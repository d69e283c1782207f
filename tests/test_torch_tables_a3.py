"""Port parity: the host tables and pair functions copied from the JAX
package — the complex-pair helpers of ``ops/cplx.py``, the integral
tables of ``ops/integrals.py``, ``System.from_fcidump``, ``utils/fci.py``
and the spin/bit maps of ``ops/onv.py`` — exactly or to 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ops import cplx as jcplx
from pynqs_tpu.ops import integrals as jints
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci as jfci

from pynqs_tpu_torch.ops import cplx, integrals, onv
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.system import System


def test_cplx_pair_functions_match_jax():
    rng = np.random.default_rng(0)
    z = rng.standard_normal(40) * 3 + 1j * rng.standard_normal(40) * 3
    np.testing.assert_array_equal(cplx.from_np_complex(z), jcplx.from_np_complex(z))
    lp = rng.standard_normal((7, 2))
    np.testing.assert_array_equal(cplx.scale(torch.as_tensor(lp), 0.3, -1.2).numpy(),
                                  np.asarray(jcplx.scale(jnp.asarray(lp), 0.3, -1.2)))
    # wide arguments too: the stable forms must not overflow
    x = np.concatenate([rng.standard_normal(50) * 2, [40.0, -60.0, 1e-8, 0.0]])
    y = np.concatenate([rng.standard_normal(50) * 2, [1.0, -2.5, 30.0, 0.7]])
    for name in ("log2cosh_pair", "log2cos_pair", "log2tanh_pair"):
        tl, tp = getattr(cplx, name)(torch.as_tensor(x), torch.as_tensor(y))
        jl, jp = getattr(jcplx, name)(jnp.asarray(x), jnp.asarray(y))
        assert np.isfinite(tl.numpy()).all(), name
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-12, err_msg=name)


def test_integral_tables_match_jax():
    rng = np.random.default_rng(1)
    norb = 3
    eri = rng.standard_normal((norb,) * 4)
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    np.testing.assert_array_equal(integrals.antisymmetrize_spin_h2e(eri),
                                  jints.antisymmetrize_spin_h2e(eri))
    _, h2e_c = jints.spin_orbital_from_spatial(np.eye(norb), eri)
    np.testing.assert_array_equal(integrals.decompress_h2e(h2e_c, 2 * norb),
                                  jints.decompress_h2e(h2e_c, 2 * norb))
    for args in ((3, 2, 1.0, 4.0, False), (3, 3, 0.5, 2.0, True), (4, 1, 1.0, 8.0, True)):
        for a, b in zip(integrals.hubbard_2d(*args), jints.hubbard_2d(*args)):
            np.testing.assert_array_equal(a, b)


def test_from_fcidump_matches_jax(tmp_path):
    """An FCIDUMP with 8-fold symmetric two-electron lines, hcore lines and
    the core energy; MS2 = 1."""
    rng = np.random.default_rng(2)
    norb = 4
    lines = ["&FCI NORB=4,NELEC=5,MS2=1,", " ORBSYM=1,1,1,1,", " ISYM=1,", "&END"]
    for i in range(1, norb + 1):
        for j in range(1, i + 1):
            for k in range(1, norb + 1):
                for l in range(1, k + 1):
                    if (i * (i - 1) // 2 + j) >= (k * (k - 1) // 2 + l):
                        lines.append(f"{rng.standard_normal() * 0.1: .16e} {i} {j} {k} {l}")
    for i in range(1, norb + 1):
        for j in range(1, i + 1):
            lines.append(f"{rng.standard_normal(): .16e} {i} {j} 0 0")
    lines.append(f"{3.25: .16e} 0 0 0 0")
    path = tmp_path / "FCIDUMP"
    path.write_text("\n".join(lines) + "\n")
    t, j = System.from_fcidump(str(path)), JSystem.from_fcidump(str(path))
    assert (t.sorb, t.noa, t.nob, t.ecore) == (j.sorb, j.noa, j.nob, j.ecore) == (8, 3, 2, 3.25)
    np.testing.assert_array_equal(t.h1e, np.asarray(j.h1e))
    np.testing.assert_array_equal(t.h2e, np.asarray(j.h2e))


def test_fci_helpers_match_jax():
    np.testing.assert_array_equal(fci.fock_bits(6), jfci.fock_bits(6))
    for sorb, noa, nob in ((8, 2, 2), (10, 3, 1), (6, 0, 2)):
        space = fci.fci_bits(sorb, noa, nob)
        assert fci.hf_index(space, noa, nob) == jfci.hf_index(space, noa, nob)
    with pytest.raises(ValueError, match="HF determinant"):
        fci.hf_index(fci.fci_bits(8, 2, 2)[1:], 2, 2)


def test_spin_bit_maps_match_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (9, 10)).astype(np.int8)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        s = onv.bits_to_spins(torch.as_tensor(bits), dt)
        np.testing.assert_array_equal(s.numpy(), np.asarray(jonv.bits_to_spins(bits, jdt)))
        back = onv.spins_to_bits(s)
        assert back.dtype == torch.int8
        np.testing.assert_array_equal(back.numpy(), np.asarray(jonv.spins_to_bits(jnp.asarray(
            s.numpy()))))
        np.testing.assert_array_equal(back.numpy(), bits)
