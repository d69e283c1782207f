"""Port parity: Slater–Condon ``comb_hij`` and ``hij_diagonal``.

Against the JAX package in f64 (1e-10) and against the independent
second-quantization oracle (tests/oracle.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from pynqs_tpu.ops.hamiltonian import comb_hij as jcomb_hij
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.ops import integrals
from pynqs_tpu_torch.ops.hamiltonian import comb_hij, hij_diagonal
from pynqs_tpu_torch.utils.system import System


def _systems(kind, sorb, noa, nob):
    if kind == "hubbard":
        return (JSystem.hubbard_1d(sorb // 2, noa, nob, u=4.0),
                System.hubbard_1d(sorb // 2, noa, nob, u=4.0))
    rng = np.random.default_rng(sorb)
    h1e = rng.standard_normal((sorb, sorb)) * 0.3
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(integrals.triangle_size(sorb)) * 0.1
    return (JSystem.from_integrals(h1e, h2e, sorb, noa, nob),
            System.from_integrals(h1e, h2e, sorb, noa, nob))


@pytest.mark.parametrize("kind", ["hubbard", "random"])
@pytest.mark.parametrize("with_comb", [True, False])
@pytest.mark.parametrize("sectors", [True, False])
def test_comb_hij_matches_jax(kind, with_comb, sectors):
    js, ts = _systems(kind, 12, 3, 2)
    bits = fci.fci_bits(12, 3, 2)
    jt, tt = js.tables, ts.tables("cpu")
    jc, jh = jcomb_hij(
        jnp.asarray(bits), *jt.astuple(), jt.hpair_sect if sectors else None,
        table=js.excitation, with_comb=with_comb,
    )
    tc, th = comb_hij(
        torch.as_tensor(bits), *tt.astuple(), tt.hpair_sect if sectors else None,
        table=ts.excitation, with_comb=with_comb,
    )
    assert th.shape == (bits.shape[0], 1 + ts.excitation.n_sd)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-10, rtol=0)
    if with_comb:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    else:
        assert tc is None


@pytest.mark.parametrize("kind", ["hubbard", "random"])
def test_comb_hij_matches_oracle(kind):
    js, ts = _systems(kind, 8, 2, 2)
    sorb = ts.sorb
    h2e_dense = integrals.h2e_element(
        ts.h2e, *np.indices((sorb,) * 4)
    )
    bits = fci.fci_bits(sorb, 2, 2)
    tt = ts.tables("cpu")
    comb, hij = comb_hij(
        torch.as_tensor(bits), *tt.astuple(), tt.hpair_sect, table=ts.excitation
    )
    for r in range(bits.shape[0]):
        ref = oracle.apply_h(oracle.bits_to_det(bits[r]), ts.h1e, h2e_dense)
        for c in range(comb.shape[1]):
            det = oracle.bits_to_det(comb[r, c].numpy())
            # <m|H|n> for the connected m (H is real symmetric)
            np.testing.assert_allclose(
                hij[r, c].item(), ref.get(det, 0.0), atol=1e-10, rtol=0
            )


def test_comb_hij_beyond_64_spin_orbitals():
    """sorb = 76 (three 32-bit words in the JAX package's packing): the
    diagonal against the oracle's quadratic form and every element
    against the JAX package."""
    rng = np.random.default_rng(1)
    sorb, noa, nob = 76, 3, 2
    h1e = rng.standard_normal((sorb, sorb)) * 0.05
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(integrals.triangle_size(sorb)) * 0.01
    js = JSystem.from_integrals(h1e, h2e, sorb, noa, nob)
    ts = System.from_integrals(h1e, h2e, sorb, noa, nob)
    bits = np.zeros((3, sorb), np.int8)
    for r in range(3):
        bits[r, 2 * rng.permutation(sorb // 2)[:noa]] = 1
        bits[r, 2 * rng.permutation(sorb // 2)[:nob] + 1] = 1
    tt = ts.tables("cpu")
    _, th = comb_hij(torch.as_tensor(bits), *tt.astuple(), tt.hpair_sect,
                     table=ts.excitation, with_comb=False)
    _, jh = jcomb_hij(jnp.asarray(bits), *js.tables.astuple(), js.tables.hpair_sect,
                      table=js.excitation, with_comb=False)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-10, rtol=0)
    for r in range(3):
        occ = np.flatnonzero(bits[r])
        e_ref = sum(h1e[p, p] for p in occ) + sum(
            0.5 * float(integrals.h2e_element(h2e, p, q, p, q)) for p in occ for q in occ
        )
        np.testing.assert_allclose(th[r, 0].item(), e_ref, atol=1e-10)
        np.testing.assert_allclose(
            hij_diagonal(torch.as_tensor(bits[r : r + 1]), tt.diag1, tt.K).item(),
            e_ref, atol=1e-10,
        )
