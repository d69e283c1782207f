"""Port parity: host tables, ONV primitives and pair helpers.

The port's numpy tables must equal the JAX package's exactly, and its
torch primitives must give the same integers and (f64) values."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ops import cplx as jcplx
from pynqs_tpu.ops import excitation as jexc
from pynqs_tpu.ops import integrals as jints
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.ops import cplx, excitation, integrals, onv
from pynqs_tpu_torch.utils.system import System


def _random_integrals(sorb, seed):
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((sorb, sorb))
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(integrals.triangle_size(sorb))
    return h1e, h2e


@pytest.mark.parametrize("sorb", [8, 12])
def test_integral_tables_equal_jax(sorb):
    h1e, h2e = _random_integrals(sorb, sorb)
    a = jints.precompute_hij_tables(h1e, h2e, sorb)
    b = integrals.precompute_hij_tables(h1e, h2e, sorb)
    for k in ("h1e", "h2e", "diag1", "K", "J", "Hpair"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for x, y in zip(a.Hpair_sect, b.Hpair_sect):
        np.testing.assert_array_equal(x, y)
    assert integrals.triangle_size(sorb) == jints.triangle_size(sorb)
    dense = jints.decompress_h2e(h2e, sorb)
    np.testing.assert_array_equal(
        integrals.compress_h2e(dense, sorb), jints.compress_h2e(dense, sorb)
    )
    for p, q in ((jints.hubbard_1d(5, 1.0, 3.0, True), integrals.hubbard_1d(5, 1.0, 3.0, True)),):
        for x, y in zip(p, q):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sector", [(8, 2, 2), (12, 3, 2), (40, 15, 15)])
def test_excitation_table_equal_jax(sector):
    a = jexc.excitation_table(*sector)
    b = excitation.excitation_table(*sector)
    assert (a.n_singles, a.n_doubles) == (b.n_singles, b.n_doubles)
    for k in ("pos", "upairs", "vpairs", "u_of_k", "v_of_k"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_system_tables_equal_jax():
    h1e, h2e = _random_integrals(12, 3)
    js = JSystem.from_integrals(h1e, h2e, 12, 3, 2)
    ts = System.from_integrals(h1e, h2e, 12, 3, 2)
    jt, tt = js.tables, ts.tables("cpu")
    for x, y in zip(jt.astuple(), tt.astuple()):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for x, y in zip(jt.hpair_sect, tt.hpair_sect):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(js.excitation.pos, ts.excitation.pos)
    jh, th = JSystem.hubbard_1d(4, 2, 2, u=4.0), System.hubbard_1d(4, 2, 2, u=4.0)
    np.testing.assert_array_equal(jh.h1e, th.h1e)
    np.testing.assert_array_equal(jh.h2e, th.h2e)


def test_onv_primitives_equal_jax():
    rng = np.random.default_rng(0)
    bits = fci.fci_bits(12, 3, 2)
    jb, tb = jnp.asarray(bits), torch.as_tensor(bits)
    np.testing.assert_array_equal(jonv.hf_bits(12, 3, 2), onv.hf_bits(12, 3, 2))
    pj = np.asarray(jonv.prefix_occ(jb))
    pt = onv.prefix_occ(tb)
    np.testing.assert_array_equal(pj, pt.numpy())
    pos = rng.integers(0, 12, size=bits.shape[0])
    np.testing.assert_array_equal(
        np.asarray(jonv.parity(jnp.asarray(pj), jnp.asarray(pos))),
        onv.parity(pt, torch.as_tensor(pos)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jonv.merged_orbital_list(jb, 3, 2)),
        onv.merged_orbital_list(tb, 3, 2).numpy(),
    )
    order = rng.permutation(12)
    A = jonv.permute_sgn_matrix(order)
    np.testing.assert_array_equal(A, onv.permute_sgn_matrix(order))
    np.testing.assert_array_equal(
        np.asarray(jonv.permute_sgn(jb[:, order], jnp.asarray(A))),
        onv.permute_sgn(tb[:, order], A).numpy(),
    )


def test_excited_bits_equal_jax():
    table = jexc.excitation_table(12, 3, 2)
    bits = fci.fci_bits(12, 3, 2)[:20]
    merged = jonv.merged_orbital_list(jnp.asarray(bits), 3, 2)
    orbs = jexc.excited_orbitals(merged, jnp.asarray(table.pos))
    is_d = jnp.arange(table.n_sd) >= table.n_singles
    a = np.asarray(jexc.make_comb_bits(jnp.asarray(bits), orbs, is_d))
    t_orbs = excitation.excited_orbitals(
        onv.merged_orbital_list(torch.as_tensor(bits), 3, 2), torch.as_tensor(table.pos)
    )
    b = excitation.make_comb_bits(
        torch.as_tensor(bits), t_orbs, torch.as_tensor(np.array(is_d))
    )
    np.testing.assert_array_equal(a, b.numpy())


def test_cplx_helpers_equal_jax():
    """Same formulas; exp/cos/sin/atan2 come from two math libraries, so
    the values agree to 1 ulp (rtol 1e-15), not bit for bit."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((30, 2))
    b = rng.standard_normal((30, 2))

    def same(x, y):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-15, atol=1e-300)

    for x, y in zip(jcplx.ratio_re_im(jnp.asarray(a), jnp.asarray(b)),
                    cplx.ratio_re_im(torch.as_tensor(a), torch.as_tensor(b))):
        same(x, y)
    for x, y in zip(jcplx.exp_pair(jnp.asarray(a)), cplx.exp_pair(torch.as_tensor(a))):
        same(x, y)
    same(jcplx.safe_atan2(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1])),
         cplx.safe_atan2(torch.as_tensor(a[:, 0]), torch.as_tensor(a[:, 1])))
    np.testing.assert_array_equal(
        np.asarray(jcplx.make(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]))),
        cplx.make(torch.as_tensor(a[:, 0]), torch.as_tensor(a[:, 1])).numpy(),
    )


def test_safe_atan2_gradient_matches_jax_and_is_finite_at_zero():
    y = np.array([0.3, -1.2, 0.0, 1e-9])
    x = np.array([0.7, 0.4, 0.0, -1e-9])
    gj = jax.grad(lambda y_, x_: jcplx.safe_atan2(y_, x_).sum(), argnums=(0, 1))(
        jnp.asarray(y), jnp.asarray(x)
    )
    ty = torch.tensor(y, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    cplx.safe_atan2(ty, tx).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gj[0]), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj[1]), rtol=1e-12, atol=0)
    assert torch.isfinite(ty.grad).all() and torch.isfinite(tx.grad).all()
