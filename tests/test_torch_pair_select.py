"""Port parity: the doubles pair selection and ``comb_hij`` with the dense
pair matrix.

``pair_select_w_plain`` (the plain version of the CUDA kernel that
replaces ``pynqs_tpu/ops/pallas_hij.py``) against the Pallas kernels in
interpret mode and against numpy; the dense ``comb_hij`` against its
sector-block and triangle forms, the JAX package and the oracle; REDUCE
with the dense matrix against REDUCE with the sector blocks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from pynqs_tpu.ops.hamiltonian import comb_hij as jcomb_hij
from pynqs_tpu.ops.pallas_hij import pair_select_w as jpair_select_w
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import integrals
from pynqs_tpu_torch.ops.hamiltonian import comb_hij, pair_indices
from pynqs_tpu_torch.ops.pair_select import VARIANTS, pair_select_w, pair_select_w_plain
from pynqs_tpu_torch.utils.system import System

SORB, NOA, NOB = 12, 3, 2


def _pairs(seed, sym, B=5, n_u=11, n_v=7, npair=45):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((npair, npair)).astype(np.float32)
    if sym:
        h = h + h.T
    return h, rng.integers(0, npair, (B, n_u)), rng.integers(0, npair, (B, n_v))


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_on_a_symmetric_hpair(variant):
    """Within 2e-7·max|hpair|: the Pallas kernel's three-way bf16 split
    of f32 hpair leaves that residual; the port's values are exact f32
    entries."""
    h, po, pv = _pairs(0, True)
    ref = np.asarray(jpair_select_w(jnp.asarray(po, jnp.int32), jnp.asarray(pv, jnp.int32),
                                    jnp.asarray(h), interpret=True, variant=variant))
    out = pair_select_w_plain(torch.as_tensor(po), torch.as_tensor(pv), torch.as_tensor(h),
                              variant=variant)
    assert out.shape == ref.shape == (5, 11, 7)
    assert np.abs(out.numpy() - ref).max() <= 2e-7 * np.abs(h).max()
    np.testing.assert_array_equal(out.numpy(), h[po[:, :, None], pv[:, None, :]])


@pytest.mark.parametrize("idx", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_asymmetric_hpair_keeps_the_advertised_indexing(variant, idx):
    """W[b, u, v] = hpair[po[b, u], pv[b, v]] exactly, also where hpair
    is not symmetric (the Pallas kernels return hpair[pv, po]); on CPU
    tensors ``pair_select_w`` is the plain version."""
    h, po, pv = _pairs(1, False)
    ref = h[po[:, :, None], pv[:, None, :]]
    args = (torch.as_tensor(po, dtype=idx), torch.as_tensor(pv, dtype=idx),
            torch.as_tensor(h, dtype=torch.float64))
    for fn in (pair_select_w_plain, pair_select_w):
        np.testing.assert_array_equal(fn(*args, variant=variant).numpy(), ref)
    with pytest.raises(ValueError, match="variant"):
        pair_select_w(*args, variant="lanes")


def _systems(kind, dtype=np.float64):
    if kind == "hubbard":
        return (JSystem.hubbard_1d(SORB // 2, NOA, NOB, u=4.0, dtype=dtype),
                System.hubbard_1d(SORB // 2, NOA, NOB, u=4.0))
    rng = np.random.default_rng(9)
    h1e = rng.standard_normal((SORB, SORB)) * 0.2
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(integrals.triangle_size(SORB)) * 0.05
    return (JSystem.from_integrals(h1e, h2e, SORB, NOA, NOB, dtype=dtype),
            System.from_integrals(h1e, h2e, SORB, NOA, NOB))


@pytest.mark.parametrize("pair_select", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("kind", ["hubbard", "random"])
def test_comb_hij_dense_equals_sectors_triangle_and_jax_f64(kind, pair_select):
    """f64: exactly the sector-block and triangle forms (every double is
    one entry copied from the same integrals), within 1e-12 of the JAX
    package's dense path (pair_select="xla", full-precision one-hot
    products in f64); the connected rows equal JAX's."""
    js, ts = _systems(kind)
    bits = fci.fci_bits(SORB, NOA, NOB)
    tt = ts.tables("cpu")
    tb = torch.as_tensor(bits)
    comb, dense = comb_hij(tb, *tt.astuple(), tt.hpair, table=ts.excitation,
                           pair_select=pair_select)
    for other in (tt.hpair_sect, None):
        _, h = comb_hij(tb, *tt.astuple(), other, table=ts.excitation)
        assert torch.equal(dense, h)
    jc, jh = jcomb_hij(jnp.asarray(bits), *js.tables.astuple(), js.tables.hpair,
                       table=js.excitation, pair_select="xla")
    np.testing.assert_allclose(dense.numpy(), np.asarray(jh), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(comb.numpy(), np.asarray(jc))


def test_comb_hij_dense_f32_matches_pallas_interpret():
    """f32 tables: within 5e-6 of the JAX package's Pallas pair selection
    in interpret mode (the bound tests/test_hamiltonian.py holds it to
    against f64)."""
    js, ts = _systems("random", np.float32)
    bits = fci.fci_bits(SORB, NOA, NOB)[:32]
    tt = ts.tables("cpu", torch.float32)
    ops32 = [jnp.asarray(np.asarray(x)) for x in js.tables.astuple()]
    _, jh = jcomb_hij(jnp.asarray(bits), *ops32, jnp.asarray(np.asarray(js.tables.hpair)),
                      table=js.excitation, with_comb=False, pair_select="pallas_interpret")
    for pair_select in ("auto", "xla", "pallas"):
        _, th = comb_hij(torch.as_tensor(bits), *tt.astuple(), tt.hpair,
                         table=ts.excitation, with_comb=False, pair_select=pair_select)
        assert th.dtype == torch.float32
        assert np.abs(th.numpy().astype(np.float64) - np.asarray(jh, np.float64)).max() < 5e-6


def test_comb_hij_dense_matches_oracle():
    _, ts = _systems("random")
    sorb = ts.sorb
    h2e_dense = integrals.h2e_element(ts.h2e, *np.indices((sorb,) * 4))
    bits = fci.fci_bits(sorb, NOA, NOB)[::37]
    tt = ts.tables("cpu")
    comb, hij = comb_hij(torch.as_tensor(bits), *tt.astuple(), tt.hpair, table=ts.excitation)
    for r in range(bits.shape[0]):
        ref = oracle.apply_h(oracle.bits_to_det(bits[r]), ts.h1e, h2e_dense)
        for c in range(comb.shape[1]):
            det = oracle.bits_to_det(comb[r, c].numpy())
            np.testing.assert_allclose(hij[r, c].item(), ref.get(det, 0.0), atol=1e-10, rtol=0)


def test_pair_select_values_and_errors():
    """``pair_indices`` gives the operands whose selection holds every
    double's integral; "pallas" with the sector blocks and unknown
    selections raise."""
    _, ts = _systems("random")
    tt = ts.tables("cpu")
    tb = torch.as_tensor(fci.fci_bits(SORB, NOA, NOB)[:9])
    po, pv = pair_indices(tb, ts.excitation)
    tab = ts.excitation
    assert po.shape == (9, tab.upairs.shape[0]) and pv.shape == (9, tab.vpairs.shape[0])
    W = pair_select_w(po, pv, tt.hpair)
    _, hij = comb_hij(tb, *tt.astuple(), tt.hpair, table=tab)
    vals = W.reshape(9, -1)[:, tab.u_of_k.astype(np.int64) * tab.vpairs.shape[0] + tab.v_of_k]
    assert torch.equal(vals.abs(), hij[:, 1 + tab.n_singles:].abs())
    with pytest.raises(ValueError, match="dense hpair"):
        comb_hij(tb, *tt.astuple(), tt.hpair_sect, table=tab, pair_select="pallas")
    with pytest.raises(ValueError, match="pair_select"):
        comb_hij(tb, *tt.astuple(), tt.hpair, table=tab, pair_select="pallas_interpret")


@pytest.mark.parametrize("topk", ["exact", "segmax"])
def test_reduce_with_dense_hpair_equals_sector_form(topk):
    """f64, one generator seed: the same matrix elements, so the same
    screened set, the same tail draws and the same E_loc bit for bit."""
    _, ts = _systems("random")
    tt = ts.tables("cpu")
    model = GraphMPSRNN(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float64, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    bits = torch.as_tensor(fci.fci_bits(SORB, NOA, NOB)[::5])

    def run(hp):
        return local_energy_reduce(lambda b: model.log_psi(b).detach(), bits, tt.astuple(),
                                   ts.excitation, torch.Generator().manual_seed(3), k_det=6,
                                   n_stoch=5, batch=13, hpair=hp, topk=topk)

    assert torch.equal(run(tt.hpair), run(tt.hpair_sect))
