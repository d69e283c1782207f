"""Port parity: the doubles pair selection and ``comb_hij`` with the dense
pair matrix.

``pair_select_w_plain`` (the plain version of the CUDA kernel that
replaces ``pynqs_tpu/ops/pallas_hij.py``) against the Pallas kernels in
interpret mode and against numpy; the kernel's host side (its launch
shape, an emulation of its walk over the flat output with its own
integer arithmetic, the wrapper's checks); the dense ``comb_hij``
against its sector-block and triangle forms, the JAX package and the
oracle; REDUCE with the dense matrix against REDUCE with the sector
blocks."""

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
from pynqs_tpu_torch.ops import pair_select as ps
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


# (B, n_u, n_v): the flagship's odd n_u·n_v, several bands, one sample;
# n_u < the lane band with an odd n_u·n_v; several samples, a band count
# that does not divide n_u (lane) or n_v (rowrow); an even n_u·n_v
RAGGED = [(1, 435, 45), (3, 7, 5), (25, 170, 17), (3, 130, 12)]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("B,n_u,n_v", RAGGED + [(2048, 435, 45), (256, 435, 45), (5, 1, 1),
                                                (4, 3000, 500), (0, 435, 45)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_launch_shape_is_one_the_kernel_takes(variant, B, n_u, n_v, itemsize):
    """Bands of at most BAND_MAX pairs that split their span evenly (the
    kernel recomputes ``bands`` from ``band`` alike), one CTA per item,
    shared memory within 48 KB; at the flagship's shapes 3 bands of 145
    occupied pairs (lane, f32) or of 15 virtual pairs (rowrow)."""
    sh = ps.pair_select_launch_shape(B, n_u, n_v, itemsize, variant)
    band, bands = sh["band"], sh["bands"]
    span = n_v if variant == "rowrow" else n_u
    assert 1 <= band <= ps.BAND_MAX[variant] and sh["threads"] == ps.THREADS
    assert bands == -(-span // band) and (bands - 1) * band < span <= bands * band
    assert sh["items"] == B * bands
    assert sh["smem_bytes"] == ps.band_smem(n_u, n_v, band, itemsize, variant) <= ps.SMEM_MAX
    if (n_u, n_v) == (435, 45) and itemsize == 4:
        assert (band, bands) == ((15, 3) if variant == "rowrow" else (145, 3))


def test_launch_shape_raises_where_no_band_fits():
    with pytest.raises(ValueError, match="shared memory"):
        ps.pair_select_launch_shape(4, 10, 6000, 8, "lane")
    with pytest.raises(ValueError, match="shared memory"):
        ps.pair_select_launch_shape(4, 13000, 6, 4, "rowrow")
    with pytest.raises(ValueError, match="items"):
        ps.pair_select_launch_shape(2**30, 435, 45, 4, "lane")


def _nan_ref(po, pv, h):
    """hpair[po, pv] with NaN where an index lies outside [0, npair)."""
    n = h.shape[0]
    ok = ((po >= 0) & (po < n))[:, :, None] & ((pv >= 0) & (pv < n))[:, None, :]
    ref = h[np.clip(po, 0, n - 1)[:, :, None], np.clip(pv, 0, n - 1)[:, None, :]]
    return np.where(ok, ref, np.nan)


def _emulate_band_kernel(po, pv, h, variant):
    """``pair_select_band`` of csrc/pair_select.cu in numpy, with its own
    integer arithmetic: every CTA (one per item) loads its indices, and
    every thread walks its outputs, reading hT = h^T.  Returns the flat
    output, each element's store count and the flat offsets of the lane
    variant's vector stores."""
    B, n_u = po.shape
    n_v, npair = pv.shape[1], h.shape[0]
    T, V = ps.THREADS, 16 // h.itemsize
    hT = np.ascontiguousarray(h.T)
    sh_ = ps.pair_select_launch_shape(B, n_u, n_v, h.itemsize, variant)
    band = sh_["band"]
    bands = ((n_v if variant == "rowrow" else n_u) + band - 1) // band
    per = n_u * n_v
    out = np.zeros(B * per, h.dtype)
    count = np.zeros(B * per, np.int64)
    vec = []

    def checked(p):
        return np.where((p >= 0) & (p < npair), p, -1)

    def pick(r, c):
        bad = (r < 0) | (c < 0)
        return np.where(bad, np.nan, hT[np.where(bad, 0, r), np.where(bad, 0, c)])

    def store(f, x):
        np.add.at(count, f, 1)
        out[f] = x

    for blk in range(B * bands):
        b, j0 = blk // bands, (blk % bands) * band
        if variant == "rowrow":
            rows = min(band, n_v - j0)
            s_pv, s_po = checked(pv[b, j0:j0 + rows]), checked(po[b, :n_u])
            m, o = rows * n_u, b * per + j0 * n_u
            for t in range(T):
                l = np.arange(t, m, T)
                v = l // n_u
                store(o + l, pick(s_pv[v], s_po[l - v * n_u]))
            continue
        rows = min(band, n_u - j0)
        s_pv, s_po = checked(pv[b, :n_v]), checked(po[b, j0:j0 + rows])
        base = b * per + j0 * n_v
        sh = base % V
        m = rows * n_v
        tile = np.zeros(sh + m, h.dtype)
        written = np.zeros(sh + m, np.int64)
        for t in range(T):
            l = np.arange(t, m, T)
            v, u = l // rows, l - (l // rows) * rows
            tile[sh + u * n_v + v] = pick(s_pv[v], s_po[u])
            np.add.at(written, sh + u * n_v + v, 1)
        assert (written[sh:] == 1).all() and (written[:sh] == 0).all()
        head = min(m, (V - sh) % V)
        nvec = (m - head) // V
        tail0 = head + nvec * V
        for t in range(T):
            l = head + np.arange(t, nvec, T) * V
            vec.append(base + l)
            assert ((sh + l) % V == 0).all()  # an aligned vector of the tile
            for k in range(V):
                store(base + l + k, tile[sh + l + k])
        t = np.arange(T)
        t = t[t < head + (m - tail0)]
        l = np.where(t < head, t, tail0 + (t - head))
        store(base + l, tile[sh + l])
    return out, count, np.concatenate(vec) if vec else np.zeros(0, np.int64)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B,n_u,n_v", RAGGED)
@pytest.mark.parametrize("variant", VARIANTS)
def test_band_kernel_walk_covers_every_output_once(variant, B, n_u, n_v, dt):
    """The kernel's partition of the flat output into items and bands,
    with (lane) a tile written once per slot and stored as 16-byte
    vectors on the run's aligned interior and scalars at its edges, or
    (rowrow) direct stores, stores every element exactly once, the value
    the plain version gives (NaN at an index outside [0, npair))."""
    rng = np.random.default_rng(B * 1000 + n_u)
    npair = 40
    h = rng.standard_normal((npair, npair)).astype(dt)  # not symmetric
    po = rng.integers(-1, npair + 1, (B, n_u))  # some out of range
    pv = rng.integers(-1, npair + 1, (B, n_v))
    po[0, 0], pv[-1, -1] = -1, npair
    out, count, vec = _emulate_band_kernel(po, pv, h, variant)
    assert (count == 1).all()
    assert (vec % (16 // h.itemsize) == 0).all()  # each vector store 16-byte aligned
    rowrow = variant == "rowrow"
    W = out.reshape(B, n_v, n_u).transpose(0, 2, 1) if rowrow else out.reshape(B, n_u, n_v)
    np.testing.assert_array_equal(W, _nan_ref(po, pv, h))
    ok = ~np.isnan(_nan_ref(po, pv, h))
    pl = pair_select_w_plain(torch.as_tensor(np.clip(po, 0, npair - 1)),
                             torch.as_tensor(np.clip(pv, 0, npair - 1)), torch.as_tensor(h),
                             variant=variant).numpy()
    np.testing.assert_array_equal(W[ok], pl[ok])


def test_transposed_operand_is_made_once_per_hpair():
    """The kernel's operand hpair^T: made at the first call, kept while
    hpair lives unchanged, made again after an in-place change."""
    h = torch.arange(12.0).reshape(3, 4)[:, :3].contiguous()
    a = ps._transposed(h)
    assert torch.equal(a, h.t()) and a.is_contiguous() and ps._transposed(h) is a
    h[0, 1] = -1.0
    b = ps._transposed(h)
    assert b is not a and torch.equal(b, h.t())
    n = len(ps._HT)
    del h
    assert len(ps._HT) == n - 1  # dropped with its hpair


def test_wrapper_checks_its_operands():
    """What the kernels do not take raises before any launch."""
    h = torch.zeros(10, 10)
    po, pv = torch.zeros(3, 4, dtype=torch.int64), torch.zeros(3, 2, dtype=torch.int64)
    out, *rest = ps._operands(po, pv, h, "rowrow")  # W laid out as [B, n_v, n_u]
    assert out.shape == (3, 4, 2) and out.stride() == (8, 1, 4)
    assert out.transpose(1, 2).is_contiguous() and rest == [3, 4, 2, 10, 0, 1, -1]
    assert ps._operands(po, pv, h, "lane")[0].is_contiguous()
    bad = [
        (po, pv, torch.zeros(10, 9)),
        (po, pv[:2], h),
        (po, pv.int(), h),
        (po, pv, h.half()),
        (po.float(), pv, h),
        (po[:, ::2], pv, h),
        (po, pv, h.t()[:, :9].t()),
        (po[0], pv, h),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ps._operands(*args, "lane")


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
