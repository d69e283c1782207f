"""The tensor-core forward's host side on the CPU: ``pack_mma_tables``
against the JAX package's weight packing, ``hidden_slots`` against the
plain forward, and the kernel's walk through the packed stream, in both
of its precisions (bf16, and f32 as three TF32 products).

The kernel itself (csrc/fused_rnn_mma.cu) runs only on the card, where
tests/test_torch_gpu.py holds it against the plain version.  Here:

  * (a) the packed stream, read back k-step by k-step in the order the
    kernel reads it and decoded with the PTX ISA's B-fragment map, in
    bf16 of mma.sync.m16n8k16 (lane 4g + c holds k = 2c + 8h + e of
    column g), in f32 of m16n8k8 TF32 (lane 4g + c holds MMA k = c and
    c + 4 of column g) and the packing's k permutation (MMA k q < 4 reads
    row 2q, q >= 4 row 2q - 7), equals entry by entry, bitwise in the
    stream's type, the JAX package's ``_pack_weights`` W and
    ``_pack_tensor_weights`` UW/KW, with the same numpy-seeded
    parameters; padding is zero;
  * (b) a plain forward that keeps the hiddens in ``hidden_slots``'
    slots is bitwise equal, in f64, to the plain forward with its dict,
    in either precision's rounding, and no slot is overwritten while it
    is live;
  * (c) an f64 emulation of the kernel's loops on the packed stream
    (slots, UW product over predecessors, KW k-steps, epilogue) agrees
    in bf16 with the plain version in f64 to 1e-9 (the two differ only
    in summation order); in f32, with each product's operands split into
    TF32 heads and tails by bit operations on the f32 words as the kernel
    splits them and the tails' product left out, with the f32 plain
    version to 1e-5 on log|psi| and 1e-4 on the phase: the split's error
    predicted before any run on the card.

A dcut_cmpr above 8 (the "tensor-3pred-d20-dc12" case: dcp 16, two
blocks of 8 c's) goes through (a) and (c) like the others, and its plain
version is held to the JAX kernel in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.fused_rnn import _pack_tensor_weights, _pack_weights
from pynqs_tpu.ops.fused_rnn import graph_mpsrnn_logpsi_fused as jfused
from pynqs_tpu.utils import fci
from pynqs_tpu.utils.graph import dag_from_order as jdag

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, graph_from_edges, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils.flagship import flagship_model
from pynqs_tpu_torch.utils.graph import dag_from_order
from pynqs_tpu_torch.utils.system import System

f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
PRECS = ("bf16", "f32")
DT = {"bf16": bf16, "f32": f32}


def _jax_dp(d):
    return 32 if d <= 32 else 48 if d <= 48 else -(-d // 64) * 64


def _pair(sorb, n, dcut, key, graph=None, jgraph=None, **kw):
    """The JAX and the torch model on one graph, with the same
    numpy-seeded parameters (a tree of numpy arrays)."""
    jm = JModel(sorb, n, n, dcut=dcut, dtype=jnp.float32, graph=jgraph, **kw)
    tm = GraphMPSRNN(sorb, n, n, dcut=dcut, dtype=torch.float32, graph=graph,
                     device="cpu", **kw)
    rng = np.random.default_rng(key)
    params = {k: (0.3 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
              for k, v in tm.named_parameters()}
    tm.load_numpy_params(params)
    return jm, params, tm


def _extra_pred_graphs(n, seed):
    rng = np.random.default_rng(seed)
    g = jdag(list(range(n)), np.abs(rng.standard_normal((n, n))), max_preds=3)
    order, preds = g
    edges = [(p, order[t]) for t, ps in enumerate(preds) for p in ps]
    return graph_from_edges(n, edges, list(order)), g


CASES = {
    "chain-d10": lambda: _pair(12, 3, 10, 1, phase_mode="arg", norm_mode="mpsrnn"),
    "dag-d8": lambda: _pair(12, 3, 8, 2, graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2),
                            phase_mode="linear", norm_mode="unit"),
    "tensor-d8-dc4": lambda: _pair(12, 3, 8, 4, graph=grid_snake_graph(3, 2),
                                   jgraph=jgrid(3, 2), use_tensor=True, dcut_cmpr=4,
                                   phase_mode="arg", norm_mode="mpsrnn"),
    "tensor-3pred-d20-dc6": lambda: _pair(12, 3, 20, 5, *_extra_pred_graphs(6, 0),
                                          use_tensor=True, dcut_cmpr=6,
                                          phase_mode="linear", norm_mode="unit"),
    "tensor-3pred-d20-dc12": lambda: _pair(12, 3, 20, 7, *_extra_pred_graphs(6, 1),
                                           use_tensor=True, dcut_cmpr=12,
                                           phase_mode="arg", norm_mode="mpsrnn"),
}


# ---------------- the kernel's reading of the packed stream ----------------


def _lane_map(prec):
    """(k, n) inside a k-step's pair of n8 tiles (16 columns) of the flat
    index of lane l = 4g + c's values.  bf16, m16n8k16: 8 values, register
    i // 2 = 2s + h holds tile s's b{2h}, b{2h+1}, i.e. k = 2c + 8h +
    (i % 2), n = 8s + g.  f32, m16n8k8 TF32: 4 values, i = 2s + r holds
    tile s's b{r}, at MMA k q = c + 4r, n = 8s + g; the packing's k
    permutation puts MMA k q < 4 at row 2q and q >= 4 at row 2(q - 4) + 1."""
    lane = np.arange(32)[:, None]
    g, c = lane // 4, lane % 4
    if prec == "bf16":
        i = np.arange(8)[None, :]
        s, h, e = i // 4, (i // 2) % 2, i % 2
        return (2 * c + 8 * h + e).ravel(), (8 * s + g).ravel()
    i = np.arange(4)[None, :]
    s, q = i // 2, c + 4 * (i % 2)
    return np.where(q < 4, 2 * q, 2 * (q - 4) + 1).ravel(), (8 * s + g).ravel()


LANE_MAPS = {p: _lane_map(p) for p in PRECS}
K_DEPTH = {"bf16": 16, "f32": 8}  # k rows of one k-step


def _unfrag(tile, n, prec="bf16"):
    """One k-step's flat values, width n -> the dense [k depth, n] B block."""
    kd, (k_idx, n_idx) = K_DEPTH[prec], LANE_MAPS[prec]
    B = torch.zeros(kd, n, dtype=f64)
    for p, part in enumerate(tile.reshape(n // 16, 16 * kd)):
        B[k_idx, 16 * p + n_idx] = part
    return B


class _Stream:
    """The kernel's walk: runs of k-steps, chunk by chunk, in the order
    of the chunk table (at most STAGE_U4 16-byte units per chunk)."""

    def __init__(self, P):
        self.tab = P["tab"].to(f64)
        self.per_u4 = 16 // P["tab"].element_size()  # values per 16-byte unit
        self.chunks = P["chunks"].tolist()
        self.c = 0

    def run(self, nks, ksz):
        per, out, v = fused_rnn.STAGE_U4 // ksz, [], self.per_u4
        for k0 in range(0, nks, per):
            off, n = self.chunks[self.c]
            self.c += 1
            m = min(per, nks - k0)
            assert n == m * ksz and n <= fused_rnn.STAGE_U4
            out += [self.tab[v * (off + i * ksz): v * (off + (i + 1) * ksz)] for i in range(m)]
        return out


def _unpack(model, P, prec="bf16", t0=0):
    """Per position t >= t0: {"W": [4, np·O, O], "UW": [np, O, 8 dcp]
    (columns (x, c, re|im)), "KW": [4, 16 per 8 c's (bf16) or 2 dcp (f32),
    O]} (the last two where coupled), as the kernel reads them from chunk
    ``site_chunk[t0]`` on: UW a run per block of cb = min(dcp, 8) c's,
    then per value W and KW; the read ends at the last chunk."""
    dcp, NP, KS = P["dcp"], P["NP"], P["KS"]
    O = 16 * NP
    cb = min(dcp, 8)
    st, sites = _Stream(P), []
    st.c = int(P["site_chunk"][t0])
    for ps in model.preds[t0:]:
        npd = len(ps)
        site = {}
        if model.use_tensor and npd >= 2:
            nb = dcp // cb
            B = [_unfrag(k, 8 * cb, prec) for _ in range(nb) for k in st.run(npd * KS, 16 * cb)]
            UW = torch.cat(B).reshape(nb, npd, O, 4, 2 * cb).permute(1, 2, 3, 0, 4)
            site["UW"] = UW.reshape(npd, O, 8 * dcp)
        nkw = (-(-dcp // 8) if prec == "bf16" else dcp // 4) if "UW" in site else 0
        W, KW = [], []
        for _ in range(4):
            B = [_unfrag(k, O, prec) for k in st.run(npd * KS + nkw, 32 * NP)]
            W.append(torch.cat(B[: npd * KS]) if npd else torch.zeros(0, O, dtype=f64))
            KW.append(torch.cat(B[npd * KS:]) if nkw else None)
        site["W"] = torch.stack(W)
        if "UW" in site:
            site["KW"] = torch.stack(KW)
        sites.append(site)
    assert st.c == len(st.chunks)
    return sites


# ---------------- (a) the packing against the JAX package ----------------


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("case", list(CASES))
def test_packed_tables_equal_the_jax_packing(case, prec):
    jm, params, tm = CASES[case]()
    d, dc = tm.dcut, tm.dcut_cmpr
    jdp = _jax_dp(d)
    P = fused_rnn.pack_mma_tables(tm, matmul_dtype=DT[prec])
    dp, dcp = P["dp"], P["dcp"]
    assert P["tab"].dtype == DT[prec] and dp == fused_rnn.mma_width(d)
    assert P["KS"] == {"bf16": 1, "f32": 2}[prec] * P["NP"]
    sites = _unpack(tm, P, prec)
    rnd = {"bf16": _bf16, "f32": _f32}[prec]  # the JAX packing in the stream's type
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    Wj = rnd(jax.jit(lambda q: _pack_weights(jm, q, jdp)[0])(jp))  # [norb, 8 jdp, 2 mp jdp]
    Wj = Wj.reshape(tm.norb, 4, 2, jdp, tm.maxp, 2, jdp)  # x, ri_o, dd, p, ri_i, e
    for t, site in enumerate(sites):
        npd = len(tm.preds[t])
        assert not Wj[t, :, :, :, npd:].any()  # JAX's masked predecessors
        W = site["W"].reshape(4, npd, 2, dp, 2, dp).numpy()  # x, p, ri_i, e, ri_o, dd
        assert not W[:, :, :, d:].any() and not W[..., d:].any()
        got = W[:, :, :, :d, :, :d].astype(np.float32)
        want = Wj[t, :, :, :d, :npd, :, :d].transpose(0, 3, 4, 5, 1, 2)
        np.testing.assert_array_equal(got, want)
    if not tm.use_tensor:
        assert P["dcp"] == 0 and not any("UW" in s for s in sites)
        return
    jdcp = -(-dc // 8) * 8
    UWj, KWj = (rnd(a) for a in jax.jit(
        lambda q: _pack_tensor_weights(jm, q, jdp, jdcp))(jp))
    UWj = UWj.reshape(tm.norb, tm.maxp, 4, 2, jdcp, tm.maxp, 2, jdp)  # j,x,ri_o,c,p,ri_i,e
    KWj = KWj.reshape(tm.norb, 4, 2, jdp, 4, 2, jdcp)  # x, ri_o, dd, x', ri_i, c
    n_coupled = 0
    for t, site in enumerate(sites):
        npd = len(tm.preds[t])
        assert ("UW" in site) == (npd >= 2)
        if "UW" not in site:
            continue
        n_coupled += 1
        UW = site["UW"].reshape(npd, 2, dp, 4, dcp, 2).numpy()  # j, ri_i, e, x, c, ri_o
        assert not UW[:, :, d:].any() and not UW[:, :, :, :, dc:].any()
        for j in range(npd):
            want = UWj[t, j, :, :, :dc, j, :, :d].transpose(3, 4, 0, 2, 1)  # ri_i,e,x,c,ri_o
            np.testing.assert_array_equal(UW[j, :, :d, :, :dc].astype(np.float32), want)
        assert site["KW"].shape[1] == {"bf16": 16 * -(-dcp // 8), "f32": 2 * dcp}[prec]
        KW = site["KW"].reshape(4, -1, 2, 2, dp).numpy()  # x, c, ri_i, ri_o, dd
        assert not KW[:, dc:].any() and not KW[..., d:].any()
        for x in range(4):
            want = KWj[t, x, :, :d, x, :, :dc].transpose(3, 2, 0, 1)  # c, ri_i, ri_o, dd
            np.testing.assert_array_equal(KW[x, :dc, :, :, :d].astype(np.float32), want)
    assert n_coupled > 0


# ---------------- (b) the hidden slots ----------------


def _stand_in_system(sorb=40, n=15, seed=0):
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    return System.from_integrals((h1e + h1e.T) / 2,
                                 rng.standard_normal(triangle_size(sorb)) * 0.01, sorb, n, n)


def _random_dag(norb, seed):
    rng = np.random.default_rng(seed)
    return dag_from_order(list(rng.permutation(norb)), rng.standard_normal((norb, norb)),
                          max_preds=int(rng.integers(2, 4)))


GRAPHS = {
    "chain": (12, None),
    "grid-3x2": (12, grid_snake_graph(3, 2)),
    "grid-4x5": (40, grid_snake_graph(4, 5)),
    "r5g64-stand-in": (40, "r5g64"),
    "random-dag-0": (16, _random_dag(8, 0)),
    "random-dag-1": (24, _random_dag(12, 1)),
    "random-dag-2": (20, _random_dag(10, 2)),
}


def _model_on(name, dcut=4, use_tensor=True):
    sorb, graph = GRAPHS[name]
    g = torch.Generator().manual_seed(3)
    if graph == "r5g64":
        return flagship_model(_stand_in_system(), dcut, use_tensor=use_tensor, max_preds=2,
                              device="cpu", generator=g)
    n = sorb // 8 + 1
    return GraphMPSRNN(sorb, n, n, dcut=dcut, graph=graph, phase_mode="arg",
                       norm_mode="mpsrnn", use_tensor=use_tensor, dtype=torch.float32,
                       device="cpu", generator=g)


def _rows(model, n, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, model.sorb), np.int8)
    for s, no in ((0, model.noa), (1, model.nob)):
        cols = np.argsort(rng.random((n, model.norb)), axis=1)[:, :no]
        out[np.repeat(np.arange(n), no), 2 * cols.ravel() + s] = 1
    return torch.as_tensor(out)


def _slot_plain(model, bits, T, mmdt):
    """graph_mpsrnn_logpsi_fused_plain with the slot file for the dict."""
    slot_w, slot_r, nslots = fused_rnn.hidden_slots(model)
    N, d, mp = bits.shape[0], model.dcut, model.maxp
    vals = bits[:, 0::2].long() + 2 * bits[:, 1::2].long()
    W = fused_rnn._round(T["W"], mmdt)
    slots = torch.zeros(nslots, N, 2 * d, dtype=f64)
    state = fused_rnn.init_state(N, "cpu", f64)
    for t, s in enumerate(model.site_order):
        npd = len(model.preds[t])
        u = torch.cat([slots[slot_r[t][j]] for j in range(npd)]
                      + [torch.zeros(N, 2 * d, dtype=f64)] * (mp - npd), dim=-1)
        h, state = fused_rnn.plain_site(model, T, W, t, vals[:, s], u, state, mmdt)
        if slot_w[t] >= 0:
            slots[slot_w[t]] = h
    return fused_rnn._finish(model, bits, torch.stack(state[:4], dim=-1))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_hidden_slots_forward_equals_the_plain_forward(name, prec):
    model = _model_on(name)
    slot_w, slot_r, nslots = fused_rnn.hidden_slots(model)
    # no slot is overwritten while live: each read finds its predecessor
    owner, last = {}, {}
    for t, ps in enumerate(model.preds):
        for p in ps:
            last[p] = t
    for t, s in enumerate(model.site_order):
        for j, p in enumerate(model.preds[t]):
            assert owner[slot_r[t][j]] == p
        if slot_w[t] >= 0:
            prev = owner.get(slot_w[t])
            assert prev is None or last[prev] <= t
            owner[slot_w[t]] = s
        else:
            assert s not in last
    live = max(sum(1 for p, tl in last.items()
                   if model.site_order.index(p) < t <= tl) for t in range(model.norb))
    assert nslots == max(1, live)
    if name == "chain":
        assert nslots == 1
    if name == "r5g64-stand-in":
        assert nslots <= 7
    bits = _rows(model, 48, 1)
    T = {k: v.double() for k, v in fused_rnn.pack_tables(model).items()}
    want = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=DT[prec],
                                                     tables=T)
    assert torch.equal(_slot_plain(model, bits, T, DT[prec]), want)


# ---------------- (c) the kernel's loops, emulated in f64 ----------------


def _tf32(x):
    """f32 values x (held in f64) rounded to TF32 by bit operations on the
    f32 words, as the kernel rounds them: half an ulp of the 10-bit
    mantissa added to the magnitude, the low 13 bits cut."""
    w = x.to(f32).view(torch.int32)
    return ((w + 0x1000) & -0x2000).view(f32).to(f64)


def _split_mm(eq, a, b):
    """The f32 mode's product: a and b split into TF32 heads and tails
    (the tail of the difference, exact in f32), a_lo b_hi + a_hi b_lo +
    a_hi b_hi in f64."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def _emulate(model, bits, prec="bf16"):
    """The tensor-core kernel's arithmetic in f64 on the packed operands:
    A from the slots, B as the walk above reads it; in f32 each product
    split as the kernel's."""
    P = fused_rnn.pack_mma_tables(model, matmul_dtype=DT[prec])
    sites = _unpack(model, P, prec)
    dp, dcp, NP = P["dp"], P["dcp"], P["NP"]
    O, d, N = 2 * dp, model.dcut, bits.shape[0]
    r = lambda x: x.to(DT[prec]).to(f64)  # noqa: E731
    mm = torch.einsum if prec == "bf16" else _split_mm
    vcat, E, PW, SC = (P[k].double() for k in ("vcat", "E", "PW", "SC"))
    slot_w, slot_r = P["slot_w"].tolist(), P["slot_r"].tolist()
    slots = torch.zeros(P["nslots"], N, O, dtype=f64)
    vals = bits[:, 0::2].long() + 2 * bits[:, 1::2].long()
    rows = torch.arange(N)
    la, ppr, ppi, pl = (torch.zeros(N, dtype=f64), torch.ones(N, dtype=f64),
                        torch.zeros(N, dtype=f64), torch.zeros(N, dtype=f64))
    ua = torch.zeros(N, dtype=torch.long)
    ub = torch.zeros(N, dtype=torch.long)
    for t, s in enumerate(model.site_order):
        npd, site, x = len(model.preds[t]), sites[t], vals[:, s]
        A = [slots[slot_r[t][j]] for j in range(npd)]
        z = torch.stack([(mm("nk,ko->no", torch.cat(A, -1), site["W"][v]) if npd
                          else torch.zeros(N, O, dtype=f64)) for v in range(4)], 1)  # [N, 4, O]
        if "UW" in site:
            pr = None
            for j in range(npd):
                uo = mm("nk,ko->no", A[j], site["UW"][j]).reshape(N, 4, dcp, 2)
                pr = uo if pr is None else torch.stack(
                    [pr[..., 0] * uo[..., 0] - pr[..., 1] * uo[..., 1],
                     pr[..., 0] * uo[..., 1] + pr[..., 1] * uo[..., 0]], -1)
            a = torch.zeros(N, 4, site["KW"].shape[1], dtype=f64)  # zero past 2 dcp in bf16
            a[:, :, : 2 * dcp] = r(pr).reshape(N, 4, 2 * dcp)
            z = z + mm("nxk,xko->nxo", a, site["KW"])
        z = z + vcat[t]
        sums = (z * z * E[t]).sum(-1)
        rem = model.norb - t - 1
        m = torch.stack([(model.noa - ua <= rem) & (model.nob - ub <= rem),
                         (ua + 1 <= model.noa) & (model.nob - ub <= rem),
                         (model.noa - ua <= rem) & (ub + 1 <= model.nob),
                         (ua + 1 <= model.noa) & (ub + 1 <= model.nob)], -1)
        lw = torch.where(m, torch.log(torch.clamp(sums, min=1e-30)), torch.full_like(sums, -1e30))
        la = la + 0.5 * (lw[rows, x] - torch.logsumexp(lw, -1))
        sel = z[rows, x]
        ssq = (z * z).sum((-2, -1)) if model.norm_mode == "mpsrnn" else (sel * sel).sum(-1)
        h = sel * torch.rsqrt(torch.clamp(ssq / (4 * d if model.norm_mode == "mpsrnn" else 1),
                                          min=1e-30))[:, None]
        if model.phase_mode == "arg":
            zr, zi = h @ PW[t, 0] + SC[t, 0], h @ PW[t, 1] + SC[t, 1]
            m2 = zr * zr + zi * zi
            mag = torch.rsqrt(torch.clamp(m2, min=1e-30))
            fr = torch.where(m2 > 1e-30, zr * mag, torch.ones_like(zr))
            fi = torch.where(m2 > 1e-30, zi * mag, torch.zeros_like(zi))
            ppr, ppi = ppr * fr - ppi * fi, ppr * fi + ppi * fr
        else:
            pl = pl + (h * PW[t][x]).sum(-1) + SC[t][x]
        ua, ub = ua + (x & 1), ub + (x >> 1)
        if slot_w[t] >= 0:
            slots[slot_w[t]] = r(h)
    return fused_rnn._finish(model, bits, torch.stack([la, ppr, ppi, pl], -1))


EMULATED = {
    "chain-d10": lambda: CASES["chain-d10"]()[2],
    "dag-d8-linear-unit": lambda: CASES["dag-d8"]()[2],
    "tensor-d8-dc4": lambda: CASES["tensor-d8-dc4"]()[2],
    "tensor-3pred-d20-dc6": lambda: CASES["tensor-3pred-d20-dc6"]()[2],
    "tensor-3pred-d20-dc12": lambda: CASES["tensor-3pred-d20-dc12"]()[2],
    "r5g64-stand-in-d24": lambda: _model_on("r5g64-stand-in", dcut=24),
    "grid-4x5-d50": lambda: _model_on("grid-4x5", dcut=50, use_tensor=False),
}


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_kernel_walk_matches_the_plain_version(case, prec):
    """bf16: against the plain version with f64 sums, to 1e-9.  f32:
    against the f32 plain version, to 1e-5 on log|psi| and 1e-4 on the
    phase (the TF32 split drops about 2^-22 of each product)."""
    model = EMULATED[case]()
    bits = (torch.as_tensor(fci.fci_bits(model.sorb, model.noa, model.nob)[:64])
            if model.sorb <= 12 else _rows(model, 64, 2))
    T = fused_rnn.pack_tables(model)
    if prec == "bf16":
        T = {k: v.double() for k, v in T.items()}
    want = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=DT[prec],
                                                     tables=T).double()
    got = _emulate(model, bits, prec)
    ta, tp = {"bf16": (1e-9, 1e-9), "f32": (1e-5, 1e-4)}[prec]
    assert (got[:, 0] - want[:, 0]).abs().max().item() < ta
    dphi = (torch.polar(torch.ones_like(got[:, 1]), got[:, 1])
            - torch.polar(torch.ones_like(want[:, 1]), want[:, 1])).abs().max().item()
    assert dphi < tp


# ---------------- the cache and the widths ----------------


def test_packed_tables_follow_the_parameters():
    """Cached while the parameters (or the given tables) are unchanged;
    an in-place update, as an optimizer step makes, repacks."""
    model = _model_on("grid-3x2")
    a = fused_rnn.pack_mma_tables(model)
    assert fused_rnn.pack_mma_tables(model) is a
    T = fused_rnn.pack_tables(model)
    b = fused_rnn.pack_mma_tables(model, T)
    assert b is not a and fused_rnn.pack_mma_tables(model, T) is b
    assert torch.equal(a["tab"], b["tab"])
    with torch.no_grad():
        model.M_re.add_(0.5)
    c = fused_rnn.pack_mma_tables(model)
    assert c is not a and not torch.equal(c["tab"], a["tab"])
    bits = _rows(model, 16, 0)
    T = {k: v.double() for k, v in fused_rnn.pack_tables(model).items()}
    want = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, tables=T)
    assert (_emulate(model, bits)[:, 0] - want[:, 0]).abs().max().item() < 1e-9


def test_f32_launch_shape():
    """The f32 mode's slots are twice the bf16 bytes: the dcut-48 chain's
    one slot stays in shared memory at 8 warps, the r5g64 stand-in's 7
    go to the global file at 4 warps; every shape within the card's
    shared memory per CTA."""
    chain = GraphMPSRNN(40, 15, 15, dcut=48, device="cpu")
    r5 = _model_on("r5g64-stand-in", dcut=64)
    stages = fused_rnn.STAGES * fused_rnn.STAGE_U4 * 16
    assert fused_rnn.mma_launch_shape(chain, matmul_dtype=f32) == {
        "nslots": 1, "slots": "shared", "warps": 8, "smem_bytes": stages + 8 * 6 * 1024}
    assert fused_rnn.mma_launch_shape(r5, matmul_dtype=f32) == {
        "nslots": 7, "slots": "global", "warps": 4, "smem_bytes": stages}
    for name, dcut in (("chain", 128), ("grid-4x5", 16), ("grid-4x5", 96), ("r5g64-stand-in", 24)):
        m = _model_on(name, dcut=dcut, use_tensor=False)
        sh = fused_rnn.mma_launch_shape(m, matmul_dtype=f32)
        slot = fused_rnn.mma_width(dcut) // 8 * 1024
        assert sh["smem_bytes"] <= fused_rnn.SMEM_LIMIT
        assert sh["smem_bytes"] == stages + (sh["warps"] * sh["nslots"] * slot
                                             if sh["slots"] == "shared" else 0)


def test_mma_widths():
    """dp tiers up to 128 (wider raises and names the ROADMAP item); any
    dcut_cmpr, padded to 4 or to a multiple of 8 as the JAX kernel pads
    it, with its KW k-steps and the coupling slot's bytes per warp."""
    assert [fused_rnn.mma_width(d) for d in (1, 10, 16, 17, 48, 50, 64, 100, 128)] == [
        16, 16, 16, 32, 48, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="dcut <= 128.*C4"):
        fused_rnn.mma_width(129)
    stages = fused_rnn.STAGES * fused_rnn.STAGE_U4 * 16
    for dc, dcp, nkw in ((1, 4, (1, 1)), (4, 4, (1, 1)), (5, 8, (1, 2)), (9, 16, (2, 4)),
                         (12, 16, (2, 4)), (17, 24, (3, 6))):
        model = GraphMPSRNN(12, 3, 3, dcut=4, graph=grid_snake_graph(3, 2), use_tensor=True,
                            dcut_cmpr=dc, device="cpu")
        for mm, k in zip((bf16, f32), nkw):
            P = fused_rnn.pack_mma_tables(model, matmul_dtype=mm)
            assert (P["dcp"], P["nkw"]) == (dcp, k)
            sh = fused_rnn.mma_launch_shape(model, matmul_dtype=mm)
            slot = 2 * 512 * (2 if mm == f32 else 1)  # dp 16
            assert sh["smem_bytes"] == stages + sh["warps"] * (sh["nslots"] * slot + 4 * k * 512)
    chain = GraphMPSRNN(12, 3, 3, dcut=4, device="cpu")
    assert fused_rnn.pack_mma_tables(chain)["nkw"] == 0


def test_plain_matches_pallas_tensor_coupling_dcut_cmpr_12():
    """The plain version at dcut_cmpr 12 (the JAX kernel pads it to 16)
    against the Pallas kernel in interpret mode, f32 matmuls: 1e-5 on
    log|psi| and 1e-4 on the phase (tests/test_torch_fused_rnn.py's: the
    same rounding points, sums in another order)."""
    jm, params, tm = CASES["tensor-3pred-d20-dc12"]()
    bits = fci.fci_bits(12, 3, 3)[:64]
    want = np.asarray(jfused(jm, {k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(bits), interpret=True, matmul_dtype=jnp.float32))
    got = fused_rnn.graph_mpsrnn_logpsi_fused(tm, torch.as_tensor(bits),
                                              matmul_dtype=f32).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-5, rtol=0)
    assert np.abs(np.exp(1j * got[:, 1]) - np.exp(1j * want[:, 1])).max() < 1e-4
