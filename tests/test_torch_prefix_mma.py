"""The tensor-core prefix passes' host side on the CPU: where the child's
weight stream starts, its walk emulated in f64, and its launch shape, in
both precisions (bf16, and f32 as three TF32 products).

The kernels themselves (csrc/fused_rnn_mma.cu ``fused_rnn_prefix_parent_mma``
and ``fused_rnn_prefix_child_mma``, and their ``_f32`` entry points) run
only on the card, where tests/test_torch_gpu.py holds them against their
plain versions and, bit for bit, against the flat tensor-core kernel in
the same precision.  Here:

  * (a) ``pack_mma_tables``' ``site_chunk``, of the bf16 and of the f32
    stream: the stream read from chunk ``site_chunk[t]`` on is exactly
    the packing of positions t … norb − 1;
  * (b) an f64 emulation of the child pass as the kernel runs it (rows
    sorted by s0, cut into tiles of the launch shape's rows, each tile
    started at its smallest s0 from an emulated parent pass's hh and sh;
    in f32 the slot seeded unrounded and each product split into TF32
    heads and tails as tests/test_torch_fused_mma.py emulates the flat
    walk) equals the flat walk on the child rows to 1e-9: the two differ
    only in which rows share a batched product;
  * (c) the same emulation against the JAX package's prefix forward
    (Pallas kernels in interpret mode) at the tolerances of
    tests/test_torch_prefix.py: bf16 1e-4 on log|ψ| and 1e-3 on the
    unit-circle phase, f32 1e-5 and 1e-4;
  * (d) ``mma_launch_shape``: the flat forward's shape as before, and the
    prefix passes' shape fills the SMs where the rows allow and keeps 8
    warps at large N.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ops import fused_rnn_prefix as jpre
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops import fused_rnn_prefix as pre

from test_torch_fused_mma import CASES, DT, _model_on, _pair, _split_mm, _unpack

f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
SORB, N_EL = 12, 3
BITS = fci.fci_bits(SORB, N_EL, N_EL)  # 400 determinants


# ---------------- (a) the stream from a position on ----------------


STREAMS = {
    "chain-d10": lambda: CASES["chain-d10"]()[2],
    "chain-d48-sorb40": lambda: GraphMPSRNN(40, 15, 15, dcut=48, device="cpu",
                                            generator=torch.Generator().manual_seed(0)),
    "dag-d8": lambda: CASES["dag-d8"]()[2],
    "tensor-3pred-d20-dc6": lambda: CASES["tensor-3pred-d20-dc6"]()[2],
    "r5g64-stand-in-d24": lambda: _model_on("r5g64-stand-in", dcut=24),
}


def _site_chunk_starts_each_position_s_stream(case, prec):
    """Exact: the decoded weights from every start position equal the
    whole stream's decoding of the same positions, and the read ends at
    the last chunk (``_unpack`` checks that)."""
    model = STREAMS[case]()
    P = fused_rnn.pack_mma_tables(model, matmul_dtype=DT[prec])
    sc = P["site_chunk"].tolist()
    nch = P["chunks"].shape[0]
    assert P["site_chunk"].dtype == torch.int32 and len(sc) == model.norb + 1
    assert sc[0] == 0 and sc[-1] == nch and sc == sorted(sc)
    whole = _unpack(model, P, prec)
    for t0 in range(model.norb + 1):
        part = _unpack(model, P, prec, t0)
        assert len(part) == model.norb - t0
        for a, b in zip(part, whole[t0:]):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), (t0, k)


@pytest.mark.parametrize("case", list(STREAMS))
def test_site_chunk_starts_each_position_s_stream(case):
    _site_chunk_starts_each_position_s_stream(case, "bf16")


@pytest.mark.parametrize("case", list(STREAMS))
def test_f32_site_chunk_starts_each_position_s_stream(case):
    """The f32 stream (k8-steps of f32 words, twice the bf16 bytes) that
    the f32 child pass starts from ``site_chunk``."""
    _site_chunk_starts_each_position_s_stream(case, "f32")


# ---------------- (b) the child pass's walk, emulated ----------------


def _r(x, prec="bf16"):
    """The slot's value of x: rounded to bf16, or (f32) to f32."""
    return x.to(DT[prec]).to(f64)


def _walk(model, P, sites, vals, t0=0, seed=None, prec="bf16"):
    """The tensor-core kernel's walk over a chain in f64 on the packed
    operands, for rows ``vals`` [n, norb] from position t0: A from the
    row's slot, B as the kernel reads the stream, in f32 each product
    split into TF32 heads and tails.  ``seed`` = (slot [n, O], state
    (log|ψ|, Re Π, Im Π, linear phase, α, β counts)), else from zero.
    Returns (out4 [n, 4], hh [n, norb, 2d] the f64 h after each position,
    sh [n, norb, 8] the state after it), as the parent pass writes them
    (zero before t0)."""
    dp, d, norb = P["dp"], model.dcut, model.norb
    O, N = 2 * dp, vals.shape[0]
    vcat, E, PW, SC = (P[k].double() for k in ("vcat", "E", "PW", "SC"))
    rows = torch.arange(N)
    if seed is None:
        slot = torch.zeros(N, O, dtype=f64)
        la, ppr, ppi, pl = (torch.zeros(N, dtype=f64), torch.ones(N, dtype=f64),
                            torch.zeros(N, dtype=f64), torch.zeros(N, dtype=f64))
        ua = ub = torch.zeros(N, dtype=torch.long)
    else:
        slot, (la, ppr, ppi, pl, ua, ub) = seed
    hh = torch.zeros(N, norb, 2 * d, dtype=f64)
    sh = torch.zeros(N, norb, 8, dtype=f64)
    for t in range(t0, norb):
        site, x = sites[t], vals[:, model.site_order[t]]
        npd = len(model.preds[t])
        mm = (lambda a, b: a @ b) if prec == "bf16" else (  # noqa: E731
            lambda a, b: _split_mm("nk,ko->no", a, b))
        z = torch.stack([mm(slot, site["W"][v]) if npd else torch.zeros(N, O, dtype=f64)
                         for v in range(4)], 1) + vcat[t]  # [N, 4, O]
        sums = (z * z * E[t]).sum(-1)
        rem = norb - t - 1
        m = torch.stack([(model.noa - ua <= rem) & (model.nob - ub <= rem),
                         (ua + 1 <= model.noa) & (model.nob - ub <= rem),
                         (model.noa - ua <= rem) & (ub + 1 <= model.nob),
                         (ua + 1 <= model.noa) & (ub + 1 <= model.nob)], -1)
        lw = torch.where(m, torch.log(torch.clamp(sums, min=1e-30)), torch.full_like(sums, -1e30))
        la = la + 0.5 * (lw[rows, x] - torch.logsumexp(lw, -1))
        sel = z[rows, x]
        if model.norm_mode == "mpsrnn":  # 4 d with the model's d, not dp
            h = sel * torch.rsqrt(torch.clamp((z * z).sum((-2, -1)) / (4 * d), min=1e-30))[:, None]
        else:
            h = sel * torch.rsqrt(torch.clamp((sel * sel).sum(-1), min=1e-30))[:, None]
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
        slot = _r(h, prec)
        hh[:, t] = torch.cat([h[:, :d], h[:, dp:dp + d]], -1)
        sh[:, t] = torch.stack([la, ppr, ppi, pl, ua.double(), ub.double()]
                               + [torch.zeros(N, dtype=f64)] * 2, -1)
    return torch.stack([la, ppr, ppi, pl], -1), hh, sh


def _child_pass(model, P, sites, vals, s0, parent, hh, sh, rows, prec="bf16"):
    """The child kernel's schedule: rows sorted by s0 (stable), tiles of
    ``rows``, each started at its smallest s0; each row seeded from its
    own parent's hh (rounded to bf16, or to f32, into the padded slot)
    and sh after that position − 1.  Returns (out4 [N, 4], the tiles'
    (parents, s0 values) for the caller's checks)."""
    dp, d = P["dp"], model.dcut
    N = vals.shape[0]
    perm = torch.argsort(s0, stable=True)
    out = torch.zeros(N, 4, dtype=f64)
    tiles = []
    for a in range(0, N, rows):
        idx = perm[a:a + rows]
        tb = int(s0[idx].min())
        seed = None
        if tb > 0:
            p = parent[idx]
            h = _r(hh[p, tb - 1], prec)
            slot = torch.zeros(len(idx), 2 * dp, dtype=f64)
            slot[:, :d], slot[:, dp:dp + d] = h[:, :d], h[:, d:]
            st = sh[p, tb - 1]
            seed = (slot, (st[:, 0], st[:, 1], st[:, 2], st[:, 3], st[:, 4].long(),
                           st[:, 5].long()))
        out[idx] = _walk(model, P, sites, vals[idx], tb, seed, prec)[0]
        tiles.append((set(parent[idx].tolist()), set(s0[idx].tolist())))
    return out, tiles


def _family(B, C, seed, mode):
    """Parents from the FCI space and C children each: "mixed" — child 0
    equals its parent (t_min = norb), the others 1 or 2 same-spin moves or
    a random determinant (t_min 0 … norb − 1); "zero" — every child
    starts at 0; "norb" — every child equals its parent."""
    rng = np.random.default_rng(seed)
    parents = BITS[rng.integers(0, len(BITS), size=B)]
    kids = np.repeat(parents[:, None], C, axis=1).copy()
    if mode != "norb":
        for b in range(B):
            for c in range(1, C):
                if rng.random() < 0.2:
                    kids[b, c] = BITS[rng.integers(0, len(BITS))]
                    continue
                for _ in range(rng.integers(1, 3)):
                    s = rng.integers(0, 2)
                    occ = np.flatnonzero(kids[b, c, s::2]) * 2 + s
                    vir = np.flatnonzero(1 - kids[b, c, s::2]) * 2 + s
                    kids[b, c, rng.choice(occ)] = 0
                    kids[b, c, rng.choice(vir)] = 1
    return torch.as_tensor(parents), torch.as_tensor(kids)


def _model(dcut, seed, phase_mode, norm_mode):
    return GraphMPSRNN(SORB, N_EL, N_EL, dcut=dcut, phase_mode=phase_mode,
                       norm_mode=norm_mode, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _prefix_emulated(model, parents, kids, t_min, rows, prec="bf16"):
    P = fused_rnn.pack_mma_tables(model, matmul_dtype=DT[prec])
    sites = _unpack(model, P, prec)
    B, C, _ = kids.shape
    pv = parents[:, 0::2].long() + 2 * parents[:, 1::2].long()
    p_out, hh, sh = _walk(model, P, sites, pv, prec=prec)
    cr = kids.reshape(B * C, -1)
    cv = cr[:, 0::2].long() + 2 * cr[:, 1::2].long()
    parent = torch.arange(B).repeat_interleave(C)
    c_out, tiles = _child_pass(model, P, sites, cv, t_min.reshape(-1).long(), parent, hh, sh,
                               rows, prec)
    flat = _walk(model, P, sites, torch.cat([pv, cv]), prec=prec)[0]
    return p_out, c_out, flat, tiles, cr


def _child_pass_equals_the_flat_walk(modes, n_sm, s0, prec):
    model = _model(modes[2], 3, *modes[:2])
    parents, kids = _family(6, 20, 4, s0)
    t_min = pre.t_min_process_order(model, parents, kids)
    if s0 == "zero":
        t_min = torch.zeros_like(t_min)
    norb = model.norb
    assert {"mixed": (t_min == 0).any() and (t_min == norb).any()
            and ((t_min > 0) & (t_min < norb)).any(),
            "zero": (t_min == 0).all(), "norb": (t_min == norb).all()}[s0]
    rows = 16 * fused_rnn.mma_launch_shape(model, t_min.numel(), n_sm, DT[prec])["warps"]
    assert rows == {132: 16, 2: 64}[n_sm]
    p_out, c_out, flat, tiles, _ = _prefix_emulated(model, parents, kids, t_min, rows, prec)
    assert (p_out - flat[:6]).abs().max().item() < 1e-9
    assert (c_out - flat[6:]).abs().max().item() < 1e-9
    if s0 == "mixed":
        assert any(len(ps) > 1 and len(ss) > 1 for ps, ss in tiles)
        assert any(min(ss) > 0 for _, ss in tiles)


@pytest.mark.parametrize("s0", ["mixed", "zero", "norb"])
@pytest.mark.parametrize("n_sm", [132, 2])
@pytest.mark.parametrize("modes", [("arg", "mpsrnn", 10), ("linear", "unit", 20)])
def test_emulated_child_pass_equals_the_flat_walk(modes, n_sm, s0):
    """1e-9 on every output of every row (log|ψ|, Re Π, Im Π, linear
    phase), parents and children; tiles of the launch shape's rows at
    132 SMs (1 warp, 16 rows) and at 2 SMs (4 warps, 64 rows), which
    mix parents and s0 values."""
    _child_pass_equals_the_flat_walk(modes, n_sm, s0, "bf16")


@pytest.mark.parametrize("s0", ["mixed", "zero", "norb"])
@pytest.mark.parametrize("n_sm", [132, 2])
@pytest.mark.parametrize("modes", [("arg", "mpsrnn", 10), ("linear", "unit", 20)])
def test_emulated_f32_child_pass_equals_the_flat_walk(modes, n_sm, s0):
    """As the bf16 test, in f32 (3xTF32, the slot seeded unrounded): the
    f32 launch shape's tiles are the bf16 ones here."""
    _child_pass_equals_the_flat_walk(modes, n_sm, s0, "f32")


# ---------------- (c) the emulation against the JAX package ----------------


def _emulated_prefix_matches_jax_prefix(modes, prec, tol):
    jm, params, tm = _pair(SORB, N_EL, 10, 1, phase_mode=modes[0], norm_mode=modes[1])
    params = {k: jnp.asarray(v) for k, v in params.items()}
    parents, kids = _family(6, 20, 2, "mixed")
    t_min = pre.t_min_process_order(tm, parents, kids)
    jp, jc = jpre.graph_mpsrnn_logpsi_fused_prefix(
        jm, params, jnp.asarray(parents.numpy()), jnp.asarray(kids.numpy()),
        jnp.asarray(t_min.numpy()), child_block=8, parent_block=8, interpret=True,
        matmul_dtype={"bf16": jnp.bfloat16, "f32": jnp.float32}[prec])
    rows = 16 * fused_rnn.mma_launch_shape(tm, t_min.numel(), 2, DT[prec])["warps"]
    p_out, c_out, _, _, cr = _prefix_emulated(tm, parents, kids, t_min, rows, prec)
    got = torch.cat([fused_rnn._finish(tm, parents, p_out),
                     fused_rnn._finish(tm, cr, c_out)]).numpy()
    want = np.concatenate([np.asarray(jp).reshape(-1, 2), np.asarray(jc).reshape(-1, 2)])
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=tol[0], rtol=0)
    assert np.abs(np.exp(1j * got[:, 1]) - np.exp(1j * want[:, 1])).max() < tol[1]


@pytest.mark.parametrize("modes", [("arg", "mpsrnn"), ("linear", "unit")])
def test_emulated_prefix_matches_jax_prefix_bf16(modes):
    """The emulated parent and child passes, finished as the wrapper
    finishes the kernel's rows, against JAX's prefix forward in bf16
    mode: 1e-4 on log|ψ|, 1e-3 on the unit-circle phase (both round W
    and h to bf16 at the same points; the sums differ in order and
    precision)."""
    _emulated_prefix_matches_jax_prefix(modes, "bf16", (1e-4, 1e-3))


@pytest.mark.parametrize("modes", [("arg", "mpsrnn"), ("linear", "unit")])
def test_emulated_prefix_matches_jax_prefix_f32(modes):
    """The same in f32 mode against JAX's prefix forward at
    precision=HIGHEST: 1e-5 on log|ψ|, 1e-4 on the phase (the split
    leaves out about 2^-22 of each product; the sums differ in order)."""
    _emulated_prefix_matches_jax_prefix(modes, "f32", (1e-5, 1e-4))


# ---------------- (d) the launch shape ----------------


def test_flat_launch_shape_is_unchanged():
    """8 warps where the slots fit beside the stages, else 4, else 4 with
    the slots in global memory (the shapes the flat kernel has taken)."""
    chain = GraphMPSRNN(40, 15, 15, dcut=48, device="cpu")
    assert fused_rnn.mma_launch_shape(chain) == {
        "nslots": 1, "slots": "shared", "warps": 8, "smem_bytes": 98304}
    r5 = _model_on("r5g64-stand-in", dcut=64)  # and a coupling slot of 2 KB per warp
    assert fused_rnn.mma_launch_shape(r5) == {
        "nslots": 7, "slots": "shared", "warps": 4, "smem_bytes": 196608}
    big = _model_on("r5g64-stand-in", dcut=128)
    assert fused_rnn.mma_launch_shape(big) == {
        "nslots": 7, "slots": "global", "warps": 4, "smem_bytes": 73728}


@pytest.mark.parametrize("dcut", [4, 48, 128])
def test_prefix_launch_shape_fills_the_sms(dcut):
    """At every row count: at least min(n_sm, ⌈N/16⌉) CTAs (every SM busy
    where the rows allow), as many warps as allow that (one halving more
    would not fill the SMs; never more than the flat shape's), shared
    memory within the card's limit; 8 warps at the step's 655,360
    children, 1 warp (128 CTAs) at its 2048 parents."""
    model = GraphMPSRNN(40, 15, 15, dcut=dcut, device="cpu")
    flat = fused_rnn.mma_launch_shape(model)
    NP = fused_rnn.mma_width(dcut) // 8
    for n_sm in (1, 3, 66, 132):
        for n in (1, 5, 16, 17, 100, 2048, 2049, 8448, 16896, 655360):
            sh = fused_rnn.mma_launch_shape(model, n, n_sm)
            w = sh["warps"]
            assert w in (1, 2, 4, 8) and w <= flat["warps"]
            assert sh["ctas"] == -(-n // (16 * w)) >= min(n_sm, -(-n // 16))
            if w < flat["warps"]:
                assert -(-n // (32 * w)) < n_sm
            assert sh["slots"] == flat["slots"] and sh["nslots"] == flat["nslots"]
            assert sh["smem_bytes"] == 73728 + (w * NP * 512 if sh["slots"] == "shared" else 0)
            assert sh["smem_bytes"] <= fused_rnn.SMEM_LIMIT
    assert fused_rnn.mma_launch_shape(model, 655360, 132)["warps"] == flat["warps"] == 8
    assert fused_rnn.mma_launch_shape(model, 2048, 132) == {
        **flat, "warps": 1, "ctas": 128, "smem_bytes": 73728 + NP * 512}
    with pytest.raises(ValueError, match="SM count"):
        fused_rnn.mma_launch_shape(model, 2048)
