"""Fused teacher-forced Graph-MPS-RNN forward: CUDA kernels and plain version.

Counterpart of ``pynqs_tpu/ops/fused_rnn.py::graph_mpsrnn_logpsi_fused``
(the Pallas kernel ``_kernel``).  It computes, without gradients, the
same (log|ψ|, arg ψ) as ``GraphMPSRNN.log_psi`` for the ψ(m)/ψ(n)
ratio forwards of the local energy.  Differences from ``log_psi``:

  * the arg-mode phase is ``atan2`` of the running unit-complex
    product Π_t ẑ_t/|ẑ_t| (a site with ẑ = 0 contributes phase 0), so
    it agrees with the per-site atan2 sum only mod 2π;
  * ``matmul_dtype=torch.bfloat16`` rounds the transition weights and
    the hidden state to bf16 before each product and accumulates in
    f32; ``torch.float32`` is full f32.  Everything else is f32.

``graph_mpsrnn_logpsi_fused`` takes the plain torch version
(``graph_mpsrnn_logpsi_fused_plain``) for rows on the CPU.  On the card
it launches the tensor-core kernel (``csrc/fused_rnn_mma.cu``, operands
from ``pack_mma_tables`` and ``hidden_slots``, launch shape from
``mma_launch_shape``), or raises: in bf16 mode its bf16 instantiation,
in f32 mode its f32 one, each product as three TF32 products.
``LAUNCHES`` counts every launch of the fused forward, ``MMA_LAUNCHES``
those of the bf16 tensor-core kernel, ``F32_MMA_LAUNCHES`` those of the
f32 one.  A call of at least ``DEDUP_MIN_ROWS`` rows, on either device,
runs the forward once per distinct row (``distinct_rows``) and gathers
its values back to every row (the distinct count is read back to the
host once).  On the card the output is the same, row for row and bit for
bit, since the kernel's values of a row depend on that row alone (the
CPU's plain version, whose products may round a row by its place in the
batch, agrees to rounding).  Each call is the
``torch.profiler`` range ``fused_rnn.forward``; while a profiler
records, each call also adds, in the range ``fused_rnn.count_distinct``
after the forward's, its rows to ``ROWS``, the rows the forward ran on
to ``EVALUATED`` and the distinct rows among them to ``DISTINCT`` (the
dedup's own count, or below the threshold ``count_distinct``).
(``ops/fused_rnn_prefix.py`` launches the same library's prefix-sharing
entry points.)  The earlier CUDA-core kernel
(``csrc/fused_rnn.cu``) is reached only to time and check it beside the
tensor-core kernel (``_launch_simt`` in bf16, ``_launch_f32_cuda_cores``
in f32; the prefix passes' ``_launch_prefix_simt``).  The tensor-core
kernel takes any dcut (``mma_width``: dp up to 128 in registers, above
in passes of 128 outputs, ``mma_passes``) and any dcut_cmpr.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import cuda_build, onv
from pynqs_tpu_torch.ops.lut import row_keys, sort_order
from pynqs_tpu_torch.ops.cuda_build import Counter, check_launch

__all__ = [
    "graph_mpsrnn_logpsi_fused",
    "graph_mpsrnn_logpsi_fused_plain",
    "fused_forward_available",
    "pack_tables",
    "pack_mma_tables",
    "hidden_slots",
    "mma_launch_shape",
    "build_kernel",
    "build_mma_kernel",
    "LAUNCHES",
    "MMA_LAUNCHES",
    "F32_MMA_LAUNCHES",
    "ROWS",
    "DISTINCT",
    "EVALUATED",
    "DEDUP_MIN_ROWS",
    "count_distinct",
    "distinct_rows",
]

_NEG = -1e30
LAUNCHES = Counter()  # every launch of the fused forward (any kernel, any mode)
MMA_LAUNCHES = Counter()  # launches of the tensor-core kernel in bf16
F32_MMA_LAUNCHES = Counter()  # launches of the tensor-core kernel in f32 (3xTF32)
# while a profiler records: rows handed to the fused forward (a host int),
# the distinct rows of each call among them (a host int where the call
# deduplicated, else a 0-d tensor on the rows' device), and the rows the
# forward ran on (a host int)
ROWS = Counter()
DISTINCT = Counter()
EVALUATED = Counter()
PACK_ROWS = 1 << 20  # rows packed at a time by count_distinct and distinct_rows
# calls of at least this many rows run once per distinct row: on an H100,
# on the REDUCE local energy's rows of the dcut-96 chain's samples (k_det
# 512, n_stoch 128), the dedup (about 0.6-1 ms a call, its launches and the
# read-back) saved time on every call measured from 512 samples' 328,192
# rows on (48-88% distinct), at dp 96 and at dcut 64 with the tensor
# coupling, and lost up to 0.3 ms on a 164,096-row call (92% distinct)
DEDUP_MIN_ROWS = 5 << 16
MMA_WIDTHS = (16, 32, 48, 64, 96, 128)  # padded d (dp) held in registers; above, multiples of 64
STAGE_U4 = 24576 // 16  # one weight stage of the tensor-core kernel, in 16-byte units
STAGES = 3  # weight stages of the tensor-core kernel
SMEM_LIMIT = 232448  # dynamic shared memory one CTA may use on sm_90, bytes


def fused_forward_available(model) -> bool:
    return isinstance(model, GraphMPSRNN)


def pack_tables(model) -> dict:
    """f32 operand tables of the fused forward (shared by both versions).

    With d = dcut, mp = max predecessors, K = 2·mp·d inputs (pred-major,
    re then im) and O = 2d outputs per value (re then im):

      W    [norb, 4, K, O]  transition  z_x = u @ W[t, x] + vcat[t, x]
      vcat [norb, 4, O]
      E    [norb, 4, O]     softplus(η) on the re and the im halves
      PW   [norb, 4, O]     phase rows: arg mode rows 0/1 give Re/Im of
                            w·h; linear mode row x is value x's readout
      SC   [norb, 4]        phase constants (arg: c_re, c_im)
    """
    f = torch.float32
    norb, d, mp = model.norb, model.dcut, model.maxp
    p = {k: v.detach().to(f) for k, v in model.named_parameters()}
    pmask = torch.as_tensor(model._pred_mask, dtype=f, device=p["M_re"].device)
    M_re = p["M_re"] * pmask[:, :, None, None, None]  # [norb, mp, 4, d(out), d(in)]
    M_im = p["M_im"] * pmask[:, :, None, None, None]
    # W[t, x, (p, c_in, e), (c_out, dd)]:
    #   z_re = M_re h_re - M_im h_im ;  z_im = M_im h_re + M_re h_im
    blocks = torch.stack(
        [
            torch.stack([M_re, M_im], dim=-1),   # from h_re: (re, im) outputs
            torch.stack([-M_im, M_re], dim=-1),  # from h_im
        ],
        dim=2,
    )  # [norb, mp, c_in, 4, dd, e, c_out]
    W = blocks.permute(0, 3, 1, 2, 5, 6, 4).reshape(norb, 4, 2 * mp * d, 2 * d)
    vcat = torch.cat([p["v_re"], p["v_im"]], dim=-1)  # [norb, 4, 2d]
    eta = F.softplus(p["eta"])
    E = torch.cat([eta, eta], dim=-1)
    if model.phase_mode == "arg":
        wr, wi = p["w_arg_re"], p["w_arg_im"]
        z = torch.zeros_like(wr)
        PW = torch.stack(
            [torch.cat([wr, -wi], -1), torch.cat([wi, wr], -1),
             torch.cat([z, z], -1), torch.cat([z, z], -1)],
            dim=1,
        )
        zc = torch.zeros_like(p["c_arg_re"])
        SC = torch.stack([p["c_arg_re"], p["c_arg_im"], zc, zc], dim=-1)
    else:
        PW = p["w_ph"]
        SC = p["c_ph"]
    out = {
        "W": W.contiguous(), "vcat": vcat.contiguous(), "E": E.contiguous(),
        "PW": PW.contiguous(), "SC": SC.contiguous(),
    }
    if model.use_tensor:
        for k in ("U_re", "U_im", "K_re", "K_im"):
            out[k] = p[k].contiguous()
    return out


def hidden_slots(model) -> tuple:
    """Slots of the tensor-core kernel's hidden file: (slot_w, slot_r,
    nslots).  slot_w[t] keeps the hidden of the site visited at position
    t (-1: no later site reads it); slot_r[t][j] holds its predecessor j
    (0 past npred).  A hidden is live from its own position to the last
    position that reads it.  The reads of position t come before its
    write, so a slot freed at t is taken again at t: a chain needs one."""
    order, preds = model.site_order, model.preds
    last = {}
    for t, ps in enumerate(preds):
        for p in ps:
            last[p] = t
    slot_of, free, nslots = {}, [], 0
    slot_w, slot_r = [], []
    for t, s in enumerate(order):
        slot_r.append([slot_of[p] for p in preds[t]] + [0] * (model.maxp - len(preds[t])))
        for p in preds[t]:
            if last[p] == t:
                free.append(slot_of.pop(p))
        if s in last:
            if free:
                sl = min(free)
                free.remove(sl)
            else:
                sl, nslots = nslots, nslots + 1
            slot_of[s] = sl
            slot_w.append(sl)
        else:
            slot_w.append(-1)
    return slot_w, slot_r, max(nslots, 1)


def mma_width(d: int) -> int:
    """The padded d (dp) of the tensor-core kernel: O = 2 dp outputs make
    whole pairs of n8 tiles and whole k16 steps; above 128 a multiple of
    64, as the JAX kernel pads it, so that O is whole passes of 128."""
    for dp in MMA_WIDTHS:
        if d <= dp:
            return dp
    return -(-d // 64) * 64


def mma_passes(dp: int) -> int:
    """The passes of 128 outputs (16 n8 tiles) in which the kernel
    computes a value's O = 2 dp outputs: 1 up to dp 128 (all in
    registers), dp / 64 above."""
    return 1 if dp <= MMA_WIDTHS[-1] else dp // 64


def coupling_width(model) -> int:
    """The padded dcut_cmpr (dcp) of the tensor-core kernel's coupling: 4
    up to 4, else a multiple of 8 (as the JAX kernel pads it); 0 without
    the coupling."""
    if not model.use_tensor:
        return 0
    dc = model.dcut_cmpr
    return 4 if dc <= 4 else -(-dc // 8) * 8


def coupling_ksteps(model, matmul_dtype=torch.bfloat16) -> int:
    """The k-steps of one value's KW_x (nkw): one k16 per block of 8 c's
    in bf16, dcp / 4 k8 in f32; the kernel's coupling slot holds 4 nkw
    A fragments per lane."""
    dcp = coupling_width(model)
    return dcp // 4 if matmul_dtype == torch.float32 else -(-dcp // 8)


def _frag(B: torch.Tensor) -> torch.Tensor:
    """B [..., K, n] (K, n multiples of 16) -> [..., K/16, 16 n] in the
    order mma.sync.m16n8k16 reads its B fragments: per k-step, per pair
    p of n8 tiles, per lane l = 4 g + c, the 8 values (n-tile 2p + s,
    k = 2c + 8 h + e) for s, h, e in {0, 1}, s slowest: one 16-byte load
    per lane gives the lane's B registers of both tiles."""
    K, n = B.shape[-2:]
    lead = B.shape[:-2]
    b = B.reshape(*lead, K // 16, 2, 4, 2, n // 16, 2, 8)  # ks, h, c, e, p, s, g
    o = len(lead)
    b = b.permute(*range(o), o, o + 4, o + 6, o + 2, o + 5, o + 1, o + 3)
    return b.reshape(*lead, K // 16, 16 * n)


def _frag_tf32(B: torch.Tensor) -> torch.Tensor:
    """B [..., K, n] (K a multiple of 8, n of 16) -> [..., K/8, 8 n] in the
    order the f32 mode's mma.sync.m16n8k8 (TF32) reads its B fragments,
    lane l = 4 g + c holding b0 = (k c, n g) and b1 = (k c + 4, n g), with
    k permuted inside each 8-block: MMA k c and c + 4 read rows 2c and
    2c + 1, so that a lane's C fragment of n-tile k is its A fragment of
    k-step k.  Per k-step, per pair p of n8 tiles, per lane, the 4 values
    (n-tile 2p + s, row 2c + e) for s, e in {0, 1}, s slowest: one 16-byte
    load per lane gives the lane's b0, b1 of both tiles."""
    K, n = B.shape[-2:]
    lead = B.shape[:-2]
    b = B.reshape(*lead, K // 8, 4, 2, n // 16, 2, 8)  # ks, c, e, p, s, g
    o = len(lead)
    b = b.permute(*range(o), o, o + 3, o + 5, o + 1, o + 4, o + 2)
    return b.reshape(*lead, K // 8, 8 * n)


_MMA_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def pack_mma_tables(model, tables=None, matmul_dtype=torch.bfloat16) -> dict:
    """Operands of the tensor-core kernel in ``matmul_dtype`` (bf16, or
    f32 for its 3xTF32 mode), from ``pack_tables``' f32 tables
    (``tables``, or the model's own).  With dp = ``mma_width(d)``, O =
    2 dp, NP = O / 16, npass = ``mma_passes(dp)`` passes of O / npass
    columns each, dcp = ``coupling_width`` (4 or a multiple of 8),
    its blocks of cb = min(dcp, 8) c's, nkw = ``coupling_ksteps``, KS the
    k-steps of one hidden (NP of k16 in bf16, 2 NP of k8 in f32) and
    ``frag`` = ``_frag`` (bf16) or ``_frag_tf32`` (f32):

      tab     the stream in ``matmul_dtype``, in the order the kernel
              consumes it; per position t with np predecessors (coupled:
              use_tensor and np >= 2):
                coupled: UW, per block b of c's a segment of, per
                  predecessor j, KS k-steps of ``frag`` of B_jb [2 dp,
                  8 cb], rows (re|im, e < dp) of predecessor j's hidden,
                  columns (x, c in block b, re|im) of u_{j,x,c};
                per value x and pass q: np * KS k-steps of ``frag`` of
                  pass q's columns of W[t, x] [2 dp · mp, O] (rows (j,
                  re|im, e), columns (re|im, dd)), then (coupled) the nkw
                  k-steps of pass q's columns of KW_x, rows (c, re|im) of
                  the product, zero past 2 dcp: [16, O] per block of 8
                  c's (bf16), [8, O] per 4 c's (f32);
      chunks  int32 [n, 2] (offset, length) in 16-byte units: each run of
              k-steps above cut into chunks of at most STAGE_U4 units;
      site_chunk  int32 [norb + 1]: the index in ``chunks`` of each
              position's first chunk (the prefix child pass starts its
              stream there), len(chunks) at norb;
      vcat, E, PW  f32 [norb, 4, O], d padded to dp in each half; SC;
      slot_w, slot_r, nslots  ``hidden_slots``; order, npred int32;
      dp, dcp, nkw, NP, KS, npass.

    Cached per model and type, while ``tables`` (or the model's
    parameters) are the same tensors at the same version: an optimizer
    step or a load repacks."""
    if matmul_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_dtype must be bf16 or f32, not {matmul_dtype}")
    src = list(model.parameters()) if tables is None else list(tables.values())
    hits = _MMA_CACHE.setdefault(model, {})
    hit = hits.get(matmul_dtype)
    if hit is not None and len(hit[0]) == len(src) and all(
        a is b and v == b._version for (a, v), b in zip(hit[0], src)
    ):
        return hit[1]
    packed = _pack_mma(model, pack_tables(model) if tables is None else tables, matmul_dtype)
    hits[matmul_dtype] = ([(t, t._version) for t in src], packed)
    return packed


@torch.no_grad()
def _pack_mma(model, T, mmdt) -> dict:
    norb, d, mp = model.norb, model.dcut, model.maxp
    dp = mma_width(d)
    O, NP, npass = 2 * dp, dp // 8, mma_passes(dp)
    dev, f = T["W"].device, torch.float32
    f32 = mmdt == torch.float32
    frag, KS = (_frag_tf32, 2 * NP) if f32 else (_frag, NP)

    def by_pass(B):  # [..., K, O] -> [..., npass, K, O / npass]
        return B.reshape(*B.shape[:-1], npass, O // npass).movedim(-2, -3)

    pad_d = lambda v: F.pad(v.reshape(*v.shape[:-1], 2, d), (0, dp - d)).reshape(  # noqa: E731
        *v.shape[:-1], O)
    W = F.pad(T["W"].reshape(norb, 4, mp, 2, d, 2, d), (0, dp - d, 0, 0, 0, dp - d))
    Wf = frag(by_pass(W.reshape(norb, 4, mp * O, O)).to(mmdt))  # [norb, 4, npass, mp KS, .]
    coupled = [model.use_tensor and len(ps) >= 2 for ps in model.preds]
    dcp, nkw = coupling_width(model), coupling_ksteps(model, mmdt)
    if model.use_tensor:
        dc, cb = model.dcut_cmpr, min(dcp, 8)
        nb = dcp // cb
        Ur = T["U_re"].permute(0, 1, 4, 2, 3)  # [norb, mp, d(e), 4, dc]
        Ui = T["U_im"].permute(0, 1, 4, 2, 3)
        UW = torch.zeros(norb, mp, 2, dp, 4, dcp, 2, dtype=f, device=dev)
        UW[:, :, 0, :d, :, :dc, 0] = Ur
        UW[:, :, 1, :d, :, :dc, 0] = -Ui
        UW[:, :, 0, :d, :, :dc, 1] = Ui
        UW[:, :, 1, :d, :, :dc, 1] = Ur
        # columns (x, c, re|im) -> per block b of cb c's: [O, 8 cb]
        UW = UW.reshape(norb, mp, O, 4, nb, 2 * cb).permute(0, 1, 4, 2, 3, 5)
        UWf = frag(UW.reshape(norb, mp, nb, O, 8 * cb).to(mmdt))  # [norb, mp, nb, KS, ...]
        Kr = T["K_re"].transpose(-1, -2)  # [norb, 4, dc, d]
        Ki = T["K_im"].transpose(-1, -2)
        KW = torch.zeros(norb, 4, nkw * (4 if f32 else 8), 2, 2, dp, dtype=f, device=dev)
        KW[:, :, :dc, 0, 0, :d] = Kr
        KW[:, :, :dc, 0, 1, :d] = Ki
        KW[:, :, :dc, 1, 0, :d] = -Ki
        KW[:, :, :dc, 1, 1, :d] = Kr
        KWf = frag(by_pass(KW.reshape(norb, 4, -1, O)).to(mmdt))  # [norb, 4, npass, nkw, .]
    pieces, chunks, off = [], [], 0

    def segment(ks):  # ks [n k-steps, ksz 16-byte units]
        nonlocal off
        ksz = ks.shape[1] * ks.element_size() // 16
        per = STAGE_U4 // ksz
        for k0 in range(0, ks.shape[0], per):
            n = min(per, ks.shape[0] - k0) * ksz
            chunks.append((off, n))
            off += n
        pieces.append(ks.reshape(-1))

    site_chunk = []
    for t in range(norb):
        site_chunk.append(len(chunks))
        npd = len(model.preds[t])
        if coupled[t]:
            for b in range(UWf.shape[2]):  # a segment per block of c's
                segment(UWf[t, :npd, b].reshape(npd * KS, -1))
        for x in range(4):
            for q in range(npass):
                ks = Wf[t, x, q, : npd * KS]
                segment(torch.cat([ks, KWf[t, x, q]]) if coupled[t] else ks)
    site_chunk.append(len(chunks))
    slot_w, slot_r, nslots = hidden_slots(model)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "tab": torch.cat(pieces) if pieces else torch.zeros(8, dtype=mmdt, device=dev),
        "chunks": torch.tensor(chunks, **i32).reshape(-1, 2),
        "site_chunk": torch.tensor(site_chunk, **i32),
        "vcat": pad_d(T["vcat"]).contiguous(), "E": pad_d(T["E"]).contiguous(),
        "PW": pad_d(T["PW"]).contiguous(), "SC": T["SC"].contiguous(),
        "slot_w": torch.tensor(slot_w, **i32), "slot_r": torch.tensor(slot_r, **i32),
        "nslots": nslots,
        "order": torch.tensor(model.site_order, **i32),
        "npred": torch.tensor([len(p) for p in model.preds], **i32),
        "dp": dp, "dcp": dcp, "nkw": nkw, "NP": NP, "KS": KS, "npass": npass,
    }


def _round(x, mmdt):
    return x.to(torch.bfloat16).to(x.dtype) if mmdt == torch.bfloat16 else x


def _finish(model, bits, out4):
    """Kernel rows (log_amp, Re Π, Im Π, linear phase) -> [N, 2] pair, with
    the reordering sign and the global phase added."""
    if model.phase_mode == "arg":
        phase = torch.atan2(out4[:, 2], out4[:, 1])
    else:
        phase = out4[:, 3]
    gp = model.global_phase.detach().to(out4.dtype)
    phase = phase + gp + model.sign_phase(bits, out4.dtype)
    return torch.stack([out4[:, 0], phase], dim=-1)


def init_state(n: int, dev, f=torch.float32) -> tuple:
    """Per-row scalar state before the first site: (log_amp, Re Π, Im Π,
    linear phase, α count, β count)."""
    z = torch.zeros(n, dtype=f, device=dev)
    return (z, torch.ones(n, dtype=f, device=dev), z, z,
            torch.zeros(n, dtype=torch.long, device=dev),
            torch.zeros(n, dtype=torch.long, device=dev))


def plain_site(model, T, W, t: int, x, u, state, matmul_dtype):
    """One site t of the plain forward for all rows.

    x [N] the rows' values at site t; u [N, 2·mp·d] the transition
    inputs (pred-major, re then im; the hidden itself for chains); W the
    transition table already rounded to the matmul type; state as
    ``init_state``.  Returns (h [N, 2d], state after site t)."""
    norb, d = model.norb, model.dcut
    log_amp, pr_re, pr_im, ph_lin, used_a, used_b = state
    rows = torch.arange(x.shape[0], device=x.device)
    u_mm = _round(u, matmul_dtype)
    z = torch.einsum("nk,xko->nxo", u_mm, W[t]) + T["vcat"][t]  # [N, 4, 2d]
    npred = len(model.preds[t])
    if model.use_tensor and npred >= 2:
        pr_c_re = pr_c_im = None
        for j in range(npred):
            hj = u_mm[:, j * 2 * d : (j + 1) * 2 * d]
            Ur = _round(T["U_re"][t, j], matmul_dtype)  # [4, dc, d]
            Ui = _round(T["U_im"][t, j], matmul_dtype)
            h_re, h_im = hj[:, :d], hj[:, d:]
            u_re = torch.einsum("xcd,nd->nxc", Ur, h_re) - torch.einsum("xcd,nd->nxc", Ui, h_im)
            u_im = torch.einsum("xcd,nd->nxc", Ur, h_im) + torch.einsum("xcd,nd->nxc", Ui, h_re)
            if pr_c_re is None:
                pr_c_re, pr_c_im = u_re, u_im
            else:
                pr_c_re, pr_c_im = (
                    pr_c_re * u_re - pr_c_im * u_im,
                    pr_c_re * u_im + pr_c_im * u_re,
                )
        pr_c_re = _round(pr_c_re, matmul_dtype)
        pr_c_im = _round(pr_c_im, matmul_dtype)
        Kr = _round(T["K_re"][t], matmul_dtype)  # [4, d, dc]
        Ki = _round(T["K_im"][t], matmul_dtype)
        d_re = torch.einsum("xdc,nxc->nxd", Kr, pr_c_re) - torch.einsum("xdc,nxc->nxd", Ki, pr_c_im)
        d_im = torch.einsum("xdc,nxc->nxd", Kr, pr_c_im) + torch.einsum("xdc,nxc->nxd", Ki, pr_c_re)
        z = z + torch.cat([d_re, d_im], dim=-1)
    zsq = z * z
    sums = (zsq * T["E"][t]).sum(-1)  # [N, 4]
    rem = norb - t - 1
    occ_a = used_a + 1 <= model.noa
    emp_a = model.noa - used_a <= rem
    occ_b = used_b + 1 <= model.nob
    emp_b = model.nob - used_b <= rem
    m = torch.stack([emp_a & emp_b, occ_a & emp_b, emp_a & occ_b, occ_a & occ_b], -1)
    lw = torch.where(m, torch.log(torch.clamp(sums, min=1e-30)), torch.full_like(sums, _NEG))
    lse = torch.logsumexp(lw, dim=-1)
    log_amp = log_amp + 0.5 * (lw[rows, x] - lse)
    sel = z[rows, x]  # [N, 2d]
    if model.norm_mode == "mpsrnn":
        nrm = torch.rsqrt(torch.clamp(zsq.sum((-2, -1)) / (4 * d), min=1e-30))
    else:
        nrm = torch.rsqrt(torch.clamp((sel * sel).sum(-1), min=1e-30))
    h = sel * nrm[:, None]
    if model.phase_mode == "arg":
        zr = h @ T["PW"][t, 0] + T["SC"][t, 0]
        zi = h @ T["PW"][t, 1] + T["SC"][t, 1]
        m2 = zr * zr + zi * zi
        ok = m2 > 1e-30
        mag = torch.rsqrt(torch.clamp(m2, min=1e-30))
        fr = torch.where(ok, zr * mag, torch.ones_like(zr))
        fi = torch.where(ok, zi * mag, torch.zeros_like(zi))
        pr_re, pr_im = pr_re * fr - pr_im * fi, pr_re * fi + pr_im * fr
    else:
        ph_lin = ph_lin + (h * T["PW"][t][x]).sum(-1) + T["SC"][t][x]
    return h, (log_amp, pr_re, pr_im, ph_lin, used_a + (x & 1), used_b + (x >> 1))


@torch.no_grad()
def graph_mpsrnn_logpsi_fused_plain(
    model, bits: torch.Tensor, *, matmul_dtype=torch.bfloat16, tables=None
) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (rows on the leading axis).
    bits [N, sorb] -> [N, 2], in the dtype of ``tables`` (f32 from
    ``pack_tables``; f64 tables give the same rounding points with f64
    sums)."""
    T = pack_tables(model) if tables is None else tables
    f = T["W"].dtype
    norb, d, mp = model.norb, model.dcut, model.maxp
    N = bits.shape[0]
    dev = bits.device
    vals = (bits[:, 0::2].long() + 2 * bits[:, 1::2].long())  # [N, norb]
    W = _round(T["W"], matmul_dtype)
    hid = {}  # site id -> [N, 2d] normalized hidden
    h = torch.zeros(N, 2 * d, dtype=f, device=dev)
    state = init_state(N, dev, f)
    for t in range(norb):
        s = model.site_order[t]
        if model.is_chain:
            u = h
        else:
            ps = model.preds[t]
            parts = [hid[p] for p in ps] + [
                torch.zeros(N, 2 * d, dtype=f, device=dev)
            ] * (mp - len(ps))
            u = torch.cat(parts, dim=-1)  # [N, 2·mp·d]
        h, state = plain_site(model, T, W, t, vals[:, s], u, state, matmul_dtype)
        if not model.is_chain:
            hid[s] = h
    return _finish(model, bits, torch.stack(state[:4], dim=-1))


# ---------------- the CUDA-core kernel ----------------


def build_kernel() -> str:
    """Compile csrc/fused_rnn.cu for sm_90a into ``build/`` (once per
    source version) and return the library path; the compiler's report
    is kept in ``cuda_build.BUILD_INFO["fused_rnn"]``."""
    return cuda_build.build_library("fused_rnn")


def _bind(so):
    P, I = ctypes.c_void_p, ctypes.c_int
    head = [
        P, I, I, I,              # vals, N, norb, d
        P, P, P,                 # order, pred, npred
        P, I,                    # W, w_bf16
        P, P, P, P,              # vcat, E, PW, SC
        I, I, I, I,              # noa, nob, phase_arg, norm_mpsrnn
    ]
    so.fused_rnn_forward.argtypes = head[:4] + [I] + head[4:] + [
        I,                       # chain
        P, P, P, P, I, I,        # Ure, Uim, Kre, Kim, dc, use_tensor
        P, P, P,                 # hbuf, out, stream
    ]
    so.fused_rnn_prefix_parent.argtypes = head + [P, P, P, P]  # hh, sh, out, stream
    so.fused_rnn_prefix_child.argtypes = head + [
        P, P, P, P, P, P,        # s0, parent, hh, sh, out, stream
    ]
    for fn in (so.fused_rnn_forward, so.fused_rnn_prefix_parent,
               so.fused_rnn_prefix_child):
        fn.restype = I


def lib():
    """The built library with the argument types of its three entry
    points (fused_rnn_forward, fused_rnn_prefix_parent/_child)."""
    return cuda_build.load_library("fused_rnn", _bind)


def site_values(model, bits: torch.Tensor) -> torch.Tensor:
    """bits [N, sorb] 0/1 -> the kernel's site values [N, norb] int8."""
    if bits.dim() != 2 or bits.shape[1] != model.sorb:
        raise ValueError(f"bits must be [N, {model.sorb}], got {tuple(bits.shape)}")
    return (bits[:, 0::2].to(torch.int8) + 2 * bits[:, 1::2].to(torch.int8)).contiguous()


def operands(model, matmul_dtype, tables, dev) -> tuple:
    """(tables, W in the matmul type, order, pred, npred) on ``dev``,
    checked for the kernel: the launch arguments every entry point shares."""
    if matmul_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_dtype must be bf16 or f32, not {matmul_dtype}")
    T = pack_tables(model) if tables is None else tables
    check_tables(T, dev)
    W = T["W"].to(matmul_dtype).contiguous()
    order = torch.as_tensor(model.site_order, dtype=torch.int32, device=dev)
    pred = torch.as_tensor(model._pred, dtype=torch.int32, device=dev).contiguous()
    npred = torch.as_tensor([len(p) for p in model.preds], dtype=torch.int32, device=dev)
    return T, W, order, pred, npred


@torch.no_grad()
def _launch_cuda_cores(model, bits, matmul_dtype, tables):
    """The CUDA-core kernel (csrc/fused_rnn.cu ``fused_rnn_forward``), for
    timing and checks beside the tensor-core kernel only."""
    dev = bits.device
    T, W, order, pred, npred = operands(model, matmul_dtype, tables, dev)
    vals = site_values(model, bits)
    norb, d, mp = model.norb, model.dcut, model.maxp
    N = bits.shape[0]
    out = torch.empty(N, 4, dtype=torch.float32, device=dev)
    # DAG hidden file: [N, norb, 2d] f32 (6.7 GB at the r5g64 step's 657,408
    # rows; the tensor-core kernel's f32 slot file is 7 of the 20 sites)
    hbuf = (
        torch.empty(0, dtype=torch.float32, device=dev)
        if model.is_chain
        else torch.empty(N, norb, 2 * d, dtype=torch.float32, device=dev)
    )
    none = torch.empty(0, dtype=torch.float32, device=dev)
    U_re, U_im, K_re, K_im = (
        (T["U_re"], T["U_im"], T["K_re"], T["K_im"]) if model.use_tensor else (none,) * 4
    )
    if N > 0:
        err = lib().fused_rnn_forward(
            vals.data_ptr(), N, norb, d, mp,
            order.data_ptr(), pred.data_ptr(), npred.data_ptr(),
            W.data_ptr(), int(matmul_dtype == torch.bfloat16),
            T["vcat"].data_ptr(), T["E"].data_ptr(), T["PW"].data_ptr(), T["SC"].data_ptr(),
            model.noa, model.nob, int(model.phase_mode == "arg"),
            int(model.norm_mode == "mpsrnn"), int(model.is_chain),
            U_re.data_ptr(), U_im.data_ptr(), K_re.data_ptr(), K_im.data_ptr(),
            model.dcut_cmpr, int(model.use_tensor),
            hbuf.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        check_launch(err, "fused_rnn")
        LAUNCHES.n += 1
    return _finish(model, bits, out)


def _launch_simt(model, bits, tables=None):
    """The CUDA-core kernel in bf16 mode, for timing it beside the
    tensor-core kernel on the same rows.  Not reachable from
    ``graph_mpsrnn_logpsi_fused``, which takes the tensor-core kernel in
    bf16 mode."""
    return _launch_cuda_cores(model, bits, torch.bfloat16, tables)


def _launch_f32_cuda_cores(model, bits, tables=None):
    """The CUDA-core kernel in f32 mode, the f32 forward's earlier design,
    for timing and checking it beside the tensor-core kernel's f32 mode on
    the same rows.  Not reachable from ``graph_mpsrnn_logpsi_fused``."""
    return _launch_cuda_cores(model, bits, torch.float32, tables)


# ---------------- the tensor-core kernel ----------------


def build_mma_kernel() -> str:
    """Compile csrc/fused_rnn_mma.cu for sm_90a into ``build/`` (once per
    source version) and return the library path; the compiler's report
    is kept in ``cuda_build.BUILD_INFO["fused_rnn_mma"]``."""
    return cuda_build.build_library("fused_rnn_mma")


def _bind_mma(so):
    P, I = ctypes.c_void_p, ctypes.c_int
    head = [
        P, I, I, I, I,           # vals, N, norb, d, dp
        P, P, P, P, I,           # order, npred, slot_w, slot_r, nslots
        P, P, I,                 # tab, chunks, nchunks
        P, P, P, P,              # vcat, E, PW, SC
        I, I, I, I,              # noa, nob, phase_arg, norm_mpsrnn
    ]
    shape = [I, I, I, P]         # warps, slots_shared, smem, gslots
    for sfx in ("", "_f32"):  # bf16, and f32 as three TF32 products
        fwd = getattr(so, f"fused_rnn_forward_mma{sfx}")
        par = getattr(so, f"fused_rnn_prefix_parent_mma{sfx}")
        child = getattr(so, f"fused_rnn_prefix_child_mma{sfx}")
        fwd.argtypes = head + [I, I, I] + shape + [P, P]  # mp, use_tensor, dcp; out, stream
        par.argtypes = head + shape + [P, P, P, P]  # hh, sh, out, stream
        child.argtypes = head + shape + [
            P, P, P, P, P, P, P,  # site_chunk, s0, parent, hh, sh, out, stream
        ]
        for fn in (fwd, par, child):
            fn.restype = I


def lib_mma():
    """The built library of the tensor-core kernel: fused_rnn_forward_mma,
    fused_rnn_prefix_parent_mma and fused_rnn_prefix_child_mma in bf16,
    and each with the suffix ``_f32`` in f32."""
    return cuda_build.load_library("fused_rnn_mma", _bind_mma)


def mma_launch_shape(model, n_rows=None, n_sm=None, matmul_dtype=torch.bfloat16) -> dict:
    """How the tensor-core kernel launches for ``model`` in
    ``matmul_dtype``: warps of 16 rows per CTA, where the hidden slots
    live ("shared" or "global"), their count, and the dynamic shared
    memory of one CTA in bytes.  A slot of one warp holds 16 rows' hidden,
    dp / 8 x 512 bytes in bf16, twice that in f32; with the tensor
    coupling each warp also has a coupling slot of 4 nkw x 512 bytes
    (``coupling_ksteps``), and above dp 128 a scratch for the selected
    value's outputs of npass x 8 KB (``mma_passes``; f32 in either
    precision), both beside the hidden slots.

    The flat forward (``n_rows`` None) takes 8 warps where the slots fit
    in shared memory beside the weight stages, else 4, else 4 with the
    slots in global memory (above dp 128 the kernel takes 4 only).  The prefix passes give their row count and
    the card's SM count ``n_sm``: from that start the warps are halved,
    down to 1, while the CTAs would not fill ``n_sm`` SMs, since every CTA
    streams all of W whatever its rows (2048 rows: 1 warp, 128 CTAs;
    large N keeps 8).  Then "ctas" is the grid too."""
    dp = mma_width(model.dcut)
    npass = mma_passes(dp)
    nslots = hidden_slots(model)[2]
    slot = dp // 8 * 512 * (2 if matmul_dtype == torch.float32 else 1)
    scratch = npass * 16 * 512 if npass > 1 else 0
    file = (nslots * slot + 4 * coupling_ksteps(model, matmul_dtype) * 512
            + scratch)  # one warp's slots
    stages = STAGES * STAGE_U4 * 16
    warps, shared = 4, False
    for w in (8, 4) if npass == 1 else (4,):
        if stages + w * file <= SMEM_LIMIT:
            warps, shared = w, True
            break
    out = {"nslots": nslots, "slots": "shared" if shared else "global"}
    if n_rows is not None:
        if n_sm is None or n_sm < 1:
            raise ValueError("the prefix passes' launch shape needs the SM count")
        while warps > 1 and -(-n_rows // (16 * warps)) < n_sm:
            warps //= 2
        out["ctas"] = -(-n_rows // (16 * warps))
    out["warps"] = warps
    out["smem_bytes"] = stages + (warps * file if shared else 0)
    return out


def check_tables(tables, dev):
    """Raise unless every table of ``tables`` (or None) is contiguous f32
    on ``dev``."""
    for k, v in (tables or {}).items():
        if v.device != dev or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"table {k} must be contiguous f32 on {dev}")


def mma_operands(model, tables, dev, N, shape, matmul_dtype=torch.bfloat16) -> tuple:
    """The launch arguments the tensor-core entry points share, from
    ``pack_mma_tables`` in ``matmul_dtype`` (checked to lie on ``dev``):
    (packed tables, the arguments from norb to norm_mpsrnn, the launch
    shape's arguments with a global slot file for N rows where the slots
    do not fit on chip, and that file, which must outlive the launch)."""
    check_tables(tables, dev)
    P = pack_mma_tables(model, tables, matmul_dtype)
    if P["tab"].device != dev:
        raise ValueError(f"the model's tables must be on {dev}")
    rows = 16 * shape["warps"]
    # one row's hidden slots and its share of its warp's coupling slot and
    # (above dp 128) of its scratch
    row_bytes = (P["nslots"] * 2 * P["dp"] * P["tab"].element_size() + 4 * P["nkw"] * 512 // 16
                 + (P["npass"] * 16 * 512 // 16 if P["npass"] > 1 else 0))
    n_gslot = 0 if shape["slots"] == "shared" else -(-N // rows) * rows * row_bytes
    gslots = torch.empty(n_gslot, dtype=torch.uint8, device=dev)  # the hidden file
    head = (
        model.norb, model.dcut, P["dp"],
        P["order"].data_ptr(), P["npred"].data_ptr(), P["slot_w"].data_ptr(),
        P["slot_r"].data_ptr(), P["nslots"], P["tab"].data_ptr(),
        P["chunks"].data_ptr(), P["chunks"].shape[0],
        P["vcat"].data_ptr(), P["E"].data_ptr(), P["PW"].data_ptr(), P["SC"].data_ptr(),
        model.noa, model.nob, int(model.phase_mode == "arg"), int(model.norm_mode == "mpsrnn"),
    )
    launch = (shape["warps"], int(shape["slots"] == "shared"), shape["smem_bytes"],
              gslots.data_ptr())
    return P, head, launch, gslots


@torch.no_grad()
def _launch_mma(model, bits, tables, matmul_dtype=torch.bfloat16):
    """The tensor-core kernel (csrc/fused_rnn_mma.cu): its bf16 mode, or
    its f32 mode of three TF32 products per product."""
    dev = bits.device
    vals = site_values(model, bits)
    N = bits.shape[0]
    out = torch.empty(N, 4, dtype=torch.float32, device=dev)
    shape = mma_launch_shape(model, matmul_dtype=matmul_dtype)
    P, head, launch, _gslots = mma_operands(model, tables, dev, N, shape, matmul_dtype)
    f32 = matmul_dtype == torch.float32
    if N > 0:
        fn = lib_mma().fused_rnn_forward_mma_f32 if f32 else lib_mma().fused_rnn_forward_mma
        err = fn(
            vals.data_ptr(), N, *head, model.maxp, int(model.use_tensor), P["dcp"], *launch,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        check_launch(err, "fused_rnn_mma")
        LAUNCHES.n += 1
        (F32_MMA_LAUNCHES if f32 else MMA_LAUNCHES).n += 1
    return _finish(model, bits, out)


def graph_mpsrnn_logpsi_fused(
    model, bits: torch.Tensor, *, matmul_dtype=torch.bfloat16, tables=None
) -> torch.Tensor:
    """Gradient-free replacement for ``model.log_psi``: bits [N, sorb]
    0/1 -> [N, 2] (log|ψ|, arg ψ), f32.  CPU rows take the plain
    version; CUDA rows launch the tensor-core kernel in bf16 or in f32
    (3xTF32), or raise.  From ``DEDUP_MIN_ROWS`` rows on, either runs on
    the distinct rows alone."""
    if not fused_forward_available(model):
        raise ValueError("the fused forward computes GraphMPSRNN models only")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")
    n = bits.shape[0]
    dedup = n >= DEDUP_MIN_ROWS
    with record_function("fused_rnn.forward"):
        if dedup:
            first, inverse = distinct_rows(bits)
            rows = bits[first]
        else:
            rows = bits
        if bits.device.type == "cpu":
            out = graph_mpsrnn_logpsi_fused_plain(
                model, rows, matmul_dtype=matmul_dtype, tables=tables
            )
        else:
            out = _launch_mma(model, rows, tables, matmul_dtype)  # raises unless bf16 or f32
        if dedup:
            out = out[inverse]
    if torch.autograd._profiler_enabled():
        with record_function("fused_rnn.count_distinct"):
            ROWS.n += n
            EVALUATED.n += rows.shape[0]
            DISTINCT.n = DISTINCT.n + (rows.shape[0] if dedup else count_distinct(bits))
    return out


def _sorted_keys(bits: torch.Tensor) -> tuple:
    """The rows of bits [N, sorb] as sorted keys [N, k] (one int64 each
    with ``row_keys``, else the packed words) and the permutation [N]
    that sorts them."""
    packed = torch.cat([onv.pack_bits(bits[s:s + PACK_ROWS])
                        for s in range(0, max(bits.shape[0], 1), PACK_ROWS)])
    key = row_keys(packed)
    if key is not None:
        srt, perm = torch.sort(key)
        return srt[:, None], perm
    perm = sort_order(packed)
    return packed[perm], perm


@torch.no_grad()
def count_distinct(bits: torch.Tensor) -> torch.Tensor:
    """The distinct rows of bits [N, sorb] as a 0-d int64 tensor on their
    device, with the keys of ``energy/eloc.unique_rows`` (the words of
    ``onv.pack_bits``, ``PACK_ROWS`` rows at a time, then ``row_keys``),
    sorted and counted where the key changes: nothing is read back to the
    host."""
    if bits.shape[0] == 0:
        return torch.zeros((), dtype=torch.long, device=bits.device)
    srt, _ = _sorted_keys(bits)
    return 1 + (srt[1:] != srt[:-1]).any(-1).sum()


@torch.no_grad()
def distinct_rows(bits: torch.Tensor) -> tuple:
    """(first [U] int64, inverse [N] int64): a row of each distinct row of
    bits [N, sorb], in the order of ``count_distinct``'s keys, and each
    row's place among them, so that ``bits[first][inverse]`` equals
    ``bits``.  U is read back to the host, once."""
    srt, perm = _sorted_keys(bits)
    new = torch.ones(bits.shape[0], dtype=torch.bool, device=bits.device)
    new[1:] = (srt[1:] != srt[:-1]).any(-1)  # where a run of equal rows starts
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.cumsum(new, 0) - 1
    return perm[new], inverse
