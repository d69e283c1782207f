"""Prefix-sharing fused forward for chain Graph-MPS-RNN: CUDA kernels
and plain version.

Counterpart of ``pynqs_tpu/ops/fused_rnn_prefix.py`` (the Pallas kernels
``_parent_kernel`` and ``_child_kernel``).  The REDUCE local energy
evaluates ψ on a sample and its C connected children, which differ from
it at ≤ 4 spin orbitals.  A child's recurrence equals its parent's up to
the child's first changed site t_min (in process order), so those sites
need not run again:

  1. parent pass: the chain forward of the B samples, which also keeps
     each site's normalized hidden h_t [B, norb, 2d] and scalar state
     (log_amp, phase product, linear phase, α/β counts) [B, norb, 8];
  2. child pass: each child starts at its t_min from its parent's state
     after site t_min − 1 (from scratch where t_min = 0; a child with
     t_min = norb is its parent's value).

The result equals the flat fused forward on the same rows up to
summation order, with the rounding points of
``ops/fused_rnn.graph_mpsrnn_logpsi_fused``.

``graph_mpsrnn_logpsi_fused_prefix`` takes the plain torch version
(``graph_mpsrnn_logpsi_fused_prefix_plain``) for rows on the CPU and two
CUDA kernels for rows on the card; on the card it launches them or
raises.  They run on the tensor cores (``csrc/fused_rnn_mma.cu``:
``fused_rnn_prefix_parent_mma`` and ``fused_rnn_prefix_child_mma`` in
bf16 mode, the same with the suffix ``_f32`` in f32 mode, each product
as three TF32 products), the walk of the flat tensor-core kernel in the
same precision, so each row equals the flat kernel's bit for bit.  The
CUDA wrapper sorts all B·C children by t_min, so that the rows of one
thread block start close together; the TPU's one-parent, 128-lane child
blocks are not carried over.  ``PARENT_LAUNCHES`` and ``CHILD_LAUNCHES``
count launches of either design, ``MMA_PARENT_LAUNCHES`` and
``MMA_CHILD_LAUNCHES`` those on the tensor cores (either precision).  The
earlier CUDA-core passes (``csrc/fused_rnn.cu``) are reached only from
``_launch_prefix_simt``, to time them beside the tensor-core passes.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops.cuda_build import Counter, check_launch
from pynqs_tpu_torch.ops.fused_rnn import _finish, _round

__all__ = [
    "ReducePrefixForward",
    "graph_mpsrnn_logpsi_fused_prefix",
    "graph_mpsrnn_logpsi_fused_prefix_plain",
    "prefix_parent",
    "prefix_parent_plain",
    "prefix_child",
    "prefix_child_plain",
    "prefix_available",
    "t_min_from_orbitals",
    "t_min_from_packed",
    "t_min_process_order",
    "sort_children_by_t_min",
    "PARENT_LAUNCHES",
    "CHILD_LAUNCHES",
    "MMA_PARENT_LAUNCHES",
    "MMA_CHILD_LAUNCHES",
]

NSTATE = 8  # scalar state slots per site in sh (the kernel's layout)
PARENT_LAUNCHES = Counter()  # every launch of the parent pass (either kernel)
CHILD_LAUNCHES = Counter()  # every launch of the child pass (either kernel)
MMA_PARENT_LAUNCHES = Counter()  # launches of the tensor-core parent pass (bf16 or f32)
MMA_CHILD_LAUNCHES = Counter()  # launches of the tensor-core child pass (bf16 or f32)


def prefix_available(model) -> bool:
    """Chain GraphMPSRNN without tensor coupling."""
    return (
        isinstance(model, GraphMPSRNN)
        and model.is_chain
        and not model.use_tensor
        and model.maxp == 1
    )


def _require_prefix(model):
    if not prefix_available(model):
        raise ValueError("prefix sharing supports chain GraphMPSRNN without tensor coupling")


def t_min_process_order(model, parent_bits: torch.Tensor, child_bits: torch.Tensor):
    """First process-order site at which each child differs from its
    parent (norb where identical).  parent_bits [B, sorb], child_bits
    [B, C, sorb] -> [B, C] int32."""
    norb = model.norb
    diff = child_bits.long() != parent_bits.long()[:, None, :]
    site_diff = diff[..., 0::2] | diff[..., 1::2]  # [B, C, norb] by site id
    proc = site_diff[..., list(model.site_order)]
    t_idx = torch.arange(norb, dtype=torch.int32, device=child_bits.device)
    return torch.where(proc, t_idx, torch.full_like(t_idx, norb)).min(-1).values


def _inverse_order(model, device) -> torch.Tensor:
    inv = np.empty(model.norb, np.int64)
    inv[np.asarray(model.site_order)] = np.arange(model.norb)
    return torch.as_tensor(inv, dtype=torch.int32, device=device)


def t_min_from_orbitals(model, orbs: torch.Tensor) -> torch.Tensor:
    """t_min of excited determinants from their spin-orbital quadruples
    orbs [..., 4] = (i, a, j, b) (a single repeats (i, a)): the smallest
    process position of the sites they touch.  -> orbs.shape[:-1] int32."""
    inv = _inverse_order(model, orbs.device)
    return inv[(orbs.long() >> 1)].min(-1).values


def t_min_from_packed(model, opack: torch.Tensor, orb_width: int) -> torch.Tensor:
    """t_min of packed quadruples ``i | a<<w | j<<2w | b<<3w`` (the JAX
    package's eloc payload, w = orb_width; bits above 4w are ignored)."""
    mask = (1 << orb_width) - 1
    orbs = torch.stack([(opack >> (orb_width * s)) & mask for s in range(4)], -1)
    return t_min_from_orbitals(model, orbs)


def sort_children_by_t_min(child_bits: torch.Tensor, t_min: torch.Tensor):
    """Sort each parent's children by t_min (stable, ascending).  Returns
    (sorted_bits, sorted_t_min, inverse_perm); the original order of
    per-child rows comes back as
    ``torch.take_along_dim(sorted_rows, inv[..., None], 1)``."""
    order = torch.argsort(t_min, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    sb = torch.take_along_dim(child_bits, order[..., None], dim=1)
    st = torch.take_along_dim(t_min, order, dim=-1)
    return sb, st, inv


def _check(model, parent_bits, child_bits, t_min):
    _require_prefix(model)
    B, C, sorb = child_bits.shape
    if parent_bits.shape != (B, sorb) or t_min.shape != (B, C) or sorb != model.sorb:
        raise ValueError(
            f"shapes: parents {tuple(parent_bits.shape)}, children "
            f"{tuple(child_bits.shape)}, t_min {tuple(t_min.shape)}"
        )


def _tables(model, tables):
    return fused_rnn.pack_tables(model) if tables is None else tables


@torch.no_grad()
def prefix_parent_plain(model, parent_bits, *, matmul_dtype=torch.bfloat16, tables=None):
    """Parent pass in plain torch: parent_bits [B, sorb] -> (out4 [B, 4]
    = (log_amp, Re Π, Im Π, linear phase), hh [B, norb, 2d], sh [B, norb,
    8]); hh[:, t] is the normalized hidden after site t, sh[:, t] the
    scalar state (log_amp, Re Π, Im Π, linear phase, α and β counts, 0,
    0) after it, in the kernel's layout."""
    T = _tables(model, tables)
    W = _round(T["W"], matmul_dtype)
    B = parent_bits.shape[0]
    dev = parent_bits.device
    vals = parent_bits[:, 0::2].long() + 2 * parent_bits[:, 1::2].long()
    h = torch.zeros(B, 2 * model.dcut, dtype=torch.float32, device=dev)
    state = fused_rnn.init_state(B, dev)
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    hh, sh = [], []
    for t in range(model.norb):
        h, state = fused_rnn.plain_site(model, T, W, t, vals[:, model.site_order[t]], h,
                                        state, matmul_dtype)
        hh.append(h)
        sh.append(torch.stack([v.to(torch.float32) for v in state] + [zero, zero], -1))
    return torch.stack(state[:4], -1), torch.stack(hh, 1), torch.stack(sh, 1)


@torch.no_grad()
def prefix_child_plain(model, child_rows, parent, s0, hh, sh, *,
                       matmul_dtype=torch.bfloat16, tables=None):
    """Child pass in plain torch: child_rows [N, sorb], parent [N] (row
    of hh/sh), s0 [N] first changed site -> out4 [N, 4].  Each row runs
    exactly its sites s0 .. norb − 1, from its parent's state after site
    s0 − 1 (from scratch where s0 = 0)."""
    T = _tables(model, tables)
    W = _round(T["W"], matmul_dtype)
    norb = model.norb
    N = child_rows.shape[0]
    dev = child_rows.device
    vals = child_rows[:, 0::2].long() + 2 * child_rows[:, 1::2].long()
    s0 = torch.clamp(s0.long(), 0, norb)
    parent = parent.long()
    seeded = torch.nonzero(s0 > 0).squeeze(1)
    at = (parent[seeded], s0[seeded] - 1)
    h = torch.zeros(N, 2 * model.dcut, dtype=torch.float32, device=dev)
    h[seeded] = hh[at]
    state = [v.clone() for v in fused_rnn.init_state(N, dev)]  # written in place
    for k in range(6):
        state[k][seeded] = sh[at][:, k].to(state[k].dtype)
    for t in range(norb):
        rows = torch.nonzero(s0 <= t).squeeze(1)
        if rows.numel() == 0:
            continue
        hn, sn = fused_rnn.plain_site(model, T, W, t, vals[rows, model.site_order[t]],
                                      h[rows], tuple(v[rows] for v in state), matmul_dtype)
        h[rows] = hn
        for k in range(6):
            state[k][rows] = sn[k]
    return torch.stack(state[:4], -1)


def _common(model, T, W, order, pred, npred, matmul_dtype):
    return (
        order.data_ptr(), pred.data_ptr(), npred.data_ptr(),
        W.data_ptr(), int(matmul_dtype == torch.bfloat16),
        T["vcat"].data_ptr(), T["E"].data_ptr(), T["PW"].data_ptr(), T["SC"].data_ptr(),
        model.noa, model.nob, int(model.phase_mode == "arg"), int(model.norm_mode == "mpsrnn"),
    )


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_dtype(matmul_dtype):
    if matmul_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_dtype must be bf16 or f32, not {matmul_dtype}")


def _parent_simt(model, vals, hh, sh, out, matmul_dtype, tables):
    """The CUDA-core parent pass (csrc/fused_rnn.cu)."""
    dev = vals.device
    T, W, order, pred, npred = fused_rnn.operands(model, matmul_dtype, tables, dev)
    err = fused_rnn.lib().fused_rnn_prefix_parent(
        vals.data_ptr(), vals.shape[0], model.norb, model.dcut,
        *_common(model, T, W, order, pred, npred, matmul_dtype),
        hh.data_ptr(), sh.data_ptr(), out.data_ptr(), _stream(dev),
    )
    check_launch(err, "fused_rnn_prefix_parent")
    PARENT_LAUNCHES.n += 1


def _entry(name, matmul_dtype):
    """The tensor-core library's entry point ``name`` in ``matmul_dtype``."""
    return getattr(fused_rnn.lib_mma(), name + ("_f32" if matmul_dtype == torch.float32 else ""))


def _parent_mma(model, vals, hh, sh, out, matmul_dtype, tables):
    """The tensor-core parent pass (csrc/fused_rnn_mma.cu), bf16 or f32
    (3xTF32) mode."""
    dev = vals.device
    B = vals.shape[0]
    shape = fused_rnn.mma_launch_shape(model, B, _n_sm(dev), matmul_dtype)
    _, head, launch, _gslots = fused_rnn.mma_operands(model, tables, dev, B, shape, matmul_dtype)
    err = _entry("fused_rnn_prefix_parent_mma", matmul_dtype)(
        vals.data_ptr(), B, *head, *launch, hh.data_ptr(), sh.data_ptr(), out.data_ptr(),
        _stream(dev),
    )
    check_launch(err, "fused_rnn_prefix_parent_mma")
    PARENT_LAUNCHES.n += 1
    MMA_PARENT_LAUNCHES.n += 1


def _parent_pass(model, parent_bits, launch):
    """Allocate the parent pass's outputs (out4, hh, sh) and run
    ``launch(vals, hh, sh, out4)`` on them; no launch for no rows."""
    dev = parent_bits.device
    norb, d = model.norb, model.dcut
    B = parent_bits.shape[0]
    vals = fused_rnn.site_values(model, parent_bits)
    hh = torch.empty(B, norb, 2 * d, dtype=torch.float32, device=dev)
    sh = torch.empty(B, norb, NSTATE, dtype=torch.float32, device=dev)
    out = torch.empty(B, 4, dtype=torch.float32, device=dev)
    if B > 0:
        launch(vals, hh, sh, out)
    return out, hh, sh


@torch.no_grad()
def prefix_parent(model, parent_bits, *, matmul_dtype=torch.bfloat16, tables=None):
    """Parent pass: ``prefix_parent_plain`` for CPU rows; for rows on the
    card the tensor-core kernel ``fused_rnn_prefix_parent_mma`` in bf16
    or f32 (3xTF32) mode (or raise)."""
    _require_prefix(model)
    dev = parent_bits.device
    if dev.type == "cpu":
        return prefix_parent_plain(model, parent_bits, matmul_dtype=matmul_dtype,
                                   tables=tables)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_dtype(matmul_dtype)
    return _parent_pass(model, parent_bits,
                        lambda *a: _parent_mma(model, *a, matmul_dtype, tables))


def _child_simt(model, vals, s0, parent, hh, sh, out, matmul_dtype, tables):
    """The CUDA-core child pass (csrc/fused_rnn.cu) on sorted rows."""
    dev = vals.device
    T, W, order, pred, npred = fused_rnn.operands(model, matmul_dtype, tables, dev)
    err = fused_rnn.lib().fused_rnn_prefix_child(
        vals.data_ptr(), vals.shape[0], model.norb, model.dcut,
        *_common(model, T, W, order, pred, npred, matmul_dtype),
        s0.data_ptr(), parent.data_ptr(), hh.data_ptr(), sh.data_ptr(), out.data_ptr(),
        _stream(dev),
    )
    check_launch(err, "fused_rnn_prefix_child")
    CHILD_LAUNCHES.n += 1


def _child_mma(model, vals, s0, parent, hh, sh, out, matmul_dtype, tables):
    """The tensor-core child pass (csrc/fused_rnn_mma.cu) on sorted rows,
    bf16 or f32 (3xTF32) mode; the weight stream, and each position's
    first chunk in it (``site_chunk``), in that mode's packing."""
    dev = vals.device
    N = vals.shape[0]
    shape = fused_rnn.mma_launch_shape(model, N, _n_sm(dev), matmul_dtype)
    P, head, launch, _gslots = fused_rnn.mma_operands(model, tables, dev, N, shape, matmul_dtype)
    err = _entry("fused_rnn_prefix_child_mma", matmul_dtype)(
        vals.data_ptr(), N, *head, *launch, P["site_chunk"].data_ptr(), s0.data_ptr(),
        parent.data_ptr(), hh.data_ptr(), sh.data_ptr(), out.data_ptr(), _stream(dev),
    )
    check_launch(err, "fused_rnn_prefix_child_mma")
    CHILD_LAUNCHES.n += 1
    MMA_CHILD_LAUNCHES.n += 1


def _child_sorted(model, child_rows, parent, s0, hh, sh, launch):
    """Check the child pass's operands, sort its rows by s0, run
    ``launch(vals, s0, parent, hh, sh, out)`` on them and put the output
    back in the rows' order."""
    dev = child_rows.device
    norb, d = model.norb, model.dcut
    N = child_rows.shape[0]
    B = hh.shape[0]
    if hh.shape != (B, norb, 2 * d) or sh.shape != (B, norb, NSTATE) or not (
        hh.is_contiguous() and sh.is_contiguous()
        and hh.dtype == sh.dtype == torch.float32 and hh.device == sh.device == dev
    ):
        raise ValueError("hh/sh must be the parent pass's contiguous f32 histories")
    if parent.numel() != N or s0.numel() != N:
        raise ValueError(f"parent and s0 need one entry per row ({N})")
    parent = parent.reshape(-1).to(dev)
    if N > 0 and (int(parent.min()) < 0 or int(parent.max()) >= B):
        raise ValueError("parent index out of range")
    out = torch.empty(N, 4, dtype=torch.float32, device=dev)
    if N > 0:
        s0 = torch.clamp(s0.reshape(-1).to(dev), 0, norb).to(torch.int32)
        perm = torch.argsort(s0, stable=True)
        s0_s = s0[perm].contiguous()
        par_s = parent[perm].to(torch.int32).contiguous()
        vals = fused_rnn.site_values(model, child_rows)[perm].contiguous()
        out_s = torch.empty(N, 4, dtype=torch.float32, device=dev)
        launch(vals, s0_s, par_s, hh, sh, out_s)
        out[perm] = out_s
    return out


@torch.no_grad()
def prefix_child(model, child_rows, parent, s0, hh, sh, *,
                 matmul_dtype=torch.bfloat16, tables=None):
    """Child pass: ``prefix_child_plain`` for CPU rows; for rows on the
    card the tensor-core kernel ``fused_rnn_prefix_child_mma`` in bf16 or
    f32 (3xTF32) mode (or raise).  On the card all rows are sorted by s0
    first, so that the rows of one thread block start close together, and
    the output is put back in order."""
    _require_prefix(model)
    dev = child_rows.device
    if dev.type == "cpu":
        return prefix_child_plain(model, child_rows, parent, s0, hh, sh,
                                  matmul_dtype=matmul_dtype, tables=tables)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_dtype(matmul_dtype)
    return _child_sorted(model, child_rows, parent, s0, hh, sh,
                         lambda *a: _child_mma(model, *a, matmul_dtype, tables))


@torch.no_grad()
def _launch_prefix_simt(kind, model, *args, tables=None, matmul_dtype=torch.bfloat16):
    """The CUDA-core parent (``kind`` "parent", args as
    ``prefix_parent``) or child pass ("child", args as ``prefix_child``)
    in bf16 or f32 mode, the earlier design, for timing it beside the
    tensor-core pass on the same rows.  No public function reaches it:
    ``prefix_parent`` and ``prefix_child`` take the tensor-core kernels in
    either mode."""
    _check_dtype(matmul_dtype)
    if kind == "parent":
        return _parent_pass(model, *args,
                            lambda *a: _parent_simt(model, *a, matmul_dtype, tables))
    if kind == "child":
        return _child_sorted(model, *args,
                             lambda *a: _child_simt(model, *a, matmul_dtype, tables))
    raise ValueError(f"kind must be 'parent' or 'child', not {kind!r}")


def _prefix(model, parent_bits, child_bits, t_min, matmul_dtype, tables, parent_fn, child_fn):
    _check(model, parent_bits, child_bits, t_min)
    T = _tables(model, tables)
    B, C, sorb = child_bits.shape
    p_out, hh, sh = parent_fn(model, parent_bits, matmul_dtype=matmul_dtype, tables=T)
    rows = child_bits.reshape(B * C, sorb)
    parent = torch.arange(B, device=rows.device).repeat_interleave(C)
    c_out = child_fn(model, rows, parent, t_min.reshape(-1), hh, sh,
                     matmul_dtype=matmul_dtype, tables=T)
    return _finish(model, parent_bits, p_out), _finish(model, rows, c_out).reshape(B, C, 2)


def graph_mpsrnn_logpsi_fused_prefix_plain(
    model, parent_bits, child_bits, t_min, *, matmul_dtype=torch.bfloat16, tables=None
):
    """The kernels' arithmetic in plain torch, on any device.
    parent_bits [B, sorb], child_bits [B, C, sorb], t_min [B, C] ->
    (lp_parent [B, 2], lp_children [B, C, 2])."""
    return _prefix(model, parent_bits, child_bits, t_min, matmul_dtype, tables,
                   prefix_parent_plain, prefix_child_plain)


def graph_mpsrnn_logpsi_fused_prefix(
    model, parent_bits, child_bits, t_min, *, matmul_dtype=torch.bfloat16, tables=None
):
    """Prefix-sharing forward: parent_bits [B, sorb]; child_bits
    [B, C, sorb], the children of parent b; t_min [B, C], each child's
    first process-order site that differs from its parent (norb or more
    for a child equal to its parent).  Returns (lp_parent [B, 2],
    lp_children [B, C, 2]), equal to the flat fused forward on the same
    rows.  CPU rows take the plain version; CUDA rows launch the two
    kernels (or raise)."""
    return _prefix(model, parent_bits, child_bits, t_min, matmul_dtype, tables,
                   prefix_parent, prefix_child)


class ReducePrefixForward:
    """The ``prefix_fwd`` contract of ``energy/eloc.local_energy_reduce``:
    the prefix-sharing forward with the model's tables packed once, and
    the t_min of excited determinants from their orbital quadruples.

        pf = ReducePrefixForward(model)
        local_energy_reduce(fwd, bits, ..., prefix_fwd=pf)
    """

    def __init__(self, model, *, matmul_dtype=torch.bfloat16):
        _require_prefix(model)
        self.model = model
        self.matmul_dtype = matmul_dtype
        self.tables = fused_rnn.pack_tables(model)

    def t_min_orbitals(self, orbs: torch.Tensor) -> torch.Tensor:
        return t_min_from_orbitals(self.model, orbs)

    def __call__(self, parent_bits, child_bits, t_min):
        return graph_mpsrnn_logpsi_fused_prefix(
            self.model, parent_bits, child_bits, t_min,
            matmul_dtype=self.matmul_dtype, tables=self.tables,
        )
