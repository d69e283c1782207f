"""Doubles pair selection  W[b, u, v] = hpair[po[b, u], pv[b, v]]:
CUDA kernel and plain version.

Counterpart of ``pynqs_tpu/ops/pallas_hij.py`` (the Pallas kernels
``_kernel`` and ``_kernel_rowrow`` behind ``pair_select_w``); the module
is named for what it computes.  ``comb_hij`` takes it for the doubles
when it is given the dense pair matrix ``hpair`` [npair, npair]: ``po``
[B, n_u] and ``pv`` [B, n_v] are each sample's canonical occupied and
virtual pair indices, and each double's value is one entry of W.

The TPU kernels select through one-hot matrix products over a three-way
bf16 split of hpair and return hpair[pv, po] (equal for the symmetric
physical matrix).  The CUDA kernel (``csrc/pair_select.cu``) gathers, so
it keeps the advertised indexing for any hpair and is exact in f32 and
f64.  ``variant`` picks the output layout of the two TPU kernels:
"lane" writes [B, n_u, n_v]; "rowrow" writes [B, n_v, n_u] and the
result is its swapped view, as ``pallas_hij.py`` swaps it back.

``pair_select_w`` takes the plain version (``pair_select_w_plain``) for
tensors on the CPU and launches the kernel for tensors on the card (or
raises).  ``LAUNCHES[variant]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pynqs_tpu_torch.ops import cuda_build
from pynqs_tpu_torch.ops.cuda_build import Counter, check_launch

__all__ = ["pair_select_w", "pair_select_w_plain", "build_kernel", "LAUNCHES", "VARIANTS"]

VARIANTS = ("lane", "rowrow")
LAUNCHES = {v: Counter() for v in VARIANTS}
_SMEM_MAX = 48 * 1024  # the kernel's shared memory: (n_u + n_v) int32


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")


def pair_select_w_plain(po: torch.Tensor, pv: torch.Tensor, hpair: torch.Tensor, *,
                        variant: str = "lane") -> torch.Tensor:
    """The kernel's function in plain torch, in the variant's layout:
    [B, n_u, n_v] ("lane") or the swapped view of [B, n_v, n_u]
    ("rowrow")."""
    _check_variant(variant)
    if variant == "rowrow":
        return hpair[po[:, None, :], pv[:, :, None]].transpose(1, 2)
    return hpair[po[:, :, None], pv[:, None, :]]


def build_kernel() -> str:
    """Compile csrc/pair_select.cu for sm_90a into ``build/`` (once per
    source version) and return the library path."""
    return cuda_build.build_library("pair_select")


def _bind(so):
    P, I = ctypes.c_void_p, ctypes.c_int
    so.pair_select.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    so.pair_select.restype = I


@torch.no_grad()
def _launch(po, pv, hpair, variant):
    dev = hpair.device
    if hpair.dim() != 2 or hpair.shape[0] != hpair.shape[1]:
        raise ValueError(f"hpair must be [npair, npair], got {tuple(hpair.shape)}")
    if hpair.dtype not in (torch.float32, torch.float64) or not hpair.is_contiguous():
        raise ValueError(f"hpair must be contiguous f32 or f64, not {hpair.dtype}")
    for name, t in (("po", po), ("pv", pv)):
        if t.device != dev or t.dtype not in (torch.int32, torch.int64) or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-d int32/int64 tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if po.dtype != pv.dtype or po.shape[0] != pv.shape[0]:
        raise ValueError("po and pv must share their dtype and batch size")
    B, n_u = po.shape
    n_v = pv.shape[1]
    if (n_u + n_v) * 4 > _SMEM_MAX:
        raise ValueError(f"n_u + n_v = {n_u + n_v} pairs exceed the kernel's shared memory")
    shape = (B, n_v, n_u) if variant == "rowrow" else (B, n_u, n_v)
    out = torch.empty(shape, dtype=hpair.dtype, device=dev)
    if out.numel() > 0:
        err = cuda_build.load_library("pair_select", _bind).pair_select(
            po.data_ptr(), pv.data_ptr(), hpair.data_ptr(), out.data_ptr(),
            B, n_u, n_v, hpair.shape[0], int(po.dtype == torch.int64),
            int(hpair.dtype == torch.float64), int(variant == "rowrow"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check_launch(err, f"pair_select ({variant})")
        LAUNCHES[variant].n += 1
    return out.transpose(1, 2) if variant == "rowrow" else out


def pair_select_w(po: torch.Tensor, pv: torch.Tensor, hpair: torch.Tensor, *,
                  variant: str = "lane") -> torch.Tensor:
    """W[b, u, v] = hpair[po[b, u], pv[b, v]] for any hpair [npair, npair].

    po [B, n_u], pv [B, n_v] int32 or int64 (values in [0, npair); the
    kernel writes NaN for one outside), hpair f32 or f64.  Returns
    [B, n_u, n_v] in hpair's dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    _check_variant(variant)
    if hpair.device.type == "cpu":
        return pair_select_w_plain(po, pv, hpair, variant=variant)
    if hpair.device.type != "cuda":
        raise ValueError(f"unsupported device {hpair.device}")
    return _launch(po, pv, hpair, variant)
