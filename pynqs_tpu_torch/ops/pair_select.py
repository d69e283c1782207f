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

The kernel reads hpair[po, pv] as hT[pv, po] along the rows of hT, a
transposed copy of hpair that the wrapper makes once per hpair: a
sample's occupied pairs are dense among all pairs, its virtual pairs
sparse, so the rows of hT share far more L2 sectors.  One CTA takes one
work item, a sample and a band of its occupied pairs ("lane") or of its
virtual pairs ("rowrow"); ``pair_select_launch_shape`` chooses the
bands.  ``pair_select_w`` takes the plain version
(``pair_select_w_plain``) for tensors on the CPU and launches the kernel
for tensors on the card (or raises).  ``LAUNCHES[variant]`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from pynqs_tpu_torch.ops import cuda_build
from pynqs_tpu_torch.ops.cuda_build import Counter, check_launch

__all__ = ["pair_select_w", "pair_select_w_plain", "pair_select_launch_shape", "build_kernel",
           "LAUNCHES", "VARIANTS"]

VARIANTS = ("lane", "rowrow")
LAUNCHES = {v: Counter() for v in VARIANTS}
THREADS = 256  # threads per CTA
# pairs per item at most: occupied pairs in lane (435 -> 3 bands of 145),
# virtual pairs in rowrow (45 -> 3 bands of 15); the fastest of the band
# sizes timed at the flagship's shapes
BAND_MAX = {"lane": 160, "rowrow": 15}
SMEM_MAX = 48 * 1024  # shared memory of one CTA
ITEMS_MAX = 2**31 - 1  # CTAs of one launch
# (hpair dtype, index dtype) -> the C entry point's (f64, idx64) flags
_FLAGS = {(torch.float32, torch.int32): (0, 0), (torch.float32, torch.int64): (0, 1),
          (torch.float64, torch.int32): (1, 0), (torch.float64, torch.int64): (1, 1)}
_ENTRY: dict = {}  # C entry point name -> bound ctypes function
_HT: dict = {}  # id(hpair) -> (a weak reference to hpair, its version, hpair^T)


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


def band_smem(n_u: int, n_v: int, band: int, itemsize: int, variant: str) -> int:
    """Shared memory of one CTA in bytes, as the kernel lays it out: the
    int32 indices padded to 16 bytes (rowrow: the band's virtual pairs
    and all n_u occupied ones; lane: all n_v virtual pairs and the band's
    occupied ones), then in lane the tile of band·n_v values behind a
    shift of up to 16/itemsize − 1 values."""
    if variant == "rowrow":
        return -(-(n_u + band) * 4 // 16) * 16
    return -(-(n_v + band) * 4 // 16) * 16 + (band * n_v + 16 // itemsize - 1) * itemsize


@functools.lru_cache(maxsize=64)
def pair_select_launch_shape(B: int, n_u: int, n_v: int, itemsize: int = 4,
                             variant: str = "lane") -> dict:
    """How the kernel launches for W [B, n_u, n_v] of ``itemsize``-byte
    values: ``bands`` bands of ``band`` pairs (occupied pairs in lane,
    virtual pairs in rowrow) that split their span evenly, each at most
    ``BAND_MAX[variant]`` and small enough that one CTA's shared memory
    (``smem_bytes``) stays within ``SMEM_MAX``; one CTA of ``threads``
    threads per item, ``items`` = B·bands.  Cached: the same dict for the
    same arguments, not to be changed."""
    _check_variant(variant)
    span = n_v if variant == "rowrow" else n_u
    band_max = BAND_MAX[variant]
    while band_max > 0 and band_smem(n_u, n_v, band_max, itemsize, variant) > SMEM_MAX:
        band_max -= 1
    if band_max == 0:
        raise ValueError(f"{n_u} occupied and {n_v} virtual pairs exceed the kernel's shared "
                         f"memory")
    bands = -(-span // band_max) if span > 0 else 0
    band = -(-span // bands) if bands else 1
    if B * bands > ITEMS_MAX:
        raise ValueError(f"{B * bands} work items exceed one launch")
    return {"band": band, "bands": bands, "items": B * bands, "threads": THREADS,
            "smem_bytes": band_smem(n_u, n_v, band, itemsize, variant)}


def build_kernel() -> str:
    """Compile csrc/pair_select.cu for sm_90a into ``build/`` (once per
    source version) and return the library path."""
    return cuda_build.build_library("pair_select")


def _bind(so):
    P, I = ctypes.c_void_p, ctypes.c_int
    so.pair_select.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, P]
    so.pair_select.restype = I
    so.pair_select_gather.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    so.pair_select_gather.restype = I


def _entry(name):
    """The library's C entry point ``name``, bound once."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = _ENTRY[name] = getattr(cuda_build.load_library("pair_select", _bind), name)
    return fn


def _operands(po, pv, hpair, variant):
    """Check what the kernels take and allocate W: (W, B, n_u, n_v, npair,
    f64, idx64, device index).  Raises ValueError on a
    shape, dtype, device or layout the kernels do not take."""
    if hpair.dim() != 2 or po.dim() != 2 or pv.dim() != 2:
        raise ValueError("po, pv and hpair must be 2-d")
    B, n_u = po.shape
    Bv, n_v = pv.shape
    npair = hpair.shape[0]
    if hpair.shape[1] != npair or Bv != B:
        raise ValueError(f"need hpair [npair, npair], po [B, n_u], pv [B, n_v]: got "
                         f"{tuple(hpair.shape)}, {tuple(po.shape)}, {tuple(pv.shape)}")
    flags = _FLAGS.get((hpair.dtype, po.dtype))
    if flags is None or pv.dtype != po.dtype:
        raise ValueError(f"need f32/f64 hpair and int32/int64 po, pv of one dtype: got "
                         f"{hpair.dtype}, {po.dtype}, {pv.dtype}")
    d = hpair.get_device()
    if po.get_device() != d or pv.get_device() != d:
        raise ValueError(f"po and pv must be on {hpair.device}")
    if not (hpair.is_contiguous() and po.is_contiguous() and pv.is_contiguous()):
        raise ValueError("po, pv and hpair must be contiguous")
    # rowrow: W [B, n_u, n_v] laid out as [B, n_v, n_u], the kernel's layout
    out = (hpair.new_empty_strided((B, n_u, n_v), (n_u * n_v, 1, n_u)) if variant == "rowrow"
           else hpair.new_empty((B, n_u, n_v)))
    return out, B, n_u, n_v, npair, *flags, d


def _transposed(hpair):
    """hpair^T, contiguous: the band kernel's operand, made once per hpair
    tensor (again after an in-place change) on the stream of that call."""
    key = id(hpair)
    hit = _HT.get(key)
    if hit is None or hit[0]() is not hpair or hit[1] != hpair._version:
        hit = _HT[key] = (weakref.ref(hpair, lambda _: _HT.pop(key, None)), hpair._version,
                          hpair.t().contiguous())
    return hit[2]


def _launch(po, pv, hpair, variant):
    out, B, n_u, n_v, npair, f64, idx64, d = _operands(po, pv, hpair, variant)
    if out.numel() > 0:
        sh = pair_select_launch_shape(B, n_u, n_v, out.element_size(), variant)
        err = _entry("pair_select")(
            po.data_ptr(), pv.data_ptr(), _transposed(hpair).data_ptr(), out.data_ptr(), B, n_u,
            n_v, npair, idx64, f64, variant == "rowrow", sh["band"],
            torch._C._cuda_getCurrentRawStream(d))
        check_launch(err, f"pair_select ({variant})")
        LAUNCHES[variant].n += 1
    return out


def _launch_gather(po, pv, hpair, variant):
    """The earlier kernel (one block per sample and 1024 outputs, reading
    hpair itself), for timing it beside the band kernel on the same
    operands.  Not reachable from ``pair_select_w``; counts no launch."""
    out, B, n_u, n_v, npair, f64, idx64, d = _operands(po, pv, hpair, variant)
    if out.numel() > 0:
        err = _entry("pair_select_gather")(
            po.data_ptr(), pv.data_ptr(), hpair.data_ptr(), out.data_ptr(), B, n_u, n_v, npair,
            idx64, f64, variant == "rowrow", torch._C._cuda_getCurrentRawStream(d))
        check_launch(err, f"pair_select_gather ({variant})")
    return out


def pair_select_w(po: torch.Tensor, pv: torch.Tensor, hpair: torch.Tensor, *,
                  variant: str = "lane") -> torch.Tensor:
    """W[b, u, v] = hpair[po[b, u], pv[b, v]] for any hpair [npair, npair].

    po [B, n_u], pv [B, n_v] int32 or int64 (values in [0, npair); the
    kernel writes NaN for one outside), hpair f32 or f64.  Returns
    [B, n_u, n_v] in hpair's dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    _check_variant(variant)
    if hpair.is_cuda:
        return _launch(po, pv, hpair, variant)
    if hpair.device.type == "cpu":
        return pair_select_w_plain(po, pv, hpair, variant=variant)
    raise ValueError(f"unsupported device {hpair.device}")
