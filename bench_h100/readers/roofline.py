"""Operation counts of kernel #1 (the fused Graph-MPS-RNN forward), the
H100's peaks, and the roofline and MFU arithmetic.

The counts are a frozen copy of ``chip_smoke.py``'s ``flop_per_site``
and ``bound``: per row and site, the complex transition of the 4 values
([2 npred d] x [4 2d], 2 FLOP per multiply-add), the tensor coupling at 2
or more predecessors, the bias, square and eta-weighted sums and the
phase readout.  A chain counts one predecessor at every site, as
``chip_smoke.py`` did; a DAG built with ``max_preds`` has 0, 1, then
``max_preds`` predecessors.  Peaks: NVIDIA's H100 SXM data sheet, dense.
"""

from __future__ import annotations

__all__ = ["BF16_FLOPS", "HBM_BYTES", "flop_per_site", "row_flop", "bound_s", "roofline_pct",
           "mfu_pct"]

BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
HBM_BYTES = 3.35e12  # HBM3 bytes/s


def flop_per_site(d: int, npred: int, dc: int = 0) -> int:
    O = 2 * d
    fl = 2 * 4 * O * (2 * npred * d) + 3 * 4 * O + 4 * O
    if dc and npred >= 2:
        fl += 4 * dc * npred * d * 8 + 6 * (npred - 1) * 4 * dc + 4 * O * dc * 4
    return fl


def row_flop(d: int, norb: int, max_preds: int, dc: int = 0) -> int:
    """FLOP of one row of kernel #1 over all sites."""
    if max_preds <= 1:
        return norb * flop_per_site(d, 1)
    return sum(flop_per_site(d, min(t, max_preds), dc) for t in range(norb))


def bound_s(flop: float, nbytes: float) -> float:
    """The least time of the work on one H100: the larger of its
    operations over the bf16 peak and its bytes over HBM's."""
    return max(flop / BF16_FLOPS, nbytes / HBM_BYTES)


def roofline_pct(events, work, *, kernel: str, flop: str, bytes: str):
    """100 x bound / the summed device time of the kernels matching
    ``kernel``; None where the trace has none."""
    from bench_h100.readers.profile import kernel_s
    t = kernel_s(events, kernel)
    if not t:
        return None
    return 100.0 * bound_s(work[flop], work[bytes]) / t


def mfu_pct(events, work, *, flop: str):
    """100 x the counted model FLOP / (window x bf16 peak) of the
    untraced window where the run has one (the profiler slows a
    host-bound step), else of the traced one."""
    work = work.get("untraced", work)
    if not work.get(flop):
        return None
    return 100.0 * work[flop] / (work["window_s"] * BF16_FLOPS)
