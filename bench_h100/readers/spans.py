"""Readings of the program's own tracing: the launch calls the host made
inside a named range of the trace, and kernel #1's distinct-row share
from the fused forward's counters.

``launches`` reads the events of ``profile.events_of``.  ``distinct_pct``
reads ``pynqs_tpu_torch.ops.fused_rnn.ROWS`` and ``DISTINCT``, which count
only while a profiler records, so over the traced window alone; a
program without them gives None.
"""

from __future__ import annotations

import bisect

__all__ = ["LAUNCH_CALLS", "launches", "distinct_pct"]

# the CUDA runtime and driver calls that put work on the device's queue
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cudaMemcpyAsync", "cudaMemsetAsync"))


def launches(events, work, *, range: str):
    """Launch calls per step made inside the host intervals of the range
    ``range``; None where the range never ran."""
    spans = sorted((e[2], e[2] + e[3]) for e in events if e[0] == "cpu_range" and e[1] == range)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for e in events:
        if e[0] == "cpu_op" and e[1] in LAUNCH_CALLS:
            i = bisect.bisect_right(starts, e[2]) - 1
            n += i >= 0 and e[2] < spans[i][1]
    return n / work["steps"]


def distinct_pct(events, work):
    """100 x the distinct rows over the rows that the fused forward was
    handed while the trace recorded; None where it was handed none."""
    from pynqs_tpu_torch.ops import fused_rnn

    rows, distinct = getattr(fused_rnn, "ROWS", None), getattr(fused_rnn, "DISTINCT", None)
    if rows is None or distinct is None or not int(rows.n):
        return None
    return 100.0 * int(distinct.n) / int(rows.n)
