"""Reading of the fused forward's dedup counter: the share of the rows
handed to the fused forward that kernel #1 ran on.

``evaluated_pct`` reads ``pynqs_tpu_torch.ops.fused_rnn.ROWS`` and
``EVALUATED``, which count only while a profiler records, so over the
traced window alone; a program without them gives None.
"""

from __future__ import annotations

__all__ = ["evaluated_pct"]


def evaluated_pct(events, work):
    """100 x the rows the fused forward ran on over the rows it was handed
    while the trace recorded; None where it was handed none."""
    from pynqs_tpu_torch.ops import fused_rnn

    rows, evaluated = getattr(fused_rnn, "ROWS", None), getattr(fused_rnn, "EVALUATED", None)
    if rows is None or evaluated is None or not int(rows.n):
        return None
    return 100.0 * int(evaluated.n) / int(rows.n)
