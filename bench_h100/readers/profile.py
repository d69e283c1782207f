"""Readings of a ``torch.profiler`` trace of the window: the time of a
named range per step, the device time of kernels by name, the device's
busy and idle time, and the breakdown of device operations and idle gaps.

``events_of`` turns the profiler's Kineto events into tuples
(kind, name, start_us, dur_us), kind one of "kernel", "gpu_mem",
"gpu_range" (a ``record_function`` range as the device saw it),
"cpu_range" and "cpu_op".
"""

from __future__ import annotations

import bisect
import contextlib
import re

__all__ = ["traced", "events_of", "range_ms", "kernel_s", "busy_s", "idle_pct", "breakdown"]

_KIND = {"kernel": "kernel", "gpu_memcpy": "gpu_mem", "gpu_memset": "gpu_mem",
         "gpu_user_annotation": "gpu_range", "user_annotation": "cpu_range",
         "cpu_op": "cpu_op", "python_function": "cpu_op"}


def _us(e, what):
    ns = getattr(e, f"{what}_ns", None)
    return ns() / 1e3 if ns is not None else getattr(e, f"{what}_us")()


def _kind(e) -> str:
    act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
    act = act.rsplit(".", 1)[-1]
    if act in _KIND:
        return _KIND[act]
    on_device = "CUDA" in str(e.device_type())
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if on_device:
        if annotation:
            return "gpu_range"
        return "gpu_mem" if e.name().startswith(("Memcpy", "Memset")) else "kernel"
    return "cpu_range" if annotation else "cpu_op"


@contextlib.contextmanager
def traced(dev):
    """A ``torch.profiler`` window over the device's activity and the
    program's ``record_function`` ranges.  On the host it records the
    ranges alone (the user scope), not every operator, which would slow a
    host-bound step by a third; where this torch has no such option it
    records every operator, and says so."""
    import torch.autograd.profiler as ap
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    enable = ap._enable_profiler
    try:
        from torch._C._profiler import RecordScope
        scopes = {RecordScope.USER_SCOPE}
    except ImportError:
        scopes = None

    def ranges_only(config, activities, *rest):
        try:
            return enable(config, activities, scopes)
        except TypeError:
            print("[trace] this torch records every host operator", flush=True)
            return enable(config, activities, *rest)

    if scopes is not None:
        ap._enable_profiler = ranges_only
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        ap._enable_profiler = enable


def events_of(prof) -> list:
    """(kind, name, start_us, dur_us) of every event of the trace."""
    raw = prof.profiler.kineto_results.events()
    out = [(_kind(e), e.name(), _us(e, "start"), _us(e, "duration")) for e in raw]
    if not out:  # the function events, where the Kineto list comes back empty
        for fe in prof.events():
            dev = "CUDA" in str(fe.device_type)
            ann = bool(getattr(fe, "is_user_annotation", False))
            kind = ("gpu_range" if ann else "kernel") if dev else (
                "cpu_range" if ann else "cpu_op")
            out.append((kind, fe.name, fe.time_range.start, fe.time_range.elapsed_us()))
    counts: dict = {}
    for e in out:
        counts[e[0]] = counts.get(e[0], 0) + 1
    print(f"[trace] {len(raw)} Kineto events; by kind {counts}", flush=True)
    return out


def range_ms(events, work, *, range: str):
    """Milliseconds per step in the range ``range``: its device span where
    the trace has one, else its host span; None where it never ran."""
    for kind in ("gpu_range", "cpu_range"):
        d = [e[3] for e in events if e[0] == kind and e[1] == range]
        if d:
            return sum(d) / 1e3 / work["steps"]
    return None


def kernel_s(events, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(e[3] for e in events if e[0] == "kernel" and rx.search(e[1])) / 1e6


def _merged(events):
    iv = sorted((e[2], e[2] + e[3]) for e in events if e[0] in ("kernel", "gpu_mem"))
    out = []
    for s, t in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(events) -> float:
    """Seconds in which an operation ran on the device (the union of the
    kernel, copy and set intervals)."""
    return sum(t - s for s, t in _merged(events)) / 1e6


def idle_pct(events, work):
    if not any(e[0] == "kernel" for e in events):
        return None
    return 100.0 * (1.0 - busy_s(events) / work["window_s"])


def _outermost(spans):
    """The spans (start, end, name) not inside another, sorted by start."""
    out = []
    for sp in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not out or sp[0] >= out[-1][1]:
            out.append(sp)
    return out


def _at(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return spans[i][2] if i >= 0 and t < spans[i][1] else None


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    idle gaps between device operations summed by what the host was in at
    the gap's start: the range there (the program's ranges do not nest),
    else the outermost operator there."""
    ops: dict = {}
    for e in events:
        if e[0] in ("kernel", "gpu_mem"):
            ops[e[1][:160]] = ops.get(e[1][:160], 0.0) + e[3] / 1e6
    iv = _merged(events)
    ranges = _outermost([(e[2], e[2] + e[3], e[1]) for e in events if e[0] == "cpu_range"])
    cpu = _outermost([(e[2], e[2] + e[3], e[1]) for e in events if e[0] == "cpu_op"])
    rs, cs = [r[0] for r in ranges], [c[0] for c in cpu]
    gaps: dict = {}
    for (_, t0), (t1, _) in zip(iv, iv[1:]):
        label = _at(ranges, rs, t0) or _at(cpu, cs, t0) or "host, no operator"
        gaps[label] = gaps.get(label, 0.0) + (t1 - t0) / 1e6
    best = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa
    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
