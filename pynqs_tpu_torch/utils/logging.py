"""Structured, parseable run logging + phase timing.

Counterpart (a copy) of ``pynqs_tpu/utils/logging.py``: both packages
write the same lines, so ``read_log`` parses either package's logs.

The reference's pervasive `time.time_ns()` phase spans and loguru sink
(utils/loggings.py, SURVEY.md §5 "the log itself is the profile") get
a structured contract here: every iteration emits one human line and
one machine-parseable `@@ {json}` line, and :class:`PhaseTimer`
accumulates per-phase wall times that `utils.log_helper.read_log`
parses back into arrays (the PyNQS_helper.py analog).
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager

__all__ = ["PhaseTimer", "RunLogger", "read_log"]


class PhaseTimer:
    def __init__(self):
        self.times: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def pop(self) -> dict[str, float]:
        t, self.times = self.times, {}
        return t


class RunLogger:
    def __init__(self, path: str | None = None, stream=None):
        self.stream = stream or sys.stdout
        self.fh = open(path, "a") if path else None

    def info(self, msg: str):
        line = f"[pynqs] {msg}"
        print(line, file=self.stream, flush=True)
        if self.fh:
            print(line, file=self.fh, flush=True)

    def record(self, **kv):
        """One machine-parseable record per iteration."""
        line = "@@ " + json.dumps(kv)
        print(line, file=self.stream, flush=True)
        if self.fh:
            print(line, file=self.fh, flush=True)

    def close(self):
        if self.fh:
            self.fh.close()


def read_log(path: str) -> list[dict]:
    """Parse `@@` records back (PyNQS_helper.read_time_from_log analog)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@@ "):
                out.append(json.loads(line[3:]))
    return out
