"""Structured, parseable run logging.

Counterpart (a copy) of ``pynqs_tpu/utils/logging.py``, without its
``PhaseTimer``: both packages write the same lines, so ``read_log``
parses either package's logs.

Every logged iteration emits one human line and one machine-parseable
``@@ {json}`` record, which ``read_log`` parses back (the
PyNQS_helper.py analog).  Where the time of a step goes is not logged
here: the port's stages and layers are ``torch.profiler`` ranges
(``VMCConfig.profile_dir`` traces them).
"""

from __future__ import annotations

import json
import sys

__all__ = ["RunLogger", "read_log"]


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
