"""Run-reproducibility helpers.

Counterpart of ``pynqs_tpu/utils/tools.py`` (``repro_header``,
``dump_input``): the header names the port's git commit, Python, torch,
its CUDA, and the card's name and count.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
import time

import torch

__all__ = ["repro_header", "dump_input"]


def repro_header() -> str:
    """Platform / torch / CUDA / card / git header for run logs."""
    try:
        git = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except OSError:
        git = "unknown"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    card = torch.cuda.get_device_name(0) if n else "none"
    lines = [
        f"pynqs_tpu_torch git={git}",
        f"python {sys.version.split()[0]} on {platform.platform()}",
        f"torch {torch.__version__} cuda={torch.version.cuda} cards={n} card={card}",
        f"started {time.strftime('%Y-%m-%d %H:%M:%S')}",
    ]
    return "\n".join(lines)


def dump_input(logger=None, script_path: str | None = None):
    """Log the header and (optionally) the full input script."""
    out = repro_header()
    if script_path is None and sys.argv and os.path.exists(sys.argv[0]):
        script_path = sys.argv[0]
    if script_path and os.path.exists(script_path):
        with open(script_path) as f:
            out += "\n----- input script -----\n" + f.read()
    if logger is not None:
        logger.info(out)
    else:
        print(out)
    return out
