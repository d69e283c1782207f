"""Device-memory accounting.

Counterpart of ``pynqs_tpu/utils/memory.py`` (``device_memory_stats``,
``MemoryTrack``, ``auto_eloc_batch``) on PyTorch's CUDA allocator: JAX's
``bytes_in_use`` is ``torch.cuda.memory_allocated``,
``peak_bytes_in_use`` is ``torch.cuda.max_memory_allocated``, and
``bytes_limit`` is what this process could hold, the device's free
memory (``torch.cuda.mem_get_info``) plus what the caching allocator
already reserved, so that ``bytes_limit - bytes_in_use`` is the memory
left to allocate.  On the CPU there are no stats (``{}``), as on a JAX
CPU device, and ``auto_eloc_batch`` takes its 4 GiB default.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["device_memory_stats", "MemoryTrack", "auto_eloc_batch"]


def device_memory_stats(device=None) -> dict:
    """{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} of a CUDA
    device (default the current one when a card is present), or {}."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return {}
    free, _total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_limit": free + torch.cuda.memory_reserved(dev),
    }


@contextmanager
def MemoryTrack(tag: str = "", logger=None, device=None):
    """Log the bytes-in-use change and the peak around a block."""
    before = device_memory_stats(device)
    yield
    after = device_memory_stats(device)
    if after:
        used = after.get("bytes_in_use", 0) - before.get("bytes_in_use", 0)
        peak = after.get("peak_bytes_in_use", 0)
        msg = f"[mem:{tag}] Δ={used / 2**20:.1f} MiB peak={peak / 2**20:.1f} MiB"
        (logger.info if logger else print)(msg)


def auto_eloc_batch(
    n_samples: int,
    n_sd: int,
    sorb: int,
    bytes_per_elem: int = 4,
    budget_bytes: int | None = None,
    device=None,
) -> int:
    """Largest power-of-two eloc chunk whose connected-space buffers
    ([chunk, 1 + n_sd, sorb] bits + Hij + ψ pairs) fit in the budget
    (default 60% of the memory left on the device when there are stats,
    else 4 GiB), at most ``n_samples``."""
    if budget_bytes is None:
        stats = device_memory_stats(device)
        limit = stats.get("bytes_limit")
        used = stats.get("bytes_in_use", 0)
        budget_bytes = int(0.6 * (limit - used)) if limit else 4 << 30
    per_sample = (1 + n_sd) * (sorb + 3 * bytes_per_elem + 2 * bytes_per_elem)
    chunk = max(1, budget_bytes // max(per_sample, 1))
    chunk = 1 << (int(chunk).bit_length() - 1)
    return int(min(chunk, n_samples))
