"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a missing card raises instead of quietly
continuing on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "model_device_dtype"]


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def model_device_dtype(model) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) of a model's first floating parameter: where its
    samples live and the float type of its Hamiltonian arithmetic."""
    for p in model.parameters():
        if p.is_floating_point():
            return p.device, p.dtype
    raise ValueError(f"{type(model).__name__} has no floating parameter")
