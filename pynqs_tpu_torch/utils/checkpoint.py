"""Parameter trees carried across from the JAX package.

The JAX package saves its parameters as a pickled dict of numpy arrays
(``pynqs_tpu/utils/checkpoint.py``); these functions read such a file
and turn the tree into torch tensors with the same key names, so a
checkpoint such as ``checkpoints/fe2s2_dcut48_final.pkl`` drives the
port unchanged.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["load_params", "params_from_numpy"]


def load_params(path: str) -> dict:
    """Read a pickled parameter tree (numpy leaves) written by the JAX
    package.  Unpickling runs code: read only the repository's files."""
    path = os.path.abspath(path)
    if not path.endswith(".pkl"):
        path += ".pkl"
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return {k: np.asarray(v) for k, v in tree.items()}


def params_from_numpy(tree: dict, device="cuda", dtype=torch.float32) -> dict:
    """numpy tree -> dict of tensors on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.asarray(v), device=dev).to(dtype)
        for k, v in tree.items()
    }
