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


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_to_numpy(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return np.asarray(tree)


def load_params(path: str) -> dict:
    """Read a pickled tree written by the JAX package, keeping its
    nesting (a structured run's file holds ``{"params": {...}}``), with
    numpy leaves all the way down.  Unpickling runs code: read only the
    repository's files."""
    path = os.path.abspath(path)
    if not path.endswith(".pkl"):
        path += ".pkl"
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return _to_numpy(tree)


def params_from_numpy(tree: dict, device="cuda", dtype=torch.float32) -> dict:
    """numpy tree -> dict of tensors on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.asarray(v), device=dev).to(dtype)
        for k, v in tree.items()
    }
