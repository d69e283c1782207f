"""Flagship model builders: the chain and the structured Graph-MPS-RNN.

Counterpart of ``pynqs_tpu/utils/flagship.py``.  The structured variant
adds to the identity chain the max-|K| exchange edges of the system's
integrals (up to ``max_preds`` predecessors per site) and, with
``use_tensor``, the compressed tensor coupling; every caller that loads
a structured checkpoint rebuilds the same graph from the same integrals.
The builders take any ``System``; ``fe2s2_system`` reads the flagship's
integrals, which the repository does not hold (the reference's
``example/Fe2S2/fe2s2-OO.pth``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.utils.checkpoint import load_params
from pynqs_tpu_torch.utils.graph import dag_from_order, exchange_matrix
from pynqs_tpu_torch.utils.system import System

__all__ = ["FE2S2_PTH", "FE2S2_FOCUS_PTH", "fe2s2_system", "flagship_graph", "flagship_model",
           "load_flagship_params"]

# the Fe2S2 integrals of the reference PyNQS checkout, expected beside
# this repository, or wherever PYNQS_FE2S2_PTH points
FE2S2_PTH = os.environ.get("PYNQS_FE2S2_PTH", os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "reference", "example", "Fe2S2", "fe2s2-OO.pth"))
# the converted FOCUS DMRG state (dcut 20) beside the integrals, or
# wherever PYNQS_FE2S2_FOCUS_PTH points
FE2S2_FOCUS_PTH = os.environ.get("PYNQS_FE2S2_FOCUS_PTH", os.path.join(
    os.path.dirname(FE2S2_PTH), "fe2s2-OO-dcut-20-focus-1e-8.pth"))


def fe2s2_system(dtype=np.float32) -> System:
    """The flagship Fe2S2 system (sorb 40, 15α/15β) from ``FE2S2_PTH``."""
    if not os.path.exists(FE2S2_PTH):
        raise FileNotFoundError(
            f"the Fe2S2 integrals are not at {FE2S2_PTH} (the reference's "
            "example/Fe2S2/fe2s2-OO.pth; set PYNQS_FE2S2_PTH, or pass a System)")
    return System.from_pth(FE2S2_PTH, dtype=dtype)


def flagship_graph(system, max_preds: int):
    """Identity site order plus the extra max-|K| exchange edges; None
    (the chain) for ``max_preds <= 1``."""
    if max_preds <= 1:
        return None
    Kx = exchange_matrix(system.h2e, system.sorb)
    return dag_from_order(list(range(system.sorb // 2)), Kx, max_preds=max_preds)


def flagship_model(system, dcut: int, *, use_tensor: bool = False, max_preds: int = 1,
                   dtype=torch.float32, device="cuda", generator=None) -> GraphMPSRNN:
    """The flagship ``GraphMPSRNN`` (arg phase, mpsrnn gauge) on ``system``."""
    return GraphMPSRNN(
        system.sorb, system.noa, system.nob, dcut=dcut,
        graph=flagship_graph(system, max_preds),
        phase_mode="arg", norm_mode="mpsrnn", use_tensor=use_tensor,
        dtype=dtype, device=device, generator=generator,
    )


def load_flagship_params(path: str) -> dict:
    """A flagship checkpoint's parameter tree: the structured runs save
    ``{"params": {...}}``, the chain runs the tree itself."""
    tree = load_params(path)
    return tree["params"] if "params" in tree else tree
