"""Flagship model builders: the chain and the structured Graph-MPS-RNN.

Counterpart of ``pynqs_tpu/utils/flagship.py``.  The structured variant
adds to the identity chain the max-|K| exchange edges of the system's
integrals (up to ``max_preds`` predecessors per site) and, with
``use_tensor``, the compressed tensor coupling; every caller that loads
a structured checkpoint rebuilds the same graph from the same integrals.
``fe2s2_system()`` is not ported: the Fe2S2 integrals are not in the
repository.  The builders take any ``System``.
"""

from __future__ import annotations

import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.utils.checkpoint import load_params
from pynqs_tpu_torch.utils.graph import dag_from_order, exchange_matrix

__all__ = ["flagship_graph", "flagship_model", "load_flagship_params"]


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
