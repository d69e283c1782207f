"""DAG topology for Graph-MPS-RNN from orbital exchange weights.

Counterpart of ``pynqs_tpu/utils/graph.py`` (``exchange_matrix``,
``dag_from_order``), kept as plain numpy.  The exchange weight
K_ij = ⟨ij|ji⟩ measures how strongly two spatial orbitals couple;
extra predecessor edges go to the most strongly coupled earlier sites.
"""

from __future__ import annotations

import numpy as np

from pynqs_tpu_torch.models.graph_mps_rnn import graph_from_edges
from pynqs_tpu_torch.ops.integrals import h2e_element

__all__ = ["exchange_matrix", "dag_from_order"]


def exchange_matrix(h2e_compressed: np.ndarray, sorb: int) -> np.ndarray:
    """Spatial-orbital exchange weights |K_ij| from spin integrals:
    |<(2i+s)(2j+s')||(2j+s')(2i+s)>| summed over the spin channels,
    zero on the diagonal."""
    norb = sorb // 2
    K = np.zeros((norb, norb))
    idx = np.arange(norb)
    for si in (0, 1):
        for sj in (0, 1):
            p = 2 * idx[:, None] + si
            q = 2 * idx[None, :] + sj
            K += np.abs(h2e_element(h2e_compressed, p, q, q, p))
    np.fill_diagonal(K, 0.0)
    return K


def dag_from_order(order, weights: np.ndarray | None = None, max_preds: int = 2):
    """Chain DAG along ``order``, plus up to ``max_preds - 1`` extra
    predecessor edges per site to the earlier sites of largest |weight|
    (ties to the larger site index).  Returns (order, preds)."""
    n = len(order)
    edges = [(order[t - 1], order[t]) for t in range(1, n)]
    if weights is not None and max_preds > 1:
        w = np.abs(weights)
        for t in range(2, n):
            v = order[t]
            cands = sorted(((w[u, v], u) for u in order[: t - 1]), reverse=True)
            added = 0
            for _, u in cands:
                if added >= max_preds - 1:
                    break
                if (u, v) not in edges:
                    edges.append((u, v))
                    added += 1
    return graph_from_edges(n, edges, list(order))
