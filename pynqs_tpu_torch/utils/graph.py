"""Orbital orderings and DAG topology for Graph-MPS-RNN.

Counterpart of ``pynqs_tpu/utils/graph.py`` (``exchange_matrix``,
``fiedler_order``, ``greedy_order``, ``load_graphml``,
``dag_from_order``), kept as plain numpy.  The exchange weight
K_ij = ⟨ij|ji⟩ measures how strongly two spatial orbitals couple;
orderings that keep strongly coupled orbitals adjacent need a smaller
bond dimension, and extra predecessor edges go to the most strongly
coupled earlier sites.  ``load_graphml`` reads GraphML with the standard
library (the JAX package reads it with networkx) and visits the sites in
networkx's ``topological_sort`` order.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from pynqs_tpu_torch.models.graph_mps_rnn import graph_from_edges
from pynqs_tpu_torch.ops.integrals import h2e_element

__all__ = ["exchange_matrix", "fiedler_order", "greedy_order", "load_graphml", "dag_from_order"]


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


def fiedler_order(weights: np.ndarray) -> list[int]:
    """Spatial orbitals ordered by the Fiedler vector (the eigenvector of
    the second-smallest eigenvalue) of the weighted graph Laplacian."""
    w = np.abs(weights)
    _, evecs = np.linalg.eigh(np.diag(w.sum(1)) - w)
    return list(np.argsort(evecs[:, 1]))


def greedy_order(weights: np.ndarray, start: int | None = None) -> list[int]:
    """Greedy max-weight path: from ``start`` (default the row of the
    largest |weight|), each next site is the unvisited one most strongly
    coupled to the last (ties to the larger index)."""
    w = np.abs(weights)
    n = w.shape[0]
    if start is None:
        start = int(np.unravel_index(np.argmax(w), w.shape)[0])
    order, used = [start], {start}
    while len(order) < n:
        last = order[-1]
        _, j = max((w[last, j], j) for j in range(n) if j not in used)
        order.append(j)
        used.add(j)
    return order


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def load_graphml(path: str):
    """A directed GraphML file (the reference's Fe2S2 example format) ->
    (order, preds) for ``GraphMPSRNN``.  Node ids are integer spatial
    orbitals.  The visiting order is networkx's ``topological_sort``:
    generations of in-degree-zero nodes, the first in document order of
    the nodes, each next one in the order its members' last incoming edge
    was taken, walking each generation's nodes in order and their
    successors in edge order."""
    graph = next(e for e in ET.parse(path).getroot().iter() if _local(e.tag) == "graph")
    if graph.get("edgedefault", "directed") != "directed":
        raise ValueError("load_graphml needs a directed graph")
    nodes, succ = [], {}

    def add(v):
        if v not in succ:
            nodes.append(v)
            succ[v] = []

    for e in graph:
        if _local(e.tag) == "node":
            add(int(e.get("id")))
        elif _local(e.tag) == "edge":
            u, v = int(e.get("source")), int(e.get("target"))
            add(u)
            add(v)
            if v not in succ[u]:  # a DiGraph keeps one edge per pair
                succ[u].append(v)
    indeg = {v: 0 for v in nodes}
    for u in nodes:
        for v in succ[u]:
            indeg[v] += 1
    gen, order = [v for v in nodes if indeg[v] == 0], []
    while gen:
        order += gen
        nxt = []
        for u in gen:
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
        gen = nxt
    if len(order) != len(nodes):
        raise ValueError("the graph has a cycle")
    # networkx lists the edges source by source in node order
    edges = [(u, v) for u in nodes for v in succ[u]]
    return graph_from_edges(len(nodes), edges, order)


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
