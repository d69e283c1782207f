"""The orbital utilities against the JAX package, on the CPU:
``utils/graph`` (``fiedler_order``, ``greedy_order`` and ``load_graphml``,
read with the standard library, on a DAG whose topological order is not
unique, against networkx's ``topological_sort`` order) and
``utils/orbitals`` (``freeze_core`` within 1e-12; ``localize_er`` on 5
orbitals: the ER functional within 1e-10 and the transformed integrals
within 1e-7, after the same numpy start draw and backtracking).  The two
packages' matrix exponentials differ in the last bits, and near the
optimum the backtracking's float comparisons can accept a step in one
that the other rejects: a move of about 1e-8 in U along a direction in
which the functional is flat to 1e-16, measured on this case.  So the
step count is not held."""

import numpy as np
import pytest

from pynqs_tpu.utils import graph as jgraph
from pynqs_tpu.utils import orbitals as jorb

from pynqs_tpu_torch.utils import graph, orbitals


def _weights(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, n))
    w = (w + w.T) / 2
    np.fill_diagonal(w, 0)
    return w


def test_orderings_equal_jax():
    for n, seed in ((8, 0), (12, 1), (20, 2)):
        w = _weights(n, seed)
        assert [int(i) for i in graph.fiedler_order(w)] == [int(i) for i in jgraph.fiedler_order(w)]
        assert graph.greedy_order(w) == jgraph.greedy_order(w)
        assert graph.greedy_order(w, start=3) == jgraph.greedy_order(w, start=3)
    tie = np.ones((5, 5)) - np.eye(5)  # every candidate ties
    assert graph.greedy_order(tie) == jgraph.greedy_order(tie)


GRAPHML = """<?xml version='1.0' encoding='utf-8'?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns"
         xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance">
  <key id="d0" for="edge" attr.name="weight" attr.type="double"/>
  <graph edgedefault="directed">
{body}
  </graph>
</graphml>
"""


@pytest.mark.parametrize("seed", [0, 1])
def test_load_graphml_equals_networkx_order(tmp_path, seed):
    """Nodes in a shuffled document order (one declared only by an edge),
    several sources: the visiting order is not unique, and both readers
    give the same (order, preds).  (A repeated edge makes networkx read a
    multigraph, whose 3-tuple edges the JAX reader cannot unpack.)"""
    rng = np.random.default_rng(seed)
    n = 9
    topo = list(rng.permutation(n))
    edges = []
    for t in range(1, n):
        k = max(int(rng.integers(0, 3)), int(t == n - 1))  # the last node has an edge
        for s in rng.choice(t, size=min(t, k), replace=False):
            edges.append((int(topo[s]), int(topo[t])))
    nodes = [v for v in rng.permutation(n) if v != topo[-1]]
    body = "\n".join([f'    <node id="{v}"/>' for v in nodes] + [
        f'    <edge source="{u}" target="{v}"><data key="d0">{rng.random():.3f}</data></edge>'
        for u, v in edges])
    path = tmp_path / "orbitals.graphml"
    path.write_text(GRAPHML.format(body=body))
    order, preds = graph.load_graphml(str(path))
    jorder, jpreds = jgraph.load_graphml(str(path))
    assert [int(v) for v in order] == [int(v) for v in jorder]
    assert [[int(p) for p in ps] for ps in preds] == [[int(p) for p in ps] for ps in jpreds]
    assert sorted(order) == list(range(n))


def _spatial(n, seed):
    """Seeded real integrals with the 8-fold symmetry of (pq|rs)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n))
    h = (h + h.T) / 2
    eri = rng.standard_normal((n, n, n, n)) * 0.1
    for perm in ((1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 0, 1)):
        eri = (eri + eri.transpose(perm)) / 2
    return h, eri


def test_freeze_core_equals_jax():
    h, eri = _spatial(6, 0)
    for nf in (0, 1, 2):
        got = orbitals.freeze_core(h, eri, 0.7, nf)
        want = jorb.freeze_core(h, eri, 0.7, nf)
        np.testing.assert_allclose(got[0], want[0], atol=1e-12, rtol=0)
        np.testing.assert_allclose(got[1], want[1], atol=1e-12, rtol=0)
        assert abs(got[2] - want[2]) < 1e-12


def test_localize_er_equals_jax():
    h, eri = _spatial(5, 1)
    h_l, eri_l, U = orbitals.localize_er(h, eri, n_iter=60)
    jh, jeri, jU = jorb.localize_er(h, eri, n_iter=60)

    def functional(e):
        return float(sum(e[i, i, i, i] for i in range(e.shape[0])))

    assert abs(functional(eri_l) - functional(jeri)) < 1e-10
    assert functional(eri_l) > functional(eri)  # it localized
    np.testing.assert_allclose(U @ U.T, np.eye(5), atol=1e-12, rtol=0)
    np.testing.assert_allclose(h_l, jh, atol=1e-7, rtol=0)
    np.testing.assert_allclose(eri_l, jeri, atol=1e-7, rtol=0)
