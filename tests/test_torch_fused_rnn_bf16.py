"""The fused forward's plain version against the JAX Pallas kernel (interpret
mode): the tensor coupling with an extra predecessor, the bf16 matmul mode
on a chain and a DAG, and the tables' dtype."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.utils import fci
from pynqs_tpu.utils.graph import dag_from_order

from pynqs_tpu_torch.models.graph_mps_rnn import graph_from_edges, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn

from test_torch_fused_rnn import TOL, _check, _pair


def test_plain_matches_pallas_tensor_extra_pred_chain():
    rng = np.random.default_rng(0)
    w = np.abs(rng.standard_normal((6, 6)))
    g = dag_from_order(list(range(6)), w, max_preds=3)
    order, preds = g
    edges = [(p, order[t]) for t, ps in enumerate(preds) for p in ps]
    tg = graph_from_edges(6, edges, list(order))
    jm, p, tm = _pair(12, 3, 8, 5, graph=tg, jgraph=g, use_tensor=True, dcut_cmpr=4,
                      phase_mode="linear", norm_mode="unit")
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:64])


@pytest.mark.parametrize("graph", ["chain", "dag"])
def test_plain_bf16_matches_pallas_bf16(graph):
    """bf16 mode: W and h rounded to bf16 at the same points, f32 sums."""
    kw = dict(graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2)) if graph == "dag" else {}
    jm, p, tm = _pair(12, 3, 8, 6, phase_mode="arg", norm_mode="mpsrnn", **kw)
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:100], mm=torch.bfloat16,
           jmm=jnp.bfloat16, tol=1e-4)


@pytest.mark.parametrize("mm", [torch.float32, torch.bfloat16])
def test_plain_follows_the_tables_dtype(mm):
    """f64 tables: the same rounding points with f64 sums, the reference
    against which the card's comparisons measure how far summation order
    alone moves a row."""
    jm, p, tm = _pair(12, 3, 8, 4, graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2),
                      use_tensor=True, dcut_cmpr=4, phase_mode="arg", norm_mode="mpsrnn")
    bits = torch.as_tensor(fci.fci_bits(12, 3, 3)[:100])
    tables = fused_rnn.pack_tables(tm)
    out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(tm, bits, matmul_dtype=mm, tables=tables)
    out64 = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
        tm, bits, matmul_dtype=mm, tables={k: v.double() for k, v in tables.items()})
    assert out64.dtype == torch.float64 and out64.shape == out.shape
    tol = TOL if mm == torch.float32 else 1e-4
    np.testing.assert_allclose(out64[:, 0].numpy(), out[:, 0].numpy(), atol=tol, rtol=0)
    d = np.abs(np.exp(1j * out64[:, 1].numpy()) - np.exp(1j * out[:, 1].numpy()))
    assert d.max() < 10 * tol, d.max()
