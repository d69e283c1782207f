"""The fused forward: plain version against the JAX Pallas kernel (run in
interpret mode, f32 matmuls), the cases of tests/test_fused_rnn.py.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.fused_rnn import graph_mpsrnn_logpsi_fused as jfused
from pynqs_tpu.utils import fci
from pynqs_tpu.utils.graph import dag_from_order

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, graph_from_edges, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn

TOL = 1e-5  # both are f32 with the same rounding points; sums differ in order


def _pair(sorb, n, dcut, key, graph=None, jgraph=None, **kw):
    jm = JModel(sorb, n, n, dcut=dcut, dtype=jnp.float32, graph=jgraph, **kw)
    params = jm.init(jax.random.PRNGKey(key))
    tm = GraphMPSRNN(sorb, n, n, dcut=dcut, dtype=torch.float32, graph=graph,
                     device="cpu", **kw)
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


def _check(jm, params, tm, bits, mm=torch.float32, jmm=jnp.float32, tol=TOL):
    ref = np.asarray(jfused(jm, params, jnp.asarray(bits), interpret=True, matmul_dtype=jmm))
    out = fused_rnn.graph_mpsrnn_logpsi_fused(tm, torch.as_tensor(bits), matmul_dtype=mm)
    assert out.dtype == torch.float32 and out.shape == (bits.shape[0], 2)
    out = out.numpy()
    np.testing.assert_allclose(out[:, 0], ref[:, 0], atol=tol, rtol=0)
    d = np.abs(np.exp(1j * out[:, 1]) - np.exp(1j * ref[:, 1]))
    assert d.max() < 10 * tol, d.max()


@pytest.mark.parametrize("phase_mode", ["arg", "linear"])
@pytest.mark.parametrize("norm_mode", ["mpsrnn", "unit"])
def test_plain_matches_pallas_chain(phase_mode, norm_mode):
    jm, p, tm = _pair(12, 3, 10, 1, phase_mode=phase_mode, norm_mode=norm_mode)
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:333])


@pytest.mark.parametrize("dcut", [40, 50])
def test_plain_matches_pallas_large_dcut(dcut):
    jm, p, tm = _pair(8, 2, dcut, 7, phase_mode="arg", norm_mode="mpsrnn")
    _check(jm, p, tm, fci.fci_bits(8, 2, 2)[:60])


def test_plain_matches_pallas_dag():
    jm, p, tm = _pair(12, 3, 8, 2, graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2),
                      phase_mode="arg", norm_mode="mpsrnn")
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:100])


def test_plain_matches_pallas_zero_phase_readout_sites():
    """z = 0 must contribute phase 0 (DMRG imports zero all readouts but
    the last)."""
    jm, p, tm = _pair(12, 3, 6, 3, phase_mode="arg", norm_mode="mpsrnn")
    p = dict(p)
    for k in ("w_arg_re", "w_arg_im", "c_arg_re", "c_arg_im"):
        p[k] = p[k].at[:-1].set(0.0)
    tm.load_numpy_params({k: np.asarray(v) for k, v in p.items()})
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:64])


def test_plain_matches_pallas_tensor_coupling():
    jm, p, tm = _pair(12, 3, 8, 4, graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2),
                      use_tensor=True, dcut_cmpr=4, phase_mode="arg", norm_mode="mpsrnn")
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:100])


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


def test_cpu_rows_take_the_plain_version_and_count_no_launch():
    tm = GraphMPSRNN(8, 2, 2, dcut=4, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    bits = torch.as_tensor(fci.fci_bits(8, 2, 2))
    before = fused_rnn.LAUNCHES.n
    a = fused_rnn.graph_mpsrnn_logpsi_fused(tm, bits)
    b = fused_rnn.graph_mpsrnn_logpsi_fused_plain(tm, bits)
    assert torch.equal(a, b)
    assert fused_rnn.LAUNCHES.n == before

