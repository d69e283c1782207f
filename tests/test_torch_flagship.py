"""The structured flagship: graph builders, checkpoint loading and the
r5g64 model (dcut 64, tensor coupling, 2 predecessors) against the JAX
package.

The Fe2S2 integrals are not in the repository, so the graph is built on
seeded stand-in integrals of the Fe2S2 shape (sorb 40, 15α/15β).  The
trained checkpoint's parameter shapes depend only on the predecessor
count, so its weights load on the stand-in graph.  Tolerances: graphs
and loaded trees are exact; log ψ in f32 on both sides, 1e-4 on log|ψ|
and 1e-3 on the unit-circle phase (20 sites of dcut-64 sums in another
order); the plain fused forward against the Pallas kernel 1e-5 (f32)
and 1e-4 (bf16), as tests/test_torch_fused_rnn.py."""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops.fused_rnn import graph_mpsrnn_logpsi_fused as jfused
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci
from pynqs_tpu.utils import flagship as jflag
from pynqs_tpu.utils import graph as jgraph

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils import checkpoint, flagship, graph
from pynqs_tpu_torch.utils.system import System

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")


def _stand_in(sorb, noa, nob, seed=0):
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(sorb)) * 0.01
    return (JSystem.from_integrals(h1e, h2e, sorb, noa, nob),
            System.from_integrals(h1e, h2e, sorb, noa, nob))


@pytest.mark.parametrize("max_preds", [1, 2, 3])
def test_graph_builders_match_jax(max_preds):
    js, ts = _stand_in(40, 15, 15)
    np.testing.assert_array_equal(graph.exchange_matrix(ts.h2e, 40),
                                  jgraph.exchange_matrix(np.asarray(js.h2e), 40))
    rng = np.random.default_rng(4)
    order = list(rng.permutation(9))
    w = rng.standard_normal((9, 9))
    assert graph.dag_from_order(order, w, max_preds) == tuple(
        jgraph.dag_from_order(order, w, max_preds))
    want = jflag.flagship_graph(js, max_preds)
    got = flagship.flagship_graph(ts, max_preds)
    if max_preds == 1:
        assert want is None and got is None
        return
    assert got[0] == list(want[0]) and got[1] == [list(p) for p in want[1]]
    assert max(len(p) for p in got[1]) == max_preds


def test_load_params_keeps_nesting_and_leaves_flat_files_as_before():
    """The structured files hold {"params": {...}}: the nesting is kept
    with numpy leaves; the chain file loads exactly as the raw pickle."""
    nested = checkpoint.load_params(os.path.join(CKPT, "fe2s2_r3_dcut64_r5g64.pkl"))
    assert set(nested) == {"params"} and isinstance(nested["params"], dict)
    assert all(isinstance(v, np.ndarray) for v in nested["params"].values())
    assert nested["params"]["U_re"].shape == (20, 2, 4, 4, 64)
    tree = flagship.load_flagship_params(os.path.join(CKPT, "fe2s2_r3_dcut64_r5g64_ema"))
    assert tree.keys() == nested["params"].keys()

    path = os.path.join(CKPT, "fe2s2_dcut48_final.pkl")
    with open(path, "rb") as f:
        raw = pickle.load(f)
    flat = checkpoint.load_params(path)
    assert flat.keys() == raw.keys()
    for k, v in raw.items():
        assert flat[k].dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(flat[k], np.asarray(v))
    assert flagship.load_flagship_params(path).keys() == raw.keys()

    # lists and tuples keep their form
    t = checkpoint._to_numpy({"a": [1.0, (2, 3)], "b": {"c": 4}})
    assert isinstance(t["a"], list) and isinstance(t["a"][1], tuple)
    assert isinstance(t["b"]["c"], np.ndarray)


def test_r5g64_log_psi_matches_jax_on_the_stand_in_graph():
    js, ts = _stand_in(40, 15, 15)
    params = flagship.load_flagship_params(os.path.join(CKPT, "fe2s2_r3_dcut64_r5g64.pkl"))
    jm = jflag.flagship_model(js, 64, use_tensor=True, max_preds=2)
    tm = flagship.flagship_model(ts, 64, use_tensor=True, max_preds=2, device="cpu")
    assert tm.maxp == 2 and tm.use_tensor and not tm.is_chain
    tm.load_numpy_params(params)
    rng = np.random.default_rng(1)
    rows = np.zeros((300, 40), np.int8)
    for s in (0, 1):
        cols = np.argsort(rng.random((300, 20)), axis=1)[:, :15]
        rows[np.repeat(np.arange(300), 15), 2 * cols.ravel() + s] = 1
    want = np.asarray(jm.log_psi({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(rows)))
    got = tm.log_psi(torch.as_tensor(rows)).detach().numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4, rtol=0)
    assert np.abs(np.exp(1j * got[:, 1]) - np.exp(1j * want[:, 1])).max() < 1e-3


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_structured_plain_fused_matches_pallas(mm):
    """The flagship builder at small size (sorb 12, dcut 8, dcut_cmpr 4,
    2 predecessors): the plain fused forward with tensor coupling against
    the Pallas kernel in interpret mode."""
    js, ts = _stand_in(12, 3, 3, seed=2)
    jm = jflag.flagship_model(js, 8, use_tensor=True, max_preds=2)
    params = jm.init(jax.random.PRNGKey(5))
    tm = flagship.flagship_model(ts, 8, use_tensor=True, max_preds=2, device="cpu")
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    assert sum(len(p) >= 2 for p in tm.preds) >= 3
    bits = fci.fci_bits(12, 3, 3)[:120]
    jmm, tmm, tol = {"f32": (jnp.float32, torch.float32, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 1e-4)}[mm]
    want = np.asarray(jfused(jm, params, jnp.asarray(bits), interpret=True, matmul_dtype=jmm))
    got = fused_rnn.graph_mpsrnn_logpsi_fused(tm, torch.as_tensor(bits),
                                              matmul_dtype=tmm).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=tol, rtol=0)
    assert np.abs(np.exp(1j * got[:, 1]) - np.exp(1j * want[:, 1])).max() < 10 * tol


def test_flagship_model_is_a_graph_mps_rnn_of_the_system():
    _, ts = _stand_in(12, 3, 3)
    m = flagship.flagship_model(ts, 6, device="cpu")
    assert isinstance(m, GraphMPSRNN) and m.is_chain and m.dcut == 6
    assert (m.phase_mode, m.norm_mode, m.noa, m.nob) == ("arg", "mpsrnn", 3, 3)
