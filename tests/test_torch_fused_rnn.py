"""The fused forward: plain version against the JAX Pallas kernel (run in
interpret mode, f32 matmuls), the cases of tests/test_fused_rnn.py: the
chain here, the rest in ``tests/test_torch_fused_rnn_graph.py`` and
``tests/test_torch_fused_rnn_bf16.py``.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops.fused_rnn import graph_mpsrnn_logpsi_fused as jfused
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
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


def test_cpu_rows_take_the_plain_version_and_count_no_launch():
    tm = GraphMPSRNN(8, 2, 2, dcut=4, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    bits = torch.as_tensor(fci.fci_bits(8, 2, 2))
    before = fused_rnn.LAUNCHES.n
    a = fused_rnn.graph_mpsrnn_logpsi_fused(tm, bits)
    b = fused_rnn.graph_mpsrnn_logpsi_fused_plain(tm, bits)
    assert torch.equal(a, b)
    assert fused_rnn.LAUNCHES.n == before
