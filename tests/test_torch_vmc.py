"""Port parity: the pair-form energy gradient against ``jax.grad``, and
the VMC loop's dead-sampler stop.  The trainer end to end is in
``tests/test_torch_vmc_loop.py``, one SR/SGD step against the JAX
package's compiled step in ``tests/test_torch_vmc_sr.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from pynqs_tpu.grad.energy_grad import energy_and_grad as jgrad
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.integrals import decompress_h2e
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.optim.vmc import VMC
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.system import System


@pytest.mark.parametrize("grad_batch", [None, 7])
@pytest.mark.parametrize("case", ["chain-arg", "dag-tensor-linear"])
def test_energy_and_grad_matches_jax(case, grad_batch):
    """Same parameters, rows, weights (with dead rows holding NaN local
    energies) and local energies: e_mean, variance and every gradient
    leaf agree to 1e-8 in f64."""
    dag = case.startswith("dag")
    kw = dict(phase_mode="arg" if case.endswith("arg") else "linear",
              norm_mode="mpsrnn" if case.endswith("arg") else "unit",
              use_tensor="tensor" in case, dcut_cmpr=3)
    jm = JModel(12, 3, 3, dcut=5, graph=jgrid(3, 2) if dag else None, **kw)
    params = jm.init(jax.random.PRNGKey(3))
    tm = GraphMPSRNN(12, 3, 3, dcut=5, graph=grid_snake_graph(3, 2) if dag else None,
                     device="cpu", **kw)
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    rng = np.random.default_rng(0)
    bits = fci.fci_bits(12, 3, 3)[rng.permutation(400)[:40]]
    w = rng.random(40)
    w[::6] = 0.0
    w /= w.sum()
    eloc = rng.standard_normal((40, 2))
    eloc[w == 0] = np.nan
    je, jg, jv = jgrad(jm, params, jnp.asarray(bits), jnp.asarray(w), jnp.asarray(eloc),
                       grad_batch=grad_batch)
    te, tg, tv = energy_and_grad(tm, torch.as_tensor(bits), torch.as_tensor(w),
                                 torch.as_tensor(eloc), grad_batch=grad_batch)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tv.item(), float(jv), atol=1e-12, rtol=0)
    assert set(tg) == set(jg)
    for k, g in tg.items():
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=1e-8, rtol=0,
                                   err_msg=k)


def _hubbard():
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    dets = oracle.fci_space(system.sorb, 2, 2)
    H = oracle.dense_h(dets, system.h1e, decompress_h2e(system.h2e, system.sorb))
    return system, float(np.linalg.eigvalsh(H)[0])


def test_vmc_stops_on_a_dead_sampler():
    """NaN parameters give NaN conditionals and no live sample: the run
    raises instead of reporting an energy of 0."""
    system, _ = _hubbard()
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.M_re.fill_(float("nan"))
    sampler = ARSampler(8, 2, 2, n_sample=100, capacity=36)
    with pytest.raises(FloatingPointError):
        VMC(model, system, sampler).run(torch.Generator().manual_seed(1), 2)
