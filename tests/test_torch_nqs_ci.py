"""Port parity: the coupled CI-NQS training (``ci/nqs_ci.py`` ``NqsCi``) and
its script, against the JAX package in f64 on the CPU.

A tiny ``GraphMPSRNN`` (sorb 8, 2α/2β, dcut 4), its seeded weights
given to the JAX model as they are and loaded back by
``load_numpy_params``, seeded random
integrals, the 6 heaviest determinants as D, and ``ci_chunk`` /
``eloc_batch`` below the work so that every chunk loop runs more than
once.  The same draw (the port sampler's rows and weights) and the same
eigenvector go through the JAX package's ``_eloc_eval``, ``_hcn_eval``
and ``_grad_step`` and through the port's pieces: the local energies,
h_nn, H_cn and the heff eigenvalue to 1e-10, and the parameters after
two iterations of ``run`` (the draw fixed on both sides) for strategies
0/1/2, with the warm-up floor on, to 1e-10.  One update per strategy is
in ``tests/test_torch_nqs_ci_step.py``, the script in
``tests/test_torch_nqs_ci_main.py``."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pynqs_tpu.ci.nqs_ci import NqsCi as JNqsCi
from pynqs_tpu.ci.nqs_ci import NqsCiConfig as JConfig
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.ci.nqs_ci import NqsCi, NqsCiConfig
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.system import System

SORB, NOA, NOB, M = 8, 2, 2, 6
# strategy -> (start_iter, cnqs_pow_min): 0 and 1 with the warm-up floor on
# for both iterations of the runs (|c_m|² is well below 0.9 here)
STRATEGIES = {0: (2, 0.9), 1: (2, 0.9), 2: (-1, 1e-4)}


def _cfg(cls, strategy):
    start, pmin = STRATEGIES[strategy]
    return cls(n_iter=2, lr=1e-2, n_sample=4096, capacity=36, grad_strategy=strategy,
               start_iter=start, cnqs_pow_min=pmin, ci_chunk=40, eloc_batch=8, log_every=0)


@lru_cache(maxsize=None)
def _common():
    """(port system, JAX system, JAX model, its parameters, D, the draw):
    the weights are the port model's seeded draw, the draw is the port's
    sampler's (rows [36, 8], weights zeroed on D and on dead slots)."""
    rng = np.random.default_rng(9)
    h1e = rng.standard_normal((SORB, SORB)) * 0.3
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(SORB)) * 0.1
    ts = System.from_integrals(h1e, h2e, SORB, NOA, NOB, ecore=0.5)
    js = JSystem.from_integrals(h1e, h2e, SORB, NOA, NOB, ecore=0.5)
    tm = GraphMPSRNN(SORB, NOA, NOB, dcut=4, dtype=torch.float64, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in tm.named_parameters()}
    space = fci.fci_bits(SORB, NOA, NOB)
    la = tm.log_psi(torch.as_tensor(space))[:, 0].detach().numpy()
    d_bits = space[np.sort(np.argsort(-la)[:M])]
    bits, w = NqsCi(tm, ts, d_bits, _cfg(NqsCiConfig, 1)).draw(torch.Generator().manual_seed(3))
    return ts, js, JModel(SORB, NOA, NOB, dcut=4), params, d_bits, (bits.numpy(), w.numpy())


def _port_model():
    params = _common()[3]
    tm = GraphMPSRNN(SORB, NOA, NOB, dcut=4, dtype=torch.float64, device="cpu")
    return tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})


@lru_cache(maxsize=None)
def _jax(strategy):
    """The JAX package's pieces and results for ``strategy`` on the common
    draw: (eloc, h_nn), Re H_cn, the heff eigenpair, the parameters after
    one ``_grad_step`` at scale 1.7, and a two-iteration ``run`` on that
    draw.  The strategies share one compiled local energy and H_cn."""
    _, js, jm, params, d_bits, (bits, w) = _common()
    nc = JNqsCi(jm, js, d_bits, _cfg(JConfig, strategy))
    if strategy != 1:
        ref = _jax(1)["nc"]
        nc._eloc_eval, nc._hcn_eval = ref._eloc_eval, ref._hcn_eval
    bits, w = jnp.asarray(bits), jnp.asarray(w)
    eloc, h_nn = nc._eloc_eval(params, bits, w)
    h_cn = np.asarray(nc._hcn_eval(params), np.float64)
    heff = np.zeros((M + 1, M + 1))
    heff[:M, :M] = np.asarray(nc._h_cc)
    heff[:M, M] = heff[M, :M] = h_cn
    heff[M, M] = float(h_nn)
    evals, evecs = np.linalg.eigh(heff)
    c = evecs[:, 0]
    stepped, _ = nc._grad_step(params, optax.adam(1e-2).init(params), bits, w, eloc,
                               jnp.asarray(float(h_nn)), jnp.asarray(c), jnp.asarray(1.7))
    nc._draw = lambda p, k: (bits, w)
    ran, c_run, hist = nc.run(jax.random.PRNGKey(1), params=params)
    return {"nc": nc, "eloc": np.asarray(eloc), "h_nn": float(h_nn),
            "h_cn": h_cn, "e": float(evals[0]), "c": c, "stepped": stepped, "ran": ran,
            "c_run": np.asarray(c_run), "hist": np.asarray(hist)}


def _port(strategy):
    ts, _, _, _, d_bits, (bits, w) = _common()
    tm = _port_model()
    return tm, NqsCi(tm, ts, d_bits, _cfg(NqsCiConfig, strategy)), (
        torch.as_tensor(bits), torch.as_tensor(w))


def _max_param_diff(tm, jparams):
    p = dict(tm.named_parameters())
    return max(float(np.abs(p[k].detach().numpy().reshape(np.shape(v)) - np.asarray(v)).max())
               for k, v in jparams.items())


def test_pieces_equal_jax():
    """h_nn, the local energies, H_cn and the heff eigenpair (1e-10; the
    eigenvector up to its sign), with chunked local energies and H_cn."""
    ref = _jax(1)
    _, nc, (bits, w) = _port(1)
    assert int((w > 0).sum()) > 8 and nc._ci_flat.shape[0] > 40  # more than one chunk
    eloc, h_nn = nc.eloc_eval(bits, w)
    h_cn, ci_mass = nc.hcn_eval()
    assert np.abs(eloc.numpy() - ref["eloc"]).max() < 1e-10
    assert abs(float(h_nn) - ref["h_nn"]) < 1e-10
    assert np.abs(h_cn.numpy() - ref["h_cn"]).max() < 1e-10
    assert 0.0 < float(ci_mass) < 1.0
    e, c = nc.solve(h_nn, h_cn)
    assert abs(e - ref["e"]) < 1e-10
    assert np.abs(c * np.sign(c @ ref["c"]) - ref["c"]).max() < 1e-10
    assert (eloc[w == 0] == 0).all()


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_run_equals_jax(strategy):
    """Two iterations of ``run`` on the fixed draw: the history (e_tot +
    ecore) and the parameters to 1e-10, the last eigenvector's |c_m|; the
    warm-up floor is on for strategies 0 and 1."""
    ref = _jax(strategy)
    tm, nc, draw = _port(strategy)
    nc.draw = lambda g: draw
    c, hist = nc.run(torch.Generator())
    assert np.abs(np.asarray(hist) - ref["hist"]).max() < 1e-10
    assert abs(abs(c[-1]) - abs(ref["c_run"][-1])) < 1e-10
    assert _max_param_diff(tm, ref["ran"]) < 1e-10
    assert [s["e_tot"] for s in nc.stats] == hist
    floor = nc.warmup_scale(0, c)
    assert floor > 1.5 if strategy in (0, 1) else floor == 1.0
    assert nc.warmup_scale(2, c) == 1.0  # start_iter 2: off from iteration 2
