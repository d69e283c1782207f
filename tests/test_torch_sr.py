"""Port parity: stochastic reconfiguration (``grad/sr.py``) against the
JAX package in f64 on the CPU (the solvers against each other, the
SR/SGD step, the freeze-and-sweep masks and ``safe_atan2`` are in
``tests/test_torch_sr_solvers.py``; NoisyTune, the SGD resume file and
the run's sweep masks in ``tests/test_torch_sr_loop.py``).

The JAX references run under ``jax.jit``, one compile per model for all
solvers (op by op each solver takes seconds).  Tolerances are relative
to the largest entry of the JAX result, per parameter name (a leaf whose
exact update is 0, such as the global phase under SR, would make a
per-leaf ratio meaningless).

Two choices keep the comparison about the port and not about roundoff:
the damping is 1e-2, where the dense solve's condition number keeps the
two packages' f64 solutions within about 1e-11 (at 1e-3 they differ by
about 2e-10 through the Jacobians' last bits); and the rows are few
(8 alive), so that plain CG converges within its 30 iterations: on a
larger S both packages' CG iterates grow apart from the 10th iteration
on, as roundoff in an ill-conditioned Krylov recurrence does, although
each matvec agrees to 1e-13.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.grad import sr as jsr
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.grad import sr
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph

DAMP = 1e-2
N_CG = 30
CASES = {
    "chain-arg": dict(phase_mode="arg", norm_mode="mpsrnn"),
    "dag-tensor-linear": dict(phase_mode="linear", norm_mode="unit", use_tensor=True,
                              dcut_cmpr=2),
}
# each solver on one model, so that one compile per model covers the set:
# arg and linear phases, the chain and the DAG with the tensor coupling
SOLVERS = {
    "chain-arg": ("blocked", "blocked-merged", "cg", "cg-jac_batch"),
    "dag-tensor-linear": ("dense", "cg"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and under the test
    runner's parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(case):
    kw = CASES[case]
    dag = case.startswith("dag")
    jm = JModel(8, 2, 2, dcut=3, graph=jgrid(2, 2) if dag else None, **kw)
    params = jm.init(jax.random.PRNGKey(5))
    tm = GraphMPSRNN(8, 2, 2, dcut=3, graph=grid_snake_graph(2, 2) if dag else None,
                     device="cpu", **kw)
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


def _merged(names):
    return {n: "M" for n in names if n.startswith("M_")}


def _close(tg, jg, tol):
    jg = {k: np.asarray(v) for k, v in jg.items()}
    scale = max(np.abs(v).max() for v in jg.values())
    assert set(tg) == set(jg)
    for k, v in jg.items():
        assert torch.isfinite(tg[k]).all(), k
        np.testing.assert_allclose(tg[k].numpy(), v, rtol=0, atol=tol * scale, err_msg=k)


@functools.lru_cache(maxsize=None)
def _sr_case(case):
    """(torch model, inputs, the JAX package's solutions by solver, the
    merged blocks) of one model."""
    jm, params, tm = _models(case)
    rng = np.random.default_rng(1)
    bits = fci.fci_bits(8, 2, 2)[rng.permutation(36)[:10]]
    w = rng.random(10)
    w[::4] = 0.0
    w /= w.sum()
    eloc = rng.standard_normal((10, 2))
    eloc[w == 0] = np.nan  # dead rows may hold anything
    merged = _merged(params)
    solvers = SOLVERS[case]

    def all_sr(p, b, w_, e):
        fns = {
            "dense": lambda: jsr.sr_gradient(jm, p, b, w_, e, damping=DAMP),
            "blocked": lambda: jsr.sr_gradient_blocked(jm, p, b, w_, e, damping=DAMP),
            "blocked-merged": lambda: jsr.sr_gradient_blocked(jm, p, b, w_, e, damping=DAMP,
                                                              blocks=merged),
            "cg": lambda: jsr.sr_gradient_cg(jm, p, b, w_, e, damping=DAMP, n_cg=N_CG),
            "cg-jac_batch": lambda: jsr.sr_gradient_cg(jm, p, b, w_, e, damping=DAMP,
                                                       n_cg=N_CG, jac_batch=4),
        }
        return {s: fns[s]() for s in solvers}

    ref = jax.jit(all_sr)(params, jnp.asarray(bits), jnp.asarray(w), jnp.asarray(eloc))
    inputs = tuple(torch.as_tensor(a) for a in (bits, w, eloc))
    return tm, inputs, ref, merged


@pytest.mark.parametrize("case,solver", [(c, s) for c in CASES for s in SOLVERS[c]])
def test_sr_matches_jax(case, solver):
    """Every solver, per parameter name, to 1e-10 of the largest entry."""
    tm, (bits, w, eloc), ref, merged = _sr_case(case)
    out = {
        "dense": lambda: sr.sr_gradient(tm, bits, w, eloc, damping=DAMP),
        "blocked": lambda: sr.sr_gradient_blocked(tm, bits, w, eloc, damping=DAMP),
        "blocked-merged": lambda: sr.sr_gradient_blocked(tm, bits, w, eloc, damping=DAMP,
                                                         blocks=merged),
        "cg": lambda: sr.sr_gradient_cg(tm, bits, w, eloc, damping=DAMP, n_cg=N_CG),
        "cg-jac_batch": lambda: sr.sr_gradient_cg(tm, bits, w, eloc, damping=DAMP,
                                                  n_cg=N_CG, jac_batch=4),
    }[solver]()
    _close(out, ref[solver], 1e-10)


# ---------------- safe_atan2 ----------------


# ---------------- the SR step ----------------


# ---------------- sweep masks, NoisyTune, resume ----------------
