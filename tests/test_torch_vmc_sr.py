"""One SR/SGD ``VMC.step`` (RESTRICTED sampler, SIMPLE eloc, each SR solver,
with and without a sweep mask) against the JAX package's compiled step."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.optim import sweep as jsweep
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JCfg
from pynqs_tpu.sampler.restricted import RestrictedSampler as JRestricted
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim import sweep
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
from pynqs_tpu_torch.utils.system import System


@pytest.fixture(scope="module", params=["dense", "cg", "blocked"])
def step_case(request):
    """One JAX VMC step (RESTRICTED sampler, SIMPLE eloc, SR, optax.sgd)
    compiled once with a mask input: with a mask of ones (no mask) and
    with a site-freeze mask.  Returns (solver, params, states, outcomes).
    The 8 states keep S's rank below 30, so that plain CG converges in
    its 30 iterations (past that, roundoff moves the two packages'
    iterates apart) and damping 1e-2 keeps the dense solve's roundoff
    under 1e-11.  The step is deterministic end to end."""
    solver = request.param
    jm = JModel(8, 2, 2, dcut=3, phase_mode="arg", norm_mode="mpsrnn")
    params = jm.init(jax.random.PRNGKey(6))
    states = fci.fci_bits(8, 2, 2)[::5]
    mask = jsweep.site_freeze_mask(params, [1, 2], dtype=jnp.float64)
    cfg = JCfg(optimizer=optax.sgd(0.05), use_sr=True, sr_solver=solver, sr_n_cg=30,
               sr_damping=1e-2, clip_grad=0.5, param_mask_fn=lambda it: mask)
    jv = JVMC(jm, JSystem.hubbard_1d(4, 2, 2, u=4.0), JRestricted(8, 2, 2, states=states), cfg)
    out = {}
    for what, m in (("none", jax.tree.map(jnp.ones_like, mask)), ("sites 1-2", mask)):
        res = jv._step(params, jv.tx.init(params), jax.random.PRNGKey(0), None,
                       jnp.float32(0.5), m)
        out[what] = ({k: np.asarray(v) for k, v in res[0].items()}, float(res[3]),
                     float(res[7]))
    return solver, {k: np.asarray(v) for k, v in params.items()}, states, out


@pytest.mark.parametrize("mask", ["none", "sites 1-2"])
def test_sgd_sr_step_matches_jax(step_case, mask):
    """One VMC.step leaves the JAX step's parameters (1e-10 of the largest
    parameter), energy and gradient norm; the frozen sites do not move."""
    solver, params, states, out = step_case
    tm = GraphMPSRNN(8, 2, 2, dcut=3, phase_mode="arg", norm_mode="mpsrnn", device="cpu")
    tm.load_numpy_params(params)
    cfg = VMCConfig(lr=0.05, optimizer="sgd", use_sr=True, sr_solver=solver, sr_n_cg=30,
                    sr_damping=1e-2, clip_grad=0.5)
    v = VMC(tm, System.hubbard_1d(4, 2, 2, u=4.0), RestrictedSampler(8, 2, 2, states=states),
            cfg)
    gmask = None if mask == "none" else sweep.site_freeze_mask(dict(tm.named_parameters()),
                                                                [1, 2])
    res = v.step(torch.Generator().manual_seed(0), 0.5, gmask=gmask)
    j_params, j_e, j_gnorm = out[mask]
    scale = max(np.abs(v).max() for v in j_params.values())
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_params[k], rtol=0, atol=1e-10 * scale,
                                   err_msg=k)
    assert abs(float(res["energy"]) - j_e) <= 1e-12
    assert abs(float(res["gnorm"]) - j_gnorm) <= 1e-10 * j_gnorm
    if gmask is not None:
        for k in ("M_re", "v_im", "w_arg_re"):
            np.testing.assert_array_equal(tm.get_parameter(k).detach().numpy()[[0, 3]],
                                          params[k][[0, 3]])
