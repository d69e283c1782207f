"""Port parity: the pair-form energy gradient against ``jax.grad``, the
VMC trainer end to end on the CPU, and one SR/SGD step (RESTRICTED
sampler, SIMPLE eloc, each SR solver, with and without a sweep mask)
against the JAX package's compiled step."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import oracle
from pynqs_tpu.grad.energy_grad import energy_and_grad as jgrad
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.integrals import decompress_h2e
from pynqs_tpu.optim import sweep as jsweep
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JCfg
from pynqs_tpu.sampler.restricted import RestrictedSampler as JRestricted
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.optim import sweep
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
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


@pytest.mark.parametrize("variant", ["simple-adam", "reduce-adamw"])
def test_vmc_hubbard_energy_goes_down(variant):
    """20 steps on the 4-site Hubbard chain (36 determinants, sampled
    exactly): the energy of the last 5 steps lies below that of the
    first 5, and every energy is finite and near or above E_0."""
    system, e0 = _hubbard()
    model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                        device="cpu", generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(8, 2, 2, n_sample=20_000, capacity=36)
    if variant == "simple-adam":
        cfg = VMCConfig(lr=0.05)
    else:
        cfg = VMCConfig(lr=0.05, optimizer="adamw", eloc_method="reduce", eloc_k_det=12,
                        eloc_n_stoch=8, eloc_topk="segmax", eloc_batch=16, grad_batch=10,
                        clip_schedule=lambda it: 1.0 if it < 10 else 0.5,
                        fused_matmul_dtype="f32")
    seen = []
    hist = VMC(model, system, sampler, cfg).run(
        torch.Generator().manual_seed(1), 20, callback=lambda it, info: seen.append(info))
    assert len(hist) == 20 and all(math.isfinite(e) for e in hist)
    assert [s["w_sum"] for s in seen] == pytest.approx([1.0] * 20, abs=1e-12)
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.05, hist
    assert min(hist) > e0 - 0.1, (min(hist), e0)


def test_eloc_forward_is_the_fused_forward_when_turned_on():
    system, _ = _hubbard()
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(8, 2, 2, n_sample=100, capacity=36)
    bits = torch.as_tensor(fci.fci_bits(8, 2, 2))
    fwd = VMC(model, system, sampler,
              VMCConfig(fused_forward=True, fused_matmul_dtype="f32"))._eloc_forward()
    assert fwd.func is fused_rnn.graph_mpsrnn_logpsi_fused
    np.testing.assert_allclose(fwd(bits).numpy(), model.log_psi(bits).detach().numpy(),
                               atol=1e-5, rtol=0)
    off = VMC(model, system, sampler, VMCConfig(fused_forward=False))._eloc_forward()
    assert torch.equal(off(bits), model.log_psi(bits).detach())


def test_eloc_forward_by_default_is_log_psi_on_the_cpu(monkeypatch):
    """As the JAX package off the accelerator (``fused_forward=None``):
    the exact forward, never the fused one, whatever its matmul type."""
    system, _ = _hubbard()
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(8, 2, 2, n_sample=100, capacity=36)
    bits = torch.as_tensor(fci.fci_bits(8, 2, 2))

    def boom(*a, **k):
        raise AssertionError("the fused forward ran on the CPU by default")

    monkeypatch.setattr(fused_rnn, "graph_mpsrnn_logpsi_fused", boom)
    for mm in ("bf16", "f32"):
        fwd = VMC(model, system, sampler, VMCConfig(fused_matmul_dtype=mm))._eloc_forward()
        assert torch.equal(fwd(bits), model.log_psi(bits).detach())


def test_adamw_steps_equal_optax_adamw():
    """Two AdamW steps of the port's optimizer equal ``optax.adamw(lr)``
    (weight decay 1e-4, the default of every AdamW run of the JAX
    package) to 1e-12 in f64, from the same parameters and gradients."""
    system, _ = _hubbard()
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu")
    rng = np.random.default_rng(5)
    names = [k for k, _ in model.named_parameters()]
    p0 = {k: rng.standard_normal(tuple(p.shape)) for k, p in model.named_parameters()}
    grads = [{k: rng.standard_normal(v.shape) for k, v in p0.items()} for _ in range(2)]
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.as_tensor(p0[k]))
    lr = 0.05
    opt = VMC(model, system, ARSampler(8, 2, 2, n_sample=100, capacity=36),
              VMCConfig(lr=lr, optimizer="adamw")).opt
    tx = optax.adamw(lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = dict(model.named_parameters())
    for g in grads:
        for k in names:
            params[k].grad = torch.as_tensor(g[k])
        opt.step()
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    for k in names:
        assert params[k].dtype == torch.float64
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), atol=1e-12,
                                   rtol=0, err_msg=k)
        assert np.abs(np.asarray(jp[k]) - p0[k]).max() > 1e-3  # the steps moved it


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
