"""Port parity: stochastic reconfiguration (``grad/sr.py``), the SR/SGD
training step, the freeze-and-sweep masks, NoisyTune, ``safe_atan2``
under ``torch.func`` and the SGD resume file, against the JAX package
in f64 on the CPU.

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
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pynqs_tpu.grad import sr as jsr
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.cplx import safe_atan2 as jatan2
from pynqs_tpu.optim import sweep as jsweep
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JCfg
from pynqs_tpu.sampler.restricted import RestrictedSampler as JRestricted
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.grad import sr
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops.cplx import safe_atan2
from pynqs_tpu_torch.optim import sweep
from pynqs_tpu_torch.optim.schedule import exponential_decay
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
from pynqs_tpu_torch.utils.system import System

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


def test_blocked_with_one_block_is_dense_and_cg_converges_to_it():
    """Port alone: one label for every tensor gives the dense solve, and
    CG past the rank of S reaches it (1e-8)."""
    _, _, tm = _models("chain-arg")
    rng = np.random.default_rng(2)
    bits = torch.as_tensor(fci.fci_bits(8, 2, 2)[rng.permutation(36)[:12]])
    w = torch.as_tensor(rng.random(12))
    w = w / w.sum()
    eloc = torch.as_tensor(rng.standard_normal((12, 2)))
    dense = sr.sr_gradient(tm, bits, w, eloc, damping=DAMP)
    one = sr.sr_gradient_blocked(tm, bits, w, eloc, damping=DAMP,
                                 blocks={n: 0 for n, _ in tm.named_parameters()})
    _close(one, dense, 1e-12)
    x = sr.sr_gradient_cg(tm, bits, w, eloc, damping=DAMP, n_cg=60)
    _close(x, dense, 1e-8)
    assert float(sr.cg_residual(tm, bits, w, eloc, x, damping=DAMP)) < 1e-8


# ---------------- safe_atan2 ----------------


def test_safe_atan2_forward_and_backward_are_the_plain_expressions():
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.standard_normal(64), dtype=torch.float32).requires_grad_()
    x = torch.as_tensor(rng.standard_normal(64), dtype=torch.float32).requires_grad_()
    x.data[:4] = 0.0
    y.data[:2] = 0.0
    g = torch.as_tensor(rng.standard_normal(64), dtype=torch.float32)
    out = safe_atan2(y, x)
    assert torch.equal(out, torch.atan2(y, x))
    gy, gx = torch.autograd.grad(out, (y, x), g)
    m2 = torch.clamp(x * x + y * y, min=1e-12)
    assert torch.equal(gy, g * x / m2) and torch.equal(gx, -g * y / m2)


def test_safe_atan2_under_forward_mode_and_vmap():
    """torch.func.jvp, forward-mode AD and vmap(grad) agree with central
    differences away from the floor, and with the JAX custom jvp at it."""
    rng = np.random.default_rng(4)
    y = torch.as_tensor(rng.standard_normal(32))
    x = torch.as_tensor(rng.standard_normal(32))
    dy = torch.as_tensor(rng.standard_normal(32))
    dx = torch.as_tensor(rng.standard_normal(32))
    h = 1e-6
    fd = (torch.atan2(y + h * dy, x + h * dx) - torch.atan2(y - h * dy, x - h * dx)) / (2 * h)
    _, t = torch.func.jvp(safe_atan2, (y, x), (dy, dx))
    np.testing.assert_allclose(t.numpy(), fd.numpy(), rtol=0, atol=1e-8)
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        t2 = fwAD.unpack_dual(safe_atan2(fwAD.make_dual(y, dy), fwAD.make_dual(x, dx))).tangent
    assert torch.equal(t2, t)
    gy, gx = torch.func.vmap(torch.func.grad(safe_atan2, argnums=(0, 1)))(y, x)
    np.testing.assert_allclose(gy.numpy(), x.numpy() / (x**2 + y**2).numpy(), rtol=1e-14)
    np.testing.assert_allclose(gx.numpy(), -y.numpy() / (x**2 + y**2).numpy(), rtol=1e-14)
    # at and below the floor: the JAX package's floored derivative
    ys = torch.tensor([0.0, 1e-8, -3e-7, 2e-6])
    xs = torch.tensor([0.0, 2e-7, 1e-9, -1e-6])
    dys = torch.tensor([1.0, -0.5, 2.0, 0.25])
    dxs = torch.tensor([0.5, 1.5, -1.0, 1.0])
    _, t = torch.func.jvp(safe_atan2, (ys, xs), (dys, dxs))
    _, jt = jax.jvp(jatan2, (jnp.asarray(ys.numpy()), jnp.asarray(xs.numpy())),
                    (jnp.asarray(dys.numpy()), jnp.asarray(dxs.numpy())))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-12, atol=0)
    assert torch.isfinite(t).all()


# ---------------- the SR step ----------------


def test_use_sr_skips_the_plain_backward(monkeypatch):
    """Under use_sr the plain gradient's backward never runs."""
    from pynqs_tpu_torch.optim import vmc as vmc_mod

    def boom(*a, **k):
        raise AssertionError("energy_and_grad ran under use_sr")

    monkeypatch.setattr(vmc_mod, "energy_and_grad", boom)
    tm = GraphMPSRNN(8, 2, 2, dcut=3, device="cpu", generator=torch.Generator().manual_seed(0))
    v = VMC(tm, System.hubbard_1d(4, 2, 2), RestrictedSampler(8, 2, 2,
                                                              states=fci.fci_bits(8, 2, 2)),
            VMCConfig(optimizer="sgd", use_sr=True, sr_solver="cg", sr_n_cg=3, lr=0.01))
    out = v.step(torch.Generator(), 1.0)
    assert math.isfinite(float(out["energy"]))
    with pytest.raises(ValueError, match="sr_solver"):
        VMC(tm, System.hubbard_1d(4, 2, 2), v.sampler, VMCConfig(sr_solver="qr"))


# ---------------- sweep masks, NoisyTune, resume ----------------


def test_site_freeze_mask_and_sweep_schedule_match_jax():
    jm = JModel(8, 2, 2, dcut=3, phase_mode="arg", use_tensor=True, graph=jgrid(2, 2))
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    for active in ([0], [1, 2], [3, 7]):
        jmask = jsweep.site_freeze_mask(params, active)
        tmask = sweep.site_freeze_mask(params, active)
        assert set(tmask) == set(jmask)
        for k, m in jmask.items():
            np.testing.assert_array_equal(tmask[k].numpy(), np.asarray(m), err_msg=k)
    for norb, window in ((6, 2), (5, 3), (2, 2), (1, 2)):
        js = jsweep.dmrg_sweep_schedule(norb, window, 7)
        ts = sweep.dmrg_sweep_schedule(norb, window, 7)
        assert [next(ts) for _ in range(12)] == [next(js) for _ in range(12)]


def test_noise_tune_moves_each_tensor_within_its_std():
    tm = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu", generator=torch.Generator().manual_seed(0))
    v = VMC(tm, System.hubbard_1d(4, 2, 2), RestrictedSampler(8, 2, 2,
                                                              states=fci.fci_bits(8, 2, 2)))
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    v.noise_tune(torch.Generator().manual_seed(1), scale=0.2)
    for k, p in tm.named_parameters():
        std = float(before[k].std(correction=0))
        d = (p.detach() - before[k]).abs()
        assert float(d.max()) <= 0.5 * std * 0.2 * (1 + 1e-12), k
        if std > 0:
            assert float(d.max()) > 0, k
        else:
            assert float(d.max()) == 0, k


def test_restore_the_jax_sgd_resume_file(tmp_path):
    """checkpoints/fe2s2_r2_dcut64_sr_resume.pkl (CG-SR + optax.sgd on the
    exp schedule, 2000 iterations): the parameters, the count, the
    schedule's lr; the port's own SGD file round-trips, in optax's leaf
    order."""
    from pynqs_tpu_torch.utils.checkpoint import load_checkpoint, load_params

    path = "checkpoints/fe2s2_r2_dcut64_sr_resume.pkl"
    tm = GraphMPSRNN(40, 15, 15, dcut=64, phase_mode="arg", norm_mode="mpsrnn",
                     dtype=torch.float32, device="cpu")
    sched = exponential_decay(1e-4, 6000, 0.1)
    v = VMC(tm, System.hubbard_1d(20, 15, 15), None,
            VMCConfig(optimizer="sgd", lr=sched, use_sr=True, sr_solver="cg"))
    ck = v.restore(path)
    assert v.count == 2000 and len(v.history) == 2000
    assert v.lr_at(v.count) == sched(2000)
    for k, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(ck["params"][k]), err_msg=k)
    out = str(tmp_path / "sgd_resume.pkl")
    v.save_checkpoint(out, 1999)
    ck2 = load_checkpoint(out)
    leaves = jax.tree.leaves(optax.sgd(lambda c: 1e-4).init(
        {k: jnp.zeros(1) for k in load_params(path)["params"]}))
    assert len(jax.tree.leaves(ck2["opt_state"])) == len(leaves) == 1
    v2 = VMC(tm, System.hubbard_1d(20, 15, 15), None, VMCConfig(optimizer="sgd", lr=sched))
    v2.restore(out)
    assert v2.count == 2000
    with pytest.raises(ValueError, match="Adam"):
        VMC(tm, System.hubbard_1d(20, 15, 15), None,
            VMCConfig(optimizer="sgd")).restore("checkpoints/fe2s2_r2_dcut64_resume.pkl")


def test_run_applies_the_sweep_mask_of_each_iteration():
    """``param_mask_fn(it)`` masks iteration it's gradient: with site it
    active at iteration it, sites 0 and 1 move and sites 2 and 3 do not."""
    tm = GraphMPSRNN(8, 2, 2, dcut=3, device="cpu", generator=torch.Generator().manual_seed(2))
    named = dict(tm.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    v = VMC(tm, System.hubbard_1d(4, 2, 2), RestrictedSampler(8, 2, 2,
                                                              states=fci.fci_bits(8, 2, 2)),
            VMCConfig(lr=0.05, optimizer="sgd",
                      param_mask_fn=lambda it: sweep.site_freeze_mask(named, [it])))
    v.run(torch.Generator(), n_iter=2)
    for k in ("M_re", "M_im", "v_re", "v_im", "eta", "w_ph", "c_ph"):
        d = (named[k].detach() - before[k]).flatten(1).abs().amax(1)
        assert (d[2:] == 0).all(), (k, d)
        # site 0 has no predecessor: its M is never read
        assert (d[1:2] > 0).all() if k.startswith("M_") else (d[:2] > 0).all(), (k, d)
