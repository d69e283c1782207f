"""Stochastic reconfiguration's solvers against each other, ``safe_atan2``
under ``torch.func``, the plain backward skipped under SR, and the
freeze-and-sweep masks against the JAX package (the set-up of
``tests/test_torch_sr.py``)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.cplx import safe_atan2 as jatan2
from pynqs_tpu.optim import sweep as jsweep
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.grad import sr
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.cplx import safe_atan2
from pynqs_tpu_torch.optim import sweep
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
from pynqs_tpu_torch.utils.system import System

from test_torch_sr import DAMP, _close, _models, _one_thread  # noqa: F401  (autouse)


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
