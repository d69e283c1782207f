"""The VMC trainer end to end on the CPU: the energy of a Hubbard chain goes
down (SIMPLE/Adam, REDUCE/AdamW), the eloc forward's choice, and the AdamW
steps against ``optax.adamw``."""

import math

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler

from test_torch_vmc import _hubbard


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
