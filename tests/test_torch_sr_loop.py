"""NoisyTune, the JAX package's SGD resume file restored in the port, and
the sweep mask of each iteration in ``VMC.run`` (the set-up of
``tests/test_torch_sr.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim import sweep
from pynqs_tpu_torch.optim.schedule import exponential_decay
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
from pynqs_tpu_torch.utils.system import System

from test_torch_sr import _one_thread  # noqa: F401  (autouse)


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
