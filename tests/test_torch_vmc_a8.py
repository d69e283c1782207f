"""Port parity of training the other ansätze: ``VMC.step`` under the exact
sampler against the JAX package's compiled step (RBM with dense SR and
SGD through ``hubbard_ladder`` stage 1, RNN with AdamW, MultiPsi and
SpinProjected with their importance reweighting), and resume files of a
nested parameter tree (the decoder's) both ways.

The JAX step reweights by |f|² whatever the sampler, so its exact sampler
gives a model with a ``log_factor`` the measure |φ|²|f|⁴.  The port
reweights only an AR sampler's counts (``VMC.reweight``); its exact
sampler weighs |ψ|² directly.  The parity cases hand the JAX step the
exact measure of the AR part φ, which its reweighting takes to |ψ|²."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import oracle
from pynqs_tpu import models as jm
from pynqs_tpu.models import extra as jextra
from pynqs_tpu.ops.integrals import decompress_h2e
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JCfg
from pynqs_tpu.sampler.exact import ExactSampler as JExact
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import checkpoint as jck

from pynqs_tpu_torch import models as tm
from pynqs_tpu_torch.examples import hubbard_ladder
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.utils.checkpoint import _to_numpy
from pynqs_tpu_torch.utils.system import System
from pynqs_tpu_torch.utils.tree import flatten_tree, tree_named_parameters, unflatten_tree

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and under the test
    runner's parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(model, seed, scale=0.1):
    """The port model's parameters, moved off its init, as a JAX-layout tree."""
    rng = np.random.default_rng(seed)
    return unflatten_tree({k: p.detach().numpy() + scale * rng.standard_normal(tuple(p.shape))
                           for k, p in tree_named_parameters(model).items()})


def _assert_params(model, jparams, atol):
    got = {k: p.detach().numpy() for k, p in tree_named_parameters(model).items()}
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def test_hubbard_ladder_stage1_matches_jax(capsys, monkeypatch):
    """Stage 1 (RBM, exact enumeration, dense SR at damping 1e-3, SGD at
    5e-2) over 3 iterations from the same parameters (the stage's model
    moved off its seeded start): the JAX VMC's history and final
    parameters to 1e-9; the FCI reference is the oracle's."""
    setup = hubbard_ladder.stage_setup
    tree = _tree(setup(1, 3, "cpu")[1], 1)

    def from_tree(*a):
        system, model, sampler, cfg = setup(*a)
        return system, model.load_numpy_params(tree), sampler, cfg

    monkeypatch.setattr(hubbard_ladder, "stage_setup", from_tree)
    out = hubbard_ladder.main(["--stage", "1", "--iters", "3"], device="cpu")
    jv = JVMC(jm.RBM(8, alpha=4, init_scale=0.1), JSystem.hubbard_1d(4, 2, 2, u=4.0),
              JExact(8, 2, 2), JCfg(n_iter=3, use_sr=True, sr_damping=1e-3,
                                    optimizer=optax.sgd(5e-2), log_every=25))
    jp, jhist = jv.run(jax.random.PRNGKey(0), params=jax.tree.map(jnp.asarray, tree), n_iter=3)
    np.testing.assert_allclose(out["history"], jhist, atol=1e-9, rtol=0)
    _assert_params(out["model"], jp, 1e-9)
    system = JSystem.hubbard_1d(4, 2, 2, u=4.0)
    dets = oracle.fci_space(8, 2, 2)
    e0 = np.linalg.eigvalsh(oracle.dense_h(dets, system.h1e, decompress_h2e(system.h2e, 8)))[0]
    assert out["n_fci"] == 36 and abs(out["fci"] - e0) < 1e-10
    assert "stage 1: sorb=8" in capsys.readouterr().out


class _JaxARPartExact(JExact):
    """The JAX exact sampler over a model's AR part (``phi``, or
    SpinProjected's ``base``): the weights |φ|²/Z that AR counts estimate."""

    def sample(self, model, params, key, state=None):
        ar, p = (model.phi, params["phi"]) if hasattr(model, "phi") else (model.base, params)
        bits, w, _, st = super().sample(ar, p, key, state)
        return bits, w, model.log_psi(params, bits), st


def _step_pair(case, seed=0):
    """(JAX model, port model, port VMCConfig, optax transform) of a case;
    the port model's init drawn from ``seed``."""
    kw = dict(CPU, generator=torch.Generator().manual_seed(seed))
    if case == "rnn-adamw":
        return (jm.RNNWavefunction(8, 2, 2, hidden=6, phase_hidden=5),
                tm.RNNWavefunction(8, 2, 2, hidden=6, phase_hidden=5, **kw),
                VMCConfig(lr=0.02, optimizer="adamw"), optax.adamw(0.02))
    if case == "multipsi-adam":
        return (jextra.MultiPsi(jm.ARRBM(8, 2, 2, nh=6, phase_hidden=5), jextra.Jastrow(8)),
                tm.MultiPsi(tm.ARRBM(8, 2, 2, nh=6, phase_hidden=5, **kw), tm.Jastrow(8, **kw)),
                VMCConfig(lr=0.02), optax.adam(0.02))
    return (jextra.SpinProjected(jm.ARRBM(8, 2, 2, nh=6, phase_hidden=5), -1),
            tm.SpinProjected(tm.ARRBM(8, 2, 2, nh=6, phase_hidden=5, **kw), -1),
            VMCConfig(lr=0.02, optimizer="sgd", clip_grad=0.5), optax.sgd(0.02))


@pytest.mark.parametrize("case", ["rnn-adamw", "multipsi-adam", "spinproj-sgd"])
def test_exact_sampler_step_matches_jax(case):
    """One ``VMC.step`` (ExactSampler, SIMPLE eloc, clip) from the same
    parameters: the JAX step's energy, gradient norm and updated
    parameters to 1e-9; with a ``log_factor`` (MultiPsi, SpinProjected)
    the JAX step gets the AR part's exact measure and reweights it by
    |f|².  ⟨H⟩ through ``operator_expected`` on the same measure is the
    step's energy.  ``VMC.reweight`` takes an AR sampler's weights w to
    w·|f|²/Σ and leaves the exact sampler's."""
    jmodel, model, cfg, tx = _step_pair(case)
    tree = _tree(model, 2, 0.3)
    model.load_numpy_params(tree)
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    vmc = VMC(model, system, ExactSampler(8, 2, 2), cfg)
    op = vmc.operator_expected((system.h1e, system.h2e), torch.Generator().manual_seed(0))
    out = vmc.step(torch.Generator().manual_seed(0), cfg.clip_grad)
    jsampler = (_JaxARPartExact if hasattr(model, "log_factor") else JExact)(8, 2, 2)
    jv = JVMC(jmodel, JSystem.hubbard_1d(4, 2, 2, u=4.0), jsampler,
              JCfg(optimizer=tx, clip_grad=cfg.clip_grad))
    jp = jax.tree.map(jnp.asarray, tree)
    res = jv._step(jp, tx.init(jp), jax.random.PRNGKey(0), None,
                   jnp.asarray(cfg.clip_grad, jnp.float32), None)
    assert abs(float(out["energy"]) - float(res[3])) < 1e-9
    assert abs(float(out["gnorm"]) - float(res[7])) < 1e-9
    assert abs(float(out["w_sum"]) - 1.0) < 1e-12
    _assert_params(model, res[0], 1e-9)
    assert abs(op.mean.real - float(res[3])) < 1e-9
    if hasattr(model, "log_factor"):
        bits = torch.as_tensor(ExactSampler(8, 2, 2)._space)
        w = torch.rand(bits.shape[0], dtype=torch.float64, generator=torch.Generator().manual_seed(1))
        w[::4] = 0
        f2 = torch.exp(2 * model.log_factor(bits)[:, 0].detach())
        want = w * f2 / (w * f2).sum()
        got = vmc.reweight(bits, w / w.sum(), ARSampler(8, 2, 2))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-15, rtol=0)
        assert torch.equal(vmc.reweight(bits, w, ExactSampler(8, 2, 2)), w)
        assert torch.equal(vmc.reweight(bits, w, ARSampler(8, 2, 2, exact_weights=True)), w)


def test_reweighted_ar_counts_follow_the_whole_model():
    """MultiPsi(ARRBM, Jastrow) sampled through the ARRBM at n = 4e6: the
    reweighted counts are the whole model's |ψ|²/Z within 0.01 in total
    variation."""
    model = tm.MultiPsi(tm.ARRBM(8, 2, 2, nh=6, phase_hidden=5, **CPU),
                        tm.Jastrow(8, **CPU))
    model.load_numpy_params(_tree(model, 5, 0.5))
    sampler = ARSampler(8, 2, 2, n_sample=4_000_000, capacity=64)
    vmc = VMC(model, System.hubbard_1d(4, 2, 2, u=4.0), sampler)
    bits, w, _ = sampler.sample(model, torch.Generator().manual_seed(6))
    w = vmc.reweight(bits, w, sampler)
    live = w > 0
    p = torch.exp(2 * model.log_psi(bits[live])[:, 0].detach())
    assert int(live.sum()) == 36
    assert (w[live] - p / p.sum()).abs().sum().item() < 0.01


def test_decoder_resume_files_both_ways(tmp_path):
    """A JAX resume file of a ``DecoderWavefunction`` AdamW run (nested
    tree, the ``blocks`` list) restores in the port with equal parameters,
    moments and count, and the third update equals optax's; the port's
    file loads in the JAX package's ``load_checkpoint`` as the same tree
    (parameters, the optimizer state's leaves in optax's order, the EMA).
    A flat tree (``GraphMPSRNN``'s) pickles to the same bytes as before."""
    model = tm.DecoderWavefunction(8, 2, 2, n_layer=2, n_head=2, d_model=8, phase_hidden=5,
                                   **CPU)
    vmc = VMC(model, System.hubbard_1d(4, 2, 2, u=4.0), ExactSampler(8, 2, 2),
              VMCConfig(lr=0.01, optimizer="adamw", ema_decay=0.9))
    p0 = _tree(model, 3)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda x: rng.standard_normal(np.shape(x)), p0) for _ in range(3)]
    tx = optax.adamw(0.01)
    update = jax.jit(tx.update)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    for g in grads[:2]:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    jck.save_checkpoint(str(tmp_path / "jax"), 1, jp, state, [1.5, 1.25],
                        extra={"ema": jp})
    vmc.restore(str(tmp_path / "jax.pkl"))
    assert vmc.count == 2 and vmc.history == [1.5, 1.25]
    _assert_params(model, jp, 0.0)
    named = vmc._named()
    mu, nu = flatten_tree(state[0].mu), flatten_tree(state[0].nu)
    for k, p in named.items():
        st = vmc.opt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu[k]), err_msg=k)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(nu[k]), err_msg=k)
        np.testing.assert_array_equal(vmc.ema_params[k].numpy(), np.asarray(flatten_tree(jp)[k]))
    vmc.apply_gradients({k: torch.as_tensor(v) for k, v in flatten_tree(grads[2]).items()})
    upd, state = update(jax.tree.map(jnp.asarray, grads[2]), state, jp)
    jp = optax.apply_updates(jp, upd)
    _assert_params(model, jp, 1e-12)

    vmc.save_checkpoint(str(tmp_path / "port.pkl"), 2)
    ck = jck.load_checkpoint(str(tmp_path / "port.pkl"))
    assert jax.tree.structure(ck["params"]) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(ck["params"]), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12, rtol=0)
    assert jax.tree.structure(ck["ema"]) == jax.tree.structure(jp)
    got, want = jax.tree.leaves(ck["opt_state"]), jax.tree.leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12, rtol=0)

    flat = {k: np.full(2, i, np.float32) for i, k in enumerate(("M_re", "v_im", "eta"))}
    assert pickle.dumps(_to_numpy(unflatten_tree(flat))) == pickle.dumps(_to_numpy(flat))
