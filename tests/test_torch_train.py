"""Port parity of the flagship training run's pieces against the JAX
package: the scheduled AdamW update, checkpoints both ways (and the
repository's JAX resume file read without optax), resume bit for bit,
the EMA, 3σ clipping and the sample-count ramp of the run loop, and the
two scripts' ``main`` on the CPU (the sampler's pieces:
``test_torch_train_sampler.py``)."""

import json
import os
import pathlib
import subprocess
import sys
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JVMCConfig
from pynqs_tpu.sampler import ar_sampler as jars
from pynqs_tpu.utils import checkpoint as jck
from pynqs_tpu.utils.logging import read_log as jread_log
from pynqs_tpu.utils.system import System as JSystem

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.optim.schedule import exponential_decay, ref_schedule
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig, ema_update
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.scripts import eval_fe2s2_final, fe2s2_r3_push
from pynqs_tpu_torch.utils.checkpoint import load_checkpoint, save_params
from pynqs_tpu_torch.utils.system import System

ROOT = pathlib.Path(__file__).resolve().parent.parent
LR, LR_END, STEPS = 0.05, 0.04996, 2  # the ref schedule reaches its floor at count 2


def _schedules(kind):
    """(the JAX script's schedule, the port's) of its two kinds.  optax's
    ``exponential_decay`` computes in float32 from optax's int32 count,
    so it is evaluated here at a float64 count, where it computes in
    float64 as the port does (``test_schedules_equal_optax`` holds the
    port to the int32-count values at float32 rounding)."""
    if kind == "exp":
        sched = optax.exponential_decay(LR, STEPS, 0.1)
        return (lambda c: sched(jnp.asarray(c, jnp.float64)),
                exponential_decay(LR, STEPS, 0.1))
    return (lambda c: jnp.maximum(LR * jnp.exp(-5e-4 * c), LR_END),
            ref_schedule(LR, LR_END))


def test_schedules_equal_optax():
    """The port's schedules at counts 0..2000 against the JAX script's:
    ``optax.exponential_decay`` at an int32 count (float32 arithmetic)
    to float32 rounding, at a float64 count to 1e-15; the ref schedule
    to 1e-15."""
    counts = [0, 1, 2, 3, 7, 100, 1999, 2000]
    jexp = optax.exponential_decay(2e-4, 2000, 1e-5 / 2e-4)
    texp = exponential_decay(2e-4, 2000, 1e-5 / 2e-4)
    jref = _schedules("ref")[0]
    tref = ref_schedule(LR, LR_END)
    for c in counts:
        assert texp(c) == pytest.approx(float(jexp(jnp.asarray(c, jnp.int32))), rel=3e-7)
        assert texp(c) == pytest.approx(float(jexp(jnp.asarray(c, jnp.float64))), rel=1e-15)
        assert tref(c) == pytest.approx(float(jref(jnp.asarray(c, jnp.int32))), rel=1e-15)
    assert texp(2000) == pytest.approx(1e-5, rel=1e-14)
    assert exponential_decay(0.1, 0, 0.5)(5) == 0.1  # optax's constant schedule


def _vmc(cfg, seed=0):
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn", device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return VMC(model, system, ARSampler(8, 2, 2, n_sample=2000, capacity=40), cfg)


def _rand_tree(vmc, rng):
    return {k: rng.standard_normal(tuple(p.shape)) for k, p in vmc.model.named_parameters()}


def _set(vmc, tree):
    vmc.model.load_numpy_params(tree)


def _params(vmc):
    return {k: p.detach().numpy().copy() for k, p in vmc.model.named_parameters()}


@pytest.mark.parametrize("kind", ["exp", "ref"])
def test_scheduled_adamw_equals_optax(kind):
    """Three updates with fixed gradients: the port's lr of update k is the
    schedule at count k, and the parameters equal ``optax.adamw(sched)``'s
    to 1e-12 in f64."""
    jsched, tsched = _schedules(kind)
    vmc = _vmc(VMCConfig(lr=tsched, optimizer="adamw"))
    rng = np.random.default_rng(1)
    p0 = _rand_tree(vmc, rng)
    _set(vmc, p0)
    tx = optax.adamw(jsched)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for k in range(3):
        g = _rand_tree(vmc, rng)
        lr = vmc.apply_gradients({n: torch.as_tensor(v) for n, v in g.items()})
        assert lr == pytest.approx(float(jsched(k)), rel=1e-14, abs=0)
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, v in _params(vmc).items():
            np.testing.assert_allclose(v, np.asarray(jp[n]), atol=1e-12, rtol=0, err_msg=n)
    assert vmc.count == 3
    if kind == "ref":
        assert vmc.lr_at(2) == LR_END


def _jax_vmc(cfg, system=None):
    system = system or JSystem.hubbard_1d(4, 2, 2, u=4.0)
    jm = JModel(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn")
    return JVMC(jm, system, jars.ARSampler(8, 2, 2, n_sample=2000, capacity=40), cfg)


def _fake_jax_step(record, gnorms=None, params_seq=None):
    """A stand-in for the JAX VMC's jitted step: records what the loop
    hands it, returns scripted parameters and gradient norms."""

    def step(params, opt_state, key, chain_state, clip_val, gmask):
        i = len(record)
        record.append({"params": params, "opt_state": opt_state, "clip": float(clip_val)})
        if params_seq is not None:
            params = {k: jnp.asarray(v) for k, v in params_seq[i].items()}
        gn = gnorms[i] if gnorms is not None else 1.0
        f = jnp.float64
        return (params, opt_state, chain_state, f(-1.0), f(0.1), f(1.0), f(10.0), f(gn),
                f(0.0), f(5.0))

    return step


def _fake_port_step(vmc, record, gnorms=None, params_seq=None):
    def step(generator, clip_val, sampler=None):
        i = len(record)
        record.append({"clip": clip_val, "n_sample": (sampler or vmc.sampler).n_sample,
                       "count": vmc.count})
        if params_seq is not None:
            _set(vmc, params_seq[i])
        vmc.count += 1
        t = torch.tensor
        return {"lr": vmc.lr_at(vmc.count - 1), "energy": t(-1.0), "var": t(0.1),
                "w_sum": t(1.0), "n_eff": t(10.0),
                "gnorm": t(gnorms[i] if gnorms is not None else 1.0),
                "dropped_frac": t(0.0), "n_unique": t(5.0)}

    return step


def test_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    """The JAX package writes a checkpoint after two optax updates; the
    port restores it and its third update equals optax's to 1e-12; the
    port's checkpoint, read by the JAX package's own resume (its
    leaf-order rebuild against ``optax.adamw(sched).init``), gives the
    optax state after three updates."""
    jsched, tsched = _schedules("exp")
    vmc = _vmc(VMCConfig(lr=tsched, optimizer="adamw"), seed=3)
    rng = np.random.default_rng(2)
    p0 = _rand_tree(vmc, rng)
    grads = [_rand_tree(vmc, rng) for _ in range(3)]
    tx = optax.adamw(jsched)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads[:2]:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    jck.save_checkpoint(str(tmp_path / "jax"), 1, jp, state, [1.5, 1.25])
    ck = vmc.restore(str(tmp_path / "jax.pkl"))
    assert type(ck["opt_state"][0]).__name__ == "ScaleByAdamState"
    assert vmc.count == 2 and vmc.history == [1.5, 1.25]
    for n, v in _params(vmc).items():
        np.testing.assert_array_equal(v, np.asarray(jp[n]))
    vmc.apply_gradients({n: torch.as_tensor(v) for n, v in grads[2].items()})
    upd, state = tx.update({n: jnp.asarray(v) for n, v in grads[2].items()}, state, jp)
    jp = optax.apply_updates(jp, upd)
    for n, v in _params(vmc).items():
        np.testing.assert_allclose(v, np.asarray(jp[n]), atol=1e-12, rtol=0, err_msg=n)

    vmc.save_checkpoint(str(tmp_path / "port.pkl"), 2)
    record = []
    jv = _jax_vmc(JVMCConfig(optimizer=tx))
    jv._step = _fake_jax_step(record)
    jv.run(jax.random.PRNGKey(0), params=dict(jp), n_iter=1,
           resume_from=str(tmp_path / "port.pkl"))
    got = record[0]["opt_state"]
    assert jax.tree.structure(got) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12, rtol=0)
    assert int(got[0].count) == 3 and int(got[2].count) == 3
    for n, v in record[0]["params"].items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(jp[n]), atol=1e-12, rtol=0)
    assert vmc.history == [1.5, 1.25] and jv.history == [1.5, 1.25, -1.0]


def test_repository_jax_resume_file_reads_without_optax():
    """``checkpoints/fe2s2_r2_dcut96_resume.pkl`` (an optax AdamW state
    inside an outer ``EmptyState``) restores into a dcut-96 VMC in a
    process in which importing jax or optax raises."""
    code = r"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'optax'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax')]:
    del sys.modules[m]
try:
    import optax
    sys.exit('optax imported')
except ImportError:
    pass
import numpy as np, torch
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.checkpoint import load_checkpoint
from pynqs_tpu_torch.utils.system import System
path = 'checkpoints/fe2s2_r2_dcut96_resume.pkl'
ck = load_checkpoint(path)
from pynqs_tpu_torch.ops.integrals import triangle_size
system = System.from_integrals(np.eye(40) * 0.1, np.zeros(triangle_size(40)), 40, 15, 15)
model = GraphMPSRNN(40, 15, 15, dcut=96, phase_mode='arg', norm_mode='mpsrnn', dtype=torch.float32, device='cpu')
vmc = VMC(model, system, ARSampler(40, 15, 15), VMCConfig(lr=lambda c: 2e-4, optimizer='adamw'))
vmc.restore(path)
adam = ck['opt_state'][1][0]
mu = max(float(np.abs(vmc.opt.state[p]['exp_avg'].numpy() - adam.mu[k]).max()) for k, p in model.named_parameters())
same = all(np.array_equal(p.detach().numpy(), ck['params'][k]) for k, p in model.named_parameters())
print(json.dumps({'count': vmc.count, 'steps': sorted({int(s['step']) for s in vmc.opt.state.values()}),
                  'file_count': int(adam.count), 'sched': int(ck['opt_state'][1][2].count),
                  'mu_err': mu, 'params_equal': same, 'history': len(vmc.history),
                  'outer': type(ck['opt_state'][0]).__name__,
                  'jax': [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax')]}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["file_count"] == out["sched"] == 2000
    assert out["count"] == 2000 and out["steps"] == [2000]
    assert out["mu_err"] == 0.0 and out["params_equal"] and out["history"] == 2000
    assert out["outer"] == "EmptyState" and out["jax"] == []


def test_checkpoint_loader_refuses_other_classes(tmp_path):
    import collections
    import pickle

    from pynqs_tpu_torch.utils import checkpoint as tck

    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": collections.OrderedDict(a=np.zeros(2))}, f)
    with pytest.raises(pickle.UnpicklingError, match="collections.OrderedDict"):
        tck.load_checkpoint(str(path))


def _train_cfg(path, **kw):
    return VMCConfig(lr=exponential_decay(0.02, 4, 0.5), optimizer="adamw",
                     eloc_method="reduce", eloc_k_det=8, eloc_n_stoch=4, eloc_batch=16,
                     grad_batch=20, clip_grad=1.0, ema_decay=0.9, checkpoint_path=path,
                     checkpoint_interval=2, log_every=1, **kw)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """4 steps equal 2 steps, a checkpoint, a resume (into a model of
    other weights) and 2 more, with the same generator object carried
    across: parameters, Adam state, EMA, lr and history bit for bit
    (exact weights on)."""
    def vmc(path, seed=0):
        v = _vmc(_train_cfg(str(path)), seed)
        v.sampler = replace(v.sampler, exact_weights=True)
        return v

    a = vmc(tmp_path / "a.pkl")
    a.run(torch.Generator().manual_seed(5), 4)
    gen = torch.Generator().manual_seed(5)
    b = vmc(tmp_path / "b.pkl")
    b.run(gen, 2)
    c = vmc(tmp_path / "c.pkl", seed=9)
    c.run(gen, 2, resume_from=str(tmp_path / "b.pkl"))
    assert c.history == a.history and len(a.history) == 4
    assert c.count == a.count == 4 and c.lr_at(c.count) == a.lr_at(a.count)
    pa, pc = dict(a.model.named_parameters()), dict(c.model.named_parameters())
    for k in pa:
        assert torch.equal(pa[k], pc[k]), k
        assert torch.equal(a.ema_params[k], c.ema_params[k]), k
        for s in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.opt.state[pa[k]][s], c.opt.state[pc[k]][s].to(
                a.opt.state[pa[k]][s].dtype)), (k, s)
    ck = load_checkpoint(str(tmp_path / "c.pkl"))
    assert ck["step"] == 1 and ck["history"] == a.history
    assert int(ck["opt_state"][2][0]) == 4
    for k in pa:
        np.testing.assert_array_equal(ck["ema"][k], a.ema_params[k].numpy())


def test_ema_clip_and_ramp_follow_the_jax_loop():
    """The run loops of both packages driven by scripted steps: the EMA
    tree (decay 0.8, from the starting parameters) after every update to
    1e-14, the clip the loop hands each step (a clip schedule under the
    3σ rule over a window of 3) and the ramp's sample count."""
    n = 7
    rng = np.random.default_rng(4)
    gnorms = [1.0, 1.1, 0.9, 1.0, 0.1, 3.0, 0.2]
    kw = dict(ema_decay=0.8, adaptive_clip_3sigma=True, clip_window=3, start_n_sample=300,
              ramp_iter=2, clip_schedule=lambda it: 2.0 if it < 4 else 1.5)
    vmc = _vmc(VMCConfig(**kw))
    p0 = _rand_tree(vmc, rng)
    seq = [_rand_tree(vmc, rng) for _ in range(n)]
    _set(vmc, p0)
    rec_t = []
    vmc.step = _fake_port_step(vmc, rec_t, gnorms, seq)
    emas = []
    vmc.run(torch.Generator().manual_seed(0), n,
            callback=lambda it, info: emas.append({k: v.clone()
                                                   for k, v in vmc.ema_params.items()}))

    rec_j, seen_n = [], []
    jv = _jax_vmc(JVMCConfig(**kw))

    def build(sampler):
        step = _fake_jax_step(rec_j, gnorms, seq)

        def counted(*a):
            seen_n.append(sampler.n_sample)
            return step(*a)

        return counted

    jv._step = build(jv.sampler)
    jv._build_step = build
    jema = []
    jv.run(jax.random.PRNGKey(0), params={k: jnp.asarray(v) for k, v in p0.items()},
           n_iter=n, callback=lambda it, e, var: jema.append(jv.ema_params))
    assert [r["clip"] for r in rec_t] == pytest.approx([r["clip"] for r in rec_j], rel=1e-6)
    assert rec_t[3]["clip"] < 2.0  # the 3σ rule cut it
    assert [r["n_sample"] for r in rec_t] == seen_n == [300, 300] + [2000] * (n - 2)
    for et, ej in zip(emas, jema):
        for k in et:
            np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]), atol=1e-14, rtol=0)
    # the recurrence itself, from the starting parameters
    e = {k: torch.as_tensor(v) for k, v in p0.items()}
    for s in seq:
        e = ema_update(e, {k: torch.as_tensor(v) for k, v in s.items()}, 0.8)
    for k in e:
        assert torch.equal(e[k], emas[-1][k])


def _tiny_system():
    rng = np.random.default_rng(0)
    h1e = rng.standard_normal((8, 8)) * 0.1
    h1e = (h1e + h1e.T) / 2
    return System.from_integrals(h1e, rng.standard_normal(triangle_size(8)) * 0.05, 8, 2, 2,
                                 ecore=0.5)


def test_scripts_main_on_the_cpu(tmp_path, capsys):
    """The training script's ``main`` for 2 iterations from a warm start
    grown from dcut 3 (auto split depth, exact weights, EMA), a resume of
    it, and the evaluation's ``main`` on the saved EMA state; the ``@@``
    records parse with the JAX package's ``read_log``."""
    system = _tiny_system()
    m3 = GraphMPSRNN(8, 2, 2, dcut=3, phase_mode="arg", norm_mode="mpsrnn", device="cpu",
                     generator=torch.Generator().manual_seed(1))
    save_params(str(tmp_path / "warm.pkl"), dict(m3.named_parameters()))
    args = ["--dcut", "4", "--grow-from", "3", "--from-ckpt", str(tmp_path / "warm.pkl"),
            "--n-sample", "5000", "--capacity", "16", "--n-group", "2", "--capacity-root", "16",
            "--max-unique", "36", "--eloc-batch", "16", "--grad-batch", "20", "--k-det", "6",
            "--n-stoch", "4", "--exact-weights", "--ema", "0.9", "--ckpt-interval", "1",
            "--tag", "t"]
    r = fe2s2_r3_push.main(args + ["--iters", "2", "--split-depth", "auto"], system=system,
                           device="cpu", root=str(tmp_path))
    out = capsys.readouterr().out
    assert f"[auto] split_depth = {r['split_depth']}" in out and "live prefixes" in out
    assert len(r["history"]) == 2 and np.isfinite(r["history"]).all()
    recs = jread_log(r["paths"]["log"])
    assert [x["iter"] for x in recs] == [0, 1]
    assert recs[1]["energy"] == r["history"][1]
    for p in ("params", "ema", "resume"):
        assert os.path.exists(r["paths"][p]), p
    r2 = fe2s2_r3_push.main(args + ["--iters", "2", "--split-depth", str(r["split_depth"]),
                                    "--resume", r["paths"]["resume"]],
                            system=system, device="cpu", root=str(tmp_path))
    assert r2["history"][:2] == r["history"] and len(r2["history"]) == 4
    assert r2["vmc"].count == 4
    assert len(jread_log(r["paths"]["log"])) == 4
    reps = eval_fe2s2_final.main(
        [r["paths"]["ema"], "--dcut", "4", "--n-sample", "5000", "--n-group", "2",
         "--split-depth", "2", "--capacity", "16", "--n-rep", "2", "--k-det", "0"],
        system=system, device="cpu")
    out = capsys.readouterr().out
    assert len(reps) == 2 and all(np.isfinite(x.e) and np.isfinite(x.s) for x in reps)
    assert "rep 1: E = " in out and "FINAL  E = " in out
    with pytest.raises(SystemExit, match="A5"):
        fe2s2_r3_push.main(args + ["--eloc-dedup-max", "100"], system=system, device="cpu",
                           root=str(tmp_path))
