"""VMC optimization loop.

Counterpart of ``pynqs_tpu/optim/vmc.py`` (``VMC``, ``VMCConfig``)
with the fields of the flagship training run.  One step: sampling
(AR, restricted, or MCMC with its chain state) → local energy (SIMPLE
or REDUCE; the ψ ratio forwards go through the fused forward) →
pair-form gradient, or its SR preconditioning (``grad/sr.py``; then the
plain gradient's backward is not run) → freeze-and-sweep mask → clip →
Adam/AdamW/SGD update at the scheduled learning rate; ``run`` adds the
parameter EMA, the sample-count ramp, 3σ clipping, the MCMC
thermalization, the run log and the resume checkpoints (the JAX
package's file format, ``utils/checkpoint.py``), ``noise_tune`` the
NoisyTune perturbation, and ``operator_expected`` measures any operator
on the state.

Data parallelism (``mesh``, ``parallel/``): one process per rank, each
sampling and evaluating its rows (the sampler takes the same mesh); the
weighted mean, the gradients (or SR's sums), the variance, w_sum and
n_eff are all-reduced, so every rank applies the same update and the
parameters stay replicated bit for bit.  The EMA, the ramp, the clipping
and the clip schedule run alike on every rank; rank 0 alone writes the
run log and the checkpoints.  ``profile_dir`` traces iterations
[2, 2 + profile_iters) with ``torch.profiler`` into
``profile_dir/trace_rank{r}.json``, and the fused forward's rows and
distinct rows over them as one ``@@`` record of the run log; every step
marks its stages as the ranges ``vmc.sample``, ``vmc.eloc``,
``vmc.grad`` (or ``vmc.sr``) and ``vmc.update``, which hold the
sampler's, local energy's, forward's and gradient's own ranges.

Resuming keeps two behaviours of the JAX loop: the loop's iteration
restarts at 0 (the clip schedule, the ramp, the 3σ window and the
checkpoint interval count from there again), and no random state is
saved (the caller passes the generator).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pynqs_tpu_torch.energy.eloc import local_energy_reduce, local_energy_simple
from pynqs_tpu_torch.grad.energy_grad import energy_and_grad, energy_stats
from pynqs_tpu_torch.grad.sr import sr_gradient, sr_gradient_blocked, sr_gradient_cg
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops.fused_rnn import (
    fused_forward_available,
    graph_mpsrnn_logpsi_fused,
    pack_tables,
)
from pynqs_tpu_torch.ops.fused_rnn_prefix import ReducePrefixForward, prefix_available
from pynqs_tpu_torch.ops.integrals import precompute_hij_tables
from pynqs_tpu_torch.parallel.mesh import all_reduce_sum
from pynqs_tpu_torch.utils.checkpoint import (
    adam_state_tree,
    load_adam_state,
    load_checkpoint,
    optax_sgd_tree,
    save_checkpoint,
    sgd_schedule_count,
)
from pynqs_tpu_torch.utils.device import model_device_dtype
from pynqs_tpu_torch.utils.logging import RunLogger
from pynqs_tpu_torch.utils.stats import operator_stats
from pynqs_tpu_torch.utils.tree import flatten_tree, tree_named_parameters, unflatten_tree

__all__ = ["VMC", "VMCConfig", "ema_update"]


@dataclass
class VMCConfig:
    n_iter: int = 500
    # a float, or a schedule: update count -> lr (optim/schedule.py), as
    # optax's ``learning_rate: float | Schedule``
    lr: float | Callable[[int], float] = 1e-2
    # "adam" | "adamw" (decay 1e-4, optax's) | "sgd" (optax.sgd: no momentum)
    optimizer: str = "adam"
    eloc_batch: int | None = None  # samples per eloc chunk
    eloc_method: str = "simple"  # "simple" | "reduce"
    eloc_k_det: int = 256  # REDUCE: deterministic terms per sample
    eloc_n_stoch: int = 64  # REDUCE: stochastic tail draws per sample
    eloc_topk: str = "exact"  # REDUCE deterministic set: "exact" | "approx" | "segmax"
    grad_batch: int | None = None  # backward microbatch rows
    clip_grad: float | None = 1.0  # global-norm clip; None = off
    clip_schedule: Callable[[int], float] | None = None  # iteration -> max-norm
    # the gradient-free eloc forwards: True = the fused forward (its CUDA
    # kernel for a model on the card, its plain version on the CPU);
    # False = model.log_psi; None = the fused forward for a model on the
    # card, model.log_psi on the CPU (as the JAX package off the TPU)
    fused_forward: bool | None = None
    fused_matmul_dtype: str = "bf16"  # "bf16" | "f32"
    # REDUCE: the screened and tail children through the prefix-sharing
    # forward (ops/fused_rnn_prefix), which reuses each sample's
    # recurrence up to the child's first changed site; chain models only
    # (others take the flat forward)
    eloc_prefix: bool = False
    # REDUCE: evaluate ψ once per distinct row of each eloc chunk's
    # forward, at most this many (energy/eloc.dedup_eval, which raises
    # above it; size it with reduce_unique_count); exclusive with
    # eloc_prefix
    eloc_dedup_max: int | None = None
    log_every: int = 25
    log_path: str | None = None
    # log a warning when the sampler drops more than this share of the
    # sampled mass (a truncated measure biases the energy)
    dropped_warn: float = 0.005
    # a resume checkpoint every checkpoint_interval iterations
    checkpoint_path: str | None = None
    checkpoint_interval: int = 100
    # sample-count ramp: the sampler with n_sample = start_n_sample for
    # the first ramp_iter iterations
    start_n_sample: int | None = None
    ramp_iter: int = 0
    # 3σ clipping: after clip_window iterations the max-norm is
    # min(clip, mean + 3 std of the last clip_window gradient norms)
    adaptive_clip_3sigma: bool = False
    clip_window: int = 100
    # exponential moving average of the parameters, e ← d·e + (1−d)·p
    # after every update; ``VMC.ema_params``, saved under "ema"
    ema_decay: float | None = None
    # stochastic reconfiguration in place of the plain gradient
    # (grad/sr.py): "dense" [P, P] solve, "cg" matrix-free min-SR
    # (jac_batch = grad_batch), "blocked" per-tensor block-diagonal
    use_sr: bool = False
    sr_damping: float = 1e-3
    sr_solver: str = "dense"
    sr_n_cg: int = 50
    # freeze-and-sweep: iteration -> gradient mask {name: tensor}
    # (optim/sweep.site_freeze_mask); None = all trainable
    param_mask_fn: Callable[[int], dict] | None = None
    # trace iterations [2, 2 + profile_iters) with torch.profiler (CPU,
    # and CUDA for a model on the card) into profile_dir/trace_rank{r}.json
    profile_dir: str | None = None
    profile_iters: int = 3


_OPTIMIZERS = ("adam", "adamw", "sgd")
_SR_SOLVERS = ("dense", "cg", "blocked")


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float) -> dict:
    """One step of the parameter EMA, e ← d·e + (1−d)·p in e's dtype (the
    JAX loop's expression)."""
    d = float(decay)
    return {k: d * e + (1.0 - d) * params[k].to(e.dtype) for k, e in ema.items()}


class _NullLog:
    """The run log of a rank other than 0: writes nothing."""

    def info(self, msg):
        pass

    def record(self, **kv):
        pass

    def close(self):
        pass


class VMC:
    """Binds (model, system, sampler) into a training step and a loop.

    ``mesh``: the data-parallel mesh (``parallel.Mesh``); by default the
    sampler's.  A sampler without one is given it."""

    def __init__(self, model, system, sampler, config: VMCConfig | None = None, mesh=None):
        smesh = getattr(sampler, "mesh", None)
        if mesh is not None and smesh is not None and smesh is not mesh:
            raise ValueError("VMC and its sampler have different meshes")
        self.mesh = mesh if mesh is not None else smesh
        if self.mesh is not None and smesh is None:
            if not hasattr(sampler, "mesh"):
                raise ValueError(f"{type(sampler).__name__} takes no mesh")
            sampler = dataclasses.replace(sampler, mesh=self.mesh)
        self.model = model
        self.system = system
        self.sampler = sampler
        self.cfg = config or VMCConfig()
        if self.cfg.optimizer not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.cfg.optimizer!r}")
        if self.cfg.sr_solver not in _SR_SOLVERS:
            raise ValueError(f"unknown sr_solver {self.cfg.sr_solver!r}")
        dev, dt = model_device_dtype(model)
        # Hamiltonian arithmetic in the model's float type (f32 on the
        # card, f64 in the CPU tests); never bf16
        tabs = system.tables(dev, dt)
        self._ops = tabs.astuple()
        self._hpair = tabs.hpair_best
        self._table = system.excitation
        self.opt = self._new_optimizer()
        self.count = 0  # updates so far: the schedule's count
        self.ema_params: dict | None = None
        self.history: list[float] = []
        # a stateful sampler's chains (MCMC), threaded through step/run
        self.chain_state = None

    def _new_optimizer(self):
        # AdamW decays by optax.adamw's default 1e-4 (torch's default is
        # 0.01): every AdamW run of the JAX package passes optax.adamw(lr)
        opt, kw = {"adam": (torch.optim.Adam, {}),
                   "adamw": (torch.optim.AdamW, {"weight_decay": 1e-4}),
                   "sgd": (torch.optim.SGD, {})}[self.cfg.optimizer]
        return opt(self.model.parameters(), lr=self.lr_at(0), **kw)

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates."""
        lr = self.cfg.lr
        return float(lr(count)) if callable(lr) else float(lr)

    def _matmul_dtype(self):
        return {"bf16": torch.bfloat16, "f32": torch.float32}[self.cfg.fused_matmul_dtype]

    def _eloc_forward(self):
        """log ψ closure for the gradient-free eloc forwards."""
        use = self.cfg.fused_forward
        if use is None:
            use = model_device_dtype(self.model)[0].type != "cpu"
        if use:
            if fused_forward_available(self.model):
                return partial(
                    graph_mpsrnn_logpsi_fused, self.model,
                    matmul_dtype=self._matmul_dtype(), tables=pack_tables(self.model),
                )
            if self.cfg.fused_forward:
                raise ValueError("fused_forward=True needs a GraphMPSRNN model")
        return lambda b: self.model.log_psi(b).detach()

    def _eloc_prefix_fwd(self):
        """ReducePrefixForward for the REDUCE eloc (``cfg.eloc_prefix``);
        None where it is off or the model is not a plain chain."""
        if not self.cfg.eloc_prefix or not prefix_available(self.model):
            return None
        return ReducePrefixForward(self.model, matmul_dtype=self._matmul_dtype())

    def apply_gradients(self, grads: dict, scale=1.0) -> float:
        """One optimizer update with ``grads`` × ``scale`` at the scheduled
        learning rate ``lr_at(count)``; returns that rate."""
        lr = self.lr_at(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        for name, p in self.model.named_parameters():
            if name in grads:
                p.grad = (grads[name] * scale).to(p.dtype)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return lr

    def _sample(self, sampler, generator):
        """(bits, weights, diagnostics) of ``sampler``; a stateful sampler
        (MCMC) continues ``chain_state``, starting it on first use."""
        if not getattr(sampler, "stateful", False):
            return sampler.sample(self.model, generator)
        if self.chain_state is None:
            self.chain_state = sampler.init_state(self.model, generator)
        bits, w, diag, self.chain_state = sampler.sample(self.model, generator,
                                                         self.chain_state)
        return bits, w, diag

    @torch.no_grad()
    def reweight(self, bits, w, sampler):
        """Weights of ``sampler``'s draws as the model's |ψ|² measure.  A
        model with a ``log_factor`` f (``MultiPsi``, ``SpinProjected``) is
        sampled through its AR part φ, so counts of an AR sampler follow
        |φ|²: w ← w·|f|² where w > 0, renormalized.  Weights that already
        measure |ψ|² (exact enumeration, MCMC, RESTRICTED, exact weights)
        stay as they are: reweighting them too would give |φ|²|f|⁴ (the
        JAX step reweights whatever the sampler)."""
        if not (hasattr(self.model, "log_factor") and getattr(sampler, "ar_part_measure", False)):
            return w
        f2 = torch.exp(2.0 * self.model.log_factor(bits)[..., 0]).to(w.dtype)
        w = w * torch.where(w > 0, f2, torch.zeros_like(f2))
        return w / all_reduce_sum(self.mesh, w.sum())

    def sr_gradient(self, bits, w, eloc) -> dict:
        """The SR-preconditioned gradient by ``cfg.sr_solver``."""
        cfg = self.cfg
        if cfg.sr_solver == "cg":
            return sr_gradient_cg(self.model, bits, w, eloc, damping=cfg.sr_damping,
                                  n_cg=cfg.sr_n_cg, jac_batch=cfg.grad_batch, mesh=self.mesh)
        if cfg.sr_solver == "blocked":
            return sr_gradient_blocked(self.model, bits, w, eloc, damping=cfg.sr_damping,
                                       mesh=self.mesh)
        return sr_gradient(self.model, bits, w, eloc, damping=cfg.sr_damping, mesh=self.mesh)

    def local_energy(self, bits, generator):
        """The step's local energies of ``bits`` by ``cfg.eloc_method``."""
        fwd = self._eloc_forward()
        if self.cfg.eloc_method == "reduce":
            return local_energy_reduce(
                fwd, bits, self._ops, self._table, generator,
                k_det=self.cfg.eloc_k_det, n_stoch=self.cfg.eloc_n_stoch,
                batch=self.cfg.eloc_batch, hpair=self._hpair,
                topk=self.cfg.eloc_topk, dedup_unique_max=self.cfg.eloc_dedup_max,
                prefix_fwd=self._eloc_prefix_fwd(), mesh=self.mesh,
            )
        return local_energy_simple(fwd, bits, self._ops, self._table,
                                   batch=self.cfg.eloc_batch, hpair=self._hpair)

    def step(self, generator: torch.Generator, clip_val: float | None, sampler=None,
             gmask: dict | None = None):
        """One training step (samples from ``sampler``, default the VMC's
        own; ``gmask`` multiplies the gradient, as ``cfg.param_mask_fn``'s
        masks in ``run``); returns a dict of 0-d tensors (energy without
        ecore, variance, w_sum, n_eff, gnorm, dropped_frac, n_unique) and
        the update's lr.  Under a mesh every value is global, the same on
        every rank."""
        smp = sampler or self.sampler
        with record_function("vmc.sample"):
            bits, w, diag = self._sample(smp, generator)
            w = self.reweight(bits, w, smp)
        with record_function("vmc.eloc"):
            eloc = self.local_energy(bits, generator)
        if self.cfg.use_sr:
            with record_function("vmc.sr"):
                # the plain gradient would be discarded: its backward is not run
                e, var = energy_stats(w, eloc, self.mesh)
                grads = self.sr_gradient(bits, w, eloc)
        else:
            with record_function("vmc.grad"):
                e, grads, var = energy_and_grad(self.model, bits, w, eloc,
                                                grad_batch=self.cfg.grad_batch, mesh=self.mesh)
        with record_function("vmc.update"):
            if gmask is not None:
                grads = {k: g * gmask[k] for k, g in grads.items()}
            gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            scale = 1.0
            if clip_val is not None:
                scale = torch.clamp(clip_val / torch.clamp(gnorm, min=1e-30), max=1.0)
            lr = self.apply_gradients(grads, scale)
        w_sum, w2 = all_reduce_sum(self.mesh, torch.stack([w.sum(), (w**2).sum()]))
        return {
            "lr": lr,
            "energy": e[0],
            "var": var,
            "w_sum": w_sum,
            "n_eff": 1.0 / torch.clamp(w2, min=1e-30),
            "gnorm": gnorm,
            "dropped_frac": diag["dropped_frac"],
            "n_unique": diag["n_unique"],
        }

    @torch.no_grad()
    def noise_tune(self, generator: torch.Generator, scale: float = 0.1) -> dict:
        """NoisyTune: add (U(0, 1) − ½)·std(p)·scale to every parameter
        tensor in place (std over the tensor, ddof 0); returns the
        parameters."""
        named = self._named()
        for name in sorted(named):
            p = named[name]
            u = torch.rand(p.shape, generator=generator, dtype=p.dtype, device=p.device)
            p.add_((u - 0.5) * p.std(correction=0) * scale)
        return named

    def operator_expected(self, operator_tables, generator: torch.Generator, sampler=None):
        """⟨O⟩ ± se for an operator given as (dense h1e, compressed h2e),
        e.g. ``ops.integrals.spin_raising`` for ⟨S⁻S⁺⟩: the operator's
        tables on the model's device and dtype, with the dense pair
        matrix as the doubles operand; samples from ``sampler`` (default
        the VMC's own; an ``ExactSampler`` gives the exact measure); the
        local operator by ``cfg.eloc_method``.  Returns ``OperatorStats``."""
        dev, dt = model_device_dtype(self.model)
        h1e_o, h2e_o = operator_tables
        t = precompute_hij_tables(np.asarray(h1e_o), np.asarray(h2e_o), self.system.sorb,
                                  self.system.dtype)

        def put(a):
            return torch.as_tensor(np.asarray(a), device=dev).to(dt)

        ops = tuple(put(x) for x in (t.h1e, t.h2e, t.diag1, t.K, t.J))
        hp = None if t.Hpair is None else put(t.Hpair)
        smp = sampler or self.sampler
        if self.mesh is not None and getattr(smp, "mesh", None) is None:
            smp = dataclasses.replace(smp, mesh=self.mesh)
        if getattr(smp, "stateful", False):  # fresh chains, as the JAX package
            bits, w = smp.sample(self.model, generator, smp.init_state(self.model, generator))[:2]
        else:
            bits, w, _ = smp.sample(self.model, generator)
        w = self.reweight(bits, w, smp)
        fwd = self._eloc_forward()
        if self.cfg.eloc_method == "reduce":
            oloc = local_energy_reduce(
                fwd, bits, ops, self._table, generator,
                k_det=self.cfg.eloc_k_det, n_stoch=self.cfg.eloc_n_stoch,
                batch=self.cfg.eloc_batch, hpair=hp, topk=self.cfg.eloc_topk,
                prefix_fwd=self._eloc_prefix_fwd(), mesh=self.mesh,
            )
        else:
            oloc = local_energy_simple(fwd, bits, ops, self._table,
                                       batch=self.cfg.eloc_batch, hpair=hp)
        return operator_stats(oloc[:, 0], w, mesh=self.mesh)

    # ---------------- checkpoints ----------------

    def _named(self) -> dict:
        """{dotted JAX-tree path: parameter} (``utils/tree.py``)."""
        return tree_named_parameters(self.model)

    def save_checkpoint(self, path: str, step: int) -> None:
        """The JAX package's resume file: parameters, the optimizer state
        as ``optax.adam``/``adamw``/``sgd`` lays it out (with the schedule
        count where ``cfg.lr`` is a schedule), the history and the EMA."""
        named = self._named()
        sched = self.count if callable(self.cfg.lr) else None
        if self.cfg.optimizer == "sgd":
            opt_state = optax_sgd_tree(sched)
        else:
            opt_state = adam_state_tree(self.opt, named, sched,
                                        decay=self.cfg.optimizer == "adamw")
        ema = None if self.ema_params is None else {"ema": unflatten_tree(self.ema_params)}
        save_checkpoint(path, step, unflatten_tree(named), opt_state, self.history, extra=ema)

    def restore(self, path: str) -> dict:
        """Load a resume file of either package: the parameters into the
        model, the Adam moments and count into a fresh optimizer (SGD has
        none), the schedule count, the history and (when the file has one)
        the EMA into ``ema_params``.  Returns the file's tree."""
        ck = load_checkpoint(path)
        self.model.load_numpy_params(ck["params"])
        self.opt = self._new_optimizer()
        if self.cfg.optimizer == "sgd":
            self.count = sgd_schedule_count(ck["opt_state"])
        else:
            self.count = load_adam_state(self.opt, self._named(), ck["opt_state"])
        self.history = [float(e) for e in ck["history"]]
        self.ema_params = None
        if ck.get("ema") is not None:
            ema = flatten_tree(ck["ema"])
            self.ema_params = {
                k: torch.as_tensor(np.asarray(ema[k])).reshape(p.shape).to(p).clone()
                for k, p in self._named().items()}
        return ck

    def run(
        self,
        generator: torch.Generator,
        n_iter: int | None = None,
        callback: Callable[[int, dict], None] | None = None,
        resume_from: str | None = None,
    ) -> list[float]:
        """Optimize; returns the energy history (total, ecore included).

        ``resume_from``: a resume file of either package (``restore``);
        otherwise the optimizer starts fresh.  Raises FloatingPointError
        on a NaN energy or a dead sampler."""
        cfg = self.cfg
        n_iter = n_iter or cfg.n_iter
        gnorms: list[float] = []
        if resume_from is not None:
            self.restore(resume_from)
        else:
            self.opt = self._new_optimizer()
            self.count = 0
        if cfg.ema_decay is None:
            self.ema_params = None
        elif resume_from is None or self.ema_params is None:
            self.ema_params = {k: p.detach().clone() for k, p in self._named().items()}
        ramp = None
        if (cfg.start_n_sample is not None and cfg.ramp_iter > 0
                and hasattr(self.sampler, "n_sample")):
            ramp = dataclasses.replace(self.sampler, n_sample=cfg.start_n_sample)
        self.chain_state = None
        if getattr(self.sampler, "stateful", False):
            # MCMC: start the chains and thermalize them once, before the loop
            self.chain_state = self.sampler.init_state(self.model, generator)
            therm = int(getattr(self.sampler, "therm", 0) or 0)
            if therm > 0:
                self.chain_state = self.sampler.run(self.model, generator, self.chain_state,
                                                    therm)[0]
        clip_on = cfg.clip_grad is not None or cfg.clip_schedule is not None
        ecore, e_ref = self.system.ecore, self.system.e_ref
        rank0 = self.mesh is None or self.mesh.rank == 0
        log = RunLogger(cfg.log_path) if rank0 else _NullLog()
        prof = None
        try:
            for it in range(n_iter):
                if cfg.profile_dir is not None and it == 2:
                    prof = self._start_profile()
                t0 = time.perf_counter()
                clip_val = cfg.clip_grad if cfg.clip_grad is not None else 0.0
                if cfg.clip_schedule is not None:
                    clip_val = float(cfg.clip_schedule(it))
                if cfg.adaptive_clip_3sigma and len(gnorms) >= cfg.clip_window:
                    recent = np.asarray(gnorms[-cfg.clip_window:])
                    clip_val = min(clip_val, float(recent.mean() + 3 * recent.std()))
                mask = {} if cfg.param_mask_fn is None else {"gmask": cfg.param_mask_fn(it)}
                out = self.step(generator, clip_val if clip_on else None,
                                ramp if ramp is not None and it < cfg.ramp_iter else None,
                                **mask)
                if cfg.ema_decay is not None:
                    self.ema_params = ema_update(self.ema_params, self._named(), cfg.ema_decay)
                gnorms.append(float(out["gnorm"]))
                e_tot = float(out["energy"]) + ecore
                w_sum = float(out["w_sum"])
                dt = time.perf_counter() - t0
                if math.isnan(e_tot) or not w_sum > 0.0:
                    # NaN parameters give zero sample counts, which read as
                    # E = 0 rather than NaN: both stop the run
                    log.info(f"iter {it}: energy NaN or dead sampler "
                             f"(w_sum={w_sum}) — aborting run")
                    raise FloatingPointError(
                        f"NaN/dead-sampler at iteration {it} (w_sum={w_sum}); "
                        f"last good: {self.history[-1] if self.history else None}"
                    )
                self.history.append(e_tot)
                if callback is not None:
                    info = {k: float(v) for k, v in out.items()}
                    info["energy_total"] = e_tot
                    info["iter_time"] = time.perf_counter() - t0
                    callback(it, info)
                if it % cfg.log_every == 0 or it == n_iter - 1:
                    self._log(log, it, out, e_tot, e_ref, dt)
                if (rank0 and cfg.checkpoint_path is not None
                        and (it + 1) % cfg.checkpoint_interval == 0):
                    self.save_checkpoint(cfg.checkpoint_path, it)
                if prof is not None and it == 1 + cfg.profile_iters:
                    self._stop_profile(prof, log)
                    prof = None
        finally:
            if prof is not None:
                self._stop_profile(prof, log)
            log.close()
        return self.history

    def _start_profile(self):
        fused_rnn.ROWS.reset()
        fused_rnn.DISTINCT.reset()
        acts = [ProfilerActivity.CPU]
        if model_device_dtype(self.model)[0].type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, log) -> str:
        """Stop the trace at the end of the traced iterations (after the
        card has finished them) and write it; the fused forward's rows and
        distinct rows over the traced iterations (``fused_rnn.ROWS``,
        ``DISTINCT``) go to the run log as one record.  Returns the
        trace's path."""
        if model_device_dtype(self.model)[0].type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_rank{0 if self.mesh is None else self.mesh.rank}.json")
        prof.export_chrome_trace(path)
        log.record(trace=path, fused_rows=int(fused_rnn.ROWS.n),
                   fused_distinct=int(fused_rnn.DISTINCT.n))
        return path

    def _log(self, log, it: int, out: dict, e_tot: float, e_ref, dt: float) -> None:
        """The JAX loop's human line and ``@@`` record of one iteration."""
        var, n_eff = float(out["var"]), float(out["n_eff"])
        extra = f" Δref={1000 * (e_tot - e_ref):+.3f} mHa" if e_ref is not None else ""
        se = (var / max(n_eff, 1.0)) ** 0.5
        drop_f = float(out["dropped_frac"])
        drop_s = f" drop={100 * drop_f:.3f}%" if drop_f >= 0 else ""
        log.info(f"iter {it:5d}  E = {e_tot:.8f} ± {se:.2e} Ha  "
                 f"σ² = {var:.3e}  t = {dt:.3f}s{extra}{drop_s}")
        log.record(iter=it, energy=e_tot, var=var, se=se, n_eff=n_eff, iter_time=dt,
                   dropped_frac=drop_f, n_unique=float(out["n_unique"]))
        if drop_f > self.cfg.dropped_warn:
            log.info(f"iter {it:5d}  WARNING: {100 * drop_f:.2f}% of the sampled mass was "
                     f"dropped (capacity truncation) — energies are biased; raise "
                     f"capacity/n_group")
