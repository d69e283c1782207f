"""VMC optimization loop.

Counterpart of ``pynqs_tpu/optim/vmc.py`` (``VMC``, ``VMCConfig``),
restricted to the fields of the flagship step.  One step: AR sampling
→ local energy (SIMPLE or REDUCE; the ψ ratio forwards go through the
fused forward) → pair-form gradient → clip → Adam/AdamW update;
``operator_expected`` measures any operator on the state.  Not
ported yet (ROADMAP): SR, freeze-and-sweep, EMA, profiling,
checkpoint resume, the sample-count ramp, 3σ clipping, the mesh.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce, local_energy_simple
from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
from pynqs_tpu_torch.ops.fused_rnn import (
    fused_forward_available,
    graph_mpsrnn_logpsi_fused,
    pack_tables,
)
from pynqs_tpu_torch.ops.fused_rnn_prefix import ReducePrefixForward, prefix_available
from pynqs_tpu_torch.ops.integrals import precompute_hij_tables
from pynqs_tpu_torch.utils.stats import operator_stats

__all__ = ["VMC", "VMCConfig"]


@dataclass
class VMCConfig:
    n_iter: int = 500
    lr: float = 1e-2
    optimizer: str = "adam"  # "adam" | "adamw"
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


class VMC:
    """Binds (model, system, sampler) into a training step and a loop."""

    def __init__(self, model, system, sampler, config: VMCConfig | None = None):
        self.model = model
        self.system = system
        self.sampler = sampler
        self.cfg = config or VMCConfig()
        dev = model.M_re.device
        # Hamiltonian arithmetic in the model's float type (f32 on the
        # card, f64 in the CPU tests); never bf16
        tabs = system.tables(dev, model.M_re.dtype)
        self._ops = tabs.astuple()
        self._hpair = tabs.hpair_best
        self._table = system.excitation
        # AdamW decays by optax.adamw's default 1e-4 (torch's default is
        # 0.01): every AdamW run of the JAX package passes optax.adamw(lr)
        opt, kw = {"adam": (torch.optim.Adam, {}),
                   "adamw": (torch.optim.AdamW, {"weight_decay": 1e-4})}[self.cfg.optimizer]
        self.opt = opt(model.parameters(), lr=self.cfg.lr, **kw)
        self.history: list[float] = []

    def _matmul_dtype(self):
        return {"bf16": torch.bfloat16, "f32": torch.float32}[self.cfg.fused_matmul_dtype]

    def _eloc_forward(self):
        """log ψ closure for the gradient-free eloc forwards."""
        use = self.cfg.fused_forward
        if use is None:
            use = self.model.M_re.device.type != "cpu"
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

    def step(self, generator: torch.Generator, clip_val: float | None):
        """One training step; returns a dict of 0-d tensors (energy
        without ecore, variance, w_sum, n_eff, gnorm, dropped_frac,
        n_unique)."""
        bits, w, diag = self.sampler.sample(self.model, generator)
        fwd = self._eloc_forward()
        if self.cfg.eloc_method == "reduce":
            eloc = local_energy_reduce(
                fwd, bits, self._ops, self._table, generator,
                k_det=self.cfg.eloc_k_det, n_stoch=self.cfg.eloc_n_stoch,
                batch=self.cfg.eloc_batch, hpair=self._hpair,
                topk=self.cfg.eloc_topk, prefix_fwd=self._eloc_prefix_fwd(),
            )
        else:
            eloc = local_energy_simple(
                fwd, bits, self._ops, self._table,
                batch=self.cfg.eloc_batch, hpair=self._hpair,
            )
        e, grads, var = energy_and_grad(
            self.model, bits, w, eloc, grad_batch=self.cfg.grad_batch
        )
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0
        if clip_val is not None:
            scale = torch.clamp(clip_val / torch.clamp(gnorm, min=1e-30), max=1.0)
        for name, p in self.model.named_parameters():
            if name in grads:
                p.grad = (grads[name] * scale).to(p.dtype)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return {
            "energy": e[0],
            "var": var,
            "w_sum": w.sum(),
            "n_eff": 1.0 / torch.clamp((w**2).sum(), min=1e-30),
            "gnorm": gnorm,
            "dropped_frac": diag["dropped_frac"],
            "n_unique": diag["n_unique"],
        }

    def operator_expected(self, operator_tables, generator: torch.Generator, sampler=None):
        """⟨O⟩ ± se for an operator given as (dense h1e, compressed h2e),
        e.g. ``ops.integrals.spin_raising`` for ⟨S⁻S⁺⟩: the operator's
        tables on the model's device and dtype, with the dense pair
        matrix as the doubles operand; samples from ``sampler`` (default
        the VMC's own; an ``ExactSampler`` gives the exact measure); the
        local operator by ``cfg.eloc_method``.  Returns ``OperatorStats``."""
        dev, dt = self.model.M_re.device, self.model.M_re.dtype
        h1e_o, h2e_o = operator_tables
        t = precompute_hij_tables(np.asarray(h1e_o), np.asarray(h2e_o), self.system.sorb,
                                  self.system.dtype)

        def put(a):
            return torch.as_tensor(np.asarray(a), device=dev).to(dt)

        ops = tuple(put(x) for x in (t.h1e, t.h2e, t.diag1, t.K, t.J))
        hp = None if t.Hpair is None else put(t.Hpair)
        bits, w, _ = (sampler or self.sampler).sample(self.model, generator)
        fwd = self._eloc_forward()
        if self.cfg.eloc_method == "reduce":
            oloc = local_energy_reduce(
                fwd, bits, ops, self._table, generator,
                k_det=self.cfg.eloc_k_det, n_stoch=self.cfg.eloc_n_stoch,
                batch=self.cfg.eloc_batch, hpair=hp, topk=self.cfg.eloc_topk,
                prefix_fwd=self._eloc_prefix_fwd(),
            )
        else:
            oloc = local_energy_simple(fwd, bits, ops, self._table,
                                       batch=self.cfg.eloc_batch, hpair=hp)
        return operator_stats(oloc[:, 0], w)

    def run(
        self,
        generator: torch.Generator,
        n_iter: int | None = None,
        callback: Callable[[int, dict], None] | None = None,
    ) -> list[float]:
        """Optimize; returns the energy history (total, ecore included).
        Raises FloatingPointError on a NaN energy or a dead sampler."""
        n_iter = n_iter or self.cfg.n_iter
        for it in range(n_iter):
            t0 = time.perf_counter()
            clip_val = self.cfg.clip_grad
            if self.cfg.clip_schedule is not None:
                clip_val = float(self.cfg.clip_schedule(it))
            out = self.step(generator, clip_val)
            e_tot = float(out["energy"]) + self.system.ecore
            w_sum = float(out["w_sum"])
            if math.isnan(e_tot) or not w_sum > 0.0:
                # NaN parameters give zero sample counts, which read as
                # E = 0 rather than NaN: both stop the run
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
        return self.history
