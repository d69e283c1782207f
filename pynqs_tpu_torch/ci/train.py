"""CI pre-training: fit an NQS ansatz to a CI wavefunction before VMC.

Counterpart of ``pynqs_tpu/ci/train.py`` (``CITrain``, ``CITrainConfig``),
with its three losses over the model's own parameters:

  * "overlap":  L = 1 − |⟨ψ_CI|ψ⟩_S|² / ⟨ψ|ψ⟩_S on the CI set S;
  * "sample":   L = 1 − |⟨o⟩_p|² / ⟨|o|²⟩_p with o(n) = ψ_CI(n)/ψ(n) and
    p = |ψ|² from the model's own AR sampling (``ar_sampling``, no
    gradient; ψ_CI read from a ``WavefunctionLUT``);
  * "lsm":      Σ_S |ψ(n)/‖ψ‖_S − c_n|², the global phase learned by the
    model.

The optimizer is ``torch.optim.Adam`` with optax.adam's defaults (β 0.9,
0.999, ε 1e-8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.lut import WavefunctionLUT
from pynqs_tpu_torch.sampler.ar import ar_sampling

__all__ = ["CITrain", "CITrainConfig", "LOSSES"]

LOSSES = ("overlap", "sample", "lsm")


@dataclass
class CITrainConfig:
    n_iter: int = 500
    lr: float = 1e-2
    loss: str = "overlap"  # one of LOSSES
    n_sample: int = 1 << 12  # loss == "sample"
    capacity: int = 1 << 10
    log_every: int = 50


class CITrain:
    """Fits ``model`` (its parameters, in place) to ``ci``; the CI set and
    coefficients go to the model's device."""

    def __init__(self, model, ci: CIWavefunction, config: CITrainConfig | None = None):
        self.model = model
        self.ci = ci
        self.cfg = config or CITrainConfig()
        if self.cfg.loss not in LOSSES:
            raise ValueError(f"unknown CITrain loss {self.cfg.loss!r}")
        dev = model.M_re.device
        self._bits = torch.as_tensor(np.asarray(ci.bits), device=dev).to(torch.int8)
        self._c = torch.as_tensor(np.asarray(ci.coeffs, np.float64), device=dev)
        self.opt = torch.optim.Adam(model.parameters(), lr=self.cfg.lr)
        if self.cfg.loss == "sample":
            logc = torch.log(self._c.abs().clamp(min=1e-30))
            phc = torch.where(self._c < 0, torch.full_like(self._c, np.pi), 0.0)
            self._lut = WavefunctionLUT.build(self._bits, torch.stack([logc, phc], -1))
        self.history: list[float] = []

    def set_loss(self) -> torch.Tensor:
        """The "overlap" or "lsm" loss on the CI set, with its graph."""
        re, im = cplx.exp_pair(self.model.log_psi(self._bits).to(self._c.dtype))
        den = (re**2 + im**2).sum()
        if self.cfg.loss == "overlap":
            return 1.0 - ((self._c @ re) ** 2 + (self._c @ im) ** 2) / den
        scale = torch.sqrt(den)
        return ((re / scale - self._c) ** 2 + (im / scale) ** 2).sum()

    def sample_loss(self, bits: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """The "sample" loss on drawn rows ``bits`` [C, sorb] with their
        ``counts`` [C], with its graph.  Dead slots (count 0) carry no
        weight and are dropped before the forward, so no inf reaches the
        backward."""
        w = counts.to(torch.float64)
        w = w / w.sum().clamp(min=1.0)
        live = w > 0
        w, bits = w[live], bits[live]
        vals, found = self._lut.lookup(bits, fill=0.0)
        lp_ci = torch.stack([torch.where(found, vals[:, 0], -690.0), vals[:, 1]], -1)
        o_re, o_im = cplx.ratio_re_im(lp_ci, self.model.log_psi(bits).to(w.dtype))
        num = (w @ o_re) ** 2 + (w @ o_im) ** 2
        den = (w * (o_re**2 + o_im**2)).sum()
        return 1.0 - num / den.clamp(min=1e-30)

    def step(self, generator: torch.Generator) -> float:
        """One Adam update; returns the loss before it."""
        if self.cfg.loss == "sample":
            bits, counts, _ = ar_sampling(self.model, self.cfg.n_sample,
                                          capacity=self.cfg.capacity, generator=generator)
            loss = self.sample_loss(bits, counts)
        else:
            loss = self.set_loss()
        self.opt.zero_grad()
        loss.backward()
        for p in self.model.parameters():  # optax updates every leaf, zero gradients too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        return float(loss.detach())

    def run(self, generator: torch.Generator) -> list[float]:
        """``n_iter`` updates from the model's current parameters, with a
        fresh optimizer state (as the JAX ``run``); returns the losses."""
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.cfg.lr)
        for _ in range(self.cfg.n_iter):
            self.history.append(self.step(generator))
        return self.history

    @torch.no_grad()
    def overlap(self) -> float:
        """|⟨ψ_CI|ψ⟩| / ‖ψ‖ on the CI set (a diagnostic)."""
        re, im = cplx.exp_pair(self.model.log_psi(self._bits).to(self._c.dtype))
        num = torch.sqrt((self._c @ re) ** 2 + (self._c @ im) ** 2)
        return float(num / torch.sqrt((re**2 + im**2).sum()))
