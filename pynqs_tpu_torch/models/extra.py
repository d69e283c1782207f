"""Non-autoregressive correction and amplitude models, and composites.

Counterpart of ``pynqs_tpu/models/extra.py``: ``Jastrow``, ``IsingRBM``
and ``DBM`` are plain log-ψ models (MCMC or exact sampling, or a
multiplicative correction inside ``MultiPsi``); ``HybridWavefunction``,
``MultiPsi`` and ``SpinProjected`` wrap other models and sample through
their AR model.  A wrapper's parameter tree is
``{"amp": ..., "phase": ...}`` (Hybrid), ``{"phi": ..., "f": ...}``
(MultiPsi) or the base model's own (SpinProjected).
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.models.base import TreeModel, normal_init
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.onv import bits_to_spins, spin_flip_bits, spin_flip_sign
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = [
    "Jastrow",
    "DBM",
    "IsingRBM",
    "HybridWavefunction",
    "MultiPsi",
    "SpinProjected",
]


def _pair0(logabs):
    """Positive real wave function -> (log|ψ|, 0) pair."""
    return cplx.make(logabs, torch.zeros_like(logabs))


class Jastrow(TreeModel):
    """log ψ = ½ xᵀ W x + a·x (pairwise Jastrow factor)."""

    def __init__(self, sorb: int, dtype=torch.float64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.sorb = sorb
        dev = resolve_device(device)
        W = normal_init(generator, dtype, dev)((sorb, sorb), 0.01)
        self.register_tree({"W": (W + W.T) / 2,
                            "a": torch.zeros(sorb, dtype=dtype, device=dev)})

    def log_psi(self, bits):
        x = bits_to_spins(bits, self.W.dtype)
        out = 0.5 * torch.einsum("...p,pq,...q->...", x, self.W, x)
        return _pair0(out + x @ self.a)


class IsingRBM(TreeModel):
    """RBM with spin-pair (Ising) visible couplings feeding the hidden
    layer, θ_j = Σ_pq W_j,pq x_p x_q + b_j; real or complex parameters."""

    def __init__(self, sorb: int, alpha: int = 1, param_type: str = "real",
                 dtype=torch.float64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if param_type not in ("real", "complex"):
            raise ValueError(f"unknown param_type {param_type!r}")
        self.sorb, self.alpha, self.param_type = sorb, alpha, param_type
        dev = resolve_device(device)
        nrm = normal_init(generator, dtype, dev)
        nh = self.nh
        tree = {"W": nrm((nh, sorb, sorb), 0.01),
                "b": torch.zeros(nh, dtype=dtype, device=dev),
                "a": nrm((sorb,), 0.01)}
        if param_type == "complex":
            tree.update(W_im=nrm((nh, sorb, sorb), 0.01),
                        b_im=torch.zeros(nh, dtype=dtype, device=dev),
                        a_im=nrm((sorb,), 0.01))
        self.register_tree(tree)

    @property
    def nh(self) -> int:
        return self.alpha * self.sorb

    def log_psi(self, bits):
        x = bits_to_spins(bits, self.W.dtype)
        th_re = torch.einsum("...p,jpq,...q->...j", x, self.W, x) + self.b
        vis_re = x @ self.a
        if self.param_type == "complex":
            th_im = torch.einsum("...p,jpq,...q->...j", x, self.W_im, x) + self.b_im
            vis_im = x @ self.a_im
        else:
            th_im = torch.zeros_like(th_re)
            vis_im = torch.zeros_like(vis_re)
        la, ph = cplx.log2cosh_pair(th_re, th_im)
        return cplx.make(vis_re + la.sum(-1), vis_im + ph.sum(-1))


class DBM(TreeModel):
    """Deep Boltzmann machine with the second hidden layer traced out
    analytically: two stacked cosh layers."""

    def __init__(self, sorb: int, nh1: int = 32, nh2: int = 32, dtype=torch.float64, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.sorb, self.nh1, self.nh2 = sorb, nh1, nh2
        dev = resolve_device(device)
        nrm = normal_init(generator, dtype, dev)
        self.register_tree({
            "W1": nrm((sorb, nh1), 1.0 / np.sqrt(sorb)),
            "b1": torch.zeros(nh1, dtype=dtype, device=dev),
            "W2": nrm((nh1, nh2), 1.0 / np.sqrt(nh1)),
            "b2": torch.zeros(nh2, dtype=dtype, device=dev),
            "a": nrm((sorb,), 0.01),
        })

    def log_psi(self, bits):
        x = bits_to_spins(bits, self.W1.dtype)
        t1 = torch.tanh(x @ self.W1 + self.b1)
        t2 = x @ self.a + torch.log(2 * torch.cosh(t1 @ self.W2 + self.b2)).sum(-1)
        return _pair0(t2)


class _Wrapper(TreeModel):
    """Takes the AR contract's attributes from the model it samples with."""

    def _ar_attrs(self, model):
        self.sorb = model.sorb
        self.noa = getattr(model, "noa", None)
        self.nob = getattr(model, "nob", None)
        self.sites_per_step = getattr(model, "sites_per_step", None)
        self.site_order = getattr(model, "site_order", None)


class HybridWavefunction(_Wrapper):
    """ψ = |amp(x)| · e^{iφ(x)}: a real AR amplitude model times a phase
    network whose log-magnitude output is the phase angle φ(x); AR
    sampling delegates to the amplitude model."""

    def __init__(self, amp_model, phase_model):
        super().__init__()
        self.amp = amp_model
        self.phase = phase_model
        self._ar_attrs(amp_model)

    def log_psi(self, bits):
        la = self.amp.log_psi(bits)
        lp = self.phase.log_psi(bits)
        return cplx.make(la[..., 0], la[..., 1] + lp[..., 0])

    def ar_init(self, capacity):
        return self.amp.ar_init(capacity)

    def ar_step(self, carry, k, prev):
        return self.amp.ar_step(carry, k, prev)


class MultiPsi(_Wrapper):
    """ψ(n) = φ(n) · f(n): an AR model φ times a correction f.  Samples
    come from |φ|²; ``log_factor`` = log f lets ``VMC`` reweight them by
    |f|²."""

    def __init__(self, sample_model, factor_model):
        super().__init__()
        self.phi = sample_model
        self.f = factor_model
        self._ar_attrs(sample_model)

    def log_psi(self, bits):
        return self.phi.log_psi(bits) + self.f.log_psi(bits)

    def log_factor(self, bits):
        return self.f.log_psi(bits)

    def ar_init(self, capacity):
        return self.phi.ar_init(capacity)

    def ar_step(self, carry, k, prev):
        return self.phi.ar_step(carry, k, prev)


class SpinProjected(_Wrapper):
    """Spin-flip projection P̂η = (1 + η Û_SF)/2:

        ψ_P(n) = [ψ(n) + η · s(n) · ψ(n̄)] / 2

    with n̄ the α↔β flipped determinant, s(n) the fermionic sign of the
    flip and η = (−1)^{N/2 − S}.  Samples come from the base |ψ|²;
    ``log_factor`` = log(ψ_P/ψ) lets ``VMC`` reweight them.  The
    parameter tree is the base model's own."""

    tree_transparent = "base"

    def __init__(self, base, eta: int):
        super().__init__()
        self.base = base
        self.eta = float(eta)
        self._ar_attrs(base)

    def log_psi(self, bits):
        lp = self.base.log_psi(bits)
        lpf = self.base.log_psi(spin_flip_bits(bits))
        s = spin_flip_sign(bits).to(lp.dtype)
        lpf_signed = cplx.make(lpf[..., 0], lpf[..., 1] + np.pi * (1.0 - s) / 2.0)
        return cplx.add_exp(lp, lpf_signed, 0.5, 0.5 * self.eta)

    def log_factor(self, bits):
        """log(ψ_P/ψ) for the sampling-measure reweighting."""
        return self.log_psi(bits) - self.base.log_psi(bits)

    def ar_init(self, capacity):
        return self.base.ar_init(capacity)

    def ar_step(self, carry, k, prev):
        return self.base.ar_step(carry, k, prev)
