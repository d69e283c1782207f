"""Autoregressive RBM (NADE-style 1-site conditionals).

Counterpart of ``pynqs_tpu/models/ar_rbm.py``.  The hidden
pre-activation is a running sum updated in O(nh) per site,

    θ_k = c + Σ_{j<k} W[:, j] x_j          (x = ±1 spins)
    p(x_k | x_<k) = softmax( U_k tanh(θ_k) + d_k )   over x_k ∈ {0, 1}

so AR sampling carries θ [C, nh] alone; the phase is an MLP over the
whole configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.models.base import TreeModel, normal_init
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.onv import bits_to_spins
from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_one_site_rows
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["ARRBM"]


class ARRBM(TreeModel):
    sites_per_step = 1

    def __init__(self, sorb: int, noa: int, nob: int, nh: int = 32, phase_hidden: int = 32,
                 dtype=torch.float64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.sorb, self.noa, self.nob = sorb, noa, nob
        self.nh, self.phase_hidden = nh, phase_hidden
        dev = resolve_device(device)
        nrm = normal_init(generator, dtype, dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.register_tree({
            "W": nrm((nh, sorb), 0.1),
            "c": zeros(nh),
            "U": nrm((sorb, 2, nh), 1.0 / np.sqrt(nh)),
            "d": zeros(sorb, 2),
            "ph_w1": nrm((sorb, phase_hidden), 0.1),
            "ph_b1": zeros(phase_hidden),
            "ph_w2": nrm((phase_hidden,), 0.1),
        })

    # ---------------- AR contract ----------------

    def ar_init(self, capacity: int):
        return self.c.expand(capacity, self.nh)

    def ar_step(self, carry, k: int, prev):
        theta = carry
        if k > 0:
            x_prev = 2.0 * prev.to(self.W.dtype) - 1.0
            theta = theta + x_prev[:, None] * self.W[:, k - 1][None, :]
        logits = torch.tanh(theta) @ self.U[k].T + self.d[k]
        return torch.log_softmax(logits, -1), theta

    # ---------------- forward ----------------

    def log_psi(self, bits):
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        B = bits.shape[0]
        dt = self.W.dtype
        x = bits_to_spins(bits, dt)  # [B, sorb]
        # θ before each site: exclusive cumulative sum of W columns
        theta_cum = torch.cumsum(x[:, None, :] * self.W[None], -1)  # [B, nh, sorb]
        theta_excl = torch.cat([torch.zeros(B, self.nh, 1, dtype=dt, device=bits.device),
                                theta_cum[..., :-1]], -1) + self.c[None, :, None]
        logits = torch.einsum("bhk,kvh->bkv", torch.tanh(theta_excl), self.U) + self.d[None]
        logp = apply_mask_logp(torch.log_softmax(logits, -1),
                               mask_one_site_rows(bits, self.noa, self.nob))
        log_amp = 0.5 * logp.gather(-1, bits[..., None])[..., 0].sum(-1)
        phase = torch.tanh(x @ self.ph_w1 + self.ph_b1) @ self.ph_w2
        out = cplx.make(log_amp, phase)
        return out[0] if squeeze else out
