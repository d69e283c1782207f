"""Autoregressive RBM with 2-site (4-way) cosh-product conditionals.

Counterpart of ``pynqs_tpu/models/ar_rbm2.py``: for each spatial block t
(spin orbitals 2t, 2t+1) the four values x ∈ {00, 10, 01, 11} are scored
by the RBM free-energy product

    val_x = Π_h 2 cosh( θ_t,h + s_a(x)·W[h, 2t] + s_b(x)·W[h, 2t+1] )

with θ_t = c + Σ_{sites < 2t} W·s the running hidden pre-activation, and
L2-normalized: P(x) = val_x² / Σ val².  Sampling carries θ [C, nh]; the
phase is an MLP over the whole configuration plus a global phase.
"""

from __future__ import annotations

import torch

from pynqs_tpu_torch.models.base import TreeModel, normal_init
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.onv import bits_to_spins
from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_two_site
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["ARRBM2"]

# the 4 block values x = a + 2b as (s_a, s_b) spin pairs
_SA = (-1.0, 1.0, -1.0, 1.0)
_SB = (-1.0, -1.0, 1.0, 1.0)


def _log2cosh(x):
    """log(2 cosh x) in the stable form |x| + log1p(e^{−2|x|})."""
    a = torch.abs(x)
    return a + torch.log1p(torch.exp(-2.0 * a))


class ARRBM2(TreeModel):
    sites_per_step = 2

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
            "ph_w1": nrm((sorb, phase_hidden), 0.1),
            "ph_b1": zeros(phase_hidden),
            "ph_w2": nrm((phase_hidden,), 0.1),
            "global_phase": zeros(),
        })

    @property
    def n_blocks(self) -> int:
        return self.sorb // 2

    def _block_logval(self, theta, t: int):
        """log Π_h 2cosh(θ + s_a W_a + s_b W_b) for the 4 values:
        θ [C, nh] -> [C, 4]."""
        wa, wb = self.W[:, 2 * t], self.W[:, 2 * t + 1]
        sa = torch.tensor(_SA, dtype=theta.dtype, device=theta.device)
        sb = torch.tensor(_SB, dtype=theta.dtype, device=theta.device)
        cand = (theta[:, None, :] + sa[None, :, None] * wa[None, None, :]
                + sb[None, :, None] * wb[None, None, :])  # [C, 4, nh]
        return _log2cosh(cand).sum(-1)

    # ---------------- AR contract ----------------

    def ar_init(self, capacity: int):
        return self.c.expand(capacity, self.nh)

    def ar_step(self, carry, k: int, prev):
        theta = carry
        if k > 0:
            dt = self.W.dtype
            a = (prev & 1).to(dt) * 2.0 - 1.0
            b = ((prev >> 1) & 1).to(dt) * 2.0 - 1.0
            theta = (theta + a[:, None] * self.W[:, 2 * (k - 1)][None]
                     + b[:, None] * self.W[:, 2 * (k - 1) + 1][None])
        logp = 2.0 * self._block_logval(theta, k)  # P ∝ val²
        return logp - torch.logsumexp(logp, -1, keepdim=True), theta

    # ---------------- forward ----------------

    def log_psi(self, bits):
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        B = bits.shape[0]
        nb = self.n_blocks
        dt = self.W.dtype
        x = bits_to_spins(bits, dt)
        cum = torch.cumsum(x[:, None, :] * self.W[None], -1)  # [B, nh, sorb]
        # θ before block t: c + the first 2t site contributions
        cum_excl = torch.cat([torch.zeros(B, self.nh, 1, dtype=dt, device=bits.device), cum],
                             -1)
        vals = bits[:, 0::2] + 2 * bits[:, 1::2]  # [B, nb]
        used_a = torch.cumsum(bits[:, 0::2], -1) - bits[:, 0::2]
        used_b = torch.cumsum(bits[:, 1::2], -1) - bits[:, 1::2]
        log_amp = torch.zeros(B, dtype=dt, device=bits.device)
        for t in range(nb):
            lv = self._block_logval(cum_excl[:, :, 2 * t] + self.c[None], t)
            rem = nb - t - 1
            mask = mask_two_site(used_a[:, t], used_b[:, t], self.noa, self.nob, rem, rem)
            logp = apply_mask_logp(2.0 * lv, mask)
            log_amp = log_amp + 0.5 * logp.gather(-1, vals[:, t, None])[:, 0]
        phase = torch.tanh(x @ self.ph_w1 + self.ph_b1) @ self.ph_w2 + self.global_phase
        out = cplx.make(log_amp, phase)
        return out[0] if squeeze else out
