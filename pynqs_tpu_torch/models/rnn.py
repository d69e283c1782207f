"""Autoregressive GRU wave function.

Counterpart of ``pynqs_tpu/models/rnn.py``: a GRU over the sorb spin
orbitals (1-site conditionals), the amplitude from per-site masked
softmax conditionals and the phase from an MLP over the whole spin
configuration.  The (N, Sz) mask inside ``log_psi`` is the sampler's, so
sampled frequencies follow |ψ|² exactly.

The GRU is the JAX package's own: z and r from [x‖h], the candidate from
[x‖r·h] (``torch.nn.GRU`` lays out its gates differently and applies r
after the hidden product: another function).
"""

from __future__ import annotations

import torch

from pynqs_tpu_torch.models.base import TreeModel, dense, dense_tree, normal_init
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.onv import bits_to_spins
from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_one_site_rows
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["RNNWavefunction"]


def _one_hot2(v, dtype):
    """[..., 2] one-hot of 0/1 values (a comparison: ``F.one_hot`` checks
    its values on the host, which ``torch.func.vmap`` cannot)."""
    return (v.long()[..., None] == torch.arange(2, device=v.device)).to(dtype)


def _gru(p, x, h):
    xh = torch.cat([x, h], -1)
    z = torch.sigmoid(dense(p.z, xh))
    r = torch.sigmoid(dense(p.r, xh))
    hc = torch.tanh(dense(p.h, torch.cat([x, r * h], -1)))
    return (1 - z) * h + z * hc


class RNNWavefunction(TreeModel):
    sites_per_step = 1

    def __init__(self, sorb: int, noa: int, nob: int, hidden: int = 64,
                 phase_hidden: int = 64, dtype=torch.float64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.sorb, self.noa, self.nob = sorb, noa, nob
        self.hidden, self.phase_hidden = hidden, phase_hidden
        nrm = normal_init(generator, dtype, resolve_device(device))
        self.register_tree({
            "gru": {g: dense_tree(nrm, 2 + hidden, hidden) for g in ("z", "r", "h")},
            "amp": dense_tree(nrm, hidden, 2),
            "ph1": dense_tree(nrm, sorb, phase_hidden),
            "ph2": dense_tree(nrm, phase_hidden, 1),
        })

    # ---------------- AR contract ----------------

    def ar_init(self, capacity: int):
        w = self.amp.w
        return torch.zeros(capacity, self.hidden, dtype=w.dtype, device=w.device)

    def ar_step(self, carry, k: int, prev):
        h = carry
        if k == 0:
            x = torch.zeros(h.shape[0], 2, dtype=h.dtype, device=h.device)
        else:
            x = _one_hot2(prev, h.dtype)
        h = _gru(self.gru, x, h)
        return torch.log_softmax(dense(self.amp, h), -1), h

    # ---------------- forward ----------------

    def _cond_logp(self, bits):
        """Masked, normalized conditional log-probs [B, sorb, 2]."""
        B = bits.shape[0]
        dt = self.amp.w.dtype
        x_seq = _one_hot2(bits, dt)  # [B, sorb, 2]
        h = torch.zeros(B, self.hidden, dtype=dt, device=bits.device)
        x = torch.zeros(B, 2, dtype=dt, device=bits.device)  # the start input
        out = []
        for k in range(self.sorb):
            h = _gru(self.gru, x, h)
            out.append(torch.log_softmax(dense(self.amp, h), -1))
            x = x_seq[:, k]
        return apply_mask_logp(torch.stack(out, 1), mask_one_site_rows(bits, self.noa, self.nob))

    def log_psi(self, bits):
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        logp = self._cond_logp(bits)
        log_amp = 0.5 * logp.gather(-1, bits[..., None])[..., 0].sum(-1)
        spins = bits_to_spins(bits, logp.dtype)
        phase = dense(self.ph2, torch.tanh(dense(self.ph1, spins)))[..., 0]
        out = cplx.make(log_amp, phase)
        return out[0] if squeeze else out
