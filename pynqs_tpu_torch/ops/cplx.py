"""Wavefunction values as real (log|ψ|, arg ψ) pairs.

Counterpart of ``pynqs_tpu/ops/cplx.py``: ``lp[..., 0] = log|ψ|``,
``lp[..., 1] = arg ψ``, the convention of every public function of the
port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "make",
    "logabs",
    "phase",
    "to_np_complex",
    "exp_pair",
    "ratio_re_im",
    "add_exp",
    "safe_atan2",
]


def make(logabs, phase):
    return torch.stack([logabs, phase], dim=-1)


def logabs(lp):
    return lp[..., 0]


def phase(lp):
    return lp[..., 1]


def to_np_complex(lp) -> np.ndarray:
    """Host-side: log ψ as a numpy complex array (log|ψ| + i·arg)."""
    a = lp.detach().cpu().numpy() if isinstance(lp, torch.Tensor) else np.asarray(lp)
    return a[..., 0] + 1j * a[..., 1]


def exp_pair(lp):
    """ψ itself as (re, im)."""
    r = torch.exp(lp[..., 0])
    return r * torch.cos(lp[..., 1]), r * torch.sin(lp[..., 1])


def ratio_re_im(lp_num, lp_den):
    """(re, im) of exp(lp_num − lp_den)."""
    r = torch.exp(lp_num[..., 0] - lp_den[..., 0])
    d1 = lp_num[..., 1] - lp_den[..., 1]
    return r * torch.cos(d1), r * torch.sin(d1)


class _SafeAtan2(torch.autograd.Function):
    """atan2 whose derivative denominator x² + y² is floored at 1e-12.

    The exact derivative (x·dy − y·dx)/(x² + y²) diverges as |z| → 0,
    and one inf poisons every parameter; the forward value is exact.
    """

    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return torch.atan2(y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        m2 = torch.clamp(x * x + y * y, min=1e-12)
        return g * x / m2, -g * y / m2


def safe_atan2(y, x):
    return _SafeAtan2.apply(y, x)


def add_exp(lp1, lp2, c1=1.0, c2=1.0):
    """log(c1·exp(lp1) + c2·exp(lp2)) as a pair, overflow-safe."""
    m = torch.maximum(lp1[..., 0], lp2[..., 0])
    r1 = c1 * torch.exp(lp1[..., 0] - m)
    r2 = c2 * torch.exp(lp2[..., 0] - m)
    re = r1 * torch.cos(lp1[..., 1]) + r2 * torch.cos(lp2[..., 1])
    im = r1 * torch.sin(lp1[..., 1]) + r2 * torch.sin(lp2[..., 1])
    mag2 = re**2 + im**2
    return make(m + 0.5 * torch.log(torch.clamp(mag2, min=1e-30)), safe_atan2(im, re))
