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
    "from_np_complex",
    "exp_pair",
    "ratio_re_im",
    "add_exp",
    "scale",
    "safe_atan2",
    "log2cosh_pair",
    "log2cos_pair",
    "log2tanh_pair",
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


def from_np_complex(logpsi) -> np.ndarray:
    """Host-side: numpy complex log ψ -> pair array."""
    return np.stack([np.real(logpsi), np.imag(logpsi)], axis=-1)


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
    The derivative is linear in the tangents, so it serves both
    directions: ``backward`` for reverse mode, ``jvp`` for forward mode
    (``torch.func.jvp``, the CG-SR matvecs), and the ``setup_context``
    form with a generated vmap rule lets ``torch.func`` transform it.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(y, x):
        return torch.atan2(y, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, x = inputs
        ctx.save_for_backward(y, x)
        ctx.save_for_forward(y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        m2 = torch.clamp(x * x + y * y, min=1e-12)
        return g * x / m2, -g * y / m2

    @staticmethod
    def jvp(ctx, dy, dx):
        y, x = ctx.saved_tensors
        m2 = torch.clamp(x * x + y * y, min=1e-12)
        dy = torch.zeros_like(y) if dy is None else dy
        dx = torch.zeros_like(x) if dx is None else dx
        return (x * dy - y * dx) / m2


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


def scale(lp, log_c: float = 0.0, phase_c: float = 0.0):
    """Multiply ψ by a constant c = exp(log_c + i·phase_c)."""
    return make(lp[..., 0] + log_c, lp[..., 1] + phase_c)


# ---- stable log(2·f(θ)) for complex θ given as (re, im) pairs ----


def log2cosh_pair(x, y):
    """(log|2cosh(x+iy)|, arg) — |cosh z|² = (cosh 2x + cos 2y)/2."""
    a = 2.0 * torch.abs(x)
    la = 0.5 * (a + torch.log1p(torch.exp(-2.0 * a) + 2.0 * torch.cos(2.0 * y) * torch.exp(-a))
                ) - 0.5 * np.log(4.0) + np.log(2.0)
    ph = torch.atan2(torch.tanh(x) * torch.sin(y), torch.cos(y))
    return la, ph


def log2cos_pair(x, y):
    """(log|2cos(x+iy)|, arg) — |cos z|² = (cosh 2y + cos 2x)/2."""
    a = 2.0 * torch.abs(y)
    la = 0.5 * (a + torch.log1p(torch.exp(-2.0 * a) + 2.0 * torch.cos(2.0 * x) * torch.exp(-a))
                ) - 0.5 * np.log(4.0) + np.log(2.0)
    ph = torch.atan2(-torch.sin(x) * torch.tanh(y), torch.cos(x))
    return la, ph


def log2tanh_pair(x, y):
    """(log|2tanh(x+iy)|, arg) via tanh z = (tanh x + i tan y)/(1 + i tanh x tan y)."""
    tx, ty = torch.tanh(x), torch.tan(y)
    num_l = 0.5 * torch.log(torch.clamp(tx**2 + ty**2, min=1e-30))
    num_p = torch.atan2(ty, tx)
    den_l = 0.5 * torch.log1p((tx * ty) ** 2)
    den_p = torch.atan2(tx * ty, torch.ones_like(tx))
    return num_l - den_l + np.log(2.0), num_p - den_p
