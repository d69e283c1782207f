"""Restricted Boltzmann machine wave functions.

Counterpart of ``pynqs_tpu/models/rbm.py``: real or complex parameters ×
{cosh, cos, tanh} hidden activations,

    log ψ(x) = a·x + Σ_j log( 2 f(W x + b)_j ),    x = ±1 spins,

carried as the (log|ψ|, arg ψ) pair; complex parameters are (re, im)
pairs of real tensors and the log-activations come from the closed forms
of ``ops/cplx.py``.
"""

from __future__ import annotations

import torch

from pynqs_tpu_torch.models.base import TreeModel, normal_init
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.onv import bits_to_spins
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["RBM"]

_ACT = {
    "cosh": cplx.log2cosh_pair,
    "cos": cplx.log2cos_pair,
    "tanh": cplx.log2tanh_pair,
}


class RBM(TreeModel):
    """RBM ansatz; ``alpha`` = nh / sorb hidden-unit density."""

    def __init__(self, sorb: int, alpha: int = 2, param_type: str = "complex",
                 activation: str = "cosh", dtype=torch.float64, init_scale: float = 1e-2,
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if param_type not in ("real", "complex"):
            raise ValueError(f"unknown param_type {param_type!r}")
        if activation not in _ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self.sorb, self.alpha = sorb, alpha
        self.param_type, self.activation = param_type, activation
        nrm = normal_init(generator, dtype, resolve_device(device))
        s, nh = init_scale, self.nh
        tree = {"a": nrm((sorb,), s), "W": nrm((sorb, nh), s), "b": nrm((nh,), s)}
        if param_type == "complex":
            tree.update(a_im=nrm((sorb,), s), W_im=nrm((sorb, nh), s), b_im=nrm((nh,), s))
        self.register_tree(tree)

    @property
    def nh(self) -> int:
        return self.alpha * self.sorb

    def log_psi(self, bits: torch.Tensor) -> torch.Tensor:
        x = bits_to_spins(bits, self.W.dtype)  # [..., sorb] ±1
        th_re = x @ self.W + self.b
        vis_re = x @ self.a
        if self.param_type == "complex":
            th_im = x @ self.W_im + self.b_im
            vis_im = x @ self.a_im
        else:
            th_im = torch.zeros_like(th_re)
            vis_im = torch.zeros_like(vis_re)
        la, ph = _ACT[self.activation](th_re, th_im)
        return cplx.make(vis_re + la.sum(-1), vis_im + ph.sum(-1))
