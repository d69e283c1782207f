"""Probability-weighted Monte-Carlo statistics.

Counterpart of ``pynqs_tpu/utils/stats.py``.  The moments are reduced on
the tensors' device; ``operator_stats`` hands them to the host as Python
numbers.  Under a ``mesh`` (``parallel/``) the sums run over the rows of
every rank (weights normalized over all of them).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pynqs_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["weighted_stats", "operator_stats", "OperatorStats"]


@dataclass(frozen=True)
class OperatorStats:
    mean: complex
    var: float
    std: float
    se: float
    n_eff: float

    def __str__(self):
        m = self.mean
        ms = f"{m.real:.8f}" if abs(m.imag) < 1e-10 else f"{m:.8f}"
        return f"{ms} ± {self.se:.2e} [σ²={self.var:.3e}]"


def weighted_stats(values: torch.Tensor, weights: torch.Tensor,
                   n_sample: float | None = None, mesh=None):
    """⟨O⟩, Var, standard error and effective sample size under
    probability weights, as 0-d tensors.

    ``weights`` sum to 1 (0 = dead row, whose value is ignored even if it
    is not finite).  ``n_sample``: the number of raw samples behind the
    weights, for the standard error; default the effective sample size
    1/Σw²."""
    alive = weights > 0
    v = torch.where(alive, values, torch.zeros_like(values))
    mean = all_reduce_sum(mesh, (weights * v).sum())
    var, w2 = all_reduce_sum(mesh, torch.stack([(weights * (v - mean).abs() ** 2).sum(),
                                                (weights**2).sum()]))
    n_eff = 1.0 / torch.clamp(w2, min=1e-30)
    n = n_eff if n_sample is None else n_eff.new_tensor(float(n_sample))
    se = torch.sqrt(var / torch.clamp(n, min=1.0))
    return mean, var, se, n_eff


def operator_stats(values: torch.Tensor, weights: torch.Tensor,
                   n_sample: float | None = None, mesh=None) -> OperatorStats:
    mean, var, se, n_eff = weighted_stats(values, weights, n_sample, mesh)
    var = float(var)
    return OperatorStats(mean=complex(mean.item()), var=var, std=var**0.5,
                         se=float(se), n_eff=float(n_eff))
