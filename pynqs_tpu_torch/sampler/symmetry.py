"""(N, Sz) particle-number masks for autoregressive sampling.

Counterpart of ``pynqs_tpu/sampler/symmetry.py``.  For a spin channel
with target count N, ``used`` electrons placed so far and ``remaining``
sites of that channel after the current one:

    occupy allowed  <=>  used + 1 <= N
    empty  allowed  <=>  N - used <= remaining

The 2-site step decides one alpha and one beta orbital at once with
values v = a + 2b.
"""

from __future__ import annotations

import torch

__all__ = ["mask_two_site", "apply_mask_logp", "NEG_INF"]

NEG_INF = -1e30


def mask_two_site(used_a, used_b, noa: int, nob: int, remaining_a, remaining_b):
    """[..., 4] bool mask over v = a + 2b two-site occupations."""
    occ_a = used_a + 1 <= noa
    emp_a = noa - used_a <= remaining_a
    occ_b = used_b + 1 <= nob
    emp_b = nob - used_b <= remaining_b
    return torch.stack(
        [emp_a & emp_b, occ_a & emp_b, emp_a & occ_b, occ_a & occ_b], dim=-1
    )


def apply_mask_logp(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mask + renormalize log-probabilities along the last axis."""
    masked = torch.where(mask, logp, torch.full_like(logp, NEG_INF))
    return masked - torch.logsumexp(masked, dim=-1, keepdim=True)
