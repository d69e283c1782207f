"""(N, Sz) particle-number masks for autoregressive sampling.

Counterpart of ``pynqs_tpu/sampler/symmetry.py``.  For a spin channel
with target count N, ``used`` electrons placed so far and ``remaining``
sites of that channel after the current one:

    occupy allowed  <=>  used + 1 <= N
    empty  allowed  <=>  N - used <= remaining

The 1-site step decides one spin orbital (empty, occupied); the 2-site
step decides one alpha and one beta orbital at once with values
v = a + 2b.
"""

from __future__ import annotations

import torch

__all__ = ["mask_one_site", "mask_one_site_rows", "mask_two_site", "apply_mask_logp",
           "NEG_INF"]

NEG_INF = -1e30


def _channel_mask(used, n_target, remaining):
    """(occupy_ok, empty_ok) boolean tensors for one channel."""
    return used + 1 <= n_target, n_target - used <= remaining


def mask_one_site(used_ch, n_target, remaining):
    """[..., 2] bool: allowed (empty, occupied) for the current site.

    used_ch: electrons already placed in this site's spin channel;
    remaining: channel sites after this one."""
    occ_ok, emp_ok = _channel_mask(used_ch, n_target, remaining)
    return torch.stack([emp_ok, occ_ok], dim=-1)


def mask_one_site_rows(bits, noa: int, nob: int):
    """[B, sorb, 2] masks of every site of the rows ``bits`` [B, sorb]
    (alpha on even, beta on odd spin orbitals), visited in order: site k
    sees its channel's electrons before it and sorb/2 − k//2 − 1 channel
    sites after it — the 1-site sampler's mask at each step."""
    bits = bits.long()
    sorb = bits.shape[-1]
    used = torch.cumsum(bits.reshape(*bits.shape[:-1], sorb // 2, 2), -2)
    used = (used.reshape(bits.shape) - bits)
    k = torch.arange(sorb, device=bits.device)
    n_target = torch.where(k % 2 == 0, noa, nob)
    return mask_one_site(used, n_target, sorb // 2 - k // 2 - 1)


def mask_two_site(used_a, used_b, noa: int, nob: int, remaining_a, remaining_b):
    """[..., 4] bool mask over v = a + 2b two-site occupations."""
    occ_a, emp_a = _channel_mask(used_a, noa, remaining_a)
    occ_b, emp_b = _channel_mask(used_b, nob, remaining_b)
    return torch.stack(
        [emp_a & emp_b, occ_a & emp_b, emp_a & occ_b, occ_a & occ_b], dim=-1
    )


def apply_mask_logp(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mask + renormalize log-probabilities along the last axis."""
    masked = torch.where(mask, logp, torch.full_like(logp, NEG_INF))
    return masked - torch.logsumexp(masked, dim=-1, keepdim=True)
