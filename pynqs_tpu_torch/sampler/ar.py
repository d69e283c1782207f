"""Exact autoregressive sampling with fixed-capacity tree expansion.

Counterpart of ``pynqs_tpu/sampler/ar.py`` (``multinomial_partition``,
``ar_sampling``, ``ar_sampling_dfs``, ``compact_by_count``).  A buffer
of at most C branches is carried through the site loop; each step
partitions every branch's count multinomially over the 4 values of the
next site, then keeps the C largest of the 4C children (rows with count
0 are dead).  Counts follow Multinomial(n_sample, |ψ|²) exactly, up to
the mass dropped when more than C branches are alive.

Model contract: ``carry = model.ar_init(C)``;
``logp, carry = model.ar_step(carry, k, prev)`` with logp [C, 4] the
normalized conditionals of site index k and ``prev`` [C] the values
chosen at step k-1.  Random draws take an explicit ``torch.Generator``
on the model's device; the streams differ from ``jax.random``.
"""

from __future__ import annotations

import torch

from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_two_site

__all__ = [
    "multinomial_partition",
    "ar_sampling",
    "ar_sampling_dfs",
    "compact_by_count",
]

_EXACT = 1 << 23  # trials per f32 binomial draw that stay integer-exact


def _binomial_int(n: torch.Tensor, p: torch.Tensor, n_parts: int, generator):
    """Exact Binomial(n, p) for integer n up to n_parts·2^23, as the sum of
    n_parts independent sub-draws (binomial additivity over trials)."""
    if n_parts <= 1:
        return torch.binomial(n.to(p.dtype), p, generator=generator).long()
    base = n // n_parts
    rem = n - base * n_parts
    out = torch.zeros_like(n)
    for i in range(n_parts):
        ni = base + (i < rem).long()
        out = out + torch.binomial(ni.to(p.dtype), p, generator=generator).long()
    return out


def multinomial_partition(
    n: torch.Tensor, logp: torch.Tensor, generator, *, max_count: int | None = None
) -> torch.Tensor:
    """Partition integer counts n [C] over categories logp [C, ncat] by a
    cascade of conditional binomials.  Returns [C, ncat] int64 whose rows
    sum to n; a category after which all mass is masked takes the rest."""
    ncat = logp.shape[-1]
    n_parts = 1 if max_count is None else -(-int(max_count) // _EXACT)
    p = torch.exp(logp)
    tail = torch.flip(torch.cumsum(torch.flip(p, [-1]), -1), [-1])  # Σ p[c:]
    after = torch.cat([tail[..., 1:], torch.zeros_like(tail[..., :1])], -1)
    out = []
    rem_n = n.long()
    rem_p = torch.ones_like(p[..., 0])
    for c in range(ncat - 1):
        cond = torch.clamp(p[..., c] / torch.clamp(rem_p, min=1e-30), 0.0, 1.0)
        cond = torch.where(after[..., c] <= 0, torch.ones_like(cond), cond)
        draw = _binomial_int(rem_n, cond, n_parts, generator)
        draw = torch.where(rem_n > 0, draw, torch.zeros_like(draw))
        out.append(draw)
        rem_n = rem_n - draw
        rem_p = rem_p - p[..., c]
    out.append(rem_n)
    return torch.stack(out, -1)


def _ar_steps(model, state, k_from: int, k_to: int, generator, max_count):
    """Advance the fixed-capacity AR state over site indices [k_from, k_to)."""
    n_steps = model.sorb // 2
    bits, counts, used_a, used_b, prev, carry = state
    C = bits.shape[0]
    for k in range(k_from, k_to):
        logp, carry = model.ar_step(carry, k, prev)
        rem = n_steps - k - 1
        logp = apply_mask_logp(logp, mask_two_site(used_a, used_b, model.noa, model.nob, rem, rem))
        sub = multinomial_partition(counts, logp, generator, max_count=max_count)
        top_counts, top_idx = torch.topk(sub.reshape(-1), C)  # sorted descending
        parent = top_idx // 4
        val = top_idx % 4
        bits = bits[parent]
        used_a = used_a[parent] + (val & 1)
        used_b = used_b[parent] + (val >> 1)
        carry = {key: v[parent] for key, v in carry.items()}
        s = model.site_order[k]
        bits[:, 2 * s] = (val & 1).to(torch.int8)
        bits[:, 2 * s + 1] = (val >> 1).to(torch.int8)
        counts = top_counts
        prev = val
    return bits, counts, used_a, used_b, prev, carry


def _root_state(model, capacity: int, n_sample: int):
    dev = model.M_re.device
    bits = torch.zeros(capacity, model.sorb, dtype=torch.int8, device=dev)
    counts = torch.zeros(capacity, dtype=torch.long, device=dev)
    counts[0] = n_sample
    zero = torch.zeros(capacity, dtype=torch.long, device=dev)
    return bits, counts, zero, zero.clone(), zero.clone(), model.ar_init(capacity)


@torch.no_grad()
def ar_sampling(model, n_sample: int, *, capacity: int, generator):
    """Exact AR sampling. Returns (bits [C, sorb] int8, counts [C] int64,
    dropped mass).  Rows are unique determinants; counts == 0 are dead."""
    state = _ar_steps(
        model, _root_state(model, capacity, n_sample), 0, model.sorb // 2,
        generator, n_sample,
    )
    bits, counts = state[0], state[1]
    return bits, counts, n_sample - counts.sum()


@torch.no_grad()
def ar_sampling_dfs(
    model, n_sample: int, *, capacity: int, n_group: int, generator,
    split_depth: int | None = None, capacity_root: int | None = None,
):
    """Prefix-partitioned AR sampling.

    Phase 1 expands the tree exactly to ``split_depth`` at
    ``capacity_root`` rows; the live branches (sorted by count) are
    dealt round-robin into ``n_group`` disjoint groups, and each group
    finishes its subtree at full ``capacity``.  Effective capacity
    n_group × capacity.  Returns (bits [n_group·capacity, sorb], counts,
    dropped); rows are globally unique.
    """
    n_steps = model.sorb // 2
    if capacity_root is None:
        capacity_root = capacity
    if capacity_root % n_group:
        raise ValueError("capacity_root must be a multiple of n_group")
    rpg = capacity_root // n_group
    if rpg > capacity:
        raise ValueError("capacity_root/n_group must fit in capacity")
    if split_depth is None:
        split_depth = max(1, min(n_steps - 1, (capacity_root.bit_length() - 1) // 2))
    state = _ar_steps(
        model, _root_state(model, capacity_root, n_sample), 0, split_depth,
        generator, n_sample,
    )
    dev = state[0].device
    out_bits, out_counts = [], []
    for g in range(n_group):
        rows = g + n_group * torch.arange(rpg, device=dev)
        idx = torch.cat([rows, rows[:1].expand(capacity - rpg)])
        bits, counts, used_a, used_b, prev, carry = state
        counts_g = counts[idx].clone()
        counts_g[rpg:] = 0  # padding rows are dead
        st = (
            bits[idx], counts_g, used_a[idx], used_b[idx], prev[idx],
            {key: v[idx] for key, v in carry.items()},
        )
        st = _ar_steps(model, st, split_depth, n_steps, generator, n_sample)
        out_bits.append(st[0])
        out_counts.append(st[1])
    bits = torch.cat(out_bits, 0)
    counts = torch.cat(out_counts, 0)
    return bits, counts, n_sample - counts.sum()


def compact_by_count(bits: torch.Tensor, counts: torch.Tensor, n_keep: int):
    """Keep the ``n_keep`` highest-count rows (exact when at most n_keep
    rows are alive)."""
    top_counts, top_idx = torch.topk(counts, n_keep)
    return bits[top_idx], top_counts
