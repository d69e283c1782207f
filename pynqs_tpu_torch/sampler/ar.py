"""Exact autoregressive sampling with fixed-capacity tree expansion.

Counterpart of ``pynqs_tpu/sampler/ar.py`` (``multinomial_partition``,
``ar_sampling`` with the ``exclude_sorted_keys`` final-step mask,
``ar_sampling_slabbed``, ``ar_sampling_dfs``, ``dfs_depth_profile``,
``tune_dfs_split_depth``, ``ar_sampling_gumbel``,
``gumbel_importance_weights``, ``compact_by_count``).  A buffer
of at most C branches is carried through the site loop; each step
partitions every branch's count multinomially over the ncat values of
the next step, then keeps the C largest of the ncat·C children (rows
with count 0 are dead).  Counts follow Multinomial(n_sample, |ψ|²)
exactly, up to the mass dropped when more than C branches are alive.

Model contract (``models/base.py``): ``carry = model.ar_init(C)``;
``logp, carry = model.ar_step(carry, k, prev)`` with logp [C, ncat] the
conditional log-probabilities of step k (masked and renormalized here)
and ``prev`` [C] the values chosen at step k-1.  A model decides ``model.sites_per_step`` spin orbitals per
step: 2 (ncat 4, values v = a + 2b of spatial orbital
``site_order[k]``, the identity where the model has no ``site_order``)
or 1 (ncat 2, spin orbital k).  The carry is a tensor or a (nested)
dict of tensors with leading axis C, gathered row-wise on branching.
Random draws take an explicit ``torch.Generator`` on the model's
device; the streams differ from ``jax.random``.
"""

from __future__ import annotations

import torch

from pynqs_tpu_torch.ops import lut, onv
from pynqs_tpu_torch.sampler.symmetry import (
    NEG_INF,
    apply_mask_logp,
    mask_one_site,
    mask_two_site,
)
from pynqs_tpu_torch.utils.device import model_device_dtype

__all__ = [
    "multinomial_partition",
    "ar_sampling",
    "ar_sampling_slabbed",
    "ar_sampling_dfs",
    "ar_sampling_gumbel",
    "gumbel_importance_weights",
    "dfs_depth_profile",
    "tune_dfs_split_depth",
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


def _layout(model):
    """(sites per step, categories per step, steps, site order)."""
    nps = model.sites_per_step
    n_steps = model.sorb // nps
    order = getattr(model, "site_order", None)
    return nps, 2**nps, n_steps, list(range(n_steps)) if order is None else order


def _gather(carry, idx):
    """Rows ``idx`` of every tensor of a carry: a tensor or a (nested)
    dict of tensors."""
    if isinstance(carry, dict):
        return {k: _gather(v, idx) for k, v in carry.items()}
    return carry[idx]


def _step_mask(model, k: int, used_a, used_b):
    """[C, ncat] symmetry mask of step k."""
    nps, _, n_steps, _ = _layout(model)
    if nps == 2:
        rem = n_steps - k - 1
        return mask_two_site(used_a, used_b, model.noa, model.nob, rem, rem)
    rem = model.sorb // 2 - k // 2 - 1  # channel sites after spin orbital k
    if k % 2 == 0:
        return mask_one_site(used_a, model.noa, rem)
    return mask_one_site(used_b, model.nob, rem)


def _place(model, k: int, bits, used_a, used_b, val):
    """Write step k's values ``val`` into the (gathered) rows; returns
    (bits, used_a, used_b)."""
    nps, _, _, order = _layout(model)
    if nps == 2:
        s = order[k]
        bits[:, 2 * s] = (val & 1).to(torch.int8)
        bits[:, 2 * s + 1] = (val >> 1).to(torch.int8)
        return bits, used_a + (val & 1), used_b + (val >> 1)
    bits[:, k] = val.to(torch.int8)
    if k % 2 == 0:
        return bits, used_a + val, used_b
    return bits, used_a, used_b + val


def _exclude_mask(bits, s: int, exclude_sorted_keys, sites_per_step: int = 2):
    """[C, ncat] bool: the completed determinant of each value at the final
    step is not in the excluded set; the step sets spatial orbital ``s``
    (v = a + 2b) or, with one site per step, spin orbital ``s``."""
    cand = []
    for v in range(2**sites_per_step):
        b2 = bits.clone()
        if sites_per_step == 2:
            b2[:, 2 * s] = v & 1
            b2[:, 2 * s + 1] = v >> 1
        else:
            b2[:, s] = v
        cand.append(~lut.lut_search(exclude_sorted_keys, onv.pack_bits(b2))[1])
    return torch.stack(cand, -1)


def _ar_steps(model, state, k_from: int, k_to: int, generator, max_count,
              exclude_sorted_keys=None):
    """Advance the fixed-capacity AR state over steps [k_from, k_to).
    ``exclude_sorted_keys`` (sorted packed ONVs) masks the members of that
    set out at the final step."""
    nps, ncat, n_steps, order = _layout(model)
    bits, counts, used_a, used_b, prev, carry = state
    C = bits.shape[0]
    for k in range(k_from, k_to):
        logp, carry = model.ar_step(carry, k, prev)
        mask = _step_mask(model, k, used_a, used_b)
        if exclude_sorted_keys is not None and k == n_steps - 1:
            mask = mask & _exclude_mask(bits, order[k] if nps == 2 else k,
                                        exclude_sorted_keys, nps)
            # a prefix whose every completion is excluded cannot be
            # completed: its count is dropped (the JAX package sends it to
            # value 0, into the excluded set or out of the sector)
            counts = torch.where(mask.any(-1), counts, torch.zeros_like(counts))
        logp = apply_mask_logp(logp, mask)
        sub = multinomial_partition(counts, logp, generator, max_count=max_count)
        top_counts, top_idx = torch.topk(sub.reshape(-1), C)  # sorted descending
        parent = top_idx // ncat
        val = top_idx % ncat
        carry = _gather(carry, parent)
        bits, used_a, used_b = _place(model, k, bits[parent], used_a[parent],
                                      used_b[parent], val)
        counts = top_counts
        prev = val
    return bits, counts, used_a, used_b, prev, carry


def _root_state(model, capacity: int, n_sample: int):
    dev = model_device_dtype(model)[0]
    bits = torch.zeros(capacity, model.sorb, dtype=torch.int8, device=dev)
    counts = torch.zeros(capacity, dtype=torch.long, device=dev)
    counts[0] = n_sample
    zero = torch.zeros(capacity, dtype=torch.long, device=dev)
    return bits, counts, zero, zero.clone(), zero.clone(), model.ar_init(capacity)


@torch.no_grad()
def ar_sampling(model, n_sample: int, *, capacity: int, generator,
                exclude_sorted_keys=None, max_count: int | None = None):
    """Exact AR sampling. Returns (bits [C, sorb] int8, counts [C] int64,
    dropped mass).  Rows are unique determinants; counts == 0 are dead.

    ``exclude_sorted_keys``: sorted packed ONVs masked out at the final
    step.  Masking renormalizes the last conditional per prefix, so the
    sampled measure is not the global restriction |ψ'|²/‖ψ'‖²; a prefix
    with no completion outside the set is dropped (it counts in the
    dropped mass).
    ``max_count`` bounds any count (default ``n_sample``)."""
    state = _ar_steps(
        model, _root_state(model, capacity, n_sample), 0, _layout(model)[2],
        generator, n_sample if max_count is None else max_count,
        exclude_sorted_keys=exclude_sorted_keys,
    )
    bits, counts = state[0], state[1]
    return bits, counts, n_sample - counts.sum()


@torch.no_grad()
def ar_sampling_slabbed(model, n_sample: int, *, capacity: int, n_slab: int, generator,
                        exclude_sorted_keys=None, dedup: bool = True):
    """AR sampling past the capacity ceiling by multinomial additivity:
    ``n_slab`` independent capacity-C trees of n_sample/n_slab draws each
    (the first n_sample mod n_slab take one more) sum to exactly
    Multinomial(n_sample, |ψ|²); the only bias left is each slab's own
    truncation.  Returns (bits [n_slab·capacity, sorb], counts, dropped);
    with ``dedup`` the rows are unique (duplicates across slabs merged,
    sorted by key, the tail zero), else the raw slab concatenation."""
    base = n_sample // n_slab
    ns = [base + (i < n_sample - base * n_slab) for i in range(n_slab)]
    out = [ar_sampling(model, n, capacity=capacity, generator=generator,
                       exclude_sorted_keys=exclude_sorted_keys, max_count=max(ns))[:2]
           for n in ns]
    bits = torch.cat([b for b, _ in out], 0)
    counts = torch.cat([c for _, c in out], 0)
    if dedup:
        uniq, counts, _ = lut.unique_onv(onv.pack_bits(bits), counts)
        bits = onv.unpack_bits(uniq, model.sorb)
    return bits, counts, n_sample - counts.sum()


def _default_split(capacity_root: int, nps: int, n_steps: int) -> int:
    """The static split depth: deep enough that ncat^d branches about fill
    ``capacity_root``."""
    return max(1, min(n_steps - 1, (capacity_root.bit_length() - 1) // nps))


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
    nps, _, n_steps, _ = _layout(model)
    if capacity_root is None:
        capacity_root = capacity
    if capacity_root % n_group:
        raise ValueError("capacity_root must be a multiple of n_group")
    rpg = capacity_root // n_group
    if rpg > capacity:
        raise ValueError("capacity_root/n_group must fit in capacity")
    if split_depth is None:
        split_depth = _default_split(capacity_root, nps, n_steps)
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
            bits[idx], counts_g, used_a[idx], used_b[idx], prev[idx], _gather(carry, idx),
        )
        st = _ar_steps(model, st, split_depth, n_steps, generator, n_sample)
        out_bits.append(st[0])
        out_counts.append(st[1])
    bits = torch.cat(out_bits, 0)
    counts = torch.cat(out_counts, 0)
    return bits, counts, n_sample - counts.sum()


@torch.no_grad()
def dfs_depth_profile(model, n_sample: int, *, capacity_root: int, generator,
                      max_depth: int | None = None):
    """The measured phase-1 profile of ``ar_sampling_dfs``: one exact
    multinomial expansion at ``capacity_root`` rows, recording after each
    step d = 1..max_depth the live prefixes and the kept count mass
    (kept[d-1] < n_sample marks the first depth at which phase 1 would
    truncate).  Returns numpy (live, kept)."""
    n_steps = _layout(model)[2]
    max_depth = min(n_steps - 1 if max_depth is None else max_depth, n_steps - 1)
    state = _root_state(model, capacity_root, n_sample)
    live, kept = [], []
    for d in range(max_depth):
        state = _ar_steps(model, state, d, d + 1, generator, n_sample)
        live.append((state[1] > 0).sum())
        kept.append(state[1].sum())
    return torch.stack(live).cpu().numpy(), torch.stack(kept).cpu().numpy()


def tune_dfs_split_depth(model, generator, n_sample: int, *, capacity: int, n_group: int,
                         capacity_root: int | None = None, safety: float | None = None,
                         max_depth: int | None = None, return_profile: bool = False):
    """``ar_sampling_dfs``' split depth from the live-branch profile of the
    current state (``dfs_depth_profile``): the deepest depth d at which
    (a) phase 1 is still exact (kept mass = n_sample), (b) the live
    branches leave room for the next step's children (live ≤ safety ×
    capacity_root, safety 1/4 by default) and (c) at least n_group
    branches are live to deal; the static rule of ``ar_sampling_dfs``
    where no depth qualifies.  With ``return_profile``: (depth, live,
    kept)."""
    nps, ncat, n_steps, _ = _layout(model)
    if capacity_root is None:
        capacity_root = capacity
    if safety is None:
        safety = 1.0 / ncat
    live, kept = dfs_depth_profile(model, n_sample, capacity_root=capacity_root,
                                   generator=generator, max_depth=max_depth)
    n = int(n_sample)
    best = None
    for d in range(1, len(live) + 1):
        if kept[d - 1] < n:
            break  # phase 1 already truncated at this depth
        if live[d - 1] > safety * capacity_root:
            break  # the next step's children may overflow the root pool
        if live[d - 1] >= n_group:
            best = d
    if best is None:
        best = _default_split(capacity_root, nps, n_steps)
    return (int(best), live, kept) if return_profile else int(best)


def _log1mexp(x):
    """log(1 − eˣ) for x ≤ 0, stable near both ends."""
    return torch.where(x > -0.693, torch.log(-torch.expm1(torch.clamp(x, max=-1e-30))),
                       torch.log1p(-torch.exp(x)))


def _log1pexp(x):
    """log(1 + eˣ) without overflow."""
    return torch.where(x < 18.0, torch.log1p(torch.exp(torch.clamp(x, max=18.0))), x)


def _gumbel(shape, generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


@torch.no_grad()
def ar_sampling_gumbel(model, capacity: int, generator):
    """Stochastic beam search: AR sampling without replacement.

    Gumbel-top-k over complete determinants drawn ancestrally (Kool et
    al., JMLR 21(47)): each live branch carries its prefix log-probability
    ``logq`` and a Gumbel ``G``; its children draw Gumbels conditioned on
    their max equalling ``G``, and the beam keeps the ``capacity``
    largest.  The leaves are the distinct determinants of one Gumbel-top-k
    draw from |ψ|².  Returns (bits [C, sorb] int8, logq [C], G [C],
    alive [C] bool); ``gumbel_importance_weights`` gives unbiased
    estimator weights."""
    _, ncat, n_steps, _ = _layout(model)
    C = capacity
    dev, dt = model_device_dtype(model)
    NEG = NEG_INF
    bits = torch.zeros(C, model.sorb, dtype=torch.int8, device=dev)
    logq = torch.full((C,), NEG, dtype=dt, device=dev)
    logq[0] = 0.0
    G = torch.full((C,), NEG, dtype=dt, device=dev)
    G[0] = _gumbel((), generator, dt, dev)
    used_a = torch.zeros(C, dtype=torch.long, device=dev)
    used_b = torch.zeros_like(used_a)
    prev = torch.zeros_like(used_a)
    carry = model.ar_init(C)
    for k in range(n_steps):
        logp, carry = model.ar_step(carry, k, prev)
        logp = apply_mask_logp(logp, _step_mask(model, k, used_a, used_b))
        child_lq = logq[:, None] + logp  # [C, ncat]
        g = child_lq + _gumbel((C, ncat), generator, dt, dev)
        Z = g.max(-1, keepdim=True).values
        # shift so the children's max equals the parent's G exactly
        # (the numerically stable form, Kool et al. appendix B)
        v = G[:, None] - g + _log1mexp(torch.clamp(g - Z, max=-1e-30))
        cond_g = G[:, None] - torch.clamp(v, min=0.0) - _log1pexp(-v.abs())
        cond_g = torch.where(g == Z, G[:, None].expand_as(cond_g), cond_g)
        dead = (logq <= NEG / 2)[:, None] | (child_lq <= NEG / 2)
        cond_g = torch.where(dead, torch.full_like(cond_g, NEG), cond_g)
        top_g, top_idx = torch.topk(cond_g.reshape(-1), C)
        parent = top_idx // ncat
        val = top_idx % ncat
        carry = _gather(carry, parent)
        bits, used_a, used_b = _place(model, k, bits[parent], used_a[parent],
                                      used_b[parent], val)
        logq = child_lq.reshape(-1)[top_idx]
        G = top_g
        prev = val
    return bits, logq, G, logq > NEG / 2


def gumbel_importance_weights(logq, G, alive):
    """Unbiased estimator weights of a Gumbel-top-k draw: with κ the
    smallest kept Gumbel (that leaf leaves the estimator),
    w_i = p_i / P(G_i > κ), P(G_i > κ) = 1 − exp(−exp(logq_i − κ)) (Kool
    et al. eq. 14), in the log-space form that stays finite in f32.
    Returns (w [C], keep [C] bool); self-normalize for expectations."""
    kappa = torch.where(alive, G, torch.full_like(G, -NEG_INF)).min()
    keep = alive & (G > kappa)
    # t = exp(logq − κ); P(G > κ) = −expm1(−t), and for tiny t
    # log P = (logq − κ) − t/2 + O(t²), where f32's expm1 underflows
    t = torch.exp(logq - kappa)
    log_pgt = torch.where(t > 1e-4, torch.log(torch.clamp(-torch.expm1(-t), min=1e-30)),
                          (logq - kappa) - t / 2)
    return torch.where(keep, torch.exp(logq - log_pgt), torch.zeros_like(logq)), keep


def compact_by_count(bits: torch.Tensor, counts: torch.Tensor, n_keep: int):
    """Keep the ``n_keep`` highest-count rows (exact when at most n_keep
    rows are alive)."""
    top_counts, top_idx = torch.topk(counts, n_keep)
    return bits[top_idx], top_counts
