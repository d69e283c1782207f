"""Sorted-determinant lookup tables and duplicate merging.

Counterpart of ``pynqs_tpu/ops/lut.py`` (``sort_onv``, ``unique_onv``,
``lut_search``, ``WavefunctionLUT``).  Keys are the packed words of
``ops/onv.py`` (int64-held 32-bit words, word 0 least significant), so
tables and results compare with the JAX package's word for word.

Up to two words (sorb <= 64) a row's words fold into one order-keeping
int64 key, and sorting, merging and the lookup are ``torch.sort``,
``torch.unique`` and ``torch.searchsorted`` on one 1-D tensor.  Wider
keys sort by one stable sort per word (least significant first) and are
looked up by bisection.  The JAX package's one-hot MXU lookups and its
merge-join are TPU workarounds for gathers and are not ported:
``lookup_packed`` accepts their method names and answers by the one
lookup.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pynqs_tpu_torch.ops import onv

__all__ = ["row_keys", "sort_order", "sort_onv", "unique_onv", "lut_search",
           "WavefunctionLUT"]


def row_keys(packed: torch.Tensor) -> torch.Tensor | None:
    """One int64 per row that orders as the words [N, nw] do, for nw <= 2
    (the high word shifted by −2³¹ so that the sum cannot overflow);
    None for wider keys."""
    nw = packed.shape[-1]
    if nw == 1:
        return packed[:, 0]
    if nw == 2:
        return (packed[:, 1] - (1 << 31)) * (1 << 32) + packed[:, 0]
    return None


def sort_order(packed: torch.Tensor) -> torch.Tensor:
    """The stable lexicographic order [N] of packed keys [N, nw]."""
    key = row_keys(packed)
    if key is not None:
        return torch.sort(key, stable=True).indices
    perm = torch.arange(packed.shape[0], device=packed.device)
    for w in range(packed.shape[-1]):  # least significant word first
        perm = perm[torch.sort(packed[perm, w], stable=True).indices]
    return perm


def sort_onv(packed: torch.Tensor, *payloads: torch.Tensor):
    """Sort packed keys [N, nw]; payloads [N, ...] follow.  Returns
    (sorted_packed, *sorted_payloads)."""
    perm = sort_order(packed)
    return (packed[perm], *(p[perm] for p in payloads))


def unique_onv(packed: torch.Tensor, counts: torch.Tensor):
    """Merge duplicate keys: (unique_packed [N, nw], unique_counts [N],
    n_unique).  Rows with count 0 are dead and dropped; rows [0, n_unique)
    hold the sorted unique live keys and their summed counts, the rest
    zeros."""
    n = packed.shape[0]
    dev = packed.device
    live = counts != 0
    perm = sort_order(packed)
    perm = perm[torch.sort((~live[perm]).long(), stable=True).indices]  # dead rows last
    sp, sc = packed[perm], counts[perm]
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = (sp[1:] != sp[:-1]).any(-1)
    is_new &= sc != 0
    seg = torch.cumsum(is_new.long(), 0) - 1
    n_unique = int(is_new.sum())
    merged = torch.zeros_like(counts).index_add_(0, seg[sc != 0], sc[sc != 0])
    uniq = torch.zeros_like(packed)
    uniq[:n_unique] = sp[is_new]
    return uniq, merged, n_unique


def lut_search(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """Each query's place in a sorted table: sorted_keys [M, nw], queries
    [Q, nw] -> (idx [Q] int64, found [Q] bool); idx is the first row not
    below the query (clipped to M − 1) and names the match where found."""
    m = sorted_keys.shape[0]
    if m == 0:
        z = torch.zeros(queries.shape[0], dtype=torch.long, device=queries.device)
        return z, z.bool()
    tk, qk = row_keys(sorted_keys), row_keys(queries)
    if tk is not None:
        lo = torch.searchsorted(tk, qk)
    else:  # bisection on the words
        lo = torch.zeros(queries.shape[0], dtype=torch.long, device=queries.device)
        hi = torch.full_like(lo, m)
        for _ in range((m - 1).bit_length() + 1):
            mid = (lo + hi) // 2
            lt = onv.compare_keys_lt(sorted_keys[mid.clamp(max=m - 1)], queries) & (mid < m)
            lo = torch.where(lt, mid + 1, lo)
            hi = torch.where(lt, hi, mid)
    idx = lo.clamp(max=m - 1)
    return idx, (sorted_keys[idx] == queries).all(-1)


@dataclass(frozen=True)
class WavefunctionLUT:
    """Per-determinant values over a sorted determinant set, typically
    the (log|ψ|, arg ψ) pair [M, 2]; misses read ``fill``."""

    sorted_keys: torch.Tensor  # [M, nw] int64-held words
    values: torch.Tensor  # [M, ...]

    @classmethod
    def build(cls, bits: torch.Tensor, values: torch.Tensor) -> "WavefunctionLUT":
        sp, sv = sort_onv(onv.pack_bits(bits), values)
        return cls(sorted_keys=sp, values=sv)

    def lookup_packed(self, packed: torch.Tensor, fill=0.0, method: str = "auto"):
        """(values [Q, ...], found [Q]) of packed queries [Q, nw].  ``method``
        takes the JAX package's names, which all answer by the one lookup."""
        if method not in ("auto", "bisect", "mxu", "merge"):
            raise ValueError(f"unknown lookup method {method!r}")
        idx, found = lut_search(self.sorted_keys, packed)
        vals = self.values[idx]
        mask = found.reshape(found.shape + (1,) * (vals.dim() - 1))
        return torch.where(mask, vals, torch.as_tensor(fill, dtype=vals.dtype,
                                                       device=vals.device)), found

    def lookup(self, bits: torch.Tensor, fill=0.0):
        return self.lookup_packed(onv.pack_bits(bits), fill)
