"""Singles-and-doubles excitation enumeration with static shapes.

Counterpart of ``pynqs_tpu/ops/excitation.py``.  For fixed (sorb, noa,
nob) every determinant of the sector has the same number n_sd of
connected singles and doubles, and the positions of their orbitals in
the per-sample merged occupied→virtual list
(:func:`pynqs_tpu_torch.ops.onv.merged_orbital_list`) depend only on
the sector.  The [n_sd, 4] position table is built once on the host;
on the device the excitation orbitals are one gather.

Ordering: singles (alpha, beta), then doubles (aaaa, bbbb, abab).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "num_singles_doubles",
    "ExcitationTable",
    "excitation_table",
    "excited_orbitals",
    "excite_bits",
    "make_comb_bits",
]


def num_singles_doubles(sorb: int, noa: int, nob: int) -> tuple[int, int, int]:
    """(n_singles, n_doubles, n_sd) for a (sorb, noa, nob) sector."""
    k = sorb // 2
    nva, nvb = k - noa, k - nob
    ns = noa * nva + nob * nvb
    ndaa = noa * (noa - 1) * nva * (nva - 1) // 4
    ndbb = nob * (nob - 1) * nvb * (nvb - 1) // 4
    ndab = noa * nob * nva * nvb
    nd = ndaa + ndbb + ndab
    return ns, nd, ns + nd


def _unpack_canon(ij: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonical pair index ij = i(i-1)/2 + j (i > j) -> (i, j)."""
    i = (np.sqrt((ij + 1) * 2.0) + 0.5).astype(np.int64)
    j = ij - i * (i - 1) // 2
    return i, j


@dataclass(frozen=True, eq=False)  # identity hash: usable as a cache key
class ExcitationTable:
    """Static per-sector excitation metadata.

    ``pos``: [n_sd, 4] int32 positions (occ_i, virt_a, occ_j, virt_b)
    into the merged orbital list; for singles the (j, b) slots repeat
    (i, a).  ``upairs``/``vpairs``: distinct occupied/virtual slot pairs
    of the doubles; ``u_of_k``/``v_of_k``: each double's pair rows.
    """

    sorb: int
    noa: int
    nob: int
    n_singles: int
    n_doubles: int
    pos: np.ndarray
    upairs: np.ndarray = None
    vpairs: np.ndarray = None
    u_of_k: np.ndarray = None
    v_of_k: np.ndarray = None

    @property
    def n_sd(self) -> int:
        return self.n_singles + self.n_doubles


@lru_cache(maxsize=32)
def excitation_table(sorb: int, noa: int, nob: int) -> ExcitationTable:
    """Precompute the [n_sd, 4] merged-list position table on host."""
    k = sorb // 2
    nva, nvb = k - noa, k - nob
    nsa, nsb = noa * nva, nob * nvb
    noaa = noa * (noa - 1) // 2
    nobb = nob * (nob - 1) // 2
    nvaa = nva * (nva - 1) // 2
    nvbb = nvb * (nvb - 1) // 2
    ndaa, ndbb, ndab = noaa * nvaa, nobb * nvbb, noa * nob * nva * nvb

    rows = []
    if nsa:
        kk = np.arange(nsa)
        i = 2 * (kk % noa)
        a = 2 * (kk // noa + noa)
        rows.append(np.stack([i, a, i, a], 1))
    if nsb:
        kk = np.arange(nsb)
        i = 2 * (kk % nob) + 1
        a = 2 * (kk // nob + nob) + 1
        rows.append(np.stack([i, a, i, a], 1))
    if ndaa:
        kk = np.arange(ndaa)
        o0, o1 = _unpack_canon(kk % noaa)
        v0, v1 = _unpack_canon(kk // noaa)
        rows.append(
            np.stack([o0 * 2, (v0 + noa) * 2, o1 * 2, (v1 + noa) * 2], 1)
        )
    if ndbb:
        kk = np.arange(ndbb)
        o0, o1 = _unpack_canon(kk % nobb)
        v0, v1 = _unpack_canon(kk // nobb)
        rows.append(
            np.stack(
                [o0 * 2 + 1, (v0 + nob) * 2 + 1, o1 * 2 + 1, (v1 + nob) * 2 + 1], 1
            )
        )
    if ndab:
        kk = np.arange(ndab)
        ia = kk % (noa * nva)
        jb = kk // (noa * nva)
        i = (ia % noa) * 2
        a = (ia // noa + noa) * 2
        j = (jb % nob) * 2 + 1
        b = (jb // nob + nob) * 2 + 1
        rows.append(np.stack([i, a, j, b], 1))

    pos = (
        np.concatenate(rows, 0).astype(np.int32)
        if rows
        else np.zeros((0, 4), np.int32)
    )
    n_s = nsa + nsb
    n_d = ndaa + ndbb + ndab
    if pos.shape[0] != n_s + n_d:
        raise AssertionError("excitation table size mismatch")

    dpos = pos[n_s:]
    occ_pairs: dict = {}
    vir_pairs: dict = {}
    u_of_k = np.zeros(n_d, np.int32)
    v_of_k = np.zeros(n_d, np.int32)
    for kk in range(n_d):
        i, a, j, b = (int(x) for x in dpos[kk])
        u_of_k[kk] = occ_pairs.setdefault((min(i, j), max(i, j)), len(occ_pairs))
        v_of_k[kk] = vir_pairs.setdefault((min(a, b), max(a, b)), len(vir_pairs))
    upairs = np.asarray(list(occ_pairs.keys()), np.int32).reshape(-1, 2)
    vpairs = np.asarray(list(vir_pairs.keys()), np.int32).reshape(-1, 2)
    return ExcitationTable(
        sorb=sorb, noa=noa, nob=nob, n_singles=n_s, n_doubles=n_d, pos=pos,
        upairs=upairs, vpairs=vpairs, u_of_k=u_of_k, v_of_k=v_of_k,
    )


def excited_orbitals(merged: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """merged [B, sorb], pos [n_sd, 4] -> orbitals (i, a, j, b) [B, n_sd, 4]."""
    return merged[:, pos.long()]


def excite_bits(
    bits: torch.Tensor, orbs: torch.Tensor, is_double: torch.Tensor
) -> torch.Tensor:
    """Excited determinants: bits [B, sorb] 0/1, orbs [B, n, 4] (i, a, j, b),
    is_double broadcastable to [B, n].  Returns [B, n, sorb] int8 with i
    (and j) cleared and a (and b) set.

    For a single the (j, b) writes repeat (i, a), so one write pattern
    serves both kinds.
    """
    b, n = orbs.shape[:2]
    sorb = bits.shape[-1]
    orbs = orbs.long()
    is_double = is_double.expand(b, n)
    j = torch.where(is_double, orbs[..., 2], orbs[..., 0])
    bb = torch.where(is_double, orbs[..., 3], orbs[..., 1])
    out = bits.to(torch.int8)[:, None, :].expand(b, n, sorb).clone()
    out.scatter_(2, orbs[..., 0:1], 0)
    out.scatter_(2, j[..., None], 0)
    out.scatter_(2, orbs[..., 1:2], 1)
    out.scatter_(2, bb[..., None], 1)
    return out


def make_comb_bits(
    bits: torch.Tensor, orbs: torch.Tensor, is_double: torch.Tensor
) -> torch.Tensor:
    """Excited determinants for the static per-column flags is_double [n]."""
    return excite_bits(bits, orbs, is_double[None, :])
