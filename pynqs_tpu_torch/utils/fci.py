"""Host-side determinant spaces (numpy).

Counterpart of ``pynqs_tpu/utils/fci.py`` (``fci_bits``, ``fock_bits``,
``hf_index``; the native C++ enumerator for large spaces is not ported).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

__all__ = ["fci_bits", "fock_bits", "hf_index"]


def fci_bits(sorb: int, noa: int, nob: int) -> np.ndarray:
    """All (noa, nob) determinants as unpacked bits [n_fci, sorb] int8,
    even bits alpha and odd bits beta, ascending by the packed
    little-endian integer value (the JAX package's order)."""
    norb = sorb // 2
    dets = []
    for occ_a in combinations(range(norb), noa):
        da = sum(1 << (2 * i) for i in occ_a)
        for occ_b in combinations(range(norb), nob):
            dets.append(da | sum(1 << (2 * i + 1) for i in occ_b))
    dets.sort()
    out = np.zeros((len(dets), sorb), dtype=np.int8)
    for r, d in enumerate(dets):
        for s in range(sorb):
            out[r, s] = (d >> s) & 1
    return out


def fock_bits(sorb: int) -> np.ndarray:
    """The full Fock space (2^sorb determinants) as bits; tiny systems only."""
    ar = np.arange(1 << sorb, dtype=np.uint64)[:, None]
    return ((ar >> np.arange(sorb, dtype=np.uint64)[None, :]) & 1).astype(np.int8)


def hf_index(space_bits: np.ndarray, noa: int, nob: int) -> int:
    """Index of the aufbau HF determinant inside a bit-space array."""
    hf = np.zeros(space_bits.shape[1], dtype=np.int8)
    hf[0 : 2 * noa : 2] = 1
    hf[1 : 2 * nob : 2] = 1
    hit = np.nonzero((space_bits == hf).all(1))[0]
    if hit.size != 1:
        raise ValueError("HF determinant not found in space")
    return int(hit[0])
