"""Host-side determinant spaces (numpy).

Counterpart of ``pynqs_tpu/utils/fci.py::fci_bits`` (its native C++
enumerator for large spaces is not ported).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

__all__ = ["fci_bits"]


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
