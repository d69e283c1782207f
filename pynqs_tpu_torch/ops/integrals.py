"""Electron-integral storage and the host-side Slater–Condon tables (numpy).

Counterpart of ``pynqs_tpu/ops/integrals.py``; the port keeps its own
copy so that it never imports the JAX package.

  * ``h1e``: dense [sorb, sorb] one-electron matrix.
  * ``h2e``: antisymmetrized physicist elements <ij||kl> in the
    4-fold-compressed pair triangle: for i>j, k>l, ij = i(i-1)/2+j,
    kl = k(k-1)/2+l, ``h2e[ij(ij+1)/2 + kl] = <ij||kl>`` for ij >= kl.

Spin orbitals are interleaved alpha/beta (even/odd).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "pair_count",
    "triangle_size",
    "compress_h2e",
    "h2e_element",
    "decompress_h2e",
    "antisymmetrize_spin_h2e",
    "spin_orbital_from_spatial",
    "hubbard_1d",
    "hubbard_2d",
    "HijTables",
    "sector_pair_index",
    "hpair_sector_blocks",
    "precompute_hij_tables",
    "spin_raising",
]


def pair_count(sorb: int) -> int:
    return sorb * (sorb - 1) // 2


def triangle_size(sorb: int) -> int:
    p = pair_count(sorb)
    return p * (p + 1) // 2


def _pair_index(i: np.ndarray, j: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonical pair index and sign: ij = max(max-1)/2 + min, sgn = -1 if i<j."""
    hi = np.maximum(i, j)
    lo = np.minimum(i, j)
    idx = hi * (hi - 1) // 2 + lo
    sgn = np.where(i > j, 1.0, -1.0)
    return idx, sgn


def h2e_element(h2e_c: np.ndarray, i, j, k, l) -> np.ndarray:
    """Vectorized <ij||kl> from the compressed triangle (any index order);
    zero when i == j or k == l."""
    i, j, k, l = map(np.asarray, (i, j, k, l))
    ij, s1 = _pair_index(i, j)
    kl, s2 = _pair_index(k, l)
    hi = np.maximum(ij, kl)
    lo = np.minimum(ij, kl)
    # zero entries (i==j or k==l) may compute out-of-range indices; clip
    ijkl = np.minimum(hi * (hi + 1) // 2 + lo, h2e_c.shape[0] - 1)
    val = h2e_c[ijkl] * s1 * s2
    return np.where((i == j) | (k == l), 0.0, val)


def compress_h2e(h2e_dense: np.ndarray, sorb: int) -> np.ndarray:
    """Dense antisymmetrized <ij||kl> [sorb]^4 -> compressed triangle."""
    i, j = np.tril_indices(sorb, k=-1)  # i > j
    order = np.argsort(i * (i - 1) // 2 + j)
    pi, pj = i[order], j[order]
    p = pair_count(sorb)
    a, b = np.tril_indices(p)
    out = np.empty(triangle_size(sorb), dtype=h2e_dense.dtype)
    out[a * (a + 1) // 2 + b] = h2e_dense[pi[a], pj[a], pi[b], pj[b]]
    return out


def decompress_h2e(h2e_c: np.ndarray, sorb: int) -> np.ndarray:
    """Compressed triangle -> dense antisymmetrized <ij||kl> [sorb]^4."""
    idx = np.indices((sorb, sorb, sorb, sorb))
    return h2e_element(h2e_c, idx[0], idx[1], idx[2], idx[3])


def antisymmetrize_spin_h2e(eri_spatial: np.ndarray) -> np.ndarray:
    """Spatial chemist ERI (pr|qs) [norb]^4 -> dense spin <pq||rs> [sorb]^4,
    with <pq|rs> = (pr|qs)·δ(σp,σr)·δ(σq,σs) and <pq||rs> = <pq|rs> − <pq|sr>.
    For small sorb (tests); ``spin_orbital_from_spatial`` fills the
    triangle directly."""
    norb = eri_spatial.shape[0]
    p = np.arange(2 * norb)
    sp = p & 1
    P = p // 2
    d = (sp[:, None] == sp[None, :]).astype(eri_spatial.dtype)
    phys = np.einsum("prqs->pqrs", eri_spatial[np.ix_(P, P, P, P)])
    phys = phys * d[:, None, :, None] * d[None, :, None, :]
    return phys - phys.transpose(0, 1, 3, 2)


def spin_orbital_from_spatial(
    hcore: np.ndarray, eri_spatial: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Spatial (hcore, chemist ERI) -> (dense spin h1e, compressed h2e)."""
    norb = hcore.shape[0]
    sorb = 2 * norb
    h1e = np.zeros((sorb, sorb), dtype=np.float64)
    h1e[0::2, 0::2] = hcore
    h1e[1::2, 1::2] = hcore

    i, j = np.tril_indices(sorb, k=-1)
    order = np.argsort(i * (i - 1) // 2 + j)
    pi, pj = i[order], j[order]
    p = pair_count(sorb)
    a, b = np.tril_indices(p)
    I, Jx = pi[a], pj[a]
    K, L = pi[b], pj[b]

    def anti(ii, jj, kk, ll):
        d_ik = (ii & 1) == (kk & 1)
        d_jl = (jj & 1) == (ll & 1)
        d_il = (ii & 1) == (ll & 1)
        d_jk = (jj & 1) == (kk & 1)
        t1 = np.where(
            d_ik & d_jl, eri_spatial[ii // 2, kk // 2, jj // 2, ll // 2], 0.0
        )
        t2 = np.where(
            d_il & d_jk, eri_spatial[ii // 2, ll // 2, jj // 2, kk // 2], 0.0
        )
        return t1 - t2

    out = np.empty(triangle_size(sorb), dtype=np.float64)
    n = a.shape[0]
    chunk = 8_000_000  # bounds peak memory for large sorb
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        idx = a[s:e] * (a[s:e] + 1) // 2 + b[s:e]
        out[idx] = anti(I[s:e], Jx[s:e], K[s:e], L[s:e])
    return h1e, out


def hubbard_1d(
    nsites: int, t: float = 1.0, u: float = 4.0, pbc: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """1D Hubbard model spatial integrals (hcore, chemist ERI)."""
    hcore = np.zeros((nsites, nsites))
    for s in range(nsites - 1):
        hcore[s, s + 1] = hcore[s + 1, s] = -t
    if pbc and nsites > 2:
        hcore[0, nsites - 1] = hcore[nsites - 1, 0] = -t
    eri = np.zeros((nsites,) * 4)
    for s in range(nsites):
        eri[s, s, s, s] = u
    return hcore, eri


def hubbard_2d(
    nx: int, ny: int, t: float = 1.0, u: float = 4.0, pbc: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """2D square-lattice Hubbard model spatial integrals (hcore, ERI),
    site (r, c) = r·nx + c."""
    n = nx * ny
    hcore = np.zeros((n, n))

    def sid(r, c):
        return r * nx + c

    for r in range(ny):
        for c in range(nx):
            s = sid(r, c)
            if c + 1 < nx:
                hcore[s, sid(r, c + 1)] = hcore[sid(r, c + 1), s] = -t
            elif pbc and nx > 2:
                hcore[s, sid(r, 0)] = hcore[sid(r, 0), s] = -t
            if r + 1 < ny:
                hcore[s, sid(r + 1, c)] = hcore[sid(r + 1, c), s] = -t
            elif pbc and ny > 2:
                hcore[s, sid(0, c)] = hcore[sid(0, c), s] = -t
    eri = np.zeros((n,) * 4)
    for s in range(n):
        eri[s, s, s, s] = u
    return hcore, eri


@dataclass(frozen=True)
class HijTables:
    """Host operands of the Slater–Condon functions.

    ``K[p, q] = <pq||pq>``; ``J[k, p*sorb+q] = <pk||qk>``;
    ``Hpair_sect`` = (H_aa, H_bb, H_ab), the same-spin-sector blocks of
    the pair matrix ``Hpair[pi, pj] = <pi||pj>`` in sector-local pair
    indexing (None when the pair space exceeds 4096 pairs).
    """

    sorb: int
    h1e: np.ndarray
    h2e: np.ndarray
    diag1: np.ndarray
    K: np.ndarray
    J: np.ndarray
    Hpair: np.ndarray | None = None
    Hpair_sect: tuple | None = None


def sector_pair_index(sorb: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global canonical-pair index of each sector-local pair.

    aa: (2p_hi, 2p_lo), local p_hi(p_hi-1)/2 + p_lo; bb: the same over
    beta orbitals; ab: (2p_a, 2p_b+1), local p_a*norb + p_b.
    """
    norb = sorb // 2

    def tri(hi, lo):
        return hi.astype(np.int64) * (hi - 1) // 2 + lo

    ph, pl = np.tril_indices(norb, -1)
    idx_aa = tri(2 * ph, 2 * pl)
    idx_bb = tri(2 * ph + 1, 2 * pl + 1)
    pa = np.repeat(np.arange(norb), norb)
    pb = np.tile(np.arange(norb), norb)
    oa, ob = 2 * pa, 2 * pb + 1
    idx_ab = tri(np.maximum(oa, ob), np.minimum(oa, ob))
    return idx_aa, idx_bb, idx_ab


def hpair_sector_blocks(Hpair: np.ndarray, sorb: int) -> tuple:
    """(H_aa, H_bb, H_ab) same-sector blocks of the dense pair matrix."""
    return tuple(
        np.ascontiguousarray(Hpair[np.ix_(idx, idx)])
        for idx in sector_pair_index(sorb)
    )


def precompute_hij_tables(
    h1e: np.ndarray, h2e_c: np.ndarray, sorb: int, dtype=np.float64
) -> HijTables:
    """Build the dense tables from compressed integrals."""
    p = np.arange(sorb)
    K = h2e_element(h2e_c, p[:, None], p[None, :], p[:, None], p[None, :])
    K = K.astype(dtype)
    kk = p[:, None, None]
    pp = p[None, :, None]
    qq = p[None, None, :]
    J = h2e_element(h2e_c, pp, kk, qq, kk).astype(dtype)

    npair = pair_count(sorb)
    Hpair = None
    Hpair_sect = None
    if npair <= 4096:
        a, b = np.tril_indices(npair)
        tri = a * (a + 1) // 2 + b
        Hpair = np.zeros((npair, npair), dtype=dtype)
        Hpair[a, b] = h2e_c[tri]
        Hpair[b, a] = h2e_c[tri]
        Hpair_sect = hpair_sector_blocks(Hpair, sorb)
    return HijTables(
        sorb=sorb,
        h1e=np.ascontiguousarray(h1e, dtype=dtype),
        h2e=np.ascontiguousarray(h2e_c, dtype=dtype),
        diag1=np.ascontiguousarray(np.diag(h1e), dtype=dtype),
        K=np.ascontiguousarray(K),
        J=np.ascontiguousarray(J.reshape(sorb, sorb * sorb)),
        Hpair=Hpair,
        Hpair_sect=Hpair_sect,
    )


def spin_raising(sorb: int, c1: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """S⁻S⁺ as (dense h1e, compressed h2e): the one-body part
    c1·Spᵀ Sp with Sp[2i, 2i+1] = 1, the two-body part the doubly
    antisymmetrized v[prqs] = Sp[q, p] Sp[r, s]."""
    nbas = sorb // 2
    sp = np.zeros((sorb, sorb))
    for i in range(nbas):
        sp[2 * i, 2 * i + 1] = 1.0
    h1e = c1 * (sp.T @ sp)
    v = np.einsum("qp,rs->prqs", sp, sp)
    v = v - v.transpose(0, 1, 3, 2)
    v = v - v.transpose(1, 0, 2, 3)
    return h1e, compress_h2e(c1 * v, sorb)
