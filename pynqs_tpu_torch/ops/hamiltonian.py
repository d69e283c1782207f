"""Slater–Condon matrix elements over the connected singles and doubles.

Counterpart of ``pynqs_tpu/ops/hamiltonian.py`` (``hij_diagonal``,
``comb_hij``, ``hij_pairs``, ``hij_dense``).  On a GPU a data-dependent gather is cheap, so the JAX
package's one-hot selections and three-way bf16 splits are not ported:

  * diagonal  <n|H|n> = occ·diag(h1e) + ½ occᵀ K occ;
  * singles   <n|H|n_i^a> = (h1e[i,a] + Σ_{k∈occ} <ik||ak>) · sign,
    one product occ @ J for all (i, a), then a gather per sample;
  * doubles   <n|H|n_ij^ab> = <ij||ab> · sign, a direct gather from the
    spin-sector pair blocks (H_aa, H_bb, H_ab); or, given the dense pair
    matrix, the pair selection W[b, u, v] = Hpair[po[b, u], pv[b, v]]
    (``ops/pair_select.py``, a CUDA kernel on the card) and one static
    gather of each double's entry; or the compressed triangle where no
    pair matrix is built;
  * signs from one exclusive prefix count per sample;
  * between arbitrary determinants (``hij_pairs``, ``hij_dense``): the
    excitation degree from the differing bits, zero beyond doubles.

The operands' dtype is the arithmetic's: f32 on the card, f64 in the
CPU tests.  No TF32 (the package switches it off on import).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from pynqs_tpu_torch.ops import onv
from pynqs_tpu_torch.ops.excitation import ExcitationTable, make_comb_bits
from pynqs_tpu_torch.ops.pair_select import pair_select_w

__all__ = ["hij_diagonal", "comb_hij", "pair_indices", "hij_pairs", "hij_dense",
           "PAIR_SELECT", "DENSE_PAIRS"]

# comb_hij's ``pair_select`` values, the JAX package's names: all read the
# dense matrix through pair_select_w (the kernel for CUDA rows, the plain
# version for CPU rows); "pallas" with the sector blocks raises
PAIR_SELECT = ("auto", "xla", "pallas")


def hij_diagonal(bits: torch.Tensor, diag1: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """<n|H|n> for a batch. bits [B, sorb] -> [B]."""
    occ = bits.to(K.dtype)
    return occ @ diag1 + 0.5 * ((occ @ K) * occ).sum(-1)


def _parity_from_count(cnt: torch.Tensor) -> torch.Tensor:
    return 1 - 2 * (cnt & 1)


@lru_cache(maxsize=16)
def _static(table: ExcitationTable, device: str):
    """Device copies of the table's static index arrays."""
    dev = torch.device(device)
    ns = table.n_singles
    pos = torch.as_tensor(table.pos.astype(np.int64), device=dev)
    # spin sector of each double: 0 = aa, 1 = bb, 2 = ab (the parity of
    # a merged-list slot is the spin of the orbital it holds)
    par = table.pos[ns:, [0, 2]] % 2
    sector = np.where(
        (par[:, 0] == 0) & (par[:, 1] == 0), 0,
        np.where((par[:, 0] == 1) & (par[:, 1] == 1), 1, 2),
    )
    is_double = torch.zeros(table.n_sd, dtype=torch.bool, device=dev)
    is_double[ns:] = True
    return pos, torch.as_tensor(sector, device=dev), is_double


def _doubles_values(i, a, j, b, sector, hpair_sect, norb):
    """Unsigned <ij||ab> per double from the sector pair blocks: the
    occupied pair (i, j) and the virtual pair (a, b) lie in the same
    sector, so each value is one entry of that sector's block."""

    def local(o1, o2):
        s1, s2 = o1 >> 1, o2 >> 1
        hi = torch.maximum(s1, s2)
        lo = torch.minimum(s1, s2)
        tri = hi * (hi - 1) // 2 + lo  # same-spin sectors
        a_first = (o1 & 1) == 0  # alpha member first (ab sector)
        ab = torch.where(a_first, s1, s2) * norb + torch.where(a_first, s2, s1)
        return torch.where(sector == 2, ab, tri)

    po = local(i, j)
    pv = local(a, b)
    flat = torch.cat([h.reshape(-1) for h in hpair_sect])
    nps = torch.as_tensor([h.shape[0] for h in hpair_sect], device=i.device)
    off = torch.as_tensor(
        [0, hpair_sect[0].numel(), hpair_sect[0].numel() + hpair_sect[1].numel()],
        device=i.device,
    )
    return flat[off[sector] + po * nps[sector] + pv]


@lru_cache(maxsize=16)
def _pair_static(table: ExcitationTable, device: str):
    """Device copies of the doubles' pair tables: the occupied and
    virtual slot pairs, and each double's flat index u·n_v + v into W."""
    dev = torch.device(device)
    up = torch.as_tensor(table.upairs.astype(np.int64), device=dev)
    vp = torch.as_tensor(table.vpairs.astype(np.int64), device=dev)
    uv = table.u_of_k.astype(np.int64) * table.vpairs.shape[0] + table.v_of_k
    return up, vp, torch.as_tensor(uv, device=dev)


def _pair_operands(merged, table: ExcitationTable, device: str):
    """(po [B, n_u], pv [B, n_v], uv [n_d]): each sample's canonical
    occupied and virtual pair indices hi(hi-1)/2 + lo, from its merged
    orbital list, and each double's flat index into W."""
    up, vp, uv = _pair_static(table, device)

    def canon(slots):
        o1, o2 = merged[:, slots[:, 0]], merged[:, slots[:, 1]]
        hi = torch.maximum(o1, o2)
        lo = torch.minimum(o1, o2)
        return hi * (hi - 1) // 2 + lo

    return canon(up), canon(vp), uv


def pair_indices(bits: torch.Tensor, table: ExcitationTable):
    """(po [B, n_u], pv [B, n_v]) int64: each sample's canonical occupied
    and virtual pair indices, the operands of the pair selection."""
    merged = onv.merged_orbital_list(bits, table.noa, table.nob)
    return _pair_operands(merged, table, str(bits.device))[:2]


def _tri_index(p0, p1, q0, q1):
    """Compressed-triangle flat index for canonical (p0>p1, q0>q1)."""
    ij = p0 * (p0 - 1) // 2 + p1
    kl = q0 * (q0 - 1) // 2 + q1
    hi = torch.maximum(ij, kl)
    lo = torch.minimum(ij, kl)
    return hi * (hi + 1) // 2 + lo


def comb_hij(
    bits: torch.Tensor,
    h1e: torch.Tensor,
    h2e: torch.Tensor,
    diag1: torch.Tensor,
    K: torch.Tensor,
    J: torch.Tensor,
    hpair=None,
    *,
    table: ExcitationTable,
    with_comb: bool = True,
    pair_select: str = "auto",
):
    """Connected determinants and their matrix elements.

    bits [B, sorb] 0/1.  Returns (comb, hij): ``comb`` [B, 1 + n_sd,
    sorb] int8 with row 0 the sample itself (None when with_comb is
    False) and ``hij`` [B, 1 + n_sd] with hij[:, 0] = <n|H|n>.
    ``hpair``: the doubles operand, as in the JAX package: a tuple of
    the spin-sector pair blocks, a tensor for the dense pair matrix
    [npair, npair], or None for the compressed triangle ``h2e``.
    ``pair_select`` is one of ``PAIR_SELECT``; the dense matrix is read
    through ``pair_select_w`` whatever its value.  The call is the
    ``torch.profiler`` range ``hamiltonian.comb_hij``.
    """
    if pair_select not in PAIR_SELECT:
        raise ValueError(f"pair_select must be one of {PAIR_SELECT}, not {pair_select!r}")
    sectors = isinstance(hpair, (tuple, list))
    if sectors and pair_select == "pallas":
        raise ValueError("pair_select='pallas' needs the dense hpair matrix, not sector blocks")
    with record_function("hamiltonian.comb_hij"):
        sorb = table.sorb
        ns = table.n_singles
        nd = table.n_doubles
        dtype = K.dtype
        pos, sector, is_double = _static(table, str(bits.device))

        occ = bits.to(dtype)
        prefix = onv.prefix_occ(bits)  # [B, sorb]
        merged = onv.merged_orbital_list(bits, table.noa, table.nob)  # [B, sorb]
        orbs = merged[:, pos]  # [B, n_sd, 4] orbitals (i, a, j, b)
        cnts = torch.gather(prefix, 1, merged)[:, pos]  # prefix at (i, a, j, b)

        hii = hij_diagonal(bits, diag1, K)

        # singles: S[b, p*sorb+q] = h1e[p,q] + Σ_k occ_k <pk||qk>
        s_full = occ @ J + h1e.reshape(1, -1)
        i_s, a_s = orbs[:, :ns, 0], orbs[:, :ns, 1]
        val_s = torch.gather(s_full, 1, i_s * sorb + a_s)
        cnt_ia = cnts[:, :ns, 0] + cnts[:, :ns, 1] - (i_s < a_s).long()
        hij_s = val_s * _parity_from_count(cnt_ia).to(dtype)

        # doubles
        i_d, a_d, j_d, b_d = orbs[:, ns:].unbind(-1)
        p0 = torch.maximum(i_d, j_d)
        p1 = torch.minimum(i_d, j_d)
        q0 = torch.maximum(a_d, b_d)
        q1 = torch.minimum(a_d, b_d)
        if sectors:
            val_d = _doubles_values(i_d, a_d, j_d, b_d, sector, hpair, sorb // 2)
        elif hpair is not None and nd > 0:
            po, pv, uv = _pair_operands(merged, table, str(bits.device))
            val_d = pair_select_w(po, pv, hpair).reshape(bits.shape[0], -1)[:, uv].to(dtype)
        else:
            val_d = h2e[_tri_index(p0, p1, q0, q1)]
        base = cnts[:, ns:, :].sum(-1)
        corr = (
            -(p0 < q0).long() - (p1 < q0).long() + (q1 < q0).long()
            - (p0 < q1).long() - (p1 < q1).long() + (q0 < q1).long()
        )
        hij_d = val_d * _parity_from_count(base + corr).to(dtype)

        hij = torch.cat([hii[:, None], hij_s, hij_d], dim=-1)
        comb = None
        if with_comb:
            exc = make_comb_bits(bits, orbs, is_double)
            comb = torch.cat([bits.to(torch.int8)[:, None, :], exc], dim=1)
        return comb, hij


def hij_pairs(bra_bits, ket_bits, h1e, h2e, diag1, K, J) -> torch.Tensor:
    """<bra|H|ket> for elementwise pairs of determinants [..., sorb]:
    excitation degree 0, 1 or 2, zero beyond."""
    sorb = bra_bits.shape[-1]
    dtype = K.dtype
    bra, ket = torch.broadcast_tensors(bra_bits.long(), ket_bits.long())
    d = bra ^ ket
    cre = d & bra  # occupied in bra only
    ann = d & ket  # occupied in ket only
    ncre, nann = cre.sum(-1), ann.sum(-1)
    pref_bra, pref_ket = onv.prefix_occ(bra), onv.prefix_occ(ket)
    ar = torch.arange(sorb, device=bra.device)

    def hi_lo(mask):  # highest and lowest set position (clipped when none)
        hi = torch.where(mask > 0, ar, -1).amax(-1).clamp(0, sorb - 1)
        lo = torch.where(mask > 0, ar, sorb).amin(-1).clamp(0, sorb - 1)
        return hi, lo

    def at(pref, pos):
        return torch.gather(pref, -1, pos[..., None])[..., 0]

    p_hi, p_lo = hi_lo(cre)
    q_hi, q_lo = hi_lo(ann)
    hij0 = hij_diagonal(bra.reshape(-1, sorb), diag1, K).reshape(bra.shape[:-1])
    # singles: h1e[p, q] + Σ_{k ∈ occ(bra)} <pk||qk>, p = p_hi, q = q_hi
    val1 = (bra.to(dtype) * J.t()[p_hi * sorb + q_hi]).sum(-1) + h1e[p_hi, q_hi]
    hij1 = val1 * _parity_from_count(at(pref_bra, p_hi) + at(pref_ket, q_hi)).to(dtype)
    # doubles
    # (clamped: rows of other degrees give indices that are not read)
    val2 = h2e[_tri_index(p_hi, p_lo, q_hi, q_lo).clamp(max=h2e.shape[0] - 1)]
    cnt2 = at(pref_bra, p_hi) + at(pref_bra, p_lo) + at(pref_ket, q_hi) + at(pref_ket, q_lo)
    hij2 = val2 * _parity_from_count(cnt2).to(dtype)
    zero = torch.zeros_like(hij0)
    return torch.where(
        (ncre == 0) & (nann == 0), hij0,
        torch.where((ncre == 1) & (nann == 1), hij1,
                    torch.where((ncre == 2) & (nann == 2), hij2, zero)))


DENSE_PAIRS = 1 << 19  # (bra, ket) pairs per block of hij_dense


def hij_dense(bra_bits, ket_bits, h1e, h2e, diag1, K, J):
    """Dense [n, m] matrix <bra_i|H|ket_j>, built in row blocks of at most
    ``DENSE_PAIRS`` (bra, ket) pairs, so that [rows, m, sorb] never forms
    whole."""
    n, m = bra_bits.shape[0], ket_bits.shape[0]
    out = torch.empty(n, m, dtype=K.dtype, device=K.device)
    rows = max(1, DENSE_PAIRS // max(m, 1))
    for s in range(0, n, rows):
        out[s:s + rows] = hij_pairs(bra_bits[s:s + rows, None, :], ket_bits[None, :, :],
                                    h1e, h2e, diag1, K, J)
    return out
