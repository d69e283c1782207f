"""Occupation-number-vector (ONV) primitives.

Counterpart of ``pynqs_tpu/ops/onv.py``.  A determinant over ``sorb``
spin orbitals is an unpacked 0/1 row ``bits[..., sorb]`` (int8); even
indices are alpha, odd are beta, spatial orbital of ``s`` is ``s // 2``.

The packed form, the key of sorting, dedup and the lookup table, is the
JAX package's word layout: ``n_words32(sorb)`` 32-bit words, bit ``s`` in
word ``s // 32`` at position ``s % 32``, keys ordered with word 0 least
significant.  torch has little uint32 support, so the words are held in
int64 (values 0 .. 2³² − 1); ``ops/lut.row_keys`` folds up to two
words into one order-keeping int64 per row.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "n_words32",
    "pack_bits",
    "unpack_bits",
    "popcount_u32",
    "bits_to_spins",
    "spins_to_bits",
    "compare_keys_lt",
    "compare_keys_le",
    "hf_bits",
    "prefix_occ",
    "parity",
    "merged_orbital_list",
    "permute_sgn_matrix",
    "permute_sgn",
    "spin_flip_bits",
    "spin_flip_sign",
]


def n_words32(sorb: int) -> int:
    """Number of 32-bit words that hold ``sorb`` bits."""
    return (sorb + 31) // 32


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits [..., sorb] -> the words [..., n_words32(sorb)] as int64.
    A row's 0/1 bytes, padded to 32 per word and read as int64s of 8 bytes
    each, fold into one byte per int64 by one multiply (byte j lands on
    bit 56 + j, and nothing below carries into the top byte); 4 such
    bytes make a word."""
    sorb = bits.shape[-1]
    nw = n_words32(sorb)
    b = torch.nn.functional.pad(bits.reshape(-1, sorb).to(torch.int8), (0, nw * 32 - sorb))
    byte = ((b.view(torch.int64) * 0x0102040810204080) >> 56) & 0xFF  # [n, 4 nw]
    shift = torch.arange(0, 32, 8, device=bits.device)
    return (byte.view(b.shape[0], nw, 4) << shift).sum(-1).reshape(bits.shape[:-1] + (nw,))


def unpack_bits(words: torch.Tensor, sorb: int) -> torch.Tensor:
    """The words [..., nw] -> 0/1 bits [..., sorb] int8."""
    shifts = torch.arange(32, device=words.device)
    b = torch.bitwise_right_shift(words.long()[..., :, None], shifts) & 1
    return b.reshape(words.shape[:-1] + (words.shape[-1] * 32,))[..., :sorb].to(torch.int8)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words (held in int64), int64."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _cmp_words(a: torch.Tensor, b: torch.Tensor):
    """(a < b, a == b) of multi-word keys, word 0 least significant."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones(shape, dtype=torch.bool, device=a.device)
    for w in range(a.shape[-1] - 1, -1, -1):  # most significant word first
        lt = lt | (eq & (a[..., w] < b[..., w]))
        eq = eq & (a[..., w] == b[..., w])
    return lt, eq


def compare_keys_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b for packed keys [..., nw]."""
    return _cmp_words(a, b)[0]


def compare_keys_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b for packed keys [..., nw]."""
    lt, eq = _cmp_words(a, b)
    return lt | eq


def hf_bits(sorb: int, noa: int, nob: int) -> np.ndarray:
    """Hartree–Fock determinant: lowest noa alpha and nob beta occupied."""
    bits = np.zeros(sorb, dtype=np.int8)
    bits[0 : 2 * noa : 2] = 1
    bits[1 : 2 * nob : 2] = 1
    return bits


def bits_to_spins(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """0/1 bits -> ±1 spins (occupied +1, empty −1)."""
    return 2 * bits.to(dtype) - 1


def spins_to_bits(spins: torch.Tensor) -> torch.Tensor:
    """±1 spins -> 0/1 int8 bits."""
    return (spins > 0).to(torch.int8)


def prefix_occ(bits: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count: [..., s] = occupied orbitals below s (int64)."""
    b = bits.long()
    return torch.cumsum(b, dim=-1) - b


def parity(prefix: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Fermionic sign (-1)^{#occupied below pos} as ±1 int64."""
    cnt = torch.gather(prefix, -1, pos.long()[..., None])[..., 0]
    return 1 - 2 * (cnt & 1)


def merged_orbital_list(bits: torch.Tensor, noa: int, nob: int) -> torch.Tensor:
    """Interleaved occupied→virtual orbital list per sample [..., sorb].

    Even slots hold alpha orbitals (the occupied ones ascending, then
    the virtual ones ascending), odd slots beta likewise.  ``noa``/``nob``
    are implied by the bits and kept for the JAX signature.
    """
    del noa, nob
    sorb = bits.shape[-1]
    norb = sorb // 2
    spatial = torch.arange(norb, device=bits.device)

    def channel(occ_ch, offset):
        # occupied sort before virtuals, each ascending; keys are unique
        keys = (1 - occ_ch.long()) * norb + spatial
        return 2 * torch.argsort(keys, dim=-1) + offset

    merged = torch.stack(
        [channel(bits[..., 0::2], 0), channel(bits[..., 1::2], 1)], dim=-1
    )
    return merged.reshape(bits.shape[:-1] + (sorb,))


def permute_sgn_matrix(order) -> np.ndarray:
    """A[u, t] = (u < t) & (order[u] > order[t]): the reordering sign of a
    determinant whose orbitals are visited in ``order`` is
    (-1)^(occ_oᵀ A occ_o) with occ_o = bits gathered in ``order``."""
    order = np.asarray(order)
    u = np.arange(order.shape[0])
    return ((u[:, None] < u[None, :]) & (order[:, None] > order[None, :])).astype(
        np.int32
    )


def permute_sgn(bits: torch.Tensor, A) -> torch.Tensor:
    """±1 reordering sign per sample; ``bits`` already gathered in the
    visiting order, ``A`` from :func:`permute_sgn_matrix`."""
    # counts stay below sorb², exact in f64 (CUDA has no integer matmul)
    occ = bits.to(torch.float64)
    A = torch.as_tensor(np.asarray(A), dtype=torch.float64, device=bits.device)
    inv = ((occ @ A) * occ).sum(-1).long()
    return 1 - 2 * (inv & 1)


def _spin_flip_perm(sorb: int) -> np.ndarray:
    return np.arange(sorb).reshape(-1, 2)[:, ::-1].reshape(-1)


def spin_flip_bits(bits: torch.Tensor) -> torch.Tensor:
    """α↔β spin flip: swap each even position with the odd one above it."""
    return bits[..., torch.as_tensor(_spin_flip_perm(bits.shape[-1]), device=bits.device)]


def spin_flip_sign(bits: torch.Tensor) -> torch.Tensor:
    """±1 fermionic sign of the spin flip applied to |n⟩: the reordering
    parity of the pairwise even/odd swap (as ``permute_sgn``)."""
    perm = _spin_flip_perm(bits.shape[-1])
    return permute_sgn(bits[..., torch.as_tensor(perm, device=bits.device)],
                       permute_sgn_matrix(perm))
