"""Occupation-number-vector (ONV) primitives.

Counterpart of ``pynqs_tpu/ops/onv.py``.  A determinant over ``sorb``
spin orbitals is an unpacked 0/1 row ``bits[..., sorb]`` (int8); even
indices are alpha, odd are beta, spatial orbital of ``s`` is ``s // 2``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "hf_bits",
    "prefix_occ",
    "parity",
    "merged_orbital_list",
    "permute_sgn_matrix",
    "permute_sgn",
    "spin_flip_bits",
    "spin_flip_sign",
]


def hf_bits(sorb: int, noa: int, nob: int) -> np.ndarray:
    """Hartree–Fock determinant: lowest noa alpha and nob beta occupied."""
    bits = np.zeros(sorb, dtype=np.int8)
    bits[0 : 2 * noa : 2] = 1
    bits[1 : 2 * nob : 2] = 1
    return bits


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
