"""CI wavefunction container and its deterministic energy.

Counterpart of ``pynqs_tpu/ci/wavefunction.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pynqs_tpu_torch.ops import onv
from pynqs_tpu_torch.ops.hamiltonian import hij_dense

__all__ = ["CIWavefunction"]


@dataclass(frozen=True)
class CIWavefunction:
    """coeffs [m] (normalized on construction), bits [m, sorb] int8
    determinants; both host (numpy) arrays."""

    coeffs: np.ndarray
    bits: np.ndarray

    def __post_init__(self):
        c = np.asarray(self.coeffs)
        n = np.linalg.norm(c)
        if n > 0:
            object.__setattr__(self, "coeffs", c / n)

    @property
    def m(self) -> int:
        return self.bits.shape[0]

    def select(self, threshold: float) -> "CIWavefunction":
        """The determinants with |c| >= threshold, by |c| descending."""
        c = np.abs(np.asarray(self.coeffs))
        keep = np.nonzero(c >= threshold)[0]
        order = keep[np.argsort(-c[keep])]
        return CIWavefunction(coeffs=np.asarray(self.coeffs)[order], bits=self.bits[order])

    def energy(self, tables, ecore: float = 0.0, chunk: int = 512) -> float:
        """⟨ψ|H|ψ⟩ + ecore from dense Slater–Condon blocks of ``chunk`` rows.
        ``tables``: a ``DeviceTables`` or the tuple (h1e, h2e, diag1, K, J);
        the arithmetic is in their dtype, on their device."""
        ops = tables.astuple() if hasattr(tables, "astuple") else tuple(tables)
        K = ops[3]
        c = torch.as_tensor(np.asarray(self.coeffs), device=K.device).to(K.dtype)
        bits = torch.as_tensor(np.asarray(self.bits), device=K.device)
        e = 0.0
        for s in range(0, self.m, chunk):
            h_block = hij_dense(bits[s:s + chunk], bits, *ops)  # [chunk, m]
            e += float(c[s:s + chunk] @ (h_block @ c))
        return e + ecore

    @classmethod
    def hf_rooted(cls, sorb: int, noa: int, nob: int) -> "CIWavefunction":
        return cls(coeffs=np.ones(1), bits=onv.hf_bits(sorb, noa, nob)[None, :])
