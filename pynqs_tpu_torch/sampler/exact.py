"""Exact enumeration of the full FCI space as a sampler.

Counterpart of ``pynqs_tpu/sampler/exact.py``: every determinant of the
(noa, nob) sector, weighted by its normalized |ψ|².  It is the exact
measure of the tests and of small active spaces, with the ``ARSampler``
interface.  Under a ``mesh`` (``parallel/``) each rank takes its
contiguous block of the space's rows (the row count must divide by the
mesh size, as the JAX package's sharding requires) and the weights are
normalized over all ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pynqs_tpu_torch.parallel.mesh import all_reduce_max, all_reduce_sum, shard_batch
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.device import model_device_dtype, resolve_device

__all__ = ["ExactSampler"]


@dataclass(frozen=True)
class ExactSampler:
    sorb: int
    noa: int
    nob: int
    mesh: object = None
    _space: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        if self._space is None:
            object.__setattr__(self, "_space", fci.fci_bits(self.sorb, self.noa, self.nob))
        if self.mesh is not None and self.n_states % self.mesh.size:
            raise ValueError(f"{self.n_states} FCI states do not split over "
                             f"{self.mesh.size} ranks")

    @property
    def n_states(self) -> int:
        return self._space.shape[0]

    def space(self, device=None) -> torch.Tensor:
        """The space [n_fci, sorb] int8 on ``device`` (default the card)."""
        return torch.as_tensor(self._space, device=resolve_device(device))

    @torch.no_grad()
    def sample(self, model, generator: torch.Generator | None = None):
        """Returns (bits [n_fci, sorb] int8, weights |ψ|²/Z [n_fci],
        diagnostics {"dropped_frac", "n_unique"} as 0-d tensors) on the
        model's device, under a mesh this rank's rows; ``generator`` is not
        used."""
        del generator
        bits = shard_batch(self.mesh, self.space(model_device_dtype(model)[0]))
        la = model.log_psi(bits)[..., 0]
        w = torch.exp(2 * (la - all_reduce_max(self.mesh, la.max())))
        w = w / all_reduce_sum(self.mesh, w.sum())
        return bits, w, {"dropped_frac": torch.zeros((), dtype=torch.float64, device=w.device),
                         "n_unique": torch.tensor(self.n_states, device=w.device)}
