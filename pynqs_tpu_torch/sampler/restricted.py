"""RESTRICTED (given-states) sampler: deterministic optimization over a
fixed determinant set.

Counterpart of ``pynqs_tpu/sampler/restricted.py``: every determinant of
a given set is evaluated and weighted by its normalized |ψ|² within the
set.  States outside the (noa, nob) sector are dropped, and so are the
members of ``exclude_sorted_keys`` (sorted packed ONVs), so that |ψ|
cannot be pinned to zero on them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pynqs_tpu_torch.ops import lut, onv

__all__ = ["RestrictedSampler"]


@dataclass(frozen=True)
class RestrictedSampler:
    """``states``: [N, sorb] 0/1 determinants (any array-like)."""

    sorb: int
    noa: int
    nob: int
    states: np.ndarray = field(default=None, repr=False)
    exclude_sorted_keys: object = None  # sorted packed ONVs to drop

    def __post_init__(self):
        st = np.asarray(self.states, np.int8)
        if st.ndim != 2 or st.shape[1] != self.sorb:
            raise ValueError(f"states must be [N, {self.sorb}]")
        keep = (st[:, 0::2].sum(1) == self.noa) & (st[:, 1::2].sum(1) == self.nob)
        st = st[keep]
        if self.exclude_sorted_keys is not None:
            keys = torch.as_tensor(np.asarray(self.exclude_sorted_keys)).long().cpu()
            _, member = lut.lut_search(keys, onv.pack_bits(torch.as_tensor(st)))
            st = st[~member.numpy()]
        if st.shape[0] == 0:
            raise ValueError("no states left after sector/exclusion filter")
        object.__setattr__(self, "states", st)

    @property
    def n_states(self) -> int:
        return self.states.shape[0]

    @torch.no_grad()
    def sample(self, model, generator: torch.Generator | None = None):
        """(bits [N, sorb] on the model's device, weights |ψ|²/Z over the
        set, diagnostics): no draw, so the generator is not used and no
        mass is dropped (``dropped_frac`` −1: not measured)."""
        bits = torch.as_tensor(self.states, device=model.M_re.device)
        la = model.log_psi(bits)[:, 0]
        w = torch.exp(2 * (la - la.max()))
        w = w / w.sum()
        diag = {"dropped_frac": torch.tensor(-1.0, dtype=w.dtype, device=w.device),
                "n_unique": (w > 0).sum()}
        return bits, w, diag
