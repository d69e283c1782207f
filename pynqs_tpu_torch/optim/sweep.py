"""DMRG-style freeze-and-sweep training masks.

Counterpart of ``pynqs_tpu/optim/sweep.py``: the sweep is a gradient
mask over the parameter dict — 1 on the active site window, 0 elsewhere
— that ``VMC`` multiplies into the gradients (``VMCConfig.param_mask_fn``:
iteration → mask).  Works for any model whose site-indexed parameters
carry the site axis first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["site_freeze_mask", "dmrg_sweep_schedule"]

# parameter names whose leading axis is the (spatial-site / visiting) index
_SITE_AXIS_PARAMS = {
    "M_re", "M_im", "v_re", "v_im", "eta", "U_re", "U_im", "K_re", "K_im",
    "w_arg_re", "w_arg_im", "c_arg_re", "c_arg_im", "w_ph", "c_ph",
    "A_re", "A_im",
}


def site_freeze_mask(params: dict, active_sites, dtype=None) -> dict:
    """{name: mask}: site-indexed parameters masked per leading index
    (active sites only), shaped [n, 1, ...] to broadcast; every other
    parameter (global phase, ...) a 0-d one.  Each mask lies on its
    parameter's device, in ``dtype`` (default the parameter's)."""
    active = np.asarray(sorted(set(int(s) for s in active_sites)), np.int64)
    out = {}
    for name, leaf in params.items():
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        dt = dtype or (t.dtype if t.is_floating_point() else torch.float32)
        if name in _SITE_AXIS_PARAMS and t.dim() >= 1:
            m = torch.zeros(t.shape[0], dtype=dt, device=t.device)
            m[torch.as_tensor(active[active < t.shape[0]], device=t.device)] = 1
            out[name] = m.reshape((t.shape[0],) + (1,) * (t.dim() - 1))
        else:
            out[name] = torch.ones((), dtype=dt, device=t.device)
    return out


def dmrg_sweep_schedule(norb: int, window: int = 2, iters_per_window: int = 50):
    """Yields (start_iter, active_sites) sweeping left → right, then
    right → left, forever."""
    starts = list(range(0, max(norb - window + 1, 1)))
    order = starts + starts[::-1][1:-1] if len(starts) > 1 else starts
    it = 0
    while True:
        for s in order:
            yield it, list(range(s, min(s + window, norb)))
            it += iters_per_window
