"""Warm starts of a Graph-MPS-RNN: from a smaller dcut, into a larger
structure, and from a converted FOCUS MPS file.

Counterpart of ``pynqs_tpu/utils/mps_import.py`` (``grow_dcut``,
``structural_warm_start``, ``load_focus_mpsrnn``,
``mpsrnn_params_from_state_dict``, ``load_renormalizer_mpsrnn``; the raw
FOCUS binaries are ``utils/focus_ctns.py``'s) on numpy parameter trees with the
``GraphMPSRNN`` key names.  Where the JAX functions draw a fresh init
from the target model (``model.init(key)``), these take the port
model's own init rule (``GraphMPSRNN.init_params``) with a seeded
``torch.Generator``; the arithmetic on the trees is the JAX package's.
The results load with ``GraphMPSRNN.load_numpy_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.utils.torch_io import safe_torch_load

__all__ = [
    "grow_dcut",
    "structural_warm_start",
    "load_focus_mpsrnn",
    "mpsrnn_params_from_state_dict",
    "load_renormalizer_mpsrnn",
]


def _np_dtype(model):
    return torch.empty(0, dtype=model.M_re.dtype).numpy().dtype


def _fresh(model, generator, seed: int) -> dict:
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    return model.init_params(gen)


def grow_dcut(params: dict, model_old, model_new, *, exact: bool = True,
              fresh_scale: float = 1e-3, generator: torch.Generator | None = None) -> dict:
    """Pad Graph-MPS-RNN parameters from ``model_old.dcut`` to the larger
    ``model_new.dcut`` (reference graph_mpsrnn.py:483-527).

    With ``exact`` and ``norm_mode="mpsrnn"`` the grow preserves the
    wavefunction up to O(fresh_scale²): zero-padding scales every site's
    gauge-normalized hidden by γ = sqrt(d_new/d_old), so the old blocks of
    what reads a hidden (M, U, w_arg/w_ph) are divided by γ.  Padded
    entries get ``fresh_scale`` × a fresh init (default generator seed
    11), except the phase readouts (w_arg/w_ph/c_*), whose padding stays
    exactly zero: noise there scrambles atan2(0, 0) at sites whose phase
    input is zero."""
    d0, d1 = model_old.dcut, model_new.dcut
    if d1 < d0:
        raise ValueError("grow_dcut only grows")
    init = _fresh(model_new, generator, 11)
    dt = _np_dtype(model_new)
    gamma = float(np.sqrt(d1 / d0))
    reads_hidden = ("M_re", "M_im", "U_re", "U_im", "w_arg_re", "w_arg_im", "w_ph")
    phase_keys = ("w_arg_re", "w_arg_im", "w_ph", "c_arg_re", "c_arg_im", "c_ph")
    compensate = exact and getattr(model_new, "norm_mode", None) == "mpsrnn"
    out = {}
    for k, v in init.items():
        fs = 0.0 if k in phase_keys else fresh_scale
        if k not in params:
            out[k] = np.asarray(v * fs, dt)
            continue
        pv = np.asarray(params[k])
        if pv.shape == v.shape:
            out[k] = np.asarray(pv, dt)
            continue
        tgt = v * fs
        sl = tuple(slice(0, s) for s in pv.shape)
        tgt[sl] = pv / gamma if (compensate and k in reads_hidden) else pv
        out[k] = np.asarray(tgt, dt)
    return out


def structural_warm_start(params: dict, model_new, *, generator: torch.Generator | None = None,
                          fresh_scale: float = 1e-2) -> dict:
    """Re-express a trained tree in a structurally larger model (extra
    predecessor slots, tensor coupling K/U, ...): tensors of the same
    shape carry over; grown ones keep the checkpoint block in the leading
    corner and ``fresh_scale`` × a fresh init (default generator seed 7)
    elsewhere; absent ones start at ``fresh_scale`` × init.  float32, as
    the JAX function returns."""
    params = {k: np.asarray(v) for k, v in params.items()}
    init = _fresh(model_new, generator, 7)
    merged = {}
    for k, v in init.items():
        if k in params and params[k].shape == v.shape:
            merged[k] = params[k]
        elif k in params:
            pv = params[k]
            if pv.ndim != v.ndim:
                raise ValueError(f"{k}: rank mismatch {pv.shape} vs {v.shape}")
            tgt = v * fresh_scale
            sl = tuple(slice(0, s) for s in pv.shape)
            tgt[sl] = pv
            merged[k] = tgt
        else:
            merged[k] = v * fresh_scale
    return {k: np.asarray(v, np.float32) for k, v in merged.items()}


def _strip(key_dict):
    return {k.replace("module.", "").replace("sample.", ""): v for k, v in key_dict.items()}


def load_focus_mpsrnn(path: str, model) -> dict:
    """Parameters warm-started from a converted FOCUS MPS file (a torch
    state dict, read with ``safe_torch_load``) for a chain ``GraphMPSRNN``
    with phase_mode="arg", norm_mode="mpsrnn"."""
    sd = safe_torch_load(path)
    if "model" in sd:
        sd = sd["model"]
    return mpsrnn_params_from_state_dict(_strip(sd), model)


def mpsrnn_params_from_state_dict(sd: dict, model) -> dict:
    """Converted-layout state dict (``params_M.all_sites``: a list of
    [4, Dout, Din, 2] with the boundary M last; ``params_w.all_sites``
    [norb, dcut_f, 2]; ``params_c.all_sites`` [norb, 2]) → parameter tree.
    Bond dimensions below dcut are zero-padded (top-left block); the
    boundary M acts on the all-ones left vector; η is uniform 1."""

    def arr(x):
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)

    M_list = sd["params_M.all_sites"]
    w = arr(sd["params_w.all_sites"])  # [norb, dcut_f, 2]
    c = arr(sd["params_c.all_sites"])  # [norb, 2]
    norb, d = model.norb, model.dcut
    if model.maxp != 1:
        raise ValueError("FOCUS import requires a chain graph (maxp == 1)")
    if len(M_list) != norb:
        raise ValueError(f"file has {len(M_list)} site tensors, model has {norb} sites")
    dt = _np_dtype(model)
    params = {k: np.zeros(tuple(p.shape), dt) for k, p in model.named_parameters()}
    M_re = np.zeros((norb, 1, 4, d, d))
    M_im = np.zeros((norb, 1, 4, d, d))
    v_re = np.zeros((norb, 4, d))
    v_im = np.zeros((norb, 4, d))
    bound = arr(M_list[-1]).sum(axis=2)  # [4, Dout, 2]: M @ 1
    v_re[0, :, : bound.shape[1]] = bound[..., 0]
    v_im[0, :, : bound.shape[1]] = bound[..., 1]
    for t in range(1, norb):
        Mt = arr(M_list[t - 1])  # [4, Dout, Din, 2]
        do, di = Mt.shape[1], Mt.shape[2]
        M_re[t, 0, :, :do, :di] = Mt[..., 0]
        M_im[t, 0, :, :do, :di] = Mt[..., 1]
    dcut_f = w.shape[1]
    w_re = np.zeros((norb, d))
    w_im = np.zeros((norb, d))
    w_re[:, :dcut_f] = w[..., 0]
    w_im[:, :dcut_f] = w[..., 1]
    params.update({
        "M_re": M_re, "M_im": M_im, "v_re": v_re, "v_im": v_im,
        "w_arg_re": w_re, "w_arg_im": w_im, "c_arg_re": c[:, 0], "c_arg_im": c[:, 1],
        "eta": np.ones((norb, 4, d)), "global_phase": np.zeros(()),
    })
    return {k: np.asarray(v, dt) for k, v in params.items()}


def load_renormalizer_mpsrnn(path_or_tensors, model) -> dict:
    """Renormalizer DMRG warm start: a torch-saved list of 1-site tensors
    [l, 2, r] over spin orbitals (read with ``safe_torch_load``), or the
    list itself.  Spin-orbital pairs contract to 2-site tensors [l, 4,
    r], whose tensor-product order [0, 1, 2, 3] becomes the model's x =
    n_alpha + 2 n_beta by [0, 2, 1, 3]; then the converted-file
    structure as ``focus_ctns.ctns_state_dict`` with the identity
    physical order."""
    from pynqs_tpu_torch.utils.focus_ctns import ctns_state_dict

    src = safe_torch_load(path_or_tensors) if isinstance(path_or_tensors, str) else path_or_tensors
    ts = [np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t) for t in src]
    if len(ts) % 2:
        raise ValueError("expected an even number of 1-site tensors "
                         "(two spin orbitals per spatial site)")
    sites = []
    for i in range(0, len(ts), 2):
        m1, m2 = ts[i], ts[i + 1]
        m = np.einsum("iak,kbj->iabj", m1, m2).reshape(m1.shape[0], 4, m2.shape[-1])
        sites.append(np.ascontiguousarray(m[:, [0, 2, 1, 3], :]))
    return mpsrnn_params_from_state_dict(ctns_state_dict(sites, phys=np.arange(4)), model)
