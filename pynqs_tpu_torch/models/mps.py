"""Dense matrix-product-state wave function.

Counterpart of ``pynqs_tpu/models/mps.py``: fixed-bond dense complex
site tensors, evaluated left to right with per-site renormalization
accumulating log-norms,

    ψ(x) = l† (Π_t A_t[x_t]) r,   carried as the (log|ψ|, arg ψ) pair.

It is not autoregressive: a learnable ansatz under MCMC or exact
sampling, or a frozen trial wave function.  ``exact_mps_from_focus``
and ``focus_trial_log_psi`` read converted FOCUS DMRG files.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.models.base import TreeModel, normal_init
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.cplx import safe_atan2
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.mps_import import load_focus_mpsrnn
from pynqs_tpu_torch.utils.torch_io import safe_torch_load

__all__ = ["MPSWavefunction", "exact_mps_from_focus", "focus_trial_log_psi"]


class MPSWavefunction(TreeModel):
    def __init__(self, sorb: int, dcut: int = 16, dtype=torch.float64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.sorb, self.dcut = sorb, dcut
        dev = resolve_device(device)
        nrm = normal_init(generator, dtype, dev)
        n, d = self.norb, dcut
        s = 0.05 / np.sqrt(d)
        self.register_tree({
            "A_re": torch.eye(d, dtype=dtype, device=dev).expand(n, 4, d, d)
            + nrm((n, 4, d, d), s),
            "A_im": nrm((n, 4, d, d), s),
            "l": torch.ones(d, dtype=dtype, device=dev),
            "r": torch.ones(d, dtype=dtype, device=dev),
        })

    @property
    def norb(self) -> int:
        return self.sorb // 2

    def log_psi(self, bits):
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        B = bits.shape[0]
        vals = bits[:, 0::2] + 2 * bits[:, 1::2]  # [B, norb]
        v_re = self.l.expand(B, self.dcut)
        v_im = torch.zeros_like(v_re)
        log_norm = torch.zeros(B, dtype=v_re.dtype, device=bits.device)
        for t in range(self.norb):
            At_re, At_im = self.A_re[t][vals[:, t]], self.A_im[t][vals[:, t]]  # [B, d, d]
            n_re = (torch.einsum("bd,bde->be", v_re, At_re)
                    - torch.einsum("bd,bde->be", v_im, At_im))
            n_im = (torch.einsum("bd,bde->be", v_re, At_im)
                    + torch.einsum("bd,bde->be", v_im, At_re))
            mag = torch.sqrt(torch.clamp((n_re**2 + n_im**2).sum(-1, keepdim=True), min=1e-30))
            log_norm = log_norm + torch.log(mag[:, 0])
            v_re, v_im = n_re / mag, n_im / mag
        z_re, z_im = v_re @ self.r, v_im @ self.r
        la = log_norm + 0.5 * torch.log(torch.clamp(z_re**2 + z_im**2, min=1e-30))
        out = cplx.make(la, safe_atan2(z_im, z_re))
        return out[0] if squeeze else out


def _focus_sites(path: str) -> list:
    sd = safe_torch_load(path)
    if "model" in sd:
        sd = sd["model"]
    sd = {k.replace("module.", "").replace("sample.", ""): v for k, v in sd.items()}
    return [np.asarray(m) for m in sd["params_M.all_sites"]]


def exact_mps_from_focus(path: str, dtype=torch.float64, *, device=None):
    """A converted FOCUS MPS file as a frozen raw-chain evaluator: every
    site's QN blocks zero-padded into one dense complex tensor.  Returns
    (model, params) — the model with the parameter tree loaded —
    evaluating

        ψ(x) = (Π_{t=norb-1..1} M_t[x_t]) · b[x_0],   b = boundary·1.

    The raw chain is the physical amplitude only for canonical site
    tensors; the FOCUS conversion keeps the phase but not the gauge, so
    the DMRG state as a trial is ``focus_trial_log_psi``."""
    M_list = _focus_sites(path)
    norb = len(M_list)
    d = max(max(m.shape[1] for m in M_list), max(m.shape[2] for m in M_list))
    # the model's v_out[e] = Σ_d v_in[d] A[x, d, e]: A[x, in, out] = M_t[x, out, in]
    A_re = np.zeros((norb, 4, d, d))
    A_im = np.zeros((norb, 4, d, d))
    bound = M_list[-1].sum(axis=2)  # [4, Dout, 2]: the first site's boundary
    A_re[0, :, 0, : bound.shape[1]] = bound[..., 0]
    A_im[0, :, 0, : bound.shape[1]] = bound[..., 1]
    for t in range(1, norb):
        Mt = M_list[t - 1]  # [4, Dout, Din, 2]
        do, di = Mt.shape[1], Mt.shape[2]
        A_re[t, :, :di, :do] = np.swapaxes(Mt[..., 0], 1, 2)
        A_im[t, :, :di, :do] = np.swapaxes(Mt[..., 1], 1, 2)
    l = np.zeros(d)
    l[0] = 1.0  # the trivial left boundary feeding site 0
    r = np.zeros(d)
    r[0] = 1.0  # the final bond dimension is 1
    model = MPSWavefunction(2 * norb, dcut=d, dtype=dtype, device=device)
    params = {"A_re": A_re, "A_im": A_im, "l": l, "r": r}
    model.load_numpy_params(params)
    return model, params


def focus_trial_log_psi(path: str, noa: int, nob: int, dtype=torch.float32, *, device=None):
    """The frozen DMRG trial wave function for GFMC: the FOCUS-converted
    MPS through the conditional (MPS-RNN gauge) construction, a chain
    ``GraphMPSRNN`` with phase_mode="arg", norm_mode="mpsrnn".  Returns
    ``bits [B, sorb] -> (log|ψ_T|, arg) [B, 2]`` (no gradient)."""
    M_list = _focus_sites(path)
    model = GraphMPSRNN(2 * len(M_list), noa, nob, dcut=max(m.shape[1] for m in M_list),
                        phase_mode="arg", norm_mode="mpsrnn", dtype=dtype,
                        device=resolve_device(device))
    model.load_numpy_params(load_focus_mpsrnn(path, model))

    @torch.no_grad()
    def trial(bits):
        return model.log_psi(bits)

    return trial
