"""MPS-Transformer: transformer-modulated matrix-product amplitudes.

Counterpart of ``pynqs_tpu/models/mps_transformer.py``: a causal GPT
backbone (``DecoderWavefunction``, parameters under ``"bb"``) reads the
prefix and emits, per 2-site block, a modulation of learned base MPS
site tensors; amplitudes come from the contracted chain

    h̃_t(x) = v_{t-1} · Ã_t(x),   P(x) ∝ ‖h̃_t(x)‖²

with Ã_t by ``pmode`` and the complex carry v renormalized per block;
the phase is Σ_t arg(w_t · v_t + c_t).  The AR carry is nested:
``{"kv": {"k", "v"}, "v_re", "v_im", "h_gpt"}``.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.models.base import TreeModel, dense, dense_tree, normal_init
from pynqs_tpu_torch.models.transformer import DecoderWavefunction
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.cplx import safe_atan2
from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_two_site
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["MPSDecoder", "PMODES"]

# how the backbone's hidden state modulates the base site tensors A:
#   "element": A ∘ (1 + s), per-(x, column) scale
#   "linear":  A + g[b,x] · Wt[α,β], a scalar times a learned bond matrix
#   "conv":    A + u[b,x,α] ⊗ w[β], a row vector times a learned column
#   "spm":     A·(1 + g[b,x]) + h[b,x], scalar-plus-shift
PMODES = ("element", "linear", "conv", "spm")


class MPSDecoder(TreeModel):
    sites_per_step = 2

    def __init__(self, sorb: int, noa: int, nob: int, dcut: int = 8, n_layer: int = 1,
                 n_head: int = 2, d_model: int = 32, dtype=torch.float64,
                 pmode: str = "element", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if pmode not in PMODES:
            raise ValueError(f"unknown pmode {pmode!r}")
        self.sorb, self.noa, self.nob, self.dcut = sorb, noa, nob, dcut
        self.n_layer, self.n_head, self.d_model, self.pmode = n_layer, n_head, d_model, pmode
        dev = resolve_device(device)
        self.bb = DecoderWavefunction(sorb, noa, nob, n_layer=n_layer, n_head=n_head,
                                      d_model=d_model, dtype=dtype, device=dev,
                                      generator=generator)
        nrm = normal_init(generator, dtype, dev)
        nb, d = self.n_blocks, dcut
        s = 0.05 / np.sqrt(d)
        tree = {
            "A_re": torch.eye(d, dtype=dtype, device=dev).expand(nb, 4, d, d)
            + nrm((nb, 4, d, d), s),
            "A_im": nrm((nb, 4, d, d), s),
            "mod": dense_tree(nrm, d_model, 4 * d, 0.01),  # d_model -> [4, dcut]
            "w_re": nrm((nb, d), 1.0 / np.sqrt(d)),
            "w_im": torch.zeros(nb, d, dtype=dtype, device=dev),
            "c_re": torch.ones(nb, dtype=dtype, device=dev),
            "c_im": torch.zeros(nb, dtype=dtype, device=dev),
        }
        if pmode == "linear":
            tree.update(Wt=nrm((nb, d, d), s), mod_g=dense_tree(nrm, d_model, 4, 0.01))
        elif pmode == "conv":
            tree.update(wc=nrm((nb, d), 0.1))
        elif pmode == "spm":
            tree.update(mod_g=dense_tree(nrm, d_model, 8, 0.01))
        self.register_tree(tree)

    @property
    def n_blocks(self) -> int:
        return self.sorb // 2

    # ---------------- shared site step ----------------

    def _site_weights(self, t: int, h_gpt, v_re, v_im):
        """Candidate carries and log-weights of block t: h_gpt [B, d_model],
        v_* [B, dcut] -> (cand_re, cand_im [B, 4, dcut], logw [B, 4])."""
        B, d = h_gpt.shape[0], self.dcut
        A_re, A_im = self.A_re[t][None], self.A_im[t][None]
        if self.pmode == "element":
            s = dense(self.mod, h_gpt).reshape(B, 4, 1, d)
            A_re, A_im = A_re * (1.0 + s), A_im * (1.0 + s)
        elif self.pmode == "linear":
            gW = dense(self.mod_g, h_gpt).reshape(B, 4, 1, 1) * self.Wt[t][None, None]
            A_re, A_im = A_re + gW, A_im + gW
        elif self.pmode == "conv":
            uw = dense(self.mod, h_gpt).reshape(B, 4, d, 1) * self.wc[t][None, None, None, :]
            A_re, A_im = A_re + uw, A_im + uw
        else:  # spm
            gh = dense(self.mod_g, h_gpt).reshape(B, 8)
            g, shift = gh[:, :4].reshape(B, 4, 1, 1), gh[:, 4:].reshape(B, 4, 1, 1)
            A_re, A_im = A_re * (1.0 + g) + shift, A_im * (1.0 + g) + shift
        c_re = (torch.einsum("bd,bxde->bxe", v_re, A_re)
                - torch.einsum("bd,bxde->bxe", v_im, A_im))
        c_im = (torch.einsum("bd,bxde->bxe", v_re, A_im)
                + torch.einsum("bd,bxde->bxe", v_im, A_re))
        w = (c_re**2 + c_im**2).sum(-1)
        return c_re, c_im, torch.log(torch.clamp(w, min=1e-30))

    def _select_norm(self, c_re, c_im, x):
        idx = x.long()[:, None, None].expand(-1, 1, self.dcut)
        sel_re = torch.gather(c_re, 1, idx)[:, 0]
        sel_im = torch.gather(c_im, 1, idx)[:, 0]
        nrm = torch.rsqrt(torch.clamp((sel_re**2 + sel_im**2).sum(-1, keepdim=True),
                                      min=1e-30))
        return sel_re * nrm, sel_im * nrm

    def _v0(self, n: int):
        d, w = self.dcut, self.w_re
        return (torch.ones(n, d, dtype=w.dtype, device=w.device) / np.sqrt(d),
                torch.zeros(n, d, dtype=w.dtype, device=w.device))

    # ---------------- forward ----------------

    def log_psi(self, bits):
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        B, nb = bits.shape[0], self.n_blocks
        vals = bits[:, 0::2] + 2 * bits[:, 1::2]
        tokens = torch.cat([torch.full((B, 1), 4, dtype=vals.dtype, device=vals.device),
                            vals[:, :-1]], 1)
        h_seq = self.bb._hidden_full(tokens)  # [B, nb, d_model]
        used_a = torch.cumsum(bits[:, 0::2], -1) - bits[:, 0::2]
        used_b = torch.cumsum(bits[:, 1::2], -1) - bits[:, 1::2]
        v_re, v_im = self._v0(B)
        log_amp = torch.zeros(B, dtype=v_re.dtype, device=bits.device)
        phase = torch.zeros_like(log_amp)
        for t in range(nb):
            c_re, c_im, logw = self._site_weights(t, h_seq[:, t], v_re, v_im)
            rem = nb - t - 1
            mask = mask_two_site(used_a[:, t], used_b[:, t], self.noa, self.nob, rem, rem)
            x = vals[:, t]
            log_amp = log_amp + 0.5 * apply_mask_logp(logw, mask).gather(-1, x[:, None])[:, 0]
            v_re, v_im = self._select_norm(c_re, c_im, x)
            z_re = v_re @ self.w_re[t] - v_im @ self.w_im[t] + self.c_re[t]
            z_im = v_im @ self.w_re[t] + v_re @ self.w_im[t] + self.c_im[t]
            phase = phase + safe_atan2(z_im, z_re)
        out = cplx.make(log_amp, phase)
        return out[0] if squeeze else out

    # ---------------- AR contract ----------------

    def ar_init(self, capacity: int):
        v_re, v_im = self._v0(capacity)
        return {"kv": self.bb.ar_init(capacity), "v_re": v_re, "v_im": v_im,
                "h_gpt": torch.zeros(capacity, self.d_model, dtype=v_re.dtype,
                                     device=v_re.device)}

    def ar_step(self, carry, k: int, prev):
        if k > 0:  # finalize block k-1's carry with its chosen value
            c_re, c_im, _ = self._site_weights(k - 1, carry["h_gpt"], carry["v_re"],
                                               carry["v_im"])
            v_re, v_im = self._select_norm(c_re, c_im, prev)
        else:
            v_re, v_im = carry["v_re"], carry["v_im"]
        h_gpt, kv = self.bb._hidden_step(carry["kv"], k, prev)
        logw = self._site_weights(k, h_gpt, v_re, v_im)[2]
        logp = logw - torch.logsumexp(logw, -1, keepdim=True)
        return logp, {"kv": kv, "v_re": v_re, "v_im": v_im, "h_gpt": h_gpt}
