"""GPT-style decoder wave function (2-site, 4-way conditionals).

Counterpart of ``pynqs_tpu/models/transformer.py``: a causal transformer
over the sorb/2 two-site blocks, vocabulary {00, 10, 01, 11} plus a
start token; the amplitude from masked conditionals of the block logits
by ``norm_method``, the phase from an MLP over the whole spin
configuration plus a learnable global phase.  The teacher-forced
forward is one batched causal-attention pass; AR sampling carries a KV
cache preallocated as [C, n_layer, L, h, dh] and written at step k.

As in the JAX package: GELU is the tanh approximation, layer norm the
biased variance with eps 1e-5 inside the rsqrt, and the causal and
position masks −1e30.  Attention is explicit matmuls and a softmax.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pynqs_tpu_torch.models.base import TreeModel, dense, dense_tree, normal_init
from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops.onv import bits_to_spins
from pynqs_tpu_torch.sampler.symmetry import NEG_INF, apply_mask_logp, mask_two_site
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["DecoderWavefunction", "NORM_METHODS"]

# amplitude parametrization from the per-block head logits x:
#   "softmax-log":  P = softmax(x);            ψ_cond = sqrt(P)
#   "norm":         a = x/‖x‖₂ (signed);       P = a², ψ_cond = a
#   "norm-abs":     a = |x|/‖|x|‖₂;            P = a², ψ_cond = a
#   "softmax-sign": P = softmax(x);            ψ_cond = sign(x)·sqrt(P)
# Sampling draws from P, the symmetry mask renormalized per step.
NORM_METHODS = ("softmax-log", "norm", "norm-abs", "softmax-sign")


def _ln(p, x):
    return F.layer_norm(x, x.shape[-1:], p.g, p.b, eps=1e-5)


def _ln_tree(d, dtype, dev):
    return {"g": torch.ones(d, dtype=dtype, device=dev),
            "b": torch.zeros(d, dtype=dtype, device=dev)}


def _mlp(blk, h):
    return h + dense(blk.fc2, F.gelu(dense(blk.fc, _ln(blk.ln2, h)), approximate="tanh"))


class DecoderWavefunction(TreeModel):
    sites_per_step = 2

    def __init__(self, sorb: int, noa: int, nob: int, n_layer: int = 2, n_head: int = 4,
                 d_model: int = 64, phase_hidden: int = 64, dtype=torch.float64,
                 norm_method: str = "softmax-log", scan_sites: bool = True, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if norm_method not in NORM_METHODS:
            raise ValueError(f"unknown norm_method {norm_method!r}")
        self.sorb, self.noa, self.nob = sorb, noa, nob
        self.n_layer, self.n_head, self.d_model = n_layer, n_head, d_model
        self.phase_hidden, self.norm_method = phase_hidden, norm_method
        self.scan_sites = scan_sites  # the JAX field; the site loop here is Python's
        dev = resolve_device(device)
        nrm = normal_init(generator, dtype, dev)
        d = d_model
        tree = {
            "wte": nrm((5, d), 0.02),  # start token + 4 block values
            "wpe": nrm((self.n_blocks, d), 0.02),
            "lnf": _ln_tree(d, dtype, dev),
            "head": dense_tree(nrm, d, 4, 0.02),
            "ph1": dense_tree(nrm, sorb, phase_hidden),
            "ph2": dense_tree(nrm, phase_hidden, 1),
            "global_phase": torch.zeros((), dtype=dtype, device=dev),
            "blocks": [{
                "ln1": _ln_tree(d, dtype, dev),
                "qkv": dense_tree(nrm, d, 3 * d),
                "proj": dense_tree(nrm, d, d),
                "ln2": _ln_tree(d, dtype, dev),
                "fc": dense_tree(nrm, d, 4 * d),
                "fc2": dense_tree(nrm, 4 * d, d),
            } for _ in range(n_layer)],
        }
        self.register_tree(tree)

    @property
    def n_blocks(self) -> int:
        return self.sorb // 2

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    # ---------------- full (teacher-forced) forward ----------------

    def _hidden_full(self, tokens):
        """Final-layernorm hidden states [B, L, d_model] of tokens [B, L]
        in 0..4 (the first is the start token 4)."""
        B, L = tokens.shape
        h = self.wte[tokens] + self.wpe[:L][None]
        causal = torch.ones(L, L, dtype=torch.bool, device=tokens.device).tril()
        scale = math.sqrt(self.d_head)
        for blk in self.blocks:
            q, k, v = dense(blk.qkv, _ln(blk.ln1, h)).split(self.d_model, -1)
            q, k, v = (t.reshape(B, L, self.n_head, self.d_head).transpose(1, 2)
                       for t in (q, k, v))
            att = (q @ k.transpose(-1, -2)) / scale
            att = torch.softmax(torch.where(causal, att, torch.full_like(att, NEG_INF)), -1)
            y = (att @ v).transpose(1, 2).reshape(B, L, self.d_model)
            h = _mlp(blk, h + dense(blk.proj, y))
        return _ln(self.lnf, h)

    def _raw_cond_logp(self, logits):
        """(log P over the 4 block values, sign phase 0/π) before the
        symmetry mask (masking and renormalizing commute with softmax and
        with L2 normalization)."""
        zero = torch.zeros_like(logits)
        if self.norm_method in ("softmax-log", "softmax-sign"):
            logp = torch.log_softmax(logits, -1)
            if self.norm_method == "softmax-sign":
                return logp, torch.where(logits > 0, zero, zero + np.pi)
            return logp, zero
        y = torch.abs(logits) if self.norm_method == "norm-abs" else logits
        logp = 2.0 * torch.log(torch.clamp(torch.abs(y), min=1e-30))
        if self.norm_method == "norm":
            return logp, torch.where(y < 0, zero + np.pi, zero)
        return logp, zero

    def _cond_logp(self, bits):
        """Masked normalized conditional log-probs [B, n_blocks, 4] and the
        per-value sign phase (0/π)."""
        B = bits.shape[0]
        nb = self.n_blocks
        vals = bits[:, 0::2] + 2 * bits[:, 1::2]  # [B, nb]
        tokens = torch.cat([torch.full((B, 1), 4, dtype=vals.dtype, device=vals.device),
                            vals[:, :-1]], 1)
        logp, ph = self._raw_cond_logp(dense(self.head, self._hidden_full(tokens)))
        used_a = torch.cumsum(bits[:, 0::2], -1) - bits[:, 0::2]
        used_b = torch.cumsum(bits[:, 1::2], -1) - bits[:, 1::2]
        rem = nb - 1 - torch.arange(nb, device=bits.device)
        mask = mask_two_site(used_a, used_b, self.noa, self.nob, rem[None], rem[None])
        return apply_mask_logp(logp, mask), ph

    def log_psi(self, bits):
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        logp, ph_sign = self._cond_logp(bits)
        vals = (bits[:, 0::2] + 2 * bits[:, 1::2])[..., None]
        log_amp = 0.5 * logp.gather(-1, vals)[..., 0].sum(-1)
        spins = bits_to_spins(bits, logp.dtype)
        phase = (dense(self.ph2, torch.tanh(dense(self.ph1, spins)))[..., 0]
                 + self.global_phase
                 + ph_sign.gather(-1, vals)[..., 0].sum(-1))  # signed-amplitude methods
        out = cplx.make(log_amp, phase)
        return out[0] if squeeze else out

    # ---------------- AR contract ----------------

    def ar_init(self, capacity: int):
        shape = (capacity, self.n_layer, self.n_blocks, self.n_head, self.d_head)
        w = self.wte
        return {"k": torch.zeros(shape, dtype=w.dtype, device=w.device),
                "v": torch.zeros(shape, dtype=w.dtype, device=w.device)}

    def ar_step(self, carry, k: int, prev):
        h, carry = self._hidden_step(carry, k, prev)
        return self._raw_cond_logp(dense(self.head, h))[0], carry

    def _hidden_step(self, carry, k: int, prev):
        """One cached decoding step: hidden [C, d_model] and the cache with
        step k's keys and values written in place."""
        C = prev.shape[0]
        tok = torch.full((C,), 4, dtype=torch.long, device=prev.device) if k == 0 else prev
        h = self.wte[tok.long()] + self.wpe[k]  # [C, d]
        pos = (torch.arange(self.n_blocks, device=prev.device) <= k)[None, None, :]
        scale = math.sqrt(self.d_head)
        for li, blk in enumerate(self.blocks):
            q, kk, v = dense(blk.qkv, _ln(blk.ln1, h)).split(self.d_model, -1)
            carry["k"][:, li, k] = kk.reshape(C, self.n_head, self.d_head)
            carry["v"][:, li, k] = v.reshape(C, self.n_head, self.d_head)
            q = q.reshape(C, self.n_head, self.d_head)
            att = torch.einsum("chd,clhd->chl", q, carry["k"][:, li]) / scale
            att = torch.softmax(torch.where(pos, att, torch.full_like(att, NEG_INF)), -1)
            y = torch.einsum("chl,clhd->chd", att, carry["v"][:, li]).reshape(C, self.d_model)
            h = _mlp(blk, h + dense(blk.proj, y))
        return _ln(self.lnf, h), carry
