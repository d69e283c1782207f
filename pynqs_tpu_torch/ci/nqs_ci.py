"""Hybrid CI-NQS: the coupled NqsCi training and the one-shot polish.

Counterpart of ``pynqs_tpu/ci/nqs_ci.py`` (``NqsCiConfig``, ``NqsCi``,
``ci_polish``).  Both work with ψ = Σ_i c_i|d_i⟩ + c_m|φ̂⟩, φ̂ the NQS
without the CI set D, and the (m+1)×(m+1) Hamiltonian of that family:

  * H_cc = ⟨d_i|H|d_j⟩, dense Slater–Condon blocks (``hij_dense``);
  * H_cn[i] = Σ_{k ∈ SD(d_i) \\ D} H_ik φ(k) / ‖φ'‖, exact over each
    d_i's connected space (``comb_hij``), with ‖φ'‖² = 1 − Σ_D |φ(d)|²
    in closed form (exact AR normalization);
  * H_nn, the local energy of the D-masked state.

``NqsCi`` trains θ through the eigenvector: each iteration draws
samples of φ (no gradient), estimates H_nn over them, takes H_cn, solves
the f64 eigenproblem on the device, and descends the Hellmann–Feynman
surrogate c†(∂H)c = c_m²·∂H_nn + 2 c_m Σ_i c_i ∂H_cn,i by autograd
through ``model.log_psi``, accumulated chunk by chunk.

``ci_polish`` builds the matrix once for fixed NQS parameters and returns
its lowest eigenvalue, the eigensolve in complex128 on the tensors'
device.  Its H_nn uses the exact |φ|² weights of the captured rows
outside D (REDUCE).  ``restrict="complement"`` estimates H_nn over the
capture: the eigenvalue is variational only where the capture covers the
complement.  ``restrict="capture"`` restricts φ' to (capture \\ D): every
entry is an exact finite sum (k_det is then n_sd), and the eigenvalue is
a true upper bound whatever the coverage.

Rows of zero weight (D members, duplicate capture rows, dead slots of
count 0) are dropped before any local energy: the masked forward floors
D rows' log-amplitude by −690, which is an exact 0 in f32, and 0·inf
would be NaN.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import (_chunks, local_energy_reduce, local_energy_simple,
                                         unique_rows)
from pynqs_tpu_torch.ops import cplx, onv
from pynqs_tpu_torch.ops.hamiltonian import comb_hij, hij_dense
from pynqs_tpu_torch.ops.lut import lut_search, sort_onv
from pynqs_tpu_torch.sampler.ar import ar_sampling
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["ci_polish", "RESTRICT", "NqsCi", "NqsCiConfig"]

RESTRICT = ("complement", "capture")
CI_ROWS = 64  # CI determinants per comb_hij call when NqsCi builds the connected block


@dataclass
class NqsCiConfig:
    n_iter: int = 300
    lr: float = 5e-3
    n_sample: int = 1 << 13
    capacity: int = 1 << 10
    log_every: int = 50
    # the reference's gradient strategies (ci_vmc/hybrid.py:60-66,495-527):
    # in the Hellmann–Feynman form 0 and 1 give the same gradient and
    # differ in the warm-up floor while |c_m| is small (0 rescales the
    # surrogate by max(c_m², cnqs_pow_min)/c_m², 1 by
    # max(|c_m|, √cnqs_pow_min)/|c_m|); 2 drops the CI coupling (the NQS
    # covariance gradient alone)
    grad_strategy: int = 1
    cnqs_pow_min: float = 1e-4
    # the floor applies while iteration < start_iter (-1: never, as the
    # JAX package; PyNQS applies it throughout)
    start_iter: int = -1
    # rows per chunk of the connected block's forwards (H_cn, with and
    # without gradient) and of the sampled rows' backward; samples per
    # local-energy chunk.  None: the whole block at once
    ci_chunk: int | None = None
    eloc_batch: int | None = None


class NqsCi:
    """Coupled CI-NQS training of ``model`` (its parameters, in place) on
    ``system`` with the CI set ``ci_bits`` [m, sorb], on the model's device.

    ``eval_fwd(bits) -> [N, 2]``: the forward of the gradient-free
    evaluations (the H_nn local energy's connected block, the no-grad
    H_cn), default ``model.log_psi``; the scripts pass the fused forward
    on the card.  The gradient's forwards are ``model.log_psi`` under
    autograd.  The optimizer is ``torch.optim.Adam(lr)`` with optax's
    defaults."""

    def __init__(self, model, system, ci_bits, config: NqsCiConfig | None = None,
                 eval_fwd=None):
        self.model, self.system = model, system
        self.cfg = cfg = config or NqsCiConfig()
        if cfg.grad_strategy not in (0, 1, 2):
            raise ValueError("grad_strategy must be 0, 1 or 2")
        self.eval_fwd = eval_fwd or model.log_psi
        dev = model.M_re.device
        tabs = system.tables(dev)
        self._ops, self._hpair, self._table = tabs.astuple(), tabs.hpair_best, system.excitation
        self._params = [p for p in model.parameters() if p.requires_grad]
        self.opt = torch.optim.Adam(self._params, lr=cfg.lr)

        d_bits = torch.as_tensor(np.asarray(ci_bits), device=dev).to(torch.int8)
        self.m = m = d_bits.shape[0]
        self._d_bits = d_bits
        (self._d_sorted,) = sort_onv(onv.pack_bits(d_bits))
        self._h_cc = hij_dense(d_bits, d_bits, *self._ops).to(torch.float64)  # [m, m]
        # each d_i's connected block, flat [m·(1 + n_sd), sorb], and its
        # elements with the connections back inside D zeroed (H_cc has them)
        flat, hij = [], []
        for s in range(0, m, CI_ROWS):
            comb, h = comb_hij(d_bits[s:s + CI_ROWS], *self._ops, self._hpair,
                               table=self._table, with_comb=True)
            comb = comb.reshape(-1, comb.shape[-1])
            flat.append(comb)
            hij.append(torch.where(self._in_d(comb).reshape(h.shape), 0.0, h))
        self._ci_flat = torch.cat(flat)
        self._ci_hij = torch.cat(hij)  # [m, 1 + n_sd], the tables' dtype
        self.history: list[float] = []  # e_tot + ecore per iteration
        self.stats: list[dict] = []  # per iteration: e_tot, c_m, h_nn, ci_mass

    def _in_d(self, bits: torch.Tensor) -> torch.Tensor:
        return lut_search(self._d_sorted, onv.pack_bits(bits))[1]

    def _masked_eval(self, bits: torch.Tensor) -> torch.Tensor:
        """log φ' = log φ off D, floored by −690 on D (eval forward)."""
        lp = self.eval_fwd(bits)
        la = torch.where(self._in_d(bits), lp[:, 0] - 690.0, lp[:, 0])
        return torch.stack([la, lp[:, 1]], -1)

    @torch.no_grad()
    def draw(self, generator: torch.Generator):
        """Samples of φ with the D members weight-zeroed: (bits [C, sorb],
        w [C] f64, summing to 1 over the rows outside D).  Not the
        sampler's per-step exclusion, which renormalizes the conditionals
        prefix by prefix: a different measure from |φ'|²/‖φ'‖²."""
        bits, counts, _ = ar_sampling(self.model, self.cfg.n_sample,
                                      capacity=self.cfg.capacity, generator=generator)
        w = torch.where(self._in_d(bits), 0, counts).to(torch.float64)
        return bits, w / w.sum().clamp(min=1.0)

    @torch.no_grad()
    def eloc_eval(self, bits: torch.Tensor, w: torch.Tensor):
        """(eloc [C, 2], h_nn): the D-masked local energy through the eval
        forward, 0 on rows of zero weight (dropped before it), and its
        w-mean."""
        alive = w > 0
        el = local_energy_simple(self._masked_eval, bits[alive], self._ops, self._table,
                                 batch=self.cfg.eloc_batch, hpair=self._hpair)
        eloc = torch.zeros(bits.shape[0], 2, dtype=el.dtype, device=el.device)
        eloc[alive] = el
        return eloc, (w * eloc[:, 0]).sum()

    @torch.no_grad()
    def hcn_eval(self):
        """(Re H_cn [m], Σ_D |φ(d)|²) through the eval forward, in its dtype,
        over ``ci_chunk``-row chunks of the connected block."""
        fwd = self.eval_fwd
        phi = torch.cat([cplx.exp_pair(fwd(self._ci_flat[s:e]))[0]
                         for s, e in _chunks(self._ci_flat.shape[0], self.cfg.ci_chunk)])
        ci_mass = torch.exp(2 * fwd(self._d_bits)[:, 0]).sum()
        norm = torch.sqrt((1.0 - ci_mass).clamp(min=1e-30))
        return (self._ci_hij * phi.reshape(self._ci_hij.shape)).sum(-1) / norm, ci_mass

    @torch.no_grad()
    def solve(self, h_nn, h_cn):
        """The lowest eigenpair of the f64 (m+1)×(m+1) matrix, on the
        device: (e_tot without ecore, c [m+1] numpy)."""
        m = self.m
        heff = torch.zeros(m + 1, m + 1, dtype=torch.float64, device=self._h_cc.device)
        heff[:m, :m] = self._h_cc
        heff[:m, m] = heff[m, :m] = h_cn.to(torch.float64)
        heff[m, m] = h_nn
        evals, evecs = torch.linalg.eigh(heff)
        return float(evals[0]), evecs[:, 0].cpu().numpy()

    def warmup_scale(self, it: int, c: np.ndarray) -> float:
        """The surrogate's factor at iteration ``it`` (strategies 0/1 while
        it < start_iter; else 1)."""
        cfg = self.cfg
        cm2 = max(float(c[self.m]) ** 2, 1e-300)
        if it >= cfg.start_iter or cfg.grad_strategy == 2:
            return 1.0
        if cfg.grad_strategy == 0:
            return max(cm2, cfg.cnqs_pow_min) / cm2
        a = np.sqrt(cm2)
        return max(a, np.sqrt(cfg.cnqs_pow_min)) / a

    def gradients(self, bits, w, eloc, h_nn, c, scale: float) -> list:
        """∂ of the surrogate scale·(c_m²·s_nn + s_cn) (strategy 2: s_nn)
        for the model's parameters, in ``model.parameters()`` order, with

            s_nn = 2 Σ_n w_n (E_loc(n) − [h_nn, 0]) · log ψ(n),
            s_cn = 2 c_m Σ_i c_i Re H_cn,i = 2 c_m A / ‖φ'‖,
            A = Σ_i c_i Σ_k H_ik Re φ(k).

        Each chunk's backward runs alone, so the saved activations scale
        with ``ci_chunk``.  ∂(A/‖φ'‖) = ∂A/‖φ'‖ − A·∂‖φ'‖/‖φ'‖²: the chunks
        of A are differentiated with ‖φ'‖ held fixed, then ‖φ'‖ once
        through log ψ of the m CI rows with A held fixed."""
        f64 = torch.float64
        grads = [torch.zeros_like(p) for p in self._params]

        def accumulate(loss):
            for acc, g in zip(grads, torch.autograd.grad(loss, self._params, allow_unused=True)):
                if g is not None:
                    acc += g

        c = torch.as_tensor(np.asarray(c), dtype=f64, device=bits.device)
        cm = c[self.m]
        coef_nn = 1.0 if self.cfg.grad_strategy == 2 else scale * cm**2
        alive = w > 0
        rows, wa = bits[alive], w[alive]
        cen = eloc[alive].to(f64) - torch.stack([h_nn.to(f64), torch.zeros_like(cm)])
        for s, e in _chunks(rows.shape[0], self.cfg.ci_chunk):
            lp = self.model.log_psi(rows[s:e])
            accumulate(coef_nn * 2.0 * (wa[s:e] * (cen[s:e] * lp).sum(-1)).sum())
        if self.cfg.grad_strategy == 2:
            return grads

        def norm_of(lp_d):
            return torch.sqrt((1.0 - torch.exp(2 * lp_d[:, 0]).sum()).clamp(min=1e-30))

        coef = scale * 2.0 * cm
        with torch.no_grad():
            norm = norm_of(self.model.log_psi(self._d_bits))
        cw = (c[:self.m, None] * self._ci_hij).reshape(-1)  # c_i H_ik per connected row
        A = torch.zeros((), dtype=f64, device=bits.device)
        for s, e in _chunks(self._ci_flat.shape[0], self.cfg.ci_chunk):
            a = (cw[s:e] * cplx.exp_pair(self.model.log_psi(self._ci_flat[s:e]))[0]).sum()
            accumulate(coef * a / norm)
            A += a.detach()
        accumulate(coef * A / norm_of(self.model.log_psi(self._d_bits)))
        return grads

    def grad_step(self, bits, w, eloc, h_nn, c, scale: float) -> None:
        """One Adam update along ``gradients``."""
        for p, g in zip(self._params, self.gradients(bits, w, eloc, h_nn, c, scale)):
            p.grad = g
        self.opt.step()

    def step(self, it: int, generator: torch.Generator):
        """One iteration: draw, H_nn, H_cn, eigensolve, gradient step.
        Returns ({"e_tot" (with ecore), "c_m", "h_nn", "ci_mass"}, c)."""
        bits, w = self.draw(generator)
        eloc, h_nn = self.eloc_eval(bits, w)
        h_cn, ci_mass = self.hcn_eval()
        e_tot, c = self.solve(h_nn, h_cn)
        self.grad_step(bits, w, eloc, h_nn, c, self.warmup_scale(it, c))
        return {"e_tot": e_tot + self.system.ecore, "c_m": float(c[self.m]),
                "h_nn": float(h_nn), "ci_mass": float(ci_mass)}, c

    def run(self, generator: torch.Generator, n_iter: int | None = None):
        """``n_iter`` (default ``cfg.n_iter``) iterations from the model's
        current parameters with a fresh optimizer state; returns (c of the
        last eigensolve [m+1] numpy, history of e_tot + ecore)."""
        cfg = self.cfg
        n_iter = n_iter or cfg.n_iter
        self.opt = torch.optim.Adam(self._params, lr=cfg.lr)
        c = None
        for it in range(n_iter):
            st, c = self.step(it, generator)
            self.history.append(st["e_tot"])
            self.stats.append(st)
            if cfg.log_every and (it % cfg.log_every == 0 or it == n_iter - 1):
                print(f"[nqsci] iter {it:5d}  e_tot = {st['e_tot']:.6f} Ha"
                      f"  |c_m| = {abs(st['c_m']):.4f}", flush=True)
        return c, self.history


@torch.no_grad()
def ci_polish(
    model,
    system,
    d_bits,
    sample_bits,
    generator: torch.Generator,
    *,
    fwd=None,
    sample_counts=None,
    ci_chunk: int = 128,
    eloc_batch: int = 1024,
    k_det: int = 1024,
    n_stoch: int = 256,
    restrict: str = "complement",
    device=None,
):
    """The polished energy of ``model`` (on ``device``, default the card).

    ``d_bits`` [m, sorb]: the CI determinants; ``sample_bits`` [C, sorb]:
    the captured set (may hold D members, duplicates and, with
    ``sample_counts`` [C], dead slots of count 0).  ``fwd``: the
    gradient-free forward rows -> [N, 2] (default ``model.log_psi``).
    ``ci_chunk`` CI rows per H_cn block, ``eloc_batch`` samples per
    local-energy chunk, REDUCE with ``k_det`` screened terms and
    ``n_stoch`` tail draws from ``generator`` (k_det = n_sd in capture
    mode).  Returns (e_elec, c [m+1] complex128 numpy, info)."""
    if restrict not in RESTRICT:
        raise ValueError(f"restrict must be 'complement' or 'capture': {restrict}")
    dev, mdev = resolve_device(device), model.M_re.device
    if mdev.type != dev.type or dev.index not in (None, mdev.index):
        raise ValueError(f"the model is on {mdev}, not on {dev}")
    dev = mdev
    if fwd is None:
        fwd = model.log_psi
    tabs = system.tables(dev)
    ops, hpair, table = tabs.astuple(), tabs.hpair_best, system.excitation
    f64 = torch.float64

    d_bits = torch.as_tensor(d_bits, device=dev).to(torch.int8)
    m = d_bits.shape[0]
    (d_sorted,) = sort_onv(onv.pack_bits(d_bits))
    lp_d = fwd(d_bits)
    p_d = torch.exp(2.0 * lp_d[:, 0].to(f64))

    # the captured rows that enter the complement: not in D, live, and the
    # first of their duplicates (D rows are floored to an exact f32 zero
    # by the masked forward, so they must never reach the local energy)
    sample_bits = torch.as_tensor(sample_bits, device=dev).to(torch.int8)
    s_packed = onv.pack_bits(sample_bits)
    keep = ~lut_search(d_sorted, s_packed)[1]
    if sample_counts is not None:
        keep &= torch.as_tensor(np.asarray(sample_counts), device=dev) > 0
    first = torch.zeros_like(keep)
    first[unique_rows(sample_bits)[0]] = True
    keep &= first
    if not bool(keep.any()):
        raise ValueError(
            "ci_polish: no usable captured rows — every sample_bits row is a D member, a "
            "duplicate, or a dead (zero-count) capacity slot; enlarge the capture or shrink "
            "the CI space")
    rows = sample_bits[keep]
    lp_s = fwd(rows)
    p_s = torch.exp(2.0 * lp_s[:, 0].to(f64))

    if restrict == "capture":
        (cap_sorted,) = sort_onv(s_packed[keep])
        norm2_c = p_s.sum().clamp(min=1e-30)
        k_det = table.n_sd
    else:
        cap_sorted = None
        norm2_c = (1.0 - p_d.sum()).clamp(min=1e-30)
    norm_c = torch.sqrt(norm2_c)

    def dead(bits):
        """Rows outside φ's support: in D, or (capture mode) not captured."""
        packed = onv.pack_bits(bits)
        out = lut_search(d_sorted, packed)[1]
        if cap_sorted is not None:
            out |= ~lut_search(cap_sorted, packed)[1]
        return out

    h_cc = hij_dense(d_bits, d_bits, *ops).to(f64)

    h_cn = []  # exact sums over each d_i's connected space
    for i in range(0, m, ci_chunk):
        comb, hij = comb_hij(d_bits[i:i + ci_chunk], *ops, hpair, table=table, with_comb=True)
        flat = comb.reshape(-1, comb.shape[-1])
        hij = torch.where(dead(flat).reshape(hij.shape), 0.0, hij).to(f64)
        phi_re, phi_im = cplx.exp_pair(fwd(flat).to(f64).reshape(comb.shape[:2] + (2,)))
        h_cn.append(torch.stack([(hij * phi_re).sum(-1), (hij * phi_im).sum(-1)], -1))
    h_cn = torch.cat(h_cn) / norm_c

    def masked_fwd(bits):
        lp = fwd(bits)
        la = torch.where(dead(bits), lp[:, 0] - 690.0, lp[:, 0])
        return torch.stack([la, lp[:, 1]], -1)

    w = torch.exp(2.0 * (lp_s[:, 0] - lp_s[:, 0].max()).to(f64))
    w = w / w.sum()
    el = local_energy_reduce(masked_fwd, rows, ops, table, generator,
                             k_det=min(k_det, table.n_sd), n_stoch=n_stoch, batch=eloc_batch,
                             hpair=hpair, topk="segmax")[:, 0].to(f64)
    h_nn = (w * el).sum()
    # coverage of the FULL complement in both modes: Σ_{capture\D}|φ|² against
    # the closed-form ‖φ'‖² = 1 − Σ_D |φ(d)|²
    p_cov = p_s.sum() / (1.0 - p_d.sum()).clamp(min=1e-30)

    # the Hermitian (m+1) matrix: the couplings are complex pairs
    H = torch.zeros(m + 1, m + 1, dtype=torch.complex128, device=dev)
    H[:m, :m] = h_cc
    H[:m, m] = torch.complex(h_cn[:, 0], h_cn[:, 1])
    H[m, :m] = torch.complex(h_cn[:, 0], -h_cn[:, 1])
    H[m, m] = h_nn
    evals, evecs = torch.linalg.eigh(H)
    c = evecs[:, 0].cpu().numpy()
    info = {
        "restrict": restrict,
        "h_nn": float(h_nn),
        "norm2_complement": float(norm2_c),
        "captured_complement_fraction": float(p_cov),
        "ci_mass": float(p_d.sum()),
        "c_m2": float(np.abs(c[-1]) ** 2),
    }
    return float(evals[0]), c, info
