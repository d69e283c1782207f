"""The one-shot CI-NQS polish of a trained state.

Counterpart of ``pynqs_tpu/ci/nqs_ci.py``'s ``ci_polish`` (the NqsCi
training loop is not ported yet).  For fixed NQS parameters it builds
the (m+1)×(m+1) Hamiltonian of ψ = Σ_i c_i|d_i⟩ + c_m|φ̂⟩, φ̂ the NQS
without the CI set D, and returns its lowest eigenvalue:

  * H_cc = ⟨d_i|H|d_j⟩, dense Slater–Condon blocks (``hij_dense``);
  * H_cn[i] = Σ_{k ∈ SD(d_i) \\ D} H_ik φ(k) / ‖φ'‖, exact over each
    d_i's connected space (``comb_hij``);
  * H_nn, the local energy of the D-masked state under the exact |φ|²
    weights of the captured rows outside D (REDUCE);
  * the eigensolve in complex128 on the tensors' device
    (``torch.linalg.eigh``).

``restrict="complement"`` takes ‖φ'‖² = 1 − Σ_D |φ(d)|² in closed form
(exact AR normalization) and estimates H_nn over the capture: the
eigenvalue is variational only where the capture covers the complement.
``restrict="capture"`` restricts φ' to (capture \\ D): every entry is an
exact finite sum (k_det is then n_sd), and the eigenvalue is a true
upper bound whatever the coverage.

D members, duplicate capture rows and dead capture slots (count 0) are
dropped before the local energy: the masked forward floors D rows'
log-amplitude by −690, which is an exact 0 in f32, and 0·inf would be
NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce, unique_rows
from pynqs_tpu_torch.ops import cplx, onv
from pynqs_tpu_torch.ops.hamiltonian import comb_hij, hij_dense
from pynqs_tpu_torch.ops.lut import lut_search, sort_onv
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["ci_polish", "RESTRICT"]

RESTRICT = ("complement", "capture")


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
