"""Final-state evaluation of a trained Graph-MPS-RNN state.

Counterpart of ``scripts/eval_fe2s2_final.py`` (its ``one()`` rep).  Per
repetition, under the DFS sampling measure:

  * E: the REDUCE local energy (k_det = 0 means exact: every connected
    term, no tail) under Rao-Blackwellized weights, the normalized
    |ψ|² of the live rows, and the same under the sample counts;
  * σ² of E_loc under those weights;
  * the spin-raising monitor ⟨S⁻S⁺⟩ (``ops.integrals.spin_raising``),
    the REDUCE local operator under the same weights;
  * the dropped sampling mass and the live row count.

Both operators read their doubles from the dense pair matrix, through
the pair selection kernel on the card (``ops/pair_select.py``); the ψ
forwards are the fused forward's CUDA kernel on the card and the model's
exact forward on the CPU, optionally of the spin-flip-projected state
ψ_P = (ψ + η·U_SF ψ)/2.

The JAX script's command line needs the Fe2S2 integrals (the
reference's ``fe2s2-OO.pth``), which are not in the repository, and
``System.from_pth`` is not ported: call ``evaluate`` with any ``System``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from functools import partial

import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.ops import cplx, fused_rnn, onv
from pynqs_tpu_torch.ops.integrals import spin_raising
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.stats import weighted_stats
from pynqs_tpu_torch.utils.system import System

__all__ = ["evaluate", "EvalRep", "projected_forward"]


@dataclass(frozen=True)
class EvalRep:
    """One repetition.  Energies are totals (ecore included)."""

    e: float  # Rao-Blackwellized E
    e_se: float  # its standard error over the effective sample size
    e_ct: float  # E under the count weights
    var: float  # σ² of E_loc under the Rao-Blackwellized weights
    s: float  # ⟨S⁻S⁺⟩
    s_se: float
    dropped: float  # dropped share of the n_sample draws
    n_live: int
    seconds: float
    rows: torch.Tensor  # the live rows [n_live, sorb] int8, on the device

    def line(self, i: int, e_ref: float | None = None) -> str:
        """The JAX script's line of this rep."""
        d = (f"  ({(self.e - e_ref) * 1e3:+.3f} mHa)  [count-weighted "
             f"{(self.e_ct - e_ref) * 1e3:+.3f}]" if e_ref is not None
             else f"  [count-weighted {self.e_ct:.6f} Ha]")
        return (f"rep {i}: E = {self.e:.6f} Ha{d}  sigma^2 = {self.var:.4g}  "
                f"<S-S+> = {self.s:.4f}  dropped = {self.dropped:.3%}  "
                f"live = {self.n_live}  t = {self.seconds:.1f}s")


def projected_forward(base, eta: float):
    """The log ψ_P forward of the spin-flip-projected state
    ψ_P(n) = ½ψ(n) + ½η·sign_SF(n)·ψ(flip(n))."""

    def fwd(bits):
        lp = base(bits)
        lpf = base(onv.spin_flip_bits(bits))
        s = onv.spin_flip_sign(bits).to(lp.dtype)
        lpf_signed = cplx.make(lpf[..., 0], lpf[..., 1] + math.pi * (1.0 - s) / 2.0)
        return cplx.add_exp(lp, lpf_signed, 0.5, 0.5 * eta)

    return fwd


@torch.no_grad()
def evaluate(
    model,
    system: System,
    *,
    n_sample: int = 10_000_000,
    capacity: int = 4096,
    n_group: int = 8,
    split_depth: int = 8,
    k_det: int = 1024,
    n_stoch: int = 256,
    batch: int = 2048,
    n_rep: int = 4,
    spin_project: int = 0,
    fwd_dtype: str = "bf16",
    generator: torch.Generator | None = None,
    device=None,
) -> list[EvalRep]:
    """``n_rep`` repetitions of the evaluation of ``model`` (a
    ``GraphMPSRNN`` on ``device``, default the card) on ``system``.

    Sampling: ``ar_sampling_dfs`` with ``n_sample`` draws, ``n_group``
    groups of ``capacity`` rows split at ``split_depth``.  Local
    operators: REDUCE with ``k_det`` screened terms and ``n_stoch`` tail
    draws (``k_det = 0``: all n_sd terms and 8 draws of an empty tail),
    ``batch`` samples per chunk.  ``spin_project`` η ∈ {-1, 0, 1}: 0
    evaluates ψ itself; otherwise ψ_P (``projected_forward``) in the
    weights and the ratios, while sampling stays on |ψ|².  The ψ forwards
    are the fused forward on the card and ``model.log_psi`` on the CPU, as
    in the JAX script; ``fwd_dtype``, the fused forward's matmul type
    ("bf16" or "f32"), applies to the card only.  Dead sample slots take
    no forward and no local operator."""
    dev, mdev = resolve_device(device), model.M_re.device
    if mdev.type != dev.type or dev.index not in (None, mdev.index):
        raise ValueError(f"the model is on {mdev}, not on {dev}")
    dev = mdev
    if spin_project not in (-1, 0, 1):
        raise ValueError("spin_project must be -1, 0 or 1")
    mm = {"bf16": torch.bfloat16, "f32": torch.float32}[fwd_dtype]
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    tabs = system.tables(dev, f32)
    s_sys = System.from_integrals(*spin_raising(system.sorb), system.sorb, system.noa,
                                  system.nob)
    tabs_s = s_sys.tables(dev, f32)
    table = system.excitation
    if dev.type == "cpu":  # the exact forward, as the JAX script off the accelerator
        fwd = model.log_psi
    else:
        fwd = partial(fused_rnn.graph_mpsrnn_logpsi_fused, model, matmul_dtype=mm,
                      tables=fused_rnn.pack_tables(model))
    if spin_project:
        fwd = projected_forward(fwd, float(spin_project))
    kd = k_det if k_det > 0 else table.n_sd
    ns = n_stoch if k_det > 0 else 8

    def oloc(t, rows):
        return local_energy_reduce(fwd, rows, t.astuple(), table, gen, k_det=kd,
                                   n_stoch=ns, batch=batch, hpair=t.hpair)[:, 0].double()

    reps = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        bits, counts, dropped = ar_sampling_dfs(
            model, n_sample, capacity=capacity, n_group=n_group, split_depth=split_depth,
            capacity_root=capacity, generator=gen)
        live = counts > 0
        rows, cnt = bits[live], counts[live].double()
        lp = fwd(rows)[:, 0].double()
        p = torch.exp(2.0 * (lp - lp.max()))
        w_ex = p / p.sum()
        el = oloc(tabs, rows)
        sl = oloc(tabs_s, rows)
        e, var, e_se, _ = weighted_stats(el, w_ex)
        s, _, s_se, _ = weighted_stats(sl, w_ex)
        e_ct = (cnt / cnt.sum() * el).sum()
        reps.append(EvalRep(
            e=e.item() + system.ecore, e_se=e_se.item(), e_ct=e_ct.item() + system.ecore,
            var=var.item(), s=s.item(), s_se=s_se.item(),
            dropped=float(dropped) / n_sample, n_live=rows.shape[0],
            seconds=time.perf_counter() - t0, rows=rows,
        ))
    return reps
