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

``main`` is the JAX script's command line around ``evaluate``:

    python -m pynqs_tpu_torch.scripts.eval_fe2s2_final checkpoints/fe2s2_r3_dcut20_ref.pkl

Its default system is the Fe2S2 integrals file
(``utils.flagship.fe2s2_system``), which the repository does not hold:
``main(system=...)`` takes any ``System``.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.ops import cplx, fused_rnn, onv
from pynqs_tpu_torch.ops.integrals import spin_raising
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params
from pynqs_tpu_torch.utils.stats import weighted_stats
from pynqs_tpu_torch.utils.system import System

__all__ = ["evaluate", "EvalRep", "projected_forward", "main", "parser"]


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
    on_rep=None,
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
    no forward and no local operator.  ``on_rep(i, rep)`` is called after
    each repetition."""
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
        if on_rep is not None:
            on_rep(len(reps) - 1, reps[-1])
    return reps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Final-state evaluation of a trained Fe2S2 "
                                             "checkpoint.")
    ap.add_argument("ckpt")
    ap.add_argument("--dcut", type=int, default=20)
    ap.add_argument("--n-sample", type=int, default=10_000_000)
    ap.add_argument("--n-group", type=int, default=8)
    ap.add_argument("--split-depth", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--k-det", type=int, default=1024,
                    help="0 = exact deterministic eloc (k_det = n_sd, no stochastic tail)")
    ap.add_argument("--n-stoch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--n-rep", type=int, default=4,
                    help="independent sample/eloc repetitions")
    ap.add_argument("--spin-project", type=int, default=0, choices=[-1, 0, 1],
                    help="evaluate the spin-flip-projected state psi_P = (1 + eta*U_SF)/2 "
                         "psi; sampling stays on |psi|^2")
    ap.add_argument("--use-tensor", action="store_true",
                    help="checkpoint was trained with tensor coupling")
    ap.add_argument("--max-preds", type=int, default=1,
                    help="checkpoint's multi-predecessor graph width")
    ap.add_argument("--fwd-dtype", choices=["bf16", "f32"], default="bf16",
                    help="fused-forward matmul dtype")
    return ap


def main(argv=None, *, system=None, device=None) -> list[EvalRep]:
    """The JAX script's ``main``: evaluate the checkpoint ``ckpt`` on
    ``system`` (default ``fe2s2_system()``) on ``device`` (default the
    card), print each rep's line and the final line; returns the reps."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, args.dcut, use_tensor=args.use_tensor,
                           max_preds=args.max_preds, device=dev)
    model.load_numpy_params(load_flagship_params(args.ckpt))

    def show(i, rep):
        print(rep.line(i, sys_.e_ref), flush=True)

    reps = evaluate(
        model, sys_, n_sample=args.n_sample, capacity=args.capacity, n_group=args.n_group,
        split_depth=args.split_depth, k_det=args.k_det, n_stoch=args.n_stoch,
        batch=args.batch, n_rep=args.n_rep, spin_project=args.spin_project,
        fwd_dtype=args.fwd_dtype, generator=torch.Generator(device=dev).manual_seed(1000),
        device=dev, on_rep=show)
    es = [r.e for r in reps]
    e_m = float(np.mean(es))
    se = float(np.std(es) / np.sqrt(len(es)))
    delta = (f"   Delta = {(e_m - sys_.e_ref) * 1000:+.3f} mHa"
             if sys_.e_ref is not None else "")
    print(f"\nFINAL  E = {e_m:.6f} +- {se:.6f} Ha{delta}   "
          f"<S-S+> = {np.mean([r.s for r in reps]):.4f}   "
          f"dropped = {np.mean([r.dropped for r in reps]):.3%}")
    return reps


if __name__ == "__main__":
    main()
