"""Fixed-node Green's-function Monte Carlo on top of a trial wavefunction.

Counterpart of ``pynqs_tpu/gfmc/walker.py`` (``GFMCConfig``, ``GFMC``,
``ci_trial_log_psi``, ``mixed_energy``).  Walkers are a fixed [W, sorb]
batch, split over the ranks of a ``mesh`` (``parallel/``) where one is
given.  One iteration is two functions:

  * ``GFMC.green_row``, deterministic: the connected determinants and
    matrix elements of every walker (``comb_hij``), the trial forward of
    the whole [W, 1 + n_sd] block (optionally once per distinct row,
    ``energy/eloc.dedup_eval``), and Sorella's fixed-node sign cure
    (γ ≥ 0):
        t_m   = H_nm · Re[ψ_T(m)/ψ_T(n)]        (m ≠ n)
        V_sf  = Σ_{t_m > 0} t_m
        e_fn  = H_nn + (1 + γ) V_sf              (effective diagonal)
        G_m   = −t_m for t_m < 0, γ·t_m for t_m > 0
        Λ     = tau_lambda, or max_n e_fn(n) + 1
        b     = Λ − e_fn + Σ_m G_m               (weight multiplier)
    and the true local energy e_loc = H_nn + Σ_m t_m of the mixed
    estimator;
  * ``GFMC.transition``, random: each walker stays with weight Λ − e_fn
    or moves to m with weight G_m (an inverse-CDF draw).

``GFMC.branch`` is systematic comb resampling from one uniform u0
(``branch_indices``).  ``GFMC.run`` keeps walkers, weights and each
generation's statistics on the device and reads the statistics back
once per ``sync_interval`` iterations; it raises when b ≤ 0 for a
walker (``check_lambda``) and whenever b or a generation statistic is
NaN or infinite (the JAX package's guard ``(b <= 0).any()`` lets NaN
through).  ``green_row``, ``transition`` and ``branch`` are the
``torch.profiler`` ranges ``gfmc.green_row``, ``gfmc.transition`` and
``gfmc.branch``; ``run``'s reads of the statistics, walkers and weights
back to the host are ``gfmc.readback``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from pynqs_tpu_torch.energy.eloc import dedup_eval
from pynqs_tpu_torch.ops.hamiltonian import comb_hij
from pynqs_tpu_torch.ops.lut import WavefunctionLUT
from pynqs_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
    rand_rows,
    shard_batch,
)
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["GFMC", "GFMCConfig", "GreenRow", "branch_indices", "ci_trial_log_psi",
           "mixed_energy"]

_FLOOR = -690.0  # log|ψ_T| of a determinant outside the CI expansion (≈ 0 amplitude)


def ci_trial_log_psi(ci, device=None):
    """The trial wavefunction of a CI expansion ``ci`` (``CIWavefunction``)
    through a lookup table: rows -> (log|c|, 0 or π) [N, 2] f64; a
    determinant outside the expansion reads log|ψ| = −690."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(ci.coeffs), dtype=torch.float64, device=dev)
    logabs = torch.log(c.abs().clamp(min=1e-30))
    ph = torch.where(c < 0, torch.pi, 0.0).to(torch.float64)
    lut = WavefunctionLUT.build(torch.as_tensor(np.asarray(ci.bits), device=dev),
                                torch.stack([logabs, ph], -1))

    def trial(bits):
        vals, found = lut.lookup(bits, fill=0.0)
        return torch.stack([torch.where(found, vals[:, 0], _FLOOR), vals[:, 1]], -1)

    return trial


@dataclass
class GFMCConfig:
    n_walkers: int = 1024
    n_iter: int = 200
    p_steps: int = 10  # depth of the mixed estimator's β products
    tau_lambda: float | None = None  # Λ; None = max e_fn of the batch + 1
    gamma: float = 0.0  # sign-cure partial inclusion
    # iterations between comb branchings; branching every step maximizes
    # the finite-population bias, so keep >= 10 and grow W instead
    branch_interval: int = 10
    seed: int = 0
    # the trial forward once per distinct row of the [W, 1 + n_sd] block,
    # at most this many (dedup_eval raises above it); 0 = off
    dedup_unique_max: int = 0
    # raise when Λ − e_fn ≤ 0 for a walker (the weights are Green
    # normalizations)
    check_lambda: bool = True
    # iterations between reads of the statistics back to the host
    sync_interval: int = 50


class GreenRow(NamedTuple):
    """The deterministic part of one iteration for W walkers."""

    comb: torch.Tensor  # [W, M, sorb] int8: row 0 the walker, then its singles and doubles
    e_loc: torch.Tensor  # [W] true local energy (without ecore)
    b: torch.Tensor  # [W] Λ − e_fn + Σ G, the weight multiplier
    g_diag: torch.Tensor  # [W] Λ − e_fn diagonal: the weight of staying
    g_off: torch.Tensor  # [W, M − 1] ≥ 0: the weight of each move
    n_unique: int | None  # distinct rows of the trial block (dedup only)


def branch_indices(weights: torch.Tensor, u0) -> torch.Tensor:
    """Systematic comb resampling: the W walker indices of the combs
    (u0 + k)/W, k = 0 .. W − 1, on the cumulative normalized weights."""
    W = weights.shape[0]
    cum = torch.cumsum(weights, 0) / weights.sum()
    combs = (torch.as_tensor(u0, dtype=weights.dtype, device=weights.device)
             + torch.arange(W, dtype=weights.dtype, device=weights.device)) / W
    return torch.searchsorted(cum, combs).clamp(0, W - 1)


class GFMC:
    """``trial_log_psi``: rows [N, sorb] -> (log|ψ_T|, arg ψ_T) [N, 2].
    The Hamiltonian tables live on ``device`` (default the card) in the
    system's dtype; ``mesh`` splits the walkers over its ranks."""

    def __init__(self, trial_log_psi, system, config: GFMCConfig | None = None, *,
                 device=None, mesh=None):
        self.trial = trial_log_psi
        self.system = system
        self.cfg = config or GFMCConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        tabs = system.tables(self.device)
        self._ops = tabs.astuple()
        self._hpair = tabs.hpair_best
        self._table = system.excitation

    @torch.no_grad()
    def green_row(self, walkers: torch.Tensor) -> GreenRow:
        """The Green row of ``walkers`` [W, sorb]."""
        with record_function("gfmc.green_row"):
            cfg = self.cfg
            comb, hij = comb_hij(walkers, *self._ops, self._hpair, table=self._table,
                                 with_comb=True)
            W, M, sorb = comb.shape
            flat = comb.reshape(W * M, sorb)
            if cfg.dedup_unique_max:
                lp, n_unique = dedup_eval(self.trial, flat, cfg.dedup_unique_max)
            else:
                lp, n_unique = self.trial(flat), None
            lp = lp.reshape(W, M, 2)
            ratio = torch.exp(lp[..., 0] - lp[:, :1, 0]) * torch.cos(lp[..., 1] - lp[:, :1, 1])
            t = hij[:, 1:] * ratio[:, 1:]
            viol = t > 0
            v_sf = torch.where(viol, t, 0.0).sum(-1)
            e_fn_diag = hij[:, 0] + (1.0 + cfg.gamma) * v_sf
            g_off = torch.where(viol, cfg.gamma * t, -t)
            e_loc = hij[:, 0] + t.sum(-1)
            lam = (torch.as_tensor(cfg.tau_lambda, dtype=e_fn_diag.dtype, device=e_fn_diag.device)
                   if cfg.tau_lambda is not None
                   else all_reduce_max(self.mesh, e_fn_diag.max()) + 1.0)
            g_diag = lam - e_fn_diag
            return GreenRow(comb, e_loc, g_diag + g_off.sum(-1), g_diag, g_off, n_unique)

    @torch.no_grad()
    def transition(self, row: GreenRow, generator: torch.Generator) -> torch.Tensor:
        """The next walkers [W, sorb]: each stays with weight g_diag or moves
        to its m-th connected determinant with weight g_off[m] (weights
        floored at 1e-30, as the JAX package's logits)."""
        with record_function("gfmc.transition"):
            g = torch.cat([row.g_diag[:, None], row.g_off], -1).clamp(min=1e-30).double()
            cdf = torch.cumsum(g, -1)
            u = rand_rows(self.mesh, g.shape[0], 1, generator=generator, dtype=cdf.dtype,
                          device=cdf.device) * cdf[:, -1:]
            choice = torch.searchsorted(cdf, u, right=True)[:, 0].clamp(max=g.shape[1] - 1)
            return row.comb[torch.arange(g.shape[0], device=g.device), choice]

    @torch.no_grad()
    def branch(self, walkers: torch.Tensor, weights: torch.Tensor, generator: torch.Generator):
        """Comb resampling from one uniform draw: (walkers, equal weights);
        under a mesh over the whole population, this rank's block."""
        with record_function("gfmc.branch"):
            u0 = torch.rand((), generator=generator, dtype=weights.dtype, device=weights.device)
            all_w = all_gather_rows(self.mesh, weights)
            idx = shard_batch(self.mesh, branch_indices(all_w, u0))
            return (all_gather_rows(self.mesh, walkers)[idx],
                    (all_w.sum() / all_w.shape[0]).expand_as(weights).clone())

    def _guard(self, it0: int, stats: np.ndarray) -> None:
        """Raise on a non-finite statistic or b, or on b ≤ 0 (check_lambda)."""
        bad = ~np.isfinite(stats).all(1)
        if bad.any():
            i = int(np.argmax(bad))
            raise FloatingPointError(
                f"GFMC iteration {it0 + i}: a non-finite b or generation statistic "
                f"(e_gen, e_gen_b, wbar, min b = {stats[i].tolist()})")
        if self.cfg.check_lambda and (stats[:, 3] <= 0.0).any():
            i = int(np.argmax(stats[:, 3] <= 0.0))
            raise FloatingPointError(
                f"GFMC iteration {it0 + i}: Λ − e_fn ≤ 0 for some walker (min b = "
                f"{stats[:, 3].min():.3e}) — raise tau_lambda")

    @torch.no_grad()
    def run(self, init_walkers, generator: torch.Generator | None = None,
            n_iter: int | None = None) -> dict:
        """Run from ``init_walkers`` [W, sorb] (e.g. samples of |ψ_T|²; under
        a mesh the same global walkers on every rank, which keeps its block).

        Per generation l: ē_l = Σ w e_loc / Σ w with the weights before the
        step, ē_l^b the same after it, and w̄_l = Σ w b / Σ w; the weights
        are then renormalized to mean 1 and every ``branch_interval``
        iterations resampled.  Returns {"e_gen", "e_gen_b", "wbar" [n_iter]
        (energies with ecore), "walkers", "weights", "n_unique" (per
        iteration with dedup, else None)}, the walkers and weights of every
        rank; assemble depth-p estimates with ``mixed_energy``."""
        cfg = self.cfg
        n_iter = n_iter or cfg.n_iter
        dev = self.device
        gen = (generator if generator is not None
               else torch.Generator(device=dev).manual_seed(cfg.seed))
        if not torch.is_tensor(init_walkers):
            init_walkers = torch.from_numpy(np.array(init_walkers))  # a copy: views may be read-only
        walkers = shard_batch(self.mesh, init_walkers.to(device=dev, dtype=torch.int8))
        weights = torch.ones(walkers.shape[0], dtype=torch.float64, device=dev)
        sync = max(1, min(cfg.sync_interval, n_iter))
        stats, pending, n_unique = [], [], []
        for it in range(n_iter):
            row = self.green_row(walkers)
            walkers = self.transition(row, gen)
            e_loc, b = row.e_loc.double(), row.b.double()
            w_pre = weights
            weights = weights * b
            sums = all_reduce_sum(self.mesh, torch.stack([
                (w_pre * e_loc).sum(), w_pre.sum(), (weights * e_loc).sum(), weights.sum()]))
            pending.append(torch.stack([
                sums[0] / sums[1],
                sums[2] / sums[3],
                sums[3] / sums[1],
                # NaN where any b is (torch.min propagates NaN)
                -all_reduce_max(self.mesh, -b.min()),
            ]))
            n_all = weights.shape[0] * (1 if self.mesh is None else self.mesh.size)
            weights = weights / (sums[3] / n_all).clamp(min=1e-30)
            if cfg.branch_interval and (it + 1) % cfg.branch_interval == 0:
                walkers, weights = self.branch(walkers, weights, gen)
            if row.n_unique is not None:
                n_unique.append(row.n_unique)
            if len(pending) == sync or it == n_iter - 1:
                with record_function("gfmc.readback"):
                    chunk = torch.stack(pending).cpu().numpy()
                self._guard(it + 1 - len(pending), chunk)
                stats.append(chunk)
                pending = []
        st = np.concatenate(stats)
        ecore = self.system.ecore
        with record_function("gfmc.readback"):
            walkers = all_gather_rows(self.mesh, walkers).cpu().numpy()
            weights = all_gather_rows(self.mesh, weights).cpu().numpy()
        return {
            "e_gen": st[:, 0] + ecore,
            "e_gen_b": st[:, 1] + ecore,
            "wbar": st[:, 2],
            "walkers": walkers,
            "weights": weights,
            "n_unique": np.asarray(n_unique) if n_unique else None,
        }


def mixed_energy(out, p: int, *, tail: int | None = None, n_blocks: int = 10):
    """Depth-``p`` mixed estimator from a ``GFMC.run`` output,

        E(p) = Σ_l G_l ē_l / Σ_l G_l,   G_l = Π_{j=1..p} w̄_{l−j},

    over the last ``tail`` generations (default: the second half), with a
    blocked standard error over ``n_blocks`` blocks.  Returns (E, se)."""
    e = np.asarray(out["e_gen"], np.float64)
    w = np.asarray(out["wbar"], np.float64)
    n = len(e)
    if tail is None:
        tail = n // 2
    tail = min(tail, n - p)
    # the p factors before generation l, scaled against overflow (a
    # constant scale cancels in the ratio)
    lw = np.log(np.maximum(w / max(w.mean(), 1e-300), 1e-300))
    cum = np.concatenate([[0.0], np.cumsum(lw)])
    ls = np.arange(n - tail, n)
    ls = ls[ls >= p]
    logg = cum[ls] - cum[ls - p]
    g = np.exp(logg - logg.max())
    est = float((g * e[ls]).sum() / g.sum())
    blocks = []
    for k in range(n_blocks):
        sl = slice(k * len(ls) // n_blocks, (k + 1) * len(ls) // n_blocks)
        if g[sl].sum() > 0:
            blocks.append((g[sl] * e[ls][sl]).sum() / g[sl].sum())
    se = float(np.std(blocks) / np.sqrt(max(len(blocks) - 1, 1)))
    return est, se
