"""Heat-bath selected CI and its Epstein–Nesbet PT2 correction.

Counterpart of ``pynqs_tpu/ci/selected.py`` (Holmes, Tubman, Umrigar,
JCTC 12, 3674 (2016)): the variational space grows from a seed by every
connected determinant a with ``max_i |H_ai c_i| > eps1``, re-diagonalized
each round (:func:`pynqs_tpu_torch.ci.solve.solve_ci`), and
:func:`en_pt2` adds the deterministic second-order correction over the
discarded space (term screen ``|H_ai c_i| > eps2``).

The connected space of each parent chunk comes from ``comb_hij`` on the
tables' device, and the screen runs there on its output: only the
surviving (determinant, |H_ai c_i|, H_ai c_i) triples are kept.
Duplicates are merged (``energy.eloc.unique_rows``) and the space is
searched (``ops.lut.lut_search``) with the int64 row keys of
``ops/lut.py`` in place of the JAX package's numpy void keys, so the
unique candidates come in another order: under ``max_space`` the kept
set can differ only where importances tie.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.ci.solve import solve_ci
from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.energy.eloc import unique_rows
from pynqs_tpu_torch.ops import onv
from pynqs_tpu_torch.ops.hamiltonian import comb_hij, hij_diagonal
from pynqs_tpu_torch.ops.lut import lut_search, sort_onv
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["selected_ci", "en_pt2"]


def _screened_connected(bits, coeffs, ops, hpair, table, eps, chunk):
    """Every (connected determinant, |H_ai c_i|, H_ai c_i) above the screen
    ``> eps``, over parent chunks of ``chunk`` rows: (bits [K, sorb] int8,
    importance [K] f64, signed term [K] f64) on the tables' device.
    ``bits`` [n, sorb] and ``coeffs`` [n] f64 are tensors there."""
    out_bits, out_imp, out_num = [], [], []
    for s in range(0, bits.shape[0], chunk):
        comb, hij = comb_hij(bits[s:s + chunk], *ops, hpair, table=table, with_comb=True)
        term = hij[:, 1:].to(torch.float64) * coeffs[s:s + chunk, None]  # no diagonal
        imp = term.abs()
        mask = imp > eps
        out_bits.append(comb[:, 1:][mask])
        out_imp.append(imp[mask])
        out_num.append(term[mask])
    return torch.cat(out_bits), torch.cat(out_imp), torch.cat(out_num)


def _merge(cand: torch.Tensor, values: torch.Tensor, reduce: str):
    """Distinct candidates in key order: (first row of each [U], ``values``
    reduced per candidate by "amax" or "sum" [U])."""
    first, inv = unique_rows(cand)
    red = torch.zeros(first.shape[0], dtype=values.dtype, device=values.device)
    return first, red.scatter_reduce_(0, inv, values, reduce)


def _outside(space: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[n] bool: which of ``rows`` are not in ``space``."""
    (keys,) = sort_onv(onv.pack_bits(space))
    return ~lut_search(keys, onv.pack_bits(rows))[1]


def _tables(system, device):
    tabs = system.tables(resolve_device(device))
    return tabs, tabs.astuple(), tabs.hpair_best


def selected_ci(
    system,
    *,
    eps1: float = 1e-3,
    eps2: float | None = None,
    seed_bits: np.ndarray | None = None,
    max_rounds: int = 20,
    max_space: int = 1_000_000,
    chunk: int = 256,
    tol: float = 1e-9,
    cache_max: int = 8192,
    verbose: bool = False,
    device=None,
):
    """Heat-bath selected CI on ``system`` in its dtype, on ``device``
    (default the card).

    Grows the space from ``seed_bits`` (default the HF determinant) by
    every connected determinant with ``|H_ai c_i| > eps1`` for some
    parent i, re-diagonalizing each round, until it stops growing (or
    ``max_rounds`` / ``max_space``).  Where the space would pass
    ``max_space``, the candidates of largest per-determinant maximum
    importance are kept.  Returns ``(e_var, ci, info)``: the variational
    energy (with ecore), the ``CIWavefunction`` and {"rounds",
    "space_sizes", "e_history"}, with "e_pt2"/"e_total" from
    :func:`en_pt2` when ``eps2`` is given."""
    tabs, ops, hpair = _tables(system, device)
    dev, table = ops[3].device, system.excitation
    if seed_bits is None:
        seed_bits = onv.hf_bits(system.sorb, system.noa, system.nob)[None, :]
    space = np.asarray(seed_bits, np.int8)
    if space.ndim == 1:
        space = space[None, :]

    def solve(space):
        return solve_ci(space, tabs, ecore=system.ecore, chunk=chunk, cache_max=cache_max,
                        tol=tol)

    e_hist, sizes = [], [int(space.shape[0])]
    e_var, ci = solve(space)
    e_hist.append(e_var)
    for rnd in range(max_rounds):
        space_d = torch.as_tensor(space, device=dev)
        cand, imp, _ = _screened_connected(
            space_d, torch.as_tensor(np.asarray(ci.coeffs, np.float64), device=dev), ops,
            hpair, table, eps1, chunk)
        if cand.shape[0] == 0:
            break
        first, imp_max = _merge(cand, imp, "amax")
        new = _outside(space_d, cand[first])
        cand_bits, cand_imp = cand[first[new]], imp_max[new]
        if cand_bits.shape[0] == 0:
            break
        room = max_space - space.shape[0]
        if room <= 0:
            break
        if cand_bits.shape[0] > room:
            cand_bits = cand_bits[torch.argsort(-cand_imp, stable=True)[:room]]
        space = np.concatenate([space, cand_bits.cpu().numpy().astype(np.int8)])
        e_var, ci = solve(space)
        e_hist.append(e_var)
        sizes.append(int(space.shape[0]))
        if verbose:
            print(f"selected_ci round {rnd}: m={space.shape[0]} E={e_var:.8f}", flush=True)

    info = {"rounds": len(sizes) - 1, "space_sizes": sizes, "e_history": e_hist}
    if eps2 is not None:
        de2 = en_pt2(system, ci, e_var, eps2=eps2, chunk=chunk, device=dev)
        info["e_pt2"] = de2
        info["e_total"] = e_var + de2
    return e_var, ci, info


def en_pt2(
    system,
    ci: CIWavefunction,
    e_var: float,
    *,
    eps2: float = 0.0,
    chunk: int = 256,
    denom_floor: float = 1e-6,
    device=None,
) -> float:
    """Deterministic Epstein–Nesbet PT2 over the discarded space:

        ΔE2 = Σ_{a∉V} (Σ_{i: |H_ai c_i| > eps2} H_ai c_i)² / (E_var − H_aa),

    with ``e_var`` including ecore.  |E_var − H_aa| is floored at
    ``denom_floor`` with its sign kept (intruder states), as
    deterministic DICE PT2 does."""
    _, ops, hpair = _tables(system, device)
    dev = ops[3].device
    space = torch.as_tensor(np.asarray(ci.bits, np.int8), device=dev)
    cand, _, term = _screened_connected(
        space, torch.as_tensor(np.asarray(ci.coeffs, np.float64), device=dev), ops, hpair,
        system.excitation, eps2, chunk)
    if cand.shape[0] == 0:
        return 0.0
    first, num = _merge(cand, term, "sum")
    external = _outside(space, cand[first])
    if not bool(external.any()):
        return 0.0
    a_bits, num = cand[first[external]], num[external]
    haa = hij_diagonal(a_bits, ops[2], ops[3]).to(torch.float64)
    denom = (e_var - system.ecore) - haa
    floor = torch.full_like(denom, denom_floor)
    denom = torch.where(denom.abs() < denom_floor, torch.where(denom < 0, -floor, floor), denom)
    return float((num**2 / denom).sum())
