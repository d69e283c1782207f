"""The port's AR sampler: exact multinomial counts of |ψ|².

The torch and JAX random streams differ, so nothing here asks for bit
parity: counts must sum to n_sample, rows must be unique valid
determinants, and the frequencies must lie within 5 binomial standard
errors of the exact |ψ|² of the model (plus 1e-9)."""

import numpy as np
import pytest
import torch

from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.sampler.ar import (
    _binomial_int,
    ar_sampling,
    ar_sampling_dfs,
    compact_by_count,
    multinomial_partition,
)
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler

SORB, NOA, NOB = 8, 2, 2
SPACE = fci.fci_bits(SORB, NOA, NOB)  # 36 determinants


def _model(graph):
    """"chain", "dag" (2x2 snake grid) or "dag-tensor" (the same grid with
    the tensor coupling at its 2-predecessor site)."""
    return GraphMPSRNN(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                       graph=grid_snake_graph(2, 2) if graph != "chain" else None,
                       use_tensor=graph == "dag-tensor", dcut_cmpr=3,
                       device="cpu", generator=torch.Generator().manual_seed(0))


def _p_exact(model):
    with torch.no_grad():
        lp = model.log_psi(torch.as_tensor(SPACE))
    p = np.exp(2 * lp[:, 0].numpy())
    assert abs(p.sum() - 1.0) < 1e-10, "AR conditionals must normalize"
    return p


def _check_counts(bits, counts, n, p):
    bits, counts = bits.numpy(), counts.numpy()
    live = counts > 0
    assert counts.sum() == n and (counts >= 0).all()
    b = bits[live]
    assert (b[:, 0::2].sum(1) == NOA).all() and (b[:, 1::2].sum(1) == NOB).all()
    assert len({r.tobytes() for r in b}) == b.shape[0], "rows must be unique"
    index = {r.tobytes(): i for i, r in enumerate(SPACE)}
    freq = np.zeros(len(SPACE))
    for r, c in zip(b, counts[live]):
        freq[index[r.tobytes()]] += c / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-9).all(), (freq - p)


@pytest.mark.parametrize("graph", ["chain", "dag", "dag-tensor"])
def test_ar_sampling_counts_follow_psi2(graph):
    model = _model(graph)
    n = 200_000
    bits, counts, dropped = ar_sampling(model, n, capacity=len(SPACE),
                                       generator=torch.Generator().manual_seed(1))
    assert int(dropped) == 0
    _check_counts(bits, counts, n, _p_exact(model))


@pytest.mark.parametrize("graph", ["chain", "dag", "dag-tensor"])
def test_ar_sampling_dfs_counts_follow_psi2(graph):
    """Prefix groups are disjoint: rows stay globally unique and the
    concatenated counts are one exact multinomial."""
    model = _model(graph)
    n = 200_000
    bits, counts, dropped = ar_sampling_dfs(
        model, n, capacity=len(SPACE), n_group=2, split_depth=2, capacity_root=16,
        generator=torch.Generator().manual_seed(2))
    assert bits.shape == (2 * len(SPACE), SORB) and int(dropped) == 0
    _check_counts(bits, counts, n, _p_exact(model))


def test_capacity_truncation_keeps_the_largest_branches():
    """capacity < n_fci: the kept mass cannot beat the top-capacity mass
    of |ψ|², and the greedy per-site compaction lands near it."""
    model = _model("chain")
    cap, n = 12, 100_000
    bits, counts, dropped = ar_sampling(model, n, capacity=cap,
                                       generator=torch.Generator().manual_seed(3))
    assert counts.sum().item() + int(dropped) == n and int(dropped) > 0
    top = np.sort(_p_exact(model))[::-1][:cap].sum()
    kept = counts.sum().item() / n
    assert top - 0.15 < kept <= top + 0.01, (kept, top)


def test_multinomial_partition_sums_and_masks():
    gen = torch.Generator().manual_seed(4)
    n = torch.tensor([0, 5, 1000, 123456], dtype=torch.long)
    logp = torch.log(torch.tensor([[0.25] * 4, [0.5, 0.5, 0.0, 0.0],
                                   [0.1, 0.2, 0.3, 0.4], [0.0, 0.0, 0.0, 1.0]]))
    out = multinomial_partition(n, logp, gen)
    assert torch.equal(out.sum(-1), n)
    assert out[1, 2:].sum() == 0 and out[3, :3].sum() == 0
    # split exact draws: the same law, summed over parts
    big = torch.full((2000,), 3 * (1 << 23) + 7, dtype=torch.long)
    d = _binomial_int(big, torch.full((2000,), 0.25, dtype=torch.float64), 4, gen)
    m, s = big[0].item() * 0.25, np.sqrt(big[0].item() * 0.25 * 0.75)
    assert ((d >= 0) & (d <= big)).all()
    assert abs(d.double().mean().item() - m) < 5 * s / np.sqrt(2000)


def test_compact_by_count_and_sampler_diagnostics():
    model = _model("chain")
    bits, counts, _ = ar_sampling(model, 50_000, capacity=len(SPACE),
                                  generator=torch.Generator().manual_seed(5))
    kb, kc = compact_by_count(bits, counts, 10)
    assert torch.equal(kc, torch.sort(counts, descending=True).values[:10])
    sampler = ARSampler(SORB, NOA, NOB, n_sample=50_000, capacity=len(SPACE),
                        dfs_n_group=2, dfs_split_depth=2, dfs_capacity_root=16,
                        max_unique=10)
    sb, w, diag = sampler.sample(model, torch.Generator().manual_seed(6))
    assert sb.shape == (10, SORB) and w.dtype == torch.float64
    assert abs(w.sum().item() - 1.0) < 1e-12
    assert diag["n_unique"].item() == (w > 0).sum().item() <= 10
    kept = 1.0 - diag["dropped_frac"].item()
    assert 0.0 < kept < 1.0  # 10 of 36 determinants kept
