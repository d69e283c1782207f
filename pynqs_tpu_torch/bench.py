"""Flagship REDUCE local-energy throughput on the Fe2S2 shape.

Counterpart of the JAX package's root ``bench.py``: the same
configuration, measured on the card.  Prints ONE JSON line
{"metric", "value", "unit"}; the metric is ⟨n|H|m⟩
matrix elements produced and consumed per second,
B × (1 + n_sd) / (time per call).

    python -m pynqs_tpu_torch.bench          (BENCH_MODE=flat|prefix,
                                              BENCH_DEDUP=1)

The model is the dcut-48 Graph-MPS-RNN chain of
``checkpoints/fe2s2_dcut48_final.pkl`` (random weights of seed 0 where
the file is absent) on the Fe2S2 integrals of ``utils.flagship
.FE2S2_PTH``, or, where those are absent, seeded random integrals of
the Fe2S2 shape (sorb 40, 15α/15β).  The inputs are B = 2048 DFS
samples of the state (n 1e6, 4 groups of 4096 at depth 6), compacted by
count, eight batches from eight seeds (random determinants without a
checkpoint); the local energy is REDUCE with k_det 256 / n_stoch 64 and
the segmax selection, its ψ forwards through kernel #1 in bf16 ("flat")
or the prefix-sharing passes, kernels #2/#3 ("prefix").  One warm-up
call, then ``n_rep`` calls over the eight batches, timed to a
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce, reduce_unique_count
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops.fused_rnn_prefix import ReducePrefixForward, prefix_available
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, compact_by_count
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import FE2S2_PTH, load_flagship_params
from pynqs_tpu_torch.utils.system import System

__all__ = ["run", "main", "rand_dets"]

K_DET, N_STOCH, B, DCUT = 256, 64, 2048, 48
CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "checkpoints", "fe2s2_dcut48_final.pkl")


def rand_dets(rng, n, sorb, noa, nob):
    """n random determinants with noa α and nob β electrons."""
    norb = sorb // 2
    out = np.zeros((n, sorb), np.int8)
    for s, no in ((0, noa), (1, nob)):
        cols = np.argsort(rng.random((n, norb)), axis=1)[:, :no]
        rows = np.repeat(np.arange(n), no)
        out[rows, 2 * cols.ravel() + s] = 1
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(system, model, *, B: int = B, k_det: int = K_DET, n_stoch: int = N_STOCH,
        n_rep: int = 8, device=None, trained: bool = True, mode: str = "flat",
        dedup: bool = False, n_sample: int = 1_000_000, capacity: int = 4096) -> dict:
    """Prints the bench's line and returns it as a dict, with ``seconds``
    (per call), ``mode``, ``dedup_unique_max`` and ``device`` beside it.  ``trained``: DFS
    samples of ``model`` (n_sample, 4 groups of ``capacity`` at depth 6)
    as inputs, else random determinants and no dedup; ``mode``: "flat" or
    "prefix" (chain models; it turns the dedup off); ``dedup``: the
    forward once per distinct row, sized from the first batch's count
    + 30%."""
    if mode not in ("flat", "prefix"):
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    dev = resolve_device(device)
    tabs = system.tables(dev, torch.float32)
    ops, table = tabs.astuple(), system.excitation
    if trained:
        def draw(seed):
            bits, counts, _ = ar_sampling_dfs(
                model, n_sample, capacity=capacity, n_group=4, split_depth=6,
                capacity_root=capacity, generator=torch.Generator(device=dev).manual_seed(seed))
            return compact_by_count(bits, counts, B)[0]

        batches = [draw(100 + i) for i in range(8)]
    else:
        rng = np.random.default_rng(1)
        batches = [torch.as_tensor(rand_dets(rng, B, system.sorb, system.noa, system.nob),
                                   device=dev) for _ in range(8)]
    dedup_max = None
    if dedup and trained:
        n_u = reduce_unique_count(batches[0], ops, table, torch.Generator(device=dev)
                                  .manual_seed(9), k_det=k_det, n_stoch=n_stoch,
                                  hpair=tabs.hpair_best, topk="segmax")[0]
        dedup_max = min(int(n_u * 1.3), B * (1 + k_det + n_stoch))
    prefix_fwd = None
    if mode == "prefix" and prefix_available(model):
        prefix_fwd, dedup_max = ReducePrefixForward(model), None
    mm = torch.bfloat16 if dev.type == "cuda" else torch.float32

    def fwd(b):
        return fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=mm)

    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(8)]

    def eloc(i):
        return local_energy_reduce(fwd, batches[i % 8], ops, table, gens[i % 8], k_det=k_det,
                                   n_stoch=n_stoch, hpair=tabs.hpair_best, topk="segmax",
                                   dedup_unique_max=dedup_max, prefix_fwd=prefix_fwd)

    eloc(0)  # warm-up: the kernels' build and first launches
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n_rep):
        out = eloc(i)
    _sync(dev)
    dt = (time.perf_counter() - t0) / n_rep
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("bench: non-finite local energies")
    rate = B * (1 + table.n_sd) / dt
    line = {"metric": "flagship_reduce_eloc_hij_terms_per_sec_per_chip", "value": rate,
            "unit": "terms/s"}
    print(json.dumps(line))
    return {**line, "seconds": dt, "mode": mode if prefix_fwd is not None else "flat",
            "dedup_unique_max": dedup_max,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def flagship_system() -> System:
    """The Fe2S2 integrals, or seeded random ones of their shape."""
    if os.path.exists(FE2S2_PTH):
        return System.from_pth(FE2S2_PTH)
    rng = np.random.default_rng(0)
    sorb = 40
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(sorb)) * 0.01
    return System.from_integrals(h1e, h2e, sorb, 15, 15)


def main(device=None) -> dict:
    """The bench at the JAX constants; prints its line and returns
    ``run``'s dict."""
    dev = resolve_device(device)
    system = flagship_system()
    model = GraphMPSRNN(system.sorb, system.noa, system.nob, dcut=DCUT, phase_mode="arg",
                        norm_mode="mpsrnn", dtype=torch.float32, device=dev,
                        generator=torch.Generator().manual_seed(0))
    trained = os.path.exists(CHECKPOINT)
    if trained:
        model.load_numpy_params(load_flagship_params(CHECKPOINT))
    return run(system, model, device=dev, trained=trained,
               mode=os.environ.get("BENCH_MODE", "flat"),
               dedup=os.environ.get("BENCH_DEDUP") == "1")


if __name__ == "__main__":
    main()
