"""Fe2S2 active space (sorb 40, 15α/15β) with a Graph-MPS-RNN, on the card.

Counterpart of ``examples/fe2s2_graph_mps_rnn.py`` (the reference's
flagship configuration), with its command line and defaults: the sites
in Fiedler order of the exchange matrix, a DAG of at most 2
predecessors per site (``dag_from_order``), dcut 20 (kernel #1's DAG
path at dp 32), AR sampling (n 1e5, capacity 4096), SIMPLE local
energies over the whole batch, AdamW on ``exponential_decay(2e-3, 1,
1 - 5e-4, end_value=5e-4)`` with clip 1.0.

    python -m pynqs_tpu_torch.examples.fe2s2_graph_mps_rnn [--iters N] [--dcut D]

Integrals: ``--pth`` (default ``utils.flagship.FE2S2_PTH``), or any
``System`` through ``main(system=...)``.  The model is f32 on the card;
on the CPU f64 unless ``--f32``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim.schedule import exponential_decay
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import FE2S2_PTH
from pynqs_tpu_torch.utils.graph import dag_from_order, exchange_matrix, fiedler_order
from pynqs_tpu_torch.utils.system import System

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--dcut", type=int, default=20)
    ap.add_argument("--n-sample", type=int, default=100_000)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--pth", default=FE2S2_PTH)
    ap.add_argument("--f32", action="store_true", help="float32 on the CPU too")
    return ap


def main(argv=None, *, system=None, device=None) -> dict:
    """Returns {"vmc", "history", "final", "graph"}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    f32 = args.f32 or dev.type != "cpu"
    if system is None:
        if not os.path.exists(args.pth):
            raise SystemExit(f"integral file not found: {args.pth}")
        system = System.from_pth(args.pth, dtype=np.float32 if f32 else np.float64)
    sys_ = system
    print(f"system: sorb={sys_.sorb} noa={sys_.noa} nob={sys_.nob} e_ref={sys_.e_ref}")
    K = exchange_matrix(sys_.h2e, sys_.sorb)
    graph = dag_from_order(fiedler_order(K), K, max_preds=2)
    model = GraphMPSRNN(sys_.sorb, sys_.noa, sys_.nob, dcut=args.dcut, graph=graph,
                        dtype=torch.float32 if f32 else torch.float64, device=dev,
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(sys_.sorb, sys_.noa, sys_.nob, n_sample=args.n_sample,
                        capacity=args.capacity)
    cfg = VMCConfig(n_iter=args.iters, optimizer="adamw", clip_grad=1.0, eloc_batch=None,
                    lr=exponential_decay(2e-3, 1, 1 - 5e-4, end_value=5e-4), log_every=10)
    vmc = VMC(model, sys_, sampler, cfg)
    hist = vmc.run(torch.Generator(device=dev).manual_seed(0))
    last = float(np.mean(hist[-100:])) if len(hist) >= 100 else float(hist[-1])
    print(f"final E(mean last 100) = {last:.6f} Ha")
    if sys_.e_ref is not None:
        print(f"Δref = {(last - sys_.e_ref) * 1000:+.3f} mHa")
    return {"vmc": vmc, "history": hist, "final": last, "graph": graph}


if __name__ == "__main__":
    main()
