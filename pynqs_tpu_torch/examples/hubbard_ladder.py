"""Capability ladder on Hubbard systems, on the card.

Counterpart of ``examples/hubbard_ladder.py``:

  stage 1: RBM + exact enumeration + SR        (BASELINE.json config 1)
  stage 2: AR-RNN + exact AR sampling + SR     (config 2 analog)
  stage 3: Transformer decoder                 (config 3 analog)
  stage 4: 2D Hubbard + Graph-MPS-RNN (snake)  (config 4 analog)

    python -m pynqs_tpu_torch.examples.hubbard_ladder [--stage N] [--iters N]

The FCI reference is the lowest eigenvalue of the dense Hamiltonian over
the sector (``hij_dense``).  Stages 1–3 run in float64 (the SR solve at
damping 1e-3 is singular in float32, as the JAX example notes); stage 4
in float32 on the card, where its local energies go through the fused
forward's kernel, and float64 on the CPU.  SGD at 5e-2 is
``optax.sgd(5e-2)``.  ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pynqs_tpu_torch.models import RBM, DecoderWavefunction, GraphMPSRNN, RNNWavefunction
from pynqs_tpu_torch.models.graph_mps_rnn import grid_snake_graph
from pynqs_tpu_torch.ops.hamiltonian import hij_dense
from pynqs_tpu_torch.ops.integrals import hubbard_2d
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.fci import fci_bits
from pynqs_tpu_torch.utils.system import System

__all__ = ["main", "parser", "stage_setup", "fci_energy"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", type=int, default=1)
    ap.add_argument("--iters", type=int, default=400)
    return ap


def fci_energy(system, device) -> tuple[float, int]:
    """(the lowest eigenvalue of H over the sector, its dimension), f64."""
    space = torch.as_tensor(fci_bits(system.sorb, system.noa, system.nob), device=device)
    H = hij_dense(space, space, *system.tables(device, torch.float64).astuple())
    return float(torch.linalg.eigvalsh(H.double())[0]) + system.ecore, space.shape[0]


def stage_setup(stage: int, iters: int, device):
    """(system, model, sampler, VMCConfig) of one stage on ``device``."""
    dev = resolve_device(device)
    f64 = torch.float64
    gen = torch.Generator().manual_seed(0)
    if stage == 1:
        system = System.hubbard_1d(4, 2, 2, u=4.0)
        model = RBM(system.sorb, alpha=4, init_scale=0.1, dtype=f64, device=dev,
                    generator=gen)
        sampler = ExactSampler(system.sorb, system.noa, system.nob)
        cfg = VMCConfig(n_iter=iters, use_sr=True, sr_damping=1e-3, optimizer="sgd",
                        lr=5e-2, log_every=25)
    elif stage == 2:
        system = System.hubbard_1d(6, 3, 3, u=4.0)
        model = RNNWavefunction(system.sorb, system.noa, system.nob, hidden=32, dtype=f64,
                                device=dev, generator=gen)
        sampler = ARSampler(system.sorb, system.noa, system.nob, n_sample=1 << 15,
                            capacity=400)
        cfg = VMCConfig(n_iter=iters, use_sr=True, sr_damping=1e-2, optimizer="sgd",
                        lr=5e-2, log_every=25)
    elif stage == 3:
        system = System.hubbard_1d(3, 2, 1, u=4.0)
        model = DecoderWavefunction(system.sorb, system.noa, system.nob, n_layer=1,
                                    n_head=2, d_model=16, dtype=f64, device=dev,
                                    generator=gen)
        sampler = ARSampler(system.sorb, system.noa, system.nob, n_sample=1 << 13,
                            capacity=9)
        cfg = VMCConfig(n_iter=iters, use_sr=True, sr_damping=1e-3, optimizer="sgd",
                        lr=5e-2, log_every=25)
    elif stage == 4:
        hc, eri = hubbard_2d(3, 2, u=4.0)
        system = System.from_spatial(hc, eri, 3, 3)
        model = GraphMPSRNN(system.sorb, system.noa, system.nob, dcut=12,
                            graph=grid_snake_graph(3, 2),
                            dtype=f64 if dev.type == "cpu" else torch.float32, device=dev,
                            generator=gen)
        sampler = ARSampler(system.sorb, system.noa, system.nob, n_sample=1 << 15,
                            capacity=400)
        cfg = VMCConfig(n_iter=iters, optimizer="adamw", lr=5e-3, log_every=25)
    else:
        raise SystemExit("stage must be 1-4")
    return system, model, sampler, cfg


def main(argv=None, *, device=None) -> dict:
    """Run one stage.  Returns {"stage", "fci", "n_fci", "history", "tail",
    "gap_mha", "model"} (Ha; the tail is the mean of the last 20; the
    trained model)."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    system, model, sampler, cfg = stage_setup(args.stage, args.iters, dev)
    e0, n_fci = fci_energy(system, dev)
    print(f"stage {args.stage}: sorb={system.sorb} FCI={e0:.6f} ({n_fci} dets)")
    hist = VMC(model, system, sampler, cfg).run(torch.Generator(device=dev).manual_seed(0))
    tail = float(np.mean(hist[-20:]))
    print(f"VMC mean(20) = {tail:.6f}  Δ = {(tail - e0) * 1000:+.3f} mHa")
    return {"stage": args.stage, "fci": e0, "n_fci": n_fci, "history": hist, "tail": tail,
            "gap_mha": (tail - e0) * 1000, "model": model}


if __name__ == "__main__":
    main()
