"""VMC-optimize Fe2S2 from the DMRG warm start, on the card.

Counterpart of ``scripts/fe2s2_train_from_dmrg.py`` (the reference's
flagship run), with its command line and defaults: a chain Graph-MPS-RNN
(dcut 20, arg phase, mpsrnn gauge; f32 on the card, f64 on the CPU)
warm-started from the converted FOCUS DMRG file through
``load_focus_mpsrnn``, AR sampling (n 1e5, capacity 1024), REDUCE local
energies (k_det 512, n_stoch 128, eloc batch 256) and AdamW (lr 2e-4,
clip 0.1) for 200 iterations.  With the Fe2S2 files the import alone
measures -116.5865 Ha (the JAX package, ``scripts/fe2s2_train_from_dmrg.py``).

    python -m pynqs_tpu_torch.scripts.fe2s2_train_from_dmrg [--iters N]

The default files are ``utils.flagship.FE2S2_PTH`` and
``FE2S2_FOCUS_PTH``, which the repository does not hold:
``main(system=...)`` takes any ``System`` and ``--focus`` any converted
FOCUS file (``--dcut`` its bond dimension or more; a raw CTNS binary
goes through ``utils.focus_ctns``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import FE2S2_FOCUS_PTH, fe2s2_system
from pynqs_tpu_torch.utils.mps_import import load_focus_mpsrnn

__all__ = ["main", "parser", "REPO"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--n-sample", type=int, default=100_000)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--dcut", type=int, default=20)
    ap.add_argument("--focus", type=str, default=FE2S2_FOCUS_PTH,
                    help="the converted FOCUS MPS file (a torch state dict)")
    return ap


def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """Run the script with ``argv`` on ``system`` (default
    ``fe2s2_system()``) on ``device`` (default the card); ``root`` is
    where relative paths are read from.  Returns {"vmc", "history",
    "seconds", "tail"}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    f32 = dev.type != "cpu"
    sys_ = system if system is not None else fe2s2_system(np.float32 if f32 else np.float64)
    model = GraphMPSRNN(sys_.sorb, sys_.noa, sys_.nob, dcut=args.dcut, phase_mode="arg",
                        norm_mode="mpsrnn", dtype=torch.float32 if f32 else torch.float64,
                        device=dev)
    model.load_numpy_params(load_focus_mpsrnn(os.path.join(root, args.focus), model))
    sampler = ARSampler(sys_.sorb, sys_.noa, sys_.nob, n_sample=args.n_sample,
                        capacity=args.capacity)
    cfg = VMCConfig(n_iter=args.iters, lr=args.lr, optimizer="adamw", clip_grad=0.1,
                    eloc_method="reduce", eloc_k_det=512, eloc_n_stoch=128, eloc_batch=256,
                    log_every=10)
    vmc = VMC(model, sys_, sampler, cfg)
    t0 = time.time()
    hist = vmc.run(torch.Generator(device=dev).manual_seed(0))
    dt = time.time() - t0
    tail = float(np.mean(hist[-25:]))
    print(f"\n{args.iters} iterations in {dt:.1f}s "
          f"({dt / max(args.iters, 1) * 1000:.0f} ms/iter incl host)")
    print(f"E first iter      = {hist[0]:.6f} Ha")
    print(f"E end mean(25)    = {tail:.6f} Ha")
    if sys_.e_ref is not None:
        print(f"Delta vs e_ref    = {(tail - sys_.e_ref) * 1000:+.2f} mHa")
    return {"vmc": vmc, "history": hist, "seconds": dt, "tail": tail}


if __name__ == "__main__":
    main()
