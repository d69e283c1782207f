"""The round-2 Fe2S2 push on the card: the dcut growth chain 64 → 96 → 128.

Counterpart of ``scripts/fe2s2_r2_push.py``, with its command line and
defaults: a chain Graph-MPS-RNN (arg phase, mpsrnn norm, f32) at dcut
``--stage``, warm-started from ``checkpoints/fe2s2_dcut64.pkl`` (stage 64)
or grown from the previous stage's ``checkpoints/fe2s2_r2_dcut{64,96}.pkl``
(``--from-ckpt`` overrides both), AR sampling with n = 5e5 at capacity
4096 (``--n-slab`` independent slabs), REDUCE local energies (k_det 512,
n_stoch 128), clip 0.1, and AdamW on an exponential learning-rate
schedule — or, with ``--sr``, CG min-SR (``--n-cg``, ``--sr-damping``)
with plain SGD on the same schedule.

    python -m pynqs_tpu_torch.scripts.fe2s2_r2_push --stage 64 --sr

writes ``logs/fe2s2_r2_dcut64.log`` and ``checkpoints/fe2s2_r2_dcut64
{,_resume}.pkl`` (``--tag`` is appended to ``dcut64``).  The warm starts
are read, and the outputs written, under ``root`` (default the
repository).  The default system is the Fe2S2 integrals file
(``utils.flagship.fe2s2_system``), which the repository does not hold:
``main(system=...)`` takes any ``System``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim.schedule import exponential_decay
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.checkpoint import load_params, save_params
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system
from pynqs_tpu_torch.utils.mps_import import grow_dcut

__all__ = ["main", "parser", "REPO"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", type=int, default=64)
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--n-sample", type=int, default=500_000)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr-end", type=float, default=1e-5)
    ap.add_argument("--from-ckpt", type=str, default=None)
    ap.add_argument("--sr", action="store_true", help="CG min-SR + SGD")
    ap.add_argument("--sr-damping", type=float, default=1e-3)
    ap.add_argument("--n-cg", type=int, default=50)
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--n-slab", type=int, default=1)
    return ap


def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """Run the script with ``argv`` (default: the process's arguments) on
    ``system`` (default ``fe2s2_system()``) on ``device`` (default the
    card), reading the warm starts and writing under ``root``.  Returns
    {"vmc", "history", "seconds", "paths"}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)

    def make(d, on=dev):
        return GraphMPSRNN(sys_.sorb, sys_.noa, sys_.nob, dcut=d, phase_mode="arg",
                           norm_mode="mpsrnn", dtype=torch.float32, device=on,
                           generator=torch.Generator().manual_seed(0))

    model = make(args.stage)
    if args.from_ckpt:
        params = load_params(args.from_ckpt)
        if "params" in params:
            params = params["params"]  # a VMC resume file
    elif args.stage == 64:
        params = load_params(os.path.join(root, "checkpoints/fe2s2_dcut64.pkl"))
    else:
        prev = {96: 64, 128: 96}[args.stage]
        params = load_params(os.path.join(root, f"checkpoints/fe2s2_r2_dcut{prev}.pkl"))
        params = grow_dcut(params, make(prev, on="cpu"), model)
    model.load_numpy_params(params)

    sampler = ARSampler(sys_.sorb, sys_.noa, sys_.nob, n_sample=args.n_sample,
                        capacity=args.capacity, n_slab=args.n_slab)
    tag = f"dcut{args.stage}{args.tag}"
    paths = {
        "log": os.path.join(root, f"logs/fe2s2_r2_{tag}.log"),
        "resume": os.path.join(root, f"checkpoints/fe2s2_r2_{tag}_resume.pkl"),
        "params": os.path.join(root, f"checkpoints/fe2s2_r2_{tag}.pkl"),
    }
    cfg = VMCConfig(
        n_iter=args.iters,
        lr=exponential_decay(args.lr, args.iters, args.lr_end / args.lr),
        optimizer="sgd" if args.sr else "adamw",
        use_sr=args.sr, sr_solver="cg", sr_damping=args.sr_damping, sr_n_cg=args.n_cg,
        clip_grad=0.1, eloc_method="reduce", eloc_k_det=512, eloc_n_stoch=128,
        log_every=50, log_path=paths["log"], checkpoint_path=paths["resume"],
        checkpoint_interval=500,
    )
    for d in ("logs", "checkpoints"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    vmc = VMC(model, sys_, sampler, cfg)
    t0 = time.time()
    hist = vmc.run(torch.Generator(device=dev).manual_seed(args.stage))
    dt = time.time() - t0
    save_params(paths["params"], dict(model.named_parameters()))
    tail, best = float(np.mean(hist[-400:])), float(np.min(hist))

    def vs_ref(e):
        return f"  ({(e - sys_.e_ref) * 1000:+.3f} mHa)" if sys_.e_ref is not None else ""

    print(f"\nstage dcut={args.stage}: {args.iters} iters in {dt:.0f}s "
          f"({dt / max(args.iters, 1) * 1000:.0f} ms/iter)\n"
          f"mean(400) = {tail:.6f} Ha{vs_ref(tail)}\n"
          f"best iter = {best:.6f} Ha{vs_ref(best)}\n"
          f"saved {paths['params']}")
    return {"vmc": vmc, "history": hist, "seconds": dt, "paths": paths}


if __name__ == "__main__":
    main()
