"""The flagship Fe2S2 training run on the card.

Counterpart of ``scripts/fe2s2_r3_push.py``, with its command line and
defaults: a dcut-96 chain Graph-MPS-RNN warm-started from
``checkpoints/fe2s2_r2_dcut96_final.pkl`` (through
``structural_warm_start``; ``--grow-from`` grows dcut first,
``--from-focus`` starts from a converted FOCUS MPS), DFS sampling with
n = 2e6 in 8 groups, REDUCE local energies (k_det 512, n_stoch 128),
AdamW on an exponential (or the reference's) learning-rate schedule,
optional parameter EMA and exact |ψ|² weights, resume checkpoints in
the JAX package's format (``--resume`` takes either package's file).

    python -m pynqs_tpu_torch.scripts.fe2s2_r3_push --tag a --iters 12000

writes ``logs/fe2s2_r3_dcut96_a.log``, ``checkpoints/fe2s2_r3_dcut96_a
{,_ema,_resume}.pkl`` under the repository.  The default system is the
Fe2S2 integrals file (``utils.flagship.fe2s2_system``), which the
repository does not hold: ``main(system=...)`` takes any ``System``,
``root=`` a directory for the logs and checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.integrals import spin_raising
from pynqs_tpu_torch.optim.schedule import exponential_decay, ref_schedule
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar import tune_dfs_split_depth
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.checkpoint import load_params, save_params
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_graph
from pynqs_tpu_torch.utils.mps_import import (
    grow_dcut,
    load_focus_mpsrnn,
    structural_warm_start,
)

__all__ = ["main", "parser", "REPO"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dcut", type=int, default=96)
    ap.add_argument("--iters", type=int, default=12000)
    ap.add_argument("--n-sample", type=int, default=2_000_000)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--n-group", type=int, default=8)
    ap.add_argument("--split-depth", type=str, default="8",
                    help="int, or 'auto' = tune from the measured live-branch profile of "
                         "the warm-start state (sampler.ar.tune_dfs_split_depth)")
    ap.add_argument("--capacity-root", type=int, default=4096)
    ap.add_argument("--max-unique", type=int, default=24576)
    ap.add_argument("--eloc-batch", type=int, default=4096)
    ap.add_argument("--eloc-dedup-max", type=int, default=None,
                    help="REDUCE forward dedup capacity per eloc chunk")
    ap.add_argument("--grad-batch", type=int, default=8192)
    ap.add_argument("--k-det", type=int, default=512)
    ap.add_argument("--n-stoch", type=int, default=128)
    ap.add_argument("--topk", choices=["exact", "segmax", "approx"], default="exact",
                    help="REDUCE deterministic-set selection")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr-end", type=float, default=1e-5)
    ap.add_argument("--sched", choices=["exp", "ref"], default="exp",
                    help="'ref' = the reference flagship schedule "
                         "max(lr*exp(-5e-4*step), lr_end)")
    ap.add_argument("--clip", type=float, default=0.1)
    ap.add_argument("--clip-stages", type=str, default=None,
                    help="'it1:v1,it2:v2,...' staged max-norm clip, e.g. '0:0.01,3000:0.001'")
    ap.add_argument("--from-ckpt", type=str,
                    default=os.path.join(REPO, "checkpoints/fe2s2_r2_dcut96_final.pkl"))
    ap.add_argument("--from-focus", type=str, default=None,
                    help="warm-start from a converted FOCUS MPS file at the model dcut; "
                         "overrides --from-ckpt")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--grow-from", type=int, default=None,
                    help="grow dcut from this checkpoint dcut")
    ap.add_argument("--use-tensor", action="store_true")
    ap.add_argument("--max-preds", type=int, default=1,
                    help=">1: add extra max-|K| predecessor edges")
    ap.add_argument("--fwd-dtype", choices=["bf16", "f32"], default="bf16",
                    help="fused eloc-forward matmul dtype; f32 also turns TF32 off")
    ap.add_argument("--exact-weights", action="store_true",
                    help="Rao-Blackwellized |psi|^2 weights over the captured set instead "
                         "of multinomial counts")
    ap.add_argument("--ema", type=float, default=None,
                    help="Polyak-average params with this decay (e.g. 0.999); saves "
                         "<tag>_ema.pkl")
    ap.add_argument("--spin-raising", type=float, default=0.0,
                    help="train on H + c*S-S+; the logged energy then includes the penalty")
    ap.add_argument("--ckpt-interval", type=int, default=500,
                    help="resume-checkpoint save interval")
    ap.add_argument("--tag", type=str, default="a")
    return ap


def _clip_schedule(spec: str | None):
    if not spec:
        return None
    stages = sorted((int(p.split(":")[0]), float(p.split(":")[1])) for p in spec.split(","))

    def clip_schedule(it, _stages=stages):
        v = _stages[0][1]
        for s_it, s_v in _stages:
            if it >= s_it:
                v = s_v
        return v

    return clip_schedule


def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """Run the script with ``argv`` (default: the process's arguments) on
    ``system`` (default ``fe2s2_system()``) on ``device`` (default the
    card), writing under ``root``.  Returns {"vmc", "history",
    "split_depth", "profile" (live, kept) or None, "seconds", "paths"}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    if args.fwd_dtype == "f32":
        # full-precision ansatz arithmetic everywhere, as the JAX script's
        # jax_default_matmul_precision=highest
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sys_ = system if system is not None else fe2s2_system(np.float32)
    if args.spin_raising > 0:
        sys_ = sys_.with_operator(*spin_raising(sys_.sorb), args.spin_raising)
    graph = flagship_graph(sys_, args.max_preds)

    def make(d, g=graph, use_tensor=args.use_tensor, on=dev):
        return GraphMPSRNN(sys_.sorb, sys_.noa, sys_.nob, dcut=d, graph=g, phase_mode="arg",
                           norm_mode="mpsrnn", dtype=torch.float32, use_tensor=use_tensor,
                           device=on, generator=torch.Generator().manual_seed(0))

    model = make(args.dcut)
    params = None
    if args.resume is None and args.from_focus is not None:
        chain = make(args.dcut, on="cpu") if graph is None else make(
            args.dcut, None, False, "cpu")
        params = load_focus_mpsrnn(args.from_focus, chain)
        if graph is not None or args.use_tensor:
            # re-merge into the structured model (extra pred slots /
            # tensor K, U start near zero)
            params = structural_warm_start(params, model)
    elif args.resume is None:
        params = load_params(args.from_ckpt)
        if "params" in params:
            params = params["params"]
        if args.grow_from is not None:
            params = grow_dcut(params, make(args.grow_from, on="cpu"), model)
        # missing params (tensor K/U, extra pred slots) start near zero;
        # shared ones carry over
        params = structural_warm_start(params, model)
    if params is not None:
        model.load_numpy_params(params)

    profile = None
    if args.split_depth == "auto":
        if params is None:
            raise SystemExit("--split-depth auto needs a warm start "
                             "(tune on the state being sampled)")
        split_depth, live, kept = tune_dfs_split_depth(
            model, torch.Generator(device=dev).manual_seed(0), args.n_sample,
            capacity=args.capacity, n_group=args.n_group,
            capacity_root=args.capacity_root, return_profile=True)
        profile = (live, kept)
        print(f"[auto] split_depth = {split_depth}")
        print(f"[auto] live prefixes by depth {live.tolist()}; kept mass by depth "
              f"{kept.tolist()}")
    else:
        split_depth = int(args.split_depth)
    sampler = ARSampler(
        sys_.sorb, sys_.noa, sys_.nob, n_sample=args.n_sample, capacity=args.capacity,
        dfs_n_group=args.n_group, dfs_split_depth=split_depth,
        dfs_capacity_root=args.capacity_root, max_unique=args.max_unique,
        exact_weights=args.exact_weights,
    )
    if args.sched == "ref":
        sched = ref_schedule(args.lr, args.lr_end)
    else:
        sched = exponential_decay(args.lr, args.iters, args.lr_end / args.lr)

    tag = f"dcut{args.dcut}_{args.tag}"
    paths = {
        "log": os.path.join(root, f"logs/fe2s2_r3_{tag}.log"),
        "resume": os.path.join(root, f"checkpoints/fe2s2_r3_{tag}_resume.pkl"),
        "params": os.path.join(root, f"checkpoints/fe2s2_r3_{tag}.pkl"),
        "ema": os.path.join(root, f"checkpoints/fe2s2_r3_{tag}_ema.pkl"),
    }
    cfg = VMCConfig(
        n_iter=args.iters, lr=sched, optimizer="adamw",
        clip_grad=args.clip, clip_schedule=_clip_schedule(args.clip_stages),
        eloc_method="reduce", eloc_k_det=args.k_det, eloc_n_stoch=args.n_stoch,
        eloc_topk=args.topk, eloc_batch=args.eloc_batch, grad_batch=args.grad_batch,
        eloc_dedup_max=args.eloc_dedup_max,
        ema_decay=args.ema, fused_matmul_dtype=args.fwd_dtype, log_every=50,
        log_path=paths["log"], checkpoint_path=paths["resume"],
        checkpoint_interval=args.ckpt_interval,
    )
    for d in ("logs", "checkpoints"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    vmc = VMC(model, sys_, sampler, cfg)
    t0 = time.time()
    hist = vmc.run(torch.Generator(device=dev).manual_seed(len(args.tag) + args.dcut),
                   resume_from=args.resume)
    dt = time.time() - t0
    save_params(paths["params"], dict(model.named_parameters()))
    if vmc.ema_params is not None:
        save_params(paths["ema"], vmc.ema_params)
    tail, best = float(np.mean(hist[-400:])), float(np.min(hist))

    def vs_ref(e):
        return f"  ({(e - sys_.e_ref) * 1000:+.3f} mHa)" if sys_.e_ref is not None else ""

    print(f"\nr3 {tag}: {len(hist)} total iters, this run {dt:.0f}s "
          f"({dt / max(args.iters, 1) * 1000:.0f} ms/iter)\n"
          f"mean(400) = {tail:.6f} Ha{vs_ref(tail)}\n"
          f"best iter = {best:.6f} Ha{vs_ref(best)}\n"
          f"saved {paths['params']}")
    return {"vmc": vmc, "history": hist, "split_depth": split_depth, "profile": profile,
            "seconds": dt, "paths": paths}


if __name__ == "__main__":
    main()
