"""CI-NQS training at Fe2S2 scale: the coupled NqsCi loop on a trained state.

Counterpart of ``scripts/fe2s2_nqsci_train.py``, with its command line
and defaults:

  1. the CI space: ``--ci-file`` (a ``save_ci`` file such as
     ``checkpoints/fe2s2_hci_m1024.npz``), or a DFS capture of the
     trained state whose top ``--seed-dets`` determinants by count seed a
     heat-bath selected CI (``ci.selected.selected_ci``) grown to ``--m``;
  2. ``ci.nqs_ci.NqsCi`` warm-started from the checkpoint;
  3. the updated parameters saved to ``checkpoints/fe2s2_r5_<tag>.pkl``
     in the JAX package's format.

The per-iteration eigenvalue mixes the exact H_cn with a Monte Carlo
H_nn: a training signal, not a variational bound (the judged number
comes from ``fe2s2_ci_polish --restrict capture`` on the saved state).
``--fwd-dtype`` is the precision of the gradient-free forwards on the
card (``fe2s2_ci_polish.polish_forward``): the fused forward in f32 (the
default; tensor cores, three TF32 products per product) or bf16 (tensor
cores, the JAX script's choice), or
``xla``, the exact site-loop ``model.log_psi``; the gradient's forwards
are ``model.log_psi``.  On the CPU every forward is ``model.log_psi``.

    python -m pynqs_tpu_torch.scripts.fe2s2_nqsci_train checkpoints/fe2s2_r3_dcut64_r5g64.pkl \\
        --dcut 64 --use-tensor --max-preds 2 --m 1024 --iters 200

Its default system is the Fe2S2 integrals file
(``utils.flagship.fe2s2_system``), which the repository does not hold:
``main(system=...)`` takes any ``System``, ``root=`` another directory
for the checkpoint.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.ci.nqs_ci import NqsCi, NqsCiConfig
from pynqs_tpu_torch.ci.selected import selected_ci
from pynqs_tpu_torch.ci.solve import load_ci
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs
from pynqs_tpu_torch.scripts.fe2s2_ci_polish import polish_forward
from pynqs_tpu_torch.scripts.fe2s2_r3_push import REPO
from pynqs_tpu_torch.utils.checkpoint import save_params
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("--dcut", type=int, default=64)
    ap.add_argument("--use-tensor", action="store_true")
    ap.add_argument("--max-preds", type=int, default=1)
    ap.add_argument("--m", type=int, default=1024, help="selected-CI space size")
    ap.add_argument("--seed-dets", type=int, default=256,
                    help="top capture determinants seeding selection")
    ap.add_argument("--eps1", type=float, default=3e-4, help="heat-bath selection threshold")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--n-sample", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=8192)
    ap.add_argument("--grad-strategy", type=int, default=1)
    ap.add_argument("--ci-file", type=str, default=None,
                    help="load the CI space from this save_ci .npz (skips capture and "
                         "selection; e.g. checkpoints/fe2s2_hci_m*.npz)")
    ap.add_argument("--ci-chunk", type=int, default=65536,
                    help="flat connected-row chunk for the H_cn forward and backward")
    ap.add_argument("--eloc-batch", type=int, default=1024)
    ap.add_argument("--tag", type=str, default="nqsci")
    ap.add_argument("--fwd-dtype", choices=["bf16", "f32", "xla"], default="f32",
                    help="gradient-free forward on the card: the fused forward in f32 or "
                         "bf16, or 'xla' = the exact site-loop model.log_psi")
    return ap


def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """The JAX script's ``main`` on ``system`` (default
    ``fe2s2_system(np.float32)``) on ``device`` (default the card); prints
    its report and returns {"history", "stats", "c", "m", "e_var",
    "seconds", "path"} (energies with ecore)."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, args.dcut, use_tensor=args.use_tensor,
                           max_preds=args.max_preds, device=dev)
    model.load_numpy_params(load_flagship_params(args.ckpt))

    def vs_ref(e):
        return f" ({(e - sys_.e_ref) * 1000:+.3f} mHa)" if sys_.e_ref is not None else ""

    if args.ci_file:
        ci, meta = load_ci(args.ci_file)
        e_var = float(meta.get("e_var", np.nan))
        print(f"loaded CI space {args.ci_file}: m={ci.bits.shape[0]}  "
              f"E_var = {e_var:.6f} Ha{vs_ref(e_var)}", flush=True)
    else:
        # ---- 1. capture the state, rank by count ----
        t0 = time.time()
        bits, counts, _ = ar_sampling_dfs(
            model, args.n_sample, capacity=4096, n_group=4, split_depth=6,
            capacity_root=4096, generator=torch.Generator(device=dev).manual_seed(11))
        bits, counts = bits.cpu().numpy(), counts.cpu().numpy()
        order = np.argsort(-counts, kind="stable")[:args.seed_dets]
        seed = bits[order][counts[order] > 0]
        print(f"capture: {int((counts > 0).sum())} uniques, seed {seed.shape[0]} dets, "
              f"t={time.time() - t0:.0f}s", flush=True)
        # ---- 2. heat-bath selected CI from the seed ----
        t0 = time.time()
        e_var, ci, _ = selected_ci(sys_, eps1=args.eps1, seed_bits=seed, max_space=args.m,
                                   chunk=128, verbose=True, device=dev)
        print(f"selected CI: m={ci.bits.shape[0]}  E_var = {e_var:.6f} Ha{vs_ref(e_var)}  "
              f"t={time.time() - t0:.0f}s", flush=True)

    # ---- 3. coupled CI-NQS training ----
    cfg = NqsCiConfig(n_iter=args.iters, lr=args.lr, n_sample=args.n_sample,
                      capacity=args.capacity, grad_strategy=args.grad_strategy,
                      ci_chunk=args.ci_chunk, eloc_batch=args.eloc_batch, log_every=10)
    nq = NqsCi(model, sys_, np.asarray(ci.bits, np.int8), cfg,
               eval_fwd=polish_forward(model, args.fwd_dtype))
    t0 = time.time()
    c, hist = nq.run(torch.Generator(device=dev).manual_seed(29))
    dt = time.time() - t0
    out = os.path.join(root, f"checkpoints/fe2s2_r5_{args.tag}.pkl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_params(out, dict(model.named_parameters()))
    h = np.asarray(hist)
    print(f"\nNqsCi {args.iters} iters, {dt:.0f}s ({dt / max(args.iters, 1):.2f} s/iter)")
    print(f"  e_tot first/10/last: {h[0]:.6f} / {h[min(9, len(h) - 1)]:.6f} / {h[-1]:.6f} Ha")
    if sys_.e_ref is not None:
        print(f"  vs e_ref: first {(h[0] - sys_.e_ref) * 1e3:+.3f}  "
              f"last {(h[-1] - sys_.e_ref) * 1e3:+.3f} mHa")
    print(f"  |c_m| (NQS weight in the eigenvector): {abs(c[-1]):.4f}")
    print(f"saved {out}")
    return {"history": list(hist), "stats": nq.stats, "c": c, "m": nq.m, "e_var": e_var,
            "seconds": dt, "path": out}


if __name__ == "__main__":
    main()
