"""Fixed-node GFMC refinement of a trained Fe2S2 flagship state.

Counterpart of ``scripts/fe2s2_gfmc.py``, with its command line and
defaults: walkers drawn from the trained state by DFS sampling (8
groups split at depth 6, ``--init-capacity`` rows each), expanded to
``--n-walkers`` by the counts, then ``gfmc.walker.GFMC`` with the state
as trial and the Buonaura–Sorella mixed estimator at depths p = 0 ..
``--p-steps``.  The trial forward is the fused forward in bf16 on the
card (its tensor-core kernel) and ``model.log_psi`` on the CPU.

    python -m pynqs_tpu_torch.scripts.fe2s2_gfmc checkpoints/fe2s2_r3_dcut64_r5g64.pkl \\
        --dcut 64 --use-tensor --max-preds 2 --n-walkers 2048 --init-capacity 8192 --tail 200

Its default system is the Fe2S2 integrals file
(``utils.flagship.fe2s2_system``), which the repository does not hold:
``main(system=...)`` takes any ``System``.
"""

from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig, mixed_energy
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "parser", "trial_forward", "draw_walkers"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("--dcut", type=int, default=48)
    ap.add_argument("--use-tensor", action="store_true")
    ap.add_argument("--max-preds", type=int, default=1)
    ap.add_argument("--n-walkers", type=int, default=1024)
    ap.add_argument("--n-iter", type=int, default=400)
    ap.add_argument("--p-steps", type=int, default=10)
    ap.add_argument("--gamma", type=float, default=0.0)
    ap.add_argument("--branch-interval", type=int, default=10)
    ap.add_argument("--tau-lambda", type=float, default=None)
    ap.add_argument("--dedup-max", type=int, default=0,
                    help="unique-row budget for the per-iteration trial block (walkers "
                         "repeat heavily after branching); more distinct rows raise")
    ap.add_argument("--n-sample", type=int, default=1_000_000,
                    help="DFS sample size for walker initialization")
    ap.add_argument("--init-capacity", type=int, default=8192,
                    help="DFS capture capacity for the walker draw")
    ap.add_argument("--tail", type=int, default=200,
                    help="iterations averaged for the reported energies")
    return ap


def trial_forward(model):
    """The trial forward: the fused forward in bf16 on the card, the exact
    ``model.log_psi`` on the CPU."""
    if model.M_re.device.type == "cpu":
        return model.log_psi
    return partial(fused_rnn.graph_mpsrnn_logpsi_fused, model, matmul_dtype=torch.bfloat16,
                   tables=fused_rnn.pack_tables(model))


def draw_walkers(model, n_walkers: int, n_sample: int, capacity: int) -> torch.Tensor:
    """The JAX script's walker draw: DFS sampling (8 groups at depth 6,
    seed 17), then ``n_walkers`` rows chosen by the counts with numpy's
    ``default_rng(5)``.  Returns [n_walkers, sorb] int8 on the model's
    device."""
    dev = model.M_re.device
    bits, counts, _ = ar_sampling_dfs(
        model, n_sample, capacity=capacity, n_group=8, split_depth=6,
        capacity_root=capacity, generator=torch.Generator(device=dev).manual_seed(17))
    c = counts.cpu().numpy().astype(np.float64)
    idx = np.random.default_rng(5).choice(len(c), size=n_walkers, p=c / c.sum())
    return bits[torch.as_tensor(idx, device=dev)]


def main(argv=None, *, system=None, device=None) -> dict:
    """The JAX script's ``main``: GFMC from the checkpoint ``ckpt`` on
    ``system`` (default ``fe2s2_system()``) on ``device`` (default the
    card); prints its report and returns ``GFMC.run``'s dict with
    "seconds", "ms_per_iter" and "mixed" [(p, E, se)] added."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, args.dcut, use_tensor=args.use_tensor,
                           max_preds=args.max_preds, device=dev)
    model.load_numpy_params(load_flagship_params(args.ckpt))
    walkers = draw_walkers(model, args.n_walkers, args.n_sample, args.init_capacity)

    cfg = GFMCConfig(
        n_walkers=args.n_walkers, n_iter=args.n_iter, p_steps=args.p_steps, gamma=args.gamma,
        branch_interval=args.branch_interval, tau_lambda=args.tau_lambda,
        dedup_unique_max=args.dedup_max,
    )
    g = GFMC(trial_forward(model), sys_, cfg, device=dev)
    t0 = time.time()
    out = g.run(walkers, generator=torch.Generator(device=dev).manual_seed(23))
    dt = time.time() - t0

    def vs_ref(e):
        return f" ({(e - sys_.e_ref) * 1000:+.3f} mHa)" if sys_.e_ref is not None else ""

    print(f"\nGFMC {args.n_iter} iters, {args.n_walkers} walkers, {dt:.1f}s "
          f"({dt / args.n_iter * 1e3:.0f} ms/iter)")
    print(f"  e_gen[0] (VMC of init draw) = {out['e_gen'][0]:.6f} Ha{vs_ref(out['e_gen'][0])}")
    mixed = []
    for p in range(args.p_steps + 1):
        e, se = mixed_energy(out, p, tail=args.tail)
        mixed.append((p, e, se))
        d = f"   Delta = {(e - sys_.e_ref) * 1000:+.3f} mHa" if sys_.e_ref is not None else ""
        print(f"  p={p:2d}  E = {e:.6f} +- {se:.6f} Ha{d}")
    return {**out, "seconds": dt, "ms_per_iter": dt / args.n_iter * 1e3, "mixed": mixed}


if __name__ == "__main__":
    main()
