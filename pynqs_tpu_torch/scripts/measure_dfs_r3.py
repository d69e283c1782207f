"""DFS sampling sizes on a trained Fe2S2 state, on the card.

Counterpart of ``scripts/measure_dfs_r3.py`` (the round-3 sizing of the
dcut-96 chain, ``checkpoints/fe2s2_r2_dcut96_final.pkl``):

  1. the live branches per AR depth at n 1e7 from a root of 16,384 rows
     (``sampler.ar.dfs_depth_profile``), which picks the split depth;
  2. the DFS dropped mass at n 1e6 (root 8192, depth 6, 8 groups);
  3. the live (unique) determinants at n 1e7 (root 16,384, depth 7, 8
     and 16 groups), which size max_unique and the eloc buffers;

each DFS run once, timed (synchronized; the JAX script times a second
run, its first being the compile).

    python -m pynqs_tpu_torch.scripts.measure_dfs_r3

``main(system=..., root=...)`` takes any ``System`` (default the Fe2S2
integrals) and reads ``CKPT`` under ``root``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, dfs_depth_profile
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "REPO", "CKPT", "DCUT", "PROFILE", "RUNS"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join("checkpoints", "fe2s2_r2_dcut96_final.pkl")  # relative to root
DCUT = 96
PROFILE = (10_000_000, 16384, 12)  # part 1: (n, root rows, depth)
RUNS = (  # (n, root, depth, groups, capacity)
    (1_000_000, 8192, 6, 8, 4096),
    (10_000_000, 16384, 7, 8, 4096),
    (10_000_000, 16384, 7, 16, 4096),
)


@torch.no_grad()
def main(*, system=None, device=None, root: str = REPO) -> dict:
    """Returns {"live_per_depth": [...], "runs": [{"n", "root", "depth",
    "groups", "capacity", "dropped", "live", "seconds"}]}."""
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, DCUT, device=dev)
    model.load_numpy_params({k: np.asarray(v, np.float32) for k, v in load_flagship_params(
        os.path.join(root, CKPT)).items()})
    print("device:", dev, flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    n_p, root_p, depth_p = PROFILE
    live, _ = dfs_depth_profile(model, n_p, capacity_root=root_p, max_depth=depth_p,
                                generator=torch.Generator(device=dev).manual_seed(0))
    print(f"live branches per depth (n={n_p:.0e}, root {root_p}) [{time.time() - t0:.0f}s]:")
    for k, lv in enumerate(live):
        print(f"  depth {k + 1:2d}: {lv}")
    out = []
    for n, root_rows, depth, G, cap in RUNS:
        sync()
        t0 = time.time()
        _, counts, dropped = ar_sampling_dfs(
            model, n, capacity=cap, n_group=G, split_depth=depth, capacity_root=root_rows,
            generator=torch.Generator(device=dev).manual_seed(2))
        sync()
        dt = time.time() - t0
        lv, dr = int((counts > 0).sum()), float(dropped) / n * 100
        print(f"DFS n={n:.0e} root={root_rows} depth={depth} G={G} cap={cap}: "
              f"dropped {dr:.4f}%  live {lv}  t={dt:.2f}s", flush=True)
        out.append({"n": n, "root": root_rows, "depth": depth, "groups": G, "capacity": cap,
                    "dropped": dr / 100, "live": lv, "seconds": dt})
    return {"live_per_depth": [int(x) for x in live], "runs": out}


if __name__ == "__main__":
    main()
