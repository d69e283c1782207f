"""Per-chunk REDUCE distinct-row counts over the whole compacted sample
buffer, on the card: the size of ``--eloc-dedup-max``.

Counterpart of ``scripts/measure_unique_chunks.py``, with its
positional arguments and defaults (checkpoint, n 1e7, max_unique 32768,
chunk B 4096).  The dedup capacity must cover the worst chunk, and late
chunks of rarer states overlap less than chunk 0.  DFS sampling of the
dcut-96 chain (8 groups, capacity 4096, split depth 8), compacted to
max_unique rows, then ``energy.eloc.reduce_unique_count`` at k_det 512 /
n_stoch 128 with f64 tables.

    python -m pynqs_tpu_torch.scripts.measure_unique_chunks [ckpt] [n] [max_unique] [B]

``main(argv, system=...)`` takes any ``System`` (default the Fe2S2
integrals); the checkpoint path is relative to ``root``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import reduce_unique_count
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, compact_by_count
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "parser", "REPO"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", nargs="?", default="checkpoints/fe2s2_r3_dcut96_a_resume.pkl")
    ap.add_argument("n", nargs="?", type=lambda s: int(float(s)), default=10_000_000)
    ap.add_argument("max_unique", nargs="?", type=int, default=32768)
    ap.add_argument("B", nargs="?", type=int, default=4096)
    ap.add_argument("--dcut", type=int, default=96)
    return ap


@torch.no_grad()
def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """Returns {"live", "dropped", "kept", "unique" (per chunk), "rows"
    (forward rows per chunk)}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, args.dcut, device=dev)
    model.load_numpy_params({k: np.asarray(v, np.float32) for k, v in load_flagship_params(
        os.path.join(root, args.ckpt)).items()})
    N = args.n
    t0 = time.time()
    bits, counts, dropped = ar_sampling_dfs(
        model, N, capacity=4096, n_group=8, split_depth=8, capacity_root=4096,
        generator=torch.Generator(device=dev).manual_seed(5))
    live = int((counts > 0).sum())
    print(f"DFS n={N:.0e} G=8 cap=4096 d=8: live={live} "
          f"dropped={float(dropped) / N * 100:.4f}%  [{time.time() - t0:.0f}s]", flush=True)
    bits_c, counts_c = compact_by_count(bits, counts, args.max_unique)[:2]
    kept = int(counts_c.sum())
    print(f"compacted to {args.max_unique}: kept mass {kept / N * 100:.4f}%", flush=True)
    ops = sys_.tables(dev, torch.float64)
    t0 = time.time()
    nu = np.asarray(reduce_unique_count(
        bits_c, ops.astuple(), sys_.excitation, torch.Generator(device=dev).manual_seed(9),
        k_det=512, n_stoch=128, batch=args.B, hpair=ops.hpair))
    rows = args.B * (1 + 512 + 128)
    print(f"per-chunk unique rows (B={args.B}, rows/chunk={rows}) [{time.time() - t0:.0f}s]:")
    for i, n in enumerate(nu):
        print(f"  chunk {i}: {n} ({n / rows * 100:.1f}%)")
    print(f"max: {nu.max()}  -> dedup capacity >= {int(nu.max() * 1.2)}")
    return {"live": live, "dropped": float(dropped) / N, "kept": kept / N,
            "unique": nu.tolist(), "rows": rows}


if __name__ == "__main__":
    main()
