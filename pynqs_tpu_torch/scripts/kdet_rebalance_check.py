"""REDUCE against SIMPLE on the card at two (k_det, n_stoch) settings.

Counterpart of ``scripts/kdet_rebalance_check.py``, with its command
line and defaults.  The flagship REDUCE setting (512, 128) against the
cheaper (256, 64): REDUCE is unbiased at any (k, n), so this prices the
variance on a trained Fe2S2 state (``checkpoints/<ckpt>``, a chain at
``--dcut``):

  - SIMPLE's exact local energy of each sample (all 1 + n_sd forwards)
    as the oracle,
  - REDUCE (segmax top set) at (512, 128) and (256, 64), ``--n-keys``
    independent tail seeds per batch,
  - the batch-energy bias against SIMPLE, the per-sample RMS deviation,
    and the spread of the batch energy over the seeds.

Samples: DFS (n 1e6, capacity 4096, 4 groups, split depth 6) compacted
to the 2048 heaviest rows, a new draw per batch; the forwards through
kernel #1 in bf16 (``ops.fused_rnn.graph_mpsrnn_logpsi_fused``).

    python -m pynqs_tpu_torch.scripts.kdet_rebalance_check [--ckpt fe2s2_dcut48_final.pkl]

``main(system=...)`` takes any ``System`` (default the Fe2S2 integrals).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce, local_energy_simple
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, compact_by_count
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "parser", "REPO", "B", "N_DRAW"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B = 2048  # samples per batch: the heaviest rows of each draw
N_DRAW = 1_000_000  # AR samples per draw


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, default="fe2s2_dcut48_final.pkl")
    ap.add_argument("--dcut", type=int, default=48)
    ap.add_argument("--n-batches", type=int, default=4)
    ap.add_argument("--n-keys", type=int, default=4)
    return ap


@torch.no_grad()
def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """Returns {(k_det, n_stoch): {"bias", "rms", "espread"} (Ha, means
    over batches and seeds)}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, args.dcut, device=dev)
    model.load_numpy_params({k: np.asarray(v, np.float32) for k, v in load_flagship_params(
        os.path.join(root, "checkpoints", args.ckpt)).items()})
    tabs = sys_.tables(dev, torch.float32)
    ops, hpair, table = tabs.astuple(), tabs.hpair_best, sys_.excitation
    T = fused_rnn.pack_tables(model)

    def fwd(bits):
        return fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, tables=T)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    configs = ((512, 128), (256, 64))
    stats = {c: {"bias": [], "rms": [], "espread": []} for c in configs}
    for b in range(args.n_batches):
        bits, counts, _ = ar_sampling_dfs(model, N_DRAW, capacity=4096, n_group=4,
                                          split_depth=6, capacity_root=4096, generator=gen(500 + b))
        bits = compact_by_count(bits, counts, B)[0]
        e_ref = local_energy_simple(fwd, bits, ops, table, batch=256,
                                    hpair=hpair)[:, 0].double().cpu().numpy()
        for kd, ns in configs:
            es = []
            for k in range(args.n_keys):
                e = local_energy_reduce(fwd, bits, ops, table, gen(7000 + 97 * b + k), k_det=kd,
                                        n_stoch=ns, hpair=hpair,
                                        topk="segmax")[:, 0].double().cpu().numpy()
                stats[(kd, ns)]["bias"].append((e - e_ref).mean())
                stats[(kd, ns)]["rms"].append(np.sqrt(((e - e_ref) ** 2).mean()))
                es.append(e.mean())
            stats[(kd, ns)]["espread"].append(np.std(es))
        print(f"batch {b}: E_SIMPLE/sample mean {e_ref.mean():+.6f} Ha, "
              f"sample std {e_ref.std():.4f} Ha", flush=True)

    print(f"\nper-sample eloc, {args.n_batches} batches x {args.n_keys} keys (mHa; batch SE of "
          f"the mean from sampling alone = sample_std/sqrt({B}), the floor the tail noise "
          f"adds to)")
    out = {}
    for c in configs:
        s = stats[c]
        print(f"  k={c[0]:3d}/n={c[1]:3d}:  bias {np.mean(s['bias']) * 1e3:+8.4f} "
              f"+- {np.std(s['bias']) / np.sqrt(len(s['bias'])) * 1e3:.4f}   "
              f"per-sample RMS dev {np.mean(s['rms']) * 1e3:8.3f}   "
              f"batch-energy spread over keys {np.mean(s['espread']) * 1e3:8.4f}")
        out[c] = {k: float(np.mean(v)) for k, v in s.items()}
    return out


if __name__ == "__main__":
    main()
