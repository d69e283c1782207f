"""CI-NQS polish of a trained Fe2S2 checkpoint (one-shot eigensolve).

Counterpart of ``scripts/fe2s2_ci_polish.py``, with its command line and
defaults: a DFS capture of the trained state, the VMC energy on the
captured set under exact |ψ|² weights (the REDUCE local energy with the
dense pair matrix, exact for ``--k-det 0``), then ``ci.nqs_ci.ci_polish``
with the ``m`` heaviest captured determinants as the CI set, for each
``m`` of ``--m``.  ``--fwd-dtype`` is the forward's precision on the
card: the fused forward in bf16 or f32 (both on the tensor cores, f32 as
three TF32 products per product), or ``xla``, the exact site-loop
``model.log_psi``; torch's own TF32 stays off.  On the CPU the forward is
``model.log_psi``.

    python -m pynqs_tpu_torch.scripts.fe2s2_ci_polish checkpoints/fe2s2_r3_dcut64_r5g64.pkl \\
        --dcut 64 --use-tensor --max-preds 2 --capacity 8192 --m 2048,4096,8192 \\
        --k-det 0 --eloc-batch 128 --ci-chunk 128

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

from pynqs_tpu_torch.ci.nqs_ci import ci_polish
from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "parser", "polish_forward"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("--dcut", type=int, default=48)
    ap.add_argument("--m", type=str, default="2048",
                    help="CI-set size, or a comma list for a sweep (e.g. 2048,4096,8192)")
    ap.add_argument("--n-sample", type=int, default=10_000_000)
    ap.add_argument("--n-group", type=int, default=8)
    ap.add_argument("--split-depth", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--k-det", type=int, default=0,
                    help="0 = exact deterministic eloc (k_det = n_sd) for the E_VMC "
                         "comparison (capture-mode ci_polish always uses k_det = n_sd)")
    ap.add_argument("--n-stoch", type=int, default=256)
    ap.add_argument("--ci-chunk", type=int, default=128)
    ap.add_argument("--eloc-batch", type=int, default=1024)
    ap.add_argument("--use-tensor", action="store_true")
    ap.add_argument("--max-preds", type=int, default=1)
    ap.add_argument("--restrict", default="capture", choices=["capture", "complement"],
                    help="'capture' = exact truncated-basis variational bound (default); "
                         "'complement' = exact H_cn + estimated H_nn (coverage-biased)")
    ap.add_argument("--fwd-dtype", choices=["bf16", "f32", "xla"], default="bf16",
                    help="forward precision on the card: the fused forward in bf16 or f32, "
                         "or 'xla' = the exact site-loop model.log_psi")
    return ap


def polish_forward(model, fwd_dtype: str):
    """The forward of ``--fwd-dtype``: on the card the fused forward in
    bf16 or f32, or ``model.log_psi`` for "xla"; on the CPU
    ``model.log_psi``.  The fused forward packs its tables from the
    model's parameters at each call (the tensor-core tables are cached
    per parameter version), so it follows a model in training too
    (``fe2s2_nqsci_train``)."""
    if fwd_dtype not in ("bf16", "f32", "xla"):
        raise ValueError(f"fwd_dtype must be bf16, f32 or xla, not {fwd_dtype!r}")
    if model.M_re.device.type == "cpu" or fwd_dtype == "xla":
        return model.log_psi
    mm = torch.bfloat16 if fwd_dtype == "bf16" else torch.float32
    return partial(fused_rnn.graph_mpsrnn_logpsi_fused, model, matmul_dtype=mm)


@torch.no_grad()
def main(argv=None, *, system=None, device=None) -> dict:
    """The JAX script's ``main`` on ``system`` (default ``fe2s2_system()``)
    on ``device`` (default the card); prints its report and returns
    {"e_vmc", "n_live", "dropped", "seconds_vmc", "results": [{"m", "e",
    "info", "seconds"}]} (energies with ecore)."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float32)
    model = flagship_model(sys_, args.dcut, use_tensor=args.use_tensor,
                           max_preds=args.max_preds, device=dev)
    model.load_numpy_params(load_flagship_params(args.ckpt))
    fwd = polish_forward(model, args.fwd_dtype)
    tabs, table = sys_.tables(dev), sys_.excitation

    m_list = [int(x) for x in args.m.split(",")]
    t0 = time.time()
    bits, counts, dropped = ar_sampling_dfs(
        model, args.n_sample, capacity=args.capacity, n_group=args.n_group,
        split_depth=args.split_depth, capacity_root=args.capacity,
        generator=torch.Generator(device=dev).manual_seed(11))
    live = counts > 0
    rows = bits[live]
    la = fwd(rows)[:, 0].double()
    p = torch.exp(2.0 * (la - la.max()))
    order = torch.argsort(-p)
    n_live = rows.shape[0]
    if max(m_list) >= n_live:
        raise ValueError(f"--m {max(m_list)} leaves no captured row outside the CI set "
                         f"({n_live} live rows)")
    print(f"sampled: {n_live} uniques, dropped {float(dropped) / args.n_sample:.3%}, "
          f"t={time.time() - t0:.0f}s", flush=True)

    # plain VMC energy on the same captured set (exact weights), the
    # doubles through the dense pair matrix
    kd = args.k_det if args.k_det > 0 else table.n_sd
    ns = args.n_stoch if args.k_det > 0 else 8
    t0 = time.time()
    el = local_energy_reduce(fwd, rows, tabs.astuple(), table,
                             torch.Generator(device=dev).manual_seed(21),
                             k_det=min(kd, table.n_sd), n_stoch=ns, batch=args.eloc_batch,
                             hpair=tabs.hpair, topk="segmax")[:, 0].double()
    e_vmc = float((p / p.sum() * el).sum()) + sys_.ecore
    t_vmc = time.time() - t0

    def vs_ref(e):
        return f" ({(e - sys_.e_ref) * 1000:+.3f} mHa)" if sys_.e_ref is not None else ""

    print(f"E_VMC (exact weights, same set) = {e_vmc:.6f} Ha{vs_ref(e_vmc)}  "
          f"t={t_vmc:.1f}s", flush=True)

    results = []
    for m in m_list:
        d_idx = order[:m]
        print(f"\n--- m = {m}  (CI set mass {float(p[d_idx].sum() / p.sum()):.4f} of "
              f"captured) ---", flush=True)
        t0 = time.time()
        e, _, info = ci_polish(
            model, sys_, rows[d_idx], bits, torch.Generator(device=dev).manual_seed(31),
            fwd=fwd, sample_counts=counts.cpu().numpy(), ci_chunk=args.ci_chunk,
            eloc_batch=args.eloc_batch, k_det=kd, n_stoch=ns, restrict=args.restrict,
            device=dev)
        e_tot = e + sys_.ecore
        dt = time.time() - t0
        print(f"ci_polish: t={dt:.0f}s  info={info}")
        print(f"E_CI-NQS = {e_tot:.6f} Ha{vs_ref(e_tot)}   gain vs VMC "
              f"{1000 * (e_vmc - e_tot):+.3f} mHa", flush=True)
        results.append({"m": m, "e": e_tot, "info": info, "seconds": dt})
    print("\n| m | E_polish (mHa) | gain vs E_VMC (mHa) |")
    print("|---|---|---|")
    for r in results:
        ref = f"{(r['e'] - sys_.e_ref) * 1000:+.3f}" if sys_.e_ref is not None else f"{r['e']:.6f} Ha"
        print(f"| {r['m']} | {ref} | {1000 * (e_vmc - r['e']):+.3f} |")
    return {"e_vmc": e_vmc, "n_live": n_live, "dropped": float(dropped) / args.n_sample,
            "seconds_vmc": t_vmc, "results": results}


if __name__ == "__main__":
    main()
