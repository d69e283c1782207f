"""Time kernels #1-#3 (the fused forward and the prefix passes) of two
checkouts of this repository on one card, in turns: other, this, this,
other.

    python -m pynqs_tpu_torch.scripts.time_fused_ab --other DIR [--rows 657408]

DIR is the root of another checkout (``git archive`` of an earlier
commit unpacked into a directory that ``.gitignore`` lists).  Each turn
is a process that imports ``pynqs_tpu_torch`` from its checkout and
builds its kernels there (both checkouts' builds run first, side by
side), then times each case's wrapper call by CUDA events (one warm-up
call, 5 timed) and its kernel alone on the device (``torch.profiler``,
the kernels named ``fused_rnn*``, 5 calls), on the same seeded random
rows of Fe2S2's shape (sorb 40, 15α/15β), in bf16 and f32:

  * ``graph_mpsrnn_logpsi_fused`` (kernel #1, its dedup off) on 657,408
    rows of the dcut-48 chain with ``checkpoints/fe2s2_dcut48_final.pkl``,
    and of the r5g64 flagship (dcut 64, 2 predecessors, the tensor coupling at
    dcut_cmpr 4) with ``checkpoints/fe2s2_r3_dcut64_r5g64.pkl`` on the
    graph of seeded stand-in integrals, as ``chip_smoke.py`` builds it;
  * the chain's prefix passes (``fused_rnn_prefix.prefix_parent`` and
    ``prefix_child``, kernels #2 and #3) at the training step's counts:
    2048 parents, each with 320 of the other rows as children (random
    determinants, so most children start at site 0).

The weights and integrals come from this checkout.  Each turn prints
one JSON line; the last line is a JSON object with, per case, the two
checkouts' mean ms (``other_ms``, ``this_ms``), every turn's ms, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SORB, NOA, NOB = 40, 15, 15


def _build(root):
    """A process that builds the tensor-core kernel of ``root``'s package."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pynqs_tpu_torch.ops import fused_rnn; fused_rnn.build_mma_kernel()")
    return subprocess.Popen([sys.executable, "-c", code, root])


def _turn(root, n_rows, seed):
    """Time the cases with the package of ``root``: {case: ms}."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.ops import fused_rnn_prefix as pre
    from pynqs_tpu_torch.ops.integrals import triangle_size
    from pynqs_tpu_torch.utils.flagship import flagship_model, load_flagship_params
    from pynqs_tpu_torch.utils.system import System

    assert fused_rnn.__file__.startswith(os.path.abspath(root)), fused_rnn.__file__
    fused_rnn.DEDUP_MIN_ROWS = 1 << 62  # kernel #1 on every row (a checkout without the dedup ignores it)
    dev = torch.device("cuda")
    irng = np.random.default_rng(0)  # chip_smoke.py's stand-in integrals
    h1e = irng.standard_normal((SORB, SORB)) * 0.1
    system = System.from_integrals((h1e + h1e.T) / 2,
                                   irng.standard_normal(triangle_size(SORB)) * 0.01,
                                   SORB, NOA, NOB)
    ck = os.path.join(HERE, "checkpoints")
    models = {
        "chain dcut 48": GraphMPSRNN(SORB, NOA, NOB, dcut=48, phase_mode="arg",
                                     norm_mode="mpsrnn", device=dev).load_numpy_params(
            load_flagship_params(os.path.join(ck, "fe2s2_dcut48_final.pkl"))),
        "r5g64 dcut 64": flagship_model(system, 64, use_tensor=True, max_preds=2,
                                        device=dev).load_numpy_params(
            load_flagship_params(os.path.join(ck, "fe2s2_r3_dcut64_r5g64.pkl"))),
    }
    rng = np.random.default_rng(seed)
    bits = np.zeros((n_rows, SORB), np.int8)
    for s, no in ((0, NOA), (1, NOB)):
        cols = np.argsort(rng.random((n_rows, SORB // 2)), axis=1)[:, :no]
        bits[np.repeat(np.arange(n_rows), no), 2 * cols.ravel() + s] = 1
    rows = torch.as_tensor(bits, device=dev)

    out = {}

    def time(case, fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[case] = start.elapsed_time(end) / 5
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        out[case + ", device"] = sum(e.self_device_time_total for e in prof.key_averages()
                                     if e.key.startswith("void fused_rnn")
                                     or "::fused_rnn" in e.key) / 5 / 1e3

    chain, B, C = models["chain dcut 48"], 2048, 320
    par, kids = rows[:B], rows[B:B + B * C]
    t_min = pre.t_min_process_order(chain, par, kids.reshape(B, C, SORB)).reshape(-1)
    par_idx = torch.arange(B, device=dev).repeat_interleave(C)
    for mm in (torch.bfloat16, torch.float32):
        mmn = str(mm).split(".")[-1]
        for name, m in models.items():
            time(f"{name} {mmn}",
                 lambda: fused_rnn.graph_mpsrnn_logpsi_fused(m, rows, matmul_dtype=mm))
        time(f"chain dcut 48 prefix parent {mmn}, {B} rows",
             lambda: pre.prefix_parent(chain, par, matmul_dtype=mm))
        _, hh, sh = pre.prefix_parent(chain, par, matmul_dtype=mm)
        time(f"chain dcut 48 prefix child {mmn}, {B * C} rows",
             lambda: pre.prefix_child(chain, kids, par_idx, t_min, hh, sh, matmul_dtype=mm))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rows", type=int, default=657408)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # internal: time one checkout
    a = ap.parse_args(argv)
    if a.turn:
        print(json.dumps(_turn(a.turn, a.rows, a.seed)), flush=True)
        return 0
    other, this = os.path.abspath(a.other), HERE
    builds = [_build(other), _build(this)]
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("a checkout's kernels did not build")
    turns = []
    for root in (other, this, this, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", other,
                            "--rows", str(a.rows), "--seed", str(a.seed), "--turn", root],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"the turn of {root} failed:\n{r.stderr}")
        turns.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps({"root": root, "ms": turns[-1]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    res = {case: {"other_ms": (turns[0][case] + turns[3][case]) / 2,
                  "this_ms": (turns[1][case] + turns[2][case]) / 2,
                  "turns_ms": [t[case] for t in turns]} for case in turns[0]}
    print(json.dumps({"rows": a.rows, "gpu": smi, "cases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
