"""The benchmark of pynqs_tpu_torch on one NVIDIA H100.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell comes from ``BENCHMARK.json``;
its files are found by name: ``configs/<config>.json`` (sizes, weights,
precision), ``traffic/<traffic>.json`` (the driver module under
``drivers/`` and its parameters), ``limits/<workload>.json`` (the limit of
each number that decides ``correct``) and ``metrics/<metric>.json`` (the
reader module under ``readers/``, its function and arguments).  Set-up
builds and warms the cell, a window of ``--seconds`` runs it, and the
reference (``reference.py``) then judges what the window's path produced.
With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window.  ``--plant`` breaks the timed path
on purpose (a fault) or judges the lower-precision control in the
program's place; the benchmark's own runs never pass it.  A ``--trace 1``
run measures an untraced window first, for what the host clock reads, then
a traced one of the same length.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_h100")
# the program's caches stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "pynqs_tpu")
FAULTS = ("unchanged", "half", "half_sample", "altered", "selection", "tail_in_det", "rows")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str, root: str = ROOT, here: str = HERE):
    """(benchmark, workload entry, config, traffic, limits) of a cell, by name."""
    bench = load_json(root, "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = load_json(here, "configs", f"{wl['config']}.json")
    tr = load_json(here, "traffic", f"{wl['traffic']}.json")
    lim = load_json(here, "limits", f"{workload}.json")
    return bench, wl, cfg, tr, lim


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The end-to-end (kind "end_to_end") or per-layer metrics this cell
    reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload]) and m["moves"] in names]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def device_lines(torch, dev) -> dict:
    """The card's name and power limit, printed before the result."""
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1}
    if dev.type == "cuda":
        try:
            q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30)
            print(f"[device] nvidia-smi: {q.stdout.strip()}", flush=True)
        except (OSError, subprocess.SubprocessError) as exc:
            print(f"[device] nvidia-smi unavailable: {exc}", flush=True)
    print(f"[device] {info['kind']}, torch {torch.__version__}", flush=True)
    return info


def run_cell(workload, seed, seconds, trace, *, plant=None, device=None, root=ROOT, here=HERE,
             t_start=T_START):
    """One run of a cell; returns the result dict (the last line's
    object) and the compared numbers."""
    import torch

    bench, wl, cfg, tr, lim = cell(workload, root, here)
    dev = torch.device(device or "cuda")
    driver = importlib.import_module(f"bench_h100.drivers.{tr['driver']}")
    dinfo = device_lines(torch, dev)
    state = driver.setup(cfg, tr, seed, dev, root=root, plant=plant)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start
    events = None
    if trace:
        # an untraced window first (the rates that the host clock reads),
        # then the same length under the profiler (what the trace reads)
        profile_mod = importlib.import_module("bench_h100.readers.profile")
        untraced = driver.window(state, seconds)
        with profile_mod.traced(dev) as prof:
            work = driver.window(state, seconds)
        events = profile_mod.events_of(prof)
        del prof
        work["untraced"] = untraced
        print(f"[trace] per step: untraced {untraced['window_s'] / untraced['steps']!r} s, "
              f"traced {work['window_s'] / work['steps']!r} s", flush=True)
    else:
        work = driver.window(state, seconds)
    if dev.type == "cuda":
        dinfo["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        dinfo["memory_peak_bytes"] = 0
    driver.report(state, work)
    t_ref = time.time()
    checks, ctrl = driver.judge(state, lim, control=plant == "control")
    print(f"[reference] judged in {time.time() - t_ref:.1f} s", flush=True)
    for name, v in (ctrl or {}).items():
        print(f"[control] {name} {v!r}", flush=True)
    if ctrl:  # the control in the program's place: its numbers are judged
        checks = {k: dict(c, value=ctrl.get(k, c["value"])) for k, c in checks.items()}
    windows = [work] + ([work["untraced"]] if "untraced" in work else [])
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": sum(w["attempted"] for w in windows),
              "failed": sum(w["failed"] for w in windows)}
    if trace:
        metrics, breakdown, busy = {}, None, None
        for m in cell_metrics(bench, workload, "per_layer"):
            spec = load_json(here, "metrics", f"{m['name']}.json")
            reader = importlib.import_module(f"bench_h100.readers.{spec['reader']}")
            v = getattr(reader, spec["fn"])(events, work, **spec.get("args", {}))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        profile_mod = importlib.import_module("bench_h100.readers.profile")
        busy = profile_mod.busy_s(events)
        breakdown = profile_mod.breakdown(events)
        dinfo.update(busy_s=busy, window_s=work["window_s"])
        result["metrics"] = metrics
    else:
        e2e = dict(work["end_to_end"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell_metrics(bench, workload, "end_to_end")}
    result["device"] = dinfo
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="pynqs_tpu_torch benchmark, one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--plant", choices=("control",) + FAULTS, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--repeat", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "pynqs_tpu_torch")):
        print("the program (pynqs_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    import torch

    bench, wl, *_ = cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['chips']} CUDA device(s) needed; found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for k in range(args.repeat - 1):  # calibration: seeds seed+1 .. in one process
        r = run_cell(args.workload, args.seed + 1 + k, args.seconds, args.trace,
                     plant=args.plant, t_start=time.time())
        print(f"[repeat] seed {args.seed + 1 + k} correct {r['correct']} "
              f"{json.dumps(r['checks'])} {json.dumps(r['metrics'])}", flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, args.trace, plant=args.plant)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of the JAX package or JAX: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
