"""Time the doubles pair selection W[b, u, v] = hpair[po[b, u], pv[b, v]]
on the card.

    python -m pynqs_tpu_torch.scripts.time_pair_select [--seed 0]

For each shape ([256, 435, 45], the evaluation's chunk, and
[2048, 435, 45], the training step's batch; Fe2S2's sorb 40, 15α/15β,
npair 780, f32 hpair, int64 indices from random determinants) and
variant, ``measure`` reports:

  * ``ms``: CUDA events around the wrapper call ``pair_select_w``;
  * ``device_ms``: the kernel alone on the device (``torch.profiler``);
  * ``host_ms``: the wrapper's host time per call, a host clock over
    unsynchronized calls (the card keeps up, so the queue never fills);
  * ``prev_ms``/``prev_device_ms``/``prev_host_ms``: the same for the
    earlier gather kernel (``pair_select._launch_gather``);
  * ``plain_ms`` and ``library_ms`` (one PyTorch gather);
  * ``bound_ms``: each input byte read once and each output byte
    written once, over 3.35 TB/s;
  * ``l2_sector_bytes``: the distinct 32-byte sectors of hpair that a
    gather along its rows must touch, per (b, u) row, times 32 bytes;
    ``l2_sector_bytes_kernel`` the same for the kernel's reads, along
    the rows of hpair^T, per (b, v) row and item band; diagnostics of
    how far the gather's L2 traffic can come down.

The last line is a JSON object of all of it.  ``chip_smoke.py`` calls
``measure`` in its phases 9 and 10.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch

__all__ = ["measure", "l2_sector_bytes", "bound_ms", "pair_inputs"]

H100_BYTES = 3.35e12  # HBM3 bytes/s, SXM data sheet
SORB, NOA, NOB = 40, 15, 15


def _sync():
    torch.cuda.synchronize()


def event_ms(fn, reps):
    """CUDA-event ms per call over ``reps`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, pattern="pair_select", reps=20):
    """Device time per call of the kernels whose name matches
    ``pattern``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)) / reps / 1e3


def host_ms(fn, calls):
    """Host-clock ms per call over ``calls`` unsynchronized calls."""
    fn()
    _sync()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    _sync()
    return ms


def bound_ms(po, pv, hp):
    """Bytes bound: W written once, po, pv and hpair read once."""
    n = (po.shape[0] * po.shape[1] * pv.shape[1] * hp.element_size()
         + sum(t.numel() * t.element_size() for t in (po, pv, hp)))
    return n / H100_BYTES * 1e3, n


def l2_sector_bytes(rows, cols, npair, itemsize, band=None, chunk=256):
    """The distinct 32-byte sectors that a gather of m[rows[b, i],
    cols[b, j]] from a row-major [npair, npair] matrix m touches, per
    (b, i) and per band of ``band`` consecutive j (default one band),
    summed, times 32 bytes."""
    n, nj = 0, cols.shape[1]
    band = band or nj
    for i in range(0, rows.shape[0], chunk):
        a, c = rows[i:i + chunk].long(), cols[i:i + chunk].long()
        for j in range(0, nj, band):
            s = ((a[:, :, None] * npair + c[:, None, j:j + band]) * itemsize // 32).sort(-1).values
            n += int(s.shape[0] * s.shape[1] + (s[..., 1:] != s[..., :-1]).sum())
    return n * 32


def pair_inputs(B, dev, seed=0):
    """(po, pv, hpair): the pair indices of B random determinants of the
    Fe2S2 shape and a seeded symmetric f32 pair matrix."""
    from pynqs_tpu_torch.ops.hamiltonian import pair_indices
    from pynqs_tpu_torch.ops.integrals import triangle_size
    from pynqs_tpu_torch.utils.system import System

    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((SORB, SORB)) * 0.1
    system = System.from_integrals((h1e + h1e.T) / 2,
                                   rng.standard_normal(triangle_size(SORB)) * 0.01,
                                   SORB, NOA, NOB)
    bits = np.zeros((B, SORB), np.int8)
    for s, no in ((0, NOA), (1, NOB)):
        cols = np.argsort(rng.random((B, SORB // 2)), axis=1)[:, :no]
        bits[np.repeat(np.arange(B), no), 2 * cols.ravel() + s] = 1
    po, pv = pair_indices(torch.as_tensor(bits, device=dev), system.excitation)
    return po, pv, system.tables(dev, torch.float32).hpair


def measure(po, pv, hp, variant, reps=50, host_calls=1000):
    """The numbers listed in the module docstring for one variant on
    these operands (CUDA tensors)."""
    from pynqs_tpu_torch.ops import pair_select as ps

    kern = lambda: ps.pair_select_w(po, pv, hp, variant=variant)  # noqa: E731
    prev = lambda: ps._launch_gather(po, pv, hp, variant)  # noqa: E731
    plain = lambda: ps.pair_select_w_plain(po, pv, hp, variant=variant)  # noqa: E731
    preps = max(2, reps // 10)
    # in turns: plain, earlier, kernel, kernel, earlier, plain
    p1, g1 = event_ms(plain, preps), event_ms(prev, reps)
    k1, k2 = event_ms(kern, reps), event_ms(kern, reps)
    g2, p2 = event_ms(prev, reps), event_ms(plain, preps)
    lib = event_ms(lambda: hp[po[..., None], pv[:, None, :]], preps)
    bnd, nbytes = bound_ms(po, pv, hp)
    band = None if variant == "rowrow" else ps.pair_select_launch_shape(
        po.shape[0], po.shape[1], pv.shape[1], hp.element_size())["band"]
    return {
        "variant": variant, "shape": [po.shape[0], po.shape[1], pv.shape[1]],
        "ms": (k1 + k2) / 2, "device_ms": device_ms(kern), "host_ms": host_ms(kern, host_calls),
        "prev_ms": (g1 + g2) / 2, "prev_device_ms": device_ms(prev),
        "prev_host_ms": host_ms(prev, host_calls), "plain_ms": (p1 + p2) / 2,
        "library_ms": lib, "bound_ms": bnd, "bytes": nbytes,
        "l2_sector_bytes": l2_sector_bytes(po, pv, hp.shape[0], hp.element_size()),
        "l2_sector_bytes_kernel": l2_sector_bytes(pv, po, hp.shape[0], hp.element_size(), band),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the timing needs one GPU")
    from pynqs_tpu_torch.ops import pair_select as ps

    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    ps.build_kernel()
    print(f"built csrc/pair_select.cu in {time.perf_counter() - t:.2f} s; gpu {gpu}", flush=True)
    rows = []
    for B, calls in ((256, 1000), (2048, 100)):
        po, pv, hp = pair_inputs(B, dev, args.seed)
        for v in ps.VARIANTS:
            ok = torch.equal(ps.pair_select_w(po, pv, hp, variant=v),
                             ps.pair_select_w_plain(po, pv, hp, variant=v))
            r = measure(po, pv, hp, v, host_calls=calls)
            r["bitwise_equal"] = ok
            rows.append(r)
            print(" ".join(f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}"
                           for k, x in r.items()) + f"; gpu {gpu}", flush=True)
    print(json.dumps({"gpu": gpu, "rows": rows}))
    if not all(r["bitwise_equal"] for r in rows):
        raise SystemExit("a kernel differs from its plain version")


if __name__ == "__main__":
    main()
