#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (and a few detail lines):
  1. environment probe (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build of the fused-forward CUDA kernel from pynqs_tpu_torch/csrc;
  3. kernel against its plain torch version on the card: the dcut-48
     Fe2S2 chain (checkpoints/fe2s2_dcut48_final.pkl; sorb 40, 15α/15β)
     on 65,536 random valid rows in f32 and bf16, a small DAG model and
     the linear/unit modes;
  4. local-energy identity: REDUCE with k_det = n_sd equals SIMPLE;
  5. three VMC steps in the flagship configuration (DFS sampling n=1e6,
     capacity 4096, 4 groups, split depth 6, compacted to B = 2048;
     REDUCE k_det 256 / n_stoch 64; seeded random integrals of the
     Fe2S2 shape), through the CUDA kernel;
  6. the kernel on the 657,408 rows of one step's eloc forward (captured
     in phase 5): agreement with the plain version, then CUDA-event
     times of both beside the card's bound.

The last two lines are the kernels' JSON summary and the result JSON.
Any failed check raises, so the script exits non-zero with no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SORB, NOA, NOB, DCUT = 40, 15, 15, 48
B, K_DET, N_STOCH = 2048, 256, 64
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES = 3.35e12  # HBM3 bytes/s


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rand_dets(rng, n, sorb, noa, nob):
    """n random determinants with noa alpha and nob beta electrons."""
    norb = sorb // 2
    out = np.zeros((n, sorb), np.int8)
    for s, no in ((0, noa), (1, nob)):
        cols = np.argsort(rng.random((n, norb)), axis=1)[:, :no]
        rows = np.repeat(np.arange(n), no)
        out[rows, 2 * cols.ravel() + s] = 1
    return out


def phase_err(a, b):
    """(max |Δ log|ψ||, max |e^{iφ_a} − e^{iφ_b}|)."""
    da = (a[:, 0] - b[:, 0]).abs().max().item()
    dp = (torch.polar(torch.ones_like(a[:, 1]), a[:, 1])
          - torch.polar(torch.ones_like(b[:, 1]), b[:, 1])).abs().max().item()
    return da, dp


def ptxas_report(text):
    """One line per kernel instantiation of ``nvcc -Xptxas -v``'s report:
    its template arguments, registers and spills."""
    out, name, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", m.group(1))
            name = (f"rows/warp {t.group(1)}, outputs/lane {t.group(2)}, "
                    f"W {'bf16' if t.group(3) == '1' else 'f32'}") if t else m.group(1)
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers{m.group(2)}; {spill}")
            name = None
    return out


def cuda_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pynqs_tpu_torch.energy.eloc import local_energy_reduce, local_energy_simple
    from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.ops.cplx import ratio_re_im
    from pynqs_tpu_torch.ops.hamiltonian import comb_hij
    from pynqs_tpu_torch.ops.integrals import triangle_size
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, compact_by_count
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
    from pynqs_tpu_torch.utils.checkpoint import load_params
    from pynqs_tpu_torch.utils.system import System

    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    try:
        nvcc = subprocess.run([fused_rnn._nvcc(), "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        nvcc = str(e)
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    log(1, f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc} | "
           f"triton import: {has_triton} | gpu: {smi} | "
           f"devices {torch.cuda.device_count()} | {sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = fused_rnn.build_kernel()
    log(2, f"built csrc/fused_rnn.cu for sm_90a in {time.perf_counter() - t0:.2f} s")
    for ln in ptxas_report(fused_rnn.BUILD_INFO.get("ptxas", "")):
        log(2, f"  ptxas: {ln}")
    smem = ctypes.CDLL(lib_path).fused_rnn_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    log(2, f"  dynamic shared memory per CTA: {smem(DCUT, 1)} B at dcut {DCUT} (chain), "
           f"{smem(16, 2)} B at dcut 16 with 2 predecessors")

    # ---- 3. kernel vs plain version on the card ----
    params = load_params(os.path.join(here, "checkpoints", "fe2s2_dcut48_final.pkl"))
    model = GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device=dev).load_numpy_params(params)
    rng = np.random.default_rng(0)
    rows = torch.as_tensor(rand_dets(rng, 65536, SORB, NOA, NOB), device=dev)
    # f32: the two versions differ only in summation order (a few ulps
    # per site, 20 sites).  bf16: both round W and h to bf16, but an
    # f32 difference of one ulp can move h across a bf16 rounding
    # boundary (a 2^-8 relative step) and such steps compound over the
    # sites, most on random rows of small amplitude
    tol = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-1, 1e-1)}

    def compare(name, m, x, mm):
        k = fused_rnn.graph_mpsrnn_logpsi_fused(m, x, matmul_dtype=mm)
        p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, x, matmul_dtype=mm)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k).all()), f"{name}: non-finite kernel output")
        da, dp = phase_err(k, p)
        ta, tp = tol[mm]
        log(3, f"{name} {str(mm).split('.')[-1]} rows {x.shape[0]}: max|Δlog|ψ|| {da:.3e} "
               f"(tol {ta:g}), max phase distance {dp:.3e} (tol {tp:g})")
        check(da <= ta and dp <= tp, f"{name}: kernel disagrees with its plain version")

    for mm in (torch.float32, torch.bfloat16):
        compare("fe2s2 dcut48 chain arg/mpsrnn", model, rows, mm)
    ref = model.log_psi(rows[:4096]).detach()
    da, dp = phase_err(fused_rnn.graph_mpsrnn_logpsi_fused(
        model, rows[:4096], matmul_dtype=torch.float32), ref)
    log(3, f"f32 kernel vs model.log_psi on 4096 rows: max|Δlog|ψ|| {da:.3e}, "
           f"max phase distance {dp:.3e} (tol 1e-4 / 1e-3)")
    check(da <= 1e-4 and dp <= 1e-3, "kernel disagrees with model.log_psi")
    g = torch.Generator().manual_seed(1)
    dag = GraphMPSRNN(SORB, NOA, NOB, dcut=16, graph=grid_snake_graph(4, 5),
                      phase_mode="arg", norm_mode="mpsrnn", dtype=torch.float32,
                      device=dev, generator=g)
    for mm in (torch.float32, torch.bfloat16):
        compare("dag grid 4x5 dcut16", dag, rows[:8192], mm)
    lin = GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, phase_mode="linear", norm_mode="unit",
                      dtype=torch.float32, device=dev, generator=g)
    for mm in (torch.float32, torch.bfloat16):
        compare("chain dcut48 linear/unit", lin, rows[:8192], mm)

    # ---- system: bench.py's stand-in for the absent Fe2S2 integrals ----
    irng = np.random.default_rng(0)
    h1e = irng.standard_normal((SORB, SORB)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = irng.standard_normal(triangle_size(SORB)) * 0.01
    system = System.from_integrals(h1e, h2e, SORB, NOA, NOB)
    tabs = system.tables(dev, torch.float32)
    table = system.excitation

    # ---- 4. local-energy identity ----
    gen = torch.Generator(device=dev).manual_seed(2)
    sbits, counts, _ = ar_sampling_dfs(model, 1_000_000, capacity=4096, n_group=4,
                                       split_depth=6, capacity_root=4096, generator=gen)
    sbits, _ = compact_by_count(sbits, counts, 64)
    f32fwd = lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=torch.float32)  # noqa: E731
    e_simple = local_energy_simple(f32fwd, sbits, tabs.astuple(), table,
                                   hpair_sect=tabs.hpair_sect)
    e_reduce = local_energy_reduce(f32fwd, sbits, tabs.astuple(), table, gen,
                                   k_det=table.n_sd, n_stoch=N_STOCH,
                                   hpair_sect=tabs.hpair_sect)
    torch.cuda.synchronize()
    # tolerance: f32 sums of 1 + n_sd terms in two orders differ by a
    # few ulps of Σ|h r|; allow 1e-4 · Σ|h r| per row
    comb, hij = comb_hij(sbits, *tabs.astuple(), tabs.hpair_sect, table=table)
    lp = f32fwd(comb.reshape(-1, SORB)).reshape(comb.shape[0], comb.shape[1], 2)
    rr, ri = ratio_re_im(lp, lp[:, :1])
    scale = (hij.abs() * torch.sqrt(rr**2 + ri**2)).sum(-1)
    diff = (e_simple - e_reduce).abs().max(-1).values
    check(bool(torch.isfinite(e_simple).all()), "non-finite SIMPLE energies")
    log(4, f"REDUCE(k_det=n_sd={table.n_sd}) vs SIMPLE on 64 sampled rows: "
           f"max|Δ| {diff.max().item():.3e}, max |Δ|/Σ|h r| "
           f"{(diff / scale).max().item():.3e} (tol 1e-4)")
    check(bool((diff <= 1e-4 * scale).all()), "REDUCE(k_det=n_sd) != SIMPLE")

    # ---- 5. three VMC steps, flagship configuration ----
    sampler = ARSampler(SORB, NOA, NOB, n_sample=1_000_000, capacity=4096,
                        dfs_n_group=4, dfs_split_depth=6, dfs_capacity_root=4096,
                        max_unique=B)
    vmc = VMC(model, system, sampler, VMCConfig(
        lr=1e-4, eloc_method="reduce", eloc_k_det=K_DET, eloc_n_stoch=N_STOCH,
        eloc_topk="segmax", clip_grad=1.0))
    gen = torch.Generator(device=dev).manual_seed(4)
    fbits, fw, _ = sampler.sample(model, gen)
    e_mm = {}
    # the rows one step's eloc forward hands the kernel, drawn from the
    # checkpoint's state before any training step, so that they are the
    # same in every run (phase 6 uses them)
    step_rows = []

    for mm in (torch.bfloat16, torch.float32):
        gen_e = torch.Generator(device=dev).manual_seed(5)  # same tail draws

        def fwd(b, mm=mm):
            step_rows.append(b)
            return fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=mm)

        el = local_energy_reduce(fwd, fbits, tabs.astuple(), table, gen_e, k_det=K_DET,
                                 n_stoch=N_STOCH, hpair_sect=tabs.hpair_sect, topk="segmax")
        e_mm[mm] = (fw @ el[:, 0].to(fw.dtype)).item()
    log(5, f"mean E_loc on one fixed batch: bf16 kernel {e_mm[torch.bfloat16]:.6f}, "
           f"f32 kernel {e_mm[torch.float32]:.6f}, difference "
           f"{(e_mm[torch.bfloat16] - e_mm[torch.float32]) * 1e3:+.4f} mHa")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(3)
    steps = []
    fused_rnn.LAUNCHES.reset()

    def cb(it, info):
        torch.cuda.synchronize()
        info["launches"] = fused_rnn.LAUNCHES.n
        info["iter_time"] = time.perf_counter() - cb.t0
        steps.append(info)
        log(5, f"step {it}: E {info['energy_total']:.6f} w_sum {info['w_sum']:.6f} "
               f"dropped_frac {info['dropped_frac']:.3e} n_unique {info['n_unique']:.0f} "
               f"wall {info['iter_time']:.3f} s kernel launches so far {info['launches']}")
        cb.t0 = time.perf_counter()

    cb.t0 = time.perf_counter()
    vmc.run(gen, 3, callback=cb)
    launches = fused_rnn.LAUNCHES.n
    check(launches > 0, "the VMC steps never launched the fused kernel")
    check(all(np.isfinite(s["energy_total"]) and s["w_sum"] > 0 for s in steps),
          "non-finite energy or dead sampler")
    log(5, f"3 steps done: kernel launches {launches}; max_memory_allocated "
           f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # where one step's time goes: its stages once more, each synchronized
    (sb, sw, _), t_sample = timed(lambda: sampler.sample(model, gen))
    bf16fwd = lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=torch.bfloat16)  # noqa: E731
    el, t_eloc = timed(lambda: local_energy_reduce(
        bf16fwd, sb, tabs.astuple(), table, gen, k_det=K_DET, n_stoch=N_STOCH,
        hpair_sect=tabs.hpair_sect, topk="segmax"))
    _, t_grad = timed(lambda: energy_and_grad(model, sb, sw, el))
    log(5, f"one step's stages (host clock): sample {t_sample:.1f} ms, eloc {t_eloc:.1f} ms "
           f"(the fused kernel inside), gradient {t_grad:.1f} ms")
    # two more steps, the second under the profiler: the device time of
    # a step by kernel, and its share of an unprofiled step's wall time
    # (the profiler slows the host side, not the kernels)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, t_step = timed(lambda: vmc.step(gen, 1.0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = timed(lambda: vmc.step(gen, 1.0))
    kerns = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                   key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kerns) / 1e3
    log(5, f"step {t_step:.1f} ms wall; profiled step {t_prof:.1f} ms wall with "
           f"{sum(e.count for e in kerns)} kernels taking {busy:.1f} ms of device time: "
           f"the device is busy {busy / t_step:.1%} of an unprofiled step")
    for e in kerns[:8]:
        log(5, f"  {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:70]}")

    # ---- 6. the kernel on one step's rows: agreement and timing ----
    trows = step_rows[0]
    n_rows = trows.shape[0]
    check(n_rows == B * (1 + K_DET + N_STOCH), f"one eloc forward of {n_rows} rows")
    tables = fused_rnn.pack_tables(model)
    times, errs = {}, {}
    for mm in (torch.bfloat16, torch.float32):
        kern = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused(model, trows, matmul_dtype=mm, tables=tables)  # noqa: E731
        plain = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, trows, matmul_dtype=mm, tables=tables)  # noqa: E731
        k_out, p_out = kern(), plain()
        torch.cuda.synchronize()
        da, dp = phase_err(k_out, p_out)
        ta, tp = tol[mm]
        log(6, f"step rows {str(mm).split('.')[-1]} rows {n_rows}: max|Δlog|ψ|| {da:.3e} "
               f"(tol {ta:g}), max phase distance {dp:.3e} (tol {tp:g})")
        check(bool(torch.isfinite(k_out).all()) and da <= ta and dp <= tp,
              "kernel disagrees with its plain version on the step's rows")
        errs[mm] = da
        # alternate plain, kernel, kernel, plain
        p1 = cuda_ms(plain, 2)
        k1 = cuda_ms(kern, 5)
        k2 = cuda_ms(kern, 5)
        p2 = cuda_ms(plain, 2)
        times[mm] = ((k1 + k2) / 2, (p1 + p2) / 2)
    norb = SORB // 2
    K, O = 2 * DCUT, 2 * DCUT
    # per row and site: 4 values x [K] x [O] products (2 FLOP each), the
    # bias, square and eta-weighted sums of 4 x [O], and the readout
    flop = n_rows * norb * (2 * 4 * O * K + 3 * 4 * O + 4 * O)
    # bits in, (log|ψ|, arg ψ) out, each table read once
    table_bytes = sum(t.numel() for t in tables.values()) * 4
    nbytes = {
        mm: n_rows * SORB + n_rows * 2 * 4 + table_bytes
        - (tables["W"].numel() * 2 if mm == torch.bfloat16 else 0)
        for mm in times
    }
    peak = {torch.bfloat16: H100_BF16_FLOPS, torch.float32: H100_F32_FLOPS}
    op_ms = {mm: flop / peak[mm] * 1e3 for mm in times}
    byte_ms = {mm: nbytes[mm] / H100_BYTES * 1e3 for mm in times}
    bound = {mm: max(op_ms[mm], byte_ms[mm]) for mm in times}
    for mm, (k, p) in times.items():
        log(6, f"fused forward {str(mm).split('.')[-1]} at {n_rows} rows: kernel {k:.3f} ms, "
               f"plain {p:.3f} ms, bound {bound[mm]:.3f} ms ({flop / 1e12:.3f} TFLOP, "
               f"{nbytes[mm] / 1e6:.1f} MB), {flop / k / 1e9:.2f} TFLOP/s; gpu {smi}")
    summary = {"kernels": [{
        "name": "fused_rnn_forward",
        "route": "cuda",
        "source": "pynqs_tpu_torch/csrc/fused_rnn.cu",
        "replaces": "pynqs_tpu/ops/fused_rnn.py:197",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16],
        "ms": times[torch.bfloat16][0],
        "plain_ms": times[torch.bfloat16][1],
        "bound_ms": bound[torch.bfloat16],
        "bound_by": "operations" if op_ms[torch.bfloat16] >= byte_ms[torch.bfloat16] else "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(summary))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
