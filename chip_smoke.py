#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (and a few detail lines):
  1. environment probe (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build of the CUDA kernels, one nvcc per source, started together
     (pynqs_tpu_torch/csrc/fused_rnn_mma.cu: the fused forward's and the
     prefix-sharing parent and child passes' bf16 mode on the tensor
     cores; csrc/fused_rnn.cu: their f32 mode on the CUDA cores;
     csrc/pair_select.cu: the doubles pair selection), with the
     compiler's register report of every instantiation and the shared
     memory of each fused launch, the tensor-core kernel's at the chain
     and r5g64 shapes and the prefix passes' at the step's row counts;
  3. the fused forward against its plain torch version on the card (bf16
     through the tensor-core kernel, f32 through the CUDA-core one): the
     dcut-48 Fe2S2 chain (checkpoints/fe2s2_dcut48_final.pkl; sorb 40,
     15α/15β) on 65,536 random valid rows in f32 and bf16, a small DAG
     model, the linear/unit modes, and the structured r5g64 flagship
     (dcut 64, tensor coupling, 2 predecessors; weights of
     checkpoints/fe2s2_r3_dcut64_r5g64.pkl on the stand-in graph) on
     65,536 rows, each comparison held by ``hold_rows``;
  4. local-energy identity: REDUCE with k_det = n_sd equals SIMPLE;
  5. three VMC steps in the flagship configuration (DFS sampling n=1e6,
     capacity 4096, 4 groups, split depth 6, compacted to B = 2048;
     REDUCE k_det 256 / n_stoch 64, segmax; seeded random integrals of
     the Fe2S2 shape), through the tensor-core kernel (checked by its
     launch count, as in phases 7 and 10);
  6. the kernel on the 657,408 rows of one step's eloc forward (captured
     in phase 5): agreement with the plain version, then CUDA-event
     times beside the card's bound: in bf16 of the tensor-core kernel,
     of the CUDA-core kernel in bf16 (``_launch_simt``, its time before
     the tensor cores) and of the plain version; in f32 of the CUDA-core
     kernel and the plain version;
  7. three VMC steps of the r5g64 flagship in the same configuration,
     through the tensor-core kernel's tensor coupling; the kernel on one
     step's rows, held and timed as in phase 6, with W's L2 traffic;
  8. the prefix-sharing path (VMCConfig.eloc_prefix) on the dcut-48
     chain, on one step's rows: in bf16 the tensor-core parent and child
     passes held to their plain versions (``hold_rows``) and bit for bit
     equal to the flat tensor-core kernel on the same rows; in f32 the
     CUDA-core passes against their plain versions and the flat
     CUDA-core kernel; REDUCE with and without it, three VMC steps
     through it (the tensor-core passes' launches counted), the site-steps
     the child's CTAs run, and CUDA-event times of each pass (in bf16 the
     tensor-core kernel, the CUDA-core kernel in bf16 and the plain
     version) and of both whole forwards;
  9. the doubles pair selection W[b,u,v] = hpair[po[b,u], pv[b,v]] at
     the flagship's [2048, 435, 45]: both variants of the band kernel
     bitwise equal to the plain version (pair indices of phase 5's
     samples and random ones, the system's symmetric hpair and a random
     asymmetric one) and to the earlier gather kernel; per variant
     (pynqs_tpu_torch/scripts/time_pair_select.measure) the wrapper
     call's CUDA-event time, the kernel's device time alone (profiler),
     the wrapper's host time per call, the same three of the earlier
     gather kernel, the plain version and one PyTorch gather beside the
     bound, and the L2 sectors the gather must touch;
     pair_select_w(variant="rowrow") once on the samples, its launch
     counted; then comb_hij on the 2048 samples, the dense pair matrix
     through the kernel bitwise equal to the sector blocks, both timed;
 10. the final-state evaluation (pynqs_tpu_torch/scripts/
     eval_fe2s2_final.evaluate) of the r5g64 flagship at full width: DFS
     sampling as phase 5 (at most 16,384 rows), REDUCE E_loc and the
     spin-raising monitor <S-S+> with k_det 1024 / n_stoch 256 in chunks
     of 256 samples, both through the dense pair matrix, bf16 forward,
     one repetition, its launches counted; the same rep again with each
     stage synchronized at every call, for the time split between the
     pair selection, comb_hij and the fused forward; both variants of the
     pair selection at the evaluation's chunk shape, bitwise and timed as
     in phase 9;
 11. the flagship training run (pynqs_tpu_torch/scripts/fe2s2_r3_push.main)
     at the script's defaults: dcut 96 warm-started from
     checkpoints/fe2s2_r2_dcut96_final.pkl, n = 2e6 in 8 groups, REDUCE
     k_det 512 / n_stoch 128 in chunks of 4096 samples, AdamW on the
     exp schedule, bf16, with --split-depth auto --exact-weights --ema
     0.999 --ckpt-interval 2 --iters 4 (the stand-in integrals written to
     a .pth file and read through the script's default system path):
     every step finite, w_sum 1, at the schedule's lr, its eloc forwards
     through the tensor-core kernel; the exact weights against the f32
     kernel's |psi|^2; one step's stages; kernel #1 at dp 96 on one eloc
     chunk's rows held to its plain version and timed, with ptxas'
     registers and spills; a resume from iteration 2's checkpoint (state
     restored bit for bit, 2 more steps); the evaluation's main on the
     saved EMA state (kernel #4 launched).

The last two lines are the kernels' JSON summary and the result JSON.
Any failed check raises, so the script exits non-zero with no result.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SORB, NOA, NOB, DCUT = 40, 15, 15, 48
DCUT_R5, MAXP_R5, DCMP_R5 = 64, 2, 4  # the r5g64 structured flagship
B, K_DET, N_STOCH = 2048, 256, 64
N_CMP, N_REF = 65536, 4096  # rows of the phase-3 comparisons
N_ID = 64  # sampled rows of the phase-4 identity
N_RED = 512  # sampled rows of the phase-8 REDUCE comparison
STEPS = 3
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES = 3.35e12  # HBM3 bytes/s
DEV = "cuda"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_info():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def reset_peak():
    torch.cuda.reset_peak_memory_stats()


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30


def rand_dets(rng, n, sorb, noa, nob):
    """n random determinants with noa alpha and nob beta electrons."""
    norb = sorb // 2
    out = np.zeros((n, sorb), np.int8)
    for s, no in ((0, noa), (1, nob)):
        cols = np.argsort(rng.random((n, norb)), axis=1)[:, :no]
        rows = np.repeat(np.arange(n), no)
        out[rows, 2 * cols.ravel() + s] = 1
    return out


def row_errs(a, b):
    """Per row: (|Δ log|ψ||, |e^{iφ_a} − e^{iφ_b}|)."""
    a, b = a.reshape(-1, 2), b.reshape(-1, 2)
    return ((a[:, 0] - b[:, 0]).abs(),
            (torch.polar(torch.ones_like(a[:, 1]), a[:, 1])
             - torch.polar(torch.ones_like(b[:, 1]), b[:, 1])).abs())


def phase_err(a, b):
    """(max |Δ log|ψ||, max |e^{iφ_a} − e^{iφ_b}|)."""
    da, dp = row_errs(a, b)
    return da.max().item(), dp.max().item()


MED_TOL = 1e-4  # the median row's |Δlog|ψ|| and phase distance


def hold_rows(k, p, q, tol):
    """Hold a kernel's rows ``k`` [N, 2] against the plain version's ``p``
    at ``tol`` = (log|ψ| tol, phase tol); ``q`` is the plain version
    with f64 sums, which shows how far summation order alone moves each
    row.  Returns (ok, what was held, stats).

    Every row is held at the log|ψ| tolerance, and the median row at
    ``MED_TOL`` in both: summation order alone moves it by f32 ulps, a
    left-out bf16 rounding point by about a bf16 ulp.  Where ``q`` stays
    within the phase tolerance, every row is held there too.  Where it
    does not, the arg-mode phase of some rows is ill-conditioned (a
    product of unit complex numbers ẑ/|ẑ| with some |ẑ| near 0), any
    two summation orders can differ by up to 2 on such a row, and at
    most 1 row in 1000 may differ by more than the phase tolerance."""
    ta, tp = tol
    da, dp = row_errs(k, p)
    dq = row_errs(q, p)[1]
    st = {"max_a": da.max().item(), "max_p": dp.max().item(), "med_a": da.median().item(),
          "med_p": dp.median().item(), "q_max_p": dq.max().item(),
          "q_over": int((dq > tp).sum()), "over": int((dp > tp).sum())}
    ok = (bool(torch.isfinite(k).all()) and st["max_a"] <= ta
          and st["med_a"] <= MED_TOL and st["med_p"] <= MED_TOL)
    if st["q_max_p"] <= tp:
        return ok and st["max_p"] <= tp, "every row", st
    return ok and st["over"] <= k.shape[0] // 1000, "ill-conditioned", st


def ptxas_report(text):
    """One line per kernel instantiation of ``nvcc -Xptxas -v``'s report:
    its template arguments, registers and spills."""
    out, name, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", m.group(1))
            w = re.search(r"fused_rnn_mma_kernelILi(\d+)ELi(\d+)ELi(\d+)EE", m.group(1))
            u = re.search(r"pair_select_(band|gather)I([fd])([il])Lb([01])E", m.group(1))
            if w:
                mode = ("flat forward", "prefix parent", "prefix child")[int(w.group(3))]
                warps = (f"{w.group(2)} warps of 16 rows" if w.group(2) != "0"
                         else "warps of 16 rows set at launch")
                name = (f"tensor cores, {mode}, O {16 * int(w.group(1))} outputs (dp "
                        f"{8 * int(w.group(1))}), {warps}")
            elif t:
                name = (f"rows/warp {t.group(1)}, outputs/lane {t.group(2)}, "
                        f"W {'bf16' if t.group(3) == '1' else 'f32'}")
            elif u:
                name = (f"{u.group(1)} kernel, {'f32' if u.group(2) == 'f' else 'f64'}, "
                        f"{'int32' if u.group(3) == 'i' else 'int64'} indices, "
                        f"{'rowrow' if u.group(4) == '1' else 'lane'}")
            else:
                name = m.group(1)
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers{m.group(2)}; {spill}")
            name = None
    return out


def build(fused_rnn, pair_select):
    """Build the kernels, one nvcc per source, all started together;
    return a function (d, mp, dcut_cmpr) -> the dynamic shared memory of
    one launch of the CUDA-core fused kernel in bytes."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        fut = pool.submit(fused_rnn.build_kernel)
        fut_mma = pool.submit(fused_rnn.build_mma_kernel)
        pool.submit(pair_select.build_kernel).result()
        fut_mma.result()
        lib_path = fut.result()
    smem = ctypes.CDLL(lib_path).fused_rnn_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return smem


def flagship_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed):
    """Phase 11: ``pynqs_tpu_torch/scripts/fe2s2_r3_push.main`` at the
    script's defaults (dcut 96 warm-started from
    checkpoints/fe2s2_r2_dcut96_final.pkl, n = 2e6 in 8 groups, REDUCE
    k_det 512 / n_stoch 128, AdamW on the exp schedule, bf16) with the
    split depth tuned, exact weights, the EMA and a checkpoint every 2 of
    4 iterations, on stand-in integrals written to a .pth file and read
    through the default system path; a resume from the iteration-2
    checkpoint for 2 more; the evaluation's ``main`` on the saved EMA
    state; kernel #1 at dp 96 on one eloc chunk's rows.  Writes only in
    a temporary directory."""
    import shutil
    import tempfile

    from pynqs_tpu_torch.energy.eloc import local_energy_reduce
    from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
    from pynqs_tpu_torch.ops import cuda_build, fused_rnn
    from pynqs_tpu_torch.ops import pair_select as ps
    from pynqs_tpu_torch.ops.integrals import triangle_size
    from pynqs_tpu_torch.optim import vmc as vmc_mod
    from pynqs_tpu_torch.optim.schedule import exponential_decay
    from pynqs_tpu_torch.scripts import eval_fe2s2_final, fe2s2_r3_push
    from pynqs_tpu_torch.utils import flagship
    from pynqs_tpu_torch.utils.checkpoint import load_checkpoint
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bf16 = torch.bfloat16
    work = tempfile.mkdtemp(prefix="chip_smoke_flagship_")
    saved = (flagship.FE2S2_PTH, vmc_mod.VMC.step, vmc_mod.save_checkpoint)
    steps, copies = [], []

    def step(self, generator, clip_val, sampler=None):
        """VMC.step, synchronized and recorded (host clock)."""
        sync()
        t = time.perf_counter()
        out = saved[1](self, generator, clip_val, sampler)
        sync()
        steps.append({"s": time.perf_counter() - t, "count": self.count - 1, "lr": out["lr"],
                      "energy": float(out["energy"]), "w_sum": float(out["w_sum"]),
                      "dropped": float(out["dropped_frac"]),
                      "n_unique": int(out["n_unique"])})
        return out

    def save_checkpoint(path, step_, *a, **k):
        """save_checkpoint, keeping a copy of each file written."""
        saved[2](path, step_, *a, **k)
        copies.append((step_, f"{os.path.splitext(path)[0]}_{len(copies)}.pkl"))
        shutil.copy(path, copies[-1][1])

    try:
        # the stand-in integrals (as the other phases) in a molecule file
        irng = np.random.default_rng(0)
        h1e = irng.standard_normal((SORB, SORB)) * 0.1
        h1e = (h1e + h1e.T) / 2
        h2e = irng.standard_normal(triangle_size(SORB)) * 0.01
        pth = os.path.join(work, "fe2s2-standin.pth")
        torch.save({"h1e": torch.as_tensor(h1e.ravel()), "h2e": torch.as_tensor(h2e),
                    "sorb": SORB, "noa": NOA, "nob": NOB, "ecore": 0.0}, pth)
        flagship.FE2S2_PTH = pth
        vmc_mod.VMC.step = step
        vmc_mod.save_checkpoint = save_checkpoint
        extra = ["--split-depth", "auto", "--exact-weights", "--ema", "0.999",
                 "--ckpt-interval", "2", "--iters", "4", "--tag", "smoke"]
        a = fe2s2_r3_push.parser().parse_args(extra)
        log(11, f"fe2s2_r3_push.main({' '.join(extra)}), defaults: dcut {a.dcut}, from "
                f"{os.path.relpath(a.from_ckpt, here)}, n_sample {a.n_sample}, capacity "
                f"{a.capacity}, {a.n_group} groups, capacity-root {a.capacity_root}, max-unique "
                f"{a.max_unique}, eloc-batch {a.eloc_batch}, grad-batch {a.grad_batch}, k_det "
                f"{a.k_det}, n_stoch {a.n_stoch}, topk {a.topk}, AdamW exp {a.lr:g} -> "
                f"{a.lr_end:g}, clip {a.clip:g}, {a.fwd_dtype}; no cut")
        counters = {"fused": fused_rnn.LAUNCHES, "fused_mma": fused_rnn.MMA_LAUNCHES}
        for c in counters.values():
            c.reset()
        reset_peak()
        t0 = time.perf_counter()
        r1 = fe2s2_r3_push.main(extra, device=dev, root=work)
        sync()
        wall1 = time.perf_counter() - t0
        l1 = {k: c.n for k, c in counters.items()}
        peak1 = peak_gib()
        live, kept = r1["profile"]
        log(11, f"tuned split depth {r1['split_depth']}; live prefixes by depth "
                f"{live.tolist()}; kept mass by depth {kept.tolist()}")
        check(r1["split_depth"] >= 1 and len(live) == SORB // 2 - 1,
              "no split depth tuned from the live profile")
        sched1 = exponential_decay(a.lr, 4, a.lr_end / a.lr)
        for st in steps:
            log(11, f"step count {st['count']}: E {st['energy']:.6f} w_sum {st['w_sum']:.8f} "
                    f"lr {st['lr']:.6e} dropped {st['dropped']:.3e} live {st['n_unique']} "
                    f"wall {st['s']:.3f} s")
        check(len(steps) == 4 and [st["count"] for st in steps] == [0, 1, 2, 3],
              "the run took other than 4 steps")
        check(all(np.isfinite(st["energy"]) and abs(st["w_sum"] - 1.0) <= 1e-5
                  for st in steps), "non-finite energy or w_sum != 1")
        check(all(st["lr"] == sched1(st["count"]) for st in steps),
              "the lr of a step is not the schedule at its count")
        check(l1["fused_mma"] > 0 and l1["fused_mma"] == l1["fused"],
              f"the training run's eloc forwards did not all go through the tensor-core "
              f"kernel: {l1}")
        s_step = float(np.mean([st["s"] for st in steps[1:]]))
        log(11, f"4 steps at dcut {a.dcut} in {wall1:.1f} s with set-up; {s_step:.3f} s/step (host "
                f"clock to torch.cuda.synchronize(), steps 1-3; step 0 {steps[0]['s']:.3f} s); "
                f"tensor-core kernel launches {l1['fused_mma']}; max_memory_allocated "
                f"{peak1:.3f} GiB; gpu {smi}")

        v = r1["vmc"]
        m = v.model
        # the exact weights: normalized |ψ|² of the live rows, against the
        # f32 kernel's log|ψ| (the sampler takes model.log_psi)
        g = torch.Generator(device=dev).manual_seed(12)
        (sb, sw, diag), t_sample = timed(lambda: v.sampler.sample(m, g))
        live_rows = sw > 0
        lp = fused_rnn.graph_mpsrnn_logpsi_fused(m, sb[live_rows], matmul_dtype=torch.float32)
        lp = lp[:, 0].double()
        w_ref = torch.exp(2.0 * (lp - lp.max()))
        w_ref = w_ref / w_ref.sum()
        w_live = sw[live_rows].double()
        big = w_ref > 1e-6 * w_ref.max()
        rel = ((w_live[big] / w_ref[big]) - 1).abs().max().item()
        l1_err = (w_live - w_ref).abs().sum().item()
        log(11, f"exact weights on {int(live_rows.sum())} live rows (n_unique "
                f"{int(diag['n_unique'])}): max relative difference from the f32 kernel's "
                f"|psi|^2 {rel:.3e} (tol 1e-3), sum |dw| {l1_err:.3e} (tol 1e-3)")
        check(int(live_rows.sum()) == int(diag["n_unique"]) and rel <= 1e-3 and l1_err <= 1e-3,
              "the exact weights are not the normalized |psi|^2 of the live rows")
        # one step's stages, each synchronized
        fwd = v._eloc_forward()
        kw = dict(k_det=v.cfg.eloc_k_det, n_stoch=v.cfg.eloc_n_stoch, batch=v.cfg.eloc_batch,
                  hpair=v._hpair, topk=v.cfg.eloc_topk)
        el, t_eloc = timed(lambda: local_energy_reduce(fwd, sb, v._ops, v._table, g, **kw))
        _, t_grad = timed(lambda: energy_and_grad(m, sb, sw, el, grad_batch=v.cfg.grad_batch))
        log(11, f"one step's stages (host clock, {sb.shape[0]} rows, {int(live_rows.sum())} "
                f"live): sample with exact weights {t_sample:.1f} ms, eloc {t_eloc:.1f} ms, "
                f"gradient {t_grad:.1f} ms; gpu {smi}")
        # one more step under the profiler: the device's busy share
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, t_prof = timed(lambda: saved[1](v, g, v.cfg.clip_grad))
        kerns = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kerns) / 1e3
        log(11, f"profiled step {t_prof:.1f} ms wall, {sum(e.count for e in kerns)} kernels "
                f"taking {busy:.1f} ms of device time: busy {busy / (1e3 * s_step):.1%} of an "
                f"unprofiled step ({s_step:.3f} s)")
        for e in kerns[:6]:
            log(11, f"  {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:70]}")

        # kernel #1 at dp 96 on one eloc chunk's rows
        seen = []

        def capture(b):
            seen.append(b)
            return fwd(b)

        local_energy_reduce(capture, sb[:v.cfg.eloc_batch], v._ops, v._table,
                            torch.Generator(device=dev).manual_seed(13), **kw)
        trows = seen[0]
        n_rows = trows.shape[0]
        T = fused_rnn.pack_tables(m)
        T64 = {key: t.double() for key, t in T.items()}
        CH = 1 << 18

        def plain(tables=T):
            return torch.cat([fused_rnn.graph_mpsrnn_logpsi_fused_plain(
                m, trows[i:i + CH], matmul_dtype=bf16, tables=tables)
                for i in range(0, n_rows, CH)])

        kern = lambda: fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=bf16, tables=T)  # noqa: E731
        k_out, p_out = kern(), plain()
        sync()
        ok, held, st = hold_rows(k_out, p_out, plain(T64), tol[bf16])
        log(11, f"kernel #1 dp {fused_rnn.mma_width(a.dcut)} vs plain on {n_rows} rows: max|dlog|psi|| {st['max_a']:.3e} "
                f"(tol {tol[bf16][0]:g}), max phase distance {st['max_p']:.3e}, median row "
                f"{st['med_a']:.3e} / {st['med_p']:.3e}; plain with f64 sums vs plain: max phase "
                f"distance {st['q_max_p']:.3e}; held: {held} (rows over {tol[bf16][1]:g}: "
                f"{st['over']}, plain f64 {st['q_over']})")
        check(ok, "kernel #1 at dp 96 disagrees with its plain version")
        err = st["max_a"]
        del k_out, p_out
        simt = lambda: fused_rnn._launch_simt(m, trows, T)  # noqa: E731
        s1 = cuda_ms(simt, 1)
        p1 = cuda_ms(plain, 1)
        k1 = cuda_ms(kern, 3)
        k2 = cuda_ms(kern, 3)
        p2 = cuda_ms(plain, 1)
        prev = (s1 + cuda_ms(simt, 1)) / 2
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = n_rows * (SORB // 2) * flop_per_site(a.dcut, 1)
        b11 = bound(flop, n_rows * SORB + n_rows * 2 * 4 + table_bytes(T, bf16), bf16)
        regs = [ln for ln in ptxas_report(cuda_build.BUILD_INFO.get("fused_rnn_mma", ""))
                if "(dp 96)" in ln]
        for ln in regs:
            log(11, f"  ptxas fused_rnn_mma: {ln}")
        flat96 = [ln for ln in regs if "flat forward" in ln]
        n_reg = int(re.search(r": (\d+) registers", flat96[0]).group(1)) if flat96 else None
        sp = re.search(r"spill stores (\d+) B, loads (\d+) B", flat96[0]) if flat96 else None
        spill = [int(sp.group(1)), int(sp.group(2))] if sp else [0, 0]
        sh = fused_rnn.mma_launch_shape(m)
        log(11, f"fused forward bf16 dp {fused_rnn.mma_width(a.dcut)} at {n_rows} rows: tensor-core kernel {k_ms:.3f} ms "
                f"({flop / k_ms / 1e9:.2f} TFLOP/s), CUDA-core kernel {prev:.3f} ms "
                f"({prev / k_ms:.2f}x), plain {p_ms:.3f} ms (in chunks of {CH}), bound "
                f"{b11[0]:.3f} ms ({b11[1]}; {flop / 1e12:.3f} TFLOP); {16 * sh['warps']} rows "
                f"per CTA, {sh['smem_bytes']} B shared memory; registers {n_reg}, spill "
                f"stores/loads {spill} B; gpu {smi}")
        del trows, seen

        # resume from the checkpoint written after iteration 2
        check([it for it, _ in copies] == [1, 3],
              f"checkpoints written at iterations {[it for it, _ in copies]}")
        ck_path = copies[0][1]  # written after iteration 2
        n_before = len(steps)
        reset_peak()
        extra2 = ["--split-depth", str(r1["split_depth"]), "--exact-weights", "--ema", "0.999",
                  "--ckpt-interval", "2", "--iters", "2", "--tag", "smoke", "--resume", ck_path]
        for c in counters.values():
            c.reset()
        r2 = fe2s2_r3_push.main(extra2, device=dev, root=work)
        sync()
        l2 = {k: c.n for k, c in counters.items()}
        v2 = r2["vmc"]
        resumed = steps[n_before:]
        sched2 = exponential_decay(a.lr, 2, a.lr_end / a.lr)
        for st in resumed:
            log(11, f"resumed step count {st['count']}: E {st['energy']:.6f} w_sum "
                    f"{st['w_sum']:.8f} lr {st['lr']:.6e} wall {st['s']:.3f} s")
        check([st["count"] for st in resumed] == [2, 3], "the resume did not restore count 2")
        check(all(np.isfinite(st["energy"]) and abs(st["w_sum"] - 1.0) <= 1e-5
                  and st["lr"] == sched2(st["count"]) for st in resumed),
              "a resumed step is not finite or not at the schedule's lr")
        ck = load_checkpoint(ck_path)
        check(v2.history[:2] == ck["history"] == r1["history"][:2] and len(v2.history) == 4,
              "the resumed history does not continue the file's")
        check(l2["fused_mma"] > 0 and l2["fused_mma"] == l2["fused"],
              f"the resumed steps did not launch the tensor-core kernel alone: {l2}")
        # the restore itself, bit for bit, on the resumed run's objects
        v2.restore(ck_path)
        adam = ck["opt_state"][0]  # the port writes optax's leaf order: (count, mu, nu)
        bad = []
        for key, p in v2.model.named_parameters():
            stt = v2.opt.state[p]
            for what, x, y in (("params", p, ck["params"][key]), ("ema", v2.ema_params[key],
                                                                  ck["ema"][key]),
                               ("exp_avg", stt["exp_avg"], adam[1][key]),
                               ("exp_avg_sq", stt["exp_avg_sq"], adam[2][key])):
                if not np.array_equal(x.detach().cpu().numpy(), y):
                    bad.append((key, what))
            if int(stt["step"]) != int(adam[0]):
                bad.append((key, "step"))
        check(not bad and v2.count == int(ck["opt_state"][2][0]) == 2
              and v2.history == ck["history"],
              f"the restore is not bit for bit the file's: {bad[:4]}")
        log(11, f"resume from iteration 2's checkpoint: parameters, EMA, AdamW moments and "
                f"step ({int(adam[0])}), schedule count {v2.count} and history restored bit for "
                f"bit; 2 resumed steps finite; launches {l2}; max_memory_allocated "
                f"{peak_gib():.3f} GiB")

        # the evaluation's main on the saved EMA state
        for c in (*ps.LAUNCHES.values(), *counters.values()):
            c.reset()
        ev_args = [r2["paths"]["ema"], "--dcut", str(a.dcut), "--n-sample", "1000000", "--n-group", "4",
                   "--split-depth", "6", "--capacity", "4096", "--batch", "256", "--n-rep", "1"]
        (rep,) = eval_fe2s2_final.main(ev_args, device=dev)
        sync()
        l3 = {"pair_select_lane": ps.LAUNCHES["lane"].n, **{k: c.n for k, c in counters.items()}}
        log(11, f"eval main (n 1e6, 4 groups at depth 6, k_det 1024 / n_stoch 256, batch 256, "
                f"1 rep) on the EMA state: E {rep.e:.6f} +- {rep.e_se:.2e}, <S-S+> {rep.s:.6f} "
                f"+- {rep.s_se:.2e}, {rep.seconds:.3f} s, live {rep.n_live}; launches {l3}; "
                f"gpu {smi}")
        check(np.isfinite(rep.e) and np.isfinite(rep.s), "non-finite evaluation")
        check(rep.s > -5 * rep.s_se, f"<S-S+> = {rep.s} below -5 se ({rep.s_se})")
        check(l3["pair_select_lane"] > 0 and l3["fused_mma"] > 0,
              f"the evaluation did not launch kernels #4 and #1: {l3}")
        return {"launches": l1["fused_mma"] + l2["fused_mma"], "err": err,
                "times": (k_ms, p_ms), "bound": b11, "prev_ms": prev, "registers": n_reg,
                "spill_bytes": spill}
    finally:
        flagship.FE2S2_PTH, vmc_mod.VMC.step, vmc_mod.save_checkpoint = saved
        shutil.rmtree(work, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pynqs_tpu_torch.energy import eloc as eloc_mod
    from pynqs_tpu_torch.energy.eloc import local_energy_reduce, local_energy_simple
    from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
    from pynqs_tpu_torch.ops import cuda_build, fused_rnn
    from pynqs_tpu_torch.ops import hamiltonian as ham_mod
    from pynqs_tpu_torch.ops import pair_select as ps
    from pynqs_tpu_torch.ops import fused_rnn_prefix as pre
    from pynqs_tpu_torch.ops.cplx import ratio_re_im
    from pynqs_tpu_torch.ops.hamiltonian import comb_hij, pair_indices
    from pynqs_tpu_torch.ops.integrals import triangle_size
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, compact_by_count
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
    from pynqs_tpu_torch.scripts import time_pair_select as tps
    from pynqs_tpu_torch.scripts.eval_fe2s2_final import evaluate
    from pynqs_tpu_torch.utils.flagship import flagship_model, load_flagship_params
    from pynqs_tpu_torch.utils.system import System

    dev = torch.device(DEV)
    here = os.path.dirname(os.path.abspath(__file__))
    bf16, f32 = torch.bfloat16, torch.float32

    def mmname(mm):
        return str(mm).split(".")[-1]

    # ---- 1. environment ----
    smi = gpu_info()
    try:
        nvcc = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True,
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

    # ---- system: bench.py's stand-in for the absent Fe2S2 integrals ----
    irng = np.random.default_rng(0)
    h1e = irng.standard_normal((SORB, SORB)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = irng.standard_normal(triangle_size(SORB)) * 0.01
    system = System.from_integrals(h1e, h2e, SORB, NOA, NOB)

    # ---- 2. build ----
    t0 = time.perf_counter()
    smem = build(fused_rnn, ps)
    log(2, f"built csrc/fused_rnn_mma.cu (the fused forward, prefix parent and child on the "
           f"tensor cores), csrc/fused_rnn.cu (the same on the CUDA cores) "
           f"and csrc/pair_select.cu (pair selection) for sm_90a in "
           f"{time.perf_counter() - t0:.2f} s")
    for name in ("fused_rnn_mma", "fused_rnn", "pair_select"):
        for ln in ptxas_report(cuda_build.BUILD_INFO.get(name, "")):
            log(2, f"  ptxas {name}: {ln}")
    log(2, f"  CUDA-core kernel, dynamic shared memory per CTA: {smem(DCUT, 1, 0)} B at dcut "
           f"{DCUT} (chain; the prefix passes too), {smem(DCUT_R5, MAXP_R5, DCMP_R5)} B at the "
           f"r5g64 shape (dcut {DCUT_R5}, {MAXP_R5} predecessors, dcut_cmpr {DCMP_R5}; limit "
           f"232,448 B), {smem(16, 2, 0)} B at dcut 16 with 2 predecessors")
    for what, m in (("chain dcut 48", GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, device=dev)),
                    ("r5g64 (dcut 64, tensor coupling, stand-in graph)",
                     flagship_model(system, DCUT_R5, use_tensor=True, max_preds=MAXP_R5,
                                    device=dev))):
        sh = fused_rnn.mma_launch_shape(m)
        log(2, f"  tensor-core kernel at {what}: dp {fused_rnn.mma_width(m.dcut)}, "
               f"{sh['warps']} warps = {16 * sh['warps']} rows per CTA, {sh['nslots']} hidden "
               f"slot(s) in {sh['slots']} memory, dynamic shared memory {sh['smem_bytes']} B "
               f"per CTA (3 weight stages of 24,576 B + the slots)")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chain_m = GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, device=dev)
    for what, n in (("parent", B), ("child", B * (K_DET + N_STOCH))):
        sh = fused_rnn.mma_launch_shape(chain_m, n, n_sm)
        log(2, f"  tensor-core prefix {what} pass at the chain step's {n} rows on {n_sm} SMs: "
               f"{sh['warps']} warp(s) = {16 * sh['warps']} rows per CTA, {sh['ctas']} CTAs, "
               f"dynamic shared memory {sh['smem_bytes']} B per CTA")
    del chain_m
    for v, what in (("lane", "occupied"), ("rowrow", "virtual")):
        sh = ps.pair_select_launch_shape(B, 435, 45, 4, v)
        log(2, f"  pair selection {v} at [{B}, 435, 45] f32: {sh['bands']} bands of "
               f"{sh['band']} {what} pairs per sample, one CTA of {sh['threads']} threads per "
               f"item ({sh['items']}), shared memory {sh['smem_bytes']} B per CTA")

    tabs = system.tables(dev, torch.float32)
    table = system.excitation
    ops = tabs.astuple()

    # ---- 3. kernel vs plain version on the card ----
    ck48 = os.path.join(here, "checkpoints", "fe2s2_dcut48_final.pkl")
    params = load_flagship_params(ck48)

    def chain48():
        return GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, phase_mode="arg", norm_mode="mpsrnn",
                           dtype=torch.float32, device=dev).load_numpy_params(params)

    model = chain48()
    rng = np.random.default_rng(0)
    rows = torch.as_tensor(rand_dets(rng, N_CMP, SORB, NOA, NOB), device=dev)
    # f32: the two versions differ only in summation order (a few ulps
    # per site, 20 sites).  bf16: both round W and h to bf16, but an
    # f32 difference of one ulp can move h across a bf16 rounding
    # boundary (a 2^-8 relative step) and such steps compound over the
    # sites, most on random rows of small amplitude
    tol = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-1, 1e-1)}

    def agree(phase, name, m, x, mm, k, p, tables=None):
        """``hold_rows`` of the kernel's rows ``k`` against the plain
        version's ``p``; returns max|Δlog|ψ||."""
        ta, tp = tol[mm]
        T = fused_rnn.pack_tables(m) if tables is None else tables
        q = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
            m, x, matmul_dtype=mm, tables={key: v.double() for key, v in T.items()})
        ok, held, st = hold_rows(k, p, q, tol[mm])
        del q
        msg = (f"{name} {mmname(mm)} rows {x.shape[0]}: max|Δlog|ψ|| {st['max_a']:.3e} "
               f"(tol {ta:g}), max phase distance {st['max_p']:.3e}, median row "
               f"{st['med_a']:.3e} / {st['med_p']:.3e} (tol {MED_TOL:g}); plain with f64 sums "
               f"vs plain: max phase distance {st['q_max_p']:.3e}")
        if held == "every row":
            msg += f"; every row held at {tp:g} in phase"
        else:
            msg += (f", {st['q_over']} rows over {tp:g}: ill-conditioned phases; kernel rows "
                    f"over {tp:g} {st['over']} (at most {x.shape[0] // 1000})")
        log(phase, msg)
        check(ok, f"{name}: kernel disagrees with its plain version")
        return st["max_a"]

    def compare(name, m, x, mm):
        before = fused_rnn.MMA_LAUNCHES.n
        k = fused_rnn.graph_mpsrnn_logpsi_fused(m, x, matmul_dtype=mm)
        p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, x, matmul_dtype=mm)
        sync()
        check(fused_rnn.MMA_LAUNCHES.n == before + (mm == bf16),
              f"{name} {mmname(mm)}: the tensor-core kernel ran in f32 or not in bf16")
        agree(3, name, m, x, mm, k, p)

    def compare_log_psi(name, m, x):
        ref = m.log_psi(x).detach()
        da, dp = phase_err(fused_rnn.graph_mpsrnn_logpsi_fused(m, x, matmul_dtype=f32), ref)
        log(3, f"{name}: f32 kernel vs model.log_psi on {x.shape[0]} rows: max|Δlog|ψ|| "
               f"{da:.3e}, max phase distance {dp:.3e} (tol 1e-4 / 1e-3)")
        check(da <= 1e-4 and dp <= 1e-3, f"{name}: kernel disagrees with model.log_psi")

    for mm in (f32, bf16):
        compare("fe2s2 dcut48 chain arg/mpsrnn", model, rows, mm)
    compare_log_psi("fe2s2 dcut48 chain", model, rows[:N_REF])
    g = torch.Generator().manual_seed(1)
    dag = GraphMPSRNN(SORB, NOA, NOB, dcut=16, graph=grid_snake_graph(4, 5),
                      phase_mode="arg", norm_mode="mpsrnn", dtype=torch.float32,
                      device=dev, generator=g)
    for mm in (f32, bf16):
        compare("dag grid 4x5 dcut16", dag, rows[:8192], mm)
    lin = GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, phase_mode="linear", norm_mode="unit",
                      dtype=torch.float32, device=dev, generator=g)
    for mm in (f32, bf16):
        compare("chain dcut48 linear/unit", lin, rows[:8192], mm)

    ck_r5 = os.path.join(here, "checkpoints", "fe2s2_r3_dcut64_r5g64.pkl")
    params_r5 = load_flagship_params(ck_r5)

    def r5g64():
        return flagship_model(system, DCUT_R5, use_tensor=True, max_preds=MAXP_R5,
                              device=dev).load_numpy_params(params_r5)

    r5 = r5g64()
    n_tensor = sum(len(p) >= 2 for p in r5.preds)
    log(3, f"r5g64: the trained graph came from the Fe2S2 exchange matrix, which is not in "
           f"the repository; the model is built on the stand-in integrals' graph "
           f"({n_tensor} of {r5.norb} sites with 2 predecessors), and the checkpoint's "
           f"weights load on it because their shapes depend only on the 2 predecessors")
    # with the r5g64 weights on the stand-in graph, the arg-mode phase of
    # some random rows is ill-conditioned (``agree`` shows it and holds
    # the rows accordingly)
    for mm in (f32, bf16):
        compare("r5g64 dcut64 tensor", r5, rows, mm)
    compare_log_psi("r5g64 dcut64 tensor", r5, rows[:N_REF])

    # ---- 4. local-energy identity ----
    gen = torch.Generator(device=dev).manual_seed(2)
    sbits, counts, _ = ar_sampling_dfs(model, 1_000_000, capacity=4096, n_group=4,
                                       split_depth=6, capacity_root=4096, generator=gen)
    sbits, _ = compact_by_count(sbits, counts, N_ID)
    f32fwd = lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=f32)  # noqa: E731
    e_simple = local_energy_simple(f32fwd, sbits, ops, table, hpair=tabs.hpair_sect)
    e_reduce = local_energy_reduce(f32fwd, sbits, ops, table, gen,
                                   k_det=table.n_sd, n_stoch=N_STOCH,
                                   hpair=tabs.hpair_sect)
    sync()

    def hr_scale(m, x):
        """Σ_m |h_nm| |ψ(m)/ψ(n)| per row over the whole connected space
        (f32 forward): the size of the terms an E_loc sums."""
        comb, hij = comb_hij(x, *ops, tabs.hpair_sect, table=table)
        lp = fused_rnn.graph_mpsrnn_logpsi_fused(
            m, comb.reshape(-1, SORB), matmul_dtype=f32).reshape(comb.shape[0], comb.shape[1], 2)
        rr, ri = ratio_re_im(lp, lp[:, :1])
        return (hij.abs() * torch.sqrt(rr**2 + ri**2)).sum(-1)

    # tolerance: f32 sums of 1 + n_sd terms in two orders differ by a
    # few ulps of Σ|h r|; allow 1e-4 · Σ|h r| per row
    scale = hr_scale(model, sbits)
    diff = (e_simple - e_reduce).abs().max(-1).values
    check(bool(torch.isfinite(e_simple).all()), "non-finite SIMPLE energies")
    log(4, f"REDUCE(k_det=n_sd={table.n_sd}) vs SIMPLE on {N_ID} sampled rows: "
           f"max|Δ| {diff.max().item():.3e}, max |Δ|/Σ|h r| "
           f"{(diff / scale).max().item():.3e} (tol 1e-4)")
    check(bool((diff <= 1e-4 * scale).all()), "REDUCE(k_det=n_sd) != SIMPLE")

    # ---- the flagship step configuration (phases 5, 7 and 8) ----
    sampler = ARSampler(SORB, NOA, NOB, n_sample=1_000_000, capacity=4096,
                        dfs_n_group=4, dfs_split_depth=6, dfs_capacity_root=4096,
                        max_unique=B)

    def config(**kw):
        return VMCConfig(lr=1e-4, eloc_method="reduce", eloc_k_det=K_DET,
                         eloc_n_stoch=N_STOCH, eloc_topk="segmax", clip_grad=1.0, **kw)

    def reduce(fwd, bits, g, **kw):
        return local_energy_reduce(fwd, bits, ops, table, g, k_det=K_DET, n_stoch=N_STOCH,
                                   hpair=tabs.hpair_sect, topk="segmax", **kw)

    def run_steps(phase, vmc, counters, seed):
        """STEPS training steps from a fresh launch count; returns the
        per-step infos with the counts after each step."""
        steps = []
        for c in counters.values():
            c.reset()

        def cb(it, info):
            sync()
            info["iter_time"] = time.perf_counter() - cb.t0
            info["launches"] = {k: c.n for k, c in counters.items()}
            steps.append(info)
            log(phase, f"step {it}: E {info['energy_total']:.6f} w_sum {info['w_sum']:.6f} "
                       f"dropped_frac {info['dropped_frac']:.3e} n_unique "
                       f"{info['n_unique']:.0f} wall {info['iter_time']:.3f} s launches so "
                       f"far {info['launches']}")
            cb.t0 = time.perf_counter()

        cb.t0 = time.perf_counter()
        vmc.run(torch.Generator(device=dev).manual_seed(seed), STEPS, callback=cb)
        check(all(np.isfinite(s["energy_total"]) and abs(s["w_sum"] - 1.0) <= 1e-5
                  for s in steps), "non-finite energy or w_sum != 1")
        return steps

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def stage_times(phase, m, fwd_kw):
        """One step's stages once more, each synchronized (host clock)."""
        g = torch.Generator(device=dev).manual_seed(8)
        (sb, sw, _), t_sample = timed(lambda: sampler.sample(m, g))
        el, t_eloc = timed(lambda: reduce(**fwd_kw(m), bits=sb, g=g))
        _, t_grad = timed(lambda: energy_and_grad(m, sb, sw, el))
        log(phase, f"one step's stages (host clock): sample {t_sample:.1f} ms, eloc "
                   f"{t_eloc:.1f} ms, gradient {t_grad:.1f} ms")

    def flat_fwd(m, mm=bf16):
        return {"fwd": lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(m, b, matmul_dtype=mm)}

    def flop_per_site(d, npred, dc=0):
        """FLOP of one row at one site with npred predecessors: the
        complex transition of 4 values ([2·npred·d] x [4·2d], 2 FLOP per
        FMA), the tensor coupling at ≥ 2 predecessors (U·h for every
        (pred, value, c) as 8 FLOP per complex multiply-add, the product
        over the predecessors, K·Π into 4·2d outputs), the bias, square
        and η-weighted sums of 4·2d values and the phase readout."""
        O = 2 * d
        fl = 2 * 4 * O * (2 * npred * d) + 3 * 4 * O + 4 * O
        if dc and npred >= 2:
            fl += 4 * dc * npred * d * 8 + 6 * (npred - 1) * 4 * dc + 4 * O * dc * 4
        return fl

    peak = {bf16: H100_BF16_FLOPS, f32: H100_F32_FLOPS}

    def bound(flop, nbytes, mm):
        op_ms, byte_ms = flop / peak[mm] * 1e3, nbytes / H100_BYTES * 1e3
        return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")

    def table_bytes(tables, mm):
        """Each table read once; W in the matmul type."""
        n = sum(t.numel() for t in tables.values()) * 4
        return n - (tables["W"].numel() * 2 if mm == bf16 else 0)

    def alternate(plain, kern, kreps, preps=2):
        """CUDA-event ms of plain, kernel, kernel, plain: (kernel, plain)."""
        p1 = cuda_ms(plain, preps)
        k1 = cuda_ms(kern, kreps)
        k2 = cuda_ms(kern, kreps)
        p2 = cuda_ms(plain, preps)
        return (k1 + k2) / 2, (p1 + p2) / 2

    def capture_rows(m, seed_s, seed_e, mm=bf16):
        """The rows one step's eloc forward hands the kernel, drawn from
        the state before any training step, so that they are the same in
        every run."""
        seen = []
        g = torch.Generator(device=dev).manual_seed(seed_s)
        fb, fw, _ = sampler.sample(m, g)

        def fwd(b):
            seen.append(b)
            return fused_rnn.graph_mpsrnn_logpsi_fused(m, b, matmul_dtype=mm)

        el = reduce(fwd, fb, torch.Generator(device=dev).manual_seed(seed_e))
        return seen[0], fb, fw, el

    def time_flat(phase, name, m, trows, kreps):
        """Agreement with the plain version (as ``compare``) and CUDA-event
        times, both modes, on one step's rows: {mm: (kernel ms, plain ms,
        max|Δlog|ψ||, the CUDA-core kernel's ms in bf16 or None)}.  The
        kernel of bf16 mode is the tensor-core one; the CUDA-core kernel
        in bf16 (``_launch_simt``) is timed before and after it."""
        tables = fused_rnn.pack_tables(m)
        res = {}
        for mm in (bf16, f32):
            kern = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=mm, tables=tables)  # noqa: E731
            plain = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, trows, matmul_dtype=mm, tables=tables)  # noqa: E731
            simt = lambda: fused_rnn._launch_simt(m, trows, tables)  # noqa: E731
            k_out, p_out = kern(), plain()
            sync()
            err = agree(phase, f"{name} step rows", m, trows, mm, k_out, p_out, tables)
            del k_out, p_out
            if mm == bf16:
                s1 = cuda_ms(simt, kreps)
                k, p = alternate(plain, kern, kreps)
                prev = (s1 + cuda_ms(simt, kreps)) / 2
            else:
                (k, p), prev = alternate(plain, kern, kreps), None
            res[mm] = (k, p, err, prev)
        return res, tables

    def w_traffic(m, tables, n):
        """(launch shape, bytes of W every CTA streams, the L2 traffic of
        W over all CTAs) of the tensor-core kernel at n rows."""
        sh = fused_rnn.mma_launch_shape(m)
        w = fused_rnn.pack_mma_tables(m, tables)["tab"].numel() * 2
        return sh, w, w * -(-n // (16 * sh["warps"]))

    # ---- 5. three VMC steps, flagship configuration ----
    trows, fbits, fw, _ = capture_rows(model, 4, 5)  # phase 6 uses them
    e_mm = {}
    for mm in (bf16, f32):
        el = reduce(**flat_fwd(model, mm), bits=fbits,
                    g=torch.Generator(device=dev).manual_seed(5))  # same tail draws
        e_mm[mm] = (fw @ el[:, 0].to(fw.dtype)).item()
    log(5, f"mean E_loc on one fixed batch: bf16 kernel {e_mm[bf16]:.6f}, "
           f"f32 kernel {e_mm[f32]:.6f}, difference "
           f"{(e_mm[bf16] - e_mm[f32]) * 1e3:+.4f} mHa")
    reset_peak()
    vmc = VMC(model, system, sampler, config())
    steps = run_steps(5, vmc, {"flat": fused_rnn.LAUNCHES, "mma": fused_rnn.MMA_LAUNCHES}, 3)
    launches = fused_rnn.MMA_LAUNCHES.n
    check(launches > 0 and launches == fused_rnn.LAUNCHES.n,
          "the VMC steps did not launch the tensor-core kernel alone")
    log(5, f"{STEPS} steps done: kernel launches {launches}; max_memory_allocated "
           f"{peak_gib():.3f} GiB")
    stage_times(5, model, flat_fwd)
    # two more steps, the second under the profiler: the device time of
    # a step by kernel, and its share of an unprofiled step's wall time
    # (the profiler slows the host side, not the kernels)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(3)
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
    n_rows = trows.shape[0]
    check(n_rows == B * (1 + K_DET + N_STOCH), f"one eloc forward of {n_rows} rows")
    t6, tables = time_flat(6, "chain dcut48", model, trows, 5)
    norb = SORB // 2
    flop6 = n_rows * norb * flop_per_site(DCUT, 1)
    nbytes6 = {mm: n_rows * SORB + n_rows * 2 * 4 + table_bytes(tables, mm) for mm in t6}
    b6 = {mm: bound(flop6, nbytes6[mm], mm) for mm in t6}
    for mm, (k, p, _, prev) in t6.items():
        log(6, f"fused forward {mmname(mm)} at {n_rows} rows: "
               + (f"tensor-core kernel {k:.3f} ms, CUDA-core kernel {prev:.3f} ms "
                  f"({prev / k:.2f}x), " if prev else f"CUDA-core kernel {k:.3f} ms, ")
               + f"plain {p:.3f} ms, bound {b6[mm][0]:.3f} ms ({flop6 / 1e12:.3f} TFLOP, "
               f"{nbytes6[mm] / 1e6:.1f} MB), {flop6 / k / 1e9:.2f} TFLOP/s; gpu {smi}")
    sh6, w6, l2_6 = w_traffic(model, tables, n_rows)
    log(6, f"tensor-core kernel at {n_rows} rows: {16 * sh6['warps']} rows per CTA, "
           f"{sh6['nslots']} slot(s) in {sh6['slots']} memory, {sh6['smem_bytes']} B shared "
           f"memory per CTA; every CTA streams {w6 / 1e6:.3f} MB of W, "
           f"{l2_6 / 1e9:.2f} GB through L2 in all")
    del trows

    # ---- 7. the r5g64 structured flagship: three VMC steps ----
    r5 = r5g64()
    trows7, fbits7, fw7, el7 = capture_rows(r5, 6, 7)
    log(7, f"r5g64 mean E_loc on one fixed batch (bf16 kernel, stand-in integrals): "
           f"{(fw7 @ el7[:, 0].to(fw7.dtype)).item():.6f}")
    reset_peak()
    vmc7 = VMC(r5, system, sampler, config())
    steps7 = run_steps(7, vmc7, {"flat": fused_rnn.LAUNCHES, "mma": fused_rnn.MMA_LAUNCHES}, 9)
    launches7 = fused_rnn.MMA_LAUNCHES.n
    check(launches7 > 0 and launches7 == fused_rnn.LAUNCHES.n,
          "the r5g64 steps did not launch the tensor-core kernel alone")
    walls = ", ".join(f"{s['iter_time']:.3f}" for s in steps7)
    log(7, f"{STEPS} r5g64 steps done: step walls {walls} s; kernel launches "
           f"{launches7}; max_memory_allocated {peak_gib():.3f} GiB")
    stage_times(7, r5, flat_fwd)
    r5 = r5g64()
    t7, tables7 = time_flat(7, "r5g64 tensor", r5, trows7, 3)
    n7 = trows7.shape[0]
    flop7 = n7 * sum(flop_per_site(DCUT_R5, len(p), DCMP_R5) for p in r5.preds)
    nbytes7 = {mm: n7 * SORB + n7 * 2 * 4 + table_bytes(tables7, mm) for mm in t7}
    b7 = {mm: bound(flop7, nbytes7[mm], mm) for mm in t7}
    for mm, (k, p, _, prev) in t7.items():
        log(7, f"fused forward with tensor coupling {mmname(mm)} at {n7} rows: "
               + (f"tensor-core kernel {k:.3f} ms, CUDA-core kernel {prev:.3f} ms "
                  f"({prev / k:.2f}x), " if prev else f"CUDA-core kernel {k:.3f} ms, ")
               + f"plain {p:.3f} ms, bound {b7[mm][0]:.3f} ms "
               f"({flop7 / 1e12:.3f} TFLOP, {nbytes7[mm] / 1e6:.1f} MB), "
               f"{flop7 / k / 1e9:.2f} TFLOP/s; gpu {smi}")
    sh7, w7, l2_7 = w_traffic(r5, tables7, n7)
    log(7, f"tensor-core kernel at {n7} rows: {16 * sh7['warps']} rows per CTA, "
           f"{sh7['nslots']} hidden slots in {sh7['slots']} memory (no DAG hidden file; the "
           f"CUDA-core kernel's f32 file would be {n7 * norb * 2 * DCUT_R5 * 4 / 1e9:.2f} GB), "
           f"{sh7['smem_bytes']} B shared memory per CTA; every CTA streams "
           f"{w7 / 1e6:.3f} MB of W, {l2_7 / 1e9:.2f} GB through L2 in all")
    del trows7

    # ---- 8. the prefix-sharing path on the dcut-48 chain ----
    model = chain48()

    class Capture(pre.ReducePrefixForward):
        """Keeps the inputs of each call."""

        def __call__(self, parent_bits, child_bits, t_min):
            self.seen = (parent_bits, child_bits, t_min)
            return super().__call__(parent_bits, child_bits, t_min)

    g8 = torch.Generator(device=dev).manual_seed(4)
    fbits8, _, _ = sampler.sample(model, g8)
    cap = Capture(model, matmul_dtype=bf16)
    reduce(None, fbits8, torch.Generator(device=dev).manual_seed(5), prefix_fwd=cap)
    par_bits, kids, t_min = cap.seen
    Bp, C = t_min.shape
    rows8 = torch.cat([par_bits.to(torch.int8), kids.reshape(-1, SORB)])
    log(8, f"one step's prefix inputs: {Bp} parents x {C} children, t_min mean "
           f"{t_min.float().mean().item():.3f}, {(t_min == 0).sum().item()} at 0, "
           f"{(t_min >= norb).sum().item()} at norb")
    kids_flat = kids.reshape(-1, SORB)
    err8 = {}
    for mm in (f32, bf16):
        kp, kc = pre.graph_mpsrnn_logpsi_fused_prefix(model, par_bits, kids, t_min,
                                                      matmul_dtype=mm)
        pp, pc = pre.graph_mpsrnn_logpsi_fused_prefix_plain(model, par_bits, kids, t_min,
                                                            matmul_dtype=mm)
        # the flat kernel of the same design on the same rows: in bf16 the
        # tensor-core kernel, whose walk the prefix passes share, so every
        # row must be equal bit for bit; in f32 the CUDA-core kernel
        flat = fused_rnn.graph_mpsrnn_logpsi_fused(model, rows8, matmul_dtype=mm)
        sync()
        check(bool(torch.isfinite(kp).all() and torch.isfinite(kc).all()),
              "non-finite prefix kernel output")
        kc = kc.reshape(-1, 2)
        e = {"parent vs plain": phase_err(kp, pp), "child vs plain": phase_err(kc, pc)}
        if mm == bf16:
            agree(8, "prefix parent (tensor cores)", model, par_bits, mm, kp, pp)
            agree(8, "prefix child (tensor cores)", model, kids_flat, mm, kc, pc.reshape(-1, 2))
            n_p = int((kp != flat[:Bp]).any(-1).sum())
            n_c = int((kc != flat[Bp:]).any(-1).sum())
            log(8, f"prefix bf16 vs the flat tensor-core kernel on the same rows: rows that "
                   f"differ at all: parent {n_p} of {Bp}, child {n_c} of {kc.shape[0]}")
            check(n_p == 0 and n_c == 0,
                  "the tensor-core prefix rows differ from the flat tensor-core kernel's")
        else:
            ta, tp = tol[mm]
            e["parent vs flat CUDA-core kernel"] = phase_err(kp, flat[:Bp])
            e["child vs flat CUDA-core kernel"] = phase_err(kc, flat[Bp:])
            for what, (da, dp) in e.items():
                log(8, f"prefix {what} {mmname(mm)}: max|Δlog|ψ|| {da:.3e} (tol {ta:g}), "
                       f"max phase distance {dp:.3e} (tol {tp:g})")
                check(da <= ta and dp <= tp, f"prefix {what} disagrees")
        err8[mm] = e
        del kp, kc, pp, pc, flat

    # REDUCE with and without prefix_fwd: the same generator seed draws
    # the same tail, so only the forwards' rounding differs
    sub = fbits8[:N_RED]
    f32fwd = lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=f32)  # noqa: E731
    e_flat = reduce(f32fwd, sub, torch.Generator(device=dev).manual_seed(9))
    e_pre = reduce(f32fwd, sub, torch.Generator(device=dev).manual_seed(9),
                   prefix_fwd=pre.ReducePrefixForward(model, matmul_dtype=f32))
    scale = hr_scale(model, sub)
    diff = (e_flat - e_pre).abs().max(-1).values
    log(8, f"REDUCE with vs without prefix_fwd (f32) on {sub.shape[0]} sampled rows: "
           f"max|Δ| {diff.max().item():.3e}, max |Δ|/Σ|h r| "
           f"{(diff / scale).max().item():.3e} (tol 1e-4)")
    check(bool(torch.isfinite(e_pre).all() and (diff <= 1e-4 * scale).all()),
          "REDUCE with prefix_fwd != REDUCE without it")

    reset_peak()
    vmc8 = VMC(chain48(), system, sampler, config(eloc_prefix=True))
    counts8 = {"parent": pre.PARENT_LAUNCHES, "child": pre.CHILD_LAUNCHES,
               "mma_parent": pre.MMA_PARENT_LAUNCHES, "mma_child": pre.MMA_CHILD_LAUNCHES,
               "flat": fused_rnn.LAUNCHES}
    steps8 = run_steps(8, vmc8, counts8, 3)
    l8 = {k: c.n for k, c in counts8.items()}
    check(l8["mma_parent"] > 0 and l8["mma_child"] > 0, "eloc_prefix steps never launched "
                                                        "the tensor-core prefix kernels")
    check(l8["mma_parent"] == l8["parent"] and l8["mma_child"] == l8["child"],
          "eloc_prefix steps launched the CUDA-core prefix kernels")
    check(l8["flat"] == 0, "eloc_prefix steps launched the flat kernel")
    walls = ", ".join(f"{s['iter_time']:.3f}" for s in steps8)
    log(8, f"{STEPS} eloc_prefix steps done: step walls {walls} s; launches {l8}; "
           f"max_memory_allocated {peak_gib():.3f} GiB")
    stage_times(8, chain48(), lambda m: {
        "fwd": None, "prefix_fwd": pre.ReducePrefixForward(m, matmul_dtype=bf16)})

    # times on the same rows: parent and child passes (in bf16 also the
    # CUDA-core kernels, timed before and after the tensor-core one), the
    # whole prefix forward, the flat kernel; plain versions beside them
    tables8 = fused_rnn.pack_tables(model)
    par_idx = torch.arange(Bp, device=dev).repeat_interleave(C)
    t_flat = t_min.reshape(-1)

    def with_prev(plain, kern, simt, kreps):
        s1 = cuda_ms(simt, kreps)
        k, p = alternate(plain, kern, kreps)
        return k, p, (s1 + cuda_ms(simt, kreps)) / 2

    t8 = {}
    for mm in (bf16, f32):
        kw = dict(matmul_dtype=mm, tables=tables8)
        _, hh, sh = pre.prefix_parent(model, par_bits, **kw)
        _, hh_p, sh_p = pre.prefix_parent_plain(model, par_bits, **kw)
        sync()
        dh = (hh - hh_p).abs().max().item()
        ds = (sh[..., :6] - sh_p[..., :6]).abs().max().item()
        log(8, f"parent histories {mmname(mm)}: max|Δh| {dh:.3e}, max|Δ state| {ds:.3e}")
        passes = {
            "parent": (lambda: pre.prefix_parent_plain(model, par_bits, **kw),
                       lambda: pre.prefix_parent(model, par_bits, **kw),
                       lambda: pre._launch_prefix_simt("parent", model, par_bits,
                                                       tables=tables8)),
            "child": (lambda: pre.prefix_child_plain(model, kids_flat, par_idx, t_flat, hh, sh,
                                                     **kw),
                      lambda: pre.prefix_child(model, kids_flat, par_idx, t_flat, hh, sh, **kw),
                      lambda: pre._launch_prefix_simt("child", model, kids_flat, par_idx,
                                                      t_flat, hh, sh, tables=tables8)),
        }
        t8[mm] = {what: (with_prev(plain, kern, simt, 5) if mm == bf16
                         else (*alternate(plain, kern, 5), None))
                  for what, (plain, kern, simt) in passes.items()}
        t8[mm]["prefix forward"] = (*alternate(
            lambda: pre.graph_mpsrnn_logpsi_fused_prefix_plain(model, par_bits, kids, t_min,
                                                               **kw),
            lambda: pre.graph_mpsrnn_logpsi_fused_prefix(model, par_bits, kids, t_min, **kw),
            5), None)
        t8[mm]["flat forward"] = (*alternate(
            lambda: fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, rows8, **kw),
            lambda: fused_rnn.graph_mpsrnn_logpsi_fused(model, rows8, **kw), 5), None)
        del hh, sh, hh_p, sh_p
    # site-steps: what the data needs (each child from its own t_min)
    # and what the child kernels run (each CTA's sorted rows from their
    # smallest t_min): the tensor-core pass's rows per CTA at this row
    # count, and the CUDA-core pass's 64
    s0 = torch.clamp(t_flat, 0, norb).sort().values
    n_child = s0.numel()
    need_child = (norb - s0).sum().item()
    flat_steps = (Bp + n_child) * norb

    def run_child(TR):
        pad = (-n_child) % TR
        s0_tile = torch.nn.functional.pad(s0, (0, pad), value=norb).reshape(-1, TR).min(1).values
        return ((norb - s0_tile) * TR).sum().item() - pad * (norb - s0_tile[-1].item())

    sh_p8 = fused_rnn.mma_launch_shape(model, Bp, n_sm)
    sh_c8 = fused_rnn.mma_launch_shape(model, n_child, n_sm)
    TR = 16 * sh_c8["warps"]
    log(8, f"tensor-core launch shapes: parent {sh_p8['warps']} warp(s) ({16 * sh_p8['warps']} "
           f"rows) x {sh_p8['ctas']} CTAs, child {sh_c8['warps']} warp(s) ({TR} rows) x "
           f"{sh_c8['ctas']} CTAs, on {n_sm} SMs")
    # the parent pass once more at the flat forward's shape (8 warps), for
    # what filling the SMs is worth at 2048 rows
    shape_fn = fused_rnn.mma_launch_shape
    w_flat = shape_fn(model)["warps"]
    fused_rnn.mma_launch_shape = lambda m, n=None, n_sm=None: shape_fn(m)
    try:
        t_par_flat = cuda_ms(lambda: pre.prefix_parent(model, par_bits, matmul_dtype=bf16,
                                                       tables=tables8), 5)
    finally:
        fused_rnn.mma_launch_shape = shape_fn
    log(8, f"parent bf16 at the flat forward's shape ({w_flat} warps x "
           f"{-(-Bp // (16 * w_flat))} CTAs): {t_par_flat:.3f} ms, against "
           f"{t8[bf16]['parent'][0]:.3f} ms at {sh_p8['warps']} warp(s) x {sh_p8['ctas']} CTAs")
    # each pass's kernel time on the device alone (torch.profiler), beside
    # the CUDA-event time of the wrapper call above: at 2048 parents the
    # wrapper's host work can be longer than the kernel
    def device_ms(fn, pattern, reps=5):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof8:
            for _ in range(reps):
                fn()
            sync()
        return sum(e.self_device_time_total for e in prof8.key_averages()
                   if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)) / reps / 1e3

    _, hh, sh = pre.prefix_parent(model, par_bits, matmul_dtype=bf16, tables=tables8)
    dev8 = {
        "parent": (device_ms(lambda: pre.prefix_parent(model, par_bits, matmul_dtype=bf16,
                                                       tables=tables8), "fused_rnn_mma_kernel"),
                   device_ms(lambda: pre._launch_prefix_simt("parent", model, par_bits,
                                                             tables=tables8),
                             "fused_rnn_kernel")),
        "child": (device_ms(lambda: pre.prefix_child(model, kids_flat, par_idx, t_flat, hh, sh,
                                                     matmul_dtype=bf16, tables=tables8),
                            "fused_rnn_mma_kernel"),
                  device_ms(lambda: pre._launch_prefix_simt("child", model, kids_flat, par_idx,
                                                            t_flat, hh, sh, tables=tables8),
                            "fused_rnn_kernel")),
    }
    del hh, sh
    for what, (dk, ds) in dev8.items():
        log(8, f"{what} bf16, device time per launch (profiler): tensor-core kernel {dk:.3f} ms "
               f"(the wrapper call {t8[bf16][what][0]:.3f} ms), CUDA-core kernel {ds:.3f} ms "
               f"(the wrapper call {t8[bf16][what][2]:.3f} ms); gpu {smi}")
    run_c = run_child(TR)
    log(8, f"site-steps: flat {flat_steps}; prefix needs {Bp * norb + need_child} "
           f"(skips {1 - (Bp * norb + need_child) / flat_steps:.2%}), the tensor-core child's "
           f"CTAs of {TR} sorted rows run {Bp * norb + run_c} "
           f"(skip {1 - (Bp * norb + run_c) / flat_steps:.2%}); the CUDA-core child's CTAs of "
           f"64 would run {Bp * norb + run_child(64)}")
    hist_bytes = Bp * norb * (2 * DCUT + pre.NSTATE) * 4
    fl = flop_per_site(DCUT, 1)
    b8 = {}
    for mm in t8:
        tb = table_bytes(tables8, mm)
        b8[mm] = {
            "parent": bound(Bp * norb * fl, Bp * SORB + Bp * 16 + hist_bytes + tb, mm),
            "child": bound(need_child * fl, n_child * (SORB + 4 + 4 + 16) + hist_bytes + tb,
                           mm),
        }
        b8[mm]["prefix forward"] = bound(
            (Bp * norb + need_child) * fl,
            (Bp + n_child) * (SORB + 8) + n_child * 4 + tb, mm)
        b8[mm]["flat forward"] = bound(flat_steps * fl, (Bp + n_child) * (SORB + 8) + tb, mm)
        for what, (k, p, prev) in t8[mm].items():
            kern = ("tensor-core kernel" if mm == bf16 else "CUDA-core kernel")
            log(8, f"{what} {mmname(mm)}: {kern} {k:.3f} ms"
                   + (f", CUDA-core kernel {prev:.3f} ms ({prev / k:.2f}x)" if prev else "")
                   + f", plain {p:.3f} ms, bound {b8[mm][what][0]:.3f} ms ({b8[mm][what][1]}); "
                   f"gpu {smi}")
    log(8, f"prefix forward / flat forward, kernels (bf16: both on the tensor cores; f32: both "
           f"on the CUDA cores): bf16 "
           f"{t8[bf16]['prefix forward'][0] / t8[bf16]['flat forward'][0]:.3f}, f32 "
           f"{t8[f32]['prefix forward'][0] / t8[f32]['flat forward'][0]:.3f}")

    # ---- 9. the doubles pair selection at the flagship's shapes ----
    po_s, pv_s = pair_indices(fbits, table)  # phase 5's 2048 samples, int64
    Bs, n_u = po_s.shape
    n_v = pv_s.shape[1]
    npair = tabs.hpair.shape[0]
    g9 = torch.Generator(device=dev).manual_seed(10)
    hp_asym = torch.randn(npair, npair, generator=g9, device=dev)
    idx_sets = {
        "samples": (po_s, pv_s),
        "random": (torch.randint(0, npair, (Bs, n_u), generator=g9, device=dev),
                   torch.randint(0, npair, (Bs, n_v), generator=g9, device=dev)),
    }
    for (iname, (po, pv)), (hname, hp) in itertools.product(
            idx_sets.items(), (("symmetric", tabs.hpair), ("asymmetric", hp_asym))):
        lib9 = hp[po[..., None], pv[:, None, :]]
        for v in ps.VARIANTS:
            k9 = ps.pair_select_w(po, pv, hp, variant=v)
            p9 = ps.pair_select_w_plain(po, pv, hp, variant=v)
            sync()
            check(torch.equal(k9, p9) and torch.equal(k9, lib9),
                  f"pair selection {v} != plain ({iname} indices, {hname} hpair)")
        log(9, f"pair selection [{Bs}, {n_u}, {n_v}] (npair {npair}), {iname} indices, "
               f"{hname} hpair: lane and rowrow kernels bitwise equal to the plain version "
               f"and to hpair[po, pv]")
        del lib9, k9, p9
    check(bool(torch.equal(tabs.hpair, tabs.hpair.T)), "the system's hpair is not symmetric")

    def time_pairs(phase, po, pv, hp, reps, host_calls):
        """``time_pair_select.measure`` of both variants on these operands,
        the earlier gather kernel held bitwise to the band kernel first;
        returns ({variant: numbers}, {variant: max|kernel − plain|})."""
        res, err = {}, {}
        for v in ps.VARIANTS:
            k = ps.pair_select_w(po, pv, hp, variant=v)
            check(torch.equal(ps._launch_gather(po, pv, hp, v), k),
                  f"the earlier gather kernel ({v}) != the band kernel")
            err[v] = (k - ps.pair_select_w_plain(po, pv, hp, variant=v)).abs().max().item()
            del k
            r = res[v] = tps.measure(po, pv, hp, v, reps=reps, host_calls=host_calls)
            log(phase, f"pair selection {v} {r['shape']}: wrapper call {r['ms']:.4f} ms, kernel "
                       f"alone {r['device_ms']:.4f} ms (profiler), host {r['host_ms']:.4f} ms per "
                       f"call; the earlier gather kernel in the same run {r['prev_ms']:.4f} ms, "
                       f"alone {r['prev_device_ms']:.4f} ms, host {r['prev_host_ms']:.4f} ms; "
                       f"plain {r['plain_ms']:.4f} ms, one gather hpair[po[..., None], "
                       f"pv[:, None, :]] {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                       f"({r['bytes'] / 1e6:.1f} MB, bytes); L2 sectors a gather must touch "
                       f"along hpair's rows {r['l2_sector_bytes'] / 1e6:.1f} MB, along the "
                       f"kernel's hpair^T rows {r['l2_sector_bytes_kernel'] / 1e6:.1f} MB "
                       f"({r['l2_sector_bytes_kernel'] / r['bytes']:.2f}x the bytes); gpu {smi}")
        return res, err

    po, pv, hp = po_s, pv_s, tabs.hpair
    m9, err9 = time_pairs(9, po, pv, hp, 20, 100)

    # the rowrow variant's path: pair_select_w(variant="rowrow") on the
    # samples' indices, from a fresh launch count
    for c in ps.LAUNCHES.values():
        c.reset()
    w_rr = ps.pair_select_w(po, pv, hp, variant="rowrow")
    sync()
    l9 = {k: c.n for k, c in ps.LAUNCHES.items()}
    check(l9 == {"lane": 0, "rowrow": 1}, f"pair_select_w(variant='rowrow') launches {l9}")
    check(torch.equal(w_rr, ps.pair_select_w_plain(po, pv, hp, variant="rowrow")),
          "pair selection rowrow != plain on the samples' indices")
    del w_rr

    # comb_hij on the 2048 samples: the dense pair matrix through the
    # kernel against the sector blocks
    _, h_sect = comb_hij(fbits, *ops, tabs.hpair_sect, table=table, with_comb=False)
    for c in ps.LAUNCHES.values():
        c.reset()
    _, h_dense = comb_hij(fbits, *ops, tabs.hpair, table=table, with_comb=False)
    sync()
    l9c = {k: c.n for k, c in ps.LAUNCHES.items()}
    check(l9c == {"lane": 1, "rowrow": 0}, f"dense comb_hij launches {l9c}")
    check(torch.equal(h_dense, h_sect), "dense comb_hij != sector form")
    t_sect = cuda_ms(lambda: comb_hij(fbits, *ops, tabs.hpair_sect, table=table,
                                      with_comb=False), 10)
    t_dense = cuda_ms(lambda: comb_hij(fbits, *ops, tabs.hpair, table=table, with_comb=False),
                      10)
    log(9, f"comb_hij on {Bs} samples ({1 + table.n_sd} elements each): dense pair matrix "
           f"bitwise equal to the sector blocks (launches {l9c}); sector blocks {t_sect:.3f} "
           f"ms, dense {t_dense:.3f} ms; gpu {smi}")
    del h_sect, h_dense, hp_asym, idx_sets

    # ---- 10. the final-state evaluation of the r5g64 flagship ----
    r5 = r5g64()
    eval_kw = dict(n_sample=1_000_000, capacity=4096, n_group=4, split_depth=6, k_det=1024,
                   n_stoch=256, batch=256, n_rep=1, fwd_dtype="bf16", device=dev)
    for c in (*ps.LAUNCHES.values(), fused_rnn.LAUNCHES, fused_rnn.MMA_LAUNCHES):
        c.reset()
    reset_peak()
    (rep,) = evaluate(r5, system, generator=torch.Generator(device=dev).manual_seed(11),
                      **eval_kw)
    sync()
    l10 = {"pair_select_lane": ps.LAUNCHES["lane"].n,
           "pair_select_rowrow": ps.LAUNCHES["rowrow"].n, "fused": fused_rnn.LAUNCHES.n,
           "fused_mma": fused_rnn.MMA_LAUNCHES.n}
    log(10, rep.line(0, system.e_ref))
    log(10, f"r5g64 evaluation (stand-in integrals, k_det 1024, n_stoch 256, batch 256, bf16 "
            f"forward): {rep.seconds:.3f} s per rep; E {rep.e:.6f} ± {rep.e_se:.2e}, <S-S+> "
            f"{rep.s:.6f} ± {rep.s_se:.2e}; launches {l10}; max_memory_allocated "
            f"{peak_gib():.3f} GiB; gpu {smi}")
    check(np.isfinite(rep.e) and np.isfinite(rep.s) and np.isfinite(rep.var),
          "non-finite evaluation")
    check(rep.s > -5 * rep.s_se, f"<S-S+> = {rep.s} below -5 se ({rep.s_se})")
    check(l10["pair_select_lane"] > 0 and l10["fused_mma"] > 0
          and l10["fused_mma"] == l10["fused"],
          f"the evaluation did not launch the pair selection and the tensor-core kernel: {l10}")

    # the same rep again, each stage synchronized at every call, for the
    # time split; it also keeps the pair selection's first operands
    spent = {"pair selection": 0.0, "comb_hij": 0.0, "fused forward": 0.0}
    first = {}

    def clocked(key, fn):
        def run(*a, **k):
            first.setdefault(key, a)
            sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spent[key] += time.perf_counter() - t
            return out
        return run

    patched = ((ham_mod, "pair_select_w", "pair selection"), (eloc_mod, "comb_hij", "comb_hij"),
               (fused_rnn, "graph_mpsrnn_logpsi_fused", "fused forward"))
    saved = [getattr(mod, name) for mod, name, _ in patched]
    for mod, name, key in patched:
        setattr(mod, name, clocked(key, getattr(mod, name)))
    try:
        (rep_c,) = evaluate(r5, system, generator=torch.Generator(device=dev).manual_seed(11),
                            **eval_kw)
        sync()
    finally:
        for (mod, name, _), fn in zip(patched, saved):
            setattr(mod, name, fn)
    check(rep_c.n_live == rep.n_live, "the synchronized rep sampled other rows")
    log(10, f"time of the synchronized rep ({rep_c.seconds:.3f} s; host clock, synchronized "
            f"at each call) in: " + ", ".join(
                f"{k} {v:.3f} s ({v / rep_c.seconds:.1%})" for k, v in spent.items())
        + " (comb_hij includes the pair selection)")

    # both variants at the evaluation's chunk shape: the first chunk's
    # operands (256 r5g64 samples, the system's f32 hpair)
    po, pv, hp = first["pair selection"][:3]
    for v in ps.VARIANTS:
        check(torch.equal(ps.pair_select_w(po, pv, hp, variant=v),
                          ps.pair_select_w_plain(po, pv, hp, variant=v)),
              f"pair selection {v} != plain at the evaluation's chunk shape")
    m10, err10 = time_pairs(10, po, pv, hp, 50, 1000)

    # ---- 11. the flagship training run at full width ----
    f11 = flagship_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed)

    def entry(name, replaces, launches_n, err, times, bnd, source="fused_rnn.cu", lib=None,
              **extra):
        return {
            "name": name, "route": "cuda", "source": f"pynqs_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches_n, "max_abs_err": err,
            "ms": times[0], "plain_ms": times[1], "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib, **extra,
        }

    # kernel #1 in bf16: the tensor-core kernel; prev_ms is the CUDA-core
    # kernel's time in bf16 on the same rows in this run
    summary = {"kernels": [
        entry("fused_rnn_forward_mma", "pynqs_tpu/ops/fused_rnn.py:197", launches,
              t6[bf16][2], t6[bf16], b6[bf16], "fused_rnn_mma.cu", prev_ms=t6[bf16][3]),
        entry("fused_rnn_forward_mma_tensor", "pynqs_tpu/ops/fused_rnn.py:254", launches7,
              t7[bf16][2], t7[bf16], b7[bf16], "fused_rnn_mma.cu", prev_ms=t7[bf16][3]),
        # kernels #2 and #3 in bf16: the tensor-core passes; prev_ms is the
        # CUDA-core pass's time in bf16 on the same rows in this run;
        # device_ms and prev_device_ms their kernels' device time alone
        entry("fused_rnn_prefix_parent", "pynqs_tpu/ops/fused_rnn_prefix.py:226",
              l8["mma_parent"], err8[bf16]["parent vs plain"][0], t8[bf16]["parent"],
              b8[bf16]["parent"], "fused_rnn_mma.cu", prev_ms=t8[bf16]["parent"][2],
              device_ms=dev8["parent"][0], prev_device_ms=dev8["parent"][1]),
        entry("fused_rnn_prefix_child", "pynqs_tpu/ops/fused_rnn_prefix.py:264",
              l8["mma_child"], err8[bf16]["child vs plain"][0], t8[bf16]["child"],
              b8[bf16]["child"], "fused_rnn_mma.cu", prev_ms=t8[bf16]["child"][2],
              device_ms=dev8["child"][0], prev_device_ms=dev8["child"][1]),
        # lane: the evaluation's launches and chunk shape (phase 10);
        # rowrow: pair_select_w(variant="rowrow") at [2048, 435, 45] (phase
        # 9); prev_*: the earlier gather kernel on the same operands in
        # this run
        *(entry(name, replaces, n, err[v], (m[v]["ms"], m[v]["plain_ms"]),
                (m[v]["bound_ms"], "bytes"), "pair_select.cu", m[v]["library_ms"],
                device_ms=m[v]["device_ms"], prev_ms=m[v]["prev_ms"],
                prev_device_ms=m[v]["prev_device_ms"])
          for name, replaces, n, v, m, err in (
              ("pair_select_lane", "pynqs_tpu/ops/pallas_hij.py:48", l10["pair_select_lane"],
               "lane", m10, err10),
              ("pair_select_rowrow", "pynqs_tpu/ops/pallas_hij.py:82", l9["rowrow"], "rowrow",
               m9, err9))),
        # kernel #1 at the training script's default width (dcut 96, dp 96)
        # on one eloc chunk of phase 11's trained state; launches: the
        # training run's, both runs (phase 11); prev_ms: the CUDA-core
        # kernel in bf16 on the same rows
        entry("fused_rnn_forward_mma_dp96", "pynqs_tpu/ops/fused_rnn.py:197",
              f11["launches"], f11["err"], f11["times"], f11["bound"], "fused_rnn_mma.cu",
              prev_ms=f11["prev_ms"], registers=f11["registers"],
              spill_bytes=f11["spill_bytes"]),
    ]}
    print(json.dumps(summary))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
