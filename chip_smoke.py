#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (and a few detail lines):
  1. environment probe (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build of the CUDA kernels, one nvcc per source, started together
     (pynqs_tpu_torch/csrc/fused_rnn_mma.cu: the fused forward and the
     prefix-sharing parent and child passes on the tensor cores, each in
     bf16 and in f32 as three TF32 products; csrc/fused_rnn.cu: the
     earlier design of all three on the CUDA cores;
     csrc/pair_select.cu: the doubles pair selection), with the
     compiler's register report of every instantiation and the shared
     memory of each fused launch, the tensor-core kernel's at the chain,
     r5g64, r5g64-at-dcut_cmpr-12, dp-96, dp-192 and dp-256 shapes in
     both modes (hidden slots, coupling slot and, above dp 128, the pass
     scratch) and the prefix passes' at the step's row counts in both
     modes;
  3. the fused forward against its plain torch version on the card (bf16
     and f32 through the tensor-core kernel, f32 as three TF32 products,
     each launch counted in its mode; in f32 the CUDA-core kernel's error
     on the same rows beside it): the dcut-48 Fe2S2 chain
     (checkpoints/fe2s2_dcut48_final.pkl; sorb 40, 15α/15β) on 65,536
     random valid rows in f32 and bf16, a small DAG model, the
     linear/unit modes, and the structured r5g64 flagship (dcut 64,
     tensor coupling, 2 predecessors; weights of
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
     times beside the card's bound: of the tensor-core kernel, of the
     CUDA-core kernel in the same mode (``_launch_simt`` in bf16,
     ``_launch_f32_cuda_cores`` in f32: the earlier designs) and of the
     plain version, in f32 beside both bounds (3xTF32 on the tensor
     cores, f32 on the CUDA cores);
  7. three VMC steps of the r5g64 flagship in the same configuration,
     through the tensor-core kernel's tensor coupling; the kernel on one
     step's rows, held and timed as in phase 6, with W's L2 traffic;
  8. the prefix-sharing path (VMCConfig.eloc_prefix) on the dcut-48
     chain, on one step's rows: in bf16 and in f32 (3xTF32) the
     tensor-core parent and child passes held to their plain versions
     (``hold_rows``) and bit for bit equal to the flat tensor-core kernel
     in the same precision on the same rows; REDUCE with and without it
     in f32 (the tensor-core passes' launches alone), three VMC steps
     through it (the tensor-core passes' launches counted), the site-steps
     the child's CTAs run, and CUDA-event and profiler device times of
     each pass in both precisions (the tensor-core kernel, the CUDA-core
     kernel in the same precision and the plain version) beside both
     bounds in f32 (3xTF32, CUDA cores), and of both whole forwards;
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
     registers and spills, and in f32 held on 65,536 of those rows; a
     resume from iteration 2's checkpoint (state
     restored bit for bit, 2 more steps); the evaluation's main on the
     saved EMA state (kernel #4 launched);
 12. the post-training refinement of the r5g64 flagship (weights of
     checkpoints/fe2s2_r3_dcut64_r5g64.pkl, the stand-in integrals through
     a .pth file as in phase 11): fixed-node GFMC through
     pynqs_tpu_torch/scripts/fe2s2_gfmc.main at the runbook's 2048 walkers
     (--p-steps 10 --init-capacity 8192 --tail 200), 20 iterations (two
     branchings), its trial blocks of 2048 x 7876 rows through the
     tensor-core kernel; on the run's last walkers one Green row with the
     forward dedup at its measured distinct-row count against the plain
     one, and one below the count raising; kernel #1 held to its plain
     version on 65,536 trial-block rows and timed on the whole block; the
     CI-NQS polish through pynqs_tpu_torch/scripts/fe2s2_ci_polish.main
     (exact local energies, m 2048, n 1e6 in 4 groups of 4096 at depth 6),
     its E_VMC pass through kernel #4 (timed at its chunk shape as in phase
     9) and each exact-eloc pass timed; the bf16/f32 pair at a smaller
     capture (n 1e5, 4 groups of 1024, m 512);
 13. the CI ladder on the r5g64 state (the same weights and stand-in
     integrals): pynqs_tpu_torch/scripts/fe2s2_hci_precompute.main at a
     cut (--max-space 256 --max-rounds 3), its file read back by load_ci;
     NqsCi training through pynqs_tpu_torch/scripts/fe2s2_nqsci_train.main
     on checkpoints/fe2s2_hci_m1024.npz at full width (m 1024, eloc batch
     256; cut: capacity 1024, n 1e5, 1 iteration), its gradient-free
     forwards through kernel #1 in f32 (the tensor-core kernel's 3xTF32
     mode), every e_tot and |c_m| finite, the parameters changed, the
     saved state loaded, one more iteration timed stage by stage, its
     h_nn through the CUDA-core kernel too (within 0.01 mHa); the
     capture -> selected CI route at m 256 (64 seed determinants, 1
     iteration); kernel #1 held to its plain version on 65,536 rows of
     one H_nn connected block in f32 (the CUDA-core kernel's error
     beside it) and bf16 and timed on one eloc batch's rows, the f32
     mode beside the CUDA-core kernel, one iteration with --fwd-dtype
     bf16 against the f32 e_tot; the
     chunked H_cn gradient against one chunk on a sub-block, and one
     gradient chunk of the run's size timed and profiled (device busy
     share, top kernels);
 14. kernel #1 at dcut_cmpr 12 (padded to 16, the coupling in two blocks
     of 8 c's through the coupling slot) on the r5g64 shape (dcut 64, 2
     predecessors, the stand-in graph, seeded weights) on 65,536 random
     rows in bf16 and f32, one launch each counted, held by ``hold_rows``
     to the plain version and to the CUDA-core kernel, and timed beside
     the same shape at dcut_cmpr 4 on the same rows;
 15. the SR trainer (pynqs_tpu_torch/scripts/fe2s2_r2_push.main) at the
     script's defaults (n 5e5, capacity 4096, REDUCE k_det 512 / n_stoch
     128, clip 0.1, CG min-SR with --n-cg 50 --sr-damping 1e-3 and SGD on
     the exp schedule; the stand-in integrals through the default system
     path): --stage 64 --sr from checkpoints/fe2s2_dcut64.pkl (2
     iterations), --stage 96 --sr grown from fe2s2_r2_dcut64.pkl and
     --stage 128 --sr grown from a copy of fe2s2_r2_dcut96_final.pkl (1
     each), --stage 64 --n-slab 4 with AdamW (1): every step finite with
     w_sum 1, its stages synchronized (sample, eloc, SR solve, update),
     the CG residual of every solve by one more matvec, the eloc
     forwards through the tensor-core walk alone (the CUDA-core count 0),
     peak memory; kernel #1 at dp 64, 96 and 128 held by ``hold_rows`` on
     65,536 eloc rows and timed on the eloc rows of 1024 samples; the
     slabbed rows unique, their counts summing to n_sample less the
     dropped count;
 16. the SR solvers in f64 on the card (dense = blocked with one block,
     CG with n_cg = 2P = dense) on a small chain; the f32 CG on phase
     15's dcut-64 samples beside f64 (both residuals); one call each of
     the MCMC (1024 chains, 32 sweeps; the sector kept), Gumbel (distinct
     rows, finite weights) and RESTRICTED (phase 15's unique rows, one VMC
     step) samplers on the dcut-64 state; local_energy_simple_dedup
     against local_energy_simple; the ported feature tour
     (pynqs_tpu_torch/examples/feature_tour.main) at its iteration
     counts but 5 CG-SR steps (of 100), each VMC rung's tail mean at most
     5 s.e. below FCI;
 17. the other ansätze (``a8_run``): the GPT decoder at the JAX defaults
     (n_layer 2, n_head 4, d_model 64, phase_hidden 64, softmax-log; f32)
     on the stand-in integrals in the flagship's step (DFS n = 1e6,
     capacity 4096, 4 groups at depth 6, REDUCE k_det 256 / n_stoch 64,
     eloc batch ``A8_ELOC_BATCH``, AdamW lr 1e-4): 3 ``VMC.step``s, each
     split by stage (synchronized) with its peak memory, finite with
     w_sum 1, and the KV-cached ``ar_step`` conditionals along the last
     step's sampled rows summing to 2·log|ψ| of ``log_psi`` within 1e-4;
     ⟨S⁻S⁺⟩ of the trained decoder through ``VMC.operator_expected``
     (the dense pair matrix: kernel #4, lane, launches counted, its W
     bitwise equal to the plain version on the first chunk, timed there
     with ``time_pairs``), above −5 s.e.; the MPS-Transformer at its
     defaults (dcut 8, n_layer 1, n_head 2, d_model 32) in the same step,
     2 steps with the same checks; ``examples/hubbard_ladder.main`` for
     stages 1–4 at ``HUB_ITERS`` iterations, each gap from FCI in mHa,
     stage 4's eloc forwards through kernel #1 (bf16, the DAG path at dp
     16), its launches counted, held by ``hold_rows`` on the stage's eloc
     rows and timed there; one ``VMC.step`` each of RBM under MCMC,
     ARRBM, ARRBM2, IsingRBM, DBM, Jastrow, MPSWavefunction,
     Hybrid(ARRBM, RBM), MultiPsi(ARRBM, Jastrow) and SpinProjected(RNN)
     on the 4-site Hubbard chain (finite, w_sum 1).
 18. data parallelism (``dp_phase``; pynqs_tpu_torch/parallel/): the
     dcut-48 chain in the flagship step with ``ARSampler(mesh,
     "same_tree")`` (n 1e6, capacity 4096: 2048 rows per rank at two
     ranks), REDUCE k_det 256 / n_stoch 64 segmax, bf16 through kernel
     #1, AdamW lr 1e-4, 3 steps: over one rank of NCCL, bit for bit the
     run without a mesh; over two gloo ranks sharing the card (spawned
     processes, ``dp_rank``): one sharded tree's rows disjoint with counts
     + dropped = n, step 1's local energies, energy and gradient within
     the stated tolerances of one process on the gathered rows with the
     same tail draws, the 3 steps with each rank's kernel #1 launches
     counted, the parameters equal between the ranks and the shared
     generator in sync after every step, each step's wall time, one
     step's stages and the peak memory per rank, <S-S+> through
     ``operator_expected`` (the dense pair matrix: kernel #4, launches
     counted), one step of ``mesh_mode="independent"``, and fixed-node
     GFMC at 2048 walkers for 3 iterations (a branching every 2) against
     one process; NCCL with one card per rank where there are two cards;
 19. the entry points: ``pynqs_tpu_torch.entry.entry()`` on the card (its
     kernel #1 launches counted, against its plain version on the CPU),
     ``dryrun_multichip(1)`` over NCCL, a 5-iteration VMC run with
     ``profile_dir`` (``profile_rank``, in a fresh process over one gloo
     rank) whose trace holds the four ``vmc.*`` ranges of iterations 2-4
     and kernel #1 by name, and
     ``pynqs_tpu_torch.bench.main()`` with BENCH_MODE flat and prefix,
     each JSON line beside the card's name and power limit;
 20. the last modules (``last_modules_run``): kernel #1 above dcut 128
     (dp 256 in 4 passes of 128 outputs, dp 192 in 3) on chains
     warm-started through ``utils.focus_ctns.load_focus_ctns_mpsrnn``
     from raw FOCUS CTNS binaries the script writes (20 sites, bond
     dimension 256 and 160, seeded block-sparse sectors), held by
     ``hold_rows`` to its plain version on 65,536 random rows in bf16
     and f32 (one launch each, counted in its mode); VMC steps in the
     DMRG script's configuration (AR n 1e5, capacity 1024, REDUCE 512 /
     128, eloc batch 256, AdamW 2e-4, clip 0.1; ``C4_STEPS``) at both
     widths, the eloc forwards in bf16 and in f32 through kernel #1
     alone, finite with w_sum 1; kernel #1 timed at both widths in both
     modes on the eloc rows of one step beside its bound and the plain
     version; at dp 192 the prefix passes on ``N_PREFIX`` random parents
     and their single excitations held to their plain versions and bit
     for bit the flat kernel's, timed; the peak memory; then
     ``fe2s2_train_from_dmrg.main`` (``DMRG_ARGS``) from a dcut-20 state
     the script writes and converts, its eloc forwards through kernel
     #1, ``validate_fe2s2_import.main``, the example
     ``examples/fe2s2_graph_mps_rnn.main`` (``EXAMPLE_ARGS``; the DAG
     path at dp 32), ``spin_subspace_eval.main`` on the r5g64 state
     (``SPIN_ARGS``), ``kdet_rebalance_check.main`` (``KDET_ARGS``),
     ``measure_unique_chunks.main`` (``UNIQUE_ARGS``) and
     ``measure_dfs_r3.main``, each on the stand-in integrals and
     finite; ``fci_bits`` through the native enumerator (built with g++
     into build/, its call counted); ``memory.auto_eloc_batch`` within
     the memory ``mem_get_info`` leaves.

The last two lines are the kernels' JSON summary and the result JSON.
Any failed check raises, so the script exits non-zero with no result.
"""

from __future__ import annotations

import ctypes
import gc
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
DCMP_C3 = 12  # phase 14: a dcut_cmpr past 8 (padded to 16: two blocks of 8 c's)
B, K_DET, N_STOCH = 2048, 256, 64
N_CMP, N_REF = 65536, 4096  # rows of the phase-3 comparisons
N_ID = 64  # sampled rows of the phase-4 identity
N_RED = 512  # sampled rows of the phase-8 REDUCE comparison
STEPS = 3
# phase 12: the runbook's flags for the r5g64 state, cut as PERF.md §4 says
R5_FLAGS = ["--dcut", "64", "--use-tensor", "--max-preds", "2"]
GFMC_ARGS = ["--n-walkers", "2048", "--p-steps", "10", "--init-capacity", "8192",
             "--tail", "200", "--n-iter", "20"]
POLISH_ARGS = ["--k-det", "0", "--eloc-batch", "128", "--ci-chunk", "128", "--m", "2048",
               "--n-sample", "1000000", "--capacity", "4096", "--n-group", "4",
               "--split-depth", "6"]
PAIR_ARGS = ["--k-det", "0", "--eloc-batch", "128", "--ci-chunk", "128", "--m", "512",
             "--n-sample", "100000", "--capacity", "1024", "--n-group", "4",
             "--split-depth", "6"]
N_HOLD = 65536  # trial-block rows of phase 12's kernel comparison
# phase 13: the runbook's NqsCi stage (r5_runbook.sh:64-78; the script's
# default --ci-chunk 65536) on the repository's HCI space, cut as PERF.md
# §4 says
NQSCI_ARGS = ["--ci-file", os.path.join("checkpoints", "fe2s2_hci_m1024.npz"), "--eloc-batch",
              "256", "--capacity", "1024", "--n-sample", "100000"]
HCI_ARGS = ["--max-space", "256", "--max-rounds", "3"]
SEL_ARGS = ["--m", "256", "--seed-dets", "64", "--iters", "1", "--eloc-batch", "256",
            "--capacity", "1024", "--n-sample", "100000"]
N_SUB = 9  # CI determinants of phase 13's chunked-gradient check (70,884 connected rows)
# phase 15: fe2s2_r2_push.main at its defaults (n 5e5, capacity 4096, REDUCE
# 512/128, clip 0.1, --n-cg 50 --sr-damping 1e-3, SGD or AdamW on the exp
# schedule), cut to 1-2 iterations per stage
R2_RUNS = (("64", ["--stage", "64", "--sr", "--iters", "2", "--tag", "_sr"]),
           ("96", ["--stage", "96", "--sr", "--iters", "1"]),
           ("128", ["--stage", "128", "--sr", "--iters", "1"]),
           ("64-slab", ["--stage", "64", "--n-slab", "4", "--iters", "1", "--tag", "_slab"]))
N_TIME = 1024  # samples whose eloc rows time kernel #1 at each r2_push width
# phase 16: the f64 solver check's damping (at 1e-3 plain CG stalls near a
# 1e-6 residual on that S), the dedup'd SIMPLE check's rows, and
# feature_tour.main's keywords: its iteration counts but the CG-SR rung's,
# cut from 100 to 5 steps (the tour took 358 s at 100 on the card, 68 s
# at 10; each step is 100 CG iterations)
SR_DAMP16 = 1e-2
N_DEDUP16 = 64
TOUR_KW = {"n_sr": 5}
# phase 17: the decoder step's sampler (the flagship's, without its
# max_unique), its eloc batch in samples (2048 x 321 forward rows per
# chunk) and the Hubbard ladder's iterations per stage (the JAX example's
# default is 400; cut as PERF.md §4 says)
A8_SAMPLER = dict(n_sample=1_000_000, capacity=4096, dfs_n_group=4, dfs_split_depth=6,
                  dfs_capacity_root=4096)
A8_ELOC_BATCH = 2048
HUB_ITERS = {1: 200, 2: 400, 3: 200, 4: 200}
# phase 18: the flagship step's sampler over the mesh (same tree, 2048 rows
# per rank at two ranks), its steps, and GFMC's walkers and iterations
DP_SAMPLER = dict(n_sample=1_000_000, capacity=4096)
DP_STEPS = 3
DP_WALKERS, DP_GFMC_ITERS = 2048, 3
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_TF32_FLOPS = 495e12  # dense tensor-core peak in TF32
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
F32X3 = "3xtf32"  # the f32 mode on the tensor cores: 3 TF32 products per product
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


def fmt_ms(ms):
    """A time in ms, or "not measured" where there is none."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


MED_TOL = 1e-4  # the median row's |Δlog|ψ|| and phase distance


def hold_rows(k, p, q, tol):
    """Hold a kernel's rows ``k`` [N, 2] against the plain version's ``p``
    at ``tol`` = (log|ψ| tol, phase tol); ``q`` is the plain version
    with f64 sums, which shows how far summation order alone moves each
    row (or a list of such evaluations of the same function: the largest
    move of each row counts; phase 15 adds the f32 evaluation of a bf16
    forward, whose distance is the bf16 plain version's own rounding
    error).  Returns (ok, what was held, stats).

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
    dq = torch.stack([row_errs(x, p)[1] for x in (q if isinstance(q, list) else [q])]).amax(0)
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
            w = re.search(r"fused_rnn_mma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])EE",
                          m.group(1))
            u = re.search(r"pair_select_(band|gather)I([fd])([il])Lb([01])E", m.group(1))
            if w:
                mode = ("flat forward", "prefix parent", "prefix child")[int(w.group(3))]
                warps = (f"{w.group(2)} warps of 16 rows" if w.group(2) != "0"
                         else "warps of 16 rows set at launch")
                width = (f"O {16 * int(w.group(1))} outputs (dp {8 * int(w.group(1))})"
                         if w.group(5) == "0" else
                         f"passes of {16 * int(w.group(1))} outputs (dp > 128)")
                name = f"tensor cores {('bf16', 'f32')[int(w.group(4))]}, {mode}, {width}, {warps}"
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


def flat_regs(dp, mode, warps):
    """(registers, [spill stores, loads] B) of the tensor-core kernel's flat
    forward instantiation at width ``dp`` in ``mode`` ("bf16" or "f32") at
    ``warps`` warps, from ptxas' report of the build."""
    from pynqs_tpu_torch.ops import cuda_build

    ln = [x for x in ptxas_report(cuda_build.BUILD_INFO.get("fused_rnn_mma", ""))
          if f"(dp {dp})" in x and f"tensor cores {mode}, flat forward" in x
          and f"{warps} warps of 16 rows" in x]
    n = int(re.search(r": (\d+) registers", ln[0]).group(1)) if ln else None
    sp = re.search(r"spill stores (\d+) B, loads (\d+) B", ln[0]) if ln else None
    return n, ([int(sp.group(1)), int(sp.group(2))] if sp else [0, 0])


def r5_graph_model(system, dcut_cmpr, dev, seed=14):
    """The r5g64 flagship's shape (dcut 64, 2 predecessors, the tensor
    coupling on the stand-in graph) at another dcut_cmpr, seeded weights."""
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.utils.flagship import flagship_graph

    return GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT_R5, graph=flagship_graph(system, MAXP_R5),
                       phase_mode="arg", norm_mode="mpsrnn", use_tensor=True,
                       dcut_cmpr=dcut_cmpr, dtype=torch.float32, device=dev,
                       generator=torch.Generator().manual_seed(seed))


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

    def step(self, generator, clip_val, sampler=None, gmask=None):
        """VMC.step, synchronized and recorded (host clock)."""
        sync()
        t = time.perf_counter()
        out = saved[1](self, generator, clip_val, sampler, gmask)
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
        flagship.FE2S2_PTH = standin_pth(work)
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

        sh = fused_rnn.mma_launch_shape(m)
        n_reg, spill = flat_regs(96, "bf16", sh["warps"])
        log(11, f"fused forward bf16 dp {fused_rnn.mma_width(a.dcut)} at {n_rows} rows: tensor-core kernel {k_ms:.3f} ms "
                f"({flop / k_ms / 1e9:.2f} TFLOP/s), CUDA-core kernel {prev:.3f} ms "
                f"({prev / k_ms:.2f}x), plain {p_ms:.3f} ms (in chunks of {CH}), bound "
                f"{b11[0]:.3f} ms ({b11[1]}; {flop / 1e12:.3f} TFLOP); {16 * sh['warps']} rows "
                f"per CTA, {sh['smem_bytes']} B shared memory; registers {n_reg}, spill "
                f"stores/loads {spill} B; gpu {smi}")
        # the f32 mode at dp 96 (the script's --fwd-dtype f32) on N_HOLD of
        # the chunk's rows
        f32 = torch.float32
        sub = trows[torch.linspace(0, n_rows - 1, N_HOLD, device=dev).long()]
        before = (fused_rnn.MMA_LAUNCHES.n, fused_rnn.F32_MMA_LAUNCHES.n)
        k_out = fused_rnn.graph_mpsrnn_logpsi_fused(m, sub, matmul_dtype=f32, tables=T)
        sync()
        check((fused_rnn.MMA_LAUNCHES.n, fused_rnn.F32_MMA_LAUNCHES.n)
              == (before[0], before[1] + 1), "the f32 rows did not launch the f32 mode once")
        p_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, sub, matmul_dtype=f32, tables=T)
        q_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, sub, matmul_dtype=f32, tables=T64)
        ok, held, st = hold_rows(k_out, p_out, q_out, tol[f32])
        shx = fused_rnn.mma_launch_shape(m, matmul_dtype=f32)
        n_reg32, spill32 = flat_regs(96, "f32", shx["warps"])
        log(11, f"kernel #1 f32 (3xTF32) dp {fused_rnn.mma_width(a.dcut)} vs plain on {N_HOLD} of "
                f"the chunk's rows: max|dlog|psi|| {st['max_a']:.3e} (tol {tol[f32][0]:g}), max "
                f"phase distance {st['max_p']:.3e}, median row {st['med_a']:.3e} / "
                f"{st['med_p']:.3e}; plain with f64 sums vs plain: max phase distance "
                f"{st['q_max_p']:.3e}; held: {held} (rows over {tol[f32][1]:g}: {st['over']}, "
                f"plain f64 {st['q_over']}); {16 * shx['warps']} rows per CTA, slots in "
                f"{shx['slots']} memory, {shx['smem_bytes']} B shared memory; registers "
                f"{n_reg32}, spill stores/loads {spill32} B")
        check(ok, "kernel #1's f32 mode at dp 96 disagrees with its plain version")
        err32 = st["max_a"]
        del trows, seen, sub, k_out, p_out, q_out

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
                "spill_bytes": spill, "f32_err": err32, "f32_registers": n_reg32,
                "f32_spill_bytes": spill32}
    finally:
        flagship.FE2S2_PTH, vmc_mod.VMC.step, vmc_mod.save_checkpoint = saved
        shutil.rmtree(work, ignore_errors=True)


def standin_pth(work):
    """The stand-in integrals (as the other phases) in a molecule file."""
    from pynqs_tpu_torch.ops.integrals import triangle_size

    irng = np.random.default_rng(0)
    h1e = irng.standard_normal((SORB, SORB)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = irng.standard_normal(triangle_size(SORB)) * 0.01
    pth = os.path.join(work, "fe2s2-standin.pth")
    torch.save({"h1e": torch.as_tensor(h1e.ravel()), "h2e": torch.as_tensor(h2e),
                "sorb": SORB, "noa": NOA, "nob": NOB, "ecore": 0.0}, pth)
    return pth


def refine_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed, time_pairs):
    """Phase 12: the r5g64 state's post-training refinement through the two
    scripts' ``main`` (GFMC, then the CI-NQS polish and its bf16/f32 pair),
    the dedup'd Green row, and kernel #1 on the GFMC trial block.  Writes
    only in a temporary directory."""
    import shutil
    import tempfile

    from pynqs_tpu_torch.ci import nqs_ci
    from pynqs_tpu_torch.energy.eloc import unique_rows
    from pynqs_tpu_torch.gfmc import walker
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.ops import hamiltonian as ham_mod
    from pynqs_tpu_torch.ops import pair_select as ps
    from pynqs_tpu_torch.scripts import fe2s2_ci_polish, fe2s2_gfmc
    from pynqs_tpu_torch.utils import flagship

    bf16 = torch.bfloat16
    ck = os.path.join(here, "checkpoints", "fe2s2_r3_dcut64_r5g64.pkl")
    work = tempfile.mkdtemp(prefix="chip_smoke_refine_")
    saved = (flagship.FE2S2_PTH, nqs_ci.local_energy_reduce,
             fe2s2_ci_polish.local_energy_reduce, ham_mod.pair_select_w)
    passes, pairs = [], []

    def clocked_reduce(orig, where):
        def run(fwd, bits, *a, **k):
            sync()
            t = time.perf_counter()
            out = orig(fwd, bits, *a, **k)
            sync()
            passes.append((where, bits.shape[0], k["k_det"], time.perf_counter() - t))
            return out
        return run

    def pair_select_w(po, pv, hp, *a, **k):
        if not pairs:
            pairs.append((po, pv, hp))
        return saved[3](po, pv, hp, *a, **k)

    counters = {"fused": fused_rnn.LAUNCHES, "fused_mma": fused_rnn.MMA_LAUNCHES,
                "fused_f32_mma": fused_rnn.F32_MMA_LAUNCHES,
                "pair_select_lane": ps.LAUNCHES["lane"],
                "pair_select_rowrow": ps.LAUNCHES["rowrow"]}

    def launches():
        return {k: c.n for k, c in counters.items()}

    try:
        flagship.FE2S2_PTH = standin_pth(work)
        nqs_ci.local_energy_reduce = clocked_reduce(saved[1], "H_nn")
        fe2s2_ci_polish.local_energy_reduce = clocked_reduce(saved[2], "E_VMC")
        ham_mod.pair_select_w = pair_select_w

        # ---- fixed-node GFMC at the runbook's walkers ----
        argv = [ck, *R5_FLAGS, *GFMC_ARGS]
        log(12, f"fe2s2_gfmc.main({' '.join(argv[1:])}) on {os.path.relpath(ck, here)}")
        for c in counters.values():
            c.reset()
        reset_peak()
        out = fe2s2_gfmc.main(argv, device=dev)
        sync()
        l_g = launches()
        peak_g = peak_gib()
        a = fe2s2_gfmc.parser().parse_args(argv)
        n_iter = a.n_iter
        stats = np.concatenate([out["e_gen"], out["e_gen_b"], out["wbar"]])
        check(np.isfinite(stats).all() and len(out["e_gen"]) == n_iter,
              "a non-finite GFMC generation statistic")
        check(all(np.isfinite(e) and np.isfinite(se) for _, e, se in out["mixed"]),
              "a non-finite mixed estimate")
        check(l_g["fused_mma"] > 0 and l_g["fused_mma"] == l_g["fused"],
              f"the GFMC trial forwards did not all go through the tensor-core kernel: {l_g}")
        log(12, f"GFMC {n_iter} iterations, {a.n_walkers} walkers: {out['ms_per_iter']:.1f} "
                f"ms/iter (host clock, the run's {out['seconds']:.3f} s / {n_iter}, nothing "
                f"inside it synchronized); e_gen[0] {out['e_gen'][0]:.6f}, e_gen[-1] "
                f"{out['e_gen'][-1]:.6f}; launches {l_g}; max_memory_allocated {peak_g:.3f} "
                f"GiB; gpu {smi}")
        log(12, "E(p) " + ", ".join(f"p={p}: {e:.6f} +- {se:.2e}" for p, e, se in out["mixed"]))

        # ---- the dedup'd Green row on the run's last walkers ----
        system = flagship.fe2s2_system(np.float32)
        model = flagship.flagship_model(system, 64, use_tensor=True, max_preds=2, device=dev)
        model.load_numpy_params(flagship.load_flagship_params(ck))
        trial = fe2s2_gfmc.trial_forward(model)

        def gfmc_with(cap):
            """A GFMC of the run's walker count with dedup cap ``cap`` (0: off)."""
            return walker.GFMC(trial, system, walker.GFMCConfig(n_walkers=a.n_walkers,
                                                                dedup_unique_max=cap), device=dev)

        # the Green row alone, synchronized around it, outside the run
        wk = torch.as_tensor(out["walkers"], device=dev)
        g_plain = gfmc_with(0)
        plain_row, t_plain = timed(lambda: g_plain.green_row(wk))
        g_ms = t_plain
        trows = plain_row.comb.reshape(-1, SORB)
        n_rows = trows.shape[0]
        n_u = unique_rows(trows)[0].shape[0]
        g_ded = gfmc_with(n_u)
        ded_row, t_ded = timed(lambda: g_ded.green_row(wk))
        check(ded_row.n_unique == n_u, "the dedup'd Green row counted other distinct rows")
        scale = (plain_row.g_off.abs().sum(-1) + plain_row.g_diag.abs()).double()
        d_e = (ded_row.e_loc - plain_row.e_loc).abs().double()
        d_b = (ded_row.b - plain_row.b).abs().double()
        bitwise = torch.equal(ded_row.e_loc, plain_row.e_loc) and torch.equal(ded_row.b,
                                                                             plain_row.b)
        log(12, f"Green row of the last {wk.shape[0]} walkers ({len(np.unique(out['walkers'], axis=0))} "
                f"distinct): {n_rows} trial rows, {n_u} distinct ({n_u / n_rows:.2%}); dedup at "
                f"n_unique_max {n_u}: max|de_loc| {d_e.max().item():.3e}, max|db| "
                f"{d_b.max().item():.3e} (tol 1e-4 x sum|G| per walker), bitwise equal "
                f"{bitwise}; Green row {t_plain:.1f} ms plain, {t_ded:.1f} ms with dedup "
                f"(host clock, synchronized); gpu {smi}")
        check(bool((d_e <= 1e-4 * scale).all() and (d_b <= 1e-4 * scale).all()),
              "the dedup'd Green row disagrees with the plain one")
        try:
            gfmc_with(n_u - 1).green_row(wk)
            raised = False
        except OverflowError:
            raised = True
        check(raised, "a dedup cap one below the distinct-row count did not raise")
        log(12, f"dedup cap {n_u - 1}: OverflowError raised")
        del ded_row, g_plain, g_ded

        # ---- kernel #1 on the trial block ----
        T = fused_rnn.pack_tables(model)
        sub = trows[torch.linspace(0, n_rows - 1, N_HOLD, device=dev).long()]
        k_out = fused_rnn.graph_mpsrnn_logpsi_fused(model, sub, matmul_dtype=bf16, tables=T)
        p_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, sub, matmul_dtype=bf16,
                                                          tables=T)
        q_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
            model, sub, matmul_dtype=bf16, tables={k: v.double() for k, v in T.items()})
        sync()
        ok, held, st = hold_rows(k_out, p_out, q_out, tol[bf16])
        log(12, f"kernel #1 r5g64 vs plain on {N_HOLD} trial-block rows: max|dlog|psi|| "
                f"{st['max_a']:.3e} (tol {tol[bf16][0]:g}), max phase distance "
                f"{st['max_p']:.3e}, median row {st['med_a']:.3e} / {st['med_p']:.3e}; plain "
                f"with f64 sums vs plain: max phase distance {st['q_max_p']:.3e}; held: {held} "
                f"(rows over {tol[bf16][1]:g}: {st['over']}, plain f64 {st['q_over']})")
        check(ok, "kernel #1 disagrees with its plain version on the trial block")
        err = st["max_a"]
        del k_out, p_out, q_out
        CH = 1 << 18

        def plain():
            return torch.cat([fused_rnn.graph_mpsrnn_logpsi_fused_plain(
                model, trows[i:i + CH], matmul_dtype=bf16, tables=T)
                for i in range(0, n_rows, CH)])

        kern = lambda: fused_rnn.graph_mpsrnn_logpsi_fused(model, trows, matmul_dtype=bf16, tables=T)  # noqa: E731
        p1 = cuda_ms(plain, 1)
        k_ms = (cuda_ms(kern, 2) + cuda_ms(kern, 2)) / 2
        p_ms = (p1 + cuda_ms(plain, 1)) / 2
        flop = n_rows * sum(flop_per_site(64, len(p), model.dcut_cmpr) for p in model.preds)
        b_k = bound(flop, n_rows * SORB + n_rows * 2 * 4 + table_bytes(T, bf16), bf16)
        log(12, f"fused forward bf16 r5g64 on the trial block ({n_rows} rows): tensor-core "
                f"kernel {k_ms:.3f} ms ({flop / k_ms / 1e9:.2f} TFLOP/s), plain {p_ms:.3f} ms "
                f"(in chunks of {CH}), bound {b_k[0]:.3f} ms ({b_k[1]}; {flop / 1e12:.3f} "
                f"TFLOP), {k_ms / g_ms:.1%} of a Green row; gpu {smi}")
        del plain_row, trows, sub, model

        # ---- the CI-NQS polish ----
        def polish(args, what):
            argv = [ck, *R5_FLAGS, *args]
            log(12, f"fe2s2_ci_polish.main({' '.join(argv[1:])}) {what}")
            passes.clear()
            for c in counters.values():
                c.reset()
            reset_peak()
            r = fe2s2_ci_polish.main(argv, device=dev)
            sync()
            lc = launches()
            for where, n, kd, s_ in passes:
                log(12, f"  exact-eloc pass {where}: {n} rows x k_det {kd} "
                        f"({n * (1 + kd)} forward rows) {s_:.3f} s")
            for res in r["results"]:
                info = res["info"]
                log(12, f"  m {res['m']}: E_CI-NQS {res['e']:.6f} (E_VMC {r['e_vmc']:.6f}, "
                        f"gain {1e3 * (r['e_vmc'] - res['e']):+.3f} mHa) in {res['seconds']:.1f} s; "
                        f"info {info}")
                check(np.isfinite(res["e"]) and all(np.isfinite(v) for k, v in info.items()
                                                    if k != "restrict"),
                      "a non-finite polish result")
                check(0.0 <= info["captured_complement_fraction"] <= 1.0,
                      f"captured_complement_fraction {info['captured_complement_fraction']}")
            check(np.isfinite(r["e_vmc"]), "non-finite E_VMC")
            log(12, f"  {r['n_live']} live captured rows, dropped {r['dropped']:.3%}; E_VMC pass "
                    f"{r['seconds_vmc']:.3f} s; launches {lc}; max_memory_allocated "
                    f"{peak_gib():.3f} GiB; gpu {smi}")
            check(lc["fused_mma" if "f32" not in args else "fused_f32_mma"] > 0
                  and lc["pair_select_lane"] > 0,
                  f"the polish did not launch kernels #1 (in its mode) and #4: {lc}")
            return r, lc, list(passes)

        pol, l_p, passes_p = polish(POLISH_ARGS, "(bf16)")
        e_pass = [s_ for *_, s_ in passes_p]
        po, pv, hp = pairs[0]
        m_ps, err_ps = time_pairs(12, po, pv, hp, 50, 1000)
        pair, l_pair = {}, {}
        for dt in ("bf16", "f32"):
            pair[dt], l_pair[dt], _ = polish([*PAIR_ARGS, "--fwd-dtype", dt],
                                             f"(the {dt} half of the pair)")
        e16, e32 = pair["bf16"]["results"][0]["e"], pair["f32"]["results"][0]["e"]
        v16, v32 = pair["bf16"]["e_vmc"], pair["f32"]["e_vmc"]
        log(12, f"bf16/f32 pair (m 512): E_CI-NQS bf16 {e16:.6f}, f32 {e32:.6f}, difference "
                f"{(e16 - e32) * 1e3:+.4f} mHa; E_VMC bf16 {v16:.6f}, f32 {v32:.6f}, difference "
                f"{(v16 - v32) * 1e3:+.4f} mHa; gpu {smi}")
        return {"gfmc_launches": l_g["fused_mma"], "err": err, "times": (k_ms, p_ms),
                "bound": b_k, "rows": n_rows, "ms_per_iter": out["ms_per_iter"],
                "polish_lane": l_p["pair_select_lane"], "pair_select": (m_ps, err_ps),
                "pass_s": e_pass, "f32_launches": l_pair["f32"]["fused_f32_mma"]}
    finally:
        (flagship.FE2S2_PTH, nqs_ci.local_energy_reduce, fe2s2_ci_polish.local_energy_reduce,
         ham_mod.pair_select_w) = saved
        shutil.rmtree(work, ignore_errors=True)


def nqsci_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed):
    """Phase 13: the CI ladder on the r5g64 state through the two scripts'
    ``main`` (the HCI precompute at a cut; NqsCi from the repository's
    m-1024 HCI space at full width, f32 and one bf16 iteration; the
    capture -> selected CI route), one NqsCi iteration timed stage by
    stage, kernel #1 on H_nn rows, and the chunked H_cn gradient on a
    sub-block.  Writes only in a temporary directory."""
    import shutil
    import tempfile

    from pynqs_tpu_torch.ci.nqs_ci import NqsCi, NqsCiConfig
    from pynqs_tpu_torch.ci.solve import load_ci
    from pynqs_tpu_torch.ops import cplx, fused_rnn
    from pynqs_tpu_torch.ops.hamiltonian import comb_hij
    from pynqs_tpu_torch.scripts import fe2s2_ci_polish, fe2s2_hci_precompute, fe2s2_nqsci_train
    from pynqs_tpu_torch.utils import flagship
    from pynqs_tpu_torch.utils.checkpoint import load_params
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bf16, f32 = torch.bfloat16, torch.float32
    ck = os.path.join(here, "checkpoints", "fe2s2_r3_dcut64_r5g64.pkl")
    work = tempfile.mkdtemp(prefix="chip_smoke_nqsci_")
    saved = flagship.FE2S2_PTH
    counters = {"fused": fused_rnn.LAUNCHES, "fused_mma": fused_rnn.MMA_LAUNCHES,
                "fused_f32_mma": fused_rnn.F32_MMA_LAUNCHES}

    def launches():
        return {k: c.n for k, c in counters.items()}

    def finite_run(out, what):
        for it, st in enumerate(out["stats"]):
            log(13, f"  {what} iteration {it}: e_tot {st['e_tot']:.6f}, |c_m| "
                    f"{abs(st['c_m']):.6f}, h_nn {st['h_nn']:.6f}, CI mass sum_D |phi(d)|^2 "
                    f"{st['ci_mass']:.6e}, |phi'|^2 = 1 - mass {1.0 - st['ci_mass']:.6e}")
            check(all(np.isfinite(st[k]) for k in ("e_tot", "c_m", "h_nn", "ci_mass")),
                  f"{what}: a non-finite NqsCi iteration {it}: {st}")

    def train(args, what):
        argv = [ck, *R5_FLAGS, *args]
        log(13, f"fe2s2_nqsci_train.main({' '.join(argv[1:])}) {what}")
        for c in counters.values():
            c.reset()
        reset_peak()
        out, ms = timed(lambda: fe2s2_nqsci_train.main(argv, device=dev, root=work))
        lc = launches()
        log(13, f"  m {out['m']}: {len(out['history'])} iterations in {ms / 1e3:.3f} s "
                f"(host clock, synchronized at the ends; the script's own {out['seconds']:.3f} "
                f"s); launches {lc}; max_memory_allocated {peak_gib():.3f} GiB; gpu {smi}")
        finite_run(out, what)
        mode, other = ("fused_mma", "fused_f32_mma") if "bf16" in args else ("fused_f32_mma",
                                                                             "fused_mma")
        check(lc["fused"] > 0 and lc[mode] == lc["fused"] and lc[other] == 0,
              f"{what}: the gradient-free forwards did not all go through kernel #1 on the "
              f"tensor cores in {'bf16' if mode == 'fused_mma' else 'f32 (3xTF32)'}: {lc}")
        return out, lc

    try:
        flagship.FE2S2_PTH = standin_pth(work)

        # ---- (a) the HCI precompute at a cut ----
        log(13, f"fe2s2_hci_precompute.main({' '.join(HCI_ARGS)}) on the stand-in integrals, f64")
        hci, ms = timed(lambda: fe2s2_hci_precompute.main(HCI_ARGS, device=dev, root=work))
        ci_a, meta = load_ci(hci["path"])
        hist = hci["info"]["e_history"]
        log(13, f"  m {hci['m']}, sizes {hci['info']['space_sizes']}, e_var per round "
                f"{['%.8f' % e for e in hist]} in {ms / 1e3:.3f} s; file {os.path.basename(hci['path'])} "
                f"read back: {ci_a.bits.shape} bits, e_var {float(meta['e_var']):.8f}")
        check(np.isfinite(hist).all() and len(hist) > 1
              and all(b < a for a, b in zip(hist, hist[1:])),
              f"the HCI e_var did not fall in every round: {hist}")
        check(ci_a.bits.shape == (hci["m"], SORB) and float(meta["e_var"]) == hci["e_var"]
              and hci["m"] <= 256, "the HCI file did not round-trip through load_ci")

        # ---- (b) NqsCi from the repository's HCI space, full width, f32 ----
        out_b, l_b = train([*NQSCI_ARGS, "--iters", "1", "--tag", "smoke"],
                           "(f32, the repository's m-1024 HCI space)")
        peak_b = peak_gib()
        start = flagship.load_flagship_params(ck)
        after = load_params(out_b["path"])
        check(set(after) == set(start) and any(
            not np.array_equal(np.asarray(after[k]), np.asarray(start[k])) for k in start),
            "the saved NqsCi state did not load or its parameters did not change")
        log(13, f"  saved {os.path.basename(out_b['path'])}: {len(after)} parameter arrays, "
                f"changed from the checkpoint")

        # one more iteration, each stage synchronized (host clock)
        system = flagship.fe2s2_system(np.float32)
        model = flagship.flagship_model(system, 64, use_tensor=True, max_preds=2, device=dev)
        model.load_numpy_params(after)
        a = fe2s2_nqsci_train.parser().parse_args([ck, *R5_FLAGS, *NQSCI_ARGS])
        ci, _ = load_ci(a.ci_file)
        cfg = NqsCiConfig(n_sample=a.n_sample, capacity=a.capacity, lr=a.lr,
                          ci_chunk=a.ci_chunk, eloc_batch=a.eloc_batch, log_every=0)
        reset_peak()
        nq, t_init = timed(lambda: NqsCi(model, system, ci.bits, cfg,
                                         eval_fwd=fe2s2_ci_polish.polish_forward(model, "f32")))
        g = torch.Generator(device=dev).manual_seed(29)
        (bits, w), t_draw = timed(lambda: nq.draw(g))
        (eloc, h_nn), t_nn = timed(lambda: nq.eloc_eval(bits, w))
        peak_nn = peak_gib()
        # the same stage through the CUDA-core kernel (the f32 forward's
        # earlier design), on the same parameters and draw
        nq.eval_fwd = lambda b: fused_rnn._launch_f32_cuda_cores(model, b)
        reset_peak()
        (_, h_nn_cc), t_nn_cc = timed(lambda: nq.eloc_eval(bits, w))
        peak_nn_cc = peak_gib()
        nq.eval_fwd = fe2s2_ci_polish.polish_forward(model, "f32")
        d_hnn = abs(float(h_nn) - float(h_nn_cc)) * 1e3
        log(13, f"h_nn of one iteration, same parameters and draw: tensor-core kernel (3xTF32) "
                f"{float(h_nn):.9f}, CUDA-core kernel {float(h_nn_cc):.9f}, difference "
                f"{d_hnn:.3e} mHa (tol 0.01); the H_nn stage {t_nn:.1f} ms and peak "
                f"{peak_nn:.3f} GiB, through the CUDA-core kernel {t_nn_cc:.1f} ms and "
                f"{peak_nn_cc:.3f} GiB; gpu {smi}")
        check(d_hnn <= 0.01, "h_nn through the f32 mode differs from the CUDA-core kernel's")
        reset_peak()
        (h_cn, ci_mass), t_cn = timed(lambda: nq.hcn_eval())
        (e_tot, c), t_eig = timed(lambda: nq.solve(h_nn, h_cn))
        peak_cn = peak_gib()
        reset_peak()
        _, t_grad = timed(lambda: nq.grad_step(bits, w, eloc, h_nn, c, 1.0))
        peak_grad = peak_gib()
        n_alive = int((w > 0).sum())
        n_sd1 = nq._ci_hij.shape[1]
        n_chunks = -(-nq._ci_flat.shape[0] // a.ci_chunk) + -(-n_alive // a.ci_chunk)
        total = t_draw + t_nn + t_cn + t_eig + t_grad
        log(13, f"one NqsCi iteration, stages synchronized (host clock): setup (the m x (1+n_sd) "
                f"connected block, H_cc) {t_init:.1f} ms; draw {t_draw:.1f} ms ({n_alive} live "
                f"rows outside D of {bits.shape[0]}); H_nn eloc {t_nn:.1f} ms ({n_alive * n_sd1} "
                f"forward rows, f32 kernel #1); no-grad H_cn {t_cn:.1f} ms "
                f"({nq._ci_flat.shape[0]} forward rows); eigensolve {t_eig:.1f} ms (m+1 = "
                f"{nq.m + 1}, f64 on the card); grad step {t_grad:.1f} ms ({nq._ci_flat.shape[0]} "
                f"+ {n_alive} + {nq.m} rows through model.log_psi and autograd in {n_chunks} chunks "
                f"of at most {a.ci_chunk}, {t_grad / n_chunks:.1f} ms per chunk); total {total:.1f} ms; e_tot {e_tot + system.ecore:.6f}, |c_m| "
                f"{abs(c[-1]):.6f}, CI mass {float(ci_mass):.6e}")
        log(13, f"  max_memory_allocated: H_nn stage {peak_nn:.3f} GiB, H_cn + eigensolve "
                f"{peak_cn:.3f} GiB, grad step {peak_grad:.3f} GiB (chunks of {a.ci_chunk} "
                f"rows); the whole main() run {peak_b:.3f} GiB; gpu {smi}")
        split = {"init": t_init, "draw": t_draw, "h_nn": t_nn, "h_cn": t_cn, "eigh": t_eig,
                 "grad": t_grad}

        # ---- (d) kernel #1 on the rows of one H_nn connected block ----
        live = bits[w > 0][:a.eloc_batch]
        comb, _ = comb_hij(live, *system.tables(dev).astuple(), system.tables(dev).hpair_best,
                           table=system.excitation, with_comb=True)
        hrows = comb.reshape(-1, SORB)
        del comb, nq, eloc
        n_rows = hrows.shape[0]
        T = fused_rnn.pack_tables(model)
        sub = hrows[torch.linspace(0, n_rows - 1, N_HOLD, device=dev).long()]
        errs = {}
        for mm in (f32, bf16):
            k_out = fused_rnn.graph_mpsrnn_logpsi_fused(model, sub, matmul_dtype=mm, tables=T)
            p_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, sub, matmul_dtype=mm,
                                                              tables=T)
            q_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
                model, sub, matmul_dtype=mm, tables={k: v.double() for k, v in T.items()})
            sync()
            ok, held, st = hold_rows(k_out, p_out, q_out, tol[mm])
            log(13, f"kernel #1 r5g64 {str(mm).split('.')[-1]} vs plain on {N_HOLD} H_nn rows: "
                    f"max|dlog|psi|| {st['max_a']:.3e} (tol {tol[mm][0]:g}), max phase distance "
                    f"{st['max_p']:.3e}, median row {st['med_a']:.3e} / {st['med_p']:.3e}; plain "
                    f"with f64 sums vs plain: max phase distance {st['q_max_p']:.3e}; held: "
                    f"{held} (rows over {tol[mm][1]:g}: {st['over']}, plain f64 {st['q_over']})")
            check(ok, f"kernel #1 ({mm}) disagrees with its plain version on H_nn rows")
            errs[mm] = st["max_a"]
            if mm == f32:  # the CUDA-core kernel on the same rows
                sp = hold_rows(fused_rnn._launch_f32_cuda_cores(model, sub, T), p_out, q_out,
                               tol[mm])[2]
                log(13, f"  the CUDA-core kernel on the same rows: max|dlog|psi|| "
                        f"{sp['max_a']:.3e}, max phase distance {sp['max_p']:.3e}, median row "
                        f"{sp['med_a']:.3e} / {sp['med_p']:.3e}")
                errs["cuda_cores"] = sp["max_a"]
            del k_out, p_out, q_out
        CH = 1 << 18

        def plain():
            return torch.cat([fused_rnn.graph_mpsrnn_logpsi_fused_plain(
                model, hrows[i:i + CH], matmul_dtype=f32, tables=T)
                for i in range(0, n_rows, CH)])

        def kern(mm):
            return lambda: fused_rnn.graph_mpsrnn_logpsi_fused(model, hrows, matmul_dtype=mm,
                                                               tables=T)

        def cuda_cores():
            return fused_rnn._launch_f32_cuda_cores(model, hrows, T)

        p1 = cuda_ms(plain, 1)
        c1 = cuda_ms(cuda_cores, 1)
        k32 = (cuda_ms(kern(f32), 2) + cuda_ms(kern(f32), 2)) / 2
        c_ms = (c1 + cuda_ms(cuda_cores, 1)) / 2
        k16 = cuda_ms(kern(bf16), 3)
        p_ms = (p1 + cuda_ms(plain, 1)) / 2
        flop = n_rows * sum(flop_per_site(64, len(p), model.dcut_cmpr) for p in model.preds)
        nbytes = n_rows * SORB + n_rows * 2 * 4 + table_bytes(T, f32)
        b_k = bound(flop, nbytes, F32X3)
        b_f32 = bound(flop, nbytes, f32)
        log(13, f"fused forward r5g64 on one eloc batch's H_nn rows ({a.eloc_batch} samples, "
                f"{n_rows} rows): f32 tensor-core kernel (3xTF32) {k32:.3f} ms "
                f"({flop / k32 / 1e9:.2f} TFLOP/s, {k32 / n_rows * 1e6:.1f} ns/row), f32 "
                f"CUDA-core kernel {c_ms:.3f} ms ({c_ms / k32:.2f}x), bf16 tensor-core kernel "
                f"{k16:.3f} ms, plain f32 {p_ms:.3f} ms (in chunks of {CH}), bound {b_k[0]:.3f} ms "
                f"in 3xTF32, {b_f32[0]:.3f} ms on the CUDA cores ({b_k[1]}; {flop / 1e12:.3f} "
                f"TFLOP); the split's max|dlog|psi|| {errs[f32]:.3e} on {N_HOLD} rows (the CUDA "
                f"cores' {errs['cuda_cores']:.3e}); gpu {smi}")
        del hrows, sub, model

        # the bf16 iteration from the same parameters and draw
        out_d, _ = train([*NQSCI_ARGS, "--iters", "1", "--fwd-dtype", "bf16", "--tag", "bf16"],
                         "(bf16, one iteration)")
        e32, e16 = out_b["history"][0], out_d["history"][0]
        log(13, f"  bf16 vs f32, iteration 0 from the same parameters and draw: e_tot bf16 "
                f"{e16:.6f}, f32 {e32:.6f}, difference {(e16 - e32) * 1e3:+.4f} mHa; h_nn "
                f"{(out_d['stats'][0]['h_nn'] - out_b['stats'][0]['h_nn']) * 1e3:+.4f} mHa; "
                f"gpu {smi}")

        # ---- (c) capture -> selected CI -> NqsCi at a cut ----
        out_c, _ = train([*SEL_ARGS, "--tag", "sel"], "(capture -> selected CI, f32)")
        check(0 < out_c["m"] <= 256 and np.isfinite(out_c["e_var"]),
              f"the capture route's selected CI: m {out_c['m']}, e_var {out_c['e_var']}")
        log(13, f"  selected CI from the capture: m {out_c['m']}, e_var {out_c['e_var']:.6f}")

        # ---- (e) the chunked H_cn gradient on a sub-block ----
        model = flagship.flagship_model(system, 64, use_tensor=True, max_preds=2, device=dev)
        model.load_numpy_params(start)
        grads = {}
        for chunk in (4096, None):
            sub_nq = NqsCi(model, system, ci.bits[:N_SUB], NqsCiConfig(
                n_sample=a.n_sample, capacity=a.capacity, ci_chunk=chunk, eloc_batch=256),
                eval_fwd=fe2s2_ci_polish.polish_forward(model, "f32"))
            g = torch.Generator(device=dev).manual_seed(3)
            bits, w = sub_nq.draw(g)
            eloc, h_nn = sub_nq.eloc_eval(bits, w)
            _, c = sub_nq.solve(h_nn, sub_nq.hcn_eval()[0])
            reset_peak()
            grads[chunk], t_g = timed(lambda: sub_nq.gradients(bits, w, eloc, h_nn, c, 1.0))
            log(13, f"  sub-block gradient, {N_SUB} CI rows ({sub_nq._ci_flat.shape[0]} connected "
                    f"rows), chunk {chunk}: {t_g:.1f} ms (host clock, synchronized), "
                    f"max_memory_allocated {peak_gib():.3f} GiB")
        # one H_cn chunk of the main run's size, forward and backward as in
        # NqsCi.gradients, timed and then under the profiler: how much of it
        # the card is busy, and in which kernels
        rows = sub_nq._ci_flat[:a.ci_chunk]
        params = list(model.parameters())

        def one_chunk():
            return torch.autograd.grad(cplx.exp_pair(model.log_psi(rows))[0].sum(), params,
                                       allow_unused=True)

        one_chunk()
        _, t_chunk = timed(one_chunk)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, t_prof = timed(one_chunk)
        kerns = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kerns) / 1e3
        log(13, f"  one gradient chunk of {rows.shape[0]} connected rows: {t_chunk:.1f} ms "
                f"(host clock, synchronized); profiled {t_prof:.1f} ms wall, "
                f"{sum(e.count for e in kerns)} kernels taking {busy:.1f} ms of device time: "
                f"busy {busy / t_chunk:.1%} of the unprofiled chunk; gpu {smi}")
        for e in kerns[:5]:
            log(13, f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:90]}")
        big = max(float(x.abs().max()) for x in grads[None])
        d = max(float((x - y).abs().max()) for x, y in zip(grads[4096], grads[None]))
        log(13, f"chunked (4096 rows) vs one-chunk H_cn gradient: max |d| {d:.3e}, largest "
                f"entry {big:.3e}, ratio {d / big:.3e} (tol 1e-5)")
        check(big > 0 and d <= 1e-5 * big, "the chunked H_cn gradient differs from one chunk")
        return {"launches": l_b["fused_f32_mma"], "err": errs[f32], "times": (k32, p_ms),
                "bound": b_k, "bound_f32": b_f32, "prev_ms": c_ms, "rows": n_rows,
                "bf16_ms": k16, "split": split, "de_bf16": e16 - e32, "d_hnn_mha": d_hnn}
    finally:
        flagship.FE2S2_PTH = saved
        shutil.rmtree(work, ignore_errors=True)


def sr_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed):
    """Phase 15: the SR trainer through ``fe2s2_r2_push.main`` at the
    script's defaults on the stand-in integrals (read through the default
    system path), each run in ``R2_RUNS``: its steps finite with w_sum 1,
    its eloc forwards through kernel #1's tensor-core walk alone, each
    step split by stage (synchronized), the CG residual of every SR solve
    by one more matvec, peak memory; kernel #1 held to its plain version
    and timed at each width on the eloc rows of ``N_TIME`` samples; the
    slabbed sampler's rows unique with counts summing to n_sample less
    the dropped count.  Writes only in a temporary directory."""
    import shutil
    import tempfile

    from pynqs_tpu_torch.energy.eloc import local_energy_reduce, unique_rows
    from pynqs_tpu_torch.grad import sr
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.optim import vmc as vmc_mod
    from pynqs_tpu_torch.sampler.ar import ar_sampling_slabbed
    from pynqs_tpu_torch.scripts import fe2s2_r2_push
    from pynqs_tpu_torch.utils import flagship

    bf16 = torch.bfloat16
    V = vmc_mod.VMC
    work = tempfile.mkdtemp(prefix="chip_smoke_sr_")
    saved = (flagship.FE2S2_PTH, V.step, V._sample, V.local_energy, V.sr_gradient,
             V.apply_gradients)
    steps, cur, last = [], {}, {}
    counters = {"fused": fused_rnn.LAUNCHES, "fused_mma": fused_rnn.MMA_LAUNCHES,
                "fused_f32_mma": fused_rnn.F32_MMA_LAUNCHES}

    def launches():
        lc = {k: c.n for k, c in counters.items()}
        lc["cuda_cores"] = lc["fused"] - lc["fused_mma"] - lc["fused_f32_mma"]
        return lc

    def clocked(name, orig):
        def run(self, *a, **k):
            out, ms = timed(lambda: orig(self, *a, **k))
            cur[name] = cur.get(name, 0.0) + ms
            return out
        return run

    def sr_gradient(self, bits, w, eloc):
        """The step's SR solve, timed; then its CG residual by one more
        matvec at the same parameters (timed apart, not in the step)."""
        x, ms = timed(lambda: saved[4](self, bits, w, eloc))
        cur["sr"] = cur.get("sr", 0.0) + ms
        res, ms_r = timed(lambda: sr.cg_residual(self.model, bits, w, eloc, x,
                                                   self.cfg.sr_damping, self.cfg.grad_batch))
        cur["residual"] = cur.get("residual", 0.0) + ms_r
        last.update(bits=bits, w=w, eloc=eloc, residual=float(res))
        return x

    def step(self, generator, clip_val, sampler=None, gmask=None):
        cur.clear()
        out, ms = timed(lambda: saved[1](self, generator, clip_val, sampler, gmask))
        steps.append({"ms": ms - cur.get("residual", 0.0), "split": dict(cur),
                      "energy": float(out["energy"]), "w_sum": float(out["w_sum"]),
                      "dropped": float(out["dropped_frac"]), "n_unique": int(out["n_unique"]),
                      "lr": out["lr"], "gnorm": float(out["gnorm"]),
                      "residual": last.get("residual")})
        return out

    def eloc_rows(v, bits):
        """The rows the eloc forward of ``bits`` hands the kernel."""
        seen = []

        def fwd(b):
            seen.append(b)
            return torch.zeros(b.shape[0], 2, device=b.device)

        local_energy_reduce(fwd, bits, v._ops, v._table, torch.Generator(device=dev).manual_seed(15),
                            k_det=v.cfg.eloc_k_det, n_stoch=v.cfg.eloc_n_stoch, hpair=v._hpair)
        return torch.cat(seen)

    def hold_and_time(name, v):
        """Kernel #1 on the eloc rows of the run's last N_TIME samples: held
        on N_HOLD of them, timed on all beside the plain version."""
        m = v.model
        trows = eloc_rows(v, last["bits"][:N_TIME])
        n_rows = trows.shape[0]
        T = fused_rnn.pack_tables(m)
        T64 = {key: t.double() for key, t in T.items()}
        sub = trows[torch.linspace(0, n_rows - 1, N_HOLD, device=dev).long()]
        k_out = fused_rnn.graph_mpsrnn_logpsi_fused(m, sub, matmul_dtype=bf16, tables=T)
        p_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, sub, matmul_dtype=bf16, tables=T)
        q_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, sub, matmul_dtype=bf16, tables=T64)
        f_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, sub, matmul_dtype=torch.float32,
                                                          tables=T)
        q_p, f_p = row_errs(q_out, p_out)[1], row_errs(f_out, p_out)[1]
        ok, held, st = hold_rows(k_out, p_out, [q_out, f_out], tol[bf16])
        dp = fused_rnn.mma_width(m.dcut)
        log(15, f"  kernel #1 dp {dp} vs plain on {N_HOLD} of the {n_rows} eloc rows: max|dlog|psi|| "
                f"{st['max_a']:.3e} (tol {tol[bf16][0]:g}), max phase distance {st['max_p']:.3e}, "
                f"median row {st['med_a']:.3e} / {st['med_p']:.3e}; plain vs plain with f64 sums: "
                f"max phase distance {q_p.max().item():.3e} ({int((q_p > tol[bf16][1]).sum())} "
                f"rows over {tol[bf16][1]:g}), vs the f32 evaluation (the bf16 plain version's own "
                f"rounding error) {f_p.max().item():.3e} ({int((f_p > tol[bf16][1]).sum())} rows "
                f"over); held: {held} (kernel rows over {tol[bf16][1]:g}: {st['over']})")
        check(ok, f"{name}: kernel #1 at dp {dp} disagrees with its plain version")
        del k_out, p_out, q_out, f_out, sub
        CH = 1 << 18

        def plain():
            return torch.cat([fused_rnn.graph_mpsrnn_logpsi_fused_plain(
                m, trows[i:i + CH], matmul_dtype=bf16, tables=T) for i in range(0, n_rows, CH)])

        kern = lambda: fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=bf16, tables=T)  # noqa: E731
        kern()
        p1, k1, k2, p2 = cuda_ms(plain, 1), cuda_ms(kern, 3), cuda_ms(kern, 3), cuda_ms(plain, 1)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = n_rows * (SORB // 2) * flop_per_site(m.dcut, 1)
        b = bound(flop, n_rows * SORB + n_rows * 2 * 4 + table_bytes(T, bf16), bf16)
        sh = fused_rnn.mma_launch_shape(m)
        n_reg, spill = flat_regs(dp, "bf16", sh["warps"])
        log(15, f"  fused forward bf16 dp {dp} on {n_rows} rows: tensor-core kernel {k_ms:.3f} ms "
                f"({flop / k_ms / 1e9:.2f} TFLOP/s), plain {p_ms:.3f} ms (in chunks of {CH}), "
                f"bound {b[0]:.3f} ms ({b[1]}); {16 * sh['warps']} rows per CTA, "
                f"{sh['smem_bytes']} B shared memory; registers {n_reg}, spill stores/loads "
                f"{spill} B; gpu {smi}")
        return {"err": st["max_a"], "times": (k_ms, p_ms), "bound": b, "rows": n_rows,
                "registers": n_reg, "spill_bytes": spill}

    out = {}
    try:
        flagship.FE2S2_PTH = standin_pth(work)
        ckd = os.path.join(work, "checkpoints")
        os.makedirs(ckd)
        for src, dst in (("fe2s2_dcut64.pkl", "fe2s2_dcut64.pkl"),
                         ("fe2s2_r2_dcut64.pkl", "fe2s2_r2_dcut64.pkl"),
                         ("fe2s2_r2_dcut96_final.pkl", "fe2s2_r2_dcut96.pkl")):
            shutil.copy(os.path.join(here, "checkpoints", src), os.path.join(ckd, dst))
        V.step, V.sr_gradient = step, sr_gradient
        V._sample = clocked("sample", saved[2])
        V.local_energy = clocked("eloc", saved[3])
        V.apply_gradients = clocked("update", saved[5])
        a = fe2s2_r2_push.parser().parse_args([])
        log(15, f"fe2s2_r2_push at its defaults: n_sample {a.n_sample}, capacity {a.capacity}, "
                f"REDUCE k_det 512 / n_stoch 128, clip 0.1, exp schedule {a.lr:g} -> "
                f"{a.lr_end:g}; --sr: CG min-SR with n_cg {a.n_cg}, damping {a.sr_damping:g}, "
                f"SGD; the stand-in integrals through the default system path")
        for name, argv in R2_RUNS:
            for c in counters.values():
                c.reset()
            steps.clear()
            last.clear()
            reset_peak()
            r, ms = timed(lambda: fe2s2_r2_push.main(argv, device=dev, root=work))
            lc, peak = launches(), peak_gib()
            v = r["vmc"]
            use_sr = "--sr" in argv
            log(15, f"({name}) fe2s2_r2_push.main({' '.join(argv)}): dcut {v.model.dcut}, "
                    f"{len(steps)} step(s) in {ms / 1e3:.3f} s with set-up; launches {lc}; "
                    f"max_memory_allocated {peak:.3f} GiB; gpu {smi}")
            for i, st in enumerate(steps):
                sp = ", ".join(f"{k} {t:.1f} ms" for k, t in st["split"].items()
                               if k != "residual")
                rest = st["ms"] - sum(t for k, t in st["split"].items() if k != "residual")
                sp += f", the rest {rest:.1f} ms" + ("" if use_sr else " (the gradient)")
                log(15, f"  step {i}: E {st['energy']:.6f} w_sum {st['w_sum']:.8f} dropped "
                        f"{st['dropped']:.3e} live {st['n_unique']} lr {st['lr']:.6e} gnorm "
                        f"{st['gnorm']:.3e}; {st['ms'] / 1e3:.3f} s (synchronized: {sp})"
                        + (f"; CG residual |(S+l)x-F|/|F| after {a.n_cg} iterations "
                           f"{st['residual']:.3e} ({st['split']['residual']:.1f} ms)"
                           if use_sr else ""))
            check(len(steps) == int(argv[argv.index("--iters") + 1]),
                  f"({name}) the run took {len(steps)} steps")
            check(all(np.isfinite(st["energy"]) and abs(st["w_sum"] - 1.0) <= 1e-5
                      for st in steps), f"({name}) non-finite energy or w_sum != 1")
            check(lc["fused_mma"] > 0 and lc["cuda_cores"] == 0 and lc["fused_f32_mma"] == 0,
                  f"({name}) the eloc forwards did not all go through the tensor-core walk in "
                  f"bf16: {lc}")
            if use_sr:
                check(all(np.isfinite(st["residual"]) for st in steps),
                      f"({name}) a non-finite CG residual")
            rec = {"launches": lc["fused_mma"], "steps": [dict(st) for st in steps],
                   "peak": peak}
            if name != "64-slab":
                rec.update(hold_and_time(name, v))
            else:
                g = torch.Generator(device=dev).manual_seed(15)
                sb, counts, dropped = ar_sampling_slabbed(v.model, a.n_sample,
                                                          capacity=a.capacity, n_slab=4,
                                                          generator=g)
                live = counts > 0
                n_live = int(live.sum())
                n_distinct = unique_rows(sb[live])[0].shape[0]
                total = int(counts.sum()) + int(dropped)
                log(15, f"  slabbed sampler (4 slabs of capacity {a.capacity}): {n_live} live "
                        f"rows, {n_distinct} distinct; counts sum {int(counts.sum())} + dropped "
                        f"{int(dropped)} = {total} (n_sample {a.n_sample})")
                check(n_live == n_distinct and total == a.n_sample,
                      "the slabbed rows are not unique, or their counts do not sum to "
                      "n_sample less the dropped count")
            if name == "64":
                out["sr_inputs"] = (v.model, last["bits"], last["w"], last["eloc"])
            out[name] = rec
        return out
    finally:
        (flagship.FE2S2_PTH, V.step, V._sample, V.local_energy, V.sr_gradient,
         V.apply_gradients) = saved
        shutil.rmtree(work, ignore_errors=True)


def tour_run(dev, smi, system, f15, timed):
    """Phase 16: the three SR solvers held to each other in f64 on the card;
    the f32 CG on phase 15's dcut-64 samples beside the same CG in f64;
    one call each of the MCMC, Gumbel and RESTRICTED samplers on the
    dcut-64 state; ``local_energy_simple_dedup`` against
    ``local_energy_simple``; the ported feature tour at ``TOUR_KW``."""
    from pynqs_tpu_torch.energy.eloc import (
        local_energy_simple,
        local_energy_simple_dedup,
        unique_rows,
    )
    from pynqs_tpu_torch.examples import feature_tour
    from pynqs_tpu_torch.grad import sr
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.ops import cplx, fused_rnn
    from pynqs_tpu_torch.ops.hamiltonian import comb_hij
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar import ar_sampling_gumbel, gumbel_importance_weights
    from pynqs_tpu_torch.sampler.mcmc import MCMCSampler
    from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
    from pynqs_tpu_torch.utils.fci import fci_bits

    f64, f32 = torch.float64, torch.float32

    def rel(x, y):
        """max |x − y| over the parameters / max |y|."""
        return (max(float((x[k] - y[k]).abs().max()) for k in y)
                / max(float(y[k].abs().max()) for k in y))

    # ---- the solvers in f64 on a small chain model ----
    sm = GraphMPSRNN(12, 3, 3, dcut=2, phase_mode="arg", norm_mode="mpsrnn", dtype=f64,
                     device=dev, generator=torch.Generator().manual_seed(16))
    P = sum(p.numel() for p in sm.parameters())
    rng = np.random.default_rng(16)
    bits = torch.as_tensor(fci_bits(12, 3, 3)[rng.permutation(400)[:300]], device=dev)
    w = rng.random(300)
    w[::7] = 0.0
    w = torch.as_tensor(w / w.sum(), device=dev)
    el = torch.as_tensor(rng.standard_normal((300, 2)), device=dev)
    names = [n for n, _ in sm.named_parameters()]
    dense, t_d = timed(lambda: sr.sr_gradient(sm, bits, w, el, damping=SR_DAMP16))
    one, _ = timed(lambda: sr.sr_gradient_blocked(sm, bits, w, el, damping=SR_DAMP16,
                                                  blocks={n: 0 for n in names}))
    _, t_b = timed(lambda: sr.sr_gradient_blocked(sm, bits, w, el, damping=SR_DAMP16))
    cg, t_c = timed(lambda: sr.sr_gradient_cg(sm, bits, w, el, damping=SR_DAMP16, n_cg=2 * P))
    res = float(sr.cg_residual(sm, bits, w, el, cg, damping=SR_DAMP16))
    e_b, e_c = rel(one, dense), rel(cg, dense)
    log(16, f"SR solvers in f64 on the card: chain sorb 12 dcut 2, P {P}, {bits.shape[0]} rows "
            f"({int((w > 0).sum())} live), damping {SR_DAMP16:g}: blocked with one block vs "
            f"dense {e_b:.3e} (tol 1e-10), CG with n_cg = 2P = {2 * P} vs dense {e_c:.3e} (tol "
            f"1e-8; residual {res:.3e}); dense {t_d:.1f} ms, blocked per tensor {t_b:.1f} ms, "
            f"CG {t_c:.1f} ms")
    check(e_b <= 1e-10 and e_c <= 1e-8, "the SR solvers disagree in f64")

    # ---- the f32 CG on phase 15's dcut-64 samples beside f64 ----
    m32, sb, sw, sel = f15["sr_inputs"]
    m64 = GraphMPSRNN(SORB, NOA, NOB, dcut=m32.dcut, phase_mode="arg", norm_mode="mpsrnn",
                      dtype=f64, device=dev).load_numpy_params(
        {k: p.detach().cpu().numpy() for k, p in m32.named_parameters()})
    x32, t32 = timed(lambda: sr.sr_gradient_cg(m32, sb, sw, sel, damping=1e-3, n_cg=50))
    x64, t64 = timed(lambda: sr.sr_gradient_cg(m64, sb, sw.double(), sel.double(), damping=1e-3,
                                               n_cg=50))
    r32 = float(sr.cg_residual(m32, sb, sw, sel, x32, damping=1e-3))
    r64 = float(sr.cg_residual(m64, sb, sw.double(), sel.double(), x64, damping=1e-3))
    num = sum(float(((x32[k].double() - x64[k]) ** 2).sum()) for k in x64)
    den = sum(float((x64[k] ** 2).sum()) for k in x64)
    log(16, f"CG (n_cg 50, damping 1e-3) on phase 15's dcut-64 samples ({sb.shape[0]} rows, "
            f"{int((sw > 0).sum())} live, P {sum(p.numel() for p in m32.parameters())}): f32 "
            f"{t32:.1f} ms, residual {r32:.3e}; f64 {t64:.1f} ms, residual {r64:.3e}; "
            f"|x32 - x64| / |x64| {np.sqrt(num / den):.3e}")
    check(np.isfinite(r32) and np.isfinite(r64) and r32 < 1 and r64 < 1
          and all(bool(torch.isfinite(x).all()) for x in x32.values()),
          "the f32 or f64 CG did not reduce the residual")
    del m64, x64

    # ---- the samplers on the dcut-64 state ----
    g = torch.Generator(device=dev).manual_seed(16)
    mc = MCMCSampler(SORB, NOA, NOB, n_chain=1024, n_sweep=32)
    st = mc.init_state(m32, g)
    (mb, mw, md, _), ms = timed(lambda: mc.sample(m32, g, st))
    kept = bool(((mb[:, 0::2].sum(1) == NOA) & (mb[:, 1::2].sum(1) == NOB)).all())
    log(16, f"MCMC: {mc.n_chain} chains x {mc.n_sweep} sweeps (p_double {mc.p_double}) in "
            f"{ms:.1f} ms; acceptance {float(md['acc_rate']):.4f}; (noa, nob) kept: {kept}; "
            f"{unique_rows(mb)[0].shape[0]} distinct rows")
    check(kept and abs(float(mw.sum()) - 1) <= 1e-5, "MCMC left the (noa, nob) sector")
    (gb, lq, gG, alive), ms = timed(lambda: ar_sampling_gumbel(m32, 4096, g))
    gw, keep = gumbel_importance_weights(lq, gG, alive)
    n_alive = int(alive.sum())
    distinct = unique_rows(gb[alive])[0].shape[0]
    log(16, f"Gumbel beam at capacity 4096 in {ms:.1f} ms: {n_alive} alive, {distinct} distinct, "
            f"{int(keep.sum())} kept; sum of the weights {float(gw.sum()):.6f} (an estimate "
            f"of 1)")
    check(distinct == n_alive and bool(torch.isfinite(gw).all()) and float(gw.sum()) > 0,
          "the Gumbel rows are not distinct or their weights not finite")
    states = sb[sw > 0].cpu().numpy()
    rs = RestrictedSampler(SORB, NOA, NOB, states=states)
    vr = VMC(m32, system, rs, VMCConfig(lr=1e-4, eloc_method="reduce", eloc_k_det=512,
                                        eloc_n_stoch=128, clip_grad=0.1))
    for c in (fused_rnn.LAUNCHES, fused_rnn.MMA_LAUNCHES):
        c.reset()
    o, ms = timed(lambda: vr.step(torch.Generator(device=dev).manual_seed(16), 0.1))
    lr_ = (fused_rnn.LAUNCHES.n, fused_rnn.MMA_LAUNCHES.n)
    log(16, f"RESTRICTED on phase 15's {rs.n_states} unique rows, one VMC step (REDUCE 512/128, "
            f"Adam): E {float(o['energy']):.6f} w_sum {float(o['w_sum']):.8f} in {ms:.1f} ms; "
            f"kernel #1 launches (all, tensor cores bf16) {lr_}")
    check(np.isfinite(float(o["energy"])) and abs(float(o["w_sum"]) - 1) <= 1e-5
          and lr_[1] > 0 and lr_[0] == lr_[1], "the RESTRICTED step failed")

    # ---- the dedup'd SIMPLE local energy ----
    tabs = system.tables(dev, f32)
    ops, table = tabs.astuple(), system.excitation
    fwd = lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(m32, b, matmul_dtype=f32)  # noqa: E731
    rows = sb[sw > 0][:N_DEDUP16]
    e_s = local_energy_simple(fwd, rows, ops, table, hpair=tabs.hpair_best)
    (e_d, n_u), ms = timed(lambda: local_energy_simple_dedup(
        fwd, rows, ops, table, n_unique_max=rows.shape[0] * (1 + table.n_sd),
        hpair=tabs.hpair_best))
    comb, hij = comb_hij(rows, *ops, tabs.hpair_best, table=table)
    lp = fwd(comb.reshape(-1, SORB)).reshape(comb.shape[0], comb.shape[1], 2)
    rr, ri = cplx.ratio_re_im(lp, lp[:, :1])
    scale = (hij.abs() * torch.sqrt(rr**2 + ri**2)).sum(-1)
    d = ((e_s - e_d).abs().max(-1).values / scale).max().item()
    log(16, f"local_energy_simple_dedup vs local_energy_simple on {rows.shape[0]} rows "
            f"({comb.shape[0] * comb.shape[1]} connected, {n_u} distinct) in {ms:.1f} ms: max "
            f"|dE|/sum|h r| {d:.3e} (tol 1e-5)")
    check(d <= 1e-5, "the dedup'd SIMPLE local energy differs")
    del comb, hij, lp, rr, ri

    # ---- the feature tour ----
    tour, ms = timed(lambda: feature_tour.main(device=dev, **TOUR_KW))
    log(16, f"feature_tour.main({TOUR_KW or 'defaults'}) in {ms / 1e3:.1f} s: "
            + ", ".join(f"{k} {v:.6f}" for k, v in tour.items()))
    check(all(np.isfinite(v) for v in tour.values()), "a non-finite feature-tour energy")
    for rung in ("vmc", "sr"):
        check(tour[rung] >= tour["fci"] - 5 * tour[f"{rung}_se"],
              f"the tour's {rung} tail mean {tour[rung]} lies more than 5 s.e. below FCI")
    return {"tour_s": ms / 1e3}


def a8_run(dev, smi, system, tol, timed, time_pairs, bound, flop_per_site, table_bytes):
    """Phase 17: the other ansätze on the card (see the module docstring).
    Returns the two kernel entries' numbers: kernel #4 on the decoder's
    ⟨S⁻S⁺⟩ chunk and kernel #1 on hubbard_ladder stage 4's eloc rows."""
    from pynqs_tpu_torch import models as M
    from pynqs_tpu_torch.energy.eloc import local_energy_simple
    from pynqs_tpu_torch.examples import hubbard_ladder
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.ops import hamiltonian as ham_mod
    from pynqs_tpu_torch.ops import pair_select as ps
    from pynqs_tpu_torch.ops.integrals import precompute_hij_tables, spin_raising
    from pynqs_tpu_torch.optim import vmc as vmc_mod
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler import ar
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
    from pynqs_tpu_torch.sampler.exact import ExactSampler
    from pynqs_tpu_torch.sampler.mcmc import MCMCSampler
    from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp
    from pynqs_tpu_torch.utils.system import System

    f32, bf16 = torch.float32, torch.bfloat16
    V = vmc_mod.VMC
    saved = (V._sample, V.local_energy, V.apply_gradients, vmc_mod.energy_and_grad)
    cur, last = {}, {}

    def clocked(name, orig):
        def run(*a, **k):
            out, ms = timed(lambda: orig(*a, **k))
            cur[name] = cur.get(name, 0.0) + ms
            if name == "sample":
                last["bits"], last["w"] = out[0], out[1]
            return out
        return run

    @torch.no_grad()
    def cache_walk(model, rows):
        """max |Σ_k masked log p_k(x_k) − 2·log|ψ(x)|| over ``rows``: the
        KV-cached walk against the teacher-forced pass."""
        nps, _, n_steps, order = ar._layout(model)
        r = rows.long()
        carry = model.ar_init(r.shape[0])
        prev = torch.zeros(r.shape[0], dtype=torch.long, device=dev)
        ua, ub = prev.clone(), prev.clone()
        tot = torch.zeros(r.shape[0], dtype=f32, device=dev)
        for k in range(n_steps):
            logp, carry = model.ar_step(carry, k, prev)
            logp = apply_mask_logp(logp, ar._step_mask(model, k, ua, ub))
            v = r[:, 2 * order[k]] + 2 * r[:, 2 * order[k] + 1] if nps == 2 else r[:, k]
            tot += logp.gather(-1, v[:, None])[:, 0]
            _, ua, ub = ar._place(model, k, r.clone(), ua, ub, v)
            prev = v
        return (tot - 2 * model.log_psi(rows)[:, 0]).abs().max().item()

    sampler = ARSampler(SORB, NOA, NOB, **A8_SAMPLER)
    cfg = VMCConfig(lr=1e-4, optimizer="adamw", eloc_method="reduce", eloc_k_det=K_DET,
                    eloc_n_stoch=N_STOCH, eloc_topk="segmax", eloc_batch=A8_ELOC_BATCH,
                    clip_grad=1.0)

    def train(name, model, n_steps, seed):
        """n_steps ``VMC.step``s, each synchronized and split by stage; the
        checks; the cache walk on the last step's sampled rows."""
        v = VMC(model, system, sampler, cfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        steps = []
        for i in range(n_steps):
            cur.clear()
            reset_peak()
            out, ms = timed(lambda: v.step(g, cfg.clip_grad))
            st = {"ms": ms, "split": dict(cur), "peak": peak_gib(),
                  "energy": float(out["energy"]) + system.ecore, "w_sum": float(out["w_sum"])}
            sp = ", ".join(f"{k} {t:.1f} ms" for k, t in st["split"].items())
            log(17, f"({name}) step {i}: E {st['energy']:.6f} w_sum {st['w_sum']:.8f} dropped "
                    f"{float(out['dropped_frac']):.3e} live {int(out['n_unique'])}; "
                    f"{ms / 1e3:.3f} s (synchronized: {sp}, the rest "
                    f"{ms - sum(cur.values()):.1f} ms); max_memory_allocated "
                    f"{st['peak']:.3f} GiB; gpu {smi}")
            check(np.isfinite(st["energy"]) and abs(st["w_sum"] - 1.0) <= 1e-5,
                  f"({name}) step {i}: non-finite energy or w_sum != 1")
            steps.append(st)
        rows = last["bits"][last["w"] > 0]
        err, ms = timed(lambda: cache_walk(model, rows))
        log(17, f"({name}) KV-cached ar_step walk along {rows.shape[0]} sampled rows vs "
                f"log_psi: max|sum log p - 2 log|psi|| {err:.3e} (tol 1e-4; {ms:.1f} ms)")
        check(rows.shape[0] >= 4096 and err <= 1e-4,
              f"({name}) the cache walk disagrees with log_psi ({err}) or too few rows")
        return v, steps

    out = {}
    V._sample = clocked("sample", saved[0])
    V.local_energy = clocked("eloc", saved[1])
    V.apply_gradients = clocked("update", saved[2])
    vmc_mod.energy_and_grad = clocked("gradient", saved[3])
    try:
        # ---- (a) the GPT decoder at the JAX defaults ----
        dec = M.DecoderWavefunction(SORB, NOA, NOB, dtype=f32, device=dev,
                                    generator=torch.Generator().manual_seed(17))
        log(17, f"decoder: n_layer {dec.n_layer}, n_head {dec.n_head}, d_model {dec.d_model}, "
                f"phase_hidden {dec.phase_hidden}, {dec.norm_method}, "
                f"{sum(p.numel() for p in dec.parameters())} parameters, f32; sampler "
                f"{A8_SAMPLER}; REDUCE {K_DET}/{N_STOCH} segmax, eloc batch {A8_ELOC_BATCH}; "
                f"AdamW lr 1e-4")
        v_dec, out["decoder_steps"] = train("decoder", dec, 3, 171)

        # <S-S+> through the dense pair matrix: kernel #4 (lane)
        first = {}
        orig_psw = ham_mod.pair_select_w

        def psw(*a, **k):
            first.setdefault("args", a)
            return orig_psw(*a, **k)

        for c in ps.LAUNCHES.values():
            c.reset()
        ham_mod.pair_select_w = psw
        try:
            op, ms = timed(lambda: v_dec.operator_expected(
                spin_raising(SORB), torch.Generator(device=dev).manual_seed(172)))
        finally:
            ham_mod.pair_select_w = orig_psw
        l17 = {k: c.n for k, c in ps.LAUNCHES.items()}
        log(17, f"<S-S+> of the trained decoder through operator_expected: {op} in "
                f"{ms / 1e3:.3f} s; pair selection launches {l17}")
        check(l17["lane"] > 0 and l17["rowrow"] == 0, f"<S-S+> pair selection launches {l17}")
        check(np.isfinite(op.mean.real) and op.mean.real > -5 * op.se,
              f"<S-S+> = {op.mean} below -5 s.e. ({op.se})")
        po, pv, hp = first["args"][:3]
        t_op = precompute_hij_tables(*spin_raising(SORB), SORB, system.dtype)
        check(torch.equal(hp, torch.as_tensor(t_op.Hpair, device=dev).to(hp.dtype)),
              "the <S-S+> chunk's pair matrix is not the operator's")
        for vv in ps.VARIANTS:
            check(torch.equal(ps.pair_select_w(po, pv, hp, variant=vv),
                              ps.pair_select_w_plain(po, pv, hp, variant=vv)),
                  f"pair selection {vv} != plain on the <S-S+> chunk")
        out["pairs"], out["pairs_err"] = time_pairs(17, po, pv, hp, 20, 100)
        out["pairs_launches"] = l17["lane"]
        del v_dec, dec, po, pv, hp

        # ---- (b) the MPS-Transformer at its defaults ----
        mdec = M.MPSDecoder(SORB, NOA, NOB, dtype=f32, device=dev,
                            generator=torch.Generator().manual_seed(173))
        log(17, f"MPSDecoder: dcut {mdec.dcut}, n_layer {mdec.n_layer}, n_head {mdec.n_head}, "
                f"d_model {mdec.d_model}, pmode {mdec.pmode}, "
                f"{sum(p.numel() for p in mdec.parameters())} parameters, f32")
        out["mpsdec_steps"] = train("MPSDecoder", mdec, 2, 174)[1]
        del mdec
    finally:
        V._sample, V.local_energy, V.apply_gradients, vmc_mod.energy_and_grad = saved

    # ---- (c) the Hubbard ladder, stages 1-4 ----
    for stage in (1, 2, 3, 4):
        for c in (fused_rnn.LAUNCHES, fused_rnn.MMA_LAUNCHES, fused_rnn.F32_MMA_LAUNCHES):
            c.reset()
        res, ms = timed(lambda: hubbard_ladder.main(
            ["--stage", str(stage), "--iters", str(HUB_ITERS[stage])], device=dev))
        lc = (fused_rnn.LAUNCHES.n, fused_rnn.MMA_LAUNCHES.n, fused_rnn.F32_MMA_LAUNCHES.n)
        log(17, f"hubbard_ladder stage {stage} ({HUB_ITERS[stage]} iterations of 400): FCI "
                f"{res['fci']:.6f} ({res['n_fci']} dets), VMC mean(20) {res['tail']:.6f}, gap "
                f"{res['gap_mha']:+.3f} mHa; {ms / 1e3:.2f} s ({ms / HUB_ITERS[stage]:.1f} ms per "
                f"iteration); fused forward launches (all, bf16, f32) {lc}; gpu {smi}")
        check(all(np.isfinite(res["history"])), f"stage {stage}: a non-finite energy")
        if stage != 4:
            continue
        check(lc[1] > 0 and lc[0] == lc[1], f"stage 4's eloc forwards did not all go through "
                                            f"kernel #1 in bf16: {lc}")
        m = res["model"]
        bits = ARSampler(m.sorb, m.noa, m.nob, n_sample=1 << 15, capacity=400).sample(
            m, torch.Generator(device=dev).manual_seed(175))[0]
        seen = []

        def fwd(b):
            seen.append(b)
            return torch.zeros(b.shape[0], 2, device=b.device)

        s4 = hubbard_ladder.stage_setup(4, 1, dev)[0]
        stabs = s4.tables(dev, f32)
        local_energy_simple(fwd, bits, stabs.astuple(), s4.excitation, hpair=stabs.hpair_best)
        trows = torch.cat(seen)
        n_rows = trows.shape[0]
        T = fused_rnn.pack_tables(m)
        k_out = fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=bf16, tables=T)
        p_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, trows, matmul_dtype=bf16, tables=T)
        q_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
            m, trows, matmul_dtype=bf16, tables={key: t.double() for key, t in T.items()})
        f_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, trows, matmul_dtype=f32, tables=T)
        ok, held, st = hold_rows(k_out, p_out, [q_out, f_out], tol[bf16])
        dp = fused_rnn.mma_width(m.dcut)
        log(17, f"  kernel #1 bf16 dp {dp} (DAG, {m.maxp} predecessors) vs plain on stage 4's "
                f"{n_rows} eloc rows: max|dlog|psi|| {st['max_a']:.3e} (tol {tol[bf16][0]:g}), "
                f"max phase distance {st['max_p']:.3e}, median row {st['med_a']:.3e} / "
                f"{st['med_p']:.3e}; held: {held} (rows over {tol[bf16][1]:g}: {st['over']})")
        check(ok, "stage 4: kernel #1 disagrees with its plain version")
        kern = lambda: fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=bf16,  # noqa: E731
                                                           tables=T)
        plain = lambda: fused_rnn.graph_mpsrnn_logpsi_fused_plain(  # noqa: E731
            m, trows, matmul_dtype=bf16, tables=T)
        kern()
        p1, k1, k2, p2 = cuda_ms(plain, 3), cuda_ms(kern, 20), cuda_ms(kern, 20), cuda_ms(plain, 3)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = n_rows * sum(flop_per_site(m.dcut, len(pr)) for pr in m.preds)
        b = bound(flop, n_rows * m.sorb + n_rows * 2 * 4 + table_bytes(T, bf16), bf16)
        log(17, f"  fused forward bf16 dp {dp} on {n_rows} rows: tensor-core kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b[0]:.5f} ms ({b[1]}); gpu {smi}")
        out["hub"] = {"launches": lc[1], "err": st["max_a"], "times": (k_ms, p_ms), "bound": b,
                      "rows": n_rows}

    # ---- (d) one step of each other model on the 4-site Hubbard chain ----
    hub = System.hubbard_1d(4, 2, 2, u=4.0)
    sorb = hub.sorb

    def mk(cls, *a, seed=0, **kw):
        return cls(*a, dtype=f32, device=dev, generator=torch.Generator().manual_seed(seed), **kw)

    arr = lambda s: mk(M.ARRBM, sorb, 2, 2, nh=16, seed=s)  # noqa: E731
    ar_s = ARSampler(sorb, 2, 2, n_sample=100_000, capacity=64)
    ex_s = ExactSampler(sorb, 2, 2)
    cases = [
        ("RBM, MCMC", mk(M.RBM, sorb, alpha=2), MCMCSampler(sorb, 2, 2, n_chain=256,
                                                            n_sweep=8, therm=0)),
        ("ARRBM", arr(1), ar_s),
        ("ARRBM2", mk(M.ARRBM2, sorb, 2, 2, nh=16, seed=2), ar_s),
        ("IsingRBM", mk(M.IsingRBM, sorb, seed=3), ex_s),
        ("DBM", mk(M.DBM, sorb, seed=4), ex_s),
        ("Jastrow", mk(M.Jastrow, sorb, seed=5), ex_s),
        ("MPSWavefunction", mk(M.MPSWavefunction, sorb, dcut=4, seed=6), ex_s),
        ("Hybrid(ARRBM, RBM)", M.HybridWavefunction(arr(7), mk(M.RBM, sorb, alpha=1, seed=8,
                                                               param_type="real")), ar_s),
        ("MultiPsi(ARRBM, Jastrow)", M.MultiPsi(arr(9), mk(M.Jastrow, sorb, seed=10)), ar_s),
        ("SpinProjected(RNN)", M.SpinProjected(mk(M.RNNWavefunction, sorb, 2, 2, hidden=16,
                                                  seed=11), -1), ar_s),
    ]
    for name, model, smp in cases:
        v = VMC(model, hub, smp, VMCConfig(lr=1e-2))
        st, ms = timed(lambda: v.step(torch.Generator(device=dev).manual_seed(176), 1.0))
        e, ws = float(st["energy"]), float(st["w_sum"])
        log(17, f"{name}: one VMC.step ({type(smp).__name__}) E {e:.6f} w_sum {ws:.8f} gnorm "
                f"{float(st['gnorm']):.3e} in {ms:.1f} ms")
        check(np.isfinite(e) and abs(ws - 1.0) <= 1e-5, f"{name}: non-finite E or w_sum != 1")
    return out


def standin_system():
    """bench.py's stand-in for the absent Fe2S2 integrals (seed 0)."""
    from pynqs_tpu_torch.ops.integrals import triangle_size
    from pynqs_tpu_torch.utils.system import System

    irng = np.random.default_rng(0)
    h1e = irng.standard_normal((SORB, SORB)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = irng.standard_normal(triangle_size(SORB)) * 0.01
    return System.from_integrals(h1e, h2e, SORB, NOA, NOB)


def chain48_model(dev):
    """The dcut-48 chain of checkpoints/fe2s2_dcut48_final.pkl, f32, on ``dev``."""
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.utils.flagship import load_flagship_params

    here = os.path.dirname(os.path.abspath(__file__))
    params = load_flagship_params(os.path.join(here, "checkpoints", "fe2s2_dcut48_final.pkl"))
    return GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, phase_mode="arg", norm_mode="mpsrnn",
                       dtype=torch.float32, device=dev).load_numpy_params(params)


def dp_vmc(mesh, dev, mode="same_tree"):
    """Phase 18's VMC: the dcut-48 chain in the flagship step with the AR
    sampler over ``mesh`` (none: one process), AdamW."""
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler

    sampler = ARSampler(SORB, NOA, NOB, mesh=mesh, mesh_mode=mode, **DP_SAMPLER)
    cfg = VMCConfig(lr=1e-4, optimizer="adamw", eloc_method="reduce", eloc_k_det=K_DET,
                    eloc_n_stoch=N_STOCH, eloc_topk="segmax", clip_grad=1.0)
    return VMC(chain48_model(dev), standin_system(), sampler, cfg)


def dp_train(mesh, dev):
    """DP_STEPS steps of ``dp_vmc`` from seed 18: (energies, parameters)."""
    vmc = dp_vmc(mesh, dev)
    hist = vmc.run(torch.Generator(device=dev).manual_seed(18), DP_STEPS)
    return hist, {k: p.detach().clone() for k, p in vmc.model.named_parameters()}


def dp_rank(mesh, walkers):
    """One rank of phase 18's two-rank run (gloo, both ranks on one card).
    Returns what the parent checks: the rows of one sharded tree, step 1's
    energy and gradient beside one process on the gathered rows with the
    same tail draws (rank 0), DP_STEPS training steps (launches of kernel
    #1, parameter spread, generator sync, wall time), one step's stages,
    the peak memory, <S-S+> through kernel #4, one independent-mode step
    and GFMC over the ranks."""
    from pynqs_tpu_torch.energy.eloc import local_energy_reduce
    from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
    from pynqs_tpu_torch.ops import fused_rnn, onv
    from pynqs_tpu_torch.ops import pair_select as ps
    from pynqs_tpu_torch.ops.integrals import spin_raising
    from pynqs_tpu_torch.parallel import all_gather_rows, generators_in_sync, replicated_check
    from pynqs_tpu_torch.sampler.ar import ar_sampling_sharded

    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev)}

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t) * 1e3

    torch.cuda.reset_peak_memory_stats(dev)
    vmc = dp_vmc(mesh, dev)
    model = vmc.model
    # the rows of one sharded tree
    g = torch.Generator(device=dev).manual_seed(11)
    bits, counts, dropped = ar_sampling_sharded(model, DP_SAMPLER["n_sample"],
                                                capacity=DP_SAMPLER["capacity"], mesh=mesh,
                                                generator=g)
    live = counts > 0
    out.update(rows=onv.pack_bits(bits[live]).cpu().numpy(), count_sum=int(counts.sum()),
               dropped=int(dropped), rows_local=bits.shape[0])
    # step 1's energy and gradient; rank 0 also on the gathered rows alone
    g = torch.Generator(device=dev).manual_seed(12)
    sb, sw, _ = vmc.sampler.sample(model, g)
    state = g.get_state()
    el = vmc.local_energy(sb, g)
    e, grads, var = energy_and_grad(model, sb, sw, el, mesh=mesh)
    ab, aw = all_gather_rows(mesh, sb), all_gather_rows(mesh, sw)
    if mesh.rank == 0:
        g1 = torch.Generator(device=dev)
        g1.set_state(state)
        tabs = vmc.system.tables(dev, torch.float32)
        el1 = local_energy_reduce(vmc._eloc_forward(), ab, tabs.astuple(),
                                  vmc.system.excitation, g1, k_det=K_DET, n_stoch=N_STOCH,
                                  hpair=tabs.hpair_best, topk="segmax")
        e1, grads1, var1 = energy_and_grad(model, ab, aw, el1)
        gmax = max(float(v.abs().max()) for v in grads1.values())
        out.update(
            eloc_err=float((el - el1[:sb.shape[0]]).abs().max()),
            e=float(e[0]), e1=float(e1[0]), var=float(var), var1=float(var1),
            g_err=max(float((grads[k] - grads1[k]).abs().max()) for k in grads) / gmax)
        del el1, grads1
    del el, grads
    # DP_STEPS training steps
    fused_rnn.LAUNCHES.reset()
    fused_rnn.MMA_LAUNCHES.reset()
    gen = torch.Generator(device=dev).manual_seed(18)
    steps = []

    def cb(it, info):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        named = dict(model.named_parameters())
        steps.append({"energy": info["energy_total"], "w_sum": info["w_sum"],
                      "dropped_frac": info["dropped_frac"], "n_unique": info["n_unique"],
                      "s": now - cb.t0, "spread": replicated_check(mesh, named),
                      "sync": generators_in_sync(mesh, gen),
                      "launches": fused_rnn.MMA_LAUNCHES.n})
        cb.t0 = time.perf_counter()

    cb.t0 = time.perf_counter()
    vmc.run(gen, DP_STEPS, callback=cb)
    out.update(steps=steps, launches=fused_rnn.MMA_LAUNCHES.n,
               all_launches=fused_rnn.LAUNCHES.n)
    # one more step, each stage synchronized (the collectives inside)
    (sb, sw, _), t_s = timed(lambda: vmc._sample(vmc.sampler, gen))
    el, t_e = timed(lambda: vmc.local_energy(sb, gen))
    (e, grads, var), t_g = timed(lambda: energy_and_grad(model, sb, sw, el, mesh=mesh))
    _, t_u = timed(lambda: vmc.apply_gradients(grads))
    out["stages_ms"] = {"sample": t_s, "eloc": t_e, "grad": t_g, "update": t_u}
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del sb, sw, el, grads
    # <S-S+> under the mesh: the dense pair matrix through kernel #4
    ps.LAUNCHES["lane"].reset()
    s2, t_o = timed(lambda: vmc.operator_expected(spin_raising(SORB), gen))
    out.update(ssp=(s2.mean.real, s2.se), ssp_ms=t_o, pair_launches=ps.LAUNCHES["lane"].n)
    # one step with one tree per rank, merged
    ind = dp_vmc(mesh, dev, "independent")
    ind.model.load_state_dict(model.state_dict())
    info, t_i = timed(lambda: ind.step(gen, 1.0))
    out.update(ind_energy=float(info["energy"]) + vmc.system.ecore,
               ind_w_sum=float(info["w_sum"]), ind_n_unique=float(info["n_unique"]),
               ind_dropped=float(info["dropped_frac"]), ind_ms=t_i)
    out["spread_end"] = replicated_check(mesh, dict(model.named_parameters()))
    # fixed-node GFMC over the ranks from the same walkers and seed, the
    # checkpoint's state as the trial (as the parent's one-process run)
    g = torch.Generator(device=dev).manual_seed(13)
    trial = chain48_model(dev)
    res, t_f = timed(lambda: gfmc_dp(mesh, dev, trial, walkers).run(walkers, generator=g))
    out["gfmc"] = {k: res[k] for k in ("e_gen", "wbar", "walkers", "weights")}
    out["gfmc_ms"] = t_f / DP_GFMC_ITERS
    out["sync_end"] = generators_in_sync(mesh, gen) and generators_in_sync(mesh, g)
    return out


def gfmc_dp(mesh, dev, model, walkers):
    """Phase 18's GFMC: ``model``'s bf16 fused forward as the trial,
    DP_GFMC_ITERS iterations, a branching every 2."""
    from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig
    from pynqs_tpu_torch.ops import fused_rnn

    cfg = GFMCConfig(n_walkers=walkers.shape[0], n_iter=DP_GFMC_ITERS, branch_interval=2)
    return GFMC(lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b), standin_system(), cfg,
                device=dev, mesh=mesh)


def dp_phase(dev, smi, walkers):
    """Phase 18: the data-parallel flagship step on the card (see the
    module docstring).  Returns the launch counts for the kernels line."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.parallel import init_mesh, run_ranks

    # the ranks below are other processes on this card: hand back what the
    # earlier phases left in this process's allocator cache
    gc.collect()
    torch.cuda.empty_cache()
    log(18, f"this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    # world 1 over NCCL: the collectives are identities, so the run is the
    # one without a mesh bit for bit
    fused_rnn.MMA_LAUNCHES.reset()
    tmp = tempfile.mkdtemp(prefix="nccl1")
    t0 = time.perf_counter()
    try:
        mesh1 = init_mesh("nccl", "file://" + os.path.join(tmp, "store"), 0, 1, dev)
        try:
            h1, p1 = dp_train(mesh1, dev)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    l1 = fused_rnn.MMA_LAUNCHES.n
    h0, p0 = dp_train(None, dev)
    dp_max = max(float((p1[k] - p0[k]).abs().max()) for k in p0)
    log(18, f"world 1 over NCCL ({mesh1.backend}): energies {h1} vs without a mesh {h0}; max "
            f"|Δ parameter| {dp_max:.3e} after {DP_STEPS} steps; kernel #1 launches {l1}; "
            f"both runs {time.perf_counter() - t0:.1f} s")
    check(h1 == h0 and dp_max == 0.0, "world 1 over NCCL differs from the run without a mesh")
    check(l1 > 0, "world 1 launched no kernel #1")
    # world 2 over gloo, both ranks on the one card
    t0 = time.perf_counter()
    ranks = run_ranks(dp_rank, 2, backend="gloo", device="cuda", args=(walkers,), timeout=600)
    t_ranks = time.perf_counter() - t0
    r0, r1 = ranks
    rows = np.concatenate([r["rows"] for r in ranks])
    disjoint = len(np.unique(rows, axis=0)) == rows.shape[0]
    total = sum(r["count_sum"] for r in ranks) + r0["dropped"]
    log(18, f"world 2 over gloo on one card ({t_ranks:.1f} s with the spawn): sharded tree "
            f"n {DP_SAMPLER['n_sample']}, capacity {DP_SAMPLER['capacity']} "
            f"({r0['rows_local']} rows per rank): live rows {[len(r['rows']) for r in ranks]}, "
            f"disjoint {disjoint}, counts + dropped = {total} (dropped {r0['dropped']})")
    check(disjoint and total == DP_SAMPLER["n_sample"] and r0["dropped"] == r1["dropped"],
          "the ranks' rows overlap or lose count")
    e_tol, g_tol = 1e-5, 1e-3
    log(18, f"step 1 over 2 ranks vs one process on the gathered {2 * r0['rows_local']} rows "
            f"with the same tail draws: eloc max|Δ| {r0['eloc_err']:.3e} (rank 0's rows), E "
            f"{r0['e']:.8f} vs {r0['e1']:.8f} (tol {e_tol:g} relative), variance "
            f"{r0['var']:.6e} vs {r0['var1']:.6e}, max|Δ gradient| / max|gradient| "
            f"{r0['g_err']:.3e} (tol {g_tol:g})")
    check(abs(r0["e"] - r0["e1"]) <= e_tol * max(1.0, abs(r0["e1"])) and r0["g_err"] <= g_tol
          and r0["eloc_err"] <= 1e-5 * max(1.0, abs(r0["e1"])),
          "the DP step's energy or gradient differs from one process on the same rows")
    for r in ranks:
        for i, s in enumerate(r["steps"]):
            log(18, f"rank {r['rank']} ({r['device']}) step {i}: E {s['energy']:.6f} w_sum "
                    f"{s['w_sum']:.6f} dropped_frac {s['dropped_frac']:.3e} n_unique "
                    f"{s['n_unique']:.0f} wall {s['s']:.3f} s; parameters max|Δ| between "
                    f"ranks {s['spread']:.1e}; generator in sync {s['sync']}; kernel #1 "
                    f"launches so far {s['launches']}")
        log(18, f"rank {r['rank']}: one step's stages (synchronized) "
                + ", ".join(f"{k} {v:.1f} ms" for k, v in r["stages_ms"].items())
                + f"; peak memory {r['peak_gib']:.3f} GiB; <S-S+> {r['ssp'][0]:.6f} ± "
                  f"{r['ssp'][1]:.2e} in {r['ssp_ms']:.1f} ms, kernel #4 launches "
                  f"{r['pair_launches']}; independent mode step E {r['ind_energy']:.6f} "
                  f"w_sum {r['ind_w_sum']:.6f} n_unique {r['ind_n_unique']:.0f} in "
                  f"{r['ind_ms']:.1f} ms; gpu {smi}")
        check(all(s["spread"] == 0.0 and s["sync"] for s in r["steps"])
              and r["spread_end"] == 0.0 and r["sync_end"],
              "parameters differ between the ranks or the shared generator left sync")
        check(all(np.isfinite(s["energy"]) and abs(s["w_sum"] - 1.0) <= 1e-5
                  for s in r["steps"]), "non-finite DP energy or w_sum != 1")
        check(r["launches"] > 0 and r["launches"] == r["all_launches"],
              f"rank {r['rank']}: the DP steps did not launch the tensor-core kernel alone")
        check(r["pair_launches"] > 0, f"rank {r['rank']}: <S-S+> did not launch kernel #4")
        check(np.isfinite(r["ind_energy"]) and abs(r["ind_w_sum"] - 1.0) <= 1e-5
              and np.isfinite(r["ssp"][0]), "non-finite independent-mode step or <S-S+>")
    check([s["energy"] for s in r0["steps"]] == [s["energy"] for s in r1["steps"]],
          "the ranks report different energies")
    # GFMC over the two ranks against one process
    model = chain48_model(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    t_ref = time.perf_counter()
    ref = gfmc_dp(None, dev, model, walkers).run(walkers, generator=g)
    sync()
    t_ref = (time.perf_counter() - t_ref) * 1e3 / DP_GFMC_ITERS
    gerr = max(float(np.abs(r["gfmc"]["e_gen"] - ref["e_gen"]).max()) for r in ranks)
    same_walkers = all(np.array_equal(r["gfmc"]["walkers"], ref["walkers"]) for r in ranks)
    log(18, f"GFMC, {walkers.shape[0]} walkers, {DP_GFMC_ITERS} iterations (a branching every "
            f"2): e_gen over 2 ranks {r0['gfmc']['e_gen'].tolist()} vs one process "
            f"{ref['e_gen'].tolist()}, max|Δ| {gerr:.3e}; walkers equal {same_walkers}; "
            f"{r0['gfmc_ms']:.1f} ms per iteration over 2 ranks on one card, {t_ref:.1f} ms in "
            f"one process; gpu {smi}")
    check(gerr <= 1e-9 * max(1.0, float(np.abs(ref["e_gen"]).max())) and same_walkers,
          "GFMC over 2 ranks differs from one process")
    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        nccl = run_ranks(dp_rank, 2, backend="nccl", device="cuda", args=(walkers,),
                         timeout=600)
        check(all(all(s["spread"] == 0.0 for s in r["steps"]) and r["launches"] > 0
                  for r in nccl), "world 2 over NCCL: parameters differ or no launch")
        log(18, f"world 2 over NCCL, one card per rank: {time.perf_counter() - t0:.1f} s, "
                f"step walls {[[round(s['s'], 3) for s in r['steps']] for r in nccl]} s")
    else:
        log(18, f"world 2 over NCCL with one card per rank: not run ("
                f"{torch.cuda.device_count()} card)")
    return {"launches": l1 + sum(r["launches"] for r in ranks),
            "pair_launches": sum(r["pair_launches"] for r in ranks)}


def profile_rank(mesh, profile_dir):
    """Phase 19's profiled run: 5 iterations of the dcut-48 chain's step
    (n 1e5, capacity 1024, REDUCE 256/64 segmax) over ``mesh`` with
    ``profile_dir`` and profile_iters 3.  Returns its seconds."""
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler

    cfg = VMCConfig(lr=1e-4, optimizer="adamw", eloc_method="reduce", eloc_k_det=K_DET,
                    eloc_n_stoch=N_STOCH, eloc_topk="segmax", log_every=10**6,
                    profile_dir=profile_dir, profile_iters=3)
    sampler = ARSampler(SORB, NOA, NOB, n_sample=100_000, capacity=1024, mesh=mesh)
    t0 = time.perf_counter()
    VMC(chain48_model(mesh.device), standin_system(), sampler, cfg).run(
        torch.Generator(device=mesh.device).manual_seed(19), 5)
    return time.perf_counter() - t0


def entry_phase(dev, smi):
    """Phase 19: ``entry()`` and ``dryrun_multichip(1)`` on the card, a
    profiled VMC run's trace, and ``pynqs_tpu_torch.bench.main`` in both
    modes.  Returns kernel #1's launches from ``entry()``."""
    import tempfile

    from pynqs_tpu_torch import bench
    from pynqs_tpu_torch.entry import dryrun_multichip, entry
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.parallel import run_ranks

    fn, (model, bits) = entry()
    fused_rnn.MMA_LAUNCHES.reset()
    e = float(fn(model, bits))
    sync()
    n_entry = fused_rnn.MMA_LAUNCHES.n
    fn_cpu, (model_cpu, bits_cpu) = entry(device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    e_cpu = float(fn_cpu(model_cpu, bits_cpu))
    log(19, f"entry(): E {e:.6f} (bf16 kernel #1, {n_entry} launch(es)); its plain version in "
            f"f32 on the CPU {e_cpu:.6f}")
    check(n_entry > 0 and np.isfinite(e) and abs(e - e_cpu) <= 1e-2 * max(1.0, abs(e_cpu)),
          "entry() did not launch kernel #1 or disagrees with its plain version")
    gc.collect()
    torch.cuda.empty_cache()  # the dry run's rank is another process on this card
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, timeout=300)
    log(19, f"dryrun_multichip(1) over NCCL: history {dry[0]['history']}, kernel #1 launches "
            f"{dry[0]['launches']}, {time.perf_counter() - t0:.1f} s with the spawn")
    check(dry[0]["launches"] > 0, "the dry run did not launch kernel #1")
    with tempfile.TemporaryDirectory() as tmp:
        # in a fresh process: in this one the earlier phases' profiler
        # sessions may leave the card's tracer recording nothing (as seen
        # in phase 17)
        t_run = run_ranks(profile_rank, 1, backend="gloo", device="cuda", args=(tmp,),
                          timeout=300)[0]
        path = os.path.join(tmp, "trace_rank0.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = [ev.get("name", "") for ev in events]
        # each range once on the host's timeline (the card's copy is
        # "gpu_user_annotation")
        marks = [ev.get("name") for ev in events if ev.get("cat") == "user_annotation"]
        ranges = {r: marks.count(r) for r in ("vmc.sample", "vmc.eloc", "vmc.grad", "vmc.update")}
        kern = sum("fused_rnn_mma_kernel" in n for n in names)
        log(19, f"profiled VMC run over one gloo rank, 5 iterations ({t_run:.1f} s), iterations "
                f"2-4 traced to {os.path.basename(path)} ({os.path.getsize(path)} B): ranges "
                f"{ranges}, fused_rnn_mma_kernel events {kern}")
        check(all(v == 3 for v in ranges.values()) and kern > 0,
              "the trace lacks a vmc.* range or kernel #1")
    out = {}
    for mode in ("flat", "prefix"):
        os.environ["BENCH_MODE"] = mode
        try:
            res = bench.main()
        finally:
            del os.environ["BENCH_MODE"]
        print(f"gpu: {smi}", flush=True)
        check(res["mode"] == mode and res["value"] > 0, f"bench {mode}: no rate")
        out[mode] = res
        log(19, f"bench {mode}: {res['value']:.4e} terms/s, {res['seconds'] * 1e3:.2f} ms per "
                f"call; gpu {smi}")
    return {"launches": n_entry, "bench": out}


FOCUS_SECTOR = (8, 33)  # phase 20: sector sizes of the written FOCUS states, [lo, hi)
C4_DCUTS = (256, 160)  # phase 20: the warm starts' bond dimensions (dp 256 and 192)
C4_STEPS = {256: {"bf16": 2, "f32": 1}, 160: {"bf16": 1, "f32": 1}}  # phase 20's VMC steps
N_PREFIX = (256, 16)  # phase 20: parents and single-excitation children per parent at dp 192
DMRG_ARGS = ["--iters", "3"]  # of fe2s2_train_from_dmrg's 200
EXAMPLE_ARGS = ["--iters", "5"]  # of the example's 1000
SPIN_ARGS = [os.path.join("checkpoints", "fe2s2_r3_dcut64_r5g64.pkl"), "--dcut", "64",
             "--use-tensor", "--max-preds", "2"]
KDET_ARGS = ["--n-keys", "2"]
UNIQUE_ARGS = [os.path.join("checkpoints", "fe2s2_r2_dcut96_final.pkl")]


def write_focus_state(path, norb, bond, seed):
    """A seeded stand-in for a DMRG state as a raw FOCUS CTNS binary: bonds
    min(4^t, 4^(norb - t), bond), each cut into sectors of ``FOCUS_SECTOR``
    states, the physical index into its 4 one-state sectors, a third of
    the blocks zero.  Returns the bonds."""
    from pynqs_tpu_torch.utils.focus_ctns import write_ctns_sites

    rng = np.random.default_rng(seed)
    D = [min(4 ** t, 4 ** (norb - t), bond) for t in range(norb + 1)]

    def cut(n):
        out = []
        while n:
            out.append(min(n, int(rng.integers(*FOCUS_SECTOR))))
            n -= out[-1]
        return out

    parts = [cut(d) for d in D]
    sites = []
    for t in range(norb):
        keep = rng.random((len(parts[t]), 4, len(parts[t + 1]))) >= 1 / 3
        keep = np.repeat(np.repeat(keep, parts[t], 0), parts[t + 1], 2)
        sites.append(rng.standard_normal((D[t], 4, D[t + 1])) / np.sqrt(D[t]) * keep)
    write_ctns_sites(path, sites, [(parts[t], parts[t + 1], [1, 1, 1, 1]) for t in range(norb)])
    return D


def single_excitations(bits, per_row, seed):
    """``per_row`` children of each row [B, sorb] (numpy int8), each one
    electron moved to an empty orbital of the same spin: [B, per_row, sorb]."""
    rng = np.random.default_rng(seed)
    B, sorb = bits.shape
    kids = np.repeat(bits[:, None], per_row, 1).copy()
    for i in range(B):
        for c in range(per_row):
            s = int(rng.integers(2))
            row = kids[i, c, s::2]
            o, e = rng.choice(np.flatnonzero(row == 1)), rng.choice(np.flatnonzero(row == 0))
            row[o], row[e] = 0, 1
    return kids


def last_modules_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed):
    """Phase 20: (a) kernel #1 at dcut > 128 (C4) on states warm-started
    from raw FOCUS CTNS binaries the script writes (20 sites, bond
    dimension 256 and 160: dp 256 in 4 passes of 128 outputs, dp 192 in
    3), held by ``hold_rows`` on ``N_CMP`` random rows in bf16 and f32;
    ``C4_STEPS`` VMC steps at each width in the DMRG script's
    configuration, their eloc forwards through kernel #1 alone; kernel #1
    timed on the eloc rows of the dp-256 run's last step at both widths in
    both modes; at dp 192 the prefix passes held to their plain versions
    and bit for bit the flat kernel's.  (b) the last ported scripts
    through their ``main``s on the stand-in integrals and on state files
    written here; ``fci_bits`` through the native library;
    ``memory.auto_eloc_batch`` against the device's memory.  Writes only
    in a temporary directory."""
    import shutil
    import tempfile

    from pynqs_tpu_torch import native
    from pynqs_tpu_torch.energy.eloc import local_energy_reduce
    from pynqs_tpu_torch.examples import fe2s2_graph_mps_rnn
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.ops import fused_rnn_prefix as pre
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
    from pynqs_tpu_torch.scripts import (
        fe2s2_train_from_dmrg,
        kdet_rebalance_check,
        measure_dfs_r3,
        measure_unique_chunks,
        spin_subspace_eval,
        validate_fe2s2_import,
    )
    from pynqs_tpu_torch.utils import fci, memory
    from pynqs_tpu_torch.utils.focus_ctns import (
        ctns_state_dict,
        load_focus_ctns_mpsrnn,
        read_ctns_sites,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    norb = SORB // 2
    system = standin_system()
    counters = {"fused": fused_rnn.LAUNCHES, "bf16": fused_rnn.MMA_LAUNCHES,
                "f32": fused_rnn.F32_MMA_LAUNCHES, "parent": pre.MMA_PARENT_LAUNCHES,
                "child": pre.MMA_CHILD_LAUNCHES}

    def reset():
        for c in counters.values():
            c.reset()

    def counts():
        return {k: c.n for k, c in counters.items()}

    def eloc_rows(v, bits):
        """The rows the eloc forward of ``bits`` hands the kernel."""
        seen = []

        def fwd(b):
            seen.append(b)
            return torch.zeros(b.shape[0], 2, device=b.device)

        local_energy_reduce(fwd, bits, v._ops, v._table, torch.Generator(device=dev).manual_seed(20),
                            k_det=v.cfg.eloc_k_det, n_stoch=v.cfg.eloc_n_stoch,
                            batch=v.cfg.eloc_batch, hpair=v._hpair)
        return torch.cat(seen)

    work = tempfile.mkdtemp(prefix="chip_smoke_c4_")
    out = {"held": {}, "times": {}, "launches": {}}
    try:
        reset_peak()
        # ---- (a) the warm starts at dcut 256 and 160 ----
        models = {}
        for dcut in C4_DCUTS:
            path = os.path.join(work, f"rcanon_isweep_d{dcut}.bin")
            D, ms_w = timed(lambda: write_focus_state(path, norb, dcut, 20 + dcut))
            m = GraphMPSRNN(SORB, NOA, NOB, dcut=dcut, phase_mode="arg", norm_mode="mpsrnn",
                            dtype=f32, device=dev)
            tree, ms_l = timed(lambda: load_focus_ctns_mpsrnn(path, m))
            m.load_numpy_params(tree)
            models[dcut] = m
            dp = fused_rnn.mma_width(dcut)
            log(20, f"FOCUS CTNS binary, {norb} sites, bonds {D}, "
                    f"{os.path.getsize(path) / 2**20:.1f} MiB, written in {ms_w:.0f} ms; "
                    f"load_focus_ctns_mpsrnn into a dcut-{dcut} chain in {ms_l:.0f} ms: dp {dp}, "
                    f"{fused_rnn.mma_passes(dp)} passes of 128 outputs")
            check(max(D) == dcut and len(read_ctns_sites(path)) == norb,
                  f"the dcut-{dcut} FOCUS binary does not read back")
        rows = torch.as_tensor(rand_dets(np.random.default_rng(20), N_CMP, SORB, NOA, NOB),
                               device=dev)
        for dcut, m in models.items():
            T = fused_rnn.pack_tables(m)
            T64 = {k: t.double() for k, t in T.items()}
            for mm in (bf16, f32):
                reset()
                k_out = fused_rnn.graph_mpsrnn_logpsi_fused(m, rows, matmul_dtype=mm, tables=T)
                sync()
                lc = counts()
                p_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, rows, matmul_dtype=mm,
                                                                  tables=T)
                q_out = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, rows, matmul_dtype=mm,
                                                                  tables=T64)
                ok, held, st = hold_rows(k_out, p_out, q_out, tol[mm])
                sh = fused_rnn.mma_launch_shape(m, matmul_dtype=mm)
                log(20, f"kernel #1 {str(mm).split('.')[-1]} dp {fused_rnn.mma_width(dcut)} vs "
                        f"plain on {N_CMP} random rows: max|dlog|psi|| {st['max_a']:.3e} (tol "
                        f"{tol[mm][0]:g}), max phase distance {st['max_p']:.3e}, median row "
                        f"{st['med_a']:.3e} / {st['med_p']:.3e}, plain with f64 sums "
                        f"{st['q_max_p']:.3e}; rows over the phase tolerance {st['over']} (plain "
                        f"with f64 sums: {st['q_over']}); held: {held}; launches {lc}; "
                        f"{sh['warps']} warps, "
                        f"slots in {sh['slots']} memory, {sh['smem_bytes']} B shared")
                check(ok, f"kernel #1 at dcut {dcut} ({mm}) disagrees with its plain version")
                check(lc["fused"] == 1 and lc["bf16" if mm == bf16 else "f32"] == 1,
                      f"kernel #1 at dcut {dcut} ({mm}) was not launched once in its mode: {lc}")
                out["held"][(dcut, mm)] = st["max_a"]
                del k_out, p_out, q_out
        del rows

        # ---- (a) VMC steps in the DMRG script's configuration ----
        last = {}
        for (dcut, m), mode in itertools.product(models.items(), ("bf16", "f32")):
            cfg = VMCConfig(lr=2e-4, optimizer="adamw", clip_grad=0.1, eloc_method="reduce",
                            eloc_k_det=512, eloc_n_stoch=128, eloc_batch=256,
                            fused_matmul_dtype=mode)
            sampler = ARSampler(SORB, NOA, NOB, n_sample=100_000, capacity=1024)
            v = VMC(m, system, sampler, cfg)
            g = torch.Generator(device=dev).manual_seed(dcut)
            reset()
            for i in range(C4_STEPS[dcut][mode]):
                r, ms = timed(lambda: v.step(g, cfg.clip_grad))
                log(20, f"dcut {dcut} {mode} step {i}: E {float(r['energy']):.6f} w_sum "
                        f"{float(r['w_sum']):.8f} live {int(r['n_unique'])} gnorm "
                        f"{float(r['gnorm']):.3e}; {ms / 1e3:.3f} s")
                check(np.isfinite(float(r["energy"])) and abs(float(r["w_sum"]) - 1) <= 1e-5,
                      f"dcut {dcut}: non-finite energy or w_sum != 1")
            lc = counts()
            log(20, f"dcut {dcut}: {C4_STEPS[dcut][mode]} step(s) with the eloc forwards in "
                    f"{mode}, launches {lc}; max_memory_allocated {peak_gib():.3f} GiB")
            check(lc[mode] > 0 and lc["fused"] == lc[mode],
                  f"dcut {dcut}: the eloc forwards did not all go through kernel #1 in {mode}: "
                  f"{lc}")
            out["launches"][(dcut, bf16 if mode == "bf16" else f32)] = lc[mode]
            last[dcut] = v
        # the eloc rows of the dp-256 run's last step's samples
        v = last[C4_DCUTS[0]]
        bits, _, _ = v.sampler.sample(v.model, torch.Generator(device=dev).manual_seed(21))
        trows = eloc_rows(v, bits)
        n_rows = trows.shape[0]
        CH = 1 << 16
        for dcut, m in models.items():
            T = fused_rnn.pack_tables(m)
            fl = n_rows * norb * flop_per_site(dcut, 1)
            nbytes = n_rows * SORB + n_rows * 2 * 4
            for mm in (bf16, f32):
                def plain(m=m, mm=mm, T=T):
                    return torch.cat([fused_rnn.graph_mpsrnn_logpsi_fused_plain(
                        m, trows[i:i + CH], matmul_dtype=mm, tables=T)
                        for i in range(0, n_rows, CH)])

                def kern(m=m, mm=mm, T=T):
                    return fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=mm,
                                                               tables=T)

                kern()
                p1, k1, k2, p2 = cuda_ms(plain, 1), cuda_ms(kern, 2), cuda_ms(kern, 2), \
                    cuda_ms(plain, 1)
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                b = bound(fl, nbytes + table_bytes(T, mm), bf16 if mm == bf16 else F32X3)
                b_cc = bound(fl, nbytes + table_bytes(T, mm), f32) if mm == f32 else None
                out["times"][(dcut, mm)] = (k_ms, p_ms, b, b_cc)
                log(20, f"kernel #1 {str(mm).split('.')[-1]} dp {fused_rnn.mma_width(dcut)} on "
                        f"the {n_rows} eloc rows of one step: {k_ms:.3f} ms "
                        f"({fl / k_ms / 1e9:.2f} TFLOP/s), plain {p_ms:.3f} ms (in chunks of "
                        f"{CH}), bound {b[0]:.3f} ms ({b[1]}"
                        + (f", 3xTF32; {b_cc[0]:.3f} ms on the CUDA cores" if b_cc else "")
                        + f"); gpu {smi}")
        out["rows"] = n_rows
        del trows

        # ---- (a) the prefix passes at dp 192, bit for bit the flat kernel ----
        # random parents and their single excitations, as phase 8 and the
        # card tests take them.  (On this warm start's sampled rows the
        # phase is a sign, arg of a real sum at the last site, and at 256
        # parents x 16 the bf16 kernel and the plain version with f64 sums
        # each put a few rows in 4352 past the phase tolerance, the same
        # ill-conditioning as hold_rows' allowance of 1 in 1000 measures.)
        m = models[160]
        Bp, C = N_PREFIX
        par = torch.as_tensor(rand_dets(np.random.default_rng(22), Bp, SORB, NOA, NOB), device=dev)
        kids = torch.as_tensor(single_excitations(par.cpu().numpy(), C, 20), device=dev)
        t_min = pre.t_min_process_order(m, par, kids)
        T = fused_rnn.pack_tables(m)
        T64 = {k: t.double() for k, t in T.items()}
        par_idx = torch.arange(Bp, device=dev).repeat_interleave(C)
        t_flat = t_min.reshape(-1)
        kids_flat = kids.reshape(-1, SORB)
        need = int((norb - t_flat.clamp(max=norb)).sum())
        out["prefix"] = {}
        for mm in (bf16, f32):
            kw = dict(matmul_dtype=mm, tables=T)
            reset()
            lp, lk = pre.graph_mpsrnn_logpsi_fused_prefix(m, par, kids, t_min, **kw)
            sync()
            lc = counts()
            pp, pk = pre.graph_mpsrnn_logpsi_fused_prefix_plain(m, par, kids, t_min, **kw)
            # the same rows through the flat plain version with f64 sums
            q = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, torch.cat([par, kids_flat]),
                                                          matmul_dtype=mm, tables=T64)
            ok, held, st = hold_rows(torch.cat([lp, lk.reshape(-1, 2)]),
                                     torch.cat([pp, pk.reshape(-1, 2)]), q, tol[mm])
            fp = fused_rnn.graph_mpsrnn_logpsi_fused(m, par, **kw)
            fk = fused_rnn.graph_mpsrnn_logpsi_fused(m, kids_flat, **kw)
            same = torch.equal(lp, fp) and torch.equal(lk.reshape(-1, 2), fk)
            _, hh, sh = pre.prefix_parent(m, par, **kw)
            passes = {
                "parent": (lambda: pre.prefix_parent_plain(m, par, **kw),
                           lambda: pre.prefix_parent(m, par, **kw)),
                "child": (lambda: pre.prefix_child_plain(m, kids_flat, par_idx, t_flat, hh, sh,
                                                         **kw),
                          lambda: pre.prefix_child(m, kids_flat, par_idx, t_flat, hh, sh, **kw)),
            }
            hist = Bp * norb * (2 * 160 + pre.NSTATE) * 4
            fl = flop_per_site(160, 1)
            tb = table_bytes(T, mm)
            peak_mm = bf16 if mm == bf16 else F32X3
            bnd = {"parent": bound(Bp * norb * fl, Bp * SORB + Bp * 16 + hist + tb, peak_mm),
                   "child": bound(need * fl, Bp * C * (SORB + 4 + 4 + 16) + hist + tb, peak_mm)}
            res = {}
            for what, (plain, kern) in passes.items():
                kern()
                p1, k1, k2, p2 = cuda_ms(plain, 1), cuda_ms(kern, 5), cuda_ms(kern, 5), \
                    cuda_ms(plain, 1)
                res[what] = ((k1 + k2) / 2, (p1 + p2) / 2, bnd[what])
            log(20, f"prefix passes {str(mm).split('.')[-1]} dp 192, {Bp} parents x {C} single "
                    f"excitations (t_min {int(t_flat.min())}..{int(t_flat.max())}, {need} "
                    f"child site-steps): vs plain max|dlog|psi|| {st['max_a']:.3e}, max phase "
                    f"distance {st['max_p']:.3e}, median row {st['med_a']:.3e} / "
                    f"{st['med_p']:.3e}, rows over the phase tolerance {st['over']} (the plain "
                    f"version with f64 sums: {st['q_over']}), held: {held}; bit for bit the flat kernel: "
                    f"{same}; launches {lc}; "
                    + "; ".join(f"{w} {k:.3f} ms, plain {p:.3f} ms, bound {b[0]:.4f} ms ({b[1]})"
                                for w, (k, p, b) in res.items()) + f"; gpu {smi}")
            check(ok, f"the dp-192 prefix passes ({mm}) disagree with their plain versions")
            check(same, f"the dp-192 prefix passes ({mm}) differ from the flat kernel")
            check(lc["parent"] == 1 and lc["child"] == 1,
                  f"the dp-192 prefix passes ({mm}) were not launched once each: {lc}")
            out["prefix"][mm] = {"err": st["max_a"], "launches": (lc["parent"], lc["child"]),
                                 **res}
            del hh, sh
        log(20, f"(a) max_memory_allocated {peak_gib():.3f} GiB")
        del models, last, v, m
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) the scripts through their mains ----
        reset_peak()
        path20 = os.path.join(work, "rcanon_isweep_d20.bin")
        write_focus_state(path20, norb, 20, 40)
        sd = ctns_state_dict(read_ctns_sites(path20))
        focus = os.path.join(work, "fe2s2-standin-dcut-20-focus.pth")
        torch.save({"params_M.all_sites": [torch.as_tensor(x) for x in sd["params_M.all_sites"]],
                    "params_w.all_sites": torch.as_tensor(sd["params_w.all_sites"]),
                    "params_c.all_sites": torch.as_tensor(sd["params_c.all_sites"])}, focus)
        reset()
        r, ms = timed(lambda: fe2s2_train_from_dmrg.main(DMRG_ARGS + ["--focus", focus],
                                                         system=system, device=dev, root=work))
        lc = counts()
        log(20, f"fe2s2_train_from_dmrg.main({' '.join(DMRG_ARGS)}) from the dcut-20 state: "
                f"history {[round(e, 6) for e in r['history']]}, {ms / 1e3:.2f} s with set-up; "
                f"launches {lc}")
        check(len(r["history"]) == 3 and np.isfinite(r["history"]).all(),
              "fe2s2_train_from_dmrg: non-finite energies")
        check(lc["bf16"] > 0 and lc["fused"] == lc["bf16"],
              f"fe2s2_train_from_dmrg: the eloc forwards did not go through kernel #1: {lc}")
        out["launches"]["dmrg"] = lc["bf16"]
        r, ms = timed(lambda: validate_fe2s2_import.main(["--focus", focus], system=system,
                                                         device=dev))
        log(20, f"validate_fe2s2_import.main(): E(import) REDUCE {r['e_reduce']:.6f}, SIMPLE "
                f"{r['e_simple']:.6f} ({(r['e_reduce'] - r['e_simple']) * 1e3:+.3f} mHa), "
                f"{r['n_unique']} unique, kept {r['kept']}; {ms / 1e3:.2f} s")
        check(np.isfinite(r["e_reduce"]) and np.isfinite(r["e_simple"]),
              "validate_fe2s2_import: non-finite energies")
        reset()
        r, ms = timed(lambda: fe2s2_graph_mps_rnn.main(EXAMPLE_ARGS, system=system, device=dev))
        lc = counts()
        log(20, f"examples/fe2s2_graph_mps_rnn.main({' '.join(EXAMPLE_ARGS)}): dp "
                f"{fused_rnn.mma_width(r['vmc'].model.dcut)} DAG of "
                f"{r['vmc'].model.maxp} predecessors, history "
                f"{[round(e, 6) for e in r['history']]}, {ms / 1e3:.2f} s; launches {lc}")
        check(len(r["history"]) == 5 and np.isfinite(r["history"]).all() and lc["bf16"] > 0,
              f"the example: non-finite energies or no kernel #1 launch ({lc})")
        r, ms = timed(lambda: spin_subspace_eval.main(SPIN_ARGS, system=system, device=dev))
        rws = r["rows"]
        log(20, f"spin_subspace_eval.main(r5g64 state): {r['n_set']} determinants captured "
                f"(dropped {r['dropped']:.3%}); " + ", ".join(
                    f"{k} E {e:.6f} <S-S+> {ss:.4f}" for k, (e, ss) in rws.items())
                + f"; {ms / 1e3:.2f} s")
        check(all(np.isfinite(x) for e_ss in rws.values() for x in e_ss)
              and rws["optimum"][0] <= min(e for e, _ in rws.values()) + 1e-6,
              "spin_subspace_eval: non-finite, or the subspace optimum above a vector in it")
        r, ms = timed(lambda: kdet_rebalance_check.main(KDET_ARGS, system=system, device=dev,
                                                        root=here))
        log(20, f"kdet_rebalance_check.main({' '.join(KDET_ARGS)}): " + "; ".join(
            f"{c}: bias {s['bias'] * 1e3:+.4f} mHa, rms {s['rms'] * 1e3:.3f} mHa, spread "
            f"{s['espread'] * 1e3:.4f} mHa" for c, s in r.items()) + f"; {ms / 1e3:.2f} s")
        check(all(np.isfinite(x) for s in r.values() for x in s.values()),
              "kdet_rebalance_check: non-finite")
        r, ms = timed(lambda: measure_unique_chunks.main(UNIQUE_ARGS, system=system, device=dev,
                                                         root=here))
        log(20, f"measure_unique_chunks.main: live {r['live']}, dropped {r['dropped']:.4%}, "
                f"unique rows per chunk {r['unique']} of {r['rows']}; {ms / 1e3:.2f} s")
        check(all(0 < n <= r["rows"] for n in r["unique"]), "measure_unique_chunks: bad counts")
        r, ms = timed(lambda: measure_dfs_r3.main(system=system, device=dev, root=here))
        log(20, f"measure_dfs_r3.main: live per depth {r['live_per_depth']}; " + "; ".join(
            f"n {x['n']:.0e} root {x['root']} depth {x['depth']} G {x['groups']}: dropped "
            f"{x['dropped']:.4%}, live {x['live']}, {x['seconds']:.2f} s" for x in r["runs"])
            + f"; {ms / 1e3:.2f} s")
        check(all(0 < x["live"] <= x["groups"] * x["capacity"] for x in r["runs"]),
              "measure_dfs_r3: bad live counts")
        native.CALLS.reset()
        fb, ms = timed(lambda: fci.fci_bits(20, 4, 4))
        log(20, f"fci_bits(20, 4, 4): {fb.shape[0]} determinants through the native library "
                f"({os.path.relpath(native.build(), here)}, {native.CALLS.n} call) in {ms:.1f} ms")
        check(native.available() and native.CALLS.n == 1 and fb.shape == (44100, 20)
              and np.array_equal(fb, fci.python_fci_bits(20, 4, 4)),
              "fci_bits did not go through the native library")
        stats = memory.device_memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        n_sd = system.excitation.n_sd
        chunk = memory.auto_eloc_batch(1 << 24, n_sd, SORB, device=dev)
        per = (1 + n_sd) * (SORB + 5 * 4)
        budget = 0.6 * (stats["bytes_limit"] - stats["bytes_in_use"])
        log(20, f"memory: allocated {stats['bytes_in_use'] / 2**30:.2f} GiB, limit (free + "
                f"reserved) {stats['bytes_limit'] / 2**30:.2f} GiB, mem_get_info free "
                f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB; auto_eloc_batch at n_sd {n_sd}: "
                f"{chunk} samples ({chunk * per / 2**30:.2f} GiB of a {budget / 2**30:.2f} GiB "
                f"budget); (b) max_memory_allocated {peak_gib():.3f} GiB")
        check(stats["bytes_limit"] >= free and chunk * per <= budget < 2 * chunk * per,
              "auto_eloc_batch does not fit the device's free memory")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    t_script = time.perf_counter()
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
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs, compact_by_count
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
    from pynqs_tpu_torch.scripts import time_pair_select as tps
    from pynqs_tpu_torch.scripts.eval_fe2s2_final import evaluate
    from pynqs_tpu_torch.utils.flagship import flagship_model, load_flagship_params

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
    system = standin_system()

    # ---- 2. build ----
    t0 = time.perf_counter()
    smem = build(fused_rnn, ps)
    log(2, f"built csrc/fused_rnn_mma.cu (the fused forward, prefix parent and child, each in "
           f"bf16 and in f32 as 3xTF32, on the tensor cores), csrc/fused_rnn.cu (the same on "
           f"the CUDA cores) and csrc/pair_select.cu (pair selection) for sm_90a in "
           f"{time.perf_counter() - t0:.2f} s")
    for name in ("fused_rnn_mma", "fused_rnn", "pair_select"):
        for ln in ptxas_report(cuda_build.BUILD_INFO.get(name, "")):
            log(2, f"  ptxas {name}: {ln}")
    log(2, f"  CUDA-core kernel, dynamic shared memory per CTA: {smem(DCUT, 1, 0)} B at dcut "
           f"{DCUT} (chain; the prefix passes too), {smem(DCUT_R5, MAXP_R5, DCMP_R5)} B at the "
           f"r5g64 shape (dcut {DCUT_R5}, {MAXP_R5} predecessors, dcut_cmpr {DCMP_R5}; limit "
           f"232,448 B), {smem(16, 2, 0)} B at dcut 16 with 2 predecessors")
    for (what, m), mm in itertools.product((
            ("chain dcut 48", GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, device=dev)),
            ("r5g64 (dcut 64, tensor coupling, stand-in graph)",
             flagship_model(system, DCUT_R5, use_tensor=True, max_preds=MAXP_R5, device=dev)),
            (f"r5g64 graph at dcut_cmpr {DCMP_C3}", r5_graph_model(system, DCMP_C3, dev)),
            ("chain dcut 96", GraphMPSRNN(SORB, NOA, NOB, dcut=96, device=dev)),
            ("chain dcut 160", GraphMPSRNN(SORB, NOA, NOB, dcut=160, device=dev)),
            ("chain dcut 256", GraphMPSRNN(SORB, NOA, NOB, dcut=256, device=dev))), (bf16, f32)):
        sh = fused_rnn.mma_launch_shape(m, matmul_dtype=mm)
        cs = 4 * fused_rnn.coupling_ksteps(m, mm) * 512
        log(2, f"  tensor-core kernel {mmname(mm)} at {what}: dp {fused_rnn.mma_width(m.dcut)} "
               f"({fused_rnn.mma_passes(fused_rnn.mma_width(m.dcut))} pass(es) of up to 128 "
               f"outputs per value), "
               f"{sh['warps']} warps = {16 * sh['warps']} rows per CTA, {sh['nslots']} hidden "
               f"slot(s) and a coupling slot of {cs} B per warp in {sh['slots']} memory, dynamic "
               f"shared memory {sh['smem_bytes']} B per CTA (3 weight stages of 24,576 B + the "
               f"slots; above dp 128 also a scratch of 8 KB per pass per warp)")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chain_m = GraphMPSRNN(SORB, NOA, NOB, dcut=DCUT, device=dev)
    for (what, n), mm in itertools.product((("parent", B), ("child", B * (K_DET + N_STOCH))),
                                           (bf16, f32)):
        sh = fused_rnn.mma_launch_shape(chain_m, n, n_sm, mm)
        log(2, f"  tensor-core prefix {what} pass {mmname(mm)} at the chain step's {n} rows on "
               f"{n_sm} SMs: {sh['warps']} warp(s) = {16 * sh['warps']} rows per CTA, "
               f"{sh['ctas']} CTAs, dynamic shared memory {sh['smem_bytes']} B per CTA")
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

    def agree(phase, name, m, x, mm, k, p, tables=None, prev=None):
        """``hold_rows`` of the kernel's rows ``k`` against the plain
        version's ``p``; ``prev``: the CUDA-core kernel's rows, whose error
        is shown beside (not held).  Returns max|Δlog|ψ||."""
        ta, tp = tol[mm]
        T = fused_rnn.pack_tables(m) if tables is None else tables
        q = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
            m, x, matmul_dtype=mm, tables={key: v.double() for key, v in T.items()})
        ok, held, st = hold_rows(k, p, q, tol[mm])
        if prev is not None:
            sp = hold_rows(prev, p, q, tol[mm])[2]
            log(phase, f"{name} {mmname(mm)} rows {x.shape[0]}: the CUDA-core kernel on the same "
                       f"rows: max|Δlog|ψ|| {sp['max_a']:.3e}, max phase distance "
                       f"{sp['max_p']:.3e}, median row {sp['med_a']:.3e} / {sp['med_p']:.3e}")
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

    def mode_launches():
        return fused_rnn.MMA_LAUNCHES.n, fused_rnn.F32_MMA_LAUNCHES.n

    def compare(name, m, x, mm):
        before = mode_launches()
        k = fused_rnn.graph_mpsrnn_logpsi_fused(m, x, matmul_dtype=mm)
        sync()
        after = mode_launches()
        check(after == (before[0] + (mm == bf16), before[1] + (mm == f32)),
              f"{name} {mmname(mm)}: not one launch of the tensor-core kernel in its mode "
              f"(bf16, f32 launches {before} -> {after})")
        p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, x, matmul_dtype=mm)
        prev = fused_rnn._launch_f32_cuda_cores(m, x) if mm == f32 else None
        sync()
        agree(3, name, m, x, mm, k, p, prev=prev)

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
    fused_rnn.F32_MMA_LAUNCHES.reset()  # the f32 E_loc forwards of this phase
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
    l4_f32 = fused_rnn.F32_MMA_LAUNCHES.n
    check(l4_f32 > 0, "the f32 local energies did not launch the tensor-core kernel's f32 mode")

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

    peak = {bf16: H100_BF16_FLOPS, f32: H100_F32_FLOPS, F32X3: H100_TF32_FLOPS / 3}

    def bound(flop, nbytes, mm):
        op_ms, byte_ms = flop / peak[mm] * 1e3, nbytes / H100_BYTES * 1e3
        return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")

    def table_bytes(tables, mm):
        """Each table read once; W in the matmul type (f32 in both f32
        kernels)."""
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
        max|Δlog|ψ||, the CUDA-core kernel's ms in the same mode)}.  The
        kernel is the tensor-core one; the CUDA-core kernel in the same
        mode (``_launch_simt``, ``_launch_f32_cuda_cores``: the earlier
        designs) is timed before and after it, and in f32 its error on the
        same rows shown."""
        tables = fused_rnn.pack_tables(m)
        res = {}
        for mm in (bf16, f32):
            kern = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused(m, trows, matmul_dtype=mm, tables=tables)  # noqa: E731
            plain = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, trows, matmul_dtype=mm, tables=tables)  # noqa: E731
            simt = ((lambda: fused_rnn._launch_simt(m, trows, tables)) if mm == bf16 else  # noqa: E731
                    (lambda: fused_rnn._launch_f32_cuda_cores(m, trows, tables)))
            k_out, p_out = kern(), plain()
            s_out = simt() if mm == f32 else None
            sync()
            err = agree(phase, f"{name} step rows", m, trows, mm, k_out, p_out, tables,
                        prev=s_out)
            del k_out, p_out, s_out
            s1 = cuda_ms(simt, kreps)
            k, p = alternate(plain, kern, kreps)
            prev = (s1 + cuda_ms(simt, kreps)) / 2
            res[mm] = (k, p, err, prev)
        return res, tables

    def w_traffic(m, tables, n, mm=bf16):
        """(launch shape, bytes of W every CTA streams, the L2 traffic of
        W over all CTAs) of the tensor-core kernel in ``mm`` at n rows."""
        sh = fused_rnn.mma_launch_shape(m, matmul_dtype=mm)
        tab = fused_rnn.pack_mma_tables(m, tables, mm)["tab"]
        w = tab.numel() * tab.element_size()
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
    b6 = {mm: bound(flop6, nbytes6[mm], F32X3 if mm == f32 else mm) for mm in t6}
    b6_f32 = bound(flop6, nbytes6[f32], f32)  # on the CUDA cores

    def flat_line(mm, k, p, prev, b, b_f32, flop, nbytes):
        return (f"tensor-core kernel {k:.3f} ms, CUDA-core kernel {prev:.3f} ms "
                f"({prev / k:.2f}x), plain {p:.3f} ms, bound {b[0]:.3f} ms"
                + (f" (3xTF32; on the CUDA cores {b_f32[0]:.3f} ms)" if mm == f32 else "")
                + f" ({flop / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), "
                f"{flop / k / 1e9:.2f} TFLOP/s; gpu {smi}")

    for mm, (k, p, _, prev) in t6.items():
        log(6, f"fused forward {mmname(mm)} at {n_rows} rows: "
               + flat_line(mm, k, p, prev, b6[mm], b6_f32, flop6, nbytes6[mm]))
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
    b7 = {mm: bound(flop7, nbytes7[mm], F32X3 if mm == f32 else mm) for mm in t7}
    b7_f32 = bound(flop7, nbytes7[f32], f32)
    for mm, (k, p, _, prev) in t7.items():
        log(7, f"fused forward with tensor coupling {mmname(mm)} at {n7} rows: "
               + flat_line(mm, k, p, prev, b7[mm], b7_f32, flop7, nbytes7[mm]))
    sh7, w7, l2_7 = w_traffic(r5, tables7, n7)
    log(7, f"tensor-core kernel at {n7} rows: {16 * sh7['warps']} rows per CTA, "
           f"{sh7['nslots']} hidden slots in {sh7['slots']} memory (no DAG hidden file; the "
           f"CUDA-core kernel's f32 file would be {n7 * norb * 2 * DCUT_R5 * 4 / 1e9:.2f} GB), "
           f"{sh7['smem_bytes']} B shared memory per CTA; every CTA streams "
           f"{w7 / 1e6:.3f} MB of W, {l2_7 / 1e9:.2f} GB through L2 in all")
    sh7x, w7x, l2_7x = w_traffic(r5, tables7, n7, f32)
    log(7, f"f32 mode at {n7} rows: {16 * sh7x['warps']} rows per CTA, {sh7x['nslots']} hidden "
           f"slots in {sh7x['slots']} memory ({n7 * sh7x['nslots'] * 8 * DCUT_R5 / 1e9:.2f} GB), "
           f"{sh7x['smem_bytes']} B shared memory per CTA; every CTA streams {w7x / 1e6:.3f} MB of "
           f"W, {l2_7x / 1e9:.2f} GB through L2 in all")
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
        # the flat tensor-core kernel in the same precision on the same
        # rows: the prefix passes share its walk (in f32 the slot seeded
        # unrounded), so every row must be equal bit for bit
        flat = fused_rnn.graph_mpsrnn_logpsi_fused(model, rows8, matmul_dtype=mm)
        sync()
        check(bool(torch.isfinite(kp).all() and torch.isfinite(kc).all()),
              "non-finite prefix kernel output")
        kc = kc.reshape(-1, 2)
        err8[mm] = {"parent vs plain": phase_err(kp, pp), "child vs plain": phase_err(kc, pc)}
        agree(8, "prefix parent (tensor cores)", model, par_bits, mm, kp, pp)
        agree(8, "prefix child (tensor cores)", model, kids_flat, mm, kc, pc.reshape(-1, 2))
        n_p = int((kp != flat[:Bp]).any(-1).sum())
        n_c = int((kc != flat[Bp:]).any(-1).sum())
        log(8, f"prefix {mmname(mm)} vs the flat tensor-core kernel in {mmname(mm)} on the same "
               f"rows: rows that differ at all: parent {n_p} of {Bp}, child {n_c} of "
               f"{kc.shape[0]}")
        check(n_p == 0 and n_c == 0,
              f"the {mmname(mm)} prefix rows differ from the flat tensor-core kernel's")
        del kp, kc, pp, pc, flat

    # REDUCE with and without prefix_fwd: the same generator seed draws
    # the same tail, so only the forwards' rounding differs
    sub = fbits8[:N_RED]
    f32fwd = lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=f32)  # noqa: E731
    e_flat = reduce(f32fwd, sub, torch.Generator(device=dev).manual_seed(9))
    counts8f = (pre.PARENT_LAUNCHES, pre.CHILD_LAUNCHES, pre.MMA_PARENT_LAUNCHES,
                pre.MMA_CHILD_LAUNCHES)
    for c in counts8f:
        c.reset()
    e_pre = reduce(f32fwd, sub, torch.Generator(device=dev).manual_seed(9),
                   prefix_fwd=pre.ReducePrefixForward(model, matmul_dtype=f32))
    sync()
    l8f = dict(zip(("parent", "child", "mma_parent", "mma_child"), (c.n for c in counts8f)))
    check(l8f["mma_parent"] == l8f["parent"] > 0 and l8f["mma_child"] == l8f["child"] > 0,
          f"the f32 prefix REDUCE did not launch the tensor-core prefix passes alone: {l8f}")
    scale = hr_scale(model, sub)
    diff = (e_flat - e_pre).abs().max(-1).values
    log(8, f"REDUCE with vs without prefix_fwd (f32) on {sub.shape[0]} sampled rows: "
           f"max|Δ| {diff.max().item():.3e}, max |Δ|/Σ|h r| "
           f"{(diff / scale).max().item():.3e} (tol 1e-4); the f32 prefix passes' launches "
           f"(tensor cores, 3xTF32) {l8f}")
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

    # times on the same rows: parent and child passes (the CUDA-core
    # kernels in the same precision, the earlier design, timed before and
    # after the tensor-core one), the whole prefix forward, the flat
    # kernel; plain versions beside them
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
                       lambda: pre._launch_prefix_simt("parent", model, par_bits, **kw)),
            "child": (lambda: pre.prefix_child_plain(model, kids_flat, par_idx, t_flat, hh, sh,
                                                     **kw),
                      lambda: pre.prefix_child(model, kids_flat, par_idx, t_flat, hh, sh, **kw),
                      lambda: pre._launch_prefix_simt("child", model, kids_flat, par_idx,
                                                      t_flat, hh, sh, **kw)),
        }
        t8[mm] = {what: with_prev(plain, kern, simt, 5)
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
    fused_rnn.mma_launch_shape = lambda m, n=None, n_sm=None, mm=bf16: shape_fn(m, matmul_dtype=mm)
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

    dev8 = {}
    for mm in (bf16, f32):
        kw = dict(matmul_dtype=mm, tables=tables8)
        _, hh, sh = pre.prefix_parent(model, par_bits, **kw)
        dev8[mm] = {
            "parent": (device_ms(lambda: pre.prefix_parent(model, par_bits, **kw),
                                 "fused_rnn_mma_kernel"),
                       device_ms(lambda: pre._launch_prefix_simt("parent", model, par_bits, **kw),
                                 "fused_rnn_kernel")),
            "child": (device_ms(lambda: pre.prefix_child(model, kids_flat, par_idx, t_flat, hh,
                                                         sh, **kw), "fused_rnn_mma_kernel"),
                      device_ms(lambda: pre._launch_prefix_simt("child", model, kids_flat,
                                                                par_idx, t_flat, hh, sh, **kw),
                                "fused_rnn_kernel")),
        }
        del hh, sh
        for what, (dk, ds) in dev8[mm].items():
            log(8, f"{what} {mmname(mm)}, device time per launch (profiler): tensor-core kernel "
                   f"{dk:.3f} ms (the wrapper call {t8[mm][what][0]:.3f} ms), CUDA-core kernel "
                   f"{ds:.3f} ms (the wrapper call {t8[mm][what][2]:.3f} ms); gpu {smi}")
    run_c = run_child(TR)
    log(8, f"site-steps: flat {flat_steps}; prefix needs {Bp * norb + need_child} "
           f"(skips {1 - (Bp * norb + need_child) / flat_steps:.2%}), the tensor-core child's "
           f"CTAs of {TR} sorted rows run {Bp * norb + run_c} "
           f"(skip {1 - (Bp * norb + run_c) / flat_steps:.2%}); the CUDA-core child's CTAs of "
           f"64 would run {Bp * norb + run_child(64)}")
    hist_bytes = Bp * norb * (2 * DCUT + pre.NSTATE) * 4
    fl = flop_per_site(DCUT, 1)
    # bounds: b8 on the tensor cores (f32: 3xTF32), b8_f32 of f32 on the
    # CUDA cores (the earlier design's)
    b8, b8_f32 = {}, {}
    for mm, peak_mm, out in ((bf16, bf16, b8), (f32, F32X3, b8), (f32, f32, b8_f32)):
        tb = table_bytes(tables8, mm)
        out[mm] = {
            "parent": bound(Bp * norb * fl, Bp * SORB + Bp * 16 + hist_bytes + tb, peak_mm),
            "child": bound(need_child * fl, n_child * (SORB + 4 + 4 + 16) + hist_bytes + tb,
                           peak_mm),
            "prefix forward": bound((Bp * norb + need_child) * fl,
                                    (Bp + n_child) * (SORB + 8) + n_child * 4 + tb, peak_mm),
            "flat forward": bound(flat_steps * fl, (Bp + n_child) * (SORB + 8) + tb, peak_mm),
        }
    for mm in t8:
        for what, (k, p, prev) in t8[mm].items():
            log(8, f"{what} {mmname(mm)}: tensor-core kernel {k:.3f} ms"
                   + (f", CUDA-core kernel {prev:.3f} ms ({prev / k:.2f}x)" if prev else "")
                   + f", plain {p:.3f} ms, bound {b8[mm][what][0]:.3f} ms ({b8[mm][what][1]})"
                   + (f" in 3xTF32, {b8_f32[mm][what][0]:.3f} ms on the CUDA cores"
                      if mm == f32 else "") + f"; gpu {smi}")
    log(8, f"prefix forward / flat forward, kernels (both on the tensor cores in each "
           f"precision): bf16 {t8[bf16]['prefix forward'][0] / t8[bf16]['flat forward'][0]:.3f}, "
           f"f32 {t8[f32]['prefix forward'][0] / t8[f32]['flat forward'][0]:.3f}")

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
        the band kernel held bitwise to the earlier gather kernel and to the
        plain version first; returns ({variant: numbers}, {variant: max|kernel − plain|})."""
        res, err = {}, {}
        for v in ps.VARIANTS:
            k = ps.pair_select_w(po, pv, hp, variant=v)
            check(torch.equal(ps._launch_gather(po, pv, hp, v), k),
                  f"the earlier gather kernel ({v}) != the band kernel")
            p = ps.pair_select_w_plain(po, pv, hp, variant=v)
            check(torch.equal(k, p), f"pair selection {v} != plain at {tuple(k.shape)} "
                                     f"(phase {phase})")
            err[v] = (k - p).abs().max().item()
            del k, p
            r = res[v] = tps.measure(po, pv, hp, v, reps=reps, host_calls=host_calls)
            log(phase, f"pair selection {v} {r['shape']}: wrapper call {r['ms']:.4f} ms, kernel "
                       f"alone {fmt_ms(r['device_ms'])} (profiler), host {r['host_ms']:.4f} ms per "
                       f"call; the earlier gather kernel in the same run {r['prev_ms']:.4f} ms, "
                       f"alone {fmt_ms(r['prev_device_ms'])}, host {r['prev_host_ms']:.4f} ms; "
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

    # ---- 12. the post-training refinement of the r5g64 flagship ----
    f12 = refine_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed, time_pairs)
    m12, err12 = f12["pair_select"]

    # ---- 13. the CI ladder on the r5g64 state ----
    t13 = time.perf_counter()
    f13 = nqsci_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed)
    log(13, f"phase 13 in {time.perf_counter() - t13:.1f} s")

    # ---- 14. kernel #1 at dcut_cmpr 12 (the coupling in blocks of 8 c's) ----
    t14 = time.perf_counter()
    m14, m14_dc4 = r5_graph_model(system, DCMP_C3, dev), r5_graph_model(system, DCMP_R5, dev)
    x14 = torch.as_tensor(rand_dets(np.random.default_rng(14), N_CMP, SORB, NOA, NOB), device=dev)
    T14 = fused_rnn.pack_tables(m14)
    counts14 = (fused_rnn.LAUNCHES, fused_rnn.MMA_LAUNCHES, fused_rnn.F32_MMA_LAUNCHES)
    for c in counts14:
        c.reset()
    k14 = {mm: fused_rnn.graph_mpsrnn_logpsi_fused(m14, x14, matmul_dtype=mm, tables=T14)
           for mm in (bf16, f32)}
    sync()
    l14 = tuple(c.n for c in counts14)
    check(l14 == (2, 1, 1), f"the dcut_cmpr {DCMP_C3} forwards did not launch the tensor-core "
                            f"kernel once in each mode (all, bf16, f32: {l14})")
    flop14 = N_CMP * sum(flop_per_site(DCUT_R5, len(p), DCMP_C3) for p in m14.preds)
    r14 = {}
    for mm in (bf16, f32):
        simt = ((lambda: fused_rnn._launch_simt(m14, x14, T14)) if mm == bf16 else  # noqa: E731
                (lambda: fused_rnn._launch_f32_cuda_cores(m14, x14, T14)))
        plain = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused_plain(  # noqa: E731
            m14, x14, matmul_dtype=mm, tables=T14)
        s_out, p_out = simt(), plain()
        sync()
        # held to the plain version, and to the CUDA-core kernel, which
        # takes any dcut_cmpr in its own layout, by the same rule
        err = agree(14, f"r5g64 graph dcut {DCUT_R5} dcut_cmpr {DCMP_C3}", m14, x14, mm, k14[mm],
                    p_out, T14, prev=s_out)
        q = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
            m14, x14, matmul_dtype=mm, tables={key: v.double() for key, v in T14.items()})
        ok, held, st = hold_rows(k14[mm], s_out, q, tol[mm])
        log(14, f"{mmname(mm)} tensor-core vs CUDA-core kernel on the same rows: max|Δlog|ψ|| "
                f"{st['max_a']:.3e}, max phase distance {st['max_p']:.3e}, median row "
                f"{st['med_a']:.3e} / {st['med_p']:.3e}, kernel rows over {tol[mm][1]:g} "
                f"{st['over']} ({held})")
        check(ok, f"dcut_cmpr {DCMP_C3} {mmname(mm)}: the tensor-core kernel disagrees with the "
                  f"CUDA-core kernel")
        del s_out, p_out, q
        kern = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused(  # noqa: E731
            m14, x14, matmul_dtype=mm, tables=T14)
        dc4 = lambda mm=mm: fused_rnn.graph_mpsrnn_logpsi_fused(  # noqa: E731
            m14_dc4, x14, matmul_dtype=mm)
        dc4()
        k, k4 = alternate(dc4, kern, 5, 5)
        p_ms, prev = cuda_ms(plain, 2), cuda_ms(simt, 3)
        nbytes = N_CMP * SORB + N_CMP * 2 * 4 + table_bytes(T14, mm)
        b, b_f32 = bound(flop14, nbytes, F32X3 if mm == f32 else mm), bound(flop14, nbytes, f32)
        r14[mm] = {"err": err, "times": (k, p_ms), "bound": b, "bound_f32": b_f32,
                   "prev_ms": prev, "dc4_ms": k4}
        log(14, f"forward {mmname(mm)} at dcut_cmpr {DCMP_C3} (dcp 16) on {N_CMP} rows: "
                f"tensor-core kernel {k:.3f} ms, at dcut_cmpr {DCMP_R5} on the same rows "
                f"{k4:.3f} ms ({k / k4:.3f}x), CUDA-core kernel {prev:.3f} ms, plain {p_ms:.3f} "
                f"ms, bound {b[0]:.3f} ms ({b[1]})"
                + (f" in 3xTF32, {b_f32[0]:.3f} ms on the CUDA cores" if mm == f32 else "")
                + f"; gpu {smi}")
    del m14, m14_dc4, x14, k14
    log(14, f"phase 14 in {time.perf_counter() - t14:.1f} s")

    # ---- 15. the SR trainer: fe2s2_r2_push at dcut 64, 96 and 128 ----
    t15 = time.perf_counter()
    f15 = sr_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed)
    log(15, f"phase 15 in {time.perf_counter() - t15:.1f} s")

    # ---- 16. the SR solvers, the samplers and the feature tour ----
    t16 = time.perf_counter()
    tour_run(dev, smi, system, f15, timed)
    del f15["sr_inputs"]
    log(16, f"phase 16 in {time.perf_counter() - t16:.1f} s")

    # ---- 17. the other ansätze: decoder, MPS-Transformer, Hubbard ladder ----
    t17 = time.perf_counter()
    f17 = a8_run(dev, smi, system, tol, timed, time_pairs, bound, flop_per_site, table_bytes)
    log(17, f"phase 17 in {time.perf_counter() - t17:.1f} s")

    # ---- 18. data parallelism: the flagship step over torch.distributed ----
    t18 = time.perf_counter()
    wrng = np.random.default_rng(18)
    wlive = (fw > 0).nonzero()[:, 0].cpu().numpy()
    wp = fw[wlive].double().cpu().numpy()
    walkers = fbits[wrng.choice(wlive, DP_WALKERS, p=wp / wp.sum())].cpu().numpy()
    f18 = dp_phase(dev, smi, walkers)
    log(18, f"phase 18 in {time.perf_counter() - t18:.1f} s")

    # ---- 19. the entry points: entry(), dryrun_multichip(1), profiler, bench ----
    t19 = time.perf_counter()
    f19 = entry_phase(dev, smi)
    log(19, f"phase 19 in {time.perf_counter() - t19:.1f} s")

    # ---- 20. the last modules: kernel #1 at dcut > 128 (C4), the DMRG warm starts, the scripts ----
    t20 = time.perf_counter()
    f20 = last_modules_run(dev, smi, here, bound, flop_per_site, table_bytes, tol, timed)
    log(20, f"phase 20 in {time.perf_counter() - t20:.1f} s")

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
    # dp_launches: its launches on phase 18's data-parallel runs (world 1
    # and both ranks of world 2); entry_launches: entry()'s (phase 19)
    summary = {"kernels": [
        entry("fused_rnn_forward_mma", "pynqs_tpu/ops/fused_rnn.py:197", launches,
              t6[bf16][2], t6[bf16], b6[bf16], "fused_rnn_mma.cu", prev_ms=t6[bf16][3],
              dp_launches=f18["launches"], entry_launches=f19["launches"]),
        entry("fused_rnn_forward_mma_tensor", "pynqs_tpu/ops/fused_rnn.py:254", launches7,
              t7[bf16][2], t7[bf16], b7[bf16], "fused_rnn_mma.cu", prev_ms=t7[bf16][3]),
        # kernels #2 and #3 in bf16: the tensor-core passes; prev_ms is the
        # CUDA-core pass's time in bf16 on the same rows in this run;
        # device_ms and prev_device_ms their kernels' device time alone
        entry("fused_rnn_prefix_parent", "pynqs_tpu/ops/fused_rnn_prefix.py:226",
              l8["mma_parent"], err8[bf16]["parent vs plain"][0], t8[bf16]["parent"],
              b8[bf16]["parent"], "fused_rnn_mma.cu", prev_ms=t8[bf16]["parent"][2],
              device_ms=dev8[bf16]["parent"][0], prev_device_ms=dev8[bf16]["parent"][1]),
        entry("fused_rnn_prefix_child", "pynqs_tpu/ops/fused_rnn_prefix.py:264",
              l8["mma_child"], err8[bf16]["child vs plain"][0], t8[bf16]["child"],
              b8[bf16]["child"], "fused_rnn_mma.cu", prev_ms=t8[bf16]["child"][2],
              device_ms=dev8[bf16]["child"][0], prev_device_ms=dev8[bf16]["child"][1]),
        # kernels #2 and #3 in f32 (precision=HIGHEST, fused_rnn_prefix.py:163):
        # the tensor-core passes in 3xTF32; launches: phase 8's f32 REDUCE
        # with prefix_fwd; bound_ms in 3xTF32, bound_f32_ms on the CUDA
        # cores; prev_ms the CUDA-core pass in f32 on the same rows
        *(entry(f"fused_rnn_prefix_{what}_f32", f"pynqs_tpu/ops/fused_rnn_prefix.py:{line}",
                l8f[f"mma_{what}"], err8[f32][f"{what} vs plain"][0], t8[f32][what],
                b8[f32][what], "fused_rnn_mma.cu", prev_ms=t8[f32][what][2],
                bound_f32_ms=b8_f32[f32][what][0], device_ms=dev8[f32][what][0],
                prev_device_ms=dev8[f32][what][1])
          for what, line in (("parent", 226), ("child", 264))),
        # lane: the evaluation's launches and chunk shape (phase 10);
        # rowrow: pair_select_w(variant="rowrow") at [2048, 435, 45] (phase
        # 9); prev_*: the earlier gather kernel on the same operands in
        # this run; dp_launches: the lane variant's on phase 18's <S-S+>
        # over two ranks
        *(entry(name, replaces, n, err[v], (m[v]["ms"], m[v]["plain_ms"]),
                (m[v]["bound_ms"], "bytes"), "pair_select.cu", m[v]["library_ms"],
                device_ms=m[v]["device_ms"], prev_ms=m[v]["prev_ms"],
                prev_device_ms=m[v]["prev_device_ms"], **extra)
          for name, replaces, n, v, m, err, extra in (
              ("pair_select_lane", "pynqs_tpu/ops/pallas_hij.py:48", l10["pair_select_lane"],
               "lane", m10, err10, {"dp_launches": f18["pair_launches"]}),
              ("pair_select_rowrow", "pynqs_tpu/ops/pallas_hij.py:82", l9["rowrow"], "rowrow",
               m9, err9, {}))),
        # kernel #1 at the training script's default width (dcut 96, dp 96)
        # on one eloc chunk of phase 11's trained state; launches: the
        # training run's, both runs (phase 11); prev_ms: the CUDA-core
        # kernel in bf16 on the same rows
        entry("fused_rnn_forward_mma_dp96", "pynqs_tpu/ops/fused_rnn.py:197",
              f11["launches"], f11["err"], f11["times"], f11["bound"], "fused_rnn_mma.cu",
              prev_ms=f11["prev_ms"], registers=f11["registers"],
              spill_bytes=f11["spill_bytes"], f32_max_abs_err=f11["f32_err"],
              f32_registers=f11["f32_registers"], f32_spill_bytes=f11["f32_spill_bytes"]),
        # kernel #1's tensor branch on one GFMC trial block (2048 walkers x
        # 7876 rows, phase 12); launches: the GFMC run's
        entry("fused_rnn_forward_mma_gfmc", "pynqs_tpu/ops/fused_rnn.py:254",
              f12["gfmc_launches"], f12["err"], f12["times"], f12["bound"], "fused_rnn_mma.cu",
              rows=f12["rows"]),
        # kernel #4 in the polish's E_VMC pass (phase 12): its launches and
        # its chunk's shape
        entry("pair_select_lane_polish", "pynqs_tpu/ops/pallas_hij.py:48",
              f12["polish_lane"], err12["lane"], (m12["lane"]["ms"], m12["lane"]["plain_ms"]),
              (m12["lane"]["bound_ms"], "bytes"), "pair_select.cu", m12["lane"]["library_ms"],
              device_ms=m12["lane"]["device_ms"], prev_ms=m12["lane"]["prev_ms"],
              prev_device_ms=m12["lane"]["prev_device_ms"]),
        # kernel #1 in f32, the tensor-core kernel's 3xTF32 mode: on one eloc
        # batch's H_nn rows of the NqsCi run (phase 13; launches: that run's;
        # bf16_ms: the bf16 mode on the same rows), on phase 6's chain rows
        # (launches: phase 4's f32 local energies) and on phase 7's r5g64
        # rows (launches: phase 12's f32 polish); prev_ms: the CUDA-core
        # kernel in f32 on the same rows in this run; bound_ms in 3xTF32
        # on the tensor cores, bound_f32_ms on the CUDA cores
        entry("fused_rnn_forward_nqsci", "pynqs_tpu/ops/fused_rnn.py:254", f13["launches"],
              f13["err"], f13["times"], f13["bound"], "fused_rnn_mma.cu", rows=f13["rows"],
              prev_ms=f13["prev_ms"], bound_f32_ms=f13["bound_f32"][0], bf16_ms=f13["bf16_ms"]),
        entry("fused_rnn_forward_f32", "pynqs_tpu/ops/fused_rnn.py:247", l4_f32, t6[f32][2],
              t6[f32], b6[f32], "fused_rnn_mma.cu", rows=n_rows, prev_ms=t6[f32][3],
              bound_f32_ms=b6_f32[0]),
        entry("fused_rnn_forward_f32_tensor", "pynqs_tpu/ops/fused_rnn.py:259",
              f12["f32_launches"], t7[f32][2], t7[f32], b7[f32], "fused_rnn_mma.cu", rows=n7,
              prev_ms=t7[f32][3], bound_f32_ms=b7_f32[0]),
        # kernel #1's tensor branch at dcut_cmpr 12 (phase 14), bf16; f32_*:
        # the f32 mode on the same rows; dc4_ms: the same shape at
        # dcut_cmpr 4; prev_ms: the CUDA-core kernel in the same mode
        entry("fused_rnn_forward_mma_dc12", "pynqs_tpu/ops/fused_rnn.py:254", l14[1],
              r14[bf16]["err"], r14[bf16]["times"], r14[bf16]["bound"], "fused_rnn_mma.cu",
              rows=N_CMP, prev_ms=r14[bf16]["prev_ms"], dc4_ms=r14[bf16]["dc4_ms"],
              f32_launches=l14[2], f32_max_abs_err=r14[f32]["err"],
              f32_ms=r14[f32]["times"][0], f32_plain_ms=r14[f32]["times"][1],
              f32_bound_ms=r14[f32]["bound"][0], f32_bound_f32_ms=r14[f32]["bound_f32"][0],
              f32_prev_ms=r14[f32]["prev_ms"], f32_dc4_ms=r14[f32]["dc4_ms"]),
        # kernel #1 (bf16) on fe2s2_r2_push's eloc rows at dcut 64, 96 and
        # 128 (phase 15): launches, the SR run's at that width; times on
        # the eloc rows of N_TIME of its samples
        *(entry(f"fused_rnn_forward_mma_r2_dp{dp}", "pynqs_tpu/ops/fused_rnn.py:197",
                f15[dp]["launches"], f15[dp]["err"], f15[dp]["times"], f15[dp]["bound"],
                "fused_rnn_mma.cu", rows=f15[dp]["rows"], registers=f15[dp]["registers"],
                spill_bytes=f15[dp]["spill_bytes"])
          for dp in ("64", "96", "128")),
        # kernel #4 on the trained decoder's <S-S+> (phase 17): its launches
        # there and its first chunk's shape; prev_*: the earlier gather
        # kernel on the same operands in this run
        entry("pair_select_lane_decoder", "pynqs_tpu/ops/pallas_hij.py:48",
              f17["pairs_launches"], f17["pairs_err"]["lane"],
              (f17["pairs"]["lane"]["ms"], f17["pairs"]["lane"]["plain_ms"]),
              (f17["pairs"]["lane"]["bound_ms"], "bytes"), "pair_select.cu",
              f17["pairs"]["lane"]["library_ms"], shape=f17["pairs"]["lane"]["shape"],
              device_ms=f17["pairs"]["lane"]["device_ms"], prev_ms=f17["pairs"]["lane"]["prev_ms"],
              prev_device_ms=f17["pairs"]["lane"]["prev_device_ms"]),
        # kernel #1 (bf16, the DAG path at dp 16) on hubbard_ladder stage 4's
        # eloc rows (phase 17); launches: the stage's run
        entry("fused_rnn_forward_mma_hubbard2d", "pynqs_tpu/ops/fused_rnn.py:197",
              f17["hub"]["launches"], f17["hub"]["err"], f17["hub"]["times"], f17["hub"]["bound"],
              "fused_rnn_mma.cu", rows=f17["hub"]["rows"]),
        # kernel #1 at dcut > 128 (C4, phase 20): dp 256 and 192 in each
        # mode; launches: phase 20's VMC steps in the DMRG script's
        # configuration with the eloc forwards in that mode (bf16 at dp
        # 256: the 2 steps); max_abs_err: hold_rows on N_CMP random rows;
        # times on the eloc rows of one step (rows); f32: bound_ms in
        # 3xTF32, bound_f32_ms on the CUDA cores
        *(entry(f"fused_rnn_forward_mma_dp{fused_rnn.mma_width(dc)}" + ("_f32" if mm == f32 else ""),
                "pynqs_tpu/ops/fused_rnn.py:" + ("197" if mm == bf16 else "247"),
                f20["launches"][(dc, mm)], f20["held"][(dc, mm)], f20["times"][(dc, mm)][:2],
                f20["times"][(dc, mm)][2], "fused_rnn_mma.cu", rows=f20["rows"],
                passes=fused_rnn.mma_passes(fused_rnn.mma_width(dc)),
                **({"bound_f32_ms": f20["times"][(dc, mm)][3][0]} if mm == f32 else {}))
          for dc, mm in itertools.product(C4_DCUTS, (bf16, f32))),
        # kernels #2 and #3 at dp 192 (phase 20): N_PREFIX parents and their
        # single excitations; launches: that check's, bf16; f32_*: the f32
        # mode (3xTF32) on the same rows
        *(entry(f"fused_rnn_prefix_{what}_dp192", f"pynqs_tpu/ops/fused_rnn_prefix.py:{line}",
                f20["prefix"][bf16]["launches"][i], f20["prefix"][bf16]["err"],
                f20["prefix"][bf16][what][:2], f20["prefix"][bf16][what][2], "fused_rnn_mma.cu",
                f32_launches=f20["prefix"][f32]["launches"][i],
                f32_max_abs_err=f20["prefix"][f32]["err"], f32_ms=f20["prefix"][f32][what][0],
                f32_plain_ms=f20["prefix"][f32][what][1],
                f32_bound_ms=f20["prefix"][f32][what][2][0])
          for i, (what, line) in enumerate((("parent", 226), ("child", 264)))),
    ]}
    log("end", f"chip_smoke.py in {time.perf_counter() - t_script:.1f} s; gpu {smi}")
    print(json.dumps(summary))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
