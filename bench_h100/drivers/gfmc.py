"""Driver of fixed-node GFMC: ``GFMC.run`` of ``pynqs_tpu_torch.gfmc.walker``.

Set-up builds the trial state as ``scripts/fe2s2_gfmc.main`` does (the
configuration's model, its fused forward in the configuration's
precision on the card), draws the initial walkers from it by DFS
sampling with the traffic's sample count and capacity (8 groups split at
depth 6) and the seed, and warms one iteration and one branching.  The
window runs chunks of ``branch_interval`` iterations, each ``GFMC.run``
starting from the last chunk's walkers, until ``--seconds`` have passed.
Every Green row of the last window is recorded (its walkers, e_loc and
b); ``judge`` recomputes one chunk's first row with the plain reference
and checks that every move inside a chunk went to a connected
determinant.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import program
from bench_h100 import reference as ref
from bench_h100.readers import roofline

__all__ = ["setup", "window", "report", "judge"]


def setup(cfg, tr, seed, dev, *, root, plant=None):
    from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig
    from pynqs_tpu_torch.ops import fused_rnn
    from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs

    h1e, h2e, system, model = program.system_and_model(cfg, seed, dev, root)
    if dev.type == "cuda":
        mm = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["fwd_dtype"]]
        trial = (lambda b, _t=fused_rnn.pack_tables(model):
                 fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=mm, tables=_t))
    else:
        trial = model.log_psi
    bits, counts, _ = ar_sampling_dfs(
        model, tr["n_sample"], capacity=tr["init_capacity"], n_group=8, split_depth=6,
        capacity_root=tr["init_capacity"], generator=torch.Generator(device=dev).manual_seed(seed))
    c = counts.cpu().numpy().astype(np.float64)
    idx = np.random.default_rng(seed).choice(len(c), size=tr["n_walkers"], p=c / c.sum())
    walkers = bits[torch.as_tensor(idx, device=dev)]
    st = {}

    def trial_rec(flat):
        lp = trial(flat)
        if plant == "rows":  # kernel #1 wrong on a sixteenth of the rows, mid-block
            a, m = lp.shape[0] // 2, max(1, lp.shape[0] // 16)
            lp = lp.clone()
            lp[a:a + m, 0] += 1.0
        if st.get("grab"):
            st["grab_lp"] = lp
        return lp

    g = GFMC(trial_rec, system, GFMCConfig(
        n_walkers=tr["n_walkers"], n_iter=tr["branch_interval"], p_steps=tr["p_steps"],
        gamma=tr["gamma"], branch_interval=tr["branch_interval"], dedup_unique_max=0),
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    st.update(cfg=cfg, tr=tr, seed=seed, dev=dev, root=root, g=g, gen=gen, h=(h1e, h2e),
              walkers=walkers, rows=[], e_gen=[], it=0, grabbed={},
              # the chunk whose first Green row is judged (chunk 0 where the
              # window ends before it)
              check_chunk=int(np.random.default_rng(seed + 3).integers(tr["check_chunks"])))
    row0 = g.green_row

    def green_row(w):
        first = st["it"] == 0 and st["chunk"] in (0, st["check_chunk"])
        st["grab"] = first
        row = row0(w)
        st["grab"] = False
        if plant == "unchanged" and "last" in st:  # an earlier row handed on again
            row = st["last"]
        if plant in ("half", "altered"):
            e, b = row.e_loc.clone(), row.b.clone()
            if plant == "half":  # the first half's values over the whole batch
                h = e.shape[0] // 2
                e[h:], b[h:] = e[:h].mean(), b[:h].mean()
            else:  # one walker's local energy altered
                e[0] += 0.5
            row = row._replace(e_loc=e, b=b)
        st["last"] = row
        st["rows"].append((st["chunk"], w.clone()))
        if first:  # the program's own block: its rows and trial values, kept without a copy
            st["grabbed"][st["chunk"]] = {"walkers": w.clone(), "comb": row.comb,
                                          "lp": st.pop("grab_lp"), "e_loc": row.e_loc.clone(),
                                          "b": row.b.clone()}
        st["it"] += 1
        return row

    g.green_row = green_row
    st["chunk"] = -1
    # warm-up: one iteration and one branching; the window goes on from there
    st["walkers"] = torch.from_numpy(g.run(walkers, generator=gen, n_iter=1)["walkers"])
    g.branch(walkers, torch.ones(walkers.shape[0], dtype=torch.float64, device=dev), gen)
    st["rows"].clear()
    st["grabbed"].clear()
    return st


def _now(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def window(st, seconds):
    g, tr, dev = st["g"], st["tr"], st["dev"]
    walkers = st["walkers"]
    for k in ("rows", "e_gen"):  # what is judged is the last window's
        st[k] = []
    st["grabbed"] = {}
    t0 = _now(dev)
    n_chunk = 0
    while True:
        st["chunk"], st["it"] = n_chunk, 0
        out = g.run(walkers, generator=st["gen"], n_iter=tr["branch_interval"])
        walkers = torch.from_numpy(out["walkers"])
        st["e_gen"].append(float(out["e_gen"][0]))
        n_chunk += 1
        t = _now(dev) - t0
        if t >= seconds:
            break
    st["walkers"] = walkers
    cfg = st["cfg"]
    iters = n_chunk * tr["branch_interval"]
    rows = iters * tr["n_walkers"] * (1 + ref.n_excitations(cfg["sorb"], cfg["noa"], cfg["nob"]))
    per_row = roofline.row_flop(cfg["dcut"], cfg["sorb"] // 2, cfg["max_preds"],
                                cfg["dcut_cmpr"] if cfg["use_tensor"] else 0)
    return {"attempted": iters, "failed": 0, "window_s": t, "steps": iters,
            "end_to_end": {"gfmc_iter_ms": t / iters * 1e3},
            "kernel1_flop": rows * per_row, "kernel1_bytes": rows * (cfg["sorb"] + 8),
            "model_flop": rows * per_row}


def report(st, work):
    print(f"[gfmc] walkers {st['tr']['n_walkers']}, iterations in window {work['steps']} "
          f"({len(st['e_gen'])} chunks), {work['window_s']:.3f} s; e_gen per chunk "
          f"{st['e_gen']}", flush=True)
    print(f"[gfmc] {program.launch_line()}", flush=True)
    if st["dev"].type == "cuda":
        print(f"[gfmc] peak memory {torch.cuda.max_memory_allocated(st['dev'])} B", flush=True)


def judge(st, lim, control=False):
    """One chunk's first Green row, stage by stage from the program's own
    block: kernel #1's trial values on rows drawn from the seed and on the
    block's last rows against the plain forward (the median gap, and the
    share of rows whose log|psi| is off by more than ``logpsi_row_tol``,
    which a fault on a minority of the rows moves), then e_loc, b and the
    generation energy against the plain Green row built from the program's
    rows and trial values; and
    the moves inside the chunks that do not reach a connected determinant
    (an exact count)."""
    cfg, tr, dev = st["cfg"], st["tr"], st["dev"]
    st.pop("g")
    st.pop("last", None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sorb, noa, nob = cfg["sorb"], cfg["noa"], cfg["nob"]
    ham, preds, P = ref.judge_inputs(cfg, *st["h"], st["seed"], st["root"], dev)
    c = st["check_chunk"] if st["check_chunk"] in st["grabbed"] else 0
    blk = st["grabbed"][c]
    comb, lp = blk["comb"], blk["lp"]
    flat = comb.reshape(-1, sorb)
    # rows drawn from the seed, and the block's last rows (its tail tiles) always
    N = flat.shape[0]
    tail = min(tr["check_tail"], N)
    pick = np.random.default_rng(st["seed"] + 5).choice(
        N - tail, size=min(N - tail, tr["check_rows"]), replace=False)
    idx = torch.as_tensor(np.concatenate([pick, np.arange(N - tail, N)]), device=dev)

    def gap_lp(quant=None):
        lr = ref.log_psi_blocks(P, preds, flat[idx], noa, nob, use_tensor=cfg["use_tensor"],
                                quant=quant)
        d = (lp[idx].float() - lr).double()
        d[:, 1] = torch.remainder(d[:, 1] + np.pi, 2 * np.pi) - np.pi
        _row_gaps(d, "control" if quant else "program")
        return d

    def over(d):  # rows whose log|psi| is off by more than the tolerance, or not finite
        return float((~(d[:, 0].abs() <= lim["logpsi_row_tol"])).double().mean())

    d = gap_lp()
    moves = sum(int((~ref.is_move(a[1], b2[1], sorb)).sum())
                for a, b2 in zip(st["rows"], st["rows"][1:]) if a[0] == b2[0])
    e_gen = st["e_gen"][c]

    def numbers(quant=None):
        e, b, scale, lam = ref.green_row_from(ham, blk["walkers"], comb, lp, quant=quant,
                                              block=tr["check_block"])
        if quant is None:
            e_p, b_p, eg = blk["e_loc"].double(), blk["b"].double(), e_gen
        else:  # the control in the program's place, judged against the reference
            (e_p, b_p), eg = (e, b), float(e.mean())
            e, b, scale, lam = ref.green_row_from(ham, blk["walkers"], comb, lp,
                                                  block=tr["check_block"])
        return {"eloc_gap": float(((e_p - e) / scale).abs().max()),
                "b_gap": float(((b_p - b) / (scale + lam.abs())).abs().max()),
                "egen_gap": abs(eg - float(e.mean())) / float(scale.mean())}

    checks = dict(numbers(), logpsi_gap=float(d.norm(dim=-1).median()), logpsi_over=over(d),
                  move_faults=moves)
    ctrl = None
    if control:
        dq = gap_lp("fp8")
        ctrl = dict(numbers("bf16"), logpsi_gap=float(dq.norm(dim=-1).median()),
                    logpsi_over=over(dq))
    print(f"[gfmc] readings {checks} (chunk {c})", flush=True)
    return {k: {"value": v, "limit": lim[k]} for k, v in checks.items()}, ctrl


def _row_gaps(d, who):
    """Quantiles and shares over thresholds of the checked rows' gaps (the
    amplitude's and the whole |delta log psi|'s), printed beside the result."""
    out = {}
    for name, g in (("amp", d[:, 0].abs()), ("all", d.norm(dim=-1))):
        q = torch.quantile(g.float()[:2 ** 24], torch.tensor([0.5, 0.99, 0.999],
                                                             device=g.device)).tolist()
        out[name] = {"p50": q[0], "p99": q[1], "p999": q[2], "max": float(g.max()),
                     "mean": float(g.mean()),
                     "over": {t: float((g > t).double().mean()) for t in (0.05, 0.1, 0.2, 0.5, 1)}}
    print(f"[gfmc] row gaps {who} {out}", flush=True)
