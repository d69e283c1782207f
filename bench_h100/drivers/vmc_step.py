"""Driver of VMC training steps: ``VMC.step`` of ``pynqs_tpu_torch.optim.vmc``.

Set-up builds the trainer as ``scripts/fe2s2_r3_push.main`` does (DFS AR
sampler, REDUCE local energies through the fused forward, AdamW on the
exponential schedule, global-norm clip) on the configuration's model and
the seeded stand-in integrals, then drives its first ``checked_steps``
steps through the same call the window makes, recording what each stage
handed on: the sampler's rows and weights, the rows each sampled row's
local energy evaluated and the local energies, the parameters before
every step and the optimizer's first moments after the first.  The
window runs further steps until ``--seconds`` have passed.  ``judge``
recomputes those stages with the plain reference from the same inputs.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_h100 import program
from bench_h100 import reference as ref
from bench_h100.readers import roofline

__all__ = ["setup", "window", "report", "judge"]


def setup(cfg, tr, seed, dev, *, root, plant=None):
    from pynqs_tpu_torch.optim import vmc as vmc_mod
    from pynqs_tpu_torch.optim.schedule import exponential_decay
    from pynqs_tpu_torch.sampler.ar_sampler import ARSampler

    sorb, noa, nob = cfg["sorb"], cfg["noa"], cfg["nob"]
    h1e, h2e, system, model = program.system_and_model(cfg, seed, dev, root)
    sampler = ARSampler(sorb, noa, nob, n_sample=tr["n_sample"], capacity=tr["capacity"],
                        dfs_n_group=tr["n_group"], dfs_split_depth=tr["split_depth"],
                        dfs_capacity_root=tr["capacity_root"], max_unique=tr["max_unique"])
    vcfg = vmc_mod.VMCConfig(
        n_iter=tr["iters"], optimizer="adamw", clip_grad=tr["clip"],
        lr=exponential_decay(tr["lr"], tr["iters"], tr["lr_end"] / tr["lr"]),
        eloc_method="reduce", eloc_k_det=tr["k_det"], eloc_n_stoch=tr["n_stoch"],
        # a wrong deterministic set: each stride segment's largest |H|, not the top k_det
        eloc_topk="segmax" if plant == "selection" else tr["topk"],
        eloc_batch=tr["eloc_batch"], grad_batch=tr["grad_batch"],
        fused_matmul_dtype=cfg["fwd_dtype"])
    vmc = vmc_mod.VMC(model, system, sampler, vcfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = {"cfg": cfg, "tr": tr, "seed": seed, "dev": dev, "root": root, "vmc": vmc,
          "gen": gen, "h": (h1e, h2e), "rec": [], "restore": []}
    _record(st, plant)
    for _ in range(tr["checked_steps"]):
        st["rec"].append({"params": {k: p.detach().clone() for k, p in
                                     model.named_parameters()}})
        out = _step(st)
        st["rec"][-1]["energy"] = float(out["energy"])
        if len(st["rec"]) == 1:
            st["exp_avg"] = {k: vmc.opt.state[p]["exp_avg"].clone()
                             for k, p in model.named_parameters() if p in vmc.opt.state}
    st["final_params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    for undo in st.pop("restore"):
        undo()
    return st


def _record(st, plant):
    """Wrap the trainer's stage calls so that the checked steps record
    their outputs (and, for a planted fault, break one of them)."""
    from pynqs_tpu_torch.optim import vmc as vmc_mod

    vmc, tr = st["vmc"], st["tr"]
    R = 1 + _k_det(st) + tr["n_stoch"]
    rng = np.random.default_rng(st["seed"] + 7)
    sample0, eloc0, fwd0 = vmc._sample, vmc.local_energy, vmc._eloc_forward

    def _sample(smp, g):
        bits, w, diag = sample0(smp, g)
        if plant == "half_sample":  # every other row left out, the rest renormalized
            w = w.clone()
            w[1::2] = 0
            w = w / w.sum()
        alive = torch.nonzero(w > 0)[:, 0].cpu().numpy()
        order = alive[np.argsort(-w[alive].cpu().numpy(), kind="stable")]
        top = order[: tr["checked_top"]]
        rest = np.setdiff1d(alive, top)
        pick = rng.choice(rest, size=min(len(rest), tr["checked_rows"] - len(top)),
                          replace=False)
        sel = np.sort(np.concatenate([top, pick]))
        st["rec"][-1].update(bits=bits.clone(), w=w.clone(),
                             dropped=float(diag["dropped_frac"]),
                             sel=torch.as_tensor(sel, device=bits.device), rows=[], off=0)
        return bits, w, diag

    def recorder(fwd):
        def f(flat):
            lp = fwd(flat)
            r = st["rec"][-1]
            b = flat.shape[0] // R
            sel = r["sel"]
            inside = sel[(sel >= r["off"]) & (sel < r["off"] + b)] - r["off"]
            r["rows"].append(flat.view(b, R, -1)[inside].clone())
            r["off"] += b
            return lp
        return f

    def local_energy(bits, g):
        eloc = eloc0(bits, g)
        if plant == "altered":  # the heaviest row's local energy altered
            eloc = eloc.clone()
            eloc[int(torch.argmax(st["rec"][-1]["w"]))] += 0.5
        st["rec"][-1]["eloc"] = eloc.clone()
        return eloc

    vmc._sample = _sample
    vmc.local_energy = local_energy
    vmc._eloc_forward = lambda: recorder(fwd0())
    st["restore"].append(lambda: [vmc.__dict__.pop(k) for k in
                                  ("_sample", "local_energy", "_eloc_forward")])
    if plant == "half":  # the mean over every other row of the batch
        eg0 = vmc_mod.energy_and_grad

        def energy_and_grad(model, bits, w, eloc, **kw):
            w = w.clone()
            w[1::2] = 0
            return eg0(model, bits, w / w.sum(), eloc, **kw)

        vmc_mod.energy_and_grad = energy_and_grad
        st["restore"].append(lambda: setattr(vmc_mod, "energy_and_grad", eg0))
    if plant == "tail_in_det":  # each sample's first tail draw is a deterministic child
        from pynqs_tpu_torch.energy import eloc as eloc_mod
        draw0 = eloc_mod.sample_tail_cdf

        def sample_tail_cdf(resid, *a, **k):
            draw = draw0(resid, *a, **k)
            draw[:, 0] = torch.argmin(resid, 1)  # the deterministic entries are zeroed there
            return draw

        eloc_mod.sample_tail_cdf = sample_tail_cdf
        st["restore"].append(lambda: setattr(eloc_mod, "sample_tail_cdf", draw0))
    if plant == "unchanged":  # the update leaves the parameters as they were
        def apply_gradients(grads, scale=1.0):
            vmc.count += 1
            return vmc.lr_at(vmc.count - 1)

        vmc.apply_gradients = apply_gradients


def _k_det(st):
    cfg = st["cfg"]
    return min(st["tr"]["k_det"], ref.n_excitations(cfg["sorb"], cfg["noa"], cfg["nob"]))


def _step(st):
    """One training step as ``VMC.run`` makes it: the step, then the
    values the loop reads back (which wait for the card)."""
    out = st["vmc"].step(st["gen"], st["tr"]["clip"])
    e, gnorm, w_sum = float(out["energy"]), float(out["gnorm"]), float(out["w_sum"])
    if not (math.isfinite(e) and math.isfinite(gnorm) and w_sum > 0):
        raise FloatingPointError(f"step: energy {e}, gnorm {gnorm}, w_sum {w_sum}")
    st.setdefault("n_unique", []).append(int(out["n_unique"]))
    return out


def window(st, seconds):
    """Steps until ``seconds`` have passed; the window ends at a
    synchronize after the last step."""
    dev = st["dev"]
    st["n_unique"] = []
    t0 = _now(dev)
    n = 0
    while True:
        _step(st)
        n += 1
        t = _now(dev) - t0
        if t >= seconds:
            break
    cfg, tr = st["cfg"], st["tr"]
    per_row = roofline.row_flop(cfg["dcut"], cfg["sorb"] // 2, cfg["max_preds"],
                                cfg["dcut_cmpr"] if cfg["use_tensor"] else 0)
    # the rows the work needs: the kept samples, not the compaction's dead rows
    kept = sum(st["n_unique"])
    k1_rows = kept * (1 + _k_det(st) + tr["n_stoch"])
    return {"attempted": n, "failed": 0, "window_s": t, "steps": n,
            "end_to_end": {"vmc_step_s": t / n},
            "kernel1_flop": k1_rows * per_row,
            "kernel1_bytes": k1_rows * (cfg["sorb"] + 8),
            # eloc forwards, the gradient's forward and backward (3x) over
            # the kept samples, and one forward per kept sample for the sampler
            "model_flop": (k1_rows + 4 * kept) * per_row}


def _now(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def report(st, work):
    print(f"[vmc] steps in window {work['steps']}, {work['window_s']:.3f} s; kept samples per "
          f"step {st['n_unique']}; checked steps {len(st['rec'])}", flush=True)
    print(f"[vmc] {program.launch_line()}", flush=True)
    if st["dev"].type == "cuda":
        print(f"[vmc] peak memory {torch.cuda.max_memory_allocated(st['dev'])} B", flush=True)


def _leaf_gap(prog: dict, refd: dict, keep=None) -> float:
    """Worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, the median leaf's ‖ref‖)."""
    names = [k for k in refd if keep is None or k in keep]
    rn = {k: float(refd[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in names)


def _eloc_numbers(e_prog, e_ref, scale, w) -> dict:
    """Local-energy gaps of the checked rows: the median relative to each
    row's sum of term magnitudes, and the weight-averaged gap in Ha."""
    d = (e_prog - e_ref).norm(dim=-1)
    return {"eloc_rel_med": float((d / scale.clamp(min=1e-30)).median()),
            "eloc_w_abs": float((w * d).sum() / w.sum())}


def judge(st, lim, control=False):
    """The numbers that decide ``correct`` (each with its limit), and with
    ``control`` the same numbers of the reference put in the program's
    place in the next lower precision."""
    cfg, tr, dev, rec = st["cfg"], st["tr"], st["dev"], st["rec"]
    st.pop("vmc")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    noa, nob = cfg["noa"], cfg["nob"]
    ham, preds, p0 = ref.judge_inputs(cfg, *st["h"], st["seed"], st["root"], dev)
    ut = cfg["use_tensor"]
    n, kd = tr["n_sample"], _k_det(st)
    gaps = {"energy_gap": 0.0, "sampler_chi2": 0.0, "selection_faults": 0}
    cand, ccand = [], []
    grads, cgrads = [], []
    for k, r in enumerate(rec):
        P = p0 if k == 0 else r["params"]
        rows = torch.cat(r["rows"], 0)
        fwd = lambda b, P=P: ref.log_psi_blocks(P, preds, b, noa, nob, use_tensor=ut)  # noqa
        e_ref, scale, sel_bad = ref.reduce_eloc(ham, fwd, rows, kd, tr["n_stoch"])
        gaps["selection_faults"] += int(sel_bad.sum())
        w_sel = r["w"][r["sel"]].double()
        cand.append(_eloc_numbers(r["eloc"][r["sel"]].double(), e_ref, scale, w_sel))
        if control:
            fq = lambda b, P=P: ref.log_psi_blocks(P, preds, b, noa, nob, use_tensor=ut,  # noqa
                                                   quant="fp8")
            ccand.append(_eloc_numbers(ref.reduce_eloc(ham, fq, rows, kd, tr["n_stoch"])[0],
                                       e_ref, scale, w_sel))
        w, eloc = r["w"].double(), r["eloc"].double()
        alive = w > 0
        e_w = float((w[alive] * eloc[alive, 0]).sum())
        gaps["energy_gap"] = max(gaps["energy_gap"], abs(r["energy"] - e_w))
        # the sampler: counts against n |psi|^2 where at least chi2_min_count are expected
        lp = ref.log_psi_blocks(P, preds, r["bits"][alive], noa, nob, use_tensor=ut)
        mu = n * torch.exp(2.0 * lp[:, 0].double())
        cnt = w[alive] * n * (1.0 - r["dropped"])
        big = mu >= tr["chi2_min_count"]
        if int(big.sum()):
            chi2 = float(((cnt[big] - mu[big]) ** 2 / mu[big]).mean())
            gaps["sampler_chi2"] = max(gaps["sampler_chi2"], chi2)
        g = ref.energy_grad(P, preds, r["bits"], r["w"], r["eloc"], noa, nob, use_tensor=ut,
                            block=tr["grad_batch"])
        s = ref.clip_scale(g, tr["clip"])
        grads.append({k2: v * s for k2, v in g.items()})
        if control:
            g = ref.energy_grad(P, preds, r["bits"], r["w"], r["eloc"], noa, nob,
                                use_tensor=ut, block=tr["grad_batch"], tf32=True)
            s = ref.clip_scale(g, tr["clip"])
            cgrads.append({k2: v * s for k2, v in g.items()})
    # the first gradient as the optimizer got it: its first moment / (1 - beta1)
    # (none where the optimizer took no step: a zero gradient)
    g_prog = {k: st["exp_avg"][k] / 0.1 if k in st["exp_avg"] else torch.zeros_like(v)
              for k, v in grads[0].items()}
    gaps["grad_gap"] = _leaf_gap(g_prog, grads[0])
    rn = {k: float(v.norm()) for k, v in grads[0].items()}
    med = float(np.median(list(rn.values())))
    keep = {k for k, v in rn.items() if v >= 1e-3 * med}
    sched = [tr["lr"] * (tr["lr_end"] / tr["lr"]) ** (c / tr["iters"]) for c in range(len(rec))]
    p_ref = ref.adamw_steps(p0, grads, sched)
    d_ref = {k: p_ref[k] - p0[k] for k in p0}
    d_prog = {k: st["final_params"][k] - p0[k] for k in p0}
    gaps["update_gap"] = _leaf_gap(d_prog, d_ref, keep)
    for k in cand[0]:
        gaps[k] = max(c[k] for c in cand)
    ctrl = None
    if control:
        ctrl = {k: max(c[k] for c in ccand) for k in ccand[0]}
        ctrl["grad_gap"] = _leaf_gap(cgrads[0], grads[0])
        pc = ref.adamw_steps(p0, cgrads, sched)
        ctrl["update_gap"] = _leaf_gap({k: pc[k] - p0[k] for k in p0}, d_ref, keep)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()}
    print(f"[vmc] readings {gaps}", flush=True)
    print(f"[vmc] leaves left out of update_gap (reference gradient under 1e-3 of the median "
          f"leaf's): {sorted(set(p0) - keep)}", flush=True)
    return checks, ctrl
