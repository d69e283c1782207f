"""Spin-filtered subspace energy of a trained state on its captured set,
on the card.

Counterpart of ``scripts/spin_subspace_eval.py``, with its command line
and defaults.  The trained Fe2S2 states carry even-S spin contamination;
without retraining, this measures the best energy in the spin Krylov
subspace

    span{ v,  S²v,  (S²)² v }          (S² = S⁻S⁺ on Sz=0)

of the state restricted to its DFS-captured determinant set S (n 1e7 in
8 groups, split depth 9, capacity 4096).  Every operator application is
an S-restricted matvec through the sample-space local energy
(``energy.eloc.local_energy_sample_space``: comb_hij and the port's
LUT) in f64, so each energy is the exact Rayleigh quotient of a CI
vector supported on S: variational.  Reports E(v) on S, E of (6-S²)/6 v
and (6-S²)(20-S²)/120 v, and the optimum of the 3x3 generalized
eigenproblem (scipy, on the host), each with its <S-S+>.

    python -m pynqs_tpu_torch.scripts.spin_subspace_eval <ckpt> [--dcut 64 --use-tensor --max-preds 2]

The JAX script runs on the CPU; this one runs on the card unless
``main(..., device="cpu")``.  ``main(system=...)`` takes any ``System``
(default the Fe2S2 integrals, ``utils.flagship.fe2s2_system``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from scipy.linalg import eigh

from pynqs_tpu_torch.energy.eloc import local_energy_sample_space
from pynqs_tpu_torch.ops.hamiltonian import hij_diagonal
from pynqs_tpu_torch.ops.integrals import precompute_hij_tables, spin_raising
from pynqs_tpu_torch.ops.lut import WavefunctionLUT
from pynqs_tpu_torch.sampler.ar import ar_sampling_dfs
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system, flagship_model, load_flagship_params

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("--dcut", type=int, default=20)
    ap.add_argument("--n-sample", type=int, default=10_000_000)
    ap.add_argument("--n-group", type=int, default=8)
    ap.add_argument("--split-depth", type=int, default=9)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--use-tensor", action="store_true")
    ap.add_argument("--max-preds", type=int, default=1)
    return ap


@torch.no_grad()
def main(argv=None, *, system=None, device=None) -> dict:
    """Returns {"bits" (the captured set), "n_set", "dropped", "rows":
    {name: (E, <S-S+>)}} with the names "v", "p6", "p6p20" and
    "optimum" (E with ecore)."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    f64 = torch.float64
    sys_ = system if system is not None else fe2s2_system(np.float64)
    model = flagship_model(sys_, args.dcut, use_tensor=args.use_tensor,
                           max_preds=args.max_preds, device=dev)
    model.load_numpy_params({k: np.asarray(v, np.float32)
                             for k, v in load_flagship_params(args.ckpt).items()})

    t0 = time.time()
    bits, counts, dropped = ar_sampling_dfs(
        model, args.n_sample, capacity=args.capacity, n_group=args.n_group,
        split_depth=args.split_depth, capacity_root=args.capacity,
        generator=torch.Generator(device=dev).manual_seed(7))
    bits = bits[counts > 0].contiguous()
    U = bits.shape[0]
    print(f"captured set: {U} dets, dropped mass {float(dropped) / args.n_sample:.3%}  "
          f"({time.time() - t0:.0f}s)", flush=True)

    # amplitudes of the trained state on S (f32 forward, f64 algebra)
    lp = model.log_psi(bits).to(f64)
    v = torch.polar(torch.exp(lp[:, 0]), lp[:, 1])
    v = v / torch.linalg.vector_norm(v)

    ops_h = sys_.tables(dev, f64).astuple()
    ts = precompute_hij_tables(*spin_raising(sys_.sorb), sys_.sorb, np.float64)
    ops_s = tuple(torch.as_tensor(x, dtype=f64, device=dev)
                  for x in (ts.h1e, ts.h2e, ts.diag1, ts.K, ts.J))
    ones_pair = torch.zeros(U, 2, dtype=f64, device=dev)

    def pair_of(u):
        return torch.stack([torch.log(torch.clamp(u.abs(), min=1e-280)), torch.angle(u)], -1)

    def matvec(ops, diag, u):
        """y = O_S u, the operator restricted to the captured set: the
        sample-space local energy with a unit reference amplitude (so the
        ratios are u(m), no division by u(x), which may vanish for a
        projected vector), u scaled to max |u| = 1 for the log-pair LUT,
        and the diagonal added back."""
        scale = u.abs().max()
        un = u / scale
        lut = WavefunctionLUT.build(bits, pair_of(un))
        el = local_energy_sample_space(bits, ones_pair, lut, ops, sys_.excitation,
                                       batch=args.batch)
        off = torch.complex(el[:, 0] - diag, el[:, 1])
        return scale * (off + diag * un)

    diag_h = hij_diagonal(bits, ops_h[2], ops_h[3]).to(f64)
    diag_s = hij_diagonal(bits, ops_s[2], ops_s[3]).to(f64)

    def H(u):
        return matvec(ops_h, diag_h, u)

    def S2(u):
        return matvec(ops_s, diag_s, u)

    def vdot(a, b):
        return torch.vdot(a, b).real.item()

    def vs_ref(e):
        return f"  ({(e - sys_.e_ref) * 1000:+.3f} mHa)" if sys_.e_ref is not None else ""

    rows = {}

    def report(key, name, u):
        n2 = vdot(u, u)
        e = vdot(u, H(u)) / n2 + sys_.ecore
        ss = vdot(u, S2(u)) / n2
        print(f"{name:28s} E = {e:.6f} Ha{vs_ref(e)}   <S-S+> = {ss:.4f}", flush=True)
        rows[key] = (e, ss)

    t0 = time.time()
    b0 = v
    b1 = S2(b0)
    b2 = S2(b1)
    print(f"S2 Krylov built ({time.time() - t0:.0f}s)", flush=True)
    report("v", "v (captured-set RQ)", b0)
    report("p6", "(6-S2)/6 v", (6.0 * b0 - b1) / 6.0)
    report("p6p20", "(6-S2)(20-S2)/120 v", (120.0 * b0 - 26.0 * b1 + b2) / 120.0)

    # the generalized eigenproblem in span{b0, b1, b2}, on the host
    B = torch.stack([b0, b1, b2], 1)  # [U, 3]
    t0 = time.time()
    HB = torch.stack([H(B[:, j]) for j in range(3)], 1)
    print(f"H matvecs done ({time.time() - t0:.0f}s)", flush=True)
    A = (B.conj().T @ HB).cpu().numpy()
    M = (B.conj().T @ B).cpu().numpy()
    w, c = eigh((A + A.conj().T) / 2, (M + M.conj().T) / 2)
    u_opt = B @ torch.as_tensor(c[:, 0], device=dev)
    e_opt = float(w[0]) + sys_.ecore
    ss_opt = vdot(u_opt, S2(u_opt)) / vdot(u_opt, u_opt)
    print(f"{'subspace optimum':28s} E = {e_opt:.6f} Ha{vs_ref(e_opt)}   <S-S+> = {ss_opt:.4f}")
    rows["optimum"] = (e_opt, ss_opt)
    return {"bits": bits, "n_set": U, "dropped": float(dropped) / args.n_sample, "rows": rows}


if __name__ == "__main__":
    main()
