"""Feature tour on a 6-site Hubbard chain, on the card.

Counterpart of ``examples/feature_tour.py``: the pre-train → VMC →
projector ladder end to end with no external quantum-chemistry
dependency:
  1. exact FCI reference via the dense Slater–Condon matrix,
  2. native CISD (on the singles-doubles space) + CITrain pre-training
     of the ansatz onto it,
  3. VMC with the DFS prefix-partitioned AR sampler + REDUCE eloc (Adam),
  4. matrix-free CG min-SR refinement (SGD),
  5. RESTRICTED (given-states) deterministic optimization,
  6. fixed-node GFMC on the trained NQS's CI trial with walker dedup.

    python -m pynqs_tpu_torch.examples.feature_tour

The iteration counts are keyword arguments of ``main`` with the JAX
example's values; ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.ci import CITrain, CITrainConfig, cisd_space, solve_ci
from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig, ci_trial_log_psi, mixed_energy
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.hamiltonian import hij_dense
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.fci import fci_bits
from pynqs_tpu_torch.utils.system import System

__all__ = ["main"]


def _vmc_run(vmc, seed: int, dev, tail: int = 10):
    """Run ``vmc``; returns (history, mean of the last ``tail`` energies,
    its standard error from the per-iteration σ²/n_eff)."""
    se2 = []
    hist = vmc.run(torch.Generator(device=dev).manual_seed(seed),
                   callback=lambda it, info: se2.append(info["var"] / max(info["n_eff"], 1.0)))
    t = min(tail, len(hist))
    return hist, float(np.mean(hist[-t:])), float(np.sqrt(np.sum(se2[-t:])) / t)


def main(*, device=None, dtype=torch.float32, n_citrain: int = 200, n_vmc: int = 150,
         n_sr: int = 100, n_cg: int = 100, n_restricted: int = 50, n_gfmc: int = 80) -> dict:
    """Run the tour on ``device`` (default the card); returns each rung's
    energy (Ha): {"fci", "cisd", "overlap", "vmc", "vmc_se", "sr", "sr_se",
    "restricted", "gfmc"}."""
    dev = resolve_device(device)
    sys_ = System.hubbard_1d(6, 2, 2, u=4.0)
    space = fci_bits(sys_.sorb, sys_.noa, sys_.nob)
    tabs = sys_.tables(dev, torch.float64)
    sp = torch.as_tensor(space, device=dev)
    e0 = float(torch.linalg.eigvalsh(hij_dense(sp, sp, *tabs.astuple()).double())[0])
    print(f"FCI reference: {e0:.6f} Ha over {space.shape[0]} determinants")
    out = {"fci": e0}

    # ---- 2. native CISD + CITrain pre-training ----
    e_sd, ci_sd = solve_ci(cisd_space(sys_.sorb, sys_.noa, sys_.nob), tabs, ecore=sys_.ecore)
    print(f"native CISD:  {e_sd:.6f} Ha ({1000 * (e_sd - e0):+.2f} mHa)")
    model = GraphMPSRNN(sys_.sorb, sys_.noa, sys_.nob, dcut=10, dtype=dtype, device=dev,
                        generator=torch.Generator().manual_seed(0))
    pre = CITrain(model, ci_sd.select(1e-6),
                  CITrainConfig(n_iter=n_citrain, lr=2e-2, loss="overlap", log_every=100))
    pre.run(torch.Generator(device=dev).manual_seed(4))
    out.update(cisd=e_sd, overlap=pre.overlap())
    print(f"CITrain:      |<psi|CISD>|^2 = {out['overlap']:.4f}")

    # ---- 3. VMC: DFS prefix-partitioned AR sampling + REDUCE eloc ----
    sampler = ARSampler(sys_.sorb, sys_.noa, sys_.nob, n_sample=50_000, capacity=128,
                        dfs_n_group=2, dfs_split_depth=3, dfs_capacity_root=64)
    vmc = VMC(model, sys_, sampler, VMCConfig(
        n_iter=n_vmc, lr=2e-2, optimizer="adam", eloc_method="reduce", eloc_k_det=24,
        eloc_n_stoch=8, log_every=50))
    _, out["vmc"], out["vmc_se"] = _vmc_run(vmc, 0, dev)
    print(f"VMC (Adam):   {out['vmc']:.6f} Ha ({1000 * (out['vmc'] - e0):+.2f} mHa)")

    # ---- 4. CG min-SR refinement ----
    vmc_sr = VMC(model, sys_, sampler, VMCConfig(
        n_iter=n_sr, lr=5e-2, optimizer="sgd", use_sr=True, sr_solver="cg", sr_n_cg=n_cg,
        sr_damping=1e-3, eloc_method="reduce", eloc_k_det=24, eloc_n_stoch=8, log_every=50))
    _, out["sr"], out["sr_se"] = _vmc_run(vmc_sr, 1, dev)
    print(f"VMC (CG-SR):  {out['sr']:.6f} Ha ({1000 * (out['sr'] - e0):+.2f} mHa)")

    # ---- 5. RESTRICTED deterministic optimization on a det subset ----
    with torch.no_grad():
        lp = model.log_psi(sp)
    top = np.argsort(-lp[:, 0].cpu().numpy())[:64]
    rsamp = RestrictedSampler(sys_.sorb, sys_.noa, sys_.nob, states=space[top])
    vmc_r = VMC(model, sys_, rsamp, VMCConfig(n_iter=n_restricted, lr=5e-3, log_every=50))
    hist = vmc_r.run(torch.Generator(device=dev).manual_seed(2))
    out["restricted"] = hist[-1]
    print(f"RESTRICTED:   {hist[-1]:.6f} Ha (64-det support)")

    # ---- 6. fixed-node GFMC with the trained-NQS-derived CI trial ----
    with torch.no_grad():
        lp = model.log_psi(sp).double().cpu().numpy()
    c = np.exp(lp[:, 0]) * np.cos(lp[:, 1])
    trial = ci_trial_log_psi(CIWavefunction(coeffs=c, bits=space), device=dev)
    walkers = np.repeat(space, 4, axis=0)[:256]
    res = GFMC(trial, sys_, GFMCConfig(n_iter=n_gfmc, p_steps=6, branch_interval=10,
                                       dedup_unique_max=256),
               device=dev).run(walkers, torch.Generator(device=dev).manual_seed(3))
    out["gfmc"] = mixed_energy(res, 6, tail=20)[0]
    print(f"GFMC (p=6):   {out['gfmc']:.6f} Ha ({1000 * (out['gfmc'] - e0):+.2f} mHa)")
    return out


if __name__ == "__main__":
    main()
