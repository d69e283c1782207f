"""Rank bodies of the port's data-parallel tests (``tests/test_torch_dist_*.py``).

``parallel.run_ranks`` pickles these by name into spawned processes, so
they live in a module that imports torch and the port only.  Each takes
the rank's mesh, or None for the one-process reference of the same
scenario, and returns numpy arrays and floats.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig
from pynqs_tpu_torch.grad.energy_grad import energy_and_grad
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.models.rnn import RNNWavefunction
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.parallel import (all_reduce_sum, generators_in_sync, replicated_check,
                                      shard_batch)
from pynqs_tpu_torch.sampler.ar import ar_sampling_sharded
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.sampler.mcmc import MCMCSampler
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.system import System

CPU = torch.device("cpu")


def _model(system, seed=0, dcut=4):
    return GraphMPSRNN(system.sorb, system.noa, system.nob, dcut=dcut, phase_mode="arg",
                       norm_mode="mpsrnn", dtype=torch.float64, device=CPU,
                       generator=torch.Generator().manual_seed(seed))


def _params(model) -> dict:
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def _vmc_run(mesh, system, sampler, cfg, n_iter, seed=7) -> dict:
    """A VMC run; after every step the parameters, and (under a mesh) their
    largest difference between the ranks and whether the shared generator
    is in sync."""
    model = _model(system)
    vmc = VMC(model, system, sampler, cfg, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    params, spread, sync = [], [], []

    def cb(it, info):
        params.append(_params(model))
        spread.append(replicated_check(mesh, dict(model.named_parameters())))
        sync.append(generators_in_sync(mesh, gen))

    hist = vmc.run(gen, n_iter, callback=cb)
    return {"history": np.asarray(hist), "params": params, "spread": spread, "sync": sync}


def vmc_scenarios(mesh) -> dict:
    """An ExactSampler run with REDUCE (its tail drawn globally), an MCMC
    run and a CG-SR run, each 5 or 3 steps; and a fixed-node GFMC run over
    the same ranks.  The CG takes 5 iterations: on these 24 rows its
    residual reaches roundoff near the 8th, after which its steps divide
    roundoff by roundoff and two summation orders part at 1e-9."""
    exact_sys = System.hubbard_1d(4, 2, 1, u=4.0)  # 24 determinants
    mcmc_sys = System.hubbard_1d(4, 2, 2, u=4.0)
    red = dict(eloc_method="reduce", eloc_k_det=4, eloc_n_stoch=3)
    out = {
        "exact": _vmc_run(mesh, exact_sys, ExactSampler(8, 2, 1),
                          VMCConfig(lr=1e-2, log_every=10**6, **red), 5),
        "mcmc": _vmc_run(mesh, mcmc_sys, MCMCSampler(8, 2, 2, n_chain=64, n_sweep=4, therm=8),
                         VMCConfig(lr=1e-2, log_every=10**6, **red), 3),
        "cg": _vmc_run(mesh, exact_sys, ExactSampler(8, 2, 1),
                       VMCConfig(lr=1e-2, log_every=10**6, optimizer="sgd", use_sr=True,
                                 sr_solver="cg", sr_n_cg=5, sr_damping=1e-1, grad_batch=5),
                       3),
    }
    trial = _model(mcmc_sys, seed=3)
    space = fci.fci_bits(8, 2, 2)
    walkers = space[np.random.default_rng(4).integers(0, space.shape[0], 64)]
    gen = torch.Generator().manual_seed(3)
    res = GFMC(lambda b: trial.log_psi(b).detach(), mcmc_sys,
               GFMCConfig(n_walkers=64, n_iter=12, branch_interval=4, sync_interval=5),
               device=CPU, mesh=mesh).run(walkers, generator=gen)
    out["gfmc"] = {k: res[k] for k in ("e_gen", "e_gen_b", "wbar", "walkers", "weights")}
    out["gfmc"]["sync"] = generators_in_sync(mesh, gen)
    return out


def _rnn():
    return RNNWavefunction(8, 2, 2, hidden=16, phase_hidden=8, device=CPU,
                           generator=torch.Generator().manual_seed(0))


def sampling_scenarios(mesh) -> dict:
    """``ar_sampling_sharded`` twice from one seed, the same-tree sampler
    with the global compaction, and the independent mode."""
    model = _rnn()
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        bits, counts, dropped = ar_sampling_sharded(model, 400_000, capacity=512, mesh=mesh,
                                                    tree_height=3, generator=gen)
        runs.append({"bits": bits.numpy(), "counts": counts.numpy(),
                     "dropped": int(dropped), "sync": generators_in_sync(mesh, gen)})
    gen = torch.Generator().manual_seed(6)
    smp = ARSampler(8, 2, 2, n_sample=50_000, capacity=64, mesh=mesh, max_unique=16)
    state = gen.get_state()
    uncompacted = ARSampler(8, 2, 2, n_sample=50_000, capacity=64, mesh=mesh)
    full_bits, full_w, _ = uncompacted.sample(model, gen)
    gen.set_state(state)
    bits, w, diag = smp.sample(model, gen)
    compact = {"bits": bits.numpy(), "w": w.numpy(), "full_bits": full_bits.numpy(),
               "full_w": full_w.numpy(), "dropped_frac": float(diag["dropped_frac"])}
    gm = GraphMPSRNN(8, 2, 2, dcut=6, dtype=torch.float64, device=CPU,
                     generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(7)
    ind = ARSampler(8, 2, 2, n_sample=400_000, capacity=64, mesh=mesh, mesh_mode="independent")
    bits, w, diag = ind.sample(gm, gen)
    independent = {"bits": bits.numpy(), "w": w.numpy(),
                   "dropped_frac": float(diag["dropped_frac"]),
                   "n_unique": int(diag["n_unique"]), "sync": generators_in_sync(mesh, gen)}
    return {"sharded": runs, "compact": compact, "independent": independent}


def grad_scenario(mesh, case) -> dict:
    """``energy_and_grad`` on fixed rows, weights and local energies split
    over the ranks (``case``: the inputs, built by the caller)."""
    model = GraphMPSRNN(12, 3, 3, dcut=5, device=CPU, **case["model_kw"])
    model.load_numpy_params(case["params"])
    bits, w, eloc = (shard_batch(mesh, torch.as_tensor(case[k])) for k in ("bits", "w", "eloc"))
    e, grads, var = energy_and_grad(model, bits, w, eloc, grad_batch=7, mesh=mesh)
    return {"e": e.numpy(), "var": float(var), "grads": {k: g.numpy() for k, g in grads.items()}}


def fail_on_rank_one(mesh):
    """Rank 1 raises; rank 0 waits in a collective that cannot finish."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return float(all_reduce_sum(mesh, torch.ones(())))
