"""Entry points: a one-card compile check and a data-parallel dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

``entry()``: the REDUCE energy of a Graph-MPS-RNN on a Hubbard chain,
its ψ forwards through the fused forward (kernel #1 on the card).
``dryrun_multichip(n)``: the production VMC step (tree-sharded AR
sampling, REDUCE local energy, microbatched gradient, Adam update) over
n ranks of ``torch.distributed``, one process each.

    python -m pynqs_tpu_torch.entry [n_devices]
"""

from __future__ import annotations

import math
import sys

import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn, onv
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.parallel.launch import run_ranks
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.system import System

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): ``fn(model, bits)`` is the mean REDUCE local
    energy (k_det 32, n_stoch 8, the tail drawn from a generator of seed 1)
    of ``GraphMPSRNN`` dcut 8 (f32, seed 0) on ``System.hubbard_1d(8, 3,
    3, u=4.0)``, over 64 copies of the Hartree–Fock row.  On the card the
    ψ forwards launch kernel #1 in bf16; on the CPU (asked for) they take
    its plain version in f32."""
    dev = resolve_device(device)
    system = System.hubbard_1d(8, 3, 3, u=4.0)
    model = GraphMPSRNN(system.sorb, system.noa, system.nob, dcut=8, dtype=torch.float32,
                        device=dev, generator=torch.Generator().manual_seed(0))
    tabs = system.tables(dev, torch.float32)
    hf = torch.as_tensor(onv.hf_bits(system.sorb, system.noa, system.nob), device=dev)
    bits = hf.expand(64, system.sorb).contiguous()
    mm = torch.bfloat16 if dev.type == "cuda" else torch.float32

    def fn(model, bits):
        eloc = local_energy_reduce(
            lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=mm),
            bits, tabs.astuple(), system.excitation,
            torch.Generator(device=dev).manual_seed(1), k_det=32, n_stoch=8,
            hpair=tabs.hpair_best,
        )
        return eloc[:, 0].mean()

    return fn, (model, bits)


def _dryrun_rank(mesh) -> dict:
    """One rank of ``dryrun_multichip``: the JAX dry run's configuration
    over ``mesh``, one iteration.  Returns the rank's history and its
    kernel #1 launches."""
    system = System.hubbard_1d(6, 2, 2, u=4.0)
    n = mesh.size
    model = GraphMPSRNN(system.sorb, system.noa, system.nob, dcut=4, phase_mode="arg",
                        norm_mode="mpsrnn", dtype=torch.float32, device=mesh.device,
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(system.sorb, system.noa, system.nob, n_sample=4096, capacity=16 * n,
                        mesh=mesh)
    vmc = VMC(model, system, sampler,
              VMCConfig(n_iter=1, lr=1e-2, log_every=10**6, eloc_method="reduce",
                        eloc_k_det=8, eloc_n_stoch=4, grad_batch=8 * n),
              mesh=mesh)
    fused_rnn.LAUNCHES.reset()
    hist = vmc.run(torch.Generator(device=mesh.device).manual_seed(0), n_iter=1)
    return {"history": hist, "launches": fused_rnn.LAUNCHES.n}


def dryrun_multichip(n_devices: int, *, device=None, backend: str | None = None,
                     timeout: float = 900.0, rendezvous_dir: str | None = None) -> list:
    """The flagship production VMC step over ``n_devices`` ranks.  On the
    card (the default): NCCL with one card per rank, and it raises when
    there are fewer cards than ranks unless ``backend="gloo"`` is given,
    which puts several ranks on one card; ``device="cpu"``: gloo.  It
    never moves to the CPU by itself.  Raises on a non-finite energy;
    returns each rank's {"history", "launches"}."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError("dryrun_multichip: CPU ranks take the gloo backend")
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip: {n_devices} ranks over NCCL need "
                           f"{n_devices} cards, there are {torch.cuda.device_count()} "
                           f"(backend='gloo' shares them)")
    out = run_ranks(_dryrun_rank, n_devices, backend=backend, device=dev, timeout=timeout,
                    rendezvous_dir=rendezvous_dir)
    for r, res in enumerate(out):
        if not all(math.isfinite(e) for e in res["history"]):
            raise FloatingPointError(f"non-finite energy from the dry run on rank {r}: "
                                     f"{res['history']}")
    return out


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry: E = {float(fn(*args)):.8f}")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    print(f"dryrun_multichip({n}): {dryrun_multichip(n)}")
