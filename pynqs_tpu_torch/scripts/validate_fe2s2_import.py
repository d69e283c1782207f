"""Validate the DMRG (FOCUS dcut 20) import on the card: the VMC energy of
the imported Graph-MPS-RNN state.

Counterpart of ``scripts/validate_fe2s2_import.py``: plain AR sampling
of 200,000 draws (capacity 1024), then the REDUCE local energy (k_det
1024, n_stoch 256, batch 256) through ``model.log_psi`` and, beside it,
SIMPLE's exact local energy on the same rows, so that the two estimates
of E(import) can be compared (REDUCE is unbiased: they agree within the
tail's noise).  A faithful import gives about the DMRG energy (the
reference e_ref is -116.6056 Ha).

    python -m pynqs_tpu_torch.scripts.validate_fe2s2_import

Files as ``fe2s2_train_from_dmrg``: ``main(system=..., argv=["--focus",
path])`` for any system and converted FOCUS file.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pynqs_tpu_torch.energy.eloc import local_energy_reduce, local_energy_simple
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.sampler.ar import ar_sampling
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import FE2S2_FOCUS_PTH, fe2s2_system
from pynqs_tpu_torch.utils.mps_import import load_focus_mpsrnn

__all__ = ["main", "parser", "REPO", "N_SAMPLE", "CAPACITY", "K_DET", "N_STOCH", "BATCH"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_SAMPLE, CAPACITY = 200_000, 1024  # the AR draw
K_DET, N_STOCH, BATCH = 1024, 256, 256  # REDUCE; BATCH samples per eloc chunk


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dcut", type=int, default=20)
    ap.add_argument("--focus", type=str, default=FE2S2_FOCUS_PTH,
                    help="the converted FOCUS MPS file (a torch state dict)")
    return ap


@torch.no_grad()
def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """Returns {"e_reduce", "e_simple" (ecore included), "var_reduce",
    "n_unique", "kept"}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    f32 = dev.type != "cpu"
    dt = torch.float32 if f32 else torch.float64
    sys_ = system if system is not None else fe2s2_system(np.float32 if f32 else np.float64)
    print(f"e_ref = {sys_.e_ref}", flush=True)
    model = GraphMPSRNN(sys_.sorb, sys_.noa, sys_.nob, dcut=args.dcut, phase_mode="arg",
                        norm_mode="mpsrnn", dtype=dt, device=dev)
    model.load_numpy_params(load_focus_mpsrnn(os.path.join(root, args.focus), model))

    t0 = time.time()
    bits, counts, _ = ar_sampling(model, N_SAMPLE, capacity=CAPACITY,
                                  generator=torch.Generator(device=dev).manual_seed(0))
    kept = int(counts.sum())
    print(f"sampling: {int((counts > 0).sum())} unique, kept {kept}/{N_SAMPLE}, "
          f"t={time.time() - t0:.1f}s", flush=True)
    w = (counts.double() / kept).to(dev)
    alive = w > 0
    tabs = sys_.tables(dev, dt)
    ops, table = tabs.astuple(), sys_.excitation

    def stats(eloc):
        e = float((w[alive] * eloc[alive, 0].double()).sum())
        return e, float((w[alive] * (eloc[alive, 0].double() - e) ** 2).sum())

    t0 = time.time()
    e_r, var_r = stats(local_energy_reduce(
        model.log_psi, bits, ops, table, torch.Generator(device=dev).manual_seed(1),
        k_det=K_DET, n_stoch=N_STOCH, batch=BATCH, hpair=tabs.hpair_best))
    print(f"REDUCE eloc t={time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    e_s, var_s = stats(local_energy_simple(model.log_psi, bits, ops, table, batch=BATCH,
                                           hpair=tabs.hpair_best))
    print(f"SIMPLE eloc t={time.time() - t0:.1f}s", flush=True)
    e_r, e_s = e_r + sys_.ecore, e_s + sys_.ecore
    print(f"E(import) REDUCE = {e_r:.6f} Ha   sigma^2 = {var_r:.4f}")
    print(f"E(import) SIMPLE = {e_s:.6f} Ha   sigma^2 = {var_s:.4f}   "
          f"REDUCE - SIMPLE = {(e_r - e_s) * 1000:+.3f} mHa")
    if sys_.e_ref is not None:
        print(f"Delta vs e_ref = {(e_r - sys_.e_ref) * 1000:+.1f} mHa")
    return {"e_reduce": e_r, "e_simple": e_s, "var_reduce": var_r,
            "n_unique": int(alive.sum()), "kept": kept}


if __name__ == "__main__":
    main()
