"""The program's side of a cell's set-up: the stand-in system and the
configuration's model with its weights, built through pynqs_tpu_torch's
own entry points, and the launch counters printed beside a result."""

from __future__ import annotations

import os

import numpy as np

from bench_h100 import reference as ref

__all__ = ["system_and_model", "launch_line"]


def system_and_model(cfg, seed, dev, root):
    """(h1e, h2e, System, GraphMPSRNN): the seeded stand-in integrals,
    handed to the program as a float32 ``System``, and the flagship model
    with the configuration's checkpoint (or, without one, the seeded
    weights the reference draws alike)."""
    from pynqs_tpu_torch.utils.flagship import flagship_model, load_flagship_params
    from pynqs_tpu_torch.utils.system import System

    sorb, noa, nob = cfg["sorb"], cfg["noa"], cfg["nob"]
    h1e, h2e = ref.stand_in_integrals(seed, sorb)
    system = System.from_integrals(h1e, h2e, sorb, noa, nob, dtype=np.float32)
    model = flagship_model(system, cfg["dcut"], use_tensor=cfg["use_tensor"],
                           max_preds=cfg["max_preds"], device=dev)
    if cfg.get("weights"):
        model.load_numpy_params(load_flagship_params(os.path.join(root, cfg["weights"])))
    else:
        model.load_numpy_params(ref.seeded_params(seed, {k: tuple(p.shape) for k, p in
                                                         model.named_parameters()}))
    return h1e, h2e, system, model


def launch_line() -> str:
    """Kernel launches so far: every eloc and trial forward should count
    as a bf16 tensor-core launch of kernel #1."""
    from pynqs_tpu_torch.ops import fused_rnn, pair_select

    return (f"launches: fused forward {fused_rnn.LAUNCHES.n}, bf16 tensor-core "
            f"{fused_rnn.MMA_LAUNCHES.n}, f32 tensor-core {fused_rnn.F32_MMA_LAUNCHES.n}, "
            f"pair selection {sum(c.n for c in pair_select.LAUNCHES.values())}")
