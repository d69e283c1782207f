"""Precompute a heat-bath selected-CI space for the Fe2S2 NqsCi run.

Counterpart of ``scripts/fe2s2_hci_precompute.py``, with its command
line and defaults: grows an HCI space from the HF determinant with
``ci.selected.selected_ci`` and saves it with ``ci.solve.save_ci`` for
``fe2s2_nqsci_train --ci-file``.  It runs on the card in f64 (the JAX
script runs on the CPU with x64).

    python -m pynqs_tpu_torch.scripts.fe2s2_hci_precompute --max-space 4096 --eps1 1e-4

writes ``checkpoints/fe2s2_hci_m<m>.npz`` under the repository (``--out``
elsewhere).  The default system is the Fe2S2 integrals file
(``utils.flagship.fe2s2_system``), which the repository does not hold:
``main(system=...)`` takes any ``System``, ``root=`` another directory
for the file.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from pynqs_tpu_torch.ci.selected import selected_ci
from pynqs_tpu_torch.ci.solve import save_ci
from pynqs_tpu_torch.scripts.fe2s2_r3_push import REPO
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.flagship import fe2s2_system

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eps1", type=float, default=1e-4)
    ap.add_argument("--max-space", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--max-rounds", type=int, default=20)
    ap.add_argument("--eps2", type=float, default=None,
                    help="also compute deterministic EN-PT2 (slow)")
    ap.add_argument("--out", type=str, default=None)
    return ap


def main(argv=None, *, system=None, device=None, root: str = REPO) -> dict:
    """The JAX script's ``main`` on ``system`` (default
    ``fe2s2_system(np.float64)``) on ``device`` (default the card); prints
    its report and returns {"e_var", "m", "info", "seconds", "path"}."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    sys_ = system if system is not None else fe2s2_system(np.float64)
    t0 = time.time()
    e_var, ci, info = selected_ci(
        sys_, eps1=args.eps1, max_space=args.max_space, max_rounds=args.max_rounds,
        chunk=args.chunk, eps2=args.eps2, verbose=True, device=dev)
    dt = time.time() - t0
    m = int(ci.bits.shape[0])
    out = args.out or os.path.join(root, f"checkpoints/fe2s2_hci_m{m}.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_ci(out, ci, e_var=e_var, eps1=args.eps1, rounds=info["rounds"], seconds=dt)

    def vs_ref(e):
        return f" ({(e - sys_.e_ref) * 1000:+.3f} mHa vs e_ref)" if sys_.e_ref is not None else ""

    print(f"\nHCI m={m}  E_var = {e_var:.8f} Ha{vs_ref(e_var)}  rounds={info['rounds']}  "
          f"t={dt:.0f}s")
    if "e_total" in info:
        print(f"  +PT2: {info['e_total']:.8f} Ha{vs_ref(info['e_total'])}")
    print(f"saved {out}")
    return {"e_var": e_var, "m": m, "info": info, "seconds": dt, "path": out}


if __name__ == "__main__":
    main()
