"""Energy-history summary figure: the full trajectory, a zoom inset on
the tail and the mHa error against a reference energy.

Counterpart (a copy) of ``pynqs_tpu/utils/plotting.py``; matplotlib is
imported only when a figure is drawn.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_energy_history"]


def plot_energy_history(history, e_ref: float | None = None, path: str = "energy.png",
                        tail: int = 100):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for plotting") from e

    h = np.asarray(history, dtype=float)
    it = np.arange(len(h))
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(it, h, lw=0.8)
    ax.set_xlabel("iteration")
    ax.set_ylabel("E [Ha]")
    title = f"final mean(last {min(tail, len(h))}) = {h[-min(tail, len(h)):].mean():.6f} Ha"
    if e_ref is not None:
        err = (h[-min(tail, len(h)):].mean() - e_ref) * 1000
        title += f"   Δref = {err:+.3f} mHa"
        ax.axhline(e_ref, color="k", ls="--", lw=0.6)
    ax.set_title(title, fontsize=9)
    if len(h) > 2 * tail:
        ins = ax.inset_axes([0.45, 0.45, 0.5, 0.45])
        ins.plot(it[-tail:], h[-tail:], lw=0.8)
        if e_ref is not None:
            ins.axhline(e_ref, color="k", ls="--", lw=0.6)
        ins.tick_params(labelsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
