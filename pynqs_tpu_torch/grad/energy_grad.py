"""Variational energy gradient (pair form).

Counterpart of ``pynqs_tpu/grad/energy_grad.py``:

    ∂E = 2 ⟨ (a − ā)·∂u + (b − b̄)·∂v ⟩_w

for E_loc = a + ib and log ψ = u + iv carried as [..., 2] pairs, taken
by autograd through the surrogate 2 Σ_n w_n (c_n · log ψ_n).
``grad_batch`` accumulates the backward over row chunks, so the saved
activations scale with the chunk and not with B.

Under a ``mesh`` (``parallel/``) each rank holds its rows, with weights
normalized over all ranks: the weighted mean is all-reduced before the
centring (one collective), and the gradients and the variance are
summed over the ranks in one more, so every rank gets the global
values.

Each row chunk's forward and loss are the ``torch.profiler`` range
``grad.forward``, its backward and accumulation ``grad.backward``.  A
range's device span covers only the work launched in it on its own
thread and not in a nested range: ``grad.backward`` spans the autograd
thread's kernels from the seed of ``torch.autograd.grad`` to the
accumulation, and the variance, computed after the chunks, ends the
caller's range (``vmc.grad``) on work of its own.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from pynqs_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["energy_and_grad", "energy_stats"]


def _centered(weights, eloc, mesh=None):
    """(weights, alive, e_mean, cen) with e_mean global."""
    weights = weights.detach()
    eloc = eloc.detach().to(weights.dtype)
    alive = weights > 0
    # dead rows may hold inf/NaN eloc: select them out first
    eloc = torch.where(alive[:, None], eloc, torch.zeros_like(eloc))
    e_mean = all_reduce_sum(mesh, weights @ eloc)
    cen = torch.where(alive[:, None], eloc - e_mean, torch.zeros_like(eloc))
    return weights, alive, e_mean, cen


def _variance(weights, cen):
    """This rank's share of the variance (the whole of it without a mesh)."""
    return (weights * (cen**2).sum(-1)).sum()


def energy_stats(weights, eloc, mesh=None):
    """(e_mean [2], variance) of ``energy_and_grad`` without its backward."""
    weights, _, e_mean, cen = _centered(weights, eloc, mesh)
    return e_mean, all_reduce_sum(mesh, _variance(weights, cen))


def energy_and_grad(model, bits, weights, eloc, *, grad_batch=None, mesh=None):
    """Returns (e_mean [2], grads {name: tensor}, variance).

    bits [B, sorb]; weights [B] (sum 1 over all ranks; 0 = dead row);
    eloc [B, 2]; under a mesh the rank's rows, and the results global."""
    weights, alive, e_mean, cen = _centered(weights, eloc, mesh)

    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
    grads = [torch.zeros_like(p) for p in params]
    B = bits.shape[0]
    step = B if grad_batch is None or grad_batch >= B else grad_batch
    for s in range(0, B, step):
        e = min(s + step, B)
        with record_function("grad.forward"):
            lp = model.log_psi(bits[s:e])
            lp = torch.where(alive[s:e, None], lp, torch.zeros_like(lp))
            loss = 2.0 * (weights[s:e] * (cen[s:e] * lp).sum(-1)).sum()
        with record_function("grad.backward"):
            for acc, g in zip(grads, torch.autograd.grad(loss, params, allow_unused=True)):
                if g is not None:
                    acc += g
    var = _variance(weights, cen)
    if mesh is not None:
        flat = all_reduce_sum(mesh, torch.cat([g.reshape(-1) for g in grads]
                                              + [var.reshape(1).to(grads[0].dtype)]))
        var = flat[-1].to(var.dtype)
        grads = list(torch.split(flat[:-1], [g.numel() for g in grads]))
        grads = [g.reshape(p.shape).to(p.dtype) for g, p in zip(grads, params)]
    return e_mean, dict(zip(names, grads)), var
