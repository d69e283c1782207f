"""Ansatz interface of the port.

Counterpart of ``pynqs_tpu/models/base.py``.  Every wave-function model
is an ``nn.Module`` holding its parameters:

  * ``log_psi(bits) -> [..., 2]`` for ``bits [..., sorb]`` occupation
    vectors: the REAL pair (log|ψ|, arg ψ) (see ``ops/cplx.py``);
    amplitude-only models return phase 0.  ``forward`` is ``log_psi``, so
    ``torch.func.functional_call`` (SR) takes the model whole.
  * ``load_numpy_params(tree)``: the JAX model's parameter tree exactly as
    its ``init`` lays it out (nested dicts; the decoder's ``"blocks"``
    list), numpy leaves.

Autoregressive models also implement the exact-sampling contract of
``sampler/ar.py``, the JAX contract without ``params``:

  * ``sorb``, ``noa``, ``nob`` and ``sites_per_step`` (1: spin orbital k
    per step, 2 categories; 2: one spatial orbital per step, values
    v = a + 2b, 4 categories), optionally ``site_order`` (the spatial
    orbital of each 2-site step; identity when absent);
  * ``ar_init(capacity) -> carry`` and
    ``ar_step(carry, k, prev) -> (logp [C, ncat], carry)``: the unmasked
    conditional log-probabilities of step k given the values ``prev`` [C]
    chosen at step k−1 (0 at k = 0), up to a constant per row (the
    sampler masks and renormalizes them; the decoder's "norm" methods
    leave them unnormalized, as in JAX).  The carry is a tensor or a
    (nested) dict of tensors with leading axis C; the sampler gathers it
    row-wise on branching.  Run under ``torch.no_grad``: a model may
    update its carry in place.

Parameters are named by their path in the JAX tree
(``blocks.0.qkv.w`` ↔ ``tree["blocks"][0]["qkv"]["w"]``): ``TreeModel``
registers a tree as nested modules, and ``utils/tree.py`` converts
between the two (``tree_named_parameters``, ``flatten_tree``,
``unflatten_tree``) for ``load_numpy_params`` and the checkpoints.  A wrapper that shares its base's
tree (``SpinProjected``) names that child in ``tree_transparent``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch
from torch import nn

from pynqs_tpu_torch.utils.tree import flatten_tree, tree_named_parameters

__all__ = ["Ansatz", "ARAnsatz", "TreeModel", "load_tree_params", "normal_init", "dense_tree",
           "dense"]


@runtime_checkable
class Ansatz(Protocol):
    sorb: int

    def log_psi(self, bits: torch.Tensor) -> torch.Tensor:  # pair [..., 2]
        ...

    def load_numpy_params(self, tree): ...


@runtime_checkable
class ARAnsatz(Ansatz, Protocol):
    noa: int
    nob: int
    sites_per_step: int

    def ar_init(self, capacity: int): ...

    def ar_step(self, carry, k: int, prev: torch.Tensor): ...


def load_tree_params(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (numpy leaves) into ``model``."""
    named = tree_named_parameters(model)
    flat = flatten_tree(tree)
    if set(flat) != set(named):
        raise KeyError(f"parameter keys differ: {sorted(set(flat) ^ set(named))}")
    with torch.no_grad():
        for k, v in flat.items():
            p = named[k]
            p.copy_(torch.as_tensor(np.array(v)).reshape(p.shape).to(p.dtype))
    return model


def normal_init(generator, dtype, device):
    """``nrm(shape, scale)``: scale × N(0, 1) drawn on the CPU from
    ``generator`` (so one seed gives the same draw for any device), then
    moved to ``device``."""

    def nrm(shape, scale=1.0):
        return scale * torch.randn(shape, generator=generator, dtype=dtype).to(device)

    return nrm


def dense_tree(nrm, n_in: int, n_out: int, scale=None) -> dict:
    """A dense layer's tree {"w": [n_in, n_out] ~ scale·N(0, 1), "b":
    zeros}, scale 1/√n_in by default (the JAX package's ``_dense_init``)."""
    w = nrm((n_in, n_out), 1.0 / np.sqrt(n_in) if scale is None else scale)
    return {"w": w, "b": torch.zeros(n_out, dtype=w.dtype, device=w.device)}


def dense(p, x):
    """x @ w + b of a registered dense tree ``p``."""
    return x @ p.w + p.b


def _register(module: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            module.add_module(k, child)
        elif isinstance(v, (list, tuple)):
            items = nn.ModuleList()
            for sub in v:
                child = nn.Module()
                _register(child, sub)
                items.append(child)
            module.add_module(k, items)
        else:
            module.register_parameter(k, nn.Parameter(v.contiguous()))


class TreeModel(nn.Module):
    """A model whose parameters are a JAX-layout tree of tensors."""

    def register_tree(self, tree: dict) -> None:
        """Register the tensors of ``tree`` as parameters named by path."""
        _register(self, tree)

    def load_numpy_params(self, tree):
        """Copy a JAX parameter tree (numpy leaves, same layout) in."""
        return load_tree_params(self, tree)

    def forward(self, bits):
        return self.log_psi(bits)
