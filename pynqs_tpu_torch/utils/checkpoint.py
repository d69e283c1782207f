"""Checkpoints and parameter trees, in the JAX package's file format.

Counterpart of ``pynqs_tpu/utils/checkpoint.py``.  A file is a pickled
tree with numpy leaves: ``save_params`` writes a parameter dict (the
key names of ``GraphMPSRNN``), ``save_checkpoint`` a resume file
``{"step", "params", "opt_state", "history"[, "ema"]}``.  Files written
by either package load in the other:

  * reading never imports optax (hence JAX): ``_SafeUnpickler`` allows
    the numpy globals such files hold and maps exactly the three optax
    state classes of an Adam/AdamW run to namedtuples of this module;
    any other class raises.  Unpickling runs no other code.
  * the optimizer state is optax's (Adam/AdamW, and momentum-free SGD,
    whose state holds only the schedule count: ``sgd_schedule_count``,
    ``optax_sgd_tree``): ``adam_state_from_tree`` finds the
    Adam moments and the schedule count in such a tree (by class name,
    else by optax's leaf order), ``optax_adam_tree`` writes them back as
    plain tuples and dicts in optax's leaf order, which the JAX
    package's resume rebuilds against its own optimizer
    (``pynqs_tpu/optim/vmc.py``, by leaf order).
"""

from __future__ import annotations

import importlib
import os
import pickle
from collections import namedtuple

import numpy as np
import torch

from pynqs_tpu_torch.utils.device import resolve_device

__all__ = [
    "load_params",
    "params_from_numpy",
    "save_params",
    "save_checkpoint",
    "load_checkpoint",
    "adam_state_from_tree",
    "optax_adam_tree",
    "load_adam_state",
    "adam_state_tree",
    "sgd_schedule_count",
    "optax_sgd_tree",
]

# optax's Adam/AdamW states, by the names their files pickle
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
ScaleByScheduleState = namedtuple("ScaleByScheduleState", ["count"])
EmptyState = namedtuple("EmptyState", [])

_OPTAX = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
    ("optax._src.base", "EmptyState"): EmptyState,
}


def _numpy_globals() -> dict:
    """The globals numpy's own array pickles name; the multiarray module
    moved between numpy 1 (``numpy.core``) and 2 (``numpy._core``), and a
    file may name either."""
    try:
        ma = importlib.import_module("numpy._core.multiarray")
    except ImportError:
        ma = importlib.import_module("numpy.core.multiarray")
    out = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for name in ("numpy.core.multiarray", "numpy._core.multiarray"):
        out[(name, "_reconstruct")] = ma._reconstruct
        out[(name, "scalar")] = ma.scalar
    return out


_ALLOWED = {**_numpy_globals(), **_OPTAX}


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return _ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a checkpoint (only numpy arrays and "
                f"optax's Adam, schedule and empty states)") from None


def _path(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".pkl") else path + ".pkl"


def _load(path: str):
    with open(_path(path), "rb") as f:
        return _SafeUnpickler(f).load()


def _dump(path: str, tree) -> None:
    with open(_path(path), "wb") as f:
        pickle.dump(tree, f)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_to_numpy(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def load_params(path: str) -> dict:
    """Read a pickled parameter tree written by either package, keeping
    its nesting (a structured run's file holds ``{"params": {...}}``),
    with numpy leaves all the way down."""
    return _to_numpy(_load(path))


def save_params(path: str, params: dict) -> None:
    """Write a parameter dict (tensors or arrays) as numpy leaves."""
    _dump(path, _to_numpy(params))


def params_from_numpy(tree: dict, device="cuda", dtype=torch.float32) -> dict:
    """numpy tree -> dict of tensors on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.asarray(v), device=dev).to(dtype)
        for k, v in tree.items()
    }


def save_checkpoint(path: str, step: int, params, opt_state, history,
                    extra: dict | None = None) -> None:
    """The JAX package's resume file: ``step`` (the loop iteration that
    wrote it), the parameters, the optimizer state tree, the energy
    history and ``extra`` entries (e.g. ``{"ema": tree}``)."""
    tree = {
        "step": step,
        "params": _to_numpy(params),
        "opt_state": _to_numpy(opt_state),
        "history": [float(e) for e in history],
    }
    if extra:
        tree.update({k: _to_numpy(v) for k, v in extra.items()})
    _dump(path, tree)


def load_checkpoint(path: str) -> dict:
    """A resume file of either package, numpy leaves; optax states come
    back as this module's namedtuples of the same names."""
    return _load(path)


# ---------------- the optimizer state ----------------


def _find(tree, cls):
    """The nodes of ``tree`` that are ``cls`` instances, depth first."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _find(tree[k], cls)]
    if isinstance(tree, (list, tuple)):
        return [n for v in tree for n in _find(v, cls)]
    return []


def _leaves(tree):
    """Leaves in JAX's order: dicts by sorted key, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def adam_state_from_tree(opt_state, names) -> tuple:
    """(count, mu, nu, schedule count or None) of an optax Adam/AdamW
    state tree, ``mu``/``nu`` dicts over ``names``.  The states are found
    by class name where the file kept the classes (a JAX file may wrap
    them, e.g. an outer ``EmptyState``), otherwise by optax's leaf order:
    count, the mu leaves, the nu leaves, then the schedule count."""
    names = sorted(names)
    adam = _find(opt_state, ScaleByAdamState)
    if adam:
        if len(adam) != 1:
            raise ValueError(f"{len(adam)} Adam states in one optimizer state")
        a = adam[0]
        sched = _find(opt_state, ScaleByScheduleState)
        if set(a.mu) != set(names):
            raise KeyError(f"optimizer state keys differ: {sorted(set(a.mu) ^ set(names))}")
        return (int(a.count), dict(a.mu), dict(a.nu),
                int(sched[0].count) if sched else None)
    leaves = _leaves(opt_state)
    P = len(names)
    if len(leaves) not in (1 + 2 * P, 2 + 2 * P):
        raise ValueError(f"optimizer state has {len(leaves)} leaves; an Adam state over "
                         f"{P} parameters has {1 + 2 * P} (+1 with a schedule)")
    return (int(leaves[0]), dict(zip(names, leaves[1:1 + P])),
            dict(zip(names, leaves[1 + P:1 + 2 * P])),
            int(leaves[-1]) if len(leaves) == 2 + 2 * P else None)


def optax_adam_tree(count: int, mu: dict, nu: dict, sched_count: int | None, *,
                    decay: bool) -> tuple:
    """The state tree of ``optax.adam``/``optax.adamw`` (``decay``) with a
    float lr (``sched_count`` None) or a schedule, as plain tuples and
    dicts in optax's leaf order; counts int32 like optax's."""
    adam = (np.asarray(count, np.int32), dict(mu), dict(nu))
    lr = () if sched_count is None else (np.asarray(sched_count, np.int32),)
    return (adam, (), lr) if decay else (adam, lr)


def load_adam_state(opt: torch.optim.Optimizer, named_params: dict, opt_state) -> int:
    """Set a torch Adam/AdamW's state from an optax state tree:
    exp_avg = mu, exp_avg_sq = nu, step = count (optax increments its
    count before the bias correction, torch its step: the two agree with
    step = count).  Returns the schedule count (the Adam count where the
    tree has no schedule)."""
    count, mu, nu, sched = adam_state_from_tree(opt_state, named_params)
    opt.state.clear()
    for name, p in named_params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.asarray(mu[name])).reshape(p.shape).to(p).clone(),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu[name])).reshape(p.shape).to(p).clone(),
        }
    return count if sched is None else sched


def adam_state_tree(opt: torch.optim.Optimizer, named_params: dict,
                    sched_count: int | None, *, decay: bool) -> tuple:
    """The optax state tree of a torch Adam/AdamW (inverse of
    ``load_adam_state``); parameters not stepped yet hold zeros."""
    mu, nu, count = {}, {}, 0
    for name, p in named_params.items():
        st = opt.state.get(p, {})
        if st:
            count = int(st["step"])
        mu[name] = (st["exp_avg"] if st else torch.zeros_like(p)).detach().cpu().numpy()
        nu[name] = (st["exp_avg_sq"] if st else torch.zeros_like(p)).detach().cpu().numpy()
    return optax_adam_tree(count, mu, nu, sched_count, decay=decay)


def sgd_schedule_count(opt_state) -> int:
    """The schedule count of a momentum-free ``optax.sgd`` state tree:
    ``(EmptyState(), ScaleByScheduleState(count))`` with a schedule,
    ``(EmptyState(), EmptyState())`` with a float rate (count 0).  SGD
    keeps no moments; an Adam state raises."""
    if _find(opt_state, ScaleByAdamState):
        raise ValueError("the optimizer state is Adam's, not momentum-free SGD's")
    sched = _find(opt_state, ScaleByScheduleState)
    if sched:
        return int(sched[0].count)
    leaves = _leaves(opt_state)
    if len(leaves) > 1:
        raise ValueError(f"optimizer state has {len(leaves)} leaves; a momentum-free SGD "
                         f"state has at most 1 (the schedule count)")
    return int(leaves[0]) if leaves else 0


def optax_sgd_tree(sched_count: int | None) -> tuple:
    """The state tree of momentum-free ``optax.sgd`` with a float lr
    (``sched_count`` None) or a schedule, in optax's leaf order."""
    return ((), () if sched_count is None else (np.asarray(sched_count, np.int32),))
