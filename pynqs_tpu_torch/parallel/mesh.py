"""Data parallelism over ``torch.distributed``.

Counterpart of ``pynqs_tpu/parallel/mesh.py``.  The JAX package runs one
SPMD program over a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; the port runs one process per rank, each holding its rows
of the batch, with explicit collectives at exactly the places where the
JAX program reduces over the batch.  Parameters are replicated: every
rank applies the same all-reduced gradient, so they stay equal bit for
bit.

The JAX names map as:
  make_mesh(n)                  -> make_mesh(n): a ``Mesh`` over the
                                   default process group
  jax.distributed / the devices -> init_mesh(backend, init_method, rank,
                                   world_size, device)
  shard_batch(mesh, x)          -> shard_batch(mesh, x): the rank's rows
  a psum / global mean in jit   -> all_reduce_sum, all_reduce_max
  resharding to the whole batch -> all_gather_rows (equal blocks)
  replicated(mesh)              -> replicated_check (parameters equal on
                                   every rank)
  jax.random over the batch     -> rand_rows: the global draw from the
                                   generator every rank shares, sliced
  fold_in(key, salt + rank)     -> rank_generator

Random draws: where the JAX program draws for the global batch, every
rank draws the same global tensor from the shared generator and keeps
its rows (``rand_rows``), so a run over n ranks equals one process on
the same rows up to the order of the sums.  Where the JAX package draws
per device, ``rank_generator`` derives a generator from one value drawn
from the shared generator and the rank; the shared generator then stays
identical on every rank.  ``generators_in_sync`` checks that it does.

Backends: NCCL with one card per rank; gloo for CPU ranks and for
several ranks on one card.  gloo takes CUDA tensors for all-reduce;
``all_gather_rows`` stages a CUDA tensor through the host under gloo
(the compute stays on the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "init_mesh", "shard_batch", "all_reduce_sum",
           "all_reduce_max", "all_gather_rows", "replicated_check", "rand_rows",
           "rank_generator", "generators_in_sync"]


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel mesh over the default
    process group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "dp"

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """The mesh over the initialized default process group (all its ranks;
    ``n_devices``, where given, must be their number).  ``device``: this
    rank's device, by default the card of the rank's local index."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized (init_mesh)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the process group has {size}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu'")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(rank, size, torch.device(device), dist.get_backend(), axis)


def init_mesh(backend: str, init_method: str, rank: int, world_size: int, device) -> Mesh:
    """``torch.distributed.init_process_group`` and the mesh over it.
    NCCL needs one card per rank; a CUDA ``device`` is made current."""
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("init_mesh: NCCL needs a CUDA device per rank")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return make_mesh(world_size, device=device)


def shard_batch(mesh: Mesh | None, x):
    """The rank's contiguous block of the rows of a global tensor (or of
    each tensor of a dict); the row count must divide by the mesh size."""
    if isinstance(x, dict):
        return {k: shard_batch(mesh, v) for k, v in x.items()}
    if mesh is None or mesh.size == 1:
        return x
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_batch: {n} rows do not split over {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def _reduce(mesh, t, op):
    t = torch.as_tensor(t).clone()
    if mesh is not None:
        dist.all_reduce(t, op=op)
    return t


def all_reduce_sum(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``t`` (a new tensor; without a mesh a copy of
    ``t``).  Over one rank the collective still runs, and is exact."""
    return _reduce(mesh, t, dist.ReduceOp.SUM)


def all_reduce_max(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """max over the ranks of ``t``, elementwise."""
    return _reduce(mesh, t, dist.ReduceOp.MAX)


def all_gather_rows(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """The ranks' equal blocks of rows, concatenated in rank order.  Under
    gloo a CUDA tensor goes through the host (gloo's all-gather takes
    CPU tensors)."""
    if mesh is None:
        return x
    src = x.contiguous()
    if mesh.backend == "gloo" and src.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.cat(parts, 0).to(x.device)


def replicated_check(mesh: Mesh | None, tensors: dict) -> float:
    """max |Δ| of the dict ``tensors`` between this rank and every other:
    0.0 while they are replicated.  Every rank gets the same value."""
    if mesh is None or mesh.size == 1:
        return 0.0
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors.values()])
    rows = all_gather_rows(mesh, flat[None])
    return float((rows - rows[:1]).abs().max())


def rand_rows(mesh: Mesh | None, n_local: int, *shape, generator: torch.Generator,
              dtype=None, device=None) -> torch.Tensor:
    """U[0, 1) draws for this rank's ``n_local`` rows: the global tensor
    [n_local · size, *shape] drawn from the shared ``generator`` (the same
    on every rank, which all hold ``n_local`` rows), this rank's block of
    it.  Without a mesh, the plain draw [n_local, *shape]."""
    size = 1 if mesh is None else mesh.size
    u = torch.rand(n_local * size, *shape, generator=generator, dtype=dtype, device=device)
    return u if size == 1 else u[mesh.rank * n_local:(mesh.rank + 1) * n_local]


_GOLDEN = 0x9E3779B97F4A7C15  # odd 64-bit mixing constant


def rank_generator(mesh: Mesh | None, generator: torch.Generator, salt: int) -> torch.Generator:
    """A generator of this rank's own stream (the JAX package's
    ``fold_in(key, salt + rank)``): seeded from one value drawn from the
    shared ``generator`` (the same draw on every rank) mixed with
    ``salt + rank``.  The streams are not JAX's.  Without a mesh or over
    one rank, the shared generator itself: one rank's stream is then the
    run's, and a one-rank run draws what a run without a mesh draws."""
    if mesh is None or mesh.size == 1:
        return generator
    dev = generator.device
    base = int(torch.randint(0, 2**62, (), generator=generator, device=dev))
    return torch.Generator(device=dev).manual_seed((base + (salt + mesh.rank) * _GOLDEN) % 2**63)


def generators_in_sync(mesh: Mesh | None, generator: torch.Generator) -> bool:
    """Whether the shared ``generator`` is in the same state on every rank:
    one draw of a copy of it (the generator itself does not move),
    all-gathered and compared."""
    if mesh is None or mesh.size == 1:
        return True
    copy = torch.Generator(device=generator.device)
    copy.set_state(generator.get_state())
    u = torch.rand(1, 1, generator=copy, dtype=torch.float64, device=generator.device)
    return bool((all_gather_rows(mesh, u) == u).all())
