"""AR sampler of the VMC loop.

Counterpart of ``pynqs_tpu/sampler/ar_sampler.py``: the plain
fixed-capacity tree, independent slabs (``n_slab``), the
prefix-partitioned (DFS) tree, the adaptive sample count
(``target_unique``), the ``max_unique`` compaction and, over a ``mesh``
(``parallel/``), the same tree split between the ranks or one tree per
rank with a global merge, with the truncation diagnostics.  Weights are
the multinomial counts normalized over the unique rows, or with
``exact_weights`` the exact |ψ|² renormalized over them; under a mesh
each rank returns its rows with weights normalized over all ranks, and
the diagnostics are global (the same on every rank).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from pynqs_tpu_torch.ops import lut, onv
from pynqs_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
    rank_generator,
)
from pynqs_tpu_torch.sampler.ar import (
    ar_sampling,
    ar_sampling_dfs,
    ar_sampling_sharded,
    ar_sampling_slabbed,
    compact_by_count,
)
from pynqs_tpu_torch.utils.device import model_device_dtype

__all__ = ["ARSampler"]


@dataclass(frozen=True)
class ARSampler:
    sorb: int
    noa: int
    nob: int
    n_sample: int = 1 << 12
    capacity: int = 1 << 10  # max unique determinants carried per tree
    # > 1: n_sample over n_slab independent capacity-C trees, duplicates
    # merged (exactly Multinomial-additive; effective capacity
    # n_slab × capacity); DFS takes precedence
    n_slab: int = 1
    # DFS prefix partitioning: > 1 expands the tree exactly to
    # dfs_split_depth at dfs_capacity_root rows, then finishes
    # dfs_n_group disjoint prefix groups at full capacity each
    dfs_n_group: int = 1
    dfs_split_depth: int | None = None
    dfs_capacity_root: int | None = None
    # keep only the n highest-count rows after sampling
    max_unique: int | None = None
    # adaptive n_sample: draw the plain tree again at 10x the count until
    # at least target_unique rows are alive or the next count would pass
    # max_n_sample (default 1000 n_sample); takes precedence over DFS,
    # and the dropped mass is then taken against the realized total
    target_unique: int | None = None
    max_n_sample: int | None = None
    # Rao-Blackwellized weights: the exact |ψ|² (model.log_psi, max
    # subtracted) renormalized over the rows with count > 0, in place of
    # the normalized counts
    exact_weights: bool = False
    # data parallelism (parallel.Mesh): "same_tree" splits one tree
    # between the ranks (ar_sampling_sharded, tree_height its phase-A
    # depth; with n_slab > 1 one such tree per slab); "independent" draws
    # n_sample/n on every rank's own tree and merges the duplicates
    # globally.  Takes precedence over DFS; target_unique needs no mesh
    mesh: object = None
    mesh_mode: str = "same_tree"
    tree_height: int | None = None

    @property
    def ar_part_measure(self) -> bool:
        """The weights are the drawn counts, which follow the |ψ|² of the
        model's AR part (``VMC.reweight``); exact weights evaluate the whole
        model's |ψ|²."""
        return not self.exact_weights

    def _sample_adaptive(self, model, generator):
        max_n = self.max_n_sample or 1000 * self.n_sample
        n = self.n_sample
        bits, counts, _ = ar_sampling(model, n, capacity=self.capacity, generator=generator)
        while int((counts > 0).sum()) < self.target_unique and n * 10 <= max_n:
            n *= 10
            bits, counts, _ = ar_sampling(model, n, capacity=self.capacity,
                                          generator=generator)
        return bits, counts

    def _sample_rank_independent(self, model, generator):
        """Every rank samples its own tree (``rank_generator``, salt 31) with
        n_sample/n draws; the packed rows and counts are all-gathered, every
        rank merges the duplicates of the whole set alike
        (``ops.lut.unique_onv``, sorted by key, the dead rows last) and keeps
        the rows rank, rank + n, ... of the merged buffer."""
        mesh = self.mesh
        bits, counts, _ = ar_sampling(model, self.n_sample // mesh.size,
                                      capacity=self.capacity,
                                      generator=rank_generator(mesh, generator, 31))
        uniq, counts, _ = lut.unique_onv(all_gather_rows(mesh, onv.pack_bits(bits)),
                                         all_gather_rows(mesh, counts))
        return onv.unpack_bits(uniq[mesh.rank::mesh.size], model.sorb), \
            counts[mesh.rank::mesh.size]

    def _sample_same_tree(self, model, generator):
        """``ar_sampling_sharded``, or with ``n_slab`` > 1 one sharded tree of
        n_sample/n_slab draws per slab, concatenated (duplicates across
        slabs stay separate rows; the counts add)."""
        n_slab = max(self.n_slab, 1)
        out = [ar_sampling_sharded(model, self.n_sample // n_slab, capacity=self.capacity,
                                   mesh=self.mesh, tree_height=self.tree_height,
                                   generator=generator)[:2]
               for _ in range(n_slab)]
        return torch.cat([b for b, _ in out], 0), torch.cat([c for _, c in out], 0)

    def _compact_global(self, bits, counts):
        """``compact_by_count`` over the rows of every rank: the max_unique
        highest counts of the gathered buffer, dealt to the ranks
        round-robin (rank r keeps the (r + kn)-th largest)."""
        mesh = self.mesh
        if self.max_unique % mesh.size:
            raise ValueError(f"max_unique {self.max_unique} must divide by the mesh size "
                             f"{mesh.size}")
        bits, counts = compact_by_count(all_gather_rows(mesh, bits),
                                        all_gather_rows(mesh, counts), self.max_unique)
        return bits[mesh.rank::mesh.size], counts[mesh.rank::mesh.size]

    @torch.no_grad()
    def sample(self, model, generator: torch.Generator):
        """Returns (bits [R, sorb] int8, weights [R] (sum 1 over all ranks;
        0 = dead row), diagnostics {"dropped_frac", "n_unique"} as 0-d
        tensors); under a mesh, this rank's rows.  The compaction and the
        diagnostics are the ``torch.profiler`` range ``ar.compact``; the
        weights come after it, outside any range of the sampler, so that
        the caller's range ends on work launched in it directly (a range's
        device span leaves out what a nested range launched)."""
        mesh = self.mesh
        if mesh is not None and self.mesh_mode not in ("same_tree", "independent"):
            raise ValueError(f"unknown mesh_mode {self.mesh_mode!r}")
        n_sample = self.n_sample
        if self.target_unique is not None and mesh is None and self.n_slab == 1:
            bits, counts = self._sample_adaptive(model, generator)
            n_sample = max(int(counts.sum()), 1)
        elif mesh is not None and self.mesh_mode == "independent":
            bits, counts = self._sample_rank_independent(model, generator)
        elif mesh is not None:
            bits, counts = self._sample_same_tree(model, generator)
        elif self.dfs_n_group > 1:
            bits, counts, _ = ar_sampling_dfs(
                model, self.n_sample, capacity=self.capacity,
                n_group=self.dfs_n_group, split_depth=self.dfs_split_depth,
                capacity_root=self.dfs_capacity_root, generator=generator,
            )
        elif self.n_slab > 1:
            bits, counts, _ = ar_sampling_slabbed(
                model, self.n_sample, capacity=self.capacity, n_slab=self.n_slab,
                generator=generator,
            )
        else:
            bits, counts, _ = ar_sampling(
                model, self.n_sample, capacity=self.capacity, generator=generator
            )
        with record_function("ar.compact"):
            n_rows = bits.shape[0] * (1 if mesh is None else mesh.size)
            if self.max_unique is not None and self.max_unique < n_rows:
                if mesh is None:
                    bits, counts = compact_by_count(bits, counts, self.max_unique)
                else:
                    bits, counts = self._compact_global(bits, counts)
            # truncation diagnostic: a truncated sampling measure biases the
            # energy, so the dropped mass (compaction included) is reported
            live = counts > 0
            total, n_live = all_reduce_sum(mesh, torch.stack([counts.sum(), live.sum()]))
            diag = {
                "dropped_frac": 1.0 - total.double() / n_sample,
                "n_unique": n_live,
            }
        if self.exact_weights:
            dt = model_device_dtype(model)[1]
            logw = torch.full(counts.shape, -torch.inf, dtype=dt, device=counts.device)
            logw[live] = 2.0 * model.log_psi(bits[live])[:, 0]
            p = torch.exp(logw - all_reduce_max(mesh, logw.max()))
            w = p / all_reduce_sum(mesh, p.sum())
        else:
            w = counts.to(model_device_dtype(model)[1]) / torch.clamp(total, min=1)
        return bits, w, diag
