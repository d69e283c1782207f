"""AR sampler of the VMC loop.

Counterpart of ``pynqs_tpu/sampler/ar_sampler.py`` without a mesh: the
plain fixed-capacity tree, independent slabs (``n_slab``), the
prefix-partitioned (DFS) tree, the adaptive sample count
(``target_unique``) and the ``max_unique`` compaction, with the
truncation diagnostics.  Weights
are the multinomial counts normalized over the unique rows, or with
``exact_weights`` the exact |ψ|² renormalized over them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pynqs_tpu_torch.sampler.ar import (
    ar_sampling,
    ar_sampling_dfs,
    ar_sampling_slabbed,
    compact_by_count,
)

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

    def _sample_adaptive(self, model, generator):
        max_n = self.max_n_sample or 1000 * self.n_sample
        n = self.n_sample
        bits, counts, _ = ar_sampling(model, n, capacity=self.capacity, generator=generator)
        while int((counts > 0).sum()) < self.target_unique and n * 10 <= max_n:
            n *= 10
            bits, counts, _ = ar_sampling(model, n, capacity=self.capacity,
                                          generator=generator)
        return bits, counts

    @torch.no_grad()
    def sample(self, model, generator: torch.Generator):
        """Returns (bits [R, sorb] int8, weights [R] (sum 1; 0 = dead row),
        diagnostics {"dropped_frac", "n_unique"} as 0-d tensors)."""
        n_sample = self.n_sample
        if self.target_unique is not None and self.n_slab == 1:
            bits, counts = self._sample_adaptive(model, generator)
            n_sample = max(int(counts.sum()), 1)
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
        if self.max_unique is not None and self.max_unique < bits.shape[0]:
            bits, counts = compact_by_count(bits, counts, self.max_unique)
        # truncation diagnostic: a truncated sampling measure biases the
        # energy, so the dropped mass (compaction included) is reported
        total = counts.sum()
        live = counts > 0
        diag = {
            "dropped_frac": 1.0 - total.double() / n_sample,
            "n_unique": live.sum(),
        }
        if self.exact_weights:
            logw = torch.full(counts.shape, -torch.inf, dtype=model.M_re.dtype,
                              device=counts.device)
            logw[live] = 2.0 * model.log_psi(bits[live])[:, 0]
            p = torch.exp(logw - logw.max())
            w = p / p.sum()
        else:
            w = counts.to(model.M_re.dtype) / torch.clamp(total, min=1)
        return bits, w, diag
