"""AR sampler of the VMC loop.

Counterpart of ``pynqs_tpu/sampler/ar_sampler.py`` without a mesh: the
plain fixed-capacity tree, the prefix-partitioned (DFS) tree and the
``max_unique`` compaction, with the truncation diagnostics.  Weights
are the multinomial counts normalized over the unique rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pynqs_tpu_torch.sampler.ar import ar_sampling, ar_sampling_dfs, compact_by_count

__all__ = ["ARSampler"]


@dataclass(frozen=True)
class ARSampler:
    sorb: int
    noa: int
    nob: int
    n_sample: int = 1 << 12
    capacity: int = 1 << 10  # max unique determinants carried per tree
    # DFS prefix partitioning: > 1 expands the tree exactly to
    # dfs_split_depth at dfs_capacity_root rows, then finishes
    # dfs_n_group disjoint prefix groups at full capacity each
    dfs_n_group: int = 1
    dfs_split_depth: int | None = None
    dfs_capacity_root: int | None = None
    # keep only the n highest-count rows after sampling
    max_unique: int | None = None

    @torch.no_grad()
    def sample(self, model, generator: torch.Generator):
        """Returns (bits [R, sorb] int8, weights [R] (sum 1; 0 = dead row),
        diagnostics {"dropped_frac", "n_unique"} as 0-d tensors)."""
        if self.dfs_n_group > 1:
            bits, counts, _ = ar_sampling_dfs(
                model, self.n_sample, capacity=self.capacity,
                n_group=self.dfs_n_group, split_depth=self.dfs_split_depth,
                capacity_root=self.dfs_capacity_root, generator=generator,
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
        diag = {
            "dropped_frac": 1.0 - total.double() / self.n_sample,
            "n_unique": (counts > 0).sum(),
        }
        w = counts.to(model.M_re.dtype) / torch.clamp(total, min=1)
        return bits, w, diag
