"""The port's copy of the JAX package's parallel/multihost.py, in part:
``partition_shard_ranges``, the ownership map of partitioned serving
(infer/partition.py), which is pure arithmetic over the shard table.

The rest of that module (process info, barriers, the multi-host batch
slices) waits for a machine with several cards (ROADMAP.md queue 1,
item 6)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def partition_shard_ranges(counts: Sequence[int], parts: int
                           ) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) shard-index ranges splitting `counts` (rows per
    shard, in shard order) into at most `parts` partitions balanced by row
    count: partition p owns shards [lo_p, hi_p), its slice of the IVF
    posting lists and its cut of the hot posting set. Contiguity keeps a
    partition's id space an interval, so each host's shard files, posting
    files and append ranges stay disjoint on disk.

    Deterministic (pure arithmetic over the shard table): every worker
    derives the identical split from the same manifest. `parts` is
    clamped to the shard count; every returned range is non-empty."""
    n = len(counts)
    if n == 0:
        return [(0, 0)]
    P = max(1, min(int(parts), n))
    cum = np.cumsum(np.asarray(counts, np.int64))
    total = int(cum[-1])
    cuts: List[int] = []
    prev = 0
    for p in range(1, P):
        target = total * p / P
        j = int(np.searchsorted(cum, target))
        # cut on whichever side of the target is closer (ties take the
        # extra shard): cutting at j puts cum[j-1] rows left of the cut,
        # at j+1 puts cum[j]
        if j < n and abs(int(cum[j]) - target) <= \
                abs((int(cum[j - 1]) if j else 0) - target):
            j += 1
        # keep every partition non-empty: at least one shard on each side
        j = max(prev + 1, min(j, n - (P - p)))
        cuts.append(j)
        prev = j
    bounds = [0] + cuts + [n]
    return list(zip(bounds[:-1], bounds[1:]))
