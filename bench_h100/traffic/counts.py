"""View counts of a batch and the packed row indices.

Frozen copies of ``viewfusion_tpu_torch/training/trainer.py``'s
``stratified_count_multiset`` and ``packed_indices`` (repo commit
f80e7a7), the rule the reference's packed training path uses: each of
1..max_views floor(b / max_views) times, the remainder filled by
end-paired values, so that sum(counts) is the same every batch.
"""

from __future__ import annotations

import numpy as np


def stratified_count_multiset(b: int, max_views: int) -> np.ndarray:
    counts = np.resize(np.arange(1, max_views + 1), b)
    r = b % max_views
    if r:
        lo, hi = 1, max_views
        tail = []
        while len(tail) < r:
            if r - len(tail) == 1:
                tail.append((max_views + 2) // 2)
                break
            tail.append(lo)
            tail.append(hi)
            lo, hi = lo + 1, hi - 1
        counts[-r:] = tail
    return counts


def packed_indices(view_count: np.ndarray):
    """The valid (sample, view) pairs, (R,) int32 each."""
    sample_idx = np.repeat(np.arange(len(view_count)), view_count)
    view_idx = np.concatenate([np.arange(v) for v in view_count])
    return sample_idx.astype(np.int32), view_idx.astype(np.int32)
