"""Skew-aware bucket -> lane packing for the mesh engine.

Counterpart of paimon_tpu/parallel/packing.py.  Buckets pack onto a
fixed number of mesh lanes with a greedy longest-processing-time
bin-packer keyed on per-bucket row counts from manifest statistics (no
file reads): a hot bucket occupies one lane alone while the cold ones
share the rest, so per-step window padding is bounded by the window
budget, not by the hot bucket.  LPT's makespan is within 4/3 of the
optimum.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["pack_buckets", "packing_skew", "bucket_row_counts"]


def bucket_row_counts(splits) -> List[int]:
    """Per-split input row counts from manifest stats (DataFileMeta
    row_count sums), available before any file IO."""
    return [sum(f.row_count for f in s.data_files) for s in splits]


def pack_buckets(row_counts: Sequence[int],
                 num_lanes: int) -> List[List[int]]:
    """Greedy LPT: each bucket, by descending row count, goes to the
    least-loaded lane.  Returns `num_lanes` lists of bucket indices (a
    lane may be empty).  Deterministic: ties break on the lower bucket
    index and the lower lane index."""
    if num_lanes < 1:
        raise ValueError(f"num_lanes must be >= 1, got {num_lanes}")
    lanes: List[List[int]] = [[] for _ in range(num_lanes)]
    loads = [0] * num_lanes
    order = sorted(range(len(row_counts)),
                   key=lambda i: (-int(row_counts[i]), i))
    for i in order:
        target = min(range(num_lanes), key=lambda j: (loads[j], j))
        lanes[target].append(i)
        loads[target] += int(row_counts[i])
    return lanes


def packing_skew(row_counts: Sequence[int],
                 lanes: Sequence[Sequence[int]]) -> float:
    """max lane load / mean load of the lanes in use (1.0 = balanced);
    empty lanes (fewer buckets than lanes) are idle by construction and
    left out of the mean."""
    loads = [sum(int(row_counts[i]) for i in lane) for lane in lanes]
    total = sum(loads)
    if total == 0:
        return 1.0
    used = [ld for ld in loads if ld > 0]
    return max(loads) / (total / len(used))
