"""Offset-value codes over normalized-key lanes.

Counterpart of paimon_tpu/ops/ovc.py, reduced to the per-run codes the
device winner-select consumes (Graefe et al., "Robust and Efficient
Sorting with Offset-Value Coding", arXiv 2209.08420): for each row, the
offset of its first lane difference from its run predecessor.  A
sorted-adjacent pair that is also run-consecutive resolves key equality
from this one integer; the kernel lane-compares only the other pairs
(ops/kernels.eq_next_mask).
"""

from __future__ import annotations

import numpy as np

__all__ = ["run_ovc_offsets", "OVC_OFF_SENTINEL"]

# run-start rows carry no usable code (their predecessor is the -inf
# sentinel, not a real row): the winner-select must fall through to
# full lane compares exactly there
OVC_OFF_SENTINEL = np.uint32(0xFFFFFFFF)


def run_ovc_offsets(lanes, run_starts: np.ndarray) -> np.ndarray:
    """uint32[n] per-row OVC OFFSETS vs the run predecessor: the first
    lane index where the row differs (num_lanes = all lanes equal),
    OVC_OFF_SENTINEL at run starts.  This is the single-int code the
    device winner-select consumes: a sorted-adjacent pair that is also
    run-consecutive resolves key-(in)equality from the offset alone —
    offset >= num_key_lanes means same key — and only the remaining
    pairs fall through to the full lane-compare chain
    (ops/kernels.eq_next_mask)."""
    mat = np.asarray(lanes)
    n, num_lanes = mat.shape
    out = np.full(n, np.uint32(num_lanes), dtype=np.uint32)
    if n:
        diff = mat[1:] != mat[:-1]
        any_diff = diff.any(axis=1)
        off = np.argmax(diff, axis=1).astype(np.uint32)
        out[1:] = np.where(any_diff, off, np.uint32(num_lanes))
        starts = np.asarray(run_starts)[:-1]
        out[starts[starts < n]] = OVC_OFF_SENTINEL
    return out
