"""Offset-value codes over normalized-key lanes.

Counterpart of paimon_tpu/ops/ovc.py (Graefe et al., "Robust and
Efficient Sorting with Offset-Value Coding", arXiv 2209.08420).  Two
uses:

* the per-run codes the device winner-select consumes: for each row,
  the offset of its first lane difference from its run predecessor.  A
  sorted-adjacent pair that is also run-consecutive resolves key
  equality from this one integer; the kernel lane-compares only the
  other pairs (ops/kernels.eq_next_mask);
* the host OVC route of ops/merge.device_sorted_winners: the C library
  (native/radix_sort.c) codes each sorted run in one pass, verifying
  its (key, seq) order, and merges the k runs with single-integer
  compares, so key equality of output neighbours falls out of the
  merge.

Code layout for an L-lane u32 key row r relative to base row z:
    offset = first lane where r differs from z   (L = all equal)
    code   = (L - offset) << 32 | r[offset]      (0 when equal)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["ovc_enabled", "ovc_sorted_winners", "run_ovc_offsets",
           "OVC_OFF_SENTINEL", "OVC_PATH_ROWS"]

# rows merged through the host OVC route this process
OVC_PATH_ROWS = {"rows": 0, "merges": 0}


def ovc_enabled() -> bool:
    """The host OVC route is on unless PAIMON_DISABLE_OVC=1."""
    return os.environ.get("PAIMON_DISABLE_OVC") != "1"

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


def ovc_sorted_winners(lanes, seq: np.ndarray, keep: str,
                       run_starts: np.ndarray, num_key_lanes: int,
                       packed: Optional[np.ndarray] = None
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """(perm, winner, prev) — the contract of the unpadded host routes
    of ops/merge.device_sorted_winners — via the C OVC merge, or None
    when ineligible (library unavailable, empty input, or a run that is
    not (key, seq)-sorted; the caller takes the sort routes)."""
    from paimon_tpu_torch import native

    n = len(seq)
    if n == 0 or not ovc_enabled() or not native.predicted_available():
        return None
    if packed is not None and num_key_lanes == 2:
        res = native.ovc_merge_u64(packed, seq, run_starts)
        num_lanes = 2
    else:
        mat = np.asarray(lanes)
        if mat.shape[1] == 0:
            return None
        res = native.ovc_merge_lanes(mat, seq, run_starts)
        num_lanes = mat.shape[1]
    if res is None:
        return None
    perm, out_codes = res
    OVC_PATH_ROWS["rows"] += n
    OVC_PATH_ROWS["merges"] += 1
    # output code i is relative to output row i-1: neighbours share a
    # key iff the first difference sits past the key lanes
    eq = (out_codes[1:] >> np.uint64(32)) \
        <= np.uint64(num_lanes - num_key_lanes)
    from paimon_tpu_torch.ops.merge import _winner_epilogue
    return _winner_epilogue(perm, eq, keep)
