"""Process-shared delta-apply plan cache (the incremental metadata
plane's state holder).

Counterpart of paimon_tpu/core/plan_cache.py.  The merged live-entry set
of snapshot N is kept in memory, grouped by (partition, bucket), and a
plan for snapshot N+k advances it by reading only the delta manifest
lists of snapshots N+1..N+k, so a steady-state streaming re-plan
touches O(delta) metadata (Fast Updates on Read-Optimized Databases,
arxiv 1109.6885).  A second level caches the generated splits per
filter signature, so untouched groups do not re-run split generation,
and the deletion-vector index of the tip is memoised per index manifest.

Correctness contract (core/scan.py's advance logic):

* OVERWRITE commits (INSERT OVERWRITE, dropped partitions, bucket
  rescale) invalidate the state instead of delta-applying;
* a missing snapshot in the walk (expired), a DELETE entry whose file
  is not live, or a cached tip whose manifest-list names no longer
  match the presented snapshot (rollback_to / fast_forward recreated
  the id) all invalidate;
* states are immutable after publish: advancing copies the outer group
  dict and only the touched groups' entry dicts, so concurrent planners
  never observe a torn state.

The cache is advisory: every invalidation falls back to the cold walk,
and `scan.plan.cache.max-entries` bounds the table it will hold (plus
a process-wide LRU over tables).  `reset_plan_caches` is for tests.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

__all__ = ["PlanState", "SplitState", "TablePlanCache",
           "shared_plan_cache", "reset_plan_caches"]

# (partition_bytes, bucket) group key
GroupKey = Tuple[bytes, int]

_MAX_TABLES = 16          # process-wide LRU over per-table caches
_MAX_SPLIT_SIGS = 8       # per-table LRU over filter signatures


class PlanState:
    """Immutable-after-publish live-entry set at one snapshot."""

    __slots__ = ("snapshot_id", "base_list", "delta_list",
                 "index_manifest", "groups", "entry_count")

    def __init__(self, snapshot_id: int, base_list: str, delta_list: str,
                 index_manifest: Optional[str],
                 groups: Dict[GroupKey, Dict[tuple, object]],
                 entry_count: int):
        self.snapshot_id = snapshot_id
        self.base_list = base_list
        self.delta_list = delta_list
        self.index_manifest = index_manifest
        self.groups = groups
        self.entry_count = entry_count

    def matches_tip(self, snapshot) -> bool:
        """Guards recreated snapshot ids (rollback_to / fast_forward
        can delete and REWRITE an id with different content)."""
        return (snapshot.base_manifest_list == self.base_list
                and snapshot.delta_manifest_list == self.delta_list)


class SplitState:
    """Generated splits per group for ONE filter signature, valid at
    one (snapshot, index_manifest) point."""

    __slots__ = ("snapshot_id", "index_manifest", "group_splits")

    def __init__(self, snapshot_id: int, index_manifest: Optional[str],
                 group_splits: Dict[GroupKey, tuple]):
        self.snapshot_id = snapshot_id
        self.index_manifest = index_manifest
        self.group_splits = group_splits


class TablePlanCache:
    """One table+branch's plan state; all access under `lock`."""

    def __init__(self):
        self.lock = threading.Lock()
        self._state: Optional[PlanState] = None
        self._splits: "OrderedDict[tuple, SplitState]" = OrderedDict()
        # the memoised unfiltered deletion-vector index, keyed by index
        # manifest name (a None name is {} without any IO)
        self._dv_key: Optional[str] = None
        self._dv_index: Optional[dict] = None
        # tip snapshot known to exceed scan.plan.cache.max-entries:
        # planners skip the cold-state attempt (whose full walk they
        # would discard) and go straight to the pruned fallback
        self._over_bound_id: Optional[int] = None

    # -- entry state ---------------------------------------------------------

    def state(self) -> Optional[PlanState]:
        with self.lock:
            return self._state

    def put_state(self, new: PlanState,
                  expect: Optional[PlanState]) -> None:
        """Publish `new` unless a concurrent planner advanced past it
        (never regress the cached snapshot)."""
        with self.lock:
            cur = self._state
            if cur is None or cur is expect or \
                    cur.snapshot_id < new.snapshot_id:
                self._state = new

    def drop_state(self, expect: Optional[PlanState]) -> None:
        """Invalidate (only the observed state: a fresher concurrent
        publish survives).  Split states die with it — they were
        derived from the same walk."""
        with self.lock:
            if expect is None or self._state is expect:
                self._state = None
                self._splits.clear()
                self._dv_key = None
                self._dv_index = None

    def over_bound(self, snapshot_id: int) -> bool:
        with self.lock:
            return self._over_bound_id == snapshot_id

    def mark_over_bound(self, snapshot_id: int) -> None:
        with self.lock:
            self._over_bound_id = snapshot_id

    # -- split states --------------------------------------------------------

    def split_state(self, sig: tuple) -> Optional[SplitState]:
        with self.lock:
            st = self._splits.get(sig)
            if st is not None:
                self._splits.move_to_end(sig)
            return st

    def put_split_state(self, sig: tuple, st: SplitState) -> None:
        with self.lock:
            self._splits[sig] = st
            self._splits.move_to_end(sig)
            while len(self._splits) > _MAX_SPLIT_SIGS:
                self._splits.popitem(last=False)

    # -- deletion-vector memo ------------------------------------------------

    def dv_memo(self, key: Optional[str]):
        """(hit, dv_index) for the given index-manifest name."""
        with self.lock:
            if self._dv_key == key and self._dv_index is not None:
                return True, self._dv_index
            return False, None

    def put_dv_memo(self, key: Optional[str], dv_index: dict) -> None:
        with self.lock:
            self._dv_key = key
            self._dv_index = dv_index


_LOCK = threading.Lock()
_CACHES: "OrderedDict[tuple, TablePlanCache]" = OrderedDict()


def shared_plan_cache(table_path: str, branch: str) -> TablePlanCache:
    """The process-wide cache for one table+branch (LRU-bounded: a
    long test/serving process touching many tables stays bounded)."""
    key = (table_path.rstrip("/"), branch or "main")
    with _LOCK:
        cache = _CACHES.get(key)
        if cache is None:
            cache = TablePlanCache()
            _CACHES[key] = cache
        _CACHES.move_to_end(key)
        while len(_CACHES) > _MAX_TABLES:
            _CACHES.popitem(last=False)
        return cache


def reset_plan_caches() -> None:
    """Drop every cached plan state (test / bench hook)."""
    with _LOCK:
        _CACHES.clear()
