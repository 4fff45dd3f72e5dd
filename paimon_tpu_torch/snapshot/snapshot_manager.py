"""SnapshotManager: list/find/commit snapshot files with hint files.

reference: paimon-core/.../utils/SnapshotManager.java (snapshot/snapshot-N,
EARLIEST/LATEST hints that may be stale; full scan as fallback).

Latest-snapshot cache (tail-tolerance PR satellite, ROADMAP item 5
residual): one commit used to pay ~5 `latest_snapshot()` walks, each
2-3 store round trips (hint read + exists probe + forward walk +
snapshot JSON read) — the chain that kept small-batch ingest
latency-bound.  A validated per-manager cache cuts each walk to 1-2
`exists` probes: the cached id N is trusted iff snapshot-(N+1) is
absent AND snapshot-N still exists (guards external rollback), and a
newer commit just walks forward FROM the cache instead of from the
hint.  Invalidation is CAS-bumped: `try_commit` advances the cache on
a win AND on a loss (the contested id provably exists — the winner
wrote it), `delete_snapshot` of the cached tip drops it.  Correctness
never depends on the cache: every path re-probes the store before
answering, so a stale cache costs round trips, not wrong answers.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.snapshot.snapshot import Snapshot

__all__ = ["SnapshotManager"]

SNAPSHOT_PREFIX = "snapshot-"
EARLIEST = "EARLIEST"
LATEST = "LATEST"
# JSON list of snapshot ids FOLDED out of the middle of the chain by
# expire_snapshots' heartbeat-folding pass (maintenance/expire.py):
# readers treat these ids as legitimately absent (fsck excuses them
# from snapshot-gap), and the list self-prunes below EARLIEST
FOLDED = "FOLDED"


class SnapshotManager:
    def __init__(self, file_io: FileIO, table_path: str,
                 branch: str = "main"):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")
        self.branch = branch or "main"
        self._cache_lock = threading.Lock()
        # id-ONLY cache, deliberately: rollback_to / fast_forward can
        # delete and RECREATE a snapshot id with different content
        # (even bypassing this manager — fast_forward writes through a
        # fresh one), so the tip's JSON is re-read on every
        # latest_snapshot(); only the walk to FIND the tip is cached
        self._cached_latest_id: Optional[int] = None

    @property
    def snapshot_dir(self) -> str:
        if self.branch != "main":
            return (f"{self.table_path}/branch/branch-{self.branch}"
                    f"/snapshot")
        return f"{self.table_path}/snapshot"

    def snapshot_path(self, snapshot_id: int) -> str:
        return f"{self.snapshot_dir}/{SNAPSHOT_PREFIX}{snapshot_id}"

    # -- reads ---------------------------------------------------------------

    def snapshot(self, snapshot_id: int) -> Snapshot:
        return Snapshot.from_json(
            self.file_io.read_utf8(self.snapshot_path(snapshot_id)))

    def snapshot_exists(self, snapshot_id: int) -> bool:
        return self.file_io.exists(self.snapshot_path(snapshot_id))

    def _hint(self, name: str) -> Optional[int]:
        path = f"{self.snapshot_dir}/{name}"
        try:
            if self.file_io.exists(path):
                return int(self.file_io.read_utf8(path).strip())
        except (ValueError, OSError):
            pass
        return None

    def _all_ids(self) -> List[int]:
        ids = []
        for st in self.file_io.list_status(self.snapshot_dir):
            name = st.path.rstrip("/").split("/")[-1]
            if name.startswith(SNAPSHOT_PREFIX):
                try:
                    ids.append(int(name[len(SNAPSHOT_PREFIX):]))
                except ValueError:
                    pass
        return sorted(ids)

    def earliest_snapshot_id(self) -> Optional[int]:
        hint = self._hint(EARLIEST)
        if hint is not None and self.snapshot_exists(hint):
            # hint may be stale upward (expired snapshots); walk forward
            i = hint
            while not self.snapshot_exists(i):
                i += 1
            return i
        ids = self._all_ids()
        return ids[0] if ids else None

    def _note_latest(self, snapshot_id: int):
        with self._cache_lock:
            self._cached_latest_id = snapshot_id

    def _invalidate_latest(self):
        with self._cache_lock:
            self._cached_latest_id = None

    def latest_snapshot_id(self) -> Optional[int]:
        with self._cache_lock:
            cached = self._cached_latest_id
        if cached is not None:
            if not self.snapshot_exists(cached + 1):
                if self.snapshot_exists(cached):
                    return cached           # 2 probes, no hint read
                # the cached tip vanished (external rollback): fall
                # back to the full hint path below
                self._invalidate_latest()
            else:
                # a newer commit landed: walk forward FROM the cache
                i = cached + 1
                while self.snapshot_exists(i + 1):
                    i += 1
                self._note_latest(i)
                return i
        hint = self._hint(LATEST)
        if hint is not None and self.snapshot_exists(hint):
            # hint may be stale downward (newer commits); walk forward
            i = hint
            while self.snapshot_exists(i + 1):
                i += 1
            self._note_latest(i)
            return i
        ids = self._all_ids()
        if ids:
            self._note_latest(ids[-1])
            return ids[-1]
        return None

    def latest_snapshot(self) -> Optional[Snapshot]:
        sid = self.latest_snapshot_id()
        return self.snapshot(sid) if sid is not None else None

    def snapshots(self) -> Iterator[Snapshot]:
        earliest = self.earliest_snapshot_id()
        latest = self.latest_snapshot_id()
        if earliest is None or latest is None:
            return
        for i in range(earliest, latest + 1):
            if self.snapshot_exists(i):
                yield self.snapshot(i)

    def snapshot_count(self) -> int:
        return sum(1 for _ in self.snapshots())

    def earlier_or_equal_time_mills(self,
                                    time_millis: int) -> Optional[Snapshot]:
        """Latest snapshot with timeMillis <= given (reference
        SnapshotManager.earlierOrEqualTimeMills); binary search over
        ids, probing downward past folded-heartbeat holes."""
        lo = self.earliest_snapshot_id()
        hi = self.latest_snapshot_id()
        if lo is None or hi is None:
            return None
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            probe = mid
            while probe >= lo and not self.snapshot_exists(probe):
                probe -= 1          # folded hole: nearest older id
            if probe < lo:
                lo = mid + 1
                continue
            s = self.snapshot(probe)
            if s.time_millis <= time_millis:
                best = s
                lo = mid + 1
            else:
                hi = probe - 1
        return best

    # -- folded-heartbeat bookkeeping ----------------------------------------

    def folded_ids(self) -> set:
        """Ids deliberately removed from the middle of the chain by
        the heartbeat-folding pass; missing/corrupt file = empty."""
        path = f"{self.snapshot_dir}/{FOLDED}"
        try:
            if not self.file_io.exists(path):
                return set()
            import json
            raw = json.loads(self.file_io.read_utf8(path))
            return {int(i) for i in raw}
        except (OSError, ValueError, TypeError):
            return set()

    def record_folded(self, ids) -> None:
        """Durably record ids about to be folded — written BEFORE the
        snapshot files are deleted, so a crash between the two leaves
        ids that are folded-but-present (harmless: the excuse only
        matters for ids that are actually missing).  Self-prunes
        entries below the earliest retained snapshot, whose absence
        needs no excuse."""
        merged = self.folded_ids() | {int(i) for i in ids}
        earliest = self.earliest_snapshot_id()
        if earliest is not None:
            merged = {i for i in merged if i >= earliest}
        import json
        self.file_io.write_utf8(f"{self.snapshot_dir}/{FOLDED}",
                                json.dumps(sorted(merged)),
                                overwrite=True)

    # -- writes --------------------------------------------------------------

    def try_commit(self, snapshot: Snapshot) -> bool:
        """Atomically publish snapshot-N; False if id taken (CAS).
        Both outcomes BUMP the latest cache: a win makes `snapshot`
        the tip, a loss proves the contested id exists (the winner
        wrote it), so the next walk starts there instead of at the
        hint."""
        ok = self.file_io.try_to_write_atomic(
            self.snapshot_path(snapshot.id),
            snapshot.to_json().encode("utf-8"))
        if ok:
            self._note_latest(snapshot.id)
            self.commit_latest_hint(snapshot.id)
            if snapshot.id == 1 or self._hint(EARLIEST) is None:
                self.commit_earliest_hint(snapshot.id)
        else:
            self._note_latest(snapshot.id)
        return ok

    def commit_latest_hint(self, snapshot_id: int):
        self._write_hint(LATEST, snapshot_id)

    def commit_earliest_hint(self, snapshot_id: int):
        self._write_hint(EARLIEST, snapshot_id)

    def _write_hint(self, name: str, snapshot_id: int):
        try:
            self.file_io.write_utf8(f"{self.snapshot_dir}/{name}",
                                    str(snapshot_id), overwrite=True)
        except OSError:
            pass  # hints are best-effort

    def delete_snapshot(self, snapshot_id: int):
        with self._cache_lock:
            if self._cached_latest_id is not None and \
                    snapshot_id >= self._cached_latest_id:
                # rollback at/past the cached tip (expiry only deletes
                # OLD snapshots, which never affect the latest cache)
                self._cached_latest_id = None
        self.file_io.delete_quietly(self.snapshot_path(snapshot_id))
