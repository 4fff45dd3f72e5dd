"""Streaming scan: startup-mode matrix + follow-up scanners.

Counterpart of paimon_tpu/table/stream_scan.py.

reference: table/source/DataTableStreamScan.java:56 (tryFirstPlan
:139-164, nextPlan), source/snapshot/*StartingScanner (13 impls),
DeltaFollowUpScanner.java / ChangelogFollowUpScanner.java, consumer
progress via consumer/ConsumerManager.java.

plan() returns the next batch of splits, or None when the stream is
caught up (poll again later). The first plan is decided by the startup
mode; subsequent plans follow snapshots one by one:

- changelog-producer=none  -> delta files of APPEND snapshots
  (COMPACT/OVERWRITE snapshots are skipped: their data is rewritten, not
  new — reference DeltaFollowUpScanner.shouldScanSnapshot)
- changelog-producer!=none -> changelog files of any snapshot that
  carries them (reference ChangelogFollowUpScanner)

Streaming splits preserve row kinds: the read path emits a `_ROW_KIND`
int8 column (+I=0 -U=1 +U=2 -D=3) instead of dropping retractions.
"""

from __future__ import annotations

import time
from typing import Optional

from paimon_tpu_torch.core.scan import ScanPlan
from paimon_tpu_torch.options import ChangelogProducer, CoreOptions, StartupMode
from paimon_tpu_torch.snapshot import ChangelogManager, CommitKind

__all__ = ["DataTableStreamScan"]


class DataTableStreamScan:
    def __init__(self, builder):
        from paimon_tpu_torch.table.table import TableScan

        self.builder = builder
        self.table = builder.table
        self.options = self.table.options
        self.snapshot_manager = self.table.snapshot_manager
        self.consumer_manager = self.table.consumer_manager
        # reuse TableScan's filter wiring on a fresh FileStoreScan
        self._scan = TableScan(builder)._scan
        self._use_changelog = (
            self.options.changelog_producer != ChangelogProducer.NONE)
        self._next: Optional[int] = None
        self._first = True
        cid = self.options.consumer_id
        if cid is not None and not self.options.get(
                CoreOptions.CONSUMER_IGNORE_PROGRESS):
            progress = self.consumer_manager.consumer(cid)
            if progress is not None:
                # resume where the consumer left off; no initial full scan
                self._next = progress
                self._first = False

    def _changelog_manager(self) -> ChangelogManager:
        return ChangelogManager(self.table.file_io, self.table.path,
                                self.table.branch)

    # -- checkpointing (reference Restorable) --------------------------------

    def checkpoint(self) -> Optional[int]:
        """The next snapshot id to read (restore() with it to resume)."""
        return self._next

    def restore(self, next_snapshot_id: Optional[int]):
        self._next = next_snapshot_id
        self._first = next_snapshot_id is None

    def notify_checkpoint_complete(self, next_snapshot_id: Optional[int]):
        """Persist consumer progress (reference
        ConsumerProgressCalculator -> ConsumerManager.resetConsumer)."""
        cid = self.options.consumer_id
        if cid is not None and next_snapshot_id is not None:
            self.consumer_manager.record_consumer(cid, next_snapshot_id)

    # -- planning ------------------------------------------------------------

    def plan(self) -> Optional[ScanPlan]:
        """Consumer progress is NOT persisted here: call
        notify_checkpoint_complete(checkpoint()) once the returned splits
        are durably processed, or restarts lose unprocessed rows
        (at-least-once, like the reference's checkpoint-complete hook)."""
        if self._first:
            return self._first_plan()
        return self._follow_up_plan()

    def _first_plan(self) -> Optional[ScanPlan]:
        sm = self.snapshot_manager
        mode = self.options.startup_mode
        latest = sm.latest_snapshot_id()

        if mode in (StartupMode.LATEST_FULL, StartupMode.FULL):
            fallback = self.options.get(CoreOptions.SCAN_FALLBACK_BRANCH)
            use_fallback = fallback and fallback != self.table.branch
            if latest is None and not use_fallback:
                return None
            self._first = False
            self._next = (latest or 0) + 1
            plan = self._scan.plan(sm.snapshot(latest), streaming=True) \
                if latest is not None else ScanPlan(None, [],
                                                    streaming=True)
            if use_fallback:
                # the initial full result unions the partitions this
                # branch lacks from the fallback branch (honouring this
                # scan's filters); follow-ups stay delta-only on this
                # branch (reference ChainTableFileStoreTable)
                from paimon_tpu_torch.table.table import (
                    with_fallback_partitions,
                )
                b = self.builder
                plan = with_fallback_partitions(
                    self.table, plan, fallback,
                    partition_filter=b._partition_filter,
                    predicate=b._predicate, buckets=b._buckets)
            return plan

        if mode == StartupMode.LATEST:
            # only changes from now on (reference
            # ContinuousLatestStartingScanner)
            self._first = False
            self._next = (latest or 0) + 1
            return ScanPlan(latest, [], streaming=True)

        if mode == StartupMode.COMPACTED_FULL:
            if latest is None:
                return None
            snap = None
            earliest = sm.earliest_snapshot_id() or 1
            for sid in range(latest, earliest - 1, -1):
                s = sm.snapshot(sid)
                if s.commit_kind == CommitKind.COMPACT:
                    snap = s
                    break
            if snap is None:
                snap = sm.snapshot(latest)
            self._first = False
            self._next = snap.id + 1
            return self._scan.plan(snap, streaming=True)

        if mode == StartupMode.FROM_SNAPSHOT:
            sid = self.options.get(CoreOptions.SCAN_SNAPSHOT_ID)
            if sid is None:
                raise ValueError("scan.mode=from-snapshot requires "
                                 "scan.snapshot-id")
            earliest = sm.earliest_snapshot_id() or 1
            # decoupled changelog extends readable history below the
            # earliest snapshot (reference ChangelogManager)
            ecl = self._changelog_manager().earliest_changelog_id()
            if ecl is not None:
                earliest = min(earliest, ecl)
            self._first = False
            self._next = max(sid, earliest)
            return ScanPlan(None, [], streaming=True)

        if mode == StartupMode.FROM_SNAPSHOT_FULL:
            sid = self.options.get(CoreOptions.SCAN_SNAPSHOT_ID)
            if sid is None:
                raise ValueError("scan.mode=from-snapshot-full requires "
                                 "scan.snapshot-id")
            if latest is None:
                return None
            self._first = False
            self._next = sid + 1
            return self._scan.plan(sm.snapshot(sid), streaming=True)

        if mode == StartupMode.FROM_TIMESTAMP:
            ts = self.options.get(CoreOptions.SCAN_TIMESTAMP_MILLIS)
            if ts is None:
                raise ValueError("scan.mode=from-timestamp requires "
                                 "scan.timestamp-millis")
            snap = sm.earlier_or_equal_time_mills(ts)
            earliest = sm.earliest_snapshot_id() or 1
            if snap is None:
                # the timestamp predates every live snapshot: decoupled
                # changelog may reach further back (reference
                # ChangelogManager.earlierOrEqualTimeMills)
                older = [c for c in self._changelog_manager().changelogs()
                         if c.time_millis > ts]
                if older:
                    earliest = min(earliest, min(c.id for c in older))
            self._first = False
            self._next = earliest if snap is None else snap.id + 1
            return ScanPlan(None, [], streaming=True)

        raise ValueError(f"Unsupported streaming startup mode {mode!r}")

    def _follow_up_plan(self) -> Optional[ScanPlan]:
        sm = self.snapshot_manager
        latest = sm.latest_snapshot_id()
        if latest is None or self._next is None or self._next > latest:
            return None
        delay = self.options.get(
            CoreOptions.STREAMING_READ_SNAPSHOT_DELAY)
        try:
            snapshot = sm.snapshot(self._next)
        except FileNotFoundError:
            # the snapshot expired, but with decoupled changelog
            # retention its changelog may live on under changelog/
            # (reference ChangelogManager; consumers read past snapshot
            # expiry)
            snapshot = self._changelog_manager().try_changelog(self._next)
            if snapshot is None:
                raise
        if delay is not None:
            # streaming.read.snapshot.delay: an incremental snapshot
            # only becomes visible once it has aged past the delay
            # (reference ContinuousDataFileSnapshotEnumerator delay)
            if snapshot.time_millis > time.time() * 1000 - delay:
                return None
        bound = self.options.get(CoreOptions.SCAN_BOUNDED_WATERMARK)
        if bound is not None and snapshot.watermark is not None and \
                snapshot.watermark > bound:
            # bounded stream: event time passed the bound — end of
            # stream (reference BoundedWatermarkFollowUpScanner)
            self._next = None
            return None
        self._next += 1
        if self._use_changelog:
            # reference ChangelogFollowUpScanner: read the snapshot's
            # changelog files (empty plan if it carries none)
            return self._scan.plan_changelog(snapshot, streaming=True)
        # reference DeltaFollowUpScanner: APPEND snapshots only (plus
        # OVERWRITE deltas when streaming-read-overwrite is on)
        if snapshot.commit_kind == CommitKind.APPEND:
            return self._scan.plan_delta(snapshot, streaming=True)
        if snapshot.commit_kind == CommitKind.OVERWRITE and \
                self.options.get(CoreOptions.STREAMING_READ_OVERWRITE):
            return self._scan.plan_delta(snapshot, streaming=True)
        return ScanPlan(snapshot.id, [], streaming=True)
