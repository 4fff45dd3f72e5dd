"""Snapshot expiration with ref-counted file deletion.

Counterpart of paimon_tpu/maintenance/expire.py: the same retained sets
and deletions, so either package expires a table the other wrote.

reference: operation/ExpireSnapshotsImpl.java (retain-min/max +
time-retained window, consumer protection) + SnapshotDeletion.java
(delete data/changelog/manifest files not referenced by any retained
snapshot, never files pinned by tags).

Deviation from the reference's incremental diffing: we compute the
referenced-file sets of every RETAINED snapshot, every tag and every
branch head, and delete only expired-snapshot files outside that set —
simpler, idempotent, and safe under crashes (a re-run just continues).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from paimon_tpu_torch.manifest import FileKind
from paimon_tpu_torch.manifest.stats_sidecar import sidecar_name
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.snapshot import Snapshot

__all__ = ["expire_snapshots", "ExpireResult"]

@dataclass
class ExpireResult:
    expired_snapshots: List[int] = field(default_factory=list)
    deleted_data_files: int = 0
    deleted_manifest_files: int = 0
    # heartbeat snapshots folded OUT OF THE MIDDLE of the retained
    # chain (lease/rejoin traffic carrying no data and no offsets)
    folded_snapshots: List[int] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.expired_snapshots and not self.folded_snapshots


def _snapshot_refs(table, snapshot: Snapshot
                   ) -> Tuple[Set[Tuple], Set[str]]:
    """(data file refs {(partition_bytes, bucket, file_name, external_path)},
    manifest-plane file names {str}) referenced by one snapshot."""
    from paimon_tpu_torch.manifest import merge_manifest_entries

    scan = table.new_scan()
    data: Set[Tuple] = set()
    manifests: Set[str] = set()

    def _add_file(e):
        data.add((e.partition, e.bucket, e.file.file_name,
                  e.file.external_path))
        for extra in e.file.extra_files:
            data.add((e.partition, e.bucket, extra, None))

    def _read_list(list_name):
        entries = []
        manifests.add(list_name)
        # the columnar stats sidecar lives and dies with its list
        manifests.add(sidecar_name(list_name))
        try:
            metas = scan.manifest_list.read(list_name)
        except FileNotFoundError:
            return entries
        for m in metas:
            manifests.add(m.file_name)
            try:
                entries.extend(scan.manifest_file.read(m.file_name))
            except FileNotFoundError:
                continue
        return entries

    # the snapshot pins exactly its MERGED live set: files ADDed in base+
    # delta and not cancelled by a DELETE (a DELETE entry stays readable
    # without the physical file)
    base_delta = []
    if snapshot.base_manifest_list:
        base_delta.extend(_read_list(snapshot.base_manifest_list))
    if snapshot.delta_manifest_list:
        base_delta.extend(_read_list(snapshot.delta_manifest_list))
    for e in merge_manifest_entries(base_delta):
        if e.kind == FileKind.ADD:
            _add_file(e)
    if snapshot.changelog_manifest_list:
        # changelog plane: raw ADDs, no merge — the shared walk
        _walk_manifest_list(scan, snapshot.changelog_manifest_list,
                            data, manifests)
    if snapshot.index_manifest:
        manifests.add(snapshot.index_manifest)
        try:
            for e in scan.index_manifest_file.read(snapshot.index_manifest):
                data.add((e.partition, e.bucket,
                          e.index_file.file_name, None))
        except FileNotFoundError:
            pass
    return data, manifests


def _walk_manifest_list(scan, list_name: str, data: Set[Tuple],
                        manifests: Set[str]):
    """Record every manifest name and ADDed data ref (incl. extra
    files) reachable from one manifest list — the raw-ADD traversal
    used for the changelog plane by both _snapshot_refs and
    _changelog_refs (the base+delta plane needs merge-cancellation
    semantics and keeps its own walk)."""
    entries = []
    manifests.add(list_name)
    manifests.add(sidecar_name(list_name))
    try:
        metas = scan.manifest_list.read(list_name)
    except FileNotFoundError:
        return entries
    for m in metas:
        manifests.add(m.file_name)
        try:
            entries.extend(scan.manifest_file.read(m.file_name))
        except FileNotFoundError:
            continue
    for e in entries:
        if e.kind == FileKind.ADD:
            data.add((e.partition, e.bucket, e.file.file_name,
                      e.file.external_path))
            for extra in e.file.extra_files:
                data.add((e.partition, e.bucket, extra, None))
    return entries


def _changelog_refs(table, snapshot, scan=None):
    """(data refs, manifest names) pinned by a snapshot's CHANGELOG
    plane only."""
    if scan is None:
        scan = table.new_scan()
    data: Set[Tuple] = set()
    manifests: Set[str] = set()
    if snapshot.changelog_manifest_list:
        _walk_manifest_list(scan, snapshot.changelog_manifest_list,
                            data, manifests)
    return data, manifests


def expire_changelogs(table, retain_max: Optional[int] = None,
                      retain_min: Optional[int] = None,
                      dry_run: bool = False) -> "ExpireResult":
    """Trim the decoupled changelog set beyond
    changelog.num-retained.max, deleting the preserved metadata AND the
    changelog data files it pinned (reference ExpireChangelogImpl)."""
    from paimon_tpu_torch.snapshot.changelog_manager import ChangelogManager

    options = table.options
    if retain_max is None:
        retain_max = options.get(CoreOptions.CHANGELOG_NUM_RETAINED_MAX)
    if retain_min is None:
        retain_min = options.get(
            CoreOptions.CHANGELOG_NUM_RETAINED_MIN) or 1
    result = ExpireResult()
    if retain_max is None:
        return result
    cm = ChangelogManager(table.file_io, table.path, table.branch)
    ids = cm._ids()
    # live snapshots also count toward the retained changelog window
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id() or 0
    earliest_snap = sm.earliest_snapshot_id() or 0
    live = latest - earliest_snap + 1 if latest else 0
    excess = len(ids) + live - max(retain_min, retain_max)
    if excess <= 0:
        return result
    to_drop = ids[:excess]
    scan = table.new_scan()

    # anything still pinned survives: live snapshots, TAGS (reference
    # ExpireChangelogImpl takes the TagManager for exactly this), and
    # the changelog entries that are retained
    keep_data: Set[Tuple] = set()
    keep_manifests: Set[str] = set()
    pinners: List[Snapshot] = []
    for sid in range(earliest_snap, latest + 1):
        try:
            pinners.append(sm.snapshot(sid))
        except FileNotFoundError:
            continue
    pinners.extend(table.tag_manager.tagged_snapshots())
    for s in pinners:
        d, m = _snapshot_refs(table, s)
        keep_data |= d
        keep_manifests |= m
    for cid in ids[excess:]:
        snap = cm.try_changelog(cid)
        if snap is not None:
            d, m = _changelog_refs(table, snap, scan)
            keep_data |= d
            keep_manifests |= m

    for cid in to_drop:
        snap = cm.try_changelog(cid)
        if snap is None:
            continue
        data, manifests = _changelog_refs(table, snap, scan)
        data -= keep_data
        manifests -= keep_manifests
        result.expired_snapshots.append(cid)
        result.deleted_data_files += len(data)
        result.deleted_manifest_files += len(manifests)
        if dry_run:
            continue
        for (pbytes, bucket, fname, ext) in data:
            partition = scan._partition_codec.from_bytes(pbytes)
            table.file_io.delete_quietly(
                ext or scan.path_factory.data_file_path(partition,
                                                        bucket, fname))
        for fname in manifests:
            table.file_io.delete_quietly(
                f"{scan.path_factory.manifest_dir}/{fname}")
        cm.delete_changelog(cid)
    return result


def _fold_heartbeats(table, dry_run: bool = False) -> List[int]:
    """Fold pure-heartbeat snapshots out of the MIDDLE of the retained
    chain.  The multi-host planes commit lease renewals / rejoin
    requests as forced empty snapshots at heartbeat cadence; under a
    long-idle fleet they are the ONLY traffic, the count/age expiry
    windows never trigger (they only trim the tail), and the chain
    grows without bound.  A snapshot folds when it is provably inert:

      - strictly inside the chain (never the earliest or latest),
      - APPEND kind with deltaRecordCount == 0 and no changelog list
        (no data, no deliveries),
      - carries NO `stream.source.offset` — offset checkpoints are
        recovery points and takeover/rejoin floors (the offset floor),
      - NOT the newest such snapshot of its commit user — the lease
        view, rejoin requests and sweep watermarks are max-merged over
        a bounded newest-first walk, so each user's newest heartbeat
        stays visible (the lease floor),
      - below every consumer's progress (consumers walk ids and must
        never meet a hole ahead of them).

    Deletes the snapshot file and its uniquely-owned manifest LIST
    files (+ stats sidecars) — never manifests or data, which are
    shared.  Folded ids are durably recorded in `snapshot/FOLDED`
    BEFORE deletion so fsck's chain check can tell a fold from torn
    expiry."""
    # a snapshot carrying the stream daemon's offset is a recovery
    # point and never folds
    from paimon_tpu_torch.service.stream_daemon import PROP_OFFSET
    from paimon_tpu_torch.snapshot.snapshot import CommitKind

    sm = table.snapshot_manager
    earliest = sm.earliest_snapshot_id()
    latest = sm.latest_snapshot_id()
    if earliest is None or latest is None or latest - earliest < 2:
        return []
    consumer_min = table.consumer_manager.min_next_snapshot()
    seen_users: set = set()
    candidates = []
    for sid in range(latest - 1, earliest, -1):
        try:
            snap = sm.snapshot(sid)
        # lint-ok: fault-taxonomy id-walk skip, not a retry: a hole
        # (expired or already-folded id) just moves to the next id
        except (FileNotFoundError, OSError):
            continue
        props = snap.properties or {}
        if PROP_OFFSET in props:
            continue
        if snap.commit_kind != CommitKind.APPEND or \
                snap.delta_record_count or \
                snap.changelog_manifest_list:
            continue
        if consumer_min is not None and sid >= consumer_min:
            continue
        user = snap.commit_user or ""
        if user not in seen_users:
            seen_users.add(user)            # newest heartbeat survives
            continue
        candidates.append(snap)
    if not candidates or dry_run:
        return sorted(s.id for s in candidates)

    sm.record_folded([s.id for s in candidates])
    scan = table.new_scan()
    for s in candidates:
        for list_name in (s.base_manifest_list, s.delta_manifest_list):
            if not list_name:
                continue
            table.file_io.delete_quietly(
                f"{scan.path_factory.manifest_dir}/{list_name}")
            table.file_io.delete_quietly(
                f"{scan.path_factory.manifest_dir}/"
                f"{sidecar_name(list_name)}")
        sm.delete_snapshot(s.id)
    return sorted(s.id for s in candidates)


def _clean_empty_dirs(table, bucket_dirs) -> None:
    """snapshot.clean-empty-directories: drop bucket dirs emptied by
    expiration, then any partition dirs emptied in turn (reference
    SnapshotDeletion#cleanEmptyDirectories). Best-effort — a concurrent
    writer recreating the dir just makes the rmdir a no-op."""
    fio = table.file_io
    parents = set()
    for d in bucket_dirs:
        if fio.exists(d) and not fio.list_status(d):
            fio.delete_quietly(d)
            parents.add(d.rsplit("/", 1)[0])
    table_root = table.path.rstrip("/")
    for d in parents:
        # partition dirs can nest (k1=v1/k2=v2): walk up to the table root
        while d != table_root and d.startswith(table_root):
            if fio.exists(d) and not fio.list_status(d):
                fio.delete_quietly(d)
                d = d.rsplit("/", 1)[0]
            else:
                break


def expire_snapshots(table, retain_max: Optional[int] = None,
                     retain_min: Optional[int] = None,
                     older_than_ms: Optional[int] = None,
                     dry_run: bool = False,
                     min_retained_snapshot_id: Optional[int] = None
                     ) -> ExpireResult:
    """Expire old snapshots. Defaults come from snapshot.num-retained.*
    and snapshot.time-retained options.

    `min_retained_snapshot_id` is an absolute floor: that snapshot and
    everything after it survive regardless of the count/age windows.
    The distributed stream daemons pin EVERY host's newest
    offset-carrying checkpoint here — expiring a peer's recovery point
    would make its restart (or a survivor's takeover of its offsets)
    replay from scratch and reuse commit identifiers."""
    options = table.options
    if retain_max is None:
        retain_max = options.get(CoreOptions.SNAPSHOT_NUM_RETAINED_MAX)
    if retain_min is None:
        retain_min = options.get(CoreOptions.SNAPSHOT_NUM_RETAINED_MIN)
    if older_than_ms is None:
        time_retained = options.get(CoreOptions.SNAPSHOT_TIME_RETAINED)
        older_than_ms = int(_time.time() * 1000) - time_retained
    retain_min = max(1, retain_min)
    retain_max = max(retain_min, retain_max)

    sm = table.snapshot_manager
    earliest = sm.earliest_snapshot_id()
    latest = sm.latest_snapshot_id()
    result = ExpireResult()
    if earliest is None or latest is None:
        return result

    # hint writes are best-effort (swallowed OSError), so a torn prior
    # expire can leave EARLIEST/LATEST pointing at deleted snapshots;
    # a restart heals them even when nothing is left to expire
    if not dry_run:
        from paimon_tpu_torch.snapshot.snapshot_manager import EARLIEST, LATEST
        for name, sid in ((EARLIEST, earliest), (LATEST, latest)):
            hint = sm._hint(name)
            if hint is not None and not sm.snapshot_exists(hint):
                sm._write_hint(name, sid)

    # upper bound of expiry (exclusive). Constraints, in order:
    #   keep at least retain_min snapshots
    #   expire anything beyond retain_max regardless of age
    #   otherwise expire only snapshots older than the time threshold
    #   never pass a consumer's progress
    end = latest - retain_min + 1
    forced_end = latest - retain_max + 1
    for sid in range(max(earliest, forced_end), end):
        try:
            snap = sm.snapshot(sid)
        except FileNotFoundError:
            continue
        if snap.time_millis >= older_than_ms:
            end = sid
            break
    # consumers protect their unread snapshots even against retain_max
    consumer_min = table.consumer_manager.min_next_snapshot()
    if consumer_min is not None:
        end = min(end, consumer_min)
    if min_retained_snapshot_id is not None:
        # absolute recovery floor (multi-host checkpoint protection)
        end = min(end, min_retained_snapshot_id)
    end = min(end, latest)              # always keep the latest
    if end <= earliest:
        # the tail window kept everything — heartbeat folding is the
        # EAGER path and still runs (long-idle chains stay bounded)
        result.folded_snapshots = _fold_heartbeats(table, dry_run)
        return result

    expiring = []
    for sid in range(earliest, end):
        try:
            expiring.append(sm.snapshot(sid))
        except FileNotFoundError:
            continue
    if not expiring:
        result.folded_snapshots = _fold_heartbeats(table, dry_run)
        return result

    # referenced by anything that survives: retained snapshots, tags,
    # branch heads
    keep_data: Set[Tuple] = set()
    keep_manifests: Set[str] = set()
    survivors: List[Snapshot] = []
    for sid in range(end, latest + 1):
        try:
            survivors.append(sm.snapshot(sid))
        except FileNotFoundError:
            continue
    survivors.extend(table.tag_manager.tagged_snapshots())
    for d, m in (_snapshot_refs(table, s) for s in survivors):
        keep_data |= d
        keep_manifests |= m

    scan = table.new_scan()
    dead_data: Set[Tuple] = set()
    dead_manifests: Set[str] = set()
    for s in expiring:
        d, m = _snapshot_refs(table, s)
        dead_data |= d - keep_data
        dead_manifests |= m - keep_manifests

    # decoupled changelog retention: when configured, an expiring
    # snapshot's changelog survives as changelog/changelog-<id> and its
    # changelog files are NOT deleted here (reference
    # utils/ChangelogManager.java; trimmed later by expire_changelogs)
    decoupled = options.get(
        CoreOptions.CHANGELOG_NUM_RETAINED_MAX) is not None
    if decoupled:
        from paimon_tpu_torch.snapshot.changelog_manager import ChangelogManager
        cm = ChangelogManager(table.file_io, table.path, table.branch)
        for s in expiring:
            # EVERY expiring snapshot gets an entry — a gap at a
            # changelog-less id (e.g. a COMPACT commit) would strand
            # stream consumers walking ids past expiry
            if not dry_run:
                cm.commit_changelog(s)
            if not s.changelog_manifest_list:
                continue
            pinned, pinned_manifests = _changelog_refs(table, s, scan)
            dead_data -= pinned
            dead_manifests -= pinned_manifests

    result.expired_snapshots = [s.id for s in expiring]
    result.deleted_data_files = len(dead_data)
    result.deleted_manifest_files = len(dead_manifests)
    if dry_run:
        result.folded_snapshots = _fold_heartbeats(table, dry_run=True)
        return result

    dead_paths = []
    touched_dirs = set()
    for (pbytes, bucket, fname, ext) in dead_data:
        partition = scan._partition_codec.from_bytes(pbytes)
        if fname.startswith("index-"):
            dead_paths.append(scan.path_factory.index_file_path(fname))
        elif ext:
            dead_paths.append(ext)
        else:
            dead_paths.append(scan.path_factory.data_file_path(
                partition, bucket, fname))
            touched_dirs.add(scan.path_factory.bucket_dir(partition,
                                                          bucket))
    dead_paths.extend(f"{scan.path_factory.manifest_dir}/{fname}"
                      for fname in dead_manifests)
    threads = table.options.get(CoreOptions.DELETE_FILE_THREAD_NUM)
    if threads and threads > 1 and len(dead_paths) > 1:
        # delete-file.thread-num (reference SnapshotDeletion's
        # deleteFiles executor): deletes are independent and IO-bound
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(table.file_io.delete_quietly, dead_paths))
    else:
        for path in dead_paths:
            table.file_io.delete_quietly(path)
    if table.options.get(CoreOptions.SNAPSHOT_CLEAN_EMPTY_DIRECTORIES):
        _clean_empty_dirs(table, touched_dirs)
    keep_stats = {s.statistics for s in survivors if s.statistics}
    for s in expiring:
        if s.statistics and s.statistics not in keep_stats:
            table.file_io.delete_quietly(
                f"{table.path}/statistics/{s.statistics}")
        sm.delete_snapshot(s.id)
    sm.commit_earliest_hint(end)
    result.folded_snapshots = _fold_heartbeats(table, dry_run)
    return result
