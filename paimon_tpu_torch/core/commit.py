"""FileStoreCommit: two-phase snapshot commit with optimistic retry.

Counterpart of paimon_tpu/core/commit.py.  A commit's index entries (the dynamic-bucket hash index,
deletion vectors) fold into the previous snapshot's index manifest on
every CAS attempt.  Append tables with row-tracking.enabled get dense
row ids at commit, re-assigned on every CAS attempt from the latest
snapshot's next row id; a caller that planned against a snapshot
(`expected_latest_id`) gets CommitConflictError when another commit
landed first, and replans.  Each commit records the reference's
commit metric group (commits, retries, duration_ms) and spans
(commit.backoff, commit.manifest_encode, commit.cas).  A request
deadline (request.timeout) is checked before the snapshot CAS, and a
commit it aborts deletes every file its attempt wrote.  A commit made
inside a span stamps the span's context into the snapshot's
`trace.context` property.

reference: operation/FileStoreCommitImpl.java:139 (javadoc :122-132:
conflict check -> CAS publish; tryCommit retry loop :756), conflict
detection in operation/commit/ConflictDetection.java, atomicity provider
catalog/SnapshotCommit.java:27 (rename CAS here).
"""

from __future__ import annotations

import time as _time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from paimon_tpu_torch.core.write import CommitMessage
from paimon_tpu_torch.data.binary_row import BinaryRowCodec
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import (
    FileKind, IndexManifestFile, ManifestEntry, ManifestFile,
    ManifestFileMeta, ManifestList, merge_manifest_entries,
)
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.snapshot import CommitKind, Snapshot, SnapshotManager
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["FileStoreCommit", "CommitConflictError"]


class CommitConflictError(RuntimeError):
    pass


class FileStoreCommit:
    def __init__(self, file_io: FileIO, table_path: str,
                 table_schema: TableSchema, options: CoreOptions,
                 commit_user: Optional[str] = None,
                 branch: str = "main"):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")
        self.schema = table_schema
        self.options = options
        self.commit_user = commit_user or str(uuid.uuid4())
        self.snapshot_manager = SnapshotManager(file_io, table_path, branch)
        self.path_factory = FileStorePathFactory.from_options(
            table_path, table_schema.partition_keys, options)
        rt = table_schema.logical_row_type()
        self.partition_types = [rt.get_field(k).type
                                for k in table_schema.partition_keys]
        self._partition_codec = BinaryRowCodec(self.partition_types)
        compression = options.get(CoreOptions.MANIFEST_COMPRESSION)
        codec = {"zstd": "zstandard", "none": "null"}.get(compression,
                                                          compression)
        mdir = self.path_factory.manifest_dir
        key_types = [rt.get_field(k).type
                     for k in table_schema.trimmed_primary_keys()]
        sidecar = bool(options.get(CoreOptions.MANIFEST_STATS_SIDECAR))
        self.manifest_file = ManifestFile(
            file_io, mdir, codec, self.partition_types, key_types=key_types,
            sidecar=sidecar)
        self.manifest_list = ManifestList(
            file_io, mdir, codec, partition_types=self.partition_types,
            key_types=key_types, sidecar=sidecar)
        self.index_manifest_file = IndexManifestFile(file_io, mdir, codec)
        self.manifest_target_size = options.get(
            CoreOptions.MANIFEST_TARGET_FILE_SIZE)
        self.manifest_merge_min = options.get(
            CoreOptions.MANIFEST_MERGE_MIN_COUNT)
        # append tables with row-tracking.enabled get dense row ids at
        # commit (reference FileStoreCommitImpl.assignRowTracking:1046)
        self.row_tracking = (
            options.get(CoreOptions.ROW_TRACKING_ENABLED)
            and not table_schema.primary_keys)
        # optional lost-CAS observer (the attempt number of each loss):
        # the multi-host write plane (parallel/distributed.py) counts its
        # commit_conflicts / commit_retries here; commit arbitration IS
        # this retry loop, observed from outside
        self.conflict_listener: Optional[Callable] = None
        # optional () -> {str: str} of snapshot properties, evaluated
        # once per CAS attempt and merged under the explicit ones (the
        # CDC sink's, and the multi-host planes' lease and ownership
        # stamps, which stay fresh across retries this way)
        self.properties_provider: Optional[Callable] = None

    # -- public API ----------------------------------------------------------

    def commit(self, messages: Sequence[CommitMessage],
               commit_identifier: int = BATCH_COMMIT_IDENTIFIER,
               kind: Optional[str] = None,
               index_entries: Optional[list] = None,
               properties: Optional[Dict[str, str]] = None,
               force_create: bool = False,
               watermark: Optional[int] = None,
               expected_latest_id: Optional[int] = ...) -> Optional[int]:
        """Commit append + compact changes. Returns snapshot id (or None if
        nothing to commit). Append and compact deltas are committed as
        separate snapshots like the reference (APPEND then COMPACT), each
        with its own changelog manifest; `index_entries` ride the first
        of them.  With `expected_latest_id` the first of them raises
        CommitConflictError unless the latest snapshot is still that
        one."""
        append_entries: List[ManifestEntry] = []
        compact_entries: List[ManifestEntry] = []
        changelog_entries: List[ManifestEntry] = []
        compact_changelog_entries: List[ManifestEntry] = []
        for msg in messages:
            pbytes = self._partition_codec.to_bytes(msg.partition)
            for f in msg.new_files:
                append_entries.append(ManifestEntry(
                    FileKind.ADD, pbytes, msg.bucket, msg.total_buckets, f))
            for f in msg.changelog_files:
                changelog_entries.append(ManifestEntry(
                    FileKind.ADD, pbytes, msg.bucket, msg.total_buckets, f))
            for f in msg.compact_before:
                compact_entries.append(ManifestEntry(
                    FileKind.DELETE, pbytes, msg.bucket, msg.total_buckets,
                    f))
            for f in msg.compact_after:
                compact_entries.append(ManifestEntry(
                    FileKind.ADD, pbytes, msg.bucket, msg.total_buckets, f))
            for f in msg.compact_changelog:
                compact_changelog_entries.append(ManifestEntry(
                    FileKind.ADD, pbytes, msg.bucket, msg.total_buckets, f))

        last_id = None
        force_empty = (
            force_create or
            self.options.get(CoreOptions.COMMIT_FORCE_CREATE_SNAPSHOT) or
            self.options.get(
                CoreOptions.SNAPSHOT_IGNORE_EMPTY_COMMIT) is False)
        if append_entries or changelog_entries or index_entries or \
                (force_empty and not compact_entries):
            last_id = self._try_commit(
                append_entries, changelog_entries, commit_identifier,
                kind or CommitKind.APPEND, index_entries=index_entries,
                properties=properties, watermark=watermark,
                expected_latest_id=expected_latest_id)
            index_entries = None
        if compact_entries or compact_changelog_entries:
            last_id = self._try_commit(
                compact_entries, compact_changelog_entries,
                commit_identifier, CommitKind.COMPACT,
                check_deleted_files=True, index_entries=index_entries,
                properties=properties, watermark=watermark)
        return last_id

    def overwrite(self, messages: Sequence[CommitMessage],
                  partition_filter: Optional[dict] = None,
                  commit_identifier: int = BATCH_COMMIT_IDENTIFIER,
                  index_entries: Optional[list] = None,
                  watermark: Optional[int] = None,
                  properties: Optional[Dict[str, str]] = None
                  ) -> Optional[int]:
        """INSERT OVERWRITE: delete current files (optionally restricted to
        a partition spec) and add new ones atomically
        (reference FileStoreCommitImpl.overwrite). The delete set is
        recomputed from the latest snapshot on every CAS attempt so files
        committed concurrently between planning and publish do not
        survive the overwrite."""
        adds: List[ManifestEntry] = []
        for msg in messages:
            pbytes = self._partition_codec.to_bytes(msg.partition)
            for f in msg.new_files:
                adds.append(ManifestEntry(
                    FileKind.ADD, pbytes, msg.bucket, msg.total_buckets, f))

        def entries_fn(latest: Optional[Snapshot]) -> List[ManifestEntry]:
            entries: List[ManifestEntry] = []
            if latest is not None:
                for e in self._read_all_entries(latest):
                    if e.kind != FileKind.ADD:
                        continue
                    if partition_filter and not self._partition_matches(
                            e.partition, partition_filter):
                        continue
                    entries.append(ManifestEntry(
                        FileKind.DELETE, e.partition, e.bucket,
                        e.total_buckets, e.file))
            return entries + adds

        return self._try_commit([], [], commit_identifier,
                                CommitKind.OVERWRITE, entries_fn=entries_fn,
                                index_entries=index_entries,
                                properties=properties,
                                watermark=watermark)

    def filter_committed(self, commit_identifiers: Sequence[int]
                         ) -> List[int]:
        """Drop identifiers already committed by this user (exactly-once
        replay dedup, reference FileStoreCommit.filterCommitted:52)."""
        committed = set()
        for snap in self.snapshot_manager.snapshots():
            if snap.commit_user == self.commit_user:
                committed.add(snap.commit_identifier)
        return [c for c in commit_identifiers if c not in committed]

    # -- internals -----------------------------------------------------------

    def _read_all_entries(self, snapshot: Snapshot) -> List[ManifestEntry]:
        metas = self.manifest_list.read_all(snapshot.base_manifest_list,
                                            snapshot.delta_manifest_list)
        entries: List[ManifestEntry] = []
        for m in metas:
            entries.extend(self.manifest_file.read(m.file_name))
        return merge_manifest_entries(entries)

    def _partition_matches(self, pbytes: bytes, spec: dict) -> bool:
        values = self._partition_codec.from_bytes(pbytes)
        for i, k in enumerate(self.schema.partition_keys):
            if k in spec and str(values[i]) != str(spec[k]):
                return False
        return True

    def _try_commit(self, entries: List[ManifestEntry],
                    changelog_entries: List[ManifestEntry],
                    commit_identifier: int, kind: str,
                    check_deleted_files: bool = False,
                    index_entries: Optional[list] = None,
                    properties: Optional[Dict[str, str]] = None,
                    entries_fn=None,
                    force_full_manifest_merge: bool = False,
                    skip_missing_manifests: bool = False,
                    watermark: Optional[int] = None,
                    expected_latest_id: Optional[int] = ...,
                    statistics: Optional[str] = None) -> int:
        from paimon_tpu_torch.metrics import (
            COMMIT_CAS_MS, COMMIT_MANIFEST_ENCODE_MS, global_registry,
        )
        from paimon_tpu_torch.obs.trace import (
            current_context_token, span, sync_from_options,
        )
        from paimon_tpu_torch.utils.backoff import Backoff
        from paimon_tpu_torch.utils.deadline import (
            DeadlineExceededError, check_deadline,
        )

        sync_from_options(self.options)
        metrics = global_registry().commit_metrics()
        t0 = _time.perf_counter()
        attempts = 0
        max_retries = self.options.get(CoreOptions.COMMIT_MAX_RETRIES)
        # decorrelated jitter between the retry-wait bounds, bounded in
        # total time by commit.timeout
        backoff = Backoff(self.options.get(CoreOptions.COMMIT_MIN_RETRY_WAIT),
                          self.options.get(CoreOptions.COMMIT_MAX_RETRY_WAIT),
                          self.options.get(CoreOptions.COMMIT_TIMEOUT))
        new_manifest: Optional[ManifestFileMeta] = None
        changelog_manifest: Optional[ManifestFileMeta] = None
        entries_orig = list(entries)

        def write_manifest(manifest_entries, which):
            with span("commit.manifest_encode", cat="commit",
                      group="commit", metric=COMMIT_MANIFEST_ENCODE_MS,
                      which=which, attempt=attempts,
                      entries=len(manifest_entries)):
                return self.manifest_file.write(
                    manifest_entries, schema_id=self.schema.id)

        # this attempt's files, bound before the loop so the deadline
        # handler deletes whatever the current attempt had written when
        # the deadline tripped (any store read inside an attempt checks
        # it, not only the CAS gate)
        base_name = delta_name = changelog_name = None
        index_manifest = prev_index = None
        merged_manifests: List[ManifestFileMeta] = []

        def delete_attempt_lists():
            """Drop the current attempt's manifest lists, index manifest
            and merged manifests: the lost-CAS retry and the deadline
            abort share it (every delete is quiet and deadline-
            shielded)."""
            if base_name:
                self.manifest_list.delete(base_name)
            if delta_name:
                self.manifest_list.delete(delta_name)
            if changelog_name:
                self.manifest_list.delete(changelog_name)
            if index_manifest is not None and index_manifest != prev_index:
                self.file_io.delete_quietly(
                    self.index_manifest_file.path(index_manifest))
            for m in merged_manifests:
                self.file_io.delete_quietly(
                    self.manifest_file.path(m.file_name))

        try:
            while True:
                if attempts > max_retries or \
                        (attempts > 0 and backoff.budget_exhausted()):
                    # the per-attempt cleanup keeps the (reusable) delta and
                    # changelog manifest FILES; on giving up they would be
                    # orphaned with no snapshot referencing them
                    for m in (new_manifest, changelog_manifest):
                        if m is not None:
                            self.file_io.delete_quietly(
                                self.manifest_file.path(m.file_name))
                    raise CommitConflictError(
                        f"Commit lost the snapshot CAS race {attempts - 1} "
                        f"times (commit.max-retries={max_retries}, "
                        f"commit.timeout); giving up")
                if attempts > 0:
                    with span("commit.backoff", cat="commit",
                              attempt=attempts, table=self.table_path):
                        backoff.pause()
                attempts += 1
                latest = self.snapshot_manager.latest_snapshot()
                if expected_latest_id is not ... and \
                        (latest.id if latest else None) != expected_latest_id:
                    # the caller's plan is stale (deletion vectors or
                    # overlays built against an older snapshot): surface a
                    # conflict so it replans instead of losing a change
                    raise CommitConflictError(
                        f"Snapshot advanced past {expected_latest_id} before "
                        f"commit; replan required")
                if entries_fn is not None:
                    # delete/add set depends on the latest snapshot (e.g.
                    # overwrite): recompute per attempt
                    entries = entries_fn(latest)
                    new_manifest = None
                else:
                    entries = entries_orig
                next_row_id = latest.next_row_id if latest else None
                ids_assigned = False
                if self.row_tracking and any(
                        e.kind == FileKind.ADD and e.file.first_row_id is None
                        for e in entries):
                    # the row-id start depends on the latest snapshot, so the
                    # assignment re-runs from the unassigned entries (and the
                    # manifest is rewritten) on every CAS attempt
                    from paimon_tpu_torch.core.row_tracking import (
                        assign_row_ids,
                    )
                    start = next_row_id
                    if start is None:
                        # tracking enabled on an existing table: old files
                        # keep no ids; new ids start past every row
                        start = latest.total_record_count if latest else 0
                    entries, next_row_id = assign_row_ids(entries, start)
                    new_manifest = None
                    ids_assigned = True
                if check_deleted_files and latest is not None:
                    self._assert_files_exist(latest, entries)
                if new_manifest is None and entries:
                    new_manifest = write_manifest(entries, "delta")
                if changelog_manifest is None and changelog_entries:
                    changelog_manifest = write_manifest(changelog_entries,
                                                        "changelog")

                if latest is None:
                    base_metas: List[ManifestFileMeta] = []
                    new_id = 1
                    prev_total = 0
                    prev_index = None
                else:
                    base_metas = self.manifest_list.read_all(
                        latest.base_manifest_list, latest.delta_manifest_list)
                    new_id = latest.id + 1
                    prev_total = latest.total_record_count
                    prev_index = latest.index_manifest

                base_metas, merged_manifests = self._maybe_merge_manifests(
                    base_metas, force=force_full_manifest_merge,
                    skip_missing=skip_missing_manifests)
                base_name, base_size = self.manifest_list.write(base_metas)
                delta_metas = [new_manifest] if new_manifest else []
                delta_name, delta_size = self.manifest_list.write(delta_metas)
                changelog_name = changelog_size = None
                if changelog_manifest is not None:
                    changelog_name, changelog_size = self.manifest_list.write(
                        [changelog_manifest])
                # the full index set at this attempt's base: recombined on
                # every attempt, so a lost race never publishes over another
                # writer's index entries
                index_manifest = self.index_manifest_file.combine(
                    prev_index, index_entries or [])
                # watermarks only advance (reference FileStoreCommitImpl:
                # max of provided and previous)
                wm_vals = [w for w in
                           (watermark, latest.watermark if latest else None)
                           if w is not None]
                if force_full_manifest_merge and \
                        getattr(self, "_force_merge_total", None) is not None:
                    # the full rewrite recounted every live entry — use the
                    # true total (skip_missing may have dropped manifests)
                    prev_total = self._force_merge_total
                    self._force_merge_total = None
                delta_rows = sum(
                    (e.file.row_count if e.kind == FileKind.ADD
                     else -e.file.row_count) for e in entries)
                changelog_rows = sum(e.file.row_count for e in changelog_entries)
                attempt_props = properties
                if self.properties_provider is not None:
                    attempt_props = dict(self.properties_provider() or {})
                    attempt_props.update(properties or {})
                    attempt_props = attempt_props or None
                ctx = current_context_token()
                if ctx is not None:
                    # the store carries the trace context: readers of this
                    # snapshot link their spans to the committing span in
                    # the merged fleet trace; an explicit or provider
                    # context wins
                    attempt_props = dict(attempt_props or {})
                    attempt_props.setdefault("trace.context", ctx)
                snapshot = Snapshot(
                    id=new_id,
                    schema_id=self.schema.id,
                    base_manifest_list=base_name,
                    base_manifest_list_size=base_size,
                    delta_manifest_list=delta_name,
                    delta_manifest_list_size=delta_size,
                    changelog_manifest_list=changelog_name,
                    changelog_manifest_list_size=changelog_size,
                    index_manifest=index_manifest,
                    commit_user=self.commit_user,
                    commit_identifier=commit_identifier,
                    commit_kind=kind,
                    time_millis=int(_time.time() * 1000),
                    total_record_count=prev_total + delta_rows,
                    delta_record_count=delta_rows,
                    changelog_record_count=changelog_rows or None,
                    properties=attempt_props,
                    statistics=statistics,
                    next_row_id=next_row_id,
                    watermark=max(wm_vals) if wm_vals else None,
                )
                # the point of no return is the CAS itself: a request whose
                # deadline is spent raises here, before publishing (the
                # handler around the loop cleans this attempt's files)
                check_deadline("commit CAS")
                with span("commit.cas", cat="commit", group="commit",
                          metric=COMMIT_CAS_MS, attempt=attempts,
                          snapshot=new_id, table=self.table_path) as cas:
                    won = self.snapshot_manager.try_commit(snapshot)
                    cas.set(won=won)
                if won:
                    metrics.counter("commits").inc()
                    if attempts > 1:
                        metrics.counter("retries").inc(attempts - 1)
                    metrics.histogram("duration_ms").update(
                        (_time.perf_counter() - t0) * 1000)
                    return new_id
                # lost the race: clean up everything written for this
                # attempt and retry against the new latest (the delta
                # manifest is reusable unless the entry set is dynamic)
                if self.conflict_listener is not None:
                    self.conflict_listener(attempts)
                from paimon_tpu_torch.obs.flight import (
                    EV_COMMIT_CONFLICT, record,
                )
                record(EV_COMMIT_CONFLICT, attempt=attempts,
                       snapshot=new_id, user=self.commit_user)
                delete_attempt_lists()
                if (entries_fn is not None or ids_assigned) and \
                        new_manifest is not None:
                    # the entry set was rebuilt for this attempt (dynamic
                    # entries or row ids): its manifest is stale too
                    self.file_io.delete_quietly(
                        self.manifest_file.path(new_manifest.file_name))
                    new_manifest = None
        except DeadlineExceededError:
            # the lost-CAS cleanup plus the manifests that giving up
            # drops: nothing this attempt wrote outlives the abort
            delete_attempt_lists()
            for m in (new_manifest, changelog_manifest):
                if m is not None:
                    self.file_io.delete_quietly(
                        self.manifest_file.path(m.file_name))
            raise

    def _assert_files_exist(self, latest: Snapshot,
                            entries: List[ManifestEntry]):
        """Compaction conflict checks (reference
        operation/commit/ConflictDetection.java):
        1. every file we delete must still be live
        2. files we add at level > 0 must not overlap the key range of a
           concurrent live file at the same level (two racing
           compactions writing the same level would corrupt the
           no-overlap invariant levels >= 1 rely on)"""
        deletes = [e for e in entries if e.kind == FileKind.DELETE]
        adds_upper = [e for e in entries
                      if e.kind == FileKind.ADD and e.file.level > 0]
        if not deletes and not adds_upper:
            return
        live_entries = [e for e in self._read_all_entries(latest)
                        if e.kind == FileKind.ADD]
        live = {e.identifier() for e in live_entries}
        for d in deletes:
            ident = (d.partition, d.bucket, d.file.level, d.file.file_name,
                     tuple(d.file.extra_files), d.file.embedded_index,
                     d.file.external_path)
            if ident not in live:
                raise CommitConflictError(
                    f"File to delete no longer exists: "
                    f"{d.file.file_name} (level {d.file.level}); "
                    f"a concurrent compaction won. Retry the compaction "
                    f"from the new snapshot.")
        if not adds_upper:
            return
        key_types = [
            self.schema.logical_row_type().get_field(k).type.copy(False)
            for k in self.schema.trimmed_primary_keys()]
        if not key_types:
            return
        key_codec = BinaryRowCodec(key_types)

        def decode_key(b: bytes):
            # BinaryRow bytes are NOT order-comparable (little-endian
            # slots); decode to value tuples like the reference's typed
            # comparator
            if not b:
                return None
            try:
                return tuple(key_codec.from_bytes(b))
            except Exception:
                return None

        deleted_names = {(d.partition, d.bucket, d.file.file_name)
                         for d in deletes}
        for a in adds_upper:
            a_min = decode_key(a.file.min_key)
            a_max = decode_key(a.file.max_key)
            if a_min is None or a_max is None:
                continue
            for e in live_entries:
                if (e.partition, e.bucket, e.file.level) != \
                        (a.partition, a.bucket, a.file.level):
                    continue
                if (e.partition, e.bucket, e.file.file_name) \
                        in deleted_names:
                    continue       # replaced by this very commit
                e_min = decode_key(e.file.min_key)
                e_max = decode_key(e.file.max_key)
                if e_min is None or e_max is None:
                    continue
                if a_min <= e_max and e_min <= a_max:
                    raise CommitConflictError(
                        f"Key range of new file {a.file.file_name} "
                        f"(level {a.file.level}) overlaps live file "
                        f"{e.file.file_name}; a concurrent compaction "
                        f"wrote this level. Retry from the new snapshot.")

    def compact_manifests(self, skip_missing: bool = False,
                          properties: Optional[Dict[str, str]] = None
                          ) -> Optional[int]:
        """Force one full manifest rewrite: every base+delta manifest is
        read, DELETE entries are folded away, and the merged entry set
        is committed as a COMPACT snapshot with an empty delta — the
        base rewritten as sorted, partition-clustered, size-bounded
        manifests (reference flink/procedure/CompactManifestProcedure +
        manifest full-compaction). Returns the new snapshot id, or None
        when the table has no snapshot.  `skip_missing` tolerates
        manifest FILES deleted out of band (reference
        RemoveUnexistingManifestsProcedure) — entries they held are
        lost, which is the point of that repair.

        A pure full-compaction commits as COMPACT with an empty delta
        — the live-entry set is unchanged, so the delta-apply plan
        cache folds it as a no-op.  The `skip_missing` repair DROPS
        entries without DELETE records, so it commits as OVERWRITE:
        every cached plan (this process or any other) invalidates
        instead of serving ghost entries for files the repair
        removed."""
        if self.snapshot_manager.latest_snapshot() is None:
            return None
        return self._try_commit([], [], BATCH_COMMIT_IDENTIFIER,
                                CommitKind.OVERWRITE if skip_missing
                                else CommitKind.COMPACT,
                                properties=properties,
                                force_full_manifest_merge=True,
                                skip_missing_manifests=skip_missing)

    def _maybe_merge_manifests(self, metas: List[ManifestFileMeta],
                               force: bool = False,
                               skip_missing: bool = False
                               ) -> Tuple[List[ManifestFileMeta],
                                          List[ManifestFileMeta]]:
        """Full-rewrite small manifests when there are too many
        (reference manifest/ManifestFileMerger); `force` merges
        EVERYTHING and folds DELETE entries (compact_manifests).
        Returns (metas, newly_written) so the caller can delete fresh
        files if the commit attempt loses the CAS."""
        if force:
            entries: List[ManifestEntry] = []
            for m in metas:
                try:
                    entries.extend(self.manifest_file.read(m.file_name))
                except FileNotFoundError:
                    if not skip_missing:
                        raise
                    # repair mode: the manifest is gone, its entries
                    # are unrecoverable — drop it from the chain
            merged = merge_manifest_entries(entries)
            # the rewrite KNOWS the true row total; expose it so the
            # snapshot does not inherit counts from dropped manifests
            self._force_merge_total = sum(
                e.file.row_count for e in merged
                if e.kind == FileKind.ADD)
            if not merged:
                return [], []
            # sorted, partition-clustered, size-bounded base manifests
            # (reference Paimon manifest full-compaction): each output
            # manifest covers a narrow (partition, bucket, key) band,
            # so the per-manifest stats the columnar sidecar persists
            # stay selective and the vectorized prune keeps whole
            # manifests unfetched.  Raw-byte key order is a clustering
            # heuristic only — correctness never depends on it.
            merged.sort(key=lambda e: (e.partition, e.bucket,
                                       e.file.min_key or b""))
            total_size = sum(m.file_size for m in metas)
            total_entries = sum(m.num_added_files + m.num_deleted_files
                                for m in metas) or 1
            per_entry = max(64, total_size // total_entries) \
                if total_size else 256
            chunk = max(1, int(self.manifest_target_size // per_entry))
            out = []
            for i in range(0, len(merged), chunk):
                out.append(self.manifest_file.write(
                    merged[i:i + chunk], schema_id=self.schema.id))
            return out, list(out)
        if len(metas) < self.manifest_merge_min:
            return metas, []
        small = [m for m in metas if m.file_size < self.manifest_target_size]
        if len(small) < 2:
            return metas, []
        big = [m for m in metas if m.file_size >= self.manifest_target_size]
        entries: List[ManifestEntry] = []
        for m in small:
            entries.extend(self.manifest_file.read(m.file_name))
        merged = merge_manifest_entries(entries)
        out = list(big)
        written = []
        if merged:
            meta = self.manifest_file.write(merged, schema_id=self.schema.id)
            out.append(meta)
            written.append(meta)
        return out, written
