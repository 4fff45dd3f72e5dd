"""FileStoreTable and its read/write builders.

Counterpart of paimon_tpu/table/table.py for this package's slice:
primary-key tables with fixed, dynamic (bucket -1) or postpone (bucket
-2) buckets, cross-partition upsert, under the deduplicate, first-row,
partial-update and aggregation engines, their changelog producers;
append tables, bucket-unaware (bucket -1) or with fixed buckets by
`bucket-key`, with deletion vectors, append compaction, sort-compact,
row tracking (column updates and deletes by row id) and the sorted
global index;
streaming writes with commit identifiers, stream scans, mesh compaction
(tpu.mesh.compact), bucket rescale, the postpone rescale, row-level
DELETE (-D records on primary-key tables, deletion vectors on append
tables), and the maintenance plane: snapshot and changelog
expiry, tags and auto-tags, branches and fallback reads, incremental
reads, partition expiry and mark-done, orphan clean, fsck and repair,
manifest compaction, commit and tag callbacks, per-file indexes
(file-index.*: written with every data file, skipped by the scan,
retrofitted by maintenance/repair.py rewrite_file_index); data files in
parquet, orc, avro, csv, json or mosaic, BLOB columns in `.blob`
sidecars and VARIANT columns; the system tables, ANALYZE and its
statistics; tables on any registered FileIO (object stores among them)
with the host-SSD cache tier, hedged reads and circuit breakers
(cache.disk.*, read.hedge.*, store.breaker.*) and a request deadline on
reads, plans and commits (request.timeout).  Every table
carries the torch device its merges run on (None means "cuda"; with no
card, pass device="cpu").

reference: table/FileStoreTable.java, table/source/ReadBuilderImpl.java:49
(newScan:190, newRead:241), table/sink/BatchWriteBuilder.java,
TableWriteImpl.java:54, TableCommitImpl.java:78.
"""

from __future__ import annotations

import uuid
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.commit import FileStoreCommit
from paimon_tpu_torch.core.read import MergeFileSplitRead
from paimon_tpu_torch.core.scan import DataSplit, FileStoreScan, ScanPlan
from paimon_tpu_torch.core.write import CommitMessage, KeyValueFileStoreWrite
from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.fs import FileIO, get_file_io
from paimon_tpu_torch.manifest import FileKind
from paimon_tpu_torch.options import CoreOptions, Options
from paimon_tpu_torch.predicate import Predicate
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.schema.schema_manager import SchemaManager
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.snapshot import (
    BranchManager, CommitKind, ConsumerManager, Snapshot, SnapshotManager,
    TagManager,
)
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

__all__ = ["FileStoreTable", "BatchWriteBuilder", "StreamWriteBuilder",
           "ReadBuilder", "TableWrite", "TableCommit", "TableRead",
           "TableScan"]


def _not_ported(feature: str, item: str):
    raise NotImplementedError(
        f"{feature} is not ported to paimon_tpu_torch yet "
        f"(ROADMAP.md: {item})")


def check_writable(options: CoreOptions) -> None:
    """Raise NotImplementedError for write and compaction options this
    package does not yet honor (a table with them still reads)."""
    # read by no scan of either package
    if options.options.contains(CoreOptions.FILE_INDEX_READ_ENABLED.key):
        _not_ported(CoreOptions.FILE_INDEX_READ_ENABLED.key, "A.8.6b")
    # read by no writer of either package yet: a cap on dynamic buckets
    # and an expiry of the cross-partition index
    if options.get(CoreOptions.DYNAMIC_BUCKET_MAX_BUCKETS) != -1:
        _not_ported(CoreOptions.DYNAMIC_BUCKET_MAX_BUCKETS.key, "A.8.3b")
    if options.get(CoreOptions.CROSS_PARTITION_UPSERT_INDEX_TTL):
        _not_ported(CoreOptions.CROSS_PARTITION_UPSERT_INDEX_TTL.key,
                    "A.8.3b")
    # read by no writer of either package yet: blob sidecar layout and
    # variant shredding
    for key in (CoreOptions.BLOB_FIELD, CoreOptions.BLOB_TARGET_FILE_SIZE,
                CoreOptions.BLOB_AS_DESCRIPTOR,
                CoreOptions.VARIANT_SHREDDING_SCHEMA,
                CoreOptions.VARIANT_INFER_SHREDDING_SCHEMA,
                CoreOptions.VARIANT_SHREDDING_MAX_INFER_BUFFER_ROW,
                CoreOptions.VARIANT_SHREDDING_MAX_SCHEMA_DEPTH,
                CoreOptions.VARIANT_SHREDDING_MAX_SCHEMA_WIDTH,
                CoreOptions.VARIANT_SHREDDING_MIN_FIELD_CARDINALITY_RATIO):
        if options.options.contains(key.key):
            _not_ported(key.key, "A.8.8b")
    check_expirable(options)


def check_expirable(options: CoreOptions) -> None:
    """Refuse the expiry bounds that neither package's expiry reads: a
    cap on snapshots expired per pass and an age bound on decoupled
    changelogs."""
    for key in (CoreOptions.SNAPSHOT_EXPIRE_LIMIT,
                CoreOptions.CHANGELOG_TIME_RETAINED):
        if options.options.contains(key.key):
            _not_ported(key.key, "A.8.4b")


class FileStoreTable:
    """A primary-key or append table backed by the file store at `path`,
    merging and sorting on `device`."""

    def __init__(self, file_io: FileIO, path: str,
                 table_schema: TableSchema,
                 dynamic_options: Optional[Dict[str, str]] = None,
                 device=None, branch: str = "main"):
        self.path = path.rstrip("/")
        opts = dict(table_schema.options)
        if dynamic_options:
            opts.update({k: str(v) for k, v in dynamic_options.items()})
        self.schema = table_schema.copy(opts) \
            if dynamic_options else table_schema
        self.options = CoreOptions(Options(opts))
        self.device = resolve_device(device)
        if self.options.get(CoreOptions.STORE_BREAKER_ENABLED) or \
                self.options.get(CoreOptions.READ_HEDGE_ENABLED):
            # tail tolerance sits closest to the store, under the
            # caching wrap below: cache hits never pay breaker or hedge
            # accounting, and every real store attempt does
            from paimon_tpu_torch.fs.resilience import maybe_wrap_resilience
            file_io = maybe_wrap_resilience(file_io, self.options)
        disk_dir = self.options.get(CoreOptions.CACHE_DISK_DIR)
        if self.options.get(CoreOptions.READ_CACHE_RANGE) or disk_dir:
            from paimon_tpu_torch.fs.caching import (
                CachingFileIO, shared_cache_state, shared_disk_tier,
            )
            range_bytes = self.options.get(
                CoreOptions.READ_CACHE_RANGE_MAX_BYTES) \
                if self.options.get(CoreOptions.READ_CACHE_RANGE) else 0
            if not isinstance(file_io, CachingFileIO):
                # range-only: whole-file capacity 0 keeps read_bytes a
                # pass-through; ranged reads hit the process-wide tier.
                # With cache.disk.dir set, memory misses (capacity 0:
                # every whole-file read) demote to the host-SSD tier and
                # are served from it before the store
                file_io = CachingFileIO(
                    file_io, capacity_bytes=0,
                    range_cache_bytes=range_bytes,
                    state=shared_cache_state(0, range_bytes))
            if disk_dir:
                file_io.state.attach_disk(
                    shared_disk_tier(disk_dir, self.options.get(
                        CoreOptions.CACHE_DISK_MAX_BYTES)),
                    promote_hits=self.options.get(
                        CoreOptions.CACHE_DISK_PROMOTE_HITS))
        self.file_io = file_io
        self.branch = branch if branch != "main" else self.options.branch
        self.snapshot_manager = SnapshotManager(file_io, self.path,
                                                self.branch)
        self.schema_manager = SchemaManager(file_io, self.path, self.branch)
        self.tag_manager = TagManager(file_io, self.path)
        self.branch_manager = BranchManager(file_io, self.path)
        self.consumer_manager = ConsumerManager(file_io, self.path)

    # -- creation / loading --------------------------------------------------

    @staticmethod
    def create(path: str, schema: Schema,
               file_io: Optional[FileIO] = None,
               device=None) -> "FileStoreTable":
        dev = resolve_device(device)
        fio = file_io or get_file_io(path)
        ts = SchemaManager(fio, path).create_table(schema)
        return FileStoreTable(fio, path, ts, device=dev)

    @staticmethod
    def load(path: str, file_io: Optional[FileIO] = None,
             dynamic_options: Optional[Dict[str, str]] = None,
             device=None) -> "FileStoreTable":
        dev = resolve_device(device)
        fio = file_io or get_file_io(path)
        branch = "main"
        if dynamic_options and "branch" in dynamic_options:
            branch = dynamic_options["branch"]
        ts = SchemaManager(fio, path, branch).latest()
        if ts is None:
            raise FileNotFoundError(f"No table at {path}")
        return FileStoreTable(fio, path, ts, dynamic_options, device=dev,
                              branch=branch)

    def copy(self, dynamic_options: Dict[str, str]) -> "FileStoreTable":
        base = self.schema_manager.latest()
        return FileStoreTable(self.file_io, self.path, base,
                              dynamic_options, device=self.device,
                              branch=self.branch)

    # -- metadata ------------------------------------------------------------

    @property
    def name(self) -> str:
        return self.path.rstrip("/").split("/")[-1]

    @property
    def primary_keys(self) -> List[str]:
        return self.schema.primary_keys

    @property
    def partition_keys(self) -> List[str]:
        return self.schema.partition_keys

    def row_type(self):
        return self.schema.logical_row_type()

    def arrow_schema(self) -> pa.Schema:
        return self.schema.to_arrow_schema()

    def latest_snapshot(self) -> Optional[Snapshot]:
        return self.snapshot_manager.latest_snapshot()

    # -- builders ------------------------------------------------------------

    def new_batch_write_builder(self) -> "BatchWriteBuilder":
        return BatchWriteBuilder(self)

    def new_read_builder(self) -> "ReadBuilder":
        return ReadBuilder(self)

    def new_scan(self) -> FileStoreScan:
        return FileStoreScan(self.file_io, self.path, self.schema,
                             self.options, self.branch)

    def new_distributed_write(self, base_user: str = "writer",
                              process_index: Optional[int] = None,
                              process_count: Optional[int] = None):
        """This process's slice of the multi-host write plane
        (parallel/distributed.py): sharded (partition, bucket) ownership
        over the processes of a torch.distributed group, arbitrated
        commits (multihost.commit.arbitration), pinned-snapshot
        cross-host scans and online bucket rescale, on the table's
        device.  process_index/count default from the group
        (parallel/multihost.initialize)."""
        from paimon_tpu_torch.parallel.distributed import (
            DistributedWritePlane,
        )
        return DistributedWritePlane(self, base_user=base_user,
                                     process_index=process_index,
                                     process_count=process_count)

    def sync_iceberg(self, committer=None) -> Optional[str]:
        """Export the current snapshot as Iceberg v2 metadata under
        <table>/metadata/ (reference iceberg/IcebergCommitCallback);
        `committer` also publishes it to an Iceberg REST catalog
        (reference IcebergRestMetadataCommitter).  Raises ValueError,
        writing nothing, where an exported file has rows deleted by a
        deletion vector."""
        from paimon_tpu_torch.iceberg import sync_iceberg
        return sync_iceberg(self, committer=committer)

    def new_stream_write_builder(self) -> "StreamWriteBuilder":
        return StreamWriteBuilder(self)

    def system_table(self, name: str) -> pa.Table:
        """`<table>$<name>` as an Arrow table (reference
        SystemTableLoader)."""
        from paimon_tpu_torch.table.system import load_system_table
        return load_system_table(self, name)

    def analyze(self, columns: Optional[List[str]] = None) -> Optional[int]:
        """ANALYZE TABLE: compute and persist table and column statistics
        (reference stats/StatsFileHandler)."""
        from paimon_tpu_torch.stats import analyze_table
        return analyze_table(self, columns)

    def statistics(self) -> Optional[Dict]:
        from paimon_tpu_torch.stats import read_statistics
        return read_statistics(self)

    # -- convenience ---------------------------------------------------------

    def to_arrow(self, projection: Optional[List[str]] = None,
                 predicate: Optional[Predicate] = None,
                 with_row_ids: bool = False,
                 limit: Optional[int] = None) -> pa.Table:
        # request.timeout's entry point covers the plan too: the
        # manifest walk is store IO and rides the same deadline as the
        # read (TableRead.to_arrow's own scope guards reads of plans
        # built before it)
        from paimon_tpu_torch.utils.deadline import deadline_scope
        with deadline_scope(self.options.get(CoreOptions.REQUEST_TIMEOUT),
                            entry=True):
            rb = self.new_read_builder()
            if projection:
                rb = rb.with_projection(projection)
            if predicate is not None:
                rb = rb.with_filter(predicate)
            if with_row_ids:
                rb = rb.with_row_ids()
            if limit is not None:
                rb = rb.with_limit(limit)
            return rb.new_read().to_arrow(rb.new_scan().plan().splits)

    def compact(self, full: bool = False,
                partition_filter: Optional[dict] = None,
                group_filter=None, commit_user: Optional[str] = None,
                properties: Optional[Dict[str, str]] = None,
                properties_provider=None) -> Optional[int]:
        """Compact every (partition, bucket) and commit the result
        (reference flink CompactAction, engine-free here).
        `group_filter` is a (partition, bucket) -> bool scheduling
        predicate (the sharded maintenance plane passes its ownership
        filter, so each host compacts only its own groups);
        `commit_user`, `properties` and `properties_provider` land on
        the COMPACT snapshot."""
        from paimon_tpu_torch.compact.compact_action import compact_table
        check_writable(self.options)
        return compact_table(self, full=full,
                             partition_filter=partition_filter,
                             group_filter=group_filter,
                             commit_user=commit_user,
                             properties=properties,
                             properties_provider=properties_provider)

    def rescale_buckets(self, new_buckets: int, mesh=None,
                        properties: Optional[Dict[str, str]] = None
                        ) -> Optional[int]:
        """Change a fixed-bucket primary-key table's bucket count: the
        mesh computes the row routing (abs(hash % B) and an all_to_all
        repartition), the host rewrites the files and commits an
        overwrite (reference rescale-bucket procedure via
        ChannelComputer) stamped with `properties` (the distributed
        write plane records its ownership generation so)."""
        from paimon_tpu_torch.parallel.rescale import rescale_table_buckets
        check_writable(self.options)
        return rescale_table_buckets(self, new_buckets, mesh=mesh,
                                     properties=properties)

    def rescale_postpone(self) -> Optional[int]:
        """Move bucket-postpone staging data into real buckets (reference
        postpone/ rescale job; bucket=-2 tables)."""
        from paimon_tpu_torch.compact.compact_action import rescale_postpone
        check_writable(self.options)
        return rescale_postpone(self)

    def sort_compact(self, order_by: List[str],
                     strategy: str = "zorder") -> Optional[int]:
        """Cluster an append table by z-order, Hilbert or lexicographic
        order (reference sort-compact action, sort/zorder/ZIndexer.java),
        the curve keys ranked and sorted on the table's device."""
        from paimon_tpu_torch.compact.compact_action import sort_compact
        check_writable(self.options)
        return sort_compact(self, order_by, strategy)

    def delete_where(self, predicate: Predicate) -> Optional[int]:
        """Row-level DELETE: deletion vectors on append tables, -D
        records on primary-key tables (reference DeleteAction /
        BucketedDvMaintainer)."""
        from paimon_tpu_torch.index.dv_maintainer import delete_where
        return delete_where(self, predicate)

    # -- row tracking / data evolution ---------------------------------------

    def update_columns(self, row_ids, updates) -> Optional[int]:
        """Column-level UPDATE by row id on a row-tracked append table:
        only the touched columns of the touched row ranges are rewritten
        as overlay files (reference append/dataevolution/,
        operation/DataEvolutionSplitRead.java)."""
        from paimon_tpu_torch.core.row_tracking import update_columns
        return update_columns(self, row_ids, updates)

    def delete_by_row_ids(self, row_ids) -> Optional[int]:
        """DELETE by row id: range arithmetic into deletion vectors, no
        data reads (reference row-id keyed append deletion vectors)."""
        from paimon_tpu_torch.core.row_tracking import delete_by_row_ids
        return delete_by_row_ids(self, row_ids)

    def global_index(self, column: str, rebuild: bool = False):
        """Sorted key -> row-id global index over a row-tracked append
        table (reference paimon-common/.../globalindex/sorted/), its
        key sort on the table's device."""
        from paimon_tpu_torch.index.global_index import SortedGlobalIndex
        return SortedGlobalIndex.load_or_build(self, column,
                                               rebuild=rebuild)

    def compact_manifests(self, force: bool = True,
                          commit_user: Optional[str] = None,
                          properties: Optional[Dict[str, str]] = None,
                          properties_provider=None) -> Optional[int]:
        """Manifest full-compaction: fold the accumulated delta
        manifests into sorted, partition-clustered base manifests
        (maintenance/manifest_compact.py).  `force=False` runs only
        when the manifest.full-compaction.threshold trigger fires."""
        from paimon_tpu_torch.maintenance.manifest_compact import (
            compact_manifests,
        )
        return compact_manifests(self, force=force,
                                 commit_user=commit_user,
                                 properties=properties,
                                 properties_provider=properties_provider)

    # -- maintenance ---------------------------------------------------------

    def expire_snapshots(self, retain_max: Optional[int] = None,
                         retain_min: Optional[int] = None,
                         older_than_ms: Optional[int] = None,
                         dry_run: bool = False,
                         min_retained_snapshot_id: Optional[int] = None):
        """reference operation/ExpireSnapshotsImpl.java."""
        from paimon_tpu_torch.maintenance import expire_snapshots
        check_expirable(self.options)
        return expire_snapshots(
            self, retain_max=retain_max, retain_min=retain_min,
            older_than_ms=older_than_ms, dry_run=dry_run,
            min_retained_snapshot_id=min_retained_snapshot_id)

    def remove_orphan_files(self, older_than_ms: Optional[int] = None,
                            dry_run: bool = False,
                            now_ms: Optional[int] = None,
                            incremental: bool = False):
        """reference operation/OrphanFilesClean.java; `incremental`
        rides the last clean sweep's watermark (maintenance/orphan.py)."""
        from paimon_tpu_torch.maintenance import remove_orphan_files
        return remove_orphan_files(self, older_than_ms=older_than_ms,
                                   dry_run=dry_run, now_ms=now_ms,
                                   incremental=incremental)

    def fsck(self, snapshot_id: Optional[int] = None,
             all_snapshots: bool = True, deep: bool = False,
             incremental: bool = False, stamp_watermark: bool = False):
        """Verify the snapshot→manifest→file graph; returns an
        FsckReport of typed violations (maintenance/fsck.py)."""
        from paimon_tpu_torch.maintenance import fsck
        return fsck(self, snapshot_id=snapshot_id,
                    all_snapshots=all_snapshots, deep=deep,
                    incremental=incremental,
                    stamp_watermark=stamp_watermark)

    def expire_partitions(self, expiration_ms: Optional[int] = None,
                          now_ms: Optional[int] = None,
                          dry_run: bool = False):
        """reference operation/PartitionExpire.java."""
        from paimon_tpu_torch.maintenance import expire_partitions
        return expire_partitions(self, expiration_ms=expiration_ms,
                                 now_ms=now_ms, dry_run=dry_run)

    def mark_partitions_done(self, partitions):
        """Run the configured partition.mark-done-action(s) (reference
        flink/procedure/MarkPartitionDoneProcedure.java)."""
        from paimon_tpu_torch.maintenance import mark_partitions_done
        return mark_partitions_done(self, partitions)

    def create_tag(self, name: str, snapshot_id: Optional[int] = None):
        snap = (self.snapshot_manager.snapshot(snapshot_id)
                if snapshot_id is not None
                else self.snapshot_manager.latest_snapshot())
        if snap is None:
            raise ValueError("Table has no snapshot to tag")
        self.tag_manager.create_tag(snap, name)
        self.fire_tag_callbacks(name, snap.id)

    def fire_tag_callbacks(self, name: str, snapshot_id: int):
        """Invoke tag.callbacks (auto-tag creation calls it too)."""
        if not hasattr(self, "_tag_callbacks_cache"):
            from paimon_tpu_torch.utils.callbacks import load_callbacks
            self._tag_callbacks_cache = load_callbacks(
                self.options, "tag.callbacks", "tag.callback.#.param")
        for cb in self._tag_callbacks_cache:
            cb.call(self, name, snapshot_id)

    def delete_tag(self, name: str):
        self.tag_manager.delete_tag(name)

    def create_branch(self, name: str, tag_name: Optional[str] = None):
        snap = self.tag_manager.get_tag(tag_name) if tag_name else None
        self.branch_manager.create_branch(name, from_snapshot=snap)

    def delete_branch(self, name: str):
        self.branch_manager.drop_branch(name)

    def rename_branch(self, old: str, new: str):
        self.branch_manager.rename_branch(old, new)

    def fast_forward(self, branch_name: str):
        self.branch_manager.fast_forward(branch_name)

    def rollback_to(self, snapshot_id: int):
        """Delete snapshots newer than `snapshot_id`
        (reference table/RollbackHelper.java)."""
        latest = self.snapshot_manager.latest_snapshot_id()
        if latest is None or snapshot_id > latest:
            raise ValueError(f"Cannot rollback to {snapshot_id}")
        if not self.snapshot_manager.snapshot_exists(snapshot_id):
            raise ValueError(f"Snapshot {snapshot_id} does not exist")
        for i in range(latest, snapshot_id, -1):
            self.snapshot_manager.delete_snapshot(i)
        self.snapshot_manager.commit_latest_hint(snapshot_id)


class BatchWriteBuilder:
    def __init__(self, table: FileStoreTable):
        self.table = table
        self.commit_user = str(uuid.uuid4())
        self._overwrite: Optional[dict] = None

    def with_overwrite(self, static_partition: Optional[dict] = None
                       ) -> "BatchWriteBuilder":
        self._overwrite = static_partition or {}
        return self

    def new_write(self, apply_defaults: bool = True) -> "TableWrite":
        return TableWrite(self.table, self.commit_user, apply_defaults)

    def new_commit(self) -> "TableCommit":
        return TableCommit(self.table, self.commit_user, self._overwrite)


class StreamWriteBuilder:
    """Checkpoint-driven streaming writes with exactly-once commits keyed
    by commit identifier (reference table/sink/StreamWriteBuilder.java +
    flink/sink/CommitterOperator.java:196: on checkpoint complete, commit
    every pending identifier not yet committed by this user).

    Usage:
        wb = table.new_stream_write_builder().with_commit_user("job-7")
        w, c = wb.new_write(), wb.new_commit()
        w.write_arrow(batch); msgs = w.prepare_commit()
        c.commit(msgs, commit_identifier=checkpoint_id)
        # on recovery: replay pending checkpoints through
        # c.filter_committed([...]) to drop already-committed ones
    """

    def __init__(self, table: FileStoreTable):
        self.table = table
        self.commit_user = str(uuid.uuid4())

    def with_commit_user(self, commit_user: str) -> "StreamWriteBuilder":
        """A STABLE user id is what makes replay dedup work across
        restarts; defaults to a random uuid like the reference."""
        self.commit_user = commit_user
        return self

    def new_write(self) -> "TableWrite":
        return TableWrite(self.table, self.commit_user)

    def new_commit(self) -> "TableCommit":
        return TableCommit(self.table, self.commit_user)


class TableWrite:
    def __init__(self, table: FileStoreTable, commit_user: str,
                 apply_defaults: bool = True):
        check_writable(table.options)
        self.table = table
        self._apply_defaults = apply_defaults
        scan = table.new_scan()

        def restore(partition: Tuple, bucket: int) -> int:
            return scan.max_sequence_number(partition, bucket)

        def bucket_files_map():
            snapshot = table.snapshot_manager.latest_snapshot()
            if snapshot is None:
                return {}
            out = {}
            for e in scan.read_entries(snapshot):
                part = scan._partition_codec.from_bytes(e.partition)
                out.setdefault((part, e.bucket), []).append(e.file)
            return out

        if not table.primary_keys:
            from paimon_tpu_torch.core.append import (
                AppendOnlyFileStoreWrite,
            )
            self._write = AppendOnlyFileStoreWrite(
                table.file_io, table.path, table.schema, table.options,
                restore_max_seq=restore)
            return
        self._write = KeyValueFileStoreWrite(
            table.file_io, table.path, table.schema, table.options,
            restore_max_seq=restore, branch=table.branch,
            bucket_files_map=bucket_files_map,
            schema_manager=table.schema_manager, device=table.device)
        if table.schema.cross_partition_update():
            # pk does not cover the partition keys: route partition
            # changes as -D old + +I new via the global index
            # (reference crosspartition/GlobalIndexAssigner)
            from paimon_tpu_torch.core.cross_partition import (
                CrossPartitionUpsertWrite,
            )
            self._write = CrossPartitionUpsertWrite(self._write, table)

    def write_arrow(self, data: pa.Table,
                    row_kinds: Optional[np.ndarray] = None,
                    buckets=None):
        data = self._apply_field_defaults(data)
        if buckets is not None:
            self._write.write_arrow(data, row_kinds, buckets=buckets)
        else:
            self._write.write_arrow(data, row_kinds)

    def _apply_field_defaults(self, data: pa.Table) -> pa.Table:
        """NULL incoming values become the column's configured default
        (fields.<col>.default-value — reference DefaultValueRow applied
        on the write path)."""
        if not self._apply_defaults:
            return data
        defaults = self.table.options.field_default_values()
        if not defaults:
            return data
        import pyarrow.compute as pc
        schema = self.table.arrow_schema()
        for col, raw in defaults.items():
            if col not in data.column_names:
                continue
            arr = data.column(col)
            if arr.null_count == 0:
                continue
            scalar = pa.scalar(raw).cast(schema.field(col).type)
            data = data.set_column(data.column_names.index(col), col,
                                   pc.fill_null(arr, scalar))
        return data

    def set_delta_listener(self, listener):
        """Serving-plane hook (service/delta.py): `listener(partition,
        bucket, table, kinds, seqs)` fires for every buffered batch on
        the writing thread, after sequence reservation.  The
        cross-partition writer has no such hook (the serving writer
        refuses those tables first)."""
        if not isinstance(self._write, KeyValueFileStoreWrite):
            raise ValueError(
                "delta listener requires the primary-key write path")
        self._write.delta_listener = listener

    def write_dicts(self, rows: Sequence[dict],
                    row_kinds: Optional[Sequence[int]] = None):
        from paimon_tpu_torch.core.write import dicts_to_arrow
        table, kinds = dicts_to_arrow(self.table.arrow_schema(), rows,
                                      row_kinds)
        self.write_arrow(table, kinds)

    def prepare_commit(self) -> List[CommitMessage]:
        """Barrier over the flush pool: drains every in-flight bucket
        flush, re-raising the first worker error, then returns the
        accumulated commit messages."""
        return self._write.prepare_commit()

    def close(self):
        """Shuts down the flush pool (joining its workers).  Always
        call close, also on failure; prefer ``with wb.new_write() as
        w: ...``."""
        self._write.close()

    def __enter__(self) -> "TableWrite":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TableCommit:
    def __init__(self, table: FileStoreTable, commit_user: str,
                 overwrite: Optional[dict] = None):
        self.table = table
        self._commit = FileStoreCommit(
            table.file_io, table.path, table.schema, table.options,
            commit_user=commit_user, branch=table.branch)
        self._overwrite = overwrite
        self._callbacks = None        # loaded lazily, once

    def commit(self, messages: Sequence[CommitMessage],
               commit_identifier: int = BATCH_COMMIT_IDENTIFIER,
               watermark: Optional[int] = None,
               properties: Optional[Dict[str, str]] = None
               ) -> Optional[int]:
        """Commit the messages as one snapshot; returns its id, or None
        for an ignored empty batch commit.  `watermark` (epoch millis)
        records event-time progress in the snapshot — it only ever
        advances — and drives watermark-mode auto-tags.  `properties`
        are stored on the snapshot itself (ignored on the overwrite
        path).  After a snapshot lands: auto-tags, `commit.callbacks`,
        and `partition.end-input-to-done` for a batch commit.

        A configured `request.timeout` installs an end-to-end deadline
        (entry point): retry and CAS backoffs stop sleeping once it is
        spent and the snapshot CAS is never attempted past it, so a
        timed-out commit raises instead of orphan-committing."""
        from paimon_tpu_torch.utils.deadline import deadline_scope
        with deadline_scope(self.table.options.get(
                CoreOptions.REQUEST_TIMEOUT), entry=True):
            return self._commit_with_deadline(
                messages, commit_identifier, watermark, properties)

    def _commit_with_deadline(self, messages, commit_identifier,
                              watermark, properties) -> Optional[int]:
        # empty batch commits produce no snapshot unless forced
        # (reference snapshot.ignore-empty-commit, default on for batch
        # writers; streaming keeps empty snapshots for exactly-once
        # progress tracking)
        index_entries = [e for m in messages for e in m.index_entries]
        ignore_empty = self.table.options.get(
            CoreOptions.SNAPSHOT_IGNORE_EMPTY_COMMIT)
        if ignore_empty is None:
            ignore_empty = commit_identifier == BATCH_COMMIT_IDENTIFIER
        if ignore_empty and not messages and self._overwrite is None \
                and not self.table.options.get(
                    CoreOptions.COMMIT_FORCE_CREATE_SNAPSHOT):
            return None
        if self._overwrite is not None:
            sid = self._commit.overwrite(
                messages, partition_filter=self._overwrite or None,
                commit_identifier=commit_identifier,
                index_entries=index_entries or None,
                watermark=watermark)
        else:
            sid = self._commit.commit(
                messages, commit_identifier,
                index_entries=index_entries or None,
                properties=properties,
                # a streaming empty commit still snapshots so the
                # identifier is durable for exactly-once replay dedup
                force_create=not ignore_empty,
                watermark=watermark)
        if sid is None:
            return None
        if self.table.options.get(
                CoreOptions.TAG_AUTOMATIC_CREATION) not in (None, "none"):
            # reference TagAutoManager rides the commit callback
            from paimon_tpu_torch.maintenance.tag_auto import (
                maybe_create_tags,
            )
            maybe_create_tags(self.table)
        # user commit callbacks run post-CAS (reference CommitCallback
        # via commit.callbacks), loaded once per TableCommit
        if self._callbacks is None:
            from paimon_tpu_torch.utils.callbacks import load_callbacks
            self._callbacks = load_callbacks(
                self.table.options, "commit.callbacks",
                "commit.callback.#.param")
        for cb in self._callbacks:
            cb.call(self.table, sid, messages)
        if commit_identifier == BATCH_COMMIT_IDENTIFIER and \
                self.table.schema.partition_keys and \
                self.table.options.get(
                    CoreOptions.PARTITION_END_INPUT_TO_DONE):
            # a finished batch input marks its partitions done; raw
            # partition tuples, so mark_partitions_done applies
            # partition.default-name to null values
            parts = {tuple(m.partition) for m in messages if m.partition}
            if parts:
                self.table.mark_partitions_done(sorted(parts))
        return sid

    def filter_committed(self, identifiers: Sequence[int]) -> List[int]:
        return self._commit.filter_committed(identifiers)

    def close(self):
        pass


class ReadBuilder:
    """reference table/source/ReadBuilderImpl.java:49."""

    def __init__(self, table: FileStoreTable):
        self.table = table
        self._projection: Optional[List[str]] = None
        self._predicate: Optional[Predicate] = None
        self._partition_filter: Optional[dict] = None
        self._buckets: Optional[List[int]] = None
        self._limit: Optional[int] = None
        self._with_row_ids = False

    def with_projection(self, columns: List[str]) -> "ReadBuilder":
        self._projection = list(columns)
        return self

    def with_filter(self, predicate: Predicate) -> "ReadBuilder":
        self._predicate = predicate
        return self

    def with_partition_filter(self, spec: dict) -> "ReadBuilder":
        self._partition_filter = spec
        return self

    def with_buckets(self, buckets: List[int]) -> "ReadBuilder":
        self._buckets = buckets
        return self

    def with_limit(self, limit: int) -> "ReadBuilder":
        self._limit = limit
        return self

    def with_row_ids(self, flag: bool = True) -> "ReadBuilder":
        """Materialise `_ROW_ID` on append-table reads (row tracking)."""
        self._with_row_ids = flag
        return self

    def new_scan(self) -> "TableScan":
        return TableScan(self)

    def new_stream_scan(self):
        from paimon_tpu_torch.table.stream_scan import DataTableStreamScan
        return DataTableStreamScan(self)

    def new_read(self) -> "TableRead":
        return TableRead(self)

    def read_type(self):
        rt = self.table.row_type()
        if self._projection:
            return rt.project(self._projection)
        return rt


def with_fallback_partitions(table, plan: ScanPlan,
                             fallback_branch: str,
                             partition_filter=None, predicate=None,
                             buckets=None) -> ScanPlan:
    """Partition-level branch fallback: partitions with no data in the
    current branch read from `scan.fallback-branch` instead (reference
    table/FallbackReadFileStoreTable.java — e.g. a streaming branch
    backfilled by a batch branch).  Shared by batch scans and the
    streaming initial full load."""
    fb = FileStoreTable.load(
        table.path, table.file_io,
        dynamic_options={"branch": fallback_branch,
                         "scan.fallback-branch": ""},
        device=table.device)
    rb = fb.new_read_builder()
    if partition_filter:
        rb = rb.with_partition_filter(partition_filter)
    if predicate is not None:
        rb = rb.with_filter(predicate)
    if buckets:
        rb = rb.with_buckets(buckets)
    fb_plan = rb.new_scan().plan()
    have = {tuple(s.partition) for s in plan.splits}
    extra = [dc_replace(s, for_streaming=plan.streaming)
             for s in fb_plan.splits
             if tuple(s.partition) not in have]
    return ScanPlan(plan.snapshot_id, list(plan.splits) + extra,
                    streaming=plan.streaming)


class TableScan:
    def __init__(self, builder: ReadBuilder):
        self.builder = builder
        self._scan = builder.table.new_scan()
        if builder._partition_filter:
            self._scan.with_partition_filter(builder._partition_filter)
        if builder._buckets:
            self._scan.with_buckets(builder._buckets)
        if builder._predicate is not None:
            pk = set(builder.table.schema.trimmed_primary_keys())
            fields = set(builder._predicate.fields())
            if fields and fields <= pk:
                self._scan.with_key_filter(builder._predicate)
            else:
                self._scan.with_value_filter(builder._predicate)

    def plan(self, snapshot_id: Optional[int] = None,
             tag_name: Optional[str] = None) -> ScanPlan:
        table = self.builder.table
        snapshot = None
        opts = table.options
        between = opts.get(CoreOptions.INCREMENTAL_BETWEEN)
        if between is not None:
            return self._plan_incremental(between)
        tag_to_snap = opts.get(
            CoreOptions.INCREMENTAL_BETWEEN_TAG_TO_SNAPSHOT)
        if tag_to_snap is not None:
            return self._plan_incremental_tag_diff(tag_to_snap)
        if tag_name is None:
            tag_name = opts.get(CoreOptions.SCAN_TAG_NAME)
        if snapshot_id is None:
            snapshot_id = opts.get(CoreOptions.SCAN_SNAPSHOT_ID)
        ts_millis = opts.get(CoreOptions.SCAN_TIMESTAMP_MILLIS)
        if tag_name is not None:
            snapshot = table.tag_manager.get_tag(tag_name)
        elif snapshot_id is not None:
            snapshot = table.snapshot_manager.snapshot(snapshot_id)
        elif ts_millis is not None:
            snapshot = table.snapshot_manager.earlier_or_equal_time_mills(
                ts_millis)
            if snapshot is None:
                return ScanPlan(None, [])
        plan = self._scan.plan(snapshot)
        fallback = opts.get(CoreOptions.SCAN_FALLBACK_BRANCH)
        if fallback and fallback != table.branch:
            b = self.builder
            plan = with_fallback_partitions(
                table, plan, fallback, partition_filter=b._partition_filter,
                predicate=b._predicate, buckets=b._buckets)
        if opts.get(CoreOptions.SCAN_PLAN_SORT_PARTITION):
            # raw partition values (typed order, not lexicographic str);
            # None sorts first within its position
            plan = ScanPlan(
                plan.snapshot_id,
                sorted(plan.splits,
                       key=lambda s: tuple((v is not None, v)
                                           for v in s.partition)),
                streaming=plan.streaming)
        return plan

    def _plan_incremental(self, between: str) -> ScanPlan:
        """Batch incremental read of the deltas in (start, end]
        (reference IncrementalStartingScanner; option
        incremental-between='start,end' — snapshot ids or tag names).
        The range's delta entries are grouped per bucket, so a key
        updated twice in the range merges to one row."""
        table = self.builder.table

        def resolve(token: str) -> int:
            token = token.strip()
            if token.lstrip("-").isdigit():
                return int(token)
            return table.tag_manager.get_tag(token).id

        parts = between.split(",")
        if len(parts) != 2:
            raise ValueError("incremental-between must be 'start,end'")
        start, end = resolve(parts[0]), resolve(parts[1])
        if end < start:
            raise ValueError(f"incremental-between end {end} < start "
                             f"{start}")
        sm = table.snapshot_manager
        earliest = sm.earliest_snapshot_id()
        latest = sm.latest_snapshot_id()
        if latest is None or end > latest or \
                (earliest is not None and start + 1 < earliest):
            raise ValueError(
                f"incremental-between ({start}, {end}] outside the "
                f"available snapshot range [{earliest}, {latest}]")
        entries = []
        snap = None
        for sid in range(start + 1, end + 1):
            snap = sm.snapshot(sid)
            if snap.commit_kind != CommitKind.APPEND:
                continue
            metas = self._scan.manifest_list.read(
                snap.delta_manifest_list)
            entries.extend(e for e in self._scan._read_manifests(metas)
                           if e.kind == FileKind.ADD)
        if snap is None:
            # an empty range, whose end may have expired
            return ScanPlan(end, [])
        # the end snapshot's deletion vectors mask the range's files
        return ScanPlan(end, self._scan.generate_splits(snap, entries))

    def _plan_incremental_tag_diff(self, spec: str) -> ScanPlan:
        """'tagName,endSnapshotId': the data-file diff between the tag's
        pinned snapshot and the end snapshot, which survives the expiry
        of every snapshot between them (reference
        IncrementalTagStartingScanner).  The first token is always a tag
        name."""
        table = self.builder.table
        parts = spec.split(",")
        if len(parts) != 2:
            raise ValueError(
                "incremental-between-tag-to-snapshot must be "
                "'tagName,snapshotId'")
        tag_snap = table.tag_manager.get_tag(parts[0].strip())
        end = int(parts[1].strip())
        if end < tag_snap.id:
            raise ValueError(
                f"end snapshot {end} predates tag "
                f"{parts[0].strip()!r} (snapshot {tag_snap.id})")
        end_snap = table.snapshot_manager.snapshot(end)
        base = {(e.partition, e.bucket, e.file.file_name)
                for e in self._scan.read_entries(tag_snap)}
        entries = [e for e in self._scan.read_entries(end_snap)
                   if (e.partition, e.bucket, e.file.file_name)
                   not in base]
        return ScanPlan(end, self._scan.generate_splits(end_snap, entries))


class TableRead:
    def __init__(self, builder: ReadBuilder):
        self.builder = builder
        table = builder.table
        if table.primary_keys:
            self._read = MergeFileSplitRead(
                table.file_io, table.path, table.schema, table.options,
                schema_manager=table.schema_manager, device=table.device)
        else:
            from paimon_tpu_torch.core.append import AppendSplitRead
            self._read = AppendSplitRead(
                table.file_io, table.path, table.schema, table.options,
                schema_manager=table.schema_manager, device=table.device)
            self._read.with_row_ids(builder._with_row_ids)
        if builder._projection:
            self._read.with_projection(builder._projection)
        if builder._predicate is not None:
            self._read.with_filter(builder._predicate)

    def read_split(self, split: DataSplit) -> pa.Table:
        return self._finalize(self._read.read_split(split))

    def iter_splits(self, splits, *, ordered: bool = True):
        """Yield `(index, split, finalized_table)` through the bounded
        prefetch pipeline (parallel/scan_pipeline.py).  Accepts a
        ScanPlan or a list of DataSplits; `ordered=False` yields splits
        in completion order for throughput-only consumers."""
        if isinstance(splits, ScanPlan):
            splits = splits.splits
        for i, s, t in self._read.iter_splits(splits, ordered=ordered):
            # a with_limit() bound applies to the whole read (to_arrow),
            # not to each yielded split table
            yield i, s, self._finalize(t, apply_limit=False)

    def to_arrow(self, splits) -> pa.Table:
        """Accepts a ScanPlan or a list of DataSplits.  A configured
        `request.timeout` installs an end-to-end deadline here (entry
        point; an already-active request deadline wins)."""
        from paimon_tpu_torch.utils.deadline import deadline_scope
        with deadline_scope(self.builder.table.options.get(
                CoreOptions.REQUEST_TIMEOUT), entry=True):
            return self._to_arrow(splits)

    def _to_arrow(self, splits) -> pa.Table:
        if isinstance(splits, ScanPlan):
            split_list, streaming = splits.splits, splits.streaming
        else:
            split_list, streaming = list(splits), None
        limit = self.builder._limit
        if limit is not None and split_list:
            # early exit: stop admitting splits once enough rows are
            # buffered — closing the generator cancels pending reads
            tables, n = [], 0
            for _, _, t in self._read.iter_splits(split_list):
                if t.num_rows:
                    tables.append(t)
                    n += t.num_rows
                if n >= limit:
                    break
            if streaming is None:
                streaming = any(s.for_streaming for s in split_list)
            out = pa.concat_tables(tables, promote_options="default") \
                if tables else self._read.read_splits([], streaming)
        else:
            out = self._read.read_splits(split_list, streaming)
        return self._finalize(out)

    def _finalize(self, t: pa.Table,
                  apply_limit: bool = True) -> pa.Table:
        if self.builder._projection:
            from paimon_tpu_torch.core.read import ROW_KIND_COL
            from paimon_tpu_torch.core.row_tracking import ROW_ID_COL
            cols = [c for c in self.builder._projection
                    if c in t.column_names]
            if ROW_KIND_COL in t.column_names:
                cols.append(ROW_KIND_COL)
            if ROW_ID_COL in t.column_names and self.builder._with_row_ids:
                cols.append(ROW_ID_COL)
            t = t.select(cols)
        if apply_limit and self.builder._limit is not None:
            t = t.slice(0, self.builder._limit)
        return t

    def to_pandas(self, splits: Sequence[DataSplit]):
        return self.to_arrow(splits).to_pandas()
