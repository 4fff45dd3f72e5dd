"""FileStoreTable and its read/write builders.

Counterpart of paimon_tpu/table/table.py for this package's slice:
primary-key tables with fixed buckets under the deduplicate, first-row,
partial-update and aggregation engines, their changelog producers,
streaming writes with commit identifiers, stream scans, mesh compaction
(tpu.mesh.compact) and bucket rescale.  Every table
carries the torch device its merges run on (None means "cuda"; with no
card, pass device="cpu").

reference: table/FileStoreTable.java, table/source/ReadBuilderImpl.java:49
(newScan:190, newRead:241), table/sink/BatchWriteBuilder.java,
TableWriteImpl.java:54, TableCommitImpl.java:78.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.commit import FileStoreCommit
from paimon_tpu_torch.core.read import MergeFileSplitRead
from paimon_tpu_torch.core.scan import DataSplit, FileStoreScan, ScanPlan
from paimon_tpu_torch.core.write import CommitMessage, KeyValueFileStoreWrite
from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.fs import FileIO, get_file_io
from paimon_tpu_torch.options import (
    ChangelogProducer, CoreOptions, Options,
)
from paimon_tpu_torch.predicate import Predicate
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.schema.schema_manager import SchemaManager
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.snapshot import (
    ConsumerManager, Snapshot, SnapshotManager,
)
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

__all__ = ["FileStoreTable", "BatchWriteBuilder", "StreamWriteBuilder",
           "ReadBuilder", "TableWrite", "TableCommit", "TableRead",
           "TableScan"]


def _not_ported(feature: str, item: str):
    raise NotImplementedError(
        f"{feature} is not ported to paimon_tpu_torch yet "
        f"(ROADMAP.md: {item})")


def check_readable(schema: TableSchema, options: CoreOptions,
                   branch: str = "main") -> None:
    """Raise NotImplementedError for a table whose reads this package
    cannot yet serve, naming the ROADMAP.md item that will port it."""
    if not schema.primary_keys:
        _not_ported("append tables (no primary key)", "the remaining planes")
    if options.bucket < 1:
        _not_ported(f"bucket={options.bucket} (dynamic or postpone "
                    f"buckets)", "the remaining planes")
    if schema.cross_partition_update():
        _not_ported("cross-partition upsert (primary key without the "
                    "partition keys)", "the remaining planes")
    if options.get(CoreOptions.DELETION_VECTORS_ENABLED):
        _not_ported("deletion vectors", "the remaining planes")
    if options.get(CoreOptions.ROW_TRACKING_ENABLED):
        _not_ported("row tracking", "the remaining planes")
    if branch != "main":
        _not_ported("branches", "the remaining planes")
    for key in (CoreOptions.SCAN_TAG_NAME, CoreOptions.INCREMENTAL_BETWEEN,
                CoreOptions.SCAN_FALLBACK_BRANCH,
                CoreOptions.SCAN_IGNORE_CORRUPT_FILES,
                CoreOptions.REQUEST_TIMEOUT):
        if options.get(key):
            _not_ported(key.key, "the remaining planes")
    # the host-SSD cache tier and hedged store reads
    for key in (CoreOptions.CACHE_DISK_DIR, CoreOptions.READ_HEDGE_ENABLED):
        if options.get(key):
            _not_ported(key.key, "A.7b")
    _refuse_prefix(options, "read.retry.")


def _refuse_prefix(options: CoreOptions, prefix: str) -> None:
    """Refuse every set key under `prefix`: the reference reads these
    retry knobs, which this package does not define yet."""
    for key in options.options.keys():
        if key.startswith(prefix):
            _not_ported(key, "the remaining planes")


def check_writable(options: CoreOptions) -> None:
    """Raise NotImplementedError for write and compaction options this
    package does not yet honor (a table with them still reads)."""
    for key in (CoreOptions.WRITE_BUFFER_SPILLABLE,
                CoreOptions.PARTITION_END_INPUT_TO_DONE,
                CoreOptions.WRITE_STAGE_DIR):
        if options.get(key):
            _not_ported(key.key, "the remaining planes")
    _refuse_prefix(options, "write.retry.")
    if options.get(CoreOptions.LOCAL_MERGE_BUFFER_SIZE):
        if options.changelog_producer == ChangelogProducer.INPUT:
            raise ValueError(
                "local-merge-buffer-size folds input rows, which "
                "would drop changelog-producer=input events")
        _not_ported("local-merge-buffer-size", "the remaining planes")
    if options.file_index_spec:
        _not_ported("file indexes", "the remaining planes")
    if options.get(CoreOptions.TAG_AUTOMATIC_CREATION) != "none":
        _not_ported("tag.automatic-creation", "the remaining planes")
    if options.get(CoreOptions.COMMIT_CALLBACKS):
        _not_ported("commit.callbacks", "the remaining planes")


class FileStoreTable:
    """A primary-key table backed by the file store at `path`, merging
    on `device`."""

    def __init__(self, file_io: FileIO, path: str,
                 table_schema: TableSchema,
                 dynamic_options: Optional[Dict[str, str]] = None,
                 device=None):
        self.path = path.rstrip("/")
        opts = dict(table_schema.options)
        if dynamic_options:
            opts.update({k: str(v) for k, v in dynamic_options.items()})
        self.schema = table_schema.copy(opts) \
            if dynamic_options else table_schema
        self.options = CoreOptions(Options(opts))
        self.branch = self.options.branch
        check_readable(self.schema, self.options, self.branch)
        self.device = resolve_device(device)
        if self.options.get(CoreOptions.READ_CACHE_RANGE):
            from paimon_tpu_torch.fs.caching import (
                CachingFileIO, shared_cache_state,
            )
            if not isinstance(file_io, CachingFileIO):
                # range-only: whole-file capacity 0 keeps read_bytes a
                # pass-through; ranged reads hit the process-wide tier
                range_bytes = self.options.get(
                    CoreOptions.READ_CACHE_RANGE_MAX_BYTES)
                file_io = CachingFileIO(
                    file_io, capacity_bytes=0,
                    range_cache_bytes=range_bytes,
                    state=shared_cache_state(0, range_bytes))
        self.file_io = file_io
        self.snapshot_manager = SnapshotManager(file_io, self.path,
                                                self.branch)
        self.schema_manager = SchemaManager(file_io, self.path, self.branch)
        self.consumer_manager = ConsumerManager(file_io, self.path)

    # -- creation / loading --------------------------------------------------

    @staticmethod
    def create(path: str, schema: Schema,
               file_io: Optional[FileIO] = None,
               device=None) -> "FileStoreTable":
        dev = resolve_device(device)
        fio = file_io or get_file_io(path)
        sm = SchemaManager(fio, path)
        ts = TableSchema.from_schema(0, schema)
        check_readable(ts, CoreOptions(Options(dict(ts.options))))
        ts = sm.create_table(schema)
        return FileStoreTable(fio, path, ts, device=dev)

    @staticmethod
    def load(path: str, file_io: Optional[FileIO] = None,
             dynamic_options: Optional[Dict[str, str]] = None,
             device=None) -> "FileStoreTable":
        dev = resolve_device(device)
        fio = file_io or get_file_io(path)
        ts = SchemaManager(fio, path).latest()
        if ts is None:
            raise FileNotFoundError(f"No table at {path}")
        return FileStoreTable(fio, path, ts, dynamic_options, device=dev)

    def copy(self, dynamic_options: Dict[str, str]) -> "FileStoreTable":
        base = self.schema_manager.latest()
        return FileStoreTable(self.file_io, self.path, base,
                              dynamic_options, device=self.device)

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

    def new_stream_write_builder(self) -> "StreamWriteBuilder":
        return StreamWriteBuilder(self)

    def system_table(self, name: str):
        _not_ported("system tables", "the remaining planes")

    def create_tag(self, name: str, snapshot_id: Optional[int] = None):
        _not_ported("tags", "the remaining planes")

    def create_branch(self, name: str, tag_name: Optional[str] = None):
        _not_ported("branches", "the remaining planes")

    # -- convenience ---------------------------------------------------------

    def to_arrow(self, projection: Optional[List[str]] = None,
                 predicate: Optional[Predicate] = None,
                 limit: Optional[int] = None) -> pa.Table:
        rb = self.new_read_builder()
        if projection:
            rb = rb.with_projection(projection)
        if predicate is not None:
            rb = rb.with_filter(predicate)
        if limit is not None:
            rb = rb.with_limit(limit)
        return rb.new_read().to_arrow(rb.new_scan().plan().splits)

    def compact(self, full: bool = False,
                partition_filter: Optional[dict] = None) -> Optional[int]:
        """Compact every (partition, bucket) and commit the result
        (reference flink CompactAction, engine-free here)."""
        from paimon_tpu_torch.compact.compact_action import compact_table
        check_writable(self.options)
        return compact_table(self, full=full,
                             partition_filter=partition_filter)

    def rescale_buckets(self, new_buckets: int, mesh=None
                        ) -> Optional[int]:
        """Change a fixed-bucket primary-key table's bucket count: the
        mesh computes the row routing (abs(hash % B) and an all_to_all
        repartition), the host rewrites the files and commits an
        overwrite (reference rescale-bucket procedure via
        ChannelComputer)."""
        from paimon_tpu_torch.parallel.rescale import rescale_table_buckets
        check_writable(self.options)
        return rescale_table_buckets(self, new_buckets, mesh=mesh)


class BatchWriteBuilder:
    def __init__(self, table: FileStoreTable):
        self.table = table
        self.commit_user = str(uuid.uuid4())
        self._overwrite: Optional[dict] = None

    def with_overwrite(self, static_partition: Optional[dict] = None
                       ) -> "BatchWriteBuilder":
        self._overwrite = static_partition or {}
        return self

    def new_write(self) -> "TableWrite":
        return TableWrite(self.table, self.commit_user)

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
    def __init__(self, table: FileStoreTable, commit_user: str):
        check_writable(table.options)
        self.table = table
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

        self._write = KeyValueFileStoreWrite(
            table.file_io, table.path, table.schema, table.options,
            restore_max_seq=restore, bucket_files_map=bucket_files_map,
            schema_manager=table.schema_manager, device=table.device)

    def write_arrow(self, data: pa.Table,
                    row_kinds: Optional[np.ndarray] = None):
        self._write.write_arrow(self._apply_field_defaults(data), row_kinds)

    def _apply_field_defaults(self, data: pa.Table) -> pa.Table:
        """NULL incoming values become the column's configured default
        (fields.<col>.default-value — reference DefaultValueRow applied
        on the write path)."""
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
        the writing thread, after sequence reservation."""
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

    def commit(self, messages: Sequence[CommitMessage],
               commit_identifier: int = BATCH_COMMIT_IDENTIFIER,
               watermark: Optional[int] = None,
               properties: Optional[Dict[str, str]] = None
               ) -> Optional[int]:
        """Commit the messages as one snapshot; returns its id, or None
        for an ignored empty batch commit.  `watermark` (epoch millis)
        records event-time progress in the snapshot — it only ever
        advances.  `properties` are stored on the snapshot itself
        (ignored on the overwrite path)."""
        # empty batch commits produce no snapshot unless forced
        # (reference snapshot.ignore-empty-commit, default on for batch
        # writers; streaming keeps empty snapshots for exactly-once
        # progress tracking)
        ignore_empty = self.table.options.get(
            CoreOptions.SNAPSHOT_IGNORE_EMPTY_COMMIT)
        if ignore_empty is None:
            ignore_empty = commit_identifier == BATCH_COMMIT_IDENTIFIER
        if ignore_empty and not messages and self._overwrite is None \
                and not self.table.options.get(
                    CoreOptions.COMMIT_FORCE_CREATE_SNAPSHOT):
            return None
        if self._overwrite is not None:
            return self._commit.overwrite(
                messages, partition_filter=self._overwrite or None,
                commit_identifier=commit_identifier)
        return self._commit.commit(messages, commit_identifier,
                                   properties=properties,
                                   # a streaming empty commit still
                                   # snapshots so the identifier is
                                   # durable for exactly-once replay dedup
                                   force_create=not ignore_empty,
                                   watermark=watermark)

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

    def plan(self, snapshot_id: Optional[int] = None) -> ScanPlan:
        table = self.builder.table
        snapshot = None
        opts = table.options
        if snapshot_id is None:
            snapshot_id = opts.get(CoreOptions.SCAN_SNAPSHOT_ID)
        ts_millis = opts.get(CoreOptions.SCAN_TIMESTAMP_MILLIS)
        if snapshot_id is not None:
            snapshot = table.snapshot_manager.snapshot(snapshot_id)
        elif ts_millis is not None:
            snapshot = table.snapshot_manager.earlier_or_equal_time_mills(
                ts_millis)
            if snapshot is None:
                return ScanPlan(None, [])
        plan = self._scan.plan(snapshot)
        if opts.get(CoreOptions.SCAN_PLAN_SORT_PARTITION):
            # raw partition values (typed order, not lexicographic str);
            # None sorts first within its position
            plan = ScanPlan(
                plan.snapshot_id,
                sorted(plan.splits,
                       key=lambda s: tuple((v is not None, v)
                                           for v in s.partition)))
        return plan


class TableRead:
    def __init__(self, builder: ReadBuilder):
        self.builder = builder
        table = builder.table
        self._read = MergeFileSplitRead(
            table.file_io, table.path, table.schema, table.options,
            schema_manager=table.schema_manager, device=table.device)
        if builder._projection:
            self._read.with_projection(builder._projection)
        if builder._predicate is not None:
            self._read.with_filter(builder._predicate)

    def read_split(self, split: DataSplit) -> pa.Table:
        return self._finalize(self._read.read_split(split))

    def to_arrow(self, splits) -> pa.Table:
        """Accepts a ScanPlan or a list of DataSplits."""
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

    def _finalize(self, t: pa.Table) -> pa.Table:
        if self.builder._projection:
            from paimon_tpu_torch.core.read import ROW_KIND_COL
            cols = [c for c in self.builder._projection
                    if c in t.column_names]
            if ROW_KIND_COL in t.column_names:
                cols.append(ROW_KIND_COL)
            t = t.select(cols)
        if self.builder._limit is not None:
            t = t.slice(0, self.builder._limit)
        return t

    def to_pandas(self, splits: Sequence[DataSplit]):
        return self.to_arrow(splits).to_pandas()
