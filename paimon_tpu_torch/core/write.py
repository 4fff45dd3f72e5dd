"""Write path: buffered per-(partition,bucket) writers producing L0 files.

Counterpart of paimon_tpu/core/write.py for fixed buckets (spilling,
local merge and dynamic/postpone buckets are not ported yet); every
flush merges (deduplicate, first-row) or sorts (partial-update,
aggregation) on the writer's torch device, and under
changelog-producer=input also writes its raw rows as a changelog file.

reference call stack (SURVEY §3.1): TableWriteImpl.write ->
AbstractFileStoreWrite.write (operation/AbstractFileStoreWrite.java:186)
-> MergeTreeWriter.write/flushMemory (mergetree/MergeTreeWriter.java:164,
203) -> sort + merge-dedup -> KeyValueFileWriterFactory rolling write.

Deviation: instead of a binary sort buffer with normalized-key
insertion (SortBufferWriteBuffer.java:59), rows accumulate as Arrow
batches; at flush the whole buffer is sorted/deduped by the device kernel
in one shot and written columnar.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.bucket import FixedBucketAssigner
from paimon_tpu_torch.core.kv_file import (
    KEY_PREFIX, KeyValueFileWriter, write_changelog_file,
)
from paimon_tpu_torch.core.read import ROW_KIND_COL
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import DataFileMeta
from paimon_tpu_torch.options import ChangelogProducer, CoreOptions, MergeEngine
from paimon_tpu_torch.ops.merge import (
    KIND_COL, SEQ_COL, merge_runs, sort_table,
)
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["CommitMessage", "KeyValueFileStoreWrite", "build_kv_table"]


@dataclass
class CommitMessage:
    """reference: table/sink/CommitMessageImpl.java (without index
    entries, which are not ported yet)."""
    partition: Tuple
    bucket: int
    total_buckets: int
    new_files: List[DataFileMeta] = dc_field(default_factory=list)
    compact_before: List[DataFileMeta] = dc_field(default_factory=list)
    compact_after: List[DataFileMeta] = dc_field(default_factory=list)
    changelog_files: List[DataFileMeta] = dc_field(default_factory=list)
    compact_changelog: List[DataFileMeta] = dc_field(default_factory=list)

    def is_empty(self) -> bool:
        return not (self.new_files or self.compact_before
                    or self.compact_after or self.changelog_files
                    or self.compact_changelog)


def group_by_partition_bucket(table: pa.Table, buckets: np.ndarray,
                              partition_keys: Sequence[str]):
    """Split rows into (partition_tuple, bucket) groups.
    Returns [((part, bucket), row_indices)] — shared by the pk and
    append write paths (reference RowKeyExtractor + ChannelComputer)."""
    group_codes = [buckets]
    part_dicts = []
    for pk in partition_keys:
        enc = table.column(pk).combine_chunks().dictionary_encode()
        part_dicts.append(enc.dictionary)
        group_codes.append(np.asarray(enc.indices))
    if len(group_codes) == 1:
        uniq, inverse = np.unique(buckets, return_inverse=True)
        groups = [((), int(b)) for b in uniq]
    else:
        stacked = np.stack(group_codes, axis=1)
        uniq, inverse = np.unique(stacked, axis=0, return_inverse=True)
        groups = []
        for row in uniq:
            part = tuple(part_dicts[i][int(row[i + 1])].as_py()
                         for i in range(len(partition_keys)))
            groups.append((part, int(row[0])))
    order = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[order], np.arange(len(groups) + 1))
    return [(groups[gi], order[bounds[gi]:bounds[gi + 1]])
            for gi in range(len(groups))]


def build_kv_table(raw: pa.Table, schema: TableSchema,
                   seq: np.ndarray, kinds: np.ndarray) -> pa.Table:
    """Flatten rows into the KV file layout:
    _KEY_<pk...>, _SEQUENCE_NUMBER, _VALUE_KIND, <all value columns>."""
    cols = []
    names = []
    for k in schema.trimmed_primary_keys():
        cols.append(raw.column(k))
        names.append(KEY_PREFIX + k)
    cols.append(pa.array(seq, pa.int64()))
    names.append(SEQ_COL)
    cols.append(pa.array(kinds, pa.int8()))
    names.append(KIND_COL)
    for f in schema.fields:
        cols.append(raw.column(f.name))
        names.append(f.name)
    return pa.table(dict(zip(names, cols)))


class _BucketWriter:
    """One (partition, bucket)'s buffered state.

    Concurrency contract (parallel/write_pipeline.py): `write` and the
    flush *scheduling* run on the caller thread — sequence ranges are
    reserved at write() time, single-threaded, so pipelined flushes can
    never duplicate or reorder them.  The merge/encode/write bodies run
    as FlushPool tasks; tasks for this bucket execute strictly in
    submission order (per-key actor), so `new_files` and
    `changelog_files` are only ever touched by one task at a time."""

    def __init__(self, parent: "KeyValueFileStoreWrite", partition: Tuple,
                 bucket: int):
        self.parent = parent
        self.partition = partition
        self.bucket = bucket
        self.buffers: List[pa.Table] = []
        self.kind_buffers: List[np.ndarray] = []
        self.seq_buffers: List[np.ndarray] = []   # reserved at write()
        self.buffered_bytes = 0
        self.next_seq: Optional[int] = None   # lazily restored
        self.new_files: List[DataFileMeta] = []
        self.changelog_files: List[DataFileMeta] = []

    @property
    def _key(self) -> Tuple:
        return (self.partition, self.bucket)

    def write(self, table: pa.Table, kinds: np.ndarray):
        self.buffers.append(table)
        self.kind_buffers.append(kinds)
        # sequence numbers are reserved HERE, on the single-threaded
        # caller, never inside a pooled flush task
        seqs = self._assign_seq(table.num_rows)
        self.seq_buffers.append(seqs)
        if self.parent.delta_listener is not None:
            # the serving plane's delta tier (service/delta.py): the
            # batch is point-lookup visible once buffered, after
            # sequence reservation, so its newest-wins order is flush
            # order
            self.parent.delta_listener(self.partition, self.bucket,
                                       table, kinds, seqs)
        self.buffered_bytes += table.nbytes
        if self.buffered_bytes >= self.parent.options.write_buffer_size:
            self.flush()

    def _restore_seq(self) -> int:
        if self.next_seq is None:
            if not self.parent.options.get(
                    CoreOptions.KV_SEQUENCE_NUMBER_ENABLED):
                # key-value.sequence_number.enabled=false: all rows
                # carry seq 0 and merge order falls back to run order
                self.next_seq = 0
                return 0
            self.next_seq = self.parent.restore_max_seq(
                self.partition, self.bucket) + 1
        return self.next_seq

    def _assign_seq(self, n: int) -> np.ndarray:
        start = self._restore_seq()
        if not self.parent.options.get(
                CoreOptions.KV_SEQUENCE_NUMBER_ENABLED):
            return np.zeros(n, dtype=np.int64)
        self.next_seq = start + n
        return np.arange(start, start + n, dtype=np.int64)

    def _snapshot(self):
        """Detach the in-RAM buffer into an immutable flush payload
        (caller thread): (raw, kinds, seq) or None."""
        if not self.buffers:
            return None
        raw = pa.concat_tables(self.buffers, promote_options="none")
        kinds = np.concatenate(self.kind_buffers)
        seq = np.concatenate(self.seq_buffers)
        self.buffers, self.kind_buffers, self.seq_buffers = [], [], []
        self.buffered_bytes = 0
        return raw, kinds, seq

    def _sorted_chunk(self, snap) -> pa.Table:
        """Lay out one flush payload as a key-sorted KV chunk on the
        device (worker side; nothing on `self` is mutated).  Deduplicate
        and first-row merge it; the deferred engines (partial-update,
        aggregation) only sort it, keeping every version for the read
        or compaction merge to fold."""
        raw, kinds, seq = snap
        schema = self.parent.schema
        kv = build_kv_table(raw, schema, seq, kinds)
        key_cols = [KEY_PREFIX + k for k in schema.trimmed_primary_keys()]
        opts = self.parent.options
        engine = opts.merge_engine
        if engine not in (MergeEngine.DEDUPLICATE, MergeEngine.FIRST_ROW):
            order = sort_table(kv, key_cols,
                               key_encoder=self.parent.key_encoder,
                               device=self.parent.device)
            return kv.take(pa.array(order))
        res = merge_runs([kv], key_cols, merge_engine=engine,
                         drop_deletes=False,
                         key_encoder=self.parent.key_encoder,
                         seq_fields=opts.sequence_field or None,
                         seq_desc=opts.sequence_field_descending,
                         device=self.parent.device)
        return res.take()

    def flush(self):
        """Snapshot the buffer (caller thread) and hand the merge and
        file write to the flush pool."""
        snap = self._snapshot()
        if snap is None:
            return

        def task(snap=snap):
            metas = self.parent.kv_writer.write(
                self.partition, self.bucket, self._sorted_chunk(snap),
                level=0)
            changelog: List[DataFileMeta] = []
            if self.parent.changelog_input:
                # changelog-producer=input: raw rows in arrival order
                raw, kinds, seq = snap
                changelog = self.parent.write_changelog(
                    self.partition, self.bucket,
                    build_kv_table(raw, self.parent.schema, seq, kinds))
            # publish only after the writes succeeded
            self.new_files.extend(metas)
            self.changelog_files.extend(changelog)

        self.parent.flush_pool().submit(self._key, snap[0].nbytes, task)

    def take_commit_message(self) -> Optional[CommitMessage]:
        """Assemble this bucket's message AFTER the pool drained (the
        prepare-commit barrier); caller thread only."""
        msg = CommitMessage(self.partition, self.bucket,
                            self.parent.total_buckets,
                            new_files=list(self.new_files),
                            changelog_files=list(self.changelog_files))
        self.new_files = []
        self.changelog_files = []
        return None if msg.is_empty() else msg


def dicts_to_arrow(arrow_schema: pa.Schema, rows: Sequence[dict],
                   row_kinds: Optional[Sequence[int]] = None
                   ) -> Tuple[pa.Table, Optional[np.ndarray]]:
    """Dict rows -> (Arrow table, int8 kinds array or None): the ONE
    conversion behind TableWrite.write_dicts and the distributed
    plane's write_dicts, so coercion/default behavior cannot drift
    between the single-process and multi-host paths."""
    table = pa.Table.from_pylist(list(rows), schema=arrow_schema)
    kinds = np.asarray(row_kinds, dtype=np.int8) \
        if row_kinds is not None else None
    return table, kinds


def extract_row_kinds(table: pa.Table,
                      row_kinds: Optional[np.ndarray]
                      ) -> Tuple[pa.Table, np.ndarray]:
    """Honor an inline `_ROW_KIND` column or an explicit kinds array;
    defaults to all-INSERT."""
    if ROW_KIND_COL in table.column_names:
        row_kinds = np.asarray(table.column(ROW_KIND_COL)
                               .combine_chunks().cast(pa.int8()))
        table = table.drop_columns([ROW_KIND_COL])
    if row_kinds is None:
        row_kinds = np.zeros(table.num_rows, dtype=np.int8)
    return table, np.asarray(row_kinds, dtype=np.int8)


class KeyValueFileStoreWrite:
    """Routes rows to per-(partition,bucket) writers.

    reference: operation/KeyValueFileStoreWrite.java:70."""

    def __init__(self, file_io: FileIO, table_path: str,
                 table_schema: TableSchema, options: CoreOptions,
                 restore_max_seq: Optional[Callable[[Tuple, int], int]]
                 = None,
                 bucket_files_map: Optional[Callable[[], Dict]] = None,
                 schema_manager=None, device=None):
        self.file_io = file_io
        self.table_path = table_path
        self.schema = table_schema
        self.options = options
        self.device = device
        self._bucket_files_map = bucket_files_map
        self._schema_manager = schema_manager
        self.partition_keys = table_schema.partition_keys
        self.path_factory = FileStorePathFactory.from_options(
            table_path, self.partition_keys, options)
        self.kv_writer = KeyValueFileWriter(
            file_io, self.path_factory, table_schema,
            file_format=options.file_format,
            compression=options.file_compression,
            target_file_size=options.target_file_size,
            format_per_level=options.file_format_per_level,
            format_options=options.format_options,
            **options.kv_writer_kwargs())
        rt = table_schema.logical_row_type()
        self.total_buckets = options.bucket
        bucket_keys = table_schema.bucket_keys()
        self.bucket_assigner = FixedBucketAssigner(
            bucket_keys, [rt.get_field(k).type for k in bucket_keys],
            options.bucket)
        from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
        from paimon_tpu_torch.types import data_type_to_arrow
        self.key_encoder = NormalizedKeyEncoder(
            [data_type_to_arrow(rt.get_field(k).type)
             for k in table_schema.trimmed_primary_keys()],
            nullable=[rt.get_field(k).type.nullable
                      for k in table_schema.trimmed_primary_keys()])
        self._writers: Dict[Tuple, _BucketWriter] = {}
        # serving-plane hook (TableWrite.set_delta_listener): called with
        # (partition, bucket, table, kinds, seqs) for every buffered
        # batch, on the writing thread
        self.delta_listener = None
        self._flush_pool = None       # lazily built (write_pipeline)
        # bounded dispatch lookahead: batch N+1's hash/group-by/take
        # runs on a prep worker while batch N routes (seq reservation
        # stays on the caller, strictly in batch order)
        self._prep_pool = None
        self._prep = deque()
        self._restore_max_seq = restore_max_seq
        self.changelog_input = (
            options.changelog_producer == ChangelogProducer.INPUT)

    def flush_pool(self):
        """The shared bucket-flush executor (parallel/write_pipeline.py);
        write.flush.parallelism=1 degrades it to the inline serial path."""
        if self._flush_pool is None:
            from paimon_tpu_torch.parallel.write_pipeline import FlushPool
            self._flush_pool = FlushPool.from_options(self.options)
        return self._flush_pool

    def restore_max_seq(self, partition: Tuple, bucket: int) -> int:
        if self._restore_max_seq is None:
            return -1
        return self._restore_max_seq(partition, bucket)

    def write_changelog(self, partition: Tuple, bucket: int,
                        table: pa.Table) -> List[DataFileMeta]:
        return write_changelog_file(
            self.file_io, self.path_factory, self.schema,
            self.options.changelog_file_format,
            self.options.changelog_file_compression,
            partition, bucket, table,
            prefix=self.options.changelog_file_prefix,
            format_options=self.options.format_options)

    # -- writes --------------------------------------------------------------

    def write_arrow(self, table: pa.Table,
                    row_kinds: Optional[np.ndarray] = None):
        """Write a batch of rows (full table schema). Optional `row_kinds`
        int8[N] (RowKind codes); a `_ROW_KIND` column is also honored."""
        table, row_kinds = extract_row_kinds(table, row_kinds)
        self._dispatch(table, row_kinds)

    def _dispatch(self, table: pa.Table, row_kinds: np.ndarray):
        from paimon_tpu_torch.parallel.write_pipeline import lpt_order

        # the hash/group-by/take is a PURE function of the batch, so it
        # runs on a prep worker while the previous batch routes.
        # Routing (and therefore sequence reservation) stays on this
        # thread, in batch order.
        def prep(table=table, kinds=row_kinds):
            buckets = self.bucket_assigner.assign(table)
            out = []
            for (part, bucket), idx in lpt_order(
                    group_by_partition_bucket(
                        table, buckets, self.partition_keys)):
                out.append(((part, bucket), table.take(pa.array(idx)),
                            kinds[idx]))
            return out

        pool = self._prep_executor()
        if pool is None:
            self._route(prep())
            return
        self._prep.append(pool.submit(prep))
        # bounded lookahead: at most 4 batches prepped ahead (each holds
        # a batch-sized copy), routed strictly in submission order
        while len(self._prep) > 4:
            self._route(self._prep.popleft().result())
        while self._prep and self._prep[0].done():
            self._route(self._prep.popleft().result())

    def _route(self, groups):
        for (part, bucket), sub, kinds in groups:
            self._writer(part, bucket).write(sub, kinds)

    def _drain_prep(self):
        while self._prep:
            self._route(self._prep.popleft().result())

    def _prep_executor(self):
        """Lookahead pool (up to 4 workers, bounded by the flush
        parallelism); None (inline) on the serial path, and with a delta
        listener, whose contract is "readable when write() returns"."""
        from paimon_tpu_torch.parallel.write_pipeline import (
            resolve_flush_parallelism,
        )
        par = resolve_flush_parallelism(self.options)
        if par <= 1 or self.delta_listener is not None:
            return None
        if self._prep_pool is None:
            from paimon_tpu_torch.parallel.executors import new_thread_pool
            self._prep_pool = new_thread_pool(min(4, par),
                                              "paimon-write-prep")
        return self._prep_pool

    def _writer(self, partition: Tuple, bucket: int) -> _BucketWriter:
        key = (partition, bucket)
        if key not in self._writers:
            self._writers[key] = _BucketWriter(self, partition, bucket)
        return self._writers[key]

    def prepare_commit(self) -> List[CommitMessage]:
        """The pipeline barrier: flush every bucket (largest buffer
        first), wait for the pool, then assemble messages on the caller
        thread.  The first worker error re-raises here with the
        remaining queued flushes cancelled — a failed prepare commits
        nothing."""
        self._drain_prep()
        for w in sorted(self._writers.values(),
                        key=lambda w: -w.buffered_bytes):
            w.flush()
        self.flush_pool().drain()
        out = []
        auto_compact = not self.options.write_only
        existing_map = None
        if auto_compact and self._bucket_files_map is not None:
            # ONE manifest read for the whole commit, not one per bucket
            existing_map = self._bucket_files_map()
        for w in self._writers.values():
            msg = w.take_commit_message()
            if msg is not None:
                if auto_compact:
                    self._maybe_compact(msg, existing_map or {})
                out.append(msg)
        return out

    def _maybe_compact(self, msg: CommitMessage, existing_map: Dict):
        """Inline compaction at prepare-commit when the bucket's sorted
        runs exceed the trigger (reference MergeTreeWriter: compaction
        fires at flush unless write-only). The picked unit may include
        the message's own new L0 files: commit() publishes APPEND before
        COMPACT, so the conflict check still sees them."""
        existing = existing_map.get((msg.partition, msg.bucket), [])
        files = existing + msg.new_files
        if len(files) < 2:
            return
        from paimon_tpu_torch.compact.manager import MergeTreeCompactManager
        mgr = MergeTreeCompactManager(
            self.file_io, self.table_path, self.schema, self.options,
            msg.partition, msg.bucket, files,
            schema_manager=self._schema_manager, device=self.device)
        result = mgr.compact(full=False)
        if result is None or result.is_empty():
            return
        msg.compact_before = result.before
        msg.compact_after = result.after
        msg.compact_changelog = result.changelog

    def close(self):
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True, cancel_futures=True)
            self._prep_pool = None
        self._prep.clear()
        if self._flush_pool is not None:
            self._flush_pool.shutdown(wait=True)
            self._flush_pool = None
        self._writers.clear()
