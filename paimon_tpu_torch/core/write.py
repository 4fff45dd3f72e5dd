"""Write path: buffered per-(partition,bucket) writers producing L0 files.

Counterpart of paimon_tpu/core/write.py for fixed, dynamic (bucket -1)
and postpone (bucket -2) buckets.  Every flush merges (deduplicate,
first-row) or sorts (partial-update, aggregation) on the writer's torch
device, and under changelog-producer=input also writes its raw rows as
a changelog file.  Dynamic buckets group rows by partition first, then
assign buckets from the partition's hash index (core/dynamic_bucket.py),
whose replacement index entries ride the commit messages; postpone
buckets stage rows un-hashed under bucket -2 until `rescale_postpone`.

With `write-buffer-spillable`, a bucket's full buffer becomes a local
key-sorted run (zstd Arrow IPC) instead of an L0 file; runs past
`local-sort.max-num-file-handles` fold into one, and prepare-commit
stream-merges them (ops/merge_stream.py) into rolling L0 files.  With
`local-merge-buffer-size`, a LocalMerger folds hot keys before bucket
routing.  Both merge on the device through ops/merge.py.

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

import os
import time
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
from paimon_tpu_torch.utils.deadline import wait_future
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["CommitMessage", "KeyValueFileStoreWrite", "build_kv_table"]


@dataclass
class CommitMessage:
    """reference: table/sink/CommitMessageImpl.java."""
    partition: Tuple
    bucket: int
    total_buckets: int
    new_files: List[DataFileMeta] = dc_field(default_factory=list)
    compact_before: List[DataFileMeta] = dc_field(default_factory=list)
    compact_after: List[DataFileMeta] = dc_field(default_factory=list)
    changelog_files: List[DataFileMeta] = dc_field(default_factory=list)
    compact_changelog: List[DataFileMeta] = dc_field(default_factory=list)
    # dynamic-bucket hash index updates (reference indexIncrement)
    index_entries: List = dc_field(default_factory=list)

    def is_empty(self) -> bool:
        return not (self.new_files or self.compact_before
                    or self.compact_after or self.changelog_files
                    or self.compact_changelog or self.index_entries)


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
        uniq, inverse = unique_rows(group_codes)
        groups = []
        for row in uniq:
            part = tuple(part_dicts[i][int(row[i + 1])].as_py()
                         for i in range(len(partition_keys)))
            groups.append((part, int(row[0])))
    order = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[order], np.arange(len(groups) + 1))
    return [(groups[gi], order[bounds[gi]:bounds[gi + 1]])
            for gi in range(len(groups))]


def unique_rows(columns: Sequence[np.ndarray]):
    """np.unique(np.stack(columns, axis=1), axis=0, return_inverse=True)
    for integer code columns, through one int64 key per row (mixed radix,
    first column most significant), which sorts in the same order."""
    if len(columns[0]) == 0:
        return np.unique(np.stack(columns, axis=1), axis=0,
                         return_inverse=True)
    lows = [int(c.min()) for c in columns]
    spans = [int(c.max()) - lo + 1 for c, lo in zip(columns, lows)]
    if np.prod(np.array(spans, dtype=np.float64)) >= 2.0 ** 62:
        return np.unique(np.stack(columns, axis=1), axis=0,
                         return_inverse=True)
    key = np.zeros(len(columns[0]), dtype=np.int64)
    for c, lo, span in zip(columns, lows, spans):
        key = key * span + (c.astype(np.int64) - lo)
    ukey, inverse = np.unique(key, return_inverse=True)
    uniq = np.empty((len(ukey), len(columns)), dtype=np.int64)
    for j in range(len(columns) - 1, -1, -1):
        uniq[:, j] = ukey % spans[j] + lows[j]
        ukey = ukey // spans[j]
    return uniq, inverse.reshape(-1)


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

    Concurrency contract (parallel/write_pipeline.py): `write`, `_spill`
    and the flush *scheduling* run on the caller thread — sequence
    ranges are reserved at write() time, single-threaded, so pipelined
    flushes can never duplicate or reorder them.  The merge/encode/write
    bodies run as FlushPool tasks; tasks for this bucket execute
    strictly in submission order (per-key actor), so `new_files`,
    `changelog_files` and `spills` are only ever touched by one task at
    a time."""

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
        self.spills: List[str] = []           # key-sorted local runs
        self._spill_dir: Optional[str] = None
        self._spill_bytes = 0                 # on-disk spill footprint
        self._spills_scheduled = 0            # caller side (see _spill)
        # monotonic spill-name counter: names derived from len(spills)
        # could repeat after a fold shrinks the list
        self._spill_seq = 0
        # scheduled-not-yet-written spill payload bytes: the disk cap
        # must see queued spills too
        self._spill_sched_bytes = 0

    @property
    def _key(self) -> Tuple:
        return (self.partition, self.bucket)

    def pending_bytes(self) -> int:
        """Flush-cost estimate for LPT scheduling (buffered + spilled)."""
        return self.buffered_bytes + self._spill_bytes

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
        opts = self.parent.options
        if self.parent.spillable:
            # sorted runs spill at sort-spill-buffer-size cadence,
            # bounded overall by write-buffer-size; both count the raw
            # Arrow bytes buffered (table.nbytes)
            threshold = min(opts.write_buffer_size,
                            opts.get(CoreOptions.SORT_SPILL_BUFFER_SIZE))
            if self.buffered_bytes >= threshold:
                if self._spill_bytes + self._spill_sched_bytes >= \
                        opts.get(
                            CoreOptions.WRITE_BUFFER_SPILL_MAX_DISK_SIZE):
                    # the disk budget is spent: flush to L0 instead of
                    # spilling further (reference MaxDiskSize cap)
                    self.flush()
                else:
                    self._spill()
        elif self.buffered_bytes >= opts.write_buffer_size:
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

    def _sorted_chunk(self, snap) -> Tuple[Optional[pa.Table],
                                           List[DataFileMeta]]:
        """Lay out one flush payload as a key-sorted KV chunk on the
        device, and under changelog-producer=input write its raw rows
        (arrival order) as a changelog file.  Deduplicate and first-row
        merge the chunk; the deferred engines (partial-update,
        aggregation) only sort it, keeping every version for the read or
        compaction merge to fold.  Worker side and retry-safe: nothing
        on `self` is mutated; returns (sorted_kv, changelog metas) for
        the caller to publish once the whole task succeeded."""
        if snap is None:
            return None, []
        raw, kinds, seq = snap
        schema = self.parent.schema
        key_cols = self.parent.key_cols
        opts = self.parent.options
        engine = opts.merge_engine
        from paimon_tpu_torch.metrics import WRITE_SORT_MS
        from paimon_tpu_torch.obs.trace import span
        with span("write.sort", cat="write", group="write",
                  metric=WRITE_SORT_MS, partition=self.partition,
                  bucket=self.bucket, rows=raw.num_rows):
            kv = build_kv_table(raw, schema, seq, kinds)
            if engine not in (MergeEngine.DEDUPLICATE,
                              MergeEngine.FIRST_ROW):
                order = sort_table(kv, key_cols,
                                   key_encoder=self.parent.key_encoder,
                                   device=self.parent.device)
                sorted_kv = kv.take(pa.array(order))
            else:
                sorted_kv = merge_runs(
                    [kv], key_cols, merge_engine=engine,
                    drop_deletes=False,
                    key_encoder=self.parent.key_encoder,
                    seq_fields=opts.sequence_field or None,
                    seq_desc=opts.sequence_field_descending,
                    device=self.parent.device).take()
        changelog: List[DataFileMeta] = []
        if self.parent.changelog_input:
            changelog = self.parent.write_changelog(
                self.partition, self.bucket,
                build_kv_table(raw, schema, seq, kinds))
        return sorted_kv, changelog

    def flush(self):
        """Snapshot the buffer (caller thread) and hand the merge and
        file write to the flush pool."""
        snap = self._snapshot()
        if snap is None:
            return

        def task(snap=snap):
            sorted_kv, changelog = self._sorted_chunk(snap)
            metas = self.parent.kv_writer.write(
                self.partition, self.bucket, sorted_kv, level=0)
            # publish only after the writes succeeded: a retried attempt
            # rewrites under fresh names, never double-counts
            self.new_files.extend(metas)
            self.changelog_files.extend(changelog)

        self.parent.flush_pool().submit(self._key, snap[0].nbytes, task)

    # -- spillable buffer (reference SortBufferWriteBuffer:59 spill via
    # MergeSorter/BinaryExternalSortBuffer: full buffers become local
    # sorted runs, merged into L0 once at prepare-commit) ----------------

    def _spill_codec(self):
        """IPC compression per spill-compression (+ zstd-level)."""
        opts = self.parent.options
        codec = opts.get(CoreOptions.SPILL_COMPRESSION)
        if codec in (None, "none"):
            return None
        if codec == "zstd":
            return pa.Codec("zstd", compression_level=opts.get(
                CoreOptions.SPILL_COMPRESSION_ZSTD_LEVEL))
        return pa.Codec(codec)

    def _new_spill_path(self, stem: str) -> str:
        import tempfile
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="paimon-spill-")
        path = os.path.join(self._spill_dir,
                            f"{stem}-{self._spill_seq}.arrow")
        self._spill_seq += 1
        return path

    def _write_spill_file(self, sorted_kv: pa.Table) -> str:
        path = self._new_spill_path("spill")
        opts = pa.ipc.IpcWriteOptions(compression=self._spill_codec())
        # byte-capped batches (~24 MB): the k-way merge buffers at least
        # one batch per run, so batches as large as a whole buffer would
        # recreate the memory cliff spilling exists to avoid
        per_row = max(1, sorted_kv.nbytes // max(1, sorted_kv.num_rows))
        chunk_rows = max(1024, (24 << 20) // per_row)
        with pa.OSFile(path, "wb") as f, \
                pa.ipc.new_file(f, sorted_kv.schema, options=opts) as wr:
            wr.write_table(sorted_kv, max_chunksize=chunk_rows)
        self._spill_bytes += os.path.getsize(path)
        return path

    def _spill(self):
        """Snapshot (caller thread), then a pooled merge and IPC write.
        The spill write and the fold are separate tasks (separate retry
        domains): a transient fold failure must not re-run a spill write
        that already published, which would duplicate the run and its
        changelog."""
        snap = self._snapshot()
        if snap is None:
            return
        self._spills_scheduled += 1
        payload = snap[0].nbytes
        self._spill_sched_bytes += payload

        def spill_task(snap=snap):
            sorted_kv, changelog = self._sorted_chunk(snap)
            path = self._write_spill_file(sorted_kv)
            # publish last: a retried attempt rewrote under fresh names
            self.spills.append(path)
            self.changelog_files.extend(changelog)
            self._spill_sched_bytes -= payload

        def fold_task():
            max_handles = self.parent.options.get(
                CoreOptions.LOCAL_SORT_MAX_NUM_FILE_HANDLES)
            if len(self.spills) > max_handles:
                self._fold_spills(max_handles)

        pool = self.parent.flush_pool()
        pool.submit(self._key, payload, spill_task)
        pool.submit(self._key, 1, fold_task)

    def _fold_spills(self, max_handles: int):
        """Merge the oldest `max_handles` runs into one, so at most that
        many are open at once (reference BinaryExternalSortBuffer's
        external-merge fan-in bound)."""
        from paimon_tpu_torch.ops.merge_stream import merge_runs_streamed
        fold, rest = self.spills[:max_handles], self.spills[max_handles:]
        out_path: List[str] = []
        writer_box: List = [None, None]       # (OSFile, IPC writer)

        def emit(window: pa.Table):
            if window.num_rows == 0:
                return
            if writer_box[0] is None:
                path = self._new_spill_path("spill-fold")
                out_path.append(path)
                writer_box[0] = pa.OSFile(path, "wb")
                writer_box[1] = pa.ipc.new_file(
                    writer_box[0], window.schema,
                    options=pa.ipc.IpcWriteOptions(
                        compression=self._spill_codec()))
            writer_box[1].write_table(window)

        merge_runs_streamed([self._ipc_iter(p) for p in fold],
                            self.parent.key_cols, self.parent.key_encoder,
                            emit, self._window_merge_fn())
        if writer_box[1] is not None:
            writer_box[1].close()
            writer_box[0].close()
        # publish the new run list before unlinking the inputs: a
        # retried fold must re-read a consistent `spills`, never paths
        # it already deleted; a failed unlink leaves a stray file for
        # _drop_spills' rmtree
        fold_sizes = sum(os.path.getsize(p) for p in fold)
        self.spills = out_path + rest
        self._spill_bytes -= fold_sizes
        if out_path:
            self._spill_bytes += os.path.getsize(out_path[0])
        for p in fold:
            try:
                os.unlink(p)
            except OSError:
                pass

    @staticmethod
    def _ipc_iter(path):
        def gen():
            with pa.OSFile(path, "rb") as f:
                rd = pa.ipc.open_file(f)
                for i in range(rd.num_record_batches):
                    yield pa.Table.from_batches([rd.get_batch(i)])
        return gen()

    def _window_merge_fn(self):
        """Window merger shared by the fold and the final L0 merge:
        deduplicate and first-row keep winners (a device merge), the
        deferred engines keep every row in (key, seq) order."""
        parent = self.parent
        opts = parent.options
        engine = opts.merge_engine

        def merge_window(tables: List[pa.Table]) -> pa.Table:
            if engine in (MergeEngine.DEDUPLICATE, MergeEngine.FIRST_ROW):
                return merge_runs(
                    tables, parent.key_cols, merge_engine=engine,
                    drop_deletes=False, key_encoder=parent.key_encoder,
                    seq_fields=opts.sequence_field or None,
                    seq_desc=opts.sequence_field_descending,
                    device=parent.device).take()
            kv = pa.concat_tables(tables, promote_options="none")
            order = sort_table(kv, parent.key_cols,
                               key_encoder=parent.key_encoder,
                               device=parent.device)
            return kv.take(pa.array(order))
        return merge_window

    def _merge_spills(self, snap):
        """Streamed k-way merge of the spilled runs (and the live
        buffer's tail `snap`) into rolling L0 files, by the bounded-memory
        machinery of the compaction rewrite (ops/merge_stream.py).
        Worker side and retry-safe: output metas publish at the end and
        the spills drop only on success, so a retried attempt still has
        its inputs (a failed attempt's L0 files are orphans)."""
        from paimon_tpu_torch.ops.merge_stream import merge_runs_streamed
        tail, changelog = self._sorted_chunk(snap)
        iters = [self._ipc_iter(p) for p in self.spills]
        if tail is not None:
            iters.append(iter([tail]))
        out_metas: List[DataFileMeta] = []
        acc: List[pa.Table] = []
        acc_bytes = 0
        target = self.parent.kv_writer.target_file_size

        def write_acc():
            nonlocal acc, acc_bytes
            if not acc:
                return
            merged = pa.concat_tables(acc, promote_options="none")
            out_metas.extend(self.parent.kv_writer.write(
                self.partition, self.bucket, merged, level=0))
            acc, acc_bytes = [], 0

        def emit(window: pa.Table):
            nonlocal acc_bytes
            if window.num_rows == 0:
                return
            if acc and acc_bytes + window.nbytes > target:
                # write before overshooting, so the rolling writer does
                # not split every accumulation into full + sliver
                write_acc()
            acc.append(window)
            acc_bytes += window.nbytes
            if acc_bytes >= target:
                write_acc()

        merge_runs_streamed(iters, self.parent.key_cols,
                            self.parent.key_encoder, emit,
                            self._window_merge_fn())
        write_acc()
        self.new_files.extend(out_metas)
        self.changelog_files.extend(changelog)
        self._drop_spills()

    def _drop_spills(self):
        import shutil
        self.spills = []
        self._spill_bytes = 0
        if self._spill_dir is not None:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            self._spill_dir = None

    def schedule_final_flush(self):
        """Queue the end-of-batch drain of this bucket: the tail buffer
        is snapshotted now (caller thread), but the spill-or-flush
        decision runs inside the task, after this bucket's earlier spill
        tasks (the per-key actor runs them first)."""
        snap = self._snapshot()
        if snap is None and self._spills_scheduled == 0:
            # nothing buffered and no spill since the last drain
            return
        self._spills_scheduled = 0

        def task(snap=snap):
            if self.spills:
                self._merge_spills(snap)
                return
            sorted_kv, changelog = self._sorted_chunk(snap)
            if sorted_kv is not None:
                self.new_files.extend(self.parent.kv_writer.write(
                    self.partition, self.bucket, sorted_kv, level=0))
                self.changelog_files.extend(changelog)

        est = (snap[0].nbytes if snap is not None else 0) + \
            self._spill_bytes
        self.parent.flush_pool().submit(self._key, est, task)

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


class LocalMerger:
    """Pre-routing hot-key fold (reference mergetree/localmerge/
    HashMapLocalMerger.java): rows buffer before bucket routing; once
    the buffer reaches `local-merge-buffer-size`, duplicate keys collapse
    to their winning version in one device merge, so a hot key reaches
    the bucket writers once a fold instead of once an update.  Row
    kinds ride along: a DELETE that wins still propagates as a DELETE."""

    def __init__(self, store: "KeyValueFileStoreWrite", buffer_bytes: int):
        self.store = store
        self.buffer_bytes = buffer_bytes
        self._tables: List[pa.Table] = []
        self._kinds: List[np.ndarray] = []
        self._buckets: List[Optional[np.ndarray]] = []
        self._nbytes = 0

    def add(self, table: pa.Table, kinds: np.ndarray,
            buckets: Optional[np.ndarray] = None):
        self._tables.append(table)
        self._kinds.append(kinds)
        self._buckets.append(buckets)
        self._nbytes += table.nbytes
        if self._nbytes >= self.buffer_bytes:
            self.flush()

    def flush(self):
        if not self._tables:
            return
        raw = pa.concat_tables(self._tables, promote_options="none")
        kinds = np.concatenate(self._kinds)
        # buckets assigned by the caller survive the fold when every
        # buffered batch carried them (the topology's shuffle does)
        buckets = np.concatenate(self._buckets) \
            if all(b is not None for b in self._buckets) else None
        self._tables, self._kinds, self._buckets = [], [], []
        self._nbytes = 0
        if raw.num_rows == 0:
            return
        store = self.store
        schema = store.schema
        kv = build_kv_table(raw, schema,
                            np.arange(raw.num_rows, dtype=np.int64), kinds)
        # the merge runs before partition routing, so the fold key
        # includes the partition columns: trimmed keys alone would
        # collapse distinct rows of different partitions
        key_cols = list(schema.partition_keys) + store.key_cols
        res = merge_runs(
            [kv], key_cols, merge_engine=store.options.merge_engine,
            drop_deletes=False,
            seq_fields=store.options.sequence_field or None,
            seq_desc=store.options.sequence_field_descending,
            device=store.device)
        idx = res.indices
        store._dispatch(raw.take(pa.array(idx)), kinds[idx],
                        None if buckets is None else buckets[idx])


class KeyValueFileStoreWrite:
    """Routes rows to per-(partition,bucket) writers.

    reference: operation/KeyValueFileStoreWrite.java:70."""

    def __init__(self, file_io: FileIO, table_path: str,
                 table_schema: TableSchema, options: CoreOptions,
                 restore_max_seq: Optional[Callable[[Tuple, int], int]]
                 = None, branch: str = "main",
                 bucket_files_map: Optional[Callable[[], Dict]] = None,
                 schema_manager=None, device=None):
        from paimon_tpu_torch.parallel.write_pipeline import (
            maybe_wrap_staging,
        )
        file_io, self._stager = maybe_wrap_staging(file_io, options)
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
            index_spec=options.file_index_spec,
            bloom_fpp=options.get(CoreOptions.FILE_INDEX_BLOOM_FPP),
            index_in_manifest_threshold=options.get(
                CoreOptions.FILE_INDEX_IN_MANIFEST_THRESHOLD),
            format_per_level=options.file_format_per_level,
            format_options=options.format_options,
            **options.kv_writer_kwargs())
        rt = table_schema.logical_row_type()
        self.total_buckets = options.bucket
        bucket_keys = table_schema.bucket_keys()
        # postpone mode (reference postpone/PostponeBucketFileStoreWrite):
        # rows stage un-hashed under bucket-postpone; rescale_postpone
        # redistributes them later
        self._postpone = options.bucket == -2
        self._dynamic = None
        self.bucket_assigner = None
        if options.bucket < 1 and not self._postpone:
            # dynamic bucket mode (reference BucketMode.HASH_DYNAMIC)
            from paimon_tpu_torch.core.bucket import KeyHasher
            from paimon_tpu_torch.core.dynamic_bucket import (
                DynamicBucketAssigner,
            )
            from paimon_tpu_torch.core.scan import FileStoreScan
            self._key_hasher = KeyHasher(
                bucket_keys, [rt.get_field(k).type for k in bucket_keys])
            self._dynamic = DynamicBucketAssigner(
                FileStoreScan(file_io, table_path, table_schema, options,
                              branch=branch),
                options.dynamic_bucket_target_row_num)
            # host seconds in the assigner (hash, index load, assign)
            self.assign_seconds = 0.0
        elif not self._postpone:
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
        self.key_cols = [KEY_PREFIX + k
                         for k in table_schema.trimmed_primary_keys()]
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
        self.spillable = options.get(CoreOptions.WRITE_BUFFER_SPILLABLE)
        self._local_merger: Optional[LocalMerger] = None
        lm_size = options.get(CoreOptions.LOCAL_MERGE_BUFFER_SIZE)
        if lm_size:
            if options.merge_engine not in (MergeEngine.DEDUPLICATE,
                                            MergeEngine.FIRST_ROW):
                raise ValueError(
                    "local-merge-buffer-size supports deduplicate / "
                    "first-row merge engines (reference "
                    "HashMapLocalMerger applies whole-row merges)")
            if self.changelog_input:
                raise ValueError(
                    "local-merge-buffer-size folds input rows, which "
                    "would drop changelog-producer=input events")
            self._local_merger = LocalMerger(self, lm_size)

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
                    row_kinds: Optional[np.ndarray] = None,
                    buckets: Optional[np.ndarray] = None):
        """Write a batch of rows (full table schema). Optional `row_kinds`
        int8[N] (RowKind codes); a `_ROW_KIND` column is also honored.
        `buckets` skips re-hashing when the caller already assigned
        them (the multi-writer topology's shuffle)."""
        table, row_kinds = extract_row_kinds(table, row_kinds)
        if self._local_merger is not None and not self._postpone:
            self._local_merger.add(table, row_kinds, buckets)
            return
        self._dispatch(table, row_kinds, buckets)

    def _dispatch(self, table: pa.Table, row_kinds: np.ndarray,
                  precomputed_buckets: Optional[np.ndarray] = None):
        from paimon_tpu_torch.parallel.write_pipeline import lpt_order

        if self._postpone:
            self._drain_prep()
            buckets = np.full(table.num_rows, -2, dtype=np.int32)
            for (part, bucket), idx in lpt_order(
                    group_by_partition_bucket(
                        table, buckets, self.partition_keys)):
                self._writer(part, bucket).write(table.take(pa.array(idx)),
                                                 row_kinds[idx])
            return
        if self._dynamic is not None:
            # partition-first grouping: bucket assignment depends on the
            # partition's hash index (stateful, so no lookahead here)
            self._drain_prep()
            zeros = np.zeros(table.num_rows, dtype=np.int32)
            for (part, _), idx in group_by_partition_bucket(
                    table, zeros, self.partition_keys):
                sub = table.take(pa.array(idx))
                sub_kinds = row_kinds[idx]
                t0 = time.perf_counter()
                buckets = self._dynamic.assign(
                    part, self._key_hasher.hashes(sub))
                self.assign_seconds += time.perf_counter() - t0
                for (_, bucket), idx2 in lpt_order(
                        group_by_partition_bucket(sub, buckets, [])):
                    self._writer(part, bucket).write(
                        sub.take(pa.array(idx2)), sub_kinds[idx2])
            return

        # the hash/group-by/take is a PURE function of the batch, so it
        # runs on a prep worker while the previous batch routes.
        # Routing (and therefore sequence reservation) stays on this
        # thread, in batch order.
        def prep(table=table, kinds=row_kinds, pre=precomputed_buckets):
            buckets = pre if pre is not None \
                else self.bucket_assigner.assign(table)
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
            self._route(wait_future(self._prep.popleft(),
                                    "write prep backpressure"))
        while self._prep and self._prep[0].done():
            self._route(wait_future(self._prep.popleft(),
                                    "write prep drain"))

    def _route(self, groups):
        for (part, bucket), sub, kinds in groups:
            self._writer(part, bucket).write(sub, kinds)

    def _drain_prep(self):
        while self._prep:
            self._route(wait_future(self._prep.popleft(),
                                    "write prep drain"))

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
        """The pipeline barrier: schedule every bucket's final drain
        (largest pending bytes first), wait for the pool, then assemble
        messages on the caller thread.  The first worker error re-raises
        here with the remaining queued flushes cancelled — a failed
        prepare commits nothing."""
        if self._local_merger is not None:
            self._local_merger.flush()
        self._drain_prep()
        for w in sorted(self._writers.values(),
                        key=lambda w: -w.pending_bytes()):
            w.schedule_final_flush()
        self.flush_pool().drain()
        out = []
        auto_compact = not self.options.write_only and not self._postpone
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
        if self._dynamic is not None:
            t0 = time.perf_counter()
            entries = self._dynamic.index_entries()
            self.assign_seconds += time.perf_counter() - t0
            if entries:
                if out:
                    out[0].index_entries.extend(entries)
                else:
                    out.append(CommitMessage((), 0, self.total_buckets,
                                             index_entries=entries))
        if self._stager is not None:
            # the durability barrier comes last: every file a message
            # names must be acked by the store before the caller may
            # commit (an upload failure raises here and poisons the
            # stager: commit nothing, close the writer)
            self._stager.drain()
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
            # join the workers first, so no task mutates spill state
            # while it is cleaned
            self._flush_pool.shutdown(wait=True)
            self._flush_pool = None
        if self._stager is not None:
            # after the flush pool, so no worker stages once the upload
            # pool is shut; abandoned staged files go with the stage dir
            self._stager.close()
        for w in self._writers.values():
            w._drop_spills()          # an aborted write leaks no spill
        self._writers.clear()
