"""Append-only tables: write, read and compaction without keys.

Counterpart of paimon_tpu/core/append.py.  The writer builds the files'
column indexes (file-index.*) as the primary-key writer does; the read
narrows a file's rows by those indexes (`index/file_index.row_selection`)
and by its deletion vector, and reads row-tracked files by row range
(core/row_tracking.py).  Append paths run on the host, as the
reference's do; the device only decodes pages under
read.device-decode.  Blob columns go to `.blob` sidecars as in the
primary-key writer (format/blob.py).

reference: paimon-core/.../append/AppendOnlyWriter.java (rolling plain
files, inserts only), BucketedAppendCompactManager.java (contiguous
small-file grouping per bucket), AppendOnlyFileStoreTable /
AppendOnlySplitGenerator; unaware-bucket mode (BucketMode.BUCKET_UNAWARE,
bucket = -1) stores every file under bucket-0 with no shuffle.

Data files carry the plain value columns only (no _KEY_/_SEQUENCE_NUMBER/
_VALUE_KIND); ordering comes from DataFileMeta sequence ranges.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.bucket import FixedBucketAssigner
from paimon_tpu_torch.core.kv_file import _safe_stats
from paimon_tpu_torch.core.scan import DataSplit
from paimon_tpu_torch.core.write import (
    CommitMessage, ROW_KIND_COL, group_by_partition_bucket,
)
from paimon_tpu_torch.format import get_format
from paimon_tpu_torch.format.format import extract_simple_stats
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import DataFileMeta, FileSource, SimpleStats
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.predicate import Predicate
from paimon_tpu_torch.schema.schema_manager import SchemaManager
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.types import RowKind, data_type_to_arrow
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["AppendOnlyFileStoreWrite", "AppendSplitRead",
           "append_compact_plan"]


class AppendFileWriter:
    """Rolling writer for plain-column append files."""

    def __init__(self, file_io: FileIO, path_factory: FileStorePathFactory,
                 table_schema: TableSchema, file_format: str,
                 compression: str, target_file_size: int,
                 index_spec: Optional[Dict[str, List[str]]] = None,
                 bloom_fpp: float = 0.01,
                 index_in_manifest_threshold: int = 500,
                 format_options: Optional[Dict[str, str]] = None):
        self.file_io = file_io
        self.path_factory = path_factory
        self.schema = table_schema
        self.file_format = file_format
        self.format_options = format_options or {}
        self.compression = compression
        self.target_file_size = target_file_size
        self.index_spec = index_spec or {}
        self.bloom_fpp = bloom_fpp
        self.index_in_manifest_threshold = index_in_manifest_threshold

    @classmethod
    def from_options(cls, file_io: FileIO,
                     path_factory: FileStorePathFactory,
                     table_schema: TableSchema,
                     options: CoreOptions) -> "AppendFileWriter":
        """The writer a table's options configure (format, compression,
        target size and file indexes)."""
        return cls(file_io, path_factory, table_schema,
                   file_format=options.file_format,
                   compression=options.file_compression,
                   target_file_size=options.target_file_size,
                   index_spec=options.file_index_spec,
                   bloom_fpp=options.get(CoreOptions.FILE_INDEX_BLOOM_FPP),
                   index_in_manifest_threshold=options.get(
                       CoreOptions.FILE_INDEX_IN_MANIFEST_THRESHOLD),
                   format_options=options.format_options)

    def write(self, partition: Tuple, bucket: int, table: pa.Table,
              first_seq: int,
              file_source: int = FileSource.APPEND) -> List[DataFileMeta]:
        if table.num_rows == 0:
            return []
        n = table.num_rows
        bytes_per_row = max(1, table.nbytes // n)
        rows_per_file = max(1024, self.target_file_size // bytes_per_row)
        metas = []
        seq = first_seq
        for start in range(0, n, rows_per_file):
            chunk = table.slice(start, min(rows_per_file, n - start))
            metas.append(self._write_one(partition, bucket, chunk, seq,
                                         file_source))
            seq += chunk.num_rows
        return metas

    def _write_one(self, partition: Tuple, bucket: int, chunk: pa.Table,
                   first_seq: int, file_source: int) -> DataFileMeta:
        fmt = get_format(self.file_format)
        name = self.path_factory.new_data_file_name(fmt.extension)
        path, external = self.path_factory.new_data_file_location(
            partition, bucket, name)
        from paimon_tpu_torch.format.blob import blob_column_names
        blob_cols = blob_column_names(self.schema)
        blob_extras: List[str] = []
        if blob_cols:
            from paimon_tpu_torch.format.blob import externalize_blobs
            chunk, blob_extras = externalize_blobs(
                self.file_io, self.path_factory, partition, bucket, name,
                chunk, blob_cols)
        size = fmt.create_writer(self.compression,
                                 self.format_options).write(
            self.file_io, path, chunk)
        value_cols = [f.name for f in self.schema.fields]
        vmins, vmaxs, vnulls = extract_simple_stats(chunk, value_cols)
        value_stats = _safe_stats([f.type for f in self.schema.fields],
                                  vmins, vmaxs, vnulls)
        embedded_index, extra_files = None, []
        if self.index_spec:
            from paimon_tpu_torch.index.bloom import place_file_index
            from paimon_tpu_torch.index.file_index import build_indexes_blob
            blob = build_indexes_blob(chunk, self.index_spec,
                                      self.bloom_fpp)
            embedded_index, extra_files = place_file_index(
                self.file_io, self.path_factory, partition, bucket, name,
                blob, self.index_in_manifest_threshold)
        return DataFileMeta(
            file_name=name,
            file_size=size,
            row_count=chunk.num_rows,
            min_key=b"",
            max_key=b"",
            key_stats=SimpleStats.EMPTY,
            value_stats=value_stats,
            min_sequence_number=first_seq,
            max_sequence_number=first_seq + chunk.num_rows - 1,
            schema_id=self.schema.id,
            level=0,
            file_source=file_source,
            embedded_index=embedded_index,
            extra_files=extra_files + blob_extras,
            external_path=external,
        )


class _AppendBucketWriter:
    """Buffered state for one (partition, bucket) of an append table.

    Same concurrency contract as the pk `_BucketWriter`
    (parallel/write_pipeline.py): sequence ranges are reserved at
    flush-*scheduling* time on the single-threaded caller, the
    encode/upload body runs as a pooled task, and tasks for this bucket
    execute in submission order so `new_files` publishes
    deterministically."""

    def __init__(self, parent: "AppendOnlyFileStoreWrite", partition: Tuple,
                 bucket: int):
        self.parent = parent
        self.partition = partition
        self.bucket = bucket
        self.buffers: List[pa.Table] = []
        self.buffered_bytes = 0
        self.next_seq: Optional[int] = None
        self.new_files: List[DataFileMeta] = []

    def pending_bytes(self) -> int:
        return self.buffered_bytes

    def write(self, table: pa.Table):
        self.buffers.append(table)
        self.buffered_bytes += table.nbytes
        if self.buffered_bytes >= self.parent.options.write_buffer_size:
            self.flush()

    def flush(self):
        if not self.buffers:
            return
        raw = pa.concat_tables(self.buffers, promote_options="none")
        self.buffers = []
        est = self.buffered_bytes
        self.buffered_bytes = 0
        if self.next_seq is None:
            self.next_seq = self.parent.restore_max_seq(
                self.partition, self.bucket) + 1
        # the sequence range is reserved HERE (caller thread), so
        # pipelined flushes can never duplicate or reorder ranges
        first_seq = self.next_seq
        self.next_seq += raw.num_rows

        def task(raw=raw, first_seq=first_seq):
            metas = self.parent.file_writer.write(
                self.partition, self.bucket, raw, first_seq)
            # publish after the upload succeeded (retry-safe: retried
            # attempts pick fresh file names)
            self.new_files.extend(metas)

        self.parent.flush_pool().submit((self.partition, self.bucket),
                                        est, task)

    def take_commit_message(self) -> Optional[CommitMessage]:
        msg = CommitMessage(self.partition, self.bucket,
                            self.parent.total_buckets,
                            new_files=list(self.new_files))
        self.new_files = []
        return None if msg.is_empty() else msg


class AppendOnlyFileStoreWrite:
    """reference operation/AppendFileStoreWrite.java + AppendOnlyWriter:
    inserts only, bucket by bucket-key hash (or single unaware bucket)."""

    def __init__(self, file_io: FileIO, table_path: str,
                 table_schema: TableSchema, options: CoreOptions,
                 restore_max_seq: Optional[Callable[[Tuple, int], int]]
                 = None):
        from paimon_tpu_torch.parallel.write_pipeline import maybe_wrap_staging
        file_io, self._stager = maybe_wrap_staging(file_io, options)
        self.file_io = file_io
        self.schema = table_schema
        self.options = options
        self.partition_keys = table_schema.partition_keys
        self.path_factory = FileStorePathFactory.from_options(
            table_path, self.partition_keys, options)
        self.file_writer = AppendFileWriter.from_options(
            file_io, self.path_factory, table_schema, options)
        self.total_buckets = options.bucket
        self._unaware = options.bucket < 1
        if not self._unaware:
            bucket_keys = table_schema.bucket_keys()
            if not bucket_keys:
                raise ValueError(
                    "append table with bucket >= 1 requires 'bucket-key' "
                    "(reference SchemaValidation)")
            rt = table_schema.logical_row_type()
            self.bucket_assigner = FixedBucketAssigner(
                bucket_keys, [rt.get_field(k).type for k in bucket_keys],
                options.bucket)
        self._writers: Dict[Tuple, _AppendBucketWriter] = {}
        self._flush_pool = None       # lazily built (write_pipeline)
        self._restore_max_seq = restore_max_seq

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

    def write_arrow(self, table: pa.Table,
                    row_kinds: Optional[np.ndarray] = None):
        if ROW_KIND_COL in table.column_names:
            row_kinds = np.asarray(table.column(ROW_KIND_COL)
                                   .combine_chunks().cast(pa.int8()))
            table = table.drop_columns([ROW_KIND_COL])
        if row_kinds is not None and \
                (np.asarray(row_kinds, np.int8) != RowKind.INSERT).any():
            raise ValueError("append-only table accepts INSERT rows only "
                             "(reference AppendOnlyWriter)")

        if self._unaware:
            buckets = np.zeros(table.num_rows, dtype=np.int32)
        else:
            buckets = self.bucket_assigner.assign(table)
        from paimon_tpu_torch.parallel.write_pipeline import lpt_order
        groups = group_by_partition_bucket(table, buckets,
                                           self.partition_keys)
        for (part, bucket), idx in lpt_order(groups):
            sub = table.take(pa.array(idx))
            key = (part, bucket)
            if key not in self._writers:
                self._writers[key] = _AppendBucketWriter(self, part, bucket)
            self._writers[key].write(sub)

    def prepare_commit(self) -> List[CommitMessage]:
        # barrier: schedule the final flushes largest-first, drain the
        # pool (first worker error re-raises), then assemble messages
        for w in sorted(self._writers.values(),
                        key=lambda w: -w.pending_bytes()):
            w.flush()
        self.flush_pool().drain()
        out = []
        for w in self._writers.values():
            msg = w.take_commit_message()
            if msg is not None:
                out.append(msg)
        if self._stager is not None:
            # durability barrier: all staged uploads acked before any
            # commit message leaves (see core/write.py)
            self._stager.drain()
        return out

    def close(self):
        if self._flush_pool is not None:
            self._flush_pool.shutdown(wait=True)
            self._flush_pool = None
        if self._stager is not None:
            self._stager.close()
        self._writers.clear()


class AppendSplitRead:
    """No-merge read over append splits (reference RawFileSplitRead used
    by AppendOnlyFileStoreTable)."""

    def __init__(self, file_io: FileIO, table_path: str,
                 schema: TableSchema, options: CoreOptions,
                 schema_manager: Optional[SchemaManager] = None,
                 device=None):
        self.file_io = file_io
        self.schema = schema
        self.options = options
        self.schema_manager = schema_manager
        self.device = device
        self._with_row_ids = False
        self.path_factory = FileStorePathFactory.from_options(
            table_path, schema.partition_keys, options)
        self._schema_cache: Dict[int, TableSchema] = {schema.id: schema}
        self._projection: Optional[List[str]] = None
        self._predicate: Optional[Predicate] = None
        self._file_index_cache: Dict[tuple, object] = {}
        self._arrow_types: Optional[Dict[str, object]] = None

    def with_projection(self, columns) -> "AppendSplitRead":
        self._projection = list(columns) if columns else None
        return self

    def with_filter(self, predicate) -> "AppendSplitRead":
        self._predicate = predicate
        return self

    def with_row_ids(self, flag: bool = True) -> "AppendSplitRead":
        """Materialize `_ROW_ID` (file first_row_id + offset) on reads
        of row-tracked tables (reference SpecialFields.ROW_ID)."""
        self._with_row_ids = flag
        return self

    def arrow_type_of(self, column: str):
        for f in self.schema.fields:
            if f.name == column:
                return data_type_to_arrow(f.type)
        raise KeyError(column)

    def read_file(self, split: DataSplit, meta,
                  wanted=None) -> pa.Table:
        """One file, schema-evolved, unfiltered (evolution groups need
        whole ranges so row positions stay aligned); blob columns
        outside `wanted` are dropped unread.  Transient store
        faults retry under read.retry.* (parallel/scan_pipeline.py)."""
        from paimon_tpu_torch.parallel.scan_pipeline import read_file_retrying
        t = read_file_retrying(lambda: self._read_kv(split, meta, wanted),
                               self.options, what=meta.file_name)
        return self._evolve(t, meta.schema_id)

    def _read_kv(self, split: DataSplit, meta, wanted=None) -> pa.Table:
        """One data file's columns as stored, its blob columns resolved
        from the sidecar (those outside `wanted` dropped unread)."""
        from paimon_tpu_torch.core.kv_file import read_kv_file
        return read_kv_file(self.file_io, self.path_factory,
                            split.partition, split.bucket, meta,
                            schema=self.schema,
                            schema_manager=self.schema_manager,
                            wanted=set(wanted) if wanted else None,
                            options=self.options, device=self.device)

    def _value_columns(self) -> List[str]:
        names = [f.name for f in self.schema.fields]
        if self._projection:
            return [n for n in names if n in set(self._projection)]
        return names

    def _index_selection(self, split: DataSplit, meta, num_rows: int):
        """Superset row mask from the file's bitmap/BSI/range-bitmap
        indexes (reference fileindex/bitmap/BitmapIndexResult.java row
        filtering); None when no index narrows the file.  The exact
        predicate is re-applied after, so supersets are safe."""
        if self._predicate is None:
            return None
        from paimon_tpu_torch.index.file_index import (
            read_indexes_blob, read_indexes_file, row_selection,
        )
        # keyed by the meta's identity: rewrite_file_index keeps the
        # file name and replaces its indexes
        key = (tuple(split.partition), split.bucket, meta.file_name,
               meta.embedded_index, tuple(meta.extra_files))
        fi = self._file_index_cache.get(key)
        if fi is None:
            fi = read_indexes_blob(meta.embedded_index)
            sidecar = None if fi else next(
                (x for x in meta.extra_files if x.endswith(".index")), None)
            if sidecar is not None:
                # the entries of the predicate's columns only
                try:
                    fi = read_indexes_file(
                        self.file_io, self.path_factory.data_file_path(
                            split.partition, split.bucket, sidecar),
                        set(self._predicate.fields()))
                except FileNotFoundError:
                    pass
            self._file_index_cache[key] = fi
        if not fi:
            return None
        if self._arrow_types is None:
            self._arrow_types = {}
            for f in self.schema.fields:
                try:
                    self._arrow_types[f.name] = data_type_to_arrow(f.type)
                except (ValueError, NotImplementedError):
                    pass
        return row_selection(fi, self._predicate, num_rows,
                             self._arrow_types)

    def read_split(self, split: DataSplit) -> pa.Table:
        from paimon_tpu_torch.core.read import ROW_KIND_COL as RK
        from paimon_tpu_torch.core.row_tracking import (
            ROW_ID_COL, anchor_of, group_row_ranges, read_evolution_group,
        )
        from paimon_tpu_torch.parallel.scan_pipeline import (
            read_or_skip_corrupt,
        )

        want_rid = self._with_row_ids
        groups = group_row_ranges(split.data_files)
        has_evolution = any(len(g) > 1 for g in groups)

        tables = []
        if has_evolution or want_rid:
            # row-range path (reference DataEvolutionSplitRead): each
            # group yields its current rows, columns from newest writers
            cols = list(self._value_columns())
            if want_rid:
                cols.append(ROW_ID_COL)
            for group in sorted(
                    groups,
                    key=lambda g: (anchor_of(g).first_row_id
                                   if anchor_of(g).first_row_id is not None
                                   else -1,
                                   anchor_of(g).min_sequence_number)):
                anchor = anchor_of(group)

                def load(group=group, anchor=anchor):
                    if len(group) == 1 and anchor.first_row_id is None:
                        t = self.read_file(
                            split, anchor,
                            wanted=self._value_columns())
                        t = self._fill_partition_columns(
                            t, set(t.column_names), split.partition) \
                            .select(self._value_columns())
                        if want_rid:
                            t = t.append_column(
                                ROW_ID_COL,
                                pa.nulls(t.num_rows, pa.int64()))
                        return t
                    t = read_evolution_group(self, split, group, cols)
                    return self._fill_partition_columns(
                        t, set(t.column_names), split.partition)

                # corrupt -> skip the WHOLE group (row positions inside
                # a group must stay aligned, partial reads cannot);
                # retry=False: read_file already retries transients
                t = read_or_skip_corrupt(
                    load, self.options,
                    f"evolution group at {anchor.file_name}",
                    retry=False)
                if t is None:
                    continue
                if split.deletion_vectors and \
                        anchor.file_name in split.deletion_vectors and \
                        self.options.get(
                            CoreOptions.DELETION_VECTORS_MERGE_ON_READ):
                    dv = split.deletion_vectors[anchor.file_name]
                    t = t.filter(pa.array(dv.keep_mask(t.num_rows)))
                tables.append(t)
        else:
            for meta in sorted(split.data_files,
                               key=lambda f: f.min_sequence_number):
                t = read_or_skip_corrupt(
                    lambda meta=meta: self._read_kv(
                        split, meta, self._value_columns()),
                    self.options, f"data file {meta.file_name}")
                if t is None:
                    continue
                raw_cols = set(t.column_names)
                t = self._evolve(t, meta.schema_id)
                t = self._fill_partition_columns(t, raw_cols,
                                                 split.partition)
                keep = self._index_selection(split, meta, t.num_rows)
                if split.deletion_vectors and \
                        meta.file_name in split.deletion_vectors and \
                        self.options.get(
                            CoreOptions.DELETION_VECTORS_MERGE_ON_READ):
                    dv = split.deletion_vectors[meta.file_name]
                    dv_keep = np.asarray(dv.keep_mask(t.num_rows))
                    keep = dv_keep if keep is None else (keep & dv_keep)
                if keep is not None:
                    t = t.filter(pa.array(keep))
                tables.append(t)
        out = pa.concat_tables(tables, promote_options="none") if tables \
            else self._empty()
        if self._predicate is not None:
            out = out.filter(self._predicate.to_arrow())
        keep_cols = self._value_columns()
        if want_rid and ROW_ID_COL in out.column_names:
            keep_cols = keep_cols + [ROW_ID_COL]
        out = out.select(keep_cols)
        if split.for_streaming:
            out = out.append_column(
                RK, pa.array(np.zeros(out.num_rows, np.int8), pa.int8()))
        return out

    def iter_splits(self, splits: Sequence[DataSplit], *,
                    ordered: bool = True):
        """(index, split, table) through the bounded prefetch pipeline
        (parallel/scan_pipeline.py)."""
        from paimon_tpu_torch.parallel.scan_pipeline import iter_split_tables
        return iter_split_tables(self, splits, self.options,
                                 ordered=ordered)

    def read_splits(self, splits: Sequence[DataSplit],
                    streaming: Optional[bool] = None) -> pa.Table:
        tables = [t for _, _, t in self.iter_splits(splits)
                  if t.num_rows > 0]
        if not tables:
            from paimon_tpu_torch.core.read import ROW_KIND_COL as RK
            if streaming is None:
                streaming = any(s.for_streaming for s in splits)
            out = self._empty().select(self._value_columns())
            if streaming:
                out = out.append_column(RK, pa.array([], pa.int8()))
            return out
        return pa.concat_tables(tables, promote_options="default")

    def _empty(self) -> pa.Table:
        return pa.table({f.name: pa.array([], data_type_to_arrow(f.type))
                         for f in self.schema.fields})

    def _evolve(self, table: pa.Table, file_schema_id: int) -> pa.Table:
        from paimon_tpu_torch.core.read import evolve_table
        return evolve_table(table, file_schema_id, self.schema,
                            self.schema_manager, self._schema_cache)

    def _fill_partition_columns(self, t: pa.Table, raw_cols: set,
                                partition: Tuple) -> pa.Table:
        """Partition columns ABSENT from the stored file are constants
        derived from the partition path — fill them (reference
        PartitionInfo patching in the data-file readers; this is what
        makes migrated hive files, which never store partition values,
        readable as paimon rows)."""
        pkeys = self.schema.partition_keys
        if not pkeys or not partition:
            return t
        by_name = {f.name: f for f in self.schema.fields}
        for k, v in zip(pkeys, partition):
            if k in raw_cols or k not in by_name:
                continue
            typ = data_type_to_arrow(by_name[k].type)
            const = pa.repeat(pa.scalar(v).cast(typ), t.num_rows)
            if k in t.column_names:
                t = t.set_column(t.column_names.index(k), k, const)
            else:
                t = t.append_column(k, const)
        return t


@dataclass
class AppendCompactResult:
    before: List[DataFileMeta]
    after: List[DataFileMeta]
    changelog: List[DataFileMeta] = dc_field(default_factory=list)
    # DV index rewrites accompanying the data rewrite
    index_entries: List = dc_field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.before


def append_compact_plan(files: List[DataFileMeta], options: CoreOptions,
                        full: bool = False,
                        dvs: Optional[dict] = None
                        ) -> Optional[List[DataFileMeta]]:
    """Pick the files to rewrite (reference
    BucketedAppendCompactManager.pickCompactBefore: contiguous run of
    small files, oldest first, at least compaction.min.file-num, stopping
    once the accumulated size reaches the target).

    'Small' = below target-file-size * compaction.small-file-ratio, so
    outputs that compressed slightly under target are not re-compacted
    forever; files whose deletion vectors exceed
    compaction.delete-ratio-threshold count as compactable regardless
    of size, and are force-picked even alone (reference
    CoreOptions.COMPACTION_DELETE_RATIO_THRESHOLD)."""
    if not files or (len(files) < 2 and not dvs):
        return None
    ordered = sorted(files, key=lambda f: f.min_sequence_number)
    if full:
        return ordered if len(ordered) > 1 or dvs else None
    target = options.target_file_size
    small_limit = target * options.get(
        CoreOptions.COMPACTION_SMALL_FILE_RATIO)
    del_threshold = options.get(
        CoreOptions.COMPACTION_DELETE_RATIO_THRESHOLD)

    def delete_heavy(f: DataFileMeta) -> bool:
        if not dvs or f.file_name not in dvs:
            return False
        return dvs[f.file_name].cardinality() > \
            del_threshold * max(f.row_count, 1)

    min_num = options.get(CoreOptions.COMPACTION_MIN_FILE_NUM)
    picked: List[DataFileMeta] = []
    size = 0
    for f in ordered:
        if f.file_size < small_limit or delete_heavy(f):
            picked.append(f)
            size += f.file_size
            if size >= target and len(picked) >= min_num:
                return picked
        else:
            if len(picked) >= min_num:
                return picked
            picked, size = [], 0
    if len(picked) >= min_num:
        return picked
    # delete-heavy files are force-compacted even below min-file-num:
    # reclaiming dead rows beats file-count heuristics. The pick MUST
    # stay a contiguous slice of the sequence order — rewriting a
    # non-adjacent set would emit a file whose sequence range overlaps
    # the files in between — so take the first maximal run of
    # consecutive delete-heavy files only.
    for i, f in enumerate(ordered):
        if delete_heavy(f):
            j = i + 1
            while j < len(ordered) and delete_heavy(ordered[j]):
                j += 1
            return ordered[i:j]
    return None
