"""Read path: merge-on-read over DataSplits.

Counterpart of paimon_tpu/core/read.py; every merge runs on the
reader's torch device (ops/merge.py for deduplicate and first-row,
ops/agg.py for partial-update and aggregation).  Streaming splits add a
`_ROW_KIND` column: delta and changelog splits keep each row's kind,
full-phase splits emit the merged state as +I.

reference call stack (SURVEY §3.2): KeyValueTableRead ->
MergeFileSplitRead.createMergeReader (operation/MergeFileSplitRead.java:
269,287) -> MergeTreeReaders.readerForMergeTree -> per-section
SortMergeReaderWithLoserTree -> MergeFunctionWrapper -> DropDeleteReader;
fast path RawFileSplitRead.java:74.

Deviation: a split's runs are decoded to Arrow (Arrow C++ parquet),
then merged in one device kernel (ops/merge.py) instead of a record
iterator stack. Sections (IntervalPartition) are unnecessary: the sort
handles arbitrary overlap; non-overlapping byte ranges just sort cheaply.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.kv_file import KEY_PREFIX, read_kv_file
from paimon_tpu_torch.core.scan import DataSplit
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import DataFileMeta
from paimon_tpu_torch.options import CoreOptions, MergeEngine
from paimon_tpu_torch.ops.agg import merge_runs_agg
from paimon_tpu_torch.ops.merge import KIND_COL, SEQ_COL, merge_runs
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.predicate import Predicate
from paimon_tpu_torch.schema.schema_manager import SchemaManager
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.types import RowKind, data_type_to_arrow
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["MergeFileSplitRead", "assemble_runs", "ROW_KIND_COL",
           "evolve_table"]

ROW_KIND_COL = "_ROW_KIND"


def record_level_expire_filter(options: CoreOptions, table: pa.Table,
                               now_ms: Optional[int] = None) -> pa.Table:
    """Hide rows whose time field passed record-level.expire-time
    (reference io/RecordLevelExpire wrapping every reader; physical
    removal happens at compaction rewrite).  `now_ms` pins the wall
    clock for deterministic tests (same injectable-clock contract as
    remove_orphan_files)."""
    import pyarrow.compute as pc

    expire_ms = options.record_level_expire_time_ms
    field = options.record_level_time_field
    if not expire_ms or not field or field not in table.column_names:
        return table
    col = table.column(field).combine_chunks()
    t = col.type
    if pa.types.is_timestamp(t):
        vals_ms = np.asarray(col.cast(pa.int64()).fill_null(0))
        unit = {"s": 1000, "ms": 1, "us": 1 / 1000,
                "ns": 1 / 1_000_000}[t.unit]
        vals_ms = (vals_ms * unit).astype(np.int64)
    elif pa.types.is_int32(t):
        vals_ms = np.asarray(col.fill_null(0)).astype(np.int64) * 1000
    else:
        vals_ms = np.asarray(col.cast(pa.int64()).fill_null(0))
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    cutoff = now_ms - expire_ms
    keep = (vals_ms >= cutoff) | np.asarray(pc.is_null(col))
    if keep.all():
        return table
    return table.filter(pa.array(keep))


def evolve_table(table: pa.Table, file_schema_id: int, schema: TableSchema,
                 schema_manager: Optional[SchemaManager],
                 cache: Dict[int, TableSchema],
                 keep_sys_cols: bool = False) -> pa.Table:
    """Map an old-schema file onto the read schema by field id
    (reference schema/SchemaEvolutionUtil.java index+cast mapping).
    Shared by both split readers and both compaction rewriters.

    Same-schema files still get a cheap per-column type check + cast:
    schema-inferring formats (csv/json) may decode e.g. float32 as
    float64 or timestamps as strings."""
    if file_schema_id == schema.id:
        needs_cast = False
        for f in schema.fields:
            if f.name in table.column_names and \
                    table.column(f.name).type != data_type_to_arrow(f.type):
                needs_cast = True
                break
        if not needs_cast:
            return table
        cols = {}
        for name in table.column_names:
            col = table.column(name)
            if name.startswith(KEY_PREFIX) or name in (SEQ_COL, KIND_COL):
                cols[name] = col
                continue
            f = next((x for x in schema.fields if x.name == name), None)
            if f is None:
                cols[name] = col
                continue
            at = data_type_to_arrow(f.type)
            cols[name] = col.cast(at) if col.type != at else col
        return pa.table(cols)
    old = cache.get(file_schema_id)
    if old is None:
        if schema_manager is None:
            return table
        old = schema_manager.schema(file_schema_id)
        cache[file_schema_id] = old
    old_by_id = {f.id: f for f in old.fields}
    new_by_name = {f.name: f for f in schema.fields}
    cols = {}
    n = table.num_rows
    if keep_sys_cols:
        for name in table.column_names:
            if name.startswith(KEY_PREFIX) and \
                    name[len(KEY_PREFIX):] in new_by_name:
                # a key column whose type changed is cast like its value
                # column, so runs of both schemas merge on one key type
                # (the reference keeps each file's own key type here,
                # and its runs then fail to concatenate)
                f = new_by_name[name[len(KEY_PREFIX):]]
                cols[name] = _cast_evolved(table.column(name),
                                           old_by_id.get(f.id), f)
            elif name.startswith(KEY_PREFIX) or \
                    name in (SEQ_COL, KIND_COL):
                cols[name] = table.column(name)
    for f in schema.fields:
        old_f = old_by_id.get(f.id)
        if old_f is None or old_f.name not in table.column_names:
            cols[f.name] = pa.nulls(n, data_type_to_arrow(f.type))
        else:
            cols[f.name] = _cast_evolved(table.column(old_f.name), old_f, f)
    return pa.table(cols)


def _cast_evolved(col, old_f, f):
    """`col` (written as `old_f`) at `f`'s type: the CastExecutor rule
    matrix (Java narrowing/parse/temporal semantics), not the bare Arrow
    cast (paimon-common casting/)."""
    if old_f is None or col.type == data_type_to_arrow(f.type):
        return col
    from paimon_tpu_torch.data.casting import cast_array
    return cast_array(col, old_f.type, f.type)


def assemble_runs(files: Sequence[DataFileMeta]) -> List[List[DataFileMeta]]:
    """Order a bucket's files into sorted runs, oldest first.

    Levels >=1 are each one key-sorted non-overlapping run (older = higher
    level). Each L0 file is its own run, ordered by max sequence number
    (reference mergetree/Levels.java:39 + MergeTreeReaders.readerForMergeTree).
    """
    by_level: Dict[int, List[DataFileMeta]] = {}
    for f in files:
        by_level.setdefault(f.level, []).append(f)
    runs: List[List[DataFileMeta]] = []
    for level in sorted((l for l in by_level if l > 0), reverse=True):
        level_files = sorted(by_level[level], key=lambda f: f.min_key)
        runs.append(level_files)
    for f in sorted(by_level.get(0, []),
                    key=lambda f: (f.max_sequence_number,
                                   f.min_sequence_number)):
        runs.append([f])
    return runs


class MergeFileSplitRead:
    """Reads DataSplits with merge (or raw when safe)."""

    def __init__(self, file_io: FileIO, table_path: str,
                 schema: TableSchema, options: CoreOptions,
                 schema_manager: Optional[SchemaManager] = None,
                 device=None):
        self.file_io = file_io
        self.device = device
        self.table_path = table_path
        self.schema = schema
        self.options = options
        self.schema_manager = schema_manager
        self.path_factory = FileStorePathFactory.from_options(
            table_path, schema.partition_keys, options)
        self.trimmed_pk = schema.trimmed_primary_keys()
        self.key_cols = [KEY_PREFIX + k for k in self.trimmed_pk]
        rt = schema.logical_row_type()
        self.key_encoder = NormalizedKeyEncoder(
            [data_type_to_arrow(rt.get_field(k).type)
             for k in self.trimmed_pk],
            nullable=[rt.get_field(k).type.nullable
                      for k in self.trimmed_pk])
        self._schema_cache: Dict[int, TableSchema] = {schema.id: schema}
        self._projection: Optional[List[str]] = None
        self._predicate: Optional[Predicate] = None

    def with_projection(self, columns: Optional[List[str]]
                        ) -> "MergeFileSplitRead":
        self._projection = list(columns) if columns else None
        return self

    def with_filter(self, predicate: Optional[Predicate]
                    ) -> "MergeFileSplitRead":
        self._predicate = predicate
        return self

    # -- split read ----------------------------------------------------------

    def read_split(self, split: DataSplit) -> pa.Table:
        value_cols = self._value_columns()
        if self.options.get(CoreOptions.TABLE_READ_SEQUENCE_NUMBER):
            # expose _SEQUENCE_NUMBER as a metadata column (reference
            # table-read.sequence-number.enabled)
            value_cols = value_cols + [SEQ_COL]
        read_cols = self.key_cols + [SEQ_COL, KIND_COL] + value_cols
        read_cols = list(dict.fromkeys(read_cols))
        if split.raw_convertible:
            out = self._read_raw(split, read_cols, value_cols)
        else:
            out = self._read_merged(split, read_cols, value_cols)
        out = record_level_expire_filter(self.options, out)
        if self._predicate is not None:
            out = out.filter(self._predicate.to_arrow())
        return out

    def iter_splits(self, splits: Sequence[DataSplit]
                    ) -> Iterator[Tuple[int, DataSplit, pa.Table]]:
        """(index, split, table) in split order, read by the split pool
        (parallel/scan_pipeline.py)."""
        from paimon_tpu_torch.parallel.scan_pipeline import iter_split_tables
        return iter_split_tables(self, splits, self.options)

    def read_splits(self, splits: Sequence[DataSplit],
                    streaming: Optional[bool] = None) -> pa.Table:
        tables = [t for _, _, t in self.iter_splits(splits)
                  if t.num_rows > 0]
        if not tables:
            if streaming is None:
                streaming = any(s.for_streaming for s in splits)
            return self._empty_table(streaming)
        return pa.concat_tables(tables, promote_options="default")

    def _empty_table(self, streaming: bool) -> pa.Table:
        """Typed empty result with a schema identical to non-empty reads
        (streaming polls always carry _ROW_KIND)."""
        by_name = {f.name: f for f in self.schema.fields}
        cols = {c: pa.array([], data_type_to_arrow(by_name[c].type))
                for c in self._value_columns()}
        if self.options.get(CoreOptions.TABLE_READ_SEQUENCE_NUMBER):
            cols[SEQ_COL] = pa.array([], pa.int64())
        if streaming:
            cols[ROW_KIND_COL] = pa.array([], pa.int8())
        return pa.table(cols)

    def _value_columns(self) -> List[str]:
        names = [f.name for f in self.schema.fields]
        if self._projection:
            # key, pk, user-sequence and record-expire time columns are
            # read regardless; output honors the projection
            keep = set(self._projection) | set(self.trimmed_pk) \
                | set(self.options.sequence_field)
            if self.options.record_level_time_field:
                keep.add(self.options.record_level_time_field)
            return [n for n in names if n in keep]
        return names

    def _read_file(self, split: DataSplit, meta: DataFileMeta,
                   read_cols: List[str]) -> Optional[pa.Table]:
        """One data file under the read-path fault policy: transient
        store faults retry (read.retry.*); None when the file is
        unreadable and scan.ignore-corrupt-files skips it."""
        from paimon_tpu_torch.parallel.scan_pipeline import (
            read_or_skip_corrupt,
        )
        table = read_or_skip_corrupt(
            lambda: read_kv_file(self.file_io, self.path_factory,
                                 split.partition, split.bucket, meta,
                                 schema=self.schema,
                                 schema_manager=self.schema_manager,
                                 wanted=set(read_cols),
                                 options=self.options, device=self.device),
            self.options, f"data file {meta.file_name}")
        if table is None:
            return None
        table = self._evolve(table, meta.schema_id)
        if split.deletion_vectors and \
                meta.file_name in split.deletion_vectors and \
                self.options.get(CoreOptions.DELETION_VECTORS_MERGE_ON_READ):
            dv = split.deletion_vectors[meta.file_name]
            table = table.filter(pa.array(dv.keep_mask(table.num_rows)))
        return table.select(read_cols)

    def _read_raw(self, split: DataSplit, read_cols: List[str],
                  value_cols: List[str]) -> pa.Table:
        tables = [t for t in (self._read_file(split, f, read_cols)
                              for f in sorted(split.data_files,
                                              key=lambda f: f.min_key))
                  if t is not None]
        if not tables:
            return self._empty_table(split.for_streaming)
        merged = pa.concat_tables(tables, promote_options="none")
        if split.for_streaming and split.is_delta:
            # changelog consumers observe every row with its kind
            # (reference streaming read preserves RowKind; -U/-D survive)
            out = merged.select(value_cols)
            return out.append_column(
                ROW_KIND_COL,
                merged.column(KIND_COL).combine_chunks().cast(pa.int8()))
        kinds = np.asarray(merged.column(KIND_COL).combine_chunks()
                           .cast(pa.int8()))
        keep = (kinds == RowKind.INSERT) | (kinds == RowKind.UPDATE_AFTER)
        if not keep.all():
            merged = merged.filter(pa.array(keep))
        return self._as_inserts(merged.select(value_cols),
                                split.for_streaming)

    @staticmethod
    def _as_inserts(out: pa.Table, streaming: bool) -> pa.Table:
        """Full-phase streaming rows are the merged state: all +I."""
        if not streaming:
            return out
        return out.append_column(
            ROW_KIND_COL,
            pa.array(np.zeros(out.num_rows, np.int8), pa.int8()))

    def _read_merged(self, split: DataSplit, read_cols: List[str],
                     value_cols: List[str]) -> pa.Table:
        runs_meta = assemble_runs(split.data_files)
        runs = []
        for run_files in runs_meta:
            tables = [t for t in (self._read_file(split, f, read_cols)
                                  for f in run_files) if t is not None]
            if not tables:
                continue                  # whole run corrupt and skipped
            runs.append(pa.concat_tables(tables, promote_options="none")
                        if len(tables) > 1 else tables[0])
        if not runs:
            return self._empty_table(split.for_streaming)
        engine = self.options.merge_engine
        seq_fields = self.options.sequence_field or None
        from paimon_tpu_torch.metrics import SCAN_MERGE_MS
        from paimon_tpu_torch.obs.trace import span
        with span("scan.merge", cat="scan", group="scan",
                  metric=SCAN_MERGE_MS, engine=engine,
                  partition=split.partition, bucket=split.bucket,
                  runs=len(runs), rows=sum(r.num_rows for r in runs)):
            if engine not in (MergeEngine.DEDUPLICATE,
                              MergeEngine.FIRST_ROW):
                out = merge_runs_agg(runs, self.key_cols, self.schema,
                                     self.options,
                                     key_encoder=self.key_encoder,
                                     seq_fields=seq_fields,
                                     device=self.device).select(value_cols)
            else:
                out = merge_runs(
                    runs, self.key_cols, merge_engine=engine,
                    key_encoder=self.key_encoder, seq_fields=seq_fields,
                    seq_desc=self.options.sequence_field_descending,
                    device=self.device).take(value_cols)
        return self._as_inserts(out, split.for_streaming)

    # -- schema evolution ----------------------------------------------------

    def _evolve(self, table: pa.Table, file_schema_id: int) -> pa.Table:
        return evolve_table(table, file_schema_id, self.schema,
                            self.schema_manager, self._schema_cache,
                            keep_sys_cols=True)
