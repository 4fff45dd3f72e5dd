"""KeyValue data-file writer/reader.

Counterpart of paimon_tpu/core/kv_file.py.  Blob columns go to the
data file's `.blob` sidecar, descriptor structs in their place
(format/blob.py), and a read given the table's schema resolves them.
A data file's column indexes (file-index.*: bloom, bitmap, bit-sliced,
range-bitmap) are built from the written chunk and
embedded in its meta or written as its `.index` sidecar; changelog
files are written by `write_changelog_file`, and parquet reads take the
device decode plane (format/rawpage.py) under read.device-decode.

reference: paimon-core/.../io/KeyValueDataFileWriter.java (flattens
KeyValue to `_KEY_<k...>, _SEQUENCE_NUMBER, _VALUE_KIND, value...`),
RollingFileWriter (target-size rolling), KeyValueFileReaderFactory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.data.binary_row import BinaryRowCodec
from paimon_tpu_torch.format import get_format
from paimon_tpu_torch.format.format import extract_simple_stats
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import DataFileMeta, FileSource, SimpleStats
from paimon_tpu_torch.ops.merge import KIND_COL, SEQ_COL
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.types import DataType, SpecialFields
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["KeyValueFileWriter", "read_kv_file", "write_changelog_file",
           "KEY_PREFIX"]

KEY_PREFIX = SpecialFields.KEY_FIELD_PREFIX


class KeyValueFileWriter:
    """Writes sorted KV tables into rolling data files with stats."""

    def __init__(self, file_io: FileIO, path_factory: FileStorePathFactory,
                 table_schema: TableSchema, file_format: str = "parquet",
                 compression: str = "zstd",
                 target_file_size: int = 128 << 20,
                 index_spec: Optional[Dict[str, List[str]]] = None,
                 bloom_fpp: float = 0.01,
                 index_in_manifest_threshold: int = 500,
                 format_per_level: Optional[Dict[int, str]] = None,
                 format_options: Optional[Dict[str, str]] = None,
                 compression_per_level: Optional[Dict[int, str]] = None,
                 target_file_row_num: Optional[int] = None,
                 stats_mode_per_level: Optional[Dict[int, str]] = None,
                 stats_keep_first_n: Optional[int] = None):
        self.file_io = file_io
        self.path_factory = path_factory
        self.schema = table_schema
        self.file_format = file_format
        self.format_per_level = format_per_level or {}
        self.format_options = format_options or {}
        self.compression = compression
        self.compression_per_level = compression_per_level or {}
        self.target_file_size = target_file_size
        self.index_spec = index_spec or {}
        self.bloom_fpp = bloom_fpp
        self.index_in_manifest_threshold = index_in_manifest_threshold
        self.target_file_row_num = target_file_row_num
        self.stats_mode_per_level = stats_mode_per_level or {}
        self.stats_keep_first_n = stats_keep_first_n
        self.trimmed_pk = table_schema.trimmed_primary_keys()
        self.key_cols = [KEY_PREFIX + k for k in self.trimmed_pk]
        rt = table_schema.logical_row_type()
        self.key_types: List[DataType] = [rt.get_field(k).type
                                          for k in self.trimmed_pk]
        self._key_codec = BinaryRowCodec(
            [t.copy(False) for t in self.key_types])

    def write(self, partition: Tuple, bucket: int, kv_table: pa.Table,
              level: int,
              file_source: int = FileSource.APPEND) -> List[DataFileMeta]:
        """Write a sorted KV table, rolling at target_file_size.
        Returns DataFileMeta per file written."""
        if kv_table.num_rows == 0:
            return []
        n = kv_table.num_rows
        bytes_per_row = max(1, kv_table.nbytes // n)
        rows_per_file = max(1024, self.target_file_size // bytes_per_row)
        if self.target_file_row_num:
            # target-file-row-num: roll by rows too
            rows_per_file = min(rows_per_file, self.target_file_row_num)
        metas = []
        for start in range(0, n, rows_per_file):
            chunk = kv_table.slice(start, min(rows_per_file, n - start))
            metas.append(self._write_one(partition, bucket, chunk, level,
                                         file_source))
        return metas

    def _write_one(self, partition: Tuple, bucket: int, chunk: pa.Table,
                   level: int, file_source: int) -> DataFileMeta:
        fmt = get_format(self.format_per_level.get(level,
                                                   self.file_format))
        compression = self.compression_per_level.get(level,
                                                     self.compression)
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
        size = fmt.create_writer(compression,
                                 self.format_options).write(
            self.file_io, path, chunk)

        # key stats + min/max key (first/last row: chunk is key-sorted)
        kmins, kmaxs, knulls = extract_simple_stats(chunk, self.key_cols)
        key_stats = SimpleStats.from_values(
            [t.copy(False) for t in self.key_types], kmins, kmaxs, knulls)
        first = [chunk.column(c)[0].as_py() for c in self.key_cols]
        last = [chunk.column(c)[-1].as_py() for c in self.key_cols]

        value_cols = [f.name for f in self.schema.fields]
        value_types = [f.type for f in self.schema.fields]
        stats_mode = self.stats_mode_per_level.get(level)
        if stats_mode == "none":
            # metadata.stats-mode.per.level 'N:none': skip stats work
            # for short-lived files (planning treats absent stats as
            # unknown and never prunes on them)
            nil = [None] * len(value_cols)
            value_stats = _safe_stats(value_types, nil, nil,
                                      [None] * len(value_cols))
        else:
            vmins, vmaxs, vnulls = extract_simple_stats(chunk, value_cols)
            if self.stats_keep_first_n is not None:
                # metadata.stats-keep-first-n-columns: null out the rest
                k = self.stats_keep_first_n
                vmins = list(vmins[:k]) + [None] * (len(value_cols) - k)
                vmaxs = list(vmaxs[:k]) + [None] * (len(value_cols) - k)
            value_stats = _safe_stats(value_types, vmins, vmaxs, vnulls)

        seq = chunk.column(SEQ_COL)
        import pyarrow.compute as pc
        seq_min = pc.min(seq).as_py()
        seq_max = pc.max(seq).as_py()
        kinds = np.asarray(chunk.column(KIND_COL).combine_chunks()
                           .cast(pa.int8()))
        delete_rows = int(((kinds == 1) | (kinds == 3)).sum())

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
            min_key=self._key_codec.to_bytes(first),
            max_key=self._key_codec.to_bytes(last),
            key_stats=key_stats,
            value_stats=value_stats,
            min_sequence_number=seq_min,
            max_sequence_number=seq_max,
            schema_id=self.schema.id,
            level=level,
            delete_row_count=delete_rows,
            file_source=file_source,
            embedded_index=embedded_index,
            extra_files=extra_files + blob_extras,
            external_path=external,
        )


def _safe_stats(types: Sequence[DataType], mins, maxs, nulls) -> SimpleStats:
    """Encode stats, nulling out values BinaryRow can't carry (arrays,
    maps, rows) -- mirrors the reference's stats-mode truncation."""
    safe_mins, safe_maxs, safe_types = [], [], []
    for t, mn, mx in zip(types, mins, maxs):
        try:
            BinaryRowCodec([t]).to_bytes((mn,))
            BinaryRowCodec([t]).to_bytes((mx,))
            safe_mins.append(mn)
            safe_maxs.append(mx)
        except (ValueError, TypeError, OverflowError):
            safe_mins.append(None)
            safe_maxs.append(None)
        safe_types.append(t.as_nullable())
    codec = BinaryRowCodec(safe_types)
    return SimpleStats(codec.to_bytes(safe_mins), codec.to_bytes(safe_maxs),
                       list(nulls))


def write_changelog_file(file_io: FileIO,
                         path_factory: FileStorePathFactory,
                         schema: TableSchema, file_format: str,
                         compression: str, partition: Tuple, bucket: int,
                         table: pa.Table,
                         prefix: Optional[str] = None,
                         format_options: Optional[Dict[str, str]] = None
                         ) -> List[DataFileMeta]:
    """Write a changelog file (KV layout with _VALUE_KIND kinds kept).
    Shared by changelog-producer=input (write path) and the compaction
    changelog producers."""
    import pyarrow.compute as pc

    fmt = get_format(file_format)
    name = path_factory.new_changelog_file_name(fmt.extension, prefix)
    path, external = path_factory.new_data_file_location(
        partition, bucket, name)
    size = fmt.create_writer(compression, format_options).write(
        file_io, path, table)
    return [DataFileMeta(
        file_name=name, file_size=size, row_count=table.num_rows,
        min_key=b"", max_key=b"",
        key_stats=SimpleStats.EMPTY,
        value_stats=SimpleStats.EMPTY,
        min_sequence_number=pc.min(table.column(SEQ_COL)).as_py(),
        max_sequence_number=pc.max(table.column(SEQ_COL)).as_py(),
        schema_id=schema.id, level=0, external_path=external)]


def read_kv_file(file_io: FileIO, path_factory: FileStorePathFactory,
                 partition: Tuple, bucket: int, meta: DataFileMeta,
                 file_format: Optional[str] = None,
                 projection: Optional[List[str]] = None,
                 schema=None, schema_manager=None, wanted=None,
                 options=None, device=None) -> pa.Table:
    """Read one KV data file into Arrow.  Given `schema`, blob descriptor
    columns resolve against their `.blob` sidecar here, and blob columns
    outside `wanted` are dropped unread (format/blob.py
    maybe_resolve_blobs).  `options` (the table's) gates the footer
    cache (read.cache.footer) and, for parquet, the device decode plane
    (read.device-decode) on `device`."""
    ext = meta.file_name.rsplit(".", 1)[-1]
    fmt = get_format(file_format or ext)
    path = path_factory.data_file_path(partition, bucket, meta.file_name)
    if meta.external_path:
        path = meta.external_path
    table = None
    if fmt.identifier == "parquet" and options is not None \
            and options.get(CoreOptions.READ_DEVICE_DECODE):
        from paimon_tpu_torch.format.rawpage import maybe_read_device
        table = maybe_read_device(file_io, path, projection, options,
                                  device=device)
    if table is None:
        from paimon_tpu_torch.fs.caching import footer_cache_scope
        with footer_cache_scope(options):
            table = fmt.create_reader().read(file_io, path,
                                             projection=projection)
    if schema is not None:
        from paimon_tpu_torch.format.blob import maybe_resolve_blobs
        table = maybe_resolve_blobs(file_io, path_factory, partition,
                                    bucket, meta, table, schema,
                                    schema_manager=schema_manager,
                                    wanted=wanted)
    return table
