"""FileFormat SPI: reader/writer factories over Arrow tables.

Counterpart of paimon_tpu/format/format.py: parquet and ORC data files
(Arrow C++ decode and encode), with the reference's io spans (io.read,
decode, encode, io.upload) around parquet's fetch, decode, encode and
upload; avro rows through the pure-Python codec (format/avro.py), csv
and json through pyarrow, and mosaic (format/mosaic.py), each writing
the reference's bytes.  reference boundary: paimon-common/.../format/
FileFormat.java:43 + SimpleStatsExtractor.
"""

from __future__ import annotations

import io
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.parquet as pq

try:
    from pyarrow import orc as pa_orc
except ImportError:  # pragma: no cover
    pa_orc = None

from paimon_tpu_torch.fs import FileIO

__all__ = ["FileFormatFactory", "get_format", "FormatReader",
           "FormatWriter", "extract_simple_stats", "CorruptDataError"]


class CorruptDataError(OSError):
    """Decode-time corruption: the bytes were already fetched, so the
    failure is deterministic — NOT a transient store fault, never worth
    retrying (parallel/fault.py), but eligible for the
    scan.ignore-corrupt-files skip.  Subclasses OSError because modern
    pyarrow surfaces decode corruption (torn footers, corrupt
    compressed pages) as plain OSError and existing handlers expect
    that; the distinct type is what lets the fault taxonomy separate
    'bad bytes' from 'bad store'."""


@contextmanager
def _decode_errors(path: str):
    """Re-raise decode-phase OSErrors as CorruptDataError (fetch-phase
    store faults never pass through here)."""
    try:
        yield
    except CorruptDataError:
        raise
    except OSError as e:
        raise CorruptDataError(f"corrupt data in {path}: {e}") from e


class FormatReader:
    """Reads a file into an Arrow table, with projection + row-group
    filtering."""

    def read(self, file_io: FileIO, path: str,
             projection: Optional[List[str]] = None,
             batch_size: int = 1 << 20) -> pa.Table:
        raise NotImplementedError

    def read_batches(self, file_io: FileIO, path: str,
                     projection: Optional[List[str]] = None,
                     batch_rows: int = 1 << 20):
        """Yield the file as bounded-size Arrow tables (streamed decode
        where the format supports it; whole-file fallback otherwise)."""
        yield self.read(file_io, path, projection)


class FormatWriter:
    """Writer contract: constructors take (compression, format_options)
    — format_options is the raw option map (e.g. parquet.*) and writers
    ignore keys that aren't theirs."""

    def write(self, file_io: FileIO, path: str, table: pa.Table) -> int:
        """Write table, return file size in bytes."""
        raise NotImplementedError


class _ParquetReader(FormatReader):
    @staticmethod
    def _open(file_io, path) -> "pq.ParquetFile":
        """ParquetFile over the file's bytes, reusing a previously
        parsed footer from the process footer cache (fs/caching.py)."""
        from paimon_tpu_torch.fs.caching import global_footer_cache
        from paimon_tpu_torch.metrics import IO_READ_MS
        from paimon_tpu_torch.obs.trace import span
        with span("io.read", cat="io", group="io", metric=IO_READ_MS,
                  path=path) as sp:
            data = file_io.read_bytes(path)  # store faults propagate
            sp.set(bytes=len(data))
        cache = global_footer_cache()
        md = cache.get(path)
        with _decode_errors(path):
            pf = pq.ParquetFile(io.BytesIO(data), metadata=md)
        if md is None:
            cache.put(path, pf.metadata)
        return pf

    def read(self, file_io, path, projection=None, batch_size=1 << 20):
        from paimon_tpu_torch.metrics import IO_DECODE_MS
        from paimon_tpu_torch.obs.trace import span
        pf = self._open(file_io, path)
        with _decode_errors(path), \
                span("decode", cat="io", group="io",
                     metric=IO_DECODE_MS, path=path):
            return pf.read(columns=projection)

    def read_batches(self, file_io, path, projection=None,
                     batch_rows: int = 1 << 20):
        # compressed bytes stay resident; decode is incremental per batch
        pf = self._open(file_io, path)
        with _decode_errors(path):
            for rb in pf.iter_batches(batch_size=batch_rows,
                                      columns=projection):
                yield pa.Table.from_batches([rb])


def split_compression(spec: str):
    """'zstd' or 'zstd:7' -> (codec, level or None)
    (file.compression.zstd-level wiring)."""
    if spec and ":" in spec:
        codec, _, lvl = spec.partition(":")
        try:
            return codec, int(lvl)
        except ValueError:
            return codec, None
    return spec, None


class _ParquetWriter(FormatWriter):
    def __init__(self, compression: str = "zstd",
                 row_group_rows: int = 1 << 20,
                 format_options: Optional[Dict[str, str]] = None):
        self.compression, self.level = split_compression(compression)
        fo = format_options or {}
        self.row_group_rows = int(fo.get("parquet.row-group.rows",
                                         row_group_rows))
        # file.block-size (reference CoreOptions FILE_BLOCK_SIZE):
        # parquet row-group granularity in BYTES; converted to rows per
        # table at write time
        self.block_bytes = int(fo["file.block-size"]) \
            if "file.block-size" in fo else None
        # parquet.enable.dictionary (reference parquet writer option):
        # dictionary encoding is pure overhead on high-cardinality data
        self.use_dictionary = fo.get(
            "parquet.enable.dictionary", "true").lower() != "false"

    def write(self, file_io, path, table):
        from paimon_tpu_torch.metrics import IO_ENCODE_MS, IO_UPLOAD_MS
        from paimon_tpu_torch.obs.trace import span
        buf = io.BytesIO()
        rg = self.row_group_rows
        if self.block_bytes and table.num_rows:
            per_row = max(1, table.nbytes // table.num_rows)
            rg = max(1024, self.block_bytes // per_row)
        with span("encode", cat="io", group="io", metric=IO_ENCODE_MS,
                  path=path, rows=table.num_rows):
            pq.write_table(table, buf, compression=self.compression,
                           compression_level=self.level,
                           row_group_size=rg,
                           use_dictionary=self.use_dictionary,
                           write_statistics=True)
        data = buf.getvalue()
        with span("io.upload", cat="io", group="io",
                  metric=IO_UPLOAD_MS, path=path, bytes=len(data)):
            file_io.write_bytes(path, data, overwrite=False)
        return len(data)


class FileFormatFactory:
    def __init__(self, identifier: str, reader: FormatReader,
                 writer_cls, extension: Optional[str] = None):
        self.identifier = identifier
        self.reader = reader
        self._writer_cls = writer_cls
        self.extension = extension or identifier

    def create_reader(self) -> FormatReader:
        return self.reader

    def create_writer(self, compression: str = "zstd",
                      format_options: Optional[Dict[str, str]] = None
                      ) -> FormatWriter:
        return self._writer_cls(compression,
                                 format_options=format_options)


class _OrcReader(FormatReader):
    def read(self, file_io, path, projection=None, batch_size=1 << 20):
        if pa_orc is None:
            raise RuntimeError("pyarrow.orc unavailable")
        data = file_io.read_bytes(path)      # store faults propagate
        with _decode_errors(path):
            f = pa_orc.ORCFile(io.BytesIO(data))
            return f.read(columns=projection)


class _OrcWriter(FormatWriter):
    def __init__(self, compression: str = "zstd",
                 format_options: Optional[Dict[str, str]] = None):
        self.compression, _ = split_compression(compression)
        fo = format_options or {}
        # file.block-size -> orc stripe bytes
        self.stripe_bytes = int(fo["file.block-size"]) \
            if "file.block-size" in fo else None

    def write(self, file_io, path, table):
        if pa_orc is None:
            raise RuntimeError("pyarrow.orc unavailable")
        buf = io.BytesIO()
        kw = {"stripe_size": self.stripe_bytes} if self.stripe_bytes \
            else {}
        pa_orc.write_table(table, buf,
                           compression=self.compression.upper(), **kw)
        data = buf.getvalue()
        file_io.write_bytes(path, data, overwrite=False)
        return len(data)


class _AvroRowReader(FormatReader):
    def read(self, file_io, path, projection=None, batch_size=1 << 20):
        from paimon_tpu_torch.format import avro as avro_fmt
        _, records = avro_fmt.read_container(file_io.read_bytes(path))
        table = pa.Table.from_pylist(records)
        if projection:
            table = table.select(projection)
        return table


class _AvroRowWriter(FormatWriter):
    def __init__(self, compression: str = "zstd",
                 format_options: Optional[Dict[str, str]] = None):
        compression, _ = split_compression(compression)
        self.codec = {"zstd": "zstandard", "none": "null",
                      "gzip": "deflate"}.get(compression, compression)

    def write(self, file_io, path, table):
        from paimon_tpu_torch.format import avro as avro_fmt
        schema = _arrow_to_avro_schema(table.schema)
        data = avro_fmt.write_container(schema, table.to_pylist(),
                                        codec=self.codec)
        file_io.write_bytes(path, data, overwrite=False)
        return len(data)


def _arrow_to_avro_schema(schema: pa.Schema) -> dict:
    def conv(t: pa.DataType):
        if pa.types.is_boolean(t):
            return "boolean"
        if pa.types.is_integer(t):
            return "long" if t.bit_width > 32 else "int"
        if pa.types.is_float32(t):
            return "float"
        if pa.types.is_floating(t):
            return "double"
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            return "string"
        if pa.types.is_binary(t) or pa.types.is_large_binary(t):
            return "bytes"
        if pa.types.is_timestamp(t):
            return {"type": "long", "logicalType": "timestamp-millis"}
        if pa.types.is_date(t):
            return {"type": "int", "logicalType": "date"}
        if pa.types.is_list(t):
            return {"type": "array", "items": conv(t.value_type)}
        raise ValueError(f"No avro mapping for {t}")

    return {"type": "record", "name": "Row", "fields": [
        {"name": f.name,
         "type": ["null", conv(f.type)] if f.nullable else conv(f.type),
         **({"default": None} if f.nullable else {})}
        for f in schema]}


class _CsvReader(FormatReader):
    def read(self, file_io, path, projection=None, batch_size=1 << 20):
        from pyarrow import csv as pa_csv
        data = file_io.read_bytes(path)
        table = pa_csv.read_csv(io.BytesIO(data))
        if projection:
            table = table.select(projection)
        return table


class _CsvWriter(FormatWriter):
    def __init__(self, compression: str = "none",
                 format_options: Optional[Dict[str, str]] = None):
        pass

    def write(self, file_io, path, table):
        from pyarrow import csv as pa_csv
        buf = io.BytesIO()
        pa_csv.write_csv(table, buf)
        data = buf.getvalue()
        file_io.write_bytes(path, data, overwrite=False)
        return len(data)


class _JsonReader(FormatReader):
    def read(self, file_io, path, projection=None, batch_size=1 << 20):
        from pyarrow import json as pa_json
        data = file_io.read_bytes(path)
        table = pa_json.read_json(io.BytesIO(data))
        if projection:
            table = table.select(projection)
        return table


class _JsonWriter(FormatWriter):
    def __init__(self, compression: str = "none",
                 format_options: Optional[Dict[str, str]] = None):
        pass

    def write(self, file_io, path, table):
        import json as _json
        for f in table.schema:
            if pa.types.is_binary(f.type) or pa.types.is_large_binary(
                    f.type):
                raise ValueError(
                    f"json format cannot round-trip binary column "
                    f"{f.name!r}; use parquet/orc/avro")

        def default(v):
            # temporals serialize as ISO strings; arrow casts them back
            # on read via the schema-aware evolve path
            return v.isoformat() if hasattr(v, "isoformat") else str(v)

        lines = [_json.dumps(r, default=default)
                 for r in table.to_pylist()]
        data = ("\n".join(lines) + "\n").encode("utf-8")
        file_io.write_bytes(path, data, overwrite=False)
        return len(data)


_FORMATS: Dict[str, FileFormatFactory] = {
    "parquet": FileFormatFactory("parquet", _ParquetReader(),
                                 _ParquetWriter),
    "orc": FileFormatFactory("orc", _OrcReader(), _OrcWriter),
    "avro": FileFormatFactory("avro", _AvroRowReader(), _AvroRowWriter),
    "csv": FileFormatFactory("csv", _CsvReader(), _CsvWriter),
    "json": FileFormatFactory("json", _JsonReader(), _JsonWriter),
}


def get_format(identifier: str) -> FileFormatFactory:
    """reference FileFormat.fromIdentifier (FileFormat.java:76)."""
    ident = identifier.lower()
    if ident == "mosaic" and ident not in _FORMATS:
        # registered lazily to keep module import order simple
        from paimon_tpu_torch.format.mosaic import MOSAIC_FACTORY
        _FORMATS["mosaic"] = MOSAIC_FACTORY
    if ident not in _FORMATS:
        raise ValueError(f"Unknown file format {identifier!r}; "
                         f"available: {sorted(_FORMATS)}")
    return _FORMATS[ident]


def extract_simple_stats(table: pa.Table,
                         columns: Optional[Sequence[str]] = None
                         ) -> Tuple[List[Any], List[Any], List[int]]:
    """Column (min, max, null_count) triples from an Arrow table.

    Role of reference SimpleStatsExtractor/SimpleStatsCollector: stats
    computed at write time and stored in manifests for pruning.
    """
    import pyarrow.compute as pc
    names = list(columns) if columns else table.column_names
    mins, maxs, nulls = [], [], []
    for name in names:
        col = table.column(name)
        nulls.append(col.null_count)
        if col.null_count == len(col) or len(col) == 0:
            mins.append(None)
            maxs.append(None)
            continue
        try:
            mm = pc.min_max(col)
            mins.append(mm["min"].as_py())
            maxs.append(mm["max"].as_py())
        except pa.ArrowNotImplementedError:
            mins.append(None)
            maxs.append(None)
    return mins, maxs, nulls
