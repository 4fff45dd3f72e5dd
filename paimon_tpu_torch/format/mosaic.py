"""Mosaic: bucketed-columnar multimodal file format.

Counterpart of paimon_tpu/format/mosaic.py (the same bytes).  Ranged
reads go through the table's FileIO, so a table with read.cache.range
serves footers and column buckets from the shared range LRU
(fs/caching.py).  reference: paimon-mosaic/src/main/java/org/apache/paimon/format/mosaic/
MosaicFileFormat.java (surface: Arrow-batch writes, per-column
statistics via `mosaic.stats-columns`, `mosaic.num-buckets` column
buckets for parallel/partial IO, zstd compression, row-group max size,
writer metadata in MosaicWriterMetadata.java).  The reference's actual
byte codec lives in a native library that is not part of the source
tree, so this is a from-scratch encoding with the same capability
surface, built on Arrow IPC (the repo's native columnar plane).

Layout (little-endian):

    "MOS1"
    row group 0, column-bucket 0: Arrow IPC stream (internal zstd)
    row group 0, column-bucket 1: ...
    row group 1, column-bucket 0: ...
    ...
    footer: zstd-compressed JSON (schema, bucket layout, per-row-group
            bucket offsets/sizes + column min/max/null stats, writer
            metadata)
    u32 footer byte length
    "MOS1"

Why bucketed-columnar: multimodal rows mix tiny scalars with megabyte
blobs; by storing each column bucket as an independently fetchable
blob, a projection touches only the buckets it needs (default: one
bucket per column = pure columnar), and buckets of one row group can
be fetched in parallel.  Row-group column stats drive predicate
skipping without touching data bytes.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa

from paimon_tpu_torch.format.format import (
    FileFormatFactory, FormatReader, FormatWriter, extract_simple_stats,
)
from paimon_tpu_torch.fs import FileIO

__all__ = ["MosaicWriter", "MosaicReader", "read_footer",
           "MOSAIC_FACTORY"]

_MAGIC = b"MOS1"
_VERSION = 1
DEFAULT_ROW_GROUP_ROWS = 1 << 16


def _json_safe(v: Any):
    import datetime
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    if isinstance(v, bytes):
        return {"b64": __import__("base64").b64encode(v).decode()}
    if isinstance(v, datetime.datetime):
        return {"iso": v.isoformat(), "k": "dt"}
    if isinstance(v, datetime.date):
        return {"iso": v.isoformat(), "k": "d"}
    if isinstance(v, datetime.time):
        return {"iso": v.isoformat(), "k": "t"}
    return str(v)


class MosaicWriter(FormatWriter):
    def __init__(self, compression: str = "zstd",
                 row_group_rows: int = DEFAULT_ROW_GROUP_ROWS,
                 num_buckets: Optional[int] = None,
                 stats_columns: Optional[Sequence[str]] = None,
                 format_options: Optional[Dict[str, str]] = None):
        from paimon_tpu_torch.format.format import split_compression
        codec, level = split_compression(compression or "none")
        if codec in ("none", None):
            self.compression = None
        elif level is not None:
            try:
                self.compression = pa.Codec(codec,
                                            compression_level=level)
            except (pa.ArrowInvalid, TypeError, ValueError):
                # codec has no level knob: keep the codec, drop the
                # level (same fallback posture as _ipc_bytes)
                self.compression = codec
        else:
            self.compression = codec
        self.row_group_rows = row_group_rows
        self.num_buckets = num_buckets      # None -> one bucket per column
        self.stats_columns = list(stats_columns) if stats_columns \
            else None                       # None -> all stat-able columns

    def _bucketize(self, names: List[str]) -> List[List[str]]:
        if self.num_buckets is None or self.num_buckets >= len(names):
            return [[n] for n in names]
        b = max(1, self.num_buckets)
        return [names[i::b] for i in range(b)]

    def _ipc_bytes(self, table: pa.Table) -> bytes:
        sink = io.BytesIO()
        try:
            opts = pa.ipc.IpcWriteOptions(compression=self.compression)
        except (pa.ArrowInvalid, TypeError):
            opts = pa.ipc.IpcWriteOptions()
        with pa.ipc.new_stream(sink, table.schema, options=opts) as w:
            w.write_table(table)
        return sink.getvalue()

    def write(self, file_io: FileIO, path: str, table: pa.Table) -> int:
        names = table.column_names
        buckets = self._bucketize(names)
        stats_cols = self.stats_columns
        if stats_cols is None:
            stats_cols = [f.name for f in table.schema
                          if not pa.types.is_nested(f.type)]

        out = io.BytesIO()
        out.write(_MAGIC)
        row_groups = []
        n = table.num_rows
        step = max(1, self.row_group_rows)
        for start in range(0, max(n, 1), step):
            chunk = table.slice(start, min(step, n - start)) if n else table
            bucket_meta = []
            for cols in buckets:
                blob = self._ipc_bytes(chunk.select(cols))
                bucket_meta.append({"offset": out.tell(),
                                    "size": len(blob)})
                out.write(blob)
            mins, maxs, nulls = extract_simple_stats(chunk, stats_cols)
            stats = {c: {"min": _json_safe(mn), "max": _json_safe(mx),
                         "nulls": nc}
                     for c, mn, mx, nc in zip(stats_cols, mins, maxs,
                                              nulls)}
            row_groups.append({"num_rows": chunk.num_rows,
                               "buckets": bucket_meta, "stats": stats})
            if n == 0:
                break

        import base64
        footer = {
            "version": _VERSION,
            "schema": base64.b64encode(
                table.schema.serialize().to_pybytes()).decode(),
            "num_rows": n,
            "column_buckets": buckets,
            "stats_columns": stats_cols,
            "row_groups": row_groups,
            "writer": {"created_by": "paimon-tpu-mosaic",
                       "format_version": _VERSION},
        }
        fbytes = json.dumps(footer).encode("utf-8")
        raw_len = len(fbytes)
        try:
            comp = pa.Codec("zstd").compress(fbytes)
            comp = comp.to_pybytes() if isinstance(comp, pa.Buffer) \
                else bytes(comp)
            tail = b"Z" + struct.pack("<I", raw_len) + comp
        except (pa.ArrowInvalid, OSError):
            tail = b"R" + fbytes
        out.write(tail)
        out.write(struct.pack("<I", len(tail)))
        out.write(_MAGIC)
        data = out.getvalue()
        file_io.write_bytes(path, data, overwrite=False)
        return len(data)


def _parse_footer_tail(raw: bytes) -> Dict:
    if raw[:1] == b"Z":
        (raw_len,) = struct.unpack_from("<I", raw, 1)
        body = pa.Codec("zstd").decompress(raw[5:],
                                           decompressed_size=raw_len)
        if isinstance(body, pa.Buffer):
            body = body.to_pybytes()
    else:
        body = raw[1:]
    return json.loads(body)


def read_footer(data: bytes) -> Dict:
    if data[:4] != _MAGIC or data[-4:] != _MAGIC:
        raise ValueError("not a mosaic file (bad magic)")
    (flen,) = struct.unpack_from("<I", data, len(data) - 8)
    return _parse_footer_tail(data[len(data) - 8 - flen:len(data) - 8])


def _decode_stat(v):
    if isinstance(v, dict):
        if "b64" in v:
            import base64
            return base64.b64decode(v["b64"])
        if "iso" in v:
            import datetime
            parser = {"dt": datetime.datetime, "d": datetime.date,
                      "t": datetime.time}.get(v.get("k"),
                                              datetime.datetime)
            try:
                return parser.fromisoformat(v["iso"])
            except ValueError:
                return v["iso"]
    return v


class MosaicReader(FormatReader):
    def read(self, file_io: FileIO, path: str,
             projection: Optional[List[str]] = None,
             batch_size: int = 1 << 20,
             predicate=None) -> pa.Table:
        tables = list(self.read_batches(file_io, path, projection,
                                        batch_size, predicate))
        if not tables:
            import base64
            footer = read_footer(file_io.read_bytes(path))
            schema = pa.ipc.read_schema(pa.BufferReader(
                base64.b64decode(footer["schema"])))
            if projection:
                schema = pa.schema([schema.field(c) for c in projection])
            return schema.empty_table()
        return pa.concat_tables(tables, promote_options="none")

    def read_batches(self, file_io: FileIO, path: str,
                     projection: Optional[List[str]] = None,
                     batch_size: int = 1 << 20, predicate=None):
        # footer first (two small tail reads), then ONE vectored read
        # of exactly the surviving row groups' needed bucket ranges —
        # a projection never pays for unprojected columns' bytes
        # (reference fs/VectoredReadable + mosaic partial IO)
        size = file_io.get_file_size(path)
        if size < 12:
            raise ValueError(f"not a mosaic file (too small): {path}")
        (tail,) = file_io.read_ranges(path, [(size - 8, 8)])
        (flen,) = struct.unpack_from("<I", tail, 0)
        if tail[4:] != _MAGIC or flen > size - 12:
            raise ValueError(f"not a mosaic file (bad magic): {path}")
        (raw,) = file_io.read_ranges(path,
                                     [(size - 8 - flen, flen + 8)])
        footer = _parse_footer_tail(raw[:flen])
        buckets: List[List[str]] = footer["column_buckets"]
        wanted = list(projection) if projection else \
            [c for b in buckets for c in b]
        need = [i for i, cols in enumerate(buckets)
                if any(c in wanted for c in cols)]
        groups = [rg for rg in footer["row_groups"]
                  if predicate is None or self._rg_matches(rg,
                                                           predicate)]
        ranges = [(rg["buckets"][i]["offset"], rg["buckets"][i]["size"])
                  for rg in groups for i in need]
        blobs = file_io.read_ranges(path, ranges) if ranges else []
        pos = 0
        for rg in groups:
            parts = []
            for _ in need:
                blob = blobs[pos]
                pos += 1
                with pa.ipc.open_stream(pa.BufferReader(blob)) as r:
                    parts.append(r.read_all())
            if not parts:
                continue
            t = parts[0]
            for p in parts[1:]:
                for col_i, f in enumerate(p.schema):
                    t = t.append_column(f, p.column(col_i))
            yield t.select([c for c in wanted if c in t.column_names])

    @staticmethod
    def _rg_matches(rg: Dict, predicate) -> bool:
        """Row-group skip on footer stats (role of the reference's
        native row-group statistics pruning)."""
        stats = rg.get("stats", {})
        mins = {c: _decode_stat(s.get("min")) for c, s in stats.items()}
        maxs = {c: _decode_stat(s.get("max")) for c, s in stats.items()}
        nulls = {c: s.get("nulls") for c, s in stats.items()}
        try:
            return predicate.test_stats(mins, maxs, nulls,
                                        rg.get("num_rows", 0))
        except Exception:
            return True


def extract_footer_stats(file_io: FileIO, path: str):
    """Whole-file (min, max, null_count) per stats column from the
    footer alone — the MosaicSimpleStatsExtractor analog: stats without
    scanning data bytes."""
    footer = read_footer(file_io.read_bytes(path))
    cols = footer.get("stats_columns", [])
    mins: Dict[str, Any] = {}
    maxs: Dict[str, Any] = {}
    nulls: Dict[str, int] = {c: 0 for c in cols}
    for rg in footer["row_groups"]:
        for c, s in rg.get("stats", {}).items():
            mn, mx = _decode_stat(s.get("min")), _decode_stat(s.get("max"))
            if mn is not None and (c not in mins or mn < mins[c]):
                mins[c] = mn
            if mx is not None and (c not in maxs or mx > maxs[c]):
                maxs[c] = mx
            nulls[c] = nulls.get(c, 0) + (s.get("nulls") or 0)
    return ([mins.get(c) for c in cols], [maxs.get(c) for c in cols],
            [nulls.get(c, 0) for c in cols], cols)


MOSAIC_FACTORY = FileFormatFactory("mosaic", MosaicReader(), MosaicWriter)
