"""Avro binary codec + object container files, pure Python.

Implemented from the Apache Avro 1.11 specification (binary encoding +
object container files). The reference serializes manifests as avro object
files (docs/docs/concepts/spec/manifest.md:34); this module keeps those
files wire-compatible without a fastavro dependency.

Supported: all primitives, records, arrays, maps, unions, fixed, enums;
logicalType timestamp-millis (int <-> datetime left to callers: values pass
through as ints); codecs null / deflate / zstandard.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

__all__ = ["encode_value", "decode_value", "write_container",
           "read_container", "AvroSchemaError"]

MAGIC = b"Obj\x01"


class AvroSchemaError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Binary encoding
# ---------------------------------------------------------------------------

def _write_long(buf: io.BytesIO, n: int):
    # zigzag + varint
    n = (n << 1) ^ (n >> 63)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("unexpected end of avro data")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _schema_type(schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def encode_value(schema, value, buf: io.BytesIO):
    t = _schema_type(schema)
    if t == "null":
        if value is not None:
            raise AvroSchemaError(f"non-null value {value!r} for null schema")
        return
    if t == "boolean":
        buf.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        _write_long(buf, int(value))
    elif t == "float":
        buf.write(struct.pack("<f", float(value)))
    elif t == "double":
        buf.write(struct.pack("<d", float(value)))
    elif t == "bytes":
        data = bytes(value)
        _write_long(buf, len(data))
        buf.write(data)
    elif t == "string":
        data = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        _write_long(buf, len(data))
        buf.write(data)
    elif t == "fixed":
        data = bytes(value)
        if len(data) != schema["size"]:
            raise AvroSchemaError("fixed size mismatch")
        buf.write(data)
    elif t == "enum":
        buf.write(b"")
        _write_long(buf, schema["symbols"].index(value))
    elif t == "union":
        idx = _resolve_union(schema, value)
        _write_long(buf, idx)
        encode_value(schema[idx], value, buf)
    elif t == "record":
        for f in schema["fields"]:
            try:
                fv = value.get(f["name"], f.get("default"))
            except AttributeError:
                raise AvroSchemaError(
                    f"record value must be a dict, got {type(value)}")
            encode_value(f["type"], fv, buf)
    elif t == "array":
        items = list(value or [])
        if items:
            _write_long(buf, len(items))
            for item in items:
                encode_value(schema["items"], item, buf)
        _write_long(buf, 0)
    elif t == "map":
        entries = dict(value or {})
        if entries:
            _write_long(buf, len(entries))
            for k, v in entries.items():
                encode_value("string", k, buf)
                encode_value(schema["values"], v, buf)
        _write_long(buf, 0)
    else:
        raise AvroSchemaError(f"Unknown avro type: {t!r}")


def _resolve_union(union: list, value) -> int:
    """Pick the union branch for a Python value."""
    def matches(s, v) -> bool:
        st = _schema_type(s)
        if st == "null":
            return v is None
        if v is None:
            return False
        if st == "boolean":
            return isinstance(v, bool)
        if st in ("int", "long"):
            return isinstance(v, int) and not isinstance(v, bool)
        if st in ("float", "double"):
            return isinstance(v, float)
        if st in ("bytes", "fixed"):
            return isinstance(v, (bytes, bytearray, memoryview))
        if st == "string":
            return isinstance(v, str)
        if st == "array":
            return isinstance(v, (list, tuple))
        if st in ("map", "record"):
            return isinstance(v, dict)
        if st == "enum":
            return isinstance(v, str)
        return False

    for i, s in enumerate(union):
        if matches(s, value):
            return i
    raise AvroSchemaError(f"Value {value!r} matches no branch of {union}")


def decode_value(schema, buf: io.BytesIO):
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        n = _read_long(buf)
        return buf.read(n)
    if t == "string":
        n = _read_long(buf)
        return buf.read(n).decode("utf-8")
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "union":
        return decode_value(schema[_read_long(buf)], buf)
    if t == "record":
        return {f["name"]: decode_value(f["type"], buf)
                for f in schema["fields"]}
    if t == "array":
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                n = -n
                _read_long(buf)  # block size in bytes, unused
            for _ in range(n):
                out.append(decode_value(schema["items"], buf))
        return out
    if t == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                n = -n
                _read_long(buf)
            for _ in range(n):
                k = decode_value("string", buf)
                out[k] = decode_value(schema["values"], buf)
        return out
    raise AvroSchemaError(f"Unknown avro type: {t!r}")


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------

def _compress(codec: str, data: bytes) -> bytes:
    if codec == "null":
        return data
    if codec == "deflate":
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush()
    if codec == "zstandard":
        if _zstd is not None:
            return _zstd.ZstdCompressor(level=3).compress(data)
        return _pa_zstd_compress(data)
    raise AvroSchemaError(f"Unknown avro codec {codec!r}")


def _decompress(codec: str, data: bytes) -> bytes:
    if codec == "null":
        return data
    if codec == "deflate":
        return zlib.decompress(data, -15)
    if codec == "zstandard":
        if _zstd is not None:
            return _zstd.ZstdDecompressor().decompress(
                data, max_output_size=1 << 31)
        return _pa_zstd_decompress(data)
    raise AvroSchemaError(f"Unknown avro codec {codec!r}")


def _pa_zstd_compress(data: bytes) -> bytes:
    """zstd via pyarrow's bundled codec when the `zstandard` module is
    absent.  The streaming writer emits standard zstd frames (magic
    0x28B52FFD), byte-compatible with what any avro reader expects."""
    import pyarrow as pa
    sink = pa.BufferOutputStream()
    with pa.CompressedOutputStream(sink, "zstd") as s:
        s.write(data)
    return sink.getvalue().to_pybytes()


def _pa_zstd_decompress(data: bytes) -> bytes:
    """Streaming decompress: avro blocks don't record the decompressed
    size, and pyarrow's one-shot pa.decompress demands it — the
    CompressedInputStream path does not."""
    import pyarrow as pa
    with pa.CompressedInputStream(pa.BufferReader(data), "zstd") as s:
        return s.read()


def write_container(schema, records: Iterable[dict],
                    codec: str = "zstandard",
                    sync_marker: Optional[bytes] = None,
                    block_records: int = 4096) -> bytes:
    """Serialize records into an avro object container file (bytes)."""
    sync = sync_marker or os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8")}
    encode_value({"type": "map", "values": "bytes"}, meta, out)
    out.write(sync)

    block = io.BytesIO()
    count = 0

    def flush():
        nonlocal block, count
        if count == 0:
            return
        data = _compress(codec, block.getvalue())
        _write_long(out, count)
        _write_long(out, len(data))
        out.write(data)
        out.write(sync)
        block = io.BytesIO()
        count = 0

    for rec in records:
        encode_value(schema, rec, block)
        count += 1
        if count >= block_records:
            flush()
    flush()
    return out.getvalue()


def read_container(data: bytes) -> Tuple[dict, List[dict]]:
    """Parse an avro object container file -> (schema, records)."""
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise AvroSchemaError("Not an avro object container file")
    meta = decode_value({"type": "map", "values": "bytes"}, buf)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = buf.read(16)
    records: List[dict] = []
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, io.SEEK_CUR)
        count = _read_long(buf)
        size = _read_long(buf)
        payload = _decompress(codec, buf.read(size))
        if buf.read(16) != sync:
            raise AvroSchemaError("Sync marker mismatch")
        bbuf = io.BytesIO(payload)
        for _ in range(count):
            records.append(decode_value(schema, bbuf))
    return schema, records
