"""Variant: semi-structured values in the open binary variant format.

Counterpart of paimon_tpu/data/variant.py (the same bytes for the same
value).  reference: paimon-common/.../data/variant/ (GenericVariant,
GenericVariantBuilder, VariantShreddingWriter, ~5k LoC Java) — the
Spark/Parquet "Variant" encoding: a value is (metadata, value) byte
strings where metadata is a key dictionary and value is a compact typed
tree.  This implementation covers the encoding subset paimon writes
(null/bool/int8-64/double/string/binary/object/array), JSON round-trip,
`$`-path access (variant_get), and columnar SHREDDING: extracting a
typed Arrow column per configured path with per-row residuals, and
re-assembly on read (VariantShreddingWriter / PaimonShreddingUtils).

Layout notes (open variant spec v1):
- metadata: header byte (version=1 | sorted<<4 | (offset_size-1)<<6),
  dict_size, dict_size+1 offsets, key bytes (all ints little-endian,
  offset_size wide).
- value: header byte = basic_type | type_info<<2.
  basic 0 primitive: info 0 null, 1 true, 2 false, 3 i8, 4 i16, 5 i32,
  6 i64, 7 double, 16 long string; basic 1 short string (info=len);
  basic 2 object: info = (offsz-1) | (idsz-1)<<2 | large<<4;
  basic 3 array: info = (offsz-1) | large<<2.
"""

from __future__ import annotations

import json
import re
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import pyarrow as pa

__all__ = ["Variant", "VariantBuilder", "variant_get", "shred_column",
           "unshred_column", "ShreddingPlan", "variant_arrow_type"]

_VERSION = 1


def _uint(n: int, width: int) -> bytes:
    return int(n).to_bytes(width, "little")


def _read_uint(b: bytes, pos: int, width: int) -> int:
    return int.from_bytes(b[pos:pos + width], "little")


def _min_width(n: int) -> int:
    if n < (1 << 8):
        return 1
    if n < (1 << 16):
        return 2
    if n < (1 << 24):
        return 3
    return 4


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

class VariantBuilder:
    """Encode a python object (dict/list/str/int/float/bool/None/bytes)
    into (metadata, value)."""

    def __init__(self):
        self._keys: Dict[str, int] = {}

    def _key_id(self, k: str) -> int:
        if k not in self._keys:
            self._keys[k] = len(self._keys)
        return self._keys[k]

    def build(self, obj: Any) -> "Variant":
        value = self._encode(obj)
        keys = [k.encode() for k in self._keys]
        offsz = _min_width(sum(len(k) for k in keys) or 1)
        header = _VERSION | ((offsz - 1) << 6)
        out = [bytes([header]), _uint(len(keys), offsz)]
        off = 0
        offs = [0]
        for k in keys:
            off += len(k)
            offs.append(off)
        out += [_uint(o, offsz) for o in offs]
        out += keys
        return Variant(b"".join(out), value)

    def _encode(self, v: Any) -> bytes:
        if v is None:
            return bytes([0 | (0 << 2)])
        if v is True:
            return bytes([0 | (1 << 2)])
        if v is False:
            return bytes([0 | (2 << 2)])
        if isinstance(v, int):
            for info, fmt, lo, hi in ((3, "<b", -2**7, 2**7),
                                      (4, "<h", -2**15, 2**15),
                                      (5, "<i", -2**31, 2**31),
                                      (6, "<q", -2**63, 2**63)):
                if lo <= v < hi:
                    return bytes([0 | (info << 2)]) + struct.pack(fmt, v)
            raise ValueError(f"int out of int64 range: {v}")
        if isinstance(v, float):
            return bytes([0 | (7 << 2)]) + struct.pack("<d", v)
        if isinstance(v, str):
            raw = v.encode()
            if len(raw) < 64:
                return bytes([1 | (len(raw) << 2)]) + raw
            return bytes([0 | (16 << 2)]) + _uint(len(raw), 4) + raw
        if isinstance(v, (bytes, bytearray)):
            return bytes([0 | (15 << 2)]) + _uint(len(v), 4) + bytes(v)
        if isinstance(v, (list, tuple)):
            items = [self._encode(x) for x in v]
            total = sum(len(i) for i in items)
            offsz = _min_width(total or 1)
            large = len(items) > 255
            info = (offsz - 1) | (int(large) << 2)
            out = [bytes([3 | (info << 2)]),
                   _uint(len(items), 4 if large else 1)]
            off = 0
            offs = [0]
            for i in items:
                off += len(i)
                offs.append(off)
            out += [_uint(o, offsz) for o in offs]
            out += items
            return b"".join(out)
        if isinstance(v, dict):
            # the open variant spec requires object fields sorted by
            # key NAME (readers binary-search on it), not by field id
            fields = [(self._key_id(str(k)), self._encode(val))
                      for k, val in sorted(v.items(),
                                           key=lambda kv: str(kv[0]))]
            total = sum(len(fv) for _, fv in fields)
            offsz = _min_width(total or 1)
            idsz = _min_width(max((fid for fid, _ in fields),
                                  default=0) or 1)
            large = len(fields) > 255
            info = (offsz - 1) | ((idsz - 1) << 2) | (int(large) << 4)
            out = [bytes([2 | (info << 2)]),
                   _uint(len(fields), 4 if large else 1)]
            out += [_uint(fid, idsz) for fid, _ in fields]
            off = 0
            offs = [0]
            for _, fv in fields:
                off += len(fv)
                offs.append(off)
            out += [_uint(o, offsz) for o in offs]
            out += [fv for _, fv in fields]
            return b"".join(out)
        raise TypeError(f"cannot encode {type(v).__name__} as variant")


# ---------------------------------------------------------------------------
# the value
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Variant:
    metadata: bytes
    value: bytes

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_object(obj: Any) -> "Variant":
        return VariantBuilder().build(obj)

    @staticmethod
    def from_json(text: str) -> "Variant":
        return Variant.from_object(json.loads(text))

    # -- metadata ------------------------------------------------------------
    def _dict_keys(self) -> List[str]:
        md = self.metadata
        header = md[0]
        if header & 0x0F != _VERSION:
            raise ValueError("unsupported variant metadata version")
        offsz = ((header >> 6) & 0x3) + 1
        n = _read_uint(md, 1, offsz)
        base = 1 + offsz
        offs = [_read_uint(md, base + i * offsz, offsz)
                for i in range(n + 1)]
        data = base + (n + 1) * offsz
        return [md[data + offs[i]:data + offs[i + 1]].decode()
                for i in range(n)]

    # -- decode --------------------------------------------------------------
    def to_object(self) -> Any:
        keys = self._dict_keys()
        obj, _ = _decode(self.value, 0, keys)
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_object(), default=_json_default)

    def get(self, path: str):
        """`$`-path access: $.a.b, $['a'], $.arr[0] (reference
        Variant.variantGet / VariantPathSegment)."""
        return _walk(self.to_object(), _parse_path(path))


def _json_default(o):
    if isinstance(o, (bytes, bytearray)):
        import base64
        return base64.b64encode(bytes(o)).decode()
    raise TypeError


def _decode(b: bytes, pos: int, keys: List[str]) -> Tuple[Any, int]:
    header = b[pos]
    basic = header & 0x3
    info = header >> 2
    if basic == 0:                                  # primitive
        p = pos + 1
        if info == 0:
            return None, p
        if info == 1:
            return True, p
        if info == 2:
            return False, p
        if info in (3, 4, 5, 6):
            width = {3: 1, 4: 2, 5: 4, 6: 8}[info]
            fmt = {3: "<b", 4: "<h", 5: "<i", 6: "<q"}[info]
            return struct.unpack_from(fmt, b, p)[0], p + width
        if info == 7:
            return struct.unpack_from("<d", b, p)[0], p + 8
        if info == 15:                              # binary
            ln = _read_uint(b, p, 4)
            return b[p + 4:p + 4 + ln], p + 4 + ln
        if info == 16:                              # long string
            ln = _read_uint(b, p, 4)
            return b[p + 4:p + 4 + ln].decode(), p + 4 + ln
        raise ValueError(f"unsupported variant primitive {info}")
    if basic == 1:                                  # short string
        ln = info
        return b[pos + 1:pos + 1 + ln].decode(), pos + 1 + ln
    if basic == 2:                                  # object
        offsz = (info & 0x3) + 1
        idsz = ((info >> 2) & 0x3) + 1
        large = (info >> 4) & 0x1
        p = pos + 1
        n = _read_uint(b, p, 4 if large else 1)
        p += 4 if large else 1
        fids = [_read_uint(b, p + i * idsz, idsz) for i in range(n)]
        p += n * idsz
        offs = [_read_uint(b, p + i * offsz, offsz)
                for i in range(n + 1)]
        p += (n + 1) * offsz
        out = {}
        for i in range(n):
            v, _ = _decode(b, p + offs[i], keys)
            out[keys[fids[i]]] = v
        return out, p + offs[n]
    # basic == 3: array
    offsz = (info & 0x3) + 1
    large = (info >> 2) & 0x1
    p = pos + 1
    n = _read_uint(b, p, 4 if large else 1)
    p += 4 if large else 1
    offs = [_read_uint(b, p + i * offsz, offsz) for i in range(n + 1)]
    p += (n + 1) * offsz
    out = []
    for i in range(n):
        v, _ = _decode(b, p + offs[i], keys)
        out.append(v)
    return out, p + offs[n]


_PATH_RE = re.compile(r"\.([A-Za-z_][A-Za-z0-9_]*)"
                      r"|\[\s*(\d+)\s*\]"
                      r"|\[\s*'([^']*)'\s*\]"
                      r"|\[\s*\"([^\"]*)\"\s*\]")


def _parse_path(path: str) -> List[Any]:
    if not path.startswith("$"):
        raise ValueError(f"variant path must start with $: {path!r}")
    out: List[Any] = []
    pos = 1
    while pos < len(path):
        m = _PATH_RE.match(path, pos)
        if not m:
            raise ValueError(f"bad variant path at {pos}: {path!r}")
        field, idx, q1, q2 = m.groups()
        if idx is not None:
            out.append(int(idx))
        else:
            out.append(field or q1 or q2)
        pos = m.end()
    return out


def variant_get(v: Optional[Variant], path: str):
    return None if v is None else v.get(path)


# ---------------------------------------------------------------------------
# Arrow integration + shredding
# ---------------------------------------------------------------------------

def variant_arrow_type() -> pa.DataType:
    """On-disk arrow shape of an unshredded variant column (the
    Spark/Parquet convention: struct<metadata, value>)."""
    return pa.struct([("metadata", pa.binary()), ("value", pa.binary())])


def column_from_objects(objs) -> pa.Array:
    """python objects -> arrow struct<metadata,value> column."""
    md, val = [], []
    for o in objs:
        if o is None:
            md.append(None)
            val.append(None)
        else:
            v = o if isinstance(o, Variant) else Variant.from_object(o)
            md.append(v.metadata)
            val.append(v.value)
    return pa.StructArray.from_arrays(
        [pa.array(md, pa.binary()), pa.array(val, pa.binary())],
        names=["metadata", "value"])


def column_to_variants(col) -> List[Optional[Variant]]:
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    out = []
    for row in col.to_pylist():
        if row is None or row.get("metadata") is None:
            out.append(None)
        else:
            out.append(Variant(row["metadata"], row["value"]))
    return out


@dataclass
class ShreddingPlan:
    """Which paths shred into typed columns (reference
    VariantShreddingWritePlan): {'$.a.b': pa.int64(), ...}."""
    paths: Dict[str, pa.DataType]

    def field_name(self, path: str) -> str:
        return "typed_" + re.sub(r"[^A-Za-z0-9]+", "_",
                                 path[1:]).strip("_")


def _walk(obj, segs) -> Any:
    for seg in segs:
        if isinstance(seg, int):
            if not isinstance(obj, (list, tuple)) or \
                    not (0 <= seg < len(obj)):
                return None
            obj = obj[seg]
        else:
            if not isinstance(obj, dict) or seg not in obj:
                return None
            obj = obj[seg]
    return obj


def _coerce_exact(raw, typ: pa.DataType):
    """Shredding is LOSSLESS-only: a typed child holds the value only
    when the variant value already has that exact shape; anything lossy
    (9.99 into int64) stays residual-only (reference
    VariantShreddingWriter type-match semantics)."""
    if raw is None:
        return None
    if pa.types.is_boolean(typ):
        return raw if isinstance(raw, bool) else None
    if pa.types.is_integer(typ):
        if isinstance(raw, bool) or not isinstance(raw, int):
            return None
        try:
            return pa.scalar(raw, typ).as_py()
        except (pa.ArrowInvalid, OverflowError):
            return None
    if pa.types.is_floating(typ):
        return float(raw) if isinstance(raw, (int, float)) and \
            not isinstance(raw, bool) else None
    if pa.types.is_string(typ) or pa.types.is_large_string(typ):
        return raw if isinstance(raw, str) else None
    if pa.types.is_binary(typ) or pa.types.is_large_binary(typ):
        return bytes(raw) if isinstance(raw, (bytes, bytearray)) \
            else None
    try:
        return pa.scalar(raw, typ).as_py()
    except (pa.ArrowInvalid, pa.ArrowTypeError, OverflowError,
            TypeError):
        return None


def shred_column(col, plan: ShreddingPlan) -> pa.StructArray:
    """variant column -> struct<metadata, value, <typed...>> where each
    planned path becomes a typed child and rows keep their FULL variant
    residual in value (simple + lossless; reference shredding removes
    shredded fields from the residual as a size optimization).  Each
    row decodes ONCE; paths are parsed once."""
    variants = column_to_variants(col)
    paths = [(path, typ, _parse_path(path))
             for path, typ in plan.paths.items()]
    children: List[List[Any]] = [[] for _ in paths]
    md, val = [], []
    for v in variants:
        if v is None:
            md.append(None)
            val.append(None)
            for c in children:
                c.append(None)
            continue
        md.append(v.metadata)
        val.append(v.value)
        obj = v.to_object()
        for i, (_, typ, segs) in enumerate(paths):
            children[i].append(_coerce_exact(_walk(obj, segs), typ))
    arrays = [pa.array(md, pa.binary()), pa.array(val, pa.binary())]
    names = ["metadata", "value"]
    for (path, typ, _), vals in zip(paths, children):
        arrays.append(pa.array(vals, typ))
        names.append(plan.field_name(path))
    return pa.StructArray.from_arrays(arrays, names=names)


def unshred_column(col) -> pa.StructArray:
    """struct<metadata, value, typed...> -> plain variant column (the
    residual IS the full value here, so re-assembly is projection)."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    return pa.StructArray.from_arrays(
        [col.field("metadata"), col.field("value")],
        names=["metadata", "value"])


def typed_path_column(col, plan: ShreddingPlan, path: str) -> pa.Array:
    """Read a shredded path WITHOUT decoding variants: the typed child
    column, straight from the struct (this is the point of shredding —
    predicate/projection on $.path at columnar speed)."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    return col.field(plan.field_name(path))
