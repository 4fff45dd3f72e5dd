"""Per-file column indexes: the container blob and the skip evaluator.

Counterpart of paimon_tpu/index/file_index.py.  Blob layout (each
serialized form is the reference's byte for byte):

  v1: "PTFI" 0x01 then (name_len u16, blob_len u32, name, bloom_blob)*
  v2: "PTFI" 0x02 then (type u8, name_len u16, blob_len u32, name, blob)*

Types: 0 bloom, 1 bitmap, 2 bit-sliced, 3 range-bitmap.  A blob up to
file-index.in-manifest-threshold embeds in the manifest entry
(DataFileMeta.embedded_index); a larger one is the `<data-file>.index`
sidecar (index/bloom.py `place_file_index`).

Reading parses the entry headers only; a column's indexes deserialize
when a predicate first asks for that column (`FileIndexes.column`), so
a point query on a key with a bloom filter never decodes the value
columns' bitmaps.  `by_column` decodes everything.  A sidecar is read
by ranges (`read_indexes_file`): its headers, then the entries of the
columns a predicate names, with every header read again in the same
vectored read, so that all of them come from one version of a sidecar
that `rewrite_file_index(force=True)` replaced under the same name.

Evaluation returns dense bool selections with superset semantics: an
empty mask proves the file holds no matching row (skip), a non-empty
one is a safe row prefilter (the read re-applies the predicate).

reference: paimon-common/.../fileindex/FileIndexFormat.java,
FileIndexPredicate.java + io/FileIndexEvaluator (the skip),
fileindex/bitmap/BitmapIndexResult.java (row selection).
"""

from __future__ import annotations

import functools
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.index.bitmap import (
    BSIIndex, BitmapIndex, RangeBitmapIndex,
)
from paimon_tpu_torch.index.bloom import BloomFilter, hash_column, hash_value

__all__ = ["FileIndexes", "build_indexes_blob", "read_indexes_blob",
           "read_indexes_file", "evaluate_skip", "row_selection",
           "INDEX_TYPES", "SIDECAR_WINDOW"]

_MAGIC = b"PTFI"
_V2 = 2
SIDECAR_WINDOW = 1 << 16                  # a sidecar's first read

TYPE_BLOOM, TYPE_BITMAP, TYPE_BSI, TYPE_RANGE = 0, 1, 2, 3
INDEX_TYPES = {
    "bloom-filter": TYPE_BLOOM,
    "bitmap": TYPE_BITMAP,
    "bsi": TYPE_BSI,
    "range-bitmap": TYPE_RANGE,
}
_DESERIALIZERS: Dict[int, Callable] = {
    TYPE_BLOOM: BloomFilter.deserialize,
    TYPE_BITMAP: BitmapIndex.deserialize,
    TYPE_BSI: BSIIndex.deserialize,
    TYPE_RANGE: RangeBitmapIndex.deserialize,
}


class FileIndexes:
    """column -> {type tag -> index object}; entries read from a blob
    stay serialized until their column is asked for."""

    def __init__(self):
        self._columns: Dict[str, Dict[int, object]] = {}
        self._pending: Dict[str, List[Tuple[int, memoryview]]] = {}

    def add(self, column: str, type_tag: int, index):
        self._columns.setdefault(column, {})[type_tag] = index

    def add_serialized(self, column: str, type_tag: int, payload):
        """`payload`: the entry's bytes."""
        self._pending.setdefault(column, []).append((type_tag, payload))

    def has(self, column: str) -> bool:
        return column in self._columns or column in self._pending

    def merge(self, other: "FileIndexes"):
        """Take the columns of `other` that this one lacks."""
        for name, idxs in other._columns.items():
            if not self.has(name):
                self._columns[name] = idxs
        for name, pending in other._pending.items():
            if not self.has(name):
                self._pending[name] = pending

    def column(self, name: str) -> Optional[Dict[int, object]]:
        """The indexes of one column (deserialized on first use), or
        None when the file has none."""
        pending = self._pending.pop(name, None)
        if pending:
            for tag, payload in pending:
                self.add(name, tag, _DESERIALIZERS[tag](bytes(payload)))
        return self._columns.get(name)

    @property
    def by_column(self) -> Dict[str, Dict[int, object]]:
        for name in list(self._pending):
            self.column(name)
        return self._columns

    def __bool__(self):
        return bool(self._columns) or bool(self._pending)


def build_indexes_blob(table: pa.Table, spec: Dict[str, List[str]],
                       bloom_fpp: float = 0.01) -> Optional[bytes]:
    """spec: index-type name -> column list (e.g. {"bitmap": ["city"]})."""
    entries = []

    def emit(type_tag: int, column: str, blob: bytes):
        cname = column.encode("utf-8")
        entries.append(struct.pack("<BHI", type_tag, len(cname), len(blob))
                       + cname + blob)

    for c in spec.get("bloom-filter", []):
        if c not in table.column_names:
            continue
        try:
            hashes = hash_column(table.column(c))
        except ValueError:
            continue
        emit(TYPE_BLOOM, c, BloomFilter.build(hashes, bloom_fpp).serialize())
    for name, tag, cls in (("bitmap", TYPE_BITMAP, BitmapIndex),
                           ("bsi", TYPE_BSI, BSIIndex),
                           ("range-bitmap", TYPE_RANGE, RangeBitmapIndex)):
        for c in spec.get(name, []):
            if c not in table.column_names:
                continue
            try:
                idx = cls.build(table.column(c))
            except ValueError:
                continue
            if idx is not None:
                emit(tag, c, idx.serialize())
    if not entries:
        return None
    return _MAGIC + bytes([_V2]) + b"".join(entries)


def _entry_header(version: int, data, p: int) -> Tuple[int, int, int, int]:
    """(type tag, name length, blob length, header length) at `p`."""
    if version == 1:                      # bloom-only legacy layout
        nlen, blen = struct.unpack_from("<HI", data, p)
        return TYPE_BLOOM, nlen, blen, 6
    type_tag, nlen, blen = struct.unpack_from("<BHI", data, p)
    return type_tag, nlen, blen, 7


def read_indexes_blob(data: Optional[bytes]) -> FileIndexes:
    """The indexes of a v1 or v2 blob (empty for anything else)."""
    fi = FileIndexes()
    if not data or data[:4] != _MAGIC:
        return fi
    view = memoryview(data)
    version = data[4]
    p = 5
    while p < len(data):
        type_tag, nlen, blen, hlen = _entry_header(version, data, p)
        p += hlen
        name = bytes(view[p:p + nlen]).decode("utf-8")
        p += nlen
        if type_tag in _DESERIALIZERS:
            fi.add_serialized(name, type_tag, view[p:p + blen])
        p += blen
    return fi


def read_indexes_file(file_io, path: str, columns) -> FileIndexes:
    """The indexes of `columns` in a sidecar blob, read by ranges: its
    first SIDECAR_WINDOW bytes (all of a small sidecar, every column), each
    entry header beyond them, then one vectored read of every header
    again with the entries of `columns`.  A header that reads otherwise
    the second time means the file was replaced between the reads: it
    then reads as no index.  Equal to read_indexes_blob of the whole file
    for the columns asked."""
    buf = file_io.read_range(path, 0, SIDECAR_WINDOW)
    if len(buf) < SIDECAR_WINDOW:         # the whole file
        return read_indexes_blob(buf)
    if buf[:4] != _MAGIC:
        return FileIndexes()
    version = buf[4]
    hlen = 6 if version == 1 else 7
    base, p = 0, 5

    def span_of(off: int, n: int) -> bytes:
        # a header past the buffer: read it, its name and a little more
        nonlocal buf, base
        if off < base or off + n > base + len(buf):
            buf, base = file_io.read_range(path, off, max(n, 4096)), off
        return bytes(buf[off - base:off - base + n])

    # (offset, header and name, type tag, name, blob length)
    heads = []
    while True:
        head = span_of(p, hlen)
        if len(head) < hlen:
            break
        type_tag, nlen, blen, _ = _entry_header(version, head, 0)
        name = span_of(p + hlen, nlen)
        heads.append((p, head + name, type_tag, name, blen))
        p += hlen + nlen + blen
    wanted = {c.encode("utf-8") for c in columns}
    ranges = [(off, len(hb) + (blen if name in wanted and
                                tag in _DESERIALIZERS else 0))
              for off, hb, tag, name, blen in heads]
    fi = FileIndexes()
    for (off, hb, tag, name, blen), (_, n), data in zip(
            heads, ranges, file_io.read_ranges(path, ranges)):
        if len(data) != n or bytes(data[:len(hb)]) != hb:
            return FileIndexes()          # replaced between the reads
        if n > len(hb):
            fi.add_serialized(name.decode("utf-8"), tag,
                              memoryview(data)[len(hb):])
    return fi


# -- evaluation --------------------------------------------------------------

# structures able to produce row selections, in preference order
_SELECTIVE = (TYPE_BITMAP, TYPE_BSI, TYPE_RANGE)


@functools.lru_cache(maxsize=4096)
def _hash_of(value, arrow_type: pa.DataType) -> int:
    return hash_value(value, arrow_type)


def _literal_hash(value, arrow_type: pa.DataType) -> int:
    """hash_value, remembered per (literal, type): a plan probes every
    candidate file's bloom filter with the same literals."""
    try:
        return _hash_of(value, arrow_type)
    except TypeError:                     # an unhashable literal
        return hash_value(value, arrow_type)


def _leaf_mask(fi: FileIndexes, leaf, arrow_type=None) \
        -> Optional[np.ndarray]:
    idxs = fi.column(leaf.field)
    if not idxs:
        return None
    for tag in _SELECTIVE:
        idx = idxs.get(tag)
        if idx is None:
            continue
        mask, _exact = idx.eval(leaf.op, leaf.literal)
        if mask is not None:
            return mask
    bf = idxs.get(TYPE_BLOOM)
    if isinstance(bf, BloomFilter) and arrow_type is not None and \
            leaf.op in ("eq", "in"):
        lits = leaf.literal if leaf.op == "in" else [leaf.literal]
        try:
            hit = any(bf.might_contain(_literal_hash(v, arrow_type))
                      for v in lits)
        except (ValueError, pa.ArrowInvalid):
            return None
        if not hit:
            return np.zeros(1, dtype=bool)   # provably no match
    return None


def _eval(fi: FileIndexes, pred, types: Dict[str, pa.DataType]) \
        -> Optional[np.ndarray]:
    from paimon_tpu_torch.predicate import Compound, Leaf
    if isinstance(pred, Leaf):
        return _leaf_mask(fi, pred, types.get(pred.field))
    if isinstance(pred, Compound):
        if pred.op == "and":
            masks = [m for m in (_eval(fi, c, types) for c in pred.children)
                     if m is not None]
            if not masks:
                return None
            n = max(len(m) for m in masks)
            out = np.ones(n, dtype=bool)
            for m in masks:
                out &= m if len(m) == n else \
                    (np.zeros(n, bool) if not m.any() else np.ones(n, bool))
            return out
        if pred.op == "or":
            masks = [_eval(fi, c, types) for c in pred.children]
            if any(m is None for m in masks):
                return None
            n = max(len(m) for m in masks)
            out = np.zeros(n, dtype=bool)
            for m in masks:
                out |= m if len(m) == n else \
                    (np.ones(n, bool) if m.any() else np.zeros(n, bool))
            return out
        return None                        # NOT of a superset is unsafe
    return None


def evaluate_skip(fi: FileIndexes, pred,
                  types: Optional[Dict[str, pa.DataType]] = None) -> bool:
    """True when the indexes prove no row of the file can match."""
    if not fi or pred is None:
        return False
    mask = _eval(fi, pred, types or {})
    return mask is not None and not mask.any()


def row_selection(fi: FileIndexes, pred, num_rows: int,
                  types: Optional[Dict[str, pa.DataType]] = None
                  ) -> Optional[np.ndarray]:
    """Superset row mask for prefiltering, or None when indexes cannot
    narrow the file (bloom-only hits, unsupported ops, ...)."""
    if not fi or pred is None:
        return None
    mask = _eval(fi, pred, types or {})
    if mask is None or len(mask) != num_rows:
        return None
    return mask
