"""Bitmap, bit-sliced (BSI) and range-bitmap per-file column indexes.

Copy of paimon_tpu/index/bitmap.py (numpy and pyarrow only); each
serialized form is the reference's byte for byte.  A range bitmap built
here keeps each row's bin: its cumulative position lists are derived
when asked for, and its serialized lists are encoded container by
container from the bins (index/roaring.py
`serialize_roaring32_cumulative`), never materialized (the reference
sorts every prefix: the same lists, the same bytes).

reference: paimon-common/src/main/java/org/apache/paimon/fileindex/
bitmap/BitmapFileIndex.java (distinct value -> row-position bitmap),
bsi/BitSliceIndexBitmap.java (O'Neil bit-sliced arithmetic for range
predicates over integers), rangebitmap/RangeBitmap.java (range-encoded
bins).  All three serialize row positions with the portable roaring32
codec shared with deletion vectors (index/roaring.py).

TPU-first shape: builds are whole-column vectorized (Arrow
dictionary_encode / np.unique + one stable argsort; bit-slices peel off
with shifts over the full value vector), and predicate evaluation works
on dense numpy bool masks so AND/OR/NOT over selections are single
vector ops — no per-row loops anywhere.

Evaluation contract:
  eval(op, literal) -> (mask, exact)
where mask is a bool[num_rows] selection (None = cannot evaluate) and
exact says whether the mask is precise or a conservative superset (the
read path always re-applies the predicate exactly, so supersets only
cost unpruned rows, never correctness).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from paimon_tpu_torch.index.roaring import (
    deserialize_roaring32, serialize_roaring32,
    serialize_roaring32_cumulative,
)

__all__ = ["BitmapIndex", "BSIIndex", "RangeBitmapIndex"]


# -- typed literal codec -----------------------------------------------------

_KIND_INT, _KIND_FLOAT, _KIND_STR, _KIND_BYTES = 0, 1, 2, 3


def _column_values(col) -> Tuple[np.ndarray, "pa.Array", int, np.ndarray]:
    """-> (valid_positions, values_array, kind, null_positions)."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    t = arr.type
    nulls = np.asarray(pc.is_null(arr))
    null_pos = np.flatnonzero(nulls).astype(np.uint32)
    valid_pos = np.flatnonzero(~nulls).astype(np.uint32)
    vals = arr.drop_null()
    if pa.types.is_integer(t) or pa.types.is_boolean(t) or \
            pa.types.is_temporal(t):
        try:
            vals = vals.cast(pa.int64())
        except pa.ArrowInvalid:
            vals = vals.cast(pa.int64(), safe=False)
        return valid_pos, vals, _KIND_INT, null_pos
    if pa.types.is_floating(t):
        return valid_pos, vals.cast(pa.float64()), _KIND_FLOAT, null_pos
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return valid_pos, vals.cast(pa.large_string()), _KIND_STR, null_pos
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return valid_pos, vals.cast(pa.large_binary()), _KIND_BYTES, null_pos
    raise ValueError(f"bitmap index unsupported for type {t}")


def _encode_literal(v, kind: int) -> bytes:
    if kind == _KIND_INT:
        return struct.pack("<q", int(v))
    if kind == _KIND_FLOAT:
        return struct.pack("<d", float(v))
    b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
    return struct.pack("<I", len(b)) + b


def _norm_literal(v, kind: int):
    if kind == _KIND_INT:
        if isinstance(v, bool):
            return int(v)
        if not isinstance(v, int):
            return None
        return v
    if kind == _KIND_FLOAT:
        return float(v) if isinstance(v, (int, float)) else None
    if kind == _KIND_STR:
        return v if isinstance(v, str) else None
    return bytes(v) if isinstance(v, (bytes, bytearray)) else None


def _prefix_successor(prefix: str):
    """Smallest string greater than every string with this prefix:
    drop trailing U+10FFFF chars, bump the last remaining code point.
    None = no upper bound (prefix was all U+10FFFF)."""
    trimmed = prefix.rstrip(chr(0x10FFFF))
    if not trimmed:
        return None
    return trimmed[:-1] + chr(ord(trimmed[-1]) + 1)


def _mask_of(positions: np.ndarray, n: int) -> np.ndarray:
    m = np.zeros(n, dtype=bool)
    m[positions] = True
    return m


# -- bitmap index ------------------------------------------------------------

class BitmapIndex:
    """Distinct value -> roaring bitmap of row positions.  Distinct
    values are kept sorted, so range predicates evaluate as a contiguous
    union of position lists (beyond the reference's eq/in surface)."""

    TYPE_TAG = 1

    def __init__(self, num_rows: int, kind: int, distinct: list,
                 pos_lists: List[np.ndarray], null_pos: np.ndarray):
        self.num_rows = num_rows
        self.kind = kind
        self.distinct = distinct          # sorted python values
        self.pos_lists = pos_lists        # uint32 positions per distinct
        self.null_pos = null_pos

    # build ------------------------------------------------------------------

    @staticmethod
    def build(col, max_distinct: int = 1 << 16) -> Optional["BitmapIndex"]:
        n = len(col)
        valid_pos, vals, kind, null_pos = _column_values(col)
        if len(vals) == 0:
            return BitmapIndex(n, kind, [], [], null_pos)
        dictionary = pc.dictionary_encode(vals)
        if isinstance(dictionary, pa.ChunkedArray):
            dictionary = dictionary.combine_chunks()
        codes = np.asarray(dictionary.indices)
        dict_vals = dictionary.dictionary
        if len(dict_vals) > max_distinct:
            return None                   # too high cardinality
        # sort dictionary so eval can binary-search / range-slice
        sort_idx = np.asarray(pc.sort_indices(dict_vals)).astype(np.int64)
        rank = np.empty(len(sort_idx), dtype=np.int64)
        rank[sort_idx] = np.arange(len(sort_idx))
        sorted_codes = rank[codes]
        order = np.argsort(sorted_codes, kind="stable")
        counts = np.bincount(sorted_codes, minlength=len(dict_vals))
        bounds = np.concatenate([[0], np.cumsum(counts)])
        pos_sorted = valid_pos[order]
        pos_lists = [pos_sorted[bounds[i]:bounds[i + 1]]
                     for i in range(len(dict_vals))]
        distinct = dict_vals.take(pa.array(sort_idx)).to_pylist()
        if kind == _KIND_BYTES:
            distinct = [bytes(d) for d in distinct]
        return BitmapIndex(n, kind, distinct, pos_lists, null_pos)

    # eval -------------------------------------------------------------------

    def _find(self, v) -> int:
        import bisect
        return bisect.bisect_left(self.distinct, v)

    def _union(self, lo: int, hi: int) -> np.ndarray:
        if lo >= hi:
            return np.zeros(0, dtype=np.uint32)
        return np.concatenate(self.pos_lists[lo:hi]) \
            if hi - lo > 1 else self.pos_lists[lo]

    def eval(self, op: str, literal) -> Tuple[Optional[np.ndarray], bool]:
        n = self.num_rows
        if op == "is_null":
            return _mask_of(self.null_pos, n), True
        if op == "is_not_null":
            return ~_mask_of(self.null_pos, n), True
        if op in ("eq", "ne"):
            v = _norm_literal(literal, self.kind)
            if v is None:
                return None, False
            i = self._find(v)
            hit = i < len(self.distinct) and self.distinct[i] == v
            m = _mask_of(self.pos_lists[i], n) if hit \
                else np.zeros(n, dtype=bool)
            if op == "ne":
                m = ~m & ~_mask_of(self.null_pos, n)
            return m, True
        if op in ("in", "not_in"):
            m = np.zeros(n, dtype=bool)
            for raw in literal:
                v = _norm_literal(raw, self.kind)
                if v is None:
                    return None, False
                i = self._find(v)
                if i < len(self.distinct) and self.distinct[i] == v:
                    m |= _mask_of(self.pos_lists[i], n)
            if op == "not_in":
                m = ~m & ~_mask_of(self.null_pos, n)
            return m, True
        if op in ("lt", "le", "gt", "ge", "between"):
            if op == "between":
                lo_v = _norm_literal(literal[0], self.kind)
                hi_v = _norm_literal(literal[1], self.kind)
                if lo_v is None or hi_v is None:
                    return None, False
                import bisect
                lo = bisect.bisect_left(self.distinct, lo_v)
                hi = bisect.bisect_right(self.distinct, hi_v)
            else:
                v = _norm_literal(literal, self.kind)
                if v is None:
                    return None, False
                import bisect
                if op == "lt":
                    lo, hi = 0, bisect.bisect_left(self.distinct, v)
                elif op == "le":
                    lo, hi = 0, bisect.bisect_right(self.distinct, v)
                elif op == "gt":
                    lo, hi = bisect.bisect_right(self.distinct, v), \
                        len(self.distinct)
                else:
                    lo, hi = bisect.bisect_left(self.distinct, v), \
                        len(self.distinct)
            return _mask_of(self._union(lo, hi), n), True
        if op == "starts_with" and self.kind == _KIND_STR:
            import bisect
            lo = bisect.bisect_left(self.distinct, literal)
            succ = _prefix_successor(literal)
            # half-open [literal, successor): covers EVERY continuation
            # including U+10FFFF (an appended-sentinel bound would not)
            hi = bisect.bisect_left(self.distinct, succ) \
                if succ is not None else len(self.distinct)
            return _mask_of(self._union(lo, hi), n), True
        return None, False

    # serde ------------------------------------------------------------------

    def serialize(self) -> bytes:
        parts = [struct.pack("<IBI", self.num_rows, self.kind,
                             len(self.distinct))]
        nulls = serialize_roaring32(self.null_pos)
        parts.append(struct.pack("<I", len(nulls)))
        parts.append(nulls)
        for v, pos in zip(self.distinct, self.pos_lists):
            vb = _encode_literal(v, self.kind)
            pb = serialize_roaring32(pos)
            parts.append(struct.pack("<II", len(vb), len(pb)))
            parts.append(vb)
            parts.append(pb)
        return b"".join(parts)

    @staticmethod
    def deserialize(data: bytes) -> "BitmapIndex":
        num_rows, kind, nd = struct.unpack_from("<IBI", data, 0)
        p = 9
        (nlen,) = struct.unpack_from("<I", data, p)
        p += 4
        null_pos = deserialize_roaring32(data[p:p + nlen])
        p += nlen
        distinct, pos_lists = [], []
        for _ in range(nd):
            vlen, plen = struct.unpack_from("<II", data, p)
            p += 8
            vb = data[p:p + vlen]
            p += vlen
            if kind == _KIND_INT:
                distinct.append(struct.unpack("<q", vb)[0])
            elif kind == _KIND_FLOAT:
                distinct.append(struct.unpack("<d", vb)[0])
            else:
                (blen,) = struct.unpack_from("<I", vb, 0)
                raw = vb[4:4 + blen]
                distinct.append(raw.decode("utf-8")
                                if kind == _KIND_STR else raw)
            pos_lists.append(deserialize_roaring32(data[p:p + plen]))
            p += plen
        return BitmapIndex(num_rows, kind, distinct, pos_lists, null_pos)


# -- bit-sliced index --------------------------------------------------------

class BSIIndex:
    """Bit-sliced index over integer-like columns: values shift to
    non-negative deltas from the file min, and slice b holds the rows
    whose bit b is set.  Range predicates evaluate with the O'Neil
    slice recurrence — O(bits) vectorized mask ops, no value
    reconstruction (reference fileindex/bsi/BitSliceIndexBitmap.java)."""

    TYPE_TAG = 2

    def __init__(self, num_rows: int, min_val: int,
                 slices: List[np.ndarray], exists_pos: np.ndarray):
        self.num_rows = num_rows
        self.min_val = min_val
        self.slices = slices              # uint32 position lists per bit
        self.exists_pos = exists_pos

    @staticmethod
    def build(col) -> Optional["BSIIndex"]:
        n = len(col)
        valid_pos, vals, kind, _ = _column_values(col)
        if kind != _KIND_INT:
            return None
        if len(vals) == 0:
            return BSIIndex(n, 0, [], valid_pos)
        v = np.asarray(vals, dtype=np.int64)
        mn = int(v.min())
        delta = (v - mn).astype(np.uint64)
        bits = max(1, int(delta.max()).bit_length())
        slices = []
        for b in range(bits):
            hit = (delta >> np.uint64(b)) & np.uint64(1) == 1
            slices.append(valid_pos[hit])
        return BSIIndex(n, mn, slices, valid_pos)

    # -- O'Neil comparisons on dense masks -----------------------------------

    def _exists(self) -> np.ndarray:
        return _mask_of(self.exists_pos, self.num_rows)

    def _le(self, c: int) -> np.ndarray:
        """rows with delta <= c among existing rows."""
        n = self.num_rows
        if c < 0:
            return np.zeros(n, dtype=bool)
        nbits = len(self.slices)
        if c >= (1 << nbits):
            return self._exists()         # c above every stored delta
        lt = np.zeros(n, dtype=bool)
        eq = self._exists()
        for b in range(nbits - 1, -1, -1):
            slice_mask = _mask_of(self.slices[b], n)
            if (c >> b) & 1:
                lt |= eq & ~slice_mask
            else:
                eq &= ~slice_mask
        # eq now = rows equal to c on all inspected bits
        return lt | eq

    def eval(self, op: str, literal) -> Tuple[Optional[np.ndarray], bool]:
        n = self.num_rows
        if op == "is_not_null":
            return self._exists(), True
        if op == "is_null":
            return ~self._exists(), True
        if op == "between":
            lo = _norm_literal(literal[0], _KIND_INT)
            hi = _norm_literal(literal[1], _KIND_INT)
            if lo is None or hi is None:
                return None, False
            m = self._le(hi - self.min_val) & \
                ~self._le(lo - self.min_val - 1)
            return m & self._exists(), True
        v = _norm_literal(literal, _KIND_INT) \
            if op in ("eq", "ne", "lt", "le", "gt", "ge") else None
        if v is None:
            return None, False
        c = v - self.min_val
        ex = self._exists()
        if op == "eq":
            return (self._le(c) & ~self._le(c - 1)) & ex, True
        if op == "ne":
            return ~(self._le(c) & ~self._le(c - 1)) & ex, True
        if op == "lt":
            return self._le(c - 1) & ex, True
        if op == "le":
            return self._le(c) & ex, True
        if op == "gt":
            return ~self._le(c) & ex, True
        if op == "ge":
            return ~self._le(c - 1) & ex, True
        return None, False

    def serialize(self) -> bytes:
        parts = [struct.pack("<IqI", self.num_rows, self.min_val,
                             len(self.slices))]
        ex = serialize_roaring32(self.exists_pos)
        parts.append(struct.pack("<I", len(ex)))
        parts.append(ex)
        for s in self.slices:
            sb = serialize_roaring32(s)
            parts.append(struct.pack("<I", len(sb)))
            parts.append(sb)
        return b"".join(parts)

    @staticmethod
    def deserialize(data: bytes) -> "BSIIndex":
        num_rows, mn, nb = struct.unpack_from("<IqI", data, 0)
        p = 16
        (elen,) = struct.unpack_from("<I", data, p)
        p += 4
        exists_pos = deserialize_roaring32(data[p:p + elen])
        p += elen
        slices = []
        for _ in range(nb):
            (slen,) = struct.unpack_from("<I", data, p)
            p += 4
            slices.append(deserialize_roaring32(data[p:p + slen]))
            p += slen
        return BSIIndex(num_rows, mn, slices, exists_pos)


# -- range bitmap ------------------------------------------------------------

class RangeBitmapIndex:
    """Range-encoded binned bitmap: values bucket into <=64 quantile
    bins; bin b stores the rows with value <= upper_bound(b)
    (cumulative, so any range predicate is one or two bitmap lookups).
    Boundary bins make the selection a conservative superset — callers
    get exact=False and re-check rows (reference
    fileindex/rangebitmap/RangeBitmap.java)."""

    TYPE_TAG = 3

    def __init__(self, num_rows: int, kind: int, uppers: list,
                 cum_pos: Optional[List[np.ndarray]],
                 exists_pos: np.ndarray, min_val=0,
                 bins: Optional[np.ndarray] = None):
        self.num_rows = num_rows
        self.kind = kind
        self.uppers = uppers              # sorted bin upper bounds
        self._cum_pos = cum_pos           # rows with value <= uppers[i]
        self._bins = bins                 # or each existing row's bin
        self.exists_pos = exists_pos
        self.min_val = min_val            # exact file min for lower bound

    @property
    def cum_pos(self) -> List[np.ndarray]:
        if self._cum_pos is None:
            self._cum_pos = [self.exists_pos[self._bins <= i]
                             for i in range(len(self.uppers))]
        return self._cum_pos

    @staticmethod
    def build(col, max_bins: int = 64) -> Optional["RangeBitmapIndex"]:
        n = len(col)
        valid_pos, vals, kind, _ = _column_values(col)
        if kind not in (_KIND_INT, _KIND_FLOAT):
            return None
        if len(vals) == 0:
            return RangeBitmapIndex(n, kind, [], [], valid_pos)
        v = np.asarray(vals, dtype=np.int64 if kind == _KIND_INT
                       else np.float64)
        qs = np.unique(np.quantile(
            v, np.linspace(0, 1, max_bins + 1)[1:]))
        bin_of = np.searchsorted(qs, v, side="left")
        # the cumulative lists (rows with value <= qs[i]) are taken from
        # the bins when asked for; serialize() encodes them from the bins
        # integer values satisfy v <= q iff v <= floor(q), so floor keeps
        # "cum_pos[i] == rows with value <= uppers[i]" exact; int() would
        # truncate toward zero and break it for negative boundaries
        import math
        uppers = [math.floor(q) if kind == _KIND_INT else float(q)
                  for q in qs]
        mn = int(v.min()) if kind == _KIND_INT else float(v.min())
        return RangeBitmapIndex(n, kind, uppers, None, valid_pos, mn,
                                bins=bin_of)

    def _cum_mask(self, i: int) -> np.ndarray:
        """mask of rows with value <= uppers[i]; i < 0 or no bins
        (all-null column) -> empty."""
        if i < 0 or not self.uppers:
            return np.zeros(self.num_rows, dtype=bool)
        i = min(i, len(self.uppers) - 1)
        return _mask_of(self.cum_pos[i], self.num_rows)

    def eval(self, op: str, literal) -> Tuple[Optional[np.ndarray], bool]:
        import bisect
        if op == "is_not_null":
            return _mask_of(self.exists_pos, self.num_rows), True
        if op == "is_null":
            return ~_mask_of(self.exists_pos, self.num_rows), True
        if op == "between":
            lo = _norm_literal(literal[0], self.kind)
            hi = _norm_literal(literal[1], self.kind)
            if lo is None or hi is None:
                return None, False
            # superset: everything <= bin(hi) minus everything below the
            # bin strictly under lo
            hi_bin = bisect.bisect_left(self.uppers, hi)
            lo_bin = bisect.bisect_left(self.uppers, lo)
            m = self._cum_mask(hi_bin) & ~self._cum_mask(lo_bin - 1)
            exact = hi_bin < len(self.uppers) and \
                self.uppers[hi_bin] == hi and self.kind == _KIND_INT \
                and lo_bin == 0
            return m & _mask_of(self.exists_pos, self.num_rows), exact
        v = _norm_literal(literal, self.kind) \
            if op in ("eq", "lt", "le", "gt", "ge") else None
        if v is None:
            return None, False
        ex = _mask_of(self.exists_pos, self.num_rows)
        empty = np.zeros(self.num_rows, dtype=bool)
        mn = self.min_val
        mx = self.uppers[-1] if self.uppers else mn
        if self.uppers:
            # exact bound short-circuits: outside [min, max] is provable
            if (op == "lt" and v <= mn) or (op == "le" and v < mn) or \
                    (op == "gt" and v >= mx) or (op == "ge" and v > mx) \
                    or (op == "eq" and (v < mn or v > mx)):
                return empty, True
        i = bisect.bisect_left(self.uppers, v)
        if op in ("lt", "le"):
            return self._cum_mask(i) & ex, False
        if op in ("gt", "ge"):
            return ~self._cum_mask(i - 1) & ex, False
        if op == "eq":
            return (self._cum_mask(i) & ~self._cum_mask(i - 1)) & ex, False
        return None, False

    def serialize(self) -> bytes:
        parts = [struct.pack("<IBI", self.num_rows, self.kind,
                             len(self.uppers)),
                 struct.pack("<q" if self.kind == _KIND_INT else "<d",
                             self.min_val)]
        ex = serialize_roaring32(self.exists_pos)
        parts.append(struct.pack("<I", len(ex)))
        parts.append(ex)
        if self._cum_pos is None and len(self.uppers) < 255:
            blobs = serialize_roaring32_cumulative(
                self.exists_pos, self._bins, len(self.uppers))
        else:
            blobs = [serialize_roaring32(pos) for pos in self.cum_pos]
        for u, pb in zip(self.uppers, blobs):
            ub = _encode_literal(u, self.kind)
            parts.append(struct.pack("<HI", len(ub), len(pb)))
            parts.append(ub)
            parts.append(pb)
        return b"".join(parts)

    @staticmethod
    def deserialize(data: bytes) -> "RangeBitmapIndex":
        num_rows, kind, nb = struct.unpack_from("<IBI", data, 0)
        p = 9
        (min_val,) = struct.unpack_from(
            "<q" if kind == _KIND_INT else "<d", data, p)
        p += 8
        (elen,) = struct.unpack_from("<I", data, p)
        p += 4
        exists_pos = deserialize_roaring32(data[p:p + elen])
        p += elen
        uppers, cum_pos = [], []
        for _ in range(nb):
            ulen, plen = struct.unpack_from("<HI", data, p)
            p += 6
            ub = data[p:p + ulen]
            p += ulen
            uppers.append(struct.unpack("<q" if kind == _KIND_INT
                                        else "<d", ub)[0])
            cum_pos.append(deserialize_roaring32(data[p:p + plen]))
            p += plen
        return RangeBitmapIndex(num_rows, kind, uppers, cum_pos,
                                exists_pos, min_val)
