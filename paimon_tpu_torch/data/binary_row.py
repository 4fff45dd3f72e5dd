"""BinaryRow wire codec.

Wire format (reference paimon-common/.../data/BinaryRow.java:60 and
docs/docs/concepts/spec/manifest.md appendix):

  [4-byte big-endian arity]            -- only in serialized (manifest) form
  fixed part:
    byte 0: header (RowKind)
    null bitset: bit (i+8) set => field i null; width rounds (arity+8) bits
      up to 64-bit words
    arity * 8-byte slots, little-endian
  variable part: 8-byte-aligned var-length data

Var-length slot encoding: if len <= 7 the bytes live inline in the slot and
the top byte is 0x80|len; otherwise slot = (absolute_offset << 32) | len.
Decimal(p>18): 16-byte var area, big-endian signed unscaled.
Timestamp(p>3): slot = (offset << 32) | nano_of_milli; millis in var area.
"""

from __future__ import annotations

import struct
from datetime import date, datetime, time, timedelta
from decimal import Decimal
from typing import Any, List, Optional, Sequence, Tuple

from paimon_tpu_torch.types import (
    ArrayType, BigIntType, BinaryType, BlobType, BooleanType, CharType,
    DataType, DateType, DecimalType, DoubleType, FloatType, IntType,
    LocalZonedTimestampType, MapType, MultisetType, RowType, SmallIntType,
    TimeType, TimestampType, TinyIntType, VarBinaryType, VarCharType,
)

__all__ = ["BinaryRowCodec", "BINARY_ROW_EMPTY"]

_HEADER_BITS = 8
_MAX_INLINE = 7
_EPOCH = date(1970, 1, 1)


def _bitset_width(arity: int) -> int:
    return ((arity + 63 + _HEADER_BITS) // 64) * 8


def _round_word(n: int) -> int:
    return ((n + 7) // 8) * 8


def _is_compact_decimal(t: DecimalType) -> bool:
    return t.precision <= 18


def _is_compact_ts(t) -> bool:
    return t.precision <= 3


class BinaryRowCodec:
    """Encode/decode tuples of Python values <-> BinaryRow bytes for a fixed
    list of field types. Supports the atomic types that appear in partition
    values and column stats."""

    def __init__(self, field_types: Sequence[DataType]):
        self.field_types = list(field_types)
        self.arity = len(self.field_types)
        self._null_bytes = _bitset_width(self.arity)
        self._fixed_size = self._null_bytes + self.arity * 8

    # -- encode --------------------------------------------------------------

    def to_bytes(self, values: Sequence[Any], row_kind: int = 0,
                 with_arity_prefix: bool = True) -> bytes:
        assert len(values) == self.arity, (len(values), self.arity)
        fixed = bytearray(self._fixed_size)
        fixed[0] = row_kind
        var_parts: List[bytes] = []
        var_off = 0

        for i, (v, t) in enumerate(zip(values, self.field_types)):
            slot = self._null_bytes + i * 8
            if v is None:
                idx = i + _HEADER_BITS
                fixed[idx // 8] |= 1 << (idx % 8)
                continue
            if isinstance(t, BooleanType):
                fixed[slot] = 1 if v else 0
            elif isinstance(t, TinyIntType):
                struct.pack_into("<b", fixed, slot, int(v))
            elif isinstance(t, SmallIntType):
                struct.pack_into("<h", fixed, slot, int(v))
            elif isinstance(t, (IntType, DateType, TimeType)):
                struct.pack_into("<i", fixed, slot, _to_int32(v, t))
            elif isinstance(t, BigIntType):
                struct.pack_into("<q", fixed, slot, int(v))
            elif isinstance(t, FloatType):
                struct.pack_into("<f", fixed, slot, float(v))
            elif isinstance(t, DoubleType):
                struct.pack_into("<d", fixed, slot, float(v))
            elif isinstance(t, DecimalType):
                var_off = self._put_decimal(v, t, fixed, slot, var_parts,
                                            var_off)
            elif isinstance(t, (TimestampType, LocalZonedTimestampType)):
                var_off = self._put_timestamp(v, t, fixed, slot, var_parts,
                                              var_off)
            elif isinstance(t, (CharType, VarCharType)):
                var_off = self._put_var(str(v).encode("utf-8"), fixed, slot,
                                        var_parts, var_off)
            elif isinstance(t, (BinaryType, VarBinaryType, BlobType)):
                var_off = self._put_var(bytes(v), fixed, slot, var_parts,
                                        var_off)
            else:
                raise ValueError(f"BinaryRow cannot encode type {t}")

        body = bytes(fixed) + b"".join(var_parts)
        if with_arity_prefix:
            return struct.pack(">i", self.arity) + body
        return body

    def _put_var(self, data: bytes, fixed: bytearray, slot: int,
                 var_parts: List[bytes], var_off: int) -> int:
        n = len(data)
        if n <= _MAX_INLINE:
            fixed[slot:slot + n] = data
            fixed[slot + 7] = 0x80 | n
            return var_off
        padded = data + b"\x00" * (_round_word(n) - n)
        abs_off = self._fixed_size + var_off
        struct.pack_into("<q", fixed, slot, (abs_off << 32) | n)
        var_parts.append(padded)
        return var_off + len(padded)

    def _put_decimal(self, v, t: DecimalType, fixed: bytearray, slot: int,
                     var_parts: List[bytes], var_off: int) -> int:
        d = v if isinstance(v, Decimal) else Decimal(str(v))
        unscaled = int(d.scaleb(t.scale).to_integral_value())
        if _is_compact_decimal(t):
            struct.pack_into("<q", fixed, slot, unscaled)
            return var_off
        nbytes = max(1, (unscaled.bit_length() + 8) // 8)
        data = unscaled.to_bytes(nbytes, "big", signed=True)
        padded = data + b"\x00" * (16 - len(data))
        abs_off = self._fixed_size + var_off
        struct.pack_into("<q", fixed, slot, (abs_off << 32) | len(data))
        var_parts.append(padded)
        return var_off + 16

    def _put_timestamp(self, v, t, fixed: bytearray, slot: int,
                       var_parts: List[bytes], var_off: int) -> int:
        millis, nanos = _to_millis_nanos(v)
        if _is_compact_ts(t):
            struct.pack_into("<q", fixed, slot, millis)
            return var_off
        abs_off = self._fixed_size + var_off
        struct.pack_into("<q", fixed, slot, (abs_off << 32) | nanos)
        var_parts.append(struct.pack("<q", millis))
        return var_off + 8

    # -- decode --------------------------------------------------------------

    def from_bytes(self, data: bytes,
                   with_arity_prefix: bool = True) -> Tuple[Any, ...]:
        if with_arity_prefix and len(data) >= 4:
            data = data[4:]
        if not data:
            return tuple([None] * self.arity)
        out: List[Any] = []
        for i, t in enumerate(self.field_types):
            idx = i + _HEADER_BITS
            if data[idx // 8] & (1 << (idx % 8)):
                out.append(None)
                continue
            slot = self._null_bytes + i * 8
            out.append(self._get(data, slot, t))
        return tuple(out)

    def row_kind(self, data: bytes, with_arity_prefix: bool = True) -> int:
        if with_arity_prefix and len(data) >= 4:
            data = data[4:]
        return data[0] if data else 0

    def _get(self, data: bytes, slot: int, t: DataType) -> Any:
        if isinstance(t, BooleanType):
            return data[slot] != 0
        if isinstance(t, TinyIntType):
            return struct.unpack_from("<b", data, slot)[0]
        if isinstance(t, SmallIntType):
            return struct.unpack_from("<h", data, slot)[0]
        if isinstance(t, IntType):
            return struct.unpack_from("<i", data, slot)[0]
        if isinstance(t, DateType):
            return _EPOCH + timedelta(
                days=struct.unpack_from("<i", data, slot)[0])
        if isinstance(t, TimeType):
            ms = struct.unpack_from("<i", data, slot)[0]
            s, msec = divmod(ms, 1000)
            return time(s // 3600, (s % 3600) // 60, s % 60, msec * 1000)
        if isinstance(t, BigIntType):
            return struct.unpack_from("<q", data, slot)[0]
        if isinstance(t, FloatType):
            return struct.unpack_from("<f", data, slot)[0]
        if isinstance(t, DoubleType):
            return struct.unpack_from("<d", data, slot)[0]
        if isinstance(t, DecimalType):
            return self._get_decimal(data, slot, t)
        if isinstance(t, (TimestampType, LocalZonedTimestampType)):
            return self._get_timestamp(data, slot, t)
        if isinstance(t, (CharType, VarCharType)):
            return self._get_var(data, slot).decode("utf-8")
        if isinstance(t, (BinaryType, VarBinaryType, BlobType)):
            return self._get_var(data, slot)
        raise ValueError(f"BinaryRow cannot decode type {t}")

    @staticmethod
    def _get_var(data: bytes, slot: int) -> bytes:
        raw = struct.unpack_from("<q", data, slot)[0]
        if raw & (0x80 << 56):
            n = (raw >> 56) & 0x7F
            return data[slot:slot + n]
        off = (raw >> 32) & 0xFFFFFFFF
        n = raw & 0xFFFFFFFF
        return data[off:off + n]

    def _get_decimal(self, data: bytes, slot: int, t: DecimalType) -> Decimal:
        if _is_compact_decimal(t):
            unscaled = struct.unpack_from("<q", data, slot)[0]
        else:
            raw = struct.unpack_from("<q", data, slot)[0]
            off = (raw >> 32) & 0xFFFFFFFF
            n = raw & 0xFFFFFFFF
            unscaled = int.from_bytes(data[off:off + n], "big", signed=True)
        return Decimal(unscaled).scaleb(-t.scale)

    def _get_timestamp(self, data: bytes, slot: int, t) -> datetime:
        if _is_compact_ts(t):
            millis = struct.unpack_from("<q", data, slot)[0]
            nanos = 0
        else:
            raw = struct.unpack_from("<q", data, slot)[0]
            nanos = raw & 0xFFFFFFFF
            off = (raw >> 32) & 0xFFFFFFFF
            millis = struct.unpack_from("<q", data, off)[0]
        return _from_millis_nanos(millis, nanos)


def _to_int32(v, t) -> int:
    if isinstance(t, DateType):
        if isinstance(v, date) and not isinstance(v, datetime):
            return (v - _EPOCH).days
        return int(v)
    if isinstance(t, TimeType):
        if isinstance(v, time):
            return ((v.hour * 3600 + v.minute * 60 + v.second) * 1000
                    + v.microsecond // 1000)
        return int(v)
    return int(v)


def _to_millis_nanos(v) -> Tuple[int, int]:
    if isinstance(v, datetime):
        epoch = datetime(1970, 1, 1, tzinfo=v.tzinfo)
        delta = v - epoch
        micros = (delta.days * 86400 + delta.seconds) * 1_000_000 \
            + delta.microseconds
        millis, rem_us = divmod(micros, 1000)
        return millis, rem_us * 1000
    return int(v), 0


def _from_millis_nanos(millis: int, nanos: int = 0) -> datetime:
    return (datetime(1970, 1, 1)
            + timedelta(milliseconds=millis, microseconds=nanos // 1000))


# The empty partition row ("no partition"), arity 0.
BINARY_ROW_EMPTY = BinaryRowCodec([]).to_bytes(())
