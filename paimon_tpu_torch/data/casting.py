"""Cast rule matrix for schema evolution and value coercion.

Counterpart of paimon_tpu/data/casting.py, whole.

reference: paimon-common/src/main/java/org/apache/paimon/casting/
CastExecutors.java — the rule table resolving (source, target) type
pairs to executors — and the individual rules (NumericPrimitiveCastRule,
StringToNumericPrimitiveCastRule, StringToBooleanCastRule,
NumericToBooleanCastRule, StringToDateCastRule, StringToTimestampCastRule,
DateToTimestampCastRule, NumericPrimitiveToTimestamp,
DecimalToDecimalCastRule, BinaryToStringCastRule, StringToBinaryCastRule,
BinaryToBinaryCastRule, StringToStringCastRule, *ToStringCastRule, ...).

Semantics follow the Java executors where they differ from Arrow:
- int -> narrower int: two's-complement bit truncation (Java (int)(long))
- float/double -> int: truncate toward zero, SATURATE at the target's
  min/max (Java float-to-integral conversion)
- numeric -> boolean: value != 0; boolean -> numeric: 1/0
- string -> boolean: BinaryStringUtils.toBoolean token set
- string -> numeric/temporal: trimmed, invalid input raises (the Java
  rules throw NumberFormatException / DateTimeException)
- char(n)/varchar(n): truncate to n; char pads with spaces
- binary(n): truncate/zero-pad to n
- anything -> string: Java-style rendering (true/false, ISO temporals)

Every cast is whole-column vectorized (Arrow compute / numpy); no
per-row Python except the JSON-ish complex->string renders.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from paimon_tpu_torch.types import (
    ArrayType, BigIntType, BinaryType, BooleanType, CharType, DataType,
    DateType, DecimalType, DoubleType, FloatType, IntType,
    LocalZonedTimestampType, MapType, MultisetType, RowType, SmallIntType,
    TimeType, TimestampType, TinyIntType, VarBinaryType, VarCharType,
    data_type_to_arrow,
)

__all__ = ["can_cast", "cast_array", "CastError"]


class CastError(ValueError):
    pass


_INT_TYPES = (TinyIntType, SmallIntType, IntType, BigIntType)
_FLOAT_TYPES = (FloatType, DoubleType)
_STR_TYPES = (CharType, VarCharType)
_BIN_TYPES = (BinaryType, VarBinaryType)
_TS_TYPES = (TimestampType, LocalZonedTimestampType)

_INT_BITS = {TinyIntType: 8, SmallIntType: 16, IntType: 32,
             BigIntType: 64}
_NP_INT = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}

# reference utils/BinaryStringUtils.toBoolean token sets
_TRUE_TOKENS = {"true", "t", "yes", "y", "1"}
_FALSE_TOKENS = {"false", "f", "no", "n", "0"}


def _is_numeric(t: DataType) -> bool:
    return isinstance(t, _INT_TYPES + _FLOAT_TYPES + (DecimalType,))


def _chunked(arr) -> pa.ChunkedArray:
    if isinstance(arr, pa.ChunkedArray):
        return arr.combine_chunks()
    return arr


# -- individual rules --------------------------------------------------------

def _int_to_int(arr, src: DataType, dst: DataType):
    sb, db = _INT_BITS[type(src)], _INT_BITS[type(dst)]
    if db >= sb:
        return pc.cast(arr, data_type_to_arrow(dst))
    # Java narrowing = two's-complement truncation
    vals = np.asarray(_chunked(arr).fill_null(0)).astype(np.int64)
    out = vals.astype(_NP_INT[db])
    return pa.array(out, data_type_to_arrow(dst),
                    mask=np.asarray(pc.is_null(_chunked(arr))))


def _float_to_int(arr, src: DataType, dst: DataType):
    # JLS: float -> byte/short is float -> int (SATURATE at int bounds,
    # NaN -> 0) followed by int -> narrow (two's-complement truncation);
    # float -> long saturates at long bounds directly
    db = _INT_BITS[type(dst)]
    sat_bits = 64 if db == 64 else 32
    lo = -(1 << (sat_bits - 1))
    hi = (1 << (sat_bits - 1)) - 1
    vals = np.asarray(_chunked(arr).cast(pa.float64()).fill_null(0))
    trunc = np.trunc(vals)
    trunc = np.where(np.isnan(trunc), 0.0, trunc)
    # float64 cannot represent 2^63-1 (rounds up to 2^63), so a
    # float-space clip followed by astype would WRAP huge positives to
    # Long.MIN; saturate with explicit masks instead
    hi_f = float(1 << (sat_bits - 1))     # 2^(bits-1), exact in float
    hi_mask = trunc >= hi_f
    lo_mask = trunc <= float(lo)          # lo itself is exact
    safe = np.where(hi_mask | lo_mask, 0.0, trunc)
    out = np.where(hi_mask, hi, np.where(lo_mask, lo,
                                         safe.astype(np.int64)))
    return pa.array(out.astype(_NP_INT[db]), data_type_to_arrow(dst),
                    mask=np.asarray(pc.is_null(_chunked(arr))))


def _num_to_bool(arr, src, dst):
    base = _chunked(arr)
    if isinstance(src, DecimalType):
        base = base.cast(pa.float64())
    return pc.not_equal(base, pa.scalar(0, base.type)
                        if not pa.types.is_floating(base.type)
                        else pa.scalar(0.0, base.type))


def _bool_to_num(arr, src, dst):
    return pc.cast(pc.cast(arr, pa.int8()), data_type_to_arrow(dst))


def _str_to_bool(arr, src, dst):
    s = pc.utf8_lower(pc.utf8_trim_whitespace(_chunked(arr)))
    t = pc.is_in(s, value_set=pa.array(sorted(_TRUE_TOKENS)))
    f = pc.is_in(s, value_set=pa.array(sorted(_FALSE_TOKENS)))
    bad = pc.and_(pc.and_(pc.invert(t), pc.invert(f)), pc.is_valid(s))
    if pc.any(bad).as_py():
        val = s.filter(bad)[0].as_py()
        raise CastError(f"cannot cast string {val!r} to boolean")
    return pc.if_else(pc.is_valid(s), t, pa.nulls(len(s), pa.bool_()))


def _str_to_num(arr, src, dst):
    s = pc.utf8_trim_whitespace(_chunked(arr))
    try:
        if isinstance(dst, _INT_TYPES):
            # Java parses then range-checks; arrow safe cast does both
            return pc.cast(pc.cast(s, pa.int64()),
                           data_type_to_arrow(dst))
        return pc.cast(s, data_type_to_arrow(dst))
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as e:
        raise CastError(str(e)) from e


def _str_to_date(arr, src, dst):
    s = pc.utf8_trim_whitespace(_chunked(arr))
    try:
        return pc.cast(s, pa.date32())
    except pa.ArrowInvalid as e:
        raise CastError(str(e)) from e


def _str_to_time(arr, src, dst):
    s = pc.utf8_trim_whitespace(_chunked(arr))
    try:
        return pc.cast(s, pa.time32("ms")) \
            .cast(data_type_to_arrow(dst))
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        # HH:MM[:SS[.fff]] manual parse, vectorized per component
        try:
            parts = pc.split_pattern(s, ":")
            lst = parts.to_pylist()
            out = []
            for p in lst:
                if p is None:
                    out.append(None)
                    continue
                h, m = int(p[0]), int(p[1])
                sec = float(p[2]) if len(p) > 2 else 0.0
                # round, not truncate: 0.57*1000 is 569.999... in float
                out.append((h * 3600 + m * 60) * 1000
                           + round(sec * 1000))
            return pa.array(out, pa.time32("ms")).cast(
                data_type_to_arrow(dst))
        except (ValueError, IndexError) as e:
            raise CastError(f"bad time literal: {e}") from e


def _str_to_ts(arr, src, dst):
    s = pc.utf8_trim_whitespace(_chunked(arr))
    try:
        return pc.cast(s, data_type_to_arrow(dst))
    except pa.ArrowInvalid as e:
        raise CastError(str(e)) from e


def _date_to_ts(arr, src, dst):
    return pc.cast(pc.cast(arr, pa.timestamp("ms")),
                   data_type_to_arrow(dst))


def _ts_to_date(arr, src, dst):
    return pc.cast(_chunked(arr), pa.date32(), safe=False)


def _ts_to_time(arr, src, dst):
    ms = pc.cast(_chunked(arr), pa.timestamp("ms"), safe=False)
    vals = np.asarray(ms.cast(pa.int64()))
    return pa.array((vals % 86_400_000).astype(np.int32),
                    pa.time32("ms"),
                    mask=np.asarray(pc.is_null(ms))) \
        .cast(data_type_to_arrow(dst))


def _num_to_ts(arr, src, dst):
    # reference NumericPrimitiveToTimestamp: epoch SECONDS
    secs = pc.cast(_chunked(arr), pa.int64())
    ms = pc.multiply(secs, pa.scalar(1000, pa.int64()))
    return pc.cast(ms, pa.timestamp("ms")).cast(data_type_to_arrow(dst))


def _to_decimal(arr, src, dst: DecimalType):
    try:
        base = _chunked(arr)
        if isinstance(src, _STR_TYPES):
            base = pc.utf8_trim_whitespace(base)
        elif isinstance(src, _INT_TYPES):
            # arrow demands precision headroom for int inputs; widen to
            # the max then narrow with the overflow check (Java
            # DecimalUtils.castFrom overflow -> error)
            base = pc.cast(base, pa.decimal128(38, dst.scale))
        return pc.cast(base, data_type_to_arrow(dst))
    except pa.ArrowInvalid as e:
        raise CastError(str(e)) from e


def _decimal_to_num(arr, src, dst):
    if isinstance(dst, _FLOAT_TYPES):
        return pc.cast(_chunked(arr), data_type_to_arrow(dst))
    # exact integral part (Java BigDecimal truncates toward zero, then
    # the long narrows by bit truncation) — no float64 detour, which
    # would corrupt >2^53 values
    import decimal as _dec
    db = _INT_BITS[type(dst)]
    base = _chunked(arr)
    vals = [None if v is None else
            int(v.to_integral_value(rounding=_dec.ROUND_DOWN))
            for v in base.to_pylist()]
    mask = np.array([v is None for v in vals])
    ints = np.array([0 if v is None else (v & ((1 << 64) - 1))
                     for v in vals], dtype=np.uint64).view(np.int64)
    return pa.array(ints.astype(_NP_INT[db]), data_type_to_arrow(dst),
                    mask=mask)


def _str_to_str(arr, src, dst):
    s = _chunked(arr).cast(pa.large_string()).cast(pa.string())
    length = getattr(dst, "length", None)
    if isinstance(dst, CharType):
        s = pc.utf8_slice_codeunits(s, 0, length)
        return pc.utf8_rpad(s, width=length, padding=" ")
    if isinstance(dst, VarCharType) and length is not None and \
            length < VarCharType.MAX_LENGTH:
        return pc.utf8_slice_codeunits(s, 0, length)
    return s


def _bin_to_bin(arr, src, dst):
    length = getattr(dst, "length", None)
    vals = _chunked(arr).cast(pa.large_binary()).to_pylist()
    if isinstance(dst, BinaryType) and length is not None:
        vals = [None if v is None else
                (v[:length] + b"\x00" * (length - len(v)))
                for v in vals]
    elif isinstance(dst, VarBinaryType) and length is not None and \
            length < VarBinaryType.MAX_LENGTH:
        vals = [None if v is None else v[:length] for v in vals]
    return pa.array(vals, data_type_to_arrow(dst))


def _str_to_bin(arr, src, dst):
    return _bin_to_bin(pc.cast(_chunked(arr), pa.large_binary()), src,
                       dst)


def _bin_to_str(arr, src, dst):
    try:
        return _str_to_str(_chunked(arr).cast(pa.large_string()), src,
                           dst)
    except pa.ArrowInvalid as e:
        raise CastError(str(e)) from e


def _any_to_string(arr, src, dst):
    base = _chunked(arr)
    if isinstance(src, BooleanType):
        out = pc.if_else(base, pa.scalar("true"), pa.scalar("false"))
        return _str_to_str(out, src, dst)
    if isinstance(src, (_INT_TYPES + (DecimalType, DateType))) or \
            isinstance(src, _TS_TYPES) or isinstance(src, TimeType):
        return _str_to_str(pc.cast(base, pa.string()), src, dst)
    if isinstance(src, _FLOAT_TYPES):
        # Java Double.toString always carries a decimal point
        # ("1.0", not "1"); python repr matches that shape (exponent
        # spelling differs only at extreme magnitudes)
        rendered = pa.array(
            [None if v is None else repr(float(v))
             for v in base.to_pylist()], pa.string())
        return _str_to_str(rendered, src, dst)
    if isinstance(src, (ArrayType, MapType, MultisetType, RowType)):
        import json

        def render(v):
            if v is None:
                return None
            return json.dumps(v, default=str, separators=(",", ":"))
        return _str_to_str(
            pa.array([render(v) for v in base.to_pylist()], pa.string()),
            src, dst)
    raise CastError(f"no to-string rule for {src}")


# -- rule resolution ---------------------------------------------------------

def _resolve(src: DataType, dst: DataType) -> Optional[Callable]:
    if type(src) is type(dst):
        if isinstance(src, _STR_TYPES):
            return _str_to_str
        if isinstance(src, _BIN_TYPES):
            return _bin_to_bin
        if isinstance(src, DecimalType):
            return _to_decimal
        return lambda a, s, d: pc.cast(_chunked(a),
                                       data_type_to_arrow(d))
    if isinstance(src, _INT_TYPES) and isinstance(dst, _INT_TYPES):
        return _int_to_int
    if isinstance(src, _INT_TYPES) and isinstance(dst, _FLOAT_TYPES):
        return lambda a, s, d: pc.cast(_chunked(a),
                                       data_type_to_arrow(d))
    if isinstance(src, _FLOAT_TYPES) and isinstance(dst, _FLOAT_TYPES):
        return lambda a, s, d: pc.cast(_chunked(a),
                                       data_type_to_arrow(d), safe=False)
    if isinstance(src, _FLOAT_TYPES) and isinstance(dst, _INT_TYPES):
        return _float_to_int
    if _is_numeric(src) and isinstance(dst, BooleanType):
        return _num_to_bool
    if isinstance(src, BooleanType) and _is_numeric(dst) and \
            not isinstance(dst, DecimalType):
        return _bool_to_num
    if isinstance(src, BooleanType) and isinstance(dst, DecimalType):
        return lambda a, s, d: _to_decimal(_bool_to_num(a, s, IntType()),
                                           IntType(), d)
    if isinstance(src, DecimalType) and _is_numeric(dst):
        return _decimal_to_num
    if _is_numeric(src) and isinstance(dst, DecimalType):
        return _to_decimal
    if isinstance(src, _STR_TYPES):
        if isinstance(dst, BooleanType):
            return _str_to_bool
        if isinstance(dst, DecimalType):
            return _to_decimal
        if _is_numeric(dst):
            return _str_to_num
        if isinstance(dst, DateType):
            return _str_to_date
        if isinstance(dst, TimeType):
            return _str_to_time
        if isinstance(dst, _TS_TYPES):
            return _str_to_ts
        if isinstance(dst, _BIN_TYPES):
            return _str_to_bin
        if isinstance(dst, _STR_TYPES):
            return _str_to_str
    if isinstance(dst, _STR_TYPES):
        if isinstance(src, _BIN_TYPES):
            return _bin_to_str
        return _any_to_string
    if isinstance(src, DateType) and isinstance(dst, _TS_TYPES):
        return _date_to_ts
    if isinstance(src, _TS_TYPES) and isinstance(dst, DateType):
        return _ts_to_date
    if isinstance(src, _TS_TYPES) and isinstance(dst, TimeType):
        return _ts_to_time
    if isinstance(src, _TS_TYPES) and isinstance(dst, _TS_TYPES):
        return lambda a, s, d: pc.cast(_chunked(a),
                                       data_type_to_arrow(d), safe=False)
    if isinstance(src, _INT_TYPES) and isinstance(dst, _TS_TYPES):
        return _num_to_ts
    if isinstance(src, _BIN_TYPES) and isinstance(dst, _BIN_TYPES):
        return _bin_to_bin
    return None


def can_cast(src: DataType, dst: DataType) -> bool:
    """reference CastExecutors.resolve != null."""
    return _resolve(src, dst) is not None


def cast_array(arr, src: DataType, dst: DataType):
    """Cast a column under the rule matrix; raises CastError when no
    rule exists or the data is invalid for the target."""
    rule = _resolve(src, dst)
    if rule is None:
        raise CastError(f"no cast rule {src} -> {dst} "
                        f"(reference CastExecutors.resolve)")
    out = rule(arr, src, dst)
    want = data_type_to_arrow(dst)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    if out.type != want:
        out = out.cast(want)
    return out
