"""Computed columns for CDC ingestion.

reference: paimon-flink/paimon-flink-cdc/.../action/cdc/Expression.java
— derived columns evaluated per record at ingest time, typically to
synthesize partition values from event fields.  Supported expression
set mirrors the reference: year, month, day, hour, minute, second,
date_format(field, pattern), substring(field, begin[, end]),
truncate(field, width), cast(literal), upper, lower.

Spec strings look like the reference's CLI args:
    "part=date_format(ts, yyyy-MM-dd)"
    "y=year(ts)"  "pfx=substring(name, 0, 3)"  "b=truncate(id, 10)"

Counterpart of paimon_tpu/cdc/computed.py.
"""

from __future__ import annotations

import datetime
import re
from typing import Callable, Dict, List, Tuple

__all__ = ["parse_computed_columns", "apply_computed_columns"]

# Java SimpleDateFormat tokens -> strftime
_DATE_TOKENS = [("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
                ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]


def _to_strftime(pattern: str) -> str:
    out = pattern
    for token, repl in _DATE_TOKENS:
        out = out.replace(token, repl)
    return out


def _as_datetime(v) -> datetime.datetime:
    if isinstance(v, datetime.datetime):
        return v
    if isinstance(v, datetime.date):
        return datetime.datetime(v.year, v.month, v.day)
    if isinstance(v, (int, float)):
        # epoch millis when large, else seconds (reference TypeUtils)
        secs = v / 1000.0 if v > 10_000_000_000 else float(v)
        return datetime.datetime.fromtimestamp(
            secs, tz=datetime.timezone.utc).replace(tzinfo=None)
    return datetime.datetime.fromisoformat(str(v).replace("T", " ")
                                           .replace("Z", ""))


def _temporal(fn: Callable[[datetime.datetime], object]):
    def wrapped(row, field, *args):
        v = row.get(field)
        return None if v is None else fn(_as_datetime(v))
    return wrapped


_FUNCS: Dict[str, Callable] = {
    "year": _temporal(lambda d: d.year),
    "month": _temporal(lambda d: d.month),
    "day": _temporal(lambda d: d.day),
    "hour": _temporal(lambda d: d.hour),
    "minute": _temporal(lambda d: d.minute),
    "second": _temporal(lambda d: d.second),
}


def _date_format(row, field, pattern):
    v = row.get(field)
    if v is None:
        return None
    return _as_datetime(v).strftime(_to_strftime(pattern))


def _substring(row, field, begin, end=None):
    v = row.get(field)
    if v is None:
        return None
    s = str(v)
    b = int(begin)
    return s[b:int(end)] if end is not None else s[b:]


def _truncate(row, field, width):
    v = row.get(field)
    if v is None:
        return None
    w = int(width)
    if isinstance(v, int):
        return v - (v % w)               # reference: numeric bin
    return str(v)[:w]


def _cast(row, literal):
    return literal


def _upper(row, field):
    v = row.get(field)
    return None if v is None else str(v).upper()


def _lower(row, field):
    v = row.get(field)
    return None if v is None else str(v).lower()


_FUNCS.update({"date_format": _date_format, "substring": _substring,
               "truncate": _truncate, "cast": _cast, "upper": _upper,
               "lower": _lower})

_SPEC = re.compile(r"^\s*(\w+)\s*=\s*(\w+)\s*\(([^)]*)\)\s*$")


def parse_computed_columns(specs: List[str]
                           ) -> List[Tuple[str, Callable, List[str]]]:
    """['col=expr(args...)'] -> [(col, fn, args)] (reference
    ComputedColumnUtils.buildComputedColumns)."""
    out = []
    for spec in specs:
        m = _SPEC.match(spec)
        if not m:
            raise ValueError(f"bad computed column spec {spec!r}; "
                             f"expected name=func(args)")
        name, func, raw_args = m.groups()
        if func not in _FUNCS:
            raise ValueError(f"unknown computed-column function "
                             f"{func!r}; available: {sorted(_FUNCS)}")
        args = [a.strip() for a in raw_args.split(",") if a.strip()]
        out.append((name, _FUNCS[func], args))
    return out


def apply_computed_columns(rows: List[dict], computed) -> None:
    """Evaluate in place, row at a time (CDC batches are small; these
    run host-side before the columnar write path)."""
    for row in rows:
        for name, fn, args in computed:
            row[name] = fn(row, *args)
