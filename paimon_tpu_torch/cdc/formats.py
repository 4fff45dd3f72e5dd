"""CDC event format parsers -> (row dict, RowKind) changes.

reference: paimon-flink-cdc format/ parsers (DebeziumRecordParser,
CanalRecordParser, MaxwellRecordParser). Each parser yields zero or more
(row, kind) pairs per event; updates expand to -U/+U pairs.
Counterpart of paimon_tpu/cdc/formats.py.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from paimon_tpu_torch.types import RowKind

__all__ = ["parse_debezium", "parse_canal", "parse_maxwell",
           "parse_ogg", "parse_dms", "parse_aliyun"]

Change = Tuple[Dict, int]


def parse_debezium(event: dict) -> List[Change]:
    """Debezium envelope: {op: c|r|u|d, before: {...}, after: {...}}
    (payload unwrapping handled)."""
    payload = event.get("payload", event)
    op = payload.get("op")
    before = payload.get("before")
    after = payload.get("after")
    if op in ("c", "r"):
        return [(after, RowKind.INSERT)] if after else []
    if op == "u":
        out: List[Change] = []
        if before:
            out.append((before, RowKind.UPDATE_BEFORE))
        if after:
            out.append((after, RowKind.UPDATE_AFTER))
        return out
    if op == "d":
        return [(before, RowKind.DELETE)] if before else []
    raise ValueError(f"Unknown debezium op {op!r}")


def parse_canal(event: dict) -> List[Change]:
    """Canal JSON: {type: INSERT|UPDATE|DELETE, data: [...], old: [...]}."""
    etype = (event.get("type") or "").upper()
    data = event.get("data") or []
    old = event.get("old") or []
    out: List[Change] = []
    if etype == "INSERT":
        out.extend((row, RowKind.INSERT) for row in data)
    elif etype == "DELETE":
        out.extend((row, RowKind.DELETE) for row in data)
    elif etype == "UPDATE":
        for i, row in enumerate(data):
            if i < len(old) and old[i]:
                merged = dict(row)
                merged.update(old[i])
                out.append((merged, RowKind.UPDATE_BEFORE))
            out.append((row, RowKind.UPDATE_AFTER))
    else:
        raise ValueError(f"Unknown canal type {etype!r}")
    return out


def parse_ogg(event: dict) -> List[Change]:
    """Oracle GoldenGate JSON: {op_type: I|U|D, before: {...},
    after: {...}} (reference ogg/OggRecordParser.java)."""
    op = (event.get("op_type") or "").upper()
    before = event.get("before")
    after = event.get("after")
    if op == "I":
        return [(after, RowKind.INSERT)] if after else []
    if op == "U":
        out: List[Change] = []
        if before:
            out.append((before, RowKind.UPDATE_BEFORE))
        if after:
            out.append((after, RowKind.UPDATE_AFTER))
        return out
    if op == "D":
        return [(before, RowKind.DELETE)] if before else []
    raise ValueError(f"Unknown ogg op_type {op!r}")


def parse_dms(event: dict) -> List[Change]:
    """AWS DMS JSON: {data: {...}, metadata: {record-type: data,
    operation: load|insert|update|delete}}; an update carries the
    pre-image in BI_-prefixed columns of `data`
    (reference dms/DMSRecordParser.java)."""
    meta = event.get("metadata") or {}
    if (meta.get("record-type") or "") not in ("data", ""):
        return []                      # control/ddl records
    op = (meta.get("operation") or "").lower()
    data = event.get("data") or {}
    current = {k: v for k, v in data.items() if not k.startswith("BI_")}
    if op in ("load", "insert"):
        return [(current, RowKind.INSERT)]
    if op == "delete":
        return [(current, RowKind.DELETE)]
    if op == "update":
        before = dict(current)
        before.update({k[3:]: v for k, v in data.items()
                       if k.startswith("BI_")})
        return [(before, RowKind.UPDATE_BEFORE),
                (current, RowKind.UPDATE_AFTER)]
    raise ValueError(f"Unknown dms operation {op!r}")


def parse_aliyun(event: dict) -> List[Change]:
    """Aliyun DTS JSON: {op: INSERT|UPDATE_BEFORE|UPDATE_AFTER|DELETE,
    payload: {before: {dataColumn: {...}}, after: {dataColumn:
    {...}}}} — updates arrive as SEPARATE -U/+U events
    (reference aliyun/AliyunRecordParser.java)."""
    if event.get("ddl"):
        return []
    op = (event.get("op") or "").upper()
    payload = event.get("payload") or {}

    def cols(section: str) -> Dict:
        # dataColumn is REQUIRED — falling back to the raw section
        # would leak envelope metadata into the row and the
        # schema-evolving sink would ADD COLUMN bogus fields
        return (payload.get(section) or {}).get("dataColumn") or {}

    def one(section: str, kind: int) -> List[Change]:
        row = cols(section)
        return [(row, kind)] if row else []

    if op == "INSERT":
        return one("after", RowKind.INSERT)
    if op == "UPDATE_BEFORE":
        return one("before", RowKind.UPDATE_BEFORE)
    if op == "UPDATE_AFTER":
        return one("after", RowKind.UPDATE_AFTER)
    if op == "DELETE":
        return one("before", RowKind.DELETE)
    raise ValueError(f"Unknown aliyun op {op!r}")


def parse_maxwell(event: dict) -> List[Change]:
    """Maxwell JSON: {type: insert|update|delete, data: {...},
    old: {...}}."""
    etype = (event.get("type") or "").lower()
    data = event.get("data") or {}
    old = event.get("old") or {}
    if etype == "insert" or etype == "bootstrap-insert":
        return [(data, RowKind.INSERT)]
    if etype == "delete":
        return [(data, RowKind.DELETE)]
    if etype == "update":
        before = dict(data)
        before.update(old)
        return [(before, RowKind.UPDATE_BEFORE),
                (data, RowKind.UPDATE_AFTER)]
    raise ValueError(f"Unknown maxwell type {etype!r}")
