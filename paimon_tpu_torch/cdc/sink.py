"""Schema-evolving CDC sink.

reference: paimon-flink-cdc sink/cdc/CdcRecordStoreMultiWriteOperator +
UpdatedDataFieldsProcessFunction: unseen columns trigger ADD COLUMN
through the SchemaManager (optimistic-lock DDL), then the writer reloads
the evolved schema and writes the batch with proper row kinds.

Counterpart of paimon_tpu/cdc/sink.py.  The writer is the table's
stream write, merging on the table's device; a schema change reloads the
table on that device.
"""

from __future__ import annotations

import datetime
import decimal
from itertools import chain
from typing import Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.cdc.formats import (
    parse_aliyun, parse_canal, parse_debezium, parse_dms, parse_maxwell,
    parse_ogg,
)
from paimon_tpu_torch.schema.schema_manager import SchemaChange
from paimon_tpu_torch.table.table import FileStoreTable
from paimon_tpu_torch.types import (
    BigIntType, BooleanType, DataType, DoubleType, TimestampType,
    VarCharType,
)

__all__ = ["CdcSinkWriter"]

_PARSERS: Dict[str, Callable] = {
    "debezium": parse_debezium,
    "canal": parse_canal,
    "maxwell": parse_maxwell,
    "ogg": parse_ogg,
    "dms": parse_dms,
    "aliyun": parse_aliyun,
}


def _infer_type(values: List) -> DataType:
    """Conservative type inference for a new CDC column (reference
    TypeMapping: unknown -> STRING)."""
    return _infer_type_of(_value_types(values))


_WIDEN_RANK = {"BOOLEAN": 0, "TINYINT": 1, "SMALLINT": 2, "INT": 3,
               "BIGINT": 4, "FLOAT": 5, "DOUBLE": 6, "DECIMAL": 6,
               "TIMESTAMP": 8, "TIMESTAMP_WITH_LOCAL_TIME_ZONE": 8,
               "CHAR": 9, "VARCHAR": 9}
_NUMERIC_RANKS = {0, 1, 2, 3, 4, 5, 6}


def _widen(cur: DataType, want: DataType) -> Optional[DataType]:
    """The type `cur` must become to also hold `want`-shaped values, or
    None when it already can (reference UpdatedDataFieldsProcessFunction
    .canConvert widening lattice).  Numeric widths widen within the
    lattice (INT -> BIGINT -> DOUBLE); any cross-family conflict —
    e.g. numeric meeting TIMESTAMP, whose cast old files cannot
    satisfy — falls back to STRING."""
    a = _WIDEN_RANK.get(cur.root, 9)
    b = _WIDEN_RANK.get(want.root, 9)
    if b <= a:
        return None
    if b == 9:
        return VarCharType()
    if a in _NUMERIC_RANKS and b in _NUMERIC_RANKS:
        return DoubleType() if b >= 5 else want
    # cross-family (numeric vs temporal): only STRING holds both
    return VarCharType()


def _value_types(values: List) -> set:
    """The types of the non-null values."""
    types = set(map(type, values))
    types.discard(type(None))
    return types


def _infer_type_of(types: set) -> DataType:
    """The type of values whose non-null types are `types`: BOOLEAN,
    BIGINT, DOUBLE (numbers of several kinds) or TIMESTAMP where all of
    them are that, else STRING."""
    if not types:
        return VarCharType()
    if all(issubclass(t, bool) for t in types):
        return BooleanType()
    if all(issubclass(t, int) and not issubclass(t, bool) for t in types):
        return BigIntType()
    if all(issubclass(t, (int, float, decimal.Decimal))
           and not issubclass(t, bool) for t in types):
        return DoubleType()
    if all(issubclass(t, datetime.datetime) for t in types):
        return TimestampType()
    return VarCharType()


def _render(v):
    """A value of a column widened to STRING, as the column keeps
    ingesting the source's native values (datetime -> ISO)."""
    if v is None or isinstance(v, str):
        return v
    return v.isoformat(sep=" ") if hasattr(v, "isoformat") else str(v)


class CdcSinkWriter:
    """Parses CDC events, evolves the schema for unseen columns and
    writes through the normal table write path."""

    def __init__(self, table: FileStoreTable, format: str = "debezium",
                 commit_user: Optional[str] = None,
                 computed_columns: Optional[List[str]] = None):
        if format not in _PARSERS:
            raise ValueError(f"Unknown CDC format {format!r}; "
                             f"available: {sorted(_PARSERS)}")
        self._parse = _PARSERS[format]
        self.table = table
        self.commit_user = commit_user or "cdc"
        self._writer = None
        self._pending_msgs = []
        # which commit identifier the staged messages were last
        # ATTEMPTED under (None = not yet attempted; they ride the next
        # commit).  Lets a retried/replayed checkpoint detect that the
        # previous attempt actually landed (crash between the snapshot
        # CAS and the ack) and drop the staged messages instead of
        # re-delivering committed rows under a new identifier.
        self._pending_ckpt: Optional[int] = None
        # optional () -> {str: str} forwarded to
        # FileStoreCommit.properties_provider on every commit this
        # sink issues: re-evaluated per CAS attempt, so stamps stay
        # fresh across commit retries (explicit properties win)
        self.properties_provider = None
        self._computed = None
        if computed_columns:
            from paimon_tpu_torch.cdc.computed import parse_computed_columns
            self._computed = parse_computed_columns(computed_columns)

    def _ensure_schema(self, columns: Dict[str, List]):
        """ADD COLUMN for unseen keys; widen existing columns whose
        incoming values no longer fit (reference
        UpdatedDataFieldsProcessFunction type merging).  Columns seen
        only as null are DEFERRED — creating them as STRING on a
        null-only first batch would lock in the wrong type.  `columns`
        holds each key's values in row order, keys in the order they
        first appear (the order new columns are added in)."""
        by_name = {f.name: f for f in self.table.schema.fields}
        changes = []
        widen = []
        for name, vals in columns.items():
            types = _value_types(vals)
            if not types:
                continue                  # null-only: deferred
            if name not in by_name:
                changes.append(SchemaChange.add_column(
                    name, _infer_type_of(types)))
                continue
            widened = _widen(by_name[name].type, _infer_type_of(types))
            if widened is not None:
                widen.append(SchemaChange.update_column_type(name, widened))
        changes.extend(widen)
        if not changes:
            return
        if self._writer is not None:
            # the old writer may hold buffered, uncommitted rows: turn
            # them into pending commit messages before discarding it
            self._pending_msgs.extend(self._writer.prepare_commit())
            self._writer.close()
            self._writer = None
        self.table.schema_manager.commit_changes(*changes)
        dynamic = dict(self.table.schema.options)
        if self.table.branch != "main":
            dynamic["branch"] = self.table.branch
        self.table = FileStoreTable.load(
            self.table.path, file_io=self.table.file_io,
            dynamic_options=dynamic, device=self.table.device)

    def write_events(self, events: List[dict]):
        """Parse `events`, evolve the schema for what they carry and
        hand their rows, with their row kinds, to the table's writer.
        The rows are built column by column (each key's values in row
        order), the arrays the reference's `from_pylist` builds."""
        changes = []
        parse = self._parse
        for event in events:
            changes.extend(parse(event))
        if not changes:
            return
        kinds = np.fromiter((c[1] for c in changes), dtype=np.int8,
                            count=len(changes))
        if self._computed:
            from paimon_tpu_torch.cdc.computed import apply_computed_columns
            rows = [dict(c[0]) for c in changes]
            apply_computed_columns(rows, self._computed)
        else:
            rows = [c[0] for c in changes]          # read, never written
        columns = {k: [r.get(k) for r in rows]
                   for k in dict.fromkeys(chain.from_iterable(rows))}
        self._ensure_schema(columns)
        if self._writer is None:
            wb = self.table.new_stream_write_builder() \
                .with_commit_user(self.commit_user)
            self._wb = wb
            self._writer = wb.new_write()
        schema = self.table.arrow_schema()
        arrays = []
        for f in schema:
            vals = columns.get(f.name)
            if vals is None:
                vals = [None] * len(rows)
            elif (pa.types.is_string(f.type)
                  or pa.types.is_large_string(f.type)) and \
                    not _value_types(vals) <= {str}:
                vals = [_render(v) for v in vals]
            arrays.append(pa.array(vals, type=f.type))
        batch = pa.Table.from_arrays(arrays, schema=schema)
        self._writer.write_arrow(batch, kinds)

    def commit(self, commit_identifier: int,
               properties: Optional[Dict[str, str]] = None,
               force_create: bool = False) -> Optional[int]:
        """Commit everything staged + buffered under
        `commit_identifier`; `properties` land in the snapshot (the
        stream daemon commits its source offset here, atomically with
        the data).  `force_create` publishes a snapshot even with
        nothing buffered — distributed daemons advance their offset
        (and renew their lease) through checkpoints whose owned share
        of the window was empty.  Exactly-once on every failure shape:

        - replayed identifier (already committed by this user): commit
          nothing, return None;
        - prepare fails: staged messages restored, writer reset —
          retry the SAME identifier;
        - commit raises (which includes "the CAS actually landed but
          the process died before the ack"): messages restored keyed
          by the attempted identifier, so a later commit drops them if
          that identifier turns out to be durable instead of
          re-delivering the rows under a fresh identifier.
        """
        if self._writer is None and not self._pending_msgs and \
                not force_create:
            return None
        if self._writer is None:
            wb = self.table.new_stream_write_builder() \
                .with_commit_user(self.commit_user)
            self._wb = wb
        commit = self._wb.new_commit()
        if self.properties_provider is not None:
            commit._commit.properties_provider = \
                self.properties_provider
        if self._pending_msgs and self._pending_ckpt is not None and \
                self._pending_ckpt != commit_identifier:
            # the staged messages already rode a commit attempt under an
            # OLDER identifier; if that attempt actually landed (crash
            # between CAS and ack), committing them again here would
            # re-deliver rows the table already holds
            if not commit.filter_committed([self._pending_ckpt]):
                self._pending_msgs = []
            self._pending_ckpt = None
        msgs = list(self._pending_msgs)
        self._pending_msgs = []
        self._pending_ckpt = None
        if self._writer is not None:
            try:
                msgs.extend(self._writer.prepare_commit())
            except Exception:
                # the pipelined flush pool latched a worker error: shut
                # the writer down (joining its pool) before re-raising
                # so a retried checkpoint starts from a clean writer —
                # and RESTORE the staged pre-evolution messages, whose
                # files are already uploaded and must not be lost when
                # the retried checkpoint commits
                self._pending_msgs = msgs
                self._writer.close()
                self._writer = None
                raise
        if not commit.filter_committed([commit_identifier]):
            return None          # replayed checkpoint: exactly-once
        try:
            # (TableCommit force-creates empty snapshots for any
            # non-batch identifier, so bypassing the early return
            # above is all `force_create` needs to do here)
            return commit.commit(msgs,
                                 commit_identifier=commit_identifier,
                                 properties=properties)
        except Exception:
            # the snapshot CAS may or may not have landed (e.g. the
            # process is dying mid-checkpoint): keep the messages,
            # KEYED by this identifier, so the retried/replayed
            # checkpoint can resolve which happened via
            # filter_committed instead of guessing
            self._pending_msgs = msgs
            self._pending_ckpt = commit_identifier
            raise

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
