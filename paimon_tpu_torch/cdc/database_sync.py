"""Whole-database CDC synchronization.

reference: paimon-flink-cdc action/cdc/SyncDatabaseActionBase (+
CdcDynamicTableParsingProcessFunction): one stream of CDC events for
MANY source tables routes to per-table schema-evolving sinks; unseen
tables are auto-created with schema inferred from their first events,
with regex including/excluding filters and shared table options.

Event -> table routing uses the envelopes' own metadata: debezium
`payload.source.{db,table}`, canal/maxwell top-level
`database`/`table`.

Counterpart of paimon_tpu/cdc/database_sync.py: the catalog's tables
(and so every sink) run on the catalog's device.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.cdc.sink import CdcSinkWriter, _infer_type
from paimon_tpu_torch.schema import Schema

__all__ = ["CdcDatabaseSync"]


def _event_table_id(event: dict, fmt: str) -> Tuple[str, str]:
    if fmt == "debezium":
        src = event.get("payload", event).get("source", {}) or {}
        return (src.get("db") or src.get("database") or "default",
                src.get("table") or "unknown")
    return (event.get("database") or "default",
            event.get("table") or "unknown")


def _event_primary_keys(event: dict, fmt: str) -> List[str]:
    if fmt == "maxwell":
        return list(event.get("primary_key_columns") or [])
    if fmt == "canal":
        return list(event.get("pkNames") or [])
    # debezium: key schema is usually separate; callers pass
    # primary_keys explicitly when the envelope lacks it
    return []


class CdcDatabaseSync:
    """Route a mixed CDC stream into a catalog database, creating and
    evolving tables as events arrive."""

    def __init__(self, catalog, database: str, format: str = "debezium",
                 source_database: Optional[str] = None,
                 including_tables: Optional[str] = None,
                 excluding_tables: Optional[str] = None,
                 primary_keys: Optional[Dict[str, List[str]]] = None,
                 table_options: Optional[Dict[str, str]] = None,
                 computed_columns: Optional[Dict[str, List[str]]] = None,
                 commit_user: str = "cdc-db-sync"):
        self.catalog = catalog
        self.database = database
        # events from OTHER source databases never merge in (reference
        # SyncDatabaseAction syncs exactly one source database)
        self.source_database = source_database or database
        self.format = format
        self.including = re.compile(including_tables) \
            if including_tables else None
        self.excluding = re.compile(excluding_tables) \
            if excluding_tables else None
        self.primary_keys = primary_keys or {}
        self.table_options = {"bucket": "1", "write-only": "true",
                              **(table_options or {})}
        self.computed_columns = computed_columns or {}
        self.commit_user = commit_user
        self._writers: Dict[str, CdcSinkWriter] = {}
        catalog.create_database(database, ignore_if_exists=True)

    def _accepts(self, name: str) -> bool:
        if self.including is not None and \
                not self.including.fullmatch(name):
            return False
        if self.excluding is not None and \
                self.excluding.fullmatch(name):
            return False
        return True

    def _writer_for(self, name: str,
                    first_events: List[dict]) -> CdcSinkWriter:
        w = self._writers.get(name)
        if w is not None:
            return w
        ident = f"{self.database}.{name}"
        if not self.catalog.table_exists(ident):
            self.catalog.create_table(
                ident, self._infer_schema(name, first_events),
                ignore_if_exists=True)
        table = self.catalog.get_table(ident)
        w = CdcSinkWriter(
            table, format=self.format, commit_user=self.commit_user,
            computed_columns=self.computed_columns.get(name))
        self._writers[name] = w
        return w

    def _infer_schema(self, name: str, events: List[dict]) -> Schema:
        from paimon_tpu_torch.cdc.sink import _PARSERS
        parse = _PARSERS[self.format]
        cols: Dict[str, List] = {}
        pks = list(self.primary_keys.get(name) or [])
        for event in events:
            if not pks:
                pks = _event_primary_keys(event, self.format)
            for row, _kind in parse(event):
                for k, v in row.items():
                    cols.setdefault(k, []).append(v)
        if not pks:
            raise ValueError(
                f"cannot infer primary keys for table {name!r}: pass "
                f"primary_keys={{'{name}': [...]}} (reference "
                f"SyncDatabaseAction --primary-keys)")
        b = Schema.builder()
        for col, vals in cols.items():
            t = _infer_type(vals)
            if col in pks:
                t = t.copy(False)
            b = b.column(col, t)
        return b.primary_key(*pks).options(self.table_options).build()

    def write_events(self, events: List[dict]):
        by_table: Dict[str, List[dict]] = {}
        for event in events:
            db, name = _event_table_id(event, self.format)
            if db != self.source_database:
                continue
            if self._accepts(name):
                by_table.setdefault(name, []).append(event)
        for name, evs in by_table.items():
            self._writer_for(name, evs).write_events(evs)

    def commit(self, commit_identifier: int,
               properties: Optional[Dict[str, str]] = None
               ) -> Dict[str, Optional[int]]:
        return {name: w.commit(commit_identifier, properties=properties)
                for name, w in self._writers.items()}

    def tables(self) -> List[str]:
        return sorted(self._writers)

    def close(self):
        for w in self._writers.values():
            w.close()
        self._writers.clear()
