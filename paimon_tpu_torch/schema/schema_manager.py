"""SchemaManager: versioned schema files with optimistic-lock commit.

Counterpart of paimon_tpu/schema/schema_manager.py with option changes
only (column DDL and schema evolution are not ported yet, ROADMAP.md
A.8.1): schemas live at ``<table>/schema/schema-<N>``, table creation
writes schema-0 and `commit_changes` schema-(N+1), each via an atomic
CAS.  reference: paimon-core/.../schema/SchemaManager.java.
"""

from __future__ import annotations

from typing import List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.schema.table_schema import TableSchema

__all__ = ["SchemaManager", "SchemaChange"]

SCHEMA_PREFIX = "schema-"

# options fixed at creation (reference SchemaManager's immutable set)
_IMMUTABLE_OPTIONS = {"bucket-key", "merge-engine", "sequence.field",
                      "primary-key", "partition"}


class SchemaChange:
    """An option change (reference schema/SchemaChange.java); the
    column changes are not ported yet."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.kw = kw

    @staticmethod
    def set_option(key: str, value: str) -> "SchemaChange":
        return SchemaChange("set-option", key=key, value=str(value))

    @staticmethod
    def remove_option(key: str) -> "SchemaChange":
        return SchemaChange("remove-option", key=key)


class SchemaManager:
    def __init__(self, file_io: FileIO, table_path: str, branch: str = "main"):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")
        self.branch = branch

    def _schema_dir(self) -> str:
        if self.branch and self.branch != "main":
            return f"{self.table_path}/branch/branch-{self.branch}/schema"
        return f"{self.table_path}/schema"

    def schema_path(self, schema_id: int) -> str:
        return f"{self._schema_dir()}/{SCHEMA_PREFIX}{schema_id}"

    # -- reads ---------------------------------------------------------------

    def schema(self, schema_id: int) -> TableSchema:
        return TableSchema.from_json(
            self.file_io.read_utf8(self.schema_path(schema_id)))

    def list_all_ids(self) -> List[int]:
        out = []
        for st in self.file_io.list_status(self._schema_dir()):
            name = st.path.rstrip("/").split("/")[-1]
            if name.startswith(SCHEMA_PREFIX):
                try:
                    out.append(int(name[len(SCHEMA_PREFIX):]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[TableSchema]:
        ids = self.list_all_ids()
        return self.schema(ids[-1]) if ids else None

    def exists(self) -> bool:
        return bool(self.list_all_ids())

    # -- writes --------------------------------------------------------------

    def create_table(self, schema: Schema,
                     ignore_if_exists: bool = False) -> TableSchema:
        latest = self.latest()
        if latest is not None:
            if ignore_if_exists:
                return latest
            raise RuntimeError(f"Table already exists at {self.table_path}")
        ts = TableSchema.from_schema(0, schema)
        if not self._commit(ts):
            raise RuntimeError("Concurrent table creation detected")
        return ts

    def commit_changes(self, *changes) -> TableSchema:
        """Apply option changes with optimistic retry (reference
        SchemaManager.commitChanges): varargs of SchemaChange or one
        list of them."""
        if len(changes) == 1 and isinstance(changes[0], (list, tuple)):
            changes = tuple(changes[0])
        while True:
            latest = self.latest()
            if latest is None:
                raise RuntimeError(f"Table not found: {self.table_path}")
            new_schema = _apply(latest, changes)
            if self._commit(new_schema):
                return new_schema
            # CAS lost: retry against the newer schema

    def _commit(self, ts: TableSchema) -> bool:
        return self.file_io.try_to_write_atomic(
            self.schema_path(ts.id), ts.to_json().encode("utf-8"))


def _apply(base: TableSchema, changes) -> TableSchema:
    options = dict(base.options)
    for ch in changes:
        key = ch.kw["key"]
        if ch.kind == "set-option":
            if key in _IMMUTABLE_OPTIONS:
                raise ValueError(
                    f"Option {key!r} cannot be changed after creation")
            options[key] = ch.kw["value"]
        elif ch.kind == "remove-option":
            options.pop(key, None)
        else:
            raise ValueError(f"Unknown schema change {ch.kind}")
    return TableSchema(base.id + 1, base.fields, base.highest_field_id,
                       base.partition_keys, base.primary_keys, options,
                       base.comment)
