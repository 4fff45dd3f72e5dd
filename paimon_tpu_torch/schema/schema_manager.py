"""SchemaManager: versioned schema files with optimistic-lock commit.

Counterpart of paimon_tpu/schema/schema_manager.py, whole: option
changes and column DDL (add, drop, rename, type, nullability, comment),
validated as the reference validates them.

reference: paimon-core/.../schema/SchemaManager.java (1517 lines) --
schemas live at ``<table>/schema/schema-<N>``; DDL writes schema-(N+1) via
atomic CAS; alters validate compatibility (SchemaChange ops).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.types import DataField, DataType

__all__ = ["SchemaManager", "SchemaChange"]

SCHEMA_PREFIX = "schema-"


class SchemaChange:
    """DDL change ops (reference schema/SchemaChange.java)."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.kw = kw

    @staticmethod
    def set_option(key: str, value: str) -> "SchemaChange":
        return SchemaChange("set-option", key=key, value=str(value))

    @staticmethod
    def remove_option(key: str) -> "SchemaChange":
        return SchemaChange("remove-option", key=key)

    @staticmethod
    def add_column(name: str, typ: DataType,
                   description: Optional[str] = None) -> "SchemaChange":
        return SchemaChange("add-column", name=name, type=typ,
                            description=description)

    @staticmethod
    def drop_column(name: str) -> "SchemaChange":
        return SchemaChange("drop-column", name=name)

    @staticmethod
    def rename_column(name: str, new_name: str) -> "SchemaChange":
        return SchemaChange("rename-column", name=name, new_name=new_name)

    @staticmethod
    def update_column_type(name: str, typ: DataType) -> "SchemaChange":
        return SchemaChange("update-column-type", name=name, type=typ)

    @staticmethod
    def update_column_nullability(name: str, nullable: bool) -> "SchemaChange":
        return SchemaChange("update-column-nullability", name=name,
                            nullable=nullable)

    @staticmethod
    def update_comment(comment: str) -> "SchemaChange":
        return SchemaChange("update-comment", comment=comment)


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

    def list_all(self) -> List[TableSchema]:
        return [self.schema(i) for i in self.list_all_ids()]

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
        """Apply DDL with optimistic retry (reference
        SchemaManager.commitChanges).  Accepts either varargs of
        SchemaChange or a single list/tuple of them."""
        if len(changes) == 1 and isinstance(changes[0], (list, tuple)):
            changes = tuple(changes[0])
        while True:
            latest = self.latest()
            if latest is None:
                raise RuntimeError(f"Table not found: {self.table_path}")
            new_schema = self._apply(latest, list(changes))
            if self._commit(new_schema):
                return new_schema
            # CAS lost: retry against newer schema

    def _commit(self, ts: TableSchema) -> bool:
        return self.file_io.try_to_write_atomic(
            self.schema_path(ts.id), ts.to_json().encode("utf-8"))

    # -- change application --------------------------------------------------

    def _apply(self, base: TableSchema,
               changes: List[SchemaChange]) -> TableSchema:
        fields = list(base.fields)
        options = dict(base.options)
        comment = base.comment
        highest = base.highest_field_id

        def idx_of(name: str) -> int:
            for i, f in enumerate(fields):
                if f.name == name:
                    return i
            raise ValueError(f"Column {name!r} not found")

        for ch in changes:
            k = ch.kw
            if ch.kind == "set-option":
                _validate_option_change(k["key"])
                options[k["key"]] = k["value"]
            elif ch.kind == "remove-option":
                options.pop(k["key"], None)
            elif ch.kind == "add-column":
                if any(f.name == k["name"] for f in fields):
                    raise ValueError(f"Column {k['name']!r} already exists")
                if not k["type"].nullable:
                    raise ValueError(
                        "Cannot add NOT NULL column to existing table")
                highest += 1
                new_field = DataField(highest, k["name"], k["type"],
                                      k.get("description"))
                if _opt(options, CoreOptions.ADD_COLUMN_BEFORE_PARTITION) \
                        and base.partition_keys:
                    pos = min(i for i, f in enumerate(fields)
                              if f.name in base.partition_keys)
                    fields.insert(pos, new_field)
                else:
                    fields.append(new_field)
            elif ch.kind == "drop-column":
                if k["name"] in base.primary_keys:
                    raise ValueError("Cannot drop primary-key column")
                if k["name"] in base.partition_keys:
                    raise ValueError("Cannot drop partition column")
                fields.pop(idx_of(k["name"]))
                if not fields:
                    raise ValueError("Cannot drop all columns")
            elif ch.kind == "rename-column":
                i = idx_of(k["name"])
                if any(f.name == k["new_name"] for f in fields):
                    raise ValueError(
                        f"Column {k['new_name']!r} already exists")
                if k["name"] in base.primary_keys or \
                        k["name"] in base.partition_keys:
                    raise ValueError("Cannot rename key/partition column")
                f = fields[i]
                fields[i] = DataField(f.id, k["new_name"], f.type,
                                      f.description, f.default_value)
            elif ch.kind == "update-column-type":
                i = idx_of(k["name"])
                f = fields[i]
                _check_type_evolution(
                    f.type, k["type"],
                    allow_explicit=not _opt(
                        options, CoreOptions.DISABLE_EXPLICIT_TYPE_CASTING))
                fields[i] = DataField(f.id, f.name, k["type"], f.description,
                                      f.default_value)
            elif ch.kind == "update-column-nullability":
                i = idx_of(k["name"])
                f = fields[i]
                if k["nullable"] and f.name in base.primary_keys:
                    raise ValueError("Primary-key column must be NOT NULL")
                if not k["nullable"] and f.type.nullable and _opt(
                        options, CoreOptions.ALTER_NULL_TO_NOT_NULL_DISABLED):
                    # existing nulls would break readers (reference
                    # alter-column-null-to-not-null.disabled, default on)
                    raise ValueError(
                        "Tightening a nullable column to NOT NULL is "
                        "disabled (alter-column-null-to-not-null."
                        "disabled)")
                fields[i] = DataField(f.id, f.name,
                                      f.type.copy(k["nullable"]),
                                      f.description, f.default_value)
            elif ch.kind == "update-comment":
                comment = k["comment"]
            else:
                raise ValueError(f"Unknown schema change {ch.kind}")

        return TableSchema(base.id + 1, fields, highest, base.partition_keys,
                           base.primary_keys, options, comment)


def _opt(options: dict, option) -> bool:
    """Typed read of a table option from a raw options dict."""
    return option.parse(options.get(option.key))


_IMMUTABLE_OPTIONS = {"bucket-key", "merge-engine", "sequence.field",
                      "primary-key", "partition"}


def _validate_option_change(key: str):
    if key in _IMMUTABLE_OPTIONS:
        raise ValueError(f"Option {key!r} cannot be changed after creation")


# Allowed implicit casts for type evolution
# (reference schema/SchemaEvolutionUtil + casting/CastExecutors).
_NUMERIC_WIDENING = ["TINYINT", "SMALLINT", "INT", "BIGINT", "FLOAT",
                     "DOUBLE"]


def _check_type_evolution(old: DataType, new: DataType,
                          allow_explicit: bool = True):
    if old == new:
        return
    o, n = old.root, new.root
    if o in _NUMERIC_WIDENING and n in _NUMERIC_WIDENING:
        if _NUMERIC_WIDENING.index(n) >= _NUMERIC_WIDENING.index(o):
            return
    if o in ("CHAR", "VARCHAR") and n == "VARCHAR":
        return
    if o in ("BINARY", "VARBINARY") and n == "VARBINARY":
        return
    if o == "DECIMAL" and n == "DECIMAL":
        if new.precision >= old.precision and new.scale == old.scale:
            return
    if o == "TIMESTAMP" and n == "TIMESTAMP":
        return
    # beyond implicit widening: the reference permits any update whose
    # explicit cast rule resolves (SchemaManager.java:525
    # DataTypeCasts.supportsCast(..., allowExplicit) +
    # CastExecutors.resolve != null); our rule matrix is that resolver.
    # disable-explicit-type-casting restricts evolution to the implicit
    # widenings above.
    if allow_explicit:
        from paimon_tpu_torch.data.casting import can_cast
        if can_cast(old, new):
            return
    raise ValueError(f"Unsupported type evolution {old} -> {new}")
