"""User-facing table schema definition (reference paimon-api/.../schema/Schema.java)."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import pyarrow as pa

from paimon_tpu_torch.types import (
    DataField, DataType, RowType, arrow_schema_to_row_type,
)

__all__ = ["Schema"]


class Schema:
    """What a user supplies to create a table: fields + partition keys +
    primary keys + options + comment."""

    def __init__(self, fields: Union[RowType, List[DataField], pa.Schema],
                 partition_keys: Optional[List[str]] = None,
                 primary_keys: Optional[List[str]] = None,
                 options: Optional[Dict[str, str]] = None,
                 comment: str = ""):
        if isinstance(fields, pa.Schema):
            fields = arrow_schema_to_row_type(fields).fields
        elif isinstance(fields, RowType):
            fields = fields.fields
        self.fields: List[DataField] = list(fields)
        self.partition_keys = list(partition_keys or [])
        self.primary_keys = list(primary_keys or [])
        self.options = {k: str(v) for k, v in (options or {}).items()}
        self.comment = comment
        self._validate()

    def _validate(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate field names: {names}")
        for k in self.partition_keys:
            if k not in names:
                raise ValueError(f"Partition key {k!r} not in fields {names}")
        for k in self.primary_keys:
            if k not in names:
                raise ValueError(f"Primary key {k!r} not in fields {names}")
        # Primary keys must contain all partition keys UNLESS the table
        # runs in cross-partition upsert mode (dynamic bucket, bucket=-1:
        # reference schema/SchemaValidation.java + BucketMode.KEY_DYNAMIC)
        if self.primary_keys:
            missing = [p for p in self.partition_keys
                       if p not in self.primary_keys]
            dynamic_bucket = int(self.options.get("bucket", "-1")) == -1
            if missing and not dynamic_bucket:
                raise ValueError(
                    f"Primary key must include all partition fields, "
                    f"missing {missing} (or use dynamic bucket=-1 for "
                    f"cross-partition upsert)")

    def row_type(self) -> RowType:
        return RowType(self.fields, nullable=False)

    @staticmethod
    def builder() -> "SchemaBuilder":
        return SchemaBuilder()


class SchemaBuilder:
    def __init__(self):
        self._fields: List[DataField] = []
        self._partition_keys: List[str] = []
        self._primary_keys: List[str] = []
        self._options: Dict[str, str] = {}
        self._comment = ""
        self._next_id = 0

    def column(self, name: str, typ: DataType,
               description: Optional[str] = None) -> "SchemaBuilder":
        self._fields.append(DataField(self._next_id, name, typ, description))
        self._next_id += 1
        return self

    def partition_keys(self, *keys: str) -> "SchemaBuilder":
        self._partition_keys = list(keys)
        return self

    def primary_key(self, *keys: str) -> "SchemaBuilder":
        self._primary_keys = list(keys)
        return self

    def option(self, key: str, value: str) -> "SchemaBuilder":
        self._options[key] = str(value)
        return self

    def options(self, opts: Dict[str, str]) -> "SchemaBuilder":
        self._options.update({k: str(v) for k, v in opts.items()})
        return self

    def comment(self, c: str) -> "SchemaBuilder":
        self._comment = c
        return self

    def build(self) -> Schema:
        return Schema(self._fields, self._partition_keys, self._primary_keys,
                      self._options, self._comment)
