"""Versioned table schema persisted as ``schema/schema-N`` JSON.

Wire format per reference docs/docs/concepts/spec/schema.md and
paimon-core/.../schema/TableSchema.java. Current version 3.
"""

from __future__ import annotations

import json
import time as _time
from typing import Any, Dict, List, Optional

from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.types import (
    DataField, RowType, SpecialFields, row_type_to_arrow_schema,
)

__all__ = ["TableSchema"]

CURRENT_VERSION = 3


class TableSchema:
    def __init__(self, id: int, fields: List[DataField],
                 highest_field_id: int, partition_keys: List[str],
                 primary_keys: List[str], options: Dict[str, str],
                 comment: str = "", time_millis: Optional[int] = None,
                 version: int = CURRENT_VERSION):
        self.version = version
        self.id = id
        self.fields = list(fields)
        self.highest_field_id = highest_field_id
        self.partition_keys = list(partition_keys)
        self.primary_keys = list(primary_keys)
        self.options = dict(options)
        self.comment = comment
        self.time_millis = (int(_time.time() * 1000)
                            if time_millis is None else time_millis)

    # -- derived -------------------------------------------------------------

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def logical_row_type(self) -> RowType:
        return RowType(self.fields, nullable=False)

    def logical_partition_type(self) -> RowType:
        rt = self.logical_row_type()
        return rt.project(self.partition_keys)

    def logical_primary_keys_type(self) -> RowType:
        rt = self.logical_row_type()
        return rt.project(self.primary_keys)

    def trimmed_primary_keys(self) -> List[str]:
        """Primary keys minus partition keys — the key columns actually
        stored in data files (reference TableSchema.trimmedPrimaryKeys)."""
        if len(self.primary_keys) > len(self.partition_keys):
            trimmed = [k for k in self.primary_keys
                       if k not in self.partition_keys]
            if trimmed:
                return trimmed
        return list(self.primary_keys)

    def logical_trimmed_primary_keys_type(self) -> RowType:
        return self.logical_row_type().project(self.trimmed_primary_keys())

    def bucket_keys(self) -> List[str]:
        """Effective bucket key: `bucket-key` option, else trimmed pks,
        else empty (reference TableSchema.bucketKeys)."""
        opt = self.options.get("bucket-key")
        if opt:
            return [s.strip() for s in opt.split(",")]
        return self.trimmed_primary_keys()

    def cross_partition_update(self) -> bool:
        """PKs not containing all partition keys => cross-partition upsert
        (reference TableSchema.crossPartitionUpdate)."""
        if not self.primary_keys or not self.partition_keys:
            return False
        return any(p not in self.primary_keys for p in self.partition_keys)

    def to_arrow_schema(self):
        return row_type_to_arrow_schema(self.logical_row_type())

    def key_value_arrow_schema(self):
        """Arrow schema of KV data files: _KEY_* | _SEQUENCE_NUMBER |
        _VALUE_KIND | value fields (reference io/KeyValueDataFileWriter)."""
        kv = self.key_value_row_type()
        return row_type_to_arrow_schema(kv)

    def key_value_row_type(self) -> RowType:
        rt = self.logical_row_type()
        key_fields = [SpecialFields.key_field(rt.get_field(n))
                      for n in self.trimmed_primary_keys()]
        fields = (key_fields
                  + [SpecialFields.SEQUENCE_NUMBER, SpecialFields.VALUE_KIND]
                  + self.fields)
        return RowType(fields, nullable=False)

    # -- serde ---------------------------------------------------------------

    def to_json(self) -> str:
        d: Dict[str, Any] = {
            "version": self.version,
            "id": self.id,
            "fields": [f.to_json() for f in self.fields],
            "highestFieldId": self.highest_field_id,
            "partitionKeys": self.partition_keys,
            "primaryKeys": self.primary_keys,
            "options": self.options,
            "comment": self.comment,
            "timeMillis": self.time_millis,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "TableSchema":
        d = json.loads(s)
        version = d.get("version", 1)
        options = dict(d.get("options", {}))
        # version compat per spec/schema.md
        if version <= 1 and "bucket" not in options:
            options["bucket"] = "1"
        if version <= 2 and "file.format" not in options:
            options["file.format"] = "orc"
        return TableSchema(
            id=d["id"],
            fields=[DataField.from_json(f) for f in d["fields"]],
            highest_field_id=d["highestFieldId"],
            partition_keys=d.get("partitionKeys", []),
            primary_keys=d.get("primaryKeys", []),
            options=options,
            comment=d.get("comment") or "",
            time_millis=d.get("timeMillis"),
            version=version,
        )

    @staticmethod
    def from_schema(schema_id: int, schema: Schema) -> "TableSchema":
        highest = max((f.id for f in schema.fields), default=-1)
        return TableSchema(schema_id, schema.fields, highest,
                           schema.partition_keys, schema.primary_keys,
                           schema.options, schema.comment)

    def copy(self, options: Optional[Dict[str, str]] = None) -> "TableSchema":
        return TableSchema(self.id, self.fields, self.highest_field_id,
                           self.partition_keys, self.primary_keys,
                           options if options is not None else self.options,
                           self.comment, self.time_millis, self.version)

    def __eq__(self, other):
        return (isinstance(other, TableSchema) and self.id == other.id
                and self.fields == other.fields
                and self.partition_keys == other.partition_keys
                and self.primary_keys == other.primary_keys
                and self.options == other.options)

    def __repr__(self):
        return (f"TableSchema(id={self.id}, fields={self.field_names}, "
                f"pk={self.primary_keys}, partition={self.partition_keys})")
