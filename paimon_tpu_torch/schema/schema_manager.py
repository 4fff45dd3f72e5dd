"""SchemaManager: versioned schema files with optimistic-lock commit.

Counterpart of paimon_tpu/schema/schema_manager.py without DDL (ALTER
and schema evolution are not ported yet): schemas live at
``<table>/schema/schema-<N>``, and table creation writes schema-0 via
an atomic CAS.  reference: paimon-core/.../schema/SchemaManager.java.
"""

from __future__ import annotations

from typing import List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.schema.table_schema import TableSchema

__all__ = ["SchemaManager"]

SCHEMA_PREFIX = "schema-"


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

    def _commit(self, ts: TableSchema) -> bool:
        return self.file_io.try_to_write_atomic(
            self.schema_path(ts.id), ts.to_json().encode("utf-8"))
