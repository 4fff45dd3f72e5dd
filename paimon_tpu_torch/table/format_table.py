"""FormatTable: a plain directory of csv/json/parquet/orc files read as
a table.

Counterpart of paimon_tpu/table/format_table.py.

reference: table/FormatTable.java (no snapshots/manifests — the listing
IS the metadata; append = drop a new file in the directory; optionally
hive-style `k=v` partition subdirectories).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import pyarrow as pa

from paimon_tpu_torch.format import get_format
from paimon_tpu_torch.fs import FileIO, get_file_io

__all__ = ["FormatTable"]


class FormatTable:
    def __init__(self, path: str, file_format: str,
                 file_io: Optional[FileIO] = None):
        self.path = path.rstrip("/")
        self.format = get_format(file_format)
        self.file_io = file_io or get_file_io(path)
        self.file_io.mkdirs(self.path)

    def _data_files(self, partition: Optional[Dict[str, str]] = None
                    ) -> List[str]:
        root = self.path
        if partition:
            parts = "/".join(f"{k}={v}" for k, v in partition.items())
            root = f"{self.path}/{parts}"
            if not self.file_io.exists(root):
                return []
        return sorted(
            st.path for st in self.file_io.list_status_recursive(root)
            if st.path.endswith("." + self.format.extension))

    @staticmethod
    def _partition_of(path: str, root: str) -> Dict[str, str]:
        rel = path[len(root):].strip("/")
        out = {}
        for seg in rel.split("/")[:-1]:
            if "=" in seg:
                k, v = seg.split("=", 1)
                out[k] = v
        return out

    def to_arrow(self, partition: Optional[Dict[str, str]] = None
                 ) -> pa.Table:
        files = self._data_files(partition)
        reader = self.format.create_reader()
        tables = []
        for f in files:
            t = reader.read(self.file_io, f)
            if not t.num_rows:
                continue
            # hive-style directory keys are part of the row
            for k, v in self._partition_of(f, self.path).items():
                if k not in t.column_names:
                    t = t.append_column(
                        k, pa.array([v] * t.num_rows, pa.string()))
            tables.append(t)
        if not tables:
            return pa.table({})
        return pa.concat_tables(tables, promote_options="permissive")

    def write(self, table: pa.Table,
              partition: Optional[Dict[str, str]] = None,
              compression: str = "zstd") -> str:
        import uuid

        root = self.path
        if partition:
            parts = "/".join(f"{k}={v}" for k, v in partition.items())
            root = f"{self.path}/{parts}"
            self.file_io.mkdirs(root)
        name = f"data-{uuid.uuid4()}.{self.format.extension}"
        path = f"{root}/{name}"
        self.format.create_writer(compression).write(self.file_io, path,
                                                     table)
        return path
