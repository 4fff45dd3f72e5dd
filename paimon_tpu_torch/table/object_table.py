"""ObjectTable: a managed directory of arbitrary objects exposed as a
table of file metadata.

Counterpart of paimon_tpu/table/object_table.py.

reference: table/object/ObjectTableImpl.java:60 — rows are the objects'
metadata (path, name, length, mtime); the bytes are fetched by path.
"""

from __future__ import annotations

from typing import List, Optional

import pyarrow as pa

from paimon_tpu_torch.fs import FileIO, get_file_io, safe_join

__all__ = ["ObjectTable"]


class ObjectTable:
    def __init__(self, location: str, file_io: Optional[FileIO] = None):
        self.location = location.rstrip("/")
        self.file_io = file_io or get_file_io(location)
        self.file_io.mkdirs(self.location)

    def _walk(self) -> List:
        return self.file_io.list_status_recursive(self.location)

    def to_arrow(self) -> pa.Table:
        """One row per object (reference ObjectTable row type:
        path/name/length/mtime)."""
        stats = self._walk()
        prefix = len(self.location) + 1
        return pa.table({
            "path": pa.array([s.path[prefix:] for s in stats],
                             pa.string()),
            "name": pa.array([s.path.rsplit("/", 1)[-1] for s in stats],
                             pa.string()),
            "length": pa.array([s.size for s in stats], pa.int64()),
            "mtime_ms": pa.array([s.mtime_ms for s in stats],
                                 pa.int64()),
        })

    def put(self, rel_path: str, data: bytes):
        full = safe_join(self.location, rel_path)
        parent = full.rsplit("/", 1)[0]
        self.file_io.mkdirs(parent)
        self.file_io.write_bytes(full, data, overwrite=True)

    def read(self, rel_path: str) -> bytes:
        return self.file_io.read_bytes(safe_join(self.location, rel_path))

    def delete(self, rel_path: str):
        self.file_io.delete_quietly(safe_join(self.location, rel_path))

    def refresh(self) -> int:
        """-> current object count (reference ObjectRefresh)."""
        return len(self._walk())
