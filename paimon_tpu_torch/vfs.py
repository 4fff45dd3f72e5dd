"""VFS: a filesystem view over a catalog's warehouse.

reference: paimon-vfs (Pvfs / PaimonVirtualFileSystem: a Hadoop
FileSystem exposing catalog tables as file trees through the REST
catalog). Paths: `/<db>/<table>/<relative file>`; table internals
(snapshot/, manifest/, bucket-*/...) are readable for inspection and
object/format tables are fully browsable.

Counterpart of paimon_tpu/vfs.py: host file access only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from paimon_tpu_torch.fs import get_file_io, safe_join

__all__ = ["Vfs"]


class VfsFileStatus:
    def __init__(self, path: str, size: int, is_dir: bool):
        self.path = path
        self.size = size
        self.is_dir = is_dir

    def __repr__(self):
        kind = "dir" if self.is_dir else "file"
        return f"VfsFileStatus({self.path!r}, {self.size}, {kind})"


class Vfs:
    def __init__(self, catalog):
        self.catalog = catalog

    def _resolve(self, path: str) -> Tuple[Optional[str], Optional[str],
                                           str]:
        parts = [p for p in path.split("/") if p]
        db = parts[0] if parts else None
        table = parts[1] if len(parts) > 1 else None
        rest = "/".join(parts[2:])
        return db, table, rest

    def _table_root(self, db: str, table: str) -> str:
        # FileSystemCatalog exposes table_path; REST clients resolve the
        # path through the server (reference Pvfs works over REST too)
        if hasattr(self.catalog, "table_path"):
            return self.catalog.table_path(f"{db}.{table}")
        return self.catalog.get_table(f"{db}.{table}").path

    def _file_io(self, root: str):
        return getattr(self.catalog, "file_io", None) or get_file_io(root)

    def listdir(self, path: str = "/") -> List[VfsFileStatus]:
        db, table, rest = self._resolve(path)
        if db is None:
            return [VfsFileStatus(f"/{d}", 0, True)
                    for d in self.catalog.list_databases()]
        if table is None:
            return [VfsFileStatus(f"/{db}/{t}", 0, True)
                    for t in self.catalog.list_tables(db)]
        root = self._table_root(db, table)
        target = safe_join(root, rest) if rest else root
        out = []
        for st in self._file_io(root).list_status(target):
            rel = st.path[len(root) + 1:]
            out.append(VfsFileStatus(f"/{db}/{table}/{rel}", st.size,
                                     st.is_dir))
        return out

    def open(self, path: str) -> bytes:
        db, table, rest = self._resolve(path)
        if not (db and table and rest):
            raise IsADirectoryError(path)
        root = self._table_root(db, table)
        return self._file_io(root).read_bytes(safe_join(root, rest))

    def exists(self, path: str) -> bool:
        db, table, rest = self._resolve(path)
        if db is None:
            return True
        if table is None:
            return db in self.catalog.list_databases()
        try:
            root = self._table_root(db, table)
        except Exception:
            return False
        target = safe_join(root, rest) if rest else root
        return self._file_io(root).exists(target)

    def size(self, path: str) -> int:
        db, table, rest = self._resolve(path)
        if not (db and table and rest):
            raise IsADirectoryError(path)
        root = self._table_root(db, table)
        return self._file_io(root).get_file_size(safe_join(root, rest))
