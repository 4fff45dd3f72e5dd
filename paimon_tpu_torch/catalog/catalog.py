"""FileSystemCatalog: databases and tables as warehouse directories.

Counterpart of paimon_tpu/catalog/catalog.py.  Every catalog holds an
explicit device (None means "cuda", resolved by `device.resolve_device`,
which raises without a card); the tables it creates, loads and alters
run their merges there.

reference: catalog/FileSystemCatalog.java (layout `<wh>/<db>.db/<table>`,
database properties file, listing = directory listing),
catalog/Catalog.java (SPI semantics: existence errors, ignore flags),
catalog/Identifier.java (`db.table` parsing, `$branch` suffix).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.fs import FileIO, get_file_io
from paimon_tpu_torch.options import Options
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.schema.schema_manager import SchemaManager
from paimon_tpu_torch.table.table import FileStoreTable

__all__ = ["Catalog", "FileSystemCatalog", "Identifier", "create_catalog",
           "DatabaseNotFoundError", "DatabaseAlreadyExistsError",
           "TableNotFoundError", "TableAlreadyExistsError"]

DB_SUFFIX = ".db"
DB_PROPS_FILE = ".database-properties"


class DatabaseNotFoundError(Exception):
    pass


class DatabaseAlreadyExistsError(Exception):
    pass


class TableNotFoundError(Exception):
    pass


class TableAlreadyExistsError(Exception):
    pass


@dataclass(frozen=True)
class Identifier:
    """reference catalog/Identifier.java: `database.table[$branch]`."""
    database: str
    table: str
    branch: Optional[str] = None

    @staticmethod
    def parse(full_name: str) -> "Identifier":
        parts = full_name.split(".")
        if len(parts) != 2:
            raise ValueError(f"Identifier must be 'db.table', got "
                             f"{full_name!r}")
        table, branch = parts[1], None
        if "$branch_" in table:
            table, branch = table.split("$branch_", 1)
        return Identifier(parts[0], table, branch)

    @property
    def full_name(self) -> str:
        return f"{self.database}.{self.table}"


class Catalog:
    """Catalog SPI (reference catalog/Catalog.java)."""

    def list_databases(self) -> List[str]:
        raise NotImplementedError

    def create_database(self, name: str, ignore_if_exists: bool = False,
                        properties: Optional[Dict[str, str]] = None):
        raise NotImplementedError

    def drop_database(self, name: str, ignore_if_not_exists: bool = False,
                      cascade: bool = False):
        raise NotImplementedError

    def list_tables(self, database: str) -> List[str]:
        raise NotImplementedError

    def create_table(self, identifier, schema: Schema,
                     ignore_if_exists: bool = False) -> FileStoreTable:
        raise NotImplementedError

    def get_table(self, identifier) -> FileStoreTable:
        raise NotImplementedError

    def drop_table(self, identifier, ignore_if_not_exists: bool = False):
        raise NotImplementedError

    def rename_table(self, src, dst,
                     ignore_if_not_exists: bool = False):
        raise NotImplementedError

    def system_table(self, name: str):
        """Catalog-level `sys` database tables (all_tables,
        all_partitions, all_table_options, catalog_options — reference
        SystemTableLoader.loadGlobal)."""
        from paimon_tpu_torch.catalog.system import load_global_system_table
        return load_global_system_table(self, name)

    # -- views (reference Catalog.java:502 createView et al) -----------------
    def create_view(self, identifier, view,
                    ignore_if_exists: bool = False):
        raise NotImplementedError("this catalog does not support views")

    def get_view(self, identifier):
        raise NotImplementedError("this catalog does not support views")

    def list_views(self, database: str) -> List[str]:
        return []

    def drop_view(self, identifier, ignore_if_not_exists: bool = False):
        raise NotImplementedError("this catalog does not support views")

    def view_exists(self, identifier) -> bool:
        try:
            self.get_view(identifier)
            return True
        except (NotImplementedError, FileNotFoundError, KeyError,
                ValueError):
            return False

    # -- functions (reference Catalog.java:1230 createFunction et al) --------
    def create_function(self, identifier, function,
                        ignore_if_exists: bool = False):
        raise NotImplementedError(
            "this catalog does not support functions")

    def get_function(self, identifier):
        raise NotImplementedError(
            "this catalog does not support functions")

    def list_functions(self, database: str) -> List[str]:
        return []

    def drop_function(self, identifier,
                      ignore_if_not_exists: bool = False):
        raise NotImplementedError(
            "this catalog does not support functions")

    def function_exists(self, identifier) -> bool:
        try:
            self.get_function(identifier)
            return True
        except (NotImplementedError, FileNotFoundError, KeyError,
                ValueError):
            return False

    def close(self):
        pass

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _ident(identifier) -> Identifier:
        if isinstance(identifier, Identifier):
            return identifier
        return Identifier.parse(identifier)

    @staticmethod
    def _no_branch(identifier: Identifier, op: str) -> Identifier:
        """create/drop/rename act on whole tables only — a $branch
        identifier here would touch the main table's directory (reference
        Catalog rejects branch identifiers for DDL)."""
        if identifier.branch:
            raise ValueError(
                f"Cannot {op} a branch identifier "
                f"{identifier.full_name}$branch_{identifier.branch}; use "
                f"table.create_branch/delete_branch instead")
        return identifier


class FileSystemCatalog(Catalog):
    def __init__(self, warehouse: str, file_io: Optional[FileIO] = None,
                 device=None):
        self.device = resolve_device(device)
        self.warehouse = warehouse.rstrip("/")
        self.file_io = file_io or get_file_io(warehouse)
        self.file_io.mkdirs(self.warehouse)

    # -- databases -----------------------------------------------------------

    def database_path(self, name: str) -> str:
        return f"{self.warehouse}/{name}{DB_SUFFIX}"

    def list_databases(self) -> List[str]:
        out = []
        for st in self.file_io.list_status(self.warehouse):
            base = st.path.rstrip("/").split("/")[-1]
            if st.is_dir and base.endswith(DB_SUFFIX):
                out.append(base[:-len(DB_SUFFIX)])
        return sorted(out)

    def database_exists(self, name: str) -> bool:
        path = self.database_path(name)
        return self.file_io.exists(path)

    def create_database(self, name: str, ignore_if_exists: bool = False,
                        properties: Optional[Dict[str, str]] = None):
        path = self.database_path(name)
        if self.database_exists(name):
            if ignore_if_exists:
                return
            raise DatabaseAlreadyExistsError(name)
        self.file_io.mkdirs(path)
        if properties:
            self.file_io.write_bytes(
                f"{path}/{DB_PROPS_FILE}",
                json.dumps(properties).encode(), overwrite=True)

    def load_database_properties(self, name: str) -> Dict[str, str]:
        if not self.database_exists(name):
            raise DatabaseNotFoundError(name)
        path = f"{self.database_path(name)}/{DB_PROPS_FILE}"
        if not self.file_io.exists(path):
            return {}
        return json.loads(self.file_io.read_bytes(path))

    def drop_database(self, name: str, ignore_if_not_exists: bool = False,
                      cascade: bool = False):
        if not self.database_exists(name):
            if ignore_if_not_exists:
                return
            raise DatabaseNotFoundError(name)
        if not cascade and self.list_tables(name):
            raise ValueError(f"Database {name} is not empty "
                             f"(use cascade=True)")
        self.file_io.delete(self.database_path(name), recursive=True)

    # -- tables --------------------------------------------------------------

    def table_path(self, identifier) -> str:
        i = self._ident(identifier)
        return f"{self.database_path(i.database)}/{i.table}"

    def list_tables(self, database: str) -> List[str]:
        if not self.database_exists(database):
            raise DatabaseNotFoundError(database)
        out = []
        for st in self.file_io.list_status(self.database_path(database)):
            base = st.path.rstrip("/").split("/")[-1]
            if base.startswith(".") or not st.is_dir:
                continue
            if SchemaManager(self.file_io, st.path).latest() is not None:
                out.append(base)
        return sorted(out)

    def table_exists(self, identifier) -> bool:
        path = self.table_path(identifier)
        return SchemaManager(self.file_io, path).latest() is not None

    def create_table(self, identifier, schema: Schema,
                     ignore_if_exists: bool = False) -> FileStoreTable:
        i = self._no_branch(self._ident(identifier), "create")
        if not self.database_exists(i.database):
            raise DatabaseNotFoundError(i.database)
        path = self.table_path(i)
        if self.table_exists(i):
            if ignore_if_exists:
                return self.get_table(i)
            raise TableAlreadyExistsError(i.full_name)
        if self.view_exists(i):
            # views and tables share the name space; a table behind a
            # view would be unreachable (view resolution wins)
            raise ValueError(f"A view named {i.full_name} exists")
        return FileStoreTable.create(path, schema, file_io=self.file_io,
                                     device=self.device)

    def get_table(self, identifier) -> FileStoreTable:
        i = self._ident(identifier)
        path = self.table_path(i)
        if not self.table_exists(i):
            raise TableNotFoundError(i.full_name)
        dynamic = {"branch": i.branch} if i.branch else None
        return FileStoreTable.load(path, file_io=self.file_io,
                                   dynamic_options=dynamic,
                                   device=self.device)

    def drop_table(self, identifier, ignore_if_not_exists: bool = False):
        i = self._no_branch(self._ident(identifier), "drop")
        if not self.table_exists(i):
            if ignore_if_not_exists:
                return
            raise TableNotFoundError(i.full_name)
        self.file_io.delete(self.table_path(i), recursive=True)

    def rename_table(self, src, dst, ignore_if_not_exists: bool = False):
        s = self._no_branch(self._ident(src), "rename")
        d = self._no_branch(self._ident(dst), "rename")
        if not self.table_exists(s):
            if ignore_if_not_exists:
                return
            raise TableNotFoundError(s.full_name)
        if self.table_exists(d):
            raise TableAlreadyExistsError(d.full_name)
        self.file_io.rename(self.table_path(s), self.table_path(d))

    def alter_table(self, identifier, changes) -> FileStoreTable:
        """Apply SchemaChange ops via the table's SchemaManager
        (reference FileSystemCatalog.alterTableImpl)."""
        table = self.get_table(identifier)
        table.schema_manager.commit_changes(changes)
        return self.get_table(identifier)

    # -- views ---------------------------------------------------------------
    def _view_path(self, ident: Identifier) -> str:
        return f"{self.database_path(ident.database)}/" \
               f"{ident.table}.view/view.json"

    def create_view(self, identifier, view,
                    ignore_if_exists: bool = False):
        ident = self._ident(identifier)
        if not self.database_exists(ident.database):
            raise DatabaseNotFoundError(ident.database)
        path = self._view_path(ident)
        if self.file_io.exists(path):
            if ignore_if_exists:
                return
            raise ValueError(f"View already exists: {ident.full_name}")
        if self.table_exists(ident):
            raise ValueError(f"A table named {ident.full_name} exists")
        self.file_io.write_bytes(path, view.to_json().encode(),
                                 overwrite=False)

    def get_view(self, identifier):
        from paimon_tpu_torch.catalog.view import View
        ident = self._ident(identifier)
        path = self._view_path(ident)
        if not self.file_io.exists(path):
            raise FileNotFoundError(f"View not found: {ident.full_name}")
        return View.from_json(self.file_io.read_utf8(path))

    def list_views(self, database: str) -> List[str]:
        if not self.database_exists(database):
            raise DatabaseNotFoundError(database)
        out = []
        for st in self.file_io.list_status(self.database_path(database)):
            base = st.path.rstrip("/").split("/")[-1]
            if st.is_dir and base.endswith(".view"):
                out.append(base[:-len(".view")])
        return sorted(out)

    def view_exists(self, identifier) -> bool:
        # cheap probe: one exists() call, no read/parse
        return self.file_io.exists(self._view_path(self._ident(identifier)))

    # -- functions -----------------------------------------------------------
    def _function_path(self, ident: Identifier) -> str:
        return f"{self.database_path(ident.database)}/" \
               f"{ident.table}.function/function.json"

    def create_function(self, identifier, function,
                        ignore_if_exists: bool = False):
        ident = self._ident(identifier)
        if not self.database_exists(ident.database):
            raise DatabaseNotFoundError(ident.database)
        path = self._function_path(ident)
        if self.file_io.exists(path):
            if ignore_if_exists:
                return
            raise ValueError(f"Function already exists: "
                             f"{ident.full_name}")
        self.file_io.write_bytes(path, function.to_json().encode(),
                                 overwrite=False)

    def get_function(self, identifier):
        from paimon_tpu_torch.catalog.function import Function
        ident = self._ident(identifier)
        path = self._function_path(ident)
        if not self.file_io.exists(path):
            raise FileNotFoundError(
                f"Function not found: {ident.full_name}")
        return Function.from_json(self.file_io.read_utf8(path))

    def list_functions(self, database: str) -> List[str]:
        if not self.database_exists(database):
            raise DatabaseNotFoundError(database)
        out = []
        for st in self.file_io.list_status(self.database_path(database)):
            base = st.path.rstrip("/").split("/")[-1]
            if st.is_dir and base.endswith(".function"):
                out.append(base[:-len(".function")])
        return sorted(out)

    def drop_function(self, identifier,
                      ignore_if_not_exists: bool = False):
        ident = self._ident(identifier)
        dir_path = f"{self.database_path(ident.database)}/" \
                   f"{ident.table}.function"
        if not self.file_io.exists(dir_path):
            if ignore_if_not_exists:
                return
            raise FileNotFoundError(
                f"Function not found: {ident.full_name}")
        self.file_io.delete(dir_path, recursive=True)

    def function_exists(self, identifier) -> bool:
        return self.file_io.exists(
            self._function_path(self._ident(identifier)))

    def drop_view(self, identifier, ignore_if_not_exists: bool = False):
        ident = self._ident(identifier)
        dir_path = f"{self.database_path(ident.database)}/" \
                   f"{ident.table}.view"
        if not self.file_io.exists(dir_path):
            if ignore_if_not_exists:
                return
            raise FileNotFoundError(f"View not found: {ident.full_name}")
        self.file_io.delete(dir_path, recursive=True)


def create_catalog(options=None, device=None, **kwargs) -> Catalog:
    """Factory (reference catalog/CatalogFactory.createCatalog):
    create_catalog({"warehouse": "/path"}) or
    create_catalog(warehouse="/path", metastore="filesystem").  `device`
    is the catalog's tables' device (None means "cuda"); it is not a
    catalog option."""
    opts: Dict[str, str] = {}
    if isinstance(options, Options):
        opts.update(options.to_map())
    elif isinstance(options, dict):
        opts.update(options)
    opts.update({k: str(v) for k, v in kwargs.items()})
    metastore = opts.get("metastore", "filesystem")
    warehouse = opts.get("warehouse")
    if not warehouse and metastore == "filesystem":
        raise ValueError("catalog requires a 'warehouse' option")
    if metastore == "filesystem":
        return FileSystemCatalog(warehouse, device=device)
    if metastore == "jdbc":
        from paimon_tpu_torch.catalog.jdbc import JdbcCatalog
        uri = opts.get("uri")
        if not uri or not warehouse:
            raise ValueError("jdbc catalog requires 'uri' and "
                             "'warehouse' options")
        return JdbcCatalog(uri, warehouse, device=device)
    if metastore == "rest":
        from paimon_tpu_torch.catalog.rest import RESTCatalogClient
        uri = opts.get("uri")
        if not uri:
            raise ValueError("rest catalog requires a 'uri' option")
        return RESTCatalogClient(uri, token=opts.get("token"),
                                 prefix=opts.get("prefix", "paimon"),
                                 device=device)
    raise ValueError(f"Unsupported metastore {metastore!r} "
                     f"(available: filesystem, jdbc, rest)")
