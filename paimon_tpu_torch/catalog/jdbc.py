"""SQL-database-backed catalog (JDBC catalog analog).

reference: paimon-core/.../jdbc/JdbcCatalog.java: catalog metadata
(databases, table locations) and distributed locks live in an RDBMS;
table data stays on the filesystem. Python has no JDBC — sqlite3 (stdlib)
plays the embedded-RDBMS role with the same schema shape
(catalog_databases / catalog_tables / locks), and the lock table provides
the cross-process mutual exclusion JdbcCatalogLock gives the reference.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Dict, List, Optional

from paimon_tpu_torch.catalog.catalog import (
    Catalog, DatabaseAlreadyExistsError, DatabaseNotFoundError,
    TableAlreadyExistsError, TableNotFoundError,
)
from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.fs import FileIO, get_file_io
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.table.table import FileStoreTable

__all__ = ["JdbcCatalog"]

_DDL = [
    """CREATE TABLE IF NOT EXISTS catalog_databases (
        name TEXT PRIMARY KEY, properties TEXT)""",
    """CREATE TABLE IF NOT EXISTS catalog_tables (
        database_name TEXT, table_name TEXT, location TEXT,
        PRIMARY KEY (database_name, table_name))""",
    """CREATE TABLE IF NOT EXISTS catalog_locks (
        lock_name TEXT PRIMARY KEY, acquired_ms INTEGER)""",
]


class JdbcCatalog(Catalog):
    def __init__(self, uri: str, warehouse: str,
                 file_io: Optional[FileIO] = None,
                 lock_timeout_ms: int = 10_000, device=None):
        """uri: sqlite path (':memory:' for tests) — the reference's
        jdbc connection-string role.  `device` is the tables' device
        (None means "cuda")."""
        self.device = resolve_device(device)
        self.uri = uri
        self.warehouse = warehouse.rstrip("/")
        self.file_io = file_io or get_file_io(warehouse)
        self.file_io.mkdirs(self.warehouse)
        self.lock_timeout_ms = lock_timeout_ms
        self._conn = sqlite3.connect(uri, timeout=lock_timeout_ms / 1000,
                                     check_same_thread=False)
        if uri != ":memory:":
            # concurrent writers: WAL + busy waiting instead of
            # immediate 'database is locked' failures
            self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(f"PRAGMA busy_timeout={lock_timeout_ms}")
        # one shared connection: all access serialized (commit/rollback
        # interleaving across threads would corrupt transactions)
        self._mutex = threading.Lock()
        for ddl in _DDL:
            self._conn.execute(ddl)
        self._conn.commit()

    def _tx(self):
        return self._mutex

    # -- locks (reference JdbcCatalogLock) -----------------------------------

    def _acquire_lock(self, name: str):
        deadline = time.time() + self.lock_timeout_ms / 1000
        while time.time() < deadline:
            try:
                with self._tx():
                    self._conn.execute(
                        "INSERT INTO catalog_locks VALUES (?, ?)",
                        (name, int(time.time() * 1000)))
                    self._conn.commit()
                return
            except sqlite3.OperationalError:
                with self._tx():
                    self._conn.rollback()
                from paimon_tpu_torch.utils.backoff import wait_for
                wait_for(0.02, what="jdbc catalog lock")
                continue
            except sqlite3.IntegrityError:
                with self._tx():
                    self._conn.rollback()
                    # stale-lock takeover after the timeout window
                    row = self._conn.execute(
                        "SELECT acquired_ms FROM catalog_locks "
                        "WHERE lock_name = ?", (name,)).fetchone()
                stale = row and row[0] < (time.time() * 1000
                                          - self.lock_timeout_ms)
                if stale:
                    self._release_lock(name)
                else:
                    from paimon_tpu_torch.utils.backoff import wait_for
                    wait_for(0.02, what="jdbc catalog lock")
        raise TimeoutError(f"catalog lock {name!r} busy")

    def _release_lock(self, name: str):
        with self._tx():
            self._conn.execute(
                "DELETE FROM catalog_locks WHERE lock_name = ?", (name,))
            self._conn.commit()

    # -- databases -----------------------------------------------------------

    def list_databases(self) -> List[str]:
        with self._tx():
            return [r[0] for r in self._conn.execute(
                "SELECT name FROM catalog_databases ORDER BY name")]

    def create_database(self, name: str, ignore_if_exists: bool = False,
                        properties: Optional[Dict[str, str]] = None):
        import json
        try:
            with self._tx():
                self._conn.execute(
                    "INSERT INTO catalog_databases VALUES (?, ?)",
                    (name, json.dumps(properties or {})))
                self._conn.commit()
        except sqlite3.IntegrityError:
            if not ignore_if_exists:
                raise DatabaseAlreadyExistsError(name)

    def load_database_properties(self, name: str) -> Dict[str, str]:
        import json
        with self._tx():
            row = self._conn.execute(
                "SELECT properties FROM catalog_databases WHERE name = ?",
                (name,)).fetchone()
        if row is None:
            raise DatabaseNotFoundError(name)
        return json.loads(row[0] or "{}")

    def drop_database(self, name: str, ignore_if_not_exists: bool = False,
                      cascade: bool = False):
        if name not in self.list_databases():
            if ignore_if_not_exists:
                return
            raise DatabaseNotFoundError(name)
        tables = self.list_tables(name)
        if tables and not cascade:
            raise ValueError(f"Database {name} is not empty "
                             f"(use cascade=True)")
        for t in tables:
            self.drop_table(f"{name}.{t}")
        with self._tx():
            self._conn.execute(
                "DELETE FROM catalog_databases WHERE name = ?", (name,))
            self._conn.commit()

    # -- tables --------------------------------------------------------------

    def list_tables(self, database: str) -> List[str]:
        if database not in self.list_databases():
            raise DatabaseNotFoundError(database)
        with self._tx():
            return [r[0] for r in self._conn.execute(
                "SELECT table_name FROM catalog_tables "
                "WHERE database_name = ? ORDER BY table_name",
                (database,))]

    def _location(self, db: str, table: str) -> Optional[str]:
        with self._tx():
            row = self._conn.execute(
                "SELECT location FROM catalog_tables "
                "WHERE database_name = ? AND table_name = ?",
                (db, table)).fetchone()
        return row[0] if row else None

    def create_table(self, identifier, schema: Schema,
                     ignore_if_exists: bool = False) -> FileStoreTable:
        i = self._no_branch(self._ident(identifier), "create")
        if i.database not in self.list_databases():
            raise DatabaseNotFoundError(i.database)
        self._acquire_lock(i.full_name)
        try:
            if self._location(i.database, i.table) is not None:
                if ignore_if_exists:
                    return self.get_table(i)
                raise TableAlreadyExistsError(i.full_name)
            location = f"{self.warehouse}/{i.database}.db/{i.table}"
            t = FileStoreTable.create(location, schema,
                                      file_io=self.file_io,
                                      device=self.device)
            with self._tx():
                self._conn.execute("INSERT INTO catalog_tables VALUES "
                                   "(?, ?, ?)",
                                   (i.database, i.table, location))
                self._conn.commit()
            return t
        finally:
            self._release_lock(i.full_name)

    def get_table(self, identifier) -> FileStoreTable:
        i = self._ident(identifier)
        location = self._location(i.database, i.table)
        if location is None:
            raise TableNotFoundError(i.full_name)
        dynamic = {"branch": i.branch} if i.branch else None
        return FileStoreTable.load(location, file_io=self.file_io,
                                   dynamic_options=dynamic,
                                   device=self.device)

    def drop_table(self, identifier, ignore_if_not_exists: bool = False):
        i = self._no_branch(self._ident(identifier), "drop")
        location = self._location(i.database, i.table)
        if location is None:
            if ignore_if_not_exists:
                return
            raise TableNotFoundError(i.full_name)
        self.file_io.delete(location, recursive=True)
        with self._tx():
            self._conn.execute(
                "DELETE FROM catalog_tables WHERE database_name = ? AND "
                "table_name = ?", (i.database, i.table))
            self._conn.commit()

    def rename_table(self, src, dst, ignore_if_not_exists: bool = False):
        s = self._no_branch(self._ident(src), "rename")
        d = self._no_branch(self._ident(dst), "rename")
        location = self._location(s.database, s.table)
        if location is None:
            if ignore_if_not_exists:
                return
            raise TableNotFoundError(s.full_name)
        if d.database not in self.list_databases():
            raise DatabaseNotFoundError(d.database)
        if self._location(d.database, d.table) is not None:
            raise TableAlreadyExistsError(d.full_name)
        new_location = f"{self.warehouse}/{d.database}.db/{d.table}"
        self.file_io.mkdirs(new_location.rsplit("/", 1)[0])
        self.file_io.rename(location, new_location)
        with self._tx():
            self._conn.execute(
                "UPDATE catalog_tables SET database_name = ?, "
                "table_name = ?, location = ? "
                "WHERE database_name = ? AND table_name = ?",
                (d.database, d.table, new_location, s.database, s.table))
            self._conn.commit()

    def alter_table(self, identifier, changes) -> FileStoreTable:
        """Schema DDL through the table's SchemaManager (same shape as
        FileSystemCatalog.alter_table)."""
        table = self.get_table(identifier)
        table.schema_manager.commit_changes(changes)
        return self.get_table(identifier)

    def close(self):
        self._conn.close()
