"""File-based privilege system (RBAC catalog wrapper).

reference: paimon-core/.../privilege/ (PrivilegeManager,
FileBasedPrivilegeManager, PrivilegedCatalog): users + grants persisted
in the warehouse, every catalog/table operation checked.
"""

from __future__ import annotations

import hashlib
import json
import uuid
from typing import Dict, List, Optional

from paimon_tpu_torch.catalog.catalog import Catalog, Identifier

__all__ = ["PrivilegeManager", "PrivilegedCatalog", "PrivilegedTable",
           "Privilege", "PrivilegeError"]


class Privilege:
    SELECT = "SELECT"
    INSERT = "INSERT"
    ALTER_TABLE = "ALTER_TABLE"
    DROP_TABLE = "DROP_TABLE"
    CREATE_TABLE = "CREATE_TABLE"
    CREATE_DATABASE = "CREATE_DATABASE"
    DROP_DATABASE = "DROP_DATABASE"
    ADMIN = "ADMIN"


class PrivilegeError(PermissionError):
    pass


def _hash(password: str) -> str:
    return hashlib.sha256(password.encode("utf-8")).hexdigest()


class PrivilegeManager:
    """users/grants as one JSON file under `<warehouse>/.privilege`."""

    FILE = ".privilege"
    ROOT = "root"
    ANONYMOUS = "anonymous"

    def __init__(self, file_io, warehouse: str):
        self.file_io = file_io
        self.path = f"{warehouse.rstrip('/')}/{self.FILE}"

    # -- state ---------------------------------------------------------------

    def _load(self) -> Optional[dict]:
        if not self.file_io.exists(self.path):
            return None
        return json.loads(self.file_io.read_bytes(self.path))

    def _store(self, state: dict):
        self.file_io.write_bytes(self.path,
                                 json.dumps(state, indent=2).encode(),
                                 overwrite=True)

    def _mutate(self, fn):
        """Serialize mutations through a lock file so concurrent admins
        cannot lose each other's updates (load/modify/overwrite is not
        atomic)."""
        import time
        lock = self.path + ".lock"
        for attempt in range(200):
            if attempt and attempt % 50 == 0:
                # stale-lock takeover: a crashed holder must not brick
                # privilege mutations forever
                try:
                    st = [x for x in self.file_io.list_status(
                              self.path.rsplit("/", 1)[0])
                          if x.path == lock]
                    if st and st[0].mtime_ms and \
                            st[0].mtime_ms < (time.time() - 10) * 1000:
                        self.file_io.delete_quietly(lock)
                # lint-ok: swallow best-effort stale-lock breaking on
                # a catalog without the privilege meta table — failure
                # just means the next mutation retries the break
                except Exception:
                    pass
            # the token must be writer-unique: on object stores, an
            # ambiguous conditional PUT (503 after effect) is resolved
            # by read-back content equality (RetryingObjectStoreBackend)
            # — a constant payload would let a loser claim the lock
            token = uuid.uuid4().hex.encode()
            if self.file_io.try_to_write_atomic(lock, token):
                try:
                    state = self._require()
                    fn(state)
                    self._store(state)
                    return
                finally:
                    self.file_io.delete_quietly(lock)
            from paimon_tpu_torch.utils.backoff import wait_for
            wait_for(0.01, what="privilege file lock")
        raise TimeoutError("privilege file lock busy")

    def enabled(self) -> bool:
        return self._load() is not None

    def init(self, root_password: str):
        if self.enabled():
            raise ValueError("privileges already initialized")
        self._store({"users": {self.ROOT: _hash(root_password)},
                     "grants": {self.ROOT: {"*": [Privilege.ADMIN]}}})

    # -- users / grants ------------------------------------------------------

    def authenticate(self, user: str, password: str) -> bool:
        state = self._load()
        if state is None:
            return True                      # privileges disabled
        stored = state["users"].get(user)
        return stored is not None and stored == _hash(password)

    def create_user(self, user: str, password: str):
        def fn(state):
            if user in state["users"]:
                raise ValueError(f"User {user!r} exists")
            state["users"][user] = _hash(password)
        self._mutate(fn)

    def drop_user(self, user: str):
        def fn(state):
            if user == self.ROOT:
                raise ValueError("Cannot drop root")
            state["users"].pop(user, None)
            state["grants"].pop(user, None)
        self._mutate(fn)

    def grant(self, user: str, privilege: str, target: str = "*"):
        """target: '*', 'db' or 'db.table'."""
        def fn(state):
            if user not in state["users"]:
                raise ValueError(f"Unknown user {user!r}")
            held = state["grants"].setdefault(user, {}).setdefault(
                target, [])
            if privilege not in held:
                held.append(privilege)
        self._mutate(fn)

    def revoke(self, user: str, privilege: str, target: str = "*"):
        def fn(state):
            grants = state.get("grants", {}).get(user, {})
            if target in grants and privilege in grants[target]:
                grants[target].remove(privilege)
        self._mutate(fn)

    def check(self, user: str, privilege: str, target: str = "*"):
        state = self._load()
        if state is None:
            return                           # privileges disabled
        grants = state.get("grants", {}).get(user, {})
        scopes = ["*"]
        if target != "*":
            db = target.split(".")[0]
            scopes += [db, target]
        for scope in scopes:
            held = grants.get(scope, [])
            if Privilege.ADMIN in held or privilege in held:
                return
        raise PrivilegeError(
            f"User {user!r} lacks {privilege} on {target!r}")

    def _require(self) -> dict:
        state = self._load()
        if state is None:
            raise ValueError("privileges not initialized (call init)")
        return state


class PrivilegedTable:
    """Table proxy checking write privileges (reference
    privilege/PrivilegedFileStoreTable): reads passed through, mutating
    entry points require INSERT (or ALTER for schema/maintenance)."""

    _INSERT_METHODS = {"new_batch_write_builder",
                       "new_stream_write_builder", "delete_where",
                       "compact", "sort_compact"}
    _ALTER_METHODS = {"rollback_to", "create_tag", "delete_tag",
                      "create_branch", "delete_branch", "fast_forward",
                      "expire_snapshots", "expire_partitions",
                      "remove_orphan_files", "analyze"}

    def __init__(self, table, manager: "PrivilegeManager", user: str,
                 target: str):
        object.__setattr__(self, "_table", table)
        object.__setattr__(self, "_manager", manager)
        object.__setattr__(self, "_user", user)
        object.__setattr__(self, "_target", target)

    def __getattr__(self, name):
        if name in self._INSERT_METHODS:
            self._manager.check(self._user, Privilege.INSERT, self._target)
        elif name in self._ALTER_METHODS:
            self._manager.check(self._user, Privilege.ALTER_TABLE,
                                self._target)
        return getattr(self._table, name)

    def copy(self, dynamic_options):
        # stays privileged: copy() must not hand back a raw table
        return PrivilegedTable(self._table.copy(dynamic_options),
                               self._manager, self._user, self._target)


class PrivilegedCatalog(Catalog):
    """Catalog wrapper enforcing privileges per operation
    (reference privilege/PrivilegedCatalog.java)."""

    def __init__(self, inner, user: str, password: str):
        self.inner = inner
        self.manager = PrivilegeManager(inner.file_io, inner.warehouse)
        if not self.manager.authenticate(user, password):
            raise PrivilegeError(f"Authentication failed for {user!r}")
        self.user = user

    @property
    def device(self):
        return self.inner.device

    def list_databases(self) -> List[str]:
        return self.inner.list_databases()

    def create_database(self, name, ignore_if_exists=False,
                        properties=None):
        self.manager.check(self.user, Privilege.CREATE_DATABASE)
        return self.inner.create_database(name, ignore_if_exists,
                                          properties)

    def drop_database(self, name, ignore_if_not_exists=False,
                      cascade=False):
        self.manager.check(self.user, Privilege.DROP_DATABASE, name)
        return self.inner.drop_database(name, ignore_if_not_exists,
                                        cascade)

    def list_tables(self, database) -> List[str]:
        return self.inner.list_tables(database)

    def create_table(self, identifier, schema, ignore_if_exists=False):
        i = self._ident(identifier)
        self.manager.check(self.user, Privilege.CREATE_TABLE, i.database)
        return self.inner.create_table(identifier, schema,
                                       ignore_if_exists)

    def get_table(self, identifier):
        i = self._ident(identifier)
        self.manager.check(self.user, Privilege.SELECT, i.full_name)
        return PrivilegedTable(self.inner.get_table(identifier),
                               self.manager, self.user, i.full_name)

    def drop_table(self, identifier, ignore_if_not_exists=False):
        i = self._ident(identifier)
        self.manager.check(self.user, Privilege.DROP_TABLE, i.full_name)
        return self.inner.drop_table(identifier, ignore_if_not_exists)

    def rename_table(self, src, dst, ignore_if_not_exists=False):
        i = self._ident(src)
        self.manager.check(self.user, Privilege.ALTER_TABLE, i.full_name)
        return self.inner.rename_table(src, dst, ignore_if_not_exists)

    def alter_table(self, identifier, changes):
        i = self._ident(identifier)
        self.manager.check(self.user, Privilege.ALTER_TABLE, i.full_name)
        return self.inner.alter_table(identifier, changes)
