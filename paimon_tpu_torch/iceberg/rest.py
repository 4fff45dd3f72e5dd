"""Iceberg REST catalog committer: publish the exported Iceberg
metadata to an Iceberg-REST-protocol catalog so any Iceberg REST reader
sees paimon tables without touching paimon metadata.

Counterpart of paimon_tpu/iceberg/rest.py.

reference: paimon-iceberg/.../IcebergRestMetadataCommitter.java —
semantics mirrored (not translated): load-or-create the table in the
REST catalog; when the catalog's current state matches the base we
exported from, commit the new snapshot with a CAS requirement on the
main branch's snapshot id; when the base is incorrect (diverged /
manually edited), drop and recreate, same as the reference's
recreateTable() path. Wire format is the public Apache Iceberg REST
catalog OpenAPI: POST /v1/{prefix}/namespaces/{ns}/tables/{table} with
`requirements` (assert-table-uuid / assert-ref-snapshot-id) and
`updates` (add-snapshot, set-snapshot-ref, remove-snapshots, ...).

IcebergRESTCatalogServer is the loopback protocol double used by tests
(role of the reference's RESTCatalogServer test harness): it applies
updates under requirement checks (409 CommitFailedException on CAS
miss) and persists each committed metadata JSON at a
`metadata-location`, which independent readers (iceberg/reader.py)
consume directly.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
import uuid as uuid_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

__all__ = [
    "IcebergRestClient", "IcebergRestCommitter",
    "IcebergRESTCatalogServer", "IcebergCommitConflictError",
]


class IcebergCommitConflictError(RuntimeError):
    """CAS requirement failed at the REST catalog (409)."""


class IcebergRestClient:
    """Minimal Iceberg REST catalog protocol client."""

    def __init__(self, uri: str, prefix: str = "",
                 auth_provider=None, timeout: float = 30.0):
        self.uri = uri.rstrip("/")
        self.prefix = prefix.strip("/")
        self.auth = auth_provider
        self.timeout = timeout

    def _path(self, suffix: str) -> str:
        base = f"/v1/{self.prefix}" if self.prefix else "/v1"
        return f"{base}/{suffix}"

    def _request(self, method: str, suffix: str,
                 body: Optional[dict] = None) -> dict:
        path = self._path(suffix)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.uri + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        if self.auth is not None:
            for k, v in self.auth.auth_headers(
                    method, path, None,
                    data.decode() if data else None).items():
                req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                payload = r.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read())
            except Exception:
                detail = {}
            if e.code == 409:
                raise IcebergCommitConflictError(
                    detail.get("error", {}).get("message", str(e)))
            if e.code == 404:
                raise FileNotFoundError(path)
            raise RuntimeError(
                f"iceberg rest {method} {path}: {e.code} {detail}") from e

    # -- protocol operations ------------------------------------------------

    def config(self) -> dict:
        return self._request("GET", "config")

    def create_namespace(self, ns: str):
        try:
            self._request("POST", "namespaces", {"namespace": [ns]})
        except IcebergCommitConflictError:
            pass    # already exists

    def load_table(self, ns: str, table: str) -> Optional[dict]:
        """-> {"metadata-location": ..., "metadata": {...}} or None."""
        try:
            return self._request("GET", f"namespaces/{ns}/tables/{table}")
        except FileNotFoundError:
            return None

    def create_table(self, ns: str, table: str, metadata: dict) -> dict:
        return self._request(
            "POST", f"namespaces/{ns}/tables",
            {"name": table, "metadata": metadata})

    def drop_table(self, ns: str, table: str):
        try:
            self._request("DELETE", f"namespaces/{ns}/tables/{table}")
        except FileNotFoundError:
            pass

    def commit_table(self, ns: str, table: str,
                     requirements: List[dict],
                     updates: List[dict]) -> dict:
        return self._request(
            "POST", f"namespaces/{ns}/tables/{table}",
            {"requirements": requirements, "updates": updates})


class IcebergRestCommitter:
    """Publishes exported metadata (iceberg/metadata.py dict) to a REST
    catalog. reference IcebergRestMetadataCommitter.commitMetadata:
    the same load -> create | CAS-commit | recreate decision tree."""

    def __init__(self, client: IcebergRestClient, namespace: str,
                 table: str):
        self.client = client
        self.namespace = namespace
        self.table = table

    def commit_metadata(self, metadata: dict,
                        base_snapshot_id: Optional[int]) -> dict:
        """Commit `metadata` (a full replacement export whose snapshots
        list holds exactly the current snapshot). `base_snapshot_id` is
        the snapshot the export was derived from (None = first export).
        Returns the catalog's load-table response after commit."""
        c = self.client
        c.create_namespace(self.namespace)
        current = c.load_table(self.namespace, self.table)
        if current is None:
            c.create_table(self.namespace, self.table, metadata)
            return c.load_table(self.namespace, self.table)

        cur_meta = current["metadata"]
        cur_snap = cur_meta.get("current-snapshot-id")
        if base_snapshot_id is not None and cur_snap != base_snapshot_id \
                and cur_snap != metadata["current-snapshot-id"]:
            # incorrect base: catalog diverged from what we exported
            # from — recreate, as the reference does (recreateTable)
            c.drop_table(self.namespace, self.table)
            c.create_table(self.namespace, self.table, metadata)
            return c.load_table(self.namespace, self.table)

        snapshot = metadata["snapshots"][-1]
        requirements = [
            {"type": "assert-table-uuid",
             "uuid": cur_meta.get("table-uuid")},
            # the CAS: main must still point at the base we exported from
            {"type": "assert-ref-snapshot-id", "ref": "main",
             "snapshot-id": base_snapshot_id},
        ]
        old_ids = [s["snapshot-id"] for s in cur_meta.get("snapshots", [])
                   if s["snapshot-id"] != snapshot["snapshot-id"]]
        updates: List[dict] = [
            {"action": "add-schema",
             "schema": metadata["schemas"][-1],
             "last-column-id": metadata["last-column-id"]},
            {"action": "set-current-schema", "schema-id": -1},
            {"action": "add-snapshot", "snapshot": snapshot},
            {"action": "set-snapshot-ref", "ref-name": "main",
             "type": "branch",
             "snapshot-id": snapshot["snapshot-id"]},
            {"action": "set-properties",
             "updates": metadata.get("properties", {})},
        ]
        if old_ids:
            updates.append({"action": "remove-snapshots",
                            "snapshot-ids": old_ids})
        c.commit_table(self.namespace, self.table, requirements, updates)
        return c.load_table(self.namespace, self.table)


# ---------------------------------------------------------------------------
# loopback protocol server (test double / single-host catalog service)
# ---------------------------------------------------------------------------

class _TableState:
    def __init__(self, metadata: dict, location: str):
        self.metadata = metadata
        self.metadata_location = location


class IcebergRESTCatalogServer:
    """Implements the subset of the Iceberg REST catalog protocol the
    committer uses, with real requirement enforcement and durable
    metadata: every committed version is written as
    `<warehouse>/<ns>/<table>/metadata/rest-v<N>.metadata.json` so an
    independent reader can consume the `metadata-location` it returns.
    """

    def __init__(self, warehouse: str, file_io=None,
                 auth_check=None, host: str = "127.0.0.1", port: int = 0):
        from paimon_tpu_torch.fs.fileio import LocalFileIO
        self.warehouse = warehouse.rstrip("/")
        self.file_io = file_io or LocalFileIO()
        self.auth_check = auth_check   # fn(handler, method, path, body)
        self._tables: Dict[Tuple[str, str], _TableState] = {}
        self._namespaces = set()
        self._lock = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port),
                                         self._make_handler())
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        from paimon_tpu_torch.parallel.executors import spawn_thread
        self._thread = spawn_thread(self.httpd.serve_forever,
                                    name="paimon-iceberg-rest")
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- state transitions (under lock) -------------------------------------

    def _persist(self, ns: str, table: str, metadata: dict) -> str:
        version = int(metadata.get("_rest-version", 0)) + 1
        metadata = {k: v for k, v in metadata.items()
                    if not k.startswith("_rest")}
        metadata["_rest-version"] = version
        loc = (f"{self.warehouse}/{ns}/{table}/metadata/"
               f"rest-v{version}.metadata.json")
        self.file_io.write_bytes(
            loc, json.dumps(metadata, indent=2).encode(), overwrite=True)
        self._tables[(ns, table)] = _TableState(metadata, loc)
        return loc

    def _apply_commit(self, ns: str, table: str, body: dict):
        state = self._tables.get((ns, table))
        if state is None:
            raise FileNotFoundError(f"{ns}.{table}")
        meta = json.loads(json.dumps(state.metadata))   # deep copy
        for req in body.get("requirements", []):
            kind = req.get("type")
            if kind == "assert-table-uuid":
                if meta.get("table-uuid") != req.get("uuid"):
                    raise IcebergCommitConflictError("table-uuid changed")
            elif kind == "assert-ref-snapshot-id":
                want = req.get("snapshot-id")
                have = meta.get("refs", {}).get(
                    req.get("ref-name", req.get("ref", "main")),
                    {}).get("snapshot-id",
                            meta.get("current-snapshot-id"))
                if want != have:
                    raise IcebergCommitConflictError(
                        f"ref {req.get('ref', 'main')} at {have}, "
                        f"required {want}")
            elif kind == "assert-create":
                raise IcebergCommitConflictError("table exists")
        for up in body.get("updates", []):
            action = up.get("action")
            if action == "add-schema":
                meta.setdefault("schemas", []).append(up["schema"])
                meta["last-column-id"] = max(
                    meta.get("last-column-id", 0),
                    up.get("last-column-id", 0))
            elif action == "set-current-schema":
                sid = up["schema-id"]
                if sid == -1:
                    sid = meta["schemas"][-1].get("schema-id", 0)
                meta["current-schema-id"] = sid
            elif action == "add-snapshot":
                snap = up["snapshot"]
                snaps = [s for s in meta.get("snapshots", [])
                         if s["snapshot-id"] != snap["snapshot-id"]]
                snaps.append(snap)
                meta["snapshots"] = snaps
                meta["last-sequence-number"] = max(
                    meta.get("last-sequence-number", 0),
                    snap.get("sequence-number", 0))
            elif action == "set-snapshot-ref":
                meta.setdefault("refs", {})[up["ref-name"]] = {
                    "snapshot-id": up["snapshot-id"],
                    "type": up.get("type", "branch")}
                if up["ref-name"] == "main":
                    meta["current-snapshot-id"] = up["snapshot-id"]
            elif action == "remove-snapshots":
                drop = set(up.get("snapshot-ids", []))
                meta["snapshots"] = [
                    s for s in meta.get("snapshots", [])
                    if s["snapshot-id"] not in drop]
            elif action == "set-properties":
                meta.setdefault("properties", {}).update(
                    up.get("updates", {}))
            elif action == "remove-properties":
                for k in up.get("removals", []):
                    meta.get("properties", {}).pop(k, None)
            elif action == "set-location":
                meta["location"] = up["location"]
        return self._persist(ns, table, meta)

    # -- HTTP plumbing -------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _err(self, code: int, message: str):
                self._reply(code, {"error": {"message": message,
                                             "code": code}})

            def _handle(self, method: str):
                from urllib.parse import urlparse
                raw_path = urlparse(self.path).path
                n = int(self.headers.get("Content-Length", 0))
                raw_body = self.rfile.read(n).decode() if n else None
                if server.auth_check is not None and not \
                        server.auth_check(dict(self.headers), method,
                                          raw_path, raw_body):
                    return self._err(401, "unauthorized")
                body = json.loads(raw_body) if raw_body else {}
                parts = [p for p in raw_path.split("/") if p]
                if not parts or parts[0] != "v1":
                    return self._err(404, raw_path)
                parts = parts[1:]
                try:
                    return self._route(method, parts, body)
                except FileNotFoundError as e:
                    return self._err(404, str(e))
                except IcebergCommitConflictError as e:
                    return self._err(409, str(e))
                except Exception as e:      # noqa: BLE001
                    return self._err(500, str(e))

            def _route(self, method: str, parts: List[str], body: dict):
                with server._lock:
                    if parts == ["config"] and method == "GET":
                        return self._reply(200, {
                            "defaults": {}, "overrides": {}})
                    if parts == ["namespaces"] and method == "POST":
                        ns = ".".join(body["namespace"])
                        if ns in server._namespaces:
                            return self._err(409, "namespace exists")
                        server._namespaces.add(ns)
                        return self._reply(200, {"namespace": [ns]})
                    if len(parts) >= 3 and parts[0] == "namespaces" and \
                            parts[2] == "tables":
                        ns = parts[1]
                        if len(parts) == 3 and method == "POST":
                            name = body["name"]
                            if (ns, name) in server._tables:
                                return self._err(409, "table exists")
                            meta = dict(body["metadata"])
                            meta.setdefault("table-uuid",
                                            str(uuid_mod.uuid4()))
                            snap = meta.get("current-snapshot-id")
                            if snap is not None:
                                meta.setdefault("refs", {})["main"] = {
                                    "snapshot-id": snap,
                                    "type": "branch"}
                            loc = server._persist(ns, name, meta)
                            return self._reply(200, {
                                "metadata-location": loc,
                                "metadata": meta})
                        if len(parts) == 4:
                            name = parts[3]
                            if method == "GET":
                                st = server._tables.get((ns, name))
                                if st is None:
                                    raise FileNotFoundError(
                                        f"{ns}.{name}")
                                return self._reply(200, {
                                    "metadata-location":
                                        st.metadata_location,
                                    "metadata": st.metadata})
                            if method == "DELETE":
                                server._tables.pop((ns, name), None)
                                return self._reply(200, {})
                            if method == "POST":
                                loc = server._apply_commit(ns, name,
                                                           body)
                                st = server._tables[(ns, name)]
                                return self._reply(200, {
                                    "metadata-location": loc,
                                    "metadata": st.metadata})
                    return self._err(404, "/".join(parts))

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_DELETE(self):
                self._handle("DELETE")

        return Handler
