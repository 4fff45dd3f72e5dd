"""REST catalog: HTTP protocol + bearer-token auth.

reference: paimon-api/.../rest/ (RESTApi + 105 DTO/auth files),
paimon-core rest/RESTCatalog.java. Route shapes follow the reference's
`/v1/{prefix}/databases[/{db}[/tables[/{table}]]]` layout; table DATA
access stays direct FileIO against the path the server returns (the
reference behaves the same for filesystem-backed REST catalogs).

RESTCatalogServer wraps any Catalog (normally FileSystemCatalog) for
serving; RESTCatalogClient is a drop-in Catalog implementation whose
tables open on the client's own device (None means "cuda").
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from paimon_tpu_torch.catalog.catalog import (
    Catalog, DatabaseAlreadyExistsError, DatabaseNotFoundError,
    Identifier, TableAlreadyExistsError, TableNotFoundError,
)
from paimon_tpu_torch.schema.schema import Schema
from paimon_tpu_torch.types import DataField

__all__ = ["RESTCatalogServer", "RESTCatalogClient"]


def _schema_to_json(schema: Schema) -> dict:
    return {
        "fields": [f.to_json() for f in schema.fields],
        "partitionKeys": schema.partition_keys,
        "primaryKeys": schema.primary_keys,
        "options": schema.options,
        "comment": getattr(schema, "comment", ""),
    }


def _schema_from_json(d: dict) -> Schema:
    return Schema(
        fields=[DataField.from_json(f) for f in d["fields"]],
        partition_keys=d.get("partitionKeys") or [],
        primary_keys=d.get("primaryKeys") or [],
        options=d.get("options") or {},
        comment=d.get("comment", ""),
    )


_ERRORS = {
    "DatabaseNotFound": DatabaseNotFoundError,
    "DatabaseAlreadyExists": DatabaseAlreadyExistsError,
    "TableNotFound": TableNotFoundError,
    "TableAlreadyExists": TableAlreadyExistsError,
}


class RESTCatalogServer:
    """Serves a Catalog over HTTP (in-process; reference RESTCatalog's
    server side is an external service — this doubles as the conformance
    test double and a usable single-host catalog service)."""

    def __init__(self, catalog, token: Optional[str] = None,
                 prefix: str = "paimon", host: str = "127.0.0.1",
                 port: int = 0):
        self.catalog = catalog
        self.token = token
        self.prefix = prefix
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        from paimon_tpu_torch.parallel.executors import spawn_thread
        self._thread = spawn_thread(self.httpd.serve_forever,
                                    name="paimon-rest-catalog")
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- request handling ----------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, kind: str, message: str):
                self._reply(code, {"error": kind, "message": message})

            def _authorized(self) -> bool:
                if server.token is None:
                    return True
                auth = self.headers.get("Authorization", "")
                return auth == f"Bearer {server.token}"

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n)) if n else {}

            def _route(self, method: str):
                if not self._authorized():
                    return self._error(401, "Unauthorized", "bad token")
                from urllib.parse import urlparse
                parts = [p for p in urlparse(self.path).path.split("/")
                         if p]
                # /v1/{prefix}/databases[/{db}[/tables[/{table}]]]
                if len(parts) < 3 or parts[0] != "v1" or \
                        parts[1] != server.prefix or \
                        parts[2] != "databases":
                    return self._error(404, "NotFound", self.path)
                cat = server.catalog
                from urllib.parse import parse_qs
                query = parse_qs(urlparse(self.path).query)

                def paged(items, key):
                    """maxResults/pageToken pagination (reference
                    RESTApi.MAX_RESULTS/PAGE_TOKEN; token = last
                    name of the previous page over the sorted list)."""
                    items = sorted(items)
                    token = query.get("pageToken", [None])[0]
                    if token:
                        import bisect
                        items = items[bisect.bisect_right(items, token):]
                    try:
                        max_results = int(
                            query.get("maxResults", ["0"])[0])
                    except ValueError:
                        max_results = 0
                    out = {key: items}
                    if max_results > 0 and len(items) > max_results:
                        out[key] = items[:max_results]
                        out["nextPageToken"] = out[key][-1]
                    return out

                try:
                    if len(parts) == 3:
                        if method == "GET":
                            return self._reply(200, paged(
                                cat.list_databases(), "databases"))
                        if method == "POST":
                            b = self._body()
                            cat.create_database(
                                b["name"],
                                properties=b.get("properties"))
                            return self._reply(200, {})
                    db = parts[3]
                    if len(parts) == 4:
                        if method == "GET":
                            return self._reply(200, {
                                "name": db,
                                "properties":
                                    cat.load_database_properties(db)})
                        if method == "DELETE":
                            cascade = query.get("cascade",
                                                ["false"])[0] == "true"
                            cat.drop_database(db, cascade=cascade)
                            return self._reply(200, {})
                    if len(parts) >= 5 and parts[4] == "tables":
                        if len(parts) == 5:
                            if method == "GET":
                                return self._reply(200, paged(
                                    cat.list_tables(db), "tables"))
                            if method == "POST":
                                b = self._body()
                                t = cat.create_table(
                                    f"{db}.{b['name']}",
                                    _schema_from_json(b["schema"]))
                                return self._reply(200, {"path": t.path})
                        name = parts[5]
                        ident = f"{db}.{name}"
                        if method == "GET":
                            t = cat.get_table(ident)
                            return self._reply(200, {
                                "name": name,
                                "path": t.path,
                                "schema": json.loads(
                                    t.schema_manager.latest().to_json()),
                            })
                        if method == "DELETE":
                            cat.drop_table(ident)
                            return self._reply(200, {})
                        if method == "POST":        # rename
                            b = self._body()
                            cat.rename_table(ident,
                                             f"{db}.{b['newName']}")
                            return self._reply(200, {})
                except DatabaseNotFoundError as e:
                    return self._error(404, "DatabaseNotFound", str(e))
                except DatabaseAlreadyExistsError as e:
                    return self._error(409, "DatabaseAlreadyExists",
                                       str(e))
                except TableNotFoundError as e:
                    return self._error(404, "TableNotFound", str(e))
                except TableAlreadyExistsError as e:
                    return self._error(409, "TableAlreadyExists", str(e))
                except Exception as e:          # noqa: BLE001
                    return self._error(500, "Internal", str(e))
                return self._error(404, "NotFound", self.path)

            def do_GET(self):
                self._route("GET")

            def do_POST(self):
                self._route("POST")

            def do_DELETE(self):
                self._route("DELETE")

        return Handler


class RESTCatalogClient(Catalog):
    """reference rest/RESTCatalog.java with BearTokenAuthProvider
    (static token), BearTokenFileAuthProvider (token_file: re-read when
    the file changes, for rotated credentials) and a custom
    token_provider callable (role of the DLF/custom auth providers)."""

    def __init__(self, uri: str, token: Optional[str] = None,
                 prefix: str = "paimon",
                 token_file: Optional[str] = None,
                 token_provider=None, device=None):
        from paimon_tpu_torch.device import resolve_device
        self.device = resolve_device(device)
        self.uri = uri.rstrip("/")
        self.token = token
        self.token_file = token_file
        self.token_provider = token_provider
        self.prefix = prefix
        self._file_mtime = None

    def _current_token(self, force: bool = False) -> Optional[str]:
        if self.token_provider is not None:
            return self.token_provider()
        if self.token_file:
            import os
            try:
                st = os.stat(self.token_file)
                sig = (st.st_mtime_ns, st.st_size)
                if force or sig != self._file_mtime:
                    with open(self.token_file) as f:
                        self.token = f.read().strip()
                    self._file_mtime = sig
            except OSError:
                pass
        return self.token

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None,
                 _retry_auth: bool = True) -> dict:
        url = f"{self.uri}/v1/{self.prefix}/{path}"
        data = json.dumps(body).encode("utf-8") if body is not None \
            else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        token = self._current_token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code == 401 and _retry_auth and self.token_file:
                # rotated credentials may land inside the stat
                # signature's granularity: force one re-read and retry
                if self._current_token(force=True) != token:
                    return self._request(method, path, body,
                                         _retry_auth=False)
            return self._handle_http_error(e)

    def _handle_http_error(self, e) -> dict:
        try:
            payload = json.loads(e.read())
        except Exception:
            payload = {"error": "Internal", "message": str(e)}
        exc = _ERRORS.get(payload.get("error"))
        if exc is not None:
            raise exc(payload.get("message", ""))
        raise RuntimeError(
            f"REST catalog error {e.code}: {payload}") from e

    # -- Catalog API ---------------------------------------------------------

    def _paged(self, path: str, key: str,
               max_results: Optional[int] = None,
               page_token: Optional[str] = None):
        """One page (reference RESTApi maxResults/pageToken):
        -> (items, next_page_token)."""
        from urllib.parse import quote, urlencode
        q = {}
        if max_results:
            q["maxResults"] = str(max_results)
        if page_token:
            q["pageToken"] = page_token
        full = path + ("?" + urlencode(q, quote_via=quote) if q else "")
        resp = self._request("GET", full)
        return resp[key], resp.get("nextPageToken")

    def _list_all(self, path: str, key: str,
                  page_size: Optional[int] = None) -> List[str]:
        out: List[str] = []
        token = None
        while True:
            items, token = self._paged(path, key, page_size, token)
            out.extend(items)
            if not token:
                return out

    def list_databases(self, page_size: Optional[int] = None
                       ) -> List[str]:
        return self._list_all("databases", "databases", page_size)

    def list_databases_paged(self, max_results: Optional[int] = None,
                             page_token: Optional[str] = None):
        return self._paged("databases", "databases", max_results,
                           page_token)

    def create_database(self, name: str, ignore_if_exists: bool = False,
                        properties: Optional[Dict[str, str]] = None):
        try:
            self._request("POST", "databases",
                          {"name": name, "properties": properties})
        except DatabaseAlreadyExistsError:
            if not ignore_if_exists:
                raise

    def load_database_properties(self, name: str) -> Dict[str, str]:
        return self._request("GET", f"databases/{name}")["properties"]

    def drop_database(self, name: str, ignore_if_not_exists: bool = False,
                      cascade: bool = False):
        try:
            flag = "true" if cascade else "false"
            self._request("DELETE", f"databases/{name}?cascade={flag}")
        except DatabaseNotFoundError:
            if not ignore_if_not_exists:
                raise

    def list_tables(self, database: str,
                    page_size: Optional[int] = None) -> List[str]:
        return self._list_all(f"databases/{database}/tables", "tables",
                              page_size)

    def list_tables_paged(self, database: str,
                          max_results: Optional[int] = None,
                          page_token: Optional[str] = None):
        return self._paged(f"databases/{database}/tables", "tables",
                           max_results, page_token)

    def create_table(self, identifier, schema: Schema,
                     ignore_if_exists: bool = False):
        from paimon_tpu_torch.table.table import FileStoreTable

        i = self._no_branch(self._ident(identifier), "create")
        try:
            resp = self._request("POST",
                                 f"databases/{i.database}/tables",
                                 {"name": i.table,
                                  "schema": _schema_to_json(schema)})
            return FileStoreTable.load(resp["path"], device=self.device)
        except TableAlreadyExistsError:
            if not ignore_if_exists:
                raise
            return self.get_table(identifier)

    def get_table(self, identifier):
        from paimon_tpu_torch.table.table import FileStoreTable

        i = self._ident(identifier)
        info = self._request(
            "GET", f"databases/{i.database}/tables/{i.table}")
        dynamic = {"branch": i.branch} if i.branch else None
        return FileStoreTable.load(info["path"], dynamic_options=dynamic,
                                   device=self.device)

    def drop_table(self, identifier, ignore_if_not_exists: bool = False):
        i = self._no_branch(self._ident(identifier), "drop")
        try:
            self._request("DELETE",
                          f"databases/{i.database}/tables/{i.table}")
        except TableNotFoundError:
            if not ignore_if_not_exists:
                raise

    def rename_table(self, src, dst, ignore_if_not_exists: bool = False):
        s = self._no_branch(self._ident(src), "rename")
        d = self._no_branch(self._ident(dst), "rename")
        try:
            self._request("POST",
                          f"databases/{s.database}/tables/{s.table}",
                          {"newName": d.table})
        except TableNotFoundError:
            if not ignore_if_not_exists:
                raise
