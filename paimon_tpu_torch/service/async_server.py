"""Event-loop request engine for the query-serving plane.

Counterpart of paimon_tpu/service/async_server.py (the reference
Paimon's query service is a Netty server; the shape is the same): one
loop thread owns a selector over non-blocking sockets and accepts,
reads, parses and writes; request handlers run on a bounded worker
pool (parallel/executors.new_thread_pool) and may block; completions
return to the loop through a self-wake socket pair.  HTTP/1.1
keep-alive requests may be pipelined: every complete request in the
read buffer dispatches at once and responses leave in request order.
A connection's pipeline is bounded (reads pause when it is full), the
number of connections is bounded (accepts past it answer 503), and the
time a finished response waits for the loop is measured
(`loop_lag_ms`).
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from paimon_tpu_torch.obs.trace import server_span

__all__ = ["AsyncHttpServer", "HttpRequest", "HttpResponse"]

# request-line + headers must fit here; a client that cannot finish its
# headers in 64 KiB is not speaking our protocol
MAX_HEADER_BYTES = 64 * 1024
# request bodies are JSON key/scan specs — 64 MiB is already generous
MAX_BODY_BYTES = 64 << 20
# in-flight pipelined requests per connection before its reads pause
MAX_PIPELINED = 64

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


class HttpRequest:
    """One parsed request (headers lower-cased; body raw bytes)."""

    __slots__ = ("method", "path", "headers", "body", "keep_alive")

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes, keep_alive: bool):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.keep_alive = keep_alive


class HttpResponse:
    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(self, status: int, body: bytes,
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}

    def encode(self, keep_alive: bool) -> bytes:
        reason = _REASONS.get(self.status, "Unknown")
        lines = [f"HTTP/1.1 {self.status} {reason}",
                 f"Content-Type: {self.content_type}",
                 f"Content-Length: {len(self.body)}",
                 "Connection: " + ("keep-alive" if keep_alive
                                   else "close")]
        for k, v in self.headers.items():
            lines.append(f"{k}: {v}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head + self.body


class _ParseError(ValueError):
    pass


class _Slot:
    """One dispatched request's response seat: filled by a worker,
    drained by the loop in request order."""

    __slots__ = ("response", "keep_alive", "done_at")

    def __init__(self, keep_alive: bool):
        self.response: Optional[HttpResponse] = None
        self.keep_alive = keep_alive
        self.done_at = 0.0


class _Conn:
    __slots__ = ("sock", "rbuf", "wbuf", "slots", "eof", "close_after",
                 "paused", "events")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.slots: deque = deque()      # _Slot, request order
        self.eof = False                 # peer closed its write side
        self.close_after = False         # close once wbuf drains
        self.paused = False              # reads off: pipeline full
        self.events = 0                  # currently registered mask


def _parse_one(rbuf: bytearray) -> Optional[Tuple[HttpRequest, int]]:
    """Parse one complete request off the front of `rbuf`; returns
    (request, consumed_bytes) or None if more bytes are needed.
    Raises _ParseError on malformed input."""
    head_end = rbuf.find(b"\r\n\r\n")
    if head_end < 0:
        if len(rbuf) > MAX_HEADER_BYTES:
            raise _ParseError("headers too large")
        return None
    head = bytes(rbuf[:head_end]).decode("latin-1")
    lines = head.split("\r\n")
    parts = lines[0].split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise _ParseError(f"bad request line: {lines[0]!r}")
    method, path, version = parts
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        if not ln:
            continue
        name, sep, value = ln.partition(":")
        if not sep:
            raise _ParseError(f"bad header line: {ln!r}")
        headers[name.strip().lower()] = value.strip()
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError as e:
        raise _ParseError("bad content-length") from e
    if length < 0 or length > MAX_BODY_BYTES:
        raise _ParseError(f"body too large: {length}")
    total = head_end + 4 + length
    if len(rbuf) < total:
        return None
    body = bytes(rbuf[head_end + 4:total])
    conn_hdr = headers.get("connection", "").lower()
    keep_alive = conn_hdr != "close" and version != "HTTP/1.0"
    return HttpRequest(method, path, headers, body, keep_alive), total


class AsyncHttpServer:
    """selectors-based HTTP/1.1 server: one event-loop thread, a
    bounded handler pool, pipelined keep-alive connections.

    `handler(HttpRequest) -> HttpResponse` runs on the worker pool and
    may block; everything socket-side runs on the loop thread."""

    def __init__(self, host: str, port: int,
                 handler: Callable[[HttpRequest], HttpResponse],
                 *, workers: int = 16, max_connections: int = 1024,
                 name: str = "paimon-serve",
                 lag_histogram=None, connections_gauge=None):
        self._handler = handler
        self._name = name
        self._workers = max(1, int(workers))
        self.max_connections = max(1, int(max_connections))
        self._m_lag = lag_histogram
        self._g_conns = connections_gauge
        self._sel = selectors.DefaultSelector()
        self._listener = socket.create_server(
            (host, port), backlog=512, reuse_port=False)
        self._listener.setblocking(False)
        self.host = host
        self.port = self._listener.getsockname()[1]
        # self-wake channel: workers nudge the loop when a response is
        # ready (the loop may be parked in select())
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._done: deque = deque()      # (conn,) completions to flush
        self._done_lock = threading.Lock()
        self._conns: Dict[socket.socket, _Conn] = {}
        self._stop = threading.Event()
        self._pool_done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool = None
        self.recent_lag_ms = 0.0         # last observed completion lag

    # -- lifecycle -----------------------------------------------------------

    @property
    def connection_count(self) -> int:
        return len(self._conns)

    def start(self) -> "AsyncHttpServer":
        from paimon_tpu_torch.parallel.executors import (
            new_thread_pool, spawn_thread,
        )
        self._pool = new_thread_pool(self._workers,
                                     f"{self._name}-worker")
        self._sel.register(self._listener, selectors.EVENT_READ,
                           ("accept", None))
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           ("wake", None))
        self._thread = spawn_thread(self._loop,
                                    name=f"{self._name}-loop")
        return self

    def stop(self):
        """Graceful: stop accepting, let running handlers finish and
        their responses flush, then tear the loop down.  Safe on a
        never-started server (closes the bound listener)."""
        if self._thread is None:
            # constructed but never started: release the listener fd
            # and the wake pair
            try:
                if self._listener.fileno() >= 0:
                    self._listener.close()
                self._sel.close()
                self._wake_r.close()
                self._wake_w.close()
            except OSError:
                pass
            return
        self._stop.set()
        self._wake()
        # running handlers finish (their completions still flush: the
        # loop drains `_done` until after this join); queued-not-
        # started requests are cancelled — their slots never fill and
        # their connections just close, exactly like a server going
        # away mid-pipeline
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pool_done.set()
        self._wake()
        self._thread.join(timeout=30)
        self._thread = None

    # -- worker side ---------------------------------------------------------

    def _wake(self):
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass          # pipe full = a wake is already pending

    def _run_handler(self, conn: _Conn, slot: _Slot, req: HttpRequest):
        try:
            # one flag check when tracing is off; when on, adopts the
            # caller's X-Trace-Id/X-Parent-Span as this request's
            # context — THE server-side hop boundary for every
            # AsyncHttpServer-based service
            with server_span(req.headers, method=req.method,
                             path=req.path):
                resp = self._handler(req)
        except Exception as e:      # noqa: BLE001 — must answer
            # json.dumps, never string splicing: exception text may
            # hold quotes/backslashes/control chars and the body must
            # stay parseable for the client's error decode
            resp = HttpResponse(500, json.dumps(
                {"error": f"internal: {str(e)[:512]}"}).encode())
        slot.response = resp
        slot.done_at = time.perf_counter()
        with self._done_lock:
            self._done.append(conn)
        self._wake()

    # -- loop side -----------------------------------------------------------

    def _loop(self):
        grace_until: Optional[float] = None
        try:
            while True:
                if self._stop.is_set():
                    # closed listener: no new connections; keep
                    # looping while responses are still in flight
                    if self._listener.fileno() >= 0:
                        self._sel.unregister(self._listener)
                        self._listener.close()
                    self._drain_done()
                    if self._pool_done.is_set():
                        # the pool is drained: every response that
                        # will ever exist is flushed or buffered —
                        # give buffered bytes a short grace to leave
                        if grace_until is None:
                            grace_until = time.perf_counter() + 1.0
                        if not any(c.wbuf
                                   for c in self._conns.values()) or \
                                time.perf_counter() >= grace_until:
                            break
                for key, events in self._sel.select(timeout=0.1):
                    kind, conn = key.data
                    if kind == "accept":
                        self._accept()
                    elif kind == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        if events & selectors.EVENT_READ:
                            self._readable(conn)
                        if events & selectors.EVENT_WRITE and \
                                conn.sock in self._conns:
                            self._writable(conn)
                self._drain_done()
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            try:
                if self._listener.fileno() >= 0:
                    self._listener.close()
            except OSError:
                pass
            self._sel.close()
            self._wake_r.close()
            self._wake_w.close()

    def _accept(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            if len(self._conns) >= self.max_connections:
                # over the fd budget: an honest, tiny 503 — never a
                # silent RST from a backlog overflow
                try:
                    sock.setblocking(False)
                    sock.send(HttpResponse(
                        503, b'{"error": "connection limit"}')
                        .encode(keep_alive=False))
                except OSError:
                    pass
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            # lint-ok: fault-taxonomy best-effort socket option on a
            # fresh connection, never re-attempted: losing TCP_NODELAY
            # degrades latency, not correctness — not a store retry
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[sock] = conn
            self._register(conn, selectors.EVENT_READ)
            if self._g_conns is not None:
                self._g_conns.set(len(self._conns))

    def _register(self, conn: _Conn, events: int):
        if events == conn.events:
            return
        if conn.events == 0:
            self._sel.register(conn.sock, events, ("conn", conn))
        elif events == 0:
            self._sel.unregister(conn.sock)
        else:
            self._sel.modify(conn.sock, events, ("conn", conn))
        conn.events = events

    def _wanted_events(self, conn: _Conn) -> int:
        ev = 0
        if not conn.eof and not conn.paused and not conn.close_after:
            ev |= selectors.EVENT_READ
        if conn.wbuf:
            ev |= selectors.EVENT_WRITE
        return ev

    def _readable(self, conn: _Conn):
        if conn.sock not in self._conns:
            return                        # closed earlier this cycle
        try:
            chunk = conn.sock.recv(256 * 1024)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not chunk:
            conn.eof = True
            if not conn.slots and not conn.wbuf:
                self._close(conn)
            else:
                self._register(conn, self._wanted_events(conn))
            return
        conn.rbuf += chunk
        self._parse_and_dispatch(conn)

    def _parse_and_dispatch(self, conn: _Conn):
        while len(conn.slots) < MAX_PIPELINED:
            try:
                parsed = _parse_one(conn.rbuf)
            except _ParseError as e:
                slot = _Slot(keep_alive=False)
                slot.response = HttpResponse(
                    400, json.dumps({"error": str(e)}).encode())
                slot.done_at = time.perf_counter()
                conn.slots.append(slot)
                conn.close_after = True
                conn.rbuf.clear()         # garbage past a parse error
                self._flush_ready(conn)
                break
            if parsed is None:
                break
            req, consumed = parsed
            del conn.rbuf[:consumed]
            slot = _Slot(req.keep_alive)
            conn.slots.append(slot)
            if not req.keep_alive:
                conn.close_after = True
            try:
                if self._stop.is_set() or self._pool is None:
                    raise RuntimeError("stopping")
                self._pool.submit(self._run_handler, conn, slot, req)
            except RuntimeError:
                # racing stop(): the pool may reject between the flag
                # check and the submit — answer 503 inline
                slot.response = HttpResponse(
                    503, b'{"error": "server stopping"}')
                slot.done_at = time.perf_counter()
                self._flush_ready(conn)
        # pipeline full -> pause reads (TCP backpressures the client)
        conn.paused = len(conn.slots) >= MAX_PIPELINED
        if conn.sock in self._conns:
            self._register(conn, self._wanted_events(conn))

    def _drain_done(self) -> bool:
        """Move completed responses (in request order per connection)
        into write buffers; records event-loop lag.  Returns whether
        anything was pending."""
        moved = False
        while True:
            # lint-ok: loop-blocking micro critical section shared
            # with workers: both sides only append/popleft under the
            # lock, never block inside it — the hand-off IS the
            # event-loop completion design (loop lag is measured one
            # line below to catch it regressing)
            with self._done_lock:
                if not self._done:
                    break
                conn = self._done.popleft()
            moved = True
            if conn.sock in self._conns:
                self._flush_ready(conn)
        return moved

    def _flush_ready(self, conn: _Conn):
        now = time.perf_counter()
        while conn.slots and conn.slots[0].response is not None:
            slot = conn.slots.popleft()
            if slot.done_at:
                lag_ms = (now - slot.done_at) * 1000.0
                self.recent_lag_ms = lag_ms
                if self._m_lag is not None:
                    self._m_lag.update(lag_ms)
            keep = slot.keep_alive and not conn.close_after
            conn.wbuf += slot.response.encode(keep_alive=keep)
        if conn.paused and len(conn.slots) < MAX_PIPELINED:
            conn.paused = False
            self._parse_and_dispatch(conn)
        if conn.wbuf:
            self._writable(conn)       # opportunistic immediate write
        elif conn.sock in self._conns:
            self._maybe_finish(conn)

    def _writable(self, conn: _Conn):
        try:
            while conn.wbuf:
                n = conn.sock.send(conn.wbuf[:256 * 1024])
                if n <= 0:
                    break
                del conn.wbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        self._maybe_finish(conn)

    def _maybe_finish(self, conn: _Conn):
        if not conn.wbuf and not conn.slots and \
                (conn.close_after or conn.eof):
            self._close(conn)
            return
        self._register(conn, self._wanted_events(conn))

    def _close(self, conn: _Conn):
        if self._conns.pop(conn.sock, None) is None:
            return
        if conn.events:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.events = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        if self._g_conns is not None:
            self._g_conns.set(len(self._conns))
