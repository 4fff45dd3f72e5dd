"""Low-overhead structured span tracing.

Counterpart of paimon_tpu/obs/trace.py, reduced to its spans: the
disabled path costs one flag check and returns a shared no-op context
manager; a span that names a metric group and histogram also lands its
duration there (metrics.py), with tracing on or off, unless
metrics.enabled is false; with tracing on, spans nest through a
context variable and land in a bounded ring.  The switches are
process-global and synced from a table's options at pipeline entry
(`sync_from_options`): an explicitly set key wins, an absent key
leaves the current state.  `maybe_export` writes the ring as Chrome
trace-event JSON to trace.export.path and appends new spans to a
per-process spool under trace.export.dir (`spool_flush`), whose first
line names the process and its serving replica (`set_replica_id`).
The serving plane carries a request's context across processes: the
client's hop span stamps X-Trace-Id / X-Parent-Span (`inject_headers`)
and the server adopts them around its handler (`server_span`).
obs/merge.py merges the spools of several processes into one trace.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import platform
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "TraceCollector", "span", "enable_tracing",
           "disable_tracing", "tracing_enabled", "set_metrics_enabled",
           "metrics_enabled", "collector", "take_spans",
           "sync_from_options", "maybe_export", "export_chrome_trace",
           "set_replica_id", "inject_headers", "server_span",
           "current_context_token",
           "spool_flush", "reset_spool", "set_export_dir",
           "STAGE_SERVE_REQUEST", "STAGE_CLIENT_REQUEST",
           "STAGE_PLAN_LINK", "STAGE_LEASE_FOLD", "HDR_TRACE_ID",
           "HDR_PARENT_SPAN"]

DEFAULT_BUFFER_SPANS = 8192

# the serving plane's request spans and the headers that carry a
# request's context from client to server
STAGE_SERVE_REQUEST = "serve.request"
STAGE_CLIENT_REQUEST = "client.request"
# a scan plan of a snapshot whose commit carried a trace context
# (`trace.context` in its properties): the link back to the committer
STAGE_PLAN_LINK = "plan.link"
# a lease fold (parallel/distributed.merge_lease_view) that read a peer's
# commit carrying a trace context: the link from one host to another
STAGE_LEASE_FOLD = "lease.fold"
HDR_TRACE_ID = "X-Trace-Id"
HDR_PARENT_SPAN = "X-Parent-Span"


class Span:
    """One completed timed region; `start_us` is microseconds on the
    process's perf_counter timeline (the Chrome trace ts unit)."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "start_us",
                 "dur_us", "tid", "thread", "attrs")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 cat: str, start_us: float, dur_us: float, tid: int,
                 thread: str, attrs: Dict):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.start_us = start_us
        self.dur_us = dur_us
        self.tid = tid
        self.thread = thread
        self.attrs = attrs

    def __repr__(self):
        return (f"Span({self.name!r}, {self.dur_us / 1000.0:.3f}ms, "
                f"thread={self.thread!r}, attrs={self.attrs})")


class TraceCollector:
    """Thread-safe bounded span ring; oldest spans evict first."""

    def __init__(self, max_spans: int = DEFAULT_BUFFER_SPANS):
        self.max_spans = max(1, int(max_spans))
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.max_spans)
        self.dropped = 0

    def add(self, s: Span):
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def resize(self, max_spans: int):
        max_spans = max(1, int(max_spans))
        with self._lock:
            if max_spans != self.max_spans:
                self.max_spans = max_spans
                self._spans = deque(self._spans, maxlen=max_spans)

    def __len__(self):
        with self._lock:
            return len(self._spans)


# -- process-global state ---------------------------------------------------

_enabled = False
_metrics_on = True
_collector = TraceCollector()
_export_path: Optional[str] = None
_export_dir: Optional[str] = None
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "paimon_torch_current_span", default=None)
_trace_id: contextvars.ContextVar = contextvars.ContextVar(
    "paimon_torch_trace_id", default=None)
_replica_id: Optional[str] = None
_spool_header_done = False
# spool file identity: the OS reuses pids, so a random salt follows it
_PROC = "%s-%d-%s" % (platform.node(), os.getpid(), os.urandom(3).hex())
_spool_lock = threading.Lock()
_spooled_through = 0


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


def _observe(group: str, metric: str, ms: float) -> None:
    from paimon_tpu_torch.metrics import global_registry
    global_registry().group(group).histogram(metric).update(ms)


class _MetricSpan:
    """Tracing off, metrics on: time the region into its histogram."""

    __slots__ = ("group", "metric", "t0")

    def __init__(self, group: str, metric: str):
        self.group = group
        self.metric = metric

    def set(self, **attrs):
        return self

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _observe(self.group, self.metric,
                 (time.perf_counter() - self.t0) * 1000.0)
        return False


class _LiveSpan:
    """Tracing on: a span with nesting, the ring and the histogram."""

    __slots__ = ("name", "cat", "group", "metric", "attrs", "t0",
                 "span_id", "_token")

    def __init__(self, name: str, cat: str, group: Optional[str],
                 metric: Optional[str], attrs: Dict):
        self.name = name
        self.cat = cat
        self.group = group
        self.metric = metric
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attrs mid-span (e.g. a result size known at the end)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self.span_id = next(_ids)
        self._token = _current.set(self.span_id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        t = threading.current_thread()
        _collector.add(Span(self.span_id, _current.get(), self.name,
                            self.cat, self.t0 * 1e6, (t1 - self.t0) * 1e6,
                            t.ident or 0, t.name, self.attrs))
        if self.group is not None and _metrics_on:
            _observe(self.group, self.metric, (t1 - self.t0) * 1000.0)
        return False


def span(name: str, *, cat: str = "", group: Optional[str] = None,
         metric: Optional[str] = None, **attrs):
    """Context manager timing one stage.  `group` + `metric` (a *_MS
    name of metrics.py) also land the duration in that group's
    histogram; extra kwargs become span attributes."""
    if not _enabled:
        if group is not None and _metrics_on:
            return _MetricSpan(group, metric or name)
        return _NOOP
    return _LiveSpan(name, cat, group, metric or name, attrs)


# -- cross-process context of the serving plane ------------------------------

def process_tag() -> str:
    """Stable identity of this process inside a fleet trace:
    ``<host>-<pid>-<salt>``."""
    return _PROC


def set_replica_id(replica_id: Optional[str]) -> None:
    """Name the serving replica in this process's spool header."""
    global _replica_id
    _replica_id = replica_id


def current_context_token() -> Optional[str]:
    """``<process_tag>:<span_id>`` of the current span, or None when no
    span is open or tracing is off: what a commit stamps into its
    snapshot's properties and a request into X-Parent-Span."""
    if not _enabled:
        return None
    sid = _current.get()
    if sid is None:
        return None
    return f"{_PROC}:{sid}"


def inject_headers(headers: Dict[str, str]) -> Dict[str, str]:
    """Stamp the trace id (minted on a request's first hop) and this
    span as the remote parent onto an outbound request's headers; a
    no-op unless tracing is on and a span is open."""
    if not _enabled:
        return headers
    sid = _current.get()
    if sid is None:
        return headers
    tid = _trace_id.get()
    if tid is None:
        tid = os.urandom(16).hex()
        _trace_id.set(tid)
    headers[HDR_TRACE_ID] = tid
    headers[HDR_PARENT_SPAN] = f"{_PROC}:{sid}"
    return headers


class _AdoptedSpan:
    """A server's request span that adopts the caller's context: the
    trace id rides the context variable for the handler's duration and
    the remote parent lands in the span's attrs."""

    __slots__ = ("_headers", "_attrs", "_inner", "_tid_token")

    def __init__(self, headers: Dict[str, str], attrs: Dict):
        self._headers = headers
        self._attrs = attrs

    def __enter__(self):
        tid = self._headers.get("x-trace-id")
        parent = self._headers.get("x-parent-span")
        self._tid_token = _trace_id.set(tid) if tid else None
        if tid:
            self._attrs["trace_id"] = tid
        if parent:
            self._attrs["remote_parent"] = parent
        self._inner = _LiveSpan(STAGE_SERVE_REQUEST, "serve", None, None,
                                self._attrs)
        return self._inner.__enter__()

    def __exit__(self, exc_type, exc, tb):
        out = self._inner.__exit__(exc_type, exc, tb)
        if self._tid_token is not None:
            _trace_id.reset(self._tid_token)
        return out


def server_span(headers: Optional[Dict[str, str]], **attrs):
    """Wraps one inbound request's handler (`headers` lower-cased); the
    shared no-op when tracing is off."""
    if not _enabled:
        return _NOOP
    return _AdoptedSpan(headers or {}, attrs)


# -- switches ----------------------------------------------------------------

def enable_tracing(max_spans: Optional[int] = None):
    global _enabled
    if max_spans is not None:
        _collector.resize(max_spans)
    _enabled = True


def disable_tracing():
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


def set_metrics_enabled(flag: bool):
    global _metrics_on
    _metrics_on = bool(flag)


def metrics_enabled() -> bool:
    return _metrics_on


def collector() -> TraceCollector:
    return _collector


def take_spans(clear: bool = False) -> List[Span]:
    out = _collector.snapshot()
    if clear:
        _collector.clear()
    return out


def sync_from_options(options) -> None:
    """Sync the process-global switches from a table's CoreOptions at a
    pipeline entry point: explicitly set keys win, absent keys leave
    the current state."""
    global _export_path
    raw = getattr(options, "options", None)
    if raw is None:
        return
    from paimon_tpu_torch.options import CoreOptions
    if raw.contains(CoreOptions.TRACE_ENABLED):
        if raw.get(CoreOptions.TRACE_ENABLED):
            # only an explicit ring size resizes: the default must not
            # shrink a ring a caller enlarged (resizing drops spans)
            enable_tracing(raw.get(CoreOptions.TRACE_BUFFER_SPANS)
                           if raw.contains(CoreOptions.TRACE_BUFFER_SPANS)
                           else None)
        else:
            disable_tracing()
    if raw.contains(CoreOptions.METRICS_ENABLED):
        set_metrics_enabled(bool(raw.get(CoreOptions.METRICS_ENABLED)))
    if raw.contains(CoreOptions.TRACE_EXPORT_PATH):
        _export_path = raw.get(CoreOptions.TRACE_EXPORT_PATH)
    if raw.contains(CoreOptions.TRACE_EXPORT_DIR):
        set_export_dir(raw.get(CoreOptions.TRACE_EXPORT_DIR))


# -- export ----------------------------------------------------------------

def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def export_chrome_trace(path: str, spans=None) -> str:
    """Write the ring (or `spans`) as Chrome trace-event JSON: every
    span a complete ("X") event on its thread's track."""
    if spans is None:
        spans = take_spans()
    events: List[Dict] = []
    tracks: Dict[tuple, int] = {}
    for s in spans:
        tid = tracks.setdefault((s.thread, s.tid), len(tracks) + 1)
        events.append({"name": s.name, "cat": s.cat or "span", "ph": "X",
                       "ts": round(s.start_us, 3),
                       "dur": round(max(s.dur_us, 0.001), 3), "pid": 1,
                       "tid": tid,
                       "args": {k: _jsonable(v)
                                for k, v in s.attrs.items()}})
    for (name, _), tid in tracks.items():
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": name}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def spool_flush() -> Optional[str]:
    """Append spans newer than the last flush to
    `<trace.export.dir>/<process tag>.jsonl`, after a first line naming
    the process, its replica and a (wall clock, perf_counter) anchor
    that obs/merge.py rebases each process's spans by; returns the
    spool's path, or None without an export dir.  The stream daemon
    calls it when a loop dies for good, on kill and on SIGTERM, the
    crash hooks on an uncaught exception and at exit.  A failed write
    warns instead of raising."""
    global _spooled_through, _spool_header_done
    if _export_dir is None:
        return None
    path = os.path.join(_export_dir, _PROC + ".jsonl")
    with _spool_lock:
        fresh = [s for s in _collector.snapshot()
                 if s.span_id > _spooled_through]
        try:
            os.makedirs(_export_dir, exist_ok=True)
            with open(path, "a") as f:
                if not _spool_header_done:
                    f.write(json.dumps({
                        "proc": _PROC, "pid": os.getpid(),
                        "host": platform.node(), "replica": _replica_id,
                        "wall_s": time.time(),
                        "perf_s": time.perf_counter()}) + "\n")
                    _spool_header_done = True
                for s in fresh:
                    f.write(json.dumps({
                        "sid": s.span_id, "parent": s.parent_id,
                        "name": s.name, "cat": s.cat,
                        "ts": round(s.start_us, 3),
                        "dur": round(s.dur_us, 3),
                        "tid": s.tid, "thread": s.thread,
                        "attrs": {k: _jsonable(v)
                                  for k, v in s.attrs.items()}}) + "\n")
        except OSError as e:
            warnings.warn(f"trace spool to {path!r} failed: {e}",
                          RuntimeWarning)
            return None
        if fresh:
            _spooled_through = max(_spooled_through,
                                   max(s.span_id for s in fresh))
    return path


def reset_spool() -> None:
    """Forget the spool's state: the next flush writes the first line
    again and spools the whole ring."""
    global _spooled_through, _spool_header_done
    with _spool_lock:
        _spooled_through = 0
        _spool_header_done = False


def set_export_dir(d: Optional[str]) -> None:
    """Spool under `d` (None: no spool); a new directory starts a new
    spool file."""
    global _export_dir
    if d != _export_dir:
        _export_dir = d
        reset_spool()


def maybe_export() -> Optional[str]:
    """At a pipeline completion point, with tracing on: spool new spans
    under trace.export.dir and write the ring to trace.export.path;
    returns the path written, or None.  A failed write warns instead of
    raising: tracing must never fail the data path it observes."""
    if not _enabled:
        return None
    if _export_dir is not None:
        spool_flush()
    if _export_path is None:
        return None
    try:
        return export_chrome_trace(_export_path)
    except OSError as e:
        warnings.warn(f"trace export failed: {e}", RuntimeWarning)
        return None
