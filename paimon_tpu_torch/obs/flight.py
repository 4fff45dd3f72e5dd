"""Black-box flight recorder: an always-on bounded ring of the
operationally interesting events, the ones an operator wants to see from
the minutes before a crash: retry ladder arms (parallel/fault.py),
circuit-breaker flips (fs/resilience.py), brownout rung moves and 429 / 504 answers (service/brownout.py), CAS
conflicts (core/commit.py), lease expiries, takeovers and rejoin grants
(parallel/maintenance_plane.py), loop crashes and SIGTERM / SIGINT
(service/stream_daemon.py) and uncaught exceptions (the crash hooks
below).

Counterpart of paimon_tpu/obs/flight.py with those event kinds.
Recording is one dict append under a leaf lock and is on by default.
Dumps are atomic (tmp + ``os.replace``) JSON, field for field the
reference's, written on demand, from the crash hooks (excepthook and
atexit, installed when obs.flight.dump.dir is set) and from the stream
daemon's signal handler and terminal loop crashes.
"""

from __future__ import annotations

import atexit
import json
import os
import platform
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "FlightRecorder", "recorder", "record", "dump", "install_crash_hooks",
    "self_dump_dir", "sync_from_options",
    "EV_RETRY", "EV_BREAKER", "EV_BROWNOUT", "EV_HTTP_429", "EV_HTTP_504",
    "EV_COMMIT_CONFLICT", "EV_LEASE_EXPIRED", "EV_TAKEOVER",
    "EV_REJOIN_GRANT", "EV_LOOP_CRASH", "EV_SIGTERM", "EV_CRASH",
]

DEFAULT_EVENTS = 512

EV_RETRY = "retry"
EV_BREAKER = "breaker"
EV_BROWNOUT = "brownout"
EV_HTTP_429 = "http.429"
EV_HTTP_504 = "http.504"
EV_COMMIT_CONFLICT = "commit.conflict"
EV_LEASE_EXPIRED = "lease.expired"
EV_TAKEOVER = "takeover"
EV_REJOIN_GRANT = "rejoin.grant"
EV_LOOP_CRASH = "loop.crash"
EV_SIGTERM = "sigterm"
EV_CRASH = "crash"


class FlightRecorder:
    """Thread-safe bounded event ring with atomic JSON dumps."""

    def __init__(self, max_events: int = DEFAULT_EVENTS):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, int(max_events)))
        self._seq = 0
        self.enabled = True
        self.dump_dir: Optional[str] = None
        self.dropped = 0

    @property
    def max_events(self) -> int:
        return self._events.maxlen or 0

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ev = {"kind": kind, "t": time.time()}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def resize(self, max_events: int) -> None:
        max_events = max(1, int(max_events))
        with self._lock:
            if max_events != self._events.maxlen:
                self._events = deque(self._events, maxlen=max_events)

    def dump(self, trigger: Optional[Dict] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Write the ring (plus an optional trigger record) to `path`,
        or to an auto-named file under `dump_dir`.  Atomic: readers
        never see a torn file, and a dump racing a crash either fully
        lands or leaves the previous one.  Returns the path, or None
        when there is nowhere to write / the write failed (a recorder
        failure must never mask the crash it is recording)."""
        if path is None:
            if self.dump_dir is None:
                return None
            fname = "flight-%s-%d-%d.json" % (
                platform.node(), os.getpid(),
                int(time.time() * 1000))
            path = os.path.join(self.dump_dir, fname)
        doc = {
            "pid": os.getpid(),
            "host": platform.node(),
            "created_s": time.time(),
            "dropped": self.dropped,
            "trigger": trigger,
            "events": self.snapshot(),
        }
        tmp = path + ".tmp"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        return path


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **fields) -> None:
    """Module-level convenience: one call at every feed site."""
    _recorder.record(kind, **fields)


def dump(trigger: Optional[Dict] = None,
         path: Optional[str] = None) -> Optional[str]:
    return _recorder.dump(trigger, path)


# -- crash hooks -------------------------------------------------------------

_hooks_installed = False


def install_crash_hooks() -> None:
    """Chain onto sys.excepthook and atexit so an uncaught exception
    (or plain process exit with a dump dir configured) flushes the
    ring to disk — and the trace spool with it, so the merged fleet
    timeline includes the crashed process's last spans.  Idempotent;
    only dumps when `dump_dir` is set (a CLI one-shot without the
    option must not spray files)."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            record(EV_CRASH, error=exc_type.__name__, message=str(exc))
            _recorder.dump(trigger={"kind": EV_CRASH,
                                    "error": exc_type.__name__,
                                    "message": str(exc)})
            from paimon_tpu_torch.obs.trace import spool_flush
            spool_flush()
        except Exception:   # lint-ok: swallow a failing black-box dump must never mask the original crash being re-raised to prev_hook
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook

    def _at_exit():
        try:
            if self_dump_dir():
                _recorder.dump(trigger={"kind": "atexit"})
            from paimon_tpu_torch.obs.trace import spool_flush
            spool_flush()
        except Exception:   # lint-ok: swallow best-effort flush during interpreter teardown; raising here aborts other atexit handlers
            pass

    atexit.register(_at_exit)


def self_dump_dir() -> Optional[str]:
    return _recorder.dump_dir


def sync_from_options(options) -> None:
    """Sync the recorder from a table's options at a pipeline entry
    point — same explicit-key-wins contract as the trace switches."""
    if options is None:
        return
    raw = getattr(options, "options", None)
    if raw is None or not hasattr(raw, "contains"):
        return
    from paimon_tpu_torch.options import CoreOptions
    if raw.contains(CoreOptions.OBS_FLIGHT_ENABLED):
        _recorder.enabled = bool(raw.get(CoreOptions.OBS_FLIGHT_ENABLED))
    if raw.contains(CoreOptions.OBS_FLIGHT_EVENTS):
        _recorder.resize(raw.get(CoreOptions.OBS_FLIGHT_EVENTS))
    if raw.contains(CoreOptions.OBS_FLIGHT_DUMP_DIR):
        _recorder.dump_dir = raw.get(CoreOptions.OBS_FLIGHT_DUMP_DIR)
        if _recorder.dump_dir:
            install_crash_hooks()
