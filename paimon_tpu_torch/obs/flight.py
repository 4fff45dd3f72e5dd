"""Flight recorder: an always-on bounded ring of operationally
interesting events: retry ladder arms (parallel/fault.py), brownout
rung changes and 429 / 504 answers (service/brownout.py).

Counterpart of paimon_tpu/obs/flight.py, reduced to the ring, those
event kinds and `sync_from_options` (obs.flight.enabled and
obs.flight.events); dumps and crash hooks (obs.flight.dump.dir, which
the query service refuses) are not ported yet (ROADMAP.md A.7b).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List

__all__ = ["FlightRecorder", "recorder", "record", "sync_from_options",
           "EV_RETRY", "EV_BROWNOUT", "EV_HTTP_429", "EV_HTTP_504"]

DEFAULT_EVENTS = 512

EV_RETRY = "retry"
EV_BROWNOUT = "brownout"
EV_HTTP_429 = "http.429"
EV_HTTP_504 = "http.504"


class FlightRecorder:
    """Thread-safe bounded event ring."""

    def __init__(self, max_events: int = DEFAULT_EVENTS):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, int(max_events)))
        self._seq = 0
        self.enabled = True
        self.dropped = 0

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ev = {"kind": kind, "t": time.time(), **fields}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def resize(self, max_events: int) -> None:
        with self._lock:
            self._events = deque(self._events,
                                 maxlen=max(1, int(max_events)))

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **fields) -> None:
    """One call at every feed site."""
    _recorder.record(kind, **fields)


def sync_from_options(options) -> None:
    """Sync the recorder from a table's CoreOptions at a serving entry
    point: explicitly set keys win, absent keys leave the current
    state."""
    raw = getattr(options, "options", None)
    if raw is None:
        return
    from paimon_tpu_torch.options import CoreOptions
    if raw.contains(CoreOptions.OBS_FLIGHT_ENABLED):
        _recorder.enabled = bool(raw.get(CoreOptions.OBS_FLIGHT_ENABLED))
    if raw.contains(CoreOptions.OBS_FLIGHT_EVENTS):
        _recorder.resize(raw.get(CoreOptions.OBS_FLIGHT_EVENTS))
