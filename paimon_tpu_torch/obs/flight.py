"""Flight recorder: an always-on bounded ring of operationally
interesting events (retry ladder arms, among the reference's others).

Counterpart of paimon_tpu/obs/flight.py, reduced to the ring and its
EV_RETRY feed (parallel/fault.py); dumps, crash hooks and the other
event kinds are not ported yet (ROADMAP.md A.7).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List

__all__ = ["FlightRecorder", "recorder", "record", "EV_RETRY"]

DEFAULT_EVENTS = 512

EV_RETRY = "retry"


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
