"""Replayable CDC event sources with dense integer offsets.

The stream daemon (service/stream_daemon.py) checkpoints the offset of
the last event it committed, atomically with the snapshot; recovery
re-polls the source from that offset.  That only works when the source
can replay: `poll(after_offset, max_events)` must return the SAME
events for the same offsets on every call (a Kafka-like contract —
offsets are dense 0-based positions here).

Two implementations:

- `MemoryCdcSource` — an appendable in-memory log (tests, the soak
  harness, embedding);
- `FileCdcSource` — tails a JSONL file of CDC envelopes, offset = line
  number (the CLI `paimon table stream --source events.jsonl`).  The
  file is append-only; new lines become new events on the next poll.

Counterpart of paimon_tpu/cdc/source.py; host-only.
"""

from __future__ import annotations

import json
import threading
from itertools import repeat
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["MemoryCdcSource", "FileCdcSource"]

Polled = List[Tuple[int, Dict]]

# the C scanner json.loads runs: (value, end) of the JSON value at an
# index of a str, without json.loads' check that nothing follows it
_SCAN = json.JSONDecoder().scan_once


class MemoryCdcSource:
    """Thread-safe appendable event log; offset = position."""

    def __init__(self, events=None):
        self._events: List[Dict] = list(events or [])
        self._lock = threading.Lock()

    def append(self, *events: Dict) -> int:
        """Append events; returns the offset of the last one."""
        with self._lock:
            self._events.extend(events)
            return len(self._events) - 1

    def poll(self, after_offset: int, max_events: int) -> Polled:
        with self._lock:
            start = after_offset + 1
            chunk = self._events[start:start + max(0, max_events)]
        return [(start + i, e) for i, e in enumerate(chunk)]

    def backlog(self, after_offset: int) -> int:
        with self._lock:
            return max(0, len(self._events) - (after_offset + 1))

    def latest_offset(self) -> int:
        with self._lock:
            return len(self._events) - 1


class FileCdcSource:
    """JSONL file tail: one CDC envelope per line, offset = line index.

    Lines read so far are cached so recovery replays without re-reading
    the whole file; an incomplete trailing line (a writer mid-append)
    is left in the buffer until its newline arrives.  A line is parsed
    when a poll first returns it, so a line that is not JSON raises
    from that poll, and every later one, instead of from the read.

    Memory is bounded for long-running daemons: `commit_through(off)`
    (called by the stream daemon after each checkpoint) evicts cached
    events at/below the durably committed offset — replay only ever
    needs offsets past the last checkpoint, and a NEW process re-reads
    the file from scratch anyway.
    """

    def __init__(self, path: str):
        self.path = path
        # each line read so far: its bytes until a poll first returns
        # it, then its parsed event (lines evicted unpolled are never
        # parsed: a new process skips its committed prefix cheaply)
        self._events: List = []
        self._base = 0              # offset of self._events[0]
        self._pos = 0               # byte offset of the next unread line
        self._tail = b""            # incomplete trailing line
        self._lock = threading.Lock()

    def _refill(self):
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except FileNotFoundError:
            return
        if not data:
            return
        self._pos += len(data)
        buf = self._tail + data
        lines = buf.split(b"\n")
        self._tail = lines.pop()
        self._events.extend(line for line in map(bytes.strip, lines)
                            if line)

    def _parse(self, i0: int, i1: int) -> None:
        """Parse the unparsed lines of self._events[i0:i1] in place: one
        decode of all of them and one scan a line, each of which must end
        exactly where its line ends, or, where any does not, line by line
        up to the line that raises (the reference's json.loads a line)."""
        todo = [i for i in range(i0, i1)
                if isinstance(self._events[i], bytes)]
        if not todo:
            return
        try:
            text = b"\n".join(self._events[i] for i in todo).decode()
            lens = np.fromiter(map(len, text.split("\n")), np.int64,
                               len(todo))
            ends = np.cumsum(lens + 1) - 1
            scanned = list(map(_SCAN, repeat(text), (ends - lens).tolist()))
            if [stop for _, stop in scanned] != ends.tolist():
                raise ValueError("a line is not one JSON value")
            parsed = [event for event, _ in scanned]
        except (ValueError, StopIteration):
            for i in todo:
                self._events[i] = json.loads(self._events[i])
            return
        for i, event in zip(todo, parsed):
            self._events[i] = event

    def commit_through(self, offset: int):
        """Evict cached events at/below the durably committed offset."""
        with self._lock:
            drop = min(max(0, offset + 1 - self._base),
                       len(self._events))
            if drop:
                del self._events[:drop]
                self._base += drop

    def poll(self, after_offset: int, max_events: int) -> Polled:
        with self._lock:
            self._refill()
            start = max(after_offset + 1, self._base)
            i0 = start - self._base
            i1 = min(len(self._events), i0 + max(0, max_events))
            self._parse(i0, i1)
            chunk = self._events[i0:i1]
        return [(start + i, e) for i, e in enumerate(chunk)]

    def backlog(self, after_offset: int) -> int:
        with self._lock:
            self._refill()
            return max(0, self._base + len(self._events)
                       - (after_offset + 1))

    def latest_offset(self) -> int:
        with self._lock:
            self._refill()
            return self._base + len(self._events) - 1
