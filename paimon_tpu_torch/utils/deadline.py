"""End-to-end request deadlines, carried by a context variable.

Counterpart of paimon_tpu/utils/deadline.py.  A `Deadline` is created
once at a request entry point (the query service's /lookup, /scan and
/changelog, from service.request.timeout or the client's timeout_ms;
the table's reads, plans and commits, from request.timeout) and
consulted by the blocking waits downstream: retry-ladder sleeps
(utils/backoff.py), the admission queue (service/admission.py), the
scan and write pipelines' byte-budget blocks, the lookup store's wait
on an in-flight SST build (lookup/local_query.py), `wait_future`, and
store IO (fs/object_store.py checks before each read; the resilient
backend of fs/resilience.py abandons a hung call).  An exceeded
deadline raises `DeadlineExceededError` (HTTP 504 at the service); it
is not an OSError, so the fault taxonomy (parallel/fault.py) never
retries it, and a commit checks it before the snapshot CAS, so a
timed-out request is never orphan-committed.  Pools made by
parallel/executors.new_thread_pool carry the submitter's deadline into
each task (`run_with_deadline`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Optional

__all__ = ["Deadline", "DeadlineExceededError", "current_deadline",
           "deadline_scope", "deadline_shield", "check_deadline",
           "remaining_ms", "run_with_deadline", "wait_future"]


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end deadline passed.  Never retried (the
    fault taxonomy excludes it explicitly), never eligible for the
    corrupt-file skip, mapped to HTTP 504 by the query service."""

    status = 504


class Deadline:
    """A fixed point in (monotonic) time a request must finish by.

    Immutable; `clock` is injectable for tests.  Created via
    `deadline_scope(timeout_ms)` at request entry, read via
    `current_deadline()` anywhere downstream.
    """

    __slots__ = ("timeout_ms", "_expires", "_clock")

    def __init__(self, timeout_ms: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_ms = float(timeout_ms)
        self._clock = clock
        self._expires = clock() + self.timeout_ms / 1000.0

    def remaining_ms(self) -> float:
        """Milliseconds left; <= 0 once exceeded."""
        return (self._expires - self._clock()) * 1000.0

    def remaining_s(self) -> float:
        return max(0.0, self.remaining_ms() / 1000.0)

    def exceeded(self) -> bool:
        return self.remaining_ms() <= 0.0

    def check(self, what: str = "request"):
        """Raise DeadlineExceededError when the deadline has passed."""
        rem = self.remaining_ms()
        if rem <= 0.0:
            raise DeadlineExceededError(
                f"{what}: deadline of {self.timeout_ms:.0f}ms exceeded "
                f"({-rem:.0f}ms over)")

    def __repr__(self):
        return (f"Deadline(timeout_ms={self.timeout_ms:.0f}, "
                f"remaining_ms={self.remaining_ms():.0f})")


_CURRENT: ContextVar[Optional[Deadline]] = ContextVar(
    "paimon_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    return _CURRENT.get()


def remaining_ms() -> Optional[float]:
    """Remaining budget of the current deadline, or None when no
    deadline is in scope (callers then use their own timeouts)."""
    dl = _CURRENT.get()
    return None if dl is None else dl.remaining_ms()


def check_deadline(what: str = "request"):
    """Raise DeadlineExceededError iff a deadline is in scope and
    spent — THE check every blocking wait loop calls."""
    dl = _CURRENT.get()
    if dl is not None:
        dl.check(what)


@contextmanager
def deadline_scope(timeout_ms: Optional[float] = None, *,
                   deadline: Optional[Deadline] = None,
                   entry: bool = False,
                   clock: Callable[[], float] = time.monotonic):
    """Install a deadline for the enclosed work.

    * `timeout_ms=None` (and no `deadline`) yields without installing
      anything — callers thread their option value straight through.
    * `entry=True` marks a request ENTRY point: an already-current
      deadline wins (a table read inside a service request must not
      extend or shorten the request's budget), and the scope counts
      one `deadline_exceeded` metric when its own deadline trips.
    """
    if deadline is None and timeout_ms is None:
        yield None
        return
    if entry and _CURRENT.get() is not None:
        yield _CURRENT.get()
        return
    dl = deadline if deadline is not None \
        else Deadline(timeout_ms, clock=clock)
    token = _CURRENT.set(dl)
    try:
        yield dl
    except DeadlineExceededError:
        from paimon_tpu_torch.metrics import (
            RESILIENCE_DEADLINE_EXCEEDED, global_registry,
        )
        global_registry().resilience_metrics().counter(
            RESILIENCE_DEADLINE_EXCEEDED).inc()
        raise
    finally:
        _CURRENT.reset(token)


@contextmanager
def deadline_shield():
    """Temporarily clear the current deadline for ABORT/CLEANUP work.

    Cleanup runs exactly when the deadline is already spent — the
    commit's deadline-abort path deleting its attempt's manifests,
    `delete_quietly` dropping a staged file.  Without the shield,
    every store op inside that cleanup would raise
    DeadlineExceededError (usually swallowed by the best-effort
    handler), turning the cleanup into a silent no-op that orphans
    exactly what it was supposed to remove."""
    token = _CURRENT.set(None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def wait_future(fut, what: str = "future", poll_s: float = 0.5):
    """Deadline-bounded `Future.result()` — THE sanctioned wait for an
    executor future (the tier-1 deadline-wait rule bans a bare
    `.result()` outside this module).

    With no deadline in scope it is exactly `fut.result()` (callers
    without a request budget wait as long as the work takes, their own
    contract).  With a deadline, the wait polls in `poll_s` slices
    capped to the remaining budget and raises DeadlineExceededError
    the moment the budget is spent — a hung worker can no longer hold
    a timed-out request (the worker itself keeps running and its
    result is discarded, same abandonment contract as the scan
    pipeline's hung-split path)."""
    dl = _CURRENT.get()
    if dl is None:
        return fut.result()
    import concurrent.futures as _cf
    while True:
        dl.check(what)
        try:
            return fut.result(timeout=min(poll_s, dl.remaining_s()))
        except _cf.TimeoutError:
            if fut.done():
                # the future completed in the window between the wait
                # timing out and this check (or the worker itself
                # raised) — a done future answers instantly with the
                # WORKER's outcome; re-raising the poll's TimeoutError
                # here would turn a successful result into a crash
                return fut.result()
            continue


def run_with_deadline(dl: Optional[Deadline], fn: Callable, /,
                      *args, **kwargs):
    """Run `fn` with `dl` installed as the current deadline — the
    thread-pool propagation shim (`parallel/executors.py` wraps
    submissions with the submitter's deadline so worker-side waits and
    retry ladders stay bounded by the request that queued them)."""
    if dl is None:
        return fn(*args, **kwargs)
    token = _CURRENT.set(dl)
    try:
        return fn(*args, **kwargs)
    finally:
        _CURRENT.reset(token)
