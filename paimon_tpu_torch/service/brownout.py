"""Brownout: graceful degradation for the query-serving plane.

Counterpart of paimon_tpu/service/brownout.py.  Under pressure the
controller climbs a small, observable ladder instead of failing all
traffic:

    rung 0  normal
    rung 1  degrade   the process is marked degraded (fs/resilience.py):
                      hedged reads stop and scans stop prefetching past
                      their workers
    rung 2  shed      rung 1 + requests below service.brownout.shed-
                      priority answer HTTP 429 at once

The rung is the count of firing signals, capped at 2: any circuit
breaker of a resilient store backend open, admission-queue pressure,
and the recent rate of 429 and 504 answers.  A rung holds
service.brownout.hold-ms before it may step down.  Everything shows on
/healthz and in the `resilience` metric group.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict

from paimon_tpu_torch.options import CoreOptions

__all__ = ["BrownoutController", "RateWindow"]


class RateWindow:
    """Events-per-second over a trailing window (injectable clock);
    O(1) amortized — old timestamps evict on record/rate."""

    def __init__(self, window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._events: deque = deque()
        self._lock = threading.Lock()

    def record(self):
        now = self._clock()
        with self._lock:
            self._events.append(now)
            self._trim(now)

    def _trim(self, now: float):
        horizon = now - self.window_s
        while self._events and self._events[0] < horizon:
            self._events.popleft()

    def rate_per_s(self) -> float:
        now = self._clock()
        with self._lock:
            self._trim(now)
            return len(self._events) / self.window_s


class BrownoutController:
    """One per KvQueryServer; owns the process 'degraded' switch and
    the admission shed threshold while active."""

    # recent 429+504 rate that counts as a pressure signal (per
    # second over the trailing window; saturation shows up here long
    # before averages move)
    FAILURE_RATE_PER_S = 1.0

    def __init__(self, admission, options: CoreOptions, *,
                 clock: Callable[[], float] = time.monotonic):
        self.admission = admission
        self.enabled = options.get(CoreOptions.SERVICE_BROWNOUT_ENABLED)
        self.queue_ratio = options.get(
            CoreOptions.SERVICE_BROWNOUT_QUEUE_RATIO)
        self.shed_priority = options.get(
            CoreOptions.SERVICE_BROWNOUT_SHED_PRIORITY)
        self.hold_ms = options.get(CoreOptions.SERVICE_BROWNOUT_HOLD_MS)
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._held_until = 0.0
        self.rejected = RateWindow(clock=clock)     # 429s
        self.timeouts = RateWindow(clock=clock)     # 504s
        from paimon_tpu_torch.metrics import (
            RESILIENCE_BROWNOUT_LEVEL, global_registry,
        )
        self._g_level = global_registry().resilience_metrics() \
            .gauge(RESILIENCE_BROWNOUT_LEVEL)
        self._g_level.set(0)

    @property
    def level(self) -> int:
        return self._level

    def record_outcome(self, status: int):
        """Feed one finished request's HTTP status into the failure-
        rate signal (called by the server for every response)."""
        if status == 429:
            self.rejected.record()
            from paimon_tpu_torch.obs.flight import EV_HTTP_429, record
            record(EV_HTTP_429)
        elif status == 504:
            self.timeouts.record()
            from paimon_tpu_torch.obs.flight import EV_HTTP_504, record
            record(EV_HTTP_504)

    def signals(self) -> Dict[str, object]:
        """The three pressure signals, as /healthz reports them."""
        from paimon_tpu_torch.fs.resilience import breaker_states
        states = breaker_states()
        depth = self.admission.queued
        cap = max(1, self.admission.queue_depth)
        fail_rate = self.rejected.rate_per_s() + \
            self.timeouts.rate_per_s()
        return {
            "breakers_open": any(s != "closed" for s in states.values()),
            "breaker_states": states,
            "queue_ratio": depth / cap,
            "queue_pressure": depth / cap >= self.queue_ratio,
            "failure_rate_per_s": fail_rate,
            "failure_pressure": fail_rate >= self.FAILURE_RATE_PER_S,
        }

    def observe(self) -> int:
        """Recompute the rung and apply its actions; returns the
        level.  Cheap enough to call per request."""
        if not self.enabled:
            return 0
        sig = self.signals()
        target = min(2, int(sig["breakers_open"])
                     + int(sig["queue_pressure"])
                     + int(sig["failure_pressure"]))
        with self._lock:
            now = self._clock()
            if target > self._level:
                self._apply_locked(target, now)
            elif target < self._level and now >= self._held_until:
                self._apply_locked(target, now)
            return self._level

    def _apply_locked(self, level: int, now: float):
        from paimon_tpu_torch.fs.resilience import set_degraded_for
        from paimon_tpu_torch.obs.flight import EV_BROWNOUT, record
        if level != self._level:
            # flight-recorder: rung transitions are exactly the
            # "what changed right before it broke" an operator wants
            record(EV_BROWNOUT, frm=self._level, to=level)
        self._level = level
        self._held_until = now + self.hold_ms / 1000.0
        self._g_level.set(level)
        # per-SOURCE: several servers in one process each vote; the
        # process degrades while any of them is browned out
        set_degraded_for(self, level >= 1)
        self.admission.set_shed_below(
            self.shed_priority if level >= 2 else 0)

    def reset(self):
        """Restore rung 0 unconditionally (server shutdown: the
        process-wide degraded switch must not outlive the server that
        set it)."""
        with self._lock:
            self._apply_locked(0, self._clock())
            self._held_until = 0.0

    def healthz(self) -> Dict[str, object]:
        """The /healthz body: brownout rung, signals, admission
        pressure and hedging state in one place."""
        sig = self.signals()
        return {
            "status": "ok" if self._level == 0 else "brownout",
            "brownout_level": self._level,
            "breakers": sig["breaker_states"],
            "queue_depth": self.admission.queued,
            "queue_capacity": self.admission.queue_depth,
            "inflight_bytes": self.admission.inflight_bytes,
            "recent_429_per_s": self.rejected.rate_per_s(),
            "recent_504_per_s": self.timeouts.rate_per_s(),
            "hedging_enabled": _hedging_on(),
            "shedding_below_priority":
                self.shed_priority if self._level >= 2 else None,
        }


def _hedging_on() -> bool:
    from paimon_tpu_torch.fs.resilience import hedging_allowed
    return hedging_allowed()
