"""Capped decorrelated-jitter backoff for the commit's CAS retry loop.

Counterpart of paimon_tpu/utils/backoff.py without request deadlines
(not ported yet): the n-th wait is drawn uniformly from
[base, 3 * previous_wait], clamped to a cap, with an optional
max-elapsed-time budget after which the caller must give up.
`wait_for` is the one sleep of the mesh compaction's retry deadlines.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["Backoff", "wait_for"]


def wait_for(seconds: float, *,
             sleep: Callable[[float], None] = time.sleep,
             what: str = "wait") -> None:
    """One library sleep.  The reference caps it to the current request
    deadline and raises once that is spent; this package has no request
    deadlines yet (request.timeout is refused), so it sleeps `seconds`.
    `what` names the wait as the reference's message does."""
    if seconds > 0:
        sleep(seconds)


class Backoff:
    """Stateful backoff schedule for ONE retry loop (not thread-safe;
    create a fresh instance per operation).

    `pause()` sleeps for the next jittered wait and returns True, or
    returns False WITHOUT sleeping once the max-elapsed budget is
    exhausted — the caller should then raise its terminal error.  A
    base of 0 keeps waits at 0 (tests) while still honoring the
    elapsed budget.
    """

    def __init__(self, base_ms: float, cap_ms: Optional[float] = None,
                 max_elapsed_ms: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.base_ms = max(0.0, float(base_ms))
        self.cap_ms = self.base_ms * 32 if cap_ms is None \
            else max(float(cap_ms), self.base_ms)
        self.max_elapsed_ms = max_elapsed_ms
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._clock = clock
        self._prev_ms: Optional[float] = None
        self._started: Optional[float] = None
        self.attempts = 0

    def next_ms(self) -> float:
        """Advance the schedule and return the next wait in millis."""
        self.attempts += 1
        if self.base_ms == 0.0:
            self._prev_ms = 0.0
            return 0.0
        if self._prev_ms is None:
            wait = self.base_ms
        else:
            wait = self._rng.uniform(self.base_ms,
                                     max(self.base_ms,
                                         3.0 * self._prev_ms))
        wait = min(wait, self.cap_ms)
        self._prev_ms = wait
        return wait

    def elapsed_ms(self) -> float:
        if self._started is None:
            return 0.0
        return (self._clock() - self._started) * 1000.0

    def budget_exhausted(self) -> bool:
        return (self.max_elapsed_ms is not None
                and self.elapsed_ms() >= self.max_elapsed_ms)

    def pause(self) -> bool:
        """Sleep for the next wait.  False (no sleep) when the
        max-elapsed budget is already spent — time to give up."""
        if self._started is None:
            self._started = self._clock()
        if self.budget_exhausted():
            return False
        wait = self.next_ms()
        if wait > 0:
            if self.max_elapsed_ms is not None:
                # never sleep past the budget's end
                wait = min(wait,
                           max(0.0, self.max_elapsed_ms
                               - self.elapsed_ms()))
            if wait > 0:
                self._sleep(wait / 1000.0)
        return True
