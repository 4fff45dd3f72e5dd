"""Capped decorrelated-jitter backoff, shared by every retry loop.

Counterpart of paimon_tpu/utils/backoff.py: the n-th wait is drawn
uniformly from [base, 3 * previous_wait], clamped to a cap, with an
optional max-elapsed-time budget after which the caller must give up.
Users: the commit's CAS retry, the mesh compaction's retry ladder, and
the read and write retry ladders (parallel/scan_pipeline.py,
parallel/write_pipeline.py).

Every wait is deadline-aware (utils/deadline.py): when the calling
request carries a deadline, `pause()` never sleeps past its remaining
budget and raises DeadlineExceededError once it is spent; `wait_for()`
is the same contract for one-shot waits.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["Backoff", "wait_for"]


def wait_for(seconds: float, *,
             sleep: Callable[[float], None] = time.sleep,
             what: str = "wait") -> None:
    """One deadline-aware sleep: caps the wait to the current deadline's
    remaining budget and raises DeadlineExceededError when that budget
    is already spent.  `what` names the wait in the error."""
    from paimon_tpu_torch.utils.deadline import current_deadline
    dl = current_deadline()
    if dl is not None:
        dl.check(what)
        seconds = min(seconds, dl.remaining_s())
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
        max-elapsed budget is already spent — time to give up.  When the
        calling request carries a deadline, the wait is capped to its
        remaining budget and a spent deadline raises
        DeadlineExceededError."""
        if self._started is None:
            self._started = self._clock()
        if self.budget_exhausted():
            return False
        from paimon_tpu_torch.utils.deadline import current_deadline
        dl = current_deadline()
        if dl is not None:
            dl.check("retry backoff")
        wait = self.next_ms()
        if wait > 0:
            if self.max_elapsed_ms is not None:
                # never sleep past the budget's end
                wait = min(wait,
                           max(0.0, self.max_elapsed_ms
                               - self.elapsed_ms()))
            if dl is not None:
                wait = min(wait, dl.remaining_ms())
            if wait > 0:
                self._sleep(wait / 1000.0)
        return True
