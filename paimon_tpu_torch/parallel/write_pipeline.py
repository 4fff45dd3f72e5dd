"""Pipelined write flush executor.

Counterpart of paimon_tpu/parallel/write_pipeline.py without flush
retries and upload staging (not ported yet): a bounded pool that
overlaps bucket k's merge+encode+write with bucket k+1's and with the
incoming batch's hash/group-by on the caller thread.

* **per-bucket ordering**: tasks for the same (partition, bucket) run
  strictly in submission order through a per-key "actor" queue, so
  file metas publish deterministically; tasks for different keys run
  on up to `write.flush.parallelism` workers;
* **byte budget**: `submit` blocks the producer while the estimated
  buffered bytes in flight exceed `write.flush.max-bytes`, always
  admitting at least one task;
* **errors**: the first task error is latched and re-raised at the
  `drain()` barrier with all still-queued tasks cancelled — a flush is
  never silently dropped;
* **serial path**: parallelism 1 runs every task inline.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Callable, Dict, Optional

from paimon_tpu_torch.options import CoreOptions

__all__ = ["FlushPool", "lpt_order", "resolve_flush_parallelism"]


def lpt_order(groups):
    """Largest (partition,bucket) group first (row count stands in for
    bytes): the skewed bucket's flush starts first instead of trailing
    as the long tail.  Stable sort: equal sizes keep grouping order."""
    return sorted(groups, key=lambda g: -len(g[1]))


def resolve_flush_parallelism(options: Optional[CoreOptions]) -> int:
    """Worker threads for the pipelined write: write.flush.parallelism,
    defaulting to min(8, cpu count).  1 means the serial inline path."""
    par = None
    if options is not None:
        par = options.get(CoreOptions.WRITE_FLUSH_PARALLELISM)
    if par is None:
        par = min(8, os.cpu_count() or 1)
    return max(1, int(par))


class FlushPool:
    """Per-bucket actor queues over one shared worker pool.

    `drain()` is the prepare-commit barrier: it waits for every
    admitted task and re-raises the first task error with the remaining
    queued tasks cancelled and the pool poisoned (the cancelled
    payloads are gone, so the owning writer must be closed and
    replaced).  `shutdown()` joins the workers."""

    def __init__(self, parallelism: int, max_bytes: int):
        self.parallelism = max(1, int(parallelism))
        self.max_bytes = max(1, int(max_bytes))
        self._cond = threading.Condition(threading.Lock())
        self._queues: Dict[object, deque] = {}
        self._active: set = set()
        self._inflight_bytes = 0
        self._inflight_tasks = 0
        self._error: Optional[BaseException] = None
        self._poisoned: Optional[BaseException] = None
        self._pool = None
        self._shut = False

    @classmethod
    def from_options(cls, options: CoreOptions) -> "FlushPool":
        return cls(resolve_flush_parallelism(options),
                   options.get(CoreOptions.WRITE_FLUSH_MAX_BYTES))

    @property
    def serial(self) -> bool:
        return self.parallelism <= 1

    def submit(self, key, est_bytes: int, fn: Callable[[], None]):
        """Admit one flush task for `key`.  Serial pools run it inline."""
        if self.serial:
            fn()
            return
        est_bytes = max(1, int(est_bytes))
        with self._cond:
            self._check_poisoned()
            if self._error is not None:
                raise self._error
            while self._inflight_tasks > 0 and \
                    self._inflight_bytes + est_bytes > self.max_bytes:
                self._cond.wait()
                if self._error is not None:
                    raise self._error
            self._inflight_bytes += est_bytes
            self._inflight_tasks += 1
            self._queues.setdefault(key, deque()).append((est_bytes, fn))
            if key not in self._active:
                self._active.add(key)
                self._ensure_pool().submit(self._drain_key, key)

    def drain(self):
        """Barrier: wait for every admitted task; re-raise the first
        task error with the remaining queued tasks cancelled."""
        if self.serial:
            return
        with self._cond:
            self._check_poisoned()
            while self._inflight_tasks > 0 and self._error is None:
                self._cond.wait()
            if self._error is not None:
                self._cancel_queued()
                while self._inflight_tasks > 0:
                    self._cond.wait()
                err, self._error = self._error, None
                self._poisoned = err
                raise err

    def _cancel_queued(self):
        for q in self._queues.values():
            while q:
                est, _ = q.popleft()
                self._inflight_bytes -= est
                self._inflight_tasks -= 1

    def _check_poisoned(self):
        if self._poisoned is not None:
            raise RuntimeError(
                "write pipeline failed earlier and in-flight flushes "
                "were cancelled; close this writer and retry with a "
                "fresh one") from self._poisoned

    def shutdown(self, wait: bool = True):
        with self._cond:
            self._shut = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=True)

    def _ensure_pool(self):
        if self._pool is None:
            if self._shut:
                raise RuntimeError("FlushPool is shut down")
            from paimon_tpu_torch.parallel.executors import new_thread_pool
            self._pool = new_thread_pool(self.parallelism, "paimon-write")
        return self._pool

    def _drain_key(self, key):
        """Run `key`'s queued tasks one at a time, in order (the
        per-bucket actor: no two tasks of one bucket ever overlap)."""
        while True:
            with self._cond:
                q = self._queues.get(key)
                if not q or self._error is not None:
                    if q:
                        while q:
                            est, _ = q.popleft()
                            self._inflight_bytes -= est
                            self._inflight_tasks -= 1
                    self._active.discard(key)
                    self._cond.notify_all()
                    return
                est, fn = q.popleft()
            try:
                fn()
            except BaseException as e:      # noqa: BLE001 — latched
                with self._cond:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cond:
                    self._inflight_bytes -= est
                    self._inflight_tasks -= 1
                    self._cond.notify_all()
