"""Pipelined merge-on-read scan executor.

Counterpart of paimon_tpu/parallel/scan_pipeline.py without read
retries, corrupt-file skips and the in-flight byte budget (not ported
yet).  `scan.split.parallelism` worker threads each run a full
`read_split` (read, decode, run assembly, device merge), so split k's
merge overlaps split k+1's reads; up to `parallelism +
read.prefetch.splits` splits are in flight (no prefetch past the
workers while the serving plane's brownout marks the process degraded,
fs/resilience.py), and results are yielded in plan order, each wait
bounded by the request's deadline (utils/deadline.py).  The pool is
shut down when iteration completes, raises, or the consumer abandons
the generator.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Iterator, Optional, Sequence, Tuple

from paimon_tpu_torch.options import CoreOptions

__all__ = ["iter_split_tables", "resolve_parallelism"]


def resolve_parallelism(options: Optional[CoreOptions]) -> int:
    """Worker threads for the pipelined scan: scan.split.parallelism,
    defaulting to min(8, cpu count).  1 means serial."""
    par = None
    if options is not None:
        par = options.get(CoreOptions.SCAN_SPLIT_PARALLELISM)
    if par is None:
        par = min(8, os.cpu_count() or 1)
    return max(1, int(par))


def iter_split_tables(read, splits: Sequence, options: CoreOptions
                      ) -> Iterator[Tuple[int, object, object]]:
    """Yield `(index, split, arrow_table)` in plan order; `read` has a
    `read_split(split) -> pa.Table` method."""
    splits = list(splits)
    par = resolve_parallelism(options)
    if par <= 1 or len(splits) <= 1:
        for i, s in enumerate(splits):
            yield i, s, read.read_split(s)
        return
    from paimon_tpu_torch.fs.resilience import is_degraded
    from paimon_tpu_torch.parallel.executors import new_thread_pool
    from paimon_tpu_torch.utils.deadline import wait_future
    extra = 0 if is_degraded() else \
        max(0, options.get(CoreOptions.READ_PREFETCH_SPLITS))
    window = par + extra
    pool = new_thread_pool(par, "paimon-scan")
    inflight = deque()
    next_i = 0
    abandoned = False
    try:
        while inflight or next_i < len(splits):
            while next_i < len(splits) and len(inflight) < window:
                s = splits[next_i]
                inflight.append((next_i, s, pool.submit(read.read_split, s)))
                next_i += 1
            idx, s, fut = inflight.popleft()
            yield idx, s, wait_future(fut, "scan split")
    except GeneratorExit:
        # consumer stopped early (LIMIT satisfied): don't block it on
        # in-flight reads whose results are discarded
        abandoned = True
        raise
    finally:
        for _, _, fut in inflight:
            fut.cancel()
        pool.shutdown(wait=not abandoned, cancel_futures=True)
