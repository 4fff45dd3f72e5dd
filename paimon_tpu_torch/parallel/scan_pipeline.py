"""Pipelined merge-on-read scan executor.

Counterpart of paimon_tpu/parallel/scan_pipeline.py.  A bounded
producer-consumer pipeline over a plan's splits:

* `scan.split.parallelism` worker threads each run a full `read_split`
  (read, decode, run assembly, device merge), so split k's merge
  overlaps split k+1's reads;
* up to `parallelism + read.prefetch.splits` splits are admitted at
  once, further capped by the `read.prefetch.max-bytes` in-flight byte
  budget (the split's data-file sizes on disk); at least one split is
  always admitted, so a budget below one split cannot stall the scan;
  while the serving plane's brownout marks the process degraded
  (fs/resilience.py) nothing is prefetched past the workers;
* results come in plan order (`ordered=True`, the default) or in
  completion order (`ordered=False`), each wait bounded by the
  request's deadline (utils/deadline.py);
* a transient store fault on one data-file read retries under
  `read.retry.*` (`read_file_retrying`, the parallel/fault.py taxonomy
  and utils/backoff.py); undecodable bytes and missing planned files
  raise, or are skipped under `scan.ignore-corrupt-files`
  (`read_or_skip_corrupt`);
* the pool is shut down when iteration completes, raises, or the
  consumer abandons the generator: no thread outlives the read.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterator, Optional, Sequence, Tuple

from paimon_tpu_torch.options import CoreOptions

__all__ = ["iter_split_tables", "read_file_retrying",
           "read_fault_is_retryable", "read_or_skip_corrupt",
           "resolve_parallelism"]


def resolve_parallelism(options: Optional[CoreOptions]) -> int:
    """Worker threads for the pipelined scan: scan.split.parallelism,
    defaulting to min(8, cpu count).  1 means serial."""
    par = None
    if options is not None:
        par = options.get(CoreOptions.SCAN_SPLIT_PARALLELISM)
    if par is None:
        par = min(8, os.cpu_count() or 1)
    return max(1, int(par))


def _estimated_bytes(split) -> int:
    """In-flight cost estimate for one split: its on-disk data bytes
    (decoded size is larger; the budget is a throttle, not an
    allocator)."""
    return max(1, sum(f.file_size for f in split.data_files))


def read_fault_is_retryable(exc: BaseException) -> bool:
    """The READ-path refinement of fault.py's taxonomy: transient
    store faults retry, EXCEPT FileNotFoundError — on the read path a
    missing planned file means the snapshot raced maintenance
    (expiry/orphan clean); it cannot reappear, so it keeps the
    pre-pipeline behavior: no retry, and eligible for the
    scan.ignore-corrupt-files skip like any other unreadable file.
    (The compaction plane intentionally differs: its per-bucket ladder
    re-plans on retry, so FileNotFoundError stays transient there.)"""
    from paimon_tpu_torch.parallel.fault import is_transient_error
    return is_transient_error(exc) and \
        not isinstance(exc, FileNotFoundError)


def read_file_retrying(fn: Callable[[], object],
                       options: Optional[CoreOptions],
                       what: str = "data file"):
    """Run one file-granularity read under the read.retry.* schedule.

    Transient store faults (fault.py taxonomy: 503 TransientStoreError,
    OSError IO faults) retry with capped decorrelated-jitter backoff up
    to read.retry.max-attempts total attempts, then re-raise — they are
    NEVER eligible for the scan.ignore-corrupt-files skip, which is
    reserved for genuinely undecodable bytes.  Non-transient errors
    propagate immediately.  FileNotFoundError is excluded from the
    retry: a planned-then-deleted file (racing snapshot expiry /
    orphan clean) cannot reappear, so retrying only burns backoff
    sleeps — it propagates at once and stays in the skip-eligible
    class (see read_fault_is_retryable).
    """
    from paimon_tpu_torch.utils.backoff import Backoff

    if options is not None:
        attempts = options.get(CoreOptions.READ_RETRY_MAX_ATTEMPTS)
        base_ms = options.get(CoreOptions.READ_RETRY_BACKOFF)
    else:
        attempts = CoreOptions.READ_RETRY_MAX_ATTEMPTS.default
        base_ms = CoreOptions.READ_RETRY_BACKOFF.default
    attempts = max(1, attempts)
    backoff = None
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as e:      # noqa: BLE001 — reclassified below
            if not read_fault_is_retryable(e) or attempt >= attempts:
                raise
            from paimon_tpu_torch.metrics import (
                SCAN_READ_RETRIES, global_registry,
            )
            global_registry().scan_metrics() \
                .counter(SCAN_READ_RETRIES).inc()
            if backoff is None:
                backoff = Backoff(base_ms)
            from paimon_tpu_torch.obs.trace import span as _span
            with _span("retry.backoff", cat="scan", attempt=attempt,
                       what=what, error=type(e).__name__):
                backoff.pause()


def read_or_skip_corrupt(fn: Callable[[], object],
                         options: Optional[CoreOptions], label: str, *,
                         retry: bool = True):
    """THE read-path fault policy, shared by every split reader so the
    taxonomy can't drift between call sites:

    * transient store faults retry under read.retry.* (skipped with
      retry=False when an inner layer already retries: the append
      read's row-range groups), then re-raise — never eligible for the
      corrupt-file skip;
    * everything else (undecodable bytes, missing planned files) warns
      and returns None under scan.ignore-corrupt-files, else raises.
    """
    try:
        if retry:
            return read_file_retrying(fn, options, what=label)
        return fn()
    except Exception as e:      # noqa: BLE001 — reclassified below
        from paimon_tpu_torch.utils.deadline import DeadlineExceededError
        if isinstance(e, DeadlineExceededError):
            # a spent deadline is neither transient nor corrupt bytes:
            # it must surface as the 504, never be skipped as corrupt
            raise
        if read_fault_is_retryable(e):
            raise
        if options is not None and \
                options.get(CoreOptions.SCAN_IGNORE_CORRUPT_FILES):
            # reference scan.ignore-corrupt-files: warn + skip
            import warnings
            warnings.warn(f"skipping corrupt {label}", RuntimeWarning)
            return None
        raise


def iter_split_tables(read, splits: Sequence,
                      options: Optional[CoreOptions] = None, *,
                      ordered: bool = True,
                      stats: Optional[dict] = None
                      ) -> Iterator[Tuple[int, object, object]]:
    """Yield `(index, split, arrow_table)` through the bounded
    prefetch pipeline.

    `read` is anything with a `read_split(split) -> pa.Table` method
    (MergeFileSplitRead, AppendSplitRead, TableRead); `options`
    defaults to `read.options`.  `stats`, when given, receives
    {"parallelism", "peak_inflight_bytes", "max_inflight_splits",
    "submitted"} for tests/benchmarks.
    """
    from paimon_tpu_torch.obs import trace as _trace

    splits = list(splits)
    if options is None:
        options = getattr(read, "options", None)
    _trace.sync_from_options(options)
    par = resolve_parallelism(options)
    if stats is not None:
        stats.setdefault("parallelism", par)
        stats.setdefault("peak_inflight_bytes", 0)
        stats.setdefault("max_inflight_splits", 0)
        stats.setdefault("submitted", 0)
    if par <= 1 or len(splits) <= 1:
        # serial fast path: no pool, identical to the legacy loop
        from paimon_tpu_torch.utils.deadline import check_deadline
        table_path = getattr(read, "table_path", None)
        for i, s in enumerate(splits):
            check_deadline("scan")
            if stats is not None:
                b = _estimated_bytes(s)
                stats["submitted"] += 1
                stats["peak_inflight_bytes"] = max(
                    stats["peak_inflight_bytes"], b)
                stats["max_inflight_splits"] = max(
                    stats["max_inflight_splits"], 1)
            yield i, s, _read_split_traced(read, s, table_path)
        _trace.maybe_export()
        return
    yield from _iter_pipelined(read, splits, options, par,
                               ordered=ordered, stats=stats)


def _read_split_traced(read, split, table_path):
    """One full split read (IO + decode + merge) under a `scan.split`
    span — the per-worker track whose overlap across workers is the
    pipeline's whole point; IO/decode get their own child spans in
    format/format.py, merge in core/read.py."""
    from paimon_tpu_torch.metrics import SCAN_SPLIT_MS
    from paimon_tpu_torch.obs.trace import span
    with span("scan.split", cat="scan", group="scan",
              metric=SCAN_SPLIT_MS, table=table_path,
              partition=getattr(split, "partition", None),
              bucket=getattr(split, "bucket", None),
              files=len(getattr(split, "data_files", ()))):
        return read.read_split(split)


def _iter_pipelined(read, splits, options, par, *, ordered, stats):
    import concurrent.futures as cf

    from paimon_tpu_torch.metrics import (
        SCAN_PIPELINE_BYTES, SCAN_PIPELINE_SPLITS, global_registry,
    )
    from paimon_tpu_torch.obs import trace as _trace
    from paimon_tpu_torch.obs.trace import span as _span

    if options is not None:
        extra = options.get(CoreOptions.READ_PREFETCH_SPLITS)
        max_bytes = options.get(CoreOptions.READ_PREFETCH_MAX_BYTES)
    else:
        extra = CoreOptions.READ_PREFETCH_SPLITS.default
        max_bytes = CoreOptions.READ_PREFETCH_MAX_BYTES.default
    from paimon_tpu_torch.fs.resilience import is_degraded
    if is_degraded():
        # brownout rung 1+: stop prefetching past the worker pool —
        # shed our own speculative load before shedding requests
        extra = 0
    window = par + max(0, extra)
    max_bytes = max(1, max_bytes)
    group = global_registry().scan_metrics()
    c_splits = group.counter(SCAN_PIPELINE_SPLITS)
    c_bytes = group.counter(SCAN_PIPELINE_BYTES)

    from paimon_tpu_torch.parallel.executors import new_thread_pool
    pool = new_thread_pool(par, "paimon-scan")
    table_path = getattr(read, "table_path", None)
    from paimon_tpu_torch.utils.deadline import (
        DeadlineExceededError, check_deadline, current_deadline,
        wait_future,
    )

    inflight = deque()        # [index, split, est_bytes, future]
    inflight_bytes = 0
    next_i = 0
    abandoned = False
    try:
        while inflight or next_i < len(splits):
            # a spent request deadline stops admission AND result
            # waits right here — in-flight workers are abandoned by
            # the finally block (shutdown without join), their results
            # discarded
            check_deadline("scan pipeline")
            # admit work: window + byte budget, always >= 1 in flight
            while next_i < len(splits) and len(inflight) < window and \
                    (not inflight or
                     inflight_bytes + _estimated_bytes(splits[next_i])
                     <= max_bytes):
                s = splits[next_i]
                b = _estimated_bytes(s)
                with _span("scan.admit", cat="scan", split=next_i,
                           bucket=getattr(s, "bucket", None),
                           est_bytes=b):
                    inflight.append(
                        [next_i, s, b,
                         pool.submit(_read_split_traced, read, s,
                                     table_path)])
                inflight_bytes += b
                next_i += 1
                c_splits.inc()
                c_bytes.inc(b)
                if stats is not None:
                    stats["submitted"] += 1
                    stats["peak_inflight_bytes"] = max(
                        stats["peak_inflight_bytes"], inflight_bytes)
                    stats["max_inflight_splits"] = max(
                        stats["max_inflight_splits"], len(inflight))
            dl = current_deadline()
            if ordered:
                # deliberate backpressure: completed-but-unyielded
                # splits hold decoded tables in memory, so they keep
                # counting against the window and byte budget; under
                # head-of-line skew workers may idle rather than let
                # finished results accumulate unboundedly
                idx, s, b, fut = inflight.popleft()
            else:
                cf.wait([e[3] for e in inflight],
                        timeout=None if dl is None
                        else dl.remaining_s(),
                        return_when=cf.FIRST_COMPLETED)
                pos = next((i for i, e in enumerate(inflight)
                            if e[3].done()), None)
                if pos is None:
                    # deadline ran out with every worker still busy:
                    # abandon them all (finally skips the join)
                    abandoned = True
                    raise DeadlineExceededError(
                        "scan pipeline: deadline exceeded waiting "
                        "for any split")
                idx, s, b, fut = inflight[pos]
                del inflight[pos]
            # raises the worker's exception; a split HUNG past the
            # deadline raises DeadlineExceededError, caught below
            table = wait_future(fut, f"scan split {idx}")
            inflight_bytes -= b
            yield idx, s, table
    except GeneratorExit:
        # consumer stopped early (LIMIT satisfied, loader closed):
        # don't block it on in-flight reads whose results are
        # discarded — workers drain in the background and exit
        abandoned = True
        raise
    except DeadlineExceededError:
        # ANY deadline escape (the loop-top check, a worker-side
        # raise surfacing through fut.result) must not join workers
        # that may be hung in store calls — the whole point of the
        # 504 is to answer within one op's grace
        abandoned = True
        raise
    finally:
        # completion, abandonment and worker exceptions all land here:
        # cancel what never started; on completion/raise also join the
        # workers so no threads outlive the read
        for entry in inflight:
            entry[3].cancel()
        pool.shutdown(wait=not abandoned, cancel_futures=True)
        _trace.maybe_export()
