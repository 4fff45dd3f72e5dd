"""Pipelined write flush executor, flush retries and upload staging.

Counterpart of paimon_tpu/parallel/write_pipeline.py: a bounded pool
that overlaps bucket k's merge+encode+write with bucket k+1's and with
the incoming batch's hash/group-by on the caller thread.

* **per-bucket ordering**: tasks for the same (partition, bucket) run
  strictly in submission order through a per-key "actor" queue, so
  file metas, spill runs and changelog files publish
  deterministically; tasks for different keys run on up to
  `write.flush.parallelism` workers;
* **byte budget**: `submit` blocks the producer while the estimated
  buffered bytes in flight exceed `write.flush.max-bytes`, always
  admitting at least one task;
* **fault policy**: a transient store fault inside a flush task retries
  the task under `write.retry.*` (`flush_retrying`: each task is its
  own retry domain); an exhausted or non-transient error is latched and
  re-raised at the `drain()` barrier with all still-queued tasks
  cancelled and the pool poisoned — a flush is never silently dropped;
* **upload staging**: with `write.stage.dir` set, the writer's FileIO
  is wrapped in fs/staging.py's StagingFileIO and an `UploadStager`
  owns the store uploads (drained last in prepare_commit);
* **serial path**: parallelism 1 runs every task inline.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from paimon_tpu_torch.options import CoreOptions

__all__ = ["FlushPool", "UploadStager", "flush_retrying", "lpt_order",
           "maybe_wrap_staging", "resolve_flush_parallelism",
           "resolve_stage_parallelism"]


def lpt_order(groups):
    """Largest (partition,bucket) group first — row count stands in
    for estimated bytes; the same longest-processing-time discipline
    as parallel/packing.py, shared by the pk and append dispatchers so
    the cost estimate cannot drift between them.  The flush pool
    receives skewed buckets' work first, overlapping the hot bucket's
    encode+upload with all the small ones instead of trailing it as
    the long tail.  Stable sort: equal sizes keep grouping order."""
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


def resolve_stage_parallelism(options: Optional[CoreOptions]) -> int:
    """Upload workers for staged uploads: write.stage.parallelism,
    defaulting to min(8, cpu count).  Uploads are independent PUTs to
    writer-unique names, so width here directly hides store latency."""
    par = None
    if options is not None:
        par = options.get(CoreOptions.WRITE_STAGE_PARALLELISM)
    if par is None:
        par = min(8, os.cpu_count() or 1)
    return max(1, int(par))


def maybe_wrap_staging(file_io, options: Optional[CoreOptions]):
    """(file_io, stager-or-None): when write.stage.dir is set, build
    the writer's UploadStager and wrap its FileIO in a StagingFileIO —
    the ONE construction point shared by the pk and append file-store
    writes (flush workers then encode to local SSD + fsync, the upload
    pool owns the store PUTs, and the writer drains the stager LAST in
    prepare_commit to keep the durability contract)."""
    stage_dir = options.get(CoreOptions.WRITE_STAGE_DIR) \
        if options is not None else None
    if not stage_dir:
        return file_io, None
    from paimon_tpu_torch.fs.staging import StagingFileIO
    stager = UploadStager(stage_dir, resolve_stage_parallelism(options),
                          options)
    return StagingFileIO(file_io, stager), stager


def flush_retrying(fn: Callable[[], object],
                   options: Optional[CoreOptions],
                   what: str = "bucket flush"):
    """Run one flush-granularity operation under write.retry.*.

    Transient store faults (fault.py taxonomy: 503 TransientStoreError,
    OSError IO faults) retry with capped decorrelated-jitter backoff up
    to write.retry.max-attempts total attempts, then re-raise the
    original error.  Non-transient errors propagate immediately.  The
    retried `fn` must be restartable from the top: flush closures
    publish their outputs (file metas, spill paths) only after the
    write succeeded, and every attempt picks fresh file names, so a
    half-written attempt leaves only orphan files for maintenance."""
    from paimon_tpu_torch.parallel.fault import is_transient_error
    from paimon_tpu_torch.utils.backoff import Backoff

    if options is not None:
        attempts = options.get(CoreOptions.WRITE_RETRY_MAX_ATTEMPTS)
        base_ms = options.get(CoreOptions.WRITE_RETRY_BACKOFF)
    else:
        attempts = CoreOptions.WRITE_RETRY_MAX_ATTEMPTS.default
        base_ms = CoreOptions.WRITE_RETRY_BACKOFF.default
    attempts = max(1, attempts)
    backoff = None
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as e:      # noqa: BLE001 — reclassified below
            if not is_transient_error(e) or attempt >= attempts:
                raise
            from paimon_tpu_torch.metrics import WRITE_RETRIES, global_registry
            global_registry().write_metrics() \
                .counter(WRITE_RETRIES).inc()
            if backoff is None:
                backoff = Backoff(base_ms)
            from paimon_tpu_torch.obs.trace import span as _span
            with _span("retry.backoff", cat="write", attempt=attempt,
                       what=what, error=type(e).__name__):
                backoff.pause()


class FlushPool:
    """Bounded flush executor with per-key FIFO ordering.

    `submit(key, est_bytes, fn)` enqueues `fn` on the key's actor
    queue (strict submission order per key) and wakes a shared worker;
    it blocks the producer while the in-flight byte budget is
    exceeded.  `drain()` is the prepare-commit barrier: it waits for
    every admitted task and re-raises the first task error with the
    remaining queued tasks cancelled AND the pool poisoned — the
    cancelled payloads are unrecoverable, so the owning writer must be
    closed and replaced rather than retried (see `drain`).
    `shutdown()` joins the workers; no threads outlive the owner.
    """

    def __init__(self, parallelism: int, max_bytes: int,
                 options: Optional[CoreOptions] = None):
        self.parallelism = max(1, int(parallelism))
        self.max_bytes = max(1, int(max_bytes))
        self.options = options
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[object, deque] = {}
        self._active: set = {*()}
        self._inflight_bytes = 0
        self._inflight_tasks = 0
        self._error: Optional[BaseException] = None
        self._poisoned: Optional[BaseException] = None
        self._pool = None
        self._shut = False
        # observability for tests/benchmarks (mirrors scan stats)
        self.peak_inflight_bytes = 0
        self.max_inflight_tasks = 0
        self.submitted = 0
        from paimon_tpu_torch.metrics import (
            WRITE_FLUSHED_BYTES, WRITE_FLUSHES, WRITE_FLUSH_WAIT_MS,
            WRITE_INFLIGHT_BYTES, global_registry,
        )
        group = global_registry().write_metrics()
        self._c_flushes = group.counter(WRITE_FLUSHES)
        self._c_bytes = group.counter(WRITE_FLUSHED_BYTES)
        self._c_wait = group.counter(WRITE_FLUSH_WAIT_MS)
        self._g_inflight = group.gauge(WRITE_INFLIGHT_BYTES)
        from paimon_tpu_torch.obs import trace as _trace
        _trace.sync_from_options(options)

    @classmethod
    def from_options(cls, options: Optional[CoreOptions]) -> "FlushPool":
        par = resolve_flush_parallelism(options)
        if options is not None:
            max_bytes = options.get(CoreOptions.WRITE_FLUSH_MAX_BYTES)
        else:
            max_bytes = CoreOptions.WRITE_FLUSH_MAX_BYTES.default
        return cls(par, max_bytes, options)

    @property
    def serial(self) -> bool:
        return self.parallelism <= 1

    # -- producer side -------------------------------------------------------

    def submit(self, key, est_bytes: int, fn: Callable[[], None]):
        """Admit one flush task for `key`.  Serial pools run it inline
        (errors propagate immediately, exactly like the legacy path)."""
        est_bytes = max(1, int(est_bytes))
        self._c_flushes.inc()
        self._c_bytes.inc(est_bytes)
        self.submitted += 1
        if self.serial:
            self.peak_inflight_bytes = max(self.peak_inflight_bytes,
                                           est_bytes)
            self.max_inflight_tasks = max(self.max_inflight_tasks, 1)
            self._run_task(key, fn)
            return
        with self._cond:
            self._check_poisoned()
            if self._error is not None:
                raise self._first_error()
            # backpressure: block while over budget, unless the pool is
            # empty (always admit one so a small budget cannot stall)
            waited = None
            wait_span = None
            try:
                while self._inflight_tasks > 0 and \
                        self._inflight_bytes + est_bytes > self.max_bytes:
                    # the byte-budget block honors the request
                    # deadline: the un-admitted task's rows would be
                    # lost to a retried prepare, so a tripped deadline
                    # poisons the pool like any other producer-side
                    # abort (the caller must start a fresh writer)
                    from paimon_tpu_torch.utils.deadline import (
                        DeadlineExceededError, check_deadline,
                    )
                    try:
                        check_deadline("write byte-budget wait")
                    except DeadlineExceededError as e:
                        self._poisoned = e
                        raise
                    if waited is None:
                        waited = time.perf_counter()
                        from paimon_tpu_torch.obs.trace import span as _span
                        wait_span = _span("write.flush_wait",
                                          cat="write", key=key,
                                          est_bytes=est_bytes)
                        wait_span.__enter__()
                    self._cond.wait(timeout=0.5)
                    if self._error is not None:
                        raise self._first_error()
            finally:
                # always close the span (KeyboardInterrupt included) or
                # the producer thread's contextvar keeps a dead parent
                if wait_span is not None:
                    wait_span.__exit__(None, None, None)
            if waited is not None:
                self._c_wait.inc(
                    int((time.perf_counter() - waited) * 1000))
            self._inflight_bytes += est_bytes
            self._inflight_tasks += 1
            self.peak_inflight_bytes = max(self.peak_inflight_bytes,
                                           self._inflight_bytes)
            self.max_inflight_tasks = max(self.max_inflight_tasks,
                                          self._inflight_tasks)
            self._g_inflight.set(self._inflight_bytes)
            self._queues.setdefault(key, deque()).append((est_bytes, fn))
            if key not in self._active:
                self._active.add(key)
                self._ensure_pool().submit(self._drain_key, key)

    def drain(self):
        """Barrier: wait for every admitted task; re-raise the first
        task error with the remaining queued tasks cancelled.  A drain
        that raised POISONS the pool: the cancelled tasks' payloads
        (snapshots already detached from their writers, sequence ranges
        already reserved) are gone, so a retried prepare on the same
        writer would commit with rows silently missing — every later
        submit/drain raises instead; the caller must close this writer
        and start a fresh one."""
        if self.serial:
            return
        with self._cond:
            self._check_poisoned()
            while self._inflight_tasks > 0 and self._error is None:
                from paimon_tpu_torch.utils.deadline import (
                    DeadlineExceededError, check_deadline,
                )
                try:
                    check_deadline("write drain barrier")
                except DeadlineExceededError as e:
                    # cancel what never started and poison: the
                    # cancelled payloads are unrecoverable on this
                    # writer (running tasks are ABANDONED, not joined
                    # — the deadline must not wait on a hung upload)
                    self._cancel_queued()
                    self._poisoned = e
                    raise
                self._cond.wait(timeout=0.5)
            if self._error is not None:
                # cancel everything still queued, then wait for the
                # running tasks to finish so state stops mutating
                self._cancel_queued()
                while self._inflight_tasks > 0:
                    self._cond.wait(timeout=0.5)
                self._g_inflight.set(self._inflight_bytes)
                err, self._error = self._error, None
                self._poisoned = err
                raise err

    def _cancel_queued(self):
        """Drop every queued task (caller holds the lock)."""
        for q in self._queues.values():
            while q:
                est, _ = q.popleft()
                self._inflight_bytes -= est
                self._inflight_tasks -= 1
        self._g_inflight.set(self._inflight_bytes)

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
        from paimon_tpu_torch.obs import trace as _trace
        _trace.maybe_export()

    # -- worker side ---------------------------------------------------------

    def _run_task(self, key, fn):
        """One flush task (sort + encode + upload) under its span —
        per-bucket-actor tracks in the trace; sort/encode/upload child
        spans come from core/write.py and format/format.py."""
        from paimon_tpu_torch.metrics import WRITE_FLUSH_TASK_MS
        from paimon_tpu_torch.obs.trace import span
        part, bucket = key if isinstance(key, tuple) and len(key) == 2 \
            else (None, key)
        with span("write.flush", cat="write", group="write",
                  metric=WRITE_FLUSH_TASK_MS, partition=part,
                  bucket=bucket):
            flush_retrying(fn, self.options)

    def _first_error(self) -> BaseException:
        return RuntimeError("write pipeline already failed; "
                            "drain() reports the cause") \
            if self._error is None else self._error

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
                        # pipeline failed: cancel this key's backlog
                        while q:
                            est, _ = q.popleft()
                            self._inflight_bytes -= est
                            self._inflight_tasks -= 1
                        self._g_inflight.set(self._inflight_bytes)
                    self._active.discard(key)
                    self._cond.notify_all()
                    return
                est, fn = q.popleft()
            try:
                self._run_task(key, fn)
            except BaseException as e:      # noqa: BLE001 — latched
                with self._cond:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cond:
                    self._inflight_bytes -= est
                    self._inflight_tasks -= 1
                    self._g_inflight.set(self._inflight_bytes)
                    self._cond.notify_all()


class UploadStager:
    """Local-SSD staging between the flush workers and the object
    store (write.stage.dir; "A Host-SSD Collaborative Write
    Accelerator for LSM-Tree-Based KV Stores", arxiv 2410.21760).

    `stage(inner, path, data)` writes `data` to a staged local file
    (tmp + atomic replace on the flush worker; the upload worker
    fsyncs it just before the PUT, so "fsync, then upload" holds
    without the sync riding the per-bucket actor's critical path),
    registers it so reads of `path` can be served from the staged
    bytes while the upload is in flight (fs/staging.StagingFileIO — compaction re-reading a fresh
    L0 file inside prepare_commit never waits on the store), and hands
    the object-store PUT to a bounded upload pool.  Consequences:

    * the flush worker returns after the local fsync — encode and
      upload overlap even WITHIN one bucket (the per-bucket actor only
      serializes sort/encode/stage, not the PUTs);
    * an upload retry (write.retry.*) re-reads the staged bytes — it
      never re-sorts or re-encodes;
    * a completed upload seeds the host-SSD read tier
      (fs/caching.seed_read_cache): newly written files are the
      hottest reads;
    * `drain()` is the durability barrier: prepare_commit() calls it
      LAST, so by the time commit messages leave the writer every file
      they name is acked by the object store — the commit contract is
      byte-identical to the inline-upload path.

    Error policy mirrors FlushPool: the first upload error is latched,
    later stage() calls fail fast, drain() re-raises it with the
    stager poisoned (cancelled uploads' files are unrecoverable — the
    writer must be closed and replaced)."""

    def __init__(self, stage_dir: str, parallelism: int,
                 options: Optional[CoreOptions] = None):
        import uuid
        self.parallelism = max(1, int(parallelism))
        self.options = options
        # one private subdir per stager: concurrent writers sharing
        # write.stage.dir never collide, close() can rmtree safely
        self.dir = os.path.join(stage_dir, f"stage-{uuid.uuid4().hex}")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: Dict[str, str] = {}      # final path -> staged
        self._inflight = 0
        self._error: Optional[BaseException] = None
        self._poisoned: Optional[BaseException] = None
        self._pool = None
        self._shut = False
        self.staged = 0                          # observability (tests)
        from paimon_tpu_torch.metrics import (
            CACHE_DISK_STAGED_UPLOADS, global_registry,
        )
        self._c_uploads = global_registry().cache_disk_metrics() \
            .counter(CACHE_DISK_STAGED_UPLOADS)

    def accepts(self, path: str) -> bool:
        """Only immutable-named files (uuid'd data/changelog/index
        blobs) stage; mutable refs must hit the store synchronously."""
        from paimon_tpu_torch.fs.caching import _cacheable
        return _cacheable(path)

    def stage(self, inner, path: str, data: bytes):
        """Durably stage `data` for `path` and schedule its upload.
        Called from flush workers; raises the latched upload error (if
        any) so a failing store surfaces at the next flush instead of
        only at the barrier."""
        import uuid

        from paimon_tpu_torch.metrics import CACHE_DISK_STAGE_MS
        from paimon_tpu_torch.obs.trace import span
        with self._cond:
            self._check_poisoned()
            if self._error is not None:
                raise self._error
        staged = os.path.join(self.dir, f"{uuid.uuid4().hex}.staged")

        def _write_staged():
            # plain atomic write on the FLUSH worker (tmp+replace so
            # pending-read racers never see a torn file); the fsync
            # happens on the UPLOAD worker just before the PUT —
            # "fsync, then upload" holds, but the sync cost rides the
            # wide upload pool instead of the per-bucket actor's
            # critical path
            tmp = f"{staged}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, staged)

        with span("io.stage", cat="io", group="cache_disk",
                  metric=CACHE_DISK_STAGE_MS, path=path,
                  bytes=len(data)):
            try:
                _write_staged()
            except OSError:
                # stage dir wiped mid-run: recreate once, else degrade
                # to the inline upload (staging is an accelerator, a
                # broken local disk must not fail the write)
                try:
                    os.makedirs(self.dir, exist_ok=True)
                    _write_staged()
                except OSError:
                    inner.write_bytes(path, data, overwrite=False)
                    return
        with self._cond:
            self._pending[path] = staged
            self._inflight += 1
            self.staged += 1
        self._ensure_pool().submit(self._upload, inner, path, staged)

    def pending_bytes(self, path: str) -> Optional[bytes]:
        """The staged bytes of a not-yet-acked upload, or None.  Racing
        an upload completion is safe: the staged file is unlinked only
        AFTER the store acked and the path left `_pending`, so a lost
        race falls back to the store, which now has the file."""
        with self._lock:
            staged = self._pending.get(path)
        if staged is None:
            return None
        try:
            with open(staged, "rb") as f:
                return f.read()
        except OSError:
            return None

    def pending_size(self, path: str) -> Optional[int]:
        with self._lock:
            staged = self._pending.get(path)
        if staged is None:
            return None
        try:
            return os.path.getsize(staged)
        except OSError:
            return None

    def _upload(self, inner, path: str, staged: str):
        ok = False
        try:
            # fsync BEFORE the PUT (deferred from stage(): the staged
            # bytes must be on stable storage before any object-store
            # ack can reference them), then re-read the STAGED bytes
            # (not a closure capture): the retry contract — and crash
            # evidence — live on local SSD
            with open(staged, "rb") as f:
                os.fsync(f.fileno())
                data = f.read()

            def attempt():
                try:
                    inner.write_bytes(path, data, overwrite=False)
                except FileExistsError:
                    # ambiguous earlier attempt landed (error after
                    # effect); byte-equality identifies our write —
                    # data-file payloads are writer-unique (uuid names)
                    if inner.read_bytes(path) == data:
                        return
                    raise

            flush_retrying(attempt, self.options, what="staged upload")
            from paimon_tpu_torch.fs.caching import (
                CachingFileIO, seed_read_cache,
            )
            # seed the tier this writer's table actually reads: the
            # staged wrapper sits over the table's own CachingFileIO,
            # whose state may be private rather than the shared one
            seed_read_cache(path, data,
                            state=inner.state
                            if isinstance(inner, CachingFileIO) else None)
            self._c_uploads.inc()
            ok = True
        except BaseException as e:      # noqa: BLE001 — latched
            with self._cond:
                if self._error is None:
                    self._error = e
        finally:
            with self._cond:
                self._pending.pop(path, None)
                self._inflight -= 1
                self._cond.notify_all()
            if ok:
                try:
                    os.unlink(staged)
                except OSError:
                    pass

    def drain(self):
        """The durability barrier: wait for every staged upload's ack;
        re-raise the first upload error with the stager poisoned."""
        with self._cond:
            self._check_poisoned()
            while self._inflight > 0:
                if self._shut:
                    # close(cancel_futures) left queued uploads that
                    # will never run their finally — fail fast instead
                    # of waiting on an _inflight that cannot drop
                    raise RuntimeError(
                        "UploadStager is shut down with uploads "
                        "cancelled; nothing to drain")
                from paimon_tpu_torch.utils.deadline import (
                    DeadlineExceededError, check_deadline,
                )
                try:
                    check_deadline("staged-upload drain barrier")
                except DeadlineExceededError as e:
                    # in-flight PUTs are abandoned; the stager is
                    # poisoned so no commit message naming un-acked
                    # files can ever be assembled
                    self._poisoned = e
                    raise
                self._cond.wait(timeout=0.5)
            if self._error is not None:
                err, self._error = self._error, None
                self._poisoned = err
                raise err

    def _check_poisoned(self):
        if self._poisoned is not None:
            raise RuntimeError(
                "staged uploads failed earlier; close this writer and "
                "retry with a fresh one") from self._poisoned

    def _ensure_pool(self):
        with self._lock:
            if self._pool is None:
                if self._shut:
                    raise RuntimeError("UploadStager is shut down")
                from paimon_tpu_torch.parallel.executors import new_thread_pool
                self._pool = new_thread_pool(self.parallelism,
                                             "paimon-stage")
            return self._pool

    def close(self):
        import shutil
        with self._cond:
            self._shut = True
            pool, self._pool = self._pool, None
            self._cond.notify_all()      # wake any drain() to fail fast
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(self.dir, ignore_errors=True)
