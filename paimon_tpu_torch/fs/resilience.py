"""Tail-tolerant object-store access: hedged reads + per-backend
circuit breakers + deadline-bounded IO waits.

Counterpart of paimon_tpu/fs/resilience.py.

Everything the robustness planes shipped so far reacts to *errors*
(parallel/fault.py taxonomy, utils/backoff.py ladders); this module
defends against *slowness* — the tail that dominates p99 on real
object stores ("The Tail at Scale"):

* **Hedged reads**: GET / ranged-GET / HEAD / LIST track an online
  per-op-class latency quantile; when a call has been in flight longer
  than the adaptive p-`read.hedge.quantile` delay, ONE hedge request
  is issued and the first successful response wins — the loser is
  abandoned, never cancelled mid-store-call.  Hedges are rate-capped
  (`read.hedge.max-ratio`, default 5% extra load) and are NEVER issued
  for mutating ops (PUT/DELETE): a duplicated conditional PUT could
  collide with its own write, a duplicated DELETE could erase a
  successor's object.
* **Circuit breakers**: one breaker per backend, closed -> open on
  consecutive-failure / windowed-error-rate thresholds.  An open
  circuit fails fast (CircuitOpenError, <10ms) instead of queueing
  retry ladders onto a sick store; after `store.breaker.open-ms` a
  half-open probe re-closes it on success.  The breaker composes UNDER
  `RetryingObjectStoreBackend`, whose ladder re-raises
  CircuitOpenError before any backoff sleep.
* **Deadlines**: hedged (pooled) calls wait with
  `utils/deadline.py`-bounded timeouts, so even a HUNG store request
  (stalled socket, not an error) is abandoned the moment the request's
  end-to-end budget is spent.

Composition order (maybe_wrap_resilience):

    RetryingObjectStoreBackend( ResilientObjectStoreBackend( store ) )

so every individual attempt — first try, ladder retry, hedge — is
breaker-accounted and latency-sampled.  Resilient wrappers are
memoized per inner backend: every table.copy() and serving request
shares ONE breaker + ONE latency model per physical store.

Brownout: the serving plane (service/brownout.py) flips the
process-wide `set_degraded(True)` switch under pressure, which
disables hedging (shedding our own extra load first) and shrinks the
scan pipeline's prefetch window.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from paimon_tpu_torch.fs.object_store import (
    CircuitOpenError, ObjectStoreBackend, ObjectStoreFileIO,
    RetryingObjectStoreBackend, TransientStoreError,
)

__all__ = ["CircuitBreaker", "CircuitOpenError", "LatencyTracker",
           "ResilientObjectStoreBackend", "maybe_wrap_resilience",
           "set_degraded", "is_degraded", "breaker_states",
           "hedging_allowed"]


# -- process-wide brownout switch (service/brownout.py flips it) -------------
# aggregated across SOURCES: a process can host several serving
# planes (multiple KvQueryServers over one shared cache tier), and
# one server recovering — or stopping — must not silently clear
# another server's active brownout.  The process is degraded while
# ANY source says so.

_DEGRADED = False
_DEGRADED_LOCK = threading.Lock()
_DEGRADED_SOURCES: set = set()
_MANUAL = "__manual__"


def set_degraded_for(source, active: bool):
    """Mark one source (e.g. a BrownoutController) degraded or
    recovered; the process-wide switch is the OR over live sources."""
    global _DEGRADED
    with _DEGRADED_LOCK:
        if active:
            _DEGRADED_SOURCES.add(source)
        else:
            _DEGRADED_SOURCES.discard(source)
        _DEGRADED = bool(_DEGRADED_SOURCES)


def set_degraded(active: bool):
    """Brownout rung 1+: disable hedging process-wide (shed our own
    extra store load first) and shrink scan prefetch windows
    (parallel/scan_pipeline.py consults is_degraded).  Single-source
    convenience form (tests/manual ops)."""
    set_degraded_for(_MANUAL, active)


def is_degraded() -> bool:
    return _DEGRADED


def hedging_allowed() -> bool:
    return not _DEGRADED


# -- registry of live resilient backends (healthz / brownout signals) --------

_BACKENDS_LOCK = threading.Lock()
_BACKENDS: List["ResilientObjectStoreBackend"] = []


def _register_backend(b: "ResilientObjectStoreBackend"):
    import weakref
    with _BACKENDS_LOCK:
        _BACKENDS.append(weakref.ref(b))


def breaker_states() -> Dict[str, str]:
    """{backend name: breaker state} across every live resilient
    backend in the process — the healthz / brownout signal."""
    out: Dict[str, str] = {}
    with _BACKENDS_LOCK:
        live = [r() for r in _BACKENDS]
        _BACKENDS[:] = [r for r, b in zip(list(_BACKENDS), live)
                        if b is not None]
    for b in live:
        if b is not None and b.breaker is not None:
            out[b.name] = b.breaker.state
    return out


class LatencyTracker:
    """Online per-op-class latency quantiles for the hedge trigger —
    a thin registry of `metrics.Histogram` sliding windows (the same
    deque(maxlen)+locked-percentile machinery every other plane uses;
    a sort of <=512 floats per decision is noise next to a store
    round trip).  Only SUCCESSFUL latencies are recorded: a 503
    storm's fast errors would drag the quantile down and fire hedges
    into the very store that is melting."""

    def __init__(self, window: int = 512, min_samples: int = 20):
        self.window = window
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._hists: Dict[str, object] = {}

    def _hist(self, op_class: str):
        from paimon_tpu_torch.metrics import Histogram
        with self._lock:
            h = self._hists.get(op_class)
            if h is None:
                h = self._hists[op_class] = Histogram(self.window)
            return h

    def record(self, op_class: str, latency_ms: float):
        self._hist(op_class).update(latency_ms)

    def samples(self, op_class: str) -> int:
        with self._lock:
            h = self._hists.get(op_class)
        return 0 if h is None else h.count

    def percentile_ms(self, op_class: str,
                      p: float) -> Optional[float]:
        """The p-th percentile of recent latencies, or None until
        `min_samples` successes have been observed (no hedging off a
        cold model)."""
        with self._lock:
            h = self._hists.get(op_class)
        if h is None or h.count < self.min_samples:
            return None
        return h.percentile(p)


class CircuitBreaker:
    """closed -> open -> half-open -> closed, per backend.

    * CLOSED: calls pass; `failure_threshold` CONSECUTIVE failures or
      a windowed error rate >= `error_rate` (over the last `window`
      outcomes, once the window is full) trips it OPEN.
    * OPEN: `allow()` is False — callers fail fast with
      CircuitOpenError, no store traffic, no retry-ladder sleeps.
      After `open_ms` the next `allow()` moves to HALF_OPEN.
    * HALF_OPEN: up to `half_open_probes` concurrent trial calls pass;
      the first success re-CLOSES (counters reset), any failure
      re-OPENS with a fresh `open_ms` timer.

    `clock` is injectable; every transition updates the per-backend
    `breaker_state` gauge (0 closed / 1 half-open / 2 open)."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _GAUGE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, name: str = "store", *,
                 failure_threshold: int = 5, error_rate: float = 0.5,
                 window: int = 32, open_ms: float = 5000.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.error_rate = float(error_rate)
        self.window = max(1, int(window))
        self.open_ms = float(open_ms)
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._outcomes: deque = deque(maxlen=self.window)
        self._reopen_at = 0.0
        self._probes_left = 0
        self._half_open_at = 0.0
        from paimon_tpu_torch.metrics import (
            RESILIENCE_BREAKER_FAST_FAILS, RESILIENCE_BREAKER_STATE,
            global_registry,
        )
        g = global_registry().resilience_metrics(name)
        self._g_state = g.gauge(RESILIENCE_BREAKER_STATE)
        self._g_state.set(0)
        self._c_fast_fails = global_registry().resilience_metrics() \
            .counter(RESILIENCE_BREAKER_FAST_FAILS)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _set_state_locked(self, state: str):
        if state != self._state:
            # flight-recorder: breaker flips are the canonical
            # "something was wrong with the store" black-box event
            # (flight's lock is a leaf — safe under self._lock)
            from paimon_tpu_torch.obs.flight import EV_BREAKER, record
            record(EV_BREAKER, backend=self.name, frm=self._state,
                   to=state)
        self._state = state
        self._g_state.set(self._GAUGE_VALUE[state])

    def _maybe_half_open_locked(self):
        now = self._clock()
        if self._state == self.OPEN and now >= self._reopen_at:
            self._set_state_locked(self.HALF_OPEN)
            self._probes_left = self.half_open_probes
            self._half_open_at = now
        elif self._state == self.HALF_OPEN and \
                self._probes_left <= 0 and \
                now >= self._half_open_at + self.open_ms / 1000.0:
            # probe-loss healing: a probe whose outcome was never
            # recorded (hung in a stalled store call — this plane's
            # own threat model — or an exception outside the recorded
            # taxonomy) would otherwise wedge the breaker in
            # HALF_OPEN with zero slots FOREVER; after another
            # open-ms of silence, grant fresh probes
            self._probes_left = self.half_open_probes
            self._half_open_at = now

    def allow(self) -> bool:
        """True when a call may proceed (CLOSED, or a HALF_OPEN probe
        slot).  False = fail fast; the caller raises
        CircuitOpenError without touching the store."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.OPEN:
                self._c_fast_fails.inc()
                return False
            if self._state == self.HALF_OPEN:
                if self._probes_left <= 0:
                    self._c_fast_fails.inc()
                    return False
                self._probes_left -= 1
            return True

    def record_success(self):
        with self._lock:
            self._consecutive = 0
            self._outcomes.append(0)
            if self._state == self.HALF_OPEN:
                # the probe came back healthy: close and forget the
                # sick window (old failures must not re-trip at once)
                self._set_state_locked(self.CLOSED)
                self._outcomes.clear()

    def record_failure(self):
        with self._lock:
            self._consecutive += 1
            self._outcomes.append(1)
            if self._state == self.HALF_OPEN:
                self._trip_locked()
                return
            if self._state != self.CLOSED:
                return
            rate_tripped = (
                len(self._outcomes) >= self.window and
                sum(self._outcomes) / len(self._outcomes)
                >= self.error_rate)
            if self._consecutive >= self.failure_threshold or \
                    rate_tripped:
                self._trip_locked()

    def _trip_locked(self):
        self._set_state_locked(self.OPEN)
        self._reopen_at = self._clock() + self.open_ms / 1000.0

    def force_open(self):
        """Test/ops hook: trip the breaker now."""
        with self._lock:
            self._trip_locked()


_HEDGEABLE = frozenset({"get", "range", "head", "list"})


class ResilientObjectStoreBackend(ObjectStoreBackend):
    """Backend wrapper carrying the breaker + hedged-read machinery.

    With hedging enabled, reads (get/range/head/list) run on a small
    internal pool so the caller's wait can be (a) hedged after the
    adaptive quantile delay and (b) bounded by the request deadline
    even when the underlying call HANGS (abandoned mid-flight).
    Mutations (put/delete) always run inline and are never hedged.
    With hedging disabled, reads are plain inline calls with breaker
    accounting only — deadline grace is then the cooperative one-op
    bound, and reads never queue behind the pool."""

    POOL_SIZE = 16

    def __init__(self, inner: ObjectStoreBackend, *,
                 name: str = "store",
                 breaker: Optional[CircuitBreaker] = None,
                 hedge_enabled: bool = False,
                 hedge_quantile: float = 95.0,
                 hedge_min_delay_ms: float = 1.0,
                 hedge_max_ratio: float = 0.05,
                 tracker: Optional[LatencyTracker] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.name = name
        self.breaker = breaker
        self.hedge_enabled = hedge_enabled
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_delay_ms = float(hedge_min_delay_ms)
        self.hedge_max_ratio = float(hedge_max_ratio)
        self.tracker = tracker or LatencyTracker()
        self._clock = clock
        self._lock = threading.Lock()
        self._pool = None
        self._ops = 0               # hedgeable calls (rate-cap base)
        self._hedges = 0            # hedges issued (rate-cap numerator)
        from paimon_tpu_torch.metrics import (
            RESILIENCE_HEDGE_WAIT_MS, RESILIENCE_HEDGES_ABANDONED,
            RESILIENCE_HEDGES_ISSUED, RESILIENCE_HEDGES_WON,
            global_registry,
        )
        g = global_registry().resilience_metrics()
        self._m_issued = g.counter(RESILIENCE_HEDGES_ISSUED)
        self._m_won = g.counter(RESILIENCE_HEDGES_WON)
        self._m_abandoned = g.counter(RESILIENCE_HEDGES_ABANDONED)
        self._m_wait = g.histogram(RESILIENCE_HEDGE_WAIT_MS)
        _register_backend(self)

    # -- plumbing ------------------------------------------------------------

    def _get_pool(self):
        with self._lock:
            if self._pool is None:
                from paimon_tpu_torch.parallel.executors import new_thread_pool
                self._pool = new_thread_pool(self.POOL_SIZE,
                                             f"paimon-hedge-{self.name}")
            return self._pool

    def _breaker_gate(self, what: str):
        if self.breaker is not None and not self.breaker.allow():
            raise CircuitOpenError(
                f"{self.name}: circuit open, failing fast ({what})")

    def _run_recorded(self, op_class: str, fn: Callable):
        """One actual store attempt: breaker outcome + latency sample.
        FileNotFoundError counts as a SUCCESS (the store answered
        authoritatively); deadline errors never reach here (waits are
        bounded outside the attempt)."""
        from paimon_tpu_torch.fs.object_store import PreconditionFailed
        t0 = self._clock()
        try:
            result = fn()
        except (FileNotFoundError, PreconditionFailed):
            # the store answered authoritatively (absent key / lost
            # CAS): breaker SUCCESS — critically so for a half-open
            # probe, whose slot must never be consumed outcome-less
            if self.breaker is not None:
                self.breaker.record_success()
            self.tracker.record(op_class,
                                (self._clock() - t0) * 1000.0)
            raise
        except (TransientStoreError, OSError):
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            self.breaker.record_success()
        self.tracker.record(op_class, (self._clock() - t0) * 1000.0)
        return result

    # margin over the trigger quantile: firing AT p95 would hedge
    # ~5% of ops — the marginal just-past-p95 ones — at exactly the
    # 5% rate cap, starving the true stragglers the hedge exists for
    # (observed in the chaos bench: tail GETs denied budget while
    # jitter-top ops burned it).  1.5x p95 clears the normal latency
    # band entirely; a 20x straggler still hedges almost immediately.
    HEDGE_DELAY_MARGIN = 1.5

    def _hedge_delay_s(self, op_class: str) -> Optional[float]:
        """Adaptive hedge-fire delay, or None when hedging is off
        (disabled, browned out, cold model)."""
        if not self.hedge_enabled or not hedging_allowed():
            return None
        p = self.tracker.percentile_ms(op_class, self.hedge_quantile)
        if p is None:
            return None
        return max(p * self.HEDGE_DELAY_MARGIN,
                   self.hedge_min_delay_ms) / 1000.0

    def _hedge_budget_ok(self) -> bool:
        """Rate cap: hedges stay <= hedge_max_ratio of hedgeable
        calls, so the extra load on an already-slow store is bounded."""
        with self._lock:
            return self._hedges + 1 <= self.hedge_max_ratio * self._ops

    def _read(self, op_class: str, fn: Callable, what: str):
        from paimon_tpu_torch.utils.deadline import (
            DeadlineExceededError, current_deadline,
        )
        dl = current_deadline()
        if dl is not None:
            # BEFORE the breaker gate: a spent deadline must not
            # consume a half-open probe slot it can never report on
            dl.check(what)
        self._breaker_gate(what)
        with self._lock:
            self._ops += 1
            if self._ops + self._hedges >= 1024:
                # decay the rate-cap accounting: a LIFETIME budget
                # would bank ~ratio x total-ops of unspent hedges
                # over a long healthy run and then dump them all onto
                # the store at the exact moment it degrades; halving
                # keeps the burst bounded (~ratio x 1024) while the
                # steady-state cap stays ratio-of-recent-ops
                self._ops //= 2
                self._hedges //= 2
        if not self.hedge_enabled:
            # plain inline call: no pool dispatch, breaker-accounted.
            # Breaker-only configs must not funnel every read through
            # the bounded hedge pool (and pay a thread handoff per
            # GET) just because a deadline is in scope — without
            # hedging, deadline grace is the cooperative one-op bound
            # (the pre-op checks here and in ObjectStoreFileIO);
            # hedge-enabled configs additionally get hung calls
            # ABANDONED mid-flight via the pooled wait below
            return self._run_recorded(op_class, fn)
        delay_s = self._hedge_delay_s(op_class)
        import concurrent.futures as cf
        pool = self._get_pool()
        primary = pool.submit(self._run_recorded, op_class, fn)
        futs = [primary]
        hedge = None
        if delay_s is not None:
            # phase 1: give the primary its p-quantile grace
            t = delay_s if dl is None \
                else min(delay_s, dl.remaining_s())
            done, _ = cf.wait([primary], timeout=t)
            # fire only when the primary really got its full quantile
            # grace — a deadline closer than the hedge delay means the
            # hedge could never finish in time anyway
            if not done and t >= delay_s and \
                    self._hedge_budget_ok() and \
                    (dl is None or not dl.exceeded()):
                with self._lock:
                    self._hedges += 1
                self._m_issued.inc()
                self._m_wait.update(delay_s * 1000.0)
                hedge = pool.submit(self._run_recorded, op_class, fn)
                futs.append(hedge)
        # phase 2: first SUCCESS wins, bounded by the deadline
        pending = set(futs)
        last_err: Optional[BaseException] = None
        while pending:
            timeout = None if dl is None else dl.remaining_s()
            done, not_done = cf.wait(pending, timeout=timeout,
                                     return_when=cf.FIRST_COMPLETED)
            if not done:
                # the deadline ran out with the op(s) still HUNG in
                # flight: abandon them (their threads drain in the
                # background, results discarded)
                self._m_abandoned.inc(len(not_done))
                raise DeadlineExceededError(
                    f"{what}: deadline exceeded with "
                    f"{len(not_done)} store call(s) still in flight "
                    f"({self.name})")
            pending = not_done
            for f in done:
                err = f.exception()
                if err is None:
                    if hedge is not None and f is hedge:
                        self._m_won.inc()
                    if pending:
                        self._m_abandoned.inc(len(pending))
                    # lint-ok: deadline-wait f is in the cf.wait done
                    # set: the result is already available, this call
                    # cannot block
                    return f.result()
                if isinstance(err, FileNotFoundError):
                    # an authoritative answer, not a failure: the key
                    # is absent — raising NOW is the win (waiting on
                    # the straggler, or letting its transient error
                    # overwrite this, would send the retry ladder
                    # after a key known to be missing)
                    if pending:
                        self._m_abandoned.inc(len(pending))
                    raise err
                last_err = err
        assert last_err is not None
        raise last_err

    def _mutate(self, fn: Callable, what: str):
        """Mutations: breaker-gated + breaker-accounted, NEVER hedged,
        never run through the pool — a duplicated conditional PUT
        collides with its own write and a duplicated DELETE can erase
        a successor object.  Deliberately NO deadline check either:
        the commit CAS gate and the durability barriers own write
        abort semantics, and the commit's deadline-abort CLEANUP runs
        exactly when the deadline is already spent — a check here
        would turn every one of its deletes into a silent no-op and
        orphan the aborted attempt's manifests."""
        self._breaker_gate(what)
        op_class = what.split(" ", 1)[0]
        return self._run_recorded(op_class, fn)

    def close(self):
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    # -- ObjectStoreBackend --------------------------------------------------

    def put(self, key: str, data: bytes, if_none_match: bool = False):
        return self._mutate(
            lambda: self.inner.put(key, data,
                                   if_none_match=if_none_match),
            f"put {key}")

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        op_class = "range" if (offset or length is not None) else "get"
        return self._read(op_class,
                          lambda: self.inner.get(key, offset, length),
                          f"get {key}")

    def head(self, key: str) -> Optional[int]:
        return self._read("head", lambda: self.inner.head(key),
                          f"head {key}")

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        return self._read("list", lambda: self.inner.list(prefix),
                          f"list {prefix}")

    def delete(self, key: str) -> bool:
        return self._mutate(lambda: self.inner.delete(key),
                            f"delete {key}")


# -- table wiring ------------------------------------------------------------

_SHARED_LOCK = threading.Lock()
_SHARED_RESILIENT: "object" = None      # WeakKeyDictionary, lazy
_NAME_SEQ = [0]


def _shared_resilient(store: ObjectStoreBackend, options
                      ) -> ResilientObjectStoreBackend:
    """One resilient wrapper per physical store per process: every
    table.copy() / serving request over the same backend shares one
    breaker and one latency model (first configuration wins, like
    shared_disk_tier).  The memo is weak on BOTH ends: the value is a
    weakref because the wrapper strongly references its key
    (wrapper.inner is the store), so a strong value would pin the key
    alive forever and the entry — with its breaker gauge series and
    lazily-built hedge pool — could never be collected after the last
    table over that backend dies."""
    global _SHARED_RESILIENT
    import weakref

    from paimon_tpu_torch.options import CoreOptions
    with _SHARED_LOCK:
        if _SHARED_RESILIENT is None:
            _SHARED_RESILIENT = weakref.WeakKeyDictionary()
        ref = _SHARED_RESILIENT.get(store)
        existing = ref() if ref is not None else None
        if existing is not None:
            return existing
        _NAME_SEQ[0] += 1
        name = f"store-{_NAME_SEQ[0]}"
        breaker = None
        if options.get(CoreOptions.STORE_BREAKER_ENABLED):
            breaker = CircuitBreaker(
                name,
                failure_threshold=options.get(
                    CoreOptions.STORE_BREAKER_FAILURE_THRESHOLD),
                error_rate=options.get(
                    CoreOptions.STORE_BREAKER_ERROR_RATE),
                window=options.get(CoreOptions.STORE_BREAKER_WINDOW),
                open_ms=options.get(CoreOptions.STORE_BREAKER_OPEN_MS),
                half_open_probes=options.get(
                    CoreOptions.STORE_BREAKER_HALF_OPEN_PROBES))
        wrapped = ResilientObjectStoreBackend(
            store, name=name, breaker=breaker,
            hedge_enabled=options.get(CoreOptions.READ_HEDGE_ENABLED),
            hedge_quantile=options.get(CoreOptions.READ_HEDGE_QUANTILE),
            hedge_min_delay_ms=options.get(
                CoreOptions.READ_HEDGE_MIN_DELAY),
            hedge_max_ratio=options.get(
                CoreOptions.READ_HEDGE_MAX_RATIO))
        if breaker is not None:
            # registry gauges are immortal: when the last table over
            # this backend dies, reset its breaker_state series to
            # closed so a breaker that died OPEN cannot render a
            # phantom open circuit on /metrics forever (healthz
            # prunes dead backends; the scrape endpoint cannot)
            weakref.finalize(wrapped, breaker._g_state.set, 0)
        _SHARED_RESILIENT[store] = weakref.ref(wrapped)
        return wrapped


def maybe_wrap_resilience(file_io, options):
    """Thread the resilient backend under an object-store FileIO when
    `store.breaker.enabled` / `read.hedge.enabled` ask for it — the
    one construction point (table/table.py FileStoreTable.__init__,
    BEFORE the caching wrap so cache hits never pay breaker/hedge
    accounting).  A RetryingObjectStoreBackend stays OUTERMOST (same
    parameters, rebuilt over the resilient layer) so its ladder sees
    CircuitOpenError fail-fasts and every attempt it makes is
    individually breaker-accounted and latency-sampled."""
    from paimon_tpu_torch.options import CoreOptions
    if options is None:
        return file_io
    if not (options.get(CoreOptions.STORE_BREAKER_ENABLED) or
            options.get(CoreOptions.READ_HEDGE_ENABLED)):
        return file_io
    from paimon_tpu_torch.fs.caching import CachingFileIO
    if isinstance(file_io, CachingFileIO):
        # table.copy() on a cache-wrapped table hands us the wrapper:
        # thread resilience UNDER the cache (rewrap the inner FileIO,
        # keep the SAME cache state/tier) instead of silently
        # ignoring the breaker/hedge options
        inner = maybe_wrap_resilience(file_io.inner, options)
        if inner is file_io.inner:
            return file_io
        return CachingFileIO(inner,
                             capacity_bytes=file_io.state.capacity,
                             range_cache_bytes=file_io.state
                             .range_capacity,
                             state=file_io.state)
    if not isinstance(file_io, ObjectStoreFileIO):
        return file_io
    backend = file_io.backend
    retry_kw = None
    if isinstance(backend, RetryingObjectStoreBackend):
        retry_kw = dict(max_attempts=backend.max_attempts,
                        backoff_s=backend.backoff_s,
                        backoff_cap_s=backend.backoff_cap_s,
                        max_elapsed_s=backend.max_elapsed_s,
                        rng=backend._rng)
        backend = backend.inner
    if isinstance(backend, ResilientObjectStoreBackend):
        return file_io                 # already wired (table.copy())
    wrapped = _shared_resilient(backend, options)
    if retry_kw is not None:
        wrapped = RetryingObjectStoreBackend(wrapped, **retry_kw)
    return ObjectStoreFileIO(wrapped, scheme=file_io.scheme)
