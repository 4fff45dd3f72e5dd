"""Admission control for the query-serving plane: per-tenant in-flight
byte budgets with a bounded wait queue.

Counterpart of paimon_tpu/service/admission.py.  Every request is
charged an estimated byte cost before any heavy work runs; requests
that would push the process (or their tenant) over budget queue,
bounded and with a timeout that turns into HTTP 429, instead of
oversubscribing memory.  Capacity drains to waiters largest first, and
an idle budget always admits one request, so a request larger than the
whole budget cannot wedge the service.  Brownout rung 2 sheds requests
below a priority at once (`set_shed_below`); a request deadline bounds
the queue wait (utils/deadline.py, a 504).  Queue depth and in-flight
bytes are gauges of the `service` metric group, per tenant too.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["AdmissionController", "AdmissionRejected", "AdmissionTicket"]

DEFAULT_TENANT = "default"
DEFAULT_PRIORITY = 100


class AdmissionRejected(RuntimeError):
    """Raised when a request cannot be admitted: the wait queue is
    full, or the byte budget did not free up within the queue timeout.
    The HTTP layer maps this to 429."""

    status = 429


class _Waiter:
    __slots__ = ("bytes", "tenant", "event", "admitted", "enqueued_at")

    def __init__(self, nbytes: int, tenant: str):
        self.bytes = nbytes
        self.tenant = tenant
        self.event = threading.Event()
        self.admitted = False
        self.enqueued_at = time.perf_counter()


class AdmissionTicket:
    """Held while a request runs; releasing returns the bytes to the
    budget and drains the queue.  Context-manager form preferred."""

    def __init__(self, controller: "AdmissionController", nbytes: int,
                 tenant: str):
        self._controller = controller
        self.bytes = nbytes
        self.tenant = tenant
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self._controller._release(self)

    def __enter__(self) -> "AdmissionTicket":
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AdmissionController:
    def __init__(self, max_bytes: int,
                 tenant_max_bytes: Optional[int] = None,
                 queue_depth: int = 256,
                 queue_timeout_ms: int = 10_000,
                 table: str = ""):
        self.max_bytes = max(1, int(max_bytes))
        # `is not None`, not truthiness: an explicit 0 means "throttle
        # every tenant to the one-request anti-starvation minimum",
        # the opposite of the unlimited default
        self.tenant_max_bytes = int(tenant_max_bytes) \
            if tenant_max_bytes is not None else self.max_bytes
        self.queue_depth = max(0, int(queue_depth))
        self.queue_timeout_ms = max(0, int(queue_timeout_ms))
        self._lock = threading.Lock()
        self._inflight = 0
        self._tenant_inflight: Dict[str, int] = {}
        self._waiters: List[_Waiter] = []
        from paimon_tpu_torch.metrics import (
            SERVICE_ADMISSION_WAIT_MS, SERVICE_INFLIGHT_BYTES,
            SERVICE_QUEUE_DEPTH, SERVICE_REJECTED, SERVICE_REQUESTS,
            global_registry,
        )
        self._registry = global_registry()
        g = self._registry.service_metrics(table)
        self._m_requests = g.counter(SERVICE_REQUESTS)
        self._m_rejected = g.counter(SERVICE_REJECTED)
        self._m_wait = g.histogram(SERVICE_ADMISSION_WAIT_MS)
        from paimon_tpu_torch.metrics import RESILIENCE_BROWNOUT_SHEDS
        self._m_sheds = self._registry.resilience_metrics() \
            .counter(RESILIENCE_BROWNOUT_SHEDS)
        # brownout rung 2 (service/brownout.py): requests with
        # priority below this are shed immediately with 429 — the
        # lowest-priority tenants lose service first, the high-
        # priority path keeps its byte budget
        self._shed_below = 0
        # explicitly-set gauges (not fn-backed): a later controller on
        # the same table must take the series over, not leave a stale
        # closure pointing at a dead instance
        self._g_queue = g.gauge(SERVICE_QUEUE_DEPTH)
        self._g_inflight = g.gauge(SERVICE_INFLIGHT_BYTES)
        self._g_queue.set(0)
        self._g_inflight.set(0)
        self._tenant_gauges: Dict[str, object] = {}

    # -- introspection (tests/benchmarks) ------------------------------------

    @property
    def inflight_bytes(self) -> int:
        return self._inflight

    def tenant_inflight(self, tenant: str) -> int:
        return self._tenant_inflight.get(tenant, 0)

    @property
    def queued(self) -> int:
        return len(self._waiters)

    # -- admission -----------------------------------------------------------

    def _fits_locked(self, nbytes: int, tenant: str) -> bool:
        t_in = self._tenant_inflight.get(tenant, 0)
        fits_global = self._inflight + nbytes <= self.max_bytes \
            or self._inflight == 0
        fits_tenant = t_in + nbytes <= self.tenant_max_bytes \
            or t_in == 0
        return fits_global and fits_tenant

    # bound on DISTINCT per-tenant gauge series: tenant ids arrive
    # from untrusted request bodies, and registry gauges are
    # permanent — without a cap a client cycling tenant strings grows
    # server memory and the /metrics output without bound.  Byte
    # accounting (self._tenant_inflight) stays exact per tenant (that
    # dict IS pruned on release); only the observability series fold
    # into "__other__" past the cap.
    MAX_TENANT_GAUGES = 256

    def _tenant_gauge(self, tenant: str):
        g = self._tenant_gauges.get(tenant)
        if g is None:
            if len(self._tenant_gauges) >= self.MAX_TENANT_GAUGES:
                tenant = "__other__"
                g = self._tenant_gauges.get(tenant)
                if g is not None:
                    return g
            from paimon_tpu_torch.metrics import SERVICE_TENANT_BYTES
            g = self._registry.service_metrics(tenant).gauge(
                SERVICE_TENANT_BYTES)
            self._tenant_gauges[tenant] = g
        return g

    def _admit_locked(self, nbytes: int, tenant: str):
        self._inflight += nbytes
        self._tenant_inflight[tenant] = \
            self._tenant_inflight.get(tenant, 0) + nbytes
        self._g_inflight.set(self._inflight)
        self._tenant_gauge(tenant).set(self._tenant_inflight[tenant])
        self._m_requests.inc()

    def _drain_locked(self):
        """Admit every waiter that now fits, LARGEST-FIRST (LPT like
        parallel/packing.py).  Called with the lock held after any
        release; a smaller waiter can slip past a larger one only when
        the larger one genuinely does not fit yet."""
        if not self._waiters:
            return
        for w in sorted(self._waiters,
                        key=lambda w: (-w.bytes, w.enqueued_at)):
            if w.admitted:
                continue
            if self._fits_locked(w.bytes, w.tenant):
                w.admitted = True
                self._admit_locked(w.bytes, w.tenant)
                w.event.set()
        self._waiters = [w for w in self._waiters if not w.admitted]
        self._g_queue.set(len(self._waiters))

    def set_shed_below(self, priority: int):
        """Brownout hook: shed acquires with priority < `priority`
        (0 restores normal admission)."""
        with self._lock:
            self._shed_below = int(priority)

    def acquire(self, tenant: str = DEFAULT_TENANT,
                nbytes: int = 1,
                priority: int = DEFAULT_PRIORITY) -> AdmissionTicket:
        """Block until `nbytes` fits under both the global and the
        tenant budget, then return the ticket.  Raises
        AdmissionRejected immediately when the wait queue is full,
        when brownout is shedding this request's priority class, or
        after service.queue.timeout with no capacity.  A request
        deadline (utils/deadline.py) bounds the queue wait: a spent
        deadline raises DeadlineExceededError (504), never parks the
        caller for the full queue timeout."""
        from paimon_tpu_torch.utils.deadline import current_deadline
        tenant = tenant or DEFAULT_TENANT
        nbytes = max(1, int(nbytes))
        t0 = time.perf_counter()
        dl = current_deadline()
        if dl is not None:
            dl.check("admission")
        with self._lock:
            if priority < self._shed_below:
                self._m_rejected.inc()
                self._m_sheds.inc()
                raise AdmissionRejected(
                    f"brownout: shedding priority<{self._shed_below} "
                    f"requests; retry later")
            # fast path only when nobody is queued: arrivals must not
            # starve the waiters the drain is ordering
            if not self._waiters and self._fits_locked(nbytes, tenant):
                self._admit_locked(nbytes, tenant)
                self._m_wait.update(0.0)
                return AdmissionTicket(self, nbytes, tenant)
            if len(self._waiters) >= self.queue_depth:
                self._m_rejected.inc()
                raise AdmissionRejected(
                    f"admission queue full "
                    f"({self.queue_depth} waiting); retry later")
            w = _Waiter(nbytes, tenant)
            self._waiters.append(w)
            self._g_queue.set(len(self._waiters))
            self._drain_locked()     # we may fit right now
        wait_s = self.queue_timeout_ms / 1000.0
        deadline_bound = dl is not None and \
            dl.remaining_s() < wait_s
        if deadline_bound:
            wait_s = dl.remaining_s()
        if w.event.wait(wait_s):
            self._m_wait.update((time.perf_counter() - t0) * 1000.0)
            return AdmissionTicket(self, nbytes, tenant)
        with self._lock:
            if w.admitted:
                # the drain won the race with the timeout: keep it
                self._m_wait.update((time.perf_counter() - t0) * 1000.0)
                return AdmissionTicket(self, nbytes, tenant)
            self._waiters.remove(w)
            self._g_queue.set(len(self._waiters))
            if not deadline_bound:
                self._m_rejected.inc()
        if deadline_bound:
            # the request's own deadline ran out first: that is a 504
            # (the caller's budget), not a 429 (our capacity)
            dl.check("admission")
        raise AdmissionRejected(
            f"no byte budget within {self.queue_timeout_ms}ms "
            f"({nbytes} bytes requested, {self._inflight} in flight); "
            f"retry later")

    def _release(self, ticket: AdmissionTicket):
        with self._lock:
            self._inflight -= ticket.bytes
            left = self._tenant_inflight.get(ticket.tenant, 0) \
                - ticket.bytes
            if left > 0:
                self._tenant_inflight[ticket.tenant] = left
            else:
                self._tenant_inflight.pop(ticket.tenant, None)
            self._g_inflight.set(self._inflight)
            self._tenant_gauge(ticket.tenant).set(max(0, left))
            self._drain_locked()
