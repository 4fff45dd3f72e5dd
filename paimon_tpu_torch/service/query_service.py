"""KV query service over LocalTableQuery: one replica of the fleet.

Counterpart of paimon_tpu/service/query_service.py.  reference:
paimon-service/.../KvQueryServer.java, KvQueryClient.java and
ServiceManager.java ('primary-key-lookup' address files under
`<table>/service/`); it serves remote lookup joins.  The transport is
HTTP + JSON on the event-loop engine (service/async_server.py):

* one shared LocalTableQuery (lookup/local_query.py) with a
  snapshot-refresh TTL answers every /lookup;
* the table's FileIO joins the process-wide shared byte-cache tier
  (service.cache.shared, fs/caching.py);
* every request passes admission control (service/admission.py; 429
  when the byte budget stays full) and the brownout ladder
  (service/brownout.py), under a deadline (service.request.timeout or
  the client's timeout_ms; 504);
* /scan is merge-on-read through the scan pipeline with a
  snapshot-keyed result cache, /changelog a per-consumer stream scan,
  and GET /healthz, /stats, /slo and /metrics (Prometheus) report the
  plane;
* the hot delta tier (service/delta.py) makes a serving writer's rows
  readable by /lookup before any flush or commit;
* replicas (`replica_id=`) run behind the consistent-hash router of
  service/router.py, sharing the byte-cache, SSD and delta tiers; a
  remote replica joins with `register_with_router`, and the client
  follows the router's /topology to the owning replica;
* warm boot (service.warmboot.enabled, service/warmboot.py) restores
  persisted SSTs and plan state at query-engine construction and
  persists them on shutdown or POST /warmboot.

Every read runs on the table's device: the merged fallback of
non-deduplicate tables and /scan merge with the winner-select kernel
on the card.
"""

from __future__ import annotations

import base64
import datetime
import decimal
import http.client
import json
import threading
from typing import List, Optional

from paimon_tpu_torch.lookup import LocalTableQuery
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.service.admission import (
    AdmissionController, AdmissionRejected,
)
from paimon_tpu_torch.service.async_server import (
    AsyncHttpServer, HttpRequest, HttpResponse,
)


# wire values that JSON carries as they are (most of every row)
_PLAIN = (str, int, float, bool, type(None))


def _encode_value(v):
    """JSON-safe encoding preserving types across the wire (datetime/
    date/time -> tagged ISO, Decimal -> tagged str, bytes -> tagged
    base64) so remote lookups return the same values as local ones."""
    if isinstance(v, _PLAIN):
        return v
    if isinstance(v, datetime.datetime):
        return {"__t": "dt", "v": v.isoformat()}
    if isinstance(v, datetime.date):
        return {"__t": "d", "v": v.isoformat()}
    if isinstance(v, datetime.time):
        return {"__t": "t", "v": v.isoformat()}
    if isinstance(v, decimal.Decimal):
        return {"__t": "dec", "v": str(v)}
    if isinstance(v, (bytes, bytearray)):
        return {"__t": "b", "v": base64.b64encode(v).decode()}
    if isinstance(v, list):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    return v


def _decode_value(v):
    if isinstance(v, _PLAIN):
        return v
    if isinstance(v, dict):
        tag = v.get("__t")
        if tag == "dt":
            return datetime.datetime.fromisoformat(v["v"])
        if tag == "d":
            return datetime.date.fromisoformat(v["v"])
        if tag == "t":
            return datetime.time.fromisoformat(v["v"])
        if tag == "dec":
            return decimal.Decimal(v["v"])
        if tag == "b":
            return base64.b64decode(v["v"])
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


__all__ = ["KvQueryServer", "KvQueryClient", "ServiceManager",
           "ServiceBusyError"]

PRIMARY_KEY_LOOKUP = "primary-key-lookup"

from contextlib import nullcontext as _nullcontext  # noqa: E402

_NULLCTX = _nullcontext()


class ServiceBusyError(RuntimeError):
    """The service answered 429: admission queue full or byte budget
    exhausted within the queue timeout.  Retry with backoff."""


class ServiceManager:
    """Address registry in the table dir (reference ServiceManager)."""

    def __init__(self, file_io, table_path: str):
        self.file_io = file_io
        self.dir = f"{table_path.rstrip('/')}/service"

    def _path(self, service: str) -> str:
        return f"{self.dir}/{service}"

    def register(self, service: str, address: str):
        self.file_io.write_bytes(self._path(service),
                                 json.dumps([address]).encode(),
                                 overwrite=True)

    def unregister(self, service: str):
        self.file_io.delete_quietly(self._path(service))

    def addresses(self, service: str) -> List[str]:
        if not self.file_io.exists(self._path(service)):
            return []
        return json.loads(self.file_io.read_bytes(self._path(service)))


class KvQueryServer:
    def __init__(self, table, host: str = "127.0.0.1", port: int = 0,
                 replica_id: int = 0, delta=None):
        opts = table.options
        if opts.get(CoreOptions.SERVICE_CACHE_SHARED):
            table = self._join_shared_cache(table)
        self.table = table
        self.options = table.options
        self.replica_id = int(replica_id)
        # hot delta tier: unflushed serving-writer rows merged into
        # every /lookup (shared process-wide by table path, so N
        # in-process replicas and the serving writer see ONE tier)
        if delta is None and table.primary_keys and \
                opts.get(CoreOptions.SERVICE_DELTA_ENABLED):
            from paimon_tpu_torch.service.delta import (
                delta_eligible, shared_delta_tier,
            )
            if delta_eligible(table):
                delta = shared_delta_tier(table)
        self._delta = delta
        # ONE LocalTableQuery shared by every /lookup (plan swaps
        # serialize; reads/builds/probes run concurrently across
        # handler threads).  Built lazily so non-pk tables can still
        # serve /scan and /changelog.
        self._query: Optional[LocalTableQuery] = None
        self._query_lock = threading.Lock()
        self.admission = AdmissionController(
            max_bytes=opts.get(CoreOptions.SERVICE_MAX_INFLIGHT_BYTES),
            tenant_max_bytes=opts.get(
                CoreOptions.SERVICE_TENANT_MAX_INFLIGHT_BYTES),
            queue_depth=opts.get(CoreOptions.SERVICE_QUEUE_DEPTH),
            queue_timeout_ms=opts.get(CoreOptions.SERVICE_QUEUE_TIMEOUT),
            table=table.name)
        self._scan_row_bytes = opts.get(CoreOptions.SERVICE_SCAN_ROW_BYTES)
        self._lookup_key_bytes = opts.get(
            CoreOptions.SERVICE_LOOKUP_KEY_BYTES)
        # tail tolerance: default end-to-end deadline (clients may
        # override per request with 'timeout_ms' / the
        # X-Request-Timeout-Ms header) + the brownout ladder
        self._request_timeout = opts.get(
            CoreOptions.SERVICE_REQUEST_TIMEOUT)
        from paimon_tpu_torch.service.brownout import BrownoutController
        self.brownout = BrownoutController(self.admission, opts)
        # fleet observability: sync the process-global trace/flight
        # switches from this table's options (explicit keys win), tag
        # the trace spool with the replica id, and stand up the SLO
        # burn-rate evaluator every response feeds
        from paimon_tpu_torch.obs import flight as _flight
        from paimon_tpu_torch.obs import trace as _trace
        _trace.sync_from_options(opts)
        _flight.sync_from_options(opts)
        _trace.set_replica_id(f"r{self.replica_id}")
        from paimon_tpu_torch.obs.slo import SloConfig, SloEvaluator
        self.slo = SloEvaluator(SloConfig.from_options(opts),
                                table=table.name)
        from paimon_tpu_torch.metrics import (
            SERVICE_CHANGELOG_MS, SERVICE_CONNECTIONS,
            SERVICE_LOOKUP_CPU_MS, SERVICE_LOOKUP_KEYS,
            SERVICE_LOOKUP_MS, SERVICE_LOOP_LAG_MS,
            SERVICE_SCAN_CACHE_HITS, SERVICE_SCAN_CACHE_MISSES,
            SERVICE_SCAN_MS, global_registry,
        )
        g = global_registry().service_metrics(table.name)
        self._m_lookup_ms = g.histogram(SERVICE_LOOKUP_MS)
        self._m_scan_ms = g.histogram(SERVICE_SCAN_MS)
        self._m_changelog_ms = g.histogram(SERVICE_CHANGELOG_MS)
        self._m_lookup_keys = g.counter(SERVICE_LOOKUP_KEYS)
        # per-key handler CPU (thread_time): the honest denominator
        # behind qps headlines — wall latency can hide in IO waits,
        # CPU per key cannot
        self._m_lookup_cpu = g.histogram(SERVICE_LOOKUP_CPU_MS)
        # warm boot (service/warmboot.py): restore at query-engine
        # construction, persist on shutdown or explicit POST /warmboot
        from paimon_tpu_torch.service import warmboot as _warmboot
        self._warmboot_dir = None
        if opts.get(CoreOptions.SERVICE_WARMBOOT_ENABLED):
            base = _warmboot.warmboot_dir(opts)
            if base:
                self._warmboot_dir = _warmboot.table_state_dir(
                    base, table)
        self.last_warm_restore: Optional[dict] = None
        # the event-loop engine (service/async_server.py): handlers
        # run on the bounded service.workers pool; the loop thread
        # owns every socket and pipelined keep-alive parse
        self.server = AsyncHttpServer(
            host, port, self._handle,
            workers=opts.get(CoreOptions.SERVICE_WORKERS),
            max_connections=opts.get(CoreOptions.SERVICE_MAX_CONNECTIONS),
            name=f"paimon-serve-r{self.replica_id}",
            lag_histogram=g.histogram(SERVICE_LOOP_LAG_MS),
            connections_gauge=g.gauge(SERVICE_CONNECTIONS))
        self.port = self.server.port
        self.address = f"http://{host}:{self.port}"
        self.services = ServiceManager(table.file_io, table.path)
        # per-consumer streaming changelog scans (/changelog): each
        # consumer id owns a DataTableStreamScan whose position only
        # advances when that consumer polls, plus a pending-rows
        # carryover so large batches stream out in bounded chunks.
        # LRU-bounded: a client cycling consumer ids cannot grow
        # server memory without bound (an evicted consumer restarts
        # from a fresh scan).  One lock serializes plan+read per
        # request — stream scans are stateful and the HTTP server is
        # threaded.
        from collections import OrderedDict
        self._streams = OrderedDict()
        self._streams_lock = threading.Lock()
        self.max_changelog_consumers = 256
        self.changelog_max_rows = 10_000
        # snapshot-keyed scan result cache: a bounded /scan is a PURE
        # function of (snapshot, limit, projection) — the same request
        # against the same snapshot merges the same runs to the same
        # rows, so serving plane scans pay the merge once per
        # snapshot, not once per request.  A commit changes the
        # snapshot id and therefore the key; LRU-bounded.  Disabled
        # under record-level expire: row visibility there changes
        # with the CLOCK, not the snapshot id, so the key would lie
        self._scan_cache = OrderedDict()
        self._scan_cache_lock = threading.Lock()
        self.max_scan_cache_entries = 64
        self._scan_cache_enabled = \
            not opts.record_level_expire_time_ms
        self._m_scan_cache_hits = g.counter(SERVICE_SCAN_CACHE_HITS)
        self._m_scan_cache_misses = g.counter(
            SERVICE_SCAN_CACHE_MISSES)

    @staticmethod
    def _join_shared_cache(table):
        """Rewrap the table over the process-wide shared byte-cache
        tier (whole-file + block-range), so every request this server
        — and every other server/table in the process — serves warms
        one bounded cache.  The rewrapped table keeps the caller's
        device and dynamic options (its schema carries them)."""
        from paimon_tpu_torch.fs.caching import (
            CachingFileIO, shared_cache_state, shared_disk_tier,
        )
        # grow the shared tier FIRST: a table already wrapped by
        # read.cache.range rides the shared state with whole-file
        # capacity 0 — the serving plane's whole-file tier must turn
        # on for it too, not only for unwrapped tables
        state = shared_cache_state(
            256 << 20,
            table.options.get(CoreOptions.READ_CACHE_RANGE_MAX_BYTES))
        disk_dir = table.options.get(CoreOptions.CACHE_DISK_DIR)
        if disk_dir:
            # the serving plane rides the host-SSD second tier too:
            # memory-LRU demotions land on disk and cold requests are
            # answered from SSD before the object store
            state.attach_disk(
                shared_disk_tier(disk_dir, table.options.get(
                    CoreOptions.CACHE_DISK_MAX_BYTES)),
                promote_hits=table.options.get(
                    CoreOptions.CACHE_DISK_PROMOTE_HITS))
        if isinstance(table.file_io, CachingFileIO):
            # already caching (shared state grown above if it rides
            # it; an explicitly-constructed private wrapper keeps its
            # own configuration)
            return table
        wrapped = CachingFileIO(table.file_io, state=state)
        return type(table)(wrapped, table.path, table.schema,
                           device=table.device, branch=table.branch)

    def query(self) -> LocalTableQuery:
        """The shared serving-side point-lookup engine (pk tables)."""
        with self._query_lock:
            if self._query is None:
                q = LocalTableQuery(
                    self.table,
                    refresh_interval_ms=self.options.get(
                        CoreOptions.SERVICE_LOOKUP_REFRESH_INTERVAL),
                    delta=self._delta)
                if self._warmboot_dir is not None:
                    # adopt persisted SSTs and plan state before the
                    # first lookup: a warm replica's first batch runs
                    # with reader_builds == 0 and no cold manifest walk
                    from paimon_tpu_torch.service import warmboot
                    self.last_warm_restore = \
                        warmboot.restore_serving_state(
                            q, self._warmboot_dir)
                self._query = q
            return self._query

    def persist_warm_state(self) -> dict:
        """Persist the current serving state (built SSTs and plan-cache
        state) for warm boot; {"ssts": 0, ...} when warm boot is off or
        nothing is built yet."""
        with self._query_lock:
            q = self._query
        if q is None or self._warmboot_dir is None:
            return {"ssts": 0, "snapshot_id": None, "plan": False}
        from paimon_tpu_torch.service import warmboot
        return warmboot.persist_serving_state(q, self._warmboot_dir)

    def new_serving_writer(self, commit_user: Optional[str] = None):
        """A writer whose rows are readable via /lookup IMMEDIATELY —
        before any flush or commit — through the hot delta tier
        (service/delta.py).  One serving writer per table: delta
        visibility assumes its per-bucket sequence numbers are the
        newest in flight."""
        if self._delta is None:
            from paimon_tpu_torch.service.delta import delta_ineligible_reason
            raise ValueError(
                "delta tier unavailable: "
                + (delta_ineligible_reason(self.table)
                   or "service.delta.enabled=false"))
        from paimon_tpu_torch.service.delta import ServingWriter
        return ServingWriter(self.table, self._delta,
                             commit_user=commit_user)

    def start(self) -> "KvQueryServer":
        self.server.start()
        self.services.register(PRIMARY_KEY_LOOKUP, self.address)
        return self

    def register_with_router(self, router_address: str) -> dict:
        """Join a (possibly cross-machine) router's hash ring: POST
        this replica's (id, address) to the router's /register.  The
        router health-checks us from then on; pair with a warm-boot
        restore for a joiner that serves its first lookup hot."""
        import http.client
        host, port = KvQueryClient._hostport(router_address)
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.request(
                "POST", "/register",
                json.dumps({"id": self.replica_id,
                            "address": self.address}).encode(),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read() or b"{}")
            if resp.status != 200:
                raise RuntimeError(
                    f"router refused registration: {body}")
            return body
        finally:
            conn.close()

    def stop(self):
        self.services.unregister(PRIMARY_KEY_LOOKUP)
        self.shutdown()

    def shutdown(self):
        """Teardown minus the service-registry unregister (ReplicaSet
        replicas never registered; the router did): stop the engine,
        restore the process-wide degraded switch, drop lookup state."""
        self.server.stop()
        # the process-wide degraded switch must not outlive the server
        self.brownout.reset()
        # flush the trace spool/export: a replica's last serving spans
        # must reach it even when it exits between pipeline completion
        # points
        from paimon_tpu_torch.obs.trace import maybe_export
        maybe_export()
        # persist before close drops the SST store: a restarting replica
        # finds this one's warm state on the shared SSD tier
        if self._warmboot_dir is not None:
            try:
                self.persist_warm_state()
            # warm-state persist is advisory: a failed snapshot must not
            # block shutdown; the next boot is simply cold
            except Exception:
                pass
        with self._query_lock:
            if self._query is not None:
                self._query.close()
                self._query = None

    # -- request dispatch (runs on the engine's worker pool) -----------------

    def _json_response(self, status: int, obj,
                       headers: Optional[dict] = None) -> HttpResponse:
        hdrs = {"X-Replica-Id": str(self.replica_id)}
        if headers:
            hdrs.update(headers)
        return HttpResponse(status, json.dumps(obj).encode(),
                            headers=hdrs)

    def _handle(self, req: HttpRequest) -> HttpResponse:
        if req.method == "GET":
            return self._handle_get(req)
        if req.method == "POST":
            return self._handle_post(req)
        return self._json_response(405, {"error": "method not allowed"})

    def _handle_get(self, req: HttpRequest) -> HttpResponse:
        """GET /metrics (Prometheus text exposition of the whole
        process registry, rendered from MetricRegistry.snapshot_rows —
        the one serialization of the registry), GET /healthz
        (brownout + engine + delta introspection), GET /stats (this
        replica's obs summary as JSON) and GET /slo."""
        if req.path == "/healthz":
            # tail-tolerance introspection: brownout rung, breaker
            # states, queue pressure, recent 429/504 rates — plus the
            # replica id, pinned snapshot, delta-tier size and
            # event-loop lag: the operator's one-glance view of HOW
            # degraded the plane currently is and WHO answered
            try:
                self.brownout.observe()
                return self._json_response(200, self.healthz())
            except Exception as e:      # noqa: BLE001
                return self._json_response(500, {"error": str(e)})
        if req.path == "/stats":
            try:
                return self._json_response(200, self.stats())
            except Exception as e:      # noqa: BLE001
                return self._json_response(500, {"error": str(e)})
        if req.path == "/slo":
            # burn rates + alert state NOW (also refreshes the `slo`
            # Prometheus gauges, so a scrape can't disagree)
            try:
                return self._json_response(200, self.slo.evaluate())
            except Exception as e:      # noqa: BLE001
                return self._json_response(500, {"error": str(e)})
        if req.path != "/metrics":
            return self._json_response(404, {"error": "not found"})
        try:
            from paimon_tpu_torch.obs.export import render_prometheus
            return HttpResponse(
                200, render_prometheus().encode(),
                content_type="text/plain; version=0.0.4; charset=utf-8",
                headers={"X-Replica-Id": str(self.replica_id)})
        except Exception as e:      # noqa: BLE001
            return HttpResponse(500, str(e).encode(),
                                content_type="text/plain")

    def healthz(self) -> dict:
        """The /healthz body: the brownout controller's view plus the
        serving-engine vitals this replica owns."""
        body = self.brownout.healthz()
        with self._query_lock:
            snap = self._query.snapshot_id \
                if self._query is not None else None
        body.update({
            "replica_id": self.replica_id,
            "snapshot_id": snap,
            "delta": None if self._delta is None
            else self._delta.stats(),
            "event_loop": {
                "recent_lag_ms": round(self.server.recent_lag_ms, 3),
                "connections": self.server.connection_count,
            },
        })
        return body

    def stats(self) -> dict:
        """This replica's obs-plane summary (request-latency histograms
        as percentiles), without parsing the Prometheus text."""
        def h(hist):
            return {"count": hist.total_count,
                    "p50": round(hist.percentile(50), 4),
                    "p95": round(hist.percentile(95), 4),
                    "p99": round(hist.percentile(99), 4),
                    # trailing window samples: pooled across replicas
                    # they give a true fleet percentile (per-replica
                    # p95s cannot be merged)
                    "window": [round(v, 4)
                               for v in hist.window_values()]}
        with self._query_lock:
            snap = self._query.snapshot_id \
                if self._query is not None else None
        from paimon_tpu_torch.metrics import (
            LOOKUP_NATIVE_FALLBACKS, LOOKUP_NATIVE_PROBES,
            LOOKUP_READER_BUILDS, LOOKUP_READER_REUSES,
            global_registry,
        )
        lg = global_registry().lookup_metrics()
        return {"replica_id": self.replica_id,
                "snapshot_id": snap,
                "lookup_ms": h(self._m_lookup_ms),
                "scan_ms": h(self._m_scan_ms),
                "lookup_keys": self._m_lookup_keys.count,
                "lookup_cpu_per_key_ms": h(self._m_lookup_cpu),
                # process-global lookup-plane counters: SST builds and
                # the native-probe health (fallbacks must not move in
                # steady state)
                "lookup": {
                    "reader_builds":
                        lg.counter(LOOKUP_READER_BUILDS).count,
                    "reader_reuses":
                        lg.counter(LOOKUP_READER_REUSES).count,
                    "native_probes":
                        lg.counter(LOOKUP_NATIVE_PROBES).count,
                    "native_fallbacks":
                        lg.counter(LOOKUP_NATIVE_FALLBACKS).count,
                },
                "warm_restore": self.last_warm_restore,
                "delta": None if self._delta is None
                else self._delta.stats()}

    def _handle_post(self, req: HttpRequest) -> HttpResponse:
        if req.path == "/warmboot":
            # explicit persist: hard-link the built SSTs and the plan
            # state onto the shared SSD tier now, so replicas that
            # register after this call boot warm
            try:
                return self._json_response(200,
                                           self.persist_warm_state())
            except Exception as e:      # noqa: BLE001 -- answered 500
                return self._json_response(500, {"error": str(e)})
        if req.path == "/lookup":
            handle, timer = self._lookup, self._m_lookup_ms
        elif req.path == "/scan":
            handle, timer = self._scan, self._m_scan_ms
        elif req.path == "/changelog":
            handle, timer = self._changelog, self._m_changelog_ms
        else:
            return self._json_response(404, {"error": "not found"})
        try:
            body = json.loads(req.body or b"{}")
        except ValueError:
            return self._json_response(400, {"error": "invalid JSON"})
        import time as _time

        from paimon_tpu_torch.utils.deadline import (
            DeadlineExceededError, deadline_scope,
        )
        # end-to-end deadline: client-supplied per request (body
        # 'timeout_ms' or X-Request-Timeout-Ms header) else
        # service.request.timeout; every blocking wait downstream
        # (admission queue, prefetch byte budget, retry sleeps, store
        # IO) honors it
        timeout_ms = body.get("timeout_ms")
        if timeout_ms is None:
            timeout_ms = req.headers.get("x-request-timeout-ms")
        if timeout_ms is None:
            timeout_ms = self._request_timeout
        # NOTE explicit None checks, not `or`: timeout_ms=0 is a real
        # (already-expired) deadline the caller asked for, not an
        # absent one
        if timeout_ms is not None:
            try:
                timeout_ms = float(timeout_ms)
            except (TypeError, ValueError):
                # malformed CLIENT input is a 400, not a 500
                return self._json_response(
                    400, {"error": f"invalid timeout_ms: "
                                   f"{timeout_ms!r}"})
        self.brownout.observe()
        t0 = _time.perf_counter()
        try:
            with deadline_scope(timeout_ms):
                out = handle(body)
            status, payload = 200, out
        except DeadlineExceededError as e:
            # the request's budget is spent: in-flight work for it was
            # cancelled/abandoned downstream; tell the caller the
            # truth with a 504
            status, payload = 504, {"error": str(e), "deadline": True}
        except AdmissionRejected as e:
            status, payload = 429, {"error": str(e), "busy": True}
        except Exception as e:      # noqa: BLE001
            status, payload = 500, {"error": str(e)}
        self.brownout.record_outcome(status)
        # every data-path response is an SLO event — INCLUDING sheds
        # and deadline misses; that is exactly what the availability
        # objective counts
        self.slo.observe(status, (_time.perf_counter() - t0) * 1000.0)
        if status not in (429, 504):
            # 429s spent their time in the admission queue and 504s
            # are deadline-bounded by construction —
            # admission_wait_ms / rejected / deadline_exceeded tell
            # those stories; folding them into the service-time
            # histograms would corrupt p95/p99
            timer.update((_time.perf_counter() - t0) * 1000.0)
        return self._json_response(status, payload)

    @staticmethod
    def _tenant(req) -> str:
        return str(req.get("tenant") or "default")

    @staticmethod
    def _priority(req) -> int:
        from paimon_tpu_torch.service.admission import DEFAULT_PRIORITY
        try:
            return int(req.get("priority", DEFAULT_PRIORITY))
        except (TypeError, ValueError):
            return DEFAULT_PRIORITY

    def _lookup(self, req):
        import time as _time
        keys = req["keys"]
        est = max(1, len(keys)) * self._lookup_key_bytes
        # thread CPU, not wall: admission-queue and IO waits burn no
        # CPU on this thread, so the quotient is honest handler cost
        cpu0 = _time.thread_time()
        with self.admission.acquire(self._tenant(req), est,
                                    self._priority(req)):
            rows = self.query().lookup(
                [{k: _decode_value(v) for k, v in d.items()}
                 for d in keys],
                partition=tuple(_decode_value(v)
                                for v in req.get("partition") or ()))
        self._m_lookup_cpu.update(
            (_time.thread_time() - cpu0) * 1000.0 / max(1, len(keys)))
        self._m_lookup_keys.inc(len(keys))
        return {"rows": [None if r is None else
                         {k: _encode_value(x) for k, x in r.items()}
                         for r in rows]}

    def _changelog(self, req):
        """Streaming changelog poll (table/stream_scan.py): each
        consumer id resumes its own follow-up scan, so repeated polls
        stream snapshot-by-snapshot changes with row kinds
        (`_ROW_KIND`).  `caught_up` signals 'poll again later' — the
        stream never ends.  Serving is read-only on committed
        snapshots: it stays available while ingest or compaction are
        down (the daemon's degradation contract)."""
        consumer = str(req.get("consumer") or "default")
        limit = int(req.get("max_rows") or self.changelog_max_rows)
        est = max(1, limit) * self._scan_row_bytes
        with self.admission.acquire(self._tenant(req), est,
                                    self._priority(req)), \
                self._streams_lock:
            entry = self._streams.get(consumer)
            if entry is None:
                entry = {"scan": self.table
                         .new_read_builder().new_stream_scan(),
                         "pending": [], "plan": None}
                self._streams[consumer] = entry
                while len(self._streams) > \
                        self.max_changelog_consumers:
                    self._streams.popitem(last=False)
            self._streams.move_to_end(consumer)
            snapshot_id = None
            if not entry["pending"]:
                # a plan may be PARKED from a prior poll whose
                # materialization ticket 429'd — the stream scan has
                # already advanced past it, so it must be retried,
                # never re-planned (rows would be lost)
                plan = entry.get("plan") or entry["scan"].plan()
                if plan is None:
                    return {"rows": [], "snapshot_id": None,
                            "caught_up": True, "more": False}
                entry["plan"] = plan
                # the initial ticket only covers the poll;
                # materializing the snapshot delta is the real
                # allocation — charge its on-disk bytes before reading
                # (AdmissionRejected -> 429 with the plan parked for
                # the consumer's retry)
                delta = sum(f.file_size for s in plan.splits
                            for f in s.data_files)
                extra = max(0, delta - est)
                with self.admission.acquire(
                        self._tenant(req), extra,
                        self._priority(req)) if extra else _NULLCTX:
                    entry["pending"] = self.table \
                        .new_read_builder().new_read() \
                        .to_arrow(plan).to_pylist()
                snapshot_id = plan.snapshot_id
                entry["plan"] = None
            rows = entry["pending"][:limit]
            entry["pending"] = entry["pending"][limit:]
            more = bool(entry["pending"])
        return {"rows": [{k: _encode_value(v) for k, v in r.items()}
                         for r in rows],
                "snapshot_id": snapshot_id,
                "caught_up": False, "more": more}

    def _scan(self, req):
        """Bounded table scan through the pipelined split reader
        (parallel/scan_pipeline.py): splits stream through the
        prefetch pipeline and admission stops as soon as `limit` rows
        are buffered.  The admission charge is limit x
        service.scan.row-bytes-estimate — known BEFORE the plan, so
        even the manifest walk (heavy fan-in on large tables) runs
        under the ticket, never ahead of the byte budget."""
        limit = req.get("limit")
        limit = 10_000 if limit is None else int(limit)
        est = max(1, limit) * self._scan_row_bytes
        projection = tuple(req.get("projection") or ())
        with self.admission.acquire(self._tenant(req), est,
                                    self._priority(req)):
            rb = self.table.new_read_builder()
            if projection:
                rb = rb.with_projection(list(projection))
            rb = rb.with_limit(limit)
            plan = rb.new_scan().plan()
            # snapshot-keyed result cache: same snapshot + same args
            # = same rows (the plan above re-checks the snapshot, so
            # a commit invalidates by changing the key); bypassed
            # when row visibility is clock-dependent (record-level
            # expire)
            key = (plan.snapshot_id, limit, projection)
            if self._scan_cache_enabled:
                with self._scan_cache_lock:
                    cached = self._scan_cache.get(key)
                    if cached is not None:
                        self._scan_cache.move_to_end(key)
                if cached is not None:
                    self._m_scan_cache_hits.inc()
                    return cached
                self._m_scan_cache_misses.inc()
            t = rb.new_read().to_arrow(plan.splits)
        out = {"rows": [{k: _encode_value(v) for k, v in r.items()}
                        for r in t.to_pylist()],
               "snapshot_id": plan.snapshot_id}
        if self._scan_cache_enabled:
            with self._scan_cache_lock:
                self._scan_cache[key] = out
                while len(self._scan_cache) > \
                        self.max_scan_cache_entries:
                    self._scan_cache.popitem(last=False)
        return out


class KvQueryClient:
    """Remote point lookups; resolves the server address from the
    table's service registry (reference KvQueryClient + ServiceManager
    discovery).

    Holds persistent keep-alive connections (http.client) —
    reconnecting per request would dominate sub-ms point-get latency
    — and transparently reopens one when the server or an idle timeout
    dropped the socket (one retry, then the error surfaces).
    Thread-safe: a lock serializes requests on the shared connections.

    It follows the router (service/router.py): on first use the
    client probes GET /topology once; against a ReplicaRouter it builds
    the same consistent-hash ring and talks to this tenant's owning
    replica directly (one connection per replica), skipping the proxy
    hop.  Against a plain replica the probe 404s and the single-address
    path runs.  `last_replica` surfaces which replica answered the most
    recent request (the X-Replica-Id debug header)."""

    def __init__(self, table=None, address: Optional[str] = None,
                 tenant: str = "default",
                 priority: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 follow_topology: bool = True):
        if address is None:
            if table is None:
                raise ValueError("need a table or an address")
            addrs = ServiceManager(table.file_io, table.path) \
                .addresses(PRIMARY_KEY_LOOKUP)
            if not addrs:
                raise RuntimeError(
                    "no primary-key-lookup service registered")
            address = addrs[0]
        self.address = address.rstrip("/")
        self.tenant = tenant
        self.priority = priority          # None = server default (100)
        self.timeout_ms = timeout_ms      # per-request deadline -> 504
        self._follow = follow_topology
        self._ring = None                 # HashRing once discovered
        self._topology_checked = False
        self._conns: dict = {}            # address -> HTTPConnection
        self._lock = threading.Lock()
        self.reconnects = 0          # observable: stale-socket reopens
        self.last_replica: Optional[str] = None   # X-Replica-Id

    @staticmethod
    def _hostport(address: str):
        hostport = address.rstrip("/").split("://", 1)[-1]
        host, _, port = hostport.partition(":")
        return host, int(port) if port else 80

    @property
    def _conn(self):
        """The base-address connection (kept for introspection: tests
        kill its socket to exercise the stale-reconnect path)."""
        return self._conns.get(self.address)

    def close(self):
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()

    def __enter__(self) -> "KvQueryClient":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _ensure_topology_locked(self, timeout: int):
        """One-shot router discovery: a ReplicaRouter answers
        /topology with the ring; a plain replica 404s (or refuses) and
        the classic single-address path stays."""
        if self._topology_checked or not self._follow:
            return
        self._topology_checked = True
        host, port = self._hostport(self.address)
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request("GET", "/topology")
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                return
            topo = json.loads(data)
            if not topo.get("router"):
                return
            from paimon_tpu_torch.service.router import HashRing
            # the router's own ring: suspended replicas left it (the
            # reference builds the ring over every replica, suspended
            # ones too, and sends their tenants to a dead address)
            suspended = set(topo.get("suspended") or ())
            self._ring = HashRing(
                [r for r in topo["replicas"] if r["id"] not in suspended],
                topo.get("virtual_nodes", 64))
        except (http.client.HTTPException, ConnectionError, OSError,
                ValueError, KeyError):
            pass          # no topology: single-address path
        finally:
            conn.close()

    def _target_address(self) -> str:
        if self._ring is None:
            return self.address
        return self._ring.pick(self.tenant)["address"].rstrip("/")

    def _post(self, endpoint: str, body: dict, timeout: int,
              idempotent: bool = True) -> dict:
        """POST json on the persistent connection to this tenant's
        target (the owning replica when a ring is known).  429 raises
        ServiceBusyError (admission control pushed back); other
        server-side errors ({"error"} bodies) surface as RuntimeError
        with the server's message.

        Stale-socket handling: a reused keep-alive socket that dies
        while SENDING the request reconnects and resends once (the
        server saw nothing).  A death AFTER the request was sent is
        ambiguous — the server may have processed it — so only
        `idempotent` endpoints (lookup/scan: re-execution is wasted
        work, never wrong) resend; /changelog advances per-consumer
        server state, so its ambiguous failures surface to the caller
        instead of silently skipping a batch."""
        body = dict(body)
        body.setdefault("tenant", self.tenant)
        if self.priority is not None:
            body.setdefault("priority", self.priority)
        if self.timeout_ms is not None:
            body.setdefault("timeout_ms", self.timeout_ms)
        payload = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        from paimon_tpu_torch.obs.trace import (
            STAGE_CLIENT_REQUEST, inject_headers, span,
        )
        # the client-side hop span: inject_headers mints the 128-bit
        # trace id (first hop) and stamps X-Trace-Id/X-Parent-Span so
        # the server's serve.request span records this one as its
        # remote parent — the merged fleet trace draws the arrow
        with span(STAGE_CLIENT_REQUEST, cat="serve",
                  endpoint=endpoint):
            inject_headers(headers)
            return self._post_conn(endpoint, payload, headers, timeout,
                                   idempotent)

    def _post_conn(self, endpoint: str, payload: bytes, headers: dict,
                   timeout: int, idempotent: bool) -> dict:
        with self._lock:
            self._ensure_topology_locked(timeout)
            address = self._target_address()
            host, port = self._hostport(address)
            for attempt in (0, 1):
                conn = self._conns.get(address)
                fresh = conn is None
                if fresh:
                    conn = http.client.HTTPConnection(
                        host, port, timeout=timeout)
                sent = False
                try:
                    if not fresh:
                        conn.timeout = timeout
                        if conn.sock is not None:
                            conn.sock.settimeout(timeout)
                    conn.request("POST", f"/{endpoint}", payload,
                                 headers)
                    sent = True
                    resp = conn.getresponse()
                    data = resp.read()
                    status = resp.status
                    replica = resp.getheader("X-Replica-Id")
                # the stale keep-alive reconnect,
                # deliberately narrower than the store ladder: exactly
                # one resend, only for idempotent work on a reused
                # socket, never on timeout (see the guard below)
                except (http.client.HTTPException, ConnectionError,
                        BrokenPipeError, OSError) as e:
                    conn.close()
                    self._conns.pop(address, None)
                    # a FRESH connection that fails is a real error;
                    # only a reused socket gets the stale-retry, and
                    # only when resending cannot double-execute
                    # non-idempotent server work.  A TIMEOUT is not a
                    # stale socket: the server is still processing —
                    # resending would double both the work and the
                    # effective wait exactly when it is saturated
                    if fresh or attempt or isinstance(e, TimeoutError) \
                            or (sent and not idempotent):
                        raise RuntimeError(
                            f"{endpoint} failed: {e}") from e
                    self.reconnects += 1
                    continue
                self._conns[address] = conn
                if replica is not None:
                    self.last_replica = replica
                if status == 200:
                    return json.loads(data)
                try:
                    detail = json.loads(data).get("error", "")
                except ValueError:
                    detail = data.decode(errors="replace")
                if status == 429:
                    raise ServiceBusyError(
                        f"{endpoint} rejected: {detail}")
                if status == 504:
                    from paimon_tpu_torch.utils.deadline import (
                        DeadlineExceededError,
                    )
                    raise DeadlineExceededError(
                        f"{endpoint} timed out server-side: {detail}")
                raise RuntimeError(f"{endpoint} failed: {detail}")

    def healthz(self) -> dict:
        """GET /healthz: brownout rung, breaker states, queue depth
        and recent 429/504 rates (one-shot connection — health checks
        must not contend on the request socket)."""
        host, port = self._hostport(self.address)
        conn = http.client.HTTPConnection(host, port, timeout=10)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"healthz failed: {resp.status} "
                    f"{data.decode(errors='replace')}")
            return json.loads(data)
        finally:
            conn.close()

    def slo(self) -> dict:
        """GET /slo: multi-window burn rates + alert state for the
        replica's declared objectives (one-shot connection, like
        healthz)."""
        host, port = self._hostport(self.address)
        conn = http.client.HTTPConnection(host, port, timeout=10)
        try:
            conn.request("GET", "/slo")
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"slo failed: {resp.status} "
                    f"{data.decode(errors='replace')}")
            return json.loads(data)
        finally:
            conn.close()

    def lookup(self, keys: List[dict],
               partition: tuple = ()) -> List[Optional[dict]]:
        payload = self._post(
            "lookup",
            {"keys": [{k: _encode_value(v) for k, v in d.items()}
                      for d in keys],
             "partition": [_encode_value(v) for v in partition]},
            timeout=30)
        return [None if r is None else
                {k: _decode_value(v) for k, v in r.items()}
                for r in payload["rows"]]

    def lookup_row(self, key: dict,
                   partition: tuple = ()) -> Optional[dict]:
        return self.lookup([key], partition)[0]

    def scan(self, projection: Optional[List[str]] = None,
             limit: int = 10_000) -> List[dict]:
        """Bounded remote scan (served by the pipelined reader)."""
        payload = self._post("scan", {"projection": projection,
                                      "limit": limit}, timeout=60)
        return [{k: _decode_value(v) for k, v in r.items()}
                for r in payload["rows"]]

    def changelog(self, consumer: str = "default",
                  max_rows: Optional[int] = None) -> dict:
        """Poll the next changelog batch for `consumer` (rows carry
        `_ROW_KIND`); {"caught_up": True} means poll again later, and
        {"more": True} means the current snapshot has further chunks —
        poll immediately (large batches stream out bounded;
        `snapshot_id` is reported on a chunk's first page only)."""
        payload = self._post("changelog",
                             {"consumer": consumer,
                              "max_rows": max_rows}, timeout=60,
                             idempotent=False)
        payload["rows"] = [{k: _decode_value(v) for k, v in r.items()}
                           for r in payload["rows"]]
        return payload
