"""Horizontal read replicas: N query servers behind one router.

Counterpart of paimon_tpu/service/router.py; `HashRing` is the same
sha1 ring, so both packages pick the same replica for a tenant.  It
mirrors the reference's dedicated query-service topology
(paimon-service/: a fleet of KvQueryServers fronted by address
discovery) scaled onto this repo's serving plane:

* `ReplicaSet` runs N `KvQueryServer` replicas over ONE table in this
  process.  They share everything sharable — the process-wide byte
  cache (`fs/caching.shared_cache_state`), the host-SSD tier, and the
  hot delta tier (`service/delta.py`, shared by table path) — while
  each replica pins its own snapshot plan (`LocalTableQuery`) and owns
  its own admission budget.  Snapshot advance on ANY replica
  invalidates dropped files for EVERY replica through the existing
  `evict_dropped_file()` hook: the byte-cache tier is process-wide, so
  one replica's plan reload evicts the stale blocks everywhere before
  its new plan serves.
* `ReplicaRouter` fronts the replicas with CONSISTENT HASHING of
  tenants (`service.replicas.virtual-nodes` points per replica on a
  sha1 ring): one tenant's requests always land on the same replica —
  its SSTs, pinned blocks and changelog consumer state stay warm there
  — and adding/removing a replica moves only ~1/N of the tenants.
  The router is itself an event-loop server (service/async_server.py);
  it answers:

      POST /lookup /scan /changelog   forwarded to the owning replica
      POST /register                  {"id", "address"}: a replica on
                                      ANOTHER MACHINE joins the ring
      POST /deregister                {"id"}: planned leave
      GET  /topology                  the ring: replica ids+addresses
      GET  /healthz                   per-replica healthz + a rollup
      GET  /metrics                   Prometheus; remote replicas are
                                      re-labeled replica="<id>"

  In-process replicas are dispatched DIRECTLY (function call, no
  second TCP hop — Netty's local channel, in spirit); remote replicas
  (other processes sharing the SSD tier) forward over pooled
  keep-alive connections.  Registered remotes are health-checked every
  `service.replicas.health-interval`: two consecutive failed GET
  /healthz probes suspend a replica OUT of the ring (its tenants
  rehash to survivors), the first success re-admits it — in-process
  replicas are never probed, their liveness is the process's.
* smart clients skip the hop entirely: `KvQueryClient` fetches
  /topology once, builds the SAME ring, and talks to the owning
  replica directly — the router is the dumb-client path and the
  topology authority, not a mandatory proxy.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import re
import threading
from bisect import bisect_right
from typing import Dict, List, Optional

from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.service.async_server import (
    AsyncHttpServer, HttpRequest, HttpResponse,
)

__all__ = ["HashRing", "ReplicaRouter", "ReplicaSet"]


class HashRing:
    """Consistent-hash ring: `vnodes` sha1 points per node; a key maps
    to the first point clockwise.  Client and router build IDENTICAL
    rings from the same (id, address) list, so direct-to-replica
    routing agrees with proxied routing."""

    def __init__(self, nodes: List[dict], vnodes: int = 64):
        self.nodes = list(nodes)
        self.vnodes = max(1, int(vnodes))
        points = []
        for node in self.nodes:
            ident = f"{node['id']}:{node['address']}"
            for v in range(self.vnodes):
                h = int.from_bytes(hashlib.sha1(
                    f"{ident}#{v}".encode()).digest()[:8], "big")
                points.append((h, node))
        points.sort(key=lambda p: p[0])
        self._hashes = [p[0] for p in points]
        self._points = [p[1] for p in points]

    def pick(self, tenant: str) -> dict:
        if not self._points:
            raise RuntimeError("empty hash ring")
        h = int.from_bytes(
            hashlib.sha1(str(tenant).encode()).digest()[:8], "big")
        i = bisect_right(self._hashes, h) % len(self._points)
        return self._points[i]


class _UpstreamPool:
    """Tiny keep-alive connection pool per upstream address (the
    router's forwarding path for REMOTE replicas)."""

    def __init__(self, address: str, timeout: float = 60.0):
        hostport = address.rstrip("/").split("://", 1)[-1]
        host, _, port = hostport.partition(":")
        self.host, self.port = host, int(port) if port else 80
        self.timeout = timeout
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def request(self, method: str, path: str, body: bytes,
                headers: Dict[str, str]):
        """One proxied round trip; returns (status, body, headers).
        A dead pooled socket retries once on a fresh connection."""
        for attempt in (0, 1):
            with self._lock:
                conn = self._idle.pop() if self._idle else None
            fresh = conn is None
            if fresh:
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout)
            try:
                conn.request(method, path, body, headers)
                resp = conn.getresponse()
                data = resp.read()
                out_headers = dict(resp.getheaders())
                status = resp.status
            # lint-ok: fault-taxonomy stale keep-alive reconnect,
            # deliberately narrower than the store ladder: one resend
            # on a reused pooled socket, a fresh connection's failure
            # raises immediately
            except (http.client.HTTPException, ConnectionError,
                    OSError):
                conn.close()
                if fresh or attempt:
                    raise
                continue
            with self._lock:
                if len(self._idle) < 32:
                    self._idle.append(conn)
                else:
                    conn.close()
            return status, data, out_headers

    def close(self):
        with self._lock:
            for c in self._idle:
                c.close()
            self._idle.clear()


class ReplicaRouter:
    """Consistent-hash front end over replicas (see module docstring).
    Construct with in-process `servers` (direct dispatch) or remote
    `addresses` (HTTP forwarding) — or a mix, keyed by replica id."""

    def __init__(self, servers: Optional[List] = None,
                 addresses: Optional[Dict[int, str]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 vnodes: Optional[int] = None,
                 workers: Optional[int] = None, table_name: str = ""):
        self._local: Dict[int, object] = {
            s.replica_id: s for s in (servers or [])}
        self._remote: Dict[int, _UpstreamPool] = {
            int(i): _UpstreamPool(a)
            for i, a in (addresses or {}).items()}
        entries = [{"id": s.replica_id, "address": s.address}
                   for s in (servers or [])]
        entries += [{"id": int(i), "address": a}
                    for i, a in (addresses or {}).items()]
        if not entries:
            raise ValueError("router needs at least one replica")
        entries.sort(key=lambda e: e["id"])
        self.replicas = entries
        if servers and not table_name:
            table_name = servers[0].table.name
        opts_holder = servers[0].options if servers else None
        if vnodes is None:
            vnodes = opts_holder.get(CoreOptions.SERVICE_REPLICA_VNODES) \
                if opts_holder is not None else 64
        if workers is None:
            workers = opts_holder.get(CoreOptions.SERVICE_WORKERS) \
                if opts_holder is not None else 16
        self._vnodes = vnodes
        self._health_interval_ms = opts_holder.get(
            CoreOptions.SERVICE_REPLICA_HEALTH_INTERVAL) \
            if opts_holder is not None else 1_000
        # membership state: `_lock` guards replicas/_remote/_suspended
        # mutation; `self.ring` swaps ATOMICALLY (readers pick off
        # whatever ring reference they loaded — no read-side lock)
        self._membership_lock = threading.Lock()
        self._suspended: set = set()
        self._fail_counts: Dict[int, int] = {}
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self.ring = HashRing(entries, vnodes)
        from paimon_tpu_torch.metrics import (
            SERVICE_ROUTER_FORWARDED, SERVICE_ROUTER_RING_CHANGES,
            SERVICE_ROUTER_UPSTREAM_ERRORS, global_registry,
        )
        g = global_registry().service_metrics(table_name)
        self._m_forwarded = g.counter(SERVICE_ROUTER_FORWARDED)
        self._m_upstream_errors = g.counter(
            SERVICE_ROUTER_UPSTREAM_ERRORS)
        self._m_ring_changes = g.counter(SERVICE_ROUTER_RING_CHANGES)
        self.server = AsyncHttpServer(
            host, port, self._handle, workers=workers,
            name="paimon-router")
        self.port = self.server.port
        self.address = f"http://{host}:{self.port}"

    def start(self) -> "ReplicaRouter":
        self.server.start()
        from paimon_tpu_torch.parallel.executors import spawn_thread
        self._health_thread = spawn_thread(
            self._health_loop, name="paimon-router-health")
        return self

    def stop(self):
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
        self.server.stop()
        for pool in self._remote.values():
            pool.close()

    # -- membership ----------------------------------------------------------

    def _rebuild_ring_locked(self):
        """Swap in a fresh ring over the non-suspended membership.
        Caller holds `_membership_lock`; readers keep using whichever
        ring reference they already loaded."""
        live = [e for e in self.replicas
                if e["id"] not in self._suspended]
        self.ring = HashRing(live, self._vnodes)
        self._m_ring_changes.inc()

    def register_replica(self, rid: int, address: str) -> None:
        """Admit (or re-admit with a new address) a REMOTE replica.
        Registering an id that is currently suspended clears the
        suspension — the replica is announcing it is back."""
        rid = int(rid)
        with self._membership_lock:
            if rid in self._local:
                raise ValueError(
                    f"replica {rid} is in-process; cannot re-register")
            old_pool = self._remote.get(rid)
            self._remote[rid] = _UpstreamPool(address)
            self.replicas = (
                [e for e in self.replicas if e["id"] != rid]
                + [{"id": rid, "address": address}])
            self.replicas.sort(key=lambda e: e["id"])
            self._suspended.discard(rid)
            self._fail_counts.pop(rid, None)
            self._rebuild_ring_locked()
        if old_pool is not None:
            old_pool.close()

    def deregister_replica(self, rid: int) -> bool:
        """Planned leave: drop a remote replica from ring + membership.
        Returns False for unknown or in-process ids."""
        rid = int(rid)
        with self._membership_lock:
            if rid in self._local or rid not in self._remote:
                return False
            pool = self._remote.pop(rid)
            self.replicas = [e for e in self.replicas
                             if e["id"] != rid]
            self._suspended.discard(rid)
            self._fail_counts.pop(rid, None)
            self._rebuild_ring_locked()
        pool.close()
        return True

    def _health_loop(self):
        """Probe REMOTE replicas every `service.replicas.health-
        interval`: 2 consecutive failures suspend one out of the ring,
        the first success re-admits it.  In-process replicas are never
        probed."""
        interval = max(0.05, self._health_interval_ms / 1000.0)
        while not self._health_stop.wait(interval):
            with self._membership_lock:
                targets = list(self._remote.items())
            for rid, pool in targets:
                ok = False
                try:
                    status, _, _ = pool.request("GET", "/healthz",
                                                b"", {})
                    ok = status == 200
                except Exception:      # noqa: BLE001
                    self._m_upstream_errors.inc()
                with self._membership_lock:
                    if rid not in self._remote:
                        continue       # deregistered mid-probe
                    if ok:
                        self._fail_counts.pop(rid, None)
                        if rid in self._suspended:
                            self._suspended.discard(rid)
                            self._rebuild_ring_locked()
                    else:
                        n = self._fail_counts.get(rid, 0) + 1
                        self._fail_counts[rid] = n
                        if n >= 2 and rid not in self._suspended:
                            self._suspended.add(rid)
                            self._rebuild_ring_locked()

    # -- dispatch ------------------------------------------------------------

    def _handle(self, req: HttpRequest) -> HttpResponse:
        if req.method == "GET":
            if req.path == "/topology":
                with self._membership_lock:
                    replicas = list(self.replicas)
                    suspended = sorted(self._suspended)
                return HttpResponse(200, json.dumps(
                    {"replicas": replicas,
                     "suspended": suspended,
                     "virtual_nodes": self.ring.vnodes,
                     "router": True}).encode())
            if req.path == "/healthz":
                return self._healthz()
            if req.path == "/metrics":
                return self._metrics()
            if req.path == "/slo":
                return self._slo()
            return HttpResponse(404, b'{"error": "not found"}')
        if req.method == "POST" and req.path in ("/register",
                                                 "/deregister"):
            return self._handle_membership(req)
        if req.method != "POST" or req.path not in (
                "/lookup", "/scan", "/changelog"):
            return HttpResponse(404, b'{"error": "not found"}')
        try:
            body = json.loads(req.body or b"{}")
            tenant = str(body.get("tenant") or "default")
        except ValueError:
            return HttpResponse(400, b'{"error": "invalid JSON"}')
        node = self.ring.pick(tenant)
        self._m_forwarded.inc()
        return self._forward(node, req)

    def _handle_membership(self, req: HttpRequest) -> HttpResponse:
        try:
            body = json.loads(req.body or b"{}")
            rid = int(body["id"])
        except (ValueError, KeyError, TypeError):
            return HttpResponse(
                400, b'{"error": "expected {\\"id\\": int}"}')
        if req.path == "/register":
            address = str(body.get("address") or "")
            if not address.startswith("http"):
                return HttpResponse(
                    400, b'{"error": "expected an http address"}')
            try:
                self.register_replica(rid, address)
            except ValueError as e:
                return HttpResponse(
                    409, json.dumps({"error": str(e)}).encode())
            return HttpResponse(200, json.dumps(
                {"registered": rid,
                 "replica_count": len(self.replicas)}).encode())
        if not self.deregister_replica(rid):
            return HttpResponse(
                404, json.dumps(
                    {"error": f"unknown remote replica {rid}"}
                ).encode())
        return HttpResponse(200, json.dumps(
            {"deregistered": rid,
             "replica_count": len(self.replicas)}).encode())

    def _forward(self, node: dict, req: HttpRequest) -> HttpResponse:
        rid = node["id"]
        local = self._local.get(rid)
        if local is not None:
            # in-process replica: direct dispatch, no second TCP hop
            return local._handle(req)
        pool = self._remote.get(rid)
        if pool is None:       # deregistered between pick and forward
            self._m_upstream_errors.inc()
            return HttpResponse(
                502, json.dumps({"error": f"replica {rid} left the "
                                          f"ring"}).encode(),
                headers={"X-Replica-Id": str(rid)})
        fwd_headers = {"Content-Type": "application/json"}
        if "x-request-timeout-ms" in req.headers:
            fwd_headers["X-Request-Timeout-Ms"] = \
                req.headers["x-request-timeout-ms"]
        # propagate the trace context: the router's own serve.request
        # span (adopted from the client by the engine) is current on
        # this thread, so the replica links to the router hop and the
        # router hop links to the client — the full chain survives
        # the extra network boundary
        from paimon_tpu_torch.obs.trace import inject_headers
        inject_headers(fwd_headers)
        try:
            status, data, up_headers = pool.request(
                "POST", req.path, req.body, fwd_headers)
        except (http.client.HTTPException, ConnectionError,
                OSError) as e:
            self._m_upstream_errors.inc()
            return HttpResponse(
                502, json.dumps({"error": f"replica {rid} "
                                          f"unreachable: {e}"}).encode(),
                headers={"X-Replica-Id": str(rid)})
        headers = {"X-Replica-Id":
                   up_headers.get("X-Replica-Id", str(rid))}
        return HttpResponse(status, data, headers=headers)

    # -- aggregation ---------------------------------------------------------

    def _replica_get(self, rid: int, path: str):
        """GET `path` from one replica (direct for local, HTTP for
        remote); returns parsed JSON or raw text depending on path."""
        local = self._local.get(rid)
        if local is not None:
            resp = local._handle(HttpRequest("GET", path, {}, b"",
                                             True))
            return resp.status, resp.body
        status, data, _ = self._remote[rid].request(
            "GET", path, b"", {})
        return status, data

    def _healthz(self) -> HttpResponse:
        """Aggregated health: per-replica /healthz plus a rollup —
        the fleet is as degraded as its most degraded replica."""
        per: Dict[str, object] = {}
        worst = 0
        ok = True
        with self._membership_lock:
            replicas = list(self.replicas)
            suspended = set(self._suspended)
        for e in replicas:
            rid = e["id"]
            if rid in suspended:
                per[str(rid)] = {"suspended": True}
                ok = False
                continue
            try:
                status, body = self._replica_get(rid, "/healthz")
                h = json.loads(body)
                if status != 200:
                    ok = False
                worst = max(worst, int(h.get("brownout_level") or 0))
            except Exception as exc:      # noqa: BLE001
                self._m_upstream_errors.inc()
                h = {"error": str(exc)}
                ok = False
            per[str(rid)] = h
        return HttpResponse(200, json.dumps({
            "router": True,
            "status": "ok" if ok and worst == 0 else "degraded",
            "brownout_level_max": worst,
            "replica_count": len(replicas),
            "suspended": sorted(suspended),
            "replicas": per}).encode())

    def _metrics(self) -> HttpResponse:
        """Prometheus across the fleet.  In-process replicas share ONE
        registry — render it once.  Remote replicas' texts are
        federated with a replica="<id>" label injected per series, so
        same-named series never collide."""
        parts: List[str] = []
        if self._local:
            from paimon_tpu_torch.obs.export import render_prometheus
            parts.append(render_prometheus())
        with self._membership_lock:
            remotes = list(self._remote.items())
        for rid, pool in remotes:
            try:
                status, data, _ = pool.request("GET", "/metrics", b"",
                                               {})
                if status == 200:
                    parts.append(_relabel_prometheus(
                        data.decode(), rid))
            except Exception:      # noqa: BLE001
                self._m_upstream_errors.inc()
        return HttpResponse(
            200, "\n".join(parts).encode(),
            content_type="text/plain; version=0.0.4; charset=utf-8")

    def _slo(self) -> HttpResponse:
        """Fleet-wide SLO rollup: per-replica /slo documents folded by
        obs/slo.aggregate_slo — the fleet burns at the WORST replica's
        rate (an SLO is violated wherever any user lands) and alerts
        on the OR.  Unreachable/suspended replicas degrade the answer
        to partial instead of failing it, same contract as /metrics
        federation."""
        from paimon_tpu_torch.obs.slo import aggregate_slo
        per: Dict[str, Dict] = {}
        with self._membership_lock:
            replicas = list(self.replicas)
            suspended = set(self._suspended)
        for e in replicas:
            rid = e["id"]
            if rid in suspended:
                per[str(rid)] = {"suspended": True}
                continue
            try:
                status, body = self._replica_get(rid, "/slo")
                doc = json.loads(body)
                per[str(rid)] = doc if status == 200 else \
                    {"error": doc}
            except Exception as exc:      # noqa: BLE001
                self._m_upstream_errors.inc()
                per[str(rid)] = {"error": str(exc)}
        agg = aggregate_slo(per)
        agg["router"] = True
        agg["suspended"] = sorted(suspended)
        return HttpResponse(200, json.dumps(agg).encode())


_SERIES_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"(?P<rest>\s.*)$")


def _relabel_prometheus(text: str, replica_id: int) -> str:
    """Inject replica="<id>" into every series line of one replica's
    exposition text (comments/HELP/TYPE pass through)."""
    out = []
    label = f'replica="{replica_id}"'
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            out.append(line)
            continue
        labels = m.group("labels")
        merged = f"{label},{labels}" if labels else label
        out.append(f"{m.group('name')}{{{merged}}}{m.group('rest')}")
    return "\n".join(out)


class ReplicaSet:
    """N in-process replicas + the fronting router over one table.

        rs = ReplicaSet(table, replicas=4).start()
        client = KvQueryClient(address=rs.address)   # follows /topology
        ...
        rs.stop()

    The replicas share the process byte-cache/SSD/delta tiers; the
    router's address is what gets registered in the table's service
    directory (clients discover the ROUTER, then the ring)."""

    def __init__(self, table, replicas: Optional[int] = None,
                 host: str = "127.0.0.1"):
        from paimon_tpu_torch.service.query_service import (
            PRIMARY_KEY_LOOKUP, KvQueryServer, ServiceManager,
        )
        n = int(replicas if replicas is not None
                else table.options.get(CoreOptions.SERVICE_REPLICAS))
        if n < 1:
            raise ValueError(f"service.replicas must be >= 1, got {n}")
        self.table = table
        self.servers = [KvQueryServer(table, host=host, replica_id=i)
                        for i in range(n)]
        self.router = ReplicaRouter(servers=self.servers, host=host)
        self.address = self.router.address
        self._services = ServiceManager(table.file_io, table.path)
        self._service_name = PRIMARY_KEY_LOOKUP

    def start(self) -> "ReplicaSet":
        for s in self.servers:
            # replicas serve but do NOT register: the ROUTER is the
            # discoverable address (KvQueryServer.start would register
            # each replica over the previous one)
            s.server.start()
        self.router.start()
        self._services.register(self._service_name, self.address)
        return self

    def stop(self):
        self._services.unregister(self._service_name)
        self.router.stop()
        for s in self.servers:
            s.shutdown()       # replicas never registered themselves

    def new_serving_writer(self, commit_user: Optional[str] = None):
        """The fleet's serving writer: the delta tier is shared, so a
        write is immediately visible on EVERY replica."""
        return self.servers[0].new_serving_writer(commit_user)

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
