"""paimon_tpu_torch's one-replica serving plane against paimon_tpu's.

Counterparts of the admission, brownout, deadline, async-engine, delta
tier and KvQueryServer cases of tests/test_query_serving.py,
tests/test_serving_replicas.py and tests/test_resilience.py.  Where a
scenario has answers (admission outcomes, brownout rungs, /lookup,
/scan, /changelog rows), it runs on both packages over one table
directory with the same seeded inputs and the answers are compared
exactly.  Both packages run on the CPU (the port with device="cpu");
every server binds 127.0.0.1:0 and is stopped in `finally`, and every
client socket has a timeout.

The reference's test_non_pk_table_serves_scan_but_rejects_lookup has
no counterpart: the port refuses append tables (ROADMAP.md A.8.7).
"""

import importlib
import json
import os
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import paimon_tpu.service.admission as ref_admission
import paimon_tpu.service.brownout as ref_brownout
from paimon_tpu.options import CoreOptions as RefCoreOptions
from paimon_tpu.options import Options as RefOptions
from paimon_tpu.service import KvQueryClient as RefClient
from paimon_tpu.service import KvQueryServer as RefServer
from paimon_tpu.service.delta import reset_delta_tiers as ref_reset_tiers
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu_torch.lookup import LocalTableQuery
from paimon_tpu_torch.metrics import (
    SERVICE_LOOP_LAG_MS, SERVICE_REJECTED, SERVICE_SCAN_CACHE_HITS,
    global_registry,
)
from paimon_tpu_torch.options import CoreOptions, Options
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.service import (
    KvQueryClient, KvQueryServer, ServiceBusyError, admission, brownout,
)
from paimon_tpu_torch.service.delta import (
    ServingWriter, delta_ineligible_reason, reset_delta_tiers,
    shared_delta_tier,
)
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import (
    BigIntType, DateType, DoubleType, RowKind, VarCharType,
)
from paimon_tpu_torch.utils.deadline import (
    DeadlineExceededError, check_deadline, current_deadline, deadline_scope,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADMISSION = {"port": admission, "reference": ref_admission}
BROWNOUT = {"port": (brownout, CoreOptions, Options),
            "reference": (ref_brownout, RefCoreOptions, RefOptions)}


@pytest.fixture(autouse=True)
def _fresh_delta_tiers():
    reset_delta_tiers()
    ref_reset_tiers()
    yield
    reset_delta_tiers()
    ref_reset_tiers()


def pk_table(path, buckets=2, extra_opts=None, device="cpu"):
    opts = {"bucket": str(buckets), "write-only": "true",
            "service.lookup.refresh-interval": "0"}
    opts.update(extra_opts or {})
    schema = (Schema.builder()
              .column("id", BigIntType(False))
              .column("v", DoubleType())
              .column("name", VarCharType.string_type())
              .primary_key("id").options(opts).build())
    return FileStoreTable.create(path, schema, device=device)


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_dicts(rows, row_kinds=kinds)
        wb.new_commit().commit(w.prepare_commit())


def seeded_rows(n, seed, lo=0, tag="r"):
    vals = np.random.default_rng(seed).standard_normal(n)
    return [{"id": lo + i, "v": float(v), "name": f"{tag}{lo + i}"}
            for i, v in enumerate(vals)]


def serving_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("paimon-serve", "paimon-scan"))]


def no_serving_threads(timeout=5.0):
    end = time.monotonic() + timeout
    while serving_threads() and time.monotonic() < end:
        time.sleep(0.01)
    return not serving_threads()


# -- admission control, the same scenarios on both packages -------------------

@pytest.mark.parametrize("pkg", sorted(ADMISSION))
def test_admission_never_oversubscribed_under_load(pkg):
    mod = ADMISSION[pkg]
    budget = 10_000
    ctl = mod.AdmissionController(max_bytes=budget, queue_depth=1024,
                                  queue_timeout_ms=30_000)
    peak, errors, lock = [0], [], threading.Lock()

    def worker(seed):
        rng = np.random.default_rng(seed)
        for n in rng.integers(1, budget // 2, 25):
            try:
                with ctl.acquire(f"tenant{seed % 3}", int(n)):
                    got = ctl.inflight_bytes
                    with lock:
                        peak[0] = max(peak[0], got)
                    if got > budget:
                        errors.append(got)
                    time.sleep(0.0005)
            except mod.AdmissionRejected as e:
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert errors == []
    assert 0 < peak[0] <= budget
    assert ctl.inflight_bytes == 0 and ctl.queued == 0


@pytest.mark.parametrize("pkg", sorted(ADMISSION))
def test_admission_queue_timeout_rejects_then_recovers(pkg):
    mod = ADMISSION[pkg]
    ctl = mod.AdmissionController(max_bytes=100, queue_depth=8,
                                  queue_timeout_ms=50)
    big = ctl.acquire("a", 100)
    t0 = time.monotonic()
    with pytest.raises(mod.AdmissionRejected):
        ctl.acquire("a", 50)
    assert time.monotonic() - t0 >= 0.04
    big.release()
    with ctl.acquire("a", 50):
        pass


@pytest.mark.parametrize("pkg", sorted(ADMISSION))
def test_admission_queue_overflow_rejects_immediately(pkg):
    mod = ADMISSION[pkg]
    ctl = mod.AdmissionController(max_bytes=10, queue_depth=2,
                                  queue_timeout_ms=5_000)
    ticket = ctl.acquire("a", 10)
    waiters = []

    def wait():
        try:
            waiters.append(ctl.acquire("a", 5))
        except mod.AdmissionRejected:
            pass

    ts = [threading.Thread(target=wait) for _ in range(2)]
    [t.start() for t in ts]
    end = time.monotonic() + 2
    while ctl.queued < 2 and time.monotonic() < end:
        time.sleep(0.005)
    t0 = time.monotonic()
    with pytest.raises(mod.AdmissionRejected, match="queue full"):
        ctl.acquire("a", 5)
    assert time.monotonic() - t0 < 1.0
    ticket.release()
    [t.join(timeout=10) for t in ts]
    for w in waiters:
        w.release()


@pytest.mark.parametrize("pkg", sorted(ADMISSION))
def test_admission_largest_first_drain(pkg):
    mod = ADMISSION[pkg]
    ctl = mod.AdmissionController(max_bytes=100, queue_depth=8,
                                  queue_timeout_ms=10_000)
    first = ctl.acquire("a", 100)
    order = []

    def wait(n, tag):
        with ctl.acquire("a", n):
            order.append(tag)
            time.sleep(0.05)

    small = threading.Thread(target=wait, args=(30, "small"))
    small.start()
    end = time.monotonic() + 2
    while ctl.queued < 1 and time.monotonic() < end:
        time.sleep(0.005)
    large = threading.Thread(target=wait, args=(80, "large"))
    large.start()
    while ctl.queued < 2 and time.monotonic() < end:
        time.sleep(0.005)
    first.release()
    small.join(timeout=10)
    large.join(timeout=10)
    assert order == ["large", "small"]


@pytest.mark.parametrize("pkg", sorted(ADMISSION))
def test_admission_budgets_and_anti_stall(pkg):
    """Idle anti-stall, a zero tenant slice, tenant isolation and the
    bounded per-tenant gauges."""
    mod = ADMISSION[pkg]
    ctl = mod.AdmissionController(max_bytes=10, queue_depth=4,
                                  queue_timeout_ms=50)
    with ctl.acquire("a", 10_000) as t1:
        assert t1.bytes == 10_000
        with pytest.raises(mod.AdmissionRejected):
            ctl.acquire("a", 1)
    ctl = mod.AdmissionController(max_bytes=1000, tenant_max_bytes=0,
                                  queue_depth=4, queue_timeout_ms=50)
    with ctl.acquire("a", 10):
        with pytest.raises(mod.AdmissionRejected):
            ctl.acquire("a", 10)
        with ctl.acquire("b", 10):
            pass
    ctl = mod.AdmissionController(max_bytes=100, tenant_max_bytes=40,
                                  queue_depth=8, queue_timeout_ms=50)
    a1 = ctl.acquire("a", 40)
    with pytest.raises(mod.AdmissionRejected):
        ctl.acquire("a", 20)
    with ctl.acquire("b", 40):
        assert (ctl.tenant_inflight("a"), ctl.tenant_inflight("b")) == \
            (40, 40)
    a1.release()
    assert ctl.tenant_inflight("a") == 0
    ctl = mod.AdmissionController(max_bytes=1 << 30, queue_depth=4,
                                  queue_timeout_ms=50)
    for i in range(ctl.MAX_TENANT_GAUGES + 20):
        with ctl.acquire(f"spin-{i}", 1):
            pass
    assert len(ctl._tenant_gauges) <= ctl.MAX_TENANT_GAUGES + 1
    assert "__other__" in ctl._tenant_gauges


def test_admission_deadline_bounds_queue_wait_and_sheds_by_priority():
    ctl = admission.AdmissionController(max_bytes=100, queue_depth=8,
                                        queue_timeout_ms=30_000,
                                        table="dl-q")
    big = ctl.acquire("a", 100)
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceededError):
        with deadline_scope(50):
            ctl.acquire("b", 100)
    assert time.perf_counter() - t0 < 5.0
    big.release()
    ctl.set_shed_below(100)
    with pytest.raises(admission.AdmissionRejected):
        ctl.acquire("low", 10, priority=1)
    ctl.acquire("hi", 10, priority=100).release()
    ctl.set_shed_below(0)
    ctl.acquire("low", 10, priority=1).release()


@pytest.mark.parametrize("pkg", sorted(BROWNOUT))
def test_brownout_ladder_and_hysteresis(pkg):
    """Failure rate, then queue pressure: rung 1, rung 2 (shedding),
    held for hold-ms, then down; the same rungs on both packages."""
    mod, core, opts_cls = BROWNOUT[pkg]
    adm = ADMISSION[pkg]
    from importlib import import_module
    res = import_module(f"{'paimon_tpu_torch' if pkg == 'port' else 'paimon_tpu'}"
                        ".fs.resilience")
    clk = [0.0]
    ctl = adm.AdmissionController(max_bytes=10, queue_depth=2,
                                  queue_timeout_ms=10_000, table="bo")
    bo = mod.BrownoutController(
        ctl, core(opts_cls({"service.brownout.hold-ms": "1000"})),
        clock=lambda: clk[0])
    levels = [bo.observe()]
    for _ in range(10):
        bo.timeouts.record()
    levels.append(bo.observe())
    assert not res.hedging_allowed()
    held = ctl.acquire("a", 10)
    waiter = threading.Thread(target=lambda: ctl.acquire("b", 10).release())
    waiter.start()
    end = time.monotonic() + 5
    while ctl.queued < 1 and time.monotonic() < end:
        time.sleep(0.005)
    levels.append(bo.observe())
    hz = bo.healthz()
    assert (hz["status"], hz["shedding_below_priority"]) == \
        ("brownout", 100)
    held.release()
    waiter.join(timeout=10)
    bo.timeouts._events.clear()
    clk[0] = 0.5
    levels.append(bo.observe())          # held at rung 2
    clk[0] = 1.5
    levels.append(bo.observe())          # hold spent: down to 0
    bo.reset()
    assert levels == [0, 1, 2, 2, 0]
    assert res.hedging_allowed() and ctl._shed_below == 0


# -- deadlines -----------------------------------------------------------------

def test_deadline_scope_check_and_pool_propagation():
    from paimon_tpu_torch.parallel.executors import new_thread_pool
    clk = [0.0]
    with deadline_scope(100, clock=lambda: clk[0]) as dl:
        assert current_deadline() is dl
        check_deadline("t")
        clk[0] = 0.2
        with pytest.raises(DeadlineExceededError):
            check_deadline("t")
    assert current_deadline() is None
    with deadline_scope(50_000) as outer:
        with deadline_scope(1, entry=True) as inner:
            assert inner is outer
    with deadline_scope(None) as none:
        assert none is None
    pool = new_thread_pool(1, "dl-test")
    try:
        with deadline_scope(60_000) as dl:
            assert pool.submit(current_deadline).result() is dl
        assert pool.submit(current_deadline).result() is None
    finally:
        pool.shutdown()


# -- the query server, held against the reference's over one table -----------

def both_servers(path, scenario, opts=None):
    """scenario(client, server) on a port server and on a reference
    server over the table at `path`; returns both results."""
    out = {}
    for name, Table, Server, Client, kw in (
            ("port", FileStoreTable, KvQueryServer, KvQueryClient,
             {"device": "cpu"}),
            ("reference", RefTable, RefServer, RefClient, {})):
        server = Server(Table.load(path, dynamic_options=opts, **kw)).start()
        try:
            with Client(address=server.address) as c:
                out[name] = scenario(c, server)
        finally:
            server.stop()
    return out


def test_lookup_scan_changelog_equal_the_reference(tmp_path):
    path = str(tmp_path / "t")
    t = pk_table(path, buckets=3)
    commit(t, seeded_rows(200, seed=1))
    commit(t, seeded_rows(60, seed=2, lo=150, tag="u"))
    commit(t, [{"id": i, "v": 0.0, "name": "x"} for i in range(0, 200, 9)],
           kinds=[RowKind.DELETE] * 23)

    def scenario(c, server):
        keys = [{"id": i} for i in range(-2, 215)]
        got = {"lookup": c.lookup(keys),
               "scan": sorted(c.scan(limit=1000), key=lambda r: r["id"]),
               "scan_limited": len(c.scan(limit=10)),
               "changelog": []}
        while True:
            cl = c.changelog(consumer="c1", max_rows=70)
            got["changelog"].extend(cl["rows"])
            if cl["caught_up"]:
                break
        got["changelog"].sort(key=lambda r: r["id"])
        return got

    got = both_servers(path, scenario)
    assert got["port"] == got["reference"]
    assert got["port"]["scan_limited"] >= 10
    scan = {r["id"]: r for r in got["port"]["scan"]}
    assert got["port"]["lookup"] == [scan.get(i) for i in range(-2, 215)]


def test_partition_values_survive_the_wire(tmp_path):
    import datetime
    path = str(tmp_path / "t")
    schema = (Schema.builder().column("dt", DateType(False))
              .column("id", BigIntType(False))
              .column("name", VarCharType.string_type())
              .partition_keys("dt").primary_key("dt", "id")
              .options({"bucket": "1", "write-only": "true"}).build())
    t = FileStoreTable.create(path, schema, device="cpu")
    d = datetime.date(2026, 8, 3)
    commit(t, [{"dt": d, "id": i, "name": f"n{i}"} for i in range(5)])
    got = both_servers(path, lambda c, s: [
        c.lookup_row({"dt": d, "id": i}, partition=(d,)) for i in (3, 9)])
    assert got["port"] == got["reference"] == \
        [{"dt": d, "id": 3, "name": "n3"}, None]


def test_scan_cache_keep_alive_and_reconnect(tmp_path):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(50, seed=3))
    server = KvQueryServer(t).start()
    hits = global_registry().service_metrics(t.name) \
        .counter(SERVICE_SCAN_CACHE_HITS)
    try:
        with KvQueryClient(t) as c:
            for i in range(30):
                assert c.lookup_row({"id": i})["name"] == f"r{i}"
            assert c.reconnects == 0
            c._conn.sock.close()
            assert c.lookup_row({"id": 3})["name"] == "r3"
            assert c.reconnects == 1
            h0 = hits.count
            first = c.scan(limit=20)
            assert c.scan(limit=20) == first
            assert hits.count == h0 + 1          # same snapshot: cached
            commit(t, [{"id": i, "v": 1.0, "name": "new"}
                       for i in range(50)])
            # a new snapshot is a new key: a miss, and the new rows
            assert {r["name"] for r in c.scan(limit=20)} == {"new"}
            assert hits.count == h0 + 1
    finally:
        server.stop()


def test_endpoints_metrics_healthz_slo_stats_warmboot(tmp_path):
    prom_sample = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+]+$")
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(50, seed=4))
    server = KvQueryServer(t).start()
    try:
        with KvQueryClient(t, tenant="alice") as c:
            c.lookup([{"id": i} for i in range(10)])
            c.scan(limit=5)
            c.changelog(consumer="p")
            hz = c.healthz()
            slo = c.slo()
        with urllib.request.urlopen(f"{server.address}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        with urllib.request.urlopen(f"{server.address}/stats",
                                    timeout=30) as resp:
            stats = json.loads(resp.read())
        req = urllib.request.Request(f"{server.address}/warmboot",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            warm = json.loads(resp.read())
    finally:
        server.stop()
    assert hz["replica_id"] == 0 and hz["snapshot_id"] == 1
    assert hz["status"] == "ok" and hz["delta"]["rows"] == 0
    assert "recent_lag_ms" in hz["event_loop"]
    assert slo["enabled"] and not slo["alert"] and slo["good_events"] >= 3
    assert stats["lookup_keys"] >= 10 and stats["lookup"]["reader_builds"]
    assert warm == {"ssts": 0, "snapshot_id": None, "plan": False}
    declared = {}
    for ln in filter(None, body.splitlines()):
        if ln.startswith("# TYPE "):
            fam, kind = ln[len("# TYPE "):].rsplit(" ", 1)
            declared[fam] = kind
        else:
            assert prom_sample.match(ln), ln
    for fam, kind in (("paimon_service_requests", "counter"),
                      ("paimon_service_queue_depth", "gauge"),
                      ("paimon_service_tenant_inflight_bytes", "gauge"),
                      ("paimon_service_lookup_ms", "summary"),
                      ("paimon_service_lookup_ms_hist", "histogram"),
                      ("paimon_lookup_reader_builds", "counter"),
                      ("paimon_slo_alert", "gauge")):
        assert declared.get(fam) == kind, fam
    assert 'paimon_service_tenant_inflight_bytes{table="alice"}' in body
    assert global_registry().service_metrics(t.name).histogram(
        SERVICE_LOOP_LAG_MS).total_count >= 3


def test_admission_429_end_to_end(tmp_path):
    t = pk_table(str(tmp_path / "t"), extra_opts={
        "service.max-inflight-bytes": "1", "service.queue.depth": "1",
        "service.queue.timeout": "50"})
    commit(t, seeded_rows(2000, seed=5))
    server = KvQueryServer(t).start()
    rejected = global_registry().service_metrics(t.name) \
        .counter(SERVICE_REJECTED)
    r0, busy = rejected.count, [0]

    def hammer():
        with KvQueryClient(address=server.address) as c:
            for _ in range(6):
                try:
                    c.scan(limit=2000)
                except ServiceBusyError:
                    busy[0] += 1

    try:
        threads = [threading.Thread(target=hammer) for _ in range(6)]
        [x.start() for x in threads]
        [x.join(timeout=60) for x in threads]
        assert server.healthz()["recent_429_per_s"] > 0
    finally:
        server.stop()
    assert busy[0] > 0 and rejected.count >= r0 + busy[0]


def test_service_deadlines_answer_504_and_400(tmp_path):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(20, seed=6))
    server = KvQueryServer(t).start()
    try:
        with KvQueryClient(address=server.address, timeout_ms=0) as c:
            with pytest.raises(DeadlineExceededError):
                c.scan(limit=10)
        with KvQueryClient(address=server.address) as c:
            with pytest.raises(RuntimeError, match="invalid timeout_ms"):
                c._post("scan", {"limit": 5, "timeout_ms": "1s"}, timeout=30)
            assert c.healthz()["recent_504_per_s"] > 0
    finally:
        server.stop()


def test_async_engine_pipelining_400_and_503(tmp_path):
    t = pk_table(str(tmp_path / "t"), extra_opts={
        "service.max-connections": "2"})
    commit(t, seeded_rows(50, seed=7))
    server = KvQueryServer(t).start()
    socks = []
    try:
        reqs = []
        for i in range(8):
            body = json.dumps({"keys": [{"id": i}]}).encode()
            reqs.append((f"POST /lookup HTTP/1.1\r\nHost: x\r\n"
                         f"Content-Length: {len(body)}\r\n\r\n").encode()
                        + body)
        sk = socket.create_connection(("127.0.0.1", server.port), timeout=10)
        socks.append(sk)
        sk.sendall(b"".join(reqs))               # 8 back to back
        buf, end = b"", time.time() + 20
        while buf.count(b"HTTP/1.1 200") < 8 and time.time() < end:
            buf += sk.recv(1 << 20)
        offs = [buf.find(f'"name": "r{i}"'.encode()) for i in range(8)]
        assert all(o >= 0 for o in offs) and offs == sorted(offs)
        bad = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        socks.append(bad)
        bad.sendall(b"NOT-HTTP\r\n\r\n")
        assert b"400" in bad.recv(65536)
        bad.close()
        socks.remove(bad)
        time.sleep(0.1)
        second = socket.create_connection(("127.0.0.1", server.port),
                                          timeout=5)
        socks.append(second)
        body = b'{"keys": [{"id": 1}]}'
        second.sendall((f"POST /lookup HTTP/1.1\r\nHost: x\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n").encode()
                       + body)
        assert b"200" in second.recv(1 << 20)
        extra = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=5)
        socks.append(extra)
        got = extra.recv(65536)
        assert b"503" in got or got == b""
    finally:
        for s in socks:
            s.close()
        server.stop()
    assert no_serving_threads()


def test_concurrent_mixed_serving_with_live_commits(tmp_path):
    """Lookup, scan and changelog clients while the table takes live
    commits, each writing one version to every key: no torn batch, no
    version going backwards, no leaked thread."""
    keys = list(range(40))
    t = pk_table(str(tmp_path / "t"),
                 extra_opts={"service.lookup.refresh-interval": "20"})
    commit(t, [{"id": i, "v": 0.0, "name": "v0"} for i in keys])
    server = KvQueryServer(t).start()
    stop, errors, committed = threading.Event(), [], [0]

    def committer():
        for v in range(1, 11):
            commit(t, [{"id": i, "v": float(v), "name": f"v{v}"}
                       for i in keys])
            committed[0] = v
            time.sleep(0.02)

    def lookup_client():
        try:
            with KvQueryClient(t) as c:
                last = -1
                while not stop.is_set():
                    versions = {r["name"] for r in
                                c.lookup([{"id": i} for i in keys]) if r}
                    if len(versions) != 1:
                        errors.append(f"torn batch: {versions}")
                        return
                    v = int(versions.pop()[1:])
                    if v < last:
                        errors.append(f"backwards {last}->{v}")
                        return
                    last = v
        except Exception as e:      # noqa: BLE001
            errors.append(repr(e))

    def other_client(kind):
        try:
            with KvQueryClient(t) as c:
                while not stop.is_set():
                    if kind == "scan":
                        rows = c.scan(limit=len(keys))
                        if rows and len({r["name"] for r in rows}) != 1:
                            errors.append("torn scan")
                            return
                    else:
                        c.changelog(consumer="c", max_rows=500)
                        time.sleep(0.01)
        except Exception as e:      # noqa: BLE001
            errors.append(repr(e))

    workers = [threading.Thread(target=lookup_client) for _ in range(3)] + \
        [threading.Thread(target=other_client, args=(k,))
         for k in ("scan", "changelog")]
    [w.start() for w in workers]
    try:
        committer()
        time.sleep(0.2)
    finally:
        stop.set()
        [w.join(timeout=30) for w in workers]
        server.stop()
    assert errors == [] and committed[0] == 10
    assert no_serving_threads()


def test_server_stop_cleans_sst_disk(tmp_path):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(30, seed=8))
    server = KvQueryServer(t).start()
    try:
        with KvQueryClient(t) as c:
            c.lookup_row({"id": 1})
        sst_dir = server.query().store.dir
        assert any(f.endswith(".sst") for f in os.listdir(sst_dir))
    finally:
        server.stop()
    assert not any(f.endswith(".sst") for f in os.listdir(sst_dir))


def test_shared_cache_tier_and_dropped_file_eviction(tmp_path):
    from paimon_tpu_torch.fs.caching import CachingFileIO, shared_cache_state
    t = pk_table(str(tmp_path / "t"), buckets=1)
    commit(t, seeded_rows(50, seed=9))
    commit(t, seeded_rows(50, seed=10, tag="y"))
    a = t.copy({"read.cache.range": "true"})
    b = t.copy({"read.cache.range": "true"})
    assert isinstance(a.file_io, CachingFileIO)
    assert a.file_io is not b.file_io and a.file_io.state is b.file_io.state
    server = KvQueryServer(t).start()
    try:
        assert server.table.file_io.state is a.file_io.state
        with KvQueryClient(t) as c:
            c.lookup_row({"id": 1})
            q = server.query()
            old = {f.file_name for s in q._splits.values()
                   for f in s.data_files}
            for s in q._splits.values():
                for f in s.data_files:
                    server.table.file_io.read_bytes(q._data_path(s, f))
            state = shared_cache_state()
            assert any(n in p for p in state.cache for n in old)
            t.copy({"write-only": "false"}).compact(full=True)
            c.lookup_row({"id": 1})
            assert not {p for p in state.cache
                        if any(n in p for n in old)}
    finally:
        server.stop()


def test_rewrapped_table_keeps_device_and_dynamic_options(tmp_path):
    import torch
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(10, seed=11))
    dyn = FileStoreTable.load(str(tmp_path / "t"), device="cpu",
                              dynamic_options={
                                  "service.lookup.refresh-interval": "1234",
                                  "service.queue.depth": "7"})
    server = KvQueryServer(dyn)
    try:
        from paimon_tpu_torch.fs.caching import CachingFileIO
        assert server.table is not dyn
        assert isinstance(server.table.file_io, CachingFileIO)
        assert server.table.device == torch.device("cpu")
        assert server.table.options.get(
            CoreOptions.SERVICE_LOOKUP_REFRESH_INTERVAL) == 1234
        assert server.admission.queue_depth == 7
        assert server.query().refresh_interval_ms == 1234
        assert server.query()._read.device == torch.device("cpu")
    finally:
        server.stop()


# -- the hot delta tier --------------------------------------------------------

def test_serving_writer_read_your_writes(tmp_path):
    """A serving writer's rows and tombstones answer /lookup before any
    flush or commit, the answers after commit and refresh are the same,
    the delta drains, and the reference reads the committed table
    alike."""
    path = str(tmp_path / "t")
    t = pk_table(path)
    commit(t, seeded_rows(50, seed=12))
    server = KvQueryServer(t).start()
    try:
        sw = server.new_serving_writer()
        with KvQueryClient(address=server.address) as c:
            upd = seeded_rows(5, seed=13, lo=1000, tag="fresh") + \
                [{"id": 3, "v": 99.0, "name": "updated"}]
            sw.write_dicts(upd)
            sw.write_dicts([{"id": 5, "v": 0.0, "name": "x"}],
                           row_kinds=[RowKind.DELETE])
            snap = t.snapshot_manager.latest_snapshot_id()
            keys = [{"id": r["id"]} for r in upd] + [{"id": 5}, {"id": 6}]
            pre = c.lookup(keys)
            assert pre[:6] == upd and pre[6] is None and pre[7]["id"] == 6
            assert t.snapshot_manager.latest_snapshot_id() == snap
            assert sw.commit() == snap + 1
            server.query().refresh()
            assert c.lookup(keys) == pre
            assert server._delta.stats()["rows"] == 0
        sw.close()
    finally:
        server.stop()
    ref = RefTable.load(path)
    from paimon_tpu.lookup import LocalTableQuery as RefQuery
    q = RefQuery(ref, cache_dir=str(tmp_path / "ref-sst"))
    try:
        assert q.lookup(keys) == pre
    finally:
        q.close()


def test_delta_newest_wins_and_abandoned_writer(tmp_path):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(5, seed=14))
    tier = shared_delta_tier(t)
    q = LocalTableQuery(t, delta=tier)
    with ServingWriter(t, tier) as sw:
        sw.write_dicts([{"id": 9, "v": 1.0, "name": "first"}])
        sw.write_dicts([{"id": 9, "v": 2.0, "name": "second"}])
        assert q.lookup([{"id": 9}])[0]["name"] == "second"
        sw.write_dicts([{"id": 9, "v": 0.0, "name": "x"}],
                       row_kinds=[RowKind.DELETE])
        assert q.lookup([{"id": 9}])[0] is None
        sw.write_dicts([{"id": 9, "v": 3.0, "name": "third"}])
        assert q.lookup([{"id": 9}])[0]["name"] == "third"
    # closed without commit: its rows stop being served
    assert q.lookup([{"id": 9}])[0] is None
    q.close()


def test_delta_generation_retires_after_every_reader(tmp_path):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(10, seed=15))
    tier = shared_delta_tier(t)
    a = LocalTableQuery(t, delta=tier)
    b = LocalTableQuery(t, delta=tier)
    pending = LocalTableQuery(t, delta=tier)      # registered, no plan
    a.lookup([{"id": 1}])
    b.lookup([{"id": 1}])
    with ServingWriter(t, tier) as sw:
        sw.write_dicts([{"id": 500, "v": 1.0, "name": "d"}])
        sw.commit()
        assert tier.stats()["sealed_generations"] == 1
        a.refresh()
        a.lookup([{"id": 1}])
        pending.lookup([{"id": 1}])
        assert tier.stats()["sealed_generations"] == 1   # b pins it
        assert b.lookup([{"id": 500}])[0]["name"] == "d"
        b.close()                                         # releases
        assert tier.stats()["sealed_generations"] == 0
        assert a.lookup([{"id": 500}])[0]["name"] == "d"
    a.close()
    pending.close()


def test_delta_ineligible_configurations_and_overflow(tmp_path):
    from paimon_tpu_torch.metrics import SERVICE_DELTA_OVERFLOWS
    t = pk_table(str(tmp_path / "seq"), extra_opts={"sequence.field": "v"})
    assert "sequence.field" in delta_ineligible_reason(t)
    server = KvQueryServer(t)
    try:
        assert server._delta is None
        with pytest.raises(ValueError, match="sequence.field"):
            server.new_serving_writer()
    finally:
        server.stop()
    t2 = pk_table(str(tmp_path / "big"), extra_opts={
        "service.delta.max-bytes": "1"})
    tier = shared_delta_tier(t2)
    c = global_registry().service_metrics(t2.name).counter(
        SERVICE_DELTA_OVERFLOWS)
    before = c.count
    with ServingWriter(t2, tier) as sw:
        sw.write_dicts(seeded_rows(50, seed=16, lo=1000))
        assert c.count > before and tier.stats()["rows"] == 50


# -- what is refused until ROADMAP.md A.7b -----------------------------------

@pytest.mark.parametrize("key,value,where", [
    ("service.replicas", "2", "server"),
    ("service.warmboot.enabled", "true", "server"),
    ("obs.flight.dump.dir", "/nonexistent-dump-dir", "server"),
    ("cache.disk.dir", "/nonexistent-cache-dir", "table"),
    ("read.hedge.enabled", "true", "table"),
])
def test_a7b_options_raise(tmp_path, key, value, where):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(3, seed=17))
    with pytest.raises(NotImplementedError, match="A.7b"):
        table = t.copy({key: value})
        assert where == "server"
        KvQueryServer(table)
    assert no_serving_threads()


def test_router_following_and_registration_raise(tmp_path):
    t = pk_table(str(tmp_path / "t"))
    commit(t, seeded_rows(3, seed=18))
    server = KvQueryServer(t).start()
    try:
        with pytest.raises(NotImplementedError, match="A.7b"):
            KvQueryClient(address=server.address, follow_topology=True)
        with pytest.raises(NotImplementedError, match="A.7b"):
            server.register_with_router("http://127.0.0.1:1")
    finally:
        server.stop()


def _read_keys(module_file):
    with open(module_file) as f:
        names = set(re.findall(r"CoreOptions\.([A-Z][A-Z0-9_]+)", f.read()))
    return {getattr(RefCoreOptions, n).key for n in names
            if hasattr(getattr(RefCoreOptions, n), "key")}


def test_every_serving_option_key_is_defined_or_refused():
    """Each CoreOptions key that paimon_tpu/lookup/ and
    paimon_tpu/service/ read is defined by the port (spelled as the
    reference spells it) or belongs to a module the port does not have
    yet (the stream daemon, ROADMAP.md A.7b), whose options nothing in
    the port reads."""
    port_keys = {v.key for v in vars(CoreOptions).values()
                 if hasattr(v, "key")}
    missing = {}
    for pkg in ("lookup", "service"):
        d = os.path.join(REPO, "paimon_tpu", pkg)
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".py"):
                continue
            keys = _read_keys(os.path.join(d, fname))
            if fname == "stream_daemon.py":
                with pytest.raises(ImportError):
                    importlib.import_module(
                        "paimon_tpu_torch.service.stream_daemon")
                continue
            if keys - port_keys:
                missing[f"{pkg}/{fname}"] = sorted(keys - port_keys)
    assert missing == {}
