"""Read replicas behind the router, and warm boot, of paimon_tpu_torch
against paimon_tpu.

The router, ReplicaSet and warm-boot cases of
tests/test_serving_replicas.py (`TestReplicas`) and
tests/test_native_serving.py (`TestWarmBoot`, `TestRouterRegistration`)
run on both packages (see tests/test_torch_object_store.py
`run_case`): every tenant served with its X-Replica-Id, the proxy and
the topology-following paths, no torn batch and a coherent shared
cache under live commits and compaction, dropped files evicted across
replicas, the /healthz rollup and /metrics federation (also past a dead
remote), the ring's stability on a resize, the relabelled Prometheus
text, the delta tier on every replica, remote registration with the
health loop's suspension and re-admission, and warm boot with zero
reader builds.  The port's `HashRing` picks the reference's replica for
10,000 tenants at 1-8 replicas and after a resize, and warm-boot state
persisted by either package's server is restored by the other's with
zero reader builds, its SSTs byte-identical.
"""

import os

import pytest

from tests.test_torch_object_store import (  # noqa: F401 -- a fixture
    clean_process_state, expand, run_case,
)
from tests.test_torch_vector import case_ids

CASES = [c for c in expand("test_serving_replicas")
         if c[0][1].startswith("TestReplicas.")] + \
    [c for c in expand("test_native_serving")
     if c[0][1].startswith(("TestWarmBoot.", "TestRouterRegistration."))]

# delta tiers, disk tiers and plan caches of both packages are
# process-wide by path: no test sees another's
pytestmark = pytest.mark.usefixtures("clean_process_state")


def test_reference_cases_are_all_listed():
    # TestReplicas 10; TestWarmBoot 3 and TestRouterRegistration 3
    assert len(CASES) == 10 + 3 + 3


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- the ring ----------------------------------------------------------------

def _nodes(n, port0=8000):
    return [{"id": i, "address": f"http://10.0.0.{i}:{port0 + i}"}
            for i in range(n)]


@pytest.mark.parametrize("replicas", range(1, 9))
def test_hash_ring_picks_equal_reference(replicas):
    from paimon_tpu.service.router import HashRing as RefRing
    from paimon_tpu_torch.service.router import HashRing
    tenants = [f"tenant-{i}" for i in range(10_000)]
    for vnodes in (64, 7):
        port = HashRing(_nodes(replicas), vnodes)
        ref = RefRing(_nodes(replicas), vnodes)
        assert [port.pick(t)["id"] for t in tenants] == \
            [ref.pick(t)["id"] for t in tenants]
    # after a resize: one replica leaves, another joins at a new address
    resized = _nodes(replicas)[1:] + [{"id": 99,
                                       "address": "http://10.0.1.9:9099"}]
    port, ref = HashRing(resized, 64), RefRing(resized, 64)
    assert [port.pick(t)["id"] for t in tenants] == \
        [ref.pick(t)["id"] for t in tenants]


# -- warm boot across packages -------------------------------------------------

class Package:
    def __init__(self, name):
        if name == "port":
            import paimon_tpu_torch as pkg
            from paimon_tpu_torch.core.plan_cache import reset_plan_caches
            from paimon_tpu_torch.metrics import (
                LOOKUP_READER_BUILDS, global_registry,
            )
            from paimon_tpu_torch.service import (
                KvQueryClient, KvQueryServer,
            )
            from paimon_tpu_torch.table import FileStoreTable
            from paimon_tpu_torch.types import BigIntType, VarCharType
            self.kw = {"device": "cpu"}
        else:
            import paimon_tpu as pkg
            from paimon_tpu.core.plan_cache import reset_plan_caches
            from paimon_tpu.metrics import (
                LOOKUP_READER_BUILDS, global_registry,
            )
            from paimon_tpu.service import KvQueryClient, KvQueryServer
            from paimon_tpu.table import FileStoreTable
            from paimon_tpu.types import BigIntType, VarCharType
            self.kw = {}
        self.pkg, self.Table = pkg, FileStoreTable
        self.BigInt, self.VarChar = BigIntType, VarCharType
        self.Server, self.Client = KvQueryServer, KvQueryClient
        self.reset_plans = reset_plan_caches
        self.builds = lambda: global_registry().lookup_metrics() \
            .counter(LOOKUP_READER_BUILDS).count

    def create(self, path):
        schema = (self.pkg.Schema.builder()
                  .column("id", self.BigInt(False))
                  .column("name", self.VarChar.string_type())
                  .primary_key("id")
                  .options({"bucket": "2", "write-only": "true"}).build())
        return self.Table.create(path, schema, **self.kw)

    def load(self, path, options):
        return self.Table.load(path, dynamic_options=options, **self.kw)


def _persisted(d):
    """{file name: bytes} of the SSTs in a warm-boot state directory."""
    (state,) = os.listdir(d)
    return {n: open(os.path.join(d, state, n), "rb").read()
            for n in os.listdir(os.path.join(d, state))
            if n.endswith(".sst")}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_warm_boot_state_restored_across_packages(tmp_path, writer):
    w, r = (Package("reference"), Package("port")) \
        if writer == "reference" else (Package("port"), Package("reference"))
    path = str(tmp_path / "t")
    t = w.create(path)
    for lo in (0, 150):
        wb = t.new_batch_write_builder()
        with wb.new_write() as wr:
            wr.write_dicts([{"id": i, "name": f"n{i}"}
                            for i in range(lo, lo + 200)])
            wb.new_commit().commit(wr.prepare_commit())
    keys = [{"id": i} for i in range(0, 400, 3)]

    def serve(pkg, warm_dir):
        opts = {"service.warmboot.enabled": "true",
                "service.warmboot.dir": warm_dir,
                "service.lookup.refresh-interval": "0"}
        server = pkg.Server(pkg.load(path, opts))
        server.server.start()
        try:
            builds0 = pkg.builds()
            with pkg.Client(address=server.address) as c:
                got = c.lookup(keys)
            built = pkg.builds() - builds0
        finally:
            server.shutdown()          # persists the warm state
        return got, built, server.last_warm_restore

    # the writer's package persists; the other package's cold server
    # persists its own build into a second directory
    want, built, _ = serve(w, str(tmp_path / "warm"))
    assert built >= 2
    cold, _, _ = serve(r, str(tmp_path / "cold"))
    assert cold == want
    assert _persisted(str(tmp_path / "warm")) == \
        _persisted(str(tmp_path / "cold"))
    # the other package restores the writer's state: zero builds
    w.reset_plans()
    r.reset_plans()
    got, built, restored = serve(r, str(tmp_path / "warm"))
    assert got == want
    assert built == 0
    assert restored["ssts"] >= 2 and restored["plan"]


# -- a reference fault the port does not share ---------------------------------

@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_smart_client_skips_suspended_replicas(tmp_path, pkg):
    """A topology-following client that discovers the ring while a
    replica is suspended builds the router's ring, without it.  The
    reference's client builds its ring over every replica, suspended
    ones too, and sends their tenants to the dead address
    (paimon_tpu/service/query_service.py `_ensure_topology_locked`)."""
    import time

    p = Package(pkg)
    t = p.create(str(tmp_path / "t"))
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_dicts([{"id": i, "name": f"n{i}"} for i in range(50)])
        wb.new_commit().commit(w.prepare_commit())
    t = p.load(t.path, {"service.replicas.health-interval": "100 ms"})
    if pkg == "port":
        from paimon_tpu_torch.service.router import ReplicaRouter
    else:
        from paimon_tpu.service.router import ReplicaRouter
    s0, s1 = p.Server(t, replica_id=0), p.Server(t, replica_id=1)
    s0.server.start()
    s1.server.start()
    router = ReplicaRouter(servers=[s0]).start()
    try:
        s1.register_with_router(router.address)
        orphan = next(f"t{i}" for i in range(256)
                      if router.ring.pick(f"t{i}")["id"] == 1)
        s1.shutdown()
        deadline = time.monotonic() + 10
        while 1 not in router._suspended and time.monotonic() < deadline:
            time.sleep(0.02)
        assert router._suspended == {1}
        with p.Client(address=router.address, tenant=orphan) as c:
            if pkg == "reference":
                with pytest.raises(RuntimeError, match="refused"):
                    c.lookup_row({"id": 3})
            else:
                assert c.lookup_row({"id": 3}) == {"id": 3, "name": "n3"}
                assert c.last_replica == "0"
    finally:
        router.stop()
        s0.shutdown()
