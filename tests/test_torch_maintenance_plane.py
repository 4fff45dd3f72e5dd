"""parallel/maintenance_plane.py and the stream daemon's plane mode of
paimon_tpu_torch against paimon_tpu's.

The 27 cases of tests/test_maintenance_plane.py (takeover ownership,
leases, the plane driven by an injected clock, stamped recovery, the
fsck ownership check, the review fixes, batched event routing) run on
both packages through `run_reference_case`, except the in-process
two-daemon takeover: that case is on ROADMAP.md C's list of flaky
reference tests, so it runs on the port alone in a steady form below,
its lease clock injected (no peer can look dead before the test kills
one) and every wait a bounded wait on a condition.  A plane of each
package over one table then shows the two interoperate: a takeover
published by one is adopted, stamped and readmitted by the other.
"""

import time

import pytest

from tests.test_torch_append import _cpu_table, reference_cases, \
    run_reference_case

FLAKY_ON_REFERENCE = ("test_two_daemon_takeover_in_process",)
CASES = reference_cases("test_maintenance_plane", classes=True)


def test_reference_cases_are_all_here():
    assert len(CASES) == 27


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[1] not in FLAKY_ON_REFERENCE],
                         ids=[c[1] for c in CASES
                              if c[1] not in FLAKY_ON_REFERENCE])
def test_reference_case(case, pkg, tmp_path, monkeypatch):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


def wait_for(cond, timeout: float = 60.0, step: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def test_two_daemon_takeover_in_process(tmp_path):
    """The reference case on the port, steady: two distributed stream
    daemons (a fake 2-process topology) over one table and one
    replayable source; daemon 1 is killed and daemon 0 adopts its
    buckets.  The lease clock is the test's: it stands still while both
    daemons live and jumps past the timeout at the kill.  No event is
    lost or duplicated, the table equals the single-process oracle,
    per-user offsets strictly increase, the takeover is counted, the
    changelog materializes to the expected state and fsck is clean."""
    from paimon_tpu_torch.cdc.source import MemoryCdcSource
    from paimon_tpu_torch.core.read import ROW_KIND_COL
    from paimon_tpu_torch.metrics import (
        MULTIHOST_MAINTENANCE_TAKEOVERS, global_registry,
    )
    from paimon_tpu_torch.parallel.distributed import resume_ownership_map
    from paimon_tpu_torch.parallel.maintenance_plane import (
        MaintenancePlane,
    )
    from paimon_tpu_torch.schema import Schema
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    from paimon_tpu_torch.table import FileStoreTable as PortTable
    from paimon_tpu_torch.types import BigIntType

    FileStoreTable = _cpu_table(PortTable)

    def schema(extra=None):
        return (Schema.builder().column("id", BigIntType(False))
                .column("v", BigIntType()).primary_key("id")
                .options({"bucket": "4", **(extra or {})}).build())

    opts = {
        "stream.checkpoint.interval": "60",
        "stream.compaction.interval": "80",
        "stream.ingest.poll-interval": "10",
        "stream.serve.poll-interval": "15",
        "num-sorted-run.compaction-trigger": "3",
        "multihost.lease.interval": "150",
        "multihost.lease.timeout": "1200",
        "snapshot.num-retained.min": "100000",
        "snapshot.num-retained.max": "100000",
    }
    t = FileStoreTable.create(str(tmp_path / "dist"), schema(opts))
    source = MemoryCdcSource()
    expected = {}

    def emit(n0, n1):
        events = []
        for n in range(n0, n1):
            key = n % 37
            events.append({"op": "c", "after": {"id": key, "v": n}})
            expected[key] = n
        source.append(*events)

    g = global_registry().multihost_metrics()
    takeovers0 = g.counter(MULTIHOST_MAINTENANCE_TAKEOVERS).count
    now = {"ms": 1_000_000}
    planes = [MaintenancePlane(FileStoreTable.load(t.path),
                               base_user="stream-daemon", process_index=i,
                               process_count=2, clock=lambda: now["ms"])
              for i in range(2)]
    daemons = [StreamDaemon(FileStoreTable.load(t.path), source,
                            commit_user="stream-daemon",
                            plane=planes[i]).start() for i in range(2)]
    consumed = [[], []]

    def drain(i):
        while True:
            rows = daemons[i].poll_changelog(timeout=0.0)
            if not rows:
                return
            consumed[i].extend(rows)

    def committed(i, upto):
        drain(0), drain(1)
        return daemons[i].status()["offset_committed"] >= upto

    total = 0
    try:
        # both alive: each batch committed by both before the next
        for _ in range(6):
            emit(total, total + 30)
            total += 30
            assert wait_for(lambda: committed(0, total - 1)
                            and committed(1, total - 1)), \
                [d.status() for d in daemons]
        # host 1 dies abruptly; its lease goes stale only now
        daemons[1].kill()
        drain(1)
        now["ms"] += 10_000
        for _ in range(6):
            emit(total, total + 30)
            total += 30
            assert wait_for(lambda: committed(0, total - 1)), \
                daemons[0].status()
        last = source.latest_offset()
        assert wait_for(lambda: committed(0, last) and daemons[0].status()[
            "distributed"]["adopted"] == [1]), daemons[0].status()
        daemons[0].stop(drain=True)
        drain(0)
    finally:
        for d in daemons:
            d.kill()

    assert g.counter(MULTIHOST_MAINTENANCE_TAKEOVERS).count > takeovers0
    final = FileStoreTable.load(t.path)
    oracle = FileStoreTable.create(str(tmp_path / "oracle"), schema())
    wb = oracle.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_dicts([{"id": k, "v": v}
                       for k, v in sorted(expected.items())])
        wb.new_commit().commit(w.prepare_commit())
    assert final.to_arrow().sort_by("id").equals(
        oracle.to_arrow().sort_by("id"))
    materialized = {}
    for stream in (consumed[1], consumed[0]):
        for r in stream:
            if r[ROW_KIND_COL] in (0, 2):
                materialized[r["id"]] = r["v"]
            elif r[ROW_KIND_COL] == 3:
                materialized.pop(r["id"], None)
    assert materialized == expected
    offsets = {0: [], 1: []}
    for snap in final.snapshot_manager.snapshots():
        for p in (0, 1):
            if snap.commit_user == f"stream-daemon-p{p}" and \
                    "stream.source.offset" in (snap.properties or {}):
                offsets[p].append(
                    int(snap.properties["stream.source.offset"]))
    assert offsets[0] and offsets[1]
    for p in (0, 1):
        assert offsets[p] == sorted(set(offsets[p])), offsets[p]
    assert offsets[0][-1] >= source.latest_offset()
    resumed = resume_ownership_map(final)
    assert resumed is not None and resumed.dead == frozenset({1})
    report = final.fsck()
    assert report.ok, [v.to_dict() for v in report.violations]


def test_planes_of_both_packages_interoperate(tmp_path):
    """A port plane and a reference plane over one table, one injected
    clock: the reference's takeover of process 2 is read back by the
    port (generation, dead set, stamp), the port's heartbeat renews, a
    port rejoiner's request is granted by the reference, and each
    package's fsck and generation history agree on the chain."""
    import paimon_tpu.parallel.distributed as RD
    import paimon_tpu_torch.parallel.distributed as PD
    from paimon_tpu.parallel.maintenance_plane import (
        MaintenancePlane as RefPlane,
    )
    from paimon_tpu.schema import Schema as RefSchema
    from paimon_tpu.table import FileStoreTable as RefTable
    from paimon_tpu.types import BigIntType as RefBigInt
    from paimon_tpu_torch.parallel.maintenance_plane import MaintenancePlane
    from paimon_tpu_torch.table import FileStoreTable as PortTable

    schema = (RefSchema.builder().column("id", RefBigInt(False))
              .column("v", RefBigInt()).primary_key("id")
              .options({"bucket": "4", "multihost.lease.timeout": "1000",
                        "multihost.lease.interval": "100"}).build())
    ref = RefTable.create(str(tmp_path / "t"), schema)
    port = PortTable.load(ref.path, device="cpu")
    now = {"ms": 0}
    clock = lambda: now["ms"]            # noqa: E731
    r0 = RefPlane(ref, base_user="m", process_index=0, process_count=3,
                  clock=clock)
    p1 = MaintenancePlane(port, base_user="m", process_index=1,
                          process_count=3, clock=clock)
    r0.ensure_lease()
    now["ms"] = 5_000                    # process 2 never renewed
    p1.ensure_lease()
    assert r0.detect_and_take_over() == frozenset({2})
    r0.maybe_heartbeat(now_ms=5_000 + 100)
    now["ms"] = 5_200
    stamped = p1.stamp_properties()      # refreshes from the store
    assert p1.ownership.dead == frozenset({2})
    assert stamped["multihost.ownership.version"] == "2"
    p1.refresh_view()
    assert p1.expired_processes() == frozenset()
    assert p1.maybe_heartbeat() is not None
    # process 2 restarts as a port rejoiner; the reference grants it
    p2 = MaintenancePlane(PortTable.load(ref.path, device="cpu"),
                          base_user="m", process_index=2,
                          process_count=3, clock=clock)
    assert p2.rejoining
    assert p2.request_rejoin() is not None
    assert r0.pending_rejoin_requests() == frozenset({2})
    assert r0.readmit({2}) == frozenset({2})
    r0.maybe_heartbeat(now_ms=10_000)
    assert p2.refresh_ownership() and not p2.rejoining
    assert p2.owns((), next(b for b in range(4)
                            if PD.owner_of((), b, 3) == 2))
    for t in (RefTable.load(ref.path), PortTable.load(ref.path,
                                                      device="cpu")):
        assert t.fsck().ok
    want = RD.resume_generation_history(RefTable.load(ref.path))
    got = PD.resume_generation_history(PortTable.load(ref.path,
                                                      device="cpu"))
    assert got.to_property() == want.to_property()
    assert [sorted(m.dead) for m in got.entries] == [[], [2], []]
