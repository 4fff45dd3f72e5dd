"""The streaming daemon of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_stream_daemon.py run on the port (the
reference's source pointed at paimon_tpu_torch, its tables on the CPU),
with the port's copy of the fault-injected soak harness below standing
in for tests/soak_harness.py, which imports the reference.  The
crash-point sweep of tests/crash_sweep.py is copied here the same way
and kills every mutating op of the port's offset-commit path
(`checkpoint_once`).  Across the packages: `checkpoint_once` on the same
seeded events gives equal tables, offsets, identifiers and commit kinds,
and each package recovers the other's checkpoint; one daemon run gives
the reference's stream-group (group, metric) pairs and span names.
`plane=` runs the distributed mode (tests/test_torch_maintenance_plane.py
holds it against the reference).  Waits are bounded waits on
conditions; no fixed sleep decides a pass.
"""

import random
import sys
import time
import types
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import pytest

import paimon_tpu.metrics as RM
import paimon_tpu.obs.trace as RT
import paimon_tpu_torch.metrics as M
import paimon_tpu_torch.obs.trace as T
import paimon_tpu_torch.table.table as port_table_mod
from paimon_tpu.cdc.source import MemoryCdcSource as RefMemorySource
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.service import stream_daemon as ref_daemon
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu_torch.cdc.source import MemoryCdcSource
from paimon_tpu_torch.core.read import ROW_KIND_COL
from paimon_tpu_torch.metrics import (
    STREAM_CHECKPOINTS, STREAM_COMPACTIONS, STREAM_EVENTS_INGESTED,
    STREAM_FRESHNESS_MS, STREAM_LOOP_RESTARTS, global_registry,
)
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.service import stream_daemon as port_daemon
from paimon_tpu_torch.service.stream_daemon import (
    PROP_OFFSET, StreamDaemon, checkpoint_once, recover_checkpoint,
)
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType
from tests.failing_fileio import FailingFileIO, InjectedIOError
from tests.test_torch_append import (
    _cpu_table, reference_cases, run_reference_case,
)


def _wait(cond, timeout=15.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


# -- the port's copy of tests/soak_harness.py --------------------------------

SOAK_TABLE_OPTIONS = {
    "bucket": "2",
    # small checkpoints and a small trigger, so a short soak runs many
    # checkpoint commits and real compactions
    "stream.checkpoint.interval": "80",
    "stream.compaction.interval": "200",
    "num-sorted-run.compaction-trigger": "3",
    "stream.serve.poll-interval": "20",
    "stream.ingest.poll-interval": "10",
    "stream.restart.backoff": "20",
    "stream.restart.backoff.cap": "150",
    "write.retry.backoff": "5",
    # keep every snapshot: the offset audit walks all of them, and the
    # serving loop must never lose a delta to expiry
    "snapshot.num-retained.min": "100000",
    "snapshot.num-retained.max": "100000",
}


class _Auditor:
    """Expected state and the changelog's materialisation (upserts)."""

    def __init__(self):
        self.expected: Dict[int, int] = {}
        self.materialized: Dict[int, int] = {}

    def emit(self, key: int, value: Optional[int]):
        if value is None:
            self.expected.pop(key, None)
        else:
            self.expected[key] = value

    def apply(self, rows: List[dict]):
        for r in rows:
            kind = r[ROW_KIND_COL]
            if kind in (0, 2):                     # +I / +U
                self.materialized[r["id"]] = r["v"]
            elif kind == 3:                        # -D
                self.materialized.pop(r["id"], None)


def _drain(daemon: StreamDaemon, auditor: _Auditor,
           timeout: float = 0.05):
    while True:
        rows = daemon.poll_changelog(timeout=timeout)
        if not rows:
            return
        auditor.apply(rows)


def run_soak(base_dir: str, *, duration_s: float = 6.0, seed: int = 7,
             keys: int = 29, emit_batch: int = 4,
             emit_interval_s: float = 0.004, kills: int = 3,
             storms: int = 3, storm_fail_times: int = 5,
             mesh: bool = False, delete_ratio: float = 0.08,
             table_options: Optional[Dict[str, str]] = None,
             device="cpu") -> Dict:
    """The reference's soak on the port: ingest, compaction and serving
    for `duration_s` while 503 storms (bounded fail_times) and
    kill/restart cycles mid-checkpoint hit the store; asserts no lost or
    duplicated event in the table and in the changelog across daemon
    incarnations, strictly rising offsets and identifiers, fsck clean,
    and freshness measured; returns the report."""
    rng = random.Random(seed)
    fault_name = f"soak-{uuid.uuid4().hex[:8]}"
    opts = dict(SOAK_TABLE_OPTIONS)
    if mesh:
        opts["tpu.mesh.compact"] = "true"
    opts.update(table_options or {})
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", BigIntType()).primary_key("id")
              .options(opts).build())
    base = FileStoreTable.create(f"{base_dir}/soak", schema, device=device)
    fio = FailingFileIO(base.file_io, fault_name)
    table = FileStoreTable(fio, base.path, base.schema_manager.latest(),
                           device=device)
    source = MemoryCdcSource()
    auditor = _Auditor()
    counter = {"n": 0}

    def emit_some(k: int):
        events = []
        for _ in range(k):
            n = counter["n"]
            counter["n"] = n + 1
            key = n % keys
            if auditor.expected.get(key) is not None and \
                    rng.random() < delete_ratio:
                events.append({"op": "d", "before": {"id": key, "v": n}})
                auditor.emit(key, None)
            else:
                events.append({"op": "c", "after": {"id": key, "v": n}})
                auditor.emit(key, n)
        source.append(*events)

    # kills evenly spaced in the middle 70% of the run, storms between
    t_start = time.monotonic()
    t_end = t_start + duration_s
    emit_until = t_start + duration_s * 0.8
    kill_at = [t_start + duration_s * (0.15 + 0.7 * (i + 1) / (kills + 1))
               for i in range(kills)]
    storm_at = [t_start + duration_s * (0.1 + 0.7 * (i + 0.5)
                                        / (storms + 1))
                for i in range(storms)]
    storms_done = kills_done = 0
    g = global_registry().stream_metrics()
    names = (STREAM_EVENTS_INGESTED, STREAM_CHECKPOINTS,
             STREAM_LOOP_RESTARTS, STREAM_COMPACTIONS)
    base_counts = {name: g.counter(name).count for name in names}

    daemon = StreamDaemon(table, source).start()
    incarnations = 1
    last_emit = 0.0
    try:
        while time.monotonic() < t_end:
            now = time.monotonic()
            if now < emit_until and now - last_emit >= emit_interval_s:
                emit_some(emit_batch)
                last_emit = now
            _drain(daemon, auditor, timeout=0.0)
            if storms_done < storms and now >= storm_at[storms_done]:
                # a transient 503 storm; a small fail_after tears what
                # comes next (two-phase closes and commits too)
                FailingFileIO.reset(fault_name, rng.randrange(0, 4),
                                    fail_times=storm_fail_times)
                storms_done += 1
            if kills_done < kills and now >= kill_at[kills_done]:
                # kill mid-checkpoint: everything fails, the checkpoint
                # in flight dies, then the process "dies"
                FailingFileIO.reset(fault_name, 0)
                time.sleep(0.05)
                daemon.kill()
                FailingFileIO.disarm(fault_name)
                _drain(daemon, auditor)        # old incarnation's tail
                daemon = StreamDaemon(table, source).start()
                incarnations += 1
                kills_done += 1
            time.sleep(0.002)
        FailingFileIO.disarm(fault_name)
        last_offset = source.latest_offset()
        deadline = time.monotonic() + max(30.0, duration_s)
        while time.monotonic() < deadline:
            _drain(daemon, auditor, timeout=0.0)
            if daemon.status()["offset_committed"] >= last_offset:
                break
            time.sleep(0.05)
        status = daemon.stop(drain=True)
        _drain(daemon, auditor)
    finally:
        FailingFileIO.disarm(fault_name)
        daemon.kill()

    assert status["offset_committed"] == last_offset, \
        f"daemon never converged: committed " \
        f"{status['offset_committed']} < emitted {last_offset}"
    final = FileStoreTable.load(base.path, device=device)
    table_state = {r["id"]: r["v"] for r in final.to_arrow().to_pylist()}
    assert table_state == auditor.expected, "lost or duplicated writes"
    assert auditor.materialized == auditor.expected, \
        "lost or duplicated changelog deliveries"
    offsets, idents = [], []
    for snap in final.snapshot_manager.snapshots():
        if snap.commit_user == "stream-daemon" and snap.properties \
                and PROP_OFFSET in snap.properties:
            offsets.append(int(snap.properties[PROP_OFFSET]))
            idents.append(snap.commit_identifier)
    assert offsets == sorted(set(offsets)), offsets
    assert offsets and offsets[-1] == last_offset
    assert idents == sorted(set(idents)), idents
    assert recover_checkpoint(final, "stream-daemon")[0] == last_offset
    report = final.fsck()
    assert report.ok, [v.to_dict() for v in report.violations]
    freshness = g.histogram(STREAM_FRESHNESS_MS)
    assert freshness.total_count > 0, "no freshness samples"
    return {
        "duration_s": round(time.monotonic() - t_start, 2),
        "events_emitted": counter["n"],
        "events_ingested": g.counter(STREAM_EVENTS_INGESTED).count
        - base_counts[STREAM_EVENTS_INGESTED],
        "checkpoints": g.counter(STREAM_CHECKPOINTS).count
        - base_counts[STREAM_CHECKPOINTS],
        "loop_restarts": g.counter(STREAM_LOOP_RESTARTS).count
        - base_counts[STREAM_LOOP_RESTARTS],
        "compactions": g.counter(STREAM_COMPACTIONS).count
        - base_counts[STREAM_COMPACTIONS],
        "kill_restart_cycles": kills_done,
        "storms": storms_done,
        "daemon_incarnations": incarnations,
        "keys_final": len(auditor.expected),
        "freshness_p95_ms": freshness.percentile(95),
        "freshness_samples": freshness.total_count,
        "fsck_ok": True,
        "final_offset": last_offset,
        "snapshots": final.snapshot_manager.snapshot_count(),
    }


# -- the port's copy of tests/crash_sweep.py ---------------------------------

@dataclass
class CrashPoint:
    index: int
    op: str
    path: str

    def __str__(self):
        return f"crash point #{self.index} ({self.op} {self.path})"


def crash_point_sweep(make_table: Callable[[str], FileStoreTable],
                      operation: Callable[[FileStoreTable], object], *,
                      name: str,
                      verify_converged: Optional[Callable] = None,
                      max_points: int = 400) -> List[CrashPoint]:
    """Kill the i-th mutating op of `operation` on a fresh table for
    every i until the operation completes untouched; after each crash
    the table reads, the operation restarted on a clean FileIO
    converges, and fsck finds the converged table clean."""
    points: List[CrashPoint] = []
    for idx in range(max_points):
        table = make_table(f"{name}-{idx}")
        fio = FailingFileIO(table.file_io, name)
        broken = FileStoreTable(fio, table.path,
                                table.schema_manager.latest(),
                                device=table.device, branch=table.branch)
        FailingFileIO.reset(name, idx)
        try:
            operation(broken)
            crashed = False
        except InjectedIOError:
            crashed = True
        finally:
            trace = FailingFileIO.ops(name)
            FailingFileIO.disarm(name)
        killed = [r for r in trace if r.killed]
        if not killed:
            assert not crashed
            return points
        point = CrashPoint(idx, killed[0].op, killed[0].path)
        points.append(point)
        try:
            table.to_arrow()
        except Exception as e:              # noqa: BLE001
            raise AssertionError(f"{point}: unreadable after the crash: "
                                 f"{type(e).__name__}: {e}") from e
        fresh = FileStoreTable.load(table.path, file_io=table.file_io,
                                    device=table.device)
        try:
            operation(fresh)
        except Exception as e:              # noqa: BLE001
            raise AssertionError(f"{point}: restart did not converge: "
                                 f"{type(e).__name__}: {e}") from e
        if verify_converged is not None:
            verify_converged(fresh)
        report = fresh.fsck()
        assert report.ok, f"{point}: fsck after restart: " \
            f"{[v.to_dict() for v in report.violations]}"
    raise AssertionError(f"sweep {name!r} did not terminate within "
                         f"{max_points} crash points")


# -- the reference's cases on the port ---------------------------------------

def _cpu_init_table(table_cls):
    """`table_cls` whose constructor, create and load default to the
    CPU, for cases that build a table over a wrapped FileIO by hand."""
    class CpuInitTable(_cpu_table(table_cls)):
        def __init__(self, *args, device="cpu", **kwargs):
            super().__init__(*args, device=device, **kwargs)
    CpuInitTable.__name__ = table_cls.__name__
    return CpuInitTable


CASES = reference_cases("test_stream_daemon", skip=("test_soak_full",))


def _run_on_port(case, tmp_path, monkeypatch, request=None):
    harness = types.ModuleType("tests.soak_harness")
    harness.run_soak = run_soak
    monkeypatch.setitem(sys.modules, "tests.soak_harness", harness)
    monkeypatch.setattr(port_table_mod, "FileStoreTable",
                        _cpu_init_table(port_table_mod.FileStoreTable))
    run_reference_case(case, "port", tmp_path, monkeypatch, request)


@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case_on_port(tmp_path, monkeypatch, request, case):
    _run_on_port(case, tmp_path, monkeypatch, request)


@pytest.mark.slow
def test_soak_full_on_port(tmp_path, monkeypatch):
    _run_on_port(("test_stream_daemon", "test_soak_full"), tmp_path,
                 monkeypatch)


def test_reference_cases_are_all_here():
    assert len(CASES) == 14


# -- the stream checkpoint sweep of tests/test_crash_sweeps.py ---------------

def _sweep_factory(tmp_path):
    def make(tag):
        schema = (Schema.builder().column("id", BigIntType(False))
                  .column("v", DoubleType()).primary_key("id")
                  .options({"bucket": "1", "write-only": "true"}).build())
        return FileStoreTable.create(str(tmp_path / tag), schema,
                                     device="cpu")
    return make


def test_stream_checkpoint_sweep(tmp_path):
    """Kill every mutating op of the offset-commit path (ingest writes,
    flush uploads, manifest encodes, the snapshot CAS, hint writes): at
    each crash point the table reads, a restarted checkpoint replays
    from the recovered offset to exactly one copy of every event, the
    offset lands with the data, fsck is clean."""
    events = [{"op": "c", "after": {"id": i % 3, "v": float(i)}}
              for i in range(6)]
    expected = [{"id": 0, "v": 3.0}, {"id": 1, "v": 4.0},
                {"id": 2, "v": 5.0}]

    def op(table):
        checkpoint_once(table, MemoryCdcSource(events))

    def converged(table):
        rows = sorted(table.to_arrow().to_pylist(), key=lambda r: r["id"])
        assert rows == expected
        off, ckpt = recover_checkpoint(table, "stream-daemon")
        assert off == len(events) - 1 and ckpt >= 1
        offs = [int(s.properties[PROP_OFFSET])
                for s in table.snapshot_manager.snapshots()
                if s.commit_user == "stream-daemon" and s.properties]
        assert offs == sorted(set(offs))

    pts = crash_point_sweep(_sweep_factory(tmp_path), op,
                            name=f"sweep-stream-ckpt-{uuid.uuid4().hex[:6]}",
                            verify_converged=converged)
    assert len(pts) >= 5
    assert all(p.op and p.path for p in pts)


# -- checkpoints across the two packages -------------------------------------

def _seeded_events(seed, n, keys=50):
    rng = np.random.default_rng(seed)
    live, out = set(), []
    for i in range(n):
        k = int(rng.integers(keys))
        if k in live and rng.random() < 0.1:
            out.append({"op": "d", "before": {"id": k, "v": i}})
            live.discard(k)
        elif k in live:
            out.append({"op": "u", "before": {"id": k, "v": i - 1},
                        "after": {"id": k, "v": i}})
        else:
            out.append({"op": "c", "after": {"id": k, "v": i}})
            live.add(k)
    return out


def _both_tables(tmp_path, opts=None):
    options = {"bucket": "2", **(opts or {})}
    port = FileStoreTable.create(
        str(tmp_path / "port"),
        Schema.builder().column("id", BigIntType(False))
        .column("v", BigIntType()).primary_key("id").options(options)
        .build(), device="cpu")
    ref = RefTable.create(
        str(tmp_path / "ref"),
        RefSchema.builder().column("id", RefBigInt(False))
        .column("v", RefBigInt()).primary_key("id").options(options)
        .build())
    return port, ref


def _marks(table):
    return [(s.commit_user, s.commit_identifier, s.commit_kind,
             (s.properties or {}).get(PROP_OFFSET), s.delta_record_count)
            for s in table.snapshot_manager.snapshots()]


def _rows(table):
    return sorted(table.to_arrow().to_pylist(), key=lambda r: r["id"])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_checkpoint_once_equals_reference(tmp_path, seed):
    events = _seeded_events(seed, 400)
    port, ref = _both_tables(tmp_path)
    psrc, rsrc = MemoryCdcSource(), RefMemorySource()
    for lo in range(0, 400, 80):
        psrc.append(*events[lo:lo + 80])
        rsrc.append(*events[lo:lo + 80])
        assert (checkpoint_once(port, psrc, max_events=60) is None) == \
            (ref_daemon.checkpoint_once(ref, rsrc, max_events=60) is None)
    while checkpoint_once(port, psrc) is not None:
        assert ref_daemon.checkpoint_once(ref, rsrc) is not None
    assert ref_daemon.checkpoint_once(ref, rsrc) is None
    port = FileStoreTable.load(port.path, device="cpu")
    ref = RefTable.load(ref.path)
    assert _rows(port) == _rows(ref)
    assert _marks(port) == _marks(ref)
    want = ref_daemon.recover_checkpoint(ref, "stream-daemon")
    assert want == (399, len([m for m in _marks(ref) if m[3]]))
    assert recover_checkpoint(port, "stream-daemon") == want
    # each package recovers the other's checkpoint and reads its table
    assert recover_checkpoint(FileStoreTable.load(ref.path, device="cpu"),
                              "stream-daemon") == want
    assert ref_daemon.recover_checkpoint(RefTable.load(port.path),
                                         "stream-daemon") == want
    assert _rows(RefTable.load(port.path)) == _rows(ref)
    assert _rows(FileStoreTable.load(ref.path, device="cpu")) == _rows(ref)


def test_each_package_resumes_the_others_checkpoint(tmp_path):
    """A checkpoint written by one package, continued by the other:
    offsets and identifiers carry on, the table is the same."""
    events = _seeded_events(9, 300)
    port, ref = _both_tables(tmp_path)
    src, rsrc = MemoryCdcSource(events), RefMemorySource(events)
    checkpoint_once(port, src, max_events=100)
    ref_daemon.checkpoint_once(ref, rsrc, max_events=100)
    # the other package takes over each table
    ref_daemon.checkpoint_once(RefTable.load(port.path), rsrc,
                               max_events=100)
    checkpoint_once(FileStoreTable.load(ref.path, device="cpu"), src,
                    max_events=100)
    checkpoint_once(FileStoreTable.load(port.path, device="cpu"), src)
    ref_daemon.checkpoint_once(RefTable.load(ref.path), rsrc)
    a = FileStoreTable.load(port.path, device="cpu")
    b = RefTable.load(ref.path)
    assert _rows(a) == _rows(b)
    assert _marks(a) == _marks(b)
    assert recover_checkpoint(a, "stream-daemon") == (299, 3)


# -- metrics and spans of one daemon run -------------------------------------

@pytest.fixture
def fresh_registries(monkeypatch):
    for mod in (M, RM):
        monkeypatch.setattr(mod, "_GLOBAL", mod.MetricRegistry())

    def clean():
        for tr in (T, RT):
            tr.disable_tracing()
            tr.collector().clear()
    clean()
    yield
    clean()


class _FlakySource:
    """Fails its first poll once, so the ingest loop restarts once."""

    def __init__(self, inner):
        self.inner = inner
        self.failed = False

    def poll(self, after, n):
        if not self.failed:
            self.failed = True
            raise IOError("source connection lost")
        return self.inner.poll(after, n)

    def backlog(self, after):
        return self.inner.backlog(after)


def _daemon_run(table, daemon_cls, source, registry):
    """Ingest 120 events in 6 checkpoints, wait for a compaction and a
    served follow-up delta, then drain."""
    g = registry.stream_metrics()
    d = daemon_cls(table, _FlakySource(source)).start()
    events = _seeded_events(4, 120, keys=20)
    for lo in range(0, 120, 20):
        source.append(*events[lo:lo + 20])
        assert _wait(lambda: d.status()["offset_committed"] == lo + 19)
    assert _wait(lambda: g.counter(STREAM_COMPACTIONS).count > 0)
    assert _wait(lambda: g.histogram(STREAM_FRESHNESS_MS).total_count > 0)
    rows = []
    status = d.stop()
    while True:
        got = d.poll_changelog(timeout=0.05)
        if not got:
            break
        rows.extend(got)
    assert status["loops"]["ingest"]["restarts"] == 1
    assert not any(lp["failed"] for lp in status["loops"].values())
    return rows


def test_stream_metrics_and_spans_equal_reference(tmp_path,
                                                  fresh_registries):
    opts = {"trace.enabled": "true", "stream.checkpoint.interval": "20",
            "stream.compaction.interval": "50",
            "stream.manifest-compaction.interval": "1",
            "stream.ingest.poll-interval": "5",
            "stream.serve.poll-interval": "5",
            "stream.restart.backoff": "5",
            "num-sorted-run.compaction-trigger": "2"}
    port, ref = _both_tables(tmp_path, opts)
    got = {}
    for name, table, cls, src, mod, tr in (
            ("port", port, StreamDaemon, MemoryCdcSource(), M, T),
            ("reference", ref, ref_daemon.StreamDaemon, RefMemorySource(),
             RM, RT)):
        reg = mod.global_registry()
        _daemon_run(table, cls, src, reg)
        pairs = {(r["group"], r["metric"]) for r in reg.snapshot_rows()
                 if r["group"].startswith("stream")}
        spans = {s.name for s in tr.collector().snapshot()
                 if s.name.startswith("stream.")}
        got[name] = (pairs, spans)
    assert got["port"] == got["reference"]
    assert {m for _, m in got["port"][0]} >= {
        "events_ingested", "checkpoints", "checkpoint_ms",
        "loop_restarts", "freshness_ms", "changelog_rows_served",
        "compactions", "source_backlog"}
    assert got["port"][1] >= {"stream.ingest.batch", "stream.checkpoint",
                              "stream.compact", "stream.serve.batch",
                              "stream.restart.backoff"}


def test_daemon_runs_on_its_tables_device(tmp_path):
    port, _ = _both_tables(tmp_path)
    d = StreamDaemon(port, MemoryCdcSource())
    assert d.device == port.device
    assert d.table.device.type == "cpu"


# -- the distributed mode (it raised naming A.8.9) ---------------------------

def test_plane_mode_recovers_the_references_plane_stamps(tmp_path):
    """`plane=` runs, and `recover_plane_stamps` reads a distributed
    daemon's adoption ledger and floors as the reference's does, from a
    table either package stamped."""
    from paimon_tpu.core.commit import FileStoreCommit as RefCommit
    from paimon_tpu.parallel.distributed import OwnershipMap as RefMap
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.parallel.maintenance_plane import MaintenancePlane

    port, ref = _both_tables(tmp_path)
    props = {**RefMap(2, 3, 2, frozenset({2})).to_properties(),
             "stream.adopted": "2", "stream.floor.p2": "41",
             PROP_OFFSET: "50", "stream.ingest.ts-ms": "1"}
    for t, commit in ((port, FileStoreCommit), (ref, RefCommit)):
        commit(t.file_io, t.path, t.schema, t.options,
               commit_user="stream-daemon-p0").commit(
            [], properties=props, force_create=True)
    for t in (port, ref):
        got = port_daemon.recover_plane_stamps(t, "stream-daemon-p0")
        assert got == ref_daemon.recover_plane_stamps(t,
                                                      "stream-daemon-p0")
        assert got == (frozenset({2}), {2: 41})
    plane = MaintenancePlane(port, base_user="stream-daemon",
                             process_index=0, process_count=3,
                             clock=lambda: 0)
    d = StreamDaemon(port, MemoryCdcSource(), commit_user="stream-daemon",
                     plane=plane)
    assert d.commit_user == "stream-daemon-p0"
    assert plane.ownership.dead == frozenset({2})
    with pytest.raises(ValueError, match="base_user"):
        StreamDaemon(port, MemoryCdcSource(), commit_user="other",
                     plane=plane)


def test_file_source_parses_a_line_when_first_polled(tmp_path):
    """The port parses each line when a poll first returns it: a new
    source resuming after a committed offset never parses the prefix
    (a line there that is not JSON goes unnoticed), and a bad line past
    it raises from every poll that reaches it."""
    import json as _json

    from paimon_tpu_torch.cdc.source import FileCdcSource
    path = str(tmp_path / "events.jsonl")
    good = [_json.dumps({"op": "c", "after": {"id": i, "v": i}})
            for i in range(4)]
    with open(path, "w") as f:
        f.write("\n".join(["{not json"] + good + ["{bad", good[0]]) + "\n")
    src = FileCdcSource(path)
    assert [o for o, _ in src.poll(0, 4)] == [1, 2, 3, 4]
    assert src.backlog(0) == 6 and src.latest_offset() == 6
    src.commit_through(2)
    assert [e["after"]["id"] for _, e in src.poll(2, 2)] == [2, 3]
    for _ in range(2):
        with pytest.raises(ValueError):
            src.poll(4, 10)
    with pytest.raises(ValueError):
        FileCdcSource(path).poll(-1, 10)
