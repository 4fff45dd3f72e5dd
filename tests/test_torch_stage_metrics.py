"""The stage metrics and spans of paimon_tpu_torch's planes against
paimon_tpu's (ROADMAP.md C.7).

ROADMAP C.7's input (primary key `id BIGINT`, `v DOUBLE`, `bucket=2`,
three commits of 1,000 rows, then `to_arrow()` and `compact(full=True)`)
runs on both packages in this process, at the defaults and with
`trace.enabled=true`.  The (group, metric) pairs of the metric
registry's rows and the set of span names recorded must equal the
reference's; values may differ.  `CompactTimer` is held against the
reference's on a scripted clock.
"""

import numpy as np
import pytest

import paimon_tpu.metrics as RM
import paimon_tpu.obs.trace as RT
import paimon_tpu_torch.metrics as M
import paimon_tpu_torch.obs.trace as T
from tests.test_torch_dynamic_bucket import PORT, REF

ID_V = [("id", "BigIntType", False), ("v", "DoubleType", True)]


@pytest.fixture(autouse=True)
def _clean_registries(monkeypatch):
    """Each case runs on fresh registries (the process's own come back
    after it) and empty span rings, tracing off, in both packages.  The
    modules that resolve their counters once per process resolve them
    again, in the fresh registry."""
    import paimon_tpu.fs.caching as ref_caching
    import paimon_tpu.lookup.sst as ref_sst
    import paimon_tpu_torch.fs.caching as caching
    import paimon_tpu_torch.lookup.sst as sst
    for mod in (M, RM):
        monkeypatch.setattr(mod, "_GLOBAL", mod.MetricRegistry())
    for mod in (caching, sst, ref_caching, ref_sst):
        monkeypatch.setattr(mod, "_COUNTERS", None)
    monkeypatch.setattr(ref_caching, "_DISK_COUNTERS", None)

    def clean():
        for tr in (T, RT):
            tr.disable_tracing()
            tr.collector().clear()
    clean()
    yield
    clean()


def c7_input(pkg, root, options):
    """Three commits of 1,000 rows, a read and a full compaction."""
    t = pkg.create(str(root), pkg.schema(ID_V, options={
        "bucket": "2", **options}))
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(0, 2000, 1000)
        wb = t.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_dicts([{"id": int(i), "v": float(i)} for i in ids])
            wb.new_commit().commit(w.prepare_commit())
    rows = t.to_arrow().num_rows
    assert t.compact(full=True) is not None
    return rows


def observed(pkg):
    reg = (M if pkg is PORT else RM).global_registry()
    tr = T if pkg is PORT else RT
    pairs = {(r["group"], r["metric"]) for r in reg.snapshot_rows()}
    return pairs, {s.name for s in tr.collector().snapshot()}


@pytest.mark.parametrize("options", [{}, {"trace.enabled": "true"}],
                         ids=["defaults", "traced"])
def test_metric_pairs_and_span_names_equal_reference(tmp_path, options):
    got = {}
    for pkg in (PORT, REF):
        rows = c7_input(pkg, tmp_path / pkg.name, options)
        got[pkg.name] = (rows, *observed(pkg))
    assert got["port"] == got["reference"]
    rows, pairs, spans = got["port"]
    assert rows > 0
    # the 17 pairs C.7 found missing
    assert {("commit", "cas_ms"), ("commit", "commits"),
            ("commit", "duration_ms"), ("commit", "manifest_encode_ms"),
            ("compaction", "busy_ratio_1m"), ("compaction", "duration_ms"),
            ("compaction", "input_files"), ("compaction", "output_files"),
            ("compaction", "tasks"), ("io", "decode_ms"),
            ("io", "encode_ms"), ("io", "read_ms"), ("io", "upload_ms"),
            ("scan", "merge_ms"), ("scan", "plan_ms"), ("scan", "plans"),
            ("write", "sort_ms")} <= pairs
    if options:
        assert {"commit.cas", "commit.manifest_encode", "decode", "encode",
                "io.read", "io.upload", "scan.merge", "write.sort"} <= spans
    else:
        assert spans == set()


def test_stage_histograms_count_what_ran(tmp_path):
    """Each histogram counts one update per stage that ran: commits and
    CAS attempts, compaction tasks, encodes and uploads per data file."""
    c7_input(PORT, tmp_path, {})
    rows = {(r["group"], r["metric"]): r
            for r in M.global_registry().snapshot_rows()}
    assert rows[("commit", "commits")]["value"] == 4      # 3 + compaction
    assert rows[("commit", "cas_ms")]["total_count"] == 4
    assert rows[("commit", "duration_ms")]["total_count"] == 4
    assert rows[("compaction", "tasks")]["value"] == \
        rows[("compaction", "duration_ms")]["total_count"] == 2
    assert rows[("io", "encode_ms")]["total_count"] == \
        rows[("io", "upload_ms")]["total_count"]
    assert rows[("scan", "plans")]["value"] == \
        rows[("scan", "plan_ms")]["total_count"]
    assert rows[("scan", "merge_ms")]["total_count"] == 2  # one a bucket
    assert 0.0 <= rows[("compaction", "busy_ratio_1m")]["value"] <= 1.0


def test_a_commit_retry_counts_and_spans_its_backoff(tmp_path, monkeypatch):
    """A lost CAS retries: the commit group counts the retry and the
    backoff runs inside a commit.backoff span, in both packages."""
    from paimon_tpu.snapshot import SnapshotManager as RefSnapshots
    from paimon_tpu_torch.snapshot import SnapshotManager
    got = []
    for pkg, reg, tr, cls in ((PORT, M, T, SnapshotManager),
                              (REF, RM, RT, RefSnapshots)):
        t = pkg.create(str(tmp_path / pkg.name), pkg.schema(ID_V, options={
            "bucket": "1", "trace.enabled": "true",
            "commit.min-retry-wait": "1 ms",
            "commit.max-retry-wait": "2 ms"}))
        wb = t.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_dicts([{"id": 1, "v": 1.0}])
            msgs = w.prepare_commit()
        orig = cls.try_commit
        lost = []

        def lose_once(self, snapshot, orig=orig, lost=lost):
            if not lost:
                lost.append(1)
                return False
            return orig(self, snapshot)

        monkeypatch.setattr(cls, "try_commit", lose_once)
        wb.new_commit().commit(msgs)
        monkeypatch.setattr(cls, "try_commit", orig)
        g = reg.global_registry().group("commit")
        spans = [s.name for s in tr.collector().snapshot()]
        got.append((g.counter("retries").count, g.counter("commits").count,
                    spans.count("commit.backoff"), spans.count("commit.cas")))
    assert got[0] == got[1] == (1, 1, 1, 2)


@pytest.mark.parametrize("script", [
    [("start", 0), ("stop", 500), ("ratio", 1000)],
    [("start", 0), ("start", 100), ("stop", 200), ("stop", 700),
     ("ratio", 800)],
    [("start", 0), ("stop", 30_000), ("start", 50_000), ("ratio", 70_000),
     ("stop", 80_000), ("ratio", 95_000), ("ratio", 200_000)],
    [("stop", 10), ("start", 20), ("ratio", 20), ("ratio", 61_000)]])
def test_compact_timer_matches_reference(script):
    """Sliding 60 s window, overlapping tasks sharing one interval, an
    unmatched stop ignored: the port's busy time equals the reference's
    on the same scripted clock."""
    now = [0]
    port = M.CompactTimer(clock=lambda: now[0])
    ref = RM.CompactTimer(clock=lambda: now[0])
    for op, at in script:
        now[0] = at
        for timer in (port, ref):
            if op == "start":
                timer.start()
            elif op == "stop":
                timer.stop()
        assert port.busy_millis() == ref.busy_millis()
        assert port.busy_ratio() == ref.busy_ratio()
        assert port.busy_millis(at + 5) == ref.busy_millis(at + 5)


def test_gauge_reads_its_function():
    g = M.global_registry().group("compaction")
    vals = iter([0.25, 0.5])
    gauge = g.gauge("probe", lambda: next(vals))
    assert gauge.value == 0.25
    assert g.gauge("probe").value == 0.5       # the first binding stays
    assert M.global_registry().group("x").gauge("set").value == 0.0
