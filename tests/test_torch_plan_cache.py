"""paimon_tpu_torch's delta-apply plan cache and columnar stats sidecar
against paimon_tpu.

The cases of tests/test_metadata_plane.py that the port's planes cover,
each run on both packages: a delta-applied plan equals a cold walk
(`scan.plan.cache=false`) across commit kinds, tags, rollback and
overwrite, and both packages' plans have the same shape (their data
files carry random names, so splits compare by each file's level, row
count and key range); a streaming re-plan reads only the delta
manifests; the entry bound holds; the sidecar prunes by partition and
by key range before any manifest is fetched; a corrupt or missing
sidecar degrades to the Python check; a failed sidecar write does not
abort the commit; and each package prunes with the other's sidecar,
whose Arrow schema is the same.
"""

import pyarrow as pa
import pytest

from paimon_tpu.core.plan_cache import reset_plan_caches as ref_reset
from paimon_tpu_torch import metrics as M
from paimon_tpu_torch.core.plan_cache import reset_plan_caches
from tests.test_torch_dynamic_bucket import PORT, REF


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    reset_plan_caches()
    ref_reset()
    yield
    reset_plan_caches()
    ref_reset()


def _counter(pkg, name) -> int:
    if pkg is PORT:
        return M.global_registry().plan_metrics().counter(name).count
    from paimon_tpu.metrics import global_registry
    return global_registry().plan_metrics().counter(name).count


def make(pkg, root, opts=None, partitioned=False, buckets=2):
    cols = [("id", "BigIntType", False), ("v", "DoubleType", True)]
    pk, parts = ("id",), ()
    if partitioned:
        cols.append(("pt", "IntType", False))
        pk, parts = ("pt", "id"), ("pt",)
    schema = pkg.schema(cols, pk=pk, partitions=parts, options={
        "bucket": str(buckets), "write-only": "true", **(opts or {})})
    return pkg.create(str(root), schema)


def commit(table, rows, overwrite=False, static_partition=None):
    wb = table.new_batch_write_builder()
    if overwrite:
        wb = wb.with_overwrite(static_partition)
    w = wb.new_write()
    try:
        w.write_dicts(rows)
        return wb.new_commit().commit(w.prepare_commit())
    finally:
        w.close()


def canon(plan):
    """A plan's splits by value: files by level, rows and key range."""
    return [(s.snapshot_id, s.partition, s.bucket, s.total_buckets,
             tuple((f.level, f.row_count, f.min_key, f.max_key)
                   for f in s.data_files), s.raw_convertible)
            for s in plan.splits]


def cold_plan(table, snapshot=None, **filters):
    scan = table.copy({"scan.plan.cache": "false"}).new_scan()
    if "partition_filter" in filters:
        scan = scan.with_partition_filter(filters["partition_filter"])
    if "key_filter" in filters:
        scan = scan.with_key_filter(filters["key_filter"])
    return scan.plan(snapshot)


def both(scenario, tmp_path):
    got = [scenario(pkg, tmp_path / pkg.name) for pkg in (PORT, REF)]
    assert got[0] == got[1]
    return got[0]


class RecordingFileIO:
    """A FileIO proxy recording every path read."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = []

    def read_bytes(self, path, *a, **k):
        self.reads.append(path)
        return self._inner.read_bytes(path, *a, **k)

    def read_utf8(self, path):
        self.reads.append(path)
        return self._inner.read_utf8(path)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def watched(pkg, table):
    rio = RecordingFileIO(table.file_io)
    kw = {"device": "cpu"} if pkg is PORT else {}
    return rio, pkg.Table.load(table.path, file_io=rio, **kw)


# -- delta-apply vs cold-walk identity -------------------------------------

def test_delta_apply_oracle_across_commit_kinds(tmp_path):
    """After every commit kind the cached plan equals a cold walk;
    appends and compactions advance the state, the overwrite family
    (INSERT OVERWRITE, bucket rescale) invalidates it."""
    def scenario(pkg, root):
        t = make(pkg, root)
        out = []

        def check():
            before = _counter(pkg, M.PLAN_DELTA_APPLIES)
            warm = t.new_scan().plan()
            applied = _counter(pkg, M.PLAN_DELTA_APPLIES) - before
            assert canon(warm) == canon(cold_plan(t))
            out.append((bool(applied), canon(warm)))

        commit(t, [{"id": i, "v": 1.0} for i in range(8)])
        check()
        check()                                  # a pure tip hit
        commit(t, [{"id": i, "v": 2.0} for i in range(4, 12)])
        check()
        t.compact(full=True)                     # ADD + DELETE entries
        check()
        commit(t, [{"id": i, "v": 9.0} for i in range(3)], overwrite=True)
        check()
        commit(t, [{"id": 50, "v": 5.0}])
        check()
        t.rescale_buckets(4)
        check()
        commit(t, [{"id": 60, "v": 6.0}])
        check()
        return out

    out = both(scenario, tmp_path)
    assert [a for a, _ in out] == [False, False, True, True, False, True,
                                   False, True]


def test_delta_apply_oracle_dropped_partition(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, partitioned=True)
        for pt in range(3):
            commit(t, [{"id": i, "v": float(pt), "pt": pt}
                       for i in range(6)])
        warm = t.new_scan().plan()
        assert canon(warm) == canon(cold_plan(t))
        commit(t, [], overwrite=True, static_partition={"pt": 1})
        before = _counter(pkg, M.PLAN_DELTA_APPLIES) if pkg is PORT else \
            _counter(pkg, "plan_delta_applies")
        warm = t.new_scan().plan()
        after = _counter(pkg, "plan_delta_applies")
        assert after == before                   # invalidated
        assert canon(warm) == canon(cold_plan(t))
        return canon(warm), sorted({s.partition for s in warm.splits})

    _, parts = both(scenario, tmp_path)
    assert parts == [(0,), (2,)]


def test_delta_apply_tag_time_travel(tmp_path):
    """Planning a tagged older snapshot bypasses the cache without
    disturbing it; the tip still delta-applies afterwards."""
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": i, "v": 1.0} for i in range(4)])
        t.create_tag("v1")
        t.new_scan().plan()
        commit(t, [{"id": i, "v": 2.0} for i in range(2, 6)])
        tag_snap = t.snapshot_manager.snapshot(1)
        old = t.new_scan().plan(tag_snap)
        assert canon(old) == canon(cold_plan(t, tag_snap))
        before = _counter(pkg, "plan_delta_applies")
        warm = t.new_scan().plan()
        assert _counter(pkg, "plan_delta_applies") == before + 1
        assert canon(warm) == canon(cold_plan(t))
        return canon(old), canon(warm)

    both(scenario, tmp_path)


def test_rollback_recreated_snapshot_invalidates(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(3):
            commit(t, [{"id": j, "v": float(i)} for j in range(4)])
        t.new_scan().plan()                      # cached at snapshot 3
        t.rollback_to(1)
        commit(t, [{"id": 9, "v": 9.0}])         # recreates id 2
        commit(t, [{"id": 10, "v": 10.0}])       # recreates id 3
        warm = t.new_scan().plan()
        assert canon(warm) == canon(cold_plan(t))
        return canon(warm), sorted(t.to_arrow().column("id").to_pylist())

    _, ids = both(scenario, tmp_path)
    assert ids == [0, 1, 2, 3, 9, 10]


def test_rollback_to_older_tip_rebuilds_state(tmp_path):
    """A state anchored on a deleted higher id drops and rebuilds at the
    regressed tip; genuine time travel keeps the cached tip."""
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(3):
            commit(t, [{"id": j, "v": float(i)} for j in range(4)])
        t.new_scan().plan()
        if pkg is PORT:
            from paimon_tpu_torch.core.plan_cache import shared_plan_cache
        else:
            from paimon_tpu.core.plan_cache import shared_plan_cache
        cache = shared_plan_cache(t.path, t.branch)
        old = t.snapshot_manager.snapshot(2)
        assert canon(t.new_scan().plan(old)) == canon(cold_plan(t, old))
        assert cache.state().snapshot_id == 3
        t.rollback_to(2)
        warm = t.new_scan().plan()
        assert canon(warm) == canon(cold_plan(t))
        assert cache.state().snapshot_id == 2
        before = _counter(pkg, "plan_delta_applies")
        commit(t, [{"id": 9, "v": 9.0}])
        warm = t.new_scan().plan()
        assert _counter(pkg, "plan_delta_applies") == before + 1
        assert canon(warm) == canon(cold_plan(t))
        return canon(warm)

    both(scenario, tmp_path)


def test_read_entries_recovers_after_rollback_recreated_id(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(3):
            commit(t, [{"id": j, "v": float(i)} for j in range(4)])
        t.new_scan().plan()
        t.rollback_to(2)
        commit(t, [{"id": 9, "v": 9.0}])         # recreates id 3
        snap = t.latest_snapshot()
        entries = t.new_scan().read_entries(snap)
        if pkg is PORT:
            from paimon_tpu_torch.core.plan_cache import shared_plan_cache
        else:
            from paimon_tpu.core.plan_cache import shared_plan_cache
        state = shared_plan_cache(t.path, t.branch).state()
        assert state is not None and state.matches_tip(snap)
        assert state.entry_count == len(entries)
        cold = t.copy({"scan.plan.cache": "false"}).new_scan() \
            .read_entries(snap)
        assert sorted(e.identifier() for e in entries) == \
            sorted(e.identifier() for e in cold)
        return len(entries), sorted(t.to_arrow().column("id").to_pylist())

    both(scenario, tmp_path)


def test_streaming_replan_is_entry_identical_over_a_stream(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        before = _counter(pkg, "plan_delta_applies")
        out = []
        for i in range(8):
            commit(t, [{"id": i * 3 + d, "v": float(i)} for d in range(3)])
            warm = t.new_scan().plan()
            assert canon(warm) == canon(cold_plan(t))
            out.append(canon(warm))
        return out, _counter(pkg, "plan_delta_applies") - before

    assert both(scenario, tmp_path)[1] == 7


def test_stream_consumer_replans_through_the_cache(tmp_path):
    """A `latest` stream consumer re-planning after each commit sees
    every commit exactly once, as the reference's does."""
    def scenario(pkg, root):
        t = make(pkg, root, {"scan.mode": "latest"})
        commit(t, [{"id": 100 + i, "v": 0.0} for i in range(3)])
        scan = t.new_read_builder().new_stream_scan()
        read = t.new_read_builder().new_read()
        first = read.to_arrow(scan.plan().splits).num_rows
        seen = []
        for i in range(4):
            commit(t, [{"id": i, "v": float(i)}, {"id": 100, "v": 1.0}])
            full = t.new_scan().plan()           # the table re-plans too
            assert canon(full) == canon(cold_plan(t))
            got = read.to_arrow(scan.plan().splits)
            seen.append(sorted(got.column("id").to_pylist()))
        return first, seen

    first, seen = both(scenario, tmp_path)
    assert first == 0
    assert seen == [[i, 100] for i in range(4)]


# -- op count: a re-plan reads only the delta ------------------------------

def test_replan_reads_only_the_delta_manifests(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(3):
            commit(t, [{"id": j, "v": float(i)} for j in range(6)])
        t.new_scan().plan()                      # warm the cache
        sid = commit(t, [{"id": 100, "v": 4.0}])
        snap = t.snapshot_manager.snapshot(sid)
        delta = snap.delta_manifest_list
        delta_manifests = {m.file_name for m in
                           t.new_scan().manifest_list.read(delta)}
        assert delta_manifests
        rio, w = watched(pkg, t)
        plan = w.new_scan().plan()
        assert plan.snapshot_id == sid
        reads = sorted(p.rsplit("/", 1)[-1] for p in rio.reads
                       if "/manifest/" in p)
        assert reads == sorted([delta] + list(delta_manifests)), reads
        return len(reads)

    both(scenario, tmp_path)


def test_over_bound_table_never_walks_twice(tmp_path):
    """Over scan.plan.cache.max-entries the state is not kept, and each
    plan walks the chain once."""
    def scenario(pkg, root):
        t = make(pkg, root, {"scan.plan.cache.max-entries": "1"})
        for i in range(3):
            commit(t, [{"id": j, "v": float(i)} for j in range(6)])
        oracle = canon(cold_plan(t))
        rio, w = watched(pkg, t)
        out = []
        for _ in range(2):
            rio.reads.clear()
            assert canon(w.new_scan().plan()) == oracle
            seen = [p for p in rio.reads if "/manifest/" in p]
            assert len(seen) == len(set(seen)), seen
            out.append(len(seen))
        if pkg is PORT:
            reset_plan_caches()
            from paimon_tpu_torch.core.plan_cache import shared_plan_cache
        else:
            ref_reset()
            from paimon_tpu.core.plan_cache import shared_plan_cache
        rio.reads.clear()
        entries = w.new_scan().read_entries(w.latest_snapshot())
        seen = [p for p in rio.reads if "/manifest/" in p]
        assert len(seen) == len(set(seen)), seen
        assert shared_plan_cache(t.path, t.branch).state() is None
        return out, len(entries)

    assert both(scenario, tmp_path)[1] == 6     # 3 commits x 2 buckets


# -- vectorised manifest pruning -------------------------------------------

def test_sidecar_prunes_partition_manifests_unfetched(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, {"scan.plan.cache": "false"}, partitioned=True)
        for pt in range(4):
            commit(t, [{"id": i, "v": float(pt), "pt": pt}
                       for i in range(5)])
        snap = t.latest_snapshot()
        scan0 = t.new_scan()
        metas = scan0.manifest_list.read_all(snap.base_manifest_list,
                                             snap.delta_manifest_list)
        assert len(metas) == 4
        rio, w = watched(pkg, t)
        c = {n: _counter(pkg, n) for n in
             ("manifests_pruned", "manifests_read", "entries_decoded")}
        plan = w.new_scan().with_partition_filter({"pt": 2}).plan()
        d = {n: _counter(pkg, n) - c[n] for n in c}
        fetched = {p.rsplit("/", 1)[-1] for p in rio.reads
                   if "/manifest/manifest-" in p
                   and "manifest-list" not in p}
        kept = [m for m in metas if m.file_name in fetched]
        assert len(kept) == 1
        assert d["entries_decoded"] == \
            len(scan0.manifest_file.read(kept[0].file_name))
        return (sorted({s.partition for s in plan.splits}),
                plan.row_count, d)

    parts, rows, d = both(scenario, tmp_path)
    assert parts == [(2,)] and rows == 5
    assert d["manifests_pruned"] == 3 and d["manifests_read"] == 1


def test_sidecar_prunes_on_key_range(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, {"scan.plan.cache": "false"}, buckets=1)
        commit(t, [{"id": i, "v": 1.0} for i in range(100)])
        commit(t, [{"id": i, "v": 2.0} for i in range(1000, 1100)])
        pred = pkg.P.and_(pkg.P.greater_than("id", 1000),
                          pkg.P.less_or_equal("id", 1050))
        before = _counter(pkg, "manifests_pruned")
        plan = t.new_scan().with_key_filter(pred).plan()
        pruned = _counter(pkg, "manifests_pruned") - before
        files = [f for s in plan.splits for f in s.data_files]
        return pruned, len(files), t.to_arrow(predicate=pred).num_rows

    pruned, files, rows = both(scenario, tmp_path)
    assert pruned >= 1 and files == 1 and rows == 50


def test_key_filtered_cold_plan_prunes_with_cache_on(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, buckets=1)
        commit(t, [{"id": i, "v": 1.0} for i in range(100)])
        commit(t, [{"id": i, "v": 2.0} for i in range(1000, 1100)])
        reset_plan_caches() if pkg is PORT else ref_reset()
        pred = pkg.P.and_(pkg.P.greater_than("id", 1000),
                          pkg.P.less_or_equal("id", 1050))
        before = _counter(pkg, "manifests_pruned")
        plan = t.new_scan().with_key_filter(pred).plan()
        assert _counter(pkg, "manifests_pruned") - before >= 1
        assert len([f for s in plan.splits for f in s.data_files]) == 1
        before = _counter(pkg, "plan_delta_applies")
        t.new_scan().plan()
        commit(t, [{"id": 5000, "v": 3.0}])
        t.new_scan().plan()
        return _counter(pkg, "plan_delta_applies") - before

    assert both(scenario, tmp_path) == 1


def test_sidecar_written_and_deleted_with_its_list(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(4):
            commit(t, [{"id": j, "v": float(i)} for j in range(4)])
        scan = t.new_scan()
        snap = t.latest_snapshot()
        if pkg is PORT:
            from paimon_tpu_torch.manifest.stats_sidecar import sidecar_path
        else:
            from paimon_tpu.manifest.stats_sidecar import sidecar_path
        for name in (snap.base_manifest_list, snap.delta_manifest_list):
            assert t.file_io.exists(sidecar_path(scan.manifest_list
                                                 .path(name)))
            assert scan.manifest_list.read_sidecar(name) is not None
        old = t.snapshot_manager.snapshot(1)
        old_delta = scan.manifest_list.path(old.delta_manifest_list)
        t.expire_snapshots(retain_max=1, retain_min=1,
                           older_than_ms=10 ** 18)
        return (t.file_io.exists(old_delta),
                t.file_io.exists(sidecar_path(old_delta)), t.fsck().ok)

    assert both(scenario, tmp_path) == (False, False, True)


def test_sidecar_corruption_degrades_to_python_fallback(tmp_path):
    """A garbage sidecar never changes a result: pruning falls back to
    the per-meta Python check (the port counts each such manifest)."""
    def scenario(pkg, root):
        t = make(pkg, root, {"scan.plan.cache": "false"}, partitioned=True)
        for pt in range(3):
            commit(t, [{"id": i, "v": float(pt), "pt": pt}
                       for i in range(4)])
        scan = t.new_scan()
        snap = t.latest_snapshot()
        if pkg is PORT:
            from paimon_tpu_torch.manifest.stats_sidecar import sidecar_path
        else:
            from paimon_tpu.manifest.stats_sidecar import sidecar_path
        for name in (snap.base_manifest_list, snap.delta_manifest_list):
            p = sidecar_path(scan.manifest_list.path(name))
            if t.file_io.exists(p):
                t.file_io.write_bytes(p, b"\x00garbage", overwrite=True)
        before = M.global_registry().plan_metrics() \
            .counter(M.PLAN_SIDECAR_FALLBACKS).count
        plan = t.new_scan().with_partition_filter({"pt": 1}).plan()
        fallbacks = M.global_registry().plan_metrics() \
            .counter(M.PLAN_SIDECAR_FALLBACKS).count - before
        return (sorted({s.partition for s in plan.splits}), plan.row_count,
                fallbacks if pkg is PORT else 3)

    assert both(scenario, tmp_path) == ([(1,)], 4, 3)


def test_sidecar_write_failure_does_not_abort_commit(tmp_path):
    class SidecarFailingIO:
        def __init__(self, inner):
            self._inner = inner

        def write_bytes(self, path, *a, **k):
            if path.rsplit("/", 1)[-1].startswith("stats-"):
                raise OSError("injected sidecar write failure")
            return self._inner.write_bytes(path, *a, **k)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        kw = {"device": "cpu"} if pkg is PORT else {}
        failing = pkg.Table.load(t.path, file_io=SidecarFailingIO(t.file_io),
                                 **kw)
        sid = commit(failing, [{"id": 2, "v": 2.0}])
        snap = t.latest_snapshot()
        assert snap.id == sid
        assert t.new_scan().manifest_list.read_sidecar(
            snap.delta_manifest_list) is None
        assert canon(t.new_scan().plan()) == canon(cold_plan(t))
        return sid, t.to_arrow().num_rows, t.fsck().ok

    assert both(scenario, tmp_path) == (2, 2, True)


@pytest.mark.parametrize("writer", [PORT, REF], ids=["port", "ref"])
def test_each_package_prunes_with_the_others_sidecar(tmp_path, writer):
    """The sidecar bytes are the reference's: the same Arrow schema and
    column types, and both packages' readers prune the same manifests
    from one table's sidecars."""
    from paimon_tpu.manifest.stats_sidecar import read_sidecar as ref_read
    from paimon_tpu_torch.manifest.stats_sidecar import read_sidecar
    t = make(writer, tmp_path / "t", {"scan.plan.cache": "false"},
             partitioned=True)
    for pt in range(4):
        commit(t, [{"id": i + 10 * pt, "v": float(pt), "pt": pt}
                   for i in range(5)])
    snap = t.latest_snapshot()
    lpath = t.new_scan().manifest_list.path(snap.base_manifest_list)
    mine, theirs = read_sidecar(t.file_io, lpath), ref_read(t.file_io, lpath)
    assert mine is not None and mine.equals(theirs)
    assert [(f.name, str(f.type)) for f in mine.schema] == \
        [("file_name", "string"), ("min_bucket", "int32"),
         ("max_bucket", "int32"), ("p0_min", "int32"), ("p0_max", "int32"),
         ("k_min", "int64"), ("k_max", "int64")]
    out = []
    fb = M.global_registry().plan_metrics().counter(M.PLAN_SIDECAR_FALLBACKS)
    fb0 = fb.count
    for pkg in (PORT, REF):
        other = pkg.load(t.path, {"scan.plan.cache": "false"})
        before = _counter(pkg, "manifests_pruned")
        plan = other.new_scan().with_partition_filter({"pt": 3}).plan()
        pred = pkg.P.less_than("id", 10)
        kplan = other.new_scan().with_key_filter(pred).plan()
        out.append((_counter(pkg, "manifests_pruned") - before,
                    plan.row_count, kplan.row_count))
    # pt=3 prunes 3 manifests; id < 10 prunes pt 2 and 3 (the bound is
    # inclusive, so pt 1, whose band starts at 10, stays)
    assert out[0] == out[1] == (3 + 2, 5, 5)
    assert fb.count == fb0          # the port read every sidecar


def test_sidecar_bytes_build_equal(tmp_path):
    """Both packages build the same sidecar bytes from one list's
    metas."""
    from paimon_tpu.manifest.stats_sidecar import build_sidecar as ref_build
    from paimon_tpu.types import BigIntType as RB
    from paimon_tpu.types import IntType as RI
    from paimon_tpu_torch.manifest.stats_sidecar import build_sidecar
    from paimon_tpu_torch.types import BigIntType, IntType
    t = make(REF, tmp_path / "t", partitioned=True)
    for pt in range(3):
        commit(t, [{"id": i, "v": 1.0, "pt": pt} for i in range(5)])
    snap = t.latest_snapshot()
    metas = t.new_scan().manifest_list.read(snap.base_manifest_list)
    port_metas = PORT.load(t.path).new_scan().manifest_list.read(
        snap.base_manifest_list)
    ref_blob = ref_build(metas, [RI(False)], [RB(False)])
    blob = build_sidecar(port_metas, [IntType(False)], [BigIntType(False)])
    rd = pa.ipc.open_stream(pa.py_buffer(blob)).read_all()
    assert rd.equals(pa.ipc.open_stream(pa.py_buffer(ref_blob)).read_all())
