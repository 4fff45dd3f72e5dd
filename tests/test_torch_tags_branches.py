"""Tags, branches, fallback reads and incremental reads of
paimon_tpu_torch against paimon_tpu.

The tag and branch cases of tests/test_snapshot.py, the incremental
cases of test_stream_scan.py and the fallback and chain-streaming cases
of test_changelog_decoupled.py run the same scenario on both packages
(`both`); the rows read and the tag and branch files by name must be
equal, and the reference test's assertions hold on each.  Cross cases:
a branch one package created is written and fast-forwarded by the
other.  Every value compared is a row or a name, so equality is exact.
"""

import os
import time

import pytest

from tests.test_torch_dynamic_bucket import PORT, REF
from tests.test_torch_maintenance import (
    both, commit, make, meta_files, rows,
)


def module(pkg, name):
    import importlib
    return importlib.import_module(
        ("paimon_tpu_torch" if pkg is PORT else "paimon_tpu") + "." + name)


def make_snapshot(snap_mod, sid, time_millis=None):
    return snap_mod.Snapshot(
        id=sid, schema_id=0,
        base_manifest_list=f"manifest-list-base-{sid}",
        delta_manifest_list=f"manifest-list-delta-{sid}",
        commit_user="test-user", commit_identifier=sid,
        commit_kind=snap_mod.CommitKind.APPEND,
        time_millis=time_millis or 1_700_000_000_000 + sid,
        total_record_count=sid * 100, delta_record_count=100)


# -- managers (tests/test_snapshot.py) ---------------------------------------

def test_tags(tmp_path):
    def scenario(pkg, root):
        snap = module(pkg, "snapshot")
        fio = module(pkg, "fs").LocalFileIO()
        path = os.path.join(root, "t")
        sm = snap.SnapshotManager(fio, path)
        for i in range(1, 4):
            sm.try_commit(make_snapshot(snap, i))
        tm = snap.TagManager(fio, sm.table_path)
        tm.create_tag(sm.snapshot(2), "v1.0")
        assert tm.tag_exists("v1.0") and tm.get_tag("v1.0").id == 2
        with pytest.raises(ValueError):
            tm.create_tag(sm.snapshot(3), "v1.0")
        tm.create_tag(sm.snapshot(3), "v1.1")
        names = list(tm.tags())
        assert names == ["v1.0", "v1.1"]
        tm.delete_tag("v1.0")
        assert not tm.tag_exists("v1.0")
        tm.rename_tag("v1.1", "v2")
        with pytest.raises(ValueError):
            tm.rename_tag("v2", "v2")
        return names, sorted(os.listdir(tm.tag_dir)), \
            open(tm.tag_path("v2")).read()
    both(scenario, tmp_path)


def test_tag_time_retained_expiry(tmp_path):
    def scenario(pkg, root):
        snap = module(pkg, "snapshot")
        fio = module(pkg, "fs").LocalFileIO()
        sm = snap.SnapshotManager(fio, os.path.join(root, "t"))
        sm.try_commit(make_snapshot(snap, 1))
        tm = snap.TagManager(fio, sm.table_path)
        tm.create_tag(sm.snapshot(1), "short", time_retained_ms=1000)
        tm.create_tag(sm.snapshot(1), "forever")
        now = int(time.time() * 1000)
        kept = tm.expire_tags(now_ms=now - 10_000)
        gone = tm.expire_tags(now_ms=now + 10_000)
        return kept, gone, sorted(tm.tags())
    assert both(scenario, tmp_path) == ([], ["short"], ["forever"])


def test_branches(tmp_path):
    def scenario(pkg, root):
        snap = module(pkg, "snapshot")
        schema_mod = module(pkg, "schema")
        fio = module(pkg, "fs").LocalFileIO()
        path = os.path.join(root, "t")
        schema_mod.SchemaManager(fio, path).create_table(
            pkg.Schema.builder().column("id", pkg.types.IntType(False))
            .build())
        sm = snap.SnapshotManager(fio, path)
        for i in range(1, 3):
            sm.try_commit(make_snapshot(snap, i))
        bm = snap.BranchManager(fio, path)
        bm.create_branch("dev", from_snapshot=sm.snapshot(2))
        assert bm.branch_exists("dev") and bm.branches() == ["dev"]
        branch_sm = snap.SnapshotManager(fio, path, branch="dev")
        assert branch_sm.latest_snapshot_id() == 2
        branch_sm.try_commit(make_snapshot(snap, 3))
        bm.fast_forward("dev")
        assert sm.latest_snapshot_id() == 3
        layout = sorted(os.path.relpath(os.path.join(r, f), path)
                        for r, _, fs in os.walk(path) for f in fs)
        bm.drop_branch("dev")
        assert not bm.branch_exists("dev")
        return layout
    both(scenario, tmp_path)


# -- table-level tags and branches -------------------------------------------

def test_scan_tag_name_reads_the_tagged_snapshot(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}])
        t.create_tag("v1")
        commit(t, [{"id": 1, "v": 10.0}, {"id": 3, "v": 3.0}],
               kinds=[0, 0])
        commit(t, [{"id": 2, "v": 2.0}], kinds=[3])
        t.compact(full=True)
        tagged = rows(t, **{"scan.tag-name": "v1"})
        plan_tagged = t.new_read_builder().new_scan().plan(tag_name="v1")
        assert plan_tagged.snapshot_id == 1
        t.delete_tag("v1")
        assert "v1" not in t.tag_manager.tags()
        return tagged, rows(t), meta_files(t)
    tagged, latest, _ = both(scenario, tmp_path)
    assert tagged == [{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}]
    assert latest == [{"id": 1, "v": 10.0}, {"id": 3, "v": 3.0}]


def test_create_tag_without_snapshot_raises(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        with pytest.raises(ValueError, match="no snapshot"):
            t.create_tag("x")
        return True
    both(scenario, tmp_path)


def test_branch_write_read_rename_delete(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, partitioned=True)
        commit(t, [{"id": 1, "v": 1.0, "dt": "a"}])
        t.create_tag("base")
        t.create_branch("dev", "base")
        dev = t.copy({"branch": "dev"})
        assert dev.branch == "dev"
        commit(dev, [{"id": 2, "v": 2.0, "dt": "b"}])
        commit(t, [{"id": 3, "v": 3.0, "dt": "a"}])
        seen = {"main": rows(t), "dev": rows(dev),
                "dev-loaded": rows(pkg.load(t.path, {"branch": "dev"}))}
        t.rename_branch("dev", "feat")
        assert t.branch_manager.branches() == ["feat"]
        seen["feat"] = rows(t.copy({"branch": "feat"}))
        with pytest.raises(ValueError):
            t.rename_branch("main", "x")
        layout = meta_files(t)
        t.delete_branch("feat")
        assert t.branch_manager.branches() == []
        return seen, layout
    seen, _ = both(scenario, tmp_path)
    assert [r["id"] for r in seen["dev"]] == [1, 2]
    assert seen["feat"] == seen["dev"] == seen["dev-loaded"]


def test_fast_forward_and_rollback(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(3):
            commit(t, [{"id": i, "v": float(i)}])
        t.create_tag("t2", 2)
        t.create_branch("fix", "t2")
        fix = t.copy({"branch": "fix"})
        commit(fix, [{"id": 1, "v": 100.0}])
        t.fast_forward("fix")
        after_ff = rows(pkg.load(t.path))
        t.rollback_to(2)
        after_rb = rows(pkg.load(t.path))
        with pytest.raises(ValueError):
            t.rollback_to(99)
        return after_ff, after_rb, meta_files(t)
    ff, rb, _ = both(scenario, tmp_path)
    assert ff == [{"id": 0, "v": 0.0}, {"id": 1, "v": 100.0}]
    assert rb == [{"id": 0, "v": 0.0}, {"id": 1, "v": 1.0}]


def test_fast_forward_past_expiry_keeps_hints_valid(tmp_path):
    """A reference fault the port does not share (ROADMAP.md C): main's
    snapshots expired past the tag a branch started from, then
    fast_forward; the reference's EARLIEST hint names a deleted snapshot
    (fsck: bad-hint), the port's names the earliest one.  Rows agree."""
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(6):
            commit(t, [{"id": i, "v": 1.0}])
            if i == 1:
                t.create_tag("t1")
        t.create_branch("b", "t1")
        t.expire_snapshots(retain_max=2, retain_min=1)
        t.fast_forward("b")
        report = t.fsck()
        return rows(t), sorted(v.kind for v in report.violations)
    got = {}
    for pkg in (PORT, REF):
        root = str(tmp_path / pkg.name)
        os.makedirs(root)
        got[pkg.name] = scenario(pkg, root)
    assert got["port"][0] == got["reference"][0] == \
        [{"id": 0, "v": 1.0}, {"id": 1, "v": 1.0}]
    assert got["reference"][1] == ["bad-hint"]
    assert got["port"][1] == []


def test_branch_across_packages(tmp_path):
    """The reference creates a branch from a tag; the port writes it and
    fast-forwards main to it; the reference reads the result."""
    root = str(tmp_path)
    ref = make(REF, root, partitioned=True)
    commit(ref, [{"id": 1, "v": 1.0, "dt": "a"}])
    ref.create_tag("base")
    ref.create_branch("dev", "base")
    port = PORT.load(ref.path)
    dev = port.copy({"branch": "dev"})
    commit(dev, [{"id": 2, "v": 2.0, "dt": "b"}])
    assert rows(REF.load(ref.path, {"branch": "dev"})) == rows(dev)
    port.fast_forward("dev")
    assert rows(REF.load(ref.path)) == rows(PORT.load(ref.path)) == \
        [{"dt": "a", "id": 1, "v": 1.0}, {"dt": "b", "id": 2, "v": 2.0}]
    assert PORT.load(ref.path).fsck().ok and REF.load(ref.path).fsck().ok


# -- incremental reads (tests/test_stream_scan.py) ---------------------------

def test_incremental_between_batch_scan(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        commit(t, [{"id": 2, "v": 2.0}])
        t.create_tag("t2", 2)
        commit(t, [{"id": 3, "v": 3.0}])
        by_id = rows(t, **{"incremental-between": "1,3"})
        by_tag = rows(t, **{"incremental-between": "t2,3"})
        return by_id, by_tag
    by_id, by_tag = both(scenario, tmp_path)
    assert [r["id"] for r in by_id] == [2, 3]
    assert [r["id"] for r in by_tag] == [3]


def test_incremental_between_merges_across_snapshots(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for v in (1.0, 2.0, 3.0):
            commit(t, [{"id": 1, "v": v}])
        out = rows(t, **{"incremental-between": "0,3"})
        for bad in ("0,99", "3,1", "1"):
            with pytest.raises(ValueError):
                t.copy({"incremental-between": bad}).to_arrow()
        return out
    assert both(scenario, tmp_path) == [{"id": 1, "v": 3.0}]


def test_incremental_between_two_tags_across_buckets(tmp_path):
    """The cell's read in small: a range between two tags over two
    buckets and two partitions, with deletes and a compaction inside."""
    def scenario(pkg, root):
        t = make(pkg, root, {"bucket": "2"}, partitioned=True)
        commit(t, [{"id": i, "v": 0.0, "dt": f"d{i % 2}"}
                   for i in range(20)])
        t.create_tag("a")
        commit(t, [{"id": i, "v": 1.0, "dt": f"d{i % 2}"}
                   for i in range(0, 20, 3)])
        commit(t, [{"id": 4, "v": 0.0, "dt": "d0"}], kinds=[3])
        t.compact(full=True)
        commit(t, [{"id": 30, "v": 2.0, "dt": "d0"}])
        t.create_tag("b")
        commit(t, [{"id": 31, "v": 3.0, "dt": "d1"}])
        return (rows(t, **{"incremental-between": "a,b"}),
                rows(t, **{"incremental-between-tag-to-snapshot": "a,6"}))
    between, diff = both(scenario, tmp_path)
    assert 30 in [r["id"] for r in between]
    assert 31 in [r["id"] for r in diff]


def test_incremental_tag_to_snapshot_survives_expiry(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(4):
            commit(t, [{"id": i, "v": float(i)}])
            if i == 0:
                t.create_tag("t0")
        t.expire_snapshots(retain_max=1, retain_min=1)
        got = rows(t, **{"incremental-between-tag-to-snapshot": "t0,4"})
        with pytest.raises(ValueError):
            t.copy({"incremental-between-tag-to-snapshot":
                    "t0"}).to_arrow()
        return got
    assert [r["id"] for r in both(scenario, tmp_path)] == [1, 2, 3]


# -- fallback branch (tests/test_changelog_decoupled.py) ---------------------

def pt_table(pkg, root):
    return pkg.create(root, pkg.schema(
        [("pt", "IntType", False), ("id", "BigIntType", False),
         ("v", "DoubleType", True)], pk=("pt", "id"), partitions=("pt",),
        options={"bucket": "1", "write-only": "true"}))


def test_partition_fallback_reads(tmp_path):
    def scenario(pkg, root):
        t = pt_table(pkg, root)
        commit(t, [{"pt": 0, "id": 1, "v": 0.1},
                   {"pt": 1, "id": 1, "v": 1.1}])
        t.create_tag("base")
        t.create_branch("backfill", "base")
        fb = pkg.load(t.path, {"branch": "backfill"})
        commit(fb, [{"pt": 2, "id": 1, "v": 2.2},
                    {"pt": 1, "id": 9, "v": 9.9}])
        plain = rows(t)
        with_fb = rows(t, **{"scan.fallback-branch": "backfill"})
        assert {r["pt"] for r in plain} == {0, 1}
        assert {r["pt"] for r in with_fb} == {0, 1, 2}
        assert [r for r in with_fb if r["pt"] == 2][0]["v"] == 2.2
        assert all(r["id"] != 9 for r in with_fb if r["pt"] == 1)
        return plain, with_fb
    both(scenario, tmp_path)


def test_latest_full_stream_unions_fallback_then_delta_only(tmp_path):
    def scenario(pkg, root):
        t = pt_table(pkg, root)
        commit(t, [{"pt": 0, "id": 1, "v": 0.0}])
        t.create_tag("base")
        t.create_branch("hist", "base")
        commit(pkg.load(t.path, {"branch": "hist"}),
               [{"pt": 9, "id": 1, "v": 9.0}])
        chained = t.copy({"scan.fallback-branch": "hist"})
        scan = chained.new_read_builder().new_stream_scan()
        read = chained.new_read_builder().new_read()
        first = read.to_arrow(scan.plan()).to_pylist()
        assert {r["pt"] for r in first} == {0, 9}
        commit(t, [{"pt": 0, "id": 2, "v": 0.2}])
        nxt = read.to_arrow(scan.plan()).to_pylist()
        assert [r["id"] for r in nxt] == [2]
        return sorted(first, key=lambda r: r["pt"]), nxt
    both(scenario, tmp_path)


def test_stream_filters_apply_to_fallback(tmp_path):
    def scenario(pkg, root):
        t = pt_table(pkg, root)
        commit(t, [{"pt": 0, "id": 1, "v": 0.0}])
        t.create_tag("base")
        t.create_branch("hist", "base")
        commit(pkg.load(t.path, {"branch": "hist"}),
               [{"pt": 9, "id": 1, "v": 9.0}, {"pt": 5, "id": 1, "v": 5.0}])
        rb = t.copy({"scan.fallback-branch": "hist"}).new_read_builder() \
            .with_partition_filter({"pt": 5})
        first = rb.new_read().to_arrow(rb.new_stream_scan().plan())
        assert {r["pt"] for r in first.to_pylist()} == {5}
        return first.to_pylist()
    both(scenario, tmp_path)


def test_empty_primary_branch_still_serves_fallback(tmp_path):
    def scenario(pkg, root):
        t = pt_table(pkg, root)
        t.create_branch("hist")
        commit(pkg.load(t.path, {"branch": "hist"}),
               [{"pt": 1, "id": 1, "v": 1.0}])
        chained = t.copy({"scan.fallback-branch": "hist"})
        plan = chained.new_read_builder().new_stream_scan().plan()
        assert plan is not None
        got = chained.new_read_builder().new_read().to_arrow(plan)
        assert got.to_pylist()[0]["pt"] == 1
        return got.to_pylist(), rows(chained)
    both(scenario, tmp_path)


def test_fallback_serves_expired_partitions(tmp_path):
    """The cell's fallback read in small: main expires its oldest
    partitions; a branch made from a tag before the expiry still holds
    them, and a fallback read of main takes them from the branch."""
    def scenario(pkg, root):
        t = make(pkg, root, {"partition.expiration-time": "2 d",
                             "partition.timestamp-formatter": "yyyyMMdd"},
                 partitioned=True)
        for d in range(1, 5):
            commit(t, [{"id": i, "v": float(d), "dt": f"2026070{d}"}
                       for i in range(5)])
        t.create_tag("all")
        t.create_branch("hist", "all")
        expired = t.expire_partitions(
            now_ms=int(time.mktime((2026, 7, 5, 0, 0, 0, 0, 0, 0))) * 1000)
        return expired, rows(t), rows(t, **{"scan.fallback-branch": "hist"})
    expired, main, with_fb = both(scenario, tmp_path)
    assert expired == [("20260701",), ("20260702",)]
    assert len(main) == 10 and len(with_fb) == 20
