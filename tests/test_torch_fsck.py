"""fsck and its repairs in paimon_tpu_torch against paimon_tpu.

The cases of tests/test_fsck.py run the same corruption on a table of
each package (`both`); the two reports must agree kind for kind, on
the snapshot each violation names, and on the objects checked and the
manifest entries decoded; the repairs run and their actions must
agree.  The reference's CLI cases become the same checks through the
API (the CLI is not ported), and the ownership-chain check runs on the
port's own copy of the stamp parsing.  Every value compared is a kind,
an id or a count, so equality is exact.
"""

import json
import os

import pyarrow.parquet as pq
import pytest

from tests.test_torch_dynamic_bucket import PORT, REF

FAR_FUTURE_MS = 10 ** 18


def api(pkg):
    import importlib
    base = "paimon_tpu_torch" if pkg is PORT else "paimon_tpu"
    return importlib.import_module(f"{base}.maintenance")


def make_table(pkg, root, opts=None):
    options = {"bucket": "1", "write-only": "true"}
    options.update(opts or {})
    t = pkg.create(root, pkg.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)],
        options=options))
    for i in range(3):
        commit(t, [{"id": j, "v": float(i)} for j in range(i, i + 4)])
    return t


def commit(table, rows, properties=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows)
    sid = wb.new_commit().commit(w.prepare_commit(), properties=properties)
    w.close()
    return sid


def report_obs(report):
    """A report without its free-text details (they hold paths)."""
    return (sorted((v.kind, v.snapshot_id) for v in report.violations),
            report.snapshots_checked, report.manifests_checked,
            report.data_files_checked, report.manifest_entries_decoded,
            report.incremental, report.ok)


def both(tmp_path, scenario):
    got = {}
    for pkg in (PORT, REF):
        root = str(tmp_path / pkg.name)
        os.makedirs(root, exist_ok=True)
        got[pkg.name] = scenario(pkg, make_table(pkg, root))
    assert got["port"] == got["reference"]
    return got["port"]


def live_data_paths(table):
    scan = table.new_scan()
    return sorted(scan.path_factory.data_file_path(s.partition, s.bucket,
                                                   f.file_name)
                  for s in table.new_read_builder().new_scan().plan().splits
                  for f in sorted(s.data_files,
                                  key=lambda f: f.min_sequence_number))


def live_data_in_order(table):
    """Live data files oldest first (names are random)."""
    scan = table.new_scan()
    files = [(f.min_sequence_number, s, f)
             for s in table.new_read_builder().new_scan().plan().splits
             for f in s.data_files]
    return [scan.path_factory.data_file_path(s.partition, s.bucket,
                                             f.file_name)
            for _, s, f in sorted(files, key=lambda x: x[0])]


def latest_manifest_paths(table):
    """Manifest files of the latest snapshot, in list order."""
    scan = table.new_scan()
    snap = table.latest_snapshot()
    names = []
    for list_name in (snap.base_manifest_list, snap.delta_manifest_list):
        if list_name:
            names.extend(m.file_name
                         for m in scan.manifest_list.read(list_name))
    return [scan.manifest_file.path(n) for n in names]


def test_healthy_table_is_clean(tmp_path):
    def scenario(pkg, t):
        report = api(pkg).fsck(t)
        assert report.ok and report.snapshots_checked == 3
        assert report.manifests_checked > 0
        assert report.data_files_checked > 0
        assert t.fsck().ok
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_dangling_data_file(tmp_path):
    def scenario(pkg, t):
        os.remove(live_data_in_order(t)[0])
        report = api(pkg).fsck(t)
        kind = api(pkg).ViolationKind.DANGLING_DATA_FILE
        assert kind in report.kinds()
        v = report.by_kind(kind)[0]
        assert v.snapshot_id is not None and v.obj
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_truncated_manifest(tmp_path):
    def scenario(pkg, t):
        path = latest_manifest_paths(t)[0]
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:len(blob) // 2])
        report = api(pkg).fsck(t)
        assert api(pkg).ViolationKind.CORRUPT_MANIFEST in report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_missing_manifest(tmp_path):
    def scenario(pkg, t):
        os.remove(latest_manifest_paths(t)[0])
        report = api(pkg).fsck(t)
        assert api(pkg).ViolationKind.MISSING_MANIFEST in report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_missing_manifest_list(tmp_path):
    def scenario(pkg, t):
        os.remove(t.new_scan().manifest_list.path(
            t.latest_snapshot().base_manifest_list))
        report = api(pkg).fsck(t)
        assert api(pkg).ViolationKind.MISSING_MANIFEST_LIST in \
            report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_snapshot_chain_gap(tmp_path):
    def scenario(pkg, t):
        os.remove(f"{t.path}/snapshot/snapshot-2")
        report = api(pkg).fsck(t)
        gaps = report.by_kind(api(pkg).ViolationKind.SNAPSHOT_GAP)
        assert gaps[0].snapshot_id == 2
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_bad_hints(tmp_path):
    def scenario(pkg, t):
        open(f"{t.path}/snapshot/EARLIEST", "w").write("99")
        report = api(pkg).fsck(t)
        assert api(pkg).ViolationKind.BAD_HINT in report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_detects_corrupt_snapshot(tmp_path):
    def scenario(pkg, t):
        open(f"{t.path}/snapshot/snapshot-2", "w").write("{not json")
        report = api(pkg).fsck(t)
        assert api(pkg).ViolationKind.CORRUPT_SNAPSHOT in report.kinds()
        assert api(pkg).fix_violations(t, report) == []
        return report_obs(report)
    both(tmp_path, scenario)


def test_corrupt_index_manifest_not_deleted_by_fix(tmp_path):
    def scenario(pkg, t):
        import importlib
        base = "paimon_tpu_torch" if pkg is PORT else "paimon_tpu"
        FileStoreCommit = importlib.import_module(
            f"{base}.core.commit").FileStoreCommit
        man = importlib.import_module(f"{base}.manifest")
        im = importlib.import_module(f"{base}.manifest.index_manifest")
        kinds = api(pkg).ViolationKind
        ix = im.IndexFileMeta("HASH", "index-test-0", 8, 2)
        t.file_io.write_bytes(
            t.new_scan().path_factory.index_file_path(ix.file_name),
            b"\x00" * 8)
        FileStoreCommit(t.file_io, t.path, t.schema, t.options).commit(
            [], index_entries=[im.IndexManifestEntry(man.FileKind.ADD,
                                                     b"", 0, ix)])
        path = t.new_scan().index_manifest_file.path(
            t.latest_snapshot().index_manifest)
        open(path, "wb").write(b"garbage")
        first = api(pkg).fsck(t, all_snapshots=False)
        assert kinds.CORRUPT_INDEX_MANIFEST in first.kinds()
        assert kinds.CORRUPT_MANIFEST not in first.kinds()
        assert api(pkg).fix_violations(t, first) == []
        assert t.file_io.exists(path)
        os.remove(path)
        second = api(pkg).fsck(t, all_snapshots=False)
        assert kinds.MISSING_INDEX_MANIFEST in second.kinds()
        assert kinds.MISSING_MANIFEST not in second.kinds()
        assert api(pkg).fix_violations(t, second) == []
        return report_obs(first), report_obs(second)
    both(tmp_path, scenario)


def test_detects_row_count_mismatch(tmp_path):
    def scenario(pkg, t):
        path = f"{t.path}/snapshot/snapshot-3"
        snap = json.loads(open(path).read())
        snap["totalRecordCount"] += 5
        open(path, "w").write(json.dumps(snap))
        report = api(pkg).fsck(t, snapshot_id=3)
        assert api(pkg).ViolationKind.ROW_COUNT_MISMATCH in report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_deep_detects_stats_mismatch(tmp_path):
    def scenario(pkg, t):
        kinds = api(pkg).ViolationKind
        path = live_data_in_order(t)[0]
        tab = pq.read_table(path)
        pq.write_table(tab.slice(0, tab.num_rows - 1), path)
        shallow = api(pkg).fsck(t, deep=False)
        assert shallow.kinds() <= {kinds.FILE_SIZE_MISMATCH}
        report = api(pkg).fsck(t, deep=True)
        assert kinds.STATS_MISMATCH in report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_deep_detects_corrupt_data_file(tmp_path):
    def scenario(pkg, t):
        path = live_data_in_order(t)[0]
        open(path, "wb").write(b"\x00" * os.path.getsize(path))
        report = api(pkg).fsck(t, deep=True)
        assert api(pkg).ViolationKind.CORRUPT_DATA_FILE in report.kinds()
        return report_obs(report)
    both(tmp_path, scenario)


def test_fsck_counts_violations_metric(tmp_path):
    def scenario(pkg, t):
        import importlib
        base = "paimon_tpu_torch" if pkg is PORT else "paimon_tpu"
        metrics = importlib.import_module(f"{base}.metrics")
        group = metrics.global_registry().maintenance_metrics()
        before = group.counter(metrics.FSCK_VIOLATIONS).count
        os.remove(live_data_in_order(t)[0])
        report = api(pkg).fsck(t)
        assert group.counter(metrics.FSCK_VIOLATIONS).count == \
            before + len(report.violations)
        return len(report.violations)
    both(tmp_path, scenario)


def test_fix_dangling_data_file(tmp_path):
    def scenario(pkg, t):
        os.remove(live_data_in_order(t)[0])
        report = api(pkg).fsck(t)
        actions = api(pkg).fix_violations(t, report)
        assert "remove-unexisting-files" in actions
        assert api(pkg).fsck(t, all_snapshots=False).ok
        api(pkg).expire_snapshots(t, retain_max=1, retain_min=1,
                                  older_than_ms=FAR_FUTURE_MS)
        assert api(pkg).fsck(t).ok
        return actions, sorted(t.to_arrow().to_pylist(),
                               key=lambda r: r["id"])
    both(tmp_path, scenario)


def test_fix_corrupt_manifest(tmp_path):
    def scenario(pkg, t):
        path = latest_manifest_paths(t)[0]
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:len(blob) // 2])
        report = api(pkg).fsck(t, all_snapshots=False)
        actions = api(pkg).fix_violations(t, report)
        assert "drop-corrupt-manifests" in actions
        assert "remove-unexisting-manifests" in actions
        after = api(pkg).fsck(t, all_snapshots=False)
        assert after.ok
        return actions, report_obs(after)
    both(tmp_path, scenario)


def test_fix_bad_hints(tmp_path):
    def scenario(pkg, t):
        open(f"{t.path}/snapshot/EARLIEST", "w").write("99")
        open(f"{t.path}/snapshot/LATEST", "w").write("77")
        actions = api(pkg).fix_violations(t, api(pkg).fsck(t))
        assert actions == ["rewrite-hints"]
        assert api(pkg).fsck(t).ok
        sm = t.snapshot_manager
        return sm.earliest_snapshot_id(), sm.latest_snapshot_id()
    assert both(tmp_path, scenario) == (1, 3)


# -- the reference's CLI cases, through the API ------------------------------

def test_report_json_clean_and_violations(tmp_path):
    def scenario(pkg, t):
        clean = json.loads(json.dumps(api(pkg).fsck(t).to_dict()))
        assert clean["ok"] is True
        open(f"{t.path}/snapshot/EARLIEST", "w").write("99")
        bad = json.loads(json.dumps(api(pkg).fsck(t).to_dict()))
        assert bad["ok"] is False
        assert bad["violations"][0]["kind"] == \
            api(pkg).ViolationKind.BAD_HINT
        for d in (clean, bad):
            for v in d["violations"]:
                v.pop("detail")
        return clean, bad
    both(tmp_path, scenario)


def test_fsck_then_fix_report(tmp_path):
    def scenario(pkg, t):
        open(f"{t.path}/snapshot/EARLIEST", "w").write("99")
        actions = api(pkg).fix_violations(t, api(pkg).fsck(t))
        report = api(pkg).fsck(t)
        assert report.ok and actions == ["rewrite-hints"]
        return actions
    both(tmp_path, scenario)


def test_incremental_flags_report(tmp_path):
    def scenario(pkg, t):
        assert api(pkg).fsck(t, stamp_watermark=True).ok
        d = api(pkg).fsck(t, incremental=True).to_dict()
        assert d["ok"] and d["incremental"]
        assert d["manifest_entries_decoded"] == 0
        return d
    both(tmp_path, scenario)


# -- incremental fsck (sweep watermark) --------------------------------------

def forge_total(table, sid, delta=7):
    path = f"{table.path}/snapshot/snapshot-{sid}"
    d = json.loads(open(path).read())
    d["totalRecordCount"] = d["totalRecordCount"] + delta
    open(path, "w").write(json.dumps(d))


def new_path(after, before):
    fresh = [p for p in after if p not in before]
    assert fresh, "expected post-watermark objects"
    return fresh[0]


def test_incremental_is_o_delta(tmp_path):
    def scenario(pkg, t):
        fsck = api(pkg).fsck
        full = fsck(t, stamp_watermark=True)
        assert full.ok and not full.incremental
        rep = fsck(t, incremental=True)
        assert rep.ok and rep.incremental
        assert rep.manifest_entries_decoded == 0
        commit(t, [{"id": 50, "v": 1.0}])
        commit(t, [{"id": 51, "v": 1.0}])
        rep2 = fsck(t, incremental=True)
        assert rep2.ok and rep2.incremental
        assert 0 < rep2.manifest_entries_decoded < \
            full.manifest_entries_decoded
        return report_obs(full), report_obs(rep), report_obs(rep2)
    both(tmp_path, scenario)


def test_incremental_absent_watermark_runs_full(tmp_path):
    def scenario(pkg, t):
        rep = api(pkg).fsck(t, incremental=True)
        assert rep.ok and not rep.incremental
        assert rep.manifest_entries_decoded > 0
        return report_obs(rep)
    both(tmp_path, scenario)


def test_incremental_rollback_demotes_to_full(tmp_path):
    def scenario(pkg, t):
        fsck = api(pkg).fsck
        assert fsck(t, stamp_watermark=True).ok
        commit(t, [{"id": 60, "v": 6.0}])
        t.rollback_to(2)
        rep = fsck(t, incremental=True)
        assert rep.ok and not rep.incremental
        assert fsck(t, incremental=True, stamp_watermark=True).ok
        rep2 = fsck(t, incremental=True)
        assert rep2.ok and rep2.incremental
        return report_obs(rep), report_obs(rep2)
    both(tmp_path, scenario)


def test_validate_watermark_mirrors_matches_tip(tmp_path):
    def scenario(pkg, t):
        m = api(pkg)
        snap = t.latest_snapshot()
        good = m.SweepWatermark(snap.id, snap.base_manifest_list or "",
                                snap.delta_manifest_list or "", 123)
        return (m.validate_watermark(t, good),
                m.validate_watermark(t, m.SweepWatermark(
                    snap.id, "manifest-list-recreated", good.delta_list,
                    123)),
                m.validate_watermark(t, m.SweepWatermark(
                    snap.id + 99, good.base_list, good.delta_list, 123)))
    assert both(tmp_path, scenario) == (True, False, False)


_AGREEMENT_SEEDS = [
    ("dangling-data-file",
     lambda t, pd, pm: os.remove(new_path(live_data_in_order(t)[::-1],
                                          pd))),
    ("corrupt-manifest",
     lambda t, pd, pm: open(new_path(latest_manifest_paths(t), pm),
                            "wb").write(b"xx")),
    ("missing-manifest",
     lambda t, pd, pm: os.remove(new_path(latest_manifest_paths(t), pm))),
    ("missing-manifest-list",
     lambda t, pd, pm: os.remove(t.new_scan().manifest_list.path(
         t.latest_snapshot().delta_manifest_list))),
    ("snapshot-gap",
     lambda t, pd, pm: os.remove(
         f"{t.path}/snapshot/snapshot-{t.latest_snapshot().id - 1}")),
    ("corrupt-snapshot",
     lambda t, pd, pm: open(
         f"{t.path}/snapshot/snapshot-{t.latest_snapshot().id - 1}",
         "w").write("{not json")),
    ("row-count-mismatch",
     lambda t, pd, pm: forge_total(t, t.latest_snapshot().id)),
]


@pytest.mark.parametrize("kind,seed", _AGREEMENT_SEEDS,
                         ids=[k for k, _ in _AGREEMENT_SEEDS])
def test_incremental_full_agreement(tmp_path, kind, seed):
    def scenario(pkg, t):
        fsck = api(pkg).fsck
        assert fsck(t, stamp_watermark=True).ok
        pre_data = set(live_data_paths(t))
        pre_manifests = set(latest_manifest_paths(t))
        commit(t, [{"id": 100, "v": 9.0}])
        commit(t, [{"id": 101, "v": 9.0}])
        seed(t, pre_data, pre_manifests)
        inc = fsck(t, incremental=True)
        assert inc.incremental and kind in inc.kinds()
        full = fsck(t)
        assert kind in full.kinds()
        return report_obs(inc), report_obs(full)
    both(tmp_path, scenario)


def test_stamp_requires_clean_chain(tmp_path):
    def scenario(pkg, t):
        os.remove(live_data_in_order(t)[0])
        rep = api(pkg).fsck(t, stamp_watermark=True)
        assert not rep.ok
        after = api(pkg).fsck(t, incremental=True)
        assert not after.incremental
        return report_obs(rep), report_obs(after)
    both(tmp_path, scenario)


# -- the ownership-chain check on the port's stamp parsing -------------------

def stamp(version, processes=2, buckets=4, dead=""):
    props = {"multihost.ownership.version": str(version),
             "multihost.ownership.processes": str(processes),
             "multihost.ownership.buckets": str(buckets)}
    if dead:
        props["multihost.ownership.dead"] = dead
    return props


@pytest.mark.parametrize("stamps", [
    [stamp(1), stamp(2), stamp(2)],
    [stamp(2), stamp(1)],
    [stamp(1), stamp(1, processes=3)],
    [stamp(1), stamp(2, dead="1"), stamp(2, dead="0")],
    [stamp(1), {"multihost.ownership.version": "x"}]],
    ids=["consistent", "version-regressed", "one-version-two-maps",
         "dead-set-differs", "unparsable"])
def test_ownership_chain(tmp_path, stamps):
    """Stamped snapshots as the multi-host planes write them: both
    packages report the same ownership-inconsistency violations."""
    def scenario(pkg, t):
        for i, props in enumerate(stamps):
            commit(t, [{"id": 200 + i, "v": 0.0}], properties=props)
        return report_obs(api(pkg).fsck(t))
    obs = both(tmp_path, scenario)
    kinds = {k for k, _ in obs[0]}
    assert (kinds == set()) == (stamps[1] == stamp(2))


def test_stamp_parsing_matches_reference():
    from paimon_tpu.parallel.distributed import (
        stamp_from_properties as ref_stamp,
    )
    from paimon_tpu_torch.maintenance.fsck import stamp_from_properties
    for props in (stamp(3, 4, 8, "1,2"), stamp(1), {}, {"x": "1"}):
        got, want = stamp_from_properties(props), ref_stamp(props)
        if want is None:
            assert got is None
            continue
        m = want[0]
        assert (got.version, got.num_processes, got.num_buckets,
                got.dead) == (m.version, m.num_processes, m.num_buckets,
                              m.dead)
    with pytest.raises(ValueError):
        stamp_from_properties({"multihost.ownership.version": "v"})
