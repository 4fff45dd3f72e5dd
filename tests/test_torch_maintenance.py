"""The maintenance plane of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_maintenance.py, test_mark_done.py,
test_repair.py and the decoupled-changelog cases of
test_changelog_decoupled.py run the same scenario on both packages
(`both`): each returns what it observed — the rows read, the surviving
snapshot, changelog, tag and branch files by name, the data files per
bucket directory, the expiry and repair results — and the two must be
equal; the reference test's own assertions then hold on each.  Two
port faults (ROADMAP.md C.4, C.5) are pinned here, and each package
expires, tags and reads what the other wrote.  Every value compared is
a row, a name or a count, so equality is exact.
"""

import datetime
import json
import os
import time

import pytest

from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from tests.test_torch_dynamic_bucket import PORT, REF

_META_DIRS = ("snapshot", "tag", "changelog", "branch", "consumer",
              "partition-mark-done")


def meta_files(table):
    """Relative paths of every snapshot, tag, changelog, branch,
    consumer and mark-done file: their names are deterministic."""
    out = []
    for d in _META_DIRS:
        for root, _, files in os.walk(os.path.join(table.path, d)):
            rel = os.path.relpath(root, table.path)
            out.extend(os.path.join(rel, f) for f in files
                       if d != "partition-mark-done" or "events" not in rel)
    return sorted(out)


def data_counts(table):
    """{bucket directory: data and changelog files in it}."""
    out = {}
    for root, _, files in os.walk(table.path):
        if os.path.basename(root).startswith("bucket-"):
            n = sum(1 for f in files
                    if f.startswith(("data-", "changelog-")))
            if n:
                out[os.path.relpath(root, table.path)] = n
    return out


def manifest_counts(table):
    """Manifest and manifest-list files (the reference's stats sidecars
    aside: the port writes none)."""
    names = os.listdir(os.path.join(table.path, "manifest")) \
        if os.path.isdir(os.path.join(table.path, "manifest")) else []
    return (sum(1 for n in names if n.startswith("manifest-list-")),
            sum(1 for n in names if n.startswith("manifest-")
                and not n.startswith("manifest-list-")))


def layout(table):
    return {"meta": meta_files(table), "data": data_counts(table),
            "manifests": manifest_counts(table)}


def rows(table, **opts):
    t = table.copy(opts) if opts else table
    return sorted(t.to_arrow().to_pylist(),
                  key=lambda r: tuple(str(r[k]) for k in sorted(r)))


def both(scenario, tmp_path, *args):
    """Run `scenario(pkg, root, *args)` on each package; their
    observations must be equal.  Returns the port's."""
    got = {}
    for pkg in (PORT, REF):
        root = str(tmp_path / pkg.name)
        os.makedirs(root, exist_ok=True)
        got[pkg.name] = scenario(pkg, root, *args)
    assert got["port"] == got["reference"]
    return got["port"]


def make(pkg, root, opts=None, partitioned=False, name="t"):
    cols = [("id", "BigIntType", False), ("v", "DoubleType", True)]
    pk = ("id",)
    if partitioned:
        cols.append(("dt", "VarCharType", False))
        pk = ("id", "dt")
    options = {"bucket": "1", "write-only": "true"}
    options.update(opts or {})
    schema = pkg.schema(cols, pk=pk, partitions=("dt",) if partitioned
                        else (), options=options)
    return pkg.create(root, schema, name)


def commit(table, rows_, kinds=None, watermark=None, overwrite=False):
    wb = table.new_batch_write_builder()
    if overwrite:
        wb = wb.with_overwrite()
    w = wb.new_write()
    w.write_dicts(rows_, row_kinds=kinds)
    sid = wb.new_commit().commit(w.prepare_commit(), watermark=watermark)
    w.close()
    return sid


def expire_obs(res):
    return (res.expired_snapshots, res.deleted_data_files,
            res.deleted_manifest_files, res.folded_snapshots)


def maint(pkg, module):
    """The package's maintenance module `module`."""
    import importlib
    base = "paimon_tpu_torch" if pkg is PORT else "paimon_tpu"
    return importlib.import_module(f"{base}.maintenance.{module}")


FUTURE = int(time.time() * 1000) + 3_600_000


# -- snapshot expiry (tests/test_maintenance.py) -----------------------------

def test_expire_deletes_unreferenced_files(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(5):
            commit(t, [{"id": 1, "v": float(i)}])
        t.compact(full=True)        # snapshot 6: the L0 files go dead
        before = sum(data_counts(t).values())
        res = t.expire_snapshots(retain_max=1, retain_min=1,
                                 older_than_ms=FUTURE)
        assert res.expired_snapshots == [1, 2, 3, 4, 5]
        assert res.deleted_data_files > 0
        assert sum(data_counts(t).values()) < before
        assert rows(t) == [{"id": 1, "v": 4.0}]
        assert t.snapshot_manager.earliest_snapshot_id() == 6
        return expire_obs(res), layout(t), rows(t)
    both(scenario, tmp_path)


def test_expire_keeps_tagged_files(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        t.create_tag("keep", 1)
        for i in range(4):
            commit(t, [{"id": 1, "v": float(i)}])
        t.compact(full=True)
        res = t.expire_snapshots(retain_max=1, retain_min=1,
                                 older_than_ms=FUTURE)
        tagged = rows(t, **{"scan.tag-name": "keep"})
        assert tagged == [{"id": 1, "v": 1.0}]
        return expire_obs(res), layout(t), tagged, rows(t)
    both(scenario, tmp_path)


def test_expire_respects_consumer_progress(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(5):
            commit(t, [{"id": 1, "v": float(i)}])
        t.consumer_manager.record_consumer("job", 3)
        res = t.expire_snapshots(retain_max=1, retain_min=1,
                                 older_than_ms=FUTURE)
        assert res.expired_snapshots == [1, 2]
        assert t.snapshot_manager.earliest_snapshot_id() == 3
        return expire_obs(res), layout(t)
    both(scenario, tmp_path)


def test_expire_retain_min(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(6):
            commit(t, [{"id": 1, "v": float(i)}])
        res = t.expire_snapshots(retain_max=10, retain_min=4,
                                 older_than_ms=FUTURE)
        assert res.expired_snapshots == [1, 2]
        assert t.snapshot_manager.earliest_snapshot_id() == 3
        return expire_obs(res), layout(t)
    both(scenario, tmp_path)


def test_expire_time_retained_bounds(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        for i in range(4):
            commit(t, [{"id": 1, "v": float(i)}])
        # nothing is older than the cutoff: only retain_max forces out
        res = t.expire_snapshots(retain_max=10, retain_min=1,
                                 older_than_ms=0)
        assert res.is_empty()
        return expire_obs(res), layout(t)
    both(scenario, tmp_path)


def test_expire_at_table_options(tmp_path):
    """No arguments: snapshot.num-retained.{min,max} and the
    delete-file.thread-num pool, as a production table sets them."""
    def scenario(pkg, root):
        t = make(pkg, root, {"snapshot.num-retained.min": "2",
                             "snapshot.num-retained.max": "3",
                             "delete-file.thread-num": "4",
                             "snapshot.clean-empty-directories": "true"},
                 partitioned=True)
        for i in range(6):
            commit(t, [{"id": i, "v": float(i), "dt": f"d{i % 3}"}])
        t.compact(full=True)
        res = t.expire_snapshots()
        assert res.expired_snapshots == [1, 2, 3, 4]
        return expire_obs(res), layout(t), rows(t)
    both(scenario, tmp_path)


# -- orphan clean ------------------------------------------------------------

def plant(path, mtime_s=None):
    with open(path, "wb") as f:
        f.write(b"junk")
    if mtime_s is not None:
        os.utime(path, (mtime_s, mtime_s))
    return path


def test_orphan_files_clean(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        old = time.time() - 100
        data = plant(os.path.join(t.path, "bucket-0",
                                  "data-orphan-0.parquet"), old)
        plant(os.path.join(t.path, "manifest", "manifest-orphan-0"), old)
        before = layout(t)
        deleted = t.remove_orphan_files(
            older_than_ms=int(time.time() * 1000) - 50_000)
        names = sorted(os.path.basename(p) for p in deleted)
        assert names == ["data-orphan-0.parquet", "manifest-orphan-0"]
        assert not os.path.exists(data)
        assert rows(t) == [{"id": 1, "v": 1.0}]
        return names, before, layout(t)
    both(scenario, tmp_path)


def test_orphan_grace_period(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        orphan = plant(os.path.join(t.path, "bucket-0",
                                    "data-fresh-0.parquet"))
        assert t.remove_orphan_files() == []
        assert os.path.exists(orphan)
        return layout(t)
    both(scenario, tmp_path)


def test_orphan_grace_period_injectable_clock(tmp_path):
    def scenario(pkg, root):
        grace = maint(pkg, "orphan").DEFAULT_OLDER_THAN_MS
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        orphan = plant(os.path.join(t.path, "bucket-0",
                                    "data-wr-0.parquet"))
        mtime_ms = int(os.path.getmtime(orphan) * 1000)
        assert t.remove_orphan_files(
            now_ms=mtime_ms + grace - 10_000) == []
        assert os.path.exists(orphan)
        deleted = t.remove_orphan_files(now_ms=mtime_ms + grace + 60_000)
        names = [os.path.basename(p) for p in deleted]
        assert names == ["data-wr-0.parquet"]
        return names, layout(t)
    both(scenario, tmp_path)


def test_orphan_incremental_watermark_rides_grace_cutoff(tmp_path):
    def scenario(pkg, root):
        grace = maint(pkg, "orphan").DEFAULT_OLDER_THAN_MS
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        base = int(time.time() * 1000)
        t.remove_orphan_files(now_ms=base + grace, incremental=True)
        plant(os.path.join(t.path, "bucket-0", "data-mid-0.parquet"),
              (base + 30_000) / 1000.0)
        deleted = t.remove_orphan_files(now_ms=base + grace + 60_000,
                                        incremental=True)
        names = [os.path.basename(p) for p in deleted]
        assert names == ["data-mid-0.parquet"]
        assert rows(t) == [{"id": 1, "v": 1.0}]
        return names, meta_files(t)
    both(scenario, tmp_path)


def test_orphan_rollback_between_sweeps_demotes_to_full(tmp_path):
    def scenario(pkg, root):
        grace = maint(pkg, "orphan").DEFAULT_OLDER_THAN_MS
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        keep = t.latest_snapshot().id
        commit(t, [{"id": 2, "v": 2.0}])
        base = int(time.time() * 1000)
        t.remove_orphan_files(now_ms=base + grace, incremental=True)
        debris = plant(os.path.join(t.path, "bucket-0",
                                    "data-old-0.parquet"),
                       (base - 100_000) / 1000.0)
        assert t.remove_orphan_files(now_ms=base + grace + 60_000,
                                     incremental=True) == []
        assert os.path.exists(debris)
        t.rollback_to(keep)
        deleted = t.remove_orphan_files(now_ms=base + grace + 120_000,
                                        incremental=True)
        names = sorted(os.path.basename(p) for p in deleted)
        assert "data-old-0.parquet" in names
        assert rows(t) == [{"id": 1, "v": 1.0}]
        # the rolled-back commit's files are orphans too (the
        # reference's stats sidecars aside: the port writes none)
        return len([n for n in names if not n.startswith("stats-")]), \
            meta_files(t), rows(t)
    both(scenario, tmp_path)


def test_expire_folds_idle_heartbeat_chain(tmp_path):
    def scenario(pkg, root):
        commit_mod = __import__(
            ("paimon_tpu_torch" if pkg is PORT else "paimon_tpu")
            + ".core.commit", fromlist=["FileStoreCommit"])
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        for i in range(40):
            pid = i % 2
            fc = commit_mod.FileStoreCommit(
                t.file_io, t.path, t.schema, t.options,
                commit_user=f"stream-daemon-p{pid}", branch=t.branch)
            # a lease heartbeat (reference distributed.lease_props)
            fc.commit([], properties={f"multihost.lease.p{pid}":
                                      str(1000 + i)}, force_create=True)
        sm = t.snapshot_manager
        assert sm.snapshot_count() == 41
        res = t.expire_snapshots()
        assert len(res.folded_snapshots) == 37
        assert sm.snapshot_count() == 4
        assert set(res.folded_snapshots) <= sm.folded_ids()
        assert t.fsck().ok
        assert t.expire_snapshots().folded_snapshots == []
        tip = sm.latest_snapshot()
        found = sm.earlier_or_equal_time_mills(tip.time_millis)
        assert found is not None and found.id == tip.id
        assert t.to_arrow().num_rows == 1
        return expire_obs(res), meta_files(t), sorted(sm.folded_ids())
    both(scenario, tmp_path)


# -- partition expiry --------------------------------------------------------

def test_partition_expire(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, {"partition.expiration-time": "7 d"},
                 partitioned=True)
        commit(t, [{"id": 1, "v": 1.0, "dt": "2026-07-01"},
                   {"id": 2, "v": 2.0, "dt": "2026-07-27"}])
        now = int(time.mktime((2026, 7, 28, 0, 0, 0, 0, 0, 0))) * 1000
        expired = t.expire_partitions(now_ms=now)
        assert expired == [("2026-07-01",)]
        assert [r["dt"] for r in rows(t)] == ["2026-07-27"]
        return expired, rows(t), layout(t), \
            t.latest_snapshot().commit_kind
    both(scenario, tmp_path)


def test_partition_expire_formatter_and_max_num(tmp_path):
    """yyyyMMdd partitions (partition.timestamp-formatter), oldest first,
    at most partition.expiration-max-num a call; a dry run commits
    nothing."""
    def scenario(pkg, root):
        t = make(pkg, root, {"partition.expiration-time": "3 d",
                             "partition.timestamp-formatter": "yyyyMMdd",
                             "partition.expiration-max-num": "2"},
                 partitioned=True)
        commit(t, [{"id": d, "v": float(d), "dt": f"202607{d:02d}"}
                   for d in range(1, 8)] + [{"id": 99, "v": 0.0,
                                             "dt": "not-a-date"}])
        now = int(datetime.datetime(2026, 7, 8).timestamp() * 1000)
        sid = t.latest_snapshot().id
        dry = t.expire_partitions(now_ms=now, dry_run=True)
        assert t.latest_snapshot().id == sid
        first = t.expire_partitions(now_ms=now)
        second = t.expire_partitions(now_ms=now)
        assert first == dry == [("20260701",), ("20260702",)]
        assert second == [("20260703",), ("20260704",)]
        return first, second, rows(t)
    both(scenario, tmp_path)


# -- auto-tags and watermarks ------------------------------------------------

def tag_table(pkg, root, opts, name="t"):
    options = {"bucket": "1", "write-only": "true"}
    options.update(opts)
    return pkg.create(root, pkg.schema([("id", "BigIntType", False)],
                                       options=options), name)


def test_tag_automatic_creation(tmp_path):
    def scenario(pkg, root):
        t = tag_table(pkg, root, {"tag.automatic-creation": "process-time",
                                  "tag.creation-period": "daily",
                                  "tag.num-retained-max": "2"})
        commit(t, [{"id": 1}])
        tags = t.tag_manager.tags()
        assert len(tags) == 1
        name = next(iter(tags))
        snap_dt = datetime.datetime.fromtimestamp(
            t.latest_snapshot().time_millis / 1000,
            tz=datetime.timezone.utc)
        assert name == (snap_dt - datetime.timedelta(days=1)) \
            .strftime("%Y-%m-%d")
        commit(t, [{"id": 2}])
        assert len(t.tag_manager.tags()) <= 2
        return len(tags)
    both(scenario, tmp_path)


def test_manual_tags_survive_auto_expiry(tmp_path):
    def scenario(pkg, root):
        t = tag_table(pkg, root, {"tag.automatic-creation": "process-time",
                                  "tag.num-retained-max": "1"})
        commit(t, [{"id": 1}])
        t.create_tag("1.0-release")
        maint(pkg, "tag_auto")._expire_auto_tags(t, t.options)
        assert "1.0-release" in t.tag_manager.tags()
        return sorted(n for n in t.tag_manager.tags()
                      if not n[0].isdigit())
    both(scenario, tmp_path)


def test_tag_auto_watermark_mode_needs_watermark(tmp_path):
    def scenario(pkg, root):
        t = tag_table(pkg, root, {"tag.automatic-creation": "watermark"})
        commit(t, [{"id": 1}])
        assert t.tag_manager.tags() == {}
        return meta_files(t)
    both(scenario, tmp_path)


def test_watermark_advances_and_drives_tags(tmp_path):
    def scenario(pkg, root):
        t = tag_table(pkg, root, {"tag.automatic-creation": "watermark",
                                  "tag.creation-period": "daily"})
        day = 86_400_000
        commit(t, [{"id": 1}], watermark=3 * day + 1000)
        assert t.latest_snapshot().watermark == 3 * day + 1000
        assert "1970-01-03" in t.tag_manager.tags()
        commit(t, [{"id": 2}], watermark=2 * day)
        assert t.latest_snapshot().watermark == 3 * day + 1000
        return meta_files(t)
    both(scenario, tmp_path)


def test_watermark_daily_tags_retained_and_read(tmp_path):
    """The maintenance cell's tagging in small: 3-hour watermark steps
    over 4 days, daily tags, tag.num-retained-max=2, completion and
    success files; each retained tag reads its snapshot's rows."""
    def scenario(pkg, root):
        t = tag_table(pkg, root, {"tag.automatic-creation": "watermark",
                                  "tag.creation-period": "daily",
                                  "tag.num-retained-max": "2",
                                  "tag.create-success-file": "true",
                                  "tag.period-formatter": "without_dashes"})
        hour = 3_600_000
        for c in range(32):
            commit(t, [{"id": c % 5}, {"id": 100 + c}],
                   watermark=c * 3 * hour)
        tags = t.tag_manager.tags()
        assert len(tags) == 2
        reads = {n: rows(t, **{"scan.tag-name": n}) for n in tags}
        return sorted((n, s.id) for n, s in tags.items()), reads, \
            meta_files(t)
    both(scenario, tmp_path)


# -- callbacks ---------------------------------------------------------------

class CountingCommitCallback:
    """A `commit.callbacks` class: records every call."""
    calls = []

    def __init__(self, param=None):
        self.param = param

    def call(self, table, snapshot_id, messages):
        CountingCommitCallback.calls.append(
            (self.param, snapshot_id, len(messages)))


class CountingTagCallback:
    calls = []

    def __init__(self, param=None):
        self.param = param

    def call(self, table, tag_name, snapshot_id):
        CountingTagCallback.calls.append((self.param, tag_name,
                                          snapshot_id))


def test_commit_and_tag_callbacks(tmp_path):
    path = f"{__name__}:CountingCommitCallback"
    tag_path = f"{__name__}:CountingTagCallback"

    def scenario(pkg, root):
        CountingCommitCallback.calls = []
        CountingTagCallback.calls = []
        t = tag_table(pkg, root, {
            "commit.callbacks": path,
            f"commit.callback.{path}.param": "p1",
            "tag.callbacks": tag_path,
            "tag.automatic-creation": "watermark"})
        day = 86_400_000
        for i in range(3):
            commit(t, [{"id": i}], watermark=(i + 1) * day + 5)
        t.create_tag("manual", 1)
        return list(CountingCommitCallback.calls), \
            list(CountingTagCallback.calls)
    calls, tag_calls = both(scenario, tmp_path)
    assert calls == [("p1", 1, 1), ("p1", 2, 1), ("p1", 3, 1)]
    assert [c[1] for c in tag_calls] == ["1970-01-01", "1970-01-02",
                                         "1970-01-03", "manual"]


# -- mark-done (tests/test_mark_done.py) -------------------------------------

def done_table(pkg, root, opts=None):
    return make(pkg, root, opts, partitioned=True)


def test_success_file_marker(tmp_path):
    def scenario(pkg, root):
        md = maint(pkg, "mark_done")
        t = done_table(pkg, root)
        commit(t, [{"id": 1, "v": 1.0, "dt": "2026-07-01"}])
        marked = t.mark_partitions_done(["dt=2026-07-01"])
        assert marked == ["dt=2026-07-01"]
        path = os.path.join(t.path, "dt=2026-07-01", "_SUCCESS")
        sf = md.SuccessFile.from_json(open(path).read())
        assert sf.creation_time == sf.modification_time > 0
        t.mark_partitions_done([("2026-07-01",)])
        sf2 = md.SuccessFile.from_json(open(path).read())
        assert sf2.creation_time == sf.creation_time
        assert sf2.modification_time >= sf.modification_time
        return marked, sorted(json.loads(open(path).read()))
    both(scenario, tmp_path)


def test_done_partition_and_event_actions(tmp_path):
    def scenario(pkg, root):
        md = maint(pkg, "mark_done")
        t = done_table(pkg, root, {
            "partition.mark-done-action":
                "success-file,done-partition,mark-event"})
        commit(t, [{"id": 1, "v": 1.0, "dt": "2026-07-01"},
                   {"id": 2, "v": 2.0, "dt": "2026-07-02"}])
        t.mark_partitions_done([{"dt": "2026-07-01"}, "dt=2026-07-02"])
        reg = md.AddDonePartitionAction(t.file_io, t.path)
        assert reg.done_partitions() == ["dt=2026-07-01.done",
                                         "dt=2026-07-02.done"]
        t.mark_partitions_done(["dt=2026-07-01"])
        assert reg.done_partitions().count("dt=2026-07-01.done") == 1
        events = md.MarkPartitionDoneEventAction(t.file_io, t.path).events()
        parts = sorted(e["partition"] for e in events)
        assert parts == ["dt=2026-07-01", "dt=2026-07-01", "dt=2026-07-02"]
        assert all(e["event"] == "partition.done" for e in events)
        return reg.done_partitions(), parts, meta_files(t)
    both(scenario, tmp_path)


def test_unpartitioned_rejected(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        with pytest.raises(ValueError, match="not partitioned"):
            t.mark_partitions_done(["dt=x"])
        return True
    both(scenario, tmp_path)


def test_trigger_idle_time_semantics(tmp_path):
    def scenario(pkg, root):
        t = done_table(pkg, root, {"partition.idle-time-to-done": "15 min",
                                   "partition.time-interval": "1 d"})
        trig = maint(pkg, "mark_done").PartitionMarkDoneTrigger(t)
        day = 24 * 3600 * 1000
        start = int(datetime.datetime(2026, 7, 1).timestamp() * 1000)
        trig.notify("dt=2026-07-01", now_ms=start + day // 2)
        seen = [trig.done_partitions(now_ms=start + day),
                trig.done_partitions(now_ms=start + day + 10 * 60000),
                trig.done_partitions(now_ms=start + day + 16 * 60000),
                trig.done_partitions(now_ms=start + 2 * day)]
        trig.notify("dt=2026-07-01", now_ms=start + 2 * day)
        seen += [trig.done_partitions(now_ms=start + 2 * day + 14 * 60000),
                 trig.done_partitions(now_ms=start + 2 * day + 16 * 60000)]
        assert seen == [[], [], ["dt=2026-07-01"], [], [],
                        ["dt=2026-07-01"]]
        return seen
    both(scenario, tmp_path)


def test_trigger_end_input_and_state(tmp_path):
    def scenario(pkg, root):
        md = maint(pkg, "mark_done")
        t = done_table(pkg, root,
                       {"partition.mark-done-when-end-input": "true"})
        trig = md.PartitionMarkDoneTrigger(t)
        trig.notify(("2026-07-01",))
        trig.notify("dt=2026-07-02")
        trig2 = md.PartitionMarkDoneTrigger(t)
        trig2.restore(trig.snapshot())
        done = sorted(trig2.mark(end_input=True))
        assert done == ["dt=2026-07-01", "dt=2026-07-02"]
        assert os.path.exists(os.path.join(t.path, "dt=2026-07-01",
                                           "_SUCCESS"))
        assert trig2.done_partitions(end_input=True) == []
        return done
    both(scenario, tmp_path)


def test_traversal_rejected(tmp_path):
    def scenario(pkg, root):
        t = done_table(pkg, root)
        with pytest.raises(ValueError, match="escapes"):
            t.mark_partitions_done(["../../evil"])
        return True
    both(scenario, tmp_path)


def test_trigger_misconfig_rejected(tmp_path):
    def scenario(pkg, root):
        t = done_table(pkg, root, {"partition.idle-time-to-done": "15 min"})
        with pytest.raises(ValueError, match="must be set together"):
            maint(pkg, "mark_done").PartitionMarkDoneTrigger(t)
        return True
    both(scenario, tmp_path)


def test_trigger_skips_unparseable_partition(tmp_path):
    def scenario(pkg, root):
        t = done_table(pkg, root, {"partition.idle-time-to-done": "1 s",
                                   "partition.time-interval": "1 s"})
        trig = maint(pkg, "mark_done").PartitionMarkDoneTrigger(t)
        trig.notify("dt=not-a-date", now_ms=0)
        assert trig.done_partitions(now_ms=10 ** 12) == []
        assert trig.snapshot() == []
        return True
    both(scenario, tmp_path)


def test_end_input_to_done_marks_batch_partitions(tmp_path):
    """partition.end-input-to-done (ROADMAP.md C.2, refused until now):
    a batch commit marks the partitions it wrote; a streaming commit
    marks none."""
    def scenario(pkg, root):
        t = done_table(pkg, root, {
            "partition.end-input-to-done": "true",
            "partition.mark-done-action": "success-file,done-partition"})
        commit(t, [{"id": 1, "v": 1.0, "dt": "p1"},
                   {"id": 2, "v": 2.0, "dt": "p2"}])
        wb = t.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        w.write_dicts([{"id": 3, "v": 3.0, "dt": "p3"}])
        c.commit(w.prepare_commit(), commit_identifier=7)
        w.close()
        marked = sorted(d for d in ("p1", "p2", "p3") if os.path.exists(
            os.path.join(t.path, f"dt={d}", "_SUCCESS")))
        assert marked == ["p1", "p2"]
        return marked, meta_files(t)
    both(scenario, tmp_path)


# -- decoupled changelog (tests/test_changelog_decoupled.py) -----------------

def cl_table(pkg, root, **opts):
    options = {"bucket": "1", "write-only": "true",
               "changelog-producer": "input",
               "changelog.num-retained.max": "50"}
    options.update(opts)
    return pkg.create(root, pkg.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)],
        options=options))


def changelog_ids(pkg, t):
    mod = __import__(("paimon_tpu_torch" if pkg is PORT else "paimon_tpu")
                     + ".snapshot.changelog_manager",
                     fromlist=["ChangelogManager"])
    return mod.ChangelogManager(t.file_io, t.path)


def changelog_rows(t, snap):
    plan = t.new_scan().plan_changelog(snap, streaming=True)
    return t.new_read_builder().new_read().to_arrow(plan).to_pylist()


def drain_stream(t, scan):
    read = t.new_read_builder().new_read()
    seen = []
    while True:
        plan = scan.plan()
        if plan is None:
            return sorted(r["id"] for r in seen)
        seen.extend(read.to_arrow(plan).to_pylist())


def test_changelog_survives_snapshot_expiry(tmp_path):
    def scenario(pkg, root):
        t = cl_table(pkg, root)
        for i in range(6):
            commit(t, [{"id": i, "v": float(i)}])
        res = t.expire_snapshots(retain_max=2, retain_min=1)
        assert t.snapshot_manager.earliest_snapshot_id() == 5
        cm = changelog_ids(pkg, t)
        ids = cm._ids()
        assert ids and min(ids) == 1
        read = [changelog_rows(t, cm.changelog(c)) for c in ids]
        assert all(len(r) == 1 for r in read)
        return expire_obs(res), read, layout(t)
    both(scenario, tmp_path)


def test_stream_consumer_reads_past_expiry(tmp_path):
    def scenario(pkg, root):
        t = cl_table(pkg, root)
        for i in range(5):
            commit(t, [{"id": i, "v": float(i)}])
        scan = t.copy({"scan.mode": "from-snapshot",
                       "scan.snapshot-id": "1"}) \
            .new_read_builder().new_stream_scan()
        t.expire_snapshots(retain_max=2, retain_min=1)
        seen = drain_stream(t, scan)
        assert seen == [0, 1, 2, 3, 4]
        return seen
    both(scenario, tmp_path)


def test_compact_snapshot_gap_does_not_strand_consumers(tmp_path):
    def scenario(pkg, root):
        t = cl_table(pkg, root)
        commit(t, [{"id": 0, "v": 0.0}])
        commit(t, [{"id": 1, "v": 1.0}])
        t.compact(full=True)
        commit(t, [{"id": 2, "v": 2.0}])
        commit(t, [{"id": 3, "v": 3.0}])
        scan = t.copy({"scan.mode": "from-snapshot",
                       "scan.snapshot-id": "1"}) \
            .new_read_builder().new_stream_scan()
        t.expire_snapshots(retain_max=1, retain_min=1)
        seen = drain_stream(t, scan)
        assert seen == [0, 1, 2, 3]
        return seen, meta_files(t)
    both(scenario, tmp_path)


def test_expire_changelogs_trims(tmp_path):
    def scenario(pkg, root):
        t = cl_table(pkg, root, **{"changelog.num-retained.max": "4"})
        for i in range(8):
            commit(t, [{"id": i, "v": float(i)}])
        t.expire_snapshots(retain_max=2, retain_min=1)
        cm = changelog_ids(pkg, t)
        before = cm._ids()
        res = maint(pkg, "expire").expire_changelogs(t)
        after = cm._ids()
        assert len(after) < len(before) and res.expired_snapshots
        read = [changelog_rows(t, cm.changelog(c)) for c in after]
        assert all(len(r) == 1 for r in read)
        return before, after, expire_obs(res), read, layout(t)
    both(scenario, tmp_path)


def test_expire_changelogs_respects_tags(tmp_path):
    def scenario(pkg, root):
        t = cl_table(pkg, root, **{"changelog.num-retained.max": "1"})
        for i in range(4):
            commit(t, [{"id": i, "v": float(i)}])
        t.create_tag("pin", snapshot_id=2)
        t.expire_snapshots(retain_max=1, retain_min=1)
        res = maint(pkg, "expire").expire_changelogs(t)
        read = changelog_rows(t, t.tag_manager.get_tag("pin"))
        assert len(read) == 1
        return expire_obs(res), read, layout(t)
    both(scenario, tmp_path)


def test_without_option_changelog_dies_with_snapshot(tmp_path):
    def scenario(pkg, root):
        t = pkg.create(root, pkg.schema(
            [("id", "BigIntType", False), ("v", "DoubleType", True)],
            options={"bucket": "1", "write-only": "true",
                     "changelog-producer": "input"}), "plain")
        for i in range(5):
            commit(t, [{"id": i, "v": 0.0}])
        t.expire_snapshots(retain_max=2, retain_min=1)
        assert changelog_ids(pkg, t)._ids() == []
        return layout(t)
    both(scenario, tmp_path)


# -- repair (tests/test_repair.py) -------------------------------------------

def test_remove_unexisting_files_reconciles_after_manual_deletion(tmp_path):
    def scenario(pkg, root):
        repair = maint(pkg, "repair")
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        commit(t, [{"id": 2, "v": 2.0}])
        split = t.new_read_builder().new_scan().plan().splits[0]
        victim = max(split.data_files, key=lambda f: f.min_sequence_number)
        path = t.new_scan().path_factory.data_file_path((), 0,
                                                       victim.file_name)
        os.remove(path)
        with pytest.raises(Exception):
            t.to_arrow()
        assert repair.remove_unexisting_files(t, dry_run=True) == [path]
        assert repair.remove_unexisting_files(t) == [path]
        t2 = pkg.load(t.path)
        assert t2.to_arrow().column("id").to_pylist() == [1]
        return rows(t2), meta_files(t2)
    both(scenario, tmp_path)


def test_remove_unexisting_files_noop_when_all_present(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        before = t.latest_snapshot().id
        assert maint(pkg, "repair").remove_unexisting_files(t) == []
        assert t.latest_snapshot().id == before
        return before
    both(scenario, tmp_path)


def test_compact_manifests_merges_to_one_manifest(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, {"manifest.merge-min-count": "1000"})
        for i in range(6):
            commit(t, [{"id": i, "v": float(i)}])
        snap = t.latest_snapshot()
        base = t.new_scan().manifest_list.read_all(
            snap.base_manifest_list, snap.delta_manifest_list)
        assert len(base) > 1
        sid = maint(pkg, "repair").compact_manifests(t)
        assert sid == snap.id + 1
        t2 = pkg.load(t.path)
        snap2 = t2.latest_snapshot()
        assert snap2.commit_kind == "COMPACT"
        base2 = t2.new_scan().manifest_list.read_all(
            snap2.base_manifest_list, snap2.delta_manifest_list)
        assert len(base2) == 1
        assert snap2.total_record_count == snap.total_record_count
        return len(base), rows(t2)
    both(scenario, tmp_path)


def test_compact_manifests_empty_table_noop(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root)
        assert maint(pkg, "repair").compact_manifests(t) is None
        assert t.compact_manifests(force=False) is None
        return True
    both(scenario, tmp_path)


def test_manifest_compaction_threshold_trigger(tmp_path):
    """manifest.full-compaction.threshold: compact_manifests(force=False)
    runs only once the chain holds that many small manifests."""
    def scenario(pkg, root):
        mc = maint(pkg, "manifest_compact")
        t = make(pkg, root, {"manifest.merge-min-count": "1000",
                             "manifest.full-compaction.threshold": "4"})
        fired = []
        for i in range(6):
            commit(t, [{"id": i, "v": float(i)}])
            fired.append(mc.manifest_compaction_needed(t))
        sid = t.compact_manifests(force=False)
        return fired, sid, mc.manifest_compaction_needed(t), rows(t)
    fired, sid, after, _ = both(scenario, tmp_path)
    assert fired == [False, False, False, True, True, True]
    assert sid == 7 and not after


def test_rewrite_file_index_waits_for_file_indexes(tmp_path):
    """rewrite_file_index refuses a table without file-index options,
    then indexes its one unindexed file once they are set, in both
    packages."""
    def scenario(pkg, root):
        repair = maint(pkg, "repair")
        t = make(pkg, root)
        commit(t, [{"id": 1, "v": 1.0}])
        with pytest.raises(ValueError, match="file-index"):
            repair.rewrite_file_index(t)
        indexed = t.copy({"file-index.bloom-filter.columns": "id"})
        n = repair.rewrite_file_index(indexed), \
            repair.rewrite_file_index(indexed)
        snap = indexed.snapshot_manager.latest_snapshot()
        blobs = [e.file.embedded_index
                 for e in indexed.new_scan().read_entries(snap)]
        return n, snap.commit_kind, blobs, rows(indexed)
    n, kind, blobs, _ = both(scenario, tmp_path)
    assert n == (1, 0) and kind == "COMPACT" and blobs[0]


def delete_second_manifest(t):
    """Delete the data manifest the second commit wrote (names are
    random: take it from snapshot 2's delta manifest list)."""
    scan = t.new_scan()
    snap = t.snapshot_manager.snapshot(2)
    (meta,) = scan.manifest_list.read(snap.delta_manifest_list)
    os.remove(scan.manifest_file.path(meta.file_name))


def test_remove_unexisting_manifests(tmp_path):
    def scenario(pkg, root):
        t = make(pkg, root, {"manifest.merge-min-count": "1000"})
        for i in range(4):
            commit(t, [{"id": i, "v": float(i)}])
        delete_second_manifest(t)
        # both packages' plan caches hold the live set from before the
        # deletion: drop them so the read walks the broken chain
        if pkg is REF:
            from paimon_tpu.core.plan_cache import reset_plan_caches
        else:
            from paimon_tpu_torch.core.plan_cache import reset_plan_caches
        reset_plan_caches()
        with pytest.raises(Exception):
            t.to_arrow()
        sid = maint(pkg, "repair").remove_unexisting_manifests(t)
        assert sid is not None
        t2 = pkg.load(t.path)
        got = sorted(t2.to_arrow().column("id").to_pylist())
        assert t2.latest_snapshot().total_record_count == len(got) == 3
        return got, t2.latest_snapshot().commit_kind
    both(scenario, tmp_path)


# -- the two port faults (ROADMAP.md C.4, C.5) -------------------------------

def test_incremental_between_tag_to_snapshot_is_read(tmp_path):
    """C.4: the port ignored incremental-between-tag-to-snapshot and read
    the whole latest snapshot (6 rows); the reference reads the 4 rows
    added after the tag."""
    def scenario(pkg, root):
        t = pkg.create(root, pkg.schema(
            [("id", "BigIntType", False)],
            options={"bucket": "1", "write-only": "true"}))
        for i in range(3):
            commit(t, [{"id": i}, {"id": 10 + i}])
            if i == 0:
                t.create_tag("t0")
        got = rows(t, **{"incremental-between-tag-to-snapshot": "t0,3"})
        return got
    got = both(scenario, tmp_path)
    assert sorted(r["id"] for r in got) == [1, 2, 11, 12]


def test_overwrite_keeps_its_watermark(tmp_path):
    """C.5: an INSERT OVERWRITE dropped its watermark in the port (1000
    stayed); the reference records 2000."""
    def scenario(pkg, root):
        t = pkg.create(root, pkg.schema([("id", "BigIntType", False)],
                                        options={"bucket": "1"}))
        commit(t, [{"id": 1}], watermark=1000)
        commit(t, [{"id": 2}], watermark=2000, overwrite=True)
        return t.latest_snapshot().watermark, rows(t)
    assert both(scenario, tmp_path) == (2000, [{"id": 2}])


# -- each package maintains what the other wrote -----------------------------

def written_by(writer, root):
    """A changelog-producing, partitioned table with tags, written by
    `writer`'s package."""
    t = make(writer, root, {"changelog-producer": "input",
                            "changelog.num-retained.max": "20",
                            "snapshot.num-retained.min": "1",
                            "snapshot.num-retained.max": "2"},
             partitioned=True)
    for i in range(6):
        commit(t, [{"id": i % 4, "v": float(i), "dt": f"d{i % 2}"}])
        if i == 2:
            t.create_tag("mid")
    t.compact(full=True)
    return t


@pytest.mark.parametrize("writer, maintainer", [(REF, PORT), (PORT, REF)],
                         ids=["port-maintains-ref", "ref-maintains-port"])
def test_cross_package_expire_tag_branch(tmp_path, writer, maintainer):
    """One package writes; the other expires, tags and branches the
    table; the writer reads the result, and a run where the writer does
    everything itself is the oracle."""
    def maintain(t):
        res = t.expire_snapshots()
        t.create_tag("after")
        t.create_branch("b", "mid")
        b = t.copy({"branch": "b"})
        commit(b, [{"id": 9, "v": 9.0, "dt": "d0"}])
        return expire_obs(res)

    def observe(t):
        tags = sorted(t.tag_manager.tags())
        b = t.copy({"branch": "b"})
        return (rows(t), rows(t, **{"scan.tag-name": "mid"}), rows(b),
                tags, t.fsck(deep=True).ok, meta_files(t),
                data_counts(t))

    oracle_root = str(tmp_path / "oracle")
    os.makedirs(oracle_root)
    oracle = written_by(writer, oracle_root)
    oracle_res = maintain(oracle)
    want = observe(oracle)

    root = str(tmp_path / "cross")
    os.makedirs(root)
    written = written_by(writer, root)
    res = maintain(maintainer.load(written.path))
    assert res == oracle_res
    assert observe(writer.load(written.path)) == want
    assert observe(maintainer.load(written.path)) == want
    # the branch's snapshots live under the branch directory
    assert any(p.startswith("branch/branch-b/snapshot/") for p in want[5])


def test_cross_package_changelog_consumer_after_expiry(tmp_path):
    """The reference expires a port table with decoupled changelog; a
    port stream consumer from snapshot 1 reads every commit."""
    root = str(tmp_path / "t")
    t = FileStoreTable.create(root, (
        Schema.builder().column("id", PORT.types.BigIntType(False))
        .column("v", PORT.types.DoubleType()).primary_key("id")
        .options({"bucket": "1", "write-only": "true",
                  "changelog-producer": "input",
                  "changelog.num-retained.max": "50"}).build()),
        device="cpu")
    for i in range(5):
        commit(t, [{"id": i, "v": float(i)}])
    RefTable.load(root).expire_snapshots(retain_max=2, retain_min=1)
    scan = t.copy({"scan.mode": "from-snapshot", "scan.snapshot-id": "1"}) \
        .new_read_builder().new_stream_scan()
    assert drain_stream(t, scan) == [0, 1, 2, 3, 4]
