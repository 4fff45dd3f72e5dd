"""paimon_tpu_torch's streaming plane against paimon_tpu's.

The cases of tests/test_stream_scan.py (startup modes, follow-up
scanners, row kinds, consumer progress, exactly-once stream commits)
and of the streaming options in tests/test_wired_options.py, each run
on both packages on the CPU: the port must return what the reference
returns, plan for plan and row for row, and pass the reference test's
own assertions.  The two incremental-between cases wait for tags.
Every value compared is a table row, so equality is exact.
"""

import os
import time

import pytest

from paimon_tpu import predicate as RefP
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu_torch import predicate as P
from paimon_tpu_torch.core.read import ROW_KIND_COL
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, RowKind


class Package:
    """One package's table API, so a scenario runs unchanged on both."""

    def __init__(self, name, schema, table, big, dbl, predicate, kwargs):
        self.name = name
        self.predicate = predicate
        self._schema, self._table = schema, table
        self._big, self._dbl = big, dbl
        self._kwargs = kwargs

    def table(self, root, opts=None, name="t"):
        options = {"bucket": "1", "write-only": "true"}
        options.update(opts or {})
        schema = (self._schema.builder()
                  .column("id", self._big(False))
                  .column("v", self._dbl())
                  .primary_key("id")
                  .options(options)
                  .build())
        return self._table.create(os.path.join(root, self.name, name),
                                  schema, **self._kwargs)


PORT = Package("port", Schema, FileStoreTable, BigIntType, DoubleType, P,
               {"device": "cpu"})
REF = Package("reference", RefSchema, RefTable, RefBigInt, RefDouble, RefP,
              {})


def both(scenario, tmp_path):
    """Run `scenario(pkg, root)` on both packages; the port's result must
    equal the reference's.  Returns the port's."""
    got = scenario(PORT, str(tmp_path))
    want = scenario(REF, str(tmp_path))
    assert got == want
    return got


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, row_kinds=kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def read_plan(table, plan):
    return table.new_read_builder().new_read().to_arrow(plan).to_pylist()


def drain(table, scan):
    """Every remaining plan's rows, one list per plan."""
    out = []
    while True:
        p = scan.plan()
        if p is None:
            return out
        out.append(read_plan(table, p))


def test_latest_full_then_deltas(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}])
        commit(table, [{"id": 2, "v": 22.0}])
        scan = table.new_read_builder().new_stream_scan()
        first = sorted(read_plan(table, scan.plan()), key=lambda r: r["id"])
        caught_up = scan.plan() is None
        commit(table, [{"id": 3, "v": 3.0}])
        nxt = read_plan(table, scan.plan())
        return first, caught_up, nxt, scan.plan() is None

    first, caught_up, nxt, end = both(run, tmp_path)
    assert all(r.pop(ROW_KIND_COL) == RowKind.INSERT for r in first)
    assert first == [{"id": 1, "v": 1.0}, {"id": 2, "v": 22.0}]
    assert caught_up and end
    assert {r["id"] for r in nxt} == {3}
    assert all(r[ROW_KIND_COL] == RowKind.INSERT for r in nxt)


def test_delta_follow_up_preserves_row_kinds(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        scan = table.new_read_builder().new_stream_scan()
        scan.plan()
        commit(table, [{"id": 1, "v": 0.0}], kinds=[RowKind.DELETE])
        return read_plan(table, scan.plan())

    out = both(run, tmp_path)
    assert len(out) == 1
    assert out[0][ROW_KIND_COL] == RowKind.DELETE   # -D survives


def test_delta_follow_up_skips_compact_snapshots(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        scan = table.new_read_builder().new_stream_scan()
        scan.plan()
        commit(table, [{"id": 1, "v": 2.0}])
        table.compact(full=True)                # COMPACT snapshot
        return drain(table, scan)

    plans = both(run, tmp_path)
    # only the delta of the APPEND commit; compaction rewrite is not new
    assert [r["v"] for p in plans for r in p] == [2.0]


def test_startup_latest_sees_only_new(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        scan = table.copy({"scan.mode": "latest"}) \
            .new_read_builder().new_stream_scan()
        first = scan.plan().splits
        commit(table, [{"id": 2, "v": 2.0}])
        return first == [], read_plan(table, scan.plan())

    empty_first, out = both(run, tmp_path)
    assert empty_first
    assert {r["id"] for r in out} == {2}


def test_startup_from_snapshot(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        for i in (1, 2, 3):
            commit(table, [{"id": i, "v": float(i)}])   # snapshot i
        scan = table.copy({"scan.mode": "from-snapshot",
                           "scan.snapshot-id": "2"}) \
            .new_read_builder().new_stream_scan()
        first = scan.plan().splits
        return first == [], [r["id"] for p in drain(table, scan)
                             for r in p]

    no_full, ids = both(run, tmp_path)
    assert no_full                           # no initial full scan
    assert ids == [2, 3]


def test_startup_from_snapshot_full(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        commit(table, [{"id": 1, "v": 9.0}])   # snapshot 2
        commit(table, [{"id": 3, "v": 3.0}])   # snapshot 3
        scan = table.copy({"scan.mode": "from-snapshot-full",
                           "scan.snapshot-id": "2"}) \
            .new_read_builder().new_stream_scan()
        return read_plan(table, scan.plan()), read_plan(table, scan.plan())

    first, nxt = both(run, tmp_path)
    assert sorted(r["v"] for r in first) == [9.0]    # merged state @2
    assert [r["id"] for r in nxt] == [3]


def test_startup_from_timestamp(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        snap1 = table.snapshot_manager.snapshot(1)
        commit(table, [{"id": 2, "v": 2.0}])
        scan = table.copy({"scan.mode": "from-timestamp",
                           "scan.timestamp-millis":
                               str(snap1.time_millis)}) \
            .new_read_builder().new_stream_scan()
        first = scan.plan().splits
        return first == [], [r["id"] for p in drain(table, scan)
                             for r in p]

    empty_first, ids = both(run, tmp_path)
    assert empty_first
    assert ids == [2]


def test_changelog_producer_input_follow_up(tmp_path):
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": "input"})
        commit(table, [{"id": 1, "v": 1.0}])
        scan = table.new_read_builder().new_stream_scan()
        scan.plan()
        commit(table, [{"id": 1, "v": 2.0}])
        commit(table, [{"id": 1, "v": 0.0}], kinds=[RowKind.DELETE])
        return [r for p in drain(table, scan) for r in p]

    rows = both(run, tmp_path)
    assert [(r["v"], r[ROW_KIND_COL]) for r in rows] == \
        [(2.0, RowKind.INSERT), (0.0, RowKind.DELETE)]


def test_consumer_progress_and_resume(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        t2 = table.copy({"consumer-id": "job-a"})
        scan = t2.new_read_builder().new_stream_scan()
        scan.plan()
        # progress is only persisted once the caller confirms processing
        before = table.consumer_manager.consumer("job-a")
        scan.notify_checkpoint_complete(scan.checkpoint())
        after = table.consumer_manager.consumer("job-a")
        commit(table, [{"id": 2, "v": 2.0}])
        # a NEW scan with the same consumer-id resumes from the recorded
        # progress: no initial full scan, only the un-consumed delta
        scan2 = t2.new_read_builder().new_stream_scan()
        return before, after, read_plan(table, scan2.plan())

    before, after, out = both(run, tmp_path)
    assert before is None and after == 2
    assert {r["id"] for r in out} == {2}


def test_checkpoint_restore(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        scan = table.new_read_builder().new_stream_scan()
        scan.plan()
        cp = scan.checkpoint()
        commit(table, [{"id": 2, "v": 2.0}])
        # simulate failover: new scan restored at the checkpoint
        scan2 = table.new_read_builder().new_stream_scan()
        scan2.restore(cp)
        return read_plan(table, scan2.plan())

    out = both(run, tmp_path)
    assert {r["id"] for r in out} == {2}


def test_stream_write_exactly_once(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        wb = table.new_stream_write_builder().with_commit_user("job-1")
        w = wb.new_write()
        w.write_dicts([{"id": 1, "v": 1.0}])
        wb.new_commit().commit(w.prepare_commit(), commit_identifier=7)
        w.close()
        # recovery replays checkpoint 7: filter_committed drops it
        c2 = table.new_stream_write_builder().with_commit_user("job-1") \
            .new_commit()
        # an empty streaming commit still makes a snapshot, so its
        # identifier is durable too
        empty = c2.commit([], commit_identifier=8)
        return c2.filter_committed([7, 8, 9]), empty

    remaining, empty_sid = both(run, tmp_path)
    assert remaining == [9]
    assert empty_sid == 2


def test_compacted_full_does_not_skip_later_appends(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])   # snapshot 1 APPEND
        table.compact(full=True)                # snapshot 2 COMPACT
        commit(table, [{"id": 2, "v": 2.0}])   # snapshot 3 APPEND
        scan = table.copy({"scan.mode": "compacted-full"}) \
            .new_read_builder().new_stream_scan()
        first = read_plan(table, scan.plan())
        return first, [r for p in drain(table, scan) for r in p]

    first, rest = both(run, tmp_path)
    assert {r["id"] for r in first} == {1}
    assert {r["id"] for r in rest} == {2}   # snapshot 3 not skipped


def test_empty_streaming_poll_has_stable_schema(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        rb = table.new_read_builder().with_filter(
            pkg.predicate.equal("id", 999))
        scan = rb.new_stream_scan()
        scan.plan()
        commit(table, [{"id": 2, "v": 2.0}])
        t = rb.new_read().to_arrow(scan.plan())
        return t.num_rows, t.column_names

    num_rows, names = both(run, tmp_path)
    assert num_rows == 0
    assert ROW_KIND_COL in names             # schema stable across polls


STARTUP_MODES = ["latest-full", "full", "latest", "compacted-full",
                 "from-snapshot", "from-snapshot-full", "from-timestamp"]


@pytest.mark.parametrize("producer", ["none", "lookup"])
@pytest.mark.parametrize("mode", STARTUP_MODES)
def test_every_startup_mode_equals_reference(tmp_path, mode, producer):
    """Each startup mode the reference handles: the same plans (snapshot
    id, split count) and rows, before and after further commits."""
    def run(pkg, root):
        t = pkg.table(root, {"changelog-producer": producer})
        commit(t, [{"id": i, "v": float(i)} for i in range(6)])
        commit(t, [{"id": 2, "v": 20.0}, {"id": 7, "v": 7.0}])
        t.compact(full=True)
        commit(t, [{"id": 3, "v": 0.0}], kinds=[RowKind.DELETE])
        commit(t, [{"id": 4, "v": 40.0}])
        opts = {"scan.mode": mode}
        if mode.startswith("from-snapshot"):
            opts["scan.snapshot-id"] = "2"
        if mode == "from-timestamp":
            opts["scan.timestamp-millis"] = str(
                t.snapshot_manager.snapshot(2).time_millis)
        scan = t.copy(opts).new_read_builder().new_stream_scan()

        def poll():
            out = []
            while True:
                p = scan.plan()
                if p is None:
                    return out
                out.append((p.snapshot_id, len(p.splits),
                            read_plan(t, p)))

        first = poll()
        commit(t, [{"id": 5, "v": 50.0}, {"id": 8, "v": 8.0}])
        t.compact(full=True)
        return first, poll(), scan.checkpoint()

    first, later, checkpoint = both(run, tmp_path)
    assert first and later
    assert checkpoint == 8


def test_projection_keeps_row_kind(tmp_path):
    def run(pkg, root):
        table = pkg.table(root)
        commit(table, [{"id": 1, "v": 1.0}])
        rb = table.new_read_builder().with_projection(["v"])
        return rb.new_read().to_arrow(rb.new_stream_scan().plan()) \
            .to_pylist()

    assert both(run, tmp_path) == [{"v": 1.0, ROW_KIND_COL: 0}]


# -- streaming options (tests/test_wired_options.py) -------------------------

def test_consumer_ignore_progress(tmp_path):
    def run(pkg, root):
        t = pkg.table(root, {"consumer-id": "c1"})
        commit(t, [{"id": 1, "v": 1.0}])
        scan = t.new_read_builder().new_stream_scan()
        p1 = scan.plan()
        scan.notify_checkpoint_complete(scan.checkpoint())
        commit(t, [{"id": 2, "v": 2.0}])
        # a restarted consumer resumes from its progress...
        p2 = t.new_read_builder().new_stream_scan().plan()
        # ...unless consumer.ignore-progress starts it fresh
        t3 = t.copy({"consumer.ignore-progress": "true"})
        p3 = t3.new_read_builder().new_stream_scan().plan()
        return (p1.snapshot_id, p2.snapshot_id, len(p2.splits),
                p3.snapshot_id, len(read_plan(t3, p3)))

    p1, p2, p2_splits, p3, p3_rows = both(run, tmp_path)
    assert (p1, p2, p3) == (1, 2, 2) and p2_splits > 0
    assert p3_rows == 2                      # full load, not just delta


def test_bounded_watermark_ends_stream(tmp_path):
    def run(pkg, root):
        t = pkg.table(root, {"scan.bounded.watermark": "1000"})
        wb = t.new_stream_write_builder()
        w = wb.new_write()
        w.write_dicts([{"id": 1, "v": 1.0}])
        wb.new_commit().commit(w.prepare_commit(), commit_identifier=1,
                               watermark=500)
        w.close()
        scan = t.new_read_builder().new_stream_scan()
        first = scan.plan() is not None      # initial full load
        w2 = wb.new_write()
        w2.write_dicts([{"id": 2, "v": 2.0}])
        wb.new_commit().commit(w2.prepare_commit(), commit_identifier=2,
                               watermark=2000)       # past the bound
        w2.close()
        return (first, scan.plan() is None, scan.plan() is None,
                t.snapshot_manager.latest_snapshot().watermark)

    assert both(run, tmp_path) == (True, True, True, 2000)


def test_streaming_read_overwrite(tmp_path):
    def run(pkg, root):
        t = pkg.table(root)
        commit(t, [{"id": 1, "v": 1.0}])
        scan = t.new_read_builder().new_stream_scan()
        scan.plan()
        wb = t.new_batch_write_builder().with_overwrite()
        w = wb.new_write()
        w.write_dicts([{"id": 9, "v": 9.0}])
        wb.new_commit().commit(w.prepare_commit())
        w.close()
        # default: overwrite snapshots are skipped
        skipped = scan.plan().splits
        # with the flag: the overwrite's delta is read
        scan2 = t.copy({"streaming-read-overwrite": "true"}) \
            .new_read_builder().new_stream_scan()
        scan2.plan()
        scan2.restore(2)
        return skipped == [], read_plan(t, scan2.plan())

    skipped, rows = both(run, tmp_path)
    assert skipped
    assert [r["id"] for r in rows] == [9]


def test_changelog_file_format_and_prefix(tmp_path):
    def run(pkg, root):
        t = pkg.table(root, {"changelog-producer": "input",
                             "changelog-file.format": "orc",
                             "changelog-file.prefix": "cl-"})
        wb = t.new_stream_write_builder()
        w = wb.new_write()
        w.write_dicts([{"id": 1, "v": 1.0}])
        wb.new_commit().commit(w.prepare_commit(), commit_identifier=1)
        w.close()
        found = [n for _, _, names in os.walk(t.path) for n in names
                 if n.startswith("cl-")]
        # the changelog stream decodes the ORC files
        scan = t.copy({"scan.mode": "from-snapshot",
                       "scan.snapshot-id": "1"}) \
            .new_read_builder().new_stream_scan()
        scan.plan()
        return (len(found), all(n.endswith(".orc") for n in found),
                read_plan(t, scan.plan()))

    count, orc, rows = both(run, tmp_path)
    assert count == 1 and orc
    assert rows == [{"id": 1, "v": 1.0, ROW_KIND_COL: RowKind.INSERT}]


def test_streaming_read_snapshot_delay(tmp_path):
    def run(pkg, root):
        t = pkg.table(root)
        commit(t, [{"id": 1, "v": 1.0}])
        delayed = t.copy({"streaming.read.snapshot.delay": "1 h"}) \
            .new_read_builder().new_stream_scan()
        delayed.plan()
        commit(t, [{"id": 2, "v": 2.0}])
        held = delayed.plan()                # younger than the delay
        prompt = t.copy({"streaming.read.snapshot.delay": "0 ms"}) \
            .new_read_builder().new_stream_scan()
        prompt.restore(2)
        time.sleep(0.002)
        return held is None, read_plan(t, prompt.plan())

    held, rows = both(run, tmp_path)
    assert held
    assert [r["id"] for r in rows] == [2]


@pytest.mark.parametrize("mode", ["from-snapshot", "from-snapshot-full",
                                  "from-timestamp"])
def test_startup_modes_need_their_option(tmp_path, mode):
    table = PORT.table(str(tmp_path))
    commit(table, [{"id": 1, "v": 1.0}])
    with pytest.raises(ValueError, match=mode):
        table.copy({"scan.mode": mode}).new_read_builder() \
            .new_stream_scan().plan()
