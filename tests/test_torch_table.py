"""paimon_tpu_torch's table path against paimon_tpu and a numpy oracle.

create -> batch write + commit -> merge-on-read scan ->
compact(full=True) -> read back, on device="cpu" (torch ops and the
kernel's plain version).  Both packages share the on-disk format, so
each reads what the other wrote.  Every value compared is a table row,
so equality is exact (no tolerance).
"""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu_torch.predicate as PP
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import IntType as RefInt
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import (
    BigIntType, DoubleType, IntType, RowKind, VarCharType,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_v1")
OPTIONS = {"bucket": "1", "write-only": "true",
           "parquet.enable.dictionary": "false"}
STREAMED = {"tpu.merge.stream-threshold-rows": "2048",
            "tpu.merge.chunk-rows": "512"}


def _schema(builder_cls, big, dbl, i32, options):
    return (builder_cls.builder().column("id", big(False))
            .column("v1", big()).column("v2", dbl()).column("v3", i32())
            .primary_key("id").options(options).build())


def port_schema(**extra):
    return _schema(Schema, BigIntType, DoubleType, IntType,
                   {**OPTIONS, **extra})


def ref_schema(**extra):
    return _schema(RefSchema, RefBigInt, RefDouble, RefInt,
                   {**OPTIONS, **extra})


def seeded_runs(seed=7, rows=6000, runs=3):
    """bench.py's shape at a small size: uniform ids in [0, rows/2)."""
    rng = np.random.default_rng(seed)
    per = rows // runs
    return [pa.table({
        "id": pa.array(rng.integers(0, rows // 2, per), pa.int64()),
        "v1": pa.array(rng.integers(0, 1 << 40, per), pa.int64()),
        "v2": pa.array(rng.random(per), pa.float64()),
        "v3": pa.array(rng.integers(0, 100, per).astype(np.int32),
                       pa.int32())}) for _ in range(runs)]


def oracle(runs):
    """Last writer wins per id, in id order (numpy, independent of both
    packages)."""
    allt = pa.concat_tables(runs)
    ids = allt.column("id").to_numpy()
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    win = order[np.flatnonzero(np.r_[s[1:] != s[:-1], True])]
    return allt.take(pa.array(win))


def write(table, batches):
    for b in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write_arrow(b)
        wb.new_commit().commit(w.prepare_commit())
        w.close()


def by_id(t):
    return t.sort_by("id")


@pytest.mark.parametrize("extra", [{}, STREAMED], ids=["one-shot",
                                                       "streamed"])
def test_scan_and_full_compaction_match_reference(tmp_path, extra):
    runs = seeded_runs()
    want = oracle(runs)
    port = FileStoreTable.create(str(tmp_path / "port"),
                                 port_schema(**extra), device="cpu")
    ref = RefTable.create(str(tmp_path / "ref"), ref_schema(**extra))
    write(port, runs)
    write(ref, runs)
    p_scan, r_scan = port.to_arrow(), ref.to_arrow()
    assert by_id(p_scan).equals(want)
    assert p_scan.equals(r_scan)
    assert port.compact(full=True) is not None
    assert ref.compact(full=True) is not None
    p_back, r_back = port.to_arrow(), ref.to_arrow()
    assert by_id(p_back).equals(want)
    assert p_back.equals(r_back)
    assert len(port.new_scan().plan().splits[0].data_files) == 1


def test_port_reads_reference_table(tmp_path):
    runs = seeded_runs(seed=3)
    ref = RefTable.create(str(tmp_path / "t"), ref_schema(**STREAMED))
    write(ref, runs[:2])
    ref.compact(full=True)
    write(ref, runs[2:])
    port = FileStoreTable.load(str(tmp_path / "t"), device="cpu")
    assert port.to_arrow().equals(ref.to_arrow())
    assert by_id(port.to_arrow()).equals(oracle(runs))


def test_reference_reads_port_table(tmp_path):
    runs = seeded_runs(seed=4)
    port = FileStoreTable.create(str(tmp_path / "t"),
                                 port_schema(**STREAMED), device="cpu")
    write(port, runs[:2])
    port.compact(full=True)
    write(port, runs[2:])
    ref = RefTable.load(str(tmp_path / "t"))
    assert ref.to_arrow().equals(port.to_arrow())
    assert by_id(ref.to_arrow()).equals(oracle(runs))
    # the reference compacts what the port wrote, the port reads it back
    ref.compact(full=True)
    port = FileStoreTable.load(str(tmp_path / "t"), device="cpu")
    assert by_id(port.to_arrow()).equals(oracle(runs))


def test_golden_pk_fixture(tmp_path):
    dst = tmp_path / "golden"
    shutil.copytree(FIXTURE, dst)
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    t = FileStoreTable.load(str(dst / "golden_pk"), device="cpu")
    rows = sorted(t.to_arrow().to_pylist(),
                  key=lambda r: (r["pt"], r["id"]))
    assert rows == expected["pk_rows"]


# -- ported in-slice cases of tests/test_table_e2e.py -------------------------

def pk_schema(**options):
    return (Schema.builder()
            .column("id", BigIntType(False))
            .column("name", VarCharType.string_type())
            .column("score", DoubleType())
            .primary_key("id")
            .options({"bucket": "2", **options})
            .build())


def write_rows(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def read_sorted(table, **kw):
    return table.to_arrow(**kw).sort_by("id").to_pylist()


def new_table(tmp_path, schema=None):
    return FileStoreTable.create(str(tmp_path / "t"), schema or pk_schema(),
                                 device="cpu")


def test_create_write_read(tmp_path):
    table = new_table(tmp_path)
    rows = [{"id": i, "name": c, "score": float(i)}
            for i, c in ((1, "a"), (2, "b"), (3, "c"))]
    assert write_rows(table, rows) == 1
    assert read_sorted(table) == rows


def test_upsert_across_commits(tmp_path):
    table = new_table(tmp_path)
    write_rows(table, [{"id": 1, "name": "a", "score": 1.0},
                       {"id": 2, "name": "b", "score": 2.0}])
    write_rows(table, [{"id": 2, "name": "b2", "score": 20.0},
                       {"id": 3, "name": "c", "score": 3.0}])
    assert read_sorted(table) == [
        {"id": 1, "name": "a", "score": 1.0},
        {"id": 2, "name": "b2", "score": 20.0},
        {"id": 3, "name": "c", "score": 3.0}]
    assert table.latest_snapshot().id == 2


def test_delete_row(tmp_path):
    table = new_table(tmp_path)
    write_rows(table, [{"id": 1, "name": "a", "score": 1.0},
                       {"id": 2, "name": "b", "score": 2.0}])
    write_rows(table, [{"id": 1, "name": "a", "score": 1.0}],
               kinds=[RowKind.DELETE])
    assert [r["id"] for r in read_sorted(table)] == [2]
    table.compact(full=True)
    assert [r["id"] for r in read_sorted(table)] == [2]


def test_dedup_within_batch(tmp_path):
    table = new_table(tmp_path)
    write_rows(table, [{"id": 1, "name": f"v{i}", "score": float(i)}
                       for i in (1, 2, 3)])
    assert read_sorted(table) == [{"id": 1, "name": "v3", "score": 3.0}]


def test_first_row_engine(tmp_path):
    table = new_table(tmp_path, pk_schema(**{"merge-engine": "first-row"}))
    write_rows(table, [{"id": 1, "name": "first", "score": 1.0}])
    write_rows(table, [{"id": 1, "name": "second", "score": 2.0},
                       {"id": 2, "name": "x", "score": 0.0}])
    assert [r["name"] for r in read_sorted(table)] == ["first", "x"]


def test_projection_and_filter(tmp_path):
    table = new_table(tmp_path)
    write_rows(table, [{"id": i, "name": f"n{i}", "score": float(i)}
                       for i in range(10)])
    out = table.to_arrow(projection=["id", "score"],
                         predicate=PP.greater_than("score", 6.5))
    assert out.column_names == ["id", "score"]
    assert sorted(out.column("id").to_pylist()) == [7, 8, 9]


def test_partitioned_table(tmp_path):
    schema = (Schema.builder()
              .column("dt", VarCharType(10, False))
              .column("id", BigIntType(False))
              .column("v", IntType())
              .partition_keys("dt")
              .primary_key("dt", "id")
              .options({"bucket": "2"})
              .build())
    table = new_table(tmp_path, schema)
    write_rows(table, [{"dt": "d1", "id": 1, "v": 1},
                       {"dt": "d1", "id": 2, "v": 2},
                       {"dt": "d2", "id": 1, "v": 10}])
    assert (tmp_path / "t" / "dt=d1").exists()
    assert (tmp_path / "t" / "dt=d2").exists()
    rb = table.new_read_builder().with_partition_filter({"dt": "d2"})
    t = rb.new_read().to_arrow(rb.new_scan().plan().splits)
    assert t.column("v").to_pylist() == [10]
    assert table.to_arrow().num_rows == 3


def test_multi_bucket_distribution(tmp_path):
    table = new_table(tmp_path, pk_schema(bucket="4"))
    write_rows(table, [{"id": i, "name": str(i), "score": float(i)}
                       for i in range(100)])
    plan = table.new_read_builder().new_scan().plan()
    assert len({s.bucket for s in plan.splits}) > 1
    assert [r["id"] for r in read_sorted(table)] == list(range(100))


def test_overwrite(tmp_path):
    table = new_table(tmp_path)
    write_rows(table, [{"id": 1, "name": "a", "score": 1.0}])
    wb = table.new_batch_write_builder().with_overwrite()
    w = wb.new_write()
    w.write_dicts([{"id": 9, "name": "z", "score": 9.0}])
    wb.new_commit().commit(w.prepare_commit())
    w.close()
    assert [r["id"] for r in read_sorted(table)] == [9]
    assert table.latest_snapshot().commit_kind == "OVERWRITE"


def test_time_travel_snapshot(tmp_path):
    table = new_table(tmp_path)
    write_rows(table, [{"id": 1, "name": "a", "score": 1.0}])
    write_rows(table, [{"id": 1, "name": "b", "score": 2.0}])
    rb = table.new_read_builder()
    out1 = rb.new_read().to_arrow(rb.new_scan().plan(snapshot_id=1).splits)
    assert out1.column("name").to_pylist() == ["a"]


def test_compact_manifests_matches_reference(tmp_path):
    """One full manifest rewrite commits a COMPACT snapshot under the
    batch identifier, as the reference's does, and changes no row."""
    from paimon_tpu.core.commit import FileStoreCommit as RefCommit
    from paimon_tpu_torch.core.commit import FileStoreCommit

    runs = seeded_runs(rows=600, runs=3)
    port = FileStoreTable.create(str(tmp_path / "p"), port_schema(),
                                 device="cpu")
    ref = RefTable.create(str(tmp_path / "r"), ref_schema())
    out = []
    for table, commit_cls in ((port, FileStoreCommit), (ref, RefCommit)):
        write(table, runs)
        before = table.to_arrow().sort_by("id")
        sid = commit_cls(table.file_io, table.path, table.schema,
                         table.options).compact_manifests()
        snap = table.snapshot_manager.snapshot(sid)
        assert table.to_arrow().sort_by("id").equals(before)
        out.append((sid, snap.commit_kind, snap.commit_identifier,
                    snap.total_record_count))
    assert out[0] == out[1]
    assert out[0][1] == "COMPACT"


# -- out-of-slice features raise -------------------------------------------

@pytest.mark.parametrize("options, item", [
    ({"row-tracking.enabled": "true"}, "the remaining planes"),
    ({"scan.tag-name": "v1"}, "the remaining planes"),
    ({"bucket": "-1"}, "the remaining planes"),
    ({"deletion-vectors.enabled": "true"}, "the remaining planes"),
    ({"scan.fallback-branch": "fb"}, "the remaining planes"),
    ({"scan.ignore-corrupt-files": "true"}, "the remaining planes"),
    ({"read.retry.max-attempts": "5"}, "the remaining planes"),
    ({"read.retry.backoff": "20 ms"}, "the remaining planes"),
    ({"request.timeout": "30 s"}, "the remaining planes")])
def test_unported_table_options_raise(tmp_path, options, item):
    with pytest.raises(NotImplementedError, match=item):
        FileStoreTable.create(str(tmp_path / "t"), pk_schema(**options),
                              device="cpu")


@pytest.mark.parametrize("options, item", [
    ({"write-buffer-spillable": "true"}, "the remaining planes"),
    ({"local-merge-buffer-size": "1mb"}, "the remaining planes"),
    ({"file-index.bloom-filter.columns": "v1"}, "the remaining planes"),
    ({"partition.end-input-to-done": "true"}, "the remaining planes"),
    ({"tag.automatic-creation": "process-time"}, "the remaining planes"),
    ({"commit.callbacks": "pkg.mod:Cb"}, "the remaining planes"),
    ({"write.retry.max-attempts": "5"}, "the remaining planes"),
    ({"write.retry.backoff": "20 ms"}, "the remaining planes"),
    ({"write.stage.dir": "/tmp/stage"}, "the remaining planes")])
def test_unported_write_options_raise(tmp_path, options, item):
    table = new_table(tmp_path, pk_schema(**options))
    with pytest.raises(NotImplementedError, match=item):
        table.new_batch_write_builder().new_write()
    with pytest.raises(NotImplementedError, match=item):
        table.compact(full=True)


def test_append_table_and_other_planes_raise(tmp_path):
    schema = (Schema.builder().column("id", BigIntType())
              .options({"bucket": "1"}).build())
    with pytest.raises(NotImplementedError, match="append tables"):
        FileStoreTable.create(str(tmp_path / "a"), schema, device="cpu")
    table = new_table(tmp_path)
    for call in (lambda: table.system_table("snapshots"),
                 lambda: table.create_tag("v1"),
                 lambda: table.create_branch("b1")):
        with pytest.raises(NotImplementedError):
            call()
