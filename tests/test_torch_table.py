"""paimon_tpu_torch's table path against paimon_tpu and a numpy oracle.

create -> batch write + commit -> merge-on-read scan ->
compact(full=True) -> read back, on device="cpu" (torch ops and the
kernel's plain version).  Both packages share the on-disk format, so
each reads what the other wrote.  Every value compared is a table row,
so equality is exact (no tolerance).
"""

import functools
import json
import os
import pathlib
import shutil
import tempfile

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
from tests.test_torch_object_store import (  # noqa: F401 -- a fixture
    clean_process_state,
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

def _search_procedure(tmp_path, call="CALL sys.vector_search('docs', "
                      "'emb', '1.0,0.05', 1)"):
    """A search procedure through SQL on the CPU, on a docs table of 3
    rows."""
    from paimon_tpu_torch import create_catalog
    from paimon_tpu_torch.sql import SQLContext
    cat = create_catalog({"warehouse": str(tmp_path / "wh")}, device="cpu")
    cat.create_database("default", ignore_if_exists=True)
    ctx = SQLContext(cat)
    ctx.sql("CREATE TABLE IF NOT EXISTS docs (id BIGINT NOT NULL, "
            "title STRING, emb ARRAY<FLOAT>, PRIMARY KEY (id)) "
            "WITH ('bucket' = '1')")
    ctx.sql("INSERT INTO docs VALUES (1, 'tpu guide', ARRAY[1.0, 0.0]), "
            "(2, 'pasta', ARRAY[0.0, 1.0]), (3, 'tpu', ARRAY[0.9, 0.1])")
    return ctx.sql(call)


def _append_blob_field_write(tmp_path, **options):
    """An append table with a blob column and blob or variant options
    that no writer of either package reads (A.8.8b)."""
    from paimon_tpu_torch.types import BlobType
    schema = (Schema.builder().column("id", BigIntType())
              .column("b", BlobType()).options(options).build())
    FileStoreTable.create(str(tmp_path / "b"), schema, device="cpu") \
        .new_batch_write_builder().new_write()


# bucket -1 and deletion-vectors.enabled opened with the dynamic
# buckets, row tracking and deletion vectors with append tables, system
# tables and blob columns with the formats and types; their places hold
# other unported planes
_UNPORTED_ACTIONS = {"stream plane": lambda tmp_path:
                     _distributed_stream_daemon(),
                     "append blob-field": functools.partial(
                         _append_blob_field_write, **{"blob-field": "b"})}


@pytest.mark.parametrize("options, item", [
    ("stream plane", "A.8.9"),
    ("append blob-field", "A.8.8b")])
def test_unported_table_options_raise(tmp_path, options, item):
    with pytest.raises(NotImplementedError, match=item):
        if isinstance(options, str):
            _UNPORTED_ACTIONS[options](tmp_path)
        else:
            FileStoreTable.create(str(tmp_path / "t"), pk_schema(**options),
                                  device="cpu")


def _ref_pk_table(path, **options):
    from paimon_tpu.types import VarCharType as RefVarChar
    schema = (RefSchema.builder().column("id", RefBigInt(False))
              .column("name", RefVarChar.string_type())
              .column("score", RefDouble()).primary_key("id")
              .options({"bucket": "2", **options}).build())
    return RefTable.create(path, schema)


@pytest.mark.usefixtures("clean_process_state")
@pytest.mark.parametrize("key", ["cache.disk.dir", "request.timeout"])
def test_fleet_table_options_read_equal_to_reference(tmp_path, key):
    """The table options the serving fleet opened: a table with the
    host-SSD tier or a request deadline writes, reads and compacts as
    the reference's does."""
    got = {}
    for pkg in ("port", "reference"):
        value = str(tmp_path / f"{pkg}-ssd") if key == "cache.disk.dir" \
            else "30 s"
        path = str(tmp_path / pkg)
        t = new_table(pathlib.Path(path), pk_schema(**{key: value})) \
            if pkg == "port" else _ref_pk_table(path + "/t", **{key: value})
        rows = [{"id": i, "name": f"n{i}", "score": i / 4}
                for i in range(0, 300, 3)]
        write_rows(t, rows[:60])
        write_rows(t, rows[40:])
        out = [read_sorted(t)]
        t.compact(full=True)
        out.append(read_sorted(t))
        if key == "cache.disk.dir":
            # the scan went through the disk tier
            out.append(t.file_io.state.disk is not None)
        got[pkg] = out
    assert got["port"] == got["reference"]
    assert len(got["port"][0]) == 100


@pytest.mark.parametrize("options, item", [
    ({"file-index.read.enabled": "false"}, "A.8.6b"),
    ({"dynamic-bucket.max-buckets": "8"}, "A.8.3b"),
    ({"cross-partition-upsert.index-ttl": "1 h"}, "A.8.3b"),
    ({"snapshot.expire.limit": "10"}, "A.8.4b"),
    ({"changelog.time-retained": "1 h"}, "A.8.4b"),
    ({"blob-field": "name"}, "A.8.8b"),
    ({"blob.target-file-size": "1 gb"}, "A.8.8b"),
    ({"blob-as-descriptor": "true"}, "A.8.8b"),
    ({"variant.shreddingSchema": "v:$.a"}, "A.8.8b"),
    ({"variant.inferShreddingSchema": "true"}, "A.8.8b"),
    ({"variant.shredding.maxInferBufferRow": "10"}, "A.8.8b"),
    ({"variant.shredding.maxSchemaDepth": "2"}, "A.8.8b"),
    ({"variant.shredding.maxSchemaWidth": "2"}, "A.8.8b"),
    ({"variant.shredding.minFieldCardinalityRatio": "0.1"}, "A.8.8b")])
def test_unported_write_options_raise(tmp_path, options, item):
    table = new_table(tmp_path, pk_schema(**options))
    with pytest.raises(NotImplementedError, match=item):
        table.new_batch_write_builder().new_write()
    with pytest.raises(NotImplementedError, match=item):
        table.compact(full=True)


@pytest.mark.parametrize("key, value", [
    ("snapshot.expire.limit", "10"), ("changelog.time-retained", "1 h")])
def test_unread_expiry_bounds_raise_on_expire(tmp_path, key, value):
    """The reference defines both bounds and its expiry reads neither:
    the port refuses them rather than ignore them."""
    table = new_table(tmp_path, pk_schema(**{key: value}))
    with pytest.raises(NotImplementedError, match="A.8.4b"):
        table.expire_snapshots()


def test_append_table_and_other_planes_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A.8.8b"):
        _append_blob_field_write(tmp_path, **{"blob-as-descriptor": "true"})
    # the search procedures run since the search plane was ported
    out = _search_procedure(
        tmp_path, "CALL sys.full_text_search('docs', 'title', 'tpu', 2)")
    assert sorted(out.column("id").to_pylist()) == [1, 3]
    out = _search_procedure(
        tmp_path, "CALL sys.create_vector_index('docs', 'emb', 2, 'l2', "
        "'hnsw')")
    assert out.column(0).to_pylist() == ["hnsw index built: 3 vectors"]


def _multi_process_mesh():
    from types import SimpleNamespace

    from paimon_tpu_torch.parallel.mesh_engine import _single_process
    _single_process(SimpleNamespace(world=2))


def _variant_shredding():
    with tempfile.TemporaryDirectory() as d:
        table = FileStoreTable.create(
            os.path.join(d, "t"),
            pk_schema(**{"variant.inferShreddingSchema": "true"}),
            device="cpu")
        table.new_batch_write_builder().new_write()


def _blob_descriptor_reads():
    with tempfile.TemporaryDirectory() as d:
        _append_blob_field_write(pathlib.Path(d),
                                 **{"blob-as-descriptor": "true"})


def _distributed_stream_daemon():
    from paimon_tpu_torch.cdc.source import MemoryCdcSource
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    with tempfile.TemporaryDirectory() as d:
        table = FileStoreTable.create(os.path.join(d, "t"), pk_schema(),
                                      device="cpu")
        StreamDaemon(table, MemoryCdcSource(), plane=object())


def _plane_stamps():
    from paimon_tpu_torch.service.stream_daemon import recover_plane_stamps
    with tempfile.TemporaryDirectory() as d:
        recover_plane_stamps(FileStoreTable.create(
            os.path.join(d, "t"), pk_schema(), device="cpu"), "daemon")


def _cli_command(*argv):
    """One of the CLI's sub-command handlers, called as main() would."""
    def run():
        from paimon_tpu_torch import cli
        with tempfile.TemporaryDirectory() as d:
            args = cli.build_parser().parse_args(
                ["--device", "cpu", "-w", os.path.join(d, "wh"), *argv])
            args.func(args)
    return run


def _table_method(name):
    """One of FileStoreTable's A.8.9 methods, called as the reference's
    signature allows."""
    def run():
        with tempfile.TemporaryDirectory() as d:
            table = FileStoreTable.create(os.path.join(d, "t"), pk_schema(),
                                          device="cpu")
            if name == "sync_iceberg":
                table.sync_iceberg(committer=None)
            else:
                table.new_distributed_write("writer", process_index=0,
                                            process_count=1)
    return run


@pytest.mark.parametrize("call, item", [
    (_blob_descriptor_reads, "A.8.8b"), (_variant_shredding, "A.8.8b"),
    (_multi_process_mesh, "A.8.9"),
    (_plane_stamps, "A.8.9"),
    (_table_method("sync_iceberg"), "A.8.9"),
    (_table_method("new_distributed_write"), "A.8.9"),
    (_cli_command("fleet", "status", "d1.t"), "A.8.9"),
    (_distributed_stream_daemon, "A.8.9"),
    (_cli_command("lint"), "A.8.9")])
def test_refusals_name_their_items(call, item):
    """Each refusal names its ROADMAP.md item, and that item exists."""
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "ROADMAP.md")) as f:
        roadmap = f.read()
    with pytest.raises(NotImplementedError) as e:
        call()
    assert f"(ROADMAP.md: {item})" in str(e.value)
    assert f"**{item} " in roadmap


# -- the surfaces the serving fleet opened (they were refused) --------------

def _fleet_surface(what, tmp_path):
    """One surface of the serving fleet on one package: what it
    answers."""
    from paimon_tpu.fs import get_file_io as ref_get_file_io
    from paimon_tpu_torch.fs import get_file_io
    from paimon_tpu_torch.service import (
        KvQueryClient, KvQueryServer, ReplicaRouter,
    )
    from paimon_tpu_torch.utils.deadline import DeadlineExceededError
    if what == "object_store_path":
        # an unregistered scheme: the reference's ValueError
        out = []
        for fn in (get_file_io, ref_get_file_io):
            with pytest.raises(ValueError) as e:
                fn("s3://bucket/t")
            out.append(str(e.value))
        return out
    table = new_table(tmp_path, pk_schema(**{
        "service.replicas": "2", "request.timeout": "1 s"}))
    rows = [{"id": i, "name": f"n{i}", "score": i / 2} for i in range(20)]
    write_rows(table, rows)
    if what == "table_read_deadline":
        ok = read_sorted(table)
        with pytest.raises(DeadlineExceededError):
            read_sorted(table.copy({"request.timeout": "0 ms"}))
        return ok
    if what == "replicas":
        from paimon_tpu_torch.service import ReplicaSet
        with ReplicaSet(table) as rs:
            rs.start()
            with KvQueryClient(table) as c:      # discovers the router
                return [len(rs.servers), c.lookup_row({"id": 4}),
                        c._ring is not None]
    server = KvQueryServer(table, replica_id=3)
    server.server.start()
    try:
        if what == "follow_topology":
            with KvQueryClient(address=server.address,
                               follow_topology=True) as c:
                return [c.lookup_row({"id": 5}), c._ring, c.last_replica]
        router = ReplicaRouter(addresses={9: "http://127.0.0.1:1"}).start()
        try:
            router.deregister_replica(9)
            reg = server.register_with_router(router.address)
            with KvQueryClient(address=router.address) as c:
                return [reg, c.lookup_row({"id": 6}), c.last_replica]
        finally:
            router.stop()
    finally:
        server.shutdown()


@pytest.mark.usefixtures("clean_process_state")
@pytest.mark.parametrize("what, want", [
    ("object_store_path",
     ["No FileIO registered for scheme 's3'"] * 2),
    ("follow_topology",
     [{"id": 5, "name": "n5", "score": 2.5}, None, "3"]),
    ("router",
     [{"registered": 3, "replica_count": 1},
      {"id": 6, "name": "n6", "score": 3.0}, "3"]),
    ("replicas", [2, {"id": 4, "name": "n4", "score": 2.0}, True]),
    ("table_read_deadline",
     [{"id": i, "name": f"n{i}", "score": i / 2} for i in range(20)])])
def test_fleet_surfaces_answer(tmp_path, what, want):
    """The object-store scheme registry, the client's topology
    following, registration with a router, replicas and the table's
    read deadline answer as the reference's do."""
    assert _fleet_surface(what, tmp_path) == want


# -- options the maintenance plane opened (they were refused) ---------------

def _ref_pk_schema(**options):
    from paimon_tpu.types import VarCharType as RefVarChar
    return (RefSchema.builder()
            .column("id", RefBigInt(False))
            .column("name", RefVarChar.string_type())
            .column("score", RefDouble())
            .primary_key("id")
            .options({"bucket": "2", **options})
            .build())


class _CountingCallback:
    calls = []

    def __init__(self, param=None):
        pass

    def call(self, table, snapshot_id, messages):
        _CountingCallback.calls.append(snapshot_id)


def _opened_scenario(table, key):
    """What one opened option does on `table`: the rows it reads and
    the files it leaves."""
    rows = [{"id": i, "name": str(i), "score": float(i)} for i in range(6)]
    _CountingCallback.calls = []
    write_rows(table, rows[:3])
    if key == "scan.tag-name":
        table.create_tag("v1")
    write_rows(table, rows[3:])
    if key == "scan.fallback-branch":
        table.create_branch("fb")
        write_rows(table.copy({"branch": "fb"}), rows[:1])
    out = [read_sorted(table)]
    if key == "tag.automatic-creation":
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_dicts(rows[:1])
            wb.new_commit().commit(w.prepare_commit(),
                                   watermark=3 * 86_400_000)
        out.append(sorted(table.tag_manager.tags()))
    out.append(list(_CountingCallback.calls))
    out.append(sorted(os.listdir(table.path)))
    return out


@pytest.mark.parametrize("key, value", [
    ("scan.tag-name", "v1"), ("scan.fallback-branch", "fb"),
    ("partition.end-input-to-done", "true"),
    ("tag.automatic-creation", "watermark"),
    ("commit.callbacks", f"{__name__}:_CountingCallback")])
def test_opened_options_match_reference(tmp_path, key, value):
    """The refused cases of the two tests above for the keys the
    maintenance plane ported: a table that sets the key now behaves as
    the reference's does (tests/test_torch_maintenance.py,
    test_torch_tags_branches.py and test_torch_fsck.py hold each
    feature in depth)."""
    read_opts = {key: value} if key.startswith("scan.") else {}
    write_opts = {} if read_opts else {key: value}
    port = new_table(tmp_path, pk_schema(**write_opts))
    ref = RefTable.create(str(tmp_path / "r"), _ref_pk_schema(**write_opts))
    got = [_opened_scenario(t, key) for t in (port, ref)]
    assert got[0] == got[1]
    assert [r["id"] for r in read_sorted(port.copy(read_opts))] == \
        [r["id"] for r in read_sorted(ref.copy(read_opts))]


# -- options the read and write planes opened (they were refused) -----------

def _a85_scenario(table, key):
    """What one opened read or write option does on `table`: the rows it
    reads and the data files it leaves per bucket (row counts)."""
    rows = [{"id": i, "name": str(i), "score": float(i)} for i in range(40)]
    for lo in (0, 10, 20):
        write_rows(table, rows[lo:lo + 20])
    if key == "scan.ignore-corrupt-files":
        # zero the head of the oldest data file of bucket 0 (C.3's input)
        bdir = os.path.join(table.path, "bucket-0")
        oldest = min((os.path.join(bdir, f) for f in os.listdir(bdir)),
                     key=os.path.getmtime)
        with open(oldest, "r+b") as f:
            f.write(b"\0" * 64)
    out = [read_sorted(table)]
    for b in sorted(d for d in os.listdir(table.path)
                    if d.startswith("bucket-")):
        out.append((b, len(os.listdir(os.path.join(table.path, b)))))
    return out


@pytest.mark.parametrize("key, value", [
    ("scan.ignore-corrupt-files", "true"),
    ("read.retry.max-attempts", "5"),
    ("read.retry.backoff", "20 ms"),
    ("write-buffer-spillable", "true"),
    ("local-merge-buffer-size", "1mb"),
    ("write.retry.max-attempts", "5"),
    ("write.retry.backoff", "20 ms"),
    ("write.stage.dir", "stage")])
def test_opened_read_write_options_match_reference(tmp_path, key, value):
    """The refused cases of the two tests above for the keys the read and
    write planes ported: a table that sets the key behaves as the
    reference's does (tests/test_torch_spill.py,
    test_torch_local_merge.py and test_torch_read_write_faults.py hold
    each feature in depth)."""
    if key == "write.stage.dir":
        value = str(tmp_path / value)
    port = new_table(tmp_path, pk_schema(**{key: value}))
    ref = RefTable.create(str(tmp_path / "r"), _ref_pk_schema(**{key: value}))
    got = [_a85_scenario(t, key) for t in (port, ref)]
    assert got[0] == got[1]
    if key == "scan.ignore-corrupt-files":
        assert len(got[0][0]) < 40          # the corrupt file's rows went
    else:
        assert len(got[0][0]) == 40
    if key == "write.stage.dir":
        assert os.listdir(value) == []      # each writer's stage is gone
