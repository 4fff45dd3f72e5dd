"""System tables, ANALYZE, FormatTable and ObjectTable of
paimon_tpu_torch against paimon_tpu.

One scenario (commits with updates and deletes, a tag, a branch, a
consumer, a full compaction, ANALYZE) runs on both packages; every table
of `SYSTEM_TABLES` is read on each and compared on the columns that are
not names, paths, users or times (those are random or clock-bound).
`metrics` and `traces` read each package's own registry and trace ring:
on fresh registries and rings the same operations give the same
(group, metric, kind) rows and span names.  Format tables over csv,
json, parquet and orc directories with `dt=` partitions, and object
tables, are written by one package and read by both.
"""

import json

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.metrics as RM
import paimon_tpu.obs.trace as RT
import paimon_tpu_torch.metrics as M
import paimon_tpu_torch.obs.trace as T
from paimon_tpu.table.system import SYSTEM_TABLES as REF_SYSTEM_TABLES
from paimon_tpu_torch.table.system import SYSTEM_TABLES
from tests.test_torch_dynamic_bucket import BOTH, PORT, REF

_DROP = ("time", "file_name", "file_path", "user", "manifest_list", "path",
         "base_manifest", "delta_manifest", "changelog_manifest")


@pytest.fixture(autouse=True)
def _clean_registries(monkeypatch):
    """Fresh metric registries and empty span rings, tracing off, in
    both packages (the process's own come back after each case)."""
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


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, row_kinds=kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def seeded_rows(seed, n, key_range):
    rng = np.random.default_rng(seed)
    return [{"id": int(i), "v1": int(v), "name": f"n{int(v) % 97}"}
            for i, v in zip(rng.integers(0, key_range, n),
                            rng.integers(-10**6, 10**6, n))]


def pk_table(pkg, root, options=None, name="t"):
    T_ = pkg.types
    b = (pkg.Schema.builder().column("id", T_.BigIntType(False))
         .column("v1", T_.BigIntType())
         .column("name", T_.VarCharType.string_type())
         .primary_key("id"))
    opts = {"bucket": "2"}
    opts.update(options or {})
    return pkg.create(root, b.options(opts).build(), name)


def scenario(pkg, root, options=None):
    """Four commits (the third deletes ten ids), a tag, a branch, a
    consumer, then a full compaction and ANALYZE."""
    from paimon_tpu.types import RowKind as RefKind
    from paimon_tpu_torch.types import RowKind
    table = pk_table(pkg, root, options)
    for seed in range(3):
        commit(table, seeded_rows(seed, 300, 400))
        if seed == 1:
            table.create_tag("t1")
    kind = (RowKind if pkg is PORT else RefKind).DELETE
    commit(table, [{"id": i, "v1": None, "name": None} for i in range(10)],
           kinds=[kind] * 10)
    table.create_branch("b1", tag_name="t1")
    table.consumer_manager.record_consumer("c1", 3)
    table.compact(full=True)
    table.analyze()
    return table


def normalized(t: pa.Table, drop=()):
    cols = [c for c in t.column_names
            if not any(d in c for d in _DROP) and c not in drop]
    rows = [{c: r[c] for c in cols} for r in t.to_pylist()]
    return cols, sorted(json.dumps(r, sort_keys=True, default=str)
                        for r in rows)


def test_every_reference_system_table_is_ported():
    assert sorted(SYSTEM_TABLES) == sorted(REF_SYSTEM_TABLES)


_DATA_TABLES = sorted(set(SYSTEM_TABLES) - {"metrics", "traces"})


@pytest.mark.parametrize("name", _DATA_TABLES)
def test_system_table_equals_reference(tmp_path, name):
    tables = [scenario(p, str(tmp_path)) for p in (PORT, REF)]
    port, ref = (t.system_table(name) for t in tables)
    # a manifest's compressed size depends on the random file names in it
    drop = ("file_size",) if name == "manifests" else ()
    assert normalized(port, drop) == normalized(ref, drop)
    assert port.schema.names == ref.schema.names


@pytest.mark.parametrize("name", ["row_tracking", "table_indexes",
                                  "aggregation_fields", "read_optimized",
                                  "binlog", "audit_log"])
def test_system_table_of_other_table_kinds(tmp_path, name):
    """Row-tracked append tables (deletion vectors in the index
    manifest), aggregation tables and changelog tables."""
    def build(pkg):
        T_ = pkg.types
        root = str(tmp_path / pkg.name)
        tracked = pkg.create(root, pkg.Schema.builder()
                             .column("id", T_.BigIntType(False))
                             .column("v1", T_.BigIntType())
                             .options({"row-tracking.enabled": "true",
                                       "deletion-vectors.enabled": "true"})
                             .build(), "tracked")
        for seed in range(3):
            commit(tracked, [{"id": r["id"], "v1": r["v1"]}
                             for r in seeded_rows(seed, 100, 1000)])
        tracked.delete_where(pkg.P.less_than("id", 100))
        agg = pk_table(pkg, root, {
            "merge-engine": "aggregation",
            "fields.v1.aggregate-function": "sum",
            "changelog-producer": "lookup"}, name="agg")
        for seed in range(3):
            commit(agg, seeded_rows(seed, 200, 300))
        agg.compact(full=True)
        return tracked, agg
    port, ref = build(PORT), build(REF)
    for p, r in zip(port, ref):
        assert normalized(p.system_table(name)) == \
            normalized(r.system_table(name))


def test_known_values(tmp_path):
    """$snapshots one row a snapshot; $files rows and sizes as on disk;
    $audit_log the scan's rows, all +I; $read_optimized after the full
    compaction equals the scan; $statistics the oracle's counts."""
    import os
    table = scenario(PORT, str(tmp_path))
    snaps = table.system_table("snapshots")
    assert snaps.column("snapshot_id").to_pylist() == \
        list(range(1, table.snapshot_manager.latest_snapshot_id() + 1))
    files = table.system_table("files")
    assert files.column("file_size_in_bytes").to_pylist() == \
        [os.path.getsize(p) for p in files.column("file_path").to_pylist()]
    scan = table.to_arrow().sort_by("id")
    audit = table.system_table("audit_log")
    assert set(audit.column("rowkind").to_pylist()) == {"+I"}
    assert audit.drop_columns(["rowkind"]).sort_by("id").equals(scan)
    assert table.system_table("read_optimized").sort_by("id").equals(scan)
    want = {}
    for seed in range(3):
        for r in seeded_rows(seed, 300, 400):
            want[r["id"]] = r
    for i in range(10):
        want.pop(i, None)
    stats = table.statistics()
    assert stats["mergedRecordCount"] == len(want) == scan.num_rows
    assert stats["colStats"]["id"]["distinctCount"] == len(want)
    st = table.system_table("statistics")
    assert st.column("merged_record_count").to_pylist() == [len(want)]


def test_analyze_equals_reference(tmp_path):
    stats = [scenario(p, str(tmp_path)).statistics() for p in (PORT, REF)]
    assert stats[0] == stats[1]
    cols = [scenario(p, str(tmp_path / "c"),
                     ).analyze(["id", "name"]) for p in (PORT, REF)]
    assert cols[0] == cols[1]


@BOTH
def test_analyze_refuses_unknown_columns(tmp_path, pkg):
    table = pk_table(pkg, str(tmp_path))
    assert table.analyze() is None            # nothing to analyze yet
    commit(table, seeded_rows(0, 10, 20))
    with pytest.raises(ValueError, match="Unknown columns"):
        table.analyze(["nope"])


def test_metrics_and_traces_read_each_packages_registry(tmp_path):
    out = []
    for pkg, tr in ((PORT, T), (REF, RT)):
        tr.enable_tracing()
        table = pk_table(pkg, str(tmp_path / pkg.name))
        commit(table, seeded_rows(1, 200, 300))
        commit(table, seeded_rows(2, 200, 300))
        table.to_arrow()
        table.compact(full=True)
        traces = table.system_table("traces")
        metrics = table.system_table("metrics")
        tr.disable_tracing()
        out.append((traces.schema, sorted(set(
            traces.column("name").to_pylist())),
            metrics.schema, sorted({(r["group"], r["metric"], r["kind"])
                                    for r in metrics.to_pylist()})))
    assert out[0][0] == out[1][0] and out[0][2] == out[1][2]
    assert out[0][1] == out[1][1]
    assert "scan.merge" in out[0][1]
    assert out[0][3] == out[1][3]
    assert ("compaction", "tasks", "counter") in out[0][3]


@BOTH
def test_unknown_system_table_raises(tmp_path, pkg):
    with pytest.raises(ValueError, match="Unknown system table"):
        pk_table(pkg, str(tmp_path)).system_table("nope")


# -- format and object tables -------------------------------------------------

def _format_mods(pkg):
    if pkg is PORT:
        from paimon_tpu_torch.table.format_table import FormatTable
        from paimon_tpu_torch.table.object_table import ObjectTable
    else:
        from paimon_tpu.table.format_table import FormatTable
        from paimon_tpu.table.object_table import ObjectTable
    return FormatTable, ObjectTable


def bench_rows(seed, n):
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": pa.array(rng.integers(0, 2**40, n), pa.int64()),
        "v1": pa.array(rng.integers(-2**40, 2**40, n), pa.int64()),
        "v2": pa.array(rng.standard_normal(n), pa.float64()),
        "v3": pa.array(rng.integers(-2**31, 2**31 - 1, n), pa.int32())})


def _sorted(t):
    return t.sort_by([("dt", "ascending"), ("id", "ascending")])


@BOTH
@pytest.mark.parametrize("fmt", ["csv", "json", "parquet", "orc"])
def test_format_table_cross_reads(tmp_path, pkg, fmt):
    Writer, _ = _format_mods(pkg)
    w = Writer(str(tmp_path / "ft"), fmt)
    parts = {}
    for i, dt in enumerate(["2024-01-01", "2024-01-02", "2024-01-03"]):
        data = bench_rows(i, 500)
        w.write(data, partition={"dt": dt})
        parts[dt] = data
    want = _sorted(pa.concat_tables([
        t.append_column("dt", pa.array([dt] * t.num_rows, pa.string()))
        for dt, t in parts.items()]))
    for reader in (PORT, REF):
        R, _ = _format_mods(reader)
        got = R(str(tmp_path / "ft"), fmt).to_arrow()
        got = _sorted(got.select(want.column_names)).cast(want.schema)
        assert got.equals(want)
        one = R(str(tmp_path / "ft"), fmt).to_arrow({"dt": "2024-01-02"})
        assert one.num_rows == 500
    assert _format_mods(PORT)[0](str(tmp_path / "ft"), fmt) \
        .to_arrow({"dt": "1999-01-01"}).num_rows == 0


@BOTH
def test_object_table_listing(tmp_path, pkg):
    _, Writer = _format_mods(pkg)
    objects = {f"img/{i:03d}.bin": bytes([i]) * (i * 7) for i in range(20)}
    objects["doc/readme.txt"] = b"hello"
    w = Writer(str(tmp_path / "objs"))
    for path, data in objects.items():
        w.put(path, data)
    w.delete("img/000.bin")
    objects.pop("img/000.bin")
    listings = []
    for reader in (PORT, REF):
        _, R = _format_mods(reader)
        t = R(str(tmp_path / "objs"))
        rows = t.to_arrow().drop_columns(["mtime_ms"]).to_pylist()
        listings.append(sorted(rows, key=lambda r: r["path"]))
        assert t.refresh() == len(objects)
        assert t.read("doc/readme.txt") == b"hello"
    assert listings[0] == listings[1]
    assert {r["path"]: r["length"] for r in listings[0]} == \
        {p: len(d) for p, d in objects.items()}
    with pytest.raises(ValueError):
        w.put("../escape", b"x")


@pytest.mark.parametrize("seed", range(4))
def test_binlog_columnar_equals_row_by_row(tmp_path, seed):
    """The port builds $binlog over the read's arrays; on a table with
    INT, DOUBLE, STRING, BLOB and VARIANT columns the result equals the
    reference's row-by-row table, schema and values."""
    from paimon_tpu.data.variant import column_from_objects as ref_col
    from paimon_tpu_torch.data.variant import column_from_objects

    rng = np.random.default_rng(seed)
    n = 300
    ids = rng.integers(0, 200, n)

    def batch(variant_col):
        return pa.table({
            "id": pa.array(ids, pa.int64()),
            "v3": pa.array(rng.integers(0, 9, n).astype(np.int32),
                           mask=rng.random(n) < 0.2),
            "v2": pa.array(rng.random(n)),
            "s": pa.array([f"x{i}" for i in ids]),
            "img": pa.array([bytes([i % 256]) * int(i % 7) for i in ids],
                            pa.binary()),
            "meta": variant_col([{"w": int(i), "t": [str(i)]}
                                 for i in ids])})
    out = []
    for pkg, col in ((PORT, column_from_objects), (REF, ref_col)):
        T_ = pkg.types
        schema = (pkg.Schema.builder().column("id", T_.BigIntType(False))
                  .column("v3", T_.IntType()).column("v2", T_.DoubleType())
                  .column("s", T_.VarCharType.string_type())
                  .column("img", T_.BlobType()).column("meta",
                                                       T_.VariantType())
                  .primary_key("id").options({"bucket": "2"}).build())
        table = pkg.create(str(tmp_path), schema)
        rng = np.random.default_rng(seed)
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write_arrow(batch(col))
        wb.new_commit().commit(w.prepare_commit())
        w.close()
        out.append(table.system_table("binlog"))
    port, ref = out
    assert port.schema == ref.schema
    key = [r["id"][0] for r in port.to_pylist()]
    order = np.argsort(key, kind="stable")
    ref_key = [r["id"][0] for r in ref.to_pylist()]
    ref_order = np.argsort(ref_key, kind="stable")
    assert port.take(pa.array(order)).equals(ref.take(pa.array(ref_order)))
