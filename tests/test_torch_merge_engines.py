"""Merge-engine semantics on paimon_tpu_torch, table by table.

Copies of tests/test_merge_engines.py (sequence groups, partial-update,
long string keys in aggregation merges, collect, sequence.field) and
tests/test_agg_extras.py (roaring bitmaps, HLL/theta sketches, nested
update, primary_key, ignore-retract) with the same assertions, pointed
at the port on device="cpu".  Then a table of BASELINE config 4's shape
(aggregation sum/max, ORC level-0 runs, parquet after compaction) held
row for row against the reference, each package reading the other's
table, and the guard that keeps a level-0 file of a deferred engine
from being promoted without a rewrite.
"""

import os

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu_torch.index.roaring import (
    deserialize_roaring32, deserialize_roaring64, serialize_roaring32,
    serialize_roaring64,
)
from paimon_tpu_torch.ops.sketch import (
    hll_build, hll_estimate, theta_build, theta_estimate,
)
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable as PortTable
from paimon_tpu_torch.types import (
    ArrayType, BigIntType, DoubleType, IntType, RowType, VarBinaryType,
    VarCharType,
)


class FileStoreTable:
    """The port's table on the CPU, under the name the copied tests use."""

    @staticmethod
    def create(path, schema):
        return PortTable.create(path, schema, device="cpu")


def _commit(table, rows):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows)
    wb.new_commit().commit(w.prepare_commit())
    w.close()


def _pu_table(tmp_warehouse, opts=None):
    options = {"bucket": "1", "merge-engine": "partial-update",
               "write-only": "true"}
    options.update(opts or {})
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("a", IntType())
              .column("b", IntType())
              .column("g1_seq", IntType())
              .column("c", IntType())
              .primary_key("k")
              .options(options)
              .build())
    return FileStoreTable.create(os.path.join(tmp_warehouse, "t"), schema)


def test_sequence_group_out_of_order_update_ignored(tmp_warehouse):
    """BASELINE config-3 shape: columns a,b update only when g1_seq
    advances; c follows the global order."""
    table = _pu_table(tmp_warehouse,
                      {"fields.g1_seq.sequence-group": "a,b"})
    _commit(table, [{"k": 1, "a": 10, "b": 10, "g1_seq": 5, "c": 1}])
    # late event: lower group sequence -> a,b must NOT regress; c updates
    _commit(table, [{"k": 1, "a": 99, "b": 99, "g1_seq": 3, "c": 2}])
    row = table.to_arrow().to_pylist()[0]
    assert (row["a"], row["b"], row["g1_seq"]) == (10, 10, 5)
    assert row["c"] == 2


def test_sequence_group_advance_overwrites(tmp_warehouse):
    table = _pu_table(tmp_warehouse,
                      {"fields.g1_seq.sequence-group": "a,b"})
    _commit(table, [{"k": 1, "a": 1, "b": 1, "g1_seq": 1, "c": 1}])
    _commit(table, [{"k": 1, "a": 2, "b": None, "g1_seq": 7, "c": None}])
    row = table.to_arrow().to_pylist()[0]
    # sequence advanced: group takes the new row's values, null included
    assert (row["a"], row["b"], row["g1_seq"]) == (2, None, 7)
    # c is plain partial-update: null does not overwrite
    assert row["c"] == 1


def test_sequence_group_null_sequence_never_updates(tmp_warehouse):
    table = _pu_table(tmp_warehouse,
                      {"fields.g1_seq.sequence-group": "a,b"})
    _commit(table, [{"k": 1, "a": 1, "b": 1, "g1_seq": 4, "c": 1}])
    _commit(table, [{"k": 1, "a": 9, "b": 9, "g1_seq": None, "c": 9}])
    row = table.to_arrow().to_pylist()[0]
    assert (row["a"], row["b"], row["g1_seq"]) == (1, 1, 4)
    assert row["c"] == 9


def test_sequence_group_tie_later_row_wins(tmp_warehouse):
    table = _pu_table(tmp_warehouse,
                      {"fields.g1_seq.sequence-group": "a,b"})
    _commit(table, [{"k": 1, "a": 1, "b": 1, "g1_seq": 5, "c": 1}])
    _commit(table, [{"k": 1, "a": 2, "b": 2, "g1_seq": 5, "c": 2}])
    row = table.to_arrow().to_pylist()[0]
    assert (row["a"], row["b"]) == (2, 2)


def test_two_sequence_groups_independent(tmp_warehouse):
    options = {"bucket": "1", "merge-engine": "partial-update",
               "write-only": "true",
               "fields.s1.sequence-group": "a",
               "fields.s2.sequence-group": "b"}
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("a", IntType()).column("s1", IntType())
              .column("b", IntType()).column("s2", IntType())
              .primary_key("k").options(options).build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "t2"), schema)
    _commit(table, [{"k": 1, "a": 1, "s1": 10, "b": 1, "s2": 1}])
    _commit(table, [{"k": 1, "a": 2, "s1": 5, "b": 2, "s2": 2}])
    row = table.to_arrow().to_pylist()[0]
    assert (row["a"], row["s1"]) == (1, 10)   # s1 regressed: no update
    assert (row["b"], row["s2"]) == (2, 2)    # s2 advanced: update


def test_agg_merge_long_string_keys(tmp_warehouse):
    """Lifted limitation: string PKs longer than the 16-byte lane prefix
    must still aggregate per full key (host repair path)."""
    schema = (Schema.builder()
              .column("k", VarCharType(nullable=False))
              .column("v", BigIntType())
              .primary_key("k")
              .options({"bucket": "1", "merge-engine": "aggregation",
                        "fields.v.aggregate-function": "sum",
                        "write-only": "true"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "t"), schema)
    base = "k" * 20                       # shared 16-byte prefix
    _commit(table, [{"k": base + "A", "v": 1},
                    {"k": base + "B", "v": 10}])
    _commit(table, [{"k": base + "A", "v": 2},
                    {"k": base + "B", "v": 20},
                    {"k": "short", "v": 100}])
    rows = {r["k"]: r["v"] for r in table.to_arrow().to_pylist()}
    assert rows == {base + "A": 3, base + "B": 30, "short": 100}


def test_partial_update_remove_record_on_delete(tmp_warehouse):
    from paimon_tpu_torch.types import RowKind

    table = _pu_table(tmp_warehouse,
                      {"partial-update.remove-record-on-delete": "true"})
    _commit(table, [{"k": 1, "a": 1, "b": 1, "g1_seq": 1, "c": 1},
                    {"k": 2, "a": 2, "b": 2, "g1_seq": 2, "c": 2}])
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts([{"k": 1, "a": None, "b": None, "g1_seq": None,
                    "c": None}], row_kinds=[RowKind.DELETE])
    wb.new_commit().commit(w.prepare_commit())
    rows = table.to_arrow().to_pylist()
    assert [r["k"] for r in rows] == [2]


def test_collect_aggregator(tmp_warehouse):
    from paimon_tpu_torch.types import ArrayType

    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("tags", ArrayType(VarCharType()))
              .primary_key("k")
              .options({"bucket": "1", "merge-engine": "aggregation",
                        "fields.tags.aggregate-function": "collect",
                        "write-only": "true"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "t"), schema)
    _commit(table, [{"k": 1, "tags": ["x"]}])
    _commit(table, [{"k": 1, "tags": ["y"]}])
    row = table.to_arrow().to_pylist()[0]
    assert row["tags"] == ["x", "y"]
    table.compact(full=True)
    assert table.to_arrow().to_pylist()[0]["tags"] == ["x", "y"]


def test_collect_on_non_array_rejected(tmp_warehouse):
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("tags", VarCharType())
              .primary_key("k")
              .options({"bucket": "1", "merge-engine": "aggregation",
                        "fields.tags.aggregate-function": "collect",
                        "write-only": "true"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "t"), schema)
    _commit(table, [{"k": 1, "tags": "x"}])
    with pytest.raises(ValueError):
        table.to_arrow()


def test_sequence_group_date_field(tmp_warehouse):
    from paimon_tpu_torch.types import DateType
    import datetime

    options = {"bucket": "1", "merge-engine": "partial-update",
               "write-only": "true", "fields.d.sequence-group": "a"}
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("a", IntType()).column("d", DateType())
              .primary_key("k").options(options).build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "td"), schema)
    _commit(table, [{"k": 1, "a": 1, "d": datetime.date(2026, 7, 28)}])
    _commit(table, [{"k": 1, "a": 2, "d": datetime.date(2026, 7, 20)}])
    row = table.to_arrow().to_pylist()[0]
    assert row["a"] == 1                       # stale date: no update


def test_sequence_group_member_with_agg_function_rejected(tmp_warehouse):
    table = _pu_table(tmp_warehouse,
                      {"fields.g1_seq.sequence-group": "a,b",
                       "fields.a.aggregate-function": "sum"})
    _commit(table, [{"k": 1, "a": 1, "b": 1, "g1_seq": 1, "c": 1}])
    with pytest.raises(NotImplementedError):
        table.to_arrow()


def test_sequence_field_out_of_order_events(tmp_warehouse):
    """sequence.field: late-arriving events with larger user sequence win
    regardless of commit order (reference UserDefinedSeqComparator)."""
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("v", IntType())
              .column("event_time", BigIntType())
              .primary_key("k")
              .options({"bucket": "1", "write-only": "true",
                        "sequence.field": "event_time"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "sf"),
                                  schema)
    _commit(table, [{"k": 1, "v": 10, "event_time": 100}])
    # later commit with an EARLIER event time: must NOT win
    _commit(table, [{"k": 1, "v": 99, "event_time": 50}])
    row = table.to_arrow().to_pylist()[0]
    assert (row["v"], row["event_time"]) == (10, 100)
    # compaction preserves the same resolution
    table.compact(full=True)
    row = table.to_arrow().to_pylist()[0]
    assert (row["v"], row["event_time"]) == (10, 100)
    # larger event time wins
    _commit(table, [{"k": 1, "v": 42, "event_time": 200}])
    assert table.to_arrow().to_pylist()[0]["v"] == 42


def test_sequence_field_null_always_loses(tmp_warehouse):
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("v", IntType())
              .column("ts", BigIntType())
              .primary_key("k")
              .options({"bucket": "1", "write-only": "true",
                        "sequence.field": "ts"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "sn"),
                                  schema)
    _commit(table, [{"k": 1, "v": 1, "ts": 5}])
    _commit(table, [{"k": 1, "v": 2, "ts": None}])
    assert table.to_arrow().to_pylist()[0]["v"] == 1


def test_sequence_field_with_partial_update(tmp_warehouse):
    schema = (Schema.builder()
              .column("k", BigIntType(False))
              .column("a", IntType())
              .column("ts", BigIntType())
              .primary_key("k")
              .options({"bucket": "1", "write-only": "true",
                        "merge-engine": "partial-update",
                        "sequence.field": "ts"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "sp"),
                                  schema)
    _commit(table, [{"k": 1, "a": 1, "ts": 10}])
    _commit(table, [{"k": 1, "a": 2, "ts": 5}])   # stale event
    row = table.to_arrow().to_pylist()[0]
    assert (row["a"], row["ts"]) == (1, 10)


def test_sequence_field_first_row_rejected(tmp_warehouse):
    schema = (Schema.builder()
              .column("k", BigIntType(False)).column("ts", BigIntType())
              .primary_key("k")
              .options({"bucket": "1", "write-only": "true",
                        "merge-engine": "first-row",
                        "sequence.field": "ts"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "fr"),
                                  schema)
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    with pytest.raises(ValueError):
        w.write_dicts([{"k": 1, "ts": 1}])
        wb.new_commit().commit(w.prepare_commit())


def test_sequence_field_string_rejected(tmp_warehouse):
    schema = (Schema.builder()
              .column("k", BigIntType(False)).column("s", VarCharType())
              .primary_key("k")
              .options({"bucket": "1", "write-only": "true",
                        "sequence.field": "s"})
              .build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "ss"),
                                  schema)
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    with pytest.raises(ValueError):
        w.write_dicts([{"k": 1, "s": "a"}])
        wb.new_commit().commit(w.prepare_commit())



def agg_table(tmp_warehouse, columns, field_opts):
    b = Schema.builder().column("k", BigIntType(False))
    for name, typ in columns:
        b = b.column(name, typ)
    opts = {"bucket": "1", "write-only": "true",
            "merge-engine": "aggregation"}
    opts.update(field_opts)
    return FileStoreTable.create(os.path.join(tmp_warehouse, "t"),
                                 b.primary_key("k").options(opts).build())


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, row_kinds=kinds)
    wb.new_commit().commit(w.prepare_commit())
    w.close()


def test_rbm32_union(tmp_warehouse):
    t = agg_table(tmp_warehouse,
                  [("bits", VarBinaryType.bytes_type())],
                  {"fields.bits.aggregate-function": "rbm32"})
    commit(t, [{"k": 1, "bits": bytes(serialize_roaring32(
        np.array([1, 5, 9], np.uint32)))}])
    commit(t, [{"k": 1, "bits": bytes(serialize_roaring32(
        np.array([5, 100], np.uint32)))}])
    out = t.to_arrow().to_pylist()[0]
    assert deserialize_roaring32(out["bits"]).tolist() == [1, 5, 9, 100]


def test_rbm64_union(tmp_warehouse):
    t = agg_table(tmp_warehouse,
                  [("bits", VarBinaryType.bytes_type())],
                  {"fields.bits.aggregate-function": "rbm64"})
    big = 1 << 40
    commit(t, [{"k": 1, "bits": bytes(serialize_roaring64(
        np.array([3, big], np.uint64)))}])
    commit(t, [{"k": 1, "bits": bytes(serialize_roaring64(
        np.array([big, big + 7], np.uint64)))}])
    out = t.to_arrow().to_pylist()[0]
    assert deserialize_roaring64(out["bits"]).tolist() == \
        [3, big, big + 7]


def test_hll_sketch_merge_estimates(tmp_warehouse):
    t = agg_table(tmp_warehouse,
                  [("sk", VarBinaryType.bytes_type())],
                  {"fields.sk.aggregate-function": "hll_sketch"})
    a = hll_build(pa.array(range(0, 6000), pa.int64()))
    b = hll_build(pa.array(range(4000, 10000), pa.int64()))
    commit(t, [{"k": 1, "sk": a}])
    commit(t, [{"k": 1, "sk": b}])
    merged = t.to_arrow().to_pylist()[0]["sk"]
    est = hll_estimate(merged)
    assert abs(est - 10000) / 10000 < 0.05    # ~1.6% expected at p=12


def test_theta_sketch_merge_estimates(tmp_warehouse):
    t = agg_table(tmp_warehouse,
                  [("sk", VarBinaryType.bytes_type())],
                  {"fields.sk.aggregate-function": "theta_sketch"})
    a = theta_build(pa.array(range(0, 6000), pa.int64()))
    b = theta_build(pa.array(range(4000, 10000), pa.int64()))
    commit(t, [{"k": 1, "sk": a}])
    commit(t, [{"k": 1, "sk": b}])
    est = theta_estimate(t.to_arrow().to_pylist()[0]["sk"])
    assert abs(est - 10000) / 10000 < 0.08


def test_nested_update_append_and_keyed(tmp_warehouse):
    from paimon_tpu_torch.types import DataField
    row_t = RowType([DataField(100, "oid", BigIntType()),
                     DataField(101, "st", VarCharType.string_type())])
    t = agg_table(
        tmp_warehouse, [("orders", ArrayType(row_t))],
        {"fields.orders.aggregate-function": "nested_update",
         "fields.orders.nested-key": "oid"})
    commit(t, [{"k": 1, "orders": [{"oid": 1, "st": "new"},
                                   {"oid": 2, "st": "new"}]}])
    commit(t, [{"k": 1, "orders": [{"oid": 1, "st": "paid"}]}])
    out = t.to_arrow().to_pylist()[0]["orders"]
    assert out == [{"oid": 1, "st": "paid"}, {"oid": 2, "st": "new"}]


def test_nested_update_unkeyed_concats(tmp_warehouse):
    from paimon_tpu_torch.types import DataField
    row_t = RowType([DataField(100, "x", IntType())])
    t = agg_table(
        tmp_warehouse, [("vs", ArrayType(row_t))],
        {"fields.vs.aggregate-function": "nested_update"})
    commit(t, [{"k": 1, "vs": [{"x": 1}]}])
    commit(t, [{"k": 1, "vs": [{"x": 1}, {"x": 2}]}])
    assert t.to_arrow().to_pylist()[0]["vs"] == \
        [{"x": 1}, {"x": 1}, {"x": 2}]


def test_primary_key_agg_keeps_first(tmp_warehouse):
    t = agg_table(tmp_warehouse, [("v", IntType())],
                  {"fields.v.aggregate-function": "primary_key"})
    commit(t, [{"k": 1, "v": 10}])
    commit(t, [{"k": 1, "v": 99}])
    assert t.to_arrow().to_pylist()[0]["v"] == 10


def test_ignore_retract_sum(tmp_warehouse):
    from paimon_tpu_torch.types import RowKind
    t = agg_table(tmp_warehouse, [("a", IntType()), ("b", IntType())],
                  {"fields.a.aggregate-function": "sum",
                   "fields.b.aggregate-function": "sum",
                   "fields.b.ignore-retract": "true"})
    commit(t, [{"k": 1, "a": 10, "b": 10}])
    commit(t, [{"k": 1, "a": 3, "b": 3}],
           kinds=[RowKind.UPDATE_BEFORE])
    commit(t, [{"k": 1, "a": 1, "b": 1}])
    row = t.to_arrow().to_pylist()[0]
    assert row["a"] == 8          # 10 - 3 + 1
    assert row["b"] == 11         # retract ignored: 10 + 1


def test_ignore_retract_all_retract_is_null(tmp_warehouse):
    from paimon_tpu_torch.types import RowKind
    t = agg_table(tmp_warehouse, [("b", IntType())],
                  {"fields.b.aggregate-function": "sum",
                   "fields.b.ignore-retract": "true"})
    commit(t, [{"k": 1, "b": 5}], kinds=[RowKind.UPDATE_BEFORE])
    rows = t.to_arrow().to_pylist()
    assert rows == [] or rows[0]["b"] is None


def test_nested_update_bad_key_raises(tmp_warehouse):
    from paimon_tpu_torch.types import DataField
    row_t = RowType([DataField(100, "x", IntType())])
    t = agg_table(
        tmp_warehouse, [("vs", ArrayType(row_t))],
        {"fields.vs.aggregate-function": "nested_update",
         "fields.vs.nested-key": "xx"})
    commit(t, [{"k": 1, "vs": [{"x": 1}]}])
    commit(t, [{"k": 1, "vs": [{"x": 2}]}])
    with pytest.raises(ValueError, match="nested-key"):
        t.to_arrow()


# -- config 4's shape: aggregation sum/max, ORC at level 0, parquet above -----

CONFIG4 = {"bucket": "1", "write-only": "true",
           "parquet.enable.dictionary": "false",
           "merge-engine": "aggregation",
           "fields.v1.aggregate-function": "sum",
           "fields.v2.aggregate-function": "max",
           "fields.v3.aggregate-function": "max",
           "file.format": "parquet", "file.format.per.level": "0:orc"}
STREAMED = {"tpu.merge.stream-threshold-rows": "2048",
            "tpu.merge.chunk-rows": "512"}


def config4_schema(schema_cls, types, extra):
    return (schema_cls.builder().column("id", types.BigIntType(False))
            .column("v1", types.BigIntType()).column("v2", types.DoubleType())
            .column("v3", types.IntType()).primary_key("id")
            .options({**CONFIG4, **extra}).build())


def config4_runs(seed=7, rows=6000, runs=3):
    """bench.py's config-4 batches at a small size."""
    rng = np.random.default_rng(seed)
    per = rows // runs
    return [pa.table({
        "id": pa.array(rng.integers(0, rows // 2, per), pa.int64()),
        "v1": pa.array(rng.integers(0, 1 << 40, per), pa.int64()),
        "v2": pa.array(rng.random(per), pa.float64()),
        "v3": pa.array(rng.integers(0, 100, per).astype(np.int32),
                       pa.int32())}) for _ in range(runs)]


def config4_oracle(runs):
    """Per id: sum of v1, max of v2 and v3, in id order (numpy)."""
    allt = pa.concat_tables(runs)
    ids = allt.column("id").to_numpy()
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    col = {c: allt.column(c).to_numpy()[order] for c in ("v1", "v2", "v3")}
    return pa.table({
        "id": pa.array(s[starts], pa.int64()),
        "v1": pa.array(np.add.reduceat(col["v1"], starts), pa.int64()),
        "v2": pa.array(np.maximum.reduceat(col["v2"], starts), pa.float64()),
        "v3": pa.array(np.maximum.reduceat(col["v3"], starts), pa.int32())})


def write_batches(table, batches):
    for b in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write_arrow(b)
        wb.new_commit().commit(w.prepare_commit())
        w.close()


def file_formats(table):
    return sorted({(f.level, f.file_name.rsplit(".", 1)[-1])
                   for s in table.new_scan().plan().splits
                   for f in s.data_files})


@pytest.mark.parametrize("extra", [{}, STREAMED], ids=["one-shot",
                                                       "streamed"])
def test_config4_table_matches_reference(tmp_path, extra):
    import paimon_tpu.types as ref_types
    from paimon_tpu.schema import Schema as RefSchema
    from paimon_tpu.table import FileStoreTable as RefTable
    import paimon_tpu_torch.types as port_types

    runs = config4_runs()
    want = config4_oracle(runs)
    port = PortTable.create(str(tmp_path / "port"),
                            config4_schema(Schema, port_types, extra),
                            device="cpu")
    ref = RefTable.create(str(tmp_path / "ref"),
                          config4_schema(RefSchema, ref_types, extra))
    write_batches(port, runs)
    write_batches(ref, runs)
    assert file_formats(port) == [(0, "orc")]
    p_scan, r_scan = port.to_arrow(), ref.to_arrow()
    assert p_scan.sort_by("id").equals(want)
    assert p_scan.equals(r_scan)
    # each package reads the other's ORC level-0 runs
    assert PortTable.load(str(tmp_path / "ref"), device="cpu") \
        .to_arrow().equals(r_scan)
    assert RefTable.load(str(tmp_path / "port")).to_arrow().equals(p_scan)
    assert port.compact(full=True) is not None
    assert ref.compact(full=True) is not None
    assert file_formats(port) == [(5, "parquet")]
    p_back, r_back = port.to_arrow(), ref.to_arrow()
    assert p_back.sort_by("id").equals(want)
    assert p_back.equals(r_back)
    assert PortTable.load(str(tmp_path / "ref"), device="cpu") \
        .to_arrow().equals(r_back)
    assert RefTable.load(str(tmp_path / "port")).to_arrow().equals(p_back)


@pytest.mark.parametrize("engine, options, want", [
    ("aggregation", {"fields.v.aggregate-function": "sum"}, 3),
    ("partial-update", {}, 2)])
def test_level0_file_of_deferred_engine_is_rewritten(tmp_warehouse, engine,
                                                     options, want):
    """A flush under a deferred engine sorts but does not merge, so its
    one level-0 file holds both versions of key 1; full compaction must
    rewrite it, not promote it as is (a promoted file reads raw)."""
    schema = (Schema.builder().column("k", BigIntType(False))
              .column("v", IntType()).primary_key("k")
              .options({"bucket": "1", "write-only": "true",
                        "merge-engine": engine, **options}).build())
    table = FileStoreTable.create(os.path.join(tmp_warehouse, "t"), schema)
    _commit(table, [{"k": 1, "v": 1}, {"k": 1, "v": 2}])
    files = table.new_scan().plan().splits[0].data_files
    assert [(f.level, f.row_count) for f in files] == [(0, 2)]
    assert table.compact(full=True) is not None
    files = table.new_scan().plan().splits[0].data_files
    assert [(f.level, f.row_count) for f in files] == [(5, 1)]
    assert table.to_arrow().to_pylist() == [{"k": 1, "v": want}]
