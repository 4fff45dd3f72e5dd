"""CDC ingest of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_cdc.py run on both packages (the reference's
source, once as written and once pointed at the port, its tables on the
CPU).  Seeded change streams rendered in the six envelope formats parse
to the reference's (row, kind) pairs; the same events through each
package's CdcSinkWriter give row-identical tables that each package
reads, equal schema files after evolution (an unseen column, an INT
widened to BIGINT) and equal snapshot properties, identifiers and kinds;
CdcDatabaseSync routes a mixed stream into equal tables and schemas.
Every value compared is a row, a schema field or a property, so
equality is exact.
"""

import json
import os

import numpy as np
import pytest

import paimon_tpu.cdc.formats as ref_formats
import paimon_tpu_torch.cdc.formats as port_formats
from paimon_tpu.catalog import create_catalog as ref_create_catalog
from paimon_tpu.cdc import CdcDatabaseSync as RefDatabaseSync
from paimon_tpu.cdc import CdcSinkWriter as RefSinkWriter
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import IntType as RefInt
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch.catalog import create_catalog
from paimon_tpu_torch.cdc import CdcDatabaseSync, CdcSinkWriter
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, IntType, VarCharType
from tests.test_torch_append import reference_cases, run_reference_case

FORMATS = ("debezium", "canal", "maxwell", "ogg", "dms", "aliyun")

# -- the reference's cases on both packages -----------------------------------

CASES = reference_cases("test_cdc", classes=True)


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


# -- seeded change streams in every envelope format ---------------------------

NAMES = ["ada", "bo", "cy", "di", "ed", "flo", "gus", "hal"]


def seeded_changes(seed: int, n: int, keys: int = 64, wide_from=None):
    """n logical changes (op, before, after) over `keys` ids: inserts of
    unseen ids, updates of live ones and 15% deletes.  From change
    `wide_from` on, rows carry an unseen `city` column and `qty` values
    past INT."""
    rng = np.random.default_rng(seed)
    live = {}
    out = []
    for i in range(n):
        k = int(rng.integers(keys))
        row = {"id": k, "name": NAMES[int(rng.integers(len(NAMES)))],
               "amount": round(float(rng.random() * 1000), 2),
               "qty": int(rng.integers(1, 100))}
        if wide_from is not None and i >= wide_from:
            row["city"] = NAMES[int(rng.integers(len(NAMES)))].upper()
            row["qty"] = int(rng.integers(1, 100)) << 33
        if k in live and rng.random() < 0.15:
            out.append(("d", live.pop(k), None))
        elif k in live:
            out.append(("u", live[k], row))
            live[k] = row
        else:
            out.append(("c", None, row))
            live[k] = row
    return out


def _changed(before, after):
    return {c: v for c, v in before.items() if after.get(c) != v}


def render(fmt: str, op: str, before, after, meta=None) -> list:
    """One logical change as `fmt`'s envelopes (aliyun sends an update
    as two events).  `meta` adds routing fields (database, table)."""
    meta = meta or {}
    if fmt == "debezium":
        ev = {"op": op}
        if before is not None:
            ev["before"] = before
        if after is not None:
            ev["after"] = after
        if meta:
            return [{"payload": {**ev, "source": {
                "db": meta["database"], "table": meta["table"]}}}]
        return [ev]
    if fmt == "canal":
        typ = {"c": "INSERT", "u": "UPDATE", "d": "DELETE"}[op]
        ev = {"type": typ, "data": [after if op != "d" else before],
              **meta}
        if op == "u":
            ev["old"] = [_changed(before, after)]
        if meta:
            ev["pkNames"] = ["id"]
        return [ev]
    if fmt == "maxwell":
        typ = {"c": "insert", "u": "update", "d": "delete"}[op]
        ev = {"type": typ, "data": after if op != "d" else before, **meta}
        if op == "u":
            ev["old"] = _changed(before, after)
        if meta:
            ev["primary_key_columns"] = ["id"]
        return [ev]
    if fmt == "ogg":
        ev = {"op_type": {"c": "I", "u": "U", "d": "D"}[op]}
        if before is not None:
            ev["before"] = before
        if after is not None:
            ev["after"] = after
        return [ev]
    if fmt == "dms":
        operation = {"c": "insert", "u": "update", "d": "delete"}[op]
        data = dict(after if op != "d" else before)
        if op == "u":
            data.update({f"BI_{c}": v
                         for c, v in _changed(before, after).items()})
        return [{"data": data, "metadata": {"record-type": "data",
                                            "operation": operation}}]
    if fmt == "aliyun":
        if op == "c":
            return [{"op": "INSERT",
                     "payload": {"after": {"dataColumn": after}}}]
        if op == "d":
            return [{"op": "DELETE",
                     "payload": {"before": {"dataColumn": before}}}]
        return [{"op": "UPDATE_BEFORE",
                 "payload": {"before": {"dataColumn": before}}},
                {"op": "UPDATE_AFTER",
                 "payload": {"after": {"dataColumn": after}}}]
    raise ValueError(fmt)


def seeded_events(fmt: str, seed: int, n: int, **kw) -> list:
    return [ev for op, b, a in seeded_changes(seed, n, **kw)
            for ev in render(fmt, op, b, a)]


@pytest.mark.parametrize("fmt", FORMATS)
def test_parsers_equal_reference(fmt):
    events = seeded_events(fmt, seed=11 + FORMATS.index(fmt), n=500)
    assert len(events) >= 500
    port = getattr(port_formats, f"parse_{fmt}")
    ref = getattr(ref_formats, f"parse_{fmt}")
    for ev in events:
        assert port(ev) == ref(ev)
    kinds = {k for ev in events for _, k in port(ev)}
    assert kinds == {0, 1, 2, 3}


# -- the sink on both packages ------------------------------------------------

class Pkg:
    def __init__(self, name, schema, table, sink, types, kwargs):
        self.name, self.Schema, self.Table, self.Sink = \
            name, schema, table, sink
        self.BigInt, self.Double, self.Int, self.VarChar = types
        self.kw = kwargs

    def create(self, path, opts):
        schema = (self.Schema.builder()
                  .column("id", self.BigInt(False))
                  .column("name", self.VarChar.string_type())
                  .column("amount", self.Double())
                  .column("qty", self.Int())
                  .primary_key("id").options(opts).build())
        return self.Table.create(path, schema, **self.kw)

    def load(self, path):
        return self.Table.load(path, **self.kw)


PORT = Pkg("port", Schema, FileStoreTable, CdcSinkWriter,
           (BigIntType, DoubleType, IntType, VarCharType), {"device": "cpu"})
REF = Pkg("reference", RefSchema, RefTable, RefSinkWriter,
          (RefBigInt, RefDouble, RefInt, RefVarChar), {})


def rows_of(table):
    return sorted(table.to_arrow().to_pylist(), key=lambda r: r["id"])


def schema_files(path):
    """{schema-N: its JSON without the creation time}."""
    out = {}
    d = os.path.join(path, "schema")
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            doc = json.load(f)
        doc.pop("timeMillis", None)
        out[name] = doc
    return out


def snapshot_marks(table):
    return [(s.id, s.commit_user, s.commit_identifier, s.commit_kind,
             s.properties, s.delta_record_count)
            for s in table.snapshot_manager.snapshots()]


def sink_run(pkg, path, fmt, events, chunks=4, opts=None):
    table = pkg.create(path, {"bucket": "2", **(opts or {})})
    sink = pkg.Sink(table, format=fmt, commit_user="cdc-test")
    step = -(-len(events) // chunks)
    for c in range(chunks):
        sink.write_events(events[c * step:(c + 1) * step])
        sink.commit(c + 1, properties={"stream.source.offset":
                                       str(min(len(events),
                                               (c + 1) * step) - 1)})
    sink.close()
    return pkg.load(path)


@pytest.mark.parametrize("fmt", FORMATS)
def test_sink_tables_equal_reference_and_cross_read(tmp_path, fmt):
    # an unseen column and INT -> BIGINT arrive in the third quarter
    events = seeded_events(fmt, seed=3, n=400, wide_from=250)
    port = sink_run(PORT, str(tmp_path / "port"), fmt, events)
    ref = sink_run(REF, str(tmp_path / "ref"), fmt, events)
    want = rows_of(ref)
    assert want and "city" in want[0]
    assert rows_of(port) == want
    # each package reads the other's table
    assert rows_of(REF.load(port.path)) == want
    assert rows_of(PORT.load(ref.path)) == want
    assert schema_files(port.path) == schema_files(ref.path)
    assert len(schema_files(port.path)) >= 2
    by = {f.name: f.type.root for f in port.schema.fields}
    assert by["qty"] == "BIGINT" and by["city"] == "VARCHAR"
    assert snapshot_marks(port) == snapshot_marks(ref)


@pytest.mark.parametrize("fmt", FORMATS)
def test_each_format_equals_the_debezium_table(tmp_path, fmt):
    """The same changes in any envelope give the Debezium table."""
    changes = seeded_changes(seed=5, n=300)
    events = [ev for op, b, a in changes for ev in render(fmt, op, b, a)]
    deb = [ev for op, b, a in changes for ev in render("debezium", op, b, a)]
    got = sink_run(PORT, str(tmp_path / fmt), fmt, events, chunks=3)
    want = sink_run(PORT, str(tmp_path / "deb"), "debezium", deb, chunks=3)
    assert rows_of(got) == rows_of(want)


def test_computed_partition_equals_reference(tmp_path):
    specs = ["dt=date_format(ts, yyyy-MM-dd)", "y=year(ts)",
             "up=upper(name)", "b=truncate(id, 10)"]
    rng = np.random.default_rng(9)
    events = [{"op": "c", "after": {
        "id": i, "name": NAMES[i % len(NAMES)],
        "ts": 1_700_000_000_000 + int(rng.integers(0, 10 * 86_400_000))}}
        for i in range(200)]
    out = {}
    for pkg in (PORT, REF):
        schema = (pkg.Schema.builder().column("id", pkg.BigInt(False))
                  .column("name", pkg.VarChar.string_type())
                  .column("ts", pkg.BigInt())
                  .column("dt", pkg.VarChar.string_type())
                  .primary_key("id", "dt").partition_keys("dt")
                  .options({"bucket": "1"}).build())
        t = pkg.Table.create(str(tmp_path / pkg.name), schema, **pkg.kw)
        sink = pkg.Sink(t, computed_columns=specs)
        sink.write_events(events)
        sink.commit(1)
        sink.close()
        t = pkg.load(t.path)
        out[pkg.name] = (rows_of(t), schema_files(t.path),
                         sorted(os.listdir(t.path)))
    assert out["port"] == out["reference"]
    assert len({r["dt"] for r in out["port"][0]}) >= 5


# -- database sync on both packages -------------------------------------------

def db_events(fmt, seed, n=120):
    """Three tables of one database plus a foreign database's table,
    interleaved in order; `orders` gains a column and widens `qty` in
    the second half."""
    streams = []
    for t, name in enumerate(("users", "orders", "items")):
        wide = n * 2 // 3 if name == "orders" else None
        streams.append([ev for op, b, a in seeded_changes(
            seed + t, n, wide_from=wide) for ev in render(
                fmt, op, b, a, {"database": "appdb", "table": name})])
    streams.append([ev for op, b, a in seeded_changes(seed + 9, n)
                    for ev in render(fmt, op, b, a, {
                        "database": "otherdb", "table": "users"})])
    out = []
    for i in range(max(map(len, streams))):
        out.extend(s[i] for s in streams if i < len(s))
    return out


@pytest.mark.parametrize("fmt", ["maxwell", "canal", "debezium"])
def test_database_sync_equals_reference(tmp_path, fmt):
    events = db_events(fmt, seed=21)
    got = {}
    for name, make, sync_cls, kw in (
            ("port", create_catalog, CdcDatabaseSync, {"device": "cpu"}),
            ("reference", ref_create_catalog, RefDatabaseSync, {})):
        wh = str(tmp_path / name)
        catalog = make({"warehouse": wh}, **kw)
        sync = sync_cls(catalog, "appdb", format=fmt,
                        excluding_tables="items",
                        primary_keys={"users": ["id"], "orders": ["id"],
                                      "items": ["id"]})
        half = len(events) // 2
        sync.write_events(events[:half])
        sync.commit(1)
        sync.write_events(events[half:])
        sync.commit(2)
        tables = sync.tables()
        sync.close()
        got[name] = {
            t: (rows_of(catalog.get_table(f"appdb.{t}")),
                schema_files(os.path.join(wh, "appdb.db", t)))
            for t in tables}
        got[name]["_tables"] = tables
        assert not catalog.table_exists("appdb.items")
        assert "otherdb" not in catalog.list_databases()
    assert got["port"] == got["reference"]
    assert got["port"]["_tables"] == ["orders", "users"]
    assert len(got["port"]["orders"][1]) >= 2


def test_columnar_type_inference_equals_reference():
    """The sink infers a column's type from the set of its values' types;
    on seeded mixes of JSON and Python values that equals the reference's
    value-by-value `_infer_type`."""
    import datetime
    import decimal

    from paimon_tpu.cdc.sink import _infer_type as ref_infer
    from paimon_tpu_torch.cdc.sink import _infer_type
    pool = [None, True, False, 0, 7, 1 << 40, 1.5, -0.0,
            decimal.Decimal("2.5"), "x", "", datetime.datetime(2024, 1, 1),
            datetime.date(2024, 1, 1), {"a": 1}, [1]]
    rng = np.random.default_rng(17)
    for _ in range(500):
        vals = [pool[i] for i in rng.integers(0, len(pool),
                                              int(rng.integers(1, 6)))]
        assert str(_infer_type(vals)) == str(ref_infer(vals)), vals


def test_properties_provider_stamps_each_commit_as_reference(tmp_path):
    """The sink's `properties_provider` is evaluated once per commit
    attempt and merged under the explicit properties, in both
    packages."""
    got = {}
    for pkg in (PORT, REF):
        table = pkg.create(str(tmp_path / pkg.name), {"bucket": "1"})
        sink = pkg.Sink(table, commit_user="stamped")
        calls = []
        sink.properties_provider = lambda: (
            calls.append(1) or {"lease": str(len(calls)),
                                "stream.source.offset": "stale"})
        for c in (1, 2):
            sink.write_events(seeded_events("debezium", seed=c, n=20))
            sink.commit(c, properties={"stream.source.offset": str(c)})
        sink.close()
        got[pkg.name] = [s.properties for s in
                         pkg.load(table.path).snapshot_manager.snapshots()]
    assert got["port"] == got["reference"] == [
        {"lease": "1", "stream.source.offset": "1"},
        {"lease": "2", "stream.source.offset": "2"}]
