"""The SQL front end of paimon_tpu_torch against paimon_tpu.

All cases of tests/test_sql.py (its test classes included) run on both
packages through tests/test_torch_append.py's `run_reference_case`, the
port's catalog and tables on the CPU.  The port refuses the search
procedures until index/fulltext.py and vector/ are ported (ROADMAP.md
A.8.9): its run of the one case that calls them checks the refusal.
Then one seeded SQL script (DDL, inserts, update, delete, merge,
compaction, a tag, time travel, group by, a join, a window) runs on both
packages, each statement's result table equal; and each package reads
the tables the other's script left.
"""

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu as ref_pkg
import paimon_tpu_torch as port_pkg
from paimon_tpu.sql import SQLContext as RefSQL
from paimon_tpu_torch.sql import SQLContext as PortSQL
from tests.test_torch_append import reference_cases, run_reference_case

CASES = reference_cases("test_sql", classes=True)
SEARCH = ("test_sql", "TestSearchProcedures.test_call_search_procedures")


def test_reference_cases_are_all_listed():
    assert len(CASES) == 136
    assert SEARCH in CASES


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, request, case, pkg):
    if pkg == "port" and case == SEARCH:
        with pytest.raises(NotImplementedError,
                           match=r"\(ROADMAP.md: A.8.9\)"):
            run_reference_case(case, pkg, tmp_path, monkeypatch, request)
        return
    run_reference_case(case, pkg, tmp_path, monkeypatch, request)


@pytest.mark.parametrize("call", [
    "CALL sys.full_text_search('docs', 'title', 'tpu', 2)",
    "CALL sys.vector_search('docs', 'emb', '1.0,0.05', 1)",
    "CALL sys.hybrid_search('docs', 'emb', '0.9,0.1', 'title', 'tpu', 2)",
    "CALL sys.create_vector_index('docs', 'emb')"])
def test_search_procedures_refuse_naming_their_item(tmp_path, call):
    cat = port_pkg.create_catalog({"warehouse": str(tmp_path / "wh")},
                                  device="cpu")
    cat.create_database("default")
    ctx = PortSQL(cat)
    ctx.sql("CREATE TABLE docs (id BIGINT NOT NULL, title STRING, "
            "emb ARRAY<FLOAT>, PRIMARY KEY (id)) WITH ('bucket' = '1')")
    with pytest.raises(NotImplementedError,
                       match=r"\(ROADMAP.md: A.8.9\)"):
        ctx.sql(call)


# -- one seeded script on both packages --------------------------------------

def _staged(seed, n, id_range, unique=False):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(id_range)[:n] if unique else \
        rng.integers(0, id_range, n)
    return pa.table({
        "id": pa.array(ids, pa.int64()),
        "v1": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        "v2": pa.array(rng.random(n)),
        "v3": pa.array(rng.integers(0, 100, n), pa.int32())})


def _regions():
    rng = np.random.default_rng(11)
    return pa.table({"v3": pa.array(np.arange(100), pa.int32()),
                     "name": pa.array([f"r{i % 7}" for i in range(100)]),
                     "weight": pa.array(rng.random(100))})


SCRIPT = [
    "CREATE DATABASE shop",
    "CREATE TABLE shop.orders (id BIGINT NOT NULL, v1 BIGINT, v2 DOUBLE, "
    "v3 INT, PRIMARY KEY (id) NOT ENFORCED) WITH ('bucket' = '2')",
    "CREATE TABLE shop.regions (v3 INT NOT NULL, name STRING, "
    "weight DOUBLE, PRIMARY KEY (v3) NOT ENFORCED) WITH ('bucket' = '1')",
    "CREATE TABLE shop.totals (v3 INT NOT NULL, v1 BIGINT, v2 DOUBLE, "
    "PRIMARY KEY (v3) NOT ENFORCED) WITH ('bucket' = '1', "
    "'merge-engine' = 'aggregation', 'fields.v1.aggregate-function' = "
    "'sum', 'fields.v2.aggregate-function' = 'max')",
    "INSERT INTO shop.regions SELECT * FROM regions_src",
    "INSERT INTO shop.orders SELECT * FROM staged0",
    "INSERT INTO shop.orders SELECT * FROM staged1",
    "INSERT INTO shop.totals SELECT v3, v1, v2 FROM staged0",
    "INSERT INTO shop.totals SELECT v3, v1, v2 FROM staged1",
    "SELECT count(*) AS n, sum(v1) AS s FROM shop.orders",
    "SELECT * FROM shop.orders WHERE id BETWEEN 100 AND 400 ORDER BY id",
    "UPDATE shop.orders SET v1 = v1 + 1 WHERE v3 = 42",
    "DELETE FROM shop.orders WHERE id < 300",
    "MERGE INTO shop.orders t USING merge_src s ON t.id = s.id "
    "WHEN MATCHED THEN UPDATE SET v1 = s.v1, v2 = s.v2 "
    "WHEN NOT MATCHED THEN INSERT VALUES (s.id, s.v1, s.v2, s.v3)",
    "CALL sys.create_tag('shop.orders', 'pre_compact')",
    "CALL sys.compact('shop.orders', true)",
    "CALL sys.compact('shop.totals', true)",
    "INSERT INTO shop.orders VALUES (5000000, 7, 0.5, 1)",
    "SELECT count(*) AS n, sum(v1) AS s FROM shop.orders "
    "VERSION AS OF 'pre_compact'",
    "SELECT count(*) AS n, sum(v1) AS s FROM shop.orders",
    "SELECT v3, count(*) AS n, sum(v1) AS s, max(v2) AS m "
    "FROM shop.orders GROUP BY v3 ORDER BY v3",
    "SELECT r.name, count(*) AS n, sum(o.v1) AS s FROM shop.orders o "
    "JOIN shop.regions r ON o.v3 = r.v3 GROUP BY r.name ORDER BY r.name",
    "SELECT * FROM shop.totals ORDER BY v3",
    "SELECT id, v1, row_number() OVER (PARTITION BY v3 ORDER BY id) AS rn "
    "FROM shop.orders WHERE v3 < 3 ORDER BY v3, id",
    "SELECT snapshot_id, commit_kind, total_record_count "
    "FROM shop.orders$snapshots ORDER BY snapshot_id",
    "SELECT database_name, table_name, record_count FROM sys.all_tables "
    "ORDER BY table_name",
]


def _run_script(sql_cls, catalog):
    ctx = sql_cls(catalog)
    ctx.register("regions_src", _regions())
    ctx.register("staged0", _staged(7, 3000, 4000))
    ctx.register("staged1", _staged(8, 3000, 4000))
    ctx.register("merge_src", _staged(9, 800, 8000, unique=True))
    return [ctx.sql(stmt).to_pylist() for stmt in SCRIPT]


def test_one_script_gives_equal_results_in_both(tmp_path):
    port = _run_script(PortSQL, port_pkg.create_catalog(
        {"warehouse": str(tmp_path / "port")}, device="cpu"))
    ref = _run_script(RefSQL, ref_pkg.create_catalog(
        {"warehouse": str(tmp_path / "ref")}))
    for stmt, p, r in zip(SCRIPT, port, ref):
        assert p == r, stmt
    # the script really moved rows
    assert port[SCRIPT.index("SELECT count(*) AS n, sum(v1) AS s "
                             "FROM shop.orders")][0]["n"] > 2000


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_script_tables(tmp_path, writer):
    wh = {"warehouse": str(tmp_path / "wh")}
    port_cat = port_pkg.create_catalog(wh, device="cpu")
    ref_cat = ref_pkg.create_catalog(wh)
    if writer == "port":
        _run_script(PortSQL, port_cat)
    else:
        _run_script(RefSQL, ref_cat)
    queries = [
        "SELECT * FROM shop.orders ORDER BY id",
        "SELECT * FROM shop.totals ORDER BY v3",
        "SELECT * FROM shop.orders VERSION AS OF 'pre_compact' ORDER BY id",
        "SELECT r.name, sum(o.v1) AS s FROM shop.orders o JOIN "
        "shop.regions r ON o.v3 = r.v3 GROUP BY r.name ORDER BY r.name"]
    for q in queries:
        assert PortSQL(port_cat).sql(q).to_pylist() == \
            RefSQL(ref_cat).sql(q).to_pylist(), q
    # the reading package writes on, and the writer reads that back
    reader_sql = RefSQL(ref_cat) if writer == "port" else PortSQL(port_cat)
    reader_sql.sql("UPDATE shop.orders SET v2 = 0.0 WHERE v3 = 5")
    reader_sql.sql("CALL sys.compact('shop.orders', true)")
    q = "SELECT count(*) AS n, sum(v2) AS s FROM shop.orders WHERE v3 = 5"
    assert PortSQL(port_cat).sql(q).to_pylist() == \
        RefSQL(ref_cat).sql(q).to_pylist()
    assert PortSQL(port_cat).sql(q).to_pylist()[0]["s"] == 0.0


# -- every merge engine through SQL, and projected reads ---------------------

ENGINES = {
    "deduplicate": "'bucket' = '2'",
    "sequence-field": "'bucket' = '2', 'sequence.field' = 'ts'",
    "first-row": "'bucket' = '2', 'merge-engine' = 'first-row'",
    "aggregation": "'bucket' = '2', 'merge-engine' = 'aggregation', "
                   "'fields.v.aggregate-function' = 'sum', "
                   "'fields.g.aggregate-function' = 'max'",
    "partial-update": "'bucket' = '2', 'merge-engine' = 'partial-update', "
                      "'fields.g.sequence-group' = 'v'",
    "deletion-vectors": "'bucket' = '2', "
                        "'deletion-vectors.enabled' = 'true'"}


def _engine_script(sql_cls, catalog, options):
    ctx = sql_cls(catalog)
    ctx.sql("CREATE DATABASE db")
    ctx.sql("CREATE TABLE db.t (id BIGINT NOT NULL, ts BIGINT, v BIGINT, "
            f"g BIGINT, PRIMARY KEY (id) NOT ENFORCED) WITH ({options})")
    rng = np.random.default_rng(13)
    for _ in range(4):
        n = 500
        ctx.register("s", pa.table({
            c: pa.array(rng.integers(0, 300 if c == "id" else 1000, n),
                        pa.int64()) for c in ("id", "ts", "v", "g")}))
        ctx.sql("INSERT INTO db.t SELECT * FROM s")
    queries = ["SELECT id, v FROM db.t ORDER BY id",
               "SELECT count(*) AS n FROM db.t",
               "SELECT g, count(*) AS n, sum(v) AS s FROM db.t "
               "WHERE id > 40 GROUP BY g ORDER BY g LIMIT 20"]
    out = [ctx.sql(q).to_pylist() for q in queries]
    ctx.sql("CALL sys.compact('db.t', true)")
    return out + [ctx.sql(q).to_pylist() for q in queries]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_through_sql_equal_the_reference(tmp_path, engine):
    """Projections, counts and filtered groups of every merge engine
    read equal in both packages, before and after compaction."""
    port = _engine_script(PortSQL, port_pkg.create_catalog(
        {"warehouse": str(tmp_path / "port")}, device="cpu"),
        ENGINES[engine])
    ref = _engine_script(RefSQL, ref_pkg.create_catalog(
        {"warehouse": str(tmp_path / "ref")}), ENGINES[engine])
    assert port == ref


@pytest.mark.parametrize("engine", ["aggregation", "partial-update"])
def test_projected_table_reads_of_folding_engines(tmp_path, engine):
    """A projected to_arrow of an aggregation or partial-update table
    equals the full read's columns (the reference raises KeyError for a
    column the merge folds but the projection leaves out: ROADMAP C)."""
    cat = port_pkg.create_catalog({"warehouse": str(tmp_path / "wh")},
                                  device="cpu")
    _engine_script(PortSQL, cat, ENGINES[engine])
    PortSQL(cat).sql("INSERT INTO db.t VALUES (1, 5, 6, 7), (500, 1, 2, 3)")
    t = cat.get_table("db.t")
    full = t.to_arrow().sort_by("id")
    for cols in (["id", "v"], ["v"], ["id", "ts"]):
        got = t.to_arrow(projection=cols)
        assert got.column_names == cols
        assert sorted(map(str, got.to_pylist())) == \
            sorted(map(str, full.select(cols).to_pylist()))
    ref_t = ref_pkg.create_catalog({"warehouse": str(tmp_path / "wh")}) \
        .get_table("db.t")
    with pytest.raises(KeyError):
        ref_t.to_arrow(projection=["id", "v"])
