"""Catalogs of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_catalog.py and tests/test_rest_catalog.py, and
the two privilege cases of tests/test_aux_planes.py, run on both
packages through tests/test_torch_append.py's `run_reference_case`: the
reference's source, once as written and once with its imports pointed
at the port, whose catalogs (`create_catalog`, `FileSystemCatalog`,
`JdbcCatalog`, `RESTCatalogClient`) and tables open on the CPU.  Then
each package lists, reads and drops the warehouse, views and functions
the other wrote, and reads the JDBC catalog's sqlite file the other
wrote.  Every value compared is a name, a stored definition or a table
row, so equality is exact.
"""

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu as ref_pkg
import paimon_tpu_torch as port_pkg
from paimon_tpu.sql import SQLContext as RefSQL
from paimon_tpu_torch.sql import SQLContext as PortSQL
from tests.test_torch_append import reference_cases, run_reference_case

CASES = (reference_cases("test_catalog")
         + reference_cases("test_rest_catalog")
         + [("test_aux_planes", "test_privileges"),
            ("test_aux_planes", "test_privileged_table_blocks_writes")])


def test_reference_cases_are_all_listed():
    assert len(CASES) == 6 + 7 + 2


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[f"{f}.{c}" for f, c in CASES])
def test_reference_case(tmp_path, monkeypatch, request, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch, request)


def test_catalogs_take_an_explicit_device(tmp_path):
    """Every catalog holds its device, its tables open there, and no
    catalog option names it."""
    wh = str(tmp_path / "wh")
    cat = port_pkg.create_catalog({"warehouse": wh}, device="cpu")
    assert cat.device.type == "cpu"
    cat.create_database("db")
    t = cat.create_table("db.t", _port_schema())
    assert t.device.type == "cpu"
    assert cat.get_table("db.t").device.type == "cpu"
    assert PortSQL(cat).device.type == "cpu"
    from paimon_tpu_torch.catalog.jdbc import JdbcCatalog
    jdbc = JdbcCatalog(str(tmp_path / "c.db"), wh, device="cpu")
    assert jdbc.device.type == "cpu"
    jdbc.close()


# -- each package reads the other's catalog ---------------------------------

def _port_schema():
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType
    return (Schema.builder().column("id", BigIntType(False))
            .column("v", DoubleType()).column("q", IntType())
            .primary_key("id").options({"bucket": "2"}).build())


def _ref_schema():
    from paimon_tpu import Schema
    from paimon_tpu.types import BigIntType, DoubleType, IntType
    return (Schema.builder().column("id", BigIntType(False))
            .column("v", DoubleType()).column("q", IntType())
            .primary_key("id").options({"bucket": "2"}).build())


class Pkg:
    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.kw = {"device": "cpu"} if port else {}
        self.create_catalog = port_pkg.create_catalog if port \
            else ref_pkg.create_catalog
        self.schema = _port_schema if port else _ref_schema
        self.SQL = PortSQL if port else RefSQL
        if port:
            from paimon_tpu_torch.catalog.function import Function
            from paimon_tpu_torch.catalog.view import View
        else:
            from paimon_tpu.catalog.function import Function
            from paimon_tpu.catalog.view import View
        self.View, self.Function = View, Function

    def catalog(self, options):
        return self.create_catalog(options, **self.kw)


PAIRS = [("port", "reference"), ("reference", "port")]


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return pa.table({"id": pa.array(rng.permutation(4 * n)[:n], pa.int64()),
                     "v": pa.array(rng.random(n)),
                     "q": pa.array(rng.integers(0, 10, n), pa.int32())})


def _fill(pkg, cat):
    """A warehouse with two databases, two tables, a view and a SQL
    function, written through `pkg`'s SQL and catalog API."""
    ctx = pkg.SQL(cat)
    ctx.sql("CREATE DATABASE shop")
    ctx.sql("CREATE DATABASE misc")
    ctx.sql("CREATE TABLE shop.orders (id BIGINT NOT NULL, v DOUBLE, "
            "q INT, PRIMARY KEY (id) NOT ENFORCED) WITH ('bucket' = '2')")
    ctx.register("staged", _rows(3, 500))
    ctx.sql("INSERT INTO shop.orders SELECT * FROM staged")
    ctx.sql("UPDATE shop.orders SET v = v + 1 WHERE q = 3")
    cat.create_table("misc.t", pkg.schema())
    ctx.sql("CREATE VIEW shop.big AS SELECT id, v FROM shop.orders "
            "WHERE q > 5")
    ctx.sql("CREATE FUNCTION shop.scaled (x DOUBLE, n INT) "
            "RETURNS DOUBLE AS 'x * n'")
    cat.create_view("misc.plain", pkg.View("SELECT 1 AS one",
                                            comment="c",
                                            options={"k": "v"}))


def _observe(pkg, cat):
    ctx = pkg.SQL(cat, database="shop")
    return {
        "databases": cat.list_databases(),
        "tables": {d: cat.list_tables(d) for d in cat.list_databases()},
        "views": {d: cat.list_views(d) for d in cat.list_databases()},
        "functions": {d: cat.list_functions(d)
                      for d in cat.list_databases()},
        "view_def": [(cat.get_view(n).query, cat.get_view(n).comment,
                      cat.get_view(n).options)
                     for n in ("shop.big", "misc.plain")],
        "fn_def": cat.get_function("shop.scaled").to_json(),
        "orders": cat.get_table("shop.orders").to_arrow()
        .sort_by("id").to_pylist(),
        "via_view": ctx.sql("SELECT * FROM big ORDER BY id").to_pylist(),
        "via_fn": ctx.sql("SELECT id, scaled(v, q) AS s FROM orders "
                          "ORDER BY id").to_pylist(),
    }


@pytest.mark.parametrize("writer, reader", PAIRS)
def test_each_package_reads_and_drops_the_others_warehouse(
        tmp_path, writer, reader):
    w, r = Pkg(writer), Pkg(reader)
    wh = {"warehouse": str(tmp_path / "wh")}
    wcat = w.catalog(wh)
    _fill(w, wcat)
    assert _observe(r, r.catalog(wh)) == _observe(w, wcat)
    # the reader drops what the writer made; the writer sees it gone
    rcat = r.catalog(wh)
    rcat.drop_view("shop.big")
    rcat.drop_function("shop.scaled")
    rcat.drop_view("misc.plain")
    rcat.drop_table("shop.orders")
    rcat.drop_database("misc", cascade=True)
    wcat = w.catalog(wh)
    assert wcat.list_databases() == ["shop"]
    assert (wcat.list_tables("shop"), wcat.list_views("shop"),
            wcat.list_functions("shop")) == ([], [], [])


@pytest.mark.parametrize("writer, reader", PAIRS)
def test_jdbc_catalog_file_reads_across_packages(tmp_path, writer, reader):
    """A JDBC catalog's sqlite file and warehouse written by one package
    are listed, read, renamed and dropped by the other."""
    w, r = Pkg(writer), Pkg(reader)
    opts = {"metastore": "jdbc", "uri": str(tmp_path / "catalog.db"),
            "warehouse": str(tmp_path / "wh")}
    wcat = w.catalog(opts)
    wcat.create_database("db", properties={"owner": "x"})
    t = wcat.create_table("db.t", w.schema())
    data = _rows(5, 300)
    wb = t.new_batch_write_builder()
    with wb.new_write() as wr:
        wr.write_arrow(data)
        wb.new_commit().commit(wr.prepare_commit())
    wcat.close()
    rcat = r.catalog(opts)
    assert rcat.list_databases() == ["db"]
    assert rcat.load_database_properties("db") == {"owner": "x"}
    assert rcat.list_tables("db") == ["t"]
    assert rcat.get_table("db.t").to_arrow().sort_by("id").to_pylist() \
        == data.sort_by("id").to_pylist()
    rcat.rename_table("db.t", "db.u")
    rcat.close()
    wcat = w.catalog(opts)
    assert wcat.list_tables("db") == ["u"]
    assert wcat.get_table("db.u").to_arrow().num_rows == 300
    wcat.drop_database("db", cascade=True)
    wcat.close()
    rcat = r.catalog(opts)
    assert rcat.list_databases() == []
    rcat.close()
