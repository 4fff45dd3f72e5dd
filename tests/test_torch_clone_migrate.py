"""Clone and migrate of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_clone.py and tests/test_migrate.py run on both
packages through tests/test_torch_append.py's `run_reference_case`, the
port's catalog and tables on the CPU.  Then a clone (of a compacted
primary-key table with an L0 file over it and deletion vectors) and a
migration (of a hive-style parquet and an ORC directory) made by one
package read equal in the other, schemas, snapshots and rows.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

import paimon_tpu as ref_pkg
import paimon_tpu_torch as port_pkg
from paimon_tpu.maintenance.clone import clone_table as ref_clone
from paimon_tpu.maintenance.migrate import migrate_table as ref_migrate
from paimon_tpu_torch.maintenance.clone import clone_table as port_clone
from paimon_tpu_torch.maintenance.migrate import migrate_table as port_migrate
from tests.test_torch_append import reference_cases, run_reference_case
from tests.test_torch_dynamic_bucket import PORT, REF

CASES = (reference_cases("test_clone", classes=True)
         + reference_cases("test_migrate", classes=True))


def test_reference_cases_are_all_listed():
    assert len(CASES) == 5 + 4


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[f"{f}.{c}" for f, c in CASES])
def test_reference_case(tmp_path, monkeypatch, request, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch, request)


def _catalog(pkg, wh):
    if pkg is PORT:
        return port_pkg.create_catalog({"warehouse": wh}, device="cpu")
    return ref_pkg.create_catalog({"warehouse": wh})


def _state(table):
    snap = table.latest_snapshot()
    return {"fields": [(f.name, str(f.type)) for f in table.schema.fields],
            "primary_keys": list(table.schema.primary_keys),
            "partition_keys": list(table.schema.partition_keys),
            "records": snap.total_record_count if snap else None,
            "rows": table.to_arrow().sort_by("id").to_pylist()}


def _pk_source(pkg, cat):
    """A primary-key table: a compacted base, an L0 file over it, and
    deletion vectors from a delete."""
    schema = (pkg.Schema.builder()
              .column("id", pkg.types.BigIntType(False))
              .column("v", pkg.types.DoubleType())
              .column("q", pkg.types.IntType())
              .primary_key("id")
              .options({"bucket": "2", "deletion-vectors.enabled": "true"})
              .build())
    cat.create_database("db", ignore_if_exists=True)
    t = cat.create_table("db.src", schema)
    rng = np.random.default_rng(21)
    n = 4000
    data = pa.table({"id": pa.array(rng.permutation(n), pa.int64()),
                     "v": pa.array(rng.random(n)),
                     "q": pa.array(rng.integers(0, 9, n), pa.int32())})
    for part in (data.slice(0, n // 2), data.slice(n // 2)):
        wb = t.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(part)
            wb.new_commit().commit(w.prepare_commit())
    t.compact(full=True)
    t.delete_where(pkg.P.equal("q", 4))
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(data.slice(0, 100))
        wb.new_commit().commit(w.prepare_commit())
    return t


@pytest.mark.parametrize("maker, reader", [(PORT, REF), (REF, PORT)])
def test_a_clone_reads_equal_in_the_other_package(tmp_path, maker, reader):
    wh = str(tmp_path / "wh")
    mcat = _catalog(maker, wh)
    _pk_source(maker, mcat)
    clone = port_clone if maker is PORT else ref_clone
    made = clone(mcat, "db.src", "db.dst")
    rcat = _catalog(reader, wh)
    assert _state(rcat.get_table("db.dst")) == _state(made) == \
        _state(mcat.get_table("db.src"))
    # the reader writes on the clone; the maker reads it
    t = rcat.get_table("db.dst")
    t.compact(full=True)
    assert _state(mcat.get_table("db.dst"))["rows"] == \
        _state(made)["rows"]


def _hive_dir(root, fmt, seed):
    rng = np.random.default_rng(seed)
    n = 0
    for dt in ("2026-01-01", "2026-01-02"):
        d = os.path.join(root, f"dt={dt}")
        os.makedirs(d)
        for i in range(2):
            m = 500 + 100 * i
            t = pa.table({"id": pa.array(np.arange(n, n + m), pa.int64()),
                          "v": pa.array(rng.random(m)),
                          "s": pa.array([f"s{x % 13}" for x in range(m)])})
            path = os.path.join(d, f"part-{i}.{fmt}")
            if fmt == "parquet":
                pq.write_table(t, path)
            else:
                orc.write_table(t, path)
            n += m
    return n


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
@pytest.mark.parametrize("maker, reader", [(PORT, REF), (REF, PORT)])
def test_a_migration_reads_equal_in_the_other_package(
        tmp_path, maker, reader, fmt):
    src = str(tmp_path / "hive")
    total = _hive_dir(src, fmt, 5)
    wh = str(tmp_path / "wh")
    mcat = _catalog(maker, wh)
    mcat.create_database("db")
    migrate = port_migrate if maker is PORT else ref_migrate
    made = migrate(mcat, src, "db.m", file_format=fmt, move=False)
    got = _state(_catalog(reader, wh).get_table("db.m"))
    assert got == _state(made)
    assert got["records"] == total == len(got["rows"])
    # the same directory migrated by the other package gives the same
    # table
    other = port_migrate if maker is REF else ref_migrate
    again = other(_catalog(reader, wh), src, "db.m2", file_format=fmt,
                  move=False)
    assert _state(again) == got
