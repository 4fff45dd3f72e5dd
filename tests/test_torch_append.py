"""Append tables of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_append_table.py run on both packages: the
reference's source, once as written and once with every `paimon_tpu.`
import pointed at `paimon_tpu_torch.` and its tables on the CPU
(`reference_module`, which the deletion-vector, row-tracking and
sort-compact test files share).  Seeded append tables, bucket-unaware
and fixed-bucket with `bucket-key`, partitioned, with file indexes and
evolved schemas, are written by one package and read by both: rows,
plans (split binning by source.split.*, files skipped by value stats and
indexes), streaming deltas and the compaction picker's choices
(compaction.min.file-num, compaction.small-file-ratio) are equal.  Every
value compared is a table row or a file count, so equality is exact.
"""

import ast
import contextlib
import functools
import inspect
import os
import re
import types

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.predicate as RefP
import paimon_tpu_torch.predicate as PortP
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import IntType as RefInt
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch.core.read import ROW_KIND_COL
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, IntType, VarCharType

HERE = os.path.dirname(os.path.abspath(__file__))


# -- the reference's cases on both packages -----------------------------------

def _cpu_table(table_cls):
    """`table_cls` whose create and load default to the CPU."""
    class CpuTable(table_cls):
        @staticmethod
        def create(path, schema, file_io=None, device="cpu"):
            return table_cls.create(path, schema, file_io=file_io,
                                    device=device)

        @staticmethod
        def load(path, file_io=None, dynamic_options=None, device="cpu"):
            return table_cls.load(path, file_io=file_io,
                                  dynamic_options=dynamic_options,
                                  device=device)
    return CpuTable


def _cpu_catalog(catalog_cls):
    """`catalog_cls` whose tables default to the CPU."""
    class CpuCatalog(catalog_cls):
        def __init__(self, *args, device=None, **kwargs):
            super().__init__(*args, device=device or "cpu", **kwargs)
    CpuCatalog.__name__ = catalog_cls.__name__
    return CpuCatalog


def cpu_entry_points(monkeypatch):
    """Point the port's catalog entry points and its table package's
    FileStoreTable at the CPU for one test, wherever a reference case
    imports them from (module level or inside the test)."""
    import paimon_tpu_torch
    import paimon_tpu_torch.catalog as cat_pkg
    import paimon_tpu_torch.table as table_pkg
    from paimon_tpu_torch.catalog import catalog, jdbc, rest
    for mod, name in ((catalog, "FileSystemCatalog"), (jdbc, "JdbcCatalog"),
                      (rest, "RESTCatalogClient")):
        cpu = _cpu_catalog(getattr(mod, name))
        monkeypatch.setattr(mod, name, cpu)
        if hasattr(cat_pkg, name):
            monkeypatch.setattr(cat_pkg, name, cpu)
    # catalog.create_catalog builds the patched classes; with device=None
    # they open on the CPU
    monkeypatch.setattr(table_pkg, "FileStoreTable",
                        _cpu_table(table_pkg.FileStoreTable))
    for mod in (paimon_tpu_torch, cat_pkg):
        monkeypatch.setattr(mod, "create_catalog", catalog.create_catalog)


def _cpu_main(main):
    """The port's CLI `main` with `--device cpu` in front of argv."""
    @functools.wraps(main)
    def run(argv=None):
        return main(["--device", "cpu", *(argv or [])])
    return run


def reference_module(name: str, port: bool):
    """A reference test module, run as written or against the port (its
    FileStoreTable on the CPU, and its CLI's `main` with --device cpu).
    A port case that opens a catalog runs under `cpu_entry_points`."""
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as f:
        src = f.read()
    if port:
        src = src.replace("paimon_tpu.", "paimon_tpu_torch.") \
            .replace("from paimon_tpu import", "from paimon_tpu_torch import")
        src = re.sub(r"(?m)^(\s*)import paimon_tpu$",
                     r"\1import paimon_tpu_torch", src)
    mod = types.ModuleType(f"{name}_{'port' if port else 'reference'}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    if port and "FileStoreTable" in mod.__dict__:
        mod.FileStoreTable = _cpu_table(mod.FileStoreTable)
    if port and getattr(mod.__dict__.get("main"), "__module__", "") \
            == "paimon_tpu_torch.cli":
        mod.main = _cpu_main(mod.main)
    return mod


def reference_cases(name: str, skip=(), classes: bool = False):
    """(file, case) pairs of a reference test file: its top-level test
    functions and, with `classes`, the test methods of its Test* classes
    as "Class.method"."""
    with open(os.path.join(HERE, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and \
                node.name.startswith("test_"):
            out.append(node.name)
        elif classes and isinstance(node, ast.ClassDef) and \
                node.name.startswith("Test"):
            out.extend(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, ast.FunctionDef)
                       and m.name.startswith("test_"))
    return [(name, c) for c in out if c not in skip]


def _fixture_function(obj):
    """The function under a module's @pytest.fixture, or None."""
    if hasattr(obj, "_get_wrapped_function"):
        return obj._get_wrapped_function()
    wrapped = getattr(obj, "__pytest_wrapped__", None)
    return getattr(wrapped, "obj", None)


def run_reference_case(case, pkg, tmp_path, monkeypatch, request=None):
    """Run one reference case on `pkg` ("port" or "reference"); the
    port's curve functions and entry points run on the CPU.  Fixtures
    come from the case's own module (generator fixtures are torn down
    after it), then tmp_path / tmp_warehouse, then pytest's own through
    `request` (capsys)."""
    if pkg == "port":
        from paimon_tpu_torch.ops import zorder
        for fn in ("z_index", "hilbert_index"):
            monkeypatch.setattr(zorder, fn, functools.partial(
                getattr(zorder, fn), device="cpu"))
        cpu_entry_points(monkeypatch)
    mod = reference_module(case[0], pkg == "port")
    owner, _, name = case[1].rpartition(".")
    fn = getattr(getattr(mod, owner)(), name) if owner else \
        getattr(mod, name)
    with contextlib.ExitStack() as teardown:
        values = {}

        def value(p):
            if p in values:
                return values[p]
            fixture = _fixture_function(mod.__dict__.get(p))
            if fixture is not None:
                v = fixture(**{q: value(q) for q in
                               inspect.signature(fixture).parameters})
                if inspect.isgenerator(v):
                    gen, v = v, next(v)
                    teardown.callback(next, gen, None)
            elif p == "tmp_path":
                v = tmp_path
            elif p == "tmp_warehouse":
                v = str(tmp_path / "warehouse")
            elif p == "monkeypatch":
                v = monkeypatch
            elif request is not None:
                v = request.getfixturevalue(p)
            else:
                raise AssertionError(f"unknown fixture {p}")
            values[p] = v
            return v

        fn(**{p: value(p) for p in inspect.signature(fn).parameters})


CASES = reference_cases("test_append_table")


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


# -- seeded tables, cross-read ------------------------------------------------

class Pkg:
    def __init__(self, name, schema, table, big, dbl, i32, vc, P, kwargs):
        self.name, self.Schema, self.Table = name, schema, table
        self.big, self.dbl, self.i32, self.vc = big, dbl, i32, vc
        self.P = P
        self.kwargs = kwargs

    def schema(self, options, partitioned=False):
        b = (self.Schema.builder().column("id", self.big())
             .column("name", self.vc.string_type())
             .column("v", self.dbl()).column("k", self.i32()))
        if partitioned:
            b = b.column("dt", self.vc(nullable=False)).partition_keys("dt")
        return b.options(dict(options)).build()

    def create(self, root, options, partitioned=False, name="t"):
        return self.Table.create(os.path.join(root, self.name, name),
                                 self.schema(options, partitioned),
                                 **self.kwargs)

    def load(self, path, opts=None):
        return self.Table.load(path, dynamic_options=opts, **self.kwargs)


PORT = Pkg("port", Schema, FileStoreTable, BigIntType, DoubleType, IntType,
           VarCharType, PortP, {"device": "cpu"})
REF = Pkg("reference", RefSchema, RefTable, RefBigInt, RefDouble, RefInt,
          RefVarChar, RefP, {})
BOTH = pytest.mark.parametrize("writer", [PORT, REF], ids=["port", "ref"])


def batches(seed, commits=4, rows=300, partitioned=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        cols = {"id": pa.array(rng.integers(0, 1000, rows), pa.int64()),
                "name": pa.array([f"n{x}" for x in
                                  rng.integers(0, 50, rows)]),
                "v": pa.array(rng.random(rows), pa.float64()),
                "k": pa.array(rng.integers(0, 20, rows).astype(np.int32),
                              pa.int32())}
        if partitioned:
            cols["dt"] = pa.array([f"d{x}" for x in
                                   rng.integers(0, 3, rows)])
        out.append(pa.table(cols))
    return out


def commit_arrow(table, batch):
    wb = table.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(batch)
        return wb.new_commit().commit(w.prepare_commit())


def rows(t: pa.Table):
    return sorted(map(tuple, zip(*[t.column(c).to_pylist()
                                   for c in t.column_names])),
                  key=repr)


def plan_shape(table, predicate=None, partition=None):
    """(partition, bucket, rows, files) of each split, in plan order."""
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    if partition is not None:
        rb = rb.with_partition_filter(partition)
    return [(tuple(s.partition), s.bucket, s.row_count, len(s.data_files))
            for s in rb.new_scan().plan().splits]


def both_read(writer, path, opts=None, predicate=None, projection=None):
    """What each package reads from the table at `path`."""
    out = []
    for pkg in (PORT, REF):
        t = pkg.load(path, opts)
        pred = predicate(pkg.P) if predicate else None
        out.append(rows(t.to_arrow(projection=projection, predicate=pred)))
    return out


OPTIONS = [
    {"bucket": "-1"},
    {"bucket": "3", "bucket-key": "id"},
    {"bucket": "2", "bucket-key": "id,k",
     "file-index.bloom-filter.columns": "id",
     "file-index.bitmap.columns": "k"},
    {"bucket": "-1", "source.split.target-size": "8kb",
     "source.split.open-file-cost": "2kb"},
]


@BOTH
@pytest.mark.parametrize("opt", range(len(OPTIONS)))
@pytest.mark.parametrize("seed", [3, 11])
def test_tables_equal_reference_and_cross_read(tmp_path, writer, opt, seed):
    options = OPTIONS[opt]
    t = writer.create(str(tmp_path), options)
    data = batches(seed)
    for b in data:
        commit_arrow(t, b)
    want = rows(pa.concat_tables(data))
    port_rows, ref_rows = both_read(writer, t.path)
    assert port_rows == ref_rows == want
    # the same table written by the other package plans the same splits
    other = (REF if writer is PORT else PORT).create(str(tmp_path), options)
    for b in data:
        commit_arrow(other, b)
    assert plan_shape(PORT.load(t.path)) == plan_shape(REF.load(t.path)) \
        == plan_shape(PORT.load(other.path))
    for pred in (lambda P: P.less_than("id", 100),
                 lambda P: P.equal("k", 7),
                 lambda P: P.equal("id", 4242)):
        p_rows, r_rows = both_read(writer, t.path, predicate=pred)
        assert p_rows == r_rows
        assert plan_shape(PORT.load(t.path), pred(PortP)) == \
            plan_shape(REF.load(t.path), pred(RefP))
    p_rows, r_rows = both_read(writer, t.path, projection=["name", "id"])
    assert p_rows == r_rows


@BOTH
def test_partitioned_streaming_deltas_equal_reference(tmp_path, writer):
    t = writer.create(str(tmp_path), {"bucket": "2", "bucket-key": "id"},
                      partitioned=True)
    data = batches(5, commits=5, partitioned=True)
    commit_arrow(t, data[0])
    consumers = []
    for pkg in (PORT, REF):
        table = pkg.load(t.path)
        rb = table.new_read_builder()
        consumers.append((rb.new_stream_scan(), rb.new_read()))
    first = [rows(rd.to_arrow(sc.plan())) for sc, rd in consumers]
    assert first[0] == first[1]
    for k, b in enumerate(data[1:]):
        commit_arrow(t, b)
        if k == 1:
            t.compact(full=True)           # skipped by the delta follow-up
        got = []
        for sc, rd in consumers:
            polled = [rd.to_arrow(p) for p in (sc.plan() for _ in range(3))
                      if p is not None]      # a compaction plans nothing
            got.append(rows(pa.concat_tables(polled)))
        assert got[0] == got[1]
        assert sorted((r[:5] for r in got[0]), key=repr) == rows(b)
        assert all(r[5] == 0 for r in got[0])       # +I
    assert plan_shape(PORT.load(t.path), partition={"dt": "d1"}) == \
        plan_shape(REF.load(t.path), partition={"dt": "d1"})


@pytest.mark.parametrize("opts", [
    {"compaction.min.file-num": "3"},
    {"compaction.min.file-num": "2", "target-file-size": "16kb",
     "compaction.small-file-ratio": "0.5"},
    {"compaction.min.file-num": "4", "target-file-size": "64kb"}])
def test_compaction_picks_equal_reference(tmp_path, opts):
    """Non-full compactions on both packages pick the same files, round
    after round, and read the same rows."""
    tables = [pkg.create(str(tmp_path), {"bucket": "-1", **opts})
              for pkg in (PORT, REF)]
    data = batches(9, commits=8, rows=200)
    shapes = [[], []]
    for b in data:
        for i, t in enumerate(tables):
            commit_arrow(t, b)
            sid = t.compact()
            shapes[i].append((sid is not None, sorted(
                (f.row_count, f.min_sequence_number, f.level)
                for s in t.new_read_builder().new_scan().plan().splits
                for f in s.data_files)))
    assert shapes[0] == shapes[1]
    assert rows(tables[0].to_arrow()) == rows(tables[1].to_arrow())


@BOTH
def test_evolved_table_compacts_equal_reference(tmp_path, writer):
    """ADD COLUMN, then a widened column: both packages read old and new
    files alike, before and after a full compaction, in either order of
    writer."""
    t = writer.create(str(tmp_path), {"bucket": "-1"})
    data = batches(2, commits=2)
    for b in data:
        commit_arrow(t, b)
    change = __import__(
        "paimon_tpu_torch.schema" if writer is PORT else "paimon_tpu.schema",
        fromlist=["SchemaChange"]).SchemaChange
    t.schema_manager.commit_changes(change.add_column("extra", writer.i32()))
    t.schema_manager.commit_changes(change.update_column_type(
        "k", writer.big()))
    t = writer.load(t.path)
    extra = batches(4, commits=1)[0]
    extra = extra.set_column(3, "k", extra.column("k").cast(pa.int64())) \
        .append_column("extra", pa.array(np.arange(extra.num_rows,
                                                    dtype=np.int32)))
    commit_arrow(t, extra)
    p_rows, r_rows = both_read(writer, t.path)
    assert p_rows == r_rows
    assert len(p_rows) == 3 * 300
    other = REF if writer is PORT else PORT
    assert other.load(t.path).compact(full=True) is not None
    assert both_read(writer, t.path) == [p_rows, p_rows]


def test_index_row_selection_equals_reference(tmp_path):
    """A bitmap index narrows a file's rows before the exact filter: the
    port's read, through its ranged sidecar reader, equals the
    reference's."""
    opts = {"bucket": "-1", "file-index.bitmap.columns": "k",
            "file-index.bsi.columns": "id",
            "file-index.in-manifest-threshold": "1"}
    t = PORT.create(str(tmp_path), opts)
    for b in batches(13, commits=3):
        commit_arrow(t, b)
    for pred in (lambda P: P.equal("k", 3),
                 lambda P: P.and_(P.greater_than("id", 500),
                                  P.less_than("k", 4)),
                 lambda P: P.equal("k", 99)):
        p_rows, r_rows = both_read(PORT, t.path, predicate=pred)
        assert p_rows == r_rows


def test_writer_refuses_deletes_and_keeps_sequence(tmp_path):
    """Sequence numbers continue across writers of a bucket, as the
    reference's do."""
    metas = []
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), {"bucket": "2", "bucket-key": "id"})
        for b in batches(1, commits=3, rows=50):
            commit_arrow(t, b)
        metas.append(sorted((s.bucket, f.min_sequence_number,
                             f.max_sequence_number, f.row_count)
                            for s in t.new_read_builder().new_scan()
                            .plan().splits for f in s.data_files))
    assert metas[0] == metas[1]


def test_streaming_read_marks_rows_as_inserts(tmp_path):
    t = PORT.create(str(tmp_path), {"bucket": "-1"})
    commit_arrow(t, batches(1, commits=1, rows=10)[0])
    rb = t.new_read_builder()
    out = rb.new_read().to_arrow(rb.new_stream_scan().plan())
    assert out.column_names[-1] == ROW_KIND_COL
    assert out.column(ROW_KIND_COL).to_pylist() == [0] * 10


# -- read retries and the plan cache on append tables ----------------------------

@pytest.mark.parametrize("tracked", [False, True])
def test_append_read_retries_each_fault_once(tmp_path, tracked):
    """A transient fault on an append data file's read retries under
    read.retry.* in both packages, also inside a row-range group (whose
    reads retry file by file and are not retried again as a group)."""
    from tests import test_torch_dynamic_bucket as dyn
    from tests.test_torch_read_write_faults import (
        StormFileIO, errors_of, metric,
    )
    opts = {"bucket": "-1"}
    if tracked:
        opts["row-tracking.enabled"] = "true"
    got = []
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), opts)
        for b in batches(21, commits=3, rows=100):
            commit_arrow(t, b)
        if tracked:
            t.update_columns(np.arange(0, 300, 5), pa.table(
                {"v": pa.array(np.arange(60) * 1.5)}))
        other = dyn.PORT if pkg is PORT else dyn.REF   # the faults' pkg
        storm = StormFileIO(t.file_io, errors_of(other)[0], per_path=1)
        r0 = metric(other, "scan", "read_retries")
        stormy = pkg.Table.load(t.path, file_io=storm,
                                dynamic_options={"read.retry.backoff": "0"},
                                **pkg.kwargs)
        out = rows(stormy.to_arrow(with_row_ids=tracked))
        assert out == rows(t.to_arrow(with_row_ids=tracked))
        assert metric(other, "scan", "read_retries") - r0 == \
            storm.faults > 0
        got.append(out)
    assert got[0] == got[1]


def test_plan_cache_serves_deletes_and_split_options(tmp_path):
    """The port's plan cache memoises the deletion vectors per index
    manifest (a delete plans the new vectors) and keys split states by
    the binning options (two table objects with other source.split.*
    share the cache and plan their own bins), equal to the reference."""
    from paimon_tpu.core.plan_cache import reset_plan_caches as ref_reset
    from paimon_tpu_torch.core.plan_cache import reset_plan_caches
    reset_plan_caches()
    ref_reset()
    try:
        tables = [pkg.create(str(tmp_path), {"bucket": "-1"})
                  for pkg in (PORT, REF)]
        for b in batches(2, commits=5, rows=200):
            for t in tables:
                commit_arrow(t, b)
        small = {"source.split.target-size": "16kb",
                 "source.split.open-file-cost": "1kb"}
        for step in range(3):
            for t, pkg in zip(tables, (PORT, REF)):
                if step:
                    t.delete_where(pkg.P.equal("k", step))
            shapes = [(plan_shape(pkg.load(t.path)),
                       plan_shape(pkg.load(t.path, small)),
                       rows(pkg.load(t.path).to_arrow()))
                      for t, pkg in zip(tables, (PORT, REF))]
            assert shapes[0] == shapes[1]
            assert len(shapes[0][1]) > len(shapes[0][0]) == 1
            plan = PORT.load(tables[0].path).new_scan().plan()
            dvs = plan.splits[0].deletion_vectors
            assert (dvs is None) == (step == 0)
            reset_plan_caches()
            cold = PORT.load(tables[0].path).new_scan().plan()
            assert [s.deletion_vectors is None for s in cold.splits] == \
                [s.deletion_vectors is None for s in plan.splits]
    finally:
        reset_plan_caches()
        ref_reset()
