"""Data-file formats of paimon_tpu_torch against paimon_tpu.

avro (the pure-Python row codec of format/avro.py), csv and json
(pyarrow) and mosaic (format/mosaic.py) data files: the same seeded
tables are written by both packages, their data files compared byte for
byte (avro with a fixed sync marker, the one random part of a
container), and each package reads the other's table, before and after
a full compaction.  `file.format.per.level=0:avro` and
`changelog-file.format=avro` are covered the same way, and the cases of
tests/test_mosaic.py and tests/test_avro.py run on both packages.
"""

import functools
import inspect
import os

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.format.avro as ref_avro
import paimon_tpu_torch.format.avro as port_avro
from paimon_tpu_torch.fs import LocalFileIO
from tests.test_torch_append import reference_module
from tests.test_torch_dynamic_bucket import BOTH, PORT, REF

FORMATS = ["avro", "csv", "json", "mosaic"]
SYNC = b"paimon-test-sync"


@pytest.fixture
def fixed_sync(monkeypatch):
    """Both packages' avro containers get one sync marker (os.urandom
    otherwise), so equal records give equal bytes."""
    for mod in (ref_avro, port_avro):
        monkeypatch.setattr(mod, "write_container", functools.partial(
            mod.write_container, sync_marker=SYNC))


def bench_batches(seed, commits=3, rows=400, key_range=700):
    """bench.py's rows: id BIGINT NOT NULL, v1 BIGINT, v2 DOUBLE,
    v3 INT; ids uniform in [0, key_range)."""
    rng = np.random.default_rng(seed)
    return [pa.table({
        "id": pa.array(rng.integers(0, key_range, rows), pa.int64()),
        "v1": pa.array(rng.integers(-2**40, 2**40, rows), pa.int64()),
        "v2": pa.array(rng.standard_normal(rows), pa.float64()),
        "v3": pa.array(rng.integers(-2**31, 2**31 - 1, rows), pa.int32())})
        for _ in range(commits)]


def last_writer(batches):
    rows = {}
    for b in batches:
        for r in b.to_pylist():
            rows[r["id"]] = r
    return [rows[k] for k in sorted(rows)]


def bench_table(pkg, root, options, pk=True, name="t"):
    T = pkg.types
    b = (pkg.Schema.builder().column("id", T.BigIntType(False))
         .column("v1", T.BigIntType()).column("v2", T.DoubleType())
         .column("v3", T.IntType()))
    if pk:
        b = b.primary_key("id")
    return pkg.create(root, b.options(dict(options)).build(), name)


def commit(table, batch):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(batch)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def rows_of(table):
    return sorted(table.to_arrow().to_pylist(),
                  key=lambda r: (r["id"], r["v1"]))


def file_bytes(table, changelog=False):
    """Data files (or changelog files) by (bucket, sequence): their
    extension and bytes."""
    scan = table.new_scan()
    snap = table.snapshot_manager.latest_snapshot()
    if changelog:
        metas = []
        for sid in range(1, snap.id + 1):
            plan = scan.plan_changelog(table.snapshot_manager.snapshot(sid))
            metas.extend((s.bucket, f) for s in plan.splits
                         for f in s.data_files)
    else:
        metas = [(e.bucket, e.file) for e in scan.read_entries(snap)]
    out = []
    for bucket, f in sorted(metas, key=lambda x: (
            x[0], x[1].min_sequence_number, x[1].level)):
        with open(scan.path_factory.data_file_path((), bucket, f.file_name),
                  "rb") as fh:
            out.append((bucket, f.level, f.file_name.rsplit(".", 1)[-1],
                        fh.read()))
    return out


def _both_tables(tmp_path, options, batches, pk=True):
    tables = [bench_table(p, str(tmp_path), options, pk=pk)
              for p in (PORT, REF)]
    for t in tables:
        for b in batches:
            commit(t, b)
    return tables


def _cross_read(tables, want):
    for t, pkg in zip(tables, (PORT, REF)):
        for reader in (PORT, REF):
            assert rows_of(reader.load(t.path)) == want, (pkg.name,
                                                          reader.name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_pk_table_files_equal_and_cross_read(tmp_path, fixed_sync, fmt):
    batches = bench_batches(1)
    tables = _both_tables(tmp_path, {"bucket": "1", "file.format": fmt},
                          batches)
    want = last_writer(batches)
    port_files, ref_files = (file_bytes(t) for t in tables)
    assert [f[2] for f in port_files] == [fmt] * len(batches)
    assert port_files == ref_files
    _cross_read(tables, want)
    for t in tables:
        assert t.compact(full=True) is not None
    assert file_bytes(tables[0]) == file_bytes(tables[1])
    _cross_read(tables, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_append_table_files_equal_and_cross_read(tmp_path, fixed_sync, fmt):
    batches = bench_batches(2)
    tables = _both_tables(tmp_path, {"bucket": "-1", "file.format": fmt,
                                     "compaction.min.file-num": "2"},
                          batches, pk=False)
    want = sorted((r for b in batches for r in b.to_pylist()),
                  key=lambda r: (r["id"], r["v1"]))
    assert file_bytes(tables[0]) == file_bytes(tables[1])
    _cross_read(tables, want)
    for t in tables:
        assert t.compact(full=True) is not None
    _cross_read(tables, want)


def test_level0_avro_per_level(tmp_path, fixed_sync):
    """file.format.per.level=0:avro: L0 runs in avro, the compaction's
    output in parquet."""
    batches = bench_batches(3, commits=4)
    tables = _both_tables(tmp_path, {"bucket": "1",
                                     "file.format.per.level": "0:avro"},
                          batches)
    assert {f[2] for f in file_bytes(tables[0])} == {"avro"}
    assert file_bytes(tables[0]) == file_bytes(tables[1])
    _cross_read(tables, last_writer(batches))
    for t in tables:
        assert t.compact(full=True) is not None
    assert {f[2] for f in file_bytes(tables[0])} == {"parquet"}
    assert file_bytes(tables[0]) == file_bytes(tables[1])
    _cross_read(tables, last_writer(batches))


@pytest.mark.parametrize("producer", ["input", "full-compaction"])
def test_avro_changelog_files(tmp_path, fixed_sync, producer):
    """changelog-file.format=avro: both packages write the same
    changelog files and stream the same changelog."""
    batches = bench_batches(4, commits=3)
    options = {"bucket": "1", "changelog-producer": producer,
               "changelog-file.format": "avro"}
    tables = [bench_table(p, str(tmp_path), options) for p in (PORT, REF)]
    for t in tables:
        for b in batches:
            commit(t, b)
            if producer == "full-compaction":
                t.compact(full=True)
    port_cl, ref_cl = (file_bytes(t, changelog=True) for t in tables)
    assert port_cl and {f[2] for f in port_cl} == {"avro"}
    assert port_cl == ref_cl
    _cross_read(tables, last_writer(batches))


# -- the reference's format cases on both packages ----------------------------

def _cases(name):
    with open(os.path.join(os.path.dirname(__file__), f"{name}.py")) as f:
        return [(name, line[4:line.index("(")]) for line in f
                if line.startswith("def test_")]


CASES = _cases("test_mosaic") + _cases("test_avro")


def _expand(fn):
    """The argument sets of a case under its parametrize marks."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        values = mark.args[1]
        sets = [dict(s, **dict(zip(names, v if len(names) > 1 else (v,))))
                for s in sets for v in values]
    return sets


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, case, pkg):
    mod = reference_module(case[0], pkg == "port")
    fn = getattr(mod, case[1])
    for i, params in enumerate(_expand(fn)):
        kwargs = dict(params)
        for p in inspect.signature(fn).parameters:
            if p == "tmp_path":
                kwargs[p] = tmp_path / str(i)
                kwargs[p].mkdir()
            elif p == "fio":
                kwargs[p] = mod.LocalFileIO()
            elif p not in kwargs:
                raise AssertionError(f"unknown fixture {p}")
        fn(**kwargs)


class RangeCountingFileIO(LocalFileIO):
    def __init__(self):
        super().__init__()
        self.ranges = 0

    def read_range(self, path, offset, length):
        self.ranges += path.endswith(".mosaic")
        return super().read_range(path, offset, length)

    def read_ranges(self, path, ranges):
        self.ranges += len(ranges) * path.endswith(".mosaic")
        return super().read_ranges(path, ranges)


def test_mosaic_ranged_reads_hit_the_range_cache(tmp_path, monkeypatch):
    """A mosaic table with read.cache.range reads its column buckets
    through the shared range LRU (fs/caching.py): a second projected
    read fetches nothing from the store."""
    from paimon_tpu_torch.fs import caching
    monkeypatch.setattr(caching, "_SHARED_STATE", None)
    batches = bench_batches(5, commits=2)
    table = bench_table(PORT, str(tmp_path), {
        "bucket": "-1", "file.format": "mosaic"}, pk=False)
    for b in batches:
        commit(table, b)
    fio = RangeCountingFileIO()
    t = PORT.Table.load(table.path, file_io=fio, device="cpu",
                        dynamic_options={"read.cache.range": "true"})
    first = t.to_arrow(projection=["id", "v3"])
    fetched = fio.ranges
    assert fetched > 0
    assert t.to_arrow(projection=["id", "v3"]).equals(first)
    assert fio.ranges == fetched


@BOTH
def test_unknown_format_raises(pkg, tmp_path):
    from paimon_tpu.format import get_format as ref_get
    from paimon_tpu_torch.format import get_format as port_get
    get = port_get if pkg is PORT else ref_get
    with pytest.raises(ValueError, match="Unknown file format"):
        get("xml")
