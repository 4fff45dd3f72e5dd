"""Blob columns of paimon_tpu_torch against paimon_tpu.

A BLOB column's bytes go to the data file's `.blob` sidecar, and the data
file holds a struct<offset, length> descriptor per row
(format/blob.py).  The cases of tests/test_blob.py run on both packages
(`reference_module`); seeded primary-key and append tables with blob
columns are written by one package and read by both, through
compaction (the streamed whole-bucket rewrite reads blob files
unstreamed), the mesh engine, deletes, row-tracked updates, expiry and
the orphan clean.  Blob bytes are compared exactly.

The C.8 guard (ROADMAP.md C): the port once wrote a primary-key table's
blobs inline in the parquet file and could not read a reference table's
descriptors (`Unsupported cast from struct<offset: int64, length:
int64> to binary`).
"""

import inspect
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from paimon_tpu_torch.format.blob import DESCRIPTOR_TYPE
from paimon_tpu_torch.fs import LocalFileIO
from tests.test_torch_append import reference_module
from tests.test_torch_dynamic_bucket import BOTH, PORT, REF

# -- the reference's cases on both packages -----------------------------------

_CASES = [("test_blob_roundtrip", {"pk": True}),
          ("test_blob_roundtrip", {"pk": False}),
          ("test_blob_survives_compaction", {}),
          ("test_blob_survives_column_rename", {}),
          ("test_blob_projection_skips_sidecar", {}),
          ("test_delete_where_on_blob_table", {})]


def test_reference_cases_are_all_listed():
    with open(os.path.join(os.path.dirname(__file__), "test_blob.py")) as f:
        names = {line[4:line.index("(")] for line in f
                 if line.startswith("def test_")}
    assert names == {name for name, _ in _CASES}


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case, params", _CASES,
                         ids=[f"{n}{p}" if p else n for n, p in _CASES])
def test_reference_case(tmp_path, case, params, pkg):
    fn = getattr(reference_module("test_blob", pkg == "port"), case)
    kwargs = dict(params)
    if "tmp_warehouse" in inspect.signature(fn).parameters:
        kwargs["tmp_warehouse"] = str(tmp_path / "warehouse")
    fn(**kwargs)


# -- seeded blob tables --------------------------------------------------------

class CountingFileIO(LocalFileIO):
    """Counts the bytes read from `.blob` files."""

    def __init__(self):
        super().__init__()
        self.blob_bytes = 0

    def _count(self, path, n):
        if path.endswith(".blob"):
            self.blob_bytes += n

    def read_bytes(self, path):
        data = super().read_bytes(path)
        self._count(path, len(data))
        return data

    def read_range(self, path, offset, length):
        data = super().read_range(path, offset, length)
        self._count(path, len(data))
        return data

    def read_ranges(self, path, ranges):
        out = super().read_ranges(path, ranges)
        self._count(path, sum(len(b) for b in out))
        return out


def blob_batches(seed, commits=3, rows=120, key_range=200, nulls=True):
    """Seeded commits of (id, v, img): ids uniform in [0, key_range),
    images of 0-300 random bytes, about one in eight null."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        ids = rng.integers(0, key_range, rows)
        lens = rng.integers(0, 300, rows)
        payload = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
        cuts = np.concatenate([[0], np.cumsum(lens)])
        imgs = [payload[cuts[i]:cuts[i + 1]].tobytes() for i in range(rows)]
        if nulls:
            for i in np.flatnonzero(rng.random(rows) < 0.125):
                imgs[i] = None
        out.append(pa.table({
            "id": pa.array(ids, pa.int64()),
            "v": pa.array(rng.integers(-1000, 1000, rows), pa.int64()),
            "img": pa.array(imgs, pa.binary())}))
    return out


def last_writer(batches):
    rows = {}
    for b in batches:
        for r in b.to_pylist():
            rows[r["id"]] = r
    return [rows[k] for k in sorted(rows)]


def blob_table(pkg, root, pk=True, options=None, name="t"):
    b = (pkg.Schema.builder().column("id", pkg.types.BigIntType(False))
         .column("v", pkg.types.BigIntType())
         .column("img", pkg.types.BlobType()))
    opts = {"bucket": "1"} if pk else {"bucket": "-1"}
    opts.update(options or {})
    if pk:
        b = b.primary_key("id")
    return pkg.create(root, b.options(opts).build(), name)


def commit(table, batch):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(batch)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def rows_by_id(table, **kw):
    return sorted(table.to_arrow(**kw).to_pylist(),
                  key=lambda r: (r["id"], r.get("v")))


def entries(table):
    return table.new_scan().read_entries(
        table.snapshot_manager.latest_snapshot())


def other(pkg):
    return REF if pkg is PORT else PORT


def data_file(table, e):
    return table.new_scan().path_factory.data_file_path(
        (), e.bucket, e.file.file_name)


def sidecar_of(table, e):
    return next(x for x in e.file.extra_files if x.endswith(".blob"))


def live_blob_bytes(table):
    return sum(os.path.getsize(os.path.join(
        os.path.dirname(data_file(table, e)), sidecar_of(table, e)))
        for e in entries(table))


def blob_files_on_disk(table):
    out = set()
    for d, _, files in os.walk(table.path):
        out.update(os.path.join(d, f) for f in files if f.endswith(".blob"))
    return out


@BOTH
def test_pk_blob_table_writes_sidecars_and_cross_reads(tmp_path, pkg):
    """C.8: a primary-key blob table written by either package has a
    `.blob` sidecar in every entry's extra_files and the descriptor
    struct in the data file, and each package reads the other's rows."""
    batches = blob_batches(3)
    table = blob_table(pkg, str(tmp_path))
    for b in batches:
        commit(table, b)
    want = last_writer(batches)
    for e in entries(table):
        assert any(x.endswith(".blob") for x in e.file.extra_files)
        img = pq.ParquetFile(data_file(table, e)).schema_arrow.field("img")
        assert img.type == DESCRIPTOR_TYPE
    assert rows_by_id(table) == want
    assert rows_by_id(other(pkg).load(table.path)) == want


@BOTH
def test_full_compaction_keeps_only_the_winners_bytes(tmp_path, pkg):
    """The compaction's unstreamed blob read: new sidecars hold the
    winners' bytes, read equal by both packages, and after expiry and
    the orphan clean no `.blob` is left without its data file."""
    batches = blob_batches(4, commits=4)
    table = blob_table(pkg, str(tmp_path),
                       {"tpu.merge.stream-threshold-rows": "64",
                        "tpu.merge.chunk-rows": "32"})
    for b in batches:
        commit(table, b)
    assert table.compact(full=True) is not None
    want = last_writer(batches)
    assert rows_by_id(table) == want
    assert rows_by_id(other(pkg).load(table.path)) == want
    assert live_blob_bytes(table) == sum(len(r["img"] or b"")
                                         for r in want)
    before = blob_files_on_disk(table)
    assert len(table.expire_snapshots(retain_max=1, retain_min=1)
               .expired_snapshots) == 4
    table.remove_orphan_files(older_than_ms=int(time.time() * 1000) + 60000)
    live = {os.path.join(os.path.dirname(data_file(table, e)),
                         sidecar_of(table, e)) for e in entries(table)}
    assert blob_files_on_disk(table) == live
    assert len(before) > len(live)
    for path in live:
        assert os.path.exists(path[:-len(".blob")])
    assert rows_by_id(table) == want


def _file_shapes(table):
    """Per data file in sequence order: row count, sidecar suffix, the
    descriptor column and the sidecar's bytes."""
    out = []
    for e in sorted(entries(table), key=lambda e: e.file.min_sequence_number):
        path = data_file(table, e)
        desc = pq.ParquetFile(path).read(columns=["img"]).column("img")
        with open(os.path.join(os.path.dirname(path),
                               sidecar_of(table, e)), "rb") as f:
            payload = f.read()
        out.append((e.file.row_count, e.file.level,
                    [x[len(e.file.file_name):] for x in e.file.extra_files],
                    desc.to_pylist(), payload))
    return out


def test_both_packages_write_equal_files(tmp_path):
    """The same commits give the same data files in both packages: the
    descriptor structs and the sidecar bytes, before and after a full
    compaction."""
    batches = blob_batches(5)
    tables = [blob_table(p, str(tmp_path)) for p in (PORT, REF)]
    for t in tables:
        for b in batches:
            commit(t, b)
    assert _file_shapes(tables[0]) == _file_shapes(tables[1])
    for t in tables:
        t.compact(full=True)
    assert _file_shapes(tables[0]) == _file_shapes(tables[1])


@BOTH
def test_projection_without_blob_reads_no_sidecar(tmp_path, pkg):
    batches = blob_batches(6)
    table = blob_table(pkg, str(tmp_path))
    for b in batches:
        commit(table, b)
    for reader in (PORT, REF):
        fio = CountingFileIO()
        t = reader.Table.load(table.path, file_io=fio, **reader.kwargs)
        ids = t.to_arrow(projection=["id", "v"]).sort_by("id")
        assert ids.column("id").to_pylist() == \
            [r["id"] for r in last_writer(batches)]
        assert fio.blob_bytes == 0
        t.to_arrow()
        assert fio.blob_bytes > 0


@BOTH
def test_delete_where_on_pk_blob_table(tmp_path, pkg):
    batches = blob_batches(7)
    table = blob_table(pkg, str(tmp_path))
    for b in batches:
        commit(table, b)
    assert table.delete_where(pkg.P.less_than("id", 50)) is not None
    want = [r for r in last_writer(batches) if r["id"] >= 50]
    assert rows_by_id(table) == want
    assert rows_by_id(other(pkg).load(table.path)) == want


@BOTH
def test_mesh_compaction_of_blob_table(tmp_path, pkg):
    """tpu.mesh.compact reads blob files unstreamed through the mesh
    engine (parallel/mesh_engine.py has_blobs)."""
    batches = blob_batches(8, commits=3)
    table = blob_table(pkg, str(tmp_path),
                       {"bucket": "2", "tpu.mesh.compact": "true"})
    for b in batches:
        commit(table, b)
    assert table.compact(full=True) is not None
    want = last_writer(batches)
    assert rows_by_id(table) == want
    assert rows_by_id(other(pkg).load(table.path)) == want
    assert all(e.file.level > 0 for e in entries(table))


@BOTH
@pytest.mark.parametrize("bucket", ["-1", "2"])
def test_append_blob_table_cross_reads_and_compacts(tmp_path, pkg, bucket):
    batches = blob_batches(9, commits=4)
    options = {"bucket": bucket, "compaction.min.file-num": "2"}
    if bucket != "-1":
        options["bucket-key"] = "id"
    table = blob_table(pkg, str(tmp_path), pk=False, options=options)
    for b in batches:
        commit(table, b)
    want = sorted((r for b in batches for r in b.to_pylist()),
                  key=lambda r: (r["id"], r["v"]))
    assert rows_by_id(table) == want
    assert rows_by_id(other(pkg).load(table.path)) == want
    assert table.compact(full=True) is not None
    assert rows_by_id(table) == want
    assert rows_by_id(other(pkg).load(table.path)) == want
    assert all(any(x.endswith(".blob") for x in e.file.extra_files)
               for e in entries(table))


@BOTH
def test_row_tracked_blob_table_updates_other_columns(tmp_path, pkg):
    """An overlay of `v` leaves the anchor's blob column in place; reads
    with row ids assemble both."""
    batches = blob_batches(10, commits=2, nulls=False)
    table = blob_table(pkg, str(tmp_path), pk=False,
                       options={"row-tracking.enabled": "true"})
    for b in batches:
        commit(table, b)
    rows = table.to_arrow(with_row_ids=True).to_pylist()
    picked = [r["_ROW_ID"] for r in rows[::7]]
    assert table.update_columns(
        picked, pa.table({"v": pa.array([9999] * len(picked), pa.int64())})
    ) is not None
    for reader in (pkg, other(pkg)):
        got = {r["_ROW_ID"]: r for r in reader.load(table.path)
               .to_arrow(with_row_ids=True).to_pylist()}
        for r in rows:
            g = got[r["_ROW_ID"]]
            assert g["img"] == r["img"]
            assert g["v"] == (9999 if r["_ROW_ID"] in picked else r["v"])


# -- the port's faster resolve and take, against the plain paths ------------

@pytest.mark.parametrize("seed", range(3))
def test_contiguous_resolve_equals_row_by_row(seed):
    """format/blob.py builds a column over the sidecar's bytes when the
    descriptors' ranges follow one another; every value equals the
    reference's row-by-row slicing, and other layouts take that path."""
    from paimon_tpu_torch.format.blob import _contiguous_values

    rng = np.random.default_rng(seed)
    built = 0
    for trial in range(200):
        n = int(rng.integers(1, 40))
        base = int(rng.integers(0, 50))
        lens = rng.integers(0, 20, n)
        nulls = rng.random(n) < 0.3
        lens[nulls] = 0
        offs = base + np.concatenate([[0], np.cumsum(lens)[:-1]])
        data = rng.bytes(int(base + lens.sum() + rng.integers(0, 30)))
        if trial % 3 == 0:
            offs[rng.integers(0, n)] += 1
        arr = pa.StructArray.from_arrays(
            [pa.array(offs, pa.int64(), mask=nulls),
             pa.array(lens, pa.int64(), mask=nulls)],
            fields=list(DESCRIPTOR_TYPE), mask=pa.array(nulls))
        want = [None if o is None else data[o:o + ln] for o, ln in zip(
            arr.field("offset").to_pylist(), arr.field("length").to_pylist())]
        got = _contiguous_values(arr, data)
        if got is not None:
            got.validate(full=True)
            assert got.type == pa.binary() and got.to_pylist() == want
            built += 1
    assert built > 50


def test_take_rows_equals_take():
    from paimon_tpu_torch.ops.merge import take_rows

    rng = np.random.default_rng(4)
    parts = [pa.table({"id": pa.array(rng.integers(0, 99, 50), pa.int64()),
                       "s": pa.array([f"v{i}" for i in range(50)]),
                       "b": pa.array([rng.bytes(int(k)) for k in
                                      rng.integers(0, 64, 50)], pa.binary())})
             for _ in range(4)]
    t = pa.concat_tables(parts)
    idx = rng.permutation(t.num_rows)[:120]
    got = take_rows(t, idx)
    assert got.schema == t.schema
    assert got.equals(t.take(pa.array(idx)))


@BOTH
def test_fsck_checks_the_sidecars(tmp_path, pkg):
    """fsck treats a `.blob` as part of its data file in both packages:
    clean on a blob table, and a lost sidecar is a dangling data file."""
    batches = blob_batches(11)
    table = blob_table(pkg, str(tmp_path))
    for b in batches:
        commit(table, b)
    reports = [reader.load(table.path).fsck(deep=True)
               for reader in (PORT, REF)]
    assert all(r.ok for r in reports)
    e = entries(table)[0]
    os.remove(os.path.join(os.path.dirname(data_file(table, e)),
                           sidecar_of(table, e)))
    kinds = [reader.load(table.path).fsck().kinds()
             for reader in (PORT, REF)]
    assert kinds[0] == kinds[1] == {"dangling-data-file"}
