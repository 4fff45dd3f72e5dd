"""Dynamic bucket mode (bucket unset = -1) of paimon_tpu_torch against
paimon_tpu.

The cases of tests/test_dynamic_bucket.py (system tables aside: they are
not ported) run on both packages; the vectorised assignment is held
equal to the reference's PartitionIndex bucket for bucket, and its index
files byte for byte; each package reads the other's table; the
serving, streaming and mesh-compaction planes give the reference's
answers, or the numpy oracle's where the reference misses.  Every value
compared is a table row or a bucket number, so equality is exact.
"""

import os

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import paimon_tpu.predicate as RefP
import paimon_tpu.types as ref_types
import paimon_tpu_torch.predicate as PortP
import paimon_tpu_torch.types as port_types
from paimon_tpu.core.dynamic_bucket import PartitionIndex as RefIndex
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu_torch.core.dynamic_bucket import PartitionIndex
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable


class Package:
    """One package's table API, so a scenario runs unchanged on both."""

    def __init__(self, name, schema, table, types, predicate, kwargs):
        self.name = name
        self.Schema = schema
        self.Table = table
        self.types = types
        self.P = predicate
        self.kwargs = kwargs

    def schema(self, columns, pk=("id",), partitions=(), options=None):
        """`columns`: (name, type name, nullable) triples."""
        b = self.Schema.builder()
        for name, typ, nullable in columns:
            t = self.types.VarCharType(nullable=nullable) \
                if typ == "VarCharType" else \
                getattr(self.types, typ)(nullable)
            b = b.column(name, t)
        if partitions:
            b = b.partition_keys(*partitions)
        return b.primary_key(*pk).options(dict(options or {})).build()

    def create(self, root, schema, name="t"):
        return self.Table.create(os.path.join(root, self.name, name),
                                 schema, **self.kwargs)

    def load(self, path, opts=None):
        return self.Table.load(path, dynamic_options=opts, **self.kwargs)


PORT = Package("port", Schema, FileStoreTable, port_types, PortP,
               {"device": "cpu"})
REF = Package("reference", RefSchema, RefTable, ref_types, RefP, {})
BOTH = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])

ID_V = [("id", "BigIntType", False), ("v", "DoubleType", True)]


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, row_kinds=kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def commit_arrow(table, batch, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(batch, kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def rows_by_id(table):
    return sorted(table.to_arrow().to_pylist(), key=lambda r: r["id"])


def dyn_table(pkg, root, opts=None, name="t"):
    options = {"write-only": "true", "dynamic-bucket.target-row-num": "100"}
    options.update(opts or {})
    return pkg.create(root, pkg.schema(ID_V, options=options), name)


def buckets_of(table):
    """{id: bucket} of every live row, read split by split."""
    out = {}
    rb = table.new_read_builder()
    for s in rb.new_scan().plan().splits:
        for i in rb.new_read().read_split(s).column("id").to_pylist():
            assert i not in out, f"id {i} in two buckets"
            out[i] = s.bucket
    return out


def hash_files(table):
    """{(partition bytes, bucket): index file bytes} of the latest
    snapshot's HASH index."""
    scan = table.new_scan()
    snap = table.snapshot_manager.latest_snapshot()
    out = {}
    for e in scan.index_manifest_file.read(snap.index_manifest):
        assert e.index_file.index_type == "HASH"
        path = scan.path_factory.index_file_path(e.index_file.file_name)
        data = table.file_io.read_bytes(path)
        assert len(data) == e.index_file.file_size == \
            4 * e.index_file.row_count
        out[(e.partition, e.bucket)] = data
    return out


# -- the cases of tests/test_dynamic_bucket.py, on both packages -----------

@BOTH
def test_dynamic_bucket_grows_with_data(tmp_path, pkg):
    table = dyn_table(pkg, str(tmp_path))
    commit(table, [{"id": i, "v": float(i)} for i in range(250)])
    splits = table.new_read_builder().new_scan().plan().splits
    assert len({s.bucket for s in splits}) == 3   # 250 keys / 100 a bucket
    assert table.to_arrow().num_rows == 250
    assert table.snapshot_manager.latest_snapshot().index_manifest


@BOTH
def test_dynamic_bucket_stable_assignment_across_writers(tmp_path, pkg):
    table = dyn_table(pkg, str(tmp_path))
    commit(table, [{"id": i, "v": 1.0} for i in range(150)])
    commit(table, [{"id": i, "v": 2.0} for i in range(150)])
    out = table.to_arrow()
    assert out.num_rows == 150
    assert set(out.column("v").to_pylist()) == {2.0}


@BOTH
def test_dynamic_bucket_upsert_and_compact(tmp_path, pkg):
    table = dyn_table(pkg, str(tmp_path))
    commit(table, [{"id": i, "v": float(i)} for i in range(120)])
    commit(table, [{"id": 5, "v": 999.0}])
    assert table.compact(full=True) is not None
    rows = {r["id"]: r["v"] for r in table.to_arrow().to_pylist()}
    assert rows[5] == 999.0
    assert len(rows) == 120


@BOTH
def test_delete_where_pk_table_writes_retractions(tmp_path, pkg):
    """The primary-key case of tests/test_deletion_vectors.py, on a
    fixed-bucket and a dynamic-bucket table."""
    for name, opts in (("fixed", {"bucket": "1"}), ("dyn", {})):
        table = pkg.create(str(tmp_path), pkg.schema(ID_V, options=opts),
                           name)
        commit(table, [{"id": i, "v": float(i)} for i in range(6)])
        table.delete_where(pkg.P.greater_than("v", 3.5))
        assert sorted(table.to_arrow().column("id").to_pylist()) == \
            [0, 1, 2, 3]
        assert table.delete_where(pkg.P.greater_than("v", 100.0)) is None


# -- equal to the reference, table for table --------------------------------

def seeded_batches(seed, commits=4, rows=300, key_range=700):
    rng = np.random.default_rng(seed)
    return [pa.table({
        "id": pa.array(rng.integers(0, key_range, rows), pa.int64()),
        "v": pa.array(rng.random(rows), pa.float64())})
        for _ in range(commits)]


def last_writer(batches):
    allt = pa.concat_tables(batches)
    ids = allt.column("id").to_numpy()
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    win = order[np.flatnonzero(np.r_[s[1:] != s[:-1], True])]
    return allt.take(pa.array(win)).to_pylist()


@pytest.mark.parametrize("seed", [3, 11])
def test_tables_equal_reference_and_cross_read(tmp_path, seed):
    """Same batches through both packages: the same bucket of every id,
    byte-equal index files, rows equal to the oracle before and after a
    full compaction, each package reading the other's table, and a
    writer of either package continuing the other's table."""
    batches = seeded_batches(seed)
    tables = {}
    for pkg in (PORT, REF):
        t = dyn_table(pkg, str(tmp_path))
        for b in batches:
            commit_arrow(t, b)
        tables[pkg.name] = t
    port, ref = tables["port"], tables["reference"]
    want = last_writer(batches)
    assert rows_by_id(port) == rows_by_id(ref) == want
    assert buckets_of(port) == buckets_of(ref)
    assert hash_files(port) == hash_files(ref)
    assert rows_by_id(REF.load(port.path)) == want
    assert rows_by_id(PORT.load(ref.path)) == want
    # each package continues the other's table: same buckets again
    more = seeded_batches(seed + 100, commits=1, key_range=1400)
    commit_arrow(PORT.load(ref.path), more[0])
    commit_arrow(REF.load(port.path), more[0])
    want = last_writer(batches + more)
    assert rows_by_id(port) == rows_by_id(ref) == want
    assert buckets_of(port) == buckets_of(ref)
    assert hash_files(port) == hash_files(ref)
    for t in (port, ref):
        assert t.compact(full=True) is not None
    assert rows_by_id(port) == rows_by_id(ref) == want
    assert rows_by_id(REF.load(port.path)) == want


# -- the vectorised assignment against the reference's PartitionIndex -------

def _same_index(ref, port):
    assert ref.bucket_counts == port.bucket_counts
    assert ref.dirty_buckets == port.dirty_buckets
    for b in ref.bucket_counts:
        assert np.array(ref.bucket_hashes(b), dtype=">i4").tobytes() == \
            port.bucket_hashes(b).astype(">i4").tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_assignment_equals_reference_seeded(seed):
    """Batches with duplicate hashes (a narrow key range), batches that
    cross the reference's 65,536-hash pending merge, partly full loaded
    buckets with gaps in their numbering, and a reload from the written
    index files mid-way."""
    rng = np.random.default_rng(seed)
    target = int(rng.integers(1, 5000))
    ref, port = RefIndex(target), PartitionIndex(target)
    if seed % 2:
        for b in (0, 2, 5):
            h = np.unique(rng.integers(-2**31, 2**31,
                                       int(rng.integers(0, target + 3))))
            ref.load_bucket(b, h)
            port.load_bucket(b, h)
    for step in range(6):
        n = int(rng.integers(0, 90_000))
        h = rng.integers(-2**31, 2**31, n) if step % 2 else \
            rng.integers(-4000, 4000, n)
        assert np.array_equal(ref.assign(h), port.assign(h))
        _same_index(ref, port)
        if step == 2:
            # reload both from the files the reference would write
            files = {b: np.array(ref.bucket_hashes(b), dtype=">i4")
                     for b in ref.bucket_counts}
            ref, port = RefIndex(target), PartitionIndex(target)
            for b, data in files.items():
                ref.load_bucket(b, np.frombuffer(data.tobytes(), ">i4"))
                port.load_bucket(b, np.frombuffer(data.tobytes(), ">i4"))
            ref.dirty_buckets, port.dirty_buckets = set(), set()


@settings(max_examples=40, deadline=None)
@given(target=st.integers(0, 40),
       loaded=st.lists(st.tuples(st.integers(0, 6),
                                 st.lists(st.integers(-50, 50),
                                          max_size=30, unique=True)),
                       max_size=3, unique_by=lambda x: x[0]),
       batches=st.lists(st.lists(st.integers(-60, 60), max_size=80),
                        max_size=5))
def test_assignment_equals_reference_hypothesis(target, loaded, batches):
    ref, port = RefIndex(target), PartitionIndex(target)
    seen = set()
    for b, hashes in loaded:
        hashes = [h for h in hashes if h not in seen]
        seen.update(hashes)
        ref.load_bucket(b, np.array(hashes, dtype=np.int64))
        port.load_bucket(b, np.array(hashes, dtype=np.int64))
    for batch in batches:
        h = np.array(batch, dtype=np.int64)
        assert np.array_equal(ref.assign(h), port.assign(h))
    _same_index(ref, port)


# -- the other planes on a dynamic-bucket table -------------------------------

@BOTH
def test_mesh_compact_option_on_dynamic_buckets(tmp_path, pkg):
    """tpu.mesh.compact routes a dynamic-bucket table's full compaction
    through the mesh engine in both packages, bucket by bucket."""
    table = dyn_table(pkg, str(tmp_path), {"tpu.mesh.compact": "true"})
    batches = seeded_batches(5, commits=3)
    for b in batches:
        commit_arrow(table, b)
    before = buckets_of(table)
    assert table.compact(full=True) is not None
    assert rows_by_id(table) == last_writer(batches)
    assert buckets_of(table) == before
    assert all(f.level > 0 for s in
               table.new_read_builder().new_scan().plan().splits
               for f in s.data_files)


def test_lookup_finds_every_bucket(tmp_path):
    """LocalTableQuery finds each key through the partition's hash index.
    The reference hashes the key into bucket 0 of 1 and misses the keys
    of every other bucket (ROADMAP.md C); the port equals the oracle."""
    from paimon_tpu.lookup import LocalTableQuery as RefQuery
    from paimon_tpu_torch.lookup import LocalTableQuery

    port, ref = dyn_table(PORT, str(tmp_path)), dyn_table(REF, str(tmp_path))
    batches = seeded_batches(9, commits=2)
    for t in (port, ref):
        for b in batches:
            commit_arrow(t, b)
    want = {r["id"]: r for r in last_writer(batches)}
    bucket = buckets_of(port)
    keys = [{"id": i} for i in sorted(want)] + [{"id": 10_000}]
    got = LocalTableQuery(port).lookup(keys)
    assert got == [want.get(k["id"]) for k in keys]
    ref_got = RefQuery(ref).lookup(keys)
    for k, g in zip(keys, ref_got):
        if k["id"] in want and bucket[k["id"]] == 0:
            assert g == want[k["id"]]
        else:
            assert g is None
    assert len(set(bucket.values())) > 1


def test_serving_gives_the_oracle_and_refuses_the_delta_tier(tmp_path):
    """The query service answers from the hash index; both packages
    refuse the delta tier for bucket < 1 with the same reason."""
    from paimon_tpu.service.delta import delta_ineligible_reason as ref_why
    from paimon_tpu_torch.service import KvQueryClient, KvQueryServer
    from paimon_tpu_torch.service.delta import delta_ineligible_reason

    port, ref = dyn_table(PORT, str(tmp_path)), dyn_table(REF, str(tmp_path))
    batches = seeded_batches(13, commits=2)
    for b in batches:
        commit_arrow(port, b)
    commit_arrow(ref, batches[0])
    assert delta_ineligible_reason(port) == ref_why(ref) is not None
    want = {r["id"]: r for r in last_writer(batches)}
    server = KvQueryServer(port).start()
    try:
        client = KvQueryClient(port)
        keys = [{"id": i} for i in sorted(want)[:50]] + [{"id": 99_999}]
        assert client.lookup(keys) == [want.get(k["id"]) for k in keys]
    finally:
        server.stop()


@pytest.mark.parametrize("producer", ["input", "lookup", "full-compaction"])
def test_changelog_producers_equal_reference(tmp_path, producer):
    """A dynamic-bucket table under each changelog producer: the stream
    of changes a consumer folds equals the reference's, and the batch
    read."""
    from tests.test_torch_changelog import drain, latest_scan

    opts = {"changelog-producer": producer, "write-only": "false"}
    if producer != "input":
        opts["changelog-file.format"] = "orc"
    out = {}
    for pkg in (PORT, REF):
        t = dyn_table(pkg, str(tmp_path), opts)
        commit(t, [{"id": i, "v": 0.0} for i in range(150)])
        scan = latest_scan(t)
        rng = np.random.default_rng(17)
        seen = []
        for _ in range(3):
            ids = rng.integers(0, 260, 60)
            commit(t, [{"id": int(i), "v": float(i) + 0.5} for i in ids])
            seen.extend(drain(t, scan))
        t.compact(full=True)
        seen.extend(drain(t, scan))
        out[pkg.name] = (sorted(seen, key=lambda r: sorted(r.items())),
                         rows_by_id(t))
    assert out["port"] == out["reference"]
    assert len(out["port"][0]) >= 150
