"""Deletion vectors of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_deletion_vectors.py run on both packages (see
tests/test_torch_append.py `reference_module`).  A deletion vector's
bytes and an index file's bytes, CRCs and ranges equal the reference's
over seeds; append tables deleted from by one package read the same in
both, with and without deletion-vectors.merge-on-read; both packages
write the same deletion-vector index files for the same deletes; a
compaction applies the vectors and drops their index entries, and the
delete-ratio threshold picks the same files; a primary-key table whose
snapshot carries a deletion vector masks the same rows.  Every value
compared is a row or a byte, so equality is exact.
"""

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu.index.deletion_vector import DeletionVector as RefDV
from paimon_tpu.index.deletion_vector import (
    DeletionVectorsIndexFile as RefDVFile,
)
from paimon_tpu_torch.fs import get_file_io
from paimon_tpu_torch.index.deletion_vector import (
    DeletionVector, DeletionVectorsIndexFile, read_deletion_vectors,
)
from tests.test_torch_append import (
    BOTH, PORT, REF, batches, commit_arrow, reference_cases, rows,
    run_reference_case,
)

CASES = reference_cases("test_deletion_vectors")


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


# -- the wire format ----------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_vector_and_index_file_bytes_equal_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    dvs = {}
    for k in range(4):
        n = int(rng.integers(1, 9000))
        dvs[f"data-{k}.parquet"] = rng.choice(200_000, n, replace=False)
    for pos in dvs.values():
        assert DeletionVector(pos).serialize() == RefDV(pos).serialize()
    fio = get_file_io(str(tmp_path))
    name, size, ranges = DeletionVectorsIndexFile(
        fio, str(tmp_path / "p")).write(
        {f: DeletionVector(p) for f, p in dvs.items()}, name="dv")
    ref = RefDVFile(fio, str(tmp_path / "r")).write(
        {f: RefDV(p) for f, p in dvs.items()}, name="dv")
    assert (name, size, ranges) == ref
    assert (tmp_path / "p" / "dv").read_bytes() == \
        (tmp_path / "r" / "dv").read_bytes()
    back = read_deletion_vectors(fio, str(tmp_path / "r" / "dv"), ranges)
    for f, pos in dvs.items():
        assert back[f].positions.tolist() == sorted(pos.tolist())
        keep = back[f].keep_mask(200_000)
        assert not keep[pos].any() and keep.sum() == 200_000 - len(pos)


# -- tables -------------------------------------------------------------------

def dv_files(table):
    """The latest snapshot's deletion-vector index files: (bytes,
    cardinality, ranges with the data files named by their first
    sequence number) sorted, so two packages' tables compare."""
    scan = table.new_scan()
    snap = table.snapshot_manager.latest_snapshot()
    seq = {f.file_name: (s.bucket, f.min_sequence_number)
           for s in table.new_read_builder().new_scan().plan().splits
           for f in s.data_files}
    out = []
    if not snap.index_manifest:
        return out
    for e in scan.index_manifest_file.read(snap.index_manifest):
        if e.index_file.index_type != "DELETION_VECTORS":
            continue
        data = table.file_io.read_bytes(
            scan.path_factory.index_file_path(e.index_file.file_name))
        assert len(data) == e.index_file.file_size
        out.append((e.bucket, data, e.index_file.row_count, sorted(
            (seq[f], r) for f, r in e.index_file.dv_ranges.items())))
    return sorted(out)


DELETES = [lambda P: P.less_than("id", 100),
           lambda P: P.equal("k", 3),
           lambda P: P.and_(P.greater_than("v", 0.5), P.less_than("k", 10))]


@pytest.mark.parametrize("opts", [
    {"bucket": "-1"}, {"bucket": "3", "bucket-key": "id"}])
@pytest.mark.parametrize("seed", [1, 8])
def test_deletes_write_equal_index_files(tmp_path, opts, seed):
    """The same writes and deletes on both packages leave the same
    deletion-vector index files and read the same rows."""
    tables = [pkg.create(str(tmp_path), opts) for pkg in (PORT, REF)]
    data = batches(seed, commits=3)
    for b in data:
        for t in tables:
            commit_arrow(t, b)
    for d in DELETES:
        sids = [t.delete_where(d(pkg.P))
                for t, pkg in zip(tables, (PORT, REF))]
        assert (sids[0] is None) == (sids[1] is None)
        assert dv_files(tables[0]) == dv_files(tables[1])
        assert rows(tables[0].to_arrow()) == rows(tables[1].to_arrow())
    assert dv_files(tables[0])


@BOTH
def test_deleted_table_cross_reads(tmp_path, writer):
    """Each package reads what the other deleted, with the mask and,
    under deletion-vectors.merge-on-read=false, without it."""
    t = writer.create(str(tmp_path), {"bucket": "2", "bucket-key": "id",
                                      "deletion-vectors.enabled": "true"})
    data = batches(4, commits=3)
    for b in data:
        commit_arrow(t, b)
    t.delete_where(DELETES[0](writer.P))
    other = REF if writer is PORT else PORT
    other.load(t.path).delete_where(DELETES[1](other.P))
    want = rows(pa.concat_tables(data).filter(
        (pa.compute.field("id") >= 100) & (pa.compute.field("k") != 3)))
    for pkg in (PORT, REF):
        assert rows(pkg.load(t.path).to_arrow()) == want
        raw = pkg.load(t.path, {"deletion-vectors.merge-on-read": "false"})
        assert rows(raw.to_arrow()) == rows(pa.concat_tables(data))
    for pred in (lambda P: P.greater_than("id", 900),
                 lambda P: P.equal("k", 3)):
        got = [rows(pkg.load(t.path).to_arrow(predicate=pred(pkg.P)))
               for pkg in (PORT, REF)]
        assert got[0] == got[1]


@BOTH
@pytest.mark.parametrize("threshold", ["0.2", "0.9"])
def test_compaction_applies_vectors_equal_reference(tmp_path, writer,
                                                    threshold):
    """A non-full compaction force-picks delete-heavy files by
    compaction.delete-ratio-threshold; a full one drops every vector.
    Both packages pick the same files and keep the same index files."""
    opts = {"bucket": "-1", "compaction.min.file-num": "10",
            "compaction.delete-ratio-threshold": threshold}
    tables = [pkg.create(str(tmp_path), opts) for pkg in (PORT, REF)]
    for b in batches(6, commits=4, rows=200):
        for t in tables:
            commit_arrow(t, b)
    for t, pkg in zip(tables, (PORT, REF)):
        t.delete_where(pkg.P.less_than("k", 8))       # ~40% of each file
    compactor = writer.load(tables[0].path), writer.load(tables[1].path)
    sids = [t.compact() for t in compactor]
    assert (sids[0] is None) == (sids[1] is None) == (threshold == "0.9")
    assert dv_files(tables[0]) == dv_files(tables[1])
    assert rows(tables[0].to_arrow()) == rows(tables[1].to_arrow())
    for t in compactor:
        # a bucket left as one file without vectors compacts no further
        assert (t.compact(full=True) is None) == (threshold == "0.2")
        assert dv_files(t) == []
    assert rows(tables[0].to_arrow()) == rows(tables[1].to_arrow())


@pytest.mark.parametrize("pred", [None, "id < 10"])
def test_primary_key_table_masks_vector_rows(tmp_path, pred):
    """A primary-key snapshot that carries a deletion vector (as a
    writer that writes them would leave it) reads without the masked
    rows in both packages: the merge-on-read and the raw read."""
    from paimon_tpu.manifest import FileKind, IndexFileMeta, IndexManifestEntry
    from paimon_tpu.core.commit import FileStoreCommit

    schema = (REF.Schema.builder().column("id", REF.big(False))
              .column("v", REF.dbl()).primary_key("id")
              .options({"bucket": "1"}).build())
    ref = REF.Table.create(str(tmp_path / "pk"), schema)
    commit_arrow(ref, pa.table({"id": pa.array(range(0, 20, 2), pa.int64()),
                                "v": pa.array(np.arange(10.0))}))
    commit_arrow(ref, pa.table({"id": pa.array(range(1, 20, 2), pa.int64()),
                                "v": pa.array(np.arange(10.0))}))
    split = ref.new_read_builder().new_scan().plan().splits[0]
    target = min(split.data_files, key=lambda f: f.min_sequence_number)
    name, size, ranges = RefDVFile(ref.file_io, f"{ref.path}/index").write(
        {target.file_name: RefDV(np.array([0, 3, 9]))})
    FileStoreCommit(ref.file_io, ref.path, ref.schema, ref.options).commit(
        [], index_entries=[IndexManifestEntry(
            FileKind.ADD, ref.new_scan()._partition_codec.to_bytes(()), 0,
            IndexFileMeta("DELETION_VECTORS", name,
                                                size, 3, dv_ranges=ranges))])
    want = sorted(set(range(20 if pred is None else 10)) - {0, 6, 18})
    for pkg in (PORT, REF):
        t = pkg.load(ref.path)
        got = t.to_arrow(predicate=None if pred is None
                         else pkg.P.less_than("id", 10))
        assert sorted(got.column("id").to_pylist()) == want


def bucket_dv_entries(table):
    """{bucket: number of deletion-vector index entries} of the latest
    snapshot."""
    scan = table.new_scan()
    snap = table.snapshot_manager.latest_snapshot()
    out = {}
    for e in scan.index_manifest_file.read(snap.index_manifest):
        if e.index_file.index_type == "DELETION_VECTORS":
            out[e.bucket] = out.get(e.bucket, 0) + 1
    return out


@pytest.mark.parametrize("opts", [
    {"bucket": "-1"}, {"bucket": "2", "bucket-key": "id"}])
def test_deletes_on_buckets_of_several_splits_equal_oracle(tmp_path, opts):
    """An append bucket bins into several splits when
    source.split.target-size is small; every split carries the whole
    bucket's vectors.  Two predicate deletes that hit files of different
    splits leave one index file a bucket, and the table reads the numpy
    oracle's rows, before and after a full compaction, in both packages.
    (The reference writes one index file a split here, and its second
    delete brings back rows of the first: ROADMAP.md C.)"""
    t = PORT.create(str(tmp_path), {
        **opts, "source.split.target-size": "4kb",
        "source.split.open-file-cost": "1kb"})
    data = batches(3, commits=6)
    for b in data:
        commit_arrow(t, b)
    splits = t.new_read_builder().new_scan().plan().splits
    per_bucket = {}
    for s in splits:
        per_bucket[s.bucket] = per_bucket.get(s.bucket, 0) + 1
    assert max(per_bucket.values()) > 1, per_bucket
    whole = pa.concat_tables(data)
    ids = whole.column("id").to_numpy()
    k = whole.column("k").to_numpy()
    keep = np.ones(len(ids), bool)
    for pred, drop in ((PORT.P.less_than("id", 150), ids < 150),
                       (PORT.P.equal("k", 7), k == 7)):
        assert t.delete_where(pred) is not None
        keep &= ~drop
        assert bucket_dv_entries(t) == {b: 1 for b in per_bucket}
        want = rows(whole.filter(pa.array(keep)))
        for pkg in (PORT, REF):
            assert rows(pkg.load(t.path).to_arrow()) == want
    assert t.compact(full=True) is not None
    assert dv_files(t) == []
    for pkg in (PORT, REF):
        assert rows(pkg.load(t.path).to_arrow()) == want


class _FlakySnapshotIO:
    """Delegates to a FileIO; reads of one snapshot file fail after
    the first (a store that errs for a moment)."""

    def __init__(self, inner, name):
        self._inner, self._name, self.reads = inner, name, 0

    def read_utf8(self, path):
        if path.endswith("/" + self._name):
            self.reads += 1
            if self.reads > 1:
                raise OSError(f"injected: {path}")
        return self._inner.read_utf8(path)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


@pytest.mark.parametrize("spec", [
    ("incremental-between", "1,5"),
    ("incremental-between-tag-to-snapshot", "t1,5")])
def test_incremental_reads_mask_end_snapshot_vectors(tmp_path, spec):
    """Incremental reads mask their files with the end snapshot's
    deletion vectors, read from the snapshot the planner resolved: a
    store that fails a second read of it cannot bring deleted rows
    back.  The reference equals the oracle on a store that does not
    fail."""
    t = PORT.create(str(tmp_path), {"bucket": "-1"})
    data = batches(5, commits=4)
    for b in data:
        commit_arrow(t, b)
    t.create_tag("t1", 1)
    t.delete_where(PORT.P.less_than("id", 300))     # snapshot 5
    rest = pa.concat_tables(data[1:])
    want = rows(rest.filter(pa.compute.field("id") >= 300))
    key, value = spec
    assert rows(REF.load(t.path, {key: value}).to_arrow()) == want
    io = _FlakySnapshotIO(t.file_io, "snapshot-5")
    got = PORT.Table.load(t.path, file_io=io, dynamic_options={key: value},
                          device="cpu")
    assert rows(got.to_arrow()) == want
