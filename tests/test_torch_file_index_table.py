"""Per-file indexes on primary-key tables: paimon_tpu_torch against
paimon_tpu.

Both packages write the same seeded tables with bloom, bitmap,
bit-sliced and range-bitmap indexes (embedded in the manifest and as
`.index` sidecars); each reads the other's tables with the same planned
files and rows under the same predicates; the index blobs are byte-equal
after writes, full and mesh compactions and `rewrite_file_index`; a warm
plan cache plans as a cold planner after a rewrite; a retried indexed
write, expiry and orphan clean treat sidecars as the reference does.
The reference's primary-key cases of tests/test_file_index.py and
tests/test_bitmap_index.py run on both packages.  Every comparison is
exact.
"""

import collections
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dynamic_bucket import BOTH, PORT, REF

COLUMNS = [("id", "BigIntType", False), ("name", "VarCharType", True),
           ("v1", "BigIntType", True), ("v3", "IntType", True)]
INDEXES = {"file-index.bloom-filter.columns": "id,name",
           "file-index.bitmap.columns": "v3",
           "file-index.bsi.columns": "v3",
           "file-index.range-bitmap.columns": "v1"}
# embedded blobs under a large threshold, sidecars under a small one
THRESHOLDS = pytest.mark.parametrize("threshold", ["1 mb", "64"])


def batches(seed=3, commits=4, rows=300, keys=600):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        ids = rng.integers(0, keys, rows)
        out.append(pa.table({
            "id": pa.array(ids, pa.int64()),
            "name": pa.array([f"n{i % 50}" for i in ids]),
            "v1": pa.array(rng.integers(0, 1 << 40, rows), pa.int64()),
            "v3": pa.array(rng.integers(0, 100, rows).astype(np.int32))}))
    return out


def _absent_ids():
    seen = set(np.concatenate([b.column("id").to_numpy()
                               for b in batches()]).tolist())
    return [i for i in range(600) if i not in seen]


# ids inside every file's key range that no batch writes: only the
# indexes can skip files for them
ABSENT = _absent_ids()[:3]


def make(pkg, root, opts=None, seed=3, commits=4, name="t"):
    t = pkg.create(str(root), pkg.schema(COLUMNS, options={
        "bucket": "2", "write-only": "true", **(opts or {})}), name=name)
    for b in batches(seed, commits):
        write(t, b)
    return t


def write(t, batch):
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(batch)
        wb.new_commit().commit(w.prepare_commit())


def load(pkg, path, **opts):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg.Table.load(path, dynamic_options=opts or None, **kw)


def predicates(P):
    return {"id present": P.equal("id", 7),
            "id absent": P.equal("id", ABSENT[0]),
            "id in": P.in_("id", [5, 700, 900]),
            "id range": P.between("id", 10, 12),
            "name": P.equal("name", "n5"),
            "name absent": P.equal("name", "zz"),
            "v3 absent": P.equal("v3", 100), "v3 = 42": P.equal("v3", 42),
            "v3 < 3": P.less_than("v3", 3),
            "v1 high": P.greater_than("v1", 1 << 39),
            "and": P.and_(P.equal("id", 7), P.equal("v3", 42)),
            "or": P.or_(P.equal("id", ABSENT[1]),
                        P.equal("id", ABSENT[2]))}


def planned(t, pred):
    """(files planned, rows read sorted by id) under one predicate."""
    rb = t.new_read_builder().with_filter(pred)
    plan = rb.new_scan().plan()
    files = sum(len(s.data_files) for s in plan.splits)
    rows = rb.new_read().to_arrow(plan).sort_by("id").to_pylist()
    return files, rows


def plans(t, pkg):
    return {k: planned(t, p) for k, p in predicates(pkg.P).items()}


def entries(t):
    """Live entries by (bucket, level, min seq, max seq, rows)."""
    snap = t.snapshot_manager.latest_snapshot()
    out = {}
    for e in t.new_scan().read_entries(snap):
        f = e.file
        out[(e.bucket, f.level, f.min_sequence_number,
             f.max_sequence_number, f.row_count)] = e
    return out


def index_bytes(t):
    """Each live file's embedded blob or sidecar bytes."""
    out = {}
    for k, e in entries(t).items():
        f = e.file
        sidecars = [x for x in f.extra_files if x.endswith(".index")]
        assert sidecars == ([f.file_name + ".index"]
                            if f.embedded_index is None and sidecars
                            else sidecars)
        data = None
        if sidecars:
            path = os.path.join(t.path, f"bucket-{e.bucket}", sidecars[0])
            with open(path, "rb") as fh:
                data = fh.read()
        out[k] = (f.embedded_index, data)
    return out


def reset_plan_caches():
    from paimon_tpu.core.plan_cache import reset_plan_caches as ref_reset
    from paimon_tpu_torch.core.plan_cache import reset_plan_caches
    reset_plan_caches()
    ref_reset()


@pytest.fixture(autouse=True)
def _cold_plan_caches():
    reset_plan_caches()
    yield
    reset_plan_caches()


# -- cross-read and byte equality ---------------------------------------------

@THRESHOLDS
def test_tables_cross_read_with_equal_plans(tmp_path, threshold):
    opts = {**INDEXES, "file-index.in-manifest-threshold": threshold}
    tables = {pkg.name: make(pkg, tmp_path, opts) for pkg in (PORT, REF)}
    got = {(w, r.name): plans(load(r, tables[w].path), r)
           for w in tables for r in (PORT, REF)}
    want = got[("reference", "reference")]
    for k, v in got.items():
        assert v == want, k
    files = sum(len(s.data_files)
                for s in tables["port"].new_scan().plan().splits)
    assert files == 8
    assert want["id absent"][0] == 0 and want["name absent"][0] == 0
    assert want["v3 absent"] == (0, [])
    assert 0 < want["id present"][0] < 4       # bucket 1 holds 4 files
    assert [r["id"] for r in want["id present"][1]] == [7]


@THRESHOLDS
def test_index_blobs_byte_equal_reference(tmp_path, threshold):
    opts = {**INDEXES, "file-index.in-manifest-threshold": threshold}
    port, ref = (make(pkg, tmp_path, opts) for pkg in (PORT, REF))
    got, want = index_bytes(port), index_bytes(ref)
    assert got == want and len(got) == 8
    if threshold == "64":
        assert all(e is None and s for e, s in got.values())
    else:
        assert all(e and s is None for e, s in got.values())
    for t in (port, ref):
        t.compact(full=True)
    got, want = index_bytes(port), index_bytes(ref)
    assert got == want and len(got) == 2
    assert all(e is not None or s is not None for e, s in got.values())


def test_mesh_compaction_carries_indexes(tmp_path):
    """The mesh writer builds each output's indexes as the reference's
    mesh does (no in-manifest threshold is passed there: 500)."""
    port, ref = (make(pkg, tmp_path, INDEXES) for pkg in (PORT, REF))
    for t in (port, ref):
        assert t.copy({"tpu.mesh.compact": "true"}).compact(full=True) \
            is not None
    got = index_bytes(port)
    assert got == index_bytes(ref) and len(got) == 2
    assert all(s is not None for _, s in got.values())
    assert plans(port, PORT) == plans(ref, REF)


def test_manifest_compaction_and_stats_sidecar_keep_index_fields(tmp_path):
    opts = {**INDEXES, "file-index.in-manifest-threshold": "64",
            "manifest.merge-min-count": "1000"}
    port, ref = (make(pkg, tmp_path, opts) for pkg in (PORT, REF))
    def fields(t):
        return {k: (e.file.embedded_index, tuple(e.file.extra_files))
                for k, e in entries(t).items()}

    before = {t.path: fields(t) for t in (port, ref)}
    for t in (port, ref):
        assert t.compact_manifests(force=True) is not None
    reset_plan_caches()
    for t in (port, ref):
        assert fields(t) == before[t.path]
    assert index_bytes(port) == index_bytes(ref)
    # a partition-free table prunes by bucket through the stats sidecar
    for pkg, t in ((PORT, port), (REF, ref)):
        rb = t.new_read_builder().with_buckets([1]).with_filter(
            pkg.P.equal("id", ABSENT[0]))
        assert rb.new_scan().plan().splits == []
    assert plans(port, PORT) == plans(ref, REF)


# -- rewrite_file_index -------------------------------------------------------

def rewrite(pkg, t, force=False):
    if pkg is PORT:
        from paimon_tpu_torch.maintenance.repair import rewrite_file_index
    else:
        from paimon_tpu.maintenance.repair import rewrite_file_index
    return rewrite_file_index(t, force=force)


@THRESHOLDS
def test_rewrite_file_index_equals_reference(tmp_path, threshold):
    got = {}
    for pkg in (PORT, REF):
        t = make(pkg, tmp_path)
        with pytest.raises(ValueError, match="file-index"):
            rewrite(pkg, t)
        indexed = t.copy({"file-index.bloom-filter.columns": "id",
                          "file-index.in-manifest-threshold": threshold})
        n1 = rewrite(pkg, indexed)
        n2 = rewrite(pkg, indexed)             # nothing left unindexed
        after1 = index_bytes(indexed)
        p1 = plans(load(pkg, t.path), pkg)
        # a spec change needs force=True
        wider = indexed.copy(INDEXES)
        n3 = rewrite(pkg, wider, force=True)
        got[pkg.name] = (n1, n2, n3, after1, index_bytes(wider), p1,
                         plans(wider, pkg), wider.fsck().ok)
    assert got["port"] == got["reference"]
    n1, n2, n3 = got["port"][:3]
    assert (n1, n2, n3) == (8, 0, 8)
    assert got["port"][-1]


def test_rewrite_file_index_on_an_empty_table(tmp_path):
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), pkg.schema(COLUMNS, options={
            "bucket": "2", **INDEXES}))
        assert rewrite(pkg, t) == 0


def test_warm_plan_cache_equals_cold_after_rewrite(tmp_path):
    """A warm plan cache (and a scan object planned before) must not keep
    a file's "no index" answer once rewrite_file_index replaced its meta
    under the same file name."""
    t = make(PORT, tmp_path, {"file-index.in-manifest-threshold": "64"})
    ref = make(REF, tmp_path, {"file-index.in-manifest-threshold": "64"})
    pred = PORT.P.equal("id", ABSENT[0])
    held = t.new_scan().with_key_filter(pred)
    warm = {k: planned(t, p)[0] for k, p in predicates(PORT.P).items()}
    assert held.plan().splits and warm["id absent"] == 8
    indexed = t.copy(INDEXES)
    ref_indexed = ref.copy(INDEXES)
    assert rewrite(PORT, indexed) == rewrite(REF, ref_indexed) == 8
    warm_after = {k: planned(indexed, p)
                  for k, p in predicates(PORT.P).items()}
    assert held.plan().splits == []           # the same scan object
    reset_plan_caches()
    cold = plans(load(PORT, t.path, **INDEXES), PORT)
    assert warm_after == cold == plans(load(REF, t.path, **INDEXES), REF)
    assert cold["id absent"][0] == 0


class RewriteDuringRead:
    """A table's FileIO whose first vectored read of a sidecar first runs
    `rewrite` (every sidecar replaced under its name while a plan reads
    them by ranges)."""

    def __init__(self, inner, rewrite):
        self.inner, self.rewrite = inner, rewrite

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def read_ranges(self, path, ranges):
        if self.rewrite is not None and path.endswith(".index"):
            rewrite, self.rewrite = self.rewrite, None
            rewrite()
        return self.inner.read_ranges(path, ranges)


def _plan_files(scan):
    return sorted(f.file_name for s in scan.plan().splits
                  for f in s.data_files)


@pytest.mark.parametrize("when", ["held scan", "during the plan"])
def test_sidecar_replaced_while_a_scan_reads_it(tmp_path, monkeypatch, when):
    """rewrite_file_index(force=True) under another spec replaces each
    sidecar under its name, its entries at other offsets.  A scan that
    read the old headers before (a held scan asked a new column after the
    rewrite) or reads them while it happens plans every file that holds a
    match, as a cold planner does, and reads the same rows."""
    from paimon_tpu_torch.fs import get_file_io
    from paimon_tpu_torch.index import file_index
    monkeypatch.setattr(file_index, "SIDECAR_WINDOW", 16)   # all ranged
    t = make(PORT, tmp_path, {"file-index.bloom-filter.columns": "id",
                              "file-index.range-bitmap.columns": "v1",
                              "file-index.in-manifest-threshold": "64"})
    v1 = np.concatenate([b.column("v1").to_numpy() for b in batches()])
    key = PORT.P.equal("id", ABSENT[0])
    values = {"v1 absent": PORT.P.equal("v1", 3),
              "v1 present": PORT.P.equal("v1", int(v1[-1]))}

    def force():
        assert rewrite(PORT, load(PORT, t.path, **INDEXES), force=True) == 8

    if when == "held scan":
        held = {k: t.new_scan().with_key_filter(key) for k in values}
        assert all(_plan_files(s) == [] for s in held.values())
        force()
        got = {k: _plan_files(held[k].with_key_filter(None)
                              .with_value_filter(p))
               for k, p in values.items()}
    else:
        table = PORT.Table.load(t.path, device="cpu",
                                file_io=RewriteDuringRead(
                                    get_file_io(t.path), force))
        got = {k: _plan_files(table.new_scan().with_value_filter(p))
               for k, p in values.items()}
    reset_plan_caches()
    cold = load(PORT, t.path, **INDEXES)
    want = {k: _plan_files(cold.new_scan().with_value_filter(p))
            for k, p in values.items()}
    assert want["v1 absent"] == [] and want["v1 present"]
    # a file read across the rewrite reads as no index: it may be
    # planned in addition, never left out
    assert got["v1 present"] == want["v1 present"]
    assert set(got["v1 absent"]) <= set(_plan_files(cold.new_scan()))
    if when == "held scan":
        assert got == want
    for k, p in values.items():
        assert planned(t, p)[1] == planned(cold, p)[1]


# -- writes retried, expiry and orphan clean ----------------------------------

def data_file(path):
    return path.rsplit("/", 1)[-1].startswith("data-")


class WriteStorm:
    """The writes of data files and their sidecars numbered in `fail_at`
    (from 1, in call order) raise a transient error once."""

    def __init__(self, inner, error, fail_at):
        self.inner = inner
        self.error = error
        self.fail_at = set(fail_at)
        self.n = 0
        self.failed = []
        self.lock = threading.Lock()

    def write_bytes(self, path, data, overwrite=True):
        if data_file(path):
            with self.lock:
                self.n += 1
                if self.n in self.fail_at:
                    self.failed.append("sidecar" if path.endswith(".index")
                                       else "data")
                    raise self.error(f"503 on {path}")
        return self.inner.write_bytes(path, data, overwrite=overwrite)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def transient(pkg):
    if pkg is PORT:
        from paimon_tpu_torch.fs.object_store import TransientStoreError
    else:
        from paimon_tpu.fs.object_store import TransientStoreError
    return TransientStoreError


def write_retries(pkg):
    if pkg is PORT:
        from paimon_tpu_torch.metrics import global_registry
    else:
        from paimon_tpu.metrics import global_registry
    return global_registry().group("write").counter("write_retries").count


def live_sidecars_exist(t):
    for e in entries(t).values():
        for x in e.file.extra_files:
            assert os.path.exists(os.path.join(
                t.path, f"bucket-{e.bucket}", x)), x
    return True


@pytest.mark.parametrize("par", ["1", "4"])
def test_retried_indexed_write_matches_reference(tmp_path, par):
    """A data file or its sidecar failing to write retries the flush
    under fresh names (a data file failing after an earlier file's
    sidecar landed, a sidecar failing after its data file landed): no
    "file exists" error, the same retries and rows as the reference,
    every referenced sidecar present."""
    got = []
    for pkg in (PORT, REF):
        base = pkg.create(str(tmp_path), pkg.schema(COLUMNS, options={
            "bucket": "2", "write-only": "true", **INDEXES,
            "file-index.in-manifest-threshold": "64"}))
        storm = WriteStorm(base.file_io, transient(pkg), fail_at=(2, 5, 8))
        kw = {"device": "cpu"} if pkg is PORT else {}
        t = pkg.Table.load(base.path, file_io=storm, dynamic_options={
            "write.flush.parallelism": par, "write-buffer-size": "16 kb",
            "write.retry.max-attempts": "10", "write.retry.backoff": "0"},
            **kw)
        r0 = write_retries(pkg)
        for b in batches(commits=2):
            write(t, b)
        # which writes failed depends on the flush workers' order when
        # they run in parallel; the count does not
        kinds = storm.failed if par == "1" else len(storm.failed)
        got.append((kinds, write_retries(pkg) - r0,
                    plans(load(pkg, t.path), pkg), live_sidecars_exist(t),
                    t.fsck().ok))
    assert got[0] == got[1]
    assert got[0][1] == 3 and got[0][-1]
    if par == "1":
        assert got[0][0] == ["sidecar", "data", "data"]


@BOTH
def test_staged_indexed_upload_retries(tmp_path, pkg):
    """Under write.stage.dir the sidecar stages and uploads with its data
    file; uploads that fail twice retry from the staged bytes."""

    class StormyPuts:
        def __init__(self, inner):
            self.inner = inner
            self.attempts = collections.Counter()
            self.lock = threading.Lock()

        def write_bytes(self, path, data, overwrite=True):
            if data_file(path):
                with self.lock:
                    self.attempts[path] += 1
                    if self.attempts[path] <= 2:
                        raise transient(pkg)(f"503 on put {path}")
            return self.inner.write_bytes(path, data, overwrite=overwrite)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    base = pkg.create(str(tmp_path), pkg.schema(COLUMNS, options={
        "bucket": "2", "write-only": "true", **INDEXES,
        "file-index.in-manifest-threshold": "64"}))
    puts = StormyPuts(base.file_io)
    kw = {"device": "cpu"} if pkg is PORT else {}
    t = pkg.Table.load(base.path, file_io=puts, dynamic_options={
        "write.stage.dir": str(tmp_path / "stage"),
        "write.retry.max-attempts": "5", "write.retry.backoff": "1 ms"},
        **kw)
    for b in batches(commits=2):
        write(t, b)
    assert set(puts.attempts.values()) == {3}
    assert sum(p.endswith(".index") for p in puts.attempts) == 4
    fresh = load(pkg, base.path)
    assert live_sidecars_exist(fresh) and fresh.fsck().ok
    assert plans(fresh, pkg)["id absent"][0] == 0


def sidecar_names(t):
    names = []
    for d in sorted(os.listdir(t.path)):
        if d.startswith("bucket-"):
            names += [n for n in os.listdir(os.path.join(t.path, d))
                      if n.endswith(".index")]
    return names


def test_expiry_and_orphan_clean_handle_sidecars(tmp_path):
    got = {}
    for pkg in (PORT, REF):
        t = make(pkg, tmp_path, {**INDEXES,
                                 "file-index.in-manifest-threshold": "64",
                                 "snapshot.num-retained.min": "1",
                                 "snapshot.num-retained.max": "1"})
        n_written = len(sidecar_names(t))
        t.compact(full=True)
        live = {x for e in entries(t).values() for x in e.file.extra_files}
        t.expire_snapshots()
        after_expiry = len(sidecar_names(t))
        # a dead sidecar and a dead data file planted by a crashed writer
        bdir = os.path.join(t.path, "bucket-0")
        for n in ("data-orphan.parquet", "data-orphan.parquet.index"):
            with open(os.path.join(bdir, n), "wb") as f:
                f.write(b"x")
        old = time.time() - 7 * 86400
        for n in ("data-orphan.parquet", "data-orphan.parquet.index"):
            os.utime(os.path.join(bdir, n), (old, old))
        removed = t.remove_orphan_files(
            older_than_ms=int((time.time() - 86400) * 1000))
        left = set(sidecar_names(t))
        got[pkg.name] = (n_written, len(live), after_expiry,
                         sorted(os.path.basename(p) for p in removed
                                if "orphan" in p),
                         left == live, plans(t, pkg))
    assert got["port"] == got["reference"]
    n_written, n_live, after_expiry, removed, kept, _ = got["port"]
    assert n_written == 8 and n_live == after_expiry == 2
    assert removed == ["data-orphan.parquet", "data-orphan.parquet.index"]
    assert kept


# -- the reference's primary-key cases ----------------------------------------

def _commit(t, rows):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows)
    wb.new_commit().commit(w.prepare_commit())
    w.close()


def _files(plan):
    return sum(len(s.data_files) for s in plan.splits)


@BOTH
def test_scan_skips_files_via_bloom(tmp_path, pkg):
    t = pkg.create(str(tmp_path), pkg.schema(
        [("id", "BigIntType", False), ("name", "VarCharType", True),
         ("v", "DoubleType", True)], options={
            "bucket": "1", "write-only": "true",
            "file-index.bloom-filter.columns": "id,name"}))
    _commit(t, [{"id": i, "name": f"n{i}", "v": float(i)}
                for i in range(0, 100)])
    _commit(t, [{"id": i, "name": f"n{i}", "v": float(i)}
                for i in range(1000, 1100)])
    assert all(e.file.embedded_index for e in entries(t).values())
    rb = t.new_read_builder().with_filter(pkg.P.equal("id", 1050))
    plan = rb.new_scan().plan()
    assert _files(plan) == 1
    assert rb.new_read().to_arrow(plan).to_pylist() == \
        [{"id": 1050, "name": "n1050", "v": 1050.0}]
    # a value predicate keeps the whole bucket, or drops it whole
    rb2 = t.new_read_builder().with_filter(pkg.P.equal("name", "n42"))
    plan2 = rb2.new_scan().plan()
    assert _files(plan2) == 2
    assert rb2.new_read().to_arrow(plan2).column("id").to_pylist() == [42]
    for pred in (pkg.P.equal("name", "absent"), pkg.P.equal("id", 555)):
        assert t.new_read_builder().with_filter(pred).new_scan() \
            .plan().splits == []


@BOTH
def test_bloom_survives_compaction(tmp_path, pkg):
    t = pkg.create(str(tmp_path), pkg.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)], options={
            "bucket": "1", "write-only": "true",
            "file-index.bloom-filter.columns": "id"}))
    _commit(t, [{"id": 1, "v": 1.0}])
    _commit(t, [{"id": 2, "v": 2.0}])
    t.compact(full=True)
    assert all(e.file.embedded_index for e in entries(t).values())
    rb = t.new_read_builder().with_filter(pkg.P.equal("id", 2))
    assert rb.new_read().to_arrow(rb.new_scan().plan()) \
        .column("v").to_pylist() == [2.0]


@pytest.mark.parametrize("index", ["file-index.bloom-filter.columns",
                                   "file-index.bitmap.columns"])
@BOTH
def test_value_filter_never_drops_newer_versions(tmp_path, pkg, index):
    """A value predicate matching only an older version of a key must
    not resurrect it by pruning the newer file."""
    t = pkg.create(str(tmp_path), pkg.schema(
        [("id", "BigIntType", False), ("name", "VarCharType", True)],
        options={"bucket": "1", "write-only": "true", index: "name"}))
    _commit(t, [{"id": 1, "name": "old"}, {"id": 2, "name": "nyc"}])
    _commit(t, [{"id": 1, "name": "new"}])
    assert t.to_arrow(predicate=pkg.P.equal("name", "old")).num_rows == 0


@BOTH
def test_bloom_sidecar_above_threshold(tmp_path, pkg):
    t = pkg.create(str(tmp_path), pkg.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)], options={
            "bucket": "1", "write-only": "true",
            "file-index.bloom-filter.columns": "id",
            "file-index.in-manifest-threshold": "64"}))
    _commit(t, [{"id": i, "v": float(i)} for i in range(5000)])
    es = list(entries(t).values())
    assert all(e.file.embedded_index is None for e in es)
    assert all(any(x.endswith(".index") for x in e.file.extra_files)
               for e in es)
    rb = t.new_read_builder().with_filter(pkg.P.equal("id", 99999))
    assert rb.new_scan().plan().splits == []


def test_missing_sidecar_reads_as_no_index(tmp_path):
    """A sidecar deleted out of band skips nothing, in both packages."""
    got = []
    for pkg in (PORT, REF):
        t = make(pkg, tmp_path, {**INDEXES,
                                 "file-index.in-manifest-threshold": "64"})
        e = next(iter(entries(t).values()))
        os.remove(os.path.join(t.path, f"bucket-{e.bucket}",
                               e.file.extra_files[0]))
        reset_plan_caches()
        got.append(plans(load(pkg, t.path), pkg))
    assert got[0] == got[1]
