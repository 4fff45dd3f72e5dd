"""paimon_tpu_torch's read and write fault planes against paimon_tpu.

Copies of the reference's scan-pipeline and write-pipeline fault cases,
run on both packages where they exercise a table: a transient store
fault on a data-file read retries under `read.retry.*`, and on a flush
under `write.retry.*`; exhausted retries raise (never skipped as
corrupt, never a silently dropped flush); errors that are not transient
propagate without retry; undecodable bytes and missing planned files are
skipped under `scan.ignore-corrupt-files`; the `read.prefetch.max-bytes`
budget always admits one split; a failed flush poisons its pool and no
thread outlives a reader or writer; and `write.stage.dir` stages data
files locally, uploads them asynchronously, serves reads of in-flight
files and drains before commit.  Faults are injected by call count or
file name, never by timing, so every count is exact.  Also the deadline
of utils/backoff.py (ROADMAP.md C.6) on both packages.
"""

import collections
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dynamic_bucket import BOTH, PORT, REF

ID_V = [("id", "BigIntType", False), ("v", "DoubleType", True)]


def errors_of(pkg):
    """(TransientStoreError, CorruptDataError, is_transient_error) of one
    package."""
    if pkg is PORT:
        from paimon_tpu_torch.format.format import CorruptDataError
        from paimon_tpu_torch.fs.object_store import TransientStoreError
        from paimon_tpu_torch.parallel.fault import is_transient_error
    else:
        from paimon_tpu.format.format import CorruptDataError
        from paimon_tpu.fs.object_store import TransientStoreError
        from paimon_tpu.parallel.fault import is_transient_error
    return TransientStoreError, CorruptDataError, is_transient_error


def metric(pkg, group, name) -> int:
    if pkg is PORT:
        from paimon_tpu_torch.metrics import global_registry
    else:
        from paimon_tpu.metrics import global_registry
    return global_registry().group(group).counter(name).count


def make_table(pkg, root, seed=3, buckets=2, commits=3, rows=600,
               opts=None):
    """bench.py-shaped upserts: `commits` commits of `rows` rows with
    ids uniform in [0, rows), made from `seed`."""
    t = pkg.create(str(root), pkg.schema(ID_V, options={
        "bucket": str(buckets), "write-only": "true", **(opts or {})}))
    rng = np.random.default_rng(seed)
    for _ in range(commits):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write_arrow(pa.table({
            "id": pa.array(rng.integers(0, rows, rows), pa.int64()),
            "v": pa.array(rng.random(rows))}))
        wb.new_commit().commit(w.prepare_commit())
        w.close()
    return t


def rows_of(table):
    return table.to_arrow().sort_by("id").to_pylist()


def load(pkg, path, file_io=None, **opts):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg.Table.load(path, file_io=file_io,
                          dynamic_options=opts or None, **kw)


def _threads(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def _wait_no_threads(prefix, before=(), timeout=5.0):
    import gc
    gc.collect()
    before = set(before)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in _threads(prefix) if t not in before]:
            return []
        time.sleep(0.01)
    return [t for t in _threads(prefix) if t not in before]


def data_file(path):
    return path.rsplit("/", 1)[-1].startswith("data-")


class StormFileIO:
    """Each data file's read_bytes raises a 503 `per_path` times before
    succeeding (a passing transient storm)."""

    def __init__(self, inner, error, per_path=2):
        self.inner = inner
        self.error = error
        self.per_path = per_path
        self.counts = collections.Counter()
        self.lock = threading.Lock()
        self.faults = 0

    def read_bytes(self, path):
        if data_file(path):
            with self.lock:
                self.counts[path] += 1
                if self.counts[path] <= self.per_path:
                    self.faults += 1
                    raise self.error(f"503 on {path}")
        return self.inner.read_bytes(path)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# -- read retries -----------------------------------------------------------

@pytest.mark.parametrize("par", ["1", "4"])
def test_mid_scan_503_storm_retries_and_completes(tmp_path, par):
    got = []
    for pkg in (PORT, REF):
        transient = errors_of(pkg)[0]
        t = make_table(pkg, tmp_path / pkg.name)
        storm = StormFileIO(t.file_io, transient, per_path=2)
        r0 = metric(pkg, "scan", "read_retries")
        stormy = load(pkg, t.path, storm, **{
            "read.retry.backoff": "0", "scan.split.parallelism": par})
        rows = rows_of(stormy)
        assert rows == rows_of(t)
        assert storm.faults == 2 * len(storm.counts) > 0
        # every injected fault was one retry
        got.append((rows, metric(pkg, "scan", "read_retries") - r0
                    == storm.faults))
    assert got[0] == got[1]
    assert got[0][1]


@BOTH
def test_exhausted_transient_storm_raises_not_skipped(tmp_path, pkg):
    """A transient fault outliving read.retry.max-attempts raises, even
    under scan.ignore-corrupt-files: a 503 is never dropped as
    corrupt."""
    transient = errors_of(pkg)[0]
    t = make_table(pkg, tmp_path / "t")
    storm = StormFileIO(t.file_io, transient, per_path=10 ** 9)
    stormy = load(pkg, t.path, storm, **{
        "read.retry.backoff": "0", "read.retry.max-attempts": "2",
        "scan.ignore-corrupt-files": "true",
        "scan.split.parallelism": "4"})
    with pytest.raises(transient):
        stormy.to_arrow()
    assert not _wait_no_threads("paimon-scan"), "leaked scan threads"
    # each file read made exactly two attempts before the raise
    assert set(storm.counts.values()) == {2}


def test_decode_errors_are_not_transient():
    """The taxonomy: decode errors never retry, store faults do, in both
    packages alike."""
    for pkg in (PORT, REF):
        transient, corrupt, is_transient = errors_of(pkg)
        assert not is_transient(corrupt("corrupt page"))
        assert not is_transient(pa.ArrowInvalid("bad magic"))
        assert not is_transient(ValueError("schema bug"))
        assert is_transient(OSError("io fault"))
        assert is_transient(transient("503"))
        assert is_transient(FileNotFoundError("raced expiry"))


def _first_file(t):
    split = t.new_read_builder().new_scan().plan().splits[0]
    return f"{t.path}/bucket-{split.bucket}/{split.data_files[0].file_name}"


@pytest.mark.parametrize("damage", ["garbled_page", "not_parquet",
                                    "zeroed_head"])
def test_corrupt_file_skipped_when_opted_in(tmp_path, damage):
    """Undecodable bytes raise without the option and are skipped (with
    a warning) under scan.ignore-corrupt-files; both packages return the
    same rows: the oracle of the bucket's other files."""
    got = []
    for pkg in (PORT, REF):
        t = make_table(pkg, tmp_path / pkg.name, seed=17, buckets=1)
        path = _first_file(t)
        raw = bytearray(open(path, "rb").read())
        if damage == "garbled_page":
            mid = len(raw) // 3
            for i in range(mid, min(mid + 400, len(raw) - 100)):
                raw[i] ^= 0xA5
        elif damage == "not_parquet":
            raw = bytearray(b"not parquet at all")
        else:
            raw[:64] = b"\0" * 64
        os.remove(path)
        with open(path, "wb") as f:
            f.write(bytes(raw))
        if pkg is REF:
            from paimon_tpu.fs.caching import global_footer_cache
            global_footer_cache().clear()
        with pytest.raises(Exception):
            t.copy({"scan.split.parallelism": "4"}).to_arrow()
        lenient = t.copy({"scan.split.parallelism": "4",
                          "read.retry.backoff": "0",
                          "scan.ignore-corrupt-files": "true"})
        with pytest.warns(RuntimeWarning, match="corrupt"):
            got.append(rows_of(lenient))
    assert got[0] == got[1]
    assert 0 < len(got[0]) < 600


@BOTH
def test_missing_file_not_retried_and_skippable(tmp_path, pkg):
    """A planned-then-deleted file cannot reappear: no retry, and it is
    skippable like undecodable bytes."""
    t = make_table(pkg, tmp_path / "t", seed=19, buckets=1)
    os.remove(_first_file(t))
    r0 = metric(pkg, "scan", "read_retries")
    with pytest.raises(FileNotFoundError):
        t.copy({"scan.split.parallelism": "4"}).to_arrow()
    lenient = t.copy({"scan.split.parallelism": "4",
                      "scan.ignore-corrupt-files": "true"})
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert lenient.to_arrow().num_rows > 0
    assert metric(pkg, "scan", "read_retries") == r0


# -- the prefetch pipeline ---------------------------------------------------

def test_no_leaked_threads_after_read_and_after_abandon(tmp_path):
    t = make_table(PORT, tmp_path / "t", buckets=4)
    piped = t.copy({"scan.split.parallelism": "4"})
    piped.to_arrow()
    assert not _wait_no_threads("paimon-scan"), "leaked after read"
    rb = piped.new_read_builder()
    plan = rb.new_scan().plan()
    gen = rb.new_read()._read.iter_splits(plan.splits)
    next(gen)
    gen.close()                       # the consumer abandons mid-scan
    assert not _wait_no_threads("paimon-scan"), "leaked after abandon"


@BOTH
def test_prefetch_byte_budget_respected(tmp_path, pkg):
    """A 1-byte budget keeps exactly one split in flight (always
    admitting one); an ample budget pipelines."""
    if pkg is PORT:
        from paimon_tpu_torch.parallel.scan_pipeline import (
            iter_split_tables,
        )
    else:
        from paimon_tpu.parallel.scan_pipeline import iter_split_tables
    t = make_table(pkg, tmp_path / "t", buckets=4)
    rb = t.new_read_builder()
    splits = rb.new_scan().plan().splits
    assert len(splits) >= 2
    biggest = max(sum(f.file_size for f in s.data_files) for s in splits)
    read = rb.new_read()._read
    stats = {}
    opts = t.copy({"scan.split.parallelism": "4",
                   "read.prefetch.max-bytes": "1"}).options
    out = list(iter_split_tables(read, splits, opts, stats=stats))
    assert len(out) == len(splits)
    assert stats["max_inflight_splits"] == 1
    assert stats["peak_inflight_bytes"] <= biggest
    stats2 = {}
    ample = t.copy({"scan.split.parallelism": "4"}).options
    list(iter_split_tables(read, splits, ample, stats=stats2))
    assert stats2["max_inflight_splits"] > 1


def test_unordered_iteration_yields_every_split_once(tmp_path):
    from paimon_tpu_torch.parallel.scan_pipeline import iter_split_tables
    t = make_table(PORT, tmp_path / "t", buckets=4)
    rb = t.new_read_builder()
    splits = rb.new_scan().plan().splits
    read = rb.new_read()._read
    opts = t.copy({"scan.split.parallelism": "4"}).options
    ordered = [(i, tb.num_rows)
               for i, _, tb in iter_split_tables(read, splits, opts)]
    loose = sorted((i, tb.num_rows) for i, _, tb in
                   iter_split_tables(read, splits, opts, ordered=False))
    assert loose == ordered == [(i, n) for i, n in ordered]
    assert [i for i, _ in ordered] == list(range(len(splits)))


# -- write retries -----------------------------------------------------------

class WriteStormFileIO:
    """The first data-file write of every bucket directory raises a 503
    once (`first_per_dir`), or the first `faults` data-file writes in
    all fail: a passing storm whose size does not depend on timing."""

    def __init__(self, inner, error, faults=None):
        self.inner = inner
        self.error = error
        self.left = faults
        self.faults = 0
        self.dirs = set()
        self.lock = threading.Lock()

    def write_bytes(self, path, data, overwrite=True):
        if data_file(path):
            with self.lock:
                d = path.rsplit("/", 1)[0]
                if self.left is None:
                    fail = d not in self.dirs
                    self.dirs.add(d)
                else:
                    fail = self.left > 0
                    self.left -= fail
                if fail:
                    self.faults += 1
                    raise self.error(f"503 on {path}")
        return self.inner.write_bytes(path, data, overwrite=overwrite)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _storm_table(pkg, root, storm_faults=None, **opts):
    t = pkg.create(str(root), pkg.schema(ID_V, options={
        "bucket": "2", "write-only": "true"}))
    storm = WriteStormFileIO(t.file_io, errors_of(pkg)[0], storm_faults)
    return storm, load(pkg, t.path, storm, **{
        "write.flush.parallelism": "4", "write-buffer-size": "8 kb",
        "write.retry.backoff": "0", **opts})


@pytest.mark.parametrize("par", ["1", "4"])
def test_mid_write_503_storm_retries_and_completes(tmp_path, par):
    got = []
    for pkg in (PORT, REF):
        storm, t = _storm_table(pkg, tmp_path / pkg.name,
                                **{"write.flush.parallelism": par})
        r0 = metric(pkg, "write", "write_retries")
        wb = t.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_dicts([{"id": i, "v": float(i)} for i in range(2000)])
            wb.new_commit().commit(w.prepare_commit())
        retries = metric(pkg, "write", "write_retries") - r0
        got.append((storm.faults, retries, rows_of(t)))
    assert got[0] == got[1]
    assert got[0][0] == got[0][1] == 2      # one fault per bucket
    assert len(got[0][2]) == 2000


@BOTH
def test_exhausted_write_storm_raises_at_barrier(tmp_path, pkg):
    """A storm outliving write.retry.max-attempts raises the transient
    error at the prepare-commit barrier, and close() joins the
    workers; nothing is committed."""
    storm, t = _storm_table(pkg, tmp_path / "t", storm_faults=10 ** 9,
                            **{"write.retry.max-attempts": "2"})
    before = _threads("paimon-write")
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    try:
        with pytest.raises(errors_of(pkg)[0]):
            w.write_dicts([{"id": i, "v": float(i)} for i in range(2000)])
            w.prepare_commit()
    finally:
        w.close()
    assert not _wait_no_threads("paimon-write", before), "leaked threads"
    assert t.snapshot_manager.latest_snapshot() is None


@BOTH
def test_failed_prepare_commit_never_silently_commits(tmp_path, pkg):
    storm, t = _storm_table(pkg, tmp_path / "t", storm_faults=10 ** 9,
                            **{"write.retry.max-attempts": "2"})
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    try:
        with pytest.raises(errors_of(pkg)[0]):
            w.write_dicts([{"id": i, "v": float(i)} for i in range(2000)])
            w.prepare_commit()
        storm.left = 0                # the storm passes...
        with pytest.raises(RuntimeError, match="close this writer"):
            w.prepare_commit()        # ...but the writer is poisoned
    finally:
        w.close()
    assert t.snapshot_manager.latest_snapshot() is None


def test_non_transient_error_propagates_without_retry():
    from paimon_tpu_torch.parallel.write_pipeline import FlushPool
    pool = FlushPool(parallelism=4, max_bytes=1 << 20)
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("schema bug")

    pool.submit(("p", 0), 10, bad)
    with pytest.raises(ValueError, match="schema bug"):
        pool.drain()
    pool.shutdown()
    assert len(calls) == 1, "non-transient errors must not retry"


def test_transient_flush_task_retries_as_its_own_domain():
    """A task that fails transiently twice runs a third time (its own
    retry domain); the task queued after it on the same bucket runs
    once, after it."""
    from paimon_tpu_torch.fs.object_store import TransientStoreError
    from paimon_tpu_torch.options import CoreOptions
    from paimon_tpu_torch.parallel.write_pipeline import FlushPool
    opts = CoreOptions({"write.retry.backoff": "0"})
    pool = FlushPool(parallelism=2, max_bytes=1 << 30, options=opts)
    order = []

    def flaky():
        order.append("flaky")
        if order.count("flaky") < 3:
            raise TransientStoreError("503")

    pool.submit(("a", 0), 1, flaky)
    pool.submit(("a", 0), 1, lambda: order.append("next"))
    pool.drain()
    pool.shutdown()
    assert order == ["flaky", "flaky", "flaky", "next"]


def test_failed_drain_poisons_the_pool():
    from paimon_tpu_torch.parallel.write_pipeline import FlushPool
    pool = FlushPool(parallelism=2, max_bytes=1 << 30)

    def boom():
        raise ValueError("flush died")

    pool.submit(("a", 0), 1, boom)
    with pytest.raises(ValueError, match="flush died"):
        pool.drain()
    with pytest.raises(RuntimeError, match="close this writer"):
        pool.drain()
    with pytest.raises(RuntimeError, match="close this writer"):
        pool.submit(("a", 0), 1, lambda: None)
    pool.shutdown()


def test_error_cancels_queued_flushes():
    from paimon_tpu_torch.parallel.write_pipeline import FlushPool
    pool = FlushPool(parallelism=2, max_bytes=1 << 30)
    ran = []
    gate = threading.Event()

    def slow_fail():
        gate.wait(5)
        raise ValueError("boom")

    pool.submit(("a", 0), 1, slow_fail)
    for i in range(5):
        pool.submit(("a", 0), 1, lambda i=i: ran.append(i))
    gate.set()
    with pytest.raises(ValueError, match="boom"):
        pool.drain()
    pool.shutdown()
    assert ran == [], "queued tasks after the failure must be cancelled"


def test_no_leaked_threads_after_write_close(tmp_path):
    before = _threads("paimon-write")
    t = make_table(PORT, tmp_path / "t", commits=1, opts={
        "write.flush.parallelism": "4", "write-buffer-size": "16 kb"})
    assert not _wait_no_threads("paimon-write", before), "leaked threads"
    assert rows_of(t)


def test_flush_byte_budget_respected():
    from paimon_tpu_torch.parallel.write_pipeline import FlushPool
    pool = FlushPool(parallelism=4, max_bytes=1)
    for i in range(8):
        pool.submit(("b", i), 1000, lambda: time.sleep(0.005))
    pool.drain()
    pool.shutdown()
    assert pool.max_inflight_tasks == 1
    assert pool.peak_inflight_bytes <= 1000
    pool2 = FlushPool(parallelism=4, max_bytes=1 << 30)
    gate = threading.Event()
    for i in range(4):
        pool2.submit(("b", i), 1000, gate.wait)
    gate.set()
    pool2.drain()
    pool2.shutdown()
    assert pool2.max_inflight_tasks > 1


def test_same_bucket_flushes_never_overlap():
    from paimon_tpu_torch.parallel.write_pipeline import FlushPool
    pool = FlushPool(parallelism=4, max_bytes=1 << 30)
    order = []
    lock = threading.Lock()

    def task(i):
        with lock:
            order.append(("start", i))
        time.sleep(0.002)
        with lock:
            order.append(("end", i))

    for i in range(6):
        pool.submit(("pt", 7), 1, lambda i=i: task(i))
    pool.drain()
    pool.shutdown()
    assert order == [(p, i) for i in range(6) for p in ("start", "end")]


# -- upload staging ----------------------------------------------------------

def _ingest(t, n=4000, seed=5):
    rng = np.random.default_rng(seed)
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        for _ in range(4):
            w.write_arrow(pa.table({
                "id": pa.array(rng.integers(0, n, n // 4), pa.int64()),
                "v": pa.array(rng.random(n // 4))}))
        msgs = w.prepare_commit()
        stager = w._write._stager
        staged = stager.staged if stager is not None else None
        wb.new_commit().commit(msgs)
    return staged, sum(len(m.new_files) for m in msgs)


def test_staged_ingest_identical_and_durable(tmp_path):
    """Staged writes equal the reference's inline ones; every committed
    file is in the store (read through a fresh table object) and the
    stage directory is empty once the writer closed."""
    stage = tmp_path / "stage"
    opts = {"write-buffer-size": "16 kb", "write.stage.dir": str(stage)}
    port = make_table(PORT, tmp_path / "p", commits=0, opts=opts)
    ref = make_table(REF, tmp_path / "r", commits=0,
                     opts={"write-buffer-size": "16 kb"})
    staged, n_files = _ingest(port)
    _ingest(ref)
    assert staged == n_files > 0
    fresh = PORT.load(port.path)
    assert rows_of(fresh) == rows_of(ref)
    assert fresh.fsck().ok
    assert os.listdir(stage) == []


@BOTH
def test_staged_upload_retries_reread_staged_bytes(tmp_path, pkg):
    """Every data-file upload fails twice before landing: uploads retry
    from the staged bytes (each file staged exactly once) and count as
    write retries."""
    transient = errors_of(pkg)[0]

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
                        raise transient(f"503 on put {path}")
            return self.inner.write_bytes(path, data, overwrite=overwrite)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    base = make_table(pkg, tmp_path / "t", commits=0)
    puts = StormyPuts(base.file_io)
    t = load(pkg, base.path, puts, **{
        "write.stage.dir": str(tmp_path / "stage"),
        "write.retry.max-attempts": "5", "write.retry.backoff": "1 ms",
        "write-buffer-size": "16 kb"})
    r0 = metric(pkg, "write", "write_retries")
    staged, n_files = _ingest(t)
    assert staged == n_files > 0
    assert set(puts.attempts.values()) == {3}
    assert metric(pkg, "write", "write_retries") - r0 == 2 * n_files
    assert len(rows_of(t)) == len(rows_of(load(pkg, base.path)))


@BOTH
def test_staged_upload_failure_surfaces_at_barrier(tmp_path, pkg):
    transient = errors_of(pkg)[0]

    class DeadPuts:
        def __init__(self, inner):
            self.inner = inner

        def write_bytes(self, path, data, overwrite=True):
            if data_file(path):
                raise transient("503 forever")
            return self.inner.write_bytes(path, data, overwrite=overwrite)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    base = make_table(pkg, tmp_path / "t", commits=0)
    t = load(pkg, base.path, DeadPuts(base.file_io), **{
        "write.stage.dir": str(tmp_path / "stage"),
        "write.retry.max-attempts": "2", "write.retry.backoff": "1 ms"})
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    try:
        with pytest.raises(transient):
            w.write_dicts([{"id": i, "v": 1.0} for i in range(2000)])
            w.prepare_commit()
        with pytest.raises((RuntimeError, transient)):
            w.prepare_commit()
        with pytest.raises(RuntimeError, match="close this writer"):
            w.prepare_commit()
    finally:
        w.close()
    assert t.snapshot_manager.latest_snapshot() is None
    assert os.listdir(tmp_path / "stage") == []


def test_staged_file_is_read_before_its_upload_lands(tmp_path):
    """While an upload is held back, the writer's FileIO serves the
    staged bytes (compaction re-reading a fresh L0 file inside
    prepare_commit must not wait for the store), reports its size and
    existence, and the store gets the bytes once released."""
    from paimon_tpu_torch.fs import get_file_io
    from paimon_tpu_torch.parallel.write_pipeline import maybe_wrap_staging
    from paimon_tpu_torch.options import CoreOptions
    gate = threading.Event()

    class HeldPuts:
        def __init__(self, inner):
            self.inner = inner

        def write_bytes(self, path, data, overwrite=True):
            gate.wait(10)
            return self.inner.write_bytes(path, data, overwrite=overwrite)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    store = get_file_io(str(tmp_path))
    opts = CoreOptions({"write.stage.dir": str(tmp_path / "stage")})
    fio, stager = maybe_wrap_staging(HeldPuts(store), opts)
    path = str(tmp_path / "bucket-0" / "data-x-0.parquet")
    os.makedirs(tmp_path / "bucket-0")
    fio.write_bytes(path, b"payload-bytes", overwrite=False)
    assert not store.exists(path)
    assert fio.read_bytes(path) == b"payload-bytes"
    assert fio.read_range(path, 8, 5) == b"bytes"
    assert fio.exists(path) and fio.get_file_size(path) == 13
    gate.set()
    stager.drain()
    assert store.read_bytes(path) == b"payload-bytes"
    stager.close()
    assert not os.path.exists(stager.dir)


# -- request deadlines in the backoff (ROADMAP.md C.6) -----------------------

@BOTH
def test_backoff_pause_honours_the_request_deadline(pkg):
    """Under deadline_scope(50), Backoff(1000).pause() caps its first
    wait to the deadline and raises DeadlineExceededError at the next
    pause, within 0.2 s."""
    if pkg is PORT:
        from paimon_tpu_torch.utils.backoff import Backoff, wait_for
        from paimon_tpu_torch.utils.deadline import (
            DeadlineExceededError, deadline_scope,
        )
    else:
        from paimon_tpu.utils.backoff import Backoff, wait_for
        from paimon_tpu.utils.deadline import (
            DeadlineExceededError, deadline_scope,
        )
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        with deadline_scope(50):
            b = Backoff(1000)
            b.pause()
            b.pause()
    assert time.monotonic() - t0 < 0.2
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        with deadline_scope(50):
            wait_for(5.0)
            wait_for(5.0)
    assert time.monotonic() - t0 < 0.2
