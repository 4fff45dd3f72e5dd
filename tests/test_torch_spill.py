"""paimon_tpu_torch's spilling writes against paimon_tpu.

With `write-buffer-spillable`, a bucket's full buffer becomes a local
key-sorted run; runs past `local-sort.max-num-file-handles` fold into
one, and prepare-commit stream-merges them into rolling L0 files.  Both
packages count the raw Arrow bytes buffered, so on the same writes they
spill, fold and roll at the same points: the L0 files must be equal file
for file (row counts, key ranges, levels), the rows equal row for row.
The port merges on device="cpu" (the kernel's plain version).  Inputs
are made with numpy from a seed; every comparison is exact.
"""

import glob
import os
import tempfile
import time

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dynamic_bucket import BOTH, PORT, REF

ENGINES = ["deduplicate", "first-row", "partial-update", "aggregation"]
SPILL = {"bucket": "2", "write-only": "true",
         "write-buffer-spillable": "true",
         "sort-spill-buffer-size": "6 kb",
         "local-sort.max-num-file-handles": "3",
         "target-file-size": "24 kb"}
COLS = [("id", "BigIntType", False), ("v1", "BigIntType", True),
        ("v2", "DoubleType", True), ("v3", "IntType", True)]


@pytest.fixture(autouse=True)
def _own_tempdir(tmp_path_factory, monkeypatch):
    """Spill directories go to a temporary directory of the test's own:
    tests in other processes that count those under the shared one
    (tests/test_wired_options.py) never see them."""
    monkeypatch.setattr(tempfile, "tempdir",
                        str(tmp_path_factory.mktemp("spills")))


def batches(seed=7, n=12, rows=400, keys=3000):
    """bench.py's rows at a small size: uniform ids in [0, keys)."""
    rng = np.random.default_rng(seed)
    return [pa.table({
        "id": pa.array(rng.integers(0, keys, rows), pa.int64()),
        "v1": pa.array(rng.integers(0, 1 << 40, rows), pa.int64()),
        "v2": pa.array(rng.random(rows), pa.float64()),
        "v3": pa.array(rng.integers(0, 100, rows).astype(np.int32),
                       pa.int32())}) for _ in range(n)]


def write_batches(table, data):
    """One batch commit of every batch; returns the new files'
    (bucket, rows, min_key, max_key, level) in message order."""
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    try:
        for b in data:
            w.write_arrow(b)
        msgs = w.prepare_commit()
        files = [(m.bucket, f.row_count, f.min_key, f.max_key, f.level)
                 for m in sorted(msgs, key=lambda m: m.bucket)
                 for f in m.new_files]
        wb.new_commit().commit(msgs)
    finally:
        w.close()
    return files


def key_of(raw: bytes) -> int:
    from paimon_tpu_torch.data.binary_row import BinaryRowCodec
    from paimon_tpu_torch.types import BigIntType
    return BinaryRowCodec([BigIntType(False)]).from_bytes(raw)[0]


def rows_of(table):
    return table.to_arrow().sort_by("id").to_pylist()


def run_both(tmp_path, options, data, cols=COLS):
    out = []
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), pkg.schema(cols, options=options))
        files = write_batches(t, data)
        out.append((files, rows_of(t), t))
    return out


@pytest.mark.parametrize("par", ["1", "4"])
@pytest.mark.parametrize("engine", ENGINES)
def test_spilled_writes_equal_reference_file_for_file(tmp_path, engine,
                                                      par):
    """Spills, folds and the final streamed merge give the reference's
    L0 files and rows, serial and pipelined, under every engine (the
    deferred engines sort their spills and keep every version)."""
    opts = {**SPILL, "merge-engine": engine,
            "write.flush.parallelism": par}
    if engine == "aggregation":
        opts["fields.v1.aggregate-function"] = "sum"
    (pf, prows, _), (rf, rrows, _) = run_both(tmp_path, opts, batches())
    assert pf == rf
    assert prows == rrows
    assert len(pf) > 2                      # the target size rolled files
    if engine in ("deduplicate", "first-row"):
        # a bucket's L0 files are sorted and key-disjoint (the deferred
        # engines keep every version, which a roll may split)
        for b in (0, 1):
            ranges = [(key_of(lo), key_of(hi))
                      for bb, _, lo, hi, _ in pf if bb == b]
            assert all(ranges[i][1] < ranges[i + 1][0]
                       for i in range(len(ranges) - 1))


def test_spill_count_and_folds_match_reference(tmp_path):
    """The writer's spill counter and its fold cadence: 12 writes of
    ~13 KB into one bucket spill 12 times at 6 KB; 3 handles fold."""
    opts = {**SPILL, "bucket": "1", "write.flush.parallelism": "1"}
    seen = []
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), pkg.schema(COLS, options=opts))
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        store = w._write
        for b in batches():
            w.write_arrow(b)
        (bw,) = store._writers.values()
        seen.append((bw._spills_scheduled, len(bw.spills)))
        wb.new_commit().commit(w.prepare_commit())
        w.close()
    assert seen[0] == seen[1]
    assert seen[0][0] == 12 and seen[0][1] <= 3


@pytest.mark.parametrize("writer, reader", [(PORT, REF), (REF, PORT)],
                         ids=["port_writes", "ref_writes"])
def test_spilled_table_cross_reads(tmp_path, writer, reader):
    t = writer.create(str(tmp_path), writer.schema(COLS, options=SPILL))
    write_batches(t, batches(seed=3))
    other = reader.load(t.path)
    assert rows_of(other) == rows_of(t)


@BOTH
@pytest.mark.parametrize("par", ["1", "4"])
def test_aggressive_spill_folding_exact_counts(tmp_path, pkg, par):
    """Spill names survive folds (max-num-file-handles=2 folds after
    every spill): counts are exact serial and pipelined, and
    changelog-producer=input counts each event once."""
    opts = {"bucket": "1", "write-only": "true",
            "changelog-producer": "input",
            "write-buffer-spillable": "true",
            "sort-spill-buffer-size": "4 kb",
            "local-sort.max-num-file-handles": "2",
            "write-buffer-size": "64 kb",
            "changelog-file.format": "orc",
            "write.flush.parallelism": par, "write.retry.backoff": "0"}
    t = pkg.create(str(tmp_path), pkg.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)],
        options=opts))
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        for b in range(10):
            w.write_dicts([{"id": b * 1000 + i, "v": float(b)}
                           for i in range(200)])
        wb.new_commit().commit(w.prepare_commit())
    assert t.to_arrow().num_rows == 2000
    assert t.snapshot_manager.latest_snapshot() \
        .changelog_record_count == 2000


def _spill_dirs():
    return set(glob.glob(os.path.join(tempfile.gettempdir(),
                                      "paimon-spill-*")))


@pytest.mark.parametrize("par", ["1", "4"])
def test_spill_dirs_cleaned_on_abort_and_commit(tmp_path, par):
    """close() without prepare_commit joins the pool and removes every
    spill directory; a committed write leaves none either."""
    # spills go to this test's own temporary directory (_own_tempdir):
    # other processes' spills stay out of the count
    opts = {"bucket": "1", "write-only": "true",
            "write-buffer-size": "10kb", "write-buffer-spillable": "true",
            "write.flush.parallelism": par}
    before = _spill_dirs()
    t = PORT.create(str(tmp_path), PORT.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)],
        options=opts))
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    for b in range(12):
        w.write_dicts([{"id": i, "v": float(b)} for i in range(400)])
    deadline = time.monotonic() + 5.0
    while not (_spill_dirs() - before) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _spill_dirs() - before, "no spill dir appeared mid-write"
    w.close()                     # abort: no prepare_commit
    assert _spill_dirs() == before
    assert t.snapshot_manager.latest_snapshot() is None

    wb = t.new_batch_write_builder()
    w = wb.new_write()
    for b in range(12):
        w.write_dicts([{"id": i, "v": float(b)} for i in range(400)])
    wb.new_commit().commit(w.prepare_commit())
    assert _spill_dirs() == before          # dropped on success
    w.close()
    assert t.to_arrow().num_rows == 400


def test_disk_cap_forces_flush_like_reference(tmp_path):
    """write-buffer-spill.max-disk-size: once the spilled bytes reach
    the cap, the next full buffer flushes to L0 instead of spilling.
    The early flushes are L0 files of their own, equal to the
    reference's."""
    opts = {**SPILL, "bucket": "1",
            "write-buffer-spill.max-disk-size": "8 kb",
            "write.flush.parallelism": "1"}
    (pf, prows, _), (rf, rrows, _) = run_both(tmp_path, opts, batches())
    nocap = {**SPILL, "bucket": "1", "write.flush.parallelism": "1"}
    (nf, _, _), _ = run_both(tmp_path / "nocap", nocap, batches())
    assert pf == rf and prows == rrows
    # early flushes overlap in key: more L0 files than the capless merge
    # and not all disjoint
    assert len(pf) > len(nf)
    assert len(prows) == len({r["id"] for r in prows})
