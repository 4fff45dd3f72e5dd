"""Sort-compact and the curve keys of paimon_tpu_torch against
paimon_tpu.

The cases of tests/test_sort_compact.py run on both packages (see
tests/test_torch_append.py `reference_module`), all but three that need
a plane the port has not (the metrics registry's timers, csv and json
files, vector search).  The port's z-order and Hilbert keys and the
three permutations, ranked and sorted on the device (the CPU here),
equal `paimon_tpu.ops.zorder`'s and their own `*_plain` numpy versions
over seeds and 1-8 columns of integers, nullable integers, doubles with
NaN and -0.0, and strings that share their 16-byte prefix; z-order keys
with bit 63 set sort as unsigned; a bucket with 2^31 or more distinct
values of a column raises.  Sort-compacted tables are equal file for
file between the packages, deletion vectors applied, and each package
reads the other's.  Every value compared is a key, an index or a row,
so equality is exact.
"""

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.ops.zorder as ref_zorder
from paimon_tpu_torch.ops import zorder
from tests.test_torch_append import (
    BOTH, PORT, REF, batches, commit_arrow, reference_cases, rows,
    run_reference_case,
)

CASES = reference_cases("test_sort_compact", skip=(
    "test_metrics_registry", "test_csv_json_formats",
    "test_vector_search_batch_queries"))


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


# -- the curve keys -----------------------------------------------------------

def curve_table(seed, n=500):
    rng = np.random.default_rng(seed)
    prefix = "q" * 16
    return pa.table({
        "a": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        "b": pa.array(rng.integers(0, 7, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < 0.15),
        "c": pa.array(rng.choice(np.array([0.0, -0.0, np.nan, 1.25, -3.5,
                                           np.inf]), n), pa.float64()),
        "d": pa.array([prefix + str(x) if x % 3 else str(x)
                       for x in rng.integers(0, 40, n)], pa.string()),
        "e": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
        "f": pa.array(rng.random(n), pa.float64()),
        "g": pa.array(rng.integers(0, 3, n), pa.int64()),
        "h": pa.array(rng.integers(-5, 5, n).astype(np.int32), pa.int32()),
    })


COLUMN_SETS = [["a"], ["c"], ["d"], ["a", "b"], ["c", "d", "b"],
               ["a", "b", "c", "d"], ["e", "f", "g", "h", "a"],
               ["a", "b", "c", "d", "e", "f"],
               ["a", "b", "c", "d", "e", "f", "g"],
               ["a", "b", "c", "d", "e", "f", "g", "h"]]


@pytest.mark.parametrize("cols", COLUMN_SETS,
                         ids=["".join(c) for c in COLUMN_SETS])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_curves_equal_reference(cols, seed):
    t = curve_table(seed)
    z = zorder.z_index(t, cols, device="cpu")
    h = zorder.hilbert_index(t, cols, device="cpu")
    assert z.dtype == h.dtype == np.uint64
    assert np.array_equal(z, ref_zorder.z_index(t, cols))
    assert np.array_equal(z, zorder.z_index_plain(t, cols))
    assert np.array_equal(h, ref_zorder.hilbert_index(t, cols))
    assert np.array_equal(h, zorder.hilbert_index_plain(t, cols))
    for port_fn, ref_fn, plain_fn in (
            (zorder.z_order_permutation, ref_zorder.z_order_permutation,
             zorder.z_order_permutation_plain),
            (zorder.hilbert_permutation, ref_zorder.hilbert_permutation,
             zorder.hilbert_permutation_plain),
            (zorder.order_permutation, ref_zorder.order_permutation,
             zorder.order_permutation_plain)):
        got = port_fn(t, cols, device="cpu")
        assert got.tolist() == ref_fn(t, cols).tolist() == \
            plain_fn(t, cols).tolist()
    if len(cols) >= 2:
        # bit 63 is set on some rows, and the order is unsigned
        assert (z >= np.uint64(1 << 63)).any()
    assert (h < np.uint64(1 << 63)).all()


def test_prefix_sharing_strings_share_a_rank():
    """Strings equal in their first 16 bytes share a rank in both
    packages (the lanes are ranked as they are)."""
    t = pa.table({"s": ["k" * 16 + "b", "k" * 16 + "a", "a", "k" * 16]})
    z = zorder.z_index(t, ["s"], device="cpu")
    assert np.array_equal(z, ref_zorder.z_index(t, ["s"]))
    assert z[0] == z[1] == z[3] > z[2]


def test_empty_and_single_row_tables():
    for n in (0, 1):
        t = curve_table(3, n=n)
        for cols in (["a"], ["a", "d"]):
            assert zorder.z_order_permutation(t, cols, "cpu").tolist() == \
                ref_zorder.z_order_permutation(t, cols).tolist()
            assert zorder.order_permutation(t, cols, "cpu").tolist() == \
                ref_zorder.order_permutation(t, cols).tolist()


def test_rank_limit_raises(monkeypatch):
    """Scaled ranks are exact in int64 below 2^31 distinct values; a
    bucket with more raises instead of wrapping (lowered here to 16)."""
    monkeypatch.setattr(zorder, "_MAX_RANK", 16)
    t = pa.table({"a": pa.array(np.arange(40), pa.int64())})
    with pytest.raises(ValueError, match="2\\^31"):
        zorder.z_index(t, ["a"], device="cpu")
    small = pa.table({"a": pa.array(np.arange(16), pa.int64())})
    assert np.array_equal(zorder.z_index(small, ["a"], device="cpu"),
                          ref_zorder.z_index(small, ["a"]))


# -- sort-compacted tables ----------------------------------------------------

def data_files(table):
    """(bucket, rows, first sequence number, level) of every file, and
    the rows in file order."""
    rb = table.new_read_builder()
    files, out = [], []
    for s in rb.new_scan().plan().splits:
        for f in sorted(s.data_files, key=lambda f: f.min_sequence_number):
            files.append((s.bucket, f.row_count, f.min_sequence_number,
                          f.level))
        out.extend(rb.new_read().read_split(s).to_pylist())
    return files, out


@BOTH
@pytest.mark.parametrize("strategy, order_by", [
    ("zorder", ["id", "k"]), ("hilbert", ["v"]),
    ("hilbert", ["id", "k", "v", "name"]), ("order", ["name", "id"])])
def test_sort_compacted_tables_equal_reference(tmp_path, writer, strategy,
                                               order_by):
    opts = {"bucket": "2", "bucket-key": "id", "target-file-size": "8kb"}
    tables = [pkg.create(str(tmp_path), opts) for pkg in (PORT, REF)]
    for b in batches(12, commits=3):
        for t in tables:
            commit_arrow(t, b)
    for t, pkg in zip(tables, (PORT, REF)):
        t.delete_where(pkg.P.less_than("k", 3))
    for t in tables:
        other = REF if writer is PORT else PORT
        pkg = writer if t is tables[0] else other
        assert pkg.load(t.path).sort_compact(order_by, strategy) is not None
    assert data_files(tables[0]) == data_files(tables[1])
    for pkg in (PORT, REF):
        assert rows(pkg.load(tables[0].path).to_arrow()) == \
            rows(pkg.load(tables[1].path).to_arrow())
    snap = tables[0].latest_snapshot()
    assert snap.commit_kind == "COMPACT"
