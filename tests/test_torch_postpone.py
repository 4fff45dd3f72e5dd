"""Postpone bucket mode (bucket=-2) of paimon_tpu_torch against
paimon_tpu: staged rows stay invisible until `rescale_postpone` moves
them into dynamic buckets.

The cases of tests/test_postpone.py run on both packages; the same
batches rescale to the same buckets and rows in both; each package
reads, and rescales, the other's staging.  Rows are compared exactly.
"""

import os

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dynamic_bucket import (
    BOTH, ID_V, PORT, REF, buckets_of, commit, commit_arrow, hash_files,
    last_writer, rows_by_id, seeded_batches,
)


def make(pkg, root, opts=None, name="t"):
    options = {"bucket": "-2", "write-only": "true",
               "dynamic-bucket.target-row-num": "100"}
    options.update(opts or {})
    return pkg.create(root, pkg.schema(ID_V, options=options), name)


# -- the cases of tests/test_postpone.py, on both packages -----------------

@BOTH
def test_postpone_staging_invisible_until_rescale(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": i, "v": float(i)} for i in range(250)])
    assert os.path.isdir(os.path.join(table.path, "bucket-postpone"))
    assert table.to_arrow().num_rows == 0
    assert table.rescale_postpone() is not None
    assert table.to_arrow().num_rows == 250
    buckets = {s.bucket for s in
               table.new_read_builder().new_scan().plan().splits}
    assert -2 not in buckets
    assert len(buckets) >= 2
    assert table.rescale_postpone() is None


@BOTH
def test_postpone_upserts_resolve_after_rescale(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "v": 1.0}])
    commit(table, [{"id": 1, "v": 2.0}])
    table.rescale_postpone()
    assert table.to_arrow().to_pylist() == [{"id": 1, "v": 2.0}]


@BOTH
def test_compact_skips_postpone_staging(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "v": 1.0}])
    table.rescale_postpone()
    commit(table, [{"id": 1, "v": 0.0}], kinds=[pkg.types.RowKind.DELETE])
    table.compact(full=True)
    table.rescale_postpone()
    assert table.to_arrow().num_rows == 0


# -- equal to the reference ---------------------------------------------------

@pytest.mark.parametrize("opts, per_bucket", [
    ({}, 5_000_000),
    ({"dynamic-bucket.target-row-num": "100"}, 100),
    ({"dynamic-bucket.target-row-num": "100",
      "postpone.target-row-num-per-bucket": "150"}, 150)])
def test_rescale_equals_reference_and_cross_read(tmp_path, opts,
                                                 per_bucket):
    """The same staged batches rescale to the same buckets, index files
    and rows in both packages: at the postpone default of 5,000,000 rows
    a bucket, at an explicit dynamic-bucket.target-row-num, and with the
    postpone knob, which wins over it; each package rescales the other's
    staging."""
    base = {"bucket": "-2", "write-only": "true"}
    batches = seeded_batches(21, commits=3)
    want = last_writer(batches)
    tables = {}
    for pkg in (PORT, REF):
        for name in ("own", "other"):
            t = pkg.create(str(tmp_path), pkg.schema(
                ID_V, options={**base, **opts}), name)
            for b in batches:
                commit_arrow(t, b)
            assert t.to_arrow().num_rows == 0
            tables[(pkg.name, name)] = t
    for pkg in (PORT, REF):
        assert tables[(pkg.name, "own")].rescale_postpone() is not None
    port, ref = tables[("port", "own")], tables[("reference", "own")]
    assert rows_by_id(port) == rows_by_id(ref) == want
    assert buckets_of(port) == buckets_of(ref)
    assert len(set(buckets_of(port).values())) == \
        -(-len(want) // per_bucket)
    assert hash_files(port) == hash_files(ref)
    # each package rescales the other's staging
    assert PORT.load(tables[("reference", "other")].path) \
        .rescale_postpone() is not None
    assert REF.load(tables[("port", "other")].path) \
        .rescale_postpone() is not None
    for pkg in (PORT, REF):
        other = tables[(pkg.name, "other")]
        assert rows_by_id(other) == want
        assert buckets_of(other) == buckets_of(port)
    # staging after a rescale lands in the existing buckets
    more = pa.table({"id": pa.array(np.arange(0, 700, 7), pa.int64()),
                     "v": pa.array(np.full(100, -1.0))})
    for t in (port, ref):
        commit_arrow(t, more)
        t.rescale_postpone()
    want = last_writer(batches + [more])
    assert rows_by_id(port) == rows_by_id(ref) == want
    assert buckets_of(port) == buckets_of(ref)
    assert rows_by_id(REF.load(port.path)) == want


@BOTH
def test_mesh_compact_leaves_staging(tmp_path, pkg):
    """tpu.mesh.compact on a postpone table compacts the rescaled
    buckets and leaves the staging for the next rescale, in both
    packages."""
    table = make(pkg, str(tmp_path), {"tpu.mesh.compact": "true"})
    batches = seeded_batches(23, commits=2)
    for b in batches:
        commit_arrow(table, b)
    table.rescale_postpone()
    more = seeded_batches(24, commits=1)
    commit_arrow(table, more[0])
    assert table.compact(full=True) is not None
    assert rows_by_id(table) == last_writer(batches)
    table.rescale_postpone()
    assert rows_by_id(table) == last_writer(batches + more)
