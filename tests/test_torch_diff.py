"""paimon_tpu_torch/ops/diff.py against paimon_tpu/ops/diff.py.

The port ranks keys on a device (sort, neighbour-equality mask, running
count); here the device is the CPU, where the mask is the kernel's plain
version.  Inputs come from numpy seeds.  Every comparison is exact: ranks
are integers and diffs are table rows, compared row for row in order.
"""

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu.ops import diff as ref_diff
from paimon_tpu.ops.normkey import NormalizedKeyEncoder as RefEncoder
from paimon_tpu_torch.ops import diff
from paimon_tpu_torch.ops.merge import KIND_COL, SEQ_COL
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.types import RowKind


def same_rows(got: pa.Table, want: pa.Table) -> bool:
    """Equal schema and rows in the same order; a NaN equals a NaN (Arrow's
    own equality does not say so)."""
    def rows(t):
        return [{k: ("NaN" if isinstance(v, float) and v != v else v)
                 for k, v in r.items()} for r in t.to_pylist()]
    return got.schema == want.schema and rows(got) == rows(want)


def _encoders(types, nullable):
    return (NormalizedKeyEncoder(types, nullable=nullable),
            RefEncoder(types, nullable=nullable))


def _names(rng, n, distinct=400, long_every=3):
    """String keys, 1 in `long_every` longer than the 16-byte prefix and
    sharing it with others, so the disambiguation column is exercised."""
    ids = rng.integers(0, distinct, n)
    return [f"user-{i:06d}" + ("-profile-archive-" + str(i % 7)
                               if i % long_every == 0 else "")
            for i in ids.tolist()]


def _key_tables(kind, seed):
    """(tables, key columns, key types, nullable) for one key shape."""
    rng = np.random.default_rng(seed)
    sizes = (3000, 2500, 400)
    if kind == "bigint":
        tables = [pa.table({"k": pa.array(rng.integers(-5000, 5000, n),
                                          pa.int64())}) for n in sizes]
        return tables, ["k"], [pa.int64()], [False]
    if kind == "multi-column":
        tables = [pa.table({
            "a": pa.array(rng.integers(0, 20, n).astype(np.int32)),
            "b": pa.array(rng.integers(-3, 3, n), pa.int64()),
            "c": pa.array(rng.choice([-1.5, 0.0, 2.25, np.inf], n))})
            for n in sizes]
        return tables, ["a", "b", "c"], \
            [pa.int32(), pa.int64(), pa.float64()], [False] * 3
    if kind == "nullable":
        tables = []
        for n in sizes:
            vals = rng.integers(0, 50, n)
            mask = rng.random(n) < 0.1
            tables.append(pa.table({"k": pa.array(vals, pa.int64(),
                                                  mask=mask)}))
        return tables, ["k"], [pa.int64()], [True]
    tables = [pa.table({
        "s": pa.array(_names(rng, n)),
        "i": pa.array(rng.integers(0, 3, n).astype(np.int32))})
        for n in sizes]
    return tables, ["s", "i"], [pa.string(), pa.int32()], [False, True]


KEY_KINDS = ["bigint", "multi-column", "nullable", "truncated-strings"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_joint_key_ranks_equal_reference(kind, seed):
    tables, cols, types, nullable = _key_tables(kind, seed)
    enc, ref_enc = _encoders(types, nullable)
    got = diff.joint_key_ranks(tables, cols, enc, device="cpu")
    want = ref_diff.joint_key_ranks(tables, cols, ref_enc)
    plain = diff.joint_key_ranks_plain(tables, cols, enc)
    assert [len(g) for g in got] == [t.num_rows for t in tables]
    for g, w, p in zip(got, want, plain):
        assert g.dtype == np.int64
        assert np.array_equal(g, w)
        assert np.array_equal(p, w)
    # dense from 0
    allr = np.concatenate(got)
    assert allr.min() == 0 and np.unique(allr).size == allr.max() + 1


def test_truncated_keys_are_disambiguated():
    """Keys equal on their 16-byte prefix but not in full get different
    ranks, in full-key order."""
    keys = ["prefix-sixteen-b-zz", "prefix-sixteen-b-aa",
            "prefix-sixteen-b-aa", "prefix-sixteen-b"]
    t = pa.table({"s": pa.array(keys)})
    enc, ref_enc = _encoders([pa.string()], [False])
    got = diff.joint_key_ranks([t], ["s"], enc, device="cpu")[0]
    assert got.tolist() == [2, 1, 1, 0]
    assert np.array_equal(got, ref_diff.joint_key_ranks([t], ["s"],
                                                        ref_enc)[0])


@pytest.mark.parametrize("sizes", [(0, 0), (0, 5), (5, 0)])
def test_joint_key_ranks_empty_tables(sizes):
    tables = [pa.table({"k": pa.array(np.arange(n), pa.int64())})
              for n in sizes]
    enc, ref_enc = _encoders([pa.int64()], [False])
    got = diff.joint_key_ranks(tables, ["k"], enc, device="cpu")
    want = ref_diff.joint_key_ranks(tables, ["k"], ref_enc)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_ranks_go_through_the_kernel_wrapper(monkeypatch):
    """One neighbour-equality launch per rank computation, on the sorted
    lanes of every table at once, padded with invalid rows to a multiple
    of 4 (the card runs the CUDA kernel there)."""
    calls = []
    real = diff.eq_next_mask

    def spy(lanes, invalid, *args, **kwargs):
        calls.append((tuple(lanes.shape), int(invalid.sum())))
        return real(lanes, invalid, *args, **kwargs)

    monkeypatch.setattr(diff, "eq_next_mask", spy)
    tables, cols, types, nullable = _key_tables("bigint", 5)
    tables[-1] = tables[-1].slice(1)          # an odd total
    enc, _ = _encoders(types, nullable)
    diff.joint_key_ranks(tables, cols, enc, device="cpu")
    n = sum(t.num_rows for t in tables)
    assert n % 4 and calls == [((2, n + 4 - n % 4), 4 - n % 4)]


# -- keyed_changelog_diff ----------------------------------------------------

def _kv(keys, values, seq0=0):
    """A key-sorted, key-unique KV table: _KEY_k, seq, kind, k, v, w."""
    order = np.argsort(np.asarray(keys), kind="stable")
    keys = np.asarray(keys)[order]
    v = values["v"].take(pa.array(order))
    w = values["w"].take(pa.array(order))
    n = len(keys)
    return pa.table({
        "_KEY_k": pa.array(keys, pa.int64()),
        SEQ_COL: pa.array(np.arange(seq0, seq0 + n), pa.int64()),
        KIND_COL: pa.array(np.zeros(n, np.int8), pa.int8()),
        "k": pa.array(keys, pa.int64()),
        "v": v, "w": w})


def _values(rng, n, nan_share=0.0, null_share=0.0):
    v = rng.choice([0.5, 1.5, 2.5], n)
    v[rng.random(n) < nan_share] = np.nan
    w = rng.integers(0, 3, n)
    return {"v": pa.array(v, pa.float64(),
                          mask=rng.random(n) < null_share),
            "w": pa.array(w, pa.int64(), mask=rng.random(n) < null_share)}


def _diff_case(case, seed):
    rng = np.random.default_rng(seed)
    nb, na = 600, 700
    kb = rng.choice(1000, nb, replace=False)
    # after: most of before's keys, some dropped, some new
    keep = kb[rng.random(nb) < 0.85]
    new = rng.choice(np.setdiff1d(np.arange(2000), kb), na - len(keep),
                     replace=False)
    ka = np.concatenate([keep, new])
    nan = 0.3 if case == "nan" else 0.0
    null = 0.3 if case == "null" else 0.0
    before = _kv(kb, _values(rng, nb, nan, null))
    after_vals = _values(rng, na, nan, null)
    if case == "unchanged":
        # every kept key keeps its value: only -D and +I come out
        bv = dict(zip(before.column("k").to_pylist(),
                      zip(before.column("v").to_pylist(),
                          before.column("w").to_pylist())))
        v = [bv[k][0] if k in bv else float(rng.random()) for k in ka]
        w = [bv[k][1] if k in bv else 7 for k in ka]
        after_vals = {"v": pa.array(v, pa.float64()),
                      "w": pa.array(w, pa.int64())}
    after = _kv(ka, after_vals, seq0=nb)
    restrict = None
    if case == "restricted":
        touched = rng.choice(np.union1d(ka, kb), 150, replace=False)
        restrict = _kv(touched, _values(rng, len(touched)), seq0=5000)
    if case == "no-before":
        before = None
    return before, after, restrict


DIFF_CASES = ["upsert", "nan", "null", "unchanged", "restricted",
              "no-before"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", DIFF_CASES)
def test_keyed_changelog_diff_equals_reference(case, seed):
    before, after, restrict = _diff_case(case, seed)
    enc, ref_enc = _encoders([pa.int64()], [False])
    got = diff.keyed_changelog_diff(before, after, ["_KEY_k"], enc,
                                    ["k", "v", "w"],
                                    restrict_table=restrict, device="cpu")
    want = ref_diff.keyed_changelog_diff(before, after, ["_KEY_k"],
                                         ref_enc, ["k", "v", "w"],
                                         restrict_table=restrict)
    assert got.num_rows == want.num_rows
    assert same_rows(got, want)
    kinds = got.column(KIND_COL).to_pylist()
    # -D rows, then +I rows, then -U/+U pairs
    rank = {RowKind.DELETE: 0, RowKind.INSERT: 1,
            RowKind.UPDATE_BEFORE: 2, RowKind.UPDATE_AFTER: 2}
    assert [rank[k] for k in kinds] == sorted(rank[k] for k in kinds)
    pairs = kinds[kinds.index(RowKind.UPDATE_BEFORE):] \
        if RowKind.UPDATE_BEFORE in kinds else []
    assert pairs == [RowKind.UPDATE_BEFORE, RowKind.UPDATE_AFTER] * \
        (len(pairs) // 2)
    if case == "unchanged":
        assert RowKind.UPDATE_BEFORE not in kinds
    if case == "no-before":
        assert set(kinds) == {RowKind.INSERT}


def test_unchanged_nan_and_null_values_emit_nothing():
    keys = [1, 2, 3]
    vals = {"v": pa.array([np.nan, None, 1.0], pa.float64()),
            "w": pa.array([None, 5, 6], pa.int64())}
    before = _kv(keys, vals)
    after = _kv(keys, vals, seq0=3)
    enc, _ = _encoders([pa.int64()], [False])
    out = diff.keyed_changelog_diff(before, after, ["_KEY_k"], enc,
                                    ["k", "v", "w"], device="cpu")
    assert out.num_rows == 0


def test_string_keys_with_truncation_equal_reference():
    rng = np.random.default_rng(9)

    def kv(names, seq0):
        names = sorted(set(names))
        n = len(names)
        return pa.table({
            "_KEY_s": pa.array(names), SEQ_COL: pa.array(
                np.arange(seq0, seq0 + n), pa.int64()),
            KIND_COL: pa.array(np.zeros(n, np.int8), pa.int8()),
            "s": pa.array(names),
            "v": pa.array(rng.integers(0, 2, n), pa.int64())})

    before = kv(_names(rng, 300), 0)
    after = kv(_names(rng, 300), 1000)
    restrict = kv(_names(rng, 80), 2000)
    enc, ref_enc = _encoders([pa.string()], [False])
    for r in (None, restrict):
        got = diff.keyed_changelog_diff(before, after, ["_KEY_s"], enc,
                                        ["s", "v"], restrict_table=r,
                                        device="cpu")
        want = ref_diff.keyed_changelog_diff(before, after, ["_KEY_s"],
                                             ref_enc, ["s", "v"],
                                             restrict_table=r)
        assert same_rows(got, want)
