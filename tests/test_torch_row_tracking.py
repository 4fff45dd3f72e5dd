"""Row tracking and the global index of paimon_tpu_torch against
paimon_tpu.

The cases of tests/test_row_tracking.py run on both packages (see
tests/test_torch_append.py `reference_module`).  Row-tracked tables with
column overlays, row-id deletes and predicate deletes, written in turns
by both packages, read the same rows and row ids in both, before and
after the row-tracked compaction; a concurrent commit makes an update
replan.  The global index's parquet run and meta.json are the
reference's byte for byte, and its key order, computed on the device
(CPU here), is `pc.sort_indices`'s over seeds and the edge cases where
the lanes order otherwise: nulls, NaN, -0.0, strings that share their
16-byte prefix or hold zero bytes.  Every value compared is a row, a
row id or a byte, so equality is exact.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from paimon_tpu_torch.index.global_index import sort_indices
from tests.test_torch_append import (
    PORT, REF, reference_cases, run_reference_case,
)

CASES = reference_cases("test_row_tracking")


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


def tracked(pkg, root, name="t", **opts):
    schema = (pkg.Schema.builder().column("id", pkg.big(False))
              .column("name", pkg.vc.string_type())
              .column("score", pkg.dbl())
              .options({"bucket": "-1", "row-tracking.enabled": "true",
                        **opts}).build())
    return pkg.Table.create(os.path.join(root, pkg.name, name), schema,
                            **pkg.kwargs)


def write(table, n, start, seed):
    rng = np.random.default_rng(seed)
    wb = table.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({
            "id": pa.array(np.arange(start, start + n), pa.int64()),
            "name": pa.array([f"n{x}" for x in rng.integers(0, 30, n)]),
            "score": pa.array(rng.random(n), pa.float64())}))
        wb.new_commit().commit(w.prepare_commit())


def tracked_rows(table):
    t = table.to_arrow(with_row_ids=True)
    return sorted(zip(*[t.column(c).to_pylist() for c in t.column_names]),
                  key=lambda r: r[-1])


def steps(seed):
    """A seeded sequence of writes, updates and deletes; each step is
    run by one package, alternating."""
    rng = np.random.default_rng(seed)

    def upd(pkg, t, rids):
        rids = np.asarray(rids)
        return t.update_columns(rids, pa.table({
            "score": pa.array(rng.random(len(rids)))}))

    return [
        lambda pkg, t: write(t, 40, 0, seed),
        lambda pkg, t: write(t, 25, 40, seed + 1),
        lambda pkg, t: upd(pkg, t, rng.choice(65, 9, replace=False)),
        lambda pkg, t: t.delete_by_row_ids(rng.choice(65, 5, replace=False)),
        lambda pkg, t: t.update_columns(np.array([3, 41]), pa.table(
            {"name": ["u3", "u41"], "score": [3.5, 41.5]})),
        lambda pkg, t: t.delete_where(pkg.P.less_than("score", 0.2)),
        lambda pkg, t: write(t, 10, 65, seed + 2),
        lambda pkg, t: upd(pkg, t, [1, 2, 60, 70]),
    ]


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_alternating_writers_read_equal(tmp_path, seed):
    """One table, each step by the other package: both read the same
    rows and row ids after each step, and after the row-tracked
    compaction by either package."""
    t = tracked(PORT, str(tmp_path))
    pkgs = (PORT, REF)
    # the same steps on a reference-only table give the same result
    t_ref = tracked(REF, str(tmp_path), name="only")
    ref_steps, port_steps = steps(seed), steps(seed)
    for k, (step, ref_step) in enumerate(zip(port_steps, ref_steps)):
        pkg = pkgs[k % 2]
        step(pkg, pkg.load(t.path))
        ref_step(REF, t_ref)
        got = [tracked_rows(p.load(t.path)) for p in pkgs]
        assert got[0] == got[1] == tracked_rows(t_ref)
    before = tracked_rows(REF.load(t.path))
    assert pkgs[seed % 2].load(t.path).compact(full=True) is not None
    for p in pkgs:
        tb = p.load(t.path)
        assert tracked_rows(tb) == before
        assert tb.latest_snapshot().next_row_id == 75


def test_update_replans_after_concurrent_commit(tmp_path, monkeypatch):
    """An overlay planned against snapshot N is not published over a
    commit that landed meanwhile: the update replans and both changes
    survive."""
    from paimon_tpu_torch.core import commit as commit_mod
    t = tracked(PORT, str(tmp_path))
    write(t, 10, 0, 1)
    real = commit_mod.FileStoreCommit.commit
    calls = {"n": 0}

    def racing(self, *a, **k):
        if calls["n"] == 0 and k.get("expected_latest_id") is not None:
            calls["n"] += 1
            t.update_columns(np.array([2]), pa.table({"score": [-2.0]}))
        return real(self, *a, **k)

    monkeypatch.setattr(commit_mod.FileStoreCommit, "commit", racing)
    t.update_columns(np.array([5]), pa.table({"score": [-5.0]}))
    monkeypatch.setattr(commit_mod.FileStoreCommit, "commit", real)
    got = {r[-1]: r[2] for r in tracked_rows(t)}
    assert got[2] == -2.0 and got[5] == -5.0
    assert tracked_rows(t) == tracked_rows(REF.load(t.path))


# -- the global index ---------------------------------------------------------

def index_files(table, column):
    d = f"{table.path}/index/global/{column}"
    meta = json.loads(table.file_io.read_bytes(f"{d}/meta.json"))
    return meta, table.file_io.read_bytes(f"{d}/{meta['file']}")


@pytest.mark.parametrize("column", ["id", "name", "score"])
def test_global_index_files_equal_reference(tmp_path, column):
    tables = [tracked(pkg, str(tmp_path)) for pkg in (PORT, REF)]
    for t in tables:
        write(t, 300, 0, 4)
        write(t, 200, 1000, 6)
        t.delete_by_row_ids([1, 7, 333])
    built = [t.global_index(column) for t in tables]
    assert index_files(tables[0], column) == index_files(tables[1], column)
    assert built[0].row_ids.tolist() == built[1].row_ids.tolist()
    # each package loads the other's run without a rebuild
    for pkg, t in zip((REF, PORT), tables):
        gi = pkg.load(t.path).global_index(column)
        assert gi.row_ids.tolist() == built[0].row_ids.tolist()
    probe = built[0].keys.to_pylist()[::37] + (
        [123456789] if column == "id" else
        ["zz"] if column == "name" else [7.5])
    assert built[0].lookup(probe).tolist() == built[1].lookup(probe).tolist()
    v = built[0].keys[5].as_py()
    assert built[0].lookup_all(v).tolist() == built[1].lookup_all(v).tolist()


def _edge_arrays(seed):
    rng = np.random.default_rng(seed)
    n = 400
    prefix = "p" * 16
    strs = [None if rng.random() < 0.1 else
            (prefix + str(rng.integers(0, 50)) if rng.random() < 0.5 else
             "ab" + "\x00" * int(rng.integers(0, 3)) if rng.random() < 0.2
             else str(rng.integers(0, 60))) for _ in range(n)]
    floats = rng.choice(np.array([0.0, -0.0, np.nan, -np.nan, np.inf,
                                  -np.inf, 1.5, -1.5]), n)
    fmask = rng.random(n) < 0.1
    return {
        "int64": pa.array(rng.integers(-50, 50, n), pa.int64(),
                          mask=rng.random(n) < 0.1),
        "int32": pa.array(rng.integers(-5, 5, n).astype(np.int32)),
        "float64": pa.array(floats, pa.float64(), mask=fmask),
        "float32": pa.array(floats.astype(np.float32), pa.float32()),
        "string": pa.array(strs, pa.string()),
        "binary": pa.array([None if s is None else s.encode()
                            for s in strs], pa.binary()),
        "date": pa.array(rng.integers(0, 30, n).astype(np.int32),
                         pa.date32()),
        "bool": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
    }


@pytest.mark.parametrize("kind", ["int64", "int32", "float64", "float32",
                                  "string", "binary", "date", "bool"])
@pytest.mark.parametrize("seed", range(4))
def test_key_order_equals_pyarrow(kind, seed):
    """The device key order is pc.sort_indices's, ties in input order,
    nulls last, NaN after +inf, -0.0 tied with 0.0, strings past their
    16-byte prefix and with zero bytes in byte order."""
    keys = _edge_arrays(seed)[kind]
    want = np.asarray(pc.sort_indices(keys)).tolist()
    assert sort_indices(keys, "cpu").tolist() == want
    chunked = pa.chunked_array([keys.slice(0, 100), keys.slice(100)])
    assert sort_indices(chunked, "cpu").tolist() == want


def test_key_order_edge_cases_one_by_one():
    cases = [
        pa.array([3, None, 1, None, 2], pa.int64()),                 # nulls
        pa.array([np.nan, 1.0, np.inf, -np.nan, None, 0.5]),        # NaN
        pa.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0]),                # -0.0
        pa.array(["x" * 16 + "b", "x" * 16 + "a", "x" * 16,
                  "x" * 16 + "a"]),                                  # prefix
        pa.array(["ab\x00", "ab", "ab\x00\x00", "ab"]),              # zeros
        pa.array([], pa.int64()),
    ]
    for keys in cases:
        assert sort_indices(keys, "cpu").tolist() == \
            np.asarray(pc.sort_indices(keys)).tolist(), keys


def test_small_splits_keep_overlays_with_their_anchor(tmp_path):
    """With splits smaller than a row range's files, the reference bins
    an overlay apart from its anchor and reads its rows twice, with
    nulls in the columns it did not write (ROADMAP.md C); the port bins
    each range whole and reads the oracle's rows."""
    opts = {"source.split.target-size": "4kb",
            "source.split.open-file-cost": "1kb"}
    tables = [tracked(pkg, str(tmp_path), **opts) for pkg in (PORT, REF)]
    rids = np.arange(0, 800, 7)
    for t in tables:
        for i in range(4):
            write(t, 200, 200 * i, i)
        t.update_columns(rids, pa.table({"score": rids * 1.0}))
    port = tables[0].to_arrow(with_row_ids=True)
    assert port.num_rows == 800 and port.column("id").null_count == 0
    assert port.column("_ROW_ID").to_pylist() == list(range(800))
    assert port.column("id").to_pylist() == list(range(800))
    score = port.column("score").to_numpy()
    assert np.array_equal(score[rids], rids * 1.0)
    ref = tables[1].to_arrow(with_row_ids=True)
    assert ref.num_rows == 1600 and ref.column("id").null_count == 800
    # the same ranges, binned whole, are readable by the reference too
    # once their splits hold every file of a range
    whole = REF.load(tables[0].path, {"source.split.target-size": "1gb"})
    assert tracked_rows(whole) == tracked_rows(tables[0])


def test_deletes_on_buckets_of_several_splits_equal_oracle(tmp_path):
    """A row-tracked bucket binned into several splits: two row-id
    deletes and two predicate deletes, each over ranges of different
    splits, then the row-tracked compaction, read the numpy oracle's
    rows and row ids in both packages.  (The reference writes one
    deletion-vector file a split here, and a later delete brings back
    rows of an earlier one: ROADMAP.md C.)"""
    t = tracked(PORT, str(tmp_path), **{
        "source.split.target-size": "4kb",
        "source.split.open-file-cost": "1kb"})
    for i in range(4):
        write(t, 200, 200 * i, i)
    assert len(t.new_read_builder().new_scan().plan().splits) > 1
    rng = np.random.default_rng(11)
    # the rows written above, then overlays on a tenth of the scores
    rng_w = [np.random.default_rng(i) for i in range(4)]
    names = np.concatenate([[f"n{x}" for x in r.integers(0, 30, 200)]
                            for r in rng_w])
    score = np.concatenate([r.random(200) for r in rng_w])
    upd = np.sort(rng.choice(800, 80, replace=False))
    score[upd] = rng.random(80)
    t.update_columns(upd, pa.table({"score": pa.array(score[upd])}))
    alive = np.ones(800, bool)

    def check():
        want = [(i, str(names[i]), float(score[i]), i)
                for i in np.flatnonzero(alive)]
        assert tracked_rows(PORT.load(t.path)) == want
        # the reference reads the table once its splits hold whole
        # ranges (test_small_splits_keep_overlays_with_their_anchor)
        assert tracked_rows(REF.load(
            t.path, {"source.split.target-size": "1gb"})) == want

    for lo, hi in ((0, 800), (100, 700)):
        rids = np.sort(rng.choice(np.flatnonzero(alive[lo:hi]) + lo, 40,
                                  replace=False))
        assert t.delete_by_row_ids(rids) is not None
        alive[rids] = False
        check()
    for bound in (0.05, 0.1):
        assert t.delete_where(PORT.P.less_than("score", bound)) is not None
        alive &= ~(score < bound)
        check()
    assert t.compact(full=True) is not None
    check()
