"""Cross-partition upsert (the primary key lacks the partition key) of
paimon_tpu_torch against paimon_tpu.

The cases of tests/test_cross_partition.py run on both packages; seeded
batches with partition moves (some twice in one batch), deletes routed
to where a key lives and CDC retract/insert pairs go through both
packages and a numpy-free oracle over several writers, on the
vectorised path (a BIGINT key) and the row path (a STRING key); each
package reads the other's table.  Rows are compared exactly.
"""

import os

import numpy as np
import pytest

from tests.test_torch_dynamic_bucket import (
    BOTH, PORT, REF, commit, hash_files,
)

COLS = [("id", "BigIntType", False), ("dt", "VarCharType", False),
        ("v", "DoubleType", True)]
OPTS = {"dynamic-bucket.target-row-num": "100", "write-only": "true"}


def make(pkg, root, key_type="BigIntType", name="t", opts=None):
    cols = [("id", key_type, False)] + COLS[1:]
    return pkg.create(root, pkg.schema(cols, partitions=("dt",),
                                       options={**OPTS, **(opts or {})}),
                      name)


def rows_of(table):
    return sorted(table.to_arrow().to_pylist(),
                  key=lambda r: (str(r["id"]), r["dt"]))


# -- the cases of tests/test_cross_partition.py, on both packages ----------

@BOTH
def test_partition_move_retracts_old_row(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "dt": "d1", "v": 1.0},
                   {"id": 2, "dt": "d1", "v": 2.0}])
    commit(table, [{"id": 1, "dt": "d2", "v": 10.0}])
    assert rows_of(table) == [{"id": 1, "dt": "d2", "v": 10.0},
                              {"id": 2, "dt": "d1", "v": 2.0}]


@BOTH
def test_partition_move_across_writers(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 7, "dt": "d1", "v": 1.0}])
    commit(pkg.load(table.path), [{"id": 7, "dt": "d3", "v": 3.0}])
    assert table.to_arrow().to_pylist() == [{"id": 7, "dt": "d3", "v": 3.0}]


@BOTH
def test_same_partition_upsert_is_plain(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "dt": "d1", "v": 1.0}])
    commit(table, [{"id": 1, "dt": "d1", "v": 2.0}])
    assert table.to_arrow().to_pylist() == [{"id": 1, "dt": "d1", "v": 2.0}]


@BOTH
def test_delete_routes_to_current_partition(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "dt": "d1", "v": 1.0}])
    commit(table, [{"id": 1, "dt": "d9", "v": 0.0}],
           kinds=[pkg.types.RowKind.DELETE])
    assert table.to_arrow().num_rows == 0


@BOTH
def test_within_batch_partition_move(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 5, "dt": "d1", "v": 1.0},
                   {"id": 5, "dt": "d2", "v": 2.0}])
    assert table.to_arrow().to_pylist() == [{"id": 5, "dt": "d2", "v": 2.0}]


@BOTH
def test_cdc_retract_then_insert_same_batch(tmp_path, pkg):
    rk = pkg.types.RowKind
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "dt": "d1", "v": 1.0}])
    commit(table, [{"id": 1, "dt": "d1", "v": 1.0},
                   {"id": 1, "dt": "d2", "v": 2.0}],
           kinds=[rk.UPDATE_BEFORE, rk.UPDATE_AFTER])
    assert table.to_arrow().to_pylist() == [{"id": 1, "dt": "d2", "v": 2.0}]


@BOTH
def test_persistent_index_shared_across_writers(tmp_path, pkg):
    table = make(pkg, str(tmp_path))
    commit(table, [{"id": 1, "dt": "d1", "v": 1.0},
                   {"id": 2, "dt": "d1", "v": 2.0}])
    commit(table, [{"id": 1, "dt": "d2", "v": 10.0}])
    idx_dir = os.path.join(table.path, "index", "cross-partition")
    assert any(f.endswith(".sst") for f in os.listdir(idx_dir))
    t2 = pkg.load(table.path)
    commit(t2, [{"id": 1, "dt": "d3", "v": 100.0}])
    rows = sorted(t2.to_arrow().to_pylist(), key=lambda r: r["id"])
    assert [(r["dt"], r["id"]) for r in rows] == [("d3", 1), ("d1", 2)]


# -- seeded scenarios: both packages and an oracle ---------------------------

def scenario(seed, commits=5, rows=120, keys=150, parts=4,
             repeat_keys=True):
    """Batches of (id, dt, v) with kinds: inserts that move keys between
    partitions (with `repeat_keys`, a key may move twice in one batch),
    deletes tagged with a random partition and CDC pairs (-U, +U)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        ids = rng.integers(0, keys, rows) if repeat_keys else \
            rng.permutation(keys)[:rows]
        dts = [f"d{p}" for p in rng.integers(0, parts, rows)]
        kinds = np.where(rng.random(rows) < 0.15, 3, 0).astype(np.int8)
        upd = rng.random(rows) < 0.1
        kinds[upd & (kinds == 0)] = 2
        kinds[np.flatnonzero(kinds[:-1] == 2) + 1] = 1
        out.append(([{"id": int(i), "dt": d, "v": float(k)}
                     for k, (i, d) in enumerate(zip(ids, dts))], kinds))
    return out


def oracle(batches):
    """Each id lives once, in the partition of its last write; a retract
    (-D or -U) removes it wherever it lives."""
    live = {}
    for rows, kinds in batches:
        for r, k in zip(rows, kinds):
            if k in (1, 3):
                live.pop(r["id"], None)
            else:
                live[r["id"]] = r
    return sorted(live.values(), key=lambda r: (str(r["id"]), r["dt"]))


@pytest.mark.parametrize("key_type", ["BigIntType", "VarCharType"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_moves_equal_reference_and_oracle(tmp_path, seed, key_type):
    """Writers alternate per commit between one long-lived writer and
    fresh table objects (each bootstraps the index from the table)."""
    batches = scenario(seed)
    if key_type == "VarCharType":
        batches = [([{**r, "id": f"k{r['id']:04d}"} for r in rows], kinds)
                   for rows, kinds in batches]
    result = {}
    for pkg in (PORT, REF):
        table = make(pkg, str(tmp_path), key_type)
        long_lived = table.new_batch_write_builder()
        w = long_lived.new_write()
        for k, (rows, kinds) in enumerate(batches):
            if k % 2:
                commit(pkg.load(table.path), rows, kinds)
                w.close()
                w = table.new_batch_write_builder().new_write()
            else:
                w.write_dicts(rows, row_kinds=list(kinds))
                long_lived.new_commit().commit(w.prepare_commit())
        w.close()
        scan = rows_of(table)
        table.compact(full=True)
        result[pkg.name] = (scan, rows_of(table))
    want = oracle(batches)
    assert result["port"] == (want, want)
    # the reference's rows hold the oracle's, and may hold stale rows of
    # keys moved after two upserts in one batch (see the next test)
    for rows in result["reference"]:
        assert all(r in rows for r in want)


@pytest.mark.parametrize("key_type", ["BigIntType", "VarCharType"])
def test_upserted_twice_then_moved_in_one_batch(tmp_path, key_type):
    """Two upserts of a new key in one partition, then a move, in one
    batch: the port keeps one row, in the last partition; the reference
    drops only the upsert just before the move and keeps the first as a
    stale row (ROADMAP.md C)."""
    key = 77 if key_type == "BigIntType" else "k77"
    rows = [{"id": key, "dt": "d2", "v": 7.0},
            {"id": key, "dt": "d2", "v": 48.0},
            {"id": key, "dt": "d1", "v": 87.0}]
    got = {}
    for pkg in (PORT, REF):
        table = make(pkg, str(tmp_path), key_type)
        commit(table, rows)
        got[pkg.name] = rows_of(table)
    assert got["port"] == [{"id": key, "dt": "d1", "v": 87.0}]
    assert got["reference"] == [{"id": key, "dt": "d1", "v": 87.0},
                                {"id": key, "dt": "d2", "v": 7.0}]


def test_cross_read_and_continue(tmp_path):
    """Each package reads the other's cross-partition table (index
    manifest included) and continues writing it, moving keys."""
    batches = scenario(7, commits=3, repeat_keys=False)
    port, ref = make(PORT, str(tmp_path)), make(REF, str(tmp_path))
    for t in (port, ref):
        for rows, kinds in batches:
            commit(t, rows, kinds)
    want = oracle(batches)
    assert rows_of(REF.load(port.path)) == rows_of(PORT.load(ref.path)) \
        == want
    assert hash_files(port) == hash_files(ref)
    more = scenario(8, commits=1, repeat_keys=False)
    commit(PORT.load(ref.path), *more[0])
    commit(REF.load(port.path), *more[0])
    want = oracle(batches + more)
    assert rows_of(port) == rows_of(ref) == want


def test_lookup_and_stream_scan(tmp_path):
    """Point lookups by (key, partition) and a streaming read of the
    moves: the port equals the oracle; the stream of changes equals the
    reference's."""
    from paimon_tpu.service.delta import delta_ineligible_reason as ref_why
    from paimon_tpu_torch.lookup import LocalTableQuery
    from paimon_tpu_torch.service.delta import delta_ineligible_reason
    from tests.test_torch_changelog import drain, latest_scan

    batches = scenario(4, commits=3, repeat_keys=False)
    streams = {}
    for pkg in (PORT, REF):
        t = make(pkg, str(tmp_path), opts={"changelog-producer": "input"})
        commit(t, *batches[0])
        scan = latest_scan(t)
        for rows, kinds in batches[1:]:
            commit(t, rows, kinds)
        streams[pkg.name] = sorted(drain(t, scan),
                                   key=lambda r: sorted(r.items()))
    assert streams["port"] == streams["reference"]
    want = oracle(batches)
    port = PORT.load(os.path.join(str(tmp_path), "port", "t"))
    # both refuse the serving delta tier for these tables, alike
    assert delta_ineligible_reason(port) == ref_why(
        REF.load(os.path.join(str(tmp_path), "reference", "t"))) is not None
    q = LocalTableQuery(port)
    for r in want[:40]:
        assert q.lookup([{"id": r["id"]}], (r["dt"],)) == [r]
        other = "d9" if r["dt"] != "d9" else "d8"
        assert q.lookup([{"id": r["id"]}], (other,)) == [None]


@pytest.mark.parametrize("key_type", ["BigIntType", "VarCharType"])
def test_index_in_ram_when_file_io_is_not_local(tmp_path, key_type):
    """read.cache.range wraps the table's FileIO, so the global index
    bootstraps into RAM instead of an SST; moves across writers still
    retract the old rows, in both packages."""
    batches = scenario(5, commits=3, repeat_keys=False)
    if key_type == "VarCharType":
        batches = [([{**r, "id": f"k{r['id']:04d}"} for r in rows], kinds)
                   for rows, kinds in batches]
    got = {}
    for pkg in (PORT, REF):
        table = make(pkg, str(tmp_path), key_type,
                     opts={"read.cache.range": "true"})
        for rows, kinds in batches:
            commit(pkg.load(table.path), rows, kinds)
        assert not os.path.exists(os.path.join(table.path, "index",
                                               "cross-partition"))
        got[pkg.name] = rows_of(table)
    assert got["port"] == got["reference"] == oracle(batches)


@pytest.mark.parametrize("producer", ["lookup", "full-compaction"])
def test_changelog_producers_and_query_service(tmp_path, producer):
    """A cross-partition table under the compaction changelog producers:
    the stream of changes equals the reference's; the query service
    answers (key, partition) lookups from the oracle."""
    from paimon_tpu_torch.service import KvQueryClient, KvQueryServer
    from tests.test_torch_changelog import drain, latest_scan

    batches = scenario(6, commits=3, repeat_keys=False)
    streams = {}
    for pkg in (PORT, REF):
        t = make(pkg, str(tmp_path), opts={
            "changelog-producer": producer, "write-only": "false",
            "changelog-file.format": "orc"})
        commit(t, *batches[0])
        scan = latest_scan(t)
        for rows, kinds in batches[1:]:
            commit(t, rows, kinds)
        t.compact(full=True)
        streams[pkg.name] = sorted(drain(t, scan),
                                   key=lambda r: sorted(r.items()))
        if pkg is PORT:
            port = t
    assert streams["port"] == streams["reference"]
    assert streams["port"]
    want = oracle(batches)
    server = KvQueryServer(port).start()
    try:
        client = KvQueryClient(port)
        for r in want[:30]:
            assert client.lookup([{"id": r["id"]}], (r["dt"],)) == [r]
    finally:
        server.stop()
