"""paimon_tpu_torch's point-lookup plane against paimon_tpu's.

Counterparts of tests/test_sst_lookup.py and of the probe and
LocalTableQuery cases of tests/test_native_serving.py and
tests/test_query_serving.py.  Every scenario runs on both packages over
one table directory (written by either package) with the same seeded
inputs, and the answers are compared: rows exactly, float aggregates
within rtol 1e-12.  SST files written by either package are probed by
the other, and the port's native probe is held against its numpy walk.
Both packages run on the CPU (the port with device="cpu").
"""

import os
import threading

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.lookup.sst as ref_sst
from paimon_tpu.lookup import LocalTableQuery as RefQuery
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import IntType as RefInt
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch import native
from paimon_tpu_torch.lookup import LocalTableQuery
from paimon_tpu_torch.lookup import sst
from paimon_tpu_torch.metrics import (
    LOOKUP_FILES_PRUNED, LOOKUP_NATIVE_FALLBACKS, LOOKUP_NATIVE_PROBES,
    LOOKUP_READER_BUILDS, global_registry,
)
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import (
    BigIntType, DoubleType, IntType, RowKind, VarCharType,
)

HAS_PROBE = native.load() is not None and \
    hasattr(native.load(), "sst_probe_batch")
needs_probe = pytest.mark.skipif(not HAS_PROBE,
                                 reason="no C compiler for native/probe.c")


class Package:
    """One package's table API, so a scenario runs unchanged on both."""

    def __init__(self, name, schema, table, query, types, kwargs):
        self.name = name
        self.Schema = schema
        self.Table = table
        self.Query = query
        self.big, self.dbl, self.int, self.varchar = types
        self.kwargs = kwargs

    def create(self, path, columns, pk, opts, partition=()):
        b = self.Schema.builder()
        for name, kind in columns:
            b = b.column(name, {
                "id": lambda: self.big(False), "double": self.dbl,
                "int": self.int, "pint": lambda: self.int(False),
                "string": self.varchar.string_type,
                "skey": lambda: self.varchar.string_type(False)}[kind]())
        if partition:
            b = b.partition_keys(*partition)
        options = {"write-only": "true"}
        options.update(opts)
        return self.Table.create(path, b.primary_key(*pk).options(options)
                                 .build(), **self.kwargs)

    def load(self, path, opts=None):
        return self.Table.load(path, dynamic_options=opts, **self.kwargs)


PORT = Package("port", Schema, FileStoreTable, LocalTableQuery,
               (BigIntType, DoubleType, IntType, VarCharType),
               {"device": "cpu"})
REF = Package("reference", RefSchema, RefTable, RefQuery,
              (RefBigInt, RefDouble, RefInt, RefVarChar), {})
PACKAGES = {"port": PORT, "reference": REF}
NAME_COLS = [("id", "id"), ("name", "string")]


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, row_kinds=kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def lookups(path, keys, tmp_path, partition=(), opts=None):
    """{package: answers} of both packages' LocalTableQuery over the
    table at `path`, each with its own SST directory."""
    out = {}
    for name, pkg in PACKAGES.items():
        q = pkg.Query(pkg.load(path, opts),
                      cache_dir=str(tmp_path / f"sst-{name}"))
        try:
            out[name] = q.lookup(keys, partition)
        finally:
            q.close()
    return out


def counter(name):
    return global_registry().lookup_metrics().counter(name)


def approx_rows(got, want, floats=("v",)):
    """Rows equal; the `floats` columns within rtol 1e-12."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g is None or w is None:
            assert g is w, (g, w)
            continue
        assert g.keys() == w.keys()
        for k in g:
            if k in floats and g[k] is not None and w[k] is not None:
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0.0)
            else:
                assert g[k] == w[k], (k, g, w)


# -- SST files -----------------------------------------------------------------

def sorted_lanes(n, num_lanes=2, seed=0, dupes=None):
    rng = np.random.default_rng(seed)
    hi = max(n // dupes, 1) if dupes else 1 << 32
    lanes = rng.integers(0, hi, (n, num_lanes),
                         dtype=np.uint64).astype(np.uint32)
    order = np.argsort(sst.pack_lanes(lanes), kind="stable")
    t = pa.table({"v": pa.array(np.arange(n), pa.int64())})
    return lanes[order], t.take(pa.array(order))


def probe_rows(reader, queries, python=False, mod=sst):
    """(sorted hit positions, sorted (position, v) rows) of one probe."""
    if python:
        with mod.force_python_probe():
            hit, rows = reader.probe(queries)
    else:
        hit, rows = reader.probe(queries)
    if rows is None:
        return sorted(hit.tolist()), []
    return (sorted(hit.tolist()),
            sorted(zip(hit.tolist(), rows.column("v").to_pylist())))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sst_files_are_byte_identical_and_cross_read(tmp_path, writer):
    lanes, t = sorted_lanes(10_000)
    paths = {}
    for name, mod in (("port", sst), ("reference", ref_sst)):
        paths[name] = str(tmp_path / f"{name}.sst")
        mod.SstWriter(block_rows=512).write(paths[name], lanes, t)
    with open(paths["port"], "rb") as a, open(paths["reference"], "rb") as b:
        assert a.read() == b.read()
    q_idx = np.arange(0, 10_000, 97)
    miss = np.full((5, 2), 0xFFFFFFFF, np.uint32)
    queries = np.concatenate([lanes[q_idx], miss])
    want = (list(range(len(q_idx))),
            [(i, int(t.column("v")[int(qi)].as_py()))
             for i, qi in enumerate(q_idx)])
    for mod in (sst, ref_sst):
        r = mod.SstReader(paths[writer], mod.BlockCache())
        assert probe_rows(r, queries, mod=mod) == want
        assert probe_rows(r, queries, python=True, mod=mod) == want


def test_probe_only_touches_needed_blocks(tmp_path):
    lanes, t = sorted_lanes(8192)
    path = str(tmp_path / "f.sst")
    sst.SstWriter(block_rows=256).write(path, lanes, t)
    cache = sst.BlockCache()
    sst.SstReader(path, cache).probe(lanes[:1])
    assert len(cache._lru) <= 2


def test_block_cache_bounded(tmp_path):
    lanes, t = sorted_lanes(50_000)
    path = str(tmp_path / "f.sst")
    sst.SstWriter(block_rows=256).write(path, lanes, t)
    cache = sst.BlockCache(max_bytes=64 << 10)
    sst.SstReader(path, cache).probe(lanes[::37])
    assert cache._bytes <= 2 * (64 << 10)


@pytest.mark.parametrize("mod", [sst, ref_sst], ids=["port", "reference"])
def test_empty_sst(tmp_path, mod):
    lanes = np.zeros((0, 2), np.uint32)
    path = str(tmp_path / "e.sst")
    mod.SstWriter().write(path, lanes,
                          pa.table({"v": pa.array([], pa.int64())}))
    for reader_mod in (sst, ref_sst):
        hit, rows = reader_mod.SstReader(path, reader_mod.BlockCache()) \
            .probe(np.zeros((3, 2), np.uint32))
        assert len(hit) == 0 and rows is None


def test_lookup_store_disk_budget_evicts_lru(tmp_path):
    store = sst.LookupStore(str(tmp_path / "cache"), max_disk_bytes=200_000,
                            block_cache=sst.BlockCache())
    for i in range(6):
        lanes, t = sorted_lanes(5000, seed=i)
        store.put(f"b{i}", lanes, t)
    d = str(tmp_path / "cache")
    assert sum(os.path.getsize(os.path.join(d, f))
               for f in os.listdir(d)) <= 300_000
    assert store.get("b5") is not None
    assert store.get("b0") is None


def test_lookup_store_replace_same_key_drops_old(tmp_path):
    store = sst.LookupStore(str(tmp_path / "c"), block_cache=sst.BlockCache())
    lanes, t = sorted_lanes(100)
    store.put("k", lanes, t)
    store.put("k", lanes, t)
    assert len(store._readers) == 1
    assert len([f for f in os.listdir(str(tmp_path / "c"))
                if f.endswith(".sst")]) == 1


# -- the native probe against the numpy walk and the reference ---------------

@needs_probe
@pytest.mark.parametrize("block_rows", [64, 512])
def test_probe_parity_random_hits_and_misses(tmp_path, block_rows):
    lanes, t = sorted_lanes(5_000, seed=1)
    path = str(tmp_path / "f.sst")
    sst.SstWriter(block_rows=block_rows).write(path, lanes, t)
    rng = np.random.default_rng(2)
    queries = np.concatenate([
        lanes[rng.integers(0, len(lanes), 300)],
        rng.integers(0, 1 << 32, (300, 2), dtype=np.uint64)
        .astype(np.uint32)])
    r = sst.SstReader(path, sst.BlockCache())
    got = probe_rows(r, queries)
    assert got == probe_rows(r, queries, python=True)
    ref = ref_sst.SstReader(path, ref_sst.BlockCache())
    assert got == probe_rows(ref, queries, mod=ref_sst)


@needs_probe
def test_probe_parity_equal_key_runs_spanning_blocks(tmp_path):
    lanes, t = sorted_lanes(4_000, seed=3, dupes=40)
    path = str(tmp_path / "f.sst")
    sst.SstWriter(block_rows=64).write(path, lanes, t)
    r = sst.SstReader(path, sst.BlockCache())
    queries = lanes[::97]
    got = probe_rows(r, queries)
    assert got == probe_rows(r, queries, python=True)
    assert got == probe_rows(ref_sst.SstReader(path, ref_sst.BlockCache()),
                             queries, mod=ref_sst)
    assert len(got[1]) > len(queries)


@needs_probe
def test_native_probe_binding_matches_reference_binding():
    """native.sst_probe of both packages on one flat key buffer."""
    from paimon_tpu import native as ref_native
    lanes, _ = sorted_lanes(2_000, seed=5, dupes=4)
    packed = sst.pack_lanes(lanes)
    flat = np.frombuffer(packed.tobytes(), np.uint8)
    q = np.concatenate([packed[::7], sst.pack_lanes(
        np.full((3, 2), 0xFFFFFFFF, np.uint32))])
    hashes = sst._key_hashes(q)
    qbytes = np.frombuffer(q.tobytes(), np.uint8)
    got = native.sst_probe(flat, len(packed), 8, None, 0, qbytes, hashes)
    want = ref_native.sst_probe(flat, len(packed), 8, None, 0, qbytes,
                                hashes)
    assert want is not None
    assert [a.tolist() for a in got] == [a.tolist() for a in want]


@needs_probe
def test_missing_symbol_degrades_per_call(tmp_path, monkeypatch):
    """A library without the probe symbol degrades each probe call to
    the numpy walk, counted in lookup.native_fallbacks, with the same
    answers; once the symbol is back the native path serves again."""
    monkeypatch.setattr(native, "sst_probe_prepare", lambda *a, **k: None)
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"], {"bucket": "1"})
    commit(t, [{"id": i, "name": f"n{i}"} for i in range(100)])
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    keys = [{"id": i} for i in range(0, 100, 3)] + [{"id": 999}]
    expected = q.lookup(keys)
    fallbacks0 = counter(LOOKUP_NATIVE_FALLBACKS).count
    native0 = counter(LOOKUP_NATIVE_PROBES).count
    monkeypatch.setattr(native, "sst_probe", lambda *a, **k: None)
    assert q.lookup(keys) == expected
    assert counter(LOOKUP_NATIVE_FALLBACKS).count > fallbacks0
    assert counter(LOOKUP_NATIVE_PROBES).count == native0
    monkeypatch.undo()
    fallbacks1 = counter(LOOKUP_NATIVE_FALLBACKS).count
    assert q.lookup(keys) == expected
    assert counter(LOOKUP_NATIVE_FALLBACKS).count == fallbacks1
    q.close()


# -- LocalTableQuery -----------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_fast_path_updates_and_deletes(tmp_path, writer):
    path = str(tmp_path / "t")
    t = PACKAGES[writer].create(path, NAME_COLS, ["id"], {"bucket": "2"})
    rng = np.random.default_rng(11)
    commit(t, [{"id": i, "name": f"a{i}"} for i in range(300)])
    ids = sorted(set(rng.integers(0, 300, 120).tolist()))
    commit(t, [{"id": i, "name": f"b{i}"} for i in ids])
    dels = list(range(0, 300, 5))
    commit(t, [{"id": i, "name": "x"} for i in dels],
           kinds=[RowKind.DELETE] * len(dels))
    oracle = {r["id"]: r for r in PORT.load(path).to_arrow().to_pylist()}
    keys = [{"id": i} for i in range(-5, 310)]
    got = lookups(path, keys, tmp_path)
    assert got["port"] == got["reference"]
    assert got["port"] == [oracle.get(k["id"]) for k in keys]
    q = LocalTableQuery(PORT.load(path), cache_dir=str(tmp_path / "c"))
    q.lookup(keys)
    # per-file SSTs, the fast path: no merged bucket was built
    assert any(k.startswith("file|") for k in q.store.keys())
    assert not any(k.startswith("bucket|") for k in q.store.keys())
    q.close()


@needs_probe
def test_native_and_numpy_probes_equal_through_the_query(tmp_path):
    path = str(tmp_path / "t")
    t = PORT.create(path, NAME_COLS, ["id"], {"bucket": "2"})
    commit(t, [{"id": i, "name": f"a{i}"} for i in range(300)])
    commit(t, [{"id": i, "name": f"b{i}"} for i in range(0, 300, 3)])
    commit(t, [{"id": i, "name": "x"} for i in range(0, 300, 5)],
           kinds=[RowKind.DELETE] * 60)
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    keys = [{"id": i} for i in range(-5, 310)]
    probes0 = counter(LOOKUP_NATIVE_PROBES).count
    native_rows = q.lookup(keys)
    assert counter(LOOKUP_NATIVE_PROBES).count > probes0
    with sst.force_python_probe():
        assert q.lookup(keys) == native_rows
    q.close()
    assert native_rows == lookups(path, keys, tmp_path)["reference"]


ENGINES = {
    "aggregation": {"merge-engine": "aggregation",
                    "fields.v.aggregate-function": "sum"},
    "partial-update": {"merge-engine": "partial-update"},
    "first-row": {"merge-engine": "first-row"},
    "sequence.field": {"sequence.field": "q"},
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_merged_fallback_per_engine(tmp_path, engine, writer):
    """Aggregation, partial-update, first-row and sequence.field take
    the merged-bucket fallback; both packages answer alike, and like a
    merge-on-read scan."""
    path = str(tmp_path / "t")
    cols = [("id", "id"), ("v", "double"), ("q", "int"), ("name", "string")]
    t = PACKAGES[writer].create(path, cols, ["id"],
                                {"bucket": "2", **ENGINES[engine]})
    rng = np.random.default_rng(17)
    for c in range(3):
        ids = rng.choice(200, 120, replace=False)
        vals = rng.standard_normal(120)
        qs = rng.integers(0, 5, 120)
        commit(t, [{"id": int(i), "v": None if k % 9 == 0 else float(v),
                    "q": int(s), "name": None if k % 7 == 0 else f"c{c}"}
                   for k, (i, v, s) in enumerate(zip(ids, vals, qs))])
    keys = [{"id": i} for i in range(-3, 205)]
    got = lookups(path, keys, tmp_path)
    approx_rows(got["port"], got["reference"])
    scan = {r["id"]: r for r in PORT.load(path).to_arrow().to_pylist()}
    approx_rows(got["port"], [scan.get(k["id"]) for k in keys])
    q = LocalTableQuery(PORT.load(path), cache_dir=str(tmp_path / "c"))
    q.lookup(keys)
    assert any(k.startswith("bucket|") for k in q.store.keys())
    q.close()


def test_snapshot_refresh_ttl_gates_hint_reads(tmp_path):
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"], {"bucket": "1"})
    commit(t, [{"id": i, "name": "a"} for i in range(10)])
    clock = {"t": 0.0}
    calls = {"n": 0}
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"),
                        refresh_interval_ms=1000, clock=lambda: clock["t"])
    orig = t.snapshot_manager.latest_snapshot_id
    t.snapshot_manager.latest_snapshot_id = \
        lambda: calls.__setitem__("n", calls["n"] + 1) or orig()
    q.lookup_row({"id": 1})
    n1 = calls["n"]
    for _ in range(25):
        clock["t"] += 30
        q.lookup_row({"id": 1})
    assert calls["n"] == n1
    clock["t"] += 1500
    q.lookup_row({"id": 1})
    assert calls["n"] == n1 + 1
    commit(t, [{"id": 1, "name": "fresh"}])
    q.refresh()
    assert q.lookup_row({"id": 1})["name"] == "fresh"
    q.close()


def test_failed_snapshot_check_is_not_ttl_cached(tmp_path):
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"], {"bucket": "1"})
    commit(t, [{"id": 1, "name": "a"}])
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"),
                        refresh_interval_ms=60_000, clock=lambda: 0.0)
    orig = t.snapshot_manager.latest_snapshot_id
    t.snapshot_manager.latest_snapshot_id = \
        lambda: (_ for _ in ()).throw(OSError("fs outage"))
    for _ in range(2):
        with pytest.raises(OSError):
            q.lookup_row({"id": 1})
    t.snapshot_manager.latest_snapshot_id = orig
    assert q.lookup_row({"id": 1}) == {"id": 1, "name": "a"}
    q.close()


def test_lazy_bucket_readers_survive_unrelated_commits(tmp_path):
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"], {"bucket": "4"})
    commit(t, [{"id": i, "name": f"v{i}"} for i in range(200)])
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    assert all(r is not None for r in q.lookup([{"id": i}
                                                 for i in range(200)]))
    warm = set(q.store.keys())
    commit(t, [{"id": 0, "name": "updated"}])
    q.refresh()
    assert q.lookup_row({"id": 0})["name"] == "updated"
    after = set(q.store.keys())
    assert warm <= after and len(after) > len(warm)
    q.close()


def test_compaction_evicts_dropped_file_readers(tmp_path):
    path = str(tmp_path / "t")
    t = PORT.create(path, NAME_COLS, ["id"], {"bucket": "2"})
    for c in range(3):
        commit(t, [{"id": i, "name": f"c{c}-{i}"} for i in range(50)])
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    q.lookup([{"id": i} for i in range(50)])
    before = set(q.store.keys())
    assert len(before) >= 2
    t.copy({"write-only": "false"}).compact(full=True)
    q.refresh()
    out = q.lookup([{"id": i} for i in range(50)])
    assert out == lookups(path, [{"id": i} for i in range(50)],
                          tmp_path)["reference"]
    after = set(q.store.keys())
    assert not before & after
    assert len([f for f in os.listdir(str(tmp_path / "c"))
                if f.endswith(".sst")]) == len(after)
    q.close()


def test_manifest_stats_prune_files_before_io(tmp_path):
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"], {"bucket": "1"})
    commit(t, [{"id": i, "name": "lo"} for i in range(50)])
    commit(t, [{"id": i, "name": "hi"} for i in range(1000, 1050)])
    pruned0 = counter(LOOKUP_FILES_PRUNED).count
    builds0 = counter(LOOKUP_READER_BUILDS).count
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    assert q.lookup_row({"id": 25})["name"] == "lo"
    assert counter(LOOKUP_FILES_PRUNED).count > pruned0
    assert counter(LOOKUP_READER_BUILDS).count == builds0 + 1
    q.close()


def test_empty_merged_bucket_is_negative_cached(tmp_path):
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"],
                    {"bucket": "1", "sequence.field": "id"})
    commit(t, [{"id": i, "name": "a"} for i in range(10)])
    commit(t, [{"id": i, "name": "a"} for i in range(10)],
           kinds=[RowKind.DELETE] * 10)
    assert t.to_arrow().num_rows == 0
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    assert q.lookup_row({"id": 3}) is None
    builds = counter(LOOKUP_READER_BUILDS).count
    for _ in range(5):
        assert q.lookup_row({"id": 3}) is None
    assert counter(LOOKUP_READER_BUILDS).count == builds
    q.close()


@pytest.mark.parametrize("engine", ["deduplicate", "aggregation"])
def test_concurrent_cold_lookups_build_each_sst_once(tmp_path, engine):
    """8 threads race into cold buckets: each SST builds once (three
    per-file SSTs of one bucket, or one merged SST per bucket), and
    every thread gets the reference's answers."""
    path = str(tmp_path / "t")
    cols = [("id", "id"), ("v", "double")]
    opts = {"bucket": "1" if engine == "deduplicate" else "4"}
    if engine == "aggregation":
        opts.update(ENGINES["aggregation"])
    t = PORT.create(path, cols, ["id"], opts)
    rng = np.random.default_rng(23)
    for c in range(3):
        commit(t, [{"id": i, "v": float(v)}
                   for i, v in enumerate(rng.standard_normal(50))])
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "c"))
    builds0 = counter(LOOKUP_READER_BUILDS).count
    start = threading.Barrier(8)
    results = []
    keys = [{"id": i} for i in range(50)]

    def probe():
        start.wait()
        results.append(q.lookup(keys))

    threads = [threading.Thread(target=probe) for _ in range(8)]
    [x.start() for x in threads]
    [x.join(timeout=60) for x in threads]
    assert len(results) == 8
    built = counter(LOOKUP_READER_BUILDS).count - builds0
    assert 1 <= built <= (3 if engine == "deduplicate" else 4), built
    want = lookups(path, keys, tmp_path)["reference"]
    for r in results:
        approx_rows(r, want)
    q.close()


def test_partitioned_batches(tmp_path):
    path = str(tmp_path / "t")
    t = PORT.create(path, [("p", "pint"), ("id", "id"), ("name", "string")],
                    ["p", "id"], {"bucket": "2"}, partition=("p",))
    commit(t, [{"p": p, "id": i, "name": f"p{p}-{i}"}
               for p in range(3) for i in range(100)])
    for p in range(4):              # p = 3 does not exist
        keys = [{"p": p, "id": i} for i in range(0, 110, 7)]
        got = lookups(path, keys, tmp_path / f"p{p}", partition=(p,))
        assert got["port"] == got["reference"]
        for k, row in zip(keys, got["port"]):
            if p < 3 and k["id"] < 100:
                assert row["name"] == f"p{p}-{k['id']}"
            else:
                assert row is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_string_pk_longer_than_the_lane_prefix(tmp_path, writer):
    path = str(tmp_path / "t")
    t = PACKAGES[writer].create(path, [("k", "skey"), ("v", "int")], ["k"],
                                {"bucket": "1"})
    prefix = "x" * 40
    commit(t, [{"k": prefix + "a", "v": 1}, {"k": prefix + "b", "v": 2}])
    keys = [{"k": prefix + "b"}, {"k": prefix + "zzz"}, {"k": prefix + "a"}]
    got = lookups(path, keys, tmp_path)
    assert got["port"] == got["reference"] == [
        {"k": prefix + "b", "v": 2}, None, {"k": prefix + "a", "v": 1}]


def test_snapshot_change_invalidates(tmp_path):
    t = PORT.create(str(tmp_path / "t"), NAME_COLS, ["id"], {"bucket": "2"})
    commit(t, [{"id": i, "name": f"n{i}"} for i in range(50)])
    q = LocalTableQuery(t, cache_dir=str(tmp_path / "cache"))
    assert q.lookup_row({"id": 7})["name"] == "n7"
    assert any(f.endswith(".sst")
               for f in os.listdir(str(tmp_path / "cache")))
    commit(t, [{"id": 7, "name": "updated"}])
    assert q.lookup_row({"id": 7})["name"] == "updated"
    q.close()
