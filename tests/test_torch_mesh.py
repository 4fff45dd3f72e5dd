"""paimon_tpu_torch's mesh plane against paimon_tpu's, on the CPU.

The reference runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port runs 8 bucket lanes on device="cpu" (one batched merge a
window step, the winner-select's plain version).  Counterparts of
tests/test_mesh_engine.py (its slow dryrun is chip_smoke.py's
mesh_compaction phase here) and tests/test_multichip.py, plus the
batched segmented merge body against jax.vmap of the reference's and
against B separate 1-D calls.  Every table comparison is exact: the
merge-on-read rows, and each bucket's stored key/value rows (keys,
sequence numbers, kinds, values), across both packages, and each
package reads what the other compacted.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from paimon_tpu.ops.merge import segmented_merge_body as ref_body
from paimon_tpu.ops.normkey import NormalizedKeyEncoder as RefEncoder
from paimon_tpu.parallel import bucket_mesh as ref_bucket_mesh
from paimon_tpu.parallel import compact_table_mesh as ref_compact_mesh
from paimon_tpu.parallel import merge_buckets_sharded as ref_merge_sharded
from paimon_tpu.parallel import pack_buckets as ref_pack_buckets
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu_torch.ops.merge import segmented_merge_body
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.parallel import (
    ShardedBucketMerge, UnsupportedMergeEngineError, bucket_mesh,
    compact_table_mesh, compact_table_sharded, merge_buckets_sharded,
    pack_buckets, pad_bucket_batches, packing_skew,
)
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import (
    BigIntType, DoubleType, IntType, RowKind, VarCharType,
)
from tests.store_oracle import make_random_engine_table
from tests.test_mesh_engine import _bucket_kv as ref_bucket_kv

ENGINES = ["deduplicate", "partial-update", "aggregation", "first-row"]


@pytest.fixture(scope="module")
def mesh():
    return bucket_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) >= 8, "conftest should give 8 CPU devices"
    return ref_bucket_mesh(8)


def port_random_engine_table(path: str, seed: int, engine: str, *,
                             buckets: int = 4, commits: int = 3,
                             rows_per_commit: int = 250,
                             key_space: int = 120, deletes: bool = True,
                             sequence_group: bool = False,
                             extra_options=None) -> FileStoreTable:
    """tests/store_oracle.make_random_engine_table for the port: the
    same draws from the same seed, so both packages hold the same rows."""
    rng = random.Random(seed)
    b = (Schema.builder()
         .column("pt", IntType(False))
         .column("id", BigIntType(False))
         .column("v1", IntType())
         .column("v2", DoubleType())
         .column("name", VarCharType.string_type()))
    opts = {"bucket": str(buckets), "write-only": "true",
            "merge-engine": engine}
    if engine == "aggregation":
        opts["fields.v1.aggregate-function"] = "sum"
        opts["fields.v2.aggregate-function"] = "max"
    if sequence_group:
        opts["fields.v1.sequence-group"] = "v2,name"
    opts.update(extra_options or {})
    table = FileStoreTable.create(
        path, b.primary_key("pt", "id").options(opts).build(), device="cpu")
    for _ in range(commits):
        rows, kinds = [], []
        for _ in range(rows_per_commit):
            rows.append({
                "pt": rng.randrange(3),
                "id": rng.randrange(key_space),
                "v1": rng.randrange(1000)
                if rng.random() > 0.1 else None,
                "v2": round(rng.uniform(0, 100), 6)
                if rng.random() > 0.1 else None,
                "name": rng.choice(["a", "b", "c", "longer-value",
                                    None]),
            })
            kinds.append(RowKind.DELETE
                         if deletes and engine == "deduplicate"
                         and rng.random() < 0.15 else RowKind.INSERT)
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write_dicts(rows, row_kinds=kinds)
        wb.new_commit().commit(w.prepare_commit())
        w.close()
    return table


def rows_of(table):
    return sorted(table.to_arrow().to_pylist(),
                  key=lambda r: (r["pt"], r["id"]))


def bucket_kv(table):
    """{(partition, bucket): KV rows} of the port's stored files."""
    from paimon_tpu_torch.core.kv_file import read_kv_file
    from paimon_tpu_torch.core.read import MergeFileSplitRead, assemble_runs

    reader = MergeFileSplitRead(table.file_io, table.path, table.schema,
                                table.options)
    out = {}
    for s in table.new_read_builder().new_scan().plan().splits:
        tables = [read_kv_file(table.file_io, reader.path_factory,
                               s.partition, s.bucket, f)
                  for run in assemble_runs(s.data_files) for f in run]
        out[(tuple(s.partition), s.bucket)] = pa.concat_tables(
            tables, promote_options="none").to_pylist()
    return out


def triplets(tmp_path, engine, seed, **kw):
    """(port single-chip, port mesh, reference mesh) twins."""
    return (port_random_engine_table(str(tmp_path / "single"), seed,
                                     engine, **kw),
            port_random_engine_table(str(tmp_path / "mesh"), seed, engine,
                                     **kw),
            make_random_engine_table(str(tmp_path / "ref"), seed, engine,
                                     **kw))


def assert_all_equal(single, meshed, ref, stats):
    assert stats.snapshot_id is not None
    assert meshed.latest_snapshot().commit_kind == "COMPACT"
    want = rows_of(ref)
    assert rows_of(meshed) == rows_of(single) == want
    kv = bucket_kv(meshed)
    assert kv == bucket_kv(single) == ref_bucket_kv(ref)
    max_level = meshed.options.num_levels - 1
    for s in meshed.new_read_builder().new_scan().plan().splits:
        assert all(f.level == max_level for f in s.data_files)
    # each package reads what the other compacted
    assert rows_of(FileStoreTable.load(ref.path, device="cpu")) == want
    assert rows_of(RefTable.load(meshed.path)) == want


@pytest.mark.parametrize("engine", ENGINES)
def test_mesh_matches_single_chip(tmp_path, mesh, ref_mesh, engine):
    single, meshed, ref = triplets(tmp_path, engine, seed=7 + len(engine))
    assert single.compact(full=True) is not None
    stats = compact_table_mesh(meshed, mesh)
    ref_stats = ref_compact_mesh(ref, ref_mesh)
    assert stats.buckets > 0 and stats.windows > 0
    assert stats.output_rows == sum(len(v) for v in bucket_kv(meshed)
                                    .values()) == ref_stats.output_rows
    assert (stats.buckets, stats.input_rows, stats.lane_rows) == \
        (ref_stats.buckets, ref_stats.input_rows, ref_stats.lane_rows)
    assert stats.skew == pytest.approx(ref_stats.skew)
    assert_all_equal(single, meshed, ref, stats)


def test_mesh_partial_update_sequence_groups(tmp_path, mesh, ref_mesh):
    single, meshed, ref = triplets(tmp_path, "partial-update", seed=23,
                                   sequence_group=True)
    assert single.compact(full=True) is not None
    ref_compact_mesh(ref, ref_mesh)
    assert_all_equal(single, meshed, ref, compact_table_mesh(meshed, mesh))


def test_mesh_dedup_user_sequence_field(tmp_path, mesh, ref_mesh):
    kw = dict(deletes=False, extra_options={"sequence.field": "v1"})
    single, meshed, ref = triplets(tmp_path, "deduplicate", seed=31, **kw)
    assert single.compact(full=True) is not None
    ref_compact_mesh(ref, ref_mesh)
    assert_all_equal(single, meshed, ref, compact_table_mesh(meshed, mesh))


def test_mesh_idempotent(tmp_path, mesh):
    meshed = port_random_engine_table(str(tmp_path / "t"), 3, "deduplicate")
    stats = compact_table_mesh(meshed, mesh)
    assert stats.snapshot_id is not None
    again = compact_table_mesh(meshed, mesh)
    assert again.snapshot_id is None
    assert again.buckets == 0


def test_mesh_unsupported_engine_raises(tmp_path, mesh):
    t = port_random_engine_table(str(tmp_path / "t"), 1, "deduplicate",
                                 commits=1, rows_per_commit=20)
    bogus = t.copy({"merge-engine": "shiny-new-engine"})
    with pytest.raises(UnsupportedMergeEngineError):
        compact_table_mesh(bogus, mesh)


def test_legacy_sharded_guard_raises(tmp_path, mesh):
    """The legacy deduplicate-only path refuses every other engine."""
    t = port_random_engine_table(str(tmp_path / "t"), 2, "aggregation",
                                 commits=1, rows_per_commit=20)
    with pytest.raises(UnsupportedMergeEngineError):
        compact_table_sharded(t, mesh)


def test_mesh_rejects_changelog_producers(tmp_path, mesh):
    t = port_random_engine_table(str(tmp_path / "t"), 4, "deduplicate",
                                 commits=1, rows_per_commit=20)
    with pytest.raises(ValueError, match="changelog"):
        compact_table_mesh(t.copy({"changelog-producer": "input"}), mesh)


def test_mesh_streams_bounded_windows(tmp_path, mesh):
    """A bucket ~30x the window budget streams through the mesh: the
    per-bucket run buffers stay under runs x window rows (+ refill
    slack); the result equals the reference's merge-on-read rows."""
    window = 4096
    kw = dict(buckets=1, commits=3, rows_per_commit=40_000,
              key_space=1_000_000, deletes=False,
              extra_options={"tpu.mesh.window-rows": str(window)})
    t = port_random_engine_table(str(tmp_path / "t"), 42, "deduplicate",
                                 **kw)
    ref = make_random_engine_table(str(tmp_path / "ref"), 42,
                                   "deduplicate", **kw)
    before = rows_of(t)
    assert before == rows_of(ref)
    stats = compact_table_mesh(t, mesh)
    assert stats.snapshot_id is not None
    assert stats.input_rows > 110_000
    assert stats.windows > 5
    budget = 4 * 3 * window
    assert 0 < stats.peak_buffered_rows <= budget
    assert 0 < stats.peak_window_rows <= budget
    assert budget < stats.input_rows // 2
    assert rows_of(t) == before


def test_compact_option_routes_through_mesh(tmp_path):
    """tpu.mesh.compact=true routes compact(full=True) through the mesh
    engine; the output equals the single-chip twin's and the
    reference's routed compaction."""
    single, meshed, ref = triplets(tmp_path, "aggregation", seed=13)
    assert single.compact(full=True) is not None
    routed = meshed.copy({"tpu.mesh.compact": "true"})
    ref_routed = ref.copy({"tpu.mesh.compact": "true"})
    assert routed.compact(full=True) is not None
    assert ref_routed.compact(full=True) is not None
    assert routed.latest_snapshot().commit_kind == "COMPACT"
    assert rows_of(routed) == rows_of(single) == rows_of(ref_routed)
    assert bucket_kv(routed) == bucket_kv(single) == \
        ref_bucket_kv(ref_routed)


def test_compact_option_falls_back_single_chip(tmp_path):
    """Configurations the mesh engine cannot run (here a changelog
    producer) take the single-chip manager instead of raising."""
    opts = {"tpu.mesh.compact": "true", "changelog-producer": "input"}
    t = port_random_engine_table(str(tmp_path / "t"), 5, "deduplicate",
                                 commits=2, rows_per_commit=40,
                                 extra_options=opts)
    ref = make_random_engine_table(str(tmp_path / "ref"), 5, "deduplicate",
                                   commits=2, rows_per_commit=40,
                                   extra_options=opts)
    assert t.compact(full=True) is not None
    assert ref.compact(full=True) is not None
    assert t.latest_snapshot().commit_kind == "COMPACT"
    assert rows_of(t) == rows_of(ref)


# -- packing -----------------------------------------------------------------


def test_pack_buckets_skew_aware():
    counts = [1000, 10, 10, 10, 10, 10, 10, 10]
    lanes = pack_buckets(counts, 4)
    loads = [sum(counts[i] for i in lane) for lane in lanes]
    assert sorted(i for lane in lanes for i in lane) == list(range(8))
    assert max(loads) == 1000
    assert [0] in lanes
    assert packing_skew(counts, lanes) == pytest.approx(
        1000 / (sum(counts) / 4))
    assert lanes == ref_pack_buckets(counts, 4)


def test_pack_buckets_balances_uniform():
    counts = [100] * 16
    lanes = pack_buckets(counts, 8)
    assert all(len(lane) == 2 for lane in lanes)
    assert lanes == ref_pack_buckets(counts, 8)


def test_pack_buckets_fewer_buckets_than_lanes():
    lanes = pack_buckets([5, 7], 8)
    assert sorted(i for lane in lanes for i in lane) == [0, 1]
    assert sum(1 for lane in lanes if lane) == 2
    assert lanes == ref_pack_buckets([5, 7], 8)


def test_pack_buckets_deterministic():
    counts = [3, 9, 1, 9, 3, 7]
    assert pack_buckets(counts, 3) == pack_buckets(list(counts), 3) == \
        ref_pack_buckets(counts, 3)


# -- the sharded merge (tests/test_multichip.py) ------------------------------


def _int_key_lanes(keys):
    t = pa.table({"k": pa.array(keys, pa.int64())})
    lanes, _ = NormalizedKeyEncoder([pa.int64()], nullable=[False]) \
        .encode_table(t, ["k"])
    ref_lanes, _ = RefEncoder([pa.int64()], nullable=[False]) \
        .encode_table(t, ["k"])
    assert np.array_equal(lanes, ref_lanes)
    return lanes


def _both(lanes_list, seq_list, mesh, ref_mesh, keep="last"):
    got = merge_buckets_sharded(lanes_list, seq_list, mesh, keep=keep)
    want = ref_merge_sharded(lanes_list, seq_list, ref_mesh, keep=keep)
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    return got


def test_sharded_merge_matches_numpy(mesh, ref_mesh):
    rng = np.random.default_rng(42)
    lanes_list, seq_list, expected = [], [], []
    for b in range(8):
        n = 64 + 32 * b      # ragged bucket sizes: padding exercised
        keys = rng.integers(0, 50, n)
        lanes_list.append(_int_key_lanes(keys))
        seq_list.append(np.arange(n, dtype=np.int64))
        expected.append(len(np.unique(keys)))
    winners, total = _both(lanes_list, seq_list, mesh, ref_mesh)
    assert total == sum(expected)
    for b in range(8):
        assert len(winners[b]) == expected[b]
        keys = np.asarray(lanes_list[b][:, 1])
        for w in winners[b]:
            assert w == np.flatnonzero(keys == keys[w]).max()


def test_sharded_merge_bucket_padding(mesh, ref_mesh):
    """B not a multiple of the lanes: padded buckets add nothing."""
    rng = np.random.default_rng(1)
    lanes_list = [_int_key_lanes(rng.integers(0, 10, 32)) for _ in range(5)]
    seq_list = [np.arange(32, dtype=np.int64)] * 5
    winners, total = _both(lanes_list, seq_list, mesh, ref_mesh)
    assert len(winners) == 5
    assert total == sum(len(w) for w in winners)


def test_sharded_matches_sequential_kernel(mesh, ref_mesh):
    """Sharded result == the single-bucket merge per bucket."""
    from paimon_tpu_torch.ops.merge import device_sorted_winners

    rng = np.random.default_rng(7)
    lanes_list = [_int_key_lanes(rng.integers(0, 100, 128))
                  for _ in range(8)]
    seq_list = [np.arange(128, dtype=np.int64)] * 8
    winners, _ = _both(lanes_list, seq_list, mesh, ref_mesh)
    for b in range(8):
        perm, win, _ = device_sorted_winners(lanes_list[b], seq_list[b],
                                             device="cpu")
        seq_result = perm[np.flatnonzero(win)]
        seq_result = seq_result[seq_result < 128]
        assert np.array_equal(np.sort(winners[b]), np.sort(seq_result))


def test_first_row_keep(mesh, ref_mesh):
    lanes = _int_key_lanes(np.array([5, 5, 3, 3, 3, 9], dtype=np.int64))
    winners, total = _both([lanes], [np.arange(6, dtype=np.int64)], mesh,
                           ref_mesh, keep="first")
    assert total == 3
    assert set(winners[0].tolist()) == {0, 2, 5}


def test_int64_min_key_not_dropped(mesh, ref_mesh):
    """Key INT64_MIN encodes to all-zero lanes, like padding: the
    segment boundary treats validity as part of the key."""
    lanes = _int_key_lanes(np.array([np.iinfo(np.int64).min, 7],
                                    dtype=np.int64))
    winners, total = _both([lanes], [np.arange(2, dtype=np.int64)], mesh,
                           ref_mesh)
    assert total == 2
    assert set(winners[0].tolist()) == {0, 1}


# -- the batched segmented merge body --------------------------------------


def _batched_inputs(rng, b, n, num_lanes, kind):
    """uint32 lanes[B, N, L], seq_hi, seq_lo, invalid, ovc_off [B, N].
    "random": keys in {0, 1, 2} per lane, some invalid rows, codes of
    random offsets; "full": every lane full, one key everywhere (equal
    keys across every lane boundary), codes claiming equality and
    sequence numbers counting on across the boundaries."""
    if kind == "random":
        lanes = rng.integers(0, 3, (b, n, num_lanes)).astype(np.uint32)
        seq = rng.permutation(b * n).reshape(b, n)
        invalid = (rng.random((b, n)) < 0.1).astype(np.uint32)
        ovc = rng.integers(0, num_lanes + 2, (b, n)).astype(np.uint32)
        ovc[rng.random((b, n)) < 0.3] = 0xFFFFFFFF
    else:
        lanes = np.zeros((b, n, num_lanes), dtype=np.uint32)
        seq = np.arange(b * n).reshape(b, n)
        invalid = np.zeros((b, n), dtype=np.uint32)
        ovc = np.full((b, n), num_lanes, dtype=np.uint32)
    return (lanes, (seq >> 32).astype(np.uint32),
            (seq & 0xFFFFFFFF).astype(np.uint32), invalid, ovc)


def _port_body(inputs, keep, with_ovc, batched=True):
    lanes, seq_hi, seq_lo, invalid, ovc = (
        torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        for a in inputs)
    lanes = lanes.permute(2, 0, 1).contiguous() if batched \
        else lanes.T.contiguous()
    out = segmented_merge_body(lanes, seq_hi, seq_lo, invalid, keep,
                               ovc_off=ovc if with_ovc else None)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("kind", ["random", "full"])
@pytest.mark.parametrize("keep", ["last", "first"])
@pytest.mark.parametrize("with_ovc", [False, True], ids=["plain", "ovc"])
def test_batched_body_matches_vmap_and_1d(kind, keep, with_ovc):
    rng = np.random.default_rng(5)
    b, n, num_lanes = 3, 64, 2
    inputs = _batched_inputs(rng, b, n, num_lanes, kind)

    def ref_lane(lanes, seq_hi, seq_lo, invalid, ovc):
        return ref_body([lanes[:, i] for i in range(num_lanes)], seq_hi,
                        seq_lo, invalid, keep,
                        ovc_off=ovc if with_ovc else None)

    want = [np.asarray(o) for o in jax.vmap(ref_lane)(
        *(jnp.asarray(a) for a in inputs))]
    got = _port_body(inputs, keep, with_ovc)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.astype(g.dtype))
    for i in range(b):
        alone = _port_body([a[i] for a in inputs], keep, with_ovc,
                           batched=False)
        for g, a in zip(got, alone):
            assert np.array_equal(g[i], a)
    if kind == "full":
        # one segment per lane: its last (or first) row wins
        win = got[1]
        assert win.sum() == b
        assert win[:, -1 if keep == "last" else 0].all()


def test_sharded_bucket_merge_pads_to_lanes(mesh):
    lanes, seq_hi, seq_lo, invalid = pad_bucket_batches(
        [_int_key_lanes(np.array([1, 1, 2]))],
        [np.arange(3, dtype=np.int64)])
    perm, winner, total = ShardedBucketMerge(mesh)(lanes, seq_hi,
                                                   seq_lo, invalid)
    assert perm.shape == (1, 1024) and total == 2
    assert sorted(perm[0][winner[0]].tolist()) == [1, 2]


def test_dryrun_and_run_engines_small(tmp_path):
    """parallel/dryrun at a small size on 4 lanes: the dryrun's own
    checks pass, and run_engines' tables compact to the reference's
    row counts on the same seed (the reference on 4 CPU devices)."""
    from paimon_tpu.parallel.dryrun import run_engines as ref_run_engines
    from paimon_tpu_torch.parallel import dryrun

    dryrun.run(4, device="cpu", total_rows=20_000)
    got = dryrun.run_engines(4, rows=20_000, device="cpu",
                             out_path=str(tmp_path / "port.json"))
    want = ref_run_engines(4, rows=20_000, mesh=ref_bucket_mesh(4))
    for engine in ("deduplicate", "aggregation"):
        g, w = got["engines"][engine], want["engines"][engine]
        assert (g["input_rows"], g["output_rows"], g["buckets"]) == \
            (w["input_rows"], w["output_rows"], w["buckets"])
        assert g["input_rows"] >= 20_000
    assert (tmp_path / "port.json").exists()


# -- spans and metrics of the mesh plane (obs/trace.py, metrics.py) ----------


@pytest.fixture
def trace_state():
    """Restores obs/trace.py's process-global switches after a test."""
    from paimon_tpu_torch.obs import trace
    yield trace
    trace.disable_tracing()
    trace.set_metrics_enabled(True)
    trace._export_path = trace._export_dir = None
    trace.collector().resize(trace.DEFAULT_BUFFER_SPANS)
    trace.collector().clear()


def test_sync_from_options_explicit_wins_absent_leaves(trace_state):
    from paimon_tpu_torch.options import CoreOptions

    trace = trace_state
    trace.disable_tracing()
    trace.sync_from_options(CoreOptions({"trace.enabled": "true",
                                         "trace.buffer.spans": "32"}))
    assert trace.tracing_enabled() and trace.collector().max_spans == 32
    trace.sync_from_options(CoreOptions({"bucket": "1"}))
    assert trace.tracing_enabled()
    trace.enable_tracing(max_spans=12345)
    trace.sync_from_options(CoreOptions({"trace.enabled": "true"}))
    assert trace.collector().max_spans == 12345
    trace.sync_from_options(CoreOptions({"trace.enabled": "false"}))
    assert not trace.tracing_enabled()
    trace.sync_from_options(CoreOptions({"metrics.enabled": "false"}))
    assert not trace.metrics_enabled()
    trace.sync_from_options(CoreOptions({"metrics.enabled": "true"}))
    assert trace.metrics_enabled()


def test_traced_mesh_compaction_spans_and_histogram(tmp_path, mesh,
                                                    ref_mesh, trace_state):
    """trace.enabled with an export path and a spool directory: the mesh
    compaction records one compaction.window span a window step, as the
    reference does on the same table, lands their durations in the
    compaction group's window histogram, and writes the Chrome trace
    and the spool."""
    import json

    from paimon_tpu.obs import trace as ref_trace
    from paimon_tpu_torch.metrics import (
        COMPACTION_WINDOW_MS, global_registry,
    )

    opts = {"trace.enabled": "true",
            "trace.export.path": str(tmp_path / "trace.json"),
            "trace.export.dir": str(tmp_path / "spool")}
    hist = global_registry().compaction_metrics().histogram(
        COMPACTION_WINDOW_MS)
    before = hist.total_count
    port = port_random_engine_table(str(tmp_path / "p"), 61, "deduplicate",
                                    extra_options=opts)
    ref = make_random_engine_table(str(tmp_path / "r"), 61, "deduplicate",
                                   extra_options={"trace.enabled": "true"})
    trace_state.collector().clear()
    stats = compact_table_mesh(port, mesh)
    ref_trace.collector().clear()
    try:
        ref_compact_mesh(ref, ref_mesh)
        ref_windows = [s for s in ref_trace.take_spans()
                       if s.name == "compaction.window"]
    finally:
        ref_trace.disable_tracing()
    windows = [s for s in trace_state.take_spans()
               if s.name == "compaction.window"]
    assert len(windows) == len(ref_windows) > 0
    assert [s.attrs["lanes"] for s in windows] == \
        [s.attrs["lanes"] for s in ref_windows]
    assert hist.total_count - before == len(windows)
    assert stats.windows == sum(s.attrs["lanes"] for s in windows)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "compaction.window" for e in events)
    spool = list((tmp_path / "spool").iterdir())
    assert len(spool) == 1 and spool[0].read_text().count("\n") >= \
        len(windows)

    # metrics.enabled=false: spans still trace, the histogram stays
    trace_state.set_metrics_enabled(False)
    count = hist.total_count
    with trace_state.span("compaction.window", group="compaction",
                          metric=COMPACTION_WINDOW_MS):
        pass
    assert hist.total_count == count


@pytest.mark.parametrize("strings", [False, True],
                         ids=["covered", "string-fallback"])
def test_mesh_device_decode_hook(tmp_path, mesh, ref_mesh, monkeypatch,
                                 strings):
    """read.device-decode=true: the mesh's run readers decode parquet
    through the device decode plane; files outside its coverage (string
    columns) read through pyarrow, counted in rawpage.DECODE_COUNTS and
    in the scan group's device-decode fallbacks.  Rows and stored rows
    equal the reference's mesh compaction of the same table."""
    from paimon_tpu_torch.format import rawpage
    from paimon_tpu_torch.metrics import (
        SCAN_DEVICE_DECODE_FALLBACKS, global_registry,
    )

    monkeypatch.setattr(rawpage, "DECODE_COUNTS",
                        {"files": 0, "fallbacks": 0})
    fallbacks = global_registry().scan_metrics().counter(
        SCAN_DEVICE_DECODE_FALLBACKS)
    before = fallbacks.count
    opts = {"read.device-decode": "true"}
    if strings:
        meshed = port_random_engine_table(str(tmp_path / "p"), 71,
                                          "deduplicate", extra_options=opts)
        ref = make_random_engine_table(str(tmp_path / "r"), 71,
                                       "deduplicate", extra_options=opts)
    else:
        rng = np.random.default_rng(9)
        batches = [(rng.integers(0, 3000, 2000), rng.random(2000))
                   for _ in range(3)]
        meshed = _id_v_table(tmp_path / "p", batches, opts, ref=False)
        ref = _id_v_table(tmp_path / "r", batches, opts, ref=True)
    files = sum(len(s.data_files) for s in
                meshed.new_read_builder().new_scan().plan().splits)
    stats = compact_table_mesh(meshed, mesh)
    ref_compact_mesh(ref, ref_mesh)
    assert stats.snapshot_id is not None and stats.retries == 0
    if strings:
        assert rawpage.DECODE_COUNTS == {"files": 0, "fallbacks": files}
        assert fallbacks.count - before == files
    else:
        assert rawpage.DECODE_COUNTS == {"files": files, "fallbacks": 0}
        assert fallbacks.count == before
    key = (lambda r: (r["pt"], r["id"])) if strings else \
        (lambda r: r["id"])
    assert sorted(meshed.to_arrow().to_pylist(), key=key) == \
        sorted(ref.to_arrow().to_pylist(), key=key)
    assert bucket_kv(meshed) == ref_bucket_kv(ref)


def _id_v_table(path, batches, options, ref: bool):
    """A 4-bucket (id BIGINT key, v DOUBLE) table of `batches`, in
    either package: every column inside the device decode's coverage."""
    from paimon_tpu.schema import Schema as RefSchema
    from paimon_tpu.types import BigIntType as RefBigInt
    from paimon_tpu.types import DoubleType as RefDouble

    schema_cls, big, dbl = (RefSchema, RefBigInt, RefDouble) if ref else \
        (Schema, BigIntType, DoubleType)
    schema = (schema_cls.builder().column("id", big(False))
              .column("v", dbl()).primary_key("id")
              .options({"bucket": "4", "write-only": "true", **options})
              .build())
    table = RefTable.create(str(path), schema) if ref else \
        FileStoreTable.create(str(path), schema, device="cpu")
    for ids, vals in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write_arrow(pa.table({"id": pa.array(ids, pa.int64()),
                                "v": pa.array(vals, pa.float64())}))
        wb.new_commit().commit(w.prepare_commit())
        w.close()
    return table
