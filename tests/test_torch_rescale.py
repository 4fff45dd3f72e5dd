"""paimon_tpu_torch's sharded compaction and all_to_all bucket rescale
against paimon_tpu's, on the CPU.

Counterparts of tests/test_sharded_compact.py (the reference on its
8-device virtual CPU mesh, the port on 8 lanes on device="cpu"), the
rescale dispatch against the reference's and the host bucket formula
(negative hashes and INT32_MIN included), tables rescaled by either
package read by the other, and the collectives in two processes
(torch.distributed over gloo): the sharded merge's summed total and
the rescale's all_to_all equal to the one-process result.
"""

import os
import pickle
from datetime import timedelta

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu.core.bucket import _bucket_from_hash as ref_bucket_from_hash
from paimon_tpu.parallel import bucket_mesh as ref_bucket_mesh
from paimon_tpu.parallel import compact_table_sharded as ref_sharded
from paimon_tpu.parallel import rescale_dispatch_sharded as ref_dispatch
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import RowKind as RefRowKind
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch.core.bucket import _bucket_from_hash
from paimon_tpu_torch.parallel import (
    bucket_mesh, compact_table_sharded, merge_buckets_sharded,
    rescale_dispatch_sharded, rescale_table_buckets,
)
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import (
    BigIntType, DoubleType, IntType, RowKind, VarCharType,
)
from tests.test_mesh_engine import _bucket_kv as ref_bucket_kv


@pytest.fixture(scope="module")
def mesh():
    return bucket_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_bucket_mesh(8)


def pk_tables(tmp_path, buckets=8):
    """(port, reference) twins: id BIGINT key, name STRING, v DOUBLE."""
    def schema(cls, big, varchar, dbl):
        return (cls.builder()
                .column("id", big(False))
                .column("name", varchar.string_type())
                .column("v", dbl())
                .primary_key("id")
                .options({"bucket": str(buckets), "write-only": "true"})
                .build())
    return (FileStoreTable.create(str(tmp_path / "port"),
                                  schema(Schema, BigIntType, VarCharType,
                                         DoubleType), device="cpu"),
            RefTable.create(str(tmp_path / "ref"),
                            schema(RefSchema, RefBigInt, RefVarChar,
                                   RefDouble)))


def write(tables, rows, row_kinds=None):
    for t in tables:
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write_dicts(rows, row_kinds=row_kinds)
        wb.new_commit().commit(w.prepare_commit())
        w.close()


def rows_by_id(t):
    return t.to_arrow().sort_by("id").to_pylist()


def port_bucket_kv(table):
    from tests.test_torch_mesh import bucket_kv
    return bucket_kv(table)


def test_sharded_compact_end_to_end(tmp_path, mesh, ref_mesh):
    port, ref = pk_tables(tmp_path)
    rng = np.random.default_rng(3)
    for _ in range(3):   # 3 overlapping L0 runs per bucket
        ids = rng.integers(0, 500, 600)
        write((port, ref), [{"id": int(i), "name": f"n{i}", "v": float(i)}
                            for i in ids])
    before = rows_by_id(port)
    assert before == rows_by_id(ref)
    files_before = sum(len(s.data_files) for s in
                       port.new_read_builder().new_scan().plan().splits)

    stats = compact_table_sharded(port, mesh)
    ref_stats = ref_sharded(ref, ref_mesh)
    assert stats.snapshot_id is not None
    assert stats.buckets == 8
    assert stats.output_rows == len(before) == ref_stats.output_rows
    assert (stats.input_rows, stats.total_winners) == \
        (ref_stats.input_rows, ref_stats.total_winners)
    snap = port.latest_snapshot()
    assert snap.id == stats.snapshot_id
    assert snap.commit_kind == "COMPACT"
    assert rows_by_id(port) == before == rows_by_id(ref)
    assert port_bucket_kv(port) == ref_bucket_kv(ref)
    plan = port.new_read_builder().new_scan().plan()
    assert sum(len(s.data_files) for s in plan.splits) <= 8 < files_before
    for s in plan.splits:
        assert len(s.data_files) == 1
        assert s.data_files[0].level == port.options.num_levels - 1
    # each package reads what the other compacted
    assert rows_by_id(RefTable.load(port.path)) == before
    assert rows_by_id(FileStoreTable.load(ref.path, device="cpu")) == before


def test_sharded_compact_drops_deletes(tmp_path, mesh, ref_mesh):
    port, ref = pk_tables(tmp_path)
    write((port, ref), [{"id": i, "name": "a", "v": float(i)}
                        for i in range(40)])
    for t, kind in ((port, RowKind.DELETE), (ref, RefRowKind.DELETE)):
        write((t,), [{"id": i, "name": "a", "v": float(i)}
                     for i in range(0, 40, 2)], row_kinds=[kind] * 20)
    stats = compact_table_sharded(port, mesh)
    ref_sharded(ref, ref_mesh)
    out = port.to_arrow().sort_by("id")
    assert out.column("id").to_pylist() == list(range(1, 40, 2))
    assert stats.output_rows == 20
    assert port_bucket_kv(port) == ref_bucket_kv(ref)


def _hashes(seed, n):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    # negative hashes as int32 bit patterns, INT32_MIN and its
    # neighbours, 0 and -1
    h[:6] = np.array([0x80000000, 0x80000001, 0x7FFFFFFF, 0xFFFFFFFF, 0,
                      1], dtype=np.uint32)
    return h


def test_rescale_dispatch_matches_reference_formula(mesh, ref_mesh):
    # 5003 rows: not a multiple of 8 lanes, so padding rows exist and
    # must not race genuine slot-(0, 0) rows in the scatter
    hashes = _hashes(11, 5003)
    for new_b in (3, 8, 17):
        routing = rescale_dispatch_sharded(hashes, new_b, mesh)
        expected = _bucket_from_hash(hashes, new_b)
        assert np.array_equal(expected,
                              ref_bucket_from_hash(hashes, new_b))
        seen = 0
        for b, gids in routing.items():
            assert (expected[gids] == b).all()
            seen += len(gids)
        assert seen == len(hashes)
        want = ref_dispatch(hashes, new_b, ref_mesh)
        assert sorted(routing) == sorted(want)
        for b in routing:
            assert np.array_equal(routing[b], want[b])


def test_rescale_dispatch_skew_retries(mesh):
    """Every row to one lane overflows the first slot capacity; the
    dispatch grows it and reruns, dropping nothing."""
    from paimon_tpu_torch.parallel import rescale

    hashes = np.full(4096, 0x80000000, dtype=np.uint32)   # INT32_MIN
    caps = []
    kernel = rescale._dispatch_kernel

    def recorded(*args, **kwargs):
        blocks, dropped = kernel(*args, **kwargs)
        caps.append((args[4], dropped))
        return blocks, dropped

    rescale._dispatch_kernel = recorded
    try:
        routing = rescale_dispatch_sharded(hashes, 5, mesh)
    finally:
        rescale._dispatch_kernel = kernel
    assert len(caps) == 2 and caps[0][1] > 0 and caps[-1][1] == 0
    assert list(routing) == [int(_bucket_from_hash(hashes[:1], 5)[0])]
    assert np.array_equal(routing[list(routing)[0]], np.arange(4096))


def test_rescale_table_buckets_roundtrip(tmp_path, mesh, ref_mesh):
    port, ref = pk_tables(tmp_path, buckets=2)
    rng = np.random.default_rng(5)
    for _ in range(2):
        ids = rng.integers(0, 300, 400)
        write((port, ref), [{"id": int(i), "name": f"n{i}", "v": float(i)}
                            for i in ids])
    before = rows_by_id(port)
    assert before == rows_by_id(ref)

    assert port.rescale_buckets(8, mesh=mesh) is not None
    assert ref.rescale_buckets(8, mesh=ref_mesh) is not None

    t2 = FileStoreTable.load(port.path, device="cpu")
    assert t2.options.bucket == 8
    assert rows_by_id(t2) == before
    plan = t2.new_read_builder().new_scan().plan()
    assert {s.bucket for s in plan.splits} <= set(range(8))
    assert len(plan.splits) > 2
    assert port_bucket_kv(t2) == ref_bucket_kv(RefTable.load(ref.path))
    # each package reads what the other rescaled
    assert rows_by_id(RefTable.load(port.path)) == before
    assert rows_by_id(FileStoreTable.load(ref.path, device="cpu")) == before

    # the rescaled table keeps working: upsert + read
    write((t2,), [{"id": 7, "name": "updated", "v": -1.0}])
    row = [r for r in t2.to_arrow().to_pylist() if r["id"] == 7]
    assert row and row[0]["name"] == "updated"


def test_rescale_rejects_wrong_table_kinds(tmp_path, mesh):
    port, _ = pk_tables(tmp_path, buckets=2)
    write((port,), [{"id": 1, "name": "a", "v": 1.0}])
    with pytest.raises(ValueError):
        rescale_table_buckets(port, 0, mesh)
    schema = (Schema.builder().column("p", IntType(False))
              .column("id", BigIntType(False)).partition_keys("p")
              .primary_key("p", "id").options({"bucket": "2"}).build())
    parted = FileStoreTable.create(str(tmp_path / "parted"), schema,
                                   device="cpu")
    with pytest.raises(NotImplementedError):
        rescale_table_buckets(parted, 4, mesh)
    # dynamic buckets (bucket=-1) do not open in this package at all
    with pytest.raises(NotImplementedError):
        FileStoreTable.create(
            str(tmp_path / "dyn"),
            Schema.builder().column("id", BigIntType(False))
            .primary_key("id").options({"bucket": "-1"}).build(),
            device="cpu")


# -- collectives in two processes ---------------------------------------------


def _gloo_inputs():
    from tests.test_torch_mesh import _int_key_lanes
    rng = np.random.default_rng(42)
    lanes = [_int_key_lanes(rng.integers(0, 50, 64 + 32 * b))
             for b in range(6)]
    seqs = [np.arange(len(la), dtype=np.int64) for la in lanes]
    return lanes, seqs, _hashes(19, 3001)


def _mesh_results(mesh):
    lanes, seqs, hashes = _gloo_inputs()
    winners, total = merge_buckets_sharded(lanes, seqs, mesh)
    routing = {nb: rescale_dispatch_sharded(hashes, nb, mesh)
               for nb in (3, 16)}
    return {"winners": winners, "total": total, "routing": routing}


def _gloo_worker(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        res = _mesh_results(bucket_mesh(8, device="cpu"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def test_collectives_in_two_processes(tmp_path, mesh):
    """World size 2 over gloo: each rank holds 4 of the 8 lanes; the
    sharded merge's winners and summed total and the rescale's
    all_to_all routing equal the one-process result on every rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, 2, str(tmp_path / "rdzv"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    want = _mesh_results(mesh)
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["total"] == want["total"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["winners"], want["winners"]))
        for nb, routing in want["routing"].items():
            assert sorted(got["routing"][nb]) == sorted(routing)
            for b in routing:
                assert np.array_equal(got["routing"][nb][b], routing[b])
