"""parallel/multihost.py of paimon_tpu_torch against paimon_tpu's.

The cases of tests/test_multihost.py that do not name jax (the
single-process bootstrap, the tolerance parse, split assignment, the
commit user, the bad mesh shapes) run on both packages through
`run_reference_case`; the jax-specific ones (the global mesh's devices,
the globally sharded arrays, the Gloo opt-in warning) have port versions
here on the port's own types (a BucketMesh of one lane a process,
ShardedColumn, the gloo backend check).  Then a real 2-process gloo
group holds the agreement primitives (barrier, broadcast_value,
allgather_bytes with empty and unequal payloads) and
process_local_batch's global sum, and the port's version of
tests/test_multihost_real.py writes partitions of one table from two
processes and reduces a sharded column across them; compact_table_mesh
over a mesh of both processes compacts each one's groups.  Every worker
exits through os._exit after a bounded run, and each group has a 120 s
timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from paimon_tpu_torch.parallel import multihost as MH
from tests.test_torch_append import reference_cases, run_reference_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_CASES = ("TestGlobalMesh.test_one_axis_inferred",
              "TestGlobalMesh.test_two_axis",
              "TestProcessLocalBatch.test_batch_shards_across_mesh",
              "TestProcessLocalBatch.test_feeds_jax_data_loader_sharding",
              "TestInitializeConfigWarning."
              "test_gloo_config_failure_warns_not_silent")
CASES = reference_cases("test_multihost", skip=_JAX_CASES, classes=True)


def test_reference_cases_are_all_here():
    assert len(CASES) + len(_JAX_CASES) == 16


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c[1] for c in CASES])
def test_reference_case(case, pkg, tmp_path, monkeypatch):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


# -- the port's versions of the jax-specific cases ---------------------------

def test_global_mesh_one_lane_a_process():
    mesh = MH.global_mesh(("data",), device="cpu")
    assert (mesh.n_lanes, mesh.world, mesh.device.type) == (1, 1, "cpu")


def test_global_mesh_multi_axis_flattens():
    mesh = MH.global_mesh(("data", "model"), shape=(1, 1), device="cpu")
    assert mesh.n_lanes == 1
    with pytest.raises(ValueError, match="!= device count"):
        MH.global_mesh(("data", "model"), shape=(4, 2), device="cpu")


def test_process_local_batch_single_process():
    mesh = MH.global_mesh(("data",), device="cpu")
    n = 64
    batch = MH.process_local_batch(
        mesh, {"x": np.arange(n, dtype=np.int32),
               "y": np.arange(n, dtype=np.float32) * 2})
    assert batch["x"].shape == (n,)
    assert batch["x"].offset == 0
    assert batch["x"].local.device.type == "cpu"
    assert int(batch["x"].sum()) == n * (n - 1) // 2
    assert float(batch["y"].sum()) == float(n * (n - 1))


def test_process_local_batch_feeds_from_a_table_read(tmp_path):
    """A table's column through the loader path into one sharded column
    (the reference's jax_batches case)."""
    import pyarrow as pa

    from paimon_tpu_torch.integrations.jax_data import jax_batches
    from paimon_tpu_torch.schema import Schema
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType

    schema = (Schema.builder().column("id", BigIntType(False))
              .options({"bucket": "-1"}).build())
    t = FileStoreTable.create(str(tmp_path / "t"), schema, device="cpu")
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({"id": pa.array(range(64), pa.int64())}))
        wb.new_commit().commit(w.prepare_commit())
    batches = list(jax_batches(t, 32))
    assert len(batches) == 2
    ids = np.concatenate([b["id"].cpu().numpy() for b in batches])
    col = MH.process_local_batch(MH.global_mesh(device="cpu"),
                                 {"id": ids})["id"]
    assert col.shape == (64,) and int(col.sum()) == 64 * 63 // 2


def test_missing_gloo_warns_not_silent(monkeypatch):
    """A torch build without Gloo warns through the multihost group's
    config_warnings counter before the group is brought up (the
    reference's Gloo opt-in case)."""
    import warnings

    import torch.distributed as dist

    from paimon_tpu_torch.metrics import (
        MULTIHOST_CONFIG_WARNINGS, global_registry,
    )

    inits = []
    monkeypatch.setattr(dist, "is_gloo_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: inits.append(kw))
    counter = global_registry().multihost_metrics().counter(
        MULTIHOST_CONFIG_WARNINGS)
    before = counter.count
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        idx, count = MH.initialize("127.0.0.1:1", 2, 0)
    assert len(inits) == 1                  # the group still comes up
    assert inits[0]["backend"] == "gloo"
    assert inits[0]["init_method"] == "tcp://127.0.0.1:1"
    assert (inits[0]["world_size"], inits[0]["rank"]) == (2, 0)
    msgs = [str(w.message) for w in caught]
    assert any("Gloo" in m and "cross-process" in m for m in msgs), msgs
    assert counter.count == before + 1
    assert (idx, count) == (0, 1)           # no group was formed


def test_initialize_needs_a_coordinator(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        MH.initialize(None, 2, 0)


# -- real 2-process gloo groups ----------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(src: str, tmp_path, n: int = 2, args=(),
                timeout: float = 180.0) -> list:
    """`src` in `n` processes (argv: pid, port, tmp dir, repo, n, args);
    each must exit 0 within `timeout`, or all are killed."""
    port = free_port()
    path = tmp_path / "worker.py"
    path.write_text(src)
    procs = [subprocess.Popen(
        [sys.executable, str(path), str(pid), str(port), str(tmp_path),
         REPO, str(n), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid}:\n{out[-4000:]}"
    return outs


_PRIMITIVES = r'''
import os, sys
pid, port, tmp, repo, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4], int(sys.argv[5]))
sys.path.insert(0, repo)
sys.modules["jax"] = None
import numpy as np
from paimon_tpu_torch.parallel import multihost as MH
from paimon_tpu_torch.metrics import (
    MULTIHOST_BARRIER_WAIT_MS, global_registry,
)

assert MH.initialize(f"127.0.0.1:{port}", n, pid, timeout_s=120) == (pid, n)
assert MH.process_index() == pid and MH.process_count() == n
assert MH.distributed_write_commit_user() == f"writer-p{pid}"
assert MH.barrier("start") >= 0.0
h = global_registry().multihost_metrics().histogram(
    MULTIHOST_BARRIER_WAIT_MS)
assert h.count == 1
assert MH.broadcast_value(100 + pid) == 100
assert MH.broadcast_value(200 + pid, root=n - 1) == 200 + n - 1
# unequal and empty payloads come back exact
payload = b"" if pid == 0 else bytes(range(256)) * (pid * 3)
got = MH.allgather_bytes(payload)
want = [b"" if p == 0 else bytes(range(256)) * (p * 3) for p in range(n)]
assert got == want, [len(g) for g in got]
assert MH.allgather_bytes(b"") == [b""] * n
# each process's rows, one column sharded along the processes
rows = np.arange(pid * 1000, pid * 1000 + 100 + 50 * pid, dtype=np.int64)
col = MH.process_local_batch(MH.global_mesh(device="cpu"), {"x": rows})["x"]
sizes = [100 + 50 * p for p in range(n)]
assert col.shape == (sum(sizes),), col.shape
assert col.offset == sum(sizes[:pid])
total = sum(int(np.arange(p * 1000, p * 1000 + sizes[p]).sum())
            for p in range(n))
assert int(col.sum()) == total, (int(col.sum()), total)
# a split plan every process computes alike, disjoint and covering
shares = MH.allgather_bytes(repr(MH.assign_splits(list(range(9)))).encode())
owned = sorted(x for s in shares for x in eval(s))
assert owned == list(range(9)), owned
MH.barrier("end")
print(f"proc {pid}: PRIMITIVES-OK", flush=True)
sys.stdout.flush()
os._exit(0)
'''


def test_two_process_agreement_primitives(tmp_path):
    outs = run_workers(_PRIMITIVES, tmp_path)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: PRIMITIVES-OK" in out, out[-2000:]


_REAL = r'''
import os, sys, time
pid, port, tmp, repo, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4], int(sys.argv[5]))
sys.path.insert(0, repo)
sys.modules["jax"] = None
import numpy as np
import pyarrow as pa
from paimon_tpu_torch.parallel import multihost as MH
assert MH.initialize(f"127.0.0.1:{port}", n, pid, timeout_s=120) == (pid, n)

from paimon_tpu_torch import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, IntType, VarCharType

ROWS = 128
path = os.path.join(tmp, "t")
schema = (Schema.builder()
          .column("part", VarCharType(nullable=False))
          .column("id", BigIntType(False))
          .column("v", IntType())
          .partition_keys("part")
          .primary_key("id", "part")
          .options({"bucket": "1"}).build())
if pid == 0:
    FileStoreTable.create(path, schema, device="cpu")
MH.barrier("created")
t = FileStoreTable.load(path, device="cpu")
# each process commits its own partition; the snapshot CAS serializes
wb = t.new_batch_write_builder()
wb.commit_user = MH.distributed_write_commit_user()
w = wb.new_write()
w.write_dicts([{"part": f"h{pid}", "id": i, "v": pid} for i in range(ROWS)])
wb.new_commit().commit(w.prepare_commit())
w.close()
MH.barrier("committed")
t = FileStoreTable.load(path, device="cpu")
assert t.to_arrow().num_rows == 2 * ROWS
splits = sorted(t.new_read_builder().new_scan().plan().splits,
                key=lambda s: s.partition)
mine = MH.assign_splits(splits)
assert len(mine) == 1, "ownership must be disjoint"
read = t.new_read_builder().new_read()
local = pa.concat_tables([read.read_split(s) for s in mine])
assert local.num_rows == ROWS
g = MH.process_local_batch(MH.global_mesh(("b",), device="cpu"), {
    "v": np.asarray(local.column("v").combine_chunks(), dtype=np.int32)},
    axis="b")
total = int(g["v"].sum())
assert g["v"].shape == (2 * ROWS,)
assert total == ROWS, total          # pid-0 rows are 0, pid-1 rows are 1
print(f"proc {pid}: MULTIHOST-OK n={g['v'].shape[0]} sum={total}",
      flush=True)
os._exit(0)
'''


def test_two_process_multihost(tmp_path):
    """The port's version of tests/test_multihost_real.py: two gloo
    processes write disjoint partitions of one table (per-process commit
    users, CAS-serialized), take split ownership and reduce a column
    sharded across them."""
    outs = run_workers(_REAL, tmp_path)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: MULTIHOST-OK n=256 sum=128" in out, \
            out[-2000:]


_MESH_COMPACT = r'''
import os, sys
pid, port, tmp, repo, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4], int(sys.argv[5]))
sys.path.insert(0, repo)
sys.modules["jax"] = None
import numpy as np
import pyarrow as pa
from paimon_tpu_torch.parallel import multihost as MH
assert MH.initialize(f"127.0.0.1:{port}", n, pid, timeout_s=120) == (pid, n)
from paimon_tpu_torch import Schema
from paimon_tpu_torch.parallel import bucket_mesh, compact_table_mesh
from paimon_tpu_torch.parallel.distributed import owner_of
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType

path = os.path.join(tmp, "t")
if pid == 0:
    t = FileStoreTable.create(path, Schema.builder()
                              .column("id", BigIntType(False))
                              .column("v", BigIntType()).primary_key("id")
                              .options({"bucket": "4"}).build(),
                              device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        wb = t.new_batch_write_builder()
        with wb.new_write() as w:
            ids = rng.integers(0, 500, 400)
            w.write_arrow(pa.table({"id": pa.array(ids, pa.int64()),
                                    "v": pa.array(ids * 10, pa.int64())}))
            wb.new_commit().commit(w.prepare_commit())
MH.barrier("written")
t = FileStoreTable.load(path, device="cpu")
# a mesh of 2 lanes over the 2 processes: each compacts its own groups
stats = compact_table_mesh(t, mesh=bucket_mesh(2, "cpu"))
mine = sorted(b for b in range(4) if owner_of((), b, 2) == pid)
assert stats.buckets == len(mine) and stats.lanes == 1, stats
MH.barrier("compacted")
t = FileStoreTable.load(path, device="cpu")
for s in t.new_read_builder().new_scan().plan().splits:
    assert len(s.data_files) == 1, (s.bucket, len(s.data_files))
print(f"proc {pid}: MESH-OK {mine} {t.to_arrow().num_rows}", flush=True)
os._exit(0)
'''


def test_two_process_mesh_compacts_each_processes_groups(tmp_path):
    """compact_table_mesh over a mesh of two processes (it raised naming
    A.8.9): each process compacts the groups `owner_of` gives it, on
    its own lane, and the table ends fully compacted, equal to the rows
    written."""
    outs = run_workers(_MESH_COMPACT, tmp_path)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: MESH-OK" in out, out[-2000:]
    from paimon_tpu_torch.table import FileStoreTable
    t = FileStoreTable.load(str(tmp_path / "t"), device="cpu")
    got = t.to_arrow().sort_by("id")
    assert got.column("v").to_pylist() == [i * 10 for i in
                                           got.column("id").to_pylist()]
    assert t.fsck().ok
