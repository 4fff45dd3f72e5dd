"""Per-bucket fault isolation of paimon_tpu_torch's mesh compaction
(parallel/mesh_engine.py point 4, parallel/fault.py), on the CPU.

Counterparts of tests/test_mesh_fault_tolerance.py: transient faults in
one bucket's window stream retry with backoff, degrade to the
single-chip path once retries run out, and the commit stays equal to a
fault-free run's, file for file, and to the reference's fault-free mesh
compaction of the same seed.  Non-transient errors, the kernel
wrapper's launch failure among them, propagate at once.
"""

import jax
import pytest
import torch

from paimon_tpu.parallel import bucket_mesh as ref_bucket_mesh
from paimon_tpu.parallel import compact_table_mesh as ref_compact_mesh
from paimon_tpu_torch.metrics import (
    COMPACTION_BUCKET_FAILURES, COMPACTION_BUCKET_FALLBACKS,
    COMPACTION_BUCKET_RETRIES, global_registry,
)
from paimon_tpu_torch.obs.flight import EV_RETRY, recorder
from paimon_tpu_torch.parallel import (
    BucketRetryPolicy, bucket_mesh, compact_table_mesh, is_transient_error,
)
from paimon_tpu_torch.parallel import mesh_engine as me
from paimon_tpu_torch.table import FileStoreTable
from tests.failing_fileio import FailingFileIO, InjectedIOError
from tests.store_oracle import make_random_engine_table
from tests.test_mesh_engine import _bucket_kv as ref_bucket_kv
from tests.test_torch_mesh import bucket_kv, port_random_engine_table, rows_of


@pytest.fixture(scope="module")
def mesh():
    return bucket_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) >= 8
    return ref_bucket_mesh(8)


def _triplet(tmp_path, engine, seed, ref_mesh, **kw):
    """(clean port table, faulty-to-be port table), with the reference's
    fault-free mesh compaction of the same seed: its rows and its
    per-bucket KV rows."""
    clean = port_random_engine_table(str(tmp_path / "clean"), seed, engine,
                                     **kw)
    faulty = port_random_engine_table(str(tmp_path / "faulty"), seed,
                                      engine, **kw)
    ref = make_random_engine_table(str(tmp_path / "ref"), seed, engine,
                                   **kw)
    assert ref_compact_mesh(ref, ref_mesh).snapshot_id is not None
    return clean, faulty, (rows_of(ref), ref_bucket_kv(ref))


def _broken(table, name):
    """The table over the reference's fault-injecting FileIO (it wraps
    any FileIO by delegation)."""
    return FileStoreTable(FailingFileIO(table.file_io, name), table.path,
                          table.schema_manager.latest(), device="cpu")


def _counter(name):
    return global_registry().compaction_metrics().counter(name).count


def _policy(**kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("backoff_base_ms", 0.0)
    return BucketRetryPolicy(**kw)


def _same(table, clean, ref):
    reread = FileStoreTable.load(table.path, device="cpu")
    assert reread.latest_snapshot().commit_kind == "COMPACT"
    assert bucket_kv(reread) == bucket_kv(clean) == ref[1]
    assert rows_of(reread) == rows_of(clean) == ref[0]


def test_transient_fault_retries_to_identical_output(tmp_path, mesh,
                                                     ref_mesh):
    clean, faulty, ref = _triplet(tmp_path, "deduplicate", 101, ref_mesh,
                                  buckets=1)
    assert compact_table_mesh(clean, mesh).snapshot_id is not None
    name = "torch-mesh-retry"
    broken = _broken(faulty, name)
    retries0 = _counter(COMPACTION_BUCKET_RETRIES)
    FailingFileIO.reset(name, 0, fail_times=1)   # one transient kill
    try:
        stats = compact_table_mesh(broken, mesh, retry_policy=_policy())
    finally:
        FailingFileIO.disarm(name)
    assert stats.snapshot_id is not None
    assert stats.retries >= 1 and stats.fallbacks == 0
    assert _counter(COMPACTION_BUCKET_RETRIES) == retries0 + stats.retries
    assert [r for r in FailingFileIO.ops(name) if r.killed]
    _same(faulty, clean, ref)


def test_storm_exhausts_retries_then_single_chip_fallback(tmp_path, mesh,
                                                          ref_mesh):
    clean, faulty, ref = _triplet(tmp_path, "aggregation", 55, ref_mesh,
                                  buckets=1)
    assert compact_table_mesh(clean, mesh).snapshot_id is not None
    name = "torch-mesh-fallback"
    broken = _broken(faulty, name)
    fallbacks0 = _counter(COMPACTION_BUCKET_FALLBACKS)
    # the storm outlives the mesh retries (2 kills, max_attempts=2) but
    # has passed by the time the single-chip fallback runs
    FailingFileIO.reset(name, 0, fail_times=2)
    try:
        stats = compact_table_mesh(broken, mesh,
                                   retry_policy=_policy(max_attempts=2))
    finally:
        FailingFileIO.disarm(name)
    assert stats.snapshot_id is not None
    assert stats.retries == 1 and stats.fallbacks == 1
    assert _counter(COMPACTION_BUCKET_FALLBACKS) == fallbacks0 + 1
    _same(faulty, clean, ref)


def test_device_loss_degrades_every_bucket(tmp_path, mesh, ref_mesh,
                                           monkeypatch):
    """A lost card (torch.AcceleratorError, the port's device loss)
    fails every in-flight bucket; each rides its own ladder down to the
    single-chip path and the job still commits the fault-free result."""
    clean, faulty, ref = _triplet(tmp_path, "deduplicate", 77, ref_mesh,
                                  buckets=3)
    assert compact_table_mesh(clean, mesh).snapshot_id is not None

    def lost(self, *a):
        raise torch.AcceleratorError("device lost")

    monkeypatch.setattr(me._MeshWindowKernel, "__call__", lost)
    stats = compact_table_mesh(faulty, mesh,
                               retry_policy=_policy(max_attempts=2))
    assert stats.snapshot_id is not None
    assert stats.fallbacks >= 1
    _same(faulty, clean, ref)


def test_fallback_disabled_raises_after_retries(tmp_path, mesh):
    table = port_random_engine_table(str(tmp_path / "t"), 9, "deduplicate",
                                     buckets=1)
    name = "torch-mesh-no-fallback"
    broken = _broken(table, name)
    failures0 = _counter(COMPACTION_BUCKET_FAILURES)
    FailingFileIO.reset(name, 0)               # hard fault: never clears
    try:
        with pytest.raises(InjectedIOError):
            compact_table_mesh(
                broken, mesh,
                retry_policy=_policy(max_attempts=2, fallback=False))
    finally:
        FailingFileIO.disarm(name)
    assert _counter(COMPACTION_BUCKET_FAILURES) == failures0 + 1
    # nothing committed; the table still reads at its last snapshot
    reread = FileStoreTable.load(table.path, device="cpu")
    assert reread.latest_snapshot().commit_kind != "COMPACT"
    reread.to_arrow()


def test_non_transient_error_propagates_immediately(tmp_path, mesh,
                                                    monkeypatch):
    """Programming errors do not ride the retry ladder."""
    table = port_random_engine_table(str(tmp_path / "t"), 13,
                                     "deduplicate", buckets=1)
    calls = {"n": 0}

    def boom(self, *a, **kw):
        calls["n"] += 1
        raise ValueError("schema bug")

    monkeypatch.setattr(me._EngineContext, "merge_window_device", boom)
    monkeypatch.setattr(me._EngineContext, "merge_window_host", boom)
    with pytest.raises(ValueError, match="schema bug"):
        compact_table_mesh(table, mesh, retry_policy=_policy())
    assert calls["n"] == 1


def test_kernel_launch_failure_propagates_immediately(tmp_path, mesh,
                                                      monkeypatch):
    """The winner-select wrapper's launch failure is not transient: it
    fails the job at once instead of hiding behind the single-chip
    fallback, and nothing is committed."""
    from paimon_tpu_torch.ops import merge

    table = port_random_engine_table(str(tmp_path / "t"), 17,
                                     "deduplicate", buckets=2)
    calls = {"n": 0}

    def failed(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("eq_next_mask kernel launch failed: CUDA error 1")

    monkeypatch.setattr(merge, "eq_next_mask", failed)
    fallbacks0 = _counter(COMPACTION_BUCKET_FALLBACKS)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        compact_table_mesh(table, mesh, retry_policy=_policy())
    assert calls["n"] == 1
    assert _counter(COMPACTION_BUCKET_FALLBACKS) == fallbacks0
    assert FileStoreTable.load(table.path, device="cpu") \
        .latest_snapshot().commit_kind != "COMPACT"


def test_is_transient_error_taxonomy():
    import torch.distributed as dist

    from paimon_tpu_torch.format.format import CorruptDataError
    from paimon_tpu_torch.fs.object_store import TransientStoreError
    from paimon_tpu_torch.utils.deadline import DeadlineExceededError

    assert is_transient_error(TransientStoreError("503"))
    assert is_transient_error(InjectedIOError("killed"))
    assert is_transient_error(OSError("io"))
    assert is_transient_error(FileNotFoundError("raced"))
    assert is_transient_error(torch.AcceleratorError("device lost"))
    assert is_transient_error(dist.DistBackendError("peer died"))
    assert is_transient_error(dist.DistNetworkError("link down"))
    assert not is_transient_error(ValueError("bug"))
    assert not is_transient_error(KeyError("bug"))
    assert not is_transient_error(RuntimeError("generic"))
    assert not is_transient_error(RuntimeError(
        "eq_next_mask kernel launch failed: CUDA error 9"))
    assert not is_transient_error(RuntimeError("nvcc failed (1):\n..."))
    assert not is_transient_error(torch.cuda.OutOfMemoryError("oom"))
    assert not is_transient_error(CorruptDataError("torn footer"))
    assert not is_transient_error(DeadlineExceededError("spent"))


def test_retry_policy_from_options(tmp_path):
    table = port_random_engine_table(
        str(tmp_path / "t"), 3, "deduplicate", commits=1,
        rows_per_commit=10,
        extra_options={"compaction.retry.max-attempts": "7",
                       "compaction.retry.backoff": "250 ms",
                       "compaction.mesh.fallback": "false"})
    policy = BucketRetryPolicy.from_options(table.options)
    assert policy.max_attempts == 7
    assert policy.backoff_base_ms == 250
    assert policy.fallback is False
    default = BucketRetryPolicy.from_options(
        port_random_engine_table(str(tmp_path / "d"), 3, "deduplicate",
                                 commits=1, rows_per_commit=10).options)
    assert (default.max_attempts, default.backoff_base_ms,
            default.fallback) == (3, 10, True)


def test_retry_policy_retry_call():
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise OSError("transient")
        return "ok"

    seen = []
    events0 = sum(e["kind"] == EV_RETRY for e in recorder().snapshot())
    policy = BucketRetryPolicy(max_attempts=3, backoff_base_ms=0)
    assert policy.retry_call(
        flaky, on_retry=lambda n, e: seen.append(n)) == "ok"
    assert attempts["n"] == 3 and seen == [1, 2]
    assert sum(e["kind"] == EV_RETRY
               for e in recorder().snapshot()) >= events0 + 2

    attempts["n"] = 0
    with pytest.raises(OSError):
        BucketRetryPolicy(max_attempts=2,
                          backoff_base_ms=0).retry_call(flaky)
    assert attempts["n"] == 2

    def bug():
        raise ValueError("no retry")

    with pytest.raises(ValueError):
        policy.retry_call(bug)
