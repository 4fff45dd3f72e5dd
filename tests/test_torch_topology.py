"""The multi-writer ingest topology of paimon_tpu_torch against
paimon_tpu.

The 5 cases of tests/test_topology.py (checkpoints of 4 writers, a
replayed checkpoint that commits nothing, bucket ownership keeping a
key's versions in order over 8 writers, round-robin append, the
dynamic-bucket refusal) run on both packages
(tests/test_torch_object_store.py `run_case`).

On both packages: a topology of 4 writers commits the table a single
writer commits from the same batches, a replayed identifier commits
nothing, and the two packages' tables are equal; the port's 8 writers
under fast thread switches commit that table too.
"""

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dynamic_bucket import BOTH, PORT, REF
from tests.test_torch_object_store import expand, run_case
from tests.test_torch_vector import case_ids

CASES = expand("test_topology")


def test_reference_cases_are_all_listed():
    assert len(CASES) == 5


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


def _topology(pkg):
    import importlib
    name = "paimon_tpu_torch" if pkg is PORT else "paimon_tpu"
    return importlib.import_module(f"{name}.table.topology") \
        .StreamIngestTopology


def _batches(seed=3, checkpoints=3, per=6, n=400):
    rng = np.random.default_rng(seed)
    return [[pa.table({"id": pa.array(rng.integers(0, 2000, n), pa.int64()),
                       "v": pa.array(rng.random(n))})
             for _ in range(per)] for _ in range(checkpoints)]


def _ingest(pkg, root, name, writers, batches):
    t = pkg.create(root, pkg.schema(
        [("id", "BigIntType", False), ("v", "DoubleType", True)],
        options={"bucket": "6", "write-only": "true"}), name)
    topo = _topology(pkg)(t, num_writers=writers)
    try:
        for k, ckpt in enumerate(batches, 1):
            for b in ckpt:
                topo.write(b)
            assert topo.checkpoint(k) is not None
        # the last checkpoint replayed after a restart commits nothing
        for b in batches[-1]:
            topo.write(b)
        assert topo.checkpoint(len(batches)) is None
    finally:
        topo.close()
    assert t.latest_snapshot().id == len(batches)
    return sorted(t.to_arrow().to_pylist(), key=lambda r: r["id"])


@BOTH
def test_topology_equals_single_writer(tmp_path, pkg):
    batches = _batches()
    many = _ingest(pkg, str(tmp_path), "many", 4, batches)
    one = _ingest(pkg, str(tmp_path), "one", 1, batches)
    assert many == one
    last = {}
    for ckpt in batches:
        for b in ckpt:
            last.update(zip(b.column("id").to_pylist(),
                            b.column("v").to_pylist()))
    assert many == [{"id": k, "v": last[k]} for k in sorted(last)]


def test_packages_commit_equal_tables(tmp_path):
    batches = _batches(seed=4)
    assert _ingest(PORT, str(tmp_path), "t", 3, batches) == \
        _ingest(REF, str(tmp_path), "t", 3, batches)


def test_many_writers_under_fast_thread_switches(tmp_path):
    """8 writer threads with the interpreter switching threads every
    10 us: the committed table still equals a single writer's."""
    import sys
    batches = _batches(seed=5, checkpoints=2, per=8, n=300)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        many = _ingest(PORT, str(tmp_path), "many", 8, batches)
    finally:
        sys.setswitchinterval(interval)
    assert many == _ingest(PORT, str(tmp_path), "one", 1, batches)
