"""parallel/distributed.py of paimon_tpu_torch against paimon_tpu's.

1. The fake-topology cases of tests/test_distributed_write.py (planes
   with explicit process_index/count over one table in one process) run
   on both packages through `run_reference_case`.
2. `owner_of`, `OwnershipMap` and `GenerationHistory` equal the
   reference's over seeded inputs, partitions of every value type a
   partition holds included, as numpy and torch scalars too.
3. A single-process plane of each package on the same seeded batches
   gives row-identical tables with equal snapshot properties, and each
   package resumes the other's ownership stamps and generation history.
4. The reference's real 2-process workers (CAS arbitration with
   'exchange' routing, coordinator arbitration with 'spmd' routing and a
   rescale under traffic) run on the port over a gloo group (`port_worker`
   rewrites their prolog), and the table each leaves is equal to the
   single-process oracle and fsck-clean in both packages.
"""

import datetime
import decimal
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import paimon_tpu.parallel.distributed as RD
import paimon_tpu_torch.parallel.distributed as PD
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu_torch.table import FileStoreTable
from tests.test_torch_append import (
    _cpu_table, reference_cases, run_reference_case,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = reference_cases("test_distributed_write", classes=True,
                        skip=("test_distributed_cas_two_process",
                              "test_distributed_coordinator_and_rescale"
                              "_two_process",
                              "test_distributed_soak_four_process_kill_mid"
                              "_commit"))


def test_reference_cases_are_all_here():
    assert len(CASES) + 3 == 20


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c[1] for c in CASES])
def test_reference_case(case, pkg, tmp_path, monkeypatch):
    run_reference_case(case, pkg, tmp_path, monkeypatch)


# -- ownership equal to the reference's ---------------------------------------

def _partitions(rng, n: int = 40):
    """(python partition, the same values as numpy/torch scalars)."""
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 2**40))
        day = datetime.date(2024, 1, 1) + datetime.timedelta(
            days=int(rng.integers(0, 400)))
        py = (f"p{k % 97}", k, day, bool(k & 1), float(k) / 7,
              decimal.Decimal(k % 1000) / 100, None, b"\x00\xff",
              datetime.datetime(2024, 5, 1, 12, int(k % 60)))
        scalars = (np.str_(py[0]), np.int64(k), py[2], np.bool_(py[3]),
                   np.float64(py[4]), py[5], None, py[7],
                   np.datetime64(py[8], "us"))
        out.append((py, scalars))
        out.append(((k % 13,), (torch.tensor(k % 13),)))
        out.append(((int(k % 5), "x"), (np.int32(k % 5), np.str_("x"))))
    return out


@pytest.mark.parametrize("count", [1, 2, 3, 4, 7])
def test_owner_of_equals_the_reference(count):
    rng = np.random.default_rng(7 + count)
    for py, scalars in _partitions(rng):
        for bucket in (0, 1, 5, 63, int(rng.integers(0, 1 << 20))):
            for dead in (frozenset(), frozenset({count - 1}),
                         frozenset(range(1, count))):
                if count > 1 and len(dead) == count:
                    continue
                want = RD.owner_of(py, bucket, count, dead)
                assert PD.owner_of(py, bucket, count, dead) == want
                # numpy and torch scalars own like their Python values
                assert PD.owner_of(scalars, np.int64(bucket), count,
                                   dead) == want, (scalars, bucket)


def test_ownership_maps_and_history_equal_the_reference():
    rng = np.random.default_rng(11)
    ref_m, port_m = RD.OwnershipMap(1, 4, 16), PD.OwnershipMap(1, 4, 16)
    ref_h = RD.GenerationHistory.initial(ref_m)
    port_h = PD.GenerationHistory.initial(port_m)
    for step in range(12):
        p = int(rng.integers(0, 4))
        if p in ref_m.dead:
            ref_m, port_m = ref_m.without_dead({p}), \
                port_m.without_dead({p})
        elif len(ref_m.dead) < 3:
            ref_m, port_m = ref_m.with_dead({p}), port_m.with_dead({p})
        ref_h, port_h = ref_h.with_map(ref_m), port_h.with_map(port_m)
        assert port_m.to_properties() == ref_m.to_properties()
        assert port_h.to_properties() == ref_h.to_properties()
        assert port_m.alive() == ref_m.alive()
        assert port_m.owned_groups(p, [(), ("a",)]) == \
            ref_m.owned_groups(p, [(), ("a",)])
        for j in range(4):
            rg, pg = ref_h.map_governing(j), port_h.map_governing(j)
            assert (rg is None) == (pg is None)
            if rg is not None:
                assert pg.to_properties() == rg.to_properties()
        wider = PD.OwnershipMap(port_m.version + 1, 4, 32)
        assert port_m.handoffs_to(wider) == ref_m.handoffs_to(
            RD.OwnershipMap(ref_m.version + 1, 4, 32))
    parsed = PD.GenerationHistory.from_property(ref_h.to_property())
    assert parsed.to_property() == ref_h.to_property()
    assert PD.lease_props(1, 500, {0: 100, 3: 900}) == \
        RD.lease_props(1, 500, {0: 100, 3: 900})
    assert PD.rejoin_request_props(2, 7) == RD.rejoin_request_props(2, 7)
    assert PD.rejoin_floor_props(0, 2, 5, 99) == \
        RD.rejoin_floor_props(0, 2, 5, 99)


# -- one process of each package on the same batches -------------------------

def _schema(pkg, buckets=4):
    if pkg == "port":
        from paimon_tpu_torch.schema import Schema
        from paimon_tpu_torch.types import BigIntType, DoubleType
    else:
        from paimon_tpu.schema import Schema
        from paimon_tpu.types import BigIntType, DoubleType
    return (Schema.builder().column("id", BigIntType(False))
            .column("v", DoubleType()).primary_key("id")
            .options({"bucket": str(buckets)}).build())


def _batches(seed: int = 7, n: int = 3, rows: int = 400):
    rng = np.random.default_rng(seed)
    return [pa.table({"id": pa.array(rng.integers(0, 500, rows), pa.int64()),
                      "v": pa.array(rng.random(rows))}) for _ in range(n)]


def _plane_run(pkg, path, batches):
    cls = _cpu_table(FileStoreTable) if pkg == "port" else RefTable
    t = cls.create(path, _schema(pkg))
    plane = t.new_distributed_write(process_index=0, process_count=1)
    for i, b in enumerate(batches):
        plane.write_arrow(b)
        plane.commit(commit_identifier=i + 1)
    plane.rescale_buckets(8)
    plane.write_arrow(batches[0].slice(0, 50))
    plane.commit(commit_identifier=len(batches) + 1)
    plane.close()
    t = cls.load(path)
    props = [dict(s.properties or {}) for s in
             t.snapshot_manager.snapshots()]
    return t, t.to_arrow().sort_by("id"), props


def test_single_process_planes_agree(tmp_path):
    batches = _batches()
    port, got, got_props = _plane_run("port", str(tmp_path / "p"),
                                      batches)
    ref, want, want_props = _plane_run("reference", str(tmp_path / "r"),
                                       batches)
    assert got.equals(want)
    assert got_props == want_props
    assert got_props[-1]["multihost.ownership.version"] == "2"
    # each package resumes the other's stamps and generation history
    for mine, other, pkg in ((PD, ref, "reference"), (RD, port, "port")):
        m = mine.resume_ownership_map(other)
        h = mine.resume_generation_history(other)
        assert (m.version, m.num_processes, m.num_buckets) == (2, 1, 8)
        assert [e.version for e in h.entries] == [1, 2], pkg
    assert port.fsck().ok and ref.fsck().ok


# -- the reference's real 2-process workers on the port ----------------------

_CPU_SHIM = '''
import paimon_tpu_torch.table as _port_tables
_PortBase = _port_tables.FileStoreTable


class _CpuTable(_PortBase):
    """The port's FileStoreTable, opened on the CPU unless asked."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)

    @staticmethod
    def create(path, schema, file_io=None, device="cpu"):
        return _PortBase.create(path, schema, file_io=file_io,
                                device=device)

    @staticmethod
    def load(path, file_io=None, dynamic_options=None, device="cpu"):
        return _PortBase.load(path, file_io=file_io,
                              dynamic_options=dynamic_options,
                              device=device)


_port_tables.FileStoreTable = _CpuTable
'''


def port_worker(src: str) -> str:
    """A reference worker script pointed at the port: its jax set-up
    dropped, `paimon_tpu` imports renamed, the port's FileStoreTable on
    the CPU (inserted after the repository reaches sys.path), a 120 s
    group timeout, and an os._exit(0) at its end so that no teardown of
    the gloo group can outlive the run."""
    lines = [ln for ln in src.splitlines()
             if not re.search(r"JAX_PLATFORMS|XLA_FLAGS|^import jax|"
                              r"jax\.config", ln)]
    out = "\n".join(lines)
    out = out.replace("paimon_tpu.", "paimon_tpu_torch.") \
        .replace("from paimon_tpu import", "from paimon_tpu_torch import")
    out = re.sub(r"MH\.initialize\(([^)]*)\)",
                 r"MH.initialize(\1, timeout_s=120)", out)
    first = re.search(r"^sys\.path\.insert\(0, [^\n]*\n", out, re.M)
    out = out[:first.end()] + _CPU_SHIM + out[first.end():]
    return out + "\nsys.stdout.flush()\nos._exit(0)\n"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_port_workers(src, tmp_path, n_procs, args=(), expected_rc=None,
                     timeout=240):
    """The reference's `_run_workers` for a port worker: argv pid, port,
    table path, repo, n, args; every process exits with its expected code
    within `timeout`, or all are killed and the test fails."""
    port = _free_port()
    table_path = str(tmp_path / "t")
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(src)
    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(pid), str(port), table_path,
         REPO, str(n_procs), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n_procs)]
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
        want = (expected_rc or {}).get(pid, 0)
        assert p.returncode == want, \
            f"proc {pid} rc={p.returncode} (want {want}):\n{out[-6000:]}"
    return table_path, outs


def _check_both(table_path, oracle_rows, buckets):
    """The port's table equals the single-process oracle (each package
    reading it) and is fsck-clean in both packages."""
    oracle = RefTable.create(table_path + "-oracle",
                             _schema("reference", buckets))
    wb = oracle.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_dicts(oracle_rows)
        wb.new_commit().commit(w.prepare_commit())
    want = oracle.to_arrow().sort_by("id")
    for t in (FileStoreTable.load(table_path, device="cpu"),
              RefTable.load(table_path)):
        got = t.to_arrow().sort_by("id")
        assert got.column("id").equals(want.column("id"))
        assert got.column("v").cast(pa.float64()).equals(
            want.column("v"))
        report = t.fsck()
        assert report.ok, [v.to_dict() for v in report.violations]


def test_distributed_cas_two_process_on_port(tmp_path):
    from tests.test_distributed_write import _CAS_WORKER
    table_path, outs = run_port_workers(port_worker(_CAS_WORKER),
                                        tmp_path, 2)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: DIST-CAS-OK" in out, out[-2000:]
    _check_both(table_path, [{"id": i, "v": i % 2} for i in range(800)], 4)
    t = FileStoreTable.load(table_path, device="cpu")
    users = {s.commit_user for s in t.snapshot_manager.snapshots()}
    assert users == {"writer-p0", "writer-p1"}


def test_distributed_coordinator_and_rescale_two_process_on_port(tmp_path):
    from tests.test_distributed_write import _COORD_WORKER
    table_path, outs = run_port_workers(port_worker(_COORD_WORKER),
                                        tmp_path, 2)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: DIST-COORD-OK" in out, out[-2000:]
    _check_both(table_path, [{"id": (k - 1) * 300 + i, "v": k}
                             for k in (1, 2, 3, 4) for i in range(300)], 8)
    sm = FileStoreTable.load(table_path, device="cpu").snapshot_manager
    users = [sm.snapshot(s).commit_user
             for s in range(1, sm.latest_snapshot_id() + 1)]
    assert sm.latest_snapshot_id() == 5, users
    assert users.count("writer-committer") == 4
