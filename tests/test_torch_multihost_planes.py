"""The multi-host planes of paimon_tpu_torch over real gloo processes.

The port's versions of the reference's real-process soaks: each runs the
reference's own worker script on the port (`port_worker`: the jax set-up
dropped, the imports renamed, tables on the CPU, a 120 s group timeout,
os._exit at the end) and audits what it leaves with the reference's own
audit, which reads the port's table through paimon_tpu, then with the
port's fsck:

- the 2-process host kill (tests/test_multihost_maintenance.py
  `test_multihost_soak_host_kill_two_process`, 1,080 events): the
  victim is SIGKILLed by itself (os._exit) at a third of the stream and
  the survivor adopts its buckets;
- the 3-process kill-two-then-rejoin (`test_multihost_soak_kill_two_
  then_rejoin`, 1,080 events): two victims die, the survivor adopts
  both, both restart as store-only rejoiners (no group bring-up: the
  rendezvous store lived in process 0) and are readmitted;
- the 2-process distributed rescale
  (`test_distributed_rescale_two_process_owned_buckets_only`);
- the gloo fleet-trace merge (tests/test_fleet_obs.py
  `test_fleet_trace_merge_gloo_maintenance_soak`): both workers' spools
  and the parent's merged by the port's obs/merge.py.

Each process has a bound of its own on its run and its exit.
"""

import os
import subprocess
import sys
import time

import pytest

from paimon_tpu_torch.table import FileStoreTable
from tests.test_torch_distributed_write import (
    REPO, _free_port, port_worker, run_port_workers,
)


def _port_fsck_clean(table_path):
    report = FileStoreTable.load(table_path, device="cpu").fsck()
    assert report.ok, [v.to_dict() for v in report.violations]


def test_multihost_soak_host_kill_two_process_on_port(tmp_path):
    from tests.test_multihost_maintenance import (
        _PROLOG, _SOAK_WORKER, _audit_soak,
    )
    assert _SOAK_WORKER.startswith(_PROLOG)
    n_total = 1080
    table_path, outs = run_port_workers(
        port_worker(_SOAK_WORKER), tmp_path, 2,
        args=[n_total, n_total // 3, 0], expected_rc={1: 42}, timeout=240)
    _audit_soak(table_path, outs, n_total)
    _port_fsck_clean(table_path)


def test_multihost_soak_kill_two_then_rejoin_on_port(tmp_path):
    """Three gloo processes; process 2 dies abruptly, process 1 at the
    snapshot CAS under an injected IO storm; the survivor adopts both
    (cascading, from the generation history); both come back as
    store-only rejoiners and are readmitted; the reference's audit holds
    the table to the oracle, offsets, rejoins and the history."""
    from tests.test_multihost_maintenance import (
        _REJOIN_SOAK_WORKER, _REJOIN_WORKER, _audit_rejoin_soak,
    )
    n_total, kill, kill2, timeout = 1080, 360, 480, 240
    port = _free_port()
    table_path = str(tmp_path / "t")
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(port_worker(_REJOIN_SOAK_WORKER))
    rejoin_py = tmp_path / "rejoin.py"
    rejoin_py.write_text(port_worker(_REJOIN_WORKER))

    def spawn(py, pid, extra):
        return subprocess.Popen(
            [sys.executable, str(py), str(pid), str(port), table_path,
             REPO, "3", *map(str, extra)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = {p: spawn(worker_py, p, [n_total, kill, kill2, 0])
             for p in range(3)}
    rejoiners = {}
    outs = {}
    try:
        for p in (2, 1):            # the victims die first, in order
            outs[p] = procs[p].communicate(timeout=timeout)[0]
            assert procs[p].returncode == 42, \
                f"victim {p} rc={procs[p].returncode}:\n{outs[p][-6000:]}"
        deadline = time.monotonic() + timeout
        while not os.path.exists(table_path + ".adopted-all"):
            assert procs[0].poll() is None, \
                procs[0].communicate()[0][-6000:]
            assert time.monotonic() < deadline, \
                "the survivor never adopted both victims"
            time.sleep(0.05)
        mid = FileStoreTable.load(table_path, device="cpu").fsck()
        assert mid.ok, [v.to_dict() for v in mid.violations]
        rejoiners = {p: spawn(rejoin_py, p, [n_total]) for p in (1, 2)}
        for p in (1, 2):
            out = rejoiners[p].communicate(timeout=timeout)[0]
            outs[f"rejoin{p}"] = out
            assert rejoiners[p].returncode == 0, \
                f"rejoiner {p}:\n{out[-6000:]}"
        outs[0] = procs[0].communicate(timeout=timeout)[0]
        assert procs[0].returncode == 0, outs[0][-6000:]
    finally:
        for pr in (*procs.values(), *rejoiners.values()):
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    _audit_rejoin_soak(table_path, outs, n_total)
    _port_fsck_clean(table_path)


def test_distributed_rescale_two_process_owned_buckets_only_on_port(
        tmp_path):
    from paimon_tpu.schema import Schema
    from paimon_tpu.table import FileStoreTable as RefTable
    from paimon_tpu.types import BigIntType
    from tests.test_multihost_maintenance import _RESCALE_WORKER

    table_path, outs = run_port_workers(port_worker(_RESCALE_WORKER),
                                        tmp_path, 2)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: MH-RESCALE-OK" in out, out[-4000:]
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", BigIntType()).primary_key("id")
              .options({"bucket": "8"}).build())
    oracle = RefTable.create(str(tmp_path / "oracle"), schema)
    wb = oracle.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_dicts([{"id": i, "v": i} for i in range(600)]
                      + [{"id": 1000 + i, "v": 1} for i in range(100)])
        wb.new_commit().commit(w.prepare_commit())
    want = oracle.to_arrow().sort_by("id")
    for t in (RefTable.load(table_path),
              FileStoreTable.load(table_path, device="cpu")):
        assert t.options.bucket == 8
        assert t.to_arrow().sort_by("id").equals(want)
        report = t.fsck()
        assert report.ok, [v.to_dict() for v in report.violations]


@pytest.fixture
def port_obs_reset():
    from paimon_tpu_torch.obs import flight
    from paimon_tpu_torch.obs.trace import (
        disable_tracing, reset_spool, set_export_dir, take_spans,
    )
    yield
    disable_tracing()
    set_export_dir(None)
    take_spans(clear=True)
    reset_spool()
    flight.recorder().clear()


def test_fleet_trace_merge_gloo_maintenance_soak_on_port(tmp_path,
                                                         port_obs_reset):
    """Two port daemon processes and the auditing parent in ONE merged
    Perfetto file (the port's obs/merge.py), tied by store-carried
    trace.context arrows across both worker boundaries, the survivor's
    takeover on its track."""
    from paimon_tpu_torch.obs.merge import export_merged
    from paimon_tpu_torch.obs.trace import (
        disable_tracing, enable_tracing, set_export_dir, spool_flush,
    )
    from tests.test_fleet_obs import _OBS_SOAK_WORKER, _load_merged, \
        _os_pid_of

    spool = tmp_path / "spool"
    spool.mkdir()
    table_path, outs = run_port_workers(
        port_worker(_OBS_SOAK_WORKER), tmp_path, 2,
        args=[300, 120, str(spool)], expected_rc={1: 42}, timeout=240)
    assert "OBS-SOAK-OK" in outs[0], outs[0][-6000:]
    final = FileStoreTable.load(table_path, device="cpu")
    by_tag = {}
    for snap in final.snapshot_manager.snapshots():
        ctx = (snap.properties or {}).get("trace.context")
        if ctx:
            by_tag.setdefault(ctx.rsplit(":", 1)[0], []).append(snap)
    assert len(by_tag) >= 2, list(by_tag)
    enable_tracing()
    set_export_dir(str(spool))
    scan = final.new_read_builder().new_scan()
    for _tag, snaps in sorted(by_tag.items()):
        scan.plan(snapshot_id=min(s.id for s in snaps))
    spool_flush()
    disable_tracing()
    out = str(tmp_path / "fleet-trace.json")
    stats = export_merged(str(spool), out)
    assert stats["processes"] == 3 and stats["flows"] >= 2, stats
    procs, spans, flows = _load_merged(out)
    me = [p for p, o in _os_pid_of(procs).items() if o == os.getpid()]
    assert len(me) == 1, procs
    workers = set(procs) - set(me)
    assert workers <= {s["pid"] for s in spans}
    assert workers <= {s_ev["pid"] for s_ev, f_ev in flows
                       if f_ev["pid"] == me[0] and s_ev["name"] == "link"}
    names = {}
    for s in spans:
        names.setdefault(s["pid"], set()).add(s["name"])
    assert any("stream.checkpoint" in names[p] for p in workers), names
    assert any("stream.takeover" in names.get(p, set())
               for p in workers), names


def test_consumer_position_survives_a_death_mid_write(tmp_path,
                                                      monkeypatch):
    """A reference fault the port does not share (ROADMAP.md C): the
    reference's LocalFileIO overwrites a file in place, so a host killed
    between the truncation and the write leaves its consumer position
    empty, and the survivor's serve catch-up then raises
    JSONDecodeError at every restart (the failure of the reference's
    2-process host-kill soak).  The port writes a hidden temporary file
    and renames it over the old one: a death before the rename leaves
    the old position."""
    import json

    import paimon_tpu.fs.fileio as ref_fileio
    import paimon_tpu_torch.fs.fileio as port_fileio
    from paimon_tpu.snapshot.consumer_manager import (
        ConsumerManager as RefConsumers,
    )
    from paimon_tpu_torch.snapshot.consumer_manager import ConsumerManager

    class Death(Exception):
        pass

    def die(*args, **kwargs):
        raise Death()

    port = ConsumerManager(port_fileio.LocalFileIO(), str(tmp_path / "p"))
    port.record_consumer("stream-daemon-p1-serve", 5)
    with monkeypatch.context() as m:
        m.setattr(port_fileio.os, "replace", die)
        with pytest.raises(Death):
            port.record_consumer("stream-daemon-p1-serve", 9)
    assert port.consumer("stream-daemon-p1-serve") == 5
    assert port.consumers() == {"stream-daemon-p1-serve": 5}
    port.record_consumer("stream-daemon-p1-serve", 9)
    assert port.consumer("stream-daemon-p1-serve") == 9

    ref = RefConsumers(ref_fileio.LocalFileIO(), str(tmp_path / "r"))
    ref.record_consumer("stream-daemon-p1-serve", 5)
    real_open = open

    def open_then_die(path, mode="r", *args, **kwargs):
        f = real_open(path, mode, *args, **kwargs)   # "wb" truncates
        if "w" in mode:
            f.close()
            raise Death()
        return f

    with monkeypatch.context() as m:
        m.setattr(ref_fileio, "open", open_then_die, raising=False)
        with pytest.raises(Death):
            ref.record_consumer("stream-daemon-p1-serve", 9)
    with pytest.raises(json.JSONDecodeError):
        ref.consumer("stream-daemon-p1-serve")
