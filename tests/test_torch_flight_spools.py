"""Flight dumps, crash hooks, trace spools and their merge:
paimon_tpu_torch against paimon_tpu.

The same events recorded in both packages' flight recorders dump to JSON
documents with the same fields (a direct dump, the excepthook's and the
atexit hook's); a stream daemon loop that dies for good leaves the same
dump in both packages.  Spools written by both packages in one process
merge into the same Perfetto trace through either package's
`export_merged`, with a flow arrow between a span of one and its remote
parent in the other; the port's `fleet trace --merge` CLI writes it.
Only clock values (times, the dump's creation time) may differ.
"""

import json
import os
import sys
import time

import pytest

import paimon_tpu.obs.flight as RF
import paimon_tpu.obs.merge as RMerge
import paimon_tpu.obs.trace as RT
import paimon_tpu_torch.obs.flight as F
import paimon_tpu_torch.obs.merge as Merge
import paimon_tpu_torch.obs.trace as T
from paimon_tpu.service import stream_daemon as ref_daemon
from paimon_tpu_torch.cdc.source import MemoryCdcSource
from paimon_tpu_torch.service.stream_daemon import StreamDaemon
from tests.test_torch_stream_daemon import _both_tables, _wait

PACKAGES = ((F, T, Merge), (RF, RT, RMerge))


def _untimed(doc):
    """A dump without its clock values."""
    out = {k: v for k, v in doc.items() if k != "created_s"}
    out["events"] = [{k: v for k, v in e.items() if k != "t"}
                     for e in doc["events"]]
    return out


@pytest.fixture
def recorders(monkeypatch, tmp_path):
    """Fresh recorders in both packages, each dumping under its own
    directory; the crash hooks may be installed again (and their atexit
    handler is captured, not registered)."""
    import atexit
    hooks = []
    for name, (fl, _, _) in zip(("port", "reference"), PACKAGES):
        rec = fl.FlightRecorder(max_events=8)
        rec.dump_dir = str(tmp_path / f"dumps-{name}")
        monkeypatch.setattr(fl, "_recorder", rec)
        monkeypatch.setattr(fl, "_hooks_installed", False)
    # both modules register with the one atexit module, in install order
    monkeypatch.setattr(atexit, "register", hooks.append)
    monkeypatch.setattr(sys, "excepthook", lambda *a: None)
    return hooks


def _record_same(fl):
    fl.record(fl.EV_RETRY, op="write", attempt=1, path="data-1.parquet")
    fl.record(fl.EV_BROWNOUT, level=2)
    for i in range(9):                  # past the ring: one dropped
        fl.record(fl.EV_HTTP_429, tenant=f"t{i}")
    fl.record(fl.EV_LOOP_CRASH, loop="ingest", why="max_restarts",
              error="IOError: lost", restarts=3)


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_dump_equals_reference(recorders, tmp_path):
    docs = {}
    for name, (fl, _, _) in zip(("port", "reference"), PACKAGES):
        _record_same(fl)
        path = fl.dump(trigger={"kind": "manual"})
        assert path and os.path.basename(path).startswith("flight-")
        assert not os.path.exists(path + ".tmp")
        docs[name] = _read(path)
        # an explicit path and no dump dir
        assert fl.dump(path=str(tmp_path / f"{name}.json")) == \
            str(tmp_path / f"{name}.json")
        fl.recorder().dump_dir = None
        assert fl.dump() is None
    assert _untimed(docs["port"]) == _untimed(docs["reference"])
    assert docs["port"]["dropped"] == 4
    assert [e["seq"] for e in docs["port"]["events"]] == list(range(5, 13))


def test_crash_hooks_dump_equal_reference(recorders, tmp_path):
    docs = {}
    for fl, _, _ in PACKAGES:
        _record_same(fl)
        fl.install_crash_hooks()
        fl.install_crash_hooks()            # idempotent
    try:
        raise ValueError("boom")
    except ValueError as e:
        sys.excepthook(type(e), e, e.__traceback__)
    for name, (fl, _, _) in zip(("port", "reference"), PACKAGES):
        files = os.listdir(fl.self_dump_dir())
        assert len(files) == 1
        docs[name] = _read(os.path.join(fl.self_dump_dir(), files[0]))
    assert _untimed(docs["port"]) == _untimed(docs["reference"])
    assert docs["port"]["trigger"] == {"kind": "crash", "error": "ValueError",
                                       "message": "boom"}
    assert docs["port"]["events"][-1]["kind"] == "crash"
    # the atexit hook dumps too, with its own trigger (the port's hook
    # was installed first)
    assert len(recorders) == 2
    for at_exit, (fl, _, _) in zip(recorders, PACKAGES):
        time.sleep(0.002)                   # a new file name (ms clock)
        at_exit()
        files = sorted(os.listdir(fl.self_dump_dir()))
        assert len(files) == 2
        triggers = [_read(os.path.join(fl.self_dump_dir(), f))["trigger"]
                    for f in files]
        assert {"kind": "atexit"} in triggers


def test_dump_dir_option_installs_the_hooks(recorders, tmp_path):
    from paimon_tpu.options import CoreOptions as RefCoreOptions
    from paimon_tpu.options import Options as RefOptions
    from paimon_tpu_torch.options import CoreOptions, Options
    for fl, opts in ((F, CoreOptions(Options({
            "obs.flight.dump.dir": str(tmp_path / "p"),
            "obs.flight.events": "16"}))),
            (RF, RefCoreOptions(RefOptions({
                "obs.flight.dump.dir": str(tmp_path / "r"),
                "obs.flight.events": "16"})))):
        fl.sync_from_options(opts)
        assert fl._hooks_installed
        assert fl.recorder().max_events == 16
    assert F.self_dump_dir() == str(tmp_path / "p")


def test_terminal_loop_crash_dump_equals_reference(recorders, tmp_path):
    """A loop that dies for good (max-restarts 0 on a broken source)
    leaves one dump with its loop.crash event, in both packages."""
    class Broken:
        def poll(self, after, n):
            raise IOError("source connection lost")

        def backlog(self, after):
            return 0

    opts = {"stream.restart.max-restarts": "0",
            "stream.restart.backoff": "1"}
    port, ref = _both_tables(tmp_path, opts)
    docs = {}
    for name, table, cls, (fl, _, _) in (
            ("port", port, StreamDaemon, PACKAGES[0]),
            ("reference", ref, ref_daemon.StreamDaemon, PACKAGES[1])):
        d = cls(table, Broken(), compact=False, serve=False).start()
        assert _wait(lambda: d.status()["loops"]["ingest"]["failed"])
        status = d.stop()
        assert status["loops"]["ingest"]["failed"]
        files = os.listdir(fl.self_dump_dir())
        assert len(files) == 1
        docs[name] = _read(os.path.join(fl.self_dump_dir(), files[0]))
    assert _untimed(docs["port"]) == _untimed(docs["reference"])
    crash = docs["port"]["events"][-1]
    assert crash["kind"] == "loop.crash" and crash["loop"] == "ingest" \
        and crash["why"] == "max_restarts"


# -- spools and their merge ---------------------------------------------------

@pytest.fixture
def tracing(monkeypatch, tmp_path):
    spool = str(tmp_path / "spool")
    for tr in (T, RT):
        tr.disable_tracing()
        tr.collector().clear()
        tr.enable_tracing()
        monkeypatch.setattr(tr, "_export_dir", None)
        tr.set_export_dir(spool)
    yield spool
    for tr in (T, RT):
        tr.set_export_dir(None)
        tr.disable_tracing()
        tr.collector().clear()


def _spans(tr, remote=None):
    with tr.span("stream.checkpoint", cat="stream", offset=7):
        with tr.span("commit.cas", cat="commit", attempt=0):
            pass
    attrs = {"remote_parent": remote} if remote else {}
    with tr.span("serve.request", cat="serve", **attrs):
        pass


def _strip_clock(trace):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in trace["traceEvents"]]


def test_spools_merge_equal_through_either_package(tracing, tmp_path):
    _spans(RT)
    ref_sid = next(s.span_id for s in RT.collector().snapshot()
                   if s.name == "stream.checkpoint")
    _spans(T, remote=f"{RT.process_tag()}:{ref_sid}")
    paths = [tr.spool_flush() for tr in (T, RT)]
    assert len(set(paths)) == 2 and all(os.path.exists(p) for p in paths)
    # a second flush appends nothing new; a new span appends one line
    with open(paths[0]) as f:
        before = f.read().count("\n")
    T.spool_flush()
    with T.span("late", cat="t"):
        pass
    T.spool_flush()
    with open(paths[0]) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    assert len(lines) == before + 1
    heads = [json.loads(open(p).readline()) for p in paths]
    assert sorted(heads[0]) == sorted(heads[1])
    assert heads[0]["proc"] == T.process_tag()
    outs = {}
    for name, (_, _, mg) in zip(("port", "reference"), PACKAGES):
        out = str(tmp_path / f"merged-{name}.json")
        stats = mg.export_merged(tracing, out)
        outs[name] = (stats, _read(out))
    p_stats, p_trace = outs["port"]
    r_stats, r_trace = outs["reference"]
    assert {k: v for k, v in p_stats.items() if k != "out"} == \
        {k: v for k, v in r_stats.items() if k != "out"}
    assert p_trace == r_trace
    assert p_stats["processes"] == 2 and p_stats["flows"] == 1 and \
        p_stats["unresolved"] == 0
    assert any(e.get("ph") == "f" for e in p_trace["traceEvents"])
    # the merge of the port's reading equals the reference's parse
    assert Merge.read_spools(tracing) == RMerge.read_spools(tracing)
    assert _strip_clock(p_trace)


def test_fleet_trace_cli_merges_spools(tracing, tmp_path, capsys):
    from paimon_tpu_torch.cli import main
    _spans(T)
    _spans(RT)
    T.spool_flush()
    RT.spool_flush()
    out = str(tmp_path / "fleet.json")
    assert main(["fleet", "trace", "--merge", tracing, "--out", out]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["processes"] == 2 and stats["spans"] == 6
    assert _read(out)["traceEvents"]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["fleet", "trace", "--merge", str(empty),
                 "--out", out]) == 1


def test_daemon_kill_flushes_its_spool(tracing, tmp_path):
    port, _ = _both_tables(tmp_path, {"stream.checkpoint.interval": "10",
                                      "stream.ingest.poll-interval": "5"})
    src = MemoryCdcSource([{"op": "c", "after": {"id": i, "v": i}}
                           for i in range(20)])
    d = StreamDaemon(port, src, compact=False, serve=False).start()
    assert _wait(lambda: d.status()["offset_committed"] == 19)
    d.kill()
    procs = Merge.read_spools(tracing)
    names = {s["name"] for p in procs for s in p["spans"]}
    assert {"stream.ingest.batch", "stream.checkpoint"} <= names
