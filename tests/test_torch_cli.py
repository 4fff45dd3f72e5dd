"""The `paimon` CLI of paimon_tpu_torch against paimon_tpu.

The cases of tests/test_cli.py run on both packages through
tests/test_torch_append.py's `run_reference_case`: the port's `main`
with `--device cpu` in front of every command line.  `python -m
paimon_tpu_torch` runs as a subprocess: with `--device cpu` it answers
as the reference's CLI does on the same warehouse, and without it, on
a machine with no card, it fails naming CUDA and touches nothing.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from paimon_tpu.cli import main as ref_main
from paimon_tpu_torch.cli import main as port_main
from tests.test_torch_append import reference_cases, run_reference_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = reference_cases("test_cli", classes=True)


def test_reference_cases_are_all_listed():
    assert len(CASES) == 9


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[c for _, c in CASES])
def test_reference_case(tmp_path, monkeypatch, request, case, pkg):
    run_reference_case(case, pkg, tmp_path, monkeypatch, request)


def _cli(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "paimon_tpu_torch", *argv],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=240)


def _bootstrap(wh):
    """d1.t with a few rows, written by the reference's CLI."""
    assert ref_main(["-w", wh, "db", "create", "d1"]) == 0
    assert ref_main(["-w", wh, "table", "create", "d1.t",
                     "--column", "id:BIGINT NOT NULL", "--column", "v:DOUBLE",
                     "--primary-key", "id", "--option", "bucket=2"]) == 0
    assert ref_main(["-w", wh, "sql", "INSERT INTO d1.t VALUES "
                     "(1, 1.5), (2, 2.5), (7, -1.0)"]) == 0


def test_module_entry_point_answers_on_the_cpu(tmp_path, capsys):
    wh = str(tmp_path / "wh")
    _bootstrap(wh)
    capsys.readouterr()
    for argv in (["sql", "SELECT count(*) AS n, sum(v) AS s FROM d1.t"],
                 ["table", "read", "d1.t"]):
        got = _cli("--device", "cpu", "-f", "json", "-w", wh, *argv)
        assert got.returncode == 0, got.stderr
        assert ref_main(["-f", "json", "-w", wh, *argv]) == 0
        want = capsys.readouterr().out
        assert sorted(got.stdout.splitlines()) == \
            sorted(want.splitlines())
    assert json.loads(_cli("--device", "cpu", "-f", "json", "-w", wh, "sql",
                           "SELECT count(*) AS n FROM d1.t").stdout) == \
        {"n": 3}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine with no card")
def test_module_entry_point_without_device_needs_the_card(tmp_path):
    """No --device means the card: without one the CLI fails naming
    CUDA and creates no warehouse (no fallback to the CPU)."""
    wh = str(tmp_path / "wh")
    got = _cli("-w", wh, "db", "create", "d1")
    assert got.returncode == 1
    assert "CUDA is not available" in got.stderr
    assert not os.path.exists(wh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from paimon_tpu_torch.cli import _load_catalog, build_parser
        _load_catalog(build_parser().parse_args(["-w", wh, "db", "list"]))


def test_lint_matches_the_reference(tmp_path, capsys):
    """`lint` (it raised naming A.8.9) prints the reference's lines and
    JSON report, and exits as it does, on one fixture package: a
    finding, a reviewed suppression, a reasonless and a stale marker.
    It opens no catalog and no device, so it runs without --device."""
    pkg = tmp_path / "fixturepkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "util.py").write_text(
        "import time\n\n\n"
        "def nap():\n    time.sleep(1)\n\n\n"
        "def reviewed():\n    time.sleep(2)  # lint-ok: sleeps fixture\n\n\n"
        "def reasonless(q):\n    return q.get()  # lint-ok: deadline-wait\n"
        "\n\ndef stale():\n    return 1  # lint-ok: swallow nothing here\n")
    outs = {}
    for argv in (["lint"], ["lint", "--show-suppressed"],
                 ["lint", "--json"], ["lint", "--rule", "threads"],
                 ["lint", "--json", "--rule", "sleeps",
                  "--rule", "stale-suppression"]):
        runs = [(main([*argv, "--package-dir", str(pkg)]),
                 capsys.readouterr().out) for main in (port_main, ref_main)]
        assert runs[0] == runs[1], argv
        # the reasonless marker is a finding whatever rules run
        assert runs[0][0] == 1
        outs[" ".join(argv)] = runs[0][1]
    report = json.loads(outs["lint --json"])
    assert sorted((f["rule"], f["line"], f["suppressed"])
                  for f in report["findings"]) == [
        ("bad-suppression", 13, False), ("deadline-wait", 13, False),
        ("sleeps", 5, False), ("sleeps", 9, True),
        ("stale-suppression", 17, False)]
    got = _cli("lint", "--json", "--package-dir", str(pkg))
    assert got.returncode == 1, got.stderr
    assert port_main(["lint", "--json", "--package-dir", str(pkg)]) == 1
    assert got.stdout == capsys.readouterr().out


def test_fleet_status_matches_the_reference(tmp_path, capsys):
    """`fleet status` (it raised naming A.8.9) prints the reference's
    view of a table two plane daemons stamped: generations, dead and
    adopted sets, floors, rejoin requests and bucket shares (lease ages
    are ages now, so only their presence is compared)."""
    from paimon_tpu.parallel.distributed import (
        GenerationHistory, OwnershipMap, lease_props, rejoin_request_props,
    )
    from paimon_tpu.table import FileStoreTable as RefTable
    from paimon_tpu.core.commit import FileStoreCommit

    wh = str(tmp_path / "wh")
    _bootstrap(wh)
    t = RefTable.load(os.path.join(wh, "d1.db", "t"))
    m1 = OwnershipMap(1, 3, 2)
    hist = GenerationHistory.initial(m1).with_map(m1.with_dead({2}))
    stamps = [("stream-daemon-p0", {**hist.to_properties(),
                                    **lease_props(0, 10_000, {1: 9_000}),
                                    "stream.adopted": "2",
                                    "stream.floor.p2": "17"}),
              ("stream-daemon-p2", {**hist.to_properties(),
                                    **rejoin_request_props(2, 11_000)})]
    for user, props in stamps:
        FileStoreCommit(t.file_io, t.path, t.schema, t.options,
                        commit_user=user).commit(
            [], properties=props, force_create=True)
    capsys.readouterr()
    outs = []
    for main, device in ((port_main, ["--device", "cpu"]), (ref_main, [])):
        assert main([*device, "-w", wh, "fleet", "status", "d1.t"]) == 0
        out = json.loads(capsys.readouterr().out)
        for host in out["hosts"].values():
            host["lease_age_ms"] = host["lease_age_ms"] is not None
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0]["dead"] == [2] and outs[0]["rejoining"] == [2]
    assert outs[0]["hosts"]["0"]["floors"] == {"2": 17}


def test_trace_option_writes_a_chrome_trace(tmp_path, capsys):
    wh = str(tmp_path / "wh")
    _bootstrap(wh)
    out = str(tmp_path / "read.json")
    assert port_main(["--device", "cpu", "-w", wh, "table", "read", "d1.t",
                      "--trace", out]) == 0
    assert "trace written" in capsys.readouterr().err
    with open(out) as f:
        events = json.load(f)
    names = {e.get("name") for e in
             (events["traceEvents"] if isinstance(events, dict) else events)}
    assert "scan.split" in names or "io.read" in names


# every other sub-command: the same command lines on a warehouse of each
# package exit alike; those whose output carries no time, file name or
# process state print alike
COMMANDS = [
    (["table", "snapshots", "d1.t"], False),
    (["table", "set-option", "d1.t", "snapshot.num-retained.min", "1"], True),
    (["table", "remove-option", "d1.t", "snapshot.num-retained.min"], True),
    (["table", "compact", "d1.t"], True),
    (["table", "compact-manifests", "d1.t"], False),
    (["table", "expire-snapshots", "d1.t", "--retain-max", "2"], False),
    (["table", "fsck", "d1.t", "--deep"], False),
    (["table", "metrics", "d1.t", "--group", "scan"], False),
    (["tag", "create", "d1.t", "t1"], True),
    (["branch", "create", "d1.t", "b1", "--tag", "t1"], True),
    (["branch", "fast-forward", "d1.t", "b1"], True),
    (["branch", "delete", "d1.t", "b1"], True),
    (["table", "rename", "d1.t", "d1.u"], True),
    (["table", "read", "d1.u", "--columns", "v", "--limit", "2"], True),
    (["table", "drop", "d1.u"], True),
    (["db", "drop", "d1", "--cascade"], True),
    (["db", "list"], True)]


def test_other_sub_commands_match_the_reference(tmp_path, capsys):
    whs = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    for wh in whs.values():
        _bootstrap(wh)
    capsys.readouterr()
    for argv, same_output in COMMANDS:
        got = {}
        for pkg, wh in whs.items():
            main = port_main if pkg == "port" else ref_main
            device = ["--device", "cpu"] if pkg == "port" else []
            rc = main([*device, "-f", "json", "-w", wh, *argv])
            got[pkg] = (rc, capsys.readouterr().out)
        assert got["port"][0] == got["ref"][0] == 0, (argv, got)
        if same_output:
            assert got["port"][1] == got["ref"][1], argv
