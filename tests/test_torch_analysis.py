"""paimon_tpu_torch's whole-program analysis plane against paimon_tpu's.

The fixture cases of tests/test_analysis.py run on both engines, as
written for the reference (`[ref]`) and with their `paimon_tpu.`
imports pointed at the port (`[port]`); in a `[port]` case every
fixture package is also linted by the reference's engine, and the two
reports must agree finding for finding (rule, file, line, message,
suppression and its reason).  The three rules that name jax spellings
in the reference (collectives, distributed-init, host-materialization)
name their torch counterparts in the port: a jax fixture for the
reference and the same sites spelled for torch for the port must give
findings at the same (rule, file, line).

The production cases run on the port's own tree, and the two engines
are held against each other over both real trees for the ten rules
spelled alike in both: the port's engine over paimon_tpu/ (parsed as
files, never imported) must give the reference's report on its own
tree, and the reference's engine over paimon_tpu_torch/ must find
nothing unsuppressed.
"""

import os
import textwrap
import types

import pytest

import paimon_tpu.analysis as ref_analysis
import paimon_tpu_torch.analysis as port_analysis
from tests.test_torch_append import reference_cases

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the reference's production-tree cases: run below on the port's tree
PRODUCTION = ("test_production_tree_zero_unsuppressed_findings",
              "test_production_rule_catalog_is_complete",
              "test_production_suppressions_all_carry_reasons",
              "test_fixed_violations_stay_fixed")
CASES = [c for _, c in reference_cases("test_analysis")
         if c not in PRODUCTION]

RULES = ("swallow", "threads", "sleeps", "sockets", "collectives",
         "distributed-init", "host-materialization", "metric-drift",
         "obs-drift", "options-drift", "lock-order", "loop-blocking",
         "deadline-wait", "fault-taxonomy", "ownership-history")
META = ("bad-suppression", "stale-suppression")
# spelled alike in both packages and not gated on the package's name
SHARED = ("swallow", "threads", "sleeps", "sockets", "obs-drift",
          "lock-order", "loop-blocking", "deadline-wait", "fault-taxonomy",
          "ownership-history")


def keys(report, rules=None):
    return sorted((f.rule, f.file, f.line, f.message, f.suppressed,
                   f.suppress_reason) for f in report.findings
                  if rules is None or f.rule in rules)


def _run_both(package_dir, rule_ids=None, repo_root=None):
    """The port's report on a fixture package, after holding it against
    the reference's on the same files."""
    port = port_analysis.run_package(package_dir, rule_ids, repo_root)
    ref = ref_analysis.run_package(package_dir, rule_ids, repo_root)
    assert keys(port) == keys(ref)
    return port


def analysis_module(port: bool):
    """tests/test_analysis.py, as written or against the port (with the
    fixture reports held against the reference's)."""
    path = os.path.join(HERE, "test_analysis.py")
    with open(path) as f:
        src = f.read()
    if port:
        src = src.replace("paimon_tpu.", "paimon_tpu_torch.")
    mod = types.ModuleType(f"test_analysis_{'port' if port else 'ref'}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    if port:
        mod.run_package = _run_both
    return mod


def test_reference_cases_are_all_listed():
    assert len(CASES) + len(PRODUCTION) == 40


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("case", CASES)
def test_fixture_case(case, pkg, tmp_path, request):
    fn = getattr(analysis_module(pkg == "port"), case)
    args = {"tmp_path": tmp_path}
    fn(**{p: args[p] if p in args else request.getfixturevalue(p)
          for p in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


# -- the three rules spelled for torch ---------------------------------------

# each pair puts its flagged sites on the same lines
TRANSLATED = {
    "collectives": ({"sync.py": """
        from jax.experimental.multihost_utils import sync_global_devices
        from jax.experimental import multihost_utils


        def sync():
            sync_global_devices("x")


        def share(v):
            return multihost_utils.broadcast_one_to_all(v)


        def gather(v):
            return multihost_utils.process_allgather(v)


        def local(x):
            return x
    """, "parallel/multihost.py": """
        from jax.experimental import multihost_utils


        def barrier():
            multihost_utils.sync_global_devices("b")
    """}, {"sync.py": """
        from torch.distributed import barrier
        import torch.distributed as dist


        def sync():
            barrier()


        def share(objs):
            return dist.broadcast_object_list(objs, src=0)


        def gather(parts, t):
            return dist.all_gather(parts, t, group=dist.group.WORLD)


        def local(parts, t, group):
            return dist.all_gather(parts, t, group=group)
    """, "parallel/multihost.py": """
        import torch.distributed as dist


        def barrier():
            dist.barrier()
    """}),
    "distributed-init": ({"boot.py": """
        import jax
        from jax.distributed import initialize as init


        def boot():
            jax.distributed.initialize("h:1", 2, 0)


        def boot_again():
            init("h:1", 2, 0)
    """, "parallel/multihost.py": """
        import jax


        def initialize():
            jax.distributed.initialize()
    """}, {"boot.py": """
        import torch
        from torch.distributed import init_process_group as init


        def boot():
            torch.distributed.init_process_group("gloo")


        def boot_again():
            init("gloo")
    """, "parallel/multihost.py": """
        import torch.distributed as dist


        def initialize():
            dist.init_process_group("gloo")
    """}),
    "host-materialization": ({"ops/decode.py": """
        import jax
        import numpy as np


        def expand(x):
            a = np.asarray(x)
            b = x.tolist()
            return jax.device_get(a), b


        def fine(x):
            return x + 1
    """}, {"ops/decode.py": """
        import torch
        import numpy as np


        def expand(x):
            a = np.asarray(x)
            b = x.tolist()
            return x.cpu(), x.numpy(), x.sum().item(), a, b


        def fine(x):
            return torch.flip(x, (0,))
    """}),
}


def _make_pkg(root, files):
    pkg = root / "fixturepkg"
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    (pkg / "__init__.py").touch()
    return str(pkg)


@pytest.mark.parametrize("rule_id", sorted(TRANSLATED))
def test_translated_rule_flags_the_same_sites(rule_id, tmp_path):
    jax_files, torch_files = TRANSLATED[rule_id]
    ref = ref_analysis.run_package(
        _make_pkg(tmp_path / "ref", jax_files), [rule_id])
    port = port_analysis.run_package(
        _make_pkg(tmp_path / "port", torch_files), [rule_id])

    def sites(rep):
        return sorted({(f.rule, f.file, f.line) for f in rep.findings})
    assert len(sites(ref)) >= 3, "the jax fixture must be flagged"
    assert sites(port) == sites(ref)
    assert port.unsuppressed == port.findings


def test_host_materialization_covers_the_kernel_module(tmp_path):
    """ops/kernels.py (the CUDA kernels' wrappers) is a kernel module
    of the port, as ops/pallas_kernels.py is of the reference; each of
    the five spellings is flagged once."""
    pkg = _make_pkg(tmp_path, {"ops/kernels.py": """
        import numpy as np


        def launch(x):
            a = np.asarray(x)
            b = x.tolist()
            c = x.cpu()
            d = x.numpy()
            return x.sum().item(), a, b, c, d
    """, "format/rawpage.py": """
        def boundary(x):
            return x.cpu().numpy()
    """})
    rep = port_analysis.run_package(pkg, ["host-materialization"])
    assert [(f.file, f.line) for f in rep.findings] == [
        ("fixturepkg/ops/kernels.py", line) for line in (6, 7, 8, 9, 10)]


def test_collectives_over_a_mesh_group_are_not_flagged(tmp_path):
    """A collective that passes a group of its own (a mesh's, as
    parallel/sharded_merge.py and parallel/rescale.py do) is a mesh
    program's; positional groups count as given."""
    pkg = _make_pkg(tmp_path, {"mesh.py": """
        import torch.distributed as dist


        def step(t, parts, objs, group):
            dist.all_gather(parts, t, group=group)
            dist.all_gather(parts, t, group)
            dist.broadcast(t, 0, group)
            dist.barrier(group=group)
            dist.all_gather_object(objs, t, group=group)
            dist.barrier(group=None)
            dist.broadcast(t, 0)
    """})
    rep = port_analysis.run_package(pkg, ["collectives"])
    assert [f.line for f in rep.findings] == [11, 12]


# -- the port's own tree ------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    return port_analysis.default_report()


def test_port_tree_zero_unsuppressed_findings(port_report):
    assert port_report.model.package_name == "paimon_tpu_torch"
    assert port_report.unsuppressed == [], "\n".join(
        str(f) for f in port_report.unsuppressed)


def test_port_rule_catalog_is_complete(port_report):
    assert sorted(r.id for r in port_report.rules) == sorted(RULES)
    assert port_report.to_dict()["rules"][-2:] == list(META)


def test_port_suppressions_all_carry_reasons(port_report):
    suppressed = [f for f in port_report.findings if f.suppressed]
    assert suppressed, "expected reviewed suppressions in the tree"
    for f in suppressed:
        assert f.suppress_reason, f


def test_port_fixed_violations_stay_fixed(port_report):
    """The waits the reference fixed when it shipped its rules, as the
    port spells them (ROADMAP.md C.12): the prefetch consumer polls
    with a timeout and checks the deadline, and the compaction and
    write-prep futures are waited on through wait_future.  The port's
    core/commit.py writes its delta manifest without a pool, so it has
    no such wait."""
    mods = port_report.model.modules
    lq = mods["lookup/local_query.py"].source
    assert "while not ev.wait(" in lq
    assert "is_transient_error" in lq
    assert "while not done.wait(" in mods["table/topology.py"].source
    mgr = mods["compact/manager.py"].source
    assert "q.get(timeout=" in mgr
    assert 'check_deadline("compaction prefetch")' in mgr
    assert mgr.count("wait_future(") == 3
    assert mods["core/write.py"].source.count("wait_future(") == 3
    assert "ThreadPoolExecutor" not in mods["core/commit.py"].source
    for rid in ("deadline-wait", "fault-taxonomy", "lock-order",
                "loop-blocking"):
        assert port_report.unsuppressed_by_rule(rid) == []


def test_port_markers_match_the_reference():
    """Every reviewed marker of the port has its reference's reason
    where the reference has the same site (the nine restored ones
    included), and none is stale."""
    port = port_analysis.default_report()
    ref = ref_analysis.default_report()
    # a function's findings share one message: the key holds its reasons
    reasons = {}
    for f in ref.findings:
        if f.suppressed:
            reasons.setdefault((f.rule, f.file.split("/", 1)[1], f.message),
                               set()).add(f.suppress_reason)
    shared = 0
    for f in port.findings:
        if not f.suppressed:
            continue
        k = (f.rule, f.file.split("/", 1)[1], f.message)
        if k in reasons:
            assert f.suppress_reason in reasons[k], f
            shared += 1
    assert shared >= 9
    assert port.by_rule("stale-suppression") == []


# -- both engines over both trees ---------------------------------------------

def test_port_engine_on_the_reference_tree_equals_the_reference():
    """The port's engine parses paimon_tpu/ as files and gives the
    reference's own report for the ten shared rules: the same findings,
    suppressed and not, with the same reasons."""
    mine = port_analysis.run_package(os.path.join(ROOT, "paimon_tpu"),
                                     SHARED)
    theirs = ref_analysis.default_report()
    assert keys(mine, SHARED) == keys(theirs, SHARED)
    assert any(f.suppressed for f in mine.findings)


def test_reference_engine_on_the_port_tree_is_clean():
    """The reference's engine over paimon_tpu_torch/ finds nothing
    unsuppressed for the ten shared rules (it found 17 before the
    C.12 repair and the restored markers)."""
    rep = ref_analysis.run_package(
        os.path.join(ROOT, "paimon_tpu_torch"), SHARED)
    assert rep.unsuppressed == [], "\n".join(str(f) for f in rep.unsuppressed)
    port = port_analysis.default_report()
    assert keys(rep, SHARED) == keys(port, SHARED)


def test_chip_smoke_known_bad_package(tmp_path):
    """chip_smoke.py's analysis phase holds every rule against its
    known-bad package (one site a rule, torch spellings for the three
    translated rules, a reasonless and an orphaned marker): each rule
    reports exactly its site and `paimon lint` exits 1."""
    import chip_smoke

    out = chip_smoke.check_known_bad(str(tmp_path))
    assert out["findings"] == len(RULES) + len(META)
    assert out["cli_exit"] == 1
    assert sorted(chip_smoke.LINT_RULES) == sorted(RULES)
    assert chip_smoke.LINT_META == META
