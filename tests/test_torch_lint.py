"""The port's hygiene and drift lints over paimon_tpu_torch/.

Counterpart of tests/test_lint_swallow.py (one test a hygiene rule over
the shared engine run, and a pin that this file parses nothing itself)
and of the drift assertions of tests/test_docs.py and
tests/test_metrics.py, on the port's tree.  The port's options-drift
checks that every key paimon_tpu_torch/options.py declares has a row in
docs/options.md with the type and default the port renders (the doc is
generated from the reference's options, a superset), and that no key is
declared twice; fixture packages named paimon_tpu_torch show it flags
both.
"""

import os
import shutil
import textwrap

import pytest

from paimon_tpu_torch.analysis import default_report, run_package

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_lint():
    """ONE engine pass over paimon_tpu_torch/ shared by this file."""
    return default_report(os.path.join(REPO, "paimon_tpu_torch"))


def _clean(report, rule_id):
    offenders = report.unsuppressed_by_rule(rule_id)
    assert not offenders, "\n".join(str(f) for f in offenders)


@pytest.mark.parametrize("rule_id", [
    "swallow", "threads", "sleeps", "sockets", "collectives",
    "distributed-init", "host-materialization"])
def test_hygiene_rule_is_clean(port_lint, rule_id):
    _clean(port_lint, rule_id)


def test_this_file_does_not_parse_the_tree_itself():
    with open(__file__, encoding="utf-8") as fh:
        src = fh.read()
    # concatenation keeps this test's own source from matching itself
    assert ("import " + "ast") not in src
    assert ("os." + "walk") not in src


# -- drift ------------------------------------------------------------------

def test_options_doc_covers_the_port(port_lint):
    _clean(port_lint, "options-drift")


def test_metric_name_constants_are_produced(port_lint):
    _clean(port_lint, "metric-drift")


def test_obs_constants_are_produced(port_lint):
    _clean(port_lint, "obs-drift")


def test_no_duplicated_option_keys():
    import inspect

    from paimon_tpu_torch.analysis.rules.drift import duplicate_option_keys
    from paimon_tpu_torch.options import CoreOptions

    assert duplicate_option_keys(inspect.getsource(CoreOptions)) == []


def test_duplicate_option_key_detection():
    from paimon_tpu_torch.analysis.rules.drift import duplicate_option_keys

    src = '''
    A = ConfigOption("some.key", str, "x", "")
    B = ConfigOption(
        "other.key", int, 1, "")
    A = ConfigOption("some.key", str, "y", "")
    '''
    assert duplicate_option_keys(src) == ["some.key"]


def test_the_port_renders_the_reference_rows():
    """Every option the port declares renders as the reference's
    generator renders it (docs/generate_options.py)."""
    import sys

    sys.path.insert(0, REPO)
    from docs.generate_options import _default_repr, _type_name

    from paimon_tpu.options import CoreOptions as RefOptions
    from paimon_tpu_torch.analysis.rules.drift import option_row_prefix
    from paimon_tpu_torch.options import ConfigOption, CoreOptions

    ref = {o.key: o for o in vars(RefOptions).values()
           if hasattr(o, "key") and hasattr(o, "typ")}
    opts = [o for o in vars(CoreOptions).values()
            if isinstance(o, ConfigOption)]
    assert len(opts) == 249
    for o in opts:
        r = ref[o.key]
        assert option_row_prefix(o) == \
            f"| `{r.key}` | {_type_name(r)} | {_default_repr(r)} |"


_OPTIONS = '''
class ConfigOption:
    def __init__(self, key, typ, default, description=""):
        self.key, self.typ, self.default = key, typ, default
        self.description = description


def _parse_bool(v):
    return str(v).lower() == "true"


class CoreOptions:
    BUCKET = ConfigOption("bucket", int, -1, "Bucket count")
    WRITE_ONLY = ConfigOption("write-only", _parse_bool, False, "")
{extra}
'''
_DOC = """\
| Key | Type | Default | Description |
|---|---|---|---|
| `bucket` | int | -1 | Bucket count; -1 = unaware/dynamic |
| `write-only` | boolean | false | Skip compaction |
"""


def _options_pkg(tmp_path, extra=""):
    """A package named paimon_tpu_torch (the rule runs on no other name)
    with an options.py, beside a docs/options.md."""
    pkg = tmp_path / "paimon_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "options.py").write_text(
        _OPTIONS.format(extra=textwrap.indent(extra, "    ")))
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "options.md").write_text(_DOC)
    return str(pkg)


def test_options_drift_clean_fixture(tmp_path):
    rep = run_package(_options_pkg(tmp_path), ["options-drift"])
    assert rep.findings == []


@pytest.mark.parametrize("extra, line, words", [
    ('DUP = ConfigOption("bucket", int, 4, "")', 13,
     "'bucket' declared more than once"),
    ('SPILL = ConfigOption("write-buffer-spillable", _parse_bool, True, "")',
     15, "'write-buffer-spillable' renders as | `write-buffer-spillable` "
     "| boolean | true | but docs/options.md has no row"),
], ids=["declared_twice", "no_row"])
def test_options_drift_flags_the_fixture(tmp_path, extra, line, words):
    rep = run_package(_options_pkg(tmp_path, extra), ["options-drift"])
    (f,) = rep.findings
    assert (f.rule, f.file, f.line) == (
        "options-drift", "paimon_tpu_torch/options.py", line)
    assert words in f.message


def test_options_drift_flags_a_default_the_doc_disagrees_on(tmp_path):
    pkg = _options_pkg(tmp_path)
    src = os.path.join(pkg, "options.py")
    with open(src) as f:
        text = f.read()
    with open(src, "w") as f:
        f.write(text.replace('"write-only", _parse_bool, False',
                             '"write-only", _parse_bool, True'))
    rep = run_package(pkg, ["options-drift"])
    (f,) = rep.findings
    assert f.line == 14
    assert "has the row | `write-only` | boolean | false |" in f.message


def test_drift_rules_skip_other_packages(tmp_path):
    pkg = _options_pkg(tmp_path)
    other = tmp_path / "otherpkg"
    shutil.copytree(pkg, other)
    rep = run_package(str(other), ["options-drift", "metric-drift"])
    assert rep.findings == []


def test_metric_drift_flags_an_orphaned_constant(tmp_path):
    """A metric-name constant of paimon_tpu_torch.metrics that nothing
    in the package names is flagged at its line of metrics.py."""
    import paimon_tpu_torch.metrics as M

    names = [n for n in M.__all__ if n.isupper()]
    # one that no other constant contains, so that naming the others
    # does not name it too
    orphan = next(n for n in names
                  if not any(n in m for m in names if m != n))
    pkg = tmp_path / "paimon_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "metrics.py").write_text(
        "".join(f'{n} = "{n.lower()}"\n' for n in names))
    (pkg / "producers.py").write_text(
        "".join(f"# {n}\n" for n in names if n != orphan))
    rep = run_package(str(pkg), ["metric-drift"])
    (f,) = rep.findings
    assert f.line == names.index(orphan) + 1
    assert orphan in f.message
