"""Whole-program analysis plane.

Counterpart of paimon_tpu/analysis/.  One shared parse of the package
(`model.build_model`), a pluggable rule engine (`engine.run`) with
uniform `# lint-ok: <rule> <reason>` suppressions and stale-marker
detection, and a rule catalog spanning the hygiene lints, the
docs/metrics drift checks, and the four whole-program checkers
(lock-order, loop-blocking, deadline-wait, fault-taxonomy).  `paimon
lint` on the CLI and the tests run the SAME pass; the rules are
described in docs/static_analysis.md.
"""

from paimon_tpu_torch.analysis.engine import (
    META_RULES, Finding, Report, all_rules, get_rule, run,
    run_package, rule,
)
from paimon_tpu_torch.analysis.model import ProgramModel, build_model

__all__ = ["Finding", "META_RULES", "Report", "ProgramModel",
           "all_rules", "build_model", "get_rule", "rule", "run",
           "run_package", "default_report"]

_CACHED = {}


def default_report(package_dir=None):
    """The full-rule report over the installed paimon_tpu_torch package,
    cached per process — the lint tests share ONE parse+run instead of
    re-walking the tree per test."""
    import os
    if package_dir is None:
        package_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    key = os.path.abspath(package_dir)
    if key not in _CACHED:
        _CACHED[key] = run_package(key)
    return _CACHED[key]
