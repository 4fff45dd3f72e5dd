"""Rule engine over the shared program model.

A rule is a function `(ProgramModel) -> list[Finding]` registered
under a stable id via `@rule(...)`.  `run()` builds findings from
every requested rule, then applies the UNIFORM suppression contract:

* a finding whose line (or the line directly below a comment-only
  marker line) carries `# lint-ok: <rule-id> <reason>` is kept but
  marked suppressed — CI fails only on unsuppressed findings, humans
  still see the suppressed ones in `paimon lint --json`;
* the reason is mandatory: a bare `# lint-ok: deadline-wait` is a
  `bad-suppression` finding (an exemption nobody can review is not an
  exemption);
* a marker naming a rule that is running but matching no finding is a
  `stale-suppression` finding — suppressions rot the moment the code
  they exempted changes, and stale ones hide the next real bug;
* a marker naming a rule id that does not exist at all is
  `bad-suppression` (usually a typo that silently disables nothing).

The engine is the ONE place parse/suppress/report logic lives; rules
only look at the model and emit findings.  The tests run the engine
once per process (they share `default_report()`), the CLI (`paimon
lint`) runs the same pass for humans and CI.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence

from paimon_tpu_torch.analysis.model import ProgramModel, build_model

__all__ = ["Finding", "Rule", "rule", "all_rules", "get_rule", "run",
           "run_package", "Report", "META_RULES"]

# engine-emitted rule ids (no registered checker behind them)
META_RULES = ("bad-suppression", "stale-suppression")


class Finding:
    """One structured result: rule id, location, message — plus the
    suppression state the engine fills in."""

    __slots__ = ("rule", "file", "line", "message", "suppressed",
                 "suppress_reason")

    def __init__(self, rule: str, file: str, line: int, message: str):
        self.rule = rule
        self.file = file            # repo-relative display path
        self.line = int(line)
        self.message = message
        self.suppressed = False
        self.suppress_reason: Optional[str] = None

    def key(self):
        return (self.rule, self.file, self.line, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file,
                "line": self.line, "message": self.message,
                "suppressed": self.suppressed,
                "suppress_reason": self.suppress_reason}

    def __repr__(self):
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.file}:{self.line}: [{self.rule}]{tag} " \
               f"{self.message}"


class Rule:
    __slots__ = ("id", "title", "check")

    def __init__(self, id: str, title: str,
                 check: Callable[[ProgramModel], List[Finding]]):
        self.id = id
        self.title = title
        self.check = check


_RULES: Dict[str, Rule] = {}


def rule(id: str, title: str):
    """Register a checker under a stable rule id."""
    def deco(fn):
        if id in _RULES:
            raise ValueError(f"duplicate rule id: {id}")
        _RULES[id] = Rule(id, title, fn)
        return fn
    return deco


def _load_rules():
    # importing the package registers every rule module exactly once
    from paimon_tpu_torch.analysis import rules  # noqa: F401


def all_rules() -> List[Rule]:
    _load_rules()
    return [_RULES[k] for k in sorted(_RULES)]


def get_rule(id: str) -> Rule:
    _load_rules()
    try:
        return _RULES[id]
    except KeyError:
        raise ValueError(
            f"unknown rule id '{id}' (known: "
            f"{', '.join(sorted(_RULES) + list(META_RULES))})") \
            from None


class Report:
    """Findings (suppressed + not) from one engine run."""

    def __init__(self, model: ProgramModel, rules: List[Rule],
                 findings: List[Finding]):
        self.model = model
        self.rules = rules
        self.findings = findings

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def by_rule(self, rule_id: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule_id]

    def unsuppressed_by_rule(self, rule_id: str) -> List[Finding]:
        return [f for f in self.by_rule(rule_id) if not f.suppressed]

    def to_dict(self) -> dict:
        return {
            "package": self.model.package_name,
            "files": len(self.model.modules),
            "rules": [r.id for r in self.rules] + list(META_RULES),
            "findings": [f.to_dict() for f in self.findings],
            "summary": {
                "total": len(self.findings),
                "unsuppressed": len(self.unsuppressed),
                "suppressed": len(self.findings)
                - len(self.unsuppressed),
            },
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent,
                          sort_keys=True)


def _apply_suppressions(model: ProgramModel, rules: List[Rule],
                        findings: List[Finding]) -> List[Finding]:
    """Mark suppressed findings, then audit the markers themselves."""
    by_file = {m.rel: m for m in model.modules.values()}
    for f in findings:
        mod = by_file.get(f.file)
        if mod is None:
            continue
        s = mod.suppression_for(f.rule, f.line)
        if s is not None and s.reason:
            f.suppressed = True
            f.suppress_reason = s.reason
            s.consumed = True
        elif s is not None:
            s.consumed = True       # reasonless: audited below anyway
    known = {r.id for r in all_rules()} | set(META_RULES)
    running = {r.id for r in rules}
    audit: List[Finding] = []
    for mod in model.modules.values():
        for s in mod.suppressions:
            if s.rule not in known:
                audit.append(Finding(
                    "bad-suppression", mod.rel, s.line,
                    f"marker names unknown rule '{s.rule}' — typo? "
                    f"it suppresses nothing"))
            elif not s.reason:
                audit.append(Finding(
                    "bad-suppression", mod.rel, s.line,
                    f"marker for '{s.rule}' has no reason — "
                    f"`# lint-ok: {s.rule} <why this is deliberate>`"))
            elif s.rule in running and not s.consumed:
                audit.append(Finding(
                    "stale-suppression", mod.rel, s.line,
                    f"marker for '{s.rule}' suppresses no finding — "
                    f"the exempted code changed or moved; remove the "
                    f"marker"))
    return findings + audit


def run(model: ProgramModel,
        rule_ids: Optional[Sequence[str]] = None) -> Report:
    """Run the requested rules (default: all) over `model` and return
    the suppression-applied report.  Findings are sorted by file, line,
    rule for stable output.

    The engine-emitted meta ids (`bad-suppression`,
    `stale-suppression`) are valid in `rule_ids` — every report's
    `rules` array advertises them, so an id round-tripped from the
    JSON must not be rejected.  They select no checker (the marker
    audit always runs; stale detection needs the named rules running
    to know a marker matched nothing)."""
    rules = all_rules() if rule_ids is None \
        else [get_rule(r) for r in rule_ids if r not in META_RULES]
    findings: List[Finding] = []
    for r in rules:
        findings.extend(r.check(model))
    findings = _apply_suppressions(model, rules, findings)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return Report(model, rules, findings)


def run_package(package_dir: str,
                rule_ids: Optional[Sequence[str]] = None,
                repo_root: Optional[str] = None) -> Report:
    """Build the model (ONE parse per file) and run the rules."""
    return run(build_model(package_dir, repo_root=repo_root), rule_ids)
