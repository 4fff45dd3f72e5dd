"""Drift rules: artifacts that must track the source.

Counterpart of paimon_tpu/analysis/rules/drift.py.  `obs-drift` is
pure source analysis and runs on any package.  `metric-drift` and
`options-drift` are repo-shaped: they run only on a package named
paimon_tpu_torch (metrics.py's `__all__`; options.py beside a
docs/options.md in the repo root) and no-op on fixture packages that
lack those anchors.

docs/options.md is generated from the reference's options, a superset
of the keys this package declares, so `options-drift` cannot ask for a
byte-identical regeneration.  It keeps its own copy of the generator's
duplicate-key scan and row rendering (docs/generate_options.py) and
checks that no key is declared twice and that every declared key has
a row in docs/options.md with the type and default this package
renders.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import ProgramModel


@rule("metric-drift",
      "exported metric-name constant with no producer")
def check_metric_drift(model: ProgramModel) -> List[Finding]:
    """Every exported ALL_CAPS metric-name constant in metrics.py must
    be referenced by name somewhere else in the package — an orphaned
    constant means a dashboard/test greps for a metric nothing
    emits."""
    metrics_mod = model.modules.get("metrics.py")
    if metrics_mod is None or model.package_name != "paimon_tpu_torch":
        return []
    import paimon_tpu_torch.metrics as M
    consts = [n for n in M.__all__ if n.isupper()]
    blob = "\n".join(m.source for m in model.modules.values()
                     if m is not metrics_mod)
    out = []
    for name in consts:
        if name in blob:
            continue
        m = re.search(rf"^{name}\b", metrics_mod.source, re.MULTILINE)
        line = metrics_mod.source[:m.start()].count("\n") + 1 if m \
            else 1
        out.append(Finding(
            "metric-drift", metrics_mod.rel, line,
            f"metric-name constant {name} has no producer in "
            f"{model.package_name}/ — emit it or delete it"))
    return out


_OBS_CONST_MODULES = ("obs/trace.py", "obs/flight.py")
_OBS_CONST_RE = re.compile(
    r"^((?:STAGE|EV)_[A-Z0-9_]+)\s*=\s*['\"]", re.MULTILINE)


@rule("obs-drift",
      "exported stage/flight-event constant with no producer")
def check_obs_drift(model: ProgramModel) -> List[Finding]:
    """Every ``STAGE_*`` span-stage constant (obs/trace.py) and
    ``EV_*`` flight-event constant (obs/flight.py) must be USED
    somewhere in the package beyond its defining assignment — an
    orphaned name means the merged fleet trace / flight ring
    documents an event nothing records.  Same-module uses count:
    the producer for ``STAGE_SERVE_REQUEST`` is trace.py's own
    header-adoption path.  (SLO metric-name constants live in
    metrics.py's ``__all__`` and are covered by `metric-drift`.)

    Unlike the other drift rules this one is pure source analysis —
    no imports, no repo anchors — so it runs on fixture packages
    too."""
    out: List[Finding] = []
    all_mods = list(model.modules.values())
    for rel in _OBS_CONST_MODULES:
        mod = model.modules.get(rel)
        if mod is None:
            continue
        # the defining module minus the definition lines themselves
        residue = _OBS_CONST_RE.sub("", mod.source)
        others = "\n".join(m.source for m in all_mods if m is not mod)
        for m in _OBS_CONST_RE.finditer(mod.source):
            name = m.group(1)
            if re.search(rf"\b{name}\b", others) or \
                    re.search(rf"\b{name}\b", residue):
                continue
            line = mod.source[:m.start()].count("\n") + 1
            out.append(Finding(
                "obs-drift", mod.rel, line,
                f"observability constant {name} has no producer in "
                f"{model.package_name}/ — record it or delete it"))
    return out


_TYPE_NAMES = {
    "_parse_bool": "boolean",
    "_parse_duration_ms": "duration (ms)",
    "parse_memory_size": "memory size (bytes)",
    "str": "string", "int": "int", "float": "float",
}
_OPTION_KEY_RE = re.compile(
    r"=\s*ConfigOption\(\s*[\r\n ]*[\"']([^\"']+)[\"']")


def _type_name(opt) -> str:
    name = getattr(opt.typ, "__name__", str(opt.typ))
    return _TYPE_NAMES.get(name, name)


def _default_repr(opt) -> str:
    d = opt.default
    if d is None:
        return "(none)"
    if isinstance(d, bool):
        return "true" if d else "false"
    return str(d)


def duplicate_option_keys(src: str) -> List[str]:
    """Option keys declared more than once in a CoreOptions source body
    (docs/generate_options.py's scan).  Duplicates with the SAME
    attribute name collapse in the class dict — the second silently
    wins — so only the source shows them."""
    seen, dups = set(), set()
    for k in _OPTION_KEY_RE.findall(src):
        (dups if k in seen else seen).add(k)
    return sorted(dups)


def option_row_prefix(opt) -> str:
    """The start of an option's docs/options.md row as the generator
    renders it: key, type and default (descriptions may differ)."""
    return f"| `{opt.key}` | {_type_name(opt)} | {_default_repr(opt)} |"


def _load_options(path: str):
    """options.py of the analysed package, loaded from its file (the
    model may be a copy of the package, not the installed one)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_paimon_lint_options", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line_of(source: str, needle: str) -> int:
    i = source.find(needle)
    return source[:i].count("\n") + 1 if i >= 0 else 1


@rule("options-drift",
      "docs/options.md or CoreOptions out of sync")
def check_options_drift(model: ProgramModel) -> List[Finding]:
    """No option key may be declared twice in CoreOptions (duplicates
    with the same attribute name collapse in the class dict — the
    second silently wins), and every key paimon_tpu_torch/options.py
    declares must have a docs/options.md row with the type and
    default this package renders for it."""
    options_mod = model.modules.get("options.py")
    doc_path = os.path.join(model.repo_root, "docs", "options.md")
    if options_mod is None or not os.path.exists(doc_path) or \
            model.package_name != "paimon_tpu_torch":
        return []
    opts = _load_options(options_mod.path)
    out: List[Finding] = []
    cls_node = next((n for n in options_mod.tree.body
                     if isinstance(n, ast.ClassDef)
                     and n.name == "CoreOptions"), None)
    cls_src = ast.get_source_segment(options_mod.source, cls_node) \
        if cls_node is not None else ""
    dups = duplicate_option_keys(cls_src)
    for key in dups:
        out.append(Finding(
            "options-drift", options_mod.rel,
            _line_of(options_mod.source, f'"{key}"'),
            f"option key '{key}' declared more than once in "
            f"CoreOptions — the second declaration silently wins"))
    if dups:
        return out
    rows: Dict[str, str] = {}
    with open(doc_path, encoding="utf-8") as fh:
        for line in fh:
            if line.startswith("| `"):
                rows[line.split("`", 2)[1]] = line
    for opt in vars(opts.CoreOptions).values():
        if not isinstance(opt, opts.ConfigOption):
            continue
        want = option_row_prefix(opt)
        row = rows.get(opt.key)
        if row is not None and row.startswith(want):
            continue
        have = "no row" if row is None else \
            "the row " + " | ".join(
                c.strip() for c in row.split(" | ")[:3]) + " |"
        out.append(Finding(
            "options-drift", options_mod.rel,
            _line_of(options_mod.source, f'"{opt.key}"'),
            f"option '{opt.key}' renders as {want} but docs/options.md "
            f"has {have} — the two disagree on its type or default"))
    return out
