"""ownership-history: ownership stamps are read through ONE API.

parallel/distributed.py owns the on-snapshot encoding of the fleet's
ownership state: the `multihost.ownership.*` properties (version /
processes / buckets / dead / history) and the per-host rejoin
properties (`multihost.rejoin.request.p<i>` / `.floor.p<i>`).  The
encoding has already changed once — the generation HISTORY property
was added so `owner_of` at a historical version is exact instead of
reconstructed — and any module that parses the raw properties itself
silently breaks on the next change: it reads the current map where it
needed the governing one, or misses the dead-set.  The sanctioned
readers are `stamp_from_properties` / `has_ownership_stamp` /
`resume_generation_history` (and friends) in parallel/distributed.py.

Two shapes are flagged outside that module:

* a string literal spelling one of the canonical property keys or
  per-host prefixes — the telltale of hand-rolled stamp parsing or
  construction (docstrings are exempt: prose may NAME the properties,
  code may not touch them);
* importing the property-name constants (`OWNERSHIP_*_PROP`,
  `REJOIN_*_PREFIX`) from parallel.distributed — the same fork one
  step removed.

`multihost.rejoin.enabled` (an OPTION key, options.py's to register)
and `multihost.lease.*` (already behind `lease_props` /
`merge_lease_view`, with no versioned encoding to fork) are
deliberately out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Set

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import ProgramModel

# the canonical keys/prefixes distributed.py defines; a literal that
# STARTS WITH one of these is parsing/constructing a stamp property
_PROP_KEYS = (
    "multihost.ownership.version",
    "multihost.ownership.processes",
    "multihost.ownership.buckets",
    "multihost.ownership.dead",
    "multihost.ownership.history",
    "multihost.rejoin.request.p",
    "multihost.rejoin.floor.p",
)
_CONST_NAMES = frozenset({
    "OWNERSHIP_VERSION_PROP", "OWNERSHIP_PROCESSES_PROP",
    "OWNERSHIP_BUCKETS_PROP", "OWNERSHIP_DEAD_PROP",
    "OWNERSHIP_HISTORY_PROP",
    "REJOIN_REQUEST_PREFIX", "REJOIN_FLOOR_PREFIX",
})
_ALLOWED = frozenset({
    "parallel/distributed.py",      # the owner of the encoding
    "analysis/rules/ownership.py",  # this rule's own key table
})


def _docstring_constants(nodes) -> Set[int]:
    """ids of the Constant nodes that are docstrings (module / class /
    function leading string statements) — prose, not parsing."""
    out: Set[int] = set()
    for node in nodes:
        if isinstance(node, (ast.Module, ast.ClassDef,
                             ast.FunctionDef, ast.AsyncFunctionDef)):
            body = getattr(node, "body", None)
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


@rule("ownership-history",
      "ownership-stamp properties parsed outside parallel/distributed")
def check_ownership_history(model: ProgramModel) -> List[Finding]:
    out: List[Finding] = []
    for mod in model.modules.values():
        if mod.pkg_rel in _ALLOWED:
            continue
        docstrings = _docstring_constants(mod.nodes)
        for node in mod.nodes:
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    id(node) not in docstrings and \
                    node.value.startswith(_PROP_KEYS):
                out.append(Finding(
                    "ownership-history", mod.rel, node.lineno,
                    f"literal {node.value!r} spells an ownership-"
                    f"stamp property — read stamps through "
                    f"stamp_from_properties / has_ownership_stamp / "
                    f"resume_generation_history "
                    f"(parallel/distributed.py), which track the "
                    f"encoding as it evolves"))
            elif isinstance(node, ast.ImportFrom) and \
                    node.module and \
                    node.module.endswith("parallel.distributed"):
                forked = sorted(a.name for a in node.names
                                if a.name in _CONST_NAMES)
                if forked:
                    out.append(Finding(
                        "ownership-history", mod.rel, node.lineno,
                        f"importing {', '.join(forked)} from "
                        f"parallel.distributed forks the stamp "
                        f"encoding — use the stamp/history API "
                        f"instead of the raw property names"))
    return out
