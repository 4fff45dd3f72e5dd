"""loop-blocking: blocking call reachable from the event-loop thread.

The serving plane's whole design rests on ONE invariant: the selectors
loop thread (service/async_server.py) never parks.  A blocking call on
the loop thread stalls every connection at once — reads, writes and
accepts all stop, and the loop-lag canary fires only AFTER the damage.
The dangerous regressions are not in the loop functions themselves
(those get reviewed hard) but two or three calls away: a helper grows
a lock, a metrics path grows a queue, and nothing in a per-function
lint notices.

This rule finds the loop ROOT (the function handed to `spawn_thread`
with a thread name containing "loop" inside service/async_server.py),
computes its call-graph closure, and flags every blocking primitive
(per rules/blocking.py — lock acquires, waits, queue gets, future
results, sleeps, file IO) in any reachable function, with the call
path in the message.

Known-held exemption: the loop does take `_done_lock`-style MICRO
critical sections shared with workers (append/popleft under lock).
Those are deliberate bounded waits — suppress at the site with
`# lint-ok: loop-blocking <reason>`; the marker is the review.

If the server module exists but no loop root can be found, that is
itself a finding — a refactor that renames the loop thread must not
silently disable the rule.
"""

from __future__ import annotations

import ast
from typing import List

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import (
    FunctionInfo, ProgramModel,
)
from paimon_tpu_torch.analysis.rules.blocking import iter_blocking_sites

_SERVER_MODULE = "service/async_server.py"


def _contains_loop_name(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg != "name":
            continue
        for sub in ast.walk(kw.value):
            if isinstance(sub, ast.Constant) and \
                    isinstance(sub.value, str) and "loop" in sub.value:
                return True
    return False


def _loop_roots(model: ProgramModel) -> List[FunctionInfo]:
    mod = model.modules.get(_SERVER_MODULE)
    if mod is None:
        return []
    roots: List[FunctionInfo] = []
    for fn in model.functions.values():
        if fn.module is not mod:
            continue
        for node in fn.body_nodes:
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", None))
                    == "spawn_thread"
                    and node.args and _contains_loop_name(node)):
                continue
            target = node.args[0]
            for cand in model.resolve_call(
                    fn, ast.Call(func=target, args=[], keywords=[])):
                roots.append(cand)
    return roots


@rule("loop-blocking",
      "blocking call reachable from the event-loop thread")
def check_loop_blocking(model: ProgramModel) -> List[Finding]:
    mod = model.modules.get(_SERVER_MODULE)
    if mod is None:
        return []          # fixture package without a serving plane
    roots = _loop_roots(model)
    if not roots:
        return [Finding(
            "loop-blocking", mod.rel, 1,
            "cannot locate the event-loop root (no spawn_thread(..., "
            "name=...'loop'...) in service/async_server.py) — the "
            "loop thread was renamed or removed; update the rule's "
            "root discovery so loop-thread reachability stays "
            "checked")]
    reach = model.reachable(roots)
    out: List[Finding] = []
    for qname, (fn, _parent) in reach.items():
        for site in iter_blocking_sites(model, fn):
            # bounded waits still park the loop (a 500 ms cond.wait
            # stalls every connection for 500 ms) — flag them all
            path = model.call_path(reach, qname)
            out.append(Finding(
                "loop-blocking", fn.module.rel, site.line,
                f"{site.kind} ({site.detail}) on the event-loop "
                f"thread via {path} — the loop must never park: move "
                f"the work to the handler pool or restructure the "
                f"completion hand-off"))
    return out
