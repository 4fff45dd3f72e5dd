"""fault-taxonomy: transient store errors route through ONE ladder.

parallel/fault.py is the single definition of "worth retrying":
`is_transient_error` excludes decode corruption (deterministic bad
bytes) and spent deadlines (the caller is gone), and
`BucketRetryPolicy.retry_call` is the ladder with capped jittered
backoff and traced attempts.  The moment a module hand-rolls its own
`except TransientStoreError: <loop again>` it forks that taxonomy:
the hand-rolled copy won't exclude DeadlineExceededError, won't
back off, won't trace, and silently diverges the next time the
taxonomy learns a new error class.

Two shapes are flagged:

* naming a transient STORE error class (`TransientStoreError`,
  `CircuitOpenError`) in an `except` outside the whitelisted fault
  plane (parallel/fault.py, fs/object_store.py, fs/resilience.py) —
  storage-transient handling belongs behind the ladder, not at call
  sites;
* a hand-rolled transient RETRY: a RETRY-SHAPED loop (`while ...`, or
  `for` over an attempt counter — `range(...)` / a constant tuple)
  whose body is a `try` whose handler names a transient class or
  `OSError`/`ConnectionError` and flows back to the next attempt (a
  `continue`, or falling off the handler without return/raise/break)
  without consulting the taxonomy (`is_transient_error` /
  `retry_call`) or a `Backoff` — a retry loop the ladder cannot see.

A `for f in files: ... except OSError: continue` SKIP loop is
deliberately NOT a finding: skipping a bad item while iterating a
collection is item-level fault isolation (fsck walks, cache eviction
sweeps), a different contract from re-attempting the same operation.

A deliberate, narrowly-scoped local recovery (rebuild-once of an
evicted local file, a stale keep-alive reconnect) is the legitimate
exemption shape — suppress at the `except` with the reason.
"""

from __future__ import annotations

import ast
from typing import List

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import ProgramModel, except_names

_TRANSIENT = frozenset({"TransientStoreError", "CircuitOpenError"})
_RETRYISH = _TRANSIENT | frozenset({"OSError", "ConnectionError",
                                    "InjectedIOError"})
_WHITELIST = frozenset({
    "parallel/fault.py", "fs/object_store.py", "fs/resilience.py",
})
_TAXONOMY_CALLS = frozenset({"is_transient_error", "retry_call",
                             "Backoff", "pause"})


def _handler_rearms_loop(handler: ast.ExceptHandler) -> bool:
    """True when control can flow from this handler back into another
    loop iteration: an explicit `continue`, or the handler body
    falling off its end (no return/raise/break on the trailing
    statement)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Continue):
            return True
    last = handler.body[-1]
    return not isinstance(last, (ast.Return, ast.Raise, ast.Break))


def _consults_taxonomy(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name in _TAXONOMY_CALLS:
                return True
    return False


def _retry_shaped(loop) -> bool:
    """A loop that RE-ATTEMPTS (while ..., for over range()/constant
    tuple) rather than iterating a collection — the skip-vs-retry
    distinction the rule's second arm rests on."""
    if isinstance(loop, ast.While):
        return True
    it = loop.iter
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
            and it.func.id == "range":
        return True
    return isinstance(it, (ast.Tuple, ast.List)) and \
        all(isinstance(e, ast.Constant) for e in it.elts)


@rule("fault-taxonomy",
      "transient store errors handled outside parallel/fault.py")
def check_fault_taxonomy(model: ProgramModel) -> List[Finding]:
    out: List[Finding] = []
    for fn in model.functions.values():
        mod = fn.module
        if mod.pkg_rel in _WHITELIST:
            continue
        for node in fn.body_nodes:
            if isinstance(node, ast.ExceptHandler):
                transient = set(except_names(node.type)) & _TRANSIENT
                if transient:
                    out.append(Finding(
                        "fault-taxonomy", mod.rel, node.lineno,
                        f"except {'/'.join(sorted(transient))} in "
                        f"{fn.qname} — transient store errors are "
                        f"the fault plane's to classify: route "
                        f"through parallel/fault.py "
                        f"(is_transient_error / "
                        f"BucketRetryPolicy.retry_call) or the "
                        f"resilient store backend"))
                continue
            if not isinstance(node, (ast.For, ast.While)) or \
                    not _retry_shaped(node):
                continue
            for stmt in node.body:
                if not isinstance(stmt, ast.Try):
                    continue
                for handler in stmt.handlers:
                    names = set(except_names(handler.type))
                    if not (names & _RETRYISH):
                        continue
                    if _handler_rearms_loop(handler) and \
                            not _consults_taxonomy(handler):
                        out.append(Finding(
                            "fault-taxonomy", mod.rel,
                            handler.lineno,
                            f"hand-rolled transient retry in "
                            f"{fn.qname}: except "
                            f"{'/'.join(sorted(names & _RETRYISH))} "
                            f"re-arms the enclosing retry loop "
                            f"without consulting the taxonomy — use "
                            f"BucketRetryPolicy.retry_call (backoff, "
                            f"attempt caps, tracing) or check "
                            f"is_transient_error"))
    return out
