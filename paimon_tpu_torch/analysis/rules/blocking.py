"""Shared blocking-primitive classifier.

One definition of "this call can park the thread", used by BOTH the
event-loop reachability rule (anything blocking is fatal on the loop
thread) and the deadline-propagation rule (blocking is fine off-loop
— but only in a BOUNDED form that a spent request budget can escape).

Classification is syntactic and conservative:

* `<x>.wait()` with no arguments — Event/Condition wait, unbounded;
  with any argument it is bounded (`bounded=True`);
* `cfmod.wait(fs)` through an imported-module alias
  (concurrent.futures) — bounded iff a `timeout=` keyword is present
  (the first positional is the future list, not a timeout);
* `<fut>.result()` with no arguments — unbounded future wait;
* `<q>.get()` / `<q>.get(True)` / `<q>.get(block=True)` with no
  timeout on a QUEUE-SHAPED receiver (last name segment `q`, `queue`,
  `jobs`, `tasks`, `work`, `inbox`) — unbounded queue wait.  The
  receiver shape filter keeps `dict.get(k)` / `ContextVar.get()` out;
* `<t>.join()` with no arguments — unbounded thread/queue join;
* `<lock>.acquire()` and `with <lock>:` — lock waits (reported only
  by the event-loop rule: flagging every lock acquisition as a
  deadline hazard would drown the signal, and lock hold times are the
  lock-order rule's domain);
* `time.sleep` / builtin `open()` — reported only by the event-loop
  rule (sleeps have their own hygiene rule; file IO off-loop is the
  storage plane's job).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from paimon_tpu_torch.analysis.model import (
    LOCKLIKE_RE, FunctionInfo, ProgramModel, dotted_name,
)

__all__ = ["BlockingSite", "iter_blocking_sites"]

_QUEUE_RE = re.compile(
    r"(?:^|_)(?:q|queue|jobs|tasks|work|inbox)\d*$", re.IGNORECASE)


class BlockingSite:
    """One potentially-parking call: kind in {'wait', 'future-result',
    'queue-get', 'join', 'lock', 'sleep', 'file-io'};
    `bounded` True when a timeout bounds it."""

    __slots__ = ("line", "kind", "detail", "bounded")

    def __init__(self, line: int, kind: str, detail: str,
                 bounded: bool):
        self.line = line
        self.kind = kind
        self.detail = detail
        self.bounded = bounded


def _kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


def _receiver(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return dotted_name(call.func.value)
    return None


def iter_blocking_sites(model: ProgramModel, fn: FunctionInfo) \
        -> Iterator[BlockingSite]:
    mod = fn.module
    for node in fn.body_nodes:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                d = dotted_name(item.context_expr)
                if d and LOCKLIKE_RE.search(d.split(".")[-1]):
                    yield BlockingSite(node.lineno, "lock",
                                       f"with {d}", False)
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "open":
                yield BlockingSite(node.lineno, "file-io", "open(",
                                   True)
            continue
        if not isinstance(func, ast.Attribute):
            continue
        attr = func.attr
        recv = _receiver(node) or "<expr>"
        tail = recv.split(".")[-1]
        if attr == "sleep" and tail in ("time", "_time"):
            yield BlockingSite(node.lineno, "sleep", "time.sleep(",
                               False)
        elif attr == "acquire" and LOCKLIKE_RE.search(tail):
            # .acquire(timeout=t) / .acquire(True, t) is bounded
            bounded = _kw(node, "timeout") or len(node.args) >= 2
            yield BlockingSite(node.lineno, "lock",
                               f"{recv}.acquire(", bounded)
        elif attr == "wait":
            base = recv.split(".")[0]
            if base in mod.imports and \
                    model._module_for(mod.imports[base]) is None:
                # module-level wait (concurrent.futures.wait): the
                # positional args are futures, only timeout= bounds it
                bounded = _kw(node, "timeout")
            else:
                bounded = bool(node.args) or _kw(node, "timeout")
            yield BlockingSite(node.lineno, "wait", f"{recv}.wait(",
                               bounded)
        elif attr == "result":
            bounded = bool(node.args) or _kw(node, "timeout")
            yield BlockingSite(node.lineno, "future-result",
                               f"{recv}.result(", bounded)
        elif attr == "get" and _QUEUE_RE.search(tail):
            blocking = True
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value is False:
                blocking = False
            for k in node.keywords:
                if k.arg == "block" and \
                        isinstance(k.value, ast.Constant) and \
                        k.value.value is False:
                    blocking = False
            bounded = (not blocking) or _kw(node, "timeout") \
                or len(node.args) >= 2
            yield BlockingSite(node.lineno, "queue-get",
                               f"{recv}.get(", bounded)
        elif attr == "join" and not node.args and not node.keywords:
            yield BlockingSite(node.lineno, "join", f"{recv}.join()",
                               False)
