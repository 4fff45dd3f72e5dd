"""lock-order: inter-procedural lock-acquisition cycle detector.

The classic two-thread deadlock needs no blocked system and no load:
thread 1 holds A and wants B, thread 2 holds B and wants A.  With five
concurrency planes sharing the cache tiers, the serving plane and the
write/scan pipelines, the pairs are spread across FILES — no
single-function lint can see them.

This rule builds a lock-acquisition ORDER graph:

* lock identity comes from the model's canonicalised lock ids
  (`fs/caching.py::BlockCache.lock`): `self.X` resolves to the
  base-most class that assigns X, and `Condition(self._lock)` aliases
  to the underlying lock;
* an edge A -> B means "B was acquired while A was held": directly
  (`with a: with b:`), or transitively — while A is held, a call chain
  resolved through the conservative call graph reaches a function that
  acquires B;
* a CYCLE in the graph is a potential deadlock (finding per cycle);
  re-acquiring a NON-reentrant lock while already holding it is the
  1-cycle special case (guaranteed self-deadlock when the path
  executes) and is reported at the inner acquisition site.

Scope: edges are seeded from the lock-heavy planes (fs/caching.py,
service/, parallel/, lookup/, plus anything else that holds a lock);
call chains may leave the seed set — the point is whole-program
visibility.

Caveats (documented in docs/static_analysis.md): lock identity is
per-CLASS, not per-instance — two instances of one class locked in a
parent/child chain look like a self-cycle; when such a hierarchy is
deliberate and instance-ordered, suppress at the inner site with the
reason.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import (
    LOCKLIKE_RE, FunctionInfo, ProgramModel, dotted_name,
)


def _transitive_acquires(model: ProgramModel, fn: FunctionInfo,
                         memo: Dict[str, Set[Tuple[str, str, int]]],
                         stack: Set[str]) \
        -> Tuple[Set[Tuple[str, str, int]], bool]:
    """((lock_id, rel, line) for every lock `fn` may acquire — itself
    or through its callees — , complete?).  Cycle-safe: a back edge to
    a function on the current DFS stack is cut, which makes that
    subtree's set INCOMPLETE (the on-stack ancestor's locks are
    missing) — such results must NOT be memoized, or a function inside
    a recursive call chain permanently loses the cycle's lock
    contributions.  The top-level call (fresh stack) is always
    complete: every cut edge points at an ancestor whose own locks are
    accumulated at that ancestor's level."""
    if fn.qname in memo:
        return memo[fn.qname], True
    if fn.qname in stack:
        return set(), False
    stack.add(fn.qname)
    acq: Set[Tuple[str, str, int]] = set()
    complete = True
    for site in model.lock_sites_by_fn.get(fn.qname, ()):
        acq.add((site.lock_id, fn.module.rel, site.line))
    for callee in model.callees(fn):
        sub, sub_complete = _transitive_acquires(
            model, callee, memo, stack)
        acq |= sub
        complete = complete and sub_complete
    stack.discard(fn.qname)
    if complete:
        memo[fn.qname] = acq
    return acq, complete


class _Edge:
    __slots__ = ("src", "dst", "rel", "line", "why")

    def __init__(self, src: str, dst: str, rel: str, line: int,
                 why: str):
        self.src = src
        self.dst = dst
        self.rel = rel        # file+line where the edge is created
        self.line = line
        self.why = why


def _lock_expr(model: ProgramModel, fn: FunctionInfo, expr) \
        -> Optional[Tuple[str, bool]]:
    d = dotted_name(expr)
    if d and LOCKLIKE_RE.search(d.split(".")[-1]):
        return model.lock_identity(fn, d)
    return None


def _scan_function(model: ProgramModel, fn: FunctionInfo,
                   memo, edges: List[_Edge],
                   self_deadlocks: List[Finding]):
    """Walk `fn` tracking which with-locks are held, emitting an edge
    for every acquisition (direct or via calls) under a held lock."""
    rel = fn.module.rel

    def visit(node, held: List[Tuple[str, bool]]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[Tuple[str, bool]] = []
            for item in node.items:
                li = _lock_expr(model, fn, item.context_expr)
                if li is None:
                    continue
                lock_id, reentrant = li
                for held_id, _ in held:
                    if held_id == lock_id:
                        if not reentrant:
                            self_deadlocks.append(Finding(
                                "lock-order", rel, node.lineno,
                                f"non-reentrant lock {lock_id} "
                                f"re-acquired while already held in "
                                f"{fn.qname} — guaranteed "
                                f"self-deadlock on this path"))
                    else:
                        edges.append(_Edge(
                            held_id, lock_id, rel, node.lineno,
                            f"{fn.qname} acquires {lock_id} while "
                            f"holding {held_id} ({rel}:{node.lineno})"))
                acquired.append((lock_id, reentrant))
            inner = held + acquired
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, ast.Call) and held:
            fnode = node.func
            if isinstance(fnode, ast.Attribute) and \
                    fnode.attr == "acquire":
                li = _lock_expr(model, fn, fnode.value)
                if li is not None:
                    lock_id, reentrant = li
                    for held_id, _ in held:
                        if held_id != lock_id:
                            edges.append(_Edge(
                                held_id, lock_id, rel, node.lineno,
                                f"{fn.qname} acquires {lock_id} while "
                                f"holding {held_id} "
                                f"({rel}:{node.lineno})"))
                        elif not reentrant:
                            self_deadlocks.append(Finding(
                                "lock-order", rel, node.lineno,
                                f"non-reentrant lock {lock_id} "
                                f".acquire()d while already held in "
                                f"{fn.qname}"))
            else:
                is_self_call = isinstance(fnode, ast.Attribute) and \
                    isinstance(fnode.value, ast.Name) and \
                    fnode.value.id == "self"
                for callee in model.resolve_call(fn, node):
                    if callee is fn:
                        continue
                    if is_self_call:
                        # a direct self.m() runs on the SAME instance:
                        # the callee re-acquiring a held non-reentrant
                        # lock is a guaranteed self-deadlock, not a
                        # cross-instance maybe
                        for site in model.lock_sites_by_fn.get(
                                callee.qname, ()):
                            if not site.reentrant and any(
                                        h == site.lock_id
                                        for h, _ in held):
                                self_deadlocks.append(Finding(
                                    "lock-order", rel, node.lineno,
                                    f"{fn.qname} holds "
                                    f"{site.lock_id} and calls "
                                    f"{callee.qname}, which "
                                    f"re-acquires it "
                                    f"({callee.module.rel}:"
                                    f"{site.line}) — guaranteed "
                                    f"self-deadlock (same instance, "
                                    f"non-reentrant lock)"))
                    for (lock_id, arel, aline) in _transitive_acquires(
                            model, callee, memo, set())[0]:
                        for held_id, _ in held:
                            if held_id == lock_id:
                                # same CLASS-level lock id through a
                                # non-self call: may be another
                                # instance — not provably a cycle
                                continue
                            edges.append(_Edge(
                                held_id, lock_id, rel, node.lineno,
                                f"{fn.qname} holds {held_id} and "
                                f"calls {callee.qname} "
                                f"({rel}:{node.lineno}) which "
                                f"acquires {lock_id} "
                                f"({arel}:{aline})"))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for child in ast.iter_child_nodes(fn.node):
        visit(child, [])


def _cycles(edges: List[_Edge]) -> List[List[_Edge]]:
    """Tarjan SCCs over the lock graph; any SCC with >1 node (or a
    2-node mutual pair) is a potential deadlock.  Returns one edge
    list per cyclic SCC (evidence, deduped per src->dst pair)."""
    adj: Dict[str, Dict[str, _Edge]] = {}
    for e in edges:
        adj.setdefault(e.src, {}).setdefault(e.dst, e)
        adj.setdefault(e.dst, {})
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v: str):
        # iterative Tarjan: (node, child-iterator) frames
        frames = [(v, iter(adj.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while frames:
            node, it = frames[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    frames.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            frames.pop()
            if frames:
                parent = frames[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(scc)

    for v in list(adj):
        if v not in index:
            strongconnect(v)
    out = []
    for scc in sccs:
        members = set(scc)
        evid = [e for d in scc for e in adj[d].values()
                if e.dst in members]
        out.append(evid)
    return out


@rule("lock-order",
      "inter-procedural lock-acquisition cycle (potential deadlock)")
def check_lock_order(model: ProgramModel) -> List[Finding]:
    memo: Dict[str, Set[Tuple[str, str, int]]] = {}
    edges: List[_Edge] = []
    findings: List[Finding] = []
    for fn in model.functions.values():
        _scan_function(model, fn, memo, edges, findings)
    for evid in _cycles(edges):
        evid.sort(key=lambda e: (e.rel, e.line))
        locks = sorted({e.src for e in evid} | {e.dst for e in evid})
        why = "; ".join(e.why for e in evid[:4])
        anchor = evid[0]
        findings.append(Finding(
            "lock-order", anchor.rel, anchor.line,
            f"lock-order cycle over {{{', '.join(locks)}}} — two "
            f"threads taking these locks in opposite orders deadlock: "
            f"{why}"))
    return findings
