"""The seven hygiene lints.

Counterpart of paimon_tpu/analysis/rules/hygiene.py.  Four rules
(swallow, threads, sleeps, sockets) are the reference's, message for
message.  Three name the distributed and kernel spellings of the
reference's stack, and here name their torch counterparts:

* collectives — the host-level `torch.distributed` collectives over
  the default group (`barrier`, `broadcast`, `broadcast_object_list`,
  `all_gather`, `all_gather_object`) outside parallel/multihost.py.
  Flagged: an import of one of those names from `torch.distributed`
  (or a submodule), and a call of one, by attribute on a name bound to
  `torch.distributed` (`dist.barrier()`, `torch.distributed.barrier()`)
  or by an imported bare name, that passes no process group — no
  `group=` keyword and no positional group — or passes `None` or a
  `*.group.WORLD` attribute.  A call that passes any other group (a
  mesh's own `group=self.group`) is a collective inside a mesh
  program, the counterpart of the reference's collectives inside
  `shard_map`, and is not flagged;
* distributed-init — `torch.distributed.init_process_group` outside
  parallel/multihost.py: importing the name from `torch.distributed`,
  or calling it by attribute on a name bound to `torch.distributed` or
  by an imported bare name;
* host-materialization — `np.asarray(...)`, `.tolist()`, `.cpu()`,
  `.numpy()` and `.item()` inside the device-kernel modules
  ops/decode.py and ops/kernels.py.

Exemptions are `# lint-ok: <rule> <reason>` markers at the exempted
site, so adding one is a reviewed diff on the line it exempts and a
stale one is itself a finding.
"""

from __future__ import annotations

import ast
from typing import List

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import (
    ProgramModel, dotted_name, except_names,
)

_BROAD = {"Exception", "BaseException", "<bare>"}


def _broad_names(type_node):
    return [n for n in except_names(type_node) if n in _BROAD]


@rule("swallow",
      "silent broad-exception swallowing")
def check_swallow(model: ProgramModel) -> List[Finding]:
    """An `except Exception: pass` (or bare except / continue body)
    hides every error class — including the transient faults the
    maintenance plane must retry or propagate (parallel/fault.py).
    Narrow typed catches are out of scope: they are deliberate, local
    decisions.  Genuine best-effort paths carry a
    `# lint-ok: swallow <reason>` on the except line."""
    out = []
    for mod in model.modules.values():
        for node in mod.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if len(node.body) != 1 or not isinstance(
                    node.body[0], (ast.Pass, ast.Continue)):
                continue
            if not _broad_names(node.type):
                continue
            fn = model.enclosing_function(mod, node.lineno)
            where = fn.qname.split("::")[-1] if fn else "<module>"
            out.append(Finding(
                "swallow", mod.rel, node.lineno,
                f"silent broad except in {where}: handle the error, "
                f"propagate it, or mark the reviewed best-effort path "
                f"with `# lint-ok: swallow <reason>`"))
    return out


@rule("threads",
      "bare threading.Thread outside parallel/")
def check_threads(model: ProgramModel) -> List[Finding]:
    """All threads and pools go through parallel/executors.py
    (spawn_thread / new_thread_pool) so every worker carries an
    attributable name and the no-leaked-thread tests can key
    on it."""
    out = []
    for mod in model.modules.values():
        if mod.pkg_rel.startswith("parallel/"):
            continue               # the one reviewed home of threads
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name == "Thread":
                out.append(Finding(
                    "threads", mod.rel, node.lineno,
                    "bare threading.Thread( outside parallel/ — use "
                    "parallel/executors.py spawn_thread/"
                    "new_thread_pool so the thread is named and "
                    "reviewable"))
    return out


@rule("sleeps",
      "bare time.sleep outside utils/backoff.py")
def check_sleeps(model: ProgramModel) -> List[Finding]:
    """Every wait in library code must be deadline-aware and
    injectable — `Backoff.pause()` for retry ladders, `wait_for()`
    for one-shot waits.  A bare sleep is an un-interruptible stall a
    timed-out request cannot escape.  Injectable sleeps stored as
    attributes (`self._sleep(...)`) are fine — only direct
    `time.sleep` / `from time import sleep` CALLS are flagged."""
    out = []
    for mod in model.modules.values():
        if mod.pkg_rel == "utils/backoff.py":
            continue          # the one reviewed home of real sleeps
        time_sleep_names = set()
        for node in mod.nodes:
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "time":
                for alias in node.names:
                    if alias.name == "sleep":
                        time_sleep_names.add(alias.asname or alias.name)
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            hit = (isinstance(fn, ast.Attribute) and
                   fn.attr == "sleep" and
                   isinstance(fn.value, ast.Name) and
                   fn.value.id in ("time", "_time")) or \
                  (isinstance(fn, ast.Name) and
                   fn.id in time_sleep_names)
            if hit:
                out.append(Finding(
                    "sleeps", mod.rel, node.lineno,
                    "bare time.sleep( outside utils/backoff.py — use "
                    "Backoff.pause() for retry ladders or "
                    "utils.backoff.wait_for() for one-shot waits"))
    return out


_NET_MODULES = {"socket", "selectors"}


@rule("sockets",
      "raw socket/selectors import outside service/async_server.py")
def check_sockets(model: ProgramModel) -> List[Finding]:
    """The event-loop request engine is the ONE reviewed home of
    non-blocking socket code: its loop owns every fd, bounds
    connections and pipelining, measures loop lag and shuts down
    cleanly.  HTTP clients use http.client, servers use
    service/async_server.AsyncHttpServer."""
    out = []
    for mod in model.modules.values():
        if mod.pkg_rel == "service/async_server.py":
            continue          # the one reviewed home of raw sockets
        for node in mod.nodes:
            hit = False
            if isinstance(node, ast.Import):
                hit = any(a.name.split(".")[0] in _NET_MODULES
                          for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                hit = bool(node.module) and \
                    node.module.split(".")[0] in _NET_MODULES
            if hit:
                out.append(Finding(
                    "sockets", mod.rel, node.lineno,
                    "raw socket/selectors import outside "
                    "service/async_server.py — ad-hoc network loops "
                    "are banned: serve through AsyncHttpServer and "
                    "talk HTTP through http.client"))
    return out


# torch.distributed collective -> index of its positional `group`
_COLLECTIVES = {"barrier": 0, "broadcast": 2, "broadcast_object_list": 2,
                "all_gather": 2, "all_gather_object": 2}
_DIST = "torch.distributed"


def _dist_aliases(mod) -> set:
    """Local names bound to the torch.distributed module: `import
    torch` binds `torch` (spelled `torch.distributed.x`), `import
    torch.distributed as dist` and `from torch import distributed`
    bind the module itself.  Returns dotted spellings of it."""
    out = set()
    for node in mod.nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == _DIST and alias.asname:
                    out.add(alias.asname)
                elif alias.name.split(".")[0] == "torch" \
                        and not alias.asname:
                    out.add(_DIST)
                elif alias.name == "torch" and alias.asname:
                    out.add(f"{alias.asname}.distributed")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for alias in node.names:
                if alias.name == "distributed":
                    out.add(alias.asname or alias.name)
    return out


def _from_dist(node: ast.ImportFrom) -> bool:
    return bool(node.module) and (node.module == _DIST or
                                  node.module.startswith(_DIST + "."))


def _dist_call_name(fn, aliases: set, bound: dict) -> str:
    """The torch.distributed function a call's `func` names, or ''."""
    if isinstance(fn, ast.Attribute) and \
            dotted_name(fn.value) in aliases:
        return fn.attr
    if isinstance(fn, ast.Name):
        return bound.get(fn.id, "")
    return ""


def _default_group(call: ast.Call, pos: int) -> bool:
    """True when the call runs over the default group: no group given,
    or `None`, or `<...>.group.WORLD`."""
    g = None
    for kw in call.keywords:
        if kw.arg == "group":
            g = kw.value
    if g is None and len(call.args) > pos:
        g = call.args[pos]
    if g is None:
        return True
    if isinstance(g, ast.Constant) and g.value is None:
        return True
    d = dotted_name(g) or ""
    return d == "WORLD" or d.endswith("group.WORLD")


@rule("collectives",
      "raw multihost collectives outside parallel/multihost.py")
def check_collectives(model: ProgramModel) -> List[Finding]:
    """multihost.py's barrier() / broadcast_value() /
    allgather_bytes() are the ONE reviewed wrap: deadline-checked,
    barrier_wait_ms-instrumented, degrading to single-process no-ops.
    A raw torch.distributed collective over the default group
    elsewhere gets none of that — and a hung collective with a dead
    peer is exactly the failure the lease-based maintenance plane
    exists to tolerate."""
    out = []
    for mod in model.modules.values():
        if mod.pkg_rel == "parallel/multihost.py":
            continue        # the one reviewed home of collectives
        aliases = _dist_aliases(mod)
        bound = {}
        for node in mod.nodes:
            if isinstance(node, ast.ImportFrom) and _from_dist(node):
                for alias in node.names:
                    if alias.name in _COLLECTIVES:
                        bound[alias.asname or alias.name] = alias.name
                        out.append(Finding(
                            "collectives", mod.rel, node.lineno,
                            f"raw {alias.name} import outside "
                            f"parallel/multihost.py — use the "
                            f"deadline-bounded multihost wrappers"))
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = _dist_call_name(node.func, aliases, bound)
            if name in _COLLECTIVES and \
                    _default_group(node, _COLLECTIVES[name]):
                out.append(Finding(
                    "collectives", mod.rel, node.lineno,
                    "raw multihost collective call outside "
                    "parallel/multihost.py — use multihost.barrier() "
                    "/ broadcast_value() / allgather_bytes()"))
    return out


@rule("distributed-init",
      "torch.distributed.init_process_group outside "
      "parallel/multihost.py")
def check_distributed_init(model: ProgramModel) -> List[Finding]:
    """multihost.initialize is the ONE reviewed bring-up: it reads the
    coordinator, world size and rank, sets the peer-death tolerance,
    and warns when the torch build has no Gloo backend before the
    group comes up; a direct init_process_group elsewhere bypasses
    all of that."""
    out = []
    for mod in model.modules.values():
        if mod.pkg_rel == "parallel/multihost.py":
            continue        # the one reviewed bring-up path
        aliases = _dist_aliases(mod)
        bound = {}
        for node in mod.nodes:
            if isinstance(node, ast.ImportFrom) and _from_dist(node):
                for alias in node.names:
                    if alias.name == "init_process_group":
                        bound[alias.asname or alias.name] = alias.name
                        out.append(Finding(
                            "distributed-init", mod.rel, node.lineno,
                            "direct import of torch.distributed."
                            "init_process_group outside "
                            "parallel/multihost.py — use "
                            "multihost.initialize()"))
        for node in mod.nodes:
            if isinstance(node, ast.Call) and _dist_call_name(
                    node.func, aliases, bound) == "init_process_group":
                out.append(Finding(
                    "distributed-init", mod.rel, node.lineno,
                    "direct torch.distributed.init_process_group( "
                    "outside parallel/multihost.py — use "
                    "multihost.initialize(), which joins the gloo "
                    "group with the fleet's coordinator and "
                    "peer-death settings"))
    return out


# device-kernel modules whose bodies must stay on the device: a host
# materialization here silently reintroduces the round-trip the device
# decode plane exists to remove (the host boundary lives in
# format/rawpage.py, which orchestrates these kernels)
_KERNEL_MODULES = ("ops/decode.py", "ops/kernels.py")
_TO_HOST = frozenset({"tolist", "cpu", "numpy", "item"})


@rule("host-materialization",
      "host materialization inside a device-kernel module")
def check_host_materialization(model: ProgramModel) -> List[Finding]:
    """`np.asarray(...)` / `.tolist()` / `.cpu()` / `.numpy()` /
    `.item()` inside ops/decode.py or ops/kernels.py — keep the work
    on the device and materialize at the format/rawpage.py boundary
    instead, or mark a reviewed exception with
    `# lint-ok: host-materialization <reason>`."""
    out = []
    for pkg_rel in _KERNEL_MODULES:
        mod = model.modules.get(pkg_rel)
        if mod is None:
            continue
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            hit = (fn.attr == "asarray"
                   and isinstance(fn.value, ast.Name)
                   and fn.value.id in ("np", "numpy")) \
                or fn.attr in _TO_HOST
            if hit:
                out.append(Finding(
                    "host-materialization", mod.rel, node.lineno,
                    "host materialization (np.asarray / .tolist() / "
                    ".cpu() / .numpy() / .item()) inside a "
                    "device-kernel module — materialize at the "
                    "format/rawpage.py boundary instead"))
    return out
