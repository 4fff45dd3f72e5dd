"""Shared program model for the whole-program analysis plane.

Counterpart of paimon_tpu/analysis/model.py.  Per-function lints cannot
see ACROSS functions, so the bug classes that bite a
five-concurrency-plane architecture (lock-order inversions, a blocking
call reachable from the event-loop thread, a wait that ignores the
request deadlines) need one model of the whole package.

This module parses each source file exactly ONCE into a `ProgramModel`:

* `modules` — source + AST per file (`SourceModule`), keyed by the
  package-relative posix path (`utils/backoff.py`), so rules written
  against the real tree also run unchanged over fixture packages;
* `functions` / `classes` — every def/class with a stable qualified
  name (`fs/caching.py::BlockCache.get`), per-class self-assigned
  attribute sets (for lock ownership), and base-class links;
* a CONSERVATIVE call graph: `self.m()` resolves through the class and
  its in-package bases, bare names through local defs and from-imports,
  `mod.f()` through import aliases, and `self.X.m()` through the
  constructor type `__init__` assigned to `self.X` — anything the
  model cannot pin down stays unresolved, because a phantom call edge
  is worse than a missed one for every rule built on the graph;
* a lock-site index: every `with <lock-like>:` and `.acquire()` call,
  with lock IDENTITY canonicalised to the class that assigns the
  attribute (so `B(A)` methods and `A` methods agree on `A._lock`) and
  `threading.Condition(self._lock)` aliased to its underlying lock;
* the `# lint-ok: <rule> <reason>` suppression markers
  (engine.py consumes these; a marker that suppresses nothing is
  itself a finding).

Rules receive the model and never touch the filesystem again: one
parse per file per run.  Each module's `ast.walk` list and each
function's body walk are taken once and shared by the rules
(`SourceModule.nodes`, `FunctionInfo.body_nodes`), as are the lock
sites by function (`ProgramModel.lock_sites_by_fn`).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["SourceModule", "FunctionInfo", "ClassInfo", "LockSite",
           "Suppression", "ProgramModel", "build_model", "dotted_name",
           "except_names", "iter_function_nodes", "LOCKLIKE_RE"]

# last attribute segment that makes a `with`-target / `.acquire()`
# receiver count as a lock: _lock, lock, _build_lock, _cond, rlock,
# _sem, mutex ... ("cond" must terminate the name so `second` is not
# a lock)
LOCKLIKE_RE = re.compile(
    r"(?:^|_)(?:r?lock|cond(?:ition)?|mutex|sem(?:aphore)?)$",
    re.IGNORECASE)

_SUPPRESS_RE = re.compile(r"#\s*lint-ok:\s*([A-Za-z0-9_-]+)\s*(.*)$")


def iter_function_nodes(fn_node: ast.AST):
    """Walk a function body WITHOUT descending into nested
    def/class scopes — a nested def's body runs when the closure is
    called (often on another thread), so attributing its lock
    acquisitions or calls to the enclosing function would invent
    held-lock edges the program never takes.  Nested defs are
    registered as their own FunctionInfos and analysed separately."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _nested_stmt_bodies(node: ast.stmt) -> List[list]:
    """The statement lists nested inside a compound statement (loop
    bodies, if/else branches, try/except/else/finally, with bodies) —
    everywhere a def can legally appear outside a new scope."""
    if isinstance(node, (ast.If, ast.For, ast.AsyncFor, ast.While)):
        return [node.body, node.orelse]
    if isinstance(node, (ast.With, ast.AsyncWith)):
        return [node.body]
    if isinstance(node, ast.Try):
        return [node.body, node.orelse, node.finalbody] \
            + [h.body for h in node.handlers]
    return []


def except_names(type_node: Optional[ast.AST]) -> List[str]:
    """Exception-class simple names an `except` clause catches —
    `["<bare>"]` for a bare except, the last attribute segment for
    dotted names, tuple clauses flattened."""
    if type_node is None:
        return ["<bare>"]
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) \
        else [type_node]
    out = []
    for n in nodes:
        name = n.id if isinstance(n, ast.Name) else \
            n.attr if isinstance(n, ast.Attribute) else None
        if name:
            out.append(name)
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Suppression:
    """One `# lint-ok: <rule> <reason>` marker.  A marker on a
    comment-only line covers the next CODE line (the reason may wrap
    over following comment lines); a trailing marker covers its own
    line.  `consumed` flips when a finding matches — unconsumed
    markers are stale (engine emits them as findings)."""

    __slots__ = ("rule", "reason", "line", "applies_to", "consumed")

    def __init__(self, rule: str, reason: str, line: int,
                 applies_to: int):
        self.rule = rule
        self.reason = reason
        self.line = line              # where the marker itself sits
        self.applies_to = applies_to  # the line it exempts
        self.consumed = False


class SourceModule:
    """One parsed file: source, split lines, AST, import map,
    suppression markers."""

    __slots__ = ("rel", "pkg_rel", "path", "source", "lines", "tree",
                 "imports", "suppressions", "nodes")

    def __init__(self, rel: str, pkg_rel: str, path: str, source: str,
                 tree: ast.Module):
        self.rel = rel          # repo-relative (display): paimon_tpu_torch/x.py
        self.pkg_rel = pkg_rel  # package-relative (rule scoping): x.py
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # local name -> dotted target ("paimon_tpu_torch.utils.backoff" or
        # "paimon_tpu_torch.utils.backoff.Backoff")
        self.imports: Dict[str, str] = {}
        self.suppressions: List[Suppression] = []
        # every node of the tree in ast.walk order, walked once and
        # shared by the rules
        self.nodes: List[ast.AST] = list(ast.walk(tree))

    def suppression_for(self, rule: str, line: int) \
            -> Optional[Suppression]:
        for s in self.suppressions:
            if s.rule == rule and s.applies_to == line:
                return s
        return None


class FunctionInfo:
    __slots__ = ("module", "node", "name", "class_name", "qname",
                 "_callees", "_body")

    def __init__(self, module: SourceModule, node: ast.AST,
                 name: str, class_name: Optional[str]):
        self.module = module
        self.node = node
        self.name = name
        self.class_name = class_name
        owner = f"{class_name}.{name}" if class_name else name
        self.qname = f"{module.pkg_rel}::{owner}"
        self._callees: Optional[List["FunctionInfo"]] = None
        self._body: Optional[List[ast.AST]] = None

    @property
    def body_nodes(self) -> List[ast.AST]:
        """`iter_function_nodes(self.node)`, walked once and shared by
        the rules."""
        if self._body is None:
            self._body = list(iter_function_nodes(self.node))
        return self._body

    def __repr__(self):
        return f"FunctionInfo({self.qname})"


class ClassInfo:
    __slots__ = ("module", "name", "bases", "methods", "self_attrs",
                 "cond_aliases", "reentrant_attrs", "attr_classes")

    def __init__(self, module: SourceModule, name: str,
                 bases: List[str]):
        self.module = module
        self.name = name
        self.bases = bases                       # base-class simple names
        self.methods: Dict[str, FunctionInfo] = {}
        self.self_attrs: Set[str] = set()        # attrs assigned on self
        # self.<cond> -> "self.<lock>" for Condition(self._lock)
        self.cond_aliases: Dict[str, str] = {}
        self.reentrant_attrs: Set[str] = set()   # threading.RLock()
        # self.X = SomeClass(...) -> {"X": "SomeClass"}: lets
        # `self.X.m()` resolve to SomeClass.m when SomeClass is an
        # in-package class (resolved lazily — classes fill as modules
        # index)
        self.attr_classes: Dict[str, str] = {}


class LockSite:
    """One lock acquisition: a `with <lock>:` or `<lock>.acquire()`."""

    __slots__ = ("fn", "lock_id", "line", "kind", "reentrant")

    def __init__(self, fn: FunctionInfo, lock_id: str, line: int,
                 kind: str, reentrant: bool):
        self.fn = fn
        self.lock_id = lock_id
        self.line = line
        self.kind = kind            # "with" | "acquire"
        self.reentrant = reentrant


class ProgramModel:
    """The parse-once view every rule runs over."""

    def __init__(self, repo_root: str, package_dir: str,
                 package_name: str):
        self.repo_root = repo_root
        self.package_dir = package_dir
        self.package_name = package_name
        self.modules: Dict[str, SourceModule] = {}   # by pkg_rel
        self.functions: Dict[str, FunctionInfo] = {}  # by qname
        self.functions_by_name: Dict[str, List[FunctionInfo]] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}  # by simple name
        self.lock_sites: List[LockSite] = []
        self.lock_sites_by_fn: Dict[str, List[LockSite]] = {}

    # -- construction --------------------------------------------------------

    def _add_function(self, fn: FunctionInfo):
        if fn.qname in self.functions:
            # a nested def shadowing a method name (or two same-named
            # nested defs) must not overwrite the earlier entry —
            # rules iterate self.functions, so an overwrite would
            # silently drop a whole function body from every check
            n = 2
            while f"{fn.qname}#{n}" in self.functions:
                n += 1
            fn.qname = f"{fn.qname}#{n}"
        self.functions[fn.qname] = fn
        self.functions_by_name.setdefault(fn.name, []).append(fn)

    def _index_module(self, mod: SourceModule):
        # imports
        pkg_dotted = self.package_name
        for node in mod.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    mod.imports[alias.asname
                                or alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:          # relative: anchor in the package
                    rel_dir = os.path.dirname(mod.pkg_rel).replace(
                        os.sep, "/")
                    parts = [p for p in rel_dir.split("/") if p]
                    parts = parts[:len(parts) - (node.level - 1)] \
                        if node.level > 1 else parts
                    base = ".".join([pkg_dotted] + parts
                                    + ([node.module] if node.module
                                       else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    mod.imports[alias.asname or alias.name] = \
                        f"{base}.{alias.name}" if base else alias.name
        # suppression markers — taken from real COMMENT tokens only,
        # so `# lint-ok:` inside a docstring or string literal (this
        # plane's own documentation, a fixture snippet embedded in a
        # test string) never becomes a live marker
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(mod.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                i = tok.start[0]
                applies_to = i
                if mod.lines[i - 1].strip().startswith("#"):
                    # comment-only marker: exempt the next CODE line
                    # (the reason may wrap onto further comment lines)
                    applies_to = i + 1
                    while applies_to <= len(mod.lines) and (
                            not mod.lines[applies_to - 1].strip()
                            or mod.lines[applies_to - 1]
                            .strip().startswith("#")):
                        applies_to += 1
                mod.suppressions.append(Suppression(
                    m.group(1), m.group(2).strip(), i, applies_to))
        except tokenize.TokenError:
            pass
        # defs / classes
        self._index_scope(mod, mod.tree.body, class_name=None)

    def _index_scope(self, mod: SourceModule, body, class_name,
                     in_function: bool = False):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = FunctionInfo(mod, node, node.name, class_name)
                self._add_function(fn)
                if class_name is not None and not in_function:
                    # only CLASS-BODY defs are methods: a def nested
                    # inside a method is a closure — registering it
                    # would let `self.<name>()` resolve to it (phantom
                    # call edges, false self-deadlocks).  It still
                    # keeps class_name so `self._lock` inside the
                    # closure canonicalises like the enclosing method.
                    for ci in self.classes.get(class_name, []):
                        if ci.module is mod:
                            ci.methods[node.name] = fn
                # nested defs resolve by bare name within the module
                self._index_scope(mod, node.body, class_name,
                                  in_function=True)
            elif isinstance(node, ast.ClassDef):
                bases = [dotted_name(b).split(".")[-1]
                         for b in node.bases if dotted_name(b)]
                ci = ClassInfo(mod, node.name, bases)
                self.classes.setdefault(node.name, []).append(ci)
                self._index_scope(mod, node.body, node.name)
                self._collect_class_attrs(ci, node)
            else:
                # a def can hide in ANY compound statement (loop
                # bodies, except handlers, else/finally) — missing one
                # makes the function invisible to every rule
                for sub in _nested_stmt_bodies(node):
                    self._index_scope(mod, sub, class_name, in_function)

    def _collect_class_attrs(self, ci: ClassInfo, cls: ast.ClassDef):
        """`self.X = ...` targets, Condition-over-lock aliases, and
        RLock attrs for every method of the class."""
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                ci.self_attrs.add(tgt.attr)
                val = node.value
                if not isinstance(val, ast.Call):
                    continue
                ctor = dotted_name(val.func) or ""
                ctor_tail = ctor.split(".")[-1]
                if ctor_tail == "RLock":
                    ci.reentrant_attrs.add(tgt.attr)
                elif ctor_tail == "Condition" and val.args:
                    arg = dotted_name(val.args[0])
                    if arg and arg.startswith("self."):
                        ci.cond_aliases[tgt.attr] = arg
                elif ctor_tail and ctor_tail[0].isupper():
                    ci.attr_classes[tgt.attr] = ctor_tail

    # -- class / lock resolution ---------------------------------------------

    def _class_chain(self, name: Optional[str],
                     mod: SourceModule) -> List[ClassInfo]:
        """The class and its in-package bases (module-local ClassInfo
        preferred), breadth-first, cycle-safe."""
        out: List[ClassInfo] = []
        seen: Set[str] = set()
        queue = [name] if name else []
        while queue:
            nm = queue.pop(0)
            if nm in seen:
                continue
            seen.add(nm)
            infos = self.classes.get(nm, [])
            local = [c for c in infos if c.module is mod]
            for ci in (local or infos):
                out.append(ci)
                queue.extend(ci.bases)
        return out

    def lock_identity(self, fn: FunctionInfo,
                      dotted: str) -> Tuple[str, bool]:
        """(lock_id, reentrant) for a lock expression in `fn`.

        `self.X` canonicalises to the BASE-most in-package class that
        assigns X (so a subclass method and the defining class agree),
        and `self.<cond>` follows a `Condition(self._lock)` alias to
        the underlying lock.  Anything else is scoped to the module.
        """
        if dotted.startswith("self.") and fn.class_name:
            attr = dotted.split(".", 1)[1]
            chain = self._class_chain(fn.class_name, fn.module)
            # follow a Condition alias first (nearest class wins)
            for ci in chain:
                alias = ci.cond_aliases.get(attr.split(".")[0])
                if alias:
                    attr = alias.split(".", 1)[1]
                    break
            owner = fn.class_name
            owner_mod = fn.module
            reentrant = False
            for ci in chain:            # base-most assigner wins
                if attr.split(".")[0] in ci.self_attrs:
                    owner, owner_mod = ci.name, ci.module
                    reentrant = attr.split(".")[0] in ci.reentrant_attrs
            return f"{owner_mod.pkg_rel}::{owner}.{attr}", reentrant
        return f"{fn.module.pkg_rel}::{dotted}", False

    # -- call graph ----------------------------------------------------------

    def _module_for(self, dotted: str) -> Optional[SourceModule]:
        """SourceModule for a dotted import path inside the package."""
        prefix = self.package_name + "."
        if dotted == self.package_name:
            return self.modules.get("__init__.py")
        if not dotted.startswith(prefix):
            return None
        tail = dotted[len(prefix):].replace(".", "/")
        return self.modules.get(f"{tail}.py") \
            or self.modules.get(f"{tail}/__init__.py")

    def _module_functions(self, mod: SourceModule,
                          name: str) -> List[FunctionInfo]:
        return [f for f in self.functions_by_name.get(name, [])
                if f.module is mod]

    def resolve_call(self, fn: FunctionInfo,
                     call: ast.Call) -> List[FunctionInfo]:
        """Possible in-package targets of `call` made from `fn` —
        conservative: empty when the target cannot be pinned down."""
        func = call.func
        mod = fn.module
        if isinstance(func, ast.Name):
            nm = func.id
            local = self._module_functions(mod, nm)
            if local:
                return local
            target = mod.imports.get(nm)
            if target:
                # `from m import f` -> f in module m; or a re-export
                owner = self._module_for(
                    target.rsplit(".", 1)[0]) if "." in target else None
                if owner is not None:
                    return self._module_functions(
                        owner, target.rsplit(".", 1)[1])
            return []
        if not isinstance(func, ast.Attribute):
            return []
        attr = func.attr
        base = func.value
        if isinstance(base, ast.Name):
            if base.id == "self" and fn.class_name:
                for ci in self._class_chain(fn.class_name, mod):
                    if attr in ci.methods:
                        return [ci.methods[attr]]
                return []
            if base.id in ("cls", fn.class_name or ""):
                for ci in self._class_chain(fn.class_name, mod):
                    if attr in ci.methods:
                        return [ci.methods[attr]]
            # imported module alias:  backoff.wait_for(...)
            target = mod.imports.get(base.id)
            if target:
                owner = self._module_for(target)
                if owner is not None:
                    return self._module_functions(owner, attr)
                # a known import that is NOT a package module
                # (threading.Thread, np.argsort, ...): never fall
                # through to uniqueness guessing
                return []
            # class name used directly:  BlockCache.evict(...)
            if base.id in self.classes:
                for ci in self.classes[base.id]:
                    if attr in ci.methods:
                        return [ci.methods[attr]]
                return []
        # `self.X.m(...)` where __init__ recorded self.X = SomeClass():
        # resolve through the attribute's constructor type.  Anything
        # else stays UNRESOLVED — guessing a target for `x.get()` /
        # `sel.unregister()` by name uniqueness invents call edges the
        # program never takes (and phantom reachability is worse than
        # a missed edge for every rule built on this graph).
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and fn.class_name:
            for ci in self._class_chain(fn.class_name, mod):
                cls = ci.attr_classes.get(base.attr)
                if cls is None:
                    continue
                for target_ci in self.classes.get(cls, []):
                    if attr in target_ci.methods:
                        return [target_ci.methods[attr]]
                break
        return []

    def callees(self, fn: FunctionInfo) -> List[FunctionInfo]:
        if fn._callees is None:
            out: List[FunctionInfo] = []
            seen: Set[str] = set()
            for node in fn.body_nodes:
                if isinstance(node, ast.Call):
                    for tgt in self.resolve_call(fn, node):
                        if tgt.qname not in seen and tgt is not fn:
                            seen.add(tgt.qname)
                            out.append(tgt)
            fn._callees = out
        return fn._callees

    def reachable(self, roots: Iterable[FunctionInfo]) \
            -> Dict[str, Tuple[FunctionInfo, Optional[str]]]:
        """BFS closure over the call graph: qname -> (fn, parent
        qname) — parents give a readable path for findings."""
        out: Dict[str, Tuple[FunctionInfo, Optional[str]]] = {}
        queue: List[FunctionInfo] = []
        for r in roots:
            if r.qname not in out:
                out[r.qname] = (r, None)
                queue.append(r)
        while queue:
            fn = queue.pop(0)
            for tgt in self.callees(fn):
                if tgt.qname not in out:
                    out[tgt.qname] = (tgt, fn.qname)
                    queue.append(tgt)
        return out

    def call_path(self, reach, qname: str) -> str:
        """`root -> a -> b` chain text from a `reachable` map."""
        parts = []
        cur: Optional[str] = qname
        while cur is not None:
            parts.append(cur.split("::")[-1])
            cur = reach[cur][1]
        return " -> ".join(reversed(parts))

    # -- per-function enclosing lookup ---------------------------------------

    def enclosing_function(self, mod: SourceModule,
                           line: int) -> Optional[FunctionInfo]:
        best: Optional[FunctionInfo] = None
        for fn in self.functions.values():
            if fn.module is not mod:
                continue
            node = fn.node
            if node.lineno <= line <= (node.end_lineno or node.lineno):
                if best is None or node.lineno > best.node.lineno:
                    best = fn
        return best


def _iter_py_files(package_dir: str):
    for root, dirs, files in os.walk(package_dir):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _add_lock_site(model: ProgramModel, site: LockSite):
    model.lock_sites.append(site)
    model.lock_sites_by_fn.setdefault(site.fn.qname, []).append(site)


def _collect_lock_sites(model: ProgramModel):
    """Every `with <lock-like>:` and `<lock-like>.acquire()` in every
    function — THE index the lock-order and event-loop rules share."""
    for fn in list(model.functions.values()):
        for node in fn.body_nodes:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    d = dotted_name(item.context_expr)
                    if d and LOCKLIKE_RE.search(d.split(".")[-1]):
                        lock_id, reent = model.lock_identity(fn, d)
                        _add_lock_site(model, LockSite(
                            fn, lock_id, node.lineno, "with", reent))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                d = dotted_name(node.func.value)
                if d and LOCKLIKE_RE.search(d.split(".")[-1]):
                    lock_id, reent = model.lock_identity(fn, d)
                    _add_lock_site(model, LockSite(
                        fn, lock_id, node.lineno, "acquire", reent))


def build_model(package_dir: str,
                repo_root: Optional[str] = None) -> ProgramModel:
    """Parse every .py under `package_dir` once and index it.

    `package_dir` is the package root (the directory whose name is the
    import name — `paimon_tpu_torch/` in production, a tmp package in rule
    fixtures); `repo_root` defaults to its parent and only affects the
    repo-relative display paths.
    """
    package_dir = os.path.abspath(package_dir)
    if repo_root is None:
        repo_root = os.path.dirname(package_dir)
    model = ProgramModel(repo_root, package_dir,
                         os.path.basename(package_dir))
    for path in _iter_py_files(package_dir):
        pkg_rel = os.path.relpath(path, package_dir).replace(os.sep, "/")
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        mod = SourceModule(rel, pkg_rel, path, source,
                           ast.parse(source, rel))
        model.modules[pkg_rel] = mod
    for mod in model.modules.values():
        model._index_module(mod)
    _collect_lock_sites(model)
    return model
