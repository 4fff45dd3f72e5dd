"""SQL execution over Arrow compute with predicate pushdown into scans.

`SQLContext` is the analog of the reference's DataFusion-backed
SQLContext (pypaimon/sql/__init__.py) and of the statement surface the
JVM engines expose.  Queries compile to pyarrow.compute kernels; WHERE
conjuncts that mention a single base-table column with literals are
converted to paimon predicates and pushed into the scan (manifest/stats/
index pruning), with the full WHERE re-applied on the decoded batch so
pushdown is purely an optimization.

Counterpart of paimon_tpu/sql/executor.py.  A context runs on its
catalog's device: every table it reads, writes or compacts merges
there, the search procedures (full_text_search, vector_search,
hybrid_search, create_vector_index) included: their table reads and
their brute-force and IVF indexes run on that device.
"""

import re
from typing import Any, Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.compute as pc

from paimon_tpu_torch import predicate as P
from paimon_tpu_torch.catalog.catalog import Catalog, Identifier
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.schema.schema_manager import SchemaChange
from paimon_tpu_torch.sql import parser as ast
from paimon_tpu_torch.sql.parser import SQLError, parse
from paimon_tpu_torch.types import RowKind, parse_data_type

_AGG_FUNCS = {"count", "sum", "min", "max", "avg"}

# scalar builtins (Compiler._func) + window names: catalog UDFs never
# shadow these
_BUILTIN_FUNCS = _AGG_FUNCS | {
    "abs", "upper", "lower", "length", "char_length", "trim", "concat",
    "coalesce", "nullif", "round", "floor", "ceil", "sqrt", "power",
    "substr", "substring", "replace", "year", "month", "day", "hour",
    "minute", "second", "if", "variant_get", "row_number", "rank",
    "dense_rank", "lag", "lead", "first_value", "last_value",
    "array", "map",
}


def _result(rows: List[str], name: str = "result") -> pa.Table:
    return pa.table({name: pa.array(rows, pa.string())})


def _sort_indices(tbl: pa.Table, keys) -> pa.Array:
    """`pc.sort_indices` over `keys` = [(name, direction, placement)].

    Modern pyarrow (>= 16) accepts only (name, direction) 2-tuples with
    ONE table-wide `null_placement`; SQL ORDER BY carries per-key NULLS
    FIRST/LAST.  Uniform placements pass straight through; mixed
    placements sort by a prepended is-null indicator per key whose
    placement disagrees with the majority (True first = NULLS FIRST),
    which pyarrow cannot express natively.
    """
    placements = {pl for _, _, pl in keys}
    if len(placements) <= 1:
        return pc.sort_indices(
            tbl, sort_keys=[(n, d) for n, d, _ in keys],
            null_placement=placements.pop() if placements else "at_end")
    sort_keys, extra = [], {}
    for i, (name, direction, placement) in enumerate(keys):
        ind = f"__nulls{i}"
        extra[ind] = pc.is_null(tbl.column(name))
        # nulls-first == indicator True first == descending indicator
        sort_keys.append(
            (ind, "descending" if placement == "at_start"
             else "ascending"))
        sort_keys.append((name, direction))
    aug = tbl
    for cn, arr in extra.items():
        aug = aug.append_column(cn, arr)
    return pc.sort_indices(aug, sort_keys=sort_keys)


class Scope:
    """A resolved relation: an Arrow table whose columns are internally
    qualified ("alias.col"), plus the bare-name resolution map."""

    def __init__(self, table: pa.Table, order: List[str]):
        self.table = table
        self.order = order                      # qualified names, in order
        self.bare: Dict[str, List[str]] = {}
        for q in order:
            bare = q.split(".", 1)[1] if "." in q else q
            self.bare.setdefault(bare, []).append(q)

    def resolve(self, col: ast.Column) -> str:
        if col.qualifier:
            q = f"{col.qualifier}.{col.name}"
            if q in self.table.column_names:
                return q
            raise SQLError(f"unknown column {q}")
        cands = self.bare.get(col.name, [])
        if len(cands) == 1:
            return cands[0]
        if not cands:
            raise SQLError(f"unknown column {col.name!r}")
        raise SQLError(f"ambiguous column {col.name!r}: {cands}")


class Compiler:
    """Compile AST expressions to Arrow arrays against a Scope.  When
    `subst` is set (post-aggregation), any sub-expression whose repr is a
    key in it resolves to that column instead of being re-evaluated."""

    def __init__(self, scope: Scope, subst: Optional[Dict[str, str]] = None):
        self.scope = scope
        self.subst = subst or {}

    def _rows(self) -> int:
        return self.scope.table.num_rows

    def compile(self, e) -> Any:
        if self.subst:
            key = repr(e)
            if key in self.subst:
                return self.scope.table.column(self.subst[key])
        return self._compile(e)

    def as_array(self, e) -> pa.ChunkedArray:
        return self.broadcast(self.compile(e))

    def broadcast(self, v) -> pa.ChunkedArray:
        """Expand an already-compiled scalar across the relation."""
        if isinstance(v, (pa.ChunkedArray, pa.Array)):
            return v
        if not isinstance(v, pa.Scalar):
            v = pa.scalar(v)
        if v.type == pa.null():
            return pa.nulls(self._rows())
        return pa.chunked_array([pa.repeat(v, self._rows())])

    def _compile(self, e) -> Any:
        if isinstance(e, ast.Literal):
            return pa.scalar(e.value)
        if isinstance(e, ast.Column):
            return self.scope.table.column(self.scope.resolve(e))
        if isinstance(e, ast.Unary):
            v = self.compile(e.operand)
            return pc.invert(v) if e.op == "NOT" else pc.negate(v)
        if isinstance(e, ast.Binary):
            return self._binary(e)
        if isinstance(e, ast.IsNull):
            v = self.as_array(e.expr)
            return pc.is_valid(v) if e.negated else pc.is_null(v)
        if isinstance(e, ast.InList):
            v = self.as_array(e.expr)
            vals = [self._literal(x) for x in e.values]
            res = pc.is_in(v, value_set=pa.array(vals))
            return pc.invert(res) if e.negated else res
        if isinstance(e, ast.BetweenExpr):
            v = self.compile(e.expr)
            res = pc.and_kleene(
                pc.greater_equal(v, self.compile(e.lo)),
                pc.less_equal(v, self.compile(e.hi)))
            return pc.invert(res) if e.negated else res
        if isinstance(e, ast.LikeExpr):
            res = pc.match_like(self.as_array(e.expr), e.pattern)
            return pc.invert(res) if e.negated else res
        if isinstance(e, ast.Case):
            return self._case(e)
        if isinstance(e, ast.Cast):
            from paimon_tpu_torch.data.casting import cast_array
            from paimon_tpu_torch.types import data_type_from_arrow
            arr = self.as_array(e.expr)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            src = data_type_from_arrow(arr.type)
            return cast_array(arr, src, parse_data_type(e.type_str))
        if isinstance(e, ast.Func):
            return self._func(e)
        if isinstance(e, ast.Star):
            raise SQLError("* is only valid in SELECT items and COUNT(*)")
        raise SQLError(f"cannot evaluate expression: {e!r}")

    def _literal(self, e) -> Any:
        if isinstance(e, ast.Literal):
            return e.value
        if isinstance(e, ast.Unary) and e.op == "NEG" and \
                isinstance(e.operand, ast.Literal):
            return -e.operand.value
        raise SQLError(f"expected a literal, got {e!r}")

    def _binary(self, e: ast.Binary):
        op = e.op
        if op in ("AND", "OR"):
            l_, r_ = self.compile(e.left), self.compile(e.right)
            return (pc.and_kleene if op == "AND" else pc.or_kleene)(l_, r_)
        if op == "||":
            l_, r_ = self.as_array(e.left), self.as_array(e.right)
            return pc.binary_join_element_wise(
                pc.cast(l_, pa.string()), pc.cast(r_, pa.string()), "")
        l_, r_ = self.compile(e.left), self.compile(e.right)
        fn = {"+": pc.add, "-": pc.subtract, "*": pc.multiply,
              "/": pc.divide, "%": lambda a, b: pc.subtract(
                  a, pc.multiply(pc.cast(pc.divide(a, b), pa.int64()), b)),
              "=": pc.equal, "<>": pc.not_equal, "<": pc.less,
              "<=": pc.less_equal, ">": pc.greater,
              ">=": pc.greater_equal}.get(op)
        if fn is None:
            raise SQLError(f"unsupported operator {op}")
        return fn(l_, r_)

    def _case(self, e: ast.Case):
        result = self.as_array(e.default) if e.default is not None \
            else pa.nulls(self._rows())
        for cond, val in reversed(e.whens):
            c = self.as_array(cond)
            result = pc.if_else(pc.fill_null(c, False),
                                self.as_array(val), result)
        return result

    def _func(self, e: ast.Func):
        name, args = e.name, e.args
        if e.over is not None:
            raise SQLError(f"window function {name}() OVER is only "
                           f"allowed in SELECT items / ORDER BY")
        if name in _AGG_FUNCS:
            raise SQLError(f"aggregate {name}() not allowed here")
        a = [self.compile(x) for x in args]
        if name == "abs":
            return pc.abs(a[0])
        if name == "upper":
            return pc.utf8_upper(a[0])
        if name == "lower":
            return pc.utf8_lower(a[0])
        if name in ("length", "char_length"):
            return pc.utf8_length(a[0])
        if name == "trim":
            return pc.utf8_trim_whitespace(a[0])
        if name == "concat":
            arrs = [pc.cast(self.broadcast(v), pa.string()) for v in a]
            return pc.binary_join_element_wise(*arrs, "")
        if name == "coalesce":
            # NULL literals (type null) never contribute a value
            live = [x for x in a if x.type != pa.null()]
            if not live:
                return pa.nulls(self._rows())
            return live[0] if len(live) == 1 else pc.coalesce(*live)
        if name == "nullif":
            return pc.if_else(pc.fill_null(pc.equal(a[0], a[1]), False),
                              pa.nulls(self._rows()), self.broadcast(a[0]))
        if name == "round":
            nd = self._literal(args[1]) if len(args) > 1 else 0
            return pc.round(a[0], ndigits=nd)
        if name == "floor":
            return pc.floor(a[0])
        if name == "ceil":
            return pc.ceil(a[0])
        if name == "sqrt":
            return pc.sqrt(a[0])
        if name == "power":
            return pc.power(a[0], a[1])
        if name in ("substr", "substring"):
            start = self._literal(args[1]) - 1       # SQL is 1-based
            stop = start + self._literal(args[2]) if len(args) > 2 else None
            return pc.utf8_slice_codeunits(a[0], start, stop)
        if name == "replace":
            return pc.replace_substring(a[0],
                                        pattern=self._literal(args[1]),
                                        replacement=self._literal(args[2]))
        if name in ("year", "month", "day", "hour", "minute", "second"):
            return getattr(pc, name)(a[0])
        if name == "if":
            return pc.if_else(pc.fill_null(self.broadcast(a[0]), False),
                              self.broadcast(a[1]), self.broadcast(a[2]))
        if name == "variant_get":
            # variant_get(col, '$.path'): decode + path walk per row
            # (typed shredded columns are the fast path; this is the
            # general one — reference GenericVariantUtil.variantGet)
            from paimon_tpu_torch.data.variant import (_parse_path, _walk,
                                                 column_to_variants)
            path = self._literal(args[1])
            segs = _parse_path(path)
            col = self.broadcast(a[0])
            vs = column_to_variants(col)
            vals = [None if v is None else _walk(v.to_object(), segs)
                    for v in vs]
            # mixed types fall back to JSON strings
            try:
                return pa.array(vals)
            except (pa.ArrowInvalid, pa.ArrowTypeError):
                import json as _json
                from paimon_tpu_torch.data.variant import _json_default
                return pa.array([
                    None if x is None else
                    (x if isinstance(x, str)
                     else _json.dumps(x, default=_json_default))
                    for x in vals])
        if name == "array":
            # ARRAY[e1, e2, ...] constructor — per-row list assembly
            cols = [self.broadcast(x).to_pylist() for x in a]
            return pa.array([list(vs) for vs in zip(*cols)]) if cols \
                else pa.array([[]] * self._rows())
        if name == "map":
            # MAP[k1, v1, k2, v2, ...] constructor
            if len(a) % 2:
                raise SQLError("MAP[...] needs an even number of items")
            cols = [self.broadcast(x).to_pylist() for x in a]
            rows = []
            for vs in zip(*cols):
                rows.append(list(zip(vs[0::2], vs[1::2])))
            return pa.array(rows, pa.map_(pa.array(cols[0]).type if cols
                                          else pa.string(),
                                          pa.array(cols[1]).type if cols
                                          else pa.string()))
        raise SQLError(f"unknown function {name}()")


# ---------------------------------------------------------------------------
# WHERE -> paimon predicate pushdown
# ---------------------------------------------------------------------------

def _flip(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "<>": "<>"}[op]


def expr_to_predicate(e, scope: Scope, base_qualifier: str,
                      exact: bool = False) -> Optional[P.Predicate]:
    """Convert an expression into a paimon Predicate over bare column
    names of the base table, or None when any part is not convertible.

    exact=False (pushdown): an AND may convert PARTIALLY — a superset
    predicate is fine for pruning because the full WHERE re-applies
    after decode.  exact=True (DELETE): every conjunct must convert or
    the whole conversion fails — a partial predicate would act on rows
    the full WHERE does not match."""

    def bare(col: ast.Column) -> Optional[str]:
        try:
            q = scope.resolve(col)
        except SQLError:
            return None
        qual, _, name = q.rpartition(".")
        return name if qual == base_qualifier else None

    def lit(x) -> Tuple[bool, Any]:
        if isinstance(x, ast.Literal):
            return True, x.value
        if isinstance(x, ast.Unary) and x.op == "NEG" and \
                isinstance(x.operand, ast.Literal):
            return True, -x.operand.value
        return False, None

    def conv(e) -> Optional[P.Predicate]:
        if isinstance(e, ast.Binary) and e.op in ("AND", "OR"):
            l_, r_ = conv(e.left), conv(e.right)
            if e.op == "AND":
                if l_ is not None and r_ is not None:
                    return P.and_(l_, r_)
                if exact:
                    return None                       # all-or-nothing
                return l_ if l_ is not None else r_   # partial AND prunes
            if l_ is not None and r_ is not None:     # OR needs both arms
                return P.or_(l_, r_)
            return None
        if isinstance(e, ast.Unary) and e.op == "NOT":
            # NOT over AND/OR is never pushed: conv() may convert those
            # subtrees PARTIALLY (a pruning subset), and negating a
            # subset over-prunes.  Simple leaves convert exactly, so
            # their negation is sound.
            if isinstance(e.operand, ast.Binary) and \
                    e.operand.op in ("AND", "OR"):
                return None
            inner = conv(e.operand)
            if inner is not None and isinstance(e.operand,
                                                (ast.Binary, ast.IsNull,
                                                 ast.InList, ast.LikeExpr,
                                                 ast.BetweenExpr)):
                return P.not_(inner)
            return None
        if isinstance(e, ast.Binary):
            left_col = isinstance(e.left, ast.Column)
            right_col = isinstance(e.right, ast.Column)
            if left_col and not right_col:
                ok, v = lit(e.right)
                f = bare(e.left)
                if ok and f:
                    return _leaf(e.op, f, v)
            elif right_col and not left_col:
                ok, v = lit(e.left)
                f = bare(e.right)
                if ok and f:
                    return _leaf(_flip(e.op), f, v)
            return None
        if isinstance(e, ast.IsNull):
            if isinstance(e.expr, ast.Column):
                f = bare(e.expr)
                if f:
                    return P.is_not_null(f) if e.negated else P.is_null(f)
            return None
        if isinstance(e, ast.InList):
            if isinstance(e.expr, ast.Column):
                f = bare(e.expr)
                vals = []
                for x in e.values:
                    ok, v = lit(x)
                    if not ok:
                        return None
                    vals.append(v)
                if f:
                    return P.not_in(f, vals) if e.negated \
                        else P.in_(f, vals)
            return None
        if isinstance(e, ast.BetweenExpr):
            if isinstance(e.expr, ast.Column):
                f = bare(e.expr)
                ok1, lo = lit(e.lo)
                ok2, hi = lit(e.hi)
                if f and ok1 and ok2:
                    b = P.between(f, lo, hi)
                    return P.not_(b) if e.negated else b
            return None
        if isinstance(e, ast.LikeExpr) and not e.negated:
            if isinstance(e.expr, ast.Column):
                f = bare(e.expr)
                m = re.fullmatch(r"([^%_]*)%", e.pattern)
                if f and m:
                    return P.starts_with(f, m.group(1))
            return None
        return None

    def _leaf(op, f, v):
        return {"=": P.equal, "<>": P.not_equal, "<": P.less_than,
                "<=": P.less_or_equal, ">": P.greater_than,
                ">=": P.greater_or_equal}[op](f, v)

    return conv(e)


# ---------------------------------------------------------------------------
# SQLContext
# ---------------------------------------------------------------------------

class SQLContext:
    """Run SQL against a catalog.  `sql()` returns a pyarrow Table for
    queries; DDL/DML return a one-column result table."""

    def __init__(self, catalog: Catalog, database: str = "default"):
        self.catalog = catalog
        self.device = catalog.device
        self.database = database
        self._views: Dict[str, pa.Table] = {}
        self._view_stack: List[str] = []      # cycle detection

    # -- public -------------------------------------------------------------
    def register(self, name: str, table: pa.Table):
        """Register an in-memory Arrow table as a queryable view."""
        self._views[name] = table

    def sql(self, query: str) -> pa.Table:
        stmt = parse(query)
        self._expand_udfs(stmt)
        handler = {
            ast.Select: self._exec_select_stmt,
            ast.Explain: self._exec_explain,
            ast.Insert: self._exec_insert,
            ast.CreateTable: self._exec_create_table,
            ast.CreateDatabase: self._exec_create_database,
            ast.CreateView: self._exec_create_view,
            ast.DropView: self._exec_drop_view,
            ast.ShowViews: self._exec_show_views,
            ast.CreateFunction: self._exec_create_function,
            ast.DropFunction: self._exec_drop_function,
            ast.ShowFunctions: self._exec_show_functions,
            ast.DropTable: self._exec_drop_table,
            ast.DropDatabase: self._exec_drop_database,
            ast.ShowTables: self._exec_show_tables,
            ast.ShowDatabases: self._exec_show_databases,
            ast.ShowCreateTable: self._exec_show_create,
            ast.Describe: self._exec_describe,
            ast.Use: self._exec_use,
            ast.Delete: self._exec_delete,
            ast.MergeInto: self._exec_merge,
            ast.Truncate: self._exec_truncate,
            ast.Update: self._exec_update,
            ast.AlterTable: self._exec_alter,
            ast.Call: self._exec_call,
        }.get(type(stmt))
        if handler is None:
            raise SQLError(f"unsupported statement {type(stmt).__name__}")
        return handler(stmt)

    # -- helpers ------------------------------------------------------------
    def _ident(self, name: str) -> Identifier:
        if "." in name:
            db, t = name.split(".", 1)
            return Identifier(db, t)
        return Identifier(self.database, name)

    def _load_relation(self, ref: ast.TableRef) -> Tuple[pa.Table, str]:
        """Resolve a table reference to (arrow table, qualifier)."""
        alias = ref.alias or ref.name.split(".")[-1]
        if ref.name in self._views:
            return self._views[ref.name], alias
        name = ref.name
        if name.startswith("sys."):
            # catalog-level system tables (reference `sys` database);
            # they have no history — a time-travel clause would be
            # silently wrong, so reject it
            if ref.snapshot_id is not None or ref.tag is not None or \
                    ref.timestamp_ms is not None:
                raise SQLError("sys.* tables do not support time "
                               "travel")
            return self.catalog.system_table(name[4:]), alias
        system = None
        if "$" in name.split(".")[-1]:
            base, system = name.rsplit("$", 1)
            name = base
            alias = ref.alias or f"{base.split('.')[-1]}${system}"
        try:
            table = self.catalog.get_table(self._ident(name))
        except Exception as table_err:        # noqa: BLE001
            expanded = self._try_expand_view(ref, name)
            if expanded is None:
                raise table_err
            return expanded, alias
        dyn: Dict[str, str] = {}
        if ref.snapshot_id is not None:
            dyn["scan.snapshot-id"] = str(ref.snapshot_id)
        if ref.tag is not None:
            dyn["scan.tag-name"] = ref.tag
        if ref.timestamp_ms is not None:
            dyn["scan.timestamp-millis"] = str(ref.timestamp_ms)
        if dyn:
            table = table.copy(dyn)
        if system is not None:
            return table.system_table(system), alias
        return table, alias

    def _try_expand_view(self, ref: ast.TableRef,
                         name: str) -> Optional[pa.Table]:
        """Expand a catalog view (None when no such view): executed in
        the view's DEFINING database, with cycle detection."""
        ident = self._ident(name)
        try:
            view = self.catalog.get_view(ident)
        except (NotImplementedError, FileNotFoundError, KeyError,
                ValueError):
            return None
        if ref.snapshot_id is not None or ref.tag is not None or \
                ref.timestamp_ms is not None:
            raise SQLError("views do not support time travel")
        key = ident.full_name
        if key in self._view_stack:
            raise SQLError(
                f"cyclic view reference: "
                f"{' -> '.join(self._view_stack + [key])}")
        prev_db = self.database
        self._view_stack.append(key)
        try:
            self.database = view.options.get("default-database",
                                             prev_db)
            return self.sql(view.query)
        finally:
            self.database = prev_db
            self._view_stack.pop()

    def _pushed_predicate(self, table, alias: str, select: ast.Select):
        """WHERE -> pruning predicate, resolution-only (no I/O)."""
        if select.where is None or select.joins:
            return None
        cols = [f.name for f in table.row_type().fields]
        return expr_to_predicate(select.where, _probe_scope(cols, alias),
                                 alias)

    @staticmethod
    def _pushed_limit(select: ast.Select):
        """LIMIT safe to push into the scan: only a bare
        `SELECT <row-exprs> FROM t LIMIT n` — any WHERE/ORDER/GROUP/
        DISTINCT/OFFSET/set-op/aggregate/window consumes the full
        relation first, so those shapes read everything.  A pushed
        limit lets the pipelined reader (parallel/scan_pipeline.py)
        stop admitting splits early; the executor's final slice still
        applies and stays a no-op."""
        if select.limit is None or select.offset or select.joins or \
                select.where is not None or select.group_by or \
                select.having or select.distinct or select.order_by or \
                select.union_all is not None:
            return None
        for item in select.items:
            if _find_aggs(item.expr) or _find_windows(item.expr):
                return None
        return select.limit

    def _relation_scope(self, ref, select: ast.Select,
                        collect_plan: Optional[dict] = None) -> Scope:
        if isinstance(ref, ast.SubqueryRef):
            sub = self._exec_select(ref.select)
            q = sub.rename_columns(
                [f"{ref.alias}.{c}" for c in sub.column_names])
            return Scope(q, list(q.column_names))
        if isinstance(ref, ast.TableRef):
            rel, alias = self._load_relation(ref)
            if isinstance(rel, pa.Table):
                out = rel
            else:
                from paimon_tpu_torch.table.table import FileStoreTable
                pushed = self._pushed_predicate(rel, alias, select)
                pushed_limit = self._pushed_limit(select) \
                    if isinstance(rel, FileStoreTable) else None
                if collect_plan is not None:
                    collect_plan["pushed"] = repr(pushed) \
                        if pushed is not None else None
                    collect_plan["pushed_limit"] = pushed_limit
                if pushed_limit is not None:
                    out = rel.to_arrow(predicate=pushed,
                                       limit=pushed_limit)
                else:
                    out = rel.to_arrow(predicate=pushed)
            q = out.rename_columns(
                [f"{alias}.{c}" for c in out.column_names])
            return Scope(q, list(q.column_names))
        raise SQLError(f"unsupported FROM item {ref!r}")

    # -- catalog UDF expansion ----------------------------------------------
    def _expand_udfs(self, stmt) -> None:
        """Rewrite calls to catalog functions (sql dialect) into their
        bound definition expressions; nested/composed definitions
        resolve through the fixed-point loop below."""
        cache: Dict[str, Any] = {}        # name -> Function | None

        def lookup(name: str):
            if name not in cache:
                try:
                    cache[name] = self.catalog.get_function(
                        self._ident(name))
                except (NotImplementedError, FileNotFoundError):
                    cache[name] = None    # genuinely absent; a corrupt
                    # definition file raises out of get_function instead
            return cache[name]

        def expand(node):
            if not isinstance(node, ast.Func) or node.over is not None \
                    or node.name in _BUILTIN_FUNCS:
                return node
            fn = lookup(node.name)
            if fn is None:
                return node
            d = fn.definition("sql")
            if d is None or not d.definition:
                raise SQLError(f"function {node.name}() has no sql-"
                               f"dialect definition this engine can run")
            if len(node.args) != len(fn.input_params):
                raise SQLError(
                    f"{node.name}() takes {len(fn.input_params)} "
                    f"argument(s), got {len(node.args)}")
            body = _parse_expr_full(d.definition)
            bound = _substitute_params(
                body, {p: a for (p, _), a in
                       zip(fn.input_params, node.args)})
            self._changed = True
            return bound

        for _ in range(9):
            self._changed = False
            if isinstance(stmt, ast.Select):
                _rewrite_select_exprs(stmt, expand)
            elif isinstance(stmt, ast.Insert) and stmt.select is not None:
                _rewrite_select_exprs(stmt.select, expand)
            elif isinstance(stmt, ast.Insert) and stmt.rows is not None:
                stmt.rows = [[_transform(c, expand) for c in row]
                             for row in stmt.rows]
            elif isinstance(stmt, ast.Update):
                stmt.assignments = [(c, _transform(e, expand))
                                    for c, e in stmt.assignments]
                if stmt.where is not None:
                    stmt.where = _transform(stmt.where, expand)
            elif isinstance(stmt, ast.Delete) and stmt.where is not None:
                stmt.where = _transform(stmt.where, expand)
            elif isinstance(stmt, ast.Explain):
                _rewrite_select_exprs(stmt.select, expand)
            else:
                return
            if not self._changed:
                return
        raise SQLError("catalog function expansion did not converge "
                       "(cyclic definitions?)")

    # -- SELECT -------------------------------------------------------------
    def _exec_select_stmt(self, s: ast.Select) -> pa.Table:
        return self._exec_select(s)

    def _subquery_rewriter(self):
        """fn for _transform: evaluate uncorrelated expression
        subqueries — scalar `(SELECT ...)` to a Literal (one column,
        at most one row, NULL when empty) and `x [NOT] IN (SELECT
        ...)` to literal comparisons. A correlated subquery fails
        inside its own execution with an unknown-column error. SQL
        three-valued logic is preserved when an IN result set
        contains NULL — `x IN (.., NULL)` is TRUE
        on a match else NULL (never FALSE), `x NOT IN (.., NULL)` is
        FALSE on a match else NULL (never TRUE) — via a CASE over the
        non-null match set."""
        def fn(e):
            if isinstance(e, ast.ExistsSubquery):
                return self._rewrite_exists(e, fn)
            if isinstance(e, ast.ScalarSubquery):
                sub = self._exec_select(e.select)
                if sub.num_columns != 1:
                    raise SQLError(
                        "scalar subquery must return exactly one "
                        f"column, got {sub.num_columns}")
                if sub.num_rows > 1:
                    raise SQLError(
                        "scalar subquery returned more than one row")
                return ast.Literal(
                    sub.column(0)[0].as_py() if sub.num_rows else None)
            if not isinstance(e, ast.InSubquery):
                return e
            sub = self._exec_select(e.select)
            if sub.num_columns != 1:
                raise SQLError(
                    "IN subquery must return exactly one column, "
                    f"got {sub.num_columns}")
            raw = sub.column(0).to_pylist()
            vals = [ast.Literal(v) for v in raw if v is not None]
            has_null = len(vals) != len(raw)
            match = ast.InList(e.expr, vals, negated=False)
            if not has_null:
                return ast.InList(e.expr, vals, e.negated)
            return ast.Case(
                whens=[(match, ast.Literal(e.negated is False))],
                default=ast.Literal(None))
        return fn

    def _rewrite_exists(self, e: "ast.ExistsSubquery", fn):
        """[NOT] EXISTS handling. Uncorrelated: evaluate once with
        LIMIT 1 -> boolean literal. Correlated on ONE outer-column
        equality over a single-table subquery: decorrelate to
        `outer [NOT] IN (SELECT inner FROM ... WHERE rest AND inner IS
        NOT NULL)` — the IS NOT NULL keeps NOT EXISTS semantics exact
        (a NULL inner value can never satisfy the equality, and a
        null-free set sidesteps NOT IN's three-valued trap)."""
        sub = e.select

        def conjuncts(x):
            if isinstance(x, ast.Binary) and x.op == "AND":
                return conjuncts(x.left) + conjuncts(x.right)
            return [x] if x is not None else []

        inner_cols = inner_alias = None
        if isinstance(sub.from_, ast.TableRef) and not sub.joins:
            try:
                tbl = self.catalog.get_table(
                    self._ident(sub.from_.name))
                inner_cols = {f.name for f in tbl.row_type().fields}
                inner_alias = sub.from_.alias or \
                    sub.from_.name.split(".")[-1]
            # lint-ok: swallow EXISTS rewrite probe: any failure here
            # just falls back to the unoptimized (correct) plan
            except Exception:
                pass

        def is_inner(col: "ast.Column") -> bool:
            if col.qualifier:
                return col.qualifier == inner_alias
            return inner_cols is not None and col.name in inner_cols

        outer_col = inner_col = None
        rest = []
        for c in conjuncts(sub.where):
            if isinstance(c, ast.Binary) and c.op == "=" and \
                    isinstance(c.left, ast.Column) and \
                    isinstance(c.right, ast.Column) and \
                    inner_cols is not None:
                li, ri = is_inner(c.left), is_inner(c.right)
                if li != ri:
                    if outer_col is not None:
                        raise SQLError(
                            "EXISTS with multiple correlated "
                            "equalities is not supported")
                    inner_col = c.left if li else c.right
                    outer_col = c.right if li else c.left
                    continue
            rest.append(c)

        if outer_col is None:
            # uncorrelated: one probe row decides the constant. Keep
            # the WHOLE query shape (UNION branches, LIMIT/OFFSET
            # semantics) — only add LIMIT 1 when none was given
            import copy as _copy
            probe = _copy.deepcopy(sub)
            if probe.limit is None and probe.offset is None and \
                    probe.union_all is None:
                probe.limit = 1
            t = self._exec_select(probe)
            return ast.Literal((t.num_rows > 0) != e.negated)

        def has_aggregate(x) -> bool:
            return bool(_find_funcs(
                x, lambda f: f.name in _AGG_FUNCS and f.over is None))

        if sub.group_by or sub.having or sub.distinct or \
                any(has_aggregate(i.expr) for i in sub.items):
            # an ungrouped aggregate always yields one row, making
            # EXISTS unconditionally true — decorrelation would
            # silently change that, so refuse
            raise SQLError("correlated EXISTS does not support "
                           "GROUP BY/HAVING/DISTINCT/aggregates")
        if sub.limit is not None or sub.offset:
            raise SQLError("correlated EXISTS does not support "
                           "LIMIT/OFFSET")
        where = ast.IsNull(inner_col, negated=True)
        for c in rest:
            where = ast.Binary("AND", where, c)
        inner_sel = ast.Select(
            items=[ast.SelectItem(inner_col)], from_=sub.from_,
            where=where)
        # feed the result back through the rewriter so the IN subquery
        # materializes in the same pass; then pin the OUTER-null case
        # explicitly — NULL probe means the equality can never hold,
        # so EXISTS is FALSE and NOT EXISTS is TRUE, independent of
        # the engine's IN null propagation
        materialized = fn(ast.InSubquery(outer_col, inner_sel,
                                         e.negated))
        return ast.Case(
            whens=[(ast.IsNull(outer_col), ast.Literal(e.negated))],
            default=materialized)

    def _materialize_subqueries(self, s: ast.Select) -> None:
        """In place and idempotent — leaves no InSubquery,
        ScalarSubquery or ExistsSubquery behind."""
        _rewrite_select_exprs(s, self._subquery_rewriter())

    def _exec_select(self, s: ast.Select,
                     collect_plan: Optional[dict] = None) -> pa.Table:
        self._materialize_subqueries(s)
        if s.union_all is not None:
            left = self._exec_select(
                ast.Select(s.items, s.from_, s.joins, s.where, s.group_by,
                           s.having, [], None, None, s.distinct))
            right = self._exec_select(s.union_all)
            right = right.rename_columns(left.column_names)
            right = right.cast(left.schema)
            setop = s.setop
            if setop == "union_all":
                out = pa.concat_tables([left, right],
                                       promote_options="none")
            elif setop == "union":
                out = pa.concat_tables(
                    [left, right], promote_options="none").group_by(
                    left.column_names, use_threads=False).aggregate([])
            else:
                # INTERSECT / EXCEPT: distinct set semantics with
                # NULL = NULL (python tuples, exactly SQL's set-op
                # grouping rules — arrow joins would drop null keys).
                # Keys are built POSITIONALLY from columns (duplicate
                # output names must not collapse) and made hashable
                # (ARRAY/MAP values arrive as lists/dicts).
                rset = set(_row_keys(right))
                seen = set()
                keep = []
                for i, key in enumerate(_row_keys(left)):
                    if key in seen:
                        continue
                    if (key in rset) == (setop == "intersect"):
                        seen.add(key)
                        keep.append(i)
                out = left.take(pa.array(keep, pa.int64()))
            # trailing ORDER BY / LIMIT bind to the whole set-op
            if s.order_by:
                keys = []
                for e, asc, pl in s.order_by:
                    direction = "ascending" if asc else "descending"
                    if isinstance(e, ast.Literal) and \
                            isinstance(e.value, int):
                        name = out.column_names[
                            _ordinal(e.value, out.num_columns) - 1]
                    elif isinstance(e, ast.Column) and \
                            e.qualifier is None and \
                            e.name in out.column_names:
                        name = e.name
                    else:
                        raise SQLError("ORDER BY over a UNION must "
                                       "reference output columns")
                    keys.append((name, direction, pl))
                out = out.take(_sort_indices(out, keys))
            if s.limit is not None:
                out = out.slice(s.offset or 0, s.limit)
            elif s.offset:
                out = out.slice(s.offset)
            return out
        if s.from_ is None:
            scope = Scope(pa.table({"__dual": pa.array([0])}), ["__dual"])
            comp = Compiler(scope)
            cols, names = [], []
            for item in s.items:
                names.append(item.alias or _display_name(item.expr))
                cols.append(comp.as_array(item.expr))
            return pa.table(dict(zip(names, cols)))

        scope = self._relation_scope(s.from_, s, collect_plan)
        for j in s.joins:
            scope = self._join(scope, j, s)
        # full WHERE on the decoded relation (pushdown already pruned)
        if s.where is not None:
            mask = Compiler(scope).as_array(s.where)
            scope = Scope(scope.table.filter(pc.fill_null(mask, False)),
                          scope.order)

        has_agg = any(_find_aggs(i.expr) for i in s.items) or \
            (s.having is not None and _find_aggs(s.having)) or s.group_by
        if s.having is not None and not has_agg:
            raise SQLError("HAVING requires GROUP BY or an aggregate; "
                           "use WHERE for row filters")
        windows: Dict[str, ast.Func] = {}
        for item in s.items:
            for f in _find_windows(item.expr):
                windows.setdefault(repr(f), f)
        for e, _, _ in s.order_by:
            for f in _find_windows(e):
                windows.setdefault(repr(f), f)
        if windows and has_agg:
            raise SQLError("window functions cannot be mixed with "
                           "GROUP BY / aggregates in one SELECT; use a "
                           "subquery")
        if has_agg:
            out = self._aggregate(scope, s)
        elif windows:
            scope, win_subst = self._apply_windows(scope, windows)
            out = self._project(scope, s, subst=win_subst)
        else:
            out = self._project(scope, s, subst=None)
        if s.distinct:
            out = out.group_by(out.column_names,
                               use_threads=False).aggregate([])
        if s.limit is not None:
            off = s.offset or 0
            out = out.slice(off, s.limit)
        elif s.offset:
            out = out.slice(s.offset)
        return out

    def _join(self, left: Scope, j: ast.JoinClause, s: ast.Select) -> Scope:
        right = self._relation_scope(j.right, s)
        lt, rt = left.table, right.table
        if j.kind == "cross":
            lk = lt.append_column("__cj", pa.array([1] * lt.num_rows))
            rk = rt.append_column("__cj", pa.array([1] * rt.num_rows))
            out = lk.join(rk, keys=["__cj"], join_type="inner")
            out = out.drop_columns(["__cj"])
            return Scope(out, left.order + right.order)
        if j.condition is None:
            raise SQLError(f"{j.kind} JOIN requires ON")
        # split ON into equi-conjuncts (one side each) + residual
        probe_cols = {q: pa.array([], lt.column(q).type)
                      for q in left.order}
        probe_cols.update({q: pa.array([], rt.column(q).type)
                           for q in right.order})
        probe = Scope(pa.table(probe_cols), left.order + right.order)
        equi, residual = [], []
        for conj in _split_conjuncts(j.condition):
            pair = _equi_pair(conj, probe, left, right)
            if pair:
                equi.append(pair)
            else:
                residual.append(conj)
        if not equi:
            raise SQLError("JOIN ON requires at least one equality "
                           "between the two sides")
        # join on temp key copies so both sides' original (qualified)
        # columns survive Arrow's key coalescing
        order = left.order + right.order
        # residual (non-equi) ON conditions participate in the MATCH:
        # for outer joins, run an inner join + residual filter, then add
        # back unmatched rows null-padded — filtering the outer result
        # would wrongly drop its null rows
        aug = bool(residual) and j.kind != "inner"
        if aug:
            import numpy as np
            lt = lt.append_column("__lrow",
                                  pa.array(np.arange(lt.num_rows)))
            rt = rt.append_column("__rrow",
                                  pa.array(np.arange(rt.num_rows)))
        for i, (lq, rq) in enumerate(equi):
            lt = lt.append_column(f"__jk{i}", lt.column(lq))
            rt = rt.append_column(f"__jk{i}", rt.column(rq))
        jk = [f"__jk{i}" for i in range(len(equi))]
        out = lt.join(rt, keys=jk, join_type="inner" if aug else j.kind,
                      coalesce_keys=True)
        out = out.drop_columns(jk)
        keep = order + (["__lrow", "__rrow"] if aug else [])
        out = out.select(keep)        # Arrow join may reorder columns
        if residual:
            mask = None
            comp = Compiler(Scope(out, keep))
            for conj in residual:
                m = comp.as_array(conj)
                mask = m if mask is None else pc.and_kleene(mask, m)
            out = out.filter(pc.fill_null(mask, False))
        if aug:
            import numpy as np
            parts = [out.select(order)]
            if j.kind in ("left outer", "full outer"):
                miss = ~np.isin(np.arange(lt.num_rows),
                                np.asarray(out.column("__lrow")))
                missing = lt.filter(pa.array(miss))
                pad = {q: missing.column(q) for q in left.order}
                pad.update({q: pa.nulls(missing.num_rows,
                                        rt.column(q).type)
                            for q in right.order})
                parts.append(pa.table(pad).select(order))
            if j.kind in ("right outer", "full outer"):
                miss = ~np.isin(np.arange(rt.num_rows),
                                np.asarray(out.column("__rrow")))
                missing = rt.filter(pa.array(miss))
                pad = {q: pa.nulls(missing.num_rows, lt.column(q).type)
                       for q in left.order}
                pad.update({q: missing.column(q) for q in right.order})
                parts.append(pa.table(pad).select(order))
            out = pa.concat_tables(parts, promote_options="none")
        else:
            out = out.select(order)
        return Scope(out, order)

    def _project(self, scope: Scope, s: ast.Select,
                 subst: Optional[Dict[str, str]]) -> pa.Table:
        comp = Compiler(scope, subst)
        names: List[str] = []
        cols: List[Any] = []
        for item in s.items:
            if isinstance(item.expr, ast.Star):
                q = item.expr.qualifier
                for qual_name in scope.order:
                    if qual_name.startswith("__"):
                        continue
                    qualifier, _, bare = qual_name.rpartition(".")
                    if q is None or qualifier == q:
                        names.append(bare)
                        cols.append(scope.table.column(qual_name))
                continue
            names.append(item.alias or _display_name(item.expr))
            cols.append(comp.as_array(item.expr))
        out = pa.table(dict(zip(_dedup(names), cols)))
        if s.order_by:
            out = self._order(out, scope, s, subst, names)
        return out

    def _order(self, out: pa.Table, scope: Scope, s: ast.Select,
               subst: Optional[Dict[str, str]],
               names: List[str]) -> pa.Table:
        comp = Compiler(scope, subst)
        sort_cols, keys = [], []
        tmp = out
        for idx, (e, asc, pl) in enumerate(s.order_by):
            direction = "ascending" if asc else "descending"
            if isinstance(e, ast.Literal) and isinstance(e.value, int):
                pos = _ordinal(e.value, out.num_columns)
                keys.append((out.column_names[pos - 1], direction, pl))
                continue
            if isinstance(e, ast.Column) and e.qualifier is None and \
                    e.name in out.column_names:
                keys.append((e.name, direction, pl))
                continue
            col = comp.as_array(e)
            cn = f"__ord{idx}"
            tmp = tmp.append_column(cn, col)
            sort_cols.append(cn)
            keys.append((cn, direction, pl))
        idxs = _sort_indices(tmp, keys)
        return tmp.take(idxs).drop_columns(sort_cols) if sort_cols \
            else tmp.take(idxs)

    def _aggregate(self, scope: Scope, s: ast.Select) -> pa.Table:
        aggs: Dict[str, ast.Func] = {}
        for item in s.items:
            for f in _find_aggs(item.expr):
                aggs.setdefault(repr(f), f)
        if s.having is not None:
            for f in _find_aggs(s.having):
                aggs.setdefault(repr(f), f)
        for e, _, _ in s.order_by:
            for f in _find_aggs(e):
                aggs.setdefault(repr(f), f)
        comp = Compiler(scope)
        work = scope.table
        subst: Dict[str, str] = {}
        for i, ge in enumerate(s.group_by):
            cn = f"__g{i}"
            # GROUP BY may name a select alias or a position
            target = ge
            if isinstance(ge, ast.Literal) and isinstance(ge.value, int):
                target = s.items[_ordinal(ge.value, len(s.items)) - 1].expr
            elif isinstance(ge, ast.Column) and ge.qualifier is None:
                for item in s.items:
                    if item.alias == ge.name:
                        target = item.expr
                        break
            work = work.append_column(cn, comp.as_array(target))
            subst[repr(target)] = cn
            if repr(ge) != repr(target):
                subst[repr(ge)] = cn
        specs: List[Tuple[str, str]] = []
        out_names: List[Tuple[str, str]] = []     # (arrow result, subst key)
        for k, (key, f) in enumerate(aggs.items()):
            cn = f"__a{k}"
            if f.name == "count" and (not f.args or
                                      isinstance(f.args[0], ast.Star)):
                ones = pa.chunked_array(
                    [pa.repeat(pa.scalar(1), work.num_rows)])
                work = work.append_column(cn, ones)
                specs.append((cn, "sum"))
                out_names.append((f"{cn}_sum", key))
                continue
            work = work.append_column(cn, comp.as_array(f.args[0]))
            if f.distinct:
                fname = "count_distinct"
            else:
                fname = {"count": "count", "sum": "sum", "min": "min",
                         "max": "max", "avg": "mean"}[f.name]
            specs.append((cn, fname))
            out_names.append((f"{cn}_{fname}", key))
        if not s.group_by:
            work = work.append_column("__gall",
                                      pa.chunked_array(
                                          [pa.repeat(pa.scalar(1),
                                                     work.num_rows)]))
            keys = ["__gall"]
        else:
            keys = [f"__g{i}" for i in range(len(s.group_by))]
        gtable = work.group_by(keys, use_threads=False).aggregate(specs)
        order = list(gtable.column_names)
        if not s.group_by and gtable.num_rows == 0:
            # a global aggregate over empty input still yields one row
            # (counts become 0 below, other aggregates NULL)
            gtable = pa.table({name: pa.nulls(1, gtable.column(name).type)
                               for name in order})
        # substitution: each aggregate expression (by structural repr)
        # resolves to its arrow result column (e.g. "__a0_sum")
        agg_subst = {key: name for name, key in out_names}
        agg_subst.update(subst)
        # count()/count(*) never return NULL — fill empty groups with 0
        for key, f in aggs.items():
            cn = agg_subst[key]
            if f.name == "count":
                filled = pc.fill_null(pc.cast(gtable.column(cn),
                                              pa.int64()), 0)
                gtable = gtable.set_column(
                    gtable.column_names.index(cn), cn, filled)
        gscope = Scope(gtable, order)
        if s.having is not None:
            mask = Compiler(gscope, agg_subst).as_array(s.having)
            gtable = gtable.filter(pc.fill_null(mask, False))
            gscope = Scope(gtable, order)
        return self._project(gscope, s, subst=agg_subst)

    # -- window functions ----------------------------------------------------
    def _apply_windows(self, scope: Scope,
                       wfuncs: Dict[str, ast.Func]
                       ) -> Tuple[Scope, Dict[str, str]]:
        """Evaluate each window expression into a temp column of the
        scope; returns (augmented scope, repr->column substitution).

        Frames follow the engines' defaults: with ORDER BY, aggregates
        use the running RANGE frame (UNBOUNDED PRECEDING..CURRENT ROW,
        peers included) and last_value means "last peer"; without
        ORDER BY the frame is the whole partition.  Functions sharing
        an identical OVER spec share one sort."""
        import numpy as np

        table = scope.table
        n = table.num_rows
        comp = Compiler(scope)
        subst: Dict[str, str] = {}
        order_names = list(scope.order)

        by_spec: Dict[str, List[Tuple[str, ast.Func]]] = {}
        for key, f in wfuncs.items():
            by_spec.setdefault(repr(f.over), []).append((key, f))

        k = 0
        for group in by_spec.values():
            w = group[0][1].over
            seg = _WindowSegments(comp, w, n)
            for key, f in group:
                col = self._window_column(comp, f, seg, n)
                cname = f"__w{k}"
                k += 1
                table = table.append_column(cname, col)
                order_names.append(cname)
                subst[key] = cname
        return Scope(table, order_names), subst

    def _window_column(self, comp, f: ast.Func, seg: "_WindowSegments",
                       n: int):
        """One window function's values, in ORIGINAL row order."""
        import numpy as np

        name = f.name
        order = seg.order
        pos = np.arange(n)
        if name == "row_number":
            return seg.scatter(pos - seg.seg_first + 1)
        if name in ("rank", "dense_rank"):
            kc = seg.key_change
            if name == "rank":
                return seg.scatter(np.maximum.accumulate(
                    np.where(kc, pos, 0)) - seg.seg_first + 1)
            c = np.cumsum(kc)
            return seg.scatter(c - c[seg.seg_first] + 1)
        if name in ("lag", "lead"):
            off = 1
            if len(f.args) > 1:
                off = int(comp._literal(f.args[1]))
            default = comp._literal(f.args[2]) if len(f.args) > 2 \
                else None
            shift = -off if name == "lag" else off
            cand = pos + shift
            valid = (cand >= 0) & (cand < n)
            cand_c = np.clip(cand, 0, max(n - 1, 0))
            valid &= seg.seg_id[cand_c] == seg.seg_id
            src_sorted = np.where(valid, order[cand_c], -1)
            return seg.gather_arg(comp, f, src_sorted, default)
        if name == "first_value":
            return seg.gather_arg(comp, f, order[seg.seg_first], None)
        if name == "last_value":
            # with ORDER BY: last PEER of the current row; without:
            # partition last
            last = seg.peer_last if seg.has_order else seg.seg_last
            return seg.gather_arg(comp, f, order[last], None)
        if name in _AGG_FUNCS:
            return self._window_aggregate(comp, f, seg, n)
        raise SQLError(f"unsupported window function {name}()")

    def _window_aggregate(self, comp, f: ast.Func,
                          seg: "_WindowSegments", n: int):
        import numpy as np

        name = f.name
        order = seg.order
        star = name == "count" and (not f.args or
                                    isinstance(f.args[0], ast.Star))
        if star:
            nn = np.ones(n, dtype=np.float64)
            vals = nn
            int_result = True
        else:
            v = comp.as_array(f.args[0])
            if isinstance(v, pa.ChunkedArray):
                v = v.combine_chunks()
            nn = (~np.asarray(pc.is_null(v)))[order].astype(np.float64)
            if name == "count":
                vals = nn
            else:
                if not (pa.types.is_integer(v.type) or
                        pa.types.is_floating(v.type) or
                        pa.types.is_boolean(v.type)):
                    raise SQLError(
                        f"window {name}() needs a numeric argument")
                int_result = pa.types.is_integer(v.type)
                vals = np.asarray(pc.fill_null(
                    pc.cast(v, pa.float64()), 0.0))[order]
        if name == "count":
            if seg.has_order:
                cum = np.cumsum(nn)
                res = seg.running(cum)
            else:
                res = np.add.reduceat(nn, seg.starts_idx)[seg.seg_id]
            return seg.scatter(res.astype(np.int64))
        if name in ("sum", "avg"):
            if seg.has_order:
                tot = seg.running(np.cumsum(vals * nn))
                cnt = seg.running(np.cumsum(nn))
            else:
                tot = np.add.reduceat(vals * nn,
                                      seg.starts_idx)[seg.seg_id]
                cnt = np.add.reduceat(nn, seg.starts_idx)[seg.seg_id]
            res = tot if name == "sum" else tot / np.maximum(cnt, 1)
            if name == "sum" and not star and int_result:
                res = res.astype(np.int64)
            return seg.scatter(res, null_mask=cnt == 0)
        # min / max
        if seg.has_order:
            raise SQLError(f"window {name}() with ORDER BY (running "
                           f"frame) is not supported; omit ORDER BY "
                           f"for the whole-partition value")
        fillv = np.inf if name == "min" else -np.inf
        vv = np.where(nn > 0, vals, fillv)
        red = np.minimum if name == "min" else np.maximum
        cnt = np.add.reduceat(nn, seg.starts_idx)[seg.seg_id]
        res = red.reduceat(vv, seg.starts_idx)[seg.seg_id]
        if int_result:
            res = np.where(cnt == 0, 0, res).astype(np.int64)
        return seg.scatter(res, null_mask=cnt == 0)

    # -- EXPLAIN ------------------------------------------------------------
    def _exec_explain(self, e: ast.Explain) -> pa.Table:
        s = e.select
        lines = ["== Logical Plan =="]
        if isinstance(s.from_, ast.TableRef):
            # resolution only — EXPLAIN never reads data files
            rel, alias = self._load_relation(s.from_)
            lines.append(f"Scan: {s.from_.name}")
            pushed = None if isinstance(rel, pa.Table) else \
                self._pushed_predicate(rel, alias, s)
            if pushed is not None:
                lines.append(f"  pushed predicate: {pushed!r}")
            elif s.where is not None:
                lines.append("  pushed predicate: none")
            if not isinstance(rel, pa.Table):
                from paimon_tpu_torch.table.table import FileStoreTable
                if isinstance(rel, FileStoreTable) and \
                        self._pushed_limit(s) is not None:
                    lines.append(f"  pushed limit: {s.limit}")
        if s.where is not None:
            lines.append(f"Filter: {s.where!r}")
        for j in s.joins:
            lines.append(f"Join[{j.kind}]: {j.condition!r}")
        if s.group_by or any(_find_aggs(i.expr) for i in s.items):
            lines.append(f"Aggregate: group_by={s.group_by!r}")
        if s.order_by:
            lines.append(f"Sort: {len(s.order_by)} key(s)")
        if s.limit is not None:
            lines.append(f"Limit: {s.limit}")
        return _result(lines, "plan")

    # -- DML ----------------------------------------------------------------
    def _exec_insert(self, ins: ast.Insert) -> pa.Table:
        table = self.catalog.get_table(self._ident(ins.table))
        schema = table.arrow_schema()
        if ins.select is not None:
            data = self._exec_select(ins.select)
            if ins.columns is None:
                # positional mapping onto the table's leading fields
                cols = [f.name for f in schema][:data.num_columns]
                data = data.rename_columns(cols)
            else:
                cols = ins.columns
        else:
            scope = Scope(pa.table({"__dual": pa.array([0])}), ["__dual"])
            comp = Compiler(scope)
            n_cols = len(ins.rows[0])
            cols = ins.columns or [f.name for f in schema][:n_cols]
            arrays: List[List[Any]] = [[] for _ in range(n_cols)]
            rewrite = self._subquery_rewriter()
            for row in ins.rows:
                if len(row) != n_cols:
                    raise SQLError("VALUES rows have inconsistent arity")
                for i, cell in enumerate(row):
                    v = comp.compile(_transform(cell, rewrite))
                    if isinstance(v, pa.Scalar):
                        v = v.as_py()
                    elif isinstance(v, (pa.Array, pa.ChunkedArray)):
                        # 1-row dual scope: unwrap the single cell
                        v = v[0].as_py()
                    arrays[i].append(v)
            # build with the target field type when known — inference
            # cannot reconstruct map<> / nested types from python cells
            ftypes = {f.name: f.type for f in schema}

            def _build(c, vals):
                if c in ftypes:
                    try:
                        return pa.array(vals, ftypes[c])
                    except (pa.ArrowInvalid, pa.ArrowTypeError):
                        pass        # fall back to inference + later cast
                return pa.array(vals)

            data = pa.table({c: _build(c, vals)
                             for c, vals in zip(cols, arrays)})
        batch: Dict[str, pa.ChunkedArray] = {}
        for field in schema:
            if field.name in cols:
                src = data.column(cols.index(field.name)) \
                    if isinstance(data, pa.Table) else None
                batch[field.name] = pc.cast(src, field.type)
            else:
                batch[field.name] = pa.nulls(data.num_rows, field.type)
        out = pa.table(batch)
        wb = table.new_batch_write_builder()
        if ins.overwrite:
            wb = wb.with_overwrite()
        # context-managed: a failed flush must still join the pipelined
        # writer's pool (parallel/write_pipeline.py), not leak it
        with wb.new_write() as w:
            w.write_arrow(out)
            wb.new_commit().commit(w.prepare_commit())
        return _result([f"{out.num_rows} rows inserted"])

    def _exec_merge(self, m: "ast.MergeInto") -> pa.Table:
        """MERGE INTO over one right-outer join of target x source:
        pairs with a live target row feed the WHEN MATCHED clauses
        (first match wins), source rows with no target match feed WHEN
        NOT MATCHED; one upsert/delete batch commits atomically
        (reference MergeIntoProcedure semantics on pk tables)."""
        import numpy as np

        table = self.catalog.get_table(self._ident(m.target))
        if not table.primary_keys:
            raise SQLError("MERGE INTO requires a primary-key table")
        t_alias = m.target_alias or m.target.split(".")[-1]
        sel = ast.Select(
            items=[ast.SelectItem(ast.Star())],
            from_=ast.TableRef(m.target, alias=t_alias),
            joins=[ast.JoinClause("right outer", m.source, m.on)])
        self._materialize_subqueries(sel)
        scope = self._relation_scope(sel.from_, sel)
        scope = self._join(scope, sel.joins[0], sel)
        comp = Compiler(scope)
        n = scope.table.num_rows
        target_cols = [f.name for f in table.row_type().fields]
        schema = table.arrow_schema()

        # a pk column is NOT NULL in the target, so its null-ness in
        # the outer join identifies unmatched source rows
        pk_q = f"{t_alias}.{table.primary_keys[0]}"
        matched = np.asarray(
            pc.is_valid(scope.table.column(pk_q)).combine_chunks(),
            dtype=bool) if n else np.zeros(0, bool)

        def cond_mask(cond) -> np.ndarray:
            if cond is None:
                return np.ones(n, bool)
            v = comp.as_array(cond)
            return np.asarray(pc.fill_null(v, False).combine_chunks(),
                              dtype=bool)

        # statement-level validation runs regardless of what the data
        # currently matches — an invalid MERGE must fail deterministically
        for clause in m.clauses:
            if clause.action == "update":
                bad = set(dict(clause.assignments)) & (
                    set(table.primary_keys) |
                    set(table.partition_keys or []))
                if bad:
                    raise SQLError(
                        f"cannot UPDATE key column(s) {sorted(bad)}")

        out_tables, out_kinds = [], []
        remaining_m = matched.copy()
        remaining_nm = ~matched
        for clause in m.clauses:
            remaining = remaining_m if clause.matched else remaining_nm
            mask = remaining & cond_mask(clause.condition)
            if clause.matched:
                remaining_m = remaining_m & ~mask
            else:
                remaining_nm = remaining_nm & ~mask
            if not mask.any():
                continue
            sub = scope.table.filter(pa.array(mask))
            sub_scope = Scope(sub, scope.order)
            sub_comp = Compiler(sub_scope)
            if clause.action == "update":
                assigns = dict(clause.assignments)
                cols = {}
                for c in target_cols:
                    if c in assigns:
                        cols[c] = pc.cast(sub_comp.as_array(assigns[c]),
                                          schema.field(c).type)
                    else:
                        cols[c] = sub.column(f"{t_alias}.{c}")
                out_tables.append(pa.table(cols, schema=schema))
                out_kinds.append(np.zeros(sub.num_rows, np.int8))
            elif clause.action == "delete":
                cols = {c: sub.column(f"{t_alias}.{c}")
                        for c in target_cols}
                out_tables.append(pa.table(cols, schema=schema))
                out_kinds.append(np.full(sub.num_rows, RowKind.DELETE,
                                         np.int8))
            else:                       # insert
                cols_order = clause.insert_columns or target_cols
                if len(cols_order) != len(clause.insert_values):
                    raise SQLError("INSERT arity mismatch in MERGE")
                vals = dict(zip(cols_order, clause.insert_values))
                unknown = set(vals) - set(target_cols)
                if unknown:
                    raise SQLError(f"unknown INSERT column(s) "
                                   f"{sorted(unknown)}")
                cols = {}
                for c in target_cols:
                    if c in vals:
                        cols[c] = pc.cast(sub_comp.as_array(vals[c]),
                                          schema.field(c).type)
                    else:
                        cols[c] = pa.nulls(sub.num_rows,
                                           schema.field(c).type)
                out_tables.append(pa.table(cols, schema=schema))
                out_kinds.append(np.zeros(sub.num_rows, np.int8))
        if not out_tables:
            return _result(["0 rows merged"])
        batch = pa.concat_tables(out_tables, promote_options="none")
        kinds = np.concatenate(out_kinds)
        # SQL MERGE forbids touching one target row twice (duplicate
        # source join keys would make the outcome order-dependent)
        pk_cols = [batch.column(k).to_pylist()
                   for k in table.primary_keys]
        seen_keys = set()
        for key in zip(*pk_cols):
            if key in seen_keys:
                raise SQLError(
                    f"MERGE INTO affected target row {key} more than "
                    f"once (duplicate keys in the source?)")
            seen_keys.add(key)
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        try:
            w.write_arrow(batch, row_kinds=kinds)
            wb.new_commit().commit(w.prepare_commit())
        finally:
            w.close()
        return _result([f"{batch.num_rows} rows merged"])

    def _exec_truncate(self, t: "ast.Truncate") -> pa.Table:
        """TRUNCATE TABLE: one OVERWRITE snapshot that drops every live
        file (reference TRUNCATE via INSERT OVERWRITE / purge)."""
        _purge_all(self.catalog.get_table(self._ident(t.table)))
        return _result(["OK"])

    def _exec_delete(self, d: ast.Delete) -> pa.Table:
        table = self.catalog.get_table(self._ident(d.table))
        if d.where is None:
            raise SQLError("DELETE without WHERE is not supported; "
                           "DROP TABLE or overwrite instead")
        cols = [f.name for f in table.row_type().fields]
        alias = d.table.split(".")[-1]
        # IN (SELECT ...) materializes to a literal list first (same
        # rewrite the SELECT/UPDATE paths get)
        where = _transform(d.where, self._subquery_rewriter())
        pred = expr_to_predicate(where, _probe_scope(cols, alias),
                                 alias, exact=True)
        if pred is None:
            raise SQLError("DELETE WHERE must be expressible as column/"
                           f"literal comparisons, got: {d.where!r}")
        # delete_where returns a snapshot id; count matches for the
        # rows-affected result with a pushdown scan projected to the
        # predicate's own columns (the filter runs after projection)
        count_cols = sorted(set(pred.fields())) or [cols[0]]
        n = table.to_arrow(projection=count_cols, predicate=pred).num_rows
        table.delete_where(pred)
        return _result([f"{n} rows deleted"])

    def _exec_update(self, u: ast.Update) -> pa.Table:
        table = self.catalog.get_table(self._ident(u.table))
        if not table.primary_keys:
            raise SQLError("UPDATE requires a primary-key table")
        alias = u.table.split(".")[-1]
        sel = ast.Select(items=[ast.SelectItem(ast.Star())],
                         from_=ast.TableRef(u.table, alias=alias),
                         where=u.where)
        matched = self._exec_select(sel)
        if matched.num_rows == 0:
            return _result(["0 rows updated"])
        q = matched.rename_columns(
            [f"{alias}.{c}" for c in matched.column_names])
        scope = Scope(q, list(q.column_names))
        comp = Compiler(scope)
        out = matched
        schema = table.arrow_schema()
        rewrite = self._subquery_rewriter()
        for col, e in u.assignments:
            if col in (table.partition_keys or []) or \
                    col in table.primary_keys:
                raise SQLError(f"cannot UPDATE key column {col!r}")
            idx = out.column_names.index(col)
            e = _transform(e, rewrite)
            val = pc.cast(comp.as_array(e), schema.field(col).type)
            out = out.set_column(idx, col, val)
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(out.cast(schema))
            wb.new_commit().commit(w.prepare_commit())
        return _result([f"{out.num_rows} rows updated"])

    # -- DDL ----------------------------------------------------------------
    def _exec_create_table(self, c: ast.CreateTable) -> pa.Table:
        b = Schema.builder()
        for col in c.columns:
            b.column(col.name, parse_data_type(col.type_str),
                     description=col.comment)
        if c.primary_key:
            b.primary_key(*c.primary_key)
        if c.partitioned_by:
            b.partition_keys(*c.partitioned_by)
        b.options(c.options)
        if c.comment:
            b.comment(c.comment)
        self.catalog.create_table(self._ident(c.table), b.build(),
                                  ignore_if_exists=c.if_not_exists)
        return _result(["OK"])

    def _exec_create_database(self, c: ast.CreateDatabase) -> pa.Table:
        self.catalog.create_database(c.name,
                                     ignore_if_exists=c.if_not_exists)
        return _result(["OK"])

    def _exec_create_view(self, c: ast.CreateView) -> pa.Table:
        from paimon_tpu_torch.catalog.view import View
        ident = self._ident(c.name)
        if c.or_replace:
            self.catalog.drop_view(ident, ignore_if_not_exists=True)
        self.catalog.create_view(
            ident, View(query=c.query_text, comment=c.comment,
                        options={"default-database": ident.database}))
        return _result(["OK"])

    def _exec_drop_view(self, d: ast.DropView) -> pa.Table:
        self.catalog.drop_view(self._ident(d.name),
                               ignore_if_not_exists=d.if_exists)
        return _result(["OK"])

    def _exec_show_views(self, s: ast.ShowViews) -> pa.Table:
        db = s.database or self.database
        return pa.table({"view_name":
                         pa.array(sorted(self.catalog.list_views(db)),
                                  pa.string())})

    def _exec_create_function(self, c: ast.CreateFunction) -> pa.Table:
        from paimon_tpu_torch.catalog.function import (Function,
                                                 FunctionDefinition)
        ident_name = c.name.split(".")[-1].lower()
        if ident_name in _BUILTIN_FUNCS:
            raise SQLError(f"cannot create function {ident_name!r}: "
                           f"built-in functions cannot be shadowed")
        # validate the body parses as an expression now, not at call
        _parse_expr_full(c.body)
        for _, tstr in c.params:
            parse_data_type(tstr)
        if c.return_type:
            parse_data_type(c.return_type)
        ident = self._ident(c.name)
        if c.or_replace:
            self.catalog.drop_function(ident, ignore_if_not_exists=True)
        fn = Function(
            input_params=list(c.params), return_type=c.return_type,
            definitions={"sql": FunctionDefinition(
                "sql", definition=c.body)},
            comment=c.comment)
        self.catalog.create_function(ident, fn)
        return _result(["OK"])

    def _exec_drop_function(self, d: ast.DropFunction) -> pa.Table:
        self.catalog.drop_function(self._ident(d.name),
                                   ignore_if_not_exists=d.if_exists)
        return _result(["OK"])

    def _exec_show_functions(self, s: ast.ShowFunctions) -> pa.Table:
        db = s.database or self.database
        return pa.table({"function_name": pa.array(
            sorted(self.catalog.list_functions(db)), pa.string())})

    def _exec_drop_table(self, d: ast.DropTable) -> pa.Table:
        self.catalog.drop_table(self._ident(d.table),
                                ignore_if_not_exists=d.if_exists)
        return _result(["OK"])

    def _exec_drop_database(self, d: ast.DropDatabase) -> pa.Table:
        self.catalog.drop_database(d.name,
                                   ignore_if_not_exists=d.if_exists)
        return _result(["OK"])

    def _exec_show_tables(self, s: ast.ShowTables) -> pa.Table:
        db = s.database or self.database
        return pa.table({"table_name":
                         pa.array(sorted(self.catalog.list_tables(db)))})

    def _exec_show_databases(self, s: ast.ShowDatabases) -> pa.Table:
        return pa.table({"database_name":
                         pa.array(sorted(self.catalog.list_databases()))})

    def _exec_show_create(self, s: ast.ShowCreateTable) -> pa.Table:
        table = self.catalog.get_table(self._ident(s.table))
        schema = table.schema
        lines = [f"CREATE TABLE `{s.table}` ("]
        defs = []
        for f in schema.fields:
            d = f"  `{f.name}` {f.type}"
            if getattr(f, "description", None):
                d += f" COMMENT '{f.description}'"
            defs.append(d)
        if schema.primary_keys:
            defs.append("  PRIMARY KEY (" +
                        ", ".join(f"`{k}`" for k in schema.primary_keys) +
                        ") NOT ENFORCED")
        lines.append(",\n".join(defs))
        lines.append(")")
        if schema.partition_keys:
            lines.append("PARTITIONED BY (" +
                         ", ".join(f"`{k}`"
                                   for k in schema.partition_keys) + ")")
        if schema.options:
            opts = ",\n".join(f"  '{k}' = '{v}'"
                              for k, v in sorted(schema.options.items()))
            lines.append(f"WITH (\n{opts}\n)")
        return _result(["\n".join(lines)], "create_table")

    def _exec_describe(self, d: ast.Describe) -> pa.Table:
        table = self.catalog.get_table(self._ident(d.table))
        schema = table.schema
        pk = set(schema.primary_keys or [])
        part = set(schema.partition_keys or [])
        return pa.table({
            "name": pa.array([f.name for f in schema.fields]),
            "type": pa.array([str(f.type) for f in schema.fields]),
            "key": pa.array(["PRI" if f.name in pk else
                             ("PAR" if f.name in part else "")
                             for f in schema.fields]),
            "comment": pa.array([getattr(f, "description", None)
                                 for f in schema.fields], pa.string()),
        })

    def _exec_use(self, u: ast.Use) -> pa.Table:
        if not self.catalog.database_exists(u.database):
            raise SQLError(f"database {u.database!r} does not exist")
        self.database = u.database
        return _result(["OK"])

    def _exec_alter(self, a: ast.AlterTable) -> pa.Table:
        ident = self._ident(a.table)
        changes: List[SchemaChange] = []
        if a.action == "set-options":
            changes = [SchemaChange.set_option(k, v)
                       for k, v in a.payload.items()]
        elif a.action == "reset":
            changes = [SchemaChange.remove_option(k) for k in a.payload]
        elif a.action == "add-column":
            cd: ast.ColumnDef = a.payload
            changes = [SchemaChange.add_column(cd.name,
                                               parse_data_type(cd.type_str))]
        elif a.action == "drop-column":
            changes = [SchemaChange.drop_column(a.payload)]
        elif a.action == "rename-column":
            changes = [SchemaChange.rename_column(*a.payload)]
        self.catalog.alter_table(ident, changes)
        return _result(["OK"])

    # -- CALL procedures ----------------------------------------------------
    def _exec_call(self, c: ast.Call) -> pa.Table:
        proc = c.procedure.lower()
        if proc.startswith("sys."):
            proc = proc[4:]
        args = list(c.args)
        if not args:
            raise SQLError("CALL procedures take the table name first")
        if proc == "migrate_table":
            # CALL sys.migrate_table('/path/to/hive_dir', 'db.t'
            #   [, 'parquet'[, move]]) — reference
            # MigrateTableProcedure (ours takes the source DIRECTORY;
            # no Hive metastore exists in this environment)
            from paimon_tpu_torch.maintenance.migrate import migrate_table
            if len(args) < 2:
                raise SQLError("migrate_table needs (source_dir, "
                               "'db.table')")
            fmt = str(args[2]) if len(args) > 2 else "parquet"
            move = str(args[3]).lower() in ("true", "1") \
                if len(args) > 3 else True
            t = migrate_table(self.catalog, str(args[0]),
                              self._ident(str(args[1])),
                              file_format=fmt, move=move)
            snap = t.latest_snapshot()
            return _result([f"migrated {snap.total_record_count} rows "
                            f"into {args[1]}"])
        if proc == "compact_database":
            # reference CompactDatabaseProcedure: compact every table
            # in the database (full when the second arg says so)
            db = str(args[0])
            full = len(args) > 1 and str(args[1]).lower() in ("true",
                                                              "1",
                                                              "full")
            done = []
            for name in self.catalog.list_tables(db):
                t = self.catalog.get_table(f"{db}.{name}")
                sid = t.compact(full=full)
                if sid is not None:
                    done.append(f"{name}@{sid}")
            return _result(
                [f"{len(done)} tables compacted"] + done)
        if proc == "clone":
            # CALL sys.clone('db.src', 'db.dst') — reference
            # CloneProcedure: independent copy of the current state
            from paimon_tpu_torch.maintenance.clone import clone_table
            if len(args) < 2:
                raise SQLError("clone needs (source, target)")
            t = clone_table(self.catalog, self._ident(str(args[0])),
                            self._ident(str(args[1])))
            snap = t.latest_snapshot()
            rows = snap.total_record_count if snap else 0
            return _result([f"cloned {rows} rows into {args[1]}"])
        table = self.catalog.get_table(self._ident(str(args[0])))
        rest = args[1:]
        if proc == "compact":
            sid = table.compact(full=bool(rest[0]) if rest else False)
            return _result([f"snapshot {sid}" if sid else "nothing to do"])
        if proc == "sort_compact":
            order_by = [c.strip() for c in str(rest[0]).split(",")]
            strategy = str(rest[1]) if len(rest) > 1 else "order"
            sid = table.sort_compact(order_by, strategy=strategy)
            return _result([f"snapshot {sid}" if sid else "nothing to do"])
        if proc == "create_tag":
            table.create_tag(str(rest[0]),
                             int(rest[1]) if len(rest) > 1 else None)
            return _result(["OK"])
        if proc == "delete_tag":
            table.delete_tag(str(rest[0]))
            return _result(["OK"])
        if proc == "create_branch":
            table.create_branch(str(rest[0]),
                                str(rest[1]) if len(rest) > 1 else None)
            return _result(["OK"])
        if proc == "delete_branch":
            table.delete_branch(str(rest[0]))
            return _result(["OK"])
        if proc == "fast_forward":
            table.fast_forward(str(rest[0]))
            return _result(["OK"])
        if proc == "rollback_to":
            table.rollback_to(int(rest[0]))
            return _result(["OK"])
        if proc == "expire_snapshots":
            n = table.expire_snapshots(
                retain_max=int(rest[0]) if rest else None)
            return _result([f"{n or 0} snapshots expired"])
        if proc == "expire_partitions":
            n = table.expire_partitions(
                expiration_ms=int(rest[0]) if rest else None)
            return _result([f"{n or 0} partitions expired"])
        if proc == "remove_orphan_files":
            n = table.remove_orphan_files(
                older_than_ms=int(rest[0]) if rest else None)
            return _result([f"{n or 0} orphan files removed"])
        if proc == "rescale":
            table.rescale_buckets(int(rest[0]))
            return _result(["OK"])
        if proc == "analyze":
            n = table.analyze()
            return _result([f"{n or 0} rows analyzed"])
        if proc == "full_text_search":
            # CALL sys.full_text_search('db.t', 'col', 'query'[, k])
            # (reference flink/procedure/FullTextSearchProcedure.java)
            from paimon_tpu_torch.index.fulltext import full_text_search
            return full_text_search(table, str(rest[0]), str(rest[1]),
                                    k=int(rest[2]) if len(rest) > 2
                                    else 10)
        if proc == "vector_search":
            # CALL sys.vector_search('db.t', 'col', '0.1,0.2,...'[, k])
            # (reference flink/procedure/VectorSearchProcedure.java)
            from paimon_tpu_torch.vector import vector_search
            vec = [float(x) for x in str(rest[1]).split(",")]
            return vector_search(table, str(rest[0]), vec,
                                 k=int(rest[2]) if len(rest) > 2 else 10)
        if proc == "hybrid_search":
            # CALL sys.hybrid_search('db.t', 'vcol', '0.1,...', 'tcol',
            #                        'terms'[, k[, ranker]])
            from paimon_tpu_torch.vector import hybrid_search
            vec = [float(x) for x in str(rest[1]).split(",")]
            kk = int(rest[4]) if len(rest) > 4 else 10
            return hybrid_search(
                table,
                routes=[{"type": "vector", "column": str(rest[0]),
                         "query": vec, "limit": kk},
                        {"type": "text", "column": str(rest[2]),
                         "query": str(rest[3]), "limit": kk}],
                k=kk,
                ranker=str(rest[5]) if len(rest) > 5 else "rrf")
        if proc == "create_vector_index":
            # CALL sys.create_vector_index('db.t', 'col'[, m[, metric
            #   [, kind]]]) — kind in ivfpq|ivfsq|hnsw — builds +
            # persists the index in the table layout (reference
            # NativeVectorIndexLoader.java:28 + IvfHnswSq/Flat
            # factories)
            from paimon_tpu_torch.vector.ann import PersistedVectorIndex
            p = PersistedVectorIndex(table, str(rest[0]))
            kind = str(rest[3]) if len(rest) > 3 else "ivfpq"
            idx = p.build(m=int(rest[1]) if len(rest) > 1 else 8,
                          metric=str(rest[2]) if len(rest) > 2
                          else "l2", kind=kind)
            mem = (f", {idx.memory_bytes()} bytes resident"
                   if hasattr(idx, "memory_bytes") else "")
            return _result([f"{kind} index built: {len(idx)} vectors"
                            f"{mem}"])
        if proc == "mark_partition_done":
            # reference flink/procedure/MarkPartitionDoneProcedure.java:
            # CALL sys.mark_partition_done('db.t', 'dt=2026-07-29', ...)
            if not rest:
                raise SQLError("mark_partition_done needs partitions")
            marked = table.mark_partitions_done([str(p) for p in rest])
            return _result([f"{len(marked)} partitions marked done"])
        if proc == "expire_changelogs":
            # reference flink/procedure/ExpireChangelogsProcedure
            from paimon_tpu_torch.maintenance.expire import expire_changelogs
            r = expire_changelogs(
                table,
                retain_max=int(rest[0]) if len(rest) > 0 else None,
                retain_min=int(rest[1]) if len(rest) > 1 else None)
            return _result([f"{len(r.expired_snapshots)} changelogs "
                            f"expired"])
        if proc == "expire_tags":
            # reference flink/procedure/ExpireTagsProcedure: drop tags
            # whose tag.time-retained elapsed
            expired = table.tag_manager.expire_tags()
            return _result([f"{len(expired)} tags expired"] +
                           [str(t) for t in expired])
        if proc == "rename_tag":
            # reference flink/procedure/RenameTagProcedure
            if len(rest) != 2:
                raise SQLError("rename_tag needs (old, new)")
            old, new = str(rest[0]), str(rest[1])
            table.tag_manager.rename_tag(old, new)
            return _result([f"tag {old} renamed to {new}"])
        if proc == "clear_consumers":
            # reference flink/procedure/ClearConsumersProcedure:
            # optional regex filter over consumer ids
            import re as _re
            cm = table.consumer_manager
            pattern = _re.compile(str(rest[0])) if rest else None
            cleared = []
            for cid in list(cm.consumers()):
                if pattern is None or pattern.fullmatch(cid):
                    cm.delete_consumer(cid)
                    cleared.append(cid)
            return _result([f"{len(cleared)} consumers cleared"])
        def _scan_snapshots():
            """Yield existing snapshots, earliest to latest (expired
            ids are skipped)."""
            sm = table.snapshot_manager
            for sid in range(sm.earliest_snapshot_id() or 1,
                             (sm.latest_snapshot_id() or 0) + 1):
                try:
                    yield sm.snapshot(sid)
                except FileNotFoundError:
                    continue

        if proc == "create_tag_from_watermark":
            # reference CreateTagFromWatermarkProcedure: first snapshot
            # whose watermark reached the bound
            if len(rest) < 2:
                raise SQLError(
                    "create_tag_from_watermark needs (tag, watermark)")
            bound = int(rest[1])
            pick = None
            for s_ in _scan_snapshots():
                if s_.watermark is not None and s_.watermark >= bound:
                    pick = s_
                    break              # watermarks only advance
            if pick is None:
                raise SQLError(f"no snapshot with watermark >= {bound}")
            table.create_tag(str(rest[0]), snapshot_id=pick.id)
            return _result([f"tag {rest[0]} -> snapshot {pick.id} "
                            f"(watermark {pick.watermark})"])
        if proc in ("rollback_to_timestamp", "create_tag_from_timestamp"):
            # reference RollbackToTimestampProcedure /
            # CreateTagFromTimestampProcedure: latest snapshot with
            # time_millis <= ts
            need = 1 if proc.startswith("rollback") else 2
            if len(rest) < need:
                raise SQLError(f"{proc} needs a timestamp (millis)"
                               if need == 1
                               else f"{proc} needs (tag, millis)")
            ts = int(rest[-1])
            best = None
            for s in _scan_snapshots():
                if s.time_millis <= ts:
                    best = s
                else:
                    break          # commit times are non-decreasing
            if best is None:
                raise SQLError(f"no snapshot at or before {ts}")
            if proc == "rollback_to_timestamp":
                table.rollback_to(best.id)
                return _result([f"rolled back to snapshot {best.id}"])
            table.create_tag(str(rest[0]), snapshot_id=best.id)
            return _result([f"tag {rest[0]} -> snapshot {best.id}"])
        if proc == "remove_unexisting_files":
            # reference RemoveUnexistingFilesProcedure: reconcile
            # manifests with storage after out-of-band deletions
            from paimon_tpu_torch.maintenance.repair import (
                remove_unexisting_files,
            )
            dry = bool(rest) and str(rest[0]).lower() in ("true", "1")
            gone = remove_unexisting_files(table, dry_run=dry)
            verb = "missing" if dry else "removed"
            return _result([f"{len(gone)} files {verb}"] + gone)
        if proc == "purge_files":
            # reference PurgeFilesProcedure: drop all live data in one
            # OVERWRITE snapshot (time travel to earlier snapshots
            # keeps working until expiry)
            _purge_all(table)
            return _result(["table purged"])
        if proc == "remove_unexisting_manifests":
            # reference RemoveUnexistingManifestsProcedure
            from paimon_tpu_torch.maintenance.repair import (
                remove_unexisting_manifests,
            )
            sid = remove_unexisting_manifests(table)
            return _result(
                ["table has no snapshots; nothing to repair"]
                if sid is None
                else [f"manifest chain repaired in snapshot {sid}"])
        if proc == "rename_branch":
            # reference RenameBranchProcedure
            if len(rest) != 2:
                raise SQLError("rename_branch needs (old, new)")
            table.rename_branch(str(rest[0]), str(rest[1]))
            return _result([f"branch {rest[0]} renamed to {rest[1]}"])
        if proc == "rewrite_file_index":
            # reference RewriteFileIndexProcedure: retrofit per-file
            # indexes after enabling file-index.* on an existing table
            from paimon_tpu_torch.maintenance.repair import rewrite_file_index
            force = bool(rest) and str(rest[0]).lower() in ("true", "1")
            n = rewrite_file_index(table, force=force)
            return _result([f"{n} files indexed"])
        if proc == "compact_manifest":
            # reference CompactManifestProcedure
            from paimon_tpu_torch.maintenance.repair import compact_manifests
            sid = compact_manifests(table)
            return _result(
                ["table has no snapshots; nothing to compact"]
                if sid is None
                else [f"manifests compacted in snapshot {sid}"])
        if proc == "trigger_tag_automatic_creation":
            # reference TriggerTagAutomaticCreationProcedure
            from paimon_tpu_torch.maintenance.tag_auto import maybe_create_tags
            created = maybe_create_tags(table)
            return _result([f"{len(created)} tags created"] + created)
        raise SQLError(f"unknown procedure {c.procedure!r}")


class _WindowSegments:
    """Shared per-OVER-spec machinery: the partition/order sort, the
    segment (partition) and peer (tie-group) structure in sorted order,
    and scatter/gather back to original row order."""

    def __init__(self, comp: Compiler, w, n: int):
        import numpy as np

        self.n = n
        self.has_order = bool(w.order_by)
        cols: Dict[str, Any] = {}
        sort_keys = []
        for i, pe in enumerate(w.partition_by):
            cols[f"__wp{i}"] = comp.as_array(pe)
            sort_keys.append((f"__wp{i}", "ascending", "at_end"))
        for j, (oe, asc) in enumerate(w.order_by):
            cols[f"__wo{j}"] = comp.as_array(oe)
            sort_keys.append(
                (f"__wo{j}", "ascending" if asc else "descending",
                 "at_end"))
        cols["__wi"] = pa.array(np.arange(n))
        sort_keys.append(("__wi", "ascending", "at_end"))   # stable
        self._st = pa.table(cols)
        self.order = np.asarray(_sort_indices(self._st, sort_keys))

        seg_start = np.zeros(n, dtype=bool)
        if n:
            seg_start[0] = True
        if w.partition_by and n > 1:
            seg_start[1:] |= self._changed(
                [f"__wp{i}" for i in range(len(w.partition_by))])
        self.seg_start = seg_start
        pos = np.arange(n)
        self.seg_first = np.maximum.accumulate(
            np.where(seg_start, pos, 0))
        self.starts_idx = np.flatnonzero(seg_start)
        self.seg_id = np.cumsum(seg_start) - 1
        ends = np.append(self.starts_idx[1:] - 1, n - 1) if n else \
            np.zeros(0, dtype=np.int64)
        self.seg_last = ends[self.seg_id] if n else ends

        # peer groups: rows equal on (partition, order) keys; without
        # ORDER BY the whole partition is one peer group
        kc = seg_start.copy()
        if self.has_order and n > 1:
            kc[1:] |= self._changed(
                [f"__wo{j}" for j in range(len(w.order_by))])
        self.key_change = kc
        gstarts = np.flatnonzero(kc)
        gid = np.cumsum(kc) - 1
        gends = np.append(gstarts[1:] - 1, n - 1) if n else gstarts
        self.peer_last = gends[gid] if n else gends

    def _changed(self, names) -> "Any":
        """bool[n-1]: sorted row i+1 differs from i on any named column
        (nulls compare equal to nulls)."""
        import numpy as np

        n = self.n
        out = np.zeros(max(n - 1, 0), dtype=bool)
        for name in names:
            colv = self._st.column(name).take(pa.array(self.order))
            a, b = colv.slice(0, n - 1), colv.slice(1)
            eq = np.asarray(pc.fill_null(pc.equal(a, b), False))
            nulls = np.asarray(pc.is_null(colv))
            eq |= nulls[:-1] & nulls[1:]
            out |= ~eq
        return out

    def running(self, cum):
        """RANGE-frame running value from a global cumsum over sorted
        rows: the cumulative through the row's LAST PEER, minus
        everything before its partition."""
        import numpy as np

        prev = np.where(self.seg_first > 0,
                        cum[np.maximum(self.seg_first - 1, 0)], 0.0)
        return cum[self.peer_last] - prev

    def scatter(self, sorted_res, null_mask=None):
        """sorted-order values -> arrow array in original row order."""
        import numpy as np

        out = np.empty(self.n, dtype=np.asarray(sorted_res).dtype)
        out[self.order] = sorted_res
        if null_mask is None:
            return pa.array(out)
        m = np.empty(self.n, dtype=bool)
        m[self.order] = null_mask
        return pa.array(out, mask=m)

    def gather_arg(self, comp: Compiler, f, src_sorted, default):
        """Type-preserving gather of f's first argument by
        original-table row index (sorted-order indices; -1 = out of
        frame -> `default` or null)."""
        import numpy as np

        if not f.args:
            raise SQLError(f"{f.name}() needs an argument")
        base = comp.as_array(f.args[0])
        if isinstance(base, pa.ChunkedArray):
            base = base.combine_chunks()
        src = np.empty(self.n, dtype=np.int64)
        src[self.order] = src_sorted
        taken = base.take(pa.array(np.where(src < 0, 0, src)))
        missing = pa.array(src < 0)
        if default is not None:
            return pc.if_else(missing, pa.scalar(default, base.type),
                              taken)
        return pc.if_else(missing, pa.nulls(self.n, base.type), taken)


# ---------------------------------------------------------------------------
# small AST utilities
# ---------------------------------------------------------------------------

def _ordinal(v: int, n: int) -> int:
    """Validate a 1-based positional reference (ORDER BY 2, GROUP BY 1)."""
    if not 1 <= v <= n:
        raise SQLError(f"positional reference {v} out of range 1..{n}")
    return v


def _probe_scope(cols: List[str], alias: str) -> Scope:
    """A zero-row Scope for name resolution during predicate
    conversion (pushdown / DELETE), shared by both conversion sites."""
    return Scope(pa.table({f"{alias}.{c}": pa.array([], pa.null())
                           for c in cols}),
                 [f"{alias}.{c}" for c in cols])


def _split_conjuncts(e) -> List[Any]:
    if isinstance(e, ast.Binary) and e.op == "AND":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _equi_pair(e, probe: Scope, left: Scope, right: Scope
               ) -> Optional[Tuple[str, str]]:
    """`a.x = b.y` with one side in each scope -> (left_q, right_q)."""
    if not (isinstance(e, ast.Binary) and e.op == "=" and
            isinstance(e.left, ast.Column) and
            isinstance(e.right, ast.Column)):
        return None
    try:
        lq = probe.resolve(e.left)
        rq = probe.resolve(e.right)
    except SQLError:
        return None
    if lq in left.table.column_names and rq in right.table.column_names:
        return (lq, rq)
    if rq in left.table.column_names and lq in right.table.column_names:
        return (rq, lq)
    return None


def _parse_expr_full(text: str):
    """Parse a COMPLETE expression (trailing garbage is an error —
    Parser.expr() alone would silently stop early)."""
    from paimon_tpu_torch.sql.parser import Parser
    p = Parser(text)
    e = p.expr()
    if p.peek().kind != "EOF":
        raise SQLError(f"trailing input in expression at "
                       f"{p.peek().pos}: {text!r}")
    return e


def _transform(e, fn):
    """Bottom-up AST rewrite: fn(node) returns a replacement (or the
    node); children are rebuilt first."""
    import copy as _copy

    if isinstance(e, ast.Func):
        e = ast.Func(e.name, [_transform(a, fn) for a in e.args],
                     e.distinct,
                     None if e.over is None else ast.Window(
                         [_transform(p, fn)
                          for p in e.over.partition_by],
                         [(_transform(o, fn), asc)
                          for o, asc in e.over.order_by]))
    elif isinstance(e, ast.Binary):
        e = ast.Binary(e.op, _transform(e.left, fn),
                       _transform(e.right, fn))
    elif isinstance(e, ast.Unary):
        e = ast.Unary(e.op, _transform(e.operand, fn))
    elif isinstance(e, ast.Case):
        e = ast.Case([(_transform(c, fn), _transform(v, fn))
                      for c, v in e.whens],
                     None if e.default is None
                     else _transform(e.default, fn))
    elif isinstance(e, ast.Cast):
        e = ast.Cast(_transform(e.expr, fn), e.type_str)
    elif isinstance(e, ast.IsNull):
        e = ast.IsNull(_transform(e.expr, fn), e.negated)
    elif isinstance(e, ast.LikeExpr):
        e = ast.LikeExpr(_transform(e.expr, fn), e.pattern, e.negated)
    elif isinstance(e, ast.InList):
        e = ast.InList(_transform(e.expr, fn),
                       [_transform(v, fn) for v in e.values], e.negated)
    elif isinstance(e, ast.InSubquery):
        # the rewrite (UDF expansion, parameter substitution) applies
        # inside the subquery's expression positions too
        _rewrite_select_exprs(e.select, fn)
        e = ast.InSubquery(_transform(e.expr, fn), e.select, e.negated)
    elif isinstance(e, ast.ScalarSubquery):
        _rewrite_select_exprs(e.select, fn)
    elif isinstance(e, ast.ExistsSubquery):
        _rewrite_select_exprs(e.select, fn)
    elif isinstance(e, ast.BetweenExpr):
        e = ast.BetweenExpr(_transform(e.expr, fn),
                            _transform(e.lo, fn), _transform(e.hi, fn),
                            e.negated)
    else:
        e = _copy.copy(e) if isinstance(e, (ast.Column, ast.Literal,
                                            ast.Star)) else e
    return fn(e)


def _substitute_params(body, bindings: Dict[str, Any]):
    def rep(node):
        if isinstance(node, ast.Column) and node.qualifier is None and \
                node.name in bindings:
            return bindings[node.name]
        return node
    return _transform(body, rep)


def _rewrite_select_exprs(sel: "ast.Select", fn) -> None:
    """Apply an expression rewrite to every expression position of a
    Select tree, in place (recursing into subqueries/unions)."""
    sel.items = [ast.SelectItem(_transform(i.expr, fn), i.alias)
                 for i in sel.items]
    if sel.where is not None:
        sel.where = _transform(sel.where, fn)
    sel.group_by = [_transform(g, fn) for g in sel.group_by]
    if sel.having is not None:
        sel.having = _transform(sel.having, fn)
    sel.order_by = [(_transform(e, fn), asc, pl)
                    for e, asc, pl in sel.order_by]
    for j in sel.joins:
        if j.condition is not None:
            j.condition = _transform(j.condition, fn)
        if isinstance(j.right, ast.SubqueryRef):
            _rewrite_select_exprs(j.right.select, fn)
    if isinstance(sel.from_, ast.SubqueryRef):
        _rewrite_select_exprs(sel.from_.select, fn)
    if sel.union_all is not None:
        _rewrite_select_exprs(sel.union_all, fn)


def _purge_all(table) -> None:
    """One empty OVERWRITE commit dropping every live file (TRUNCATE
    TABLE and sys.purge_files share this)."""
    wb = table.new_batch_write_builder().with_overwrite()
    w = wb.new_write()
    try:
        wb.new_commit().commit(w.prepare_commit())
    finally:
        w.close()


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


def _row_keys(t: pa.Table):
    """Positional, hashable row keys for set-op comparison."""
    cols = [t.column(i).to_pylist() for i in range(t.num_columns)]
    for row in zip(*cols):
        yield tuple(_hashable(v) for v in row)


def _find_funcs(e, pred) -> List[ast.Func]:
    """Func nodes matching `pred`, top-down; a matched node's arguments
    are not descended into (no nested aggregates/windows)."""
    out: List[ast.Func] = []

    def walk(x):
        if isinstance(x, ast.Func):
            if pred(x):
                out.append(x)
                return
            for a in x.args:
                walk(a)
        elif isinstance(x, ast.Binary):
            walk(x.left)
            walk(x.right)
        elif isinstance(x, ast.Unary):
            walk(x.operand)
        elif isinstance(x, ast.Case):
            for c, v in x.whens:
                walk(c)
                walk(v)
            if x.default is not None:
                walk(x.default)
        elif isinstance(x, (ast.Cast, ast.IsNull, ast.LikeExpr,
                            ast.InList)):
            walk(x.expr)
        elif isinstance(x, ast.BetweenExpr):
            walk(x.expr)
            walk(x.lo)
            walk(x.hi)
    walk(e)
    return out


def _find_windows(e) -> List[ast.Func]:
    """Window-function nodes (any func with an OVER clause)."""
    return _find_funcs(e, lambda f: f.over is not None)


def _find_aggs(e) -> List[ast.Func]:
    """Plain aggregate calls (windowed aggregates are NOT aggregates)."""
    return _find_funcs(e, lambda f: f.name in _AGG_FUNCS and
                       f.over is None)


def _display_name(e) -> str:
    if isinstance(e, ast.Column):
        return e.name
    if isinstance(e, ast.Func):
        return e.name
    if isinstance(e, ast.Literal):
        return str(e.value)
    return "expr"


def _dedup(names: List[str]) -> List[str]:
    seen: Dict[str, int] = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out
