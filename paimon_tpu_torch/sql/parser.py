"""SQL tokenizer + recursive-descent parser.

Grammar coverage (what the reference surfaces through its SQL layers —
DataFusion in pypaimon, Flink/Spark SQL on the JVM; see
pypaimon/cli/cli_sql.py for the statement set the CLI drives):

  SELECT [DISTINCT] items FROM ref [JOIN ...] [WHERE] [GROUP BY]
      [HAVING] [ORDER BY] [LIMIT [OFFSET]] [UNION ALL ...]
  INSERT [OVERWRITE] INTO t [(cols)] VALUES (...) | SELECT ...
  CREATE TABLE [IF NOT EXISTS] t (col TYPE [NOT NULL] [COMMENT '..'], ..
      [, PRIMARY KEY (..)]) [PARTITIONED BY (..)] [WITH ('k'='v', ..)]
  CREATE DATABASE / DROP TABLE|DATABASE / SHOW / DESCRIBE / USE
  DELETE FROM t WHERE ..     UPDATE t SET c = e, .. [WHERE ..]
  ALTER TABLE t SET|RESET|ADD COLUMN|DROP COLUMN|RENAME COLUMN
  CALL sys.proc(args)        EXPLAIN SELECT ..

Time travel on a table reference: `t VERSION AS OF 3`,
`t VERSION AS OF 'tag'`, `t FOR SYSTEM_TIME AS OF TIMESTAMP '...'|millis`.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER",
    "LIMIT", "OFFSET", "AS", "AND", "OR", "NOT", "NULL", "IS", "IN",
    "BETWEEN", "LIKE", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE",
    "END", "CAST", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER",
    "CROSS", "ON", "UNION", "ALL", "INTERSECT", "EXCEPT", "ASC", "DESC",
    "NULLS", "FIRST", "LAST",
    "INSERT", "INTO", "OVERWRITE", "VALUES", "CREATE", "TABLE", "DATABASE",
    "IF", "EXISTS", "PRIMARY", "KEY", "ENFORCED", "PARTITIONED", "WITH",
    "COMMENT", "DROP", "SHOW", "TABLES", "DATABASES", "DESCRIBE", "DESC",
    "USE", "DELETE", "UPDATE", "SET", "RESET", "ALTER", "COLUMN", "RENAME",
    "TO", "CALL", "EXPLAIN", "VERSION", "OF", "FOR", "SYSTEM_TIME",
    "TIMESTAMP", "ADD", "TRUNCATE", "MERGE", "USING", "MATCHED", "THEN",
}


@dataclass
class Token:
    kind: str          # KEYWORD | IDENT | NUMBER | STRING | OP | EOF
    value: Any
    pos: int


class SQLError(ValueError):
    pass


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if text.startswith("--", i):
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise SQLError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j, buf = i + 1, []
            while j < n:
                if text[j] == "'" and j + 1 < n and text[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif text[j] == "'":
                    break
                else:
                    buf.append(text[j])
                    j += 1
            if j >= n:
                raise SQLError(f"unterminated string at {i}")
            toks.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '`' or c == '"':
            j = text.find(c, i + 1)
            if j < 0:
                raise SQLError(f"unterminated quoted identifier at {i}")
            toks.append(Token("IDENT", text[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n and (text[j].isdigit() or text[j] in ".eE+-"):
                if text[j] == ".":
                    if seen_dot:
                        break
                    seen_dot = True
                elif text[j] in "eE":
                    if seen_exp or j + 1 >= n or text[j + 1] not in \
                            "0123456789+-":
                        break
                    seen_exp = True
                elif text[j] in "+-" and text[j - 1] not in "eE":
                    break
                j += 1
            lit = text[i:j]
            toks.append(Token("NUMBER",
                              float(lit) if seen_dot or seen_exp
                              else int(lit), i))
            i = j
            continue
        if c.isalpha() or c == "_":
            # `$` allowed inside identifiers for system tables
            # (t$snapshots — reference table/system/SystemTableLoader.java)
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_$"):
                j += 1
            word = text[i:j]
            up = word.upper()
            if up in _KEYWORDS:
                toks.append(Token("KEYWORD", up, i))
            else:
                toks.append(Token("IDENT", word, i))
            i = j
            continue
        for op in ("<>", "!=", ">=", "<=", "||"):
            if text.startswith(op, i):
                toks.append(Token("OP", "<>" if op == "!=" else op, i))
                i += 2
                break
        else:
            if c in "+-*/%(),.=<>;[]":
                toks.append(Token("OP", c, i))
                i += 1
            else:
                raise SQLError(f"unexpected character {c!r} at {i}")
    toks.append(Token("EOF", None, n))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Literal:
    value: Any


@dataclass
class Column:
    name: str
    qualifier: Optional[str] = None

    def key(self):
        return f"{self.qualifier}.{self.name}" if self.qualifier \
            else self.name


@dataclass
class Star:
    qualifier: Optional[str] = None


@dataclass
class Unary:
    op: str            # NOT | NEG
    operand: Any


@dataclass
class Binary:
    op: str            # + - * / % = <> < <= > >= AND OR ||
    left: Any
    right: Any


@dataclass
class Window:
    partition_by: List[Any] = field(default_factory=list)
    order_by: List[Tuple[Any, bool]] = field(default_factory=list)


@dataclass
class Func:
    name: str
    args: List[Any]
    distinct: bool = False
    over: Optional[Window] = None       # window function when set


@dataclass
class Case:
    whens: List[Tuple[Any, Any]]
    default: Optional[Any]


@dataclass
class Cast:
    expr: Any
    type_str: str


@dataclass
class InList:
    expr: Any
    values: List[Any]
    negated: bool = False


@dataclass
class InSubquery:
    """x [NOT] IN (SELECT ...) — uncorrelated; materialized to an
    InList by the executor before evaluation."""
    expr: Any
    select: Any
    negated: bool = False


@dataclass
class ScalarSubquery:
    """(SELECT expr FROM ...) in expression position — uncorrelated;
    must return one column and at most one row (NULL when empty)."""
    select: Any


@dataclass
class ExistsSubquery:
    """[NOT] EXISTS (SELECT ...). Uncorrelated: evaluated once.
    Correlated on a single outer-column equality: decorrelated to a
    semi-join-shaped IN by the executor."""
    select: Any
    negated: bool = False


@dataclass
class BetweenExpr:
    expr: Any
    lo: Any
    hi: Any
    negated: bool = False


@dataclass
class LikeExpr:
    expr: Any
    pattern: str
    negated: bool = False


@dataclass
class IsNull:
    expr: Any
    negated: bool = False


@dataclass
class SelectItem:
    expr: Any
    alias: Optional[str] = None


@dataclass
class TableRef:
    name: str                      # possibly db-qualified "db.t"
    alias: Optional[str] = None
    snapshot_id: Optional[int] = None
    tag: Optional[str] = None
    timestamp_ms: Optional[int] = None


@dataclass
class Truncate:
    table: str


@dataclass
class MergeClause:
    """WHEN [NOT] MATCHED [AND cond] THEN action."""
    matched: bool
    condition: Optional[Any]
    action: str                    # update | delete | insert
    assignments: List[Tuple[str, Any]] = field(default_factory=list)
    insert_columns: Optional[List[str]] = None
    insert_values: List[Any] = field(default_factory=list)


@dataclass
class MergeInto:
    target: str
    target_alias: Optional[str]
    source: Any                    # TableRef | SubqueryRef
    on: Any
    clauses: List[MergeClause] = field(default_factory=list)


@dataclass
class SubqueryRef:
    select: "Select"
    alias: str


@dataclass
class JoinClause:
    kind: str                      # inner | left outer | right outer |
    right: Any                     # full outer | cross
    condition: Optional[Any]


def _apply_ctes(sel: "Select", ctes: Dict[str, "Select"]) -> "Select":
    """Replace references to CTE names with subqueries, in place,
    recursing through nested subqueries, UNION branches AND selects
    embedded in expressions (IN (SELECT ...)). A time-traveled
    reference (VERSION AS OF ...) is never a CTE."""
    import copy as _copy
    import dataclasses as _dc

    def rewrite(ref):
        if isinstance(ref, TableRef) and ref.name in ctes and \
                ref.snapshot_id is None and ref.tag is None and \
                ref.timestamp_ms is None:
            return SubqueryRef(select=_copy.deepcopy(ctes[ref.name]),
                               alias=ref.alias or ref.name)
        if isinstance(ref, SubqueryRef):
            _apply_ctes(ref.select, ctes)
        return ref

    def walk_expr(e):
        if isinstance(e, Select):
            _apply_ctes(e, ctes)
        elif isinstance(e, (list, tuple)):
            for x in e:
                walk_expr(x)
        elif _dc.is_dataclass(e) and not isinstance(e, type):
            for f in _dc.fields(e):
                walk_expr(getattr(e, f.name))

    if sel.from_ is not None:
        sel.from_ = rewrite(sel.from_)
    for j in sel.joins:
        j.right = rewrite(j.right)
        walk_expr(j.condition)
    for item in sel.items:
        walk_expr(item.expr)
    walk_expr(sel.where)
    walk_expr(sel.group_by)
    walk_expr(sel.having)
    walk_expr([e for e, _, _ in sel.order_by])
    if sel.union_all is not None:
        _apply_ctes(sel.union_all, ctes)
    return sel


@dataclass
class Select:
    items: List[SelectItem]
    from_: Optional[Any] = None    # TableRef | SubqueryRef
    joins: List[JoinClause] = field(default_factory=list)
    where: Optional[Any] = None
    group_by: List[Any] = field(default_factory=list)
    having: Optional[Any] = None
    order_by: List[Tuple[Any, bool, str]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    union_all: Optional["Select"] = None   # right branch of a set-op
    setop: str = "union_all"               # union_all|union|intersect|except


@dataclass
class Insert:
    table: str
    columns: Optional[List[str]]
    rows: Optional[List[List[Any]]]      # VALUES
    select: Optional[Select]             # INSERT .. SELECT
    overwrite: bool = False


@dataclass
class ColumnDef:
    name: str
    type_str: str
    comment: Optional[str] = None


@dataclass
class CreateTable:
    table: str
    columns: List[ColumnDef]
    primary_key: List[str]
    partitioned_by: List[str]
    options: dict
    if_not_exists: bool = False
    comment: Optional[str] = None


@dataclass
class CreateDatabase:
    name: str
    if_not_exists: bool = False


@dataclass
class CreateView:
    name: str
    query_text: str
    select: "Select"
    or_replace: bool = False
    comment: Optional[str] = None


@dataclass
class DropView:
    name: str
    if_exists: bool = False


@dataclass
class CreateFunction:
    name: str
    params: List[Tuple[str, str]]          # (name, type string)
    return_type: Optional[str]
    body: str                              # sql-dialect expression
    or_replace: bool = False
    comment: Optional[str] = None


@dataclass
class DropFunction:
    name: str
    if_exists: bool = False


@dataclass
class ShowFunctions:
    database: Optional[str] = None


@dataclass
class ShowViews:
    database: Optional[str] = None


@dataclass
class DropTable:
    table: str
    if_exists: bool = False


@dataclass
class DropDatabase:
    name: str
    if_exists: bool = False


@dataclass
class ShowTables:
    database: Optional[str] = None


@dataclass
class ShowDatabases:
    pass


@dataclass
class ShowCreateTable:
    table: str


@dataclass
class Describe:
    table: str


@dataclass
class Use:
    database: str


@dataclass
class Delete:
    table: str
    where: Optional[Any]


@dataclass
class Update:
    table: str
    assignments: List[Tuple[str, Any]]
    where: Optional[Any]


@dataclass
class AlterTable:
    table: str
    action: str        # set-options | reset | add-column | drop-column |
    payload: Any       # rename-column


@dataclass
class Call:
    procedure: str
    args: List[Any]


@dataclass
class Explain:
    select: Select


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.accept_kw(kw):
            raise SQLError(f"expected {kw}, got {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "OP" and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise SQLError(f"expected {op!r}, got {self.peek().value!r}")

    def at_word(self, word: str) -> bool:
        """Contextual (non-reserved) keyword: an IDENT matching `word`
        case-insensitively (VIEW/VIEWS/REPLACE/OVER/PARTITION stay
        usable as identifiers and function names)."""
        t = self.peek()
        return t.kind == "IDENT" and t.value.upper() == word

    def accept_word(self, word: str) -> bool:
        if self.at_word(word):
            self.next()
            return True
        return False

    def ident(self) -> str:
        t = self.next()
        if t.kind == "IDENT":
            return t.value
        # non-reserved use of keywords as identifiers (e.g. a column
        # named "comment" or "key")
        if t.kind == "KEYWORD" and t.value in (
                "COMMENT", "KEY", "TABLES", "DATABASES", "VERSION", "ALL",
                "FIRST", "LAST", "TIMESTAMP", "SET", "TRUNCATE",
                "MERGE", "USING", "MATCHED"):
            return t.value.lower()
        raise SQLError(f"expected identifier, got {t.value!r}")

    def qualified_name(self) -> str:
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        return ".".join(parts)

    # -- entry --------------------------------------------------------------
    def parse(self):
        stmt = self.statement()
        self.accept_op(";")
        if self.peek().kind != "EOF":
            raise SQLError(f"trailing input at {self.peek().pos}")
        return stmt

    def statement(self):
        if self.at_kw("SELECT") or self.at_kw("WITH"):
            return self.select_or_with()
        if self.accept_kw("EXPLAIN"):
            return Explain(self.select_or_with())
        if self.accept_kw("INSERT"):
            return self.insert()
        if self.accept_kw("CREATE"):
            return self.create()
        if self.accept_kw("DROP"):
            return self.drop()
        if self.accept_kw("SHOW"):
            return self.show()
        if self.accept_kw("DESCRIBE") or (
                self.at_kw("DESC") and self.peek(1).kind in ("IDENT",)):
            self.accept_kw("DESC")
            return Describe(self.qualified_name())
        if self.accept_kw("USE"):
            return Use(self.ident())
        if self.accept_kw("MERGE"):
            return self.merge_into()
        if self.accept_kw("TRUNCATE"):
            self.expect_kw("TABLE")
            return Truncate(self.qualified_name())
        if self.accept_kw("DELETE"):
            self.expect_kw("FROM")
            tbl = self.qualified_name()
            where = self.expr() if self.accept_kw("WHERE") else None
            return Delete(tbl, where)
        if self.accept_kw("UPDATE"):
            return self.update()
        if self.accept_kw("ALTER"):
            return self.alter()
        if self.accept_kw("CALL"):
            return self.call()
        raise SQLError(f"unsupported statement start: {self.peek().value!r}")

    # -- MERGE INTO ---------------------------------------------------------
    def merge_into(self) -> MergeInto:
        """MERGE INTO target [AS] t USING source [AS] s ON cond
        WHEN MATCHED [AND c] THEN UPDATE SET col=e,.. | DELETE
        WHEN NOT MATCHED [AND c] THEN INSERT [(cols)] VALUES (e,..)
        (reference MergeIntoProcedure / flink MERGE INTO)."""
        self.expect_kw("INTO")
        target = self.qualified_name()
        target_alias = None
        if self.accept_kw("AS") or self.peek().kind == "IDENT":
            target_alias = self.ident()
        self.expect_kw("USING")
        if self.accept_op("("):
            sub = self.select_or_with()
            self.expect_op(")")
            self.accept_kw("AS")
            source = SubqueryRef(sub, self.ident())
        else:
            source = TableRef(self.qualified_name())
            if self.accept_kw("AS") or self.peek().kind == "IDENT":
                source.alias = self.ident()
        self.expect_kw("ON")
        on = self.expr()
        clauses: List[MergeClause] = []
        while self.accept_kw("WHEN"):
            matched = not self.accept_kw("NOT")
            self.expect_kw("MATCHED")
            cond = self.expr() if self.accept_kw("AND") else None
            self.expect_kw("THEN")
            if matched and self.accept_kw("UPDATE"):
                self.expect_kw("SET")
                assigns = [(self.ident(),
                            (self.expect_op("="), self.expr())[1])]
                while self.accept_op(","):
                    assigns.append((self.ident(),
                                    (self.expect_op("="),
                                     self.expr())[1]))
                clauses.append(MergeClause(True, cond, "update",
                                           assignments=assigns))
            elif matched and self.accept_kw("DELETE"):
                clauses.append(MergeClause(True, cond, "delete"))
            elif not matched and self.accept_kw("INSERT"):
                cols = None
                if self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("VALUES")
                self.expect_op("(")
                vals = [self.expr()]
                while self.accept_op(","):
                    vals.append(self.expr())
                self.expect_op(")")
                clauses.append(MergeClause(False, cond, "insert",
                                           insert_columns=cols,
                                           insert_values=vals))
            else:
                raise SQLError(
                    "WHEN MATCHED takes UPDATE SET or DELETE; "
                    "WHEN NOT MATCHED takes INSERT")
        if not clauses:
            raise SQLError("MERGE INTO needs at least one WHEN clause")
        return MergeInto(target, target_alias, source, on, clauses)

    # -- WITH (common table expressions) ------------------------------------
    def with_select(self) -> Select:
        """WITH name AS (select) [, name2 AS (select)] select —
        desugared at parse time: references to a CTE name in FROM/JOIN
        positions become subqueries (reference SQL front-ends treat
        non-recursive CTEs exactly as named subqueries)."""
        self.expect_kw("WITH")
        ctes: Dict[str, Select] = {}
        while True:
            name = self.ident()
            if name in ctes:
                raise SQLError(
                    f"WITH query name {name!r} specified more than once")
            self.expect_kw("AS")
            self.expect_op("(")
            sub = self.select()
            self.expect_op(")")
            # earlier CTEs are visible inside later bodies; the dict
            # only grows after this call returns
            _apply_ctes(sub, ctes)
            ctes[name] = sub
            if not self.accept_op(","):
                break
        return _apply_ctes(self.select(), ctes)

    def select_or_with(self) -> Select:
        """A query body anywhere a SELECT is accepted (INSERT ...
        SELECT, CREATE VIEW ... AS, EXPLAIN): WITH is valid there in
        every reference front-end."""
        return self.with_select() if self.at_kw("WITH") else self.select()

    # -- SELECT -------------------------------------------------------------
    def select(self) -> Select:
        self.expect_kw("SELECT")
        s = Select(items=[])
        s.distinct = self.accept_kw("DISTINCT")
        s.items.append(self.select_item())
        while self.accept_op(","):
            s.items.append(self.select_item())
        if self.accept_kw("FROM"):
            s.from_ = self.table_factor()
            while True:
                kind = self.join_kind()
                if kind is None:
                    break
                right = self.table_factor()
                cond = self.expr() if kind != "cross" and \
                    self.accept_kw("ON") else None
                s.joins.append(JoinClause(kind, right, cond))
        if self.accept_kw("WHERE"):
            s.where = self.expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            s.group_by.append(self.expr())
            while self.accept_op(","):
                s.group_by.append(self.expr())
        if self.accept_kw("HAVING"):
            s.having = self.expr()
        setop = None
        if self.accept_kw("UNION"):
            if self.accept_kw("ALL"):
                setop = "union_all"
            else:
                self.accept_kw("DISTINCT")
                setop = "union"
        elif self.accept_kw("INTERSECT"):
            self.accept_kw("DISTINCT")
            setop = "intersect"
        elif self.accept_kw("EXCEPT"):
            self.accept_kw("DISTINCT")
            setop = "except"
        if setop is not None:
            right = self.select()
            # the recursive parse is right-associative; SQL set-ops are
            # LEFT-associative with INTERSECT binding tighter. Chains of
            # one associative op (union all / union / intersect) give
            # identical results either way; anything else would return
            # silently wrong rows — refuse with a workaround.
            if right.union_all is not None and \
                    (right.setop != setop or setop == "except"):
                raise SQLError(
                    "chained mixed or EXCEPT set operations are not "
                    "supported directly; parenthesize via a subquery: "
                    "SELECT * FROM (a <op> b) t <op> c")
            s.union_all = right
            s.setop = setop
            # a trailing ORDER BY / LIMIT binds to the WHOLE set-op;
            # the recursive parse attached it to the right branch
            # (which itself already hoisted from any deeper chain)
            s.order_by, right.order_by = right.order_by, []
            s.limit, right.limit = right.limit, None
            s.offset, right.offset = right.offset, None
            return s
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            s.order_by.append(self.order_item())
            while self.accept_op(","):
                s.order_by.append(self.order_item())
        if self.accept_kw("LIMIT"):
            s.limit = int(self._number())
            if self.accept_kw("OFFSET"):
                s.offset = int(self._number())
        return s

    def _number(self):
        t = self.next()
        if t.kind != "NUMBER":
            raise SQLError(f"expected number, got {t.value!r}")
        return t.value

    def order_item(self):
        e = self.expr()
        asc = True
        if self.accept_kw("DESC"):
            asc = False
        else:
            self.accept_kw("ASC")
        placement = "at_end"
        if self.accept_kw("NULLS"):
            placement = "at_start" if self.accept_kw("FIRST") else \
                (self.expect_kw("LAST") or "at_end")
        return (e, asc, placement)

    def select_item(self) -> SelectItem:
        if self.accept_op("*"):
            return SelectItem(Star())
        # qualified star: ident . *
        if self.peek().kind == "IDENT" and \
                self.peek(1).kind == "OP" and self.peek(1).value == "." and \
                self.peek(2).kind == "OP" and self.peek(2).value == "*":
            q = self.ident()
            self.next()
            self.next()
            return SelectItem(Star(q))
        e = self.expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind == "IDENT":
            alias = self.ident()
        return SelectItem(e, alias)

    def join_kind(self) -> Optional[str]:
        if self.accept_kw("JOIN") or (self.at_kw("INNER") and
                                      (self.next(), self.expect_kw("JOIN"))):
            return "inner"
        if self.at_kw("LEFT"):
            self.next()
            self.accept_kw("OUTER")
            self.expect_kw("JOIN")
            return "left outer"
        if self.at_kw("RIGHT"):
            self.next()
            self.accept_kw("OUTER")
            self.expect_kw("JOIN")
            return "right outer"
        if self.at_kw("FULL"):
            self.next()
            self.accept_kw("OUTER")
            self.expect_kw("JOIN")
            return "full outer"
        if self.at_kw("CROSS"):
            self.next()
            self.expect_kw("JOIN")
            return "cross"
        return None

    def table_factor(self):
        if self.accept_op("("):
            sub = self.select()
            self.expect_op(")")
            self.accept_kw("AS")
            return SubqueryRef(sub, self.ident())
        name = self.qualified_name()
        ref = TableRef(name)
        if self.accept_kw("VERSION"):
            self.expect_kw("AS")
            self.expect_kw("OF")
            t = self.next()
            if t.kind == "NUMBER":
                ref.snapshot_id = int(t.value)
            elif t.kind == "STRING":
                ref.tag = t.value
            else:
                raise SQLError("VERSION AS OF expects a snapshot id or tag")
        elif self.accept_kw("FOR"):
            self.expect_kw("SYSTEM_TIME")
            self.expect_kw("AS")
            self.expect_kw("OF")
            self.accept_kw("TIMESTAMP")
            t = self.next()
            if t.kind == "NUMBER":
                ref.timestamp_ms = int(t.value)
            elif t.kind == "STRING":
                import datetime as _dt
                dt = _dt.datetime.fromisoformat(t.value)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=_dt.timezone.utc)
                ref.timestamp_ms = int(dt.timestamp() * 1000)
            else:
                raise SQLError("FOR SYSTEM_TIME AS OF expects a timestamp")
        if self.accept_kw("AS"):
            ref.alias = self.ident()
        elif self.peek().kind == "IDENT":
            ref.alias = self.ident()
        return ref

    # -- expressions (precedence climbing) ----------------------------------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.accept_kw("OR"):
            left = Binary("OR", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.accept_kw("AND"):
            left = Binary("AND", left, self.not_expr())
        return left

    def not_expr(self):
        if self.at_kw("NOT") and self.peek(1).kind == "KEYWORD" and \
                self.peek(1).value == "EXISTS":
            self.next()
            return self._exists(negated=True)
        if self.accept_kw("NOT"):
            return Unary("NOT", self.not_expr())
        if self.at_kw("EXISTS") and self.peek(1).kind == "OP" and \
                self.peek(1).value == "(":
            return self._exists(negated=False)
        return self.comparison()

    def _exists(self, negated: bool) -> "ExistsSubquery":
        self.expect_kw("EXISTS")
        self.expect_op("(")
        sub = self.select_or_with()
        self.expect_op(")")
        return ExistsSubquery(sub, negated)

    def comparison(self):
        left = self.additive()
        negated = self.accept_kw("NOT")
        if self.accept_kw("IS"):
            neg2 = self.accept_kw("NOT")
            self.expect_kw("NULL")
            return IsNull(left, negated=neg2 or negated)
        if self.accept_kw("IN"):
            self.expect_op("(")
            if self.at_kw("SELECT") or self.at_kw("WITH"):
                sub = self.select_or_with()
                self.expect_op(")")
                return InSubquery(left, sub, negated)
            vals = [self.expr()]
            while self.accept_op(","):
                vals.append(self.expr())
            self.expect_op(")")
            return InList(left, vals, negated)
        if self.accept_kw("BETWEEN"):
            lo = self.additive()
            self.expect_kw("AND")
            hi = self.additive()
            return BetweenExpr(left, lo, hi, negated)
        if self.accept_kw("LIKE"):
            t = self.next()
            if t.kind != "STRING":
                raise SQLError("LIKE expects a string pattern")
            return LikeExpr(left, t.value, negated)
        if negated:
            raise SQLError("dangling NOT before comparison")
        for op in ("=", "<>", "<=", ">=", "<", ">"):
            if self.accept_op(op):
                return Binary(op, left, self.additive())
        return left

    def additive(self):
        left = self.multiplicative()
        while True:
            if self.accept_op("+"):
                left = Binary("+", left, self.multiplicative())
            elif self.accept_op("-"):
                left = Binary("-", left, self.multiplicative())
            elif self.accept_op("||"):
                left = Binary("||", left, self.multiplicative())
            else:
                return left

    def multiplicative(self):
        left = self.unary()
        while True:
            if self.accept_op("*"):
                left = Binary("*", left, self.unary())
            elif self.accept_op("/"):
                left = Binary("/", left, self.unary())
            elif self.accept_op("%"):
                left = Binary("%", left, self.unary())
            else:
                return left

    def unary(self):
        if self.accept_op("-"):
            return Unary("NEG", self.unary())
        self.accept_op("+")
        return self.primary()

    def primary(self):
        t = self.peek()
        if t.kind == "NUMBER" or t.kind == "STRING":
            self.next()
            return Literal(t.value)
        if t.kind == "KEYWORD":
            if self.accept_kw("NULL"):
                return Literal(None)
            if self.accept_kw("TRUE"):
                return Literal(True)
            if self.accept_kw("FALSE"):
                return Literal(False)
            if self.accept_kw("CASE"):
                return self.case_expr()
            if self.accept_kw("CAST"):
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("AS")
                type_str = self.type_string()
                self.expect_op(")")
                return Cast(e, type_str)
            if self.accept_kw("TIMESTAMP"):
                s = self.next()
                if s.kind != "STRING":
                    raise SQLError("TIMESTAMP literal expects a string")
                import datetime as _dt
                return Literal(_dt.datetime.fromisoformat(s.value))
        if self.accept_op("("):
            if self.at_kw("SELECT") or self.at_kw("WITH"):
                # scalar subquery: (SELECT max(x) FROM t) in expression
                # position — materialized to a Literal by the executor
                sub = self.select_or_with()
                self.expect_op(")")
                return ScalarSubquery(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "IDENT" or (t.kind == "KEYWORD" and t.value in (
                "COMMENT", "KEY", "VERSION", "FIRST", "LAST",
                "TRUNCATE", "MERGE", "USING", "MATCHED")):
            name = self.ident()
            if name.upper() in ("ARRAY", "MAP") and \
                    self.peek().kind == "OP" and self.peek().value == "[":
                # ARRAY[e1, ...] / MAP[k1, v1, ...] constructors
                self.next()
                args = []
                if not (self.peek().kind == "OP" and
                        self.peek().value == "]"):
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                self.expect_op("]")
                return Func(name.lower(), args)
            if self.accept_op("("):
                return self.func_call(name)
            if self.peek().kind == "OP" and self.peek().value == "." and \
                    self.peek(1).kind in ("IDENT", "KEYWORD"):
                self.next()
                col = self.ident()
                if self.accept_op("("):
                    return self.func_call(f"{name}.{col}")
                return Column(col, qualifier=name)
            return Column(name)
        raise SQLError(f"unexpected token {t.value!r} at {t.pos}")

    def func_call(self, name: str):
        distinct = self.accept_kw("DISTINCT")
        args: List[Any] = []
        if self.accept_op("*"):
            args.append(Star())
        elif not (self.peek().kind == "OP" and self.peek().value == ")"):
            args.append(self.expr())
            while self.accept_op(","):
                args.append(self.expr())
        self.expect_op(")")
        over = None
        if self.peek().kind == "IDENT" and \
                self.peek().value.upper() == "OVER":
            self.next()
            self.expect_op("(")
            over = Window()
            if self.peek().kind == "IDENT" and \
                    self.peek().value.upper() == "PARTITION":
                self.next()
                self.expect_kw("BY")
                over.partition_by.append(self.expr())
                while self.accept_op(","):
                    over.partition_by.append(self.expr())
            if self.accept_kw("ORDER"):
                self.expect_kw("BY")
                while True:
                    e = self.expr()
                    asc = True
                    if self.accept_kw("DESC"):
                        asc = False
                    else:
                        self.accept_kw("ASC")
                    over.order_by.append((e, asc))
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
        return Func(name.lower(), args, distinct, over)

    def case_expr(self):
        whens = []
        # simple CASE (CASE x WHEN v THEN r) rewritten to searched form
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expr()
        while self.accept_kw("WHEN"):
            cond = self.expr()
            if operand is not None:
                cond = Binary("=", operand, cond)
            self.expect_kw("THEN")
            whens.append((cond, self.expr()))
        default = self.expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        return Case(whens, default)

    def type_string(self) -> str:
        """Consume a type name (possibly parameterized / NOT NULL) and
        return it as the string form `types.parse_data_type` accepts."""
        parts = []
        t = self.next()
        if t.kind not in ("IDENT", "KEYWORD"):
            raise SQLError(f"expected type name, got {t.value!r}")
        parts.append(str(t.value).upper())
        name = parts[0]
        # parameterized complex types: ARRAY<T>, MAP<K, V>, MULTISET<T>,
        # ROW<name T, ...>, VECTOR<T, n> (reference DataTypeJsonParser grammar)
        if name in ("ARRAY", "MULTISET", "MAP", "ROW", "VECTOR") and \
                self.peek().kind == "OP" and self.peek().value in ("<", "("):
            open_op = self.next().value
            close_op = ">" if open_op == "<" else ")"
            inner = []
            if name == "ROW":
                while True:
                    fname = self.ident()
                    ftype = self.type_string()
                    inner.append(f"{fname} {ftype}")
                    if not self.accept_op(","):
                        break
            elif name == "MAP":
                inner.append(self.type_string())
                self.expect_op(",")
                inner.append(self.type_string())
            elif name == "VECTOR":
                inner.append(self.type_string())
                self.expect_op(",")
                inner.append(str(int(self._number())))
            else:
                inner.append(self.type_string())
            self.expect_op(close_op)
            out = f"{name}<{', '.join(inner)}>"
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                out += " NOT NULL"
            return out
        # multi-word types: DOUBLE PRECISION, TIMESTAMP WITH LOCAL TIME ZONE
        while self.peek().kind == "IDENT" and \
                self.peek().value.upper() in ("PRECISION", "WITH", "LOCAL",
                                              "TIME", "ZONE", "VARYING"):
            parts.append(self.next().value.upper())
        if self.accept_op("("):
            nums = [str(int(self._number()))]
            while self.accept_op(","):
                nums.append(str(int(self._number())))
            self.expect_op(")")
            parts[-1] += f"({', '.join(nums)})"
        if self.accept_kw("NOT"):
            self.expect_kw("NULL")
            parts.append("NOT NULL")
        return " ".join(parts)

    # -- INSERT / CREATE / ALTER / CALL -------------------------------------
    def insert(self) -> Insert:
        overwrite = self.accept_kw("OVERWRITE")
        if not overwrite:
            self.expect_kw("INTO")
        else:
            self.accept_kw("INTO")
        table = self.qualified_name()
        columns = None

        def at_paren_select() -> bool:
            return self.peek().kind == "OP" and \
                self.peek().value == "(" and \
                self.peek(1).kind == "KEYWORD" and \
                self.peek(1).value == "SELECT"

        if self.peek().kind == "OP" and self.peek().value == "(" and \
                not at_paren_select():
            self.next()
            columns = [self.ident()]
            while self.accept_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        if self.accept_kw("VALUES"):
            rows = [self.value_row()]
            while self.accept_op(","):
                rows.append(self.value_row())
            return Insert(table, columns, rows, None, overwrite)
        if at_paren_select():
            # INSERT INTO t [(cols)] (SELECT ...)
            self.next()
            sel = self.select_or_with()
            self.expect_op(")")
            return Insert(table, columns, None, sel, overwrite)
        return Insert(table, columns, None, self.select_or_with(),
                      overwrite)

    def value_row(self) -> List[Any]:
        self.expect_op("(")
        row = [self.expr()]
        while self.accept_op(","):
            row.append(self.expr())
        self.expect_op(")")
        return row

    def create(self):
        if self.accept_kw("DATABASE"):
            ine = False
            if self.accept_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            return CreateDatabase(self.ident(), ine)
        or_replace = False
        if self.accept_kw("OR"):
            if not self.accept_word("REPLACE"):
                raise SQLError("expected REPLACE after CREATE OR")
            or_replace = True
        if self.accept_word("VIEW"):
            name = self.qualified_name()
            comment = None
            if self.accept_kw("COMMENT"):
                t = self.next()
                comment = t.value
            self.expect_kw("AS")
            start = self.peek().pos
            sel = self.select_or_with()
            return CreateView(name, self.text[start:].rstrip().rstrip(";"),
                              sel, or_replace, comment)
        if self.accept_word("FUNCTION"):
            name = self.qualified_name()
            params = []
            self.expect_op("(")
            if not (self.peek().kind == "OP" and
                    self.peek().value == ")"):
                while True:
                    pname = self.ident()
                    params.append((pname, self.type_string()))
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            rtype = None
            if self.accept_word("RETURNS"):
                rtype = self.type_string()
            comment = None
            if self.accept_kw("COMMENT"):
                comment = self.next().value
            self.expect_kw("AS")
            t = self.next()
            if t.kind != "STRING":
                raise SQLError("CREATE FUNCTION body must be a string "
                               "expression: AS 'expr over params'")
            return CreateFunction(name, params, rtype, t.value,
                                  or_replace, comment)
        if or_replace:
            raise SQLError("OR REPLACE is only valid for CREATE "
                           "VIEW/FUNCTION")
        self.expect_kw("TABLE")
        ine = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            ine = True
        table = self.qualified_name()
        self.expect_op("(")
        columns: List[ColumnDef] = []
        pk: List[str] = []
        while True:
            if self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                self.expect_op("(")
                pk.append(self.ident())
                while self.accept_op(","):
                    pk.append(self.ident())
                self.expect_op(")")
                if self.accept_kw("NOT"):
                    self.expect_kw("ENFORCED")
            else:
                name = self.ident()
                type_str = self.type_string()
                comment = None
                if self.accept_kw("COMMENT"):
                    t = self.next()
                    if t.kind != "STRING":
                        raise SQLError("COMMENT expects a string")
                    comment = t.value
                columns.append(ColumnDef(name, type_str, comment))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        comment = None
        if self.accept_kw("COMMENT"):
            t = self.next()
            comment = t.value
        partitioned: List[str] = []
        if self.accept_kw("PARTITIONED"):
            self.expect_kw("BY")
            self.expect_op("(")
            partitioned.append(self.ident())
            while self.accept_op(","):
                partitioned.append(self.ident())
            self.expect_op(")")
        options: dict = {}
        if self.accept_kw("WITH"):
            self.expect_op("(")
            while True:
                k = self.next()
                self.expect_op("=")
                v = self.next()
                if k.kind != "STRING" or v.kind != "STRING":
                    raise SQLError("WITH options must be 'key' = 'value'")
                options[k.value] = v.value
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return CreateTable(table, columns, pk, partitioned, options, ine,
                           comment)

    def drop(self):
        if self.accept_kw("DATABASE"):
            ie = self._if_exists()
            return DropDatabase(self.ident(), ie)
        if self.accept_word("VIEW"):
            ie = self._if_exists()
            return DropView(self.qualified_name(), ie)
        if self.accept_word("FUNCTION"):
            ie = self._if_exists()
            return DropFunction(self.qualified_name(), ie)
        self.expect_kw("TABLE")
        ie = self._if_exists()
        return DropTable(self.qualified_name(), ie)

    def _if_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def show(self):
        if self.accept_kw("DATABASES"):
            return ShowDatabases()
        if self.accept_kw("TABLES"):
            db = None
            if self.accept_kw("FROM") or self.accept_kw("IN"):
                db = self.ident()
            return ShowTables(db)
        if self.accept_word("VIEWS"):
            db = None
            if self.accept_kw("FROM") or self.accept_kw("IN"):
                db = self.ident()
            return ShowViews(db)
        if self.accept_word("FUNCTIONS"):
            db = None
            if self.accept_kw("FROM") or self.accept_kw("IN"):
                db = self.ident()
            return ShowFunctions(db)
        if self.accept_kw("CREATE"):
            self.expect_kw("TABLE")
            return ShowCreateTable(self.qualified_name())
        raise SQLError("SHOW expects DATABASES | TABLES | VIEWS | "
                       "CREATE TABLE")

    def update(self) -> Update:
        table = self.qualified_name()
        self.expect_kw("SET")
        assignments = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assignments.append((col, self.expr()))
            if not self.accept_op(","):
                break
        where = self.expr() if self.accept_kw("WHERE") else None
        return Update(table, assignments, where)

    def alter(self) -> AlterTable:
        self.expect_kw("TABLE")
        table = self.qualified_name()
        if self.accept_kw("SET"):
            self.expect_op("(")
            opts = {}
            while True:
                k = self.next()
                self.expect_op("=")
                v = self.next()
                opts[k.value] = v.value
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return AlterTable(table, "set-options", opts)
        if self.accept_kw("RESET"):
            self.expect_op("(")
            keys = [self.next().value]
            while self.accept_op(","):
                keys.append(self.next().value)
            self.expect_op(")")
            return AlterTable(table, "reset", keys)
        if self.accept_kw("ADD"):
            self.accept_kw("COLUMN")
            name = self.ident()
            return AlterTable(table, "add-column",
                              ColumnDef(name, self.type_string()))
        if self.accept_kw("DROP"):
            self.accept_kw("COLUMN")
            return AlterTable(table, "drop-column", self.ident())
        if self.accept_kw("RENAME"):
            self.accept_kw("COLUMN")
            old = self.ident()
            self.expect_kw("TO")
            return AlterTable(table, "rename-column", (old, self.ident()))
        raise SQLError("unsupported ALTER TABLE action")

    def call(self) -> Call:
        proc = self.qualified_name()
        self.expect_op("(")
        args: List[Any] = []
        if not (self.peek().kind == "OP" and self.peek().value == ")"):
            args.append(self._call_arg())
            while self.accept_op(","):
                args.append(self._call_arg())
        self.expect_op(")")
        return Call(proc, args)

    def _call_arg(self):
        t = self.next()
        if t.kind in ("STRING", "NUMBER"):
            return t.value
        if t.kind == "KEYWORD" and t.value in ("TRUE", "FALSE"):
            return t.value == "TRUE"
        if t.kind == "KEYWORD" and t.value == "NULL":
            return None
        raise SQLError("CALL arguments must be literals")


def parse(text: str):
    return Parser(text).parse()
