"""Predicate tree: file pruning on stats + Arrow row filtering.

reference: paimon-common/.../predicate/ (Predicate.java, LeafPredicate,
CompoundPredicate, PredicateBuilder, ~30 LeafFunctions). Each predicate
does double duty: `test_stats` decides whether a file can contain matches
(min/max/null-count pruning) and `to_arrow` emits a pyarrow.compute
expression evaluated vectorized over row batches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import pyarrow.compute as pc
import pyarrow.dataset as ds

__all__ = ["Predicate", "PredicateBuilder", "equal", "not_equal",
           "greater_than", "greater_or_equal", "less_than", "less_or_equal",
           "is_null", "is_not_null", "in_", "not_in", "between",
           "starts_with", "and_", "or_", "not_"]


class Predicate:
    def test_stats(self, mins: Dict[str, Any], maxs: Dict[str, Any],
                   null_counts: Dict[str, int], row_count: int) -> bool:
        """May the file contain matching rows? Conservative: True unless
        provably empty."""
        raise NotImplementedError

    def test_row(self, row: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def to_arrow(self) -> ds.Expression:
        raise NotImplementedError

    def fields(self) -> List[str]:
        raise NotImplementedError

    def __and__(self, other):
        return and_(self, other)

    def __or__(self, other):
        return or_(self, other)

    def __invert__(self):
        return not_(self)


class Leaf(Predicate):
    def __init__(self, op: str, field: str, literal: Any = None):
        self.op = op
        self.field = field
        self.literal = literal

    def fields(self):
        return [self.field]

    def __repr__(self):
        return f"{self.field} {self.op} {self.literal!r}"

    # -- stats pruning -------------------------------------------------------

    def test_stats(self, mins, maxs, null_counts, row_count):
        mn = mins.get(self.field)
        mx = maxs.get(self.field)
        nc = null_counts.get(self.field)
        op, lit = self.op, self.literal
        if op == "is_null":
            return nc is None or nc > 0
        if op == "is_not_null":
            return nc is None or row_count == 0 or nc < row_count
        if mn is None or mx is None:
            return True  # no stats -> cannot prune
        try:
            if op == "eq":
                return mn <= lit <= mx
            if op == "ne":
                return not (mn == lit == mx)
            if op == "lt":
                return mn < lit
            if op == "le":
                return mn <= lit
            if op == "gt":
                return mx > lit
            if op == "ge":
                return mx >= lit
            if op == "in":
                return any(mn <= v <= mx for v in lit)
            if op == "not_in":
                return not (mn == mx and mn in lit)
            if op == "between":
                lo, hi = lit
                return not (mx < lo or mn > hi)
            if op == "starts_with":
                return (str(mn)[:len(lit)] <= lit <= str(mx)[:len(lit)])
        except TypeError:
            return True
        return True

    # -- row eval ------------------------------------------------------------

    def test_row(self, row):
        v = row.get(self.field)
        op, lit = self.op, self.literal
        if op == "is_null":
            return v is None
        if op == "is_not_null":
            return v is not None
        if v is None:
            return False
        if op == "eq":
            return v == lit
        if op == "ne":
            return v != lit
        if op == "lt":
            return v < lit
        if op == "le":
            return v <= lit
        if op == "gt":
            return v > lit
        if op == "ge":
            return v >= lit
        if op == "in":
            return v in lit
        if op == "not_in":
            return v not in lit
        if op == "between":
            return lit[0] <= v <= lit[1]
        if op == "starts_with":
            return str(v).startswith(lit)
        raise ValueError(f"Unknown op {op}")

    def to_arrow(self):
        f = ds.field(self.field)
        op, lit = self.op, self.literal
        if op == "eq":
            return f == lit
        if op == "ne":
            return f != lit
        if op == "lt":
            return f < lit
        if op == "le":
            return f <= lit
        if op == "gt":
            return f > lit
        if op == "ge":
            return f >= lit
        if op == "is_null":
            return f.is_null()
        if op == "is_not_null":
            return f.is_valid()
        if op == "in":
            return f.isin(list(lit))
        if op == "not_in":
            return ~f.isin(list(lit))
        if op == "between":
            return (f >= lit[0]) & (f <= lit[1])
        if op == "starts_with":
            return pc.starts_with(f, lit)
        raise ValueError(f"Unknown op {op}")


def conjunctive_equalities(pred):
    """[(field, literal)] for every equality that must hold for a row to
    match (eq leaves reachable through AND nodes only) — the conditions a
    per-file bloom filter may safely prune on."""
    out = []
    if isinstance(pred, Leaf):
        if pred.op == "eq":
            out.append((pred.field, pred.literal))
    elif isinstance(pred, Compound) and pred.op == "and":
        for c in pred.children:
            out.extend(conjunctive_equalities(c))
    return out


def conjunctive_bounds(pred, field: str):
    """Inclusive (lo, hi) value bounds that must hold on `field` for a
    row to match, folded from every range/equality leaf reachable
    through AND nodes only; either side may be None (unbounded).
    Returns None when the predicate puts NO usable bound on the field —
    callers must then keep everything.  This is the manifest-level
    vectorized prune's contract: the bounds are necessary conditions,
    so dropping a manifest whose [min,max] misses [lo,hi] can never
    drop a match (OR nodes contribute nothing, conservatively)."""
    lo = hi = None

    def fold(lo, hi, new_lo, new_hi):
        if new_lo is not None and (lo is None or new_lo > lo):
            lo = new_lo
        if new_hi is not None and (hi is None or new_hi < hi):
            hi = new_hi
        return lo, hi

    if isinstance(pred, Leaf):
        v = pred.literal
        if pred.op == "eq" and v is not None:
            lo, hi = fold(lo, hi, v, v)
        elif pred.op in ("gt", "ge") and v is not None:
            lo, hi = fold(lo, hi, v, None)
        elif pred.op in ("lt", "le") and v is not None:
            lo, hi = fold(lo, hi, None, v)
        elif pred.op == "in" and v and all(x is not None for x in v):
            try:
                lo, hi = fold(lo, hi, min(v), max(v))
            except TypeError:
                return None
        else:
            return None
        if pred.field != field:
            return None
        return lo, hi
    if isinstance(pred, Compound) and pred.op == "and":
        found = False
        for c in pred.children:
            b = conjunctive_bounds(c, field)
            if b is not None:
                found = True
                try:
                    lo, hi = fold(lo, hi, b[0], b[1])
                except TypeError:
                    return None
        return (lo, hi) if found else None
    return None


class Compound(Predicate):
    def __init__(self, op: str, children: Sequence[Predicate]):
        assert op in ("and", "or", "not")
        self.op = op
        self.children = list(children)

    def fields(self):
        out = []
        for c in self.children:
            out.extend(c.fields())
        return out

    def __repr__(self):
        if self.op == "not":
            return f"NOT({self.children[0]!r})"
        return ("(" + f" {self.op.upper()} ".join(map(repr, self.children))
                + ")")

    def test_stats(self, mins, maxs, null_counts, row_count):
        if self.op == "and":
            return all(c.test_stats(mins, maxs, null_counts, row_count)
                       for c in self.children)
        if self.op == "or":
            return any(c.test_stats(mins, maxs, null_counts, row_count)
                       for c in self.children)
        return True  # NOT cannot prune safely on min/max

    def test_row(self, row):
        if self.op == "and":
            return all(c.test_row(row) for c in self.children)
        if self.op == "or":
            return any(c.test_row(row) for c in self.children)
        return not self.children[0].test_row(row)

    def to_arrow(self):
        exprs = [c.to_arrow() for c in self.children]
        if self.op == "and":
            out = exprs[0]
            for e in exprs[1:]:
                out = out & e
            return out
        if self.op == "or":
            out = exprs[0]
            for e in exprs[1:]:
                out = out | e
            return out
        return ~exprs[0]


# -- builders ----------------------------------------------------------------

def equal(field: str, v) -> Predicate:
    return Leaf("eq", field, v)


def not_equal(field: str, v) -> Predicate:
    return Leaf("ne", field, v)


def less_than(field: str, v) -> Predicate:
    return Leaf("lt", field, v)


def less_or_equal(field: str, v) -> Predicate:
    return Leaf("le", field, v)


def greater_than(field: str, v) -> Predicate:
    return Leaf("gt", field, v)


def greater_or_equal(field: str, v) -> Predicate:
    return Leaf("ge", field, v)


def is_null(field: str) -> Predicate:
    return Leaf("is_null", field)


def is_not_null(field: str) -> Predicate:
    return Leaf("is_not_null", field)


def in_(field: str, values) -> Predicate:
    return Leaf("in", field, list(values))


def not_in(field: str, values) -> Predicate:
    return Leaf("not_in", field, list(values))


def between(field: str, lo, hi) -> Predicate:
    return Leaf("between", field, (lo, hi))


def starts_with(field: str, prefix: str) -> Predicate:
    return Leaf("starts_with", field, prefix)


def and_(*ps: Predicate) -> Predicate:
    flat = [p for p in ps if p is not None]
    if len(flat) == 1:
        return flat[0]
    return Compound("and", flat)


def or_(*ps: Predicate) -> Predicate:
    flat = [p for p in ps if p is not None]
    if len(flat) == 1:
        return flat[0]
    return Compound("or", flat)


def not_(p: Predicate) -> Predicate:
    return Compound("not", [p])


class PredicateBuilder:
    """Field-index-aware builder mirroring the reference's PredicateBuilder
    API shape (field names here, not indices)."""

    def __init__(self, row_type=None):
        self.row_type = row_type

    equal = staticmethod(equal)
    not_equal = staticmethod(not_equal)
    less_than = staticmethod(less_than)
    less_or_equal = staticmethod(less_or_equal)
    greater_than = staticmethod(greater_than)
    greater_or_equal = staticmethod(greater_or_equal)
    is_null = staticmethod(is_null)
    is_not_null = staticmethod(is_not_null)
    in_ = staticmethod(in_)
    not_in = staticmethod(not_in)
    between = staticmethod(between)
    starts_with = staticmethod(starts_with)
    and_ = staticmethod(and_)
    or_ = staticmethod(or_)
    not_ = staticmethod(not_)
