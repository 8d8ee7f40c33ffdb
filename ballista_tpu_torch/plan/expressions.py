"""Logical expression IR.

The expression vocabulary is scoped to what the TPC-H/TPC-DS query classes
need (the reference outsources this to DataFusion; see SURVEY.md §1 "engine
under it all"): column refs, literals, arithmetic/comparison/boolean ops,
CASE, casts, LIKE, IN, BETWEEN, scalar functions (date EXTRACT/substr/...),
aggregate functions, and subquery placeholders that the optimizer
decorrelates into joins before execution.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
from dataclasses import dataclass, field, replace
from typing import Any, Sequence

import pyarrow as pa

from ballista_tpu_torch.errors import PlanningError, SchemaError
from ballista_tpu_torch.plan.schema import DFField, DFSchema


class Expr:
    """Base logical expression."""

    def children(self) -> list["Expr"]:
        return []

    def with_children(self, children: list["Expr"]) -> "Expr":
        assert not children
        return self

    def data_type(self, schema: DFSchema) -> pa.DataType:
        raise NotImplementedError(type(self).__name__)

    def nullable(self, schema: DFSchema) -> bool:
        return True

    def output_name(self) -> str:
        return str(self)

    # -- convenience builders (DataFrame API surface) -----------------------
    def __add__(self, other: Any) -> "Expr":
        return BinaryExpr(self, "+", lit(other))

    def __sub__(self, other: Any) -> "Expr":
        return BinaryExpr(self, "-", lit(other))

    def __mul__(self, other: Any) -> "Expr":
        return BinaryExpr(self, "*", lit(other))

    def __truediv__(self, other: Any) -> "Expr":
        return BinaryExpr(self, "/", lit(other))

    def __gt__(self, other: Any) -> "Expr":
        return BinaryExpr(self, ">", lit(other))

    def __ge__(self, other: Any) -> "Expr":
        return BinaryExpr(self, ">=", lit(other))

    def __lt__(self, other: Any) -> "Expr":
        return BinaryExpr(self, "<", lit(other))

    def __le__(self, other: Any) -> "Expr":
        return BinaryExpr(self, "<=", lit(other))

    def eq(self, other: Any) -> "Expr":
        return BinaryExpr(self, "=", lit(other))

    def neq(self, other: Any) -> "Expr":
        return BinaryExpr(self, "<>", lit(other))

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    def is_null(self) -> "Expr":
        return IsNull(self)

    def sort(self, ascending: bool = True, nulls_first: bool | None = None) -> "SortKey":
        return SortKey(self, ascending, nulls_first if nulls_first is not None else not ascending)


def lit(v: Any) -> "Expr":
    if isinstance(v, Expr):
        return v
    return Literal(v)


@dataclass(frozen=True)
class Column(Expr):
    name: str
    qualifier: str | None = None

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return schema.field(schema.index_of(self.name, self.qualifier)).dtype

    def nullable(self, schema: DFSchema) -> bool:
        return schema.field(schema.index_of(self.name, self.qualifier)).nullable

    def output_name(self) -> str:
        return self.name

    def __str__(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name


def col(name: str) -> Column:
    if "." in name:
        q, n = name.rsplit(".", 1)
        return Column(n, q)
    return Column(name)


@dataclass(frozen=True)
class Literal(Expr):
    value: Any
    # parameter slot assigned by the serving tier's plan normalizer
    # (serving/normalize.py). Excluded from equality/repr so tagged plans
    # stay indistinguishable from untagged ones everywhere else.
    param: int | None = field(default=None, compare=False, repr=False)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return literal_type(self.value)

    def nullable(self, schema: DFSchema) -> bool:
        return self.value is None

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return f"'{self.value}'"
        if isinstance(self.value, _dt.date):
            return f"DATE '{self.value.isoformat()}'"
        return str(self.value)


def literal_type(v: Any) -> pa.DataType:
    if v is None:
        return pa.null()
    if isinstance(v, bool):
        return pa.bool_()
    if isinstance(v, int):
        return pa.int64()
    if isinstance(v, float):
        return pa.float64()
    if isinstance(v, _decimal.Decimal):
        # minimal precision/scale from the digits (pa.scalar's own typing):
        # tight literal types keep decimal arithmetic chains under the
        # precision caps — the lynchpin of the exact-decimal policy
        return pa.scalar(v).type
    if isinstance(v, str):
        return pa.string()
    if isinstance(v, _dt.date):
        return pa.date32()
    raise PlanningError(f"unsupported literal {v!r}")


_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}
_BOOL_OPS = {"and", "or"}
_ARITH_OPS = {"+", "-", "*", "/", "%"}


@dataclass(frozen=True)
class BinaryExpr(Expr):
    left: Expr
    op: str  # one of _CMP_OPS | _BOOL_OPS | _ARITH_OPS
    right: Expr

    def children(self) -> list[Expr]:
        return [self.left, self.right]

    def with_children(self, children: list[Expr]) -> "Expr":
        return BinaryExpr(children[0], self.op, children[1])

    def data_type(self, schema: DFSchema) -> pa.DataType:
        if self.op in _CMP_OPS or self.op in _BOOL_OPS:
            return pa.bool_()
        lt, rt = self.left.data_type(schema), self.right.data_type(schema)
        if pa.types.is_decimal(lt) or pa.types.is_decimal(rt):
            return decimal_arith_type(self.left, self.right, lt, rt, self.op)
        return arith_result_type(lt, rt, self.op)

    def __str__(self) -> str:
        op = self.op.upper() if self.op in _BOOL_OPS else self.op
        return f"({self.left} {op} {self.right})"


def arith_result_type(lt: pa.DataType, rt: pa.DataType, op: str) -> pa.DataType:
    # date +/- interval days → date
    if pa.types.is_date(lt):
        return lt
    if pa.types.is_date(rt):
        return rt
    if pa.types.is_floating(lt) or pa.types.is_floating(rt) or op == "/":
        return pa.float64()
    if pa.types.is_decimal(lt) or pa.types.is_decimal(rt):
        # value-blind fallback (callers without the exprs); BinaryExpr uses
        # the value-aware decimal_arith_type instead
        return decimal_arith_type(None, None, lt, rt, op)
    return pa.int64()


def _effective_decimal(expr: "Expr | None", t: pa.DataType):
    """(precision, scale) a side contributes to Arrow's decimal arithmetic.
    Integer LITERALS get minimal digits — matching the evaluator, which
    re-types them as tight decimal scalars (ops/phys_expr.py) so chains like
    price*(1-disc)*(1+tax) stay inside the 38/76 precision caps. Non-literal
    integers take Arrow's own widths (int64→(19,0) etc.)."""
    if pa.types.is_decimal(t):
        return t.precision, t.scale
    if expr is not None and isinstance(expr, Literal) and isinstance(expr.value, int) \
            and not isinstance(expr.value, bool):
        return max(1, len(str(abs(expr.value)))), 0
    if pa.types.is_integer(t):
        return {1: 3, 2: 5, 4: 10, 8: 19}.get(t.bit_width // 8, 19), 0
    return None  # float/other: not a decimal operand


def sum_result_type(t: pa.DataType) -> pa.DataType:
    """SUM output typing, shared by aggregates, window functions and the
    physical planner's accumulator schema (one rule — they must agree).
    Exact decimal sums widen to max precision (DataFusion's rule; keeps
    billion-row money sums from overflowing the input type)."""
    if pa.types.is_integer(t):
        return pa.int64()
    if pa.types.is_decimal128(t):
        return pa.decimal128(38, t.scale)
    if pa.types.is_decimal256(t):
        return pa.decimal256(76, t.scale)
    return pa.float64()


def decimal_arith_type(le: "Expr | None", re: "Expr | None",
                       lt: pa.DataType, rt: pa.DataType, op: str) -> pa.DataType:
    """Arrow's decimal result-type rules (exact decimal policy — reference
    behavior: DataFusion decimal128 exactness, SURVEY §7 hard-part #2).
    Division and chains past decimal256's cap degrade to float64; the
    evaluator mirrors every branch (ops/phys_expr.py::_decimal_binop)."""
    if op in ("/", "%"):
        return pa.float64()
    l = _effective_decimal(le, lt)
    r = _effective_decimal(re, rt)
    if l is None or r is None:  # mixed with float → float64 (Arrow promotes)
        return pa.float64()
    (lp, ls), (rp, rs) = l, r
    if op == "*":
        p, s = lp + rp + 1, ls + rs
    else:  # + -
        s = max(ls, rs)
        p = max(lp - ls, rp - rs) + s + 1
    if p <= 38 and not pa.types.is_decimal256(lt) and not pa.types.is_decimal256(rt):
        return pa.decimal128(p, s)
    if p <= 76:
        return pa.decimal256(min(p, 76), s)
    return pa.float64()


def and_(*exprs: Expr) -> Expr:
    exprs = [e for e in exprs if e is not None]
    if not exprs:
        raise PlanningError("and_ of nothing")
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryExpr(out, "and", e)
    return out


def split_conjunction(e: Expr) -> list[Expr]:
    if isinstance(e, BinaryExpr) and e.op == "and":
        return split_conjunction(e.left) + split_conjunction(e.right)
    return [e]


@dataclass(frozen=True)
class Not(Expr):
    expr: Expr

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return Not(c[0])

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        return f"NOT {self.expr}"


@dataclass(frozen=True)
class Negative(Expr):
    expr: Expr

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return Negative(c[0])

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return self.expr.data_type(schema)

    def __str__(self) -> str:
        return f"(- {self.expr})"


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return IsNull(c[0])

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def nullable(self, schema: DFSchema) -> bool:
        return False

    def __str__(self) -> str:
        return f"{self.expr} IS NULL"


@dataclass(frozen=True)
class IsNotNull(Expr):
    expr: Expr

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return IsNotNull(c[0])

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def nullable(self, schema: DFSchema) -> bool:
        return False

    def __str__(self) -> str:
        return f"{self.expr} IS NOT NULL"


@dataclass(frozen=True)
class Alias(Expr):
    expr: Expr
    name: str

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return Alias(c[0], self.name)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return self.expr.data_type(schema)

    def nullable(self, schema: DFSchema) -> bool:
        return self.expr.nullable(schema)

    def output_name(self) -> str:
        return self.name

    def __str__(self) -> str:
        return f"{self.expr} AS {self.name}"


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    to: pa.DataType

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return Cast(c[0], self.to)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return self.to

    def nullable(self, schema: DFSchema) -> bool:
        return self.expr.nullable(schema)

    def __str__(self) -> str:
        return f"CAST({self.expr} AS {self.to})"


@dataclass(frozen=True)
class Like(Expr):
    expr: Expr
    pattern: str  # SQL LIKE pattern with % and _
    negated: bool = False

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return Like(c[0], self.pattern, self.negated)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        n = " NOT" if self.negated else ""
        return f"{self.expr}{n} LIKE '{self.pattern}'"


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    values: tuple[Any, ...]  # python scalars
    negated: bool = False

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return InList(c[0], self.values, self.negated)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        n = " NOT" if self.negated else ""
        vals = ", ".join(repr(v) if not isinstance(v, str) else f"'{v}'" for v in self.values)
        return f"{self.expr}{n} IN ({vals})"


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def children(self) -> list[Expr]:
        return [self.expr, self.low, self.high]

    def with_children(self, c: list[Expr]) -> "Expr":
        return Between(c[0], c[1], c[2], self.negated)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        n = " NOT" if self.negated else ""
        return f"{self.expr}{n} BETWEEN {self.low} AND {self.high}"


@dataclass(frozen=True)
class Case(Expr):
    """CASE [expr] WHEN .. THEN .. ELSE .. END (searched form only after binding)."""

    branches: tuple[tuple[Expr, Expr], ...]  # (when_predicate, then_value)
    else_expr: Expr | None = None

    def children(self) -> list[Expr]:
        out: list[Expr] = []
        for w, t in self.branches:
            out.extend((w, t))
        if self.else_expr is not None:
            out.append(self.else_expr)
        return out

    def with_children(self, c: list[Expr]) -> "Expr":
        n = len(self.branches)
        branches = tuple((c[2 * i], c[2 * i + 1]) for i in range(n))
        els = c[2 * n] if self.else_expr is not None else None
        return Case(branches, els)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        t = self.branches[0][1].data_type(schema)
        if pa.types.is_null(t) and self.else_expr is not None:
            return self.else_expr.data_type(schema)
        # numeric widening across branches
        for _, then in self.branches[1:]:
            t = _widen(t, then.data_type(schema))
        if self.else_expr is not None:
            t = _widen(t, self.else_expr.data_type(schema))
        return t

    def __str__(self) -> str:
        parts = ["CASE"]
        for w, t in self.branches:
            parts.append(f"WHEN {w} THEN {t}")
        if self.else_expr is not None:
            parts.append(f"ELSE {self.else_expr}")
        parts.append("END")
        return " ".join(parts)


def _widen(a: pa.DataType, b: pa.DataType) -> pa.DataType:
    if a == b:
        return a
    if pa.types.is_null(a):
        return b
    if pa.types.is_null(b):
        return a
    if pa.types.is_decimal(a) or pa.types.is_decimal(b):
        # CASE branches mixing decimal with numerics: two decimals widen to
        # cover both (integer digits and scale); decimal+int grows integer
        # digits by Arrow's int width; decimal+float falls to float64
        def dims(t):
            if pa.types.is_decimal(t):
                return t.precision - t.scale, t.scale
            if pa.types.is_integer(t):
                return {8: 3, 16: 5, 32: 10, 64: 19}.get(t.bit_width, 19), 0
            return None
        da, db = dims(a), dims(b)
        if da is None or db is None:
            return pa.float64()
        ints, scale = max(da[0], db[0]), max(da[1], db[1])
        p = ints + scale
        if p <= 38 and not pa.types.is_decimal256(a) and not pa.types.is_decimal256(b):
            return pa.decimal128(p, scale)
        if p <= 76:
            return pa.decimal256(p, scale)
        return pa.float64()
    if (pa.types.is_integer(a) or pa.types.is_floating(a)) and (
        pa.types.is_integer(b) or pa.types.is_floating(b)
    ):
        if pa.types.is_floating(a) or pa.types.is_floating(b):
            return pa.float64()
        return pa.int64()
    return a


@dataclass(frozen=True)
class ScalarFunction(Expr):
    """Named scalar function; the registry in ops/ defines evaluation."""

    name: str  # extract_year, substr, strpos, length, abs, round, coalesce, date_part...
    args: tuple[Expr, ...]

    def children(self) -> list[Expr]:
        return list(self.args)

    def with_children(self, c: list[Expr]) -> "Expr":
        return ScalarFunction(self.name, tuple(c))

    def data_type(self, schema: DFSchema) -> pa.DataType:
        n = self.name
        if n in ("extract_year", "extract_month", "extract_day", "strpos", "length"):
            return pa.int64()
        if n in ("substr", "upper", "lower", "trim", "concat"):
            return pa.string()
        if n in ("abs", "round", "ceil", "floor"):
            return self.args[0].data_type(schema)
        if n == "sqrt":
            return pa.float64()
        if n == "coalesce":
            for a in self.args:
                t = a.data_type(schema)
                if not pa.types.is_null(t):
                    return t
            return pa.null()
        if n == "date_trunc":
            return pa.date32()
        from ballista_tpu_torch import udf

        u = udf.resolve(n)
        if u is not None:
            return u.return_type
        raise PlanningError(f"unknown scalar function {n}")

    def __str__(self) -> str:
        return f"{self.name}({', '.join(map(str, self.args))})"


WINDOW_FUNCS = ("row_number", "rank", "dense_rank", "lag", "lead",
                "sum", "avg", "min", "max", "count")


@dataclass(frozen=True)
class WindowFunction(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [frame]).

    Default frame follows SQL: with ORDER BY, aggregates run RANGE
    UNBOUNDED PRECEDING..CURRENT ROW (peers share); without, the whole
    partition. `frame` = ("rows", start, end) for explicit ROWS frames:
    offsets relative to the current row (negative = preceding, None =
    unbounded in that direction)."""

    func: str  # one of WINDOW_FUNCS
    args: tuple  # aggregates: (expr,) or (); lag/lead: (expr[, offset[, default]])
    partition_by: tuple = ()
    order_by: tuple = ()  # SortKey tuple
    frame: tuple | None = None  # ("rows", start|None, end|None)

    def children(self) -> list["Expr"]:
        return list(self.args) + list(self.partition_by) + [k.expr for k in self.order_by]

    def with_children(self, c: list["Expr"]) -> "Expr":
        na = len(self.args)
        np_ = len(self.partition_by)
        keys = tuple(
            SortKey(e, k.ascending, k.nulls_first)
            for e, k in zip(c[na + np_:], self.order_by)
        )
        return WindowFunction(
            self.func, tuple(c[:na]), tuple(c[na:na + np_]), keys, self.frame
        )

    def data_type(self, schema: DFSchema) -> pa.DataType:
        if self.func in ("row_number", "rank", "dense_rank", "count"):
            return pa.int64()
        if self.func == "avg":
            return pa.float64()
        t = self.args[0].data_type(schema)
        if self.func == "sum":
            return sum_result_type(t)
        return t

    def __str__(self) -> str:
        a = ", ".join(map(str, self.args))
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " + ", ".join(map(str, self.partition_by)))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(map(str, self.order_by)))
        if self.frame is not None:
            def b(v, side):
                if v is None:
                    return f"UNBOUNDED {side}"
                if v == 0:
                    return "CURRENT ROW"
                return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"

            parts.append(
                f"ROWS BETWEEN {b(self.frame[1], 'PRECEDING')} AND {b(self.frame[2], 'FOLLOWING')}"
            )
        return f"{self.func}({a}) OVER ({' '.join(parts)})"


AGG_FUNCS = ("sum", "avg", "min", "max", "count", "count_distinct",
             "stddev_samp", "stddev_pop", "var_samp", "var_pop")

# aggregates whose result is always float64 (decomposed into Welford
# (count, mean, M2) partials by the physical planner — see _plan_aggregate)
VARIANCE_FUNCS = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")


@dataclass(frozen=True)
class AggregateFunction(Expr):
    func: str  # one of AGG_FUNCS
    arg: Expr | None  # None for count(*)
    distinct: bool = False

    def children(self) -> list[Expr]:
        return [self.arg] if self.arg is not None else []

    def with_children(self, c: list[Expr]) -> "Expr":
        return AggregateFunction(self.func, c[0] if c else None, self.distinct)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        if self.func in ("count", "count_distinct"):
            return pa.int64()
        if self.func == "avg" or self.func in VARIANCE_FUNCS:
            return pa.float64()
        assert self.arg is not None
        t = self.arg.data_type(schema)
        if self.func == "sum":
            return sum_result_type(t)
        return t

    def output_name(self) -> str:
        return str(self)

    def __str__(self) -> str:
        if self.arg is None:
            return "count(*)"
        d = "DISTINCT " if self.distinct or self.func == "count_distinct" else ""
        f = "count" if self.func == "count_distinct" else self.func
        return f"{f}({d}{self.arg})"


@dataclass(frozen=True)
class SortKey:
    """Not an Expr — ordering spec used by Sort nodes."""

    expr: Expr
    ascending: bool = True
    nulls_first: bool = False

    def __str__(self) -> str:
        d = "ASC" if self.ascending else "DESC"
        n = " NULLS FIRST" if self.nulls_first else ""
        return f"{self.expr} {d}{n}"


# -- subquery placeholders (removed by the decorrelation optimizer) ---------


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    plan: Any  # LogicalPlan; Any to avoid circular import

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return self.plan.schema.field(0).dtype

    def __str__(self) -> str:
        return "(<scalar subquery>)"


@dataclass(frozen=True)
class InSubquery(Expr):
    expr: Expr
    plan: Any
    negated: bool = False

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, c: list[Expr]) -> "Expr":
        return InSubquery(c[0], self.plan, self.negated)

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        n = " NOT" if self.negated else ""
        return f"{self.expr}{n} IN (<subquery>)"


@dataclass(frozen=True)
class Exists(Expr):
    plan: Any
    negated: bool = False

    def data_type(self, schema: DFSchema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        n = "NOT " if self.negated else ""
        return f"{n}EXISTS (<subquery>)"


# -- tree utilities ---------------------------------------------------------


def transform_expr(e: Expr, fn) -> Expr:
    """Bottom-up rewrite."""
    kids = e.children()
    if kids:
        new_kids = [transform_expr(k, fn) for k in kids]
        # identity, not equality: rewrites may swap in nodes that compare
        # equal to the originals (e.g. Literal carries non-compared metadata)
        if any(a is not b for a, b in zip(new_kids, kids)):
            e = e.with_children(new_kids)
    return fn(e)


def expr_any(e: Expr, pred) -> bool:
    if pred(e):
        return True
    return any(expr_any(c, pred) for c in e.children())


def collect_columns(e: Expr, out: set | None = None) -> set:
    if out is None:
        out = set()
    if isinstance(e, Column):
        out.add(e)
    for c in e.children():
        collect_columns(c, out)
    # subquery plans keep their own columns; outer refs handled by decorrelator
    return out


def to_field(e: Expr, schema: DFSchema) -> DFField:
    # Plain column references keep their qualifier through projections so
    # self-join disambiguation (e.g. lineitem l1 vs l2) survives SELECT *.
    qualifier = e.qualifier if isinstance(e, Column) else None
    return DFField(e.output_name(), e.data_type(schema), e.nullable(schema), qualifier)
