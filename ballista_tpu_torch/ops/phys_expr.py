"""Physical expressions: index-bound, evaluated over Arrow RecordBatches.

`bind_expr` compiles a logical Expr against a DFSchema into a PhysicalExpr
tree whose `evaluate(batch)` returns a pyarrow Array (CPU engine path).
The TPU engine compiles the same logical exprs to jax instead
(ops/tpu/stage_compiler.py); keeping binding separate per engine is the
moral equivalent of the reference's create_physical_expr seam.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.errors import ExecutionError, PlanningError
from ballista_tpu_torch.plan.expressions import (
    Alias,
    Between,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Expr,
    InList,
    IsNotNull,
    IsNull,
    Like,
    Literal,
    Negative,
    Not,
    ScalarFunction,
)
from ballista_tpu_torch.plan.schema import DFSchema


class PhysicalExpr:
    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        raise NotImplementedError

    def __str__(self) -> str:
        return type(self).__name__


@dataclass
class Col(PhysicalExpr):
    index: int
    name: str

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return batch.column(self.index)

    def __str__(self) -> str:
        return f"{self.name}@{self.index}"


@dataclass
class Lit(PhysicalExpr):
    value: Any

    def evaluate(self, batch: pa.RecordBatch):
        return pa.scalar(self.value)

    def __str__(self) -> str:
        return repr(self.value)


_ARITH = {
    "+": pc.add_checked if hasattr(pc, "add_checked") else pc.add,
    "-": pc.subtract,
    "*": pc.multiply,
    "/": pc.divide,
    "%": lambda a, b: pc.subtract(a, pc.multiply(pc.floor(pc.divide(a, b)), b)),
}
_CMP = {
    "=": pc.equal, "<>": pc.not_equal, "<": pc.less,
    "<=": pc.less_equal, ">": pc.greater, ">=": pc.greater_equal,
}


@dataclass
class BinOp(PhysicalExpr):
    left: PhysicalExpr
    op: str
    right: PhysicalExpr
    # planned arith result type (decimal policy): stamped by bind_expr so
    # runtime coercion reproduces exactly what the planner typed; None for
    # comparisons/bools and pre-decimal callers
    out_type: pa.DataType | None = None

    def evaluate(self, batch: pa.RecordBatch):
        l = self.left.evaluate(batch)
        r = self.right.evaluate(batch)
        if self.op in _CMP:
            return _CMP[self.op](l, r)
        if self.op == "and":
            return pc.and_kleene(l, r)
        if self.op == "or":
            return pc.or_kleene(l, r)
        if pa.types.is_decimal(_type_of(l)) or pa.types.is_decimal(_type_of(r)):
            return _decimal_binop(self.op, l, r, self.out_type)
        if self.op == "+":
            return pc.add(l, r)
        if self.op == "-":
            return pc.subtract(l, r)
        if self.op == "*":
            return pc.multiply(l, r)
        if self.op == "/":
            if pa.types.is_integer(_type_of(l)):
                l = pc.cast(l, pa.float64())
            return pc.divide(l, r)
        if self.op == "%":
            return _ARITH["%"](l, r)
        raise ExecutionError(f"bad op {self.op}")

    def __str__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


def _type_of(v) -> pa.DataType:
    return v.type


def _decimal_binop(op: str, l, r, planned: pa.DataType | None):
    """Exact decimal arithmetic mirroring decimal_arith_type's branches
    (plan/expressions.py). Planned float64 ⇒ compute in float (division,
    float operands, precision overflow past decimal256). Planned decimal ⇒
    re-type integer-literal scalars tightly, lift decimal128 inputs to
    decimal256 when the planned type is, and pin the kernel's result to the
    planned type so batch schemas never drift from the plan."""
    import decimal as _d

    if planned is None and op in ("/", "%"):
        # a pre-decimal caller (bind-time typing failed): these ops always
        # compute in float under the exact policy anyway
        planned = pa.float64()
    if planned is not None and pa.types.is_floating(planned):
        if pa.types.is_decimal(l.type):
            l = pc.cast(l, pa.float64())
        if pa.types.is_decimal(r.type):
            r = pc.cast(r, pa.float64())
        if op == "/" and pa.types.is_integer(l.type):
            l = pc.cast(l, pa.float64())
        return _ARITH[op](l, r) if op == "%" else {
            "+": pc.add, "-": pc.subtract, "*": pc.multiply, "/": pc.divide}[op](l, r)

    def tighten(v):
        # integer literal scalar → minimal decimal (the planner's
        # _effective_decimal counterpart)
        if isinstance(v, pa.Scalar) and pa.types.is_integer(v.type):
            return pa.scalar(_d.Decimal(v.as_py()))
        return v

    l, r = tighten(l), tighten(r)
    if planned is not None and pa.types.is_decimal256(planned):
        if pa.types.is_decimal128(l.type):
            l = pc.cast(l, pa.decimal256(l.type.precision, l.type.scale))
        if pa.types.is_decimal128(r.type):
            r = pc.cast(r, pa.decimal256(r.type.precision, r.type.scale))
    out = {"+": pc.add, "-": pc.subtract, "*": pc.multiply}[op](l, r)
    if planned is not None and out.type != planned:
        out = pc.cast(out, planned)
    return out


@dataclass
class NotOp(PhysicalExpr):
    child: PhysicalExpr

    def evaluate(self, batch):
        return pc.invert(self.child.evaluate(batch))


@dataclass
class NegOp(PhysicalExpr):
    child: PhysicalExpr

    def evaluate(self, batch):
        return pc.negate(self.child.evaluate(batch))


@dataclass
class IsNullOp(PhysicalExpr):
    child: PhysicalExpr

    def evaluate(self, batch):
        return pc.is_null(self.child.evaluate(batch))


@dataclass
class IsNotNullOp(PhysicalExpr):
    child: PhysicalExpr

    def evaluate(self, batch):
        return pc.is_valid(self.child.evaluate(batch))


@dataclass
class CastOp(PhysicalExpr):
    child: PhysicalExpr
    to: pa.DataType

    def evaluate(self, batch):
        return pc.cast(self.child.evaluate(batch), self.to)


@dataclass
class LikeOp(PhysicalExpr):
    child: PhysicalExpr
    pattern: str
    negated: bool

    def evaluate(self, batch):
        out = pc.match_like(self.child.evaluate(batch), self.pattern)
        return pc.invert(out) if self.negated else out


@dataclass
class InListOp(PhysicalExpr):
    child: PhysicalExpr
    values: tuple
    negated: bool

    def evaluate(self, batch):
        arr = self.child.evaluate(batch)
        vs = pa.array(list(self.values))
        try:
            vs = vs.cast(arr.type)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            pass
        out = pc.is_in(arr, value_set=vs)
        return pc.invert(out) if self.negated else out


@dataclass
class BetweenOp(PhysicalExpr):
    child: PhysicalExpr
    low: PhysicalExpr
    high: PhysicalExpr
    negated: bool

    def evaluate(self, batch):
        v = self.child.evaluate(batch)
        out = pc.and_(pc.greater_equal(v, self.low.evaluate(batch)),
                      pc.less_equal(v, self.high.evaluate(batch)))
        return pc.invert(out) if self.negated else out


@dataclass
class CaseOp(PhysicalExpr):
    branches: tuple  # ((when, then), ...)
    else_expr: PhysicalExpr | None
    out_type: pa.DataType

    def evaluate(self, batch):
        n = batch.num_rows
        if self.else_expr is not None:
            result = self.else_expr.evaluate(batch)
            if isinstance(result, pa.Scalar):
                result = pa.array([py_for_type(result.as_py(), self.out_type)] * n, self.out_type)
            else:
                result = result.cast(self.out_type)
        else:
            result = pa.nulls(n, self.out_type)
        decided = pa.array(np.zeros(n, dtype=bool))
        # first-match-wins: apply branches in order, masking decided rows
        for when, then in self.branches:
            cond = when.evaluate(batch)
            if isinstance(cond, pa.Scalar):
                cond = pa.array([bool(cond.as_py())] * n)
            cond = pc.and_(pc.fill_null(cond, False), pc.invert(decided))
            tv = then.evaluate(batch)
            if isinstance(tv, pa.Scalar):
                tv = pa.array([py_for_type(tv.as_py(), self.out_type)] * n, self.out_type)
            else:
                tv = tv.cast(self.out_type)
            result = pc.if_else(cond, tv, result)
            decided = pc.or_(decided, cond)
        return result


@dataclass
class DateAddOp(PhysicalExpr):
    """date column ± interval literal (days/months/years)."""

    child: PhysicalExpr
    n: int
    unit: str
    sign: int

    def evaluate(self, batch):
        arr = self.child.evaluate(batch)
        if pa.types.is_timestamp(arr.type):  # joins may surface dates as ts
            arr = arr.cast(pa.date32())
        n = self.n * self.sign
        if self.unit == "day":
            return pc.add(arr.cast(pa.int32()), pa.scalar(n, pa.int32())).cast(pa.date32())
        np_days = arr.cast(pa.int32()).to_numpy(zero_copy_only=False)
        dates = np_days.astype("datetime64[D]")
        months = n * 12 if self.unit == "year" else n
        out = (dates.astype("datetime64[M]") + months).astype("datetime64[D]") + (
            dates - dates.astype("datetime64[M]").astype("datetime64[D]")
        )
        return pa.array(out).cast(pa.date32())


@dataclass
class ScalarFnOp(PhysicalExpr):
    name: str
    args: tuple

    def evaluate(self, batch):
        n = self.name
        a = [x.evaluate(batch) for x in self.args]
        if n == "extract_year":
            return pc.cast(pc.year(a[0]), pa.int64())
        if n == "extract_month":
            return pc.cast(pc.month(a[0]), pa.int64())
        if n == "extract_day":
            return pc.cast(pc.day(a[0]), pa.int64())
        if n == "substr":
            start = _as_py(a[1])
            if len(a) == 3:
                return pc.utf8_slice_codeunits(a[0], start - 1, start - 1 + _as_py(a[2]))
            return pc.utf8_slice_codeunits(a[0], start - 1)
        if n == "strpos":
            return pc.cast(pc.add(pc.find_substring(a[0], pattern=_as_py(a[1])), 1), pa.int64())
        if n == "length":
            return pc.cast(pc.utf8_length(a[0]), pa.int64())
        if n == "upper":
            return pc.utf8_upper(a[0])
        if n == "lower":
            return pc.utf8_lower(a[0])
        if n == "trim":
            return pc.utf8_trim_whitespace(a[0])
        if n == "concat":
            return pc.binary_join_element_wise(*a, "")
        if n == "abs":
            return pc.abs(a[0])
        if n == "sqrt":
            return pc.sqrt(pc.cast(a[0], pa.float64()))
        if n == "round":
            ndigits = _as_py(a[1]) if len(a) > 1 else 0
            return pc.round(a[0], ndigits=ndigits)
        if n == "ceil":
            return pc.ceil(a[0])
        if n == "floor":
            return pc.floor(a[0])
        if n == "coalesce":
            return pc.coalesce(*a)
        from ballista_tpu_torch import udf

        u = udf.resolve(n)
        if u is not None:
            arrays = [
                x if not isinstance(x, pa.Scalar)
                else pa.array([x.as_py()] * batch.num_rows, x.type)
                for x in a
            ]
            out = u.fn(*arrays)
            if not isinstance(out, (pa.Array, pa.ChunkedArray, pa.Scalar)):
                out = pa.array(out, u.return_type)
            return out
        raise ExecutionError(f"unknown scalar function {n}")


def _as_py(v):
    return v.as_py() if isinstance(v, pa.Scalar) else v


def py_for_type(v, t: pa.DataType):
    """Coerce a Python literal for materialization as type `t`: exact-policy
    decimal literals flow into float/int slots (CASE branches, lag/lead
    defaults) that pyarrow refuses to convert implicitly."""
    import decimal as _d

    if isinstance(v, _d.Decimal):
        if pa.types.is_floating(t):
            return float(v)
        if pa.types.is_integer(t):
            return int(v)
    elif isinstance(v, (int, float)) and not isinstance(v, bool) and pa.types.is_decimal(t):
        # float/int branch into a decimal slot (e.g. a sci-notation literal
        # in a CASE whose other branches are decimal)
        return _d.Decimal(str(v))
    return v


def bind_expr(e: Expr, schema: DFSchema) -> PhysicalExpr:
    if isinstance(e, Alias):
        return bind_expr(e.expr, schema)
    if isinstance(e, Column):
        i = schema.index_of(e.name, e.qualifier)
        return Col(i, e.name)
    if isinstance(e, Literal):
        v = e.value
        if isinstance(v, tuple):
            raise PlanningError("bare interval literal outside date arithmetic")
        return Lit(v)
    if isinstance(e, BinaryExpr):
        # date ± interval over a column
        if isinstance(e.right, Literal) and isinstance(e.right.value, tuple) and e.op in ("+", "-"):
            n, unit = e.right.value
            return DateAddOp(bind_expr(e.left, schema), n, unit, -1 if e.op == "-" else 1)
        out_type = None
        if e.op in ("+", "-", "*", "/", "%"):
            try:
                out_type = e.data_type(schema)  # decimal coercion contract
            except Exception:  # noqa: BLE001 — typing is advisory for non-decimals
                out_type = None
        return BinOp(bind_expr(e.left, schema), e.op, bind_expr(e.right, schema), out_type)
    if isinstance(e, Not):
        return NotOp(bind_expr(e.expr, schema))
    if isinstance(e, Negative):
        return NegOp(bind_expr(e.expr, schema))
    if isinstance(e, IsNull):
        return IsNullOp(bind_expr(e.expr, schema))
    if isinstance(e, IsNotNull):
        return IsNotNullOp(bind_expr(e.expr, schema))
    if isinstance(e, Cast):
        return CastOp(bind_expr(e.expr, schema), e.to)
    if isinstance(e, Like):
        return LikeOp(bind_expr(e.expr, schema), e.pattern, e.negated)
    if isinstance(e, InList):
        return InListOp(bind_expr(e.expr, schema), e.values, e.negated)
    if isinstance(e, Between):
        return BetweenOp(
            bind_expr(e.expr, schema), bind_expr(e.low, schema), bind_expr(e.high, schema), e.negated
        )
    if isinstance(e, Case):
        out_type = e.data_type(schema)
        return CaseOp(
            tuple((bind_expr(w, schema), bind_expr(t, schema)) for w, t in e.branches),
            bind_expr(e.else_expr, schema) if e.else_expr is not None else None,
            out_type,
        )
    if isinstance(e, ScalarFunction):
        return ScalarFnOp(e.name, tuple(bind_expr(a, schema) for a in e.args))
    raise PlanningError(f"cannot bind {type(e).__name__}: {e}")


def evaluate_to_array(pe: PhysicalExpr, batch: pa.RecordBatch) -> pa.Array:
    out = pe.evaluate(batch)
    if isinstance(out, pa.Scalar):
        out = pa.array([out.as_py()] * batch.num_rows, out.type)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    return out
