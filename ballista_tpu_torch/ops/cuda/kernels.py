"""Expression lowering onto PyTorch tensors.

Counterpart of the JAX package's ops/tpu/kernels.py. The rules carry over:
- no data-dependent shapes in the partial stage: filters produce MASKS,
  never compaction; the aggregation consumes (value, mask) pairs
- string work never reaches the device: predicates over dictionary columns
  are host-precomputed boolean LUTs, gathered by code on device
- money arithmetic stays in int64 scaled integers (exact); scale tracking
  happens at lowering time (static), not at runtime; dates stay int32 days

Where the JAX code leaned on XLA semantics, the port spells them out:
- a gather clamps an out-of-range index as XLA does (`take`), instead of
  raising (CPU) or asserting on the device (CUDA);
- binary operands are cast to their promoted dtype first, because torch
  lets a 0-d int64 literal take the dtype of an int32 column where JAX
  widens the column;
- every literal is made on the device of the columns it meets;
- division by a constant is multiplication by its reciprocal, which is
  what XLA compiles it to, so float results agree bit for bit.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import fnmatch
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

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

# -- device value with static (lowering-time) type info ---------------------


@dataclass
class DevVal:
    kind: str  # i64 | f64 | money | date | code | bool
    arr: Any  # torch tensor
    scale: int = 0
    dictionary: list | None = None
    valid: Any = None  # torch bool tensor; None = known non-null everywhere


class Unsupported(Exception):
    """Raised at lowering time → subtree falls back to the CPU engine."""


def vand(*valids):
    """Null-strict validity combine: result is null if ANY input is null
    (the SQL rule for comparisons, arithmetic, casts, function args)."""
    out = None
    for v in valids:
        if v is None:
            continue
        out = v if out is None else out & v
    return out


def true_mask(v: DevVal):
    """Project three-valued logic onto filtering: rows pass a WHERE clause
    only when the predicate is TRUE — unknown (NULL) behaves as false."""
    if v.valid is None:
        return v.arr
    return v.arr & v.valid


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` with XLA's gather semantics: a negative index wraps
    once, then every index clamps into [0, len)."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    return table[idx]


def _dev(cols) -> torch.device:
    return cols[0].device if cols else torch.device("cpu")


def _scalar(cols, value, dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=_dev(cols))


def _align(a: torch.Tensor, b: torch.Tensor):
    """Cast both operands to their promoted dtype (JAX's promotion, where a
    0-d operand does not yield to the other's narrower dtype)."""
    if a.dtype == b.dtype:
        return a, b
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


# -- lowering ----------------------------------------------------------------


class Lowering:
    """Collects host-side LUT constants while lowering expressions into
    closures over (cols, luts). LUTs are padded to pow2 so compile keys are
    stable across partitions with slightly different dictionaries."""

    def __init__(self, schema: DFSchema, kinds: list[tuple[str, int]], dictionaries: list[list | None]):
        self.schema = schema
        self.kinds = kinds  # per-field (kind, scale)
        self.dictionaries = dictionaries
        # LUTs are registered as (source_slot, builder) so they can be
        # REBUILT for each table's dictionaries: the lowered closures take
        # LUTs as arguments, only their contents change across tables.
        self.lut_builders: list[tuple[int, Any]] = []
        self.slots: list[int] = list(range(len(kinds)))  # field → source slot
        # env indirection (set by the stage compiler): field index → lowered
        # fn, so projections rebind what a Column reference means
        self.env_fns: list | None = None
        self.env_meta: list | None = None

    def add_lut(self, src_slot, builder) -> int:
        """src_slot: scan column index, or ('build', join_idx, col_idx) for
        dictionaries that live in a join's build table."""
        self.lut_builders.append((src_slot, builder))
        return len(self.lut_builders) - 1

    def build_luts(self, dictionaries_by_slot: list[list | None],
                   build_dicts: list[list[list | None]] | None = None) -> list[np.ndarray]:
        out = []
        for slot, builder in self.lut_builders:
            if isinstance(slot, tuple) and slot[0] == "build":
                dic = build_dicts[slot[1]][slot[2]] if build_dicts else None
            else:
                dic = dictionaries_by_slot[slot]
            vals = builder(dic)
            n = 1
            while n < max(len(vals), 1):
                n *= 2
            padded = np.zeros(n, dtype=vals.dtype)
            padded[: len(vals)] = vals
            out.append(padded)
        return out

    def col_index(self, c: Column) -> int:
        return self.schema.index_of(c.name, c.qualifier)


LoweredFn = Callable[[list, list], DevVal]  # (cols, luts) -> DevVal


def _string_expr_fn(e: Expr, ctx: "Lowering"):
    """Recognize pure string-function trees over ONE dictionary column
    (substr/upper/lower/trim with literal args). Returns (base Column,
    col_index, str→str fn) — predicates over such trees compose into the
    column's host-side dictionary LUT, so strings never reach the device
    (the substring(c_phone,..) IN (...) pattern of q22 and TPC-DS)."""
    if isinstance(e, Alias):
        return _string_expr_fn(e.expr, ctx)
    if isinstance(e, Column):
        i = ctx.col_index(e)
        if ctx.kinds[i][0] == "code":
            return e, i, lambda s: s
        return None
    if isinstance(e, ScalarFunction) and e.name in ("substr", "upper", "lower", "trim"):
        inner = _string_expr_fn(e.args[0], ctx) if e.args else None
        if inner is None:
            return None
        col, i, f = inner
        extra = e.args[1:]
        if not all(isinstance(a, Literal) for a in extra):
            return None
        vals = [a.value for a in extra]
        name = e.name
        if name in ("upper", "lower", "trim") and extra:
            # BTRIM(col, chars) etc. — semantics we don't model: stay on cpu
            return None
        if name == "substr":
            if not vals or not all(isinstance(v, int) for v in vals):
                return None
            if vals[0] < 1:
                return None  # SQL start<1 clamps; python would wrap
            start = vals[0] - 1
            end = start + vals[1] if len(vals) > 1 else None

            def g(s, f=f, start=start, end=end):
                t = f(s)
                return t[start:end] if end is not None else t[start:]
        elif name == "upper":
            def g(s, f=f):
                return f(s).upper()
        elif name == "lower":
            def g(s, f=f):
                return f(s).lower()
        else:  # trim
            def g(s, f=f):
                return f(s).strip()
        return col, i, g
    return None


def _lut_pred(ctx: Lowering, col: Column, i: int, builder, neg: bool) -> LoweredFn:
    """A boolean dictionary LUT gathered by code: the device form of every
    string predicate (=, <>, IN, LIKE)."""
    src = lower_expr(col, ctx)
    li = ctx.add_lut(ctx.slots[i], builder)

    def run(cols, luts):
        v = src(cols, luts)
        out = take(luts[li], v.arr)
        return DevVal("bool", ~out if neg else out, valid=v.valid)

    return run


def lower_expr(e: Expr, ctx: Lowering) -> LoweredFn:
    if isinstance(e, Alias):
        return lower_expr(e.expr, ctx)

    if isinstance(e, Column):
        i = ctx.col_index(e)
        if ctx.env_fns is not None:
            return ctx.env_fns[i]
        kind, scale = ctx.kinds[i]
        dic = ctx.dictionaries[i]
        return lambda cols, luts: DevVal(kind, cols[i], scale, dic)

    if isinstance(e, Literal):
        v = e.value
        if isinstance(v, bool):
            return lambda cols, luts: DevVal("bool", _scalar(cols, v, torch.bool))
        if isinstance(v, int):
            return lambda cols, luts: DevVal("i64", _scalar(cols, v, torch.int64))
        if isinstance(v, float):
            cents = v * 100
            if abs(cents - round(cents)) < 1e-9:
                c = int(round(cents))
                return lambda cols, luts: DevVal("money", _scalar(cols, c, torch.int64), 2)
            return lambda cols, luts: DevVal("f64", _scalar(cols, v, torch.float64))
        if isinstance(v, _decimal.Decimal):
            # exact-policy literal: the declared scale IS the fixed point
            exp = -v.as_tuple().exponent
            if 0 <= exp <= 4:
                c = int(v.scaleb(exp))
                return lambda cols, luts, c=c, exp=exp: DevVal(
                    "money", _scalar(cols, c, torch.int64), exp)
            fv = float(v)
            return lambda cols, luts, fv=fv: DevVal(
                "f64", _scalar(cols, fv, torch.float64))
        if isinstance(v, _dt.date):
            days = (v - _dt.date(1970, 1, 1)).days
            return lambda cols, luts: DevVal("date", _scalar(cols, days, torch.int32))
        raise Unsupported(f"literal {v!r}")

    if isinstance(e, BinaryExpr):
        # string equality over dictionary columns → host LUT, device gather
        if e.op in ("=", "<>"):
            for a, b in ((e.left, e.right), (e.right, e.left)):
                if isinstance(b, Literal) and isinstance(b.value, str):
                    hit = _string_expr_fn(a, ctx)
                    if hit is not None:
                        col, i, sfn = hit
                        val = b.value
                        return _lut_pred(
                            ctx, col, i,
                            lambda dic, val=val, sfn=sfn: np.array(
                                [sfn(x) == val for x in dic], dtype=bool),
                            e.op == "<>")
        lf = lower_expr(e.left, ctx)
        rf = lower_expr(e.right, ctx)
        op = e.op

        def run(cols, luts):
            return _binop(lf(cols, luts), op, rf(cols, luts))

        return run

    if isinstance(e, Not):
        f = lower_expr(e.expr, ctx)

        def run(cols, luts):
            v = f(cols, luts)
            return DevVal("bool", ~v.arr, valid=v.valid)  # NOT NULL is NULL

        return run

    if isinstance(e, IsNull) or isinstance(e, IsNotNull):
        f = lower_expr(e.expr, ctx)
        want_null = isinstance(e, IsNull)

        def run(cols, luts):
            v = f(cols, luts)
            if v.valid is None:
                fill = torch.zeros_like if want_null else torch.ones_like
                out = fill(v.arr, dtype=torch.bool)
            else:
                out = ~v.valid if want_null else v.valid
            return DevVal("bool", out)  # IS [NOT] NULL is never null itself

        return run

    if isinstance(e, Negative):
        f = lower_expr(e.expr, ctx)

        def run(cols, luts):
            v = f(cols, luts)
            return DevVal(v.kind, -v.arr, v.scale, valid=v.valid)

        return run

    if isinstance(e, Between):
        vf = lower_expr(e.expr, ctx)
        lof = lower_expr(e.low, ctx)
        hif = lower_expr(e.high, ctx)
        neg = e.negated

        def run(cols, luts):
            v = vf(cols, luts)
            lo = _binop(v, ">=", lof(cols, luts))
            hi = _binop(v, "<=", hif(cols, luts))
            both = _binop(lo, "and", hi)
            return DevVal("bool", ~both.arr if neg else both.arr, valid=both.valid)

        return run

    if isinstance(e, InList):
        # string-fn trees over a code column compose into the dictionary LUT
        hit = _string_expr_fn(e.expr, ctx)
        if hit is not None and all(isinstance(v, str) for v in e.values):
            col, i, sfn = hit
            values = set(e.values)
            return _lut_pred(
                ctx, col, i,
                lambda dic, values=values, sfn=sfn: np.array(
                    [sfn(x) in values for x in dic], dtype=bool),
                e.negated)
        inner = lower_expr(e.expr, ctx)
        if isinstance(e.expr, (Column, Alias)):
            col = e.expr.expr if isinstance(e.expr, Alias) else e.expr
            i = ctx.col_index(col)
            kind, _ = ctx.kinds[i]
            src = inner
            if kind in ("i64", "date"):
                vals = list(e.values)
                neg = e.negated

                def run(cols, luts):
                    v = src(cols, luts)
                    out = torch.zeros_like(v.arr, dtype=torch.bool)
                    for lit in vals:
                        if isinstance(lit, _dt.date):
                            lit = (lit - _dt.date(1970, 1, 1)).days
                        out = out | (v.arr == lit)
                    # NULL IN (...) / NULL NOT IN (...) are both unknown
                    return DevVal("bool", ~out if neg else out, valid=v.valid)

                return run
        raise Unsupported(f"IN over {e.expr}")

    if isinstance(e, Like):
        if not isinstance(e.expr, Column):
            raise Unsupported("LIKE over non-column")
        i = ctx.col_index(e.expr)
        kind, _ = ctx.kinds[i]
        if kind != "code":
            raise Unsupported("LIKE over non-string")
        pat = _like_to_fnmatch(e.pattern)
        return _lut_pred(
            ctx, e.expr, i,
            lambda dic, pat=pat: np.array(
                [fnmatch.fnmatchcase(x, pat) for x in dic], dtype=bool),
            e.negated)

    if isinstance(e, Case):
        branch_fns = [(lower_expr(w, ctx), lower_expr(t, ctx)) for w, t in e.branches]
        else_fn = lower_expr(e.else_expr, ctx) if e.else_expr is not None else None

        has_else = else_fn is not None

        def run(cols, luts):
            dev = _dev(cols)
            thens = [tf(cols, luts) for _, tf in branch_fns]
            whens = [wf(cols, luts) for wf, _ in branch_fns]
            # align all branch values to a common kind/scale
            target = thens[0]
            if has_else:
                evd = else_fn(cols, luts)
            else:
                # no ELSE: the fall-through value is NULL
                evd = DevVal(target.kind,
                             torch.zeros((), dtype=target.arr.dtype, device=dev),
                             target.scale,
                             valid=torch.zeros((), dtype=torch.bool, device=dev))
            allv = thens + [evd]
            kind, scale = _common_kind([(v.kind, v.scale) for v in allv])
            allv = [_coerce(v, kind, scale) for v in allv]
            nullable = any(v.valid is not None for v in whens) or any(
                v.valid is not None for v in allv
            )
            out = allv[-1].arr
            out_valid = None
            if nullable:
                ev = allv[-1].valid
                out_valid = ev if ev is not None else torch.ones((), dtype=torch.bool, device=dev)
            decided = torch.zeros((), dtype=torch.bool, device=dev)
            for w, t in zip(whens, allv[:-1]):
                taken = true_mask(w)  # a NULL condition skips its branch
                cond = taken & ~decided
                a, b = _align(t.arr, out)
                out = torch.where(cond, a, b)
                if nullable:
                    tv = t.valid if t.valid is not None else torch.ones(
                        (), dtype=torch.bool, device=dev)
                    out_valid = torch.where(cond, tv, out_valid)
                decided = decided | taken
            return DevVal(kind, out, scale, valid=out_valid)

        return run

    if isinstance(e, Cast):
        f = lower_expr(e.expr, ctx)
        import pyarrow as pa

        to = e.to

        def run(cols, luts):
            v = f(cols, luts)
            if pa.types.is_floating(to):
                return _coerce(v, "f64", 0)
            if pa.types.is_integer(to):
                if v.kind == "money":
                    return DevVal("i64", v.arr // (10**v.scale), valid=v.valid)
                return DevVal("i64", v.arr.to(torch.int64), valid=v.valid)
            raise Unsupported(f"cast to {to}")

        return run

    if isinstance(e, ScalarFunction):
        if e.name in ("extract_year", "extract_month"):
            f = lower_expr(e.args[0], ctx)
            part = e.name

            def run(cols, luts):
                v = f(cols, luts)
                if v.kind != "date":
                    raise Unsupported("extract over non-date")
                days = v.arr.to(torch.int64)
                # civil-from-days (Howard Hinnant's algorithm, vectorized)
                z = days + 719468
                era = torch.where(z >= 0, z, z - 146096) // 146097
                doe = z - era * 146097
                yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
                y = yoe + era * 400
                doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
                mp = (5 * doy + 2) // 153
                m = torch.where(mp < 10, mp + 3, mp - 9)
                y = torch.where(m <= 2, y + 1, y)
                if part == "extract_year":
                    return DevVal("i64", y, valid=v.valid)
                return DevVal("i64", m, valid=v.valid)

            return run
        raise Unsupported(f"scalar fn {e.name}")

    raise Unsupported(f"{type(e).__name__}")


def _like_to_fnmatch(pat: str) -> str:
    out = []
    for ch in pat:
        if ch == "%":
            out.append("*")
        elif ch == "_":
            out.append("?")
        elif ch in "*?[]":
            out.append(f"[{ch}]")
        else:
            out.append(ch)
    return "".join(out)


def _common_kind(pairs: list[tuple[str, int]]) -> tuple[str, int]:
    kinds = {k for k, _ in pairs}
    if "f64" in kinds:
        return "f64", 0
    if "money" in kinds:
        scale = max(s for k, s in pairs if k == "money")
        return "money", scale
    if kinds <= {"i64", "bool"}:
        return "i64", 0
    if kinds == {"date"}:
        return "date", 0
    if kinds == {"code"}:
        raise Unsupported("code-valued CASE")
    return "i64", 0


def _coerce(v: DevVal, kind: str, scale: int) -> DevVal:
    if v.kind == kind and v.scale == scale:
        return v
    if kind == "f64":
        if v.kind == "money":
            return DevVal("f64", v.arr.to(torch.float64) * (1.0 / 10**v.scale), valid=v.valid)
        return DevVal("f64", v.arr.to(torch.float64), valid=v.valid)
    if kind == "money":
        if v.kind == "money":
            return DevVal("money", v.arr * (10 ** (scale - v.scale)), scale, valid=v.valid)
        if v.kind in ("i64", "bool"):
            return DevVal("money", v.arr.to(torch.int64) * (10**scale), scale, valid=v.valid)
    if kind == "i64":
        return DevVal("i64", v.arr.to(torch.int64), valid=v.valid)
    raise Unsupported(f"coerce {v.kind}->{kind}")


_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}


def _binop(l: DevVal, op: str, r: DevVal) -> DevVal:
    if op in ("and", "or"):
        # Kleene three-valued logic. Null value slots are FILLED with False
        # at encode time, so the value lane of AND/OR is simply &/| — the
        # validity lane records where the result is actually known:
        #   x AND y known iff (both known) or (a known-FALSE side exists)
        #   x OR  y known iff (both known) or (a known-TRUE  side exists)
        if l.valid is None and r.valid is None:
            out = l.arr & r.arr if op == "and" else l.arr | r.arr
            return DevVal("bool", out)
        lv = l.valid if l.valid is not None else True
        rv = r.valid if r.valid is not None else True
        if op == "and":
            valid = (lv & rv) | (lv & ~l.arr) | (rv & ~r.arr)
            return DevVal("bool", l.arr & r.arr, valid=valid)
        valid = (lv & rv) | (lv & l.arr) | (rv & r.arr)
        return DevVal("bool", l.arr | r.arr, valid=valid)

    valid = vand(l.valid, r.valid)
    if op in _CMP_OPS:
        if l.kind == "code" or r.kind == "code":
            raise Unsupported("code comparison must be pre-lowered via LUT")
        kind, scale = _common_kind([(l.kind, l.scale), (r.kind, r.scale)])
        a, b = _align(_coerce(l, kind, scale).arr, _coerce(r, kind, scale).arr)
        fn = {
            "=": torch.eq, "<>": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge,
        }[op]
        return DevVal("bool", fn(a, b), valid=valid)

    # arithmetic (null-strict: validity is the AND of input validities)
    if op == "/":
        a = _coerce(l, "f64", 0).arr
        b = _coerce(r, "f64", 0).arr
        if b.dim() == 0:  # a literal divisor: multiply by its reciprocal
            return DevVal("f64", a * (1.0 / b), valid=valid)
        return DevVal("f64", a / b, valid=valid)
    if op == "*":
        if l.kind == "money" and r.kind == "money":
            a, b = _align(l.arr, r.arr)
            return DevVal("money", a * b, l.scale + r.scale, valid=valid)
        if l.kind == "money" and r.kind in ("i64", "bool"):
            return DevVal("money", l.arr.to(torch.int64) * r.arr.to(torch.int64),
                          l.scale, valid=valid)
        if r.kind == "money" and l.kind in ("i64", "bool"):
            return DevVal("money", r.arr.to(torch.int64) * l.arr.to(torch.int64),
                          r.scale, valid=valid)
        if "f64" in (l.kind, r.kind):
            return DevVal("f64", _coerce(l, "f64", 0).arr * _coerce(r, "f64", 0).arr,
                          valid=valid)
        return DevVal("i64", l.arr.to(torch.int64) * r.arr.to(torch.int64), valid=valid)
    if op in ("+", "-"):
        if l.kind == "date" and r.kind == "i64":
            arr = l.arr + (r.arr if op == "+" else -r.arr).to(l.arr.dtype)
            return DevVal("date", arr, valid=valid)
        kind, scale = _common_kind([(l.kind, l.scale), (r.kind, r.scale)])
        a, b = _align(_coerce(l, kind, scale).arr, _coerce(r, kind, scale).arr)
        return DevVal(kind, a + b if op == "+" else a - b, scale, valid=valid)
    raise Unsupported(f"binop {op}")
