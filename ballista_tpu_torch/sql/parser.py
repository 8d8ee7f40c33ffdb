"""Recursive-descent SQL parser (Pratt-style expression parsing).

Covers the surface the reference's benchmark/test suites exercise
(TPC-H-complete plus the CLI's DDL): SELECT with CTEs, derived tables,
explicit and comma joins, WHERE/GROUP BY/HAVING/ORDER BY/LIMIT/OFFSET,
UNION [ALL], scalar/IN/EXISTS subqueries, CASE, CAST, EXTRACT, SUBSTRING,
date/interval literals, EXPLAIN [ANALYZE], CREATE EXTERNAL TABLE, DROP
TABLE, SHOW TABLES, SET.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any

import pyarrow as pa

from ballista_tpu_torch.errors import SqlParseError
from ballista_tpu_torch.plan.expressions import (
    AggregateFunction,
    Alias,
    Between,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Exists,
    Expr,
    InList,
    InSubquery,
    IsNotNull,
    IsNull,
    Like,
    Literal,
    Negative,
    Not,
    ScalarFunction,
    ScalarSubquery,
    SortKey,
    WINDOW_FUNCS,
    WindowFunction,
)
from ballista_tpu_torch.sql.ast import (
    CreateExternalTable,
    DerivedTable,
    DropTable,
    ShowColumns,
    ValuesClause,
    ExplainStmt,
    JoinClause,
    SelectStmt,
    SetVariable,
    ShowTables,
    TableName,
)
from ballista_tpu_torch.sql.tokenizer import Token, tokenize

AGGREGATES = {"SUM", "AVG", "MIN", "MAX", "COUNT",
              "STDDEV", "STDDEV_SAMP", "STDDEV_POP",
              "VARIANCE", "VAR_SAMP", "VAR_POP"}

# SQL surface names → canonical aggregate names (SQL-standard sample forms)
_AGG_CANONICAL = {"stddev": "stddev_samp", "variance": "var_samp"}

SCALAR_FUNCS = {
    # canonical-name mapping; evaluation lives in the engines
    "SUBSTR": "substr", "SUBSTRING": "substr", "STRPOS": "strpos",
    "POSITION": "strpos", "LENGTH": "length", "CHAR_LENGTH": "length",
    "UPPER": "upper", "LOWER": "lower", "TRIM": "trim", "BTRIM": "trim",
    "CONCAT": "concat", "ABS": "abs", "ROUND": "round", "CEIL": "ceil",
    "CEILING": "ceil", "FLOOR": "floor", "COALESCE": "coalesce",
    "DATE_TRUNC": "date_trunc", "DATE_PART": "date_part", "YEAR": "extract_year",
    "SQRT": "sqrt",
}

_TYPE_NAMES = {
    "INT": pa.int64(), "INTEGER": pa.int64(), "BIGINT": pa.int64(),
    "SMALLINT": pa.int64(), "TINYINT": pa.int64(),
    "FLOAT": pa.float64(), "DOUBLE": pa.float64(), "REAL": pa.float64(),
    "DECIMAL": pa.float64(), "NUMERIC": pa.float64(),  # engine decimal policy
    "VARCHAR": pa.string(), "CHAR": pa.string(), "TEXT": pa.string(),
    "STRING": pa.string(), "DATE": pa.date32(), "BOOLEAN": pa.bool_(),
    "BOOL": pa.bool_(), "TIMESTAMP": pa.timestamp("us"),
}


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_kw(self, *kws: str) -> bool:
        if self.peek().is_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        t = self.next()
        if not (t.kind == "kw" and t.value == kw):
            raise SqlParseError(f"expected {kw}, got {t.kind} {t.value!r} at {t.pos}")

    def accept_punct(self, p: str) -> bool:
        if self.peek().kind == "punct" and self.peek().value == p:
            self.next()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        t = self.next()
        if not (t.kind == "punct" and t.value == p):
            raise SqlParseError(f"expected {p!r}, got {t.value!r} at {t.pos}")

    def expect_ident(self) -> str:
        t = self.next()
        if t.kind == "ident":
            return t.value
        # allow non-reserved keywords as identifiers in a few positions
        if t.kind == "kw" and t.value in (
            "DATE", "YEAR", "FIRST", "LAST", "ALL", "TABLES",
            "ROLLUP", "CUBE", "GROUPING", "SETS",
        ):
            return t.value.lower()
        raise SqlParseError(f"expected identifier, got {t.kind} {t.value!r} at {t.pos}")

    # -- statements ---------------------------------------------------------

    def parse_statement(self) -> Any:
        t = self.peek()
        if t.is_kw("EXPLAIN"):
            self.next()
            analyze = self.accept_kw("ANALYZE")
            verbose = self.accept_kw("VERBOSE")
            return ExplainStmt(self.parse_statement(), analyze, verbose)
        if t.is_kw("CREATE"):
            return self._parse_create()
        if t.is_kw("DROP"):
            self.next()
            self.expect_kw("TABLE")
            if_exists = False
            if self.peek().kind == "kw" and self.peek().value == "IS":  # unreachable, keep simple
                pass
            if self.peek().kind == "ident" and self.peek().value.upper() == "IF":
                self.next()
                ex = self.next()
                if not (ex.kind == "kw" and ex.value == "EXISTS"):
                    raise SqlParseError("expected EXISTS after IF")
                if_exists = True
            return DropTable(self.expect_ident(), if_exists)
        if t.is_kw("SHOW"):
            self.next()
            if self.accept_kw("COLUMNS"):
                # SHOW COLUMNS FROM t
                if not self.accept_kw("FROM"):
                    self.expect_kw("IN")
                return ShowColumns(self.expect_ident())
            self.expect_kw("TABLES")
            return ShowTables()
        if t.kind == "ident" and t.value.upper() == "DESCRIBE":
            self.next()
            return ShowColumns(self.expect_ident())
        if t.is_kw("SET"):
            self.next()
            key = self._parse_dotted_name()
            op = self.next()
            if not (op.kind == "op" and op.value == "="):
                raise SqlParseError("expected = in SET")
            val = self.next()
            return SetVariable(key, val.value)
        return self.parse_query()

    def _parse_create(self) -> CreateExternalTable:
        self.expect_kw("CREATE")
        self.accept_kw("EXTERNAL")
        self.expect_kw("TABLE")
        name = self.expect_ident()
        fmt = "parquet"
        if self.accept_kw("STORED"):
            self.expect_kw("AS")
            fmt = self.expect_ident().lower()
        self.expect_kw("LOCATION")
        loc = self.next()
        if loc.kind != "string":
            raise SqlParseError("expected string LOCATION")
        return CreateExternalTable(name, loc.value, fmt)

    def _parse_dotted_name(self) -> str:
        parts = [self.expect_ident()]
        while self.accept_punct("."):
            parts.append(self.expect_ident())
        return ".".join(parts)

    # -- queries ------------------------------------------------------------

    def parse_query(self) -> SelectStmt:
        ctes: list[tuple[str, SelectStmt]] = []
        if self.accept_kw("WITH"):
            while True:
                name = self.expect_ident()
                self.expect_kw("AS")
                self.expect_punct("(")
                sub = self.parse_query()
                self.expect_punct(")")
                ctes.append((name.lower(), sub))
                if not self.accept_punct(","):
                    break
        stmt = self._parse_query_term()
        # a parenthesized term may carry its own WITH clause — outer CTEs
        # prepend (inner names shadow outer per SQL scoping)
        stmt.ctes = ctes + list(stmt.ctes or [])
        # set operations: chain via nested set_op fields on the RHS so
        # a UNION ALL b UNION ALL c keeps all three branches (homogeneous
        # chains are associative; planner flattens them)
        cur = stmt
        while self.peek().is_kw("UNION", "EXCEPT", "INTERSECT"):
            kw = self.next().value
            all_ = self.accept_kw("ALL")
            # standard SQL: set-op branches take no bare ORDER BY/LIMIT —
            # trailing clauses bind to the whole chain
            rhs = self._parse_query_term(allow_order=False)
            op = {"UNION": "union_all" if all_ else "union",
                  "EXCEPT": "except_all" if all_ else "except",
                  "INTERSECT": "intersect_all" if all_ else "intersect"}[kw]
            cur.set_op = (op, rhs)
            cur = rhs
        # trailing ORDER BY / LIMIT of a set operation
        if self.peek().is_kw("ORDER") and not stmt.order_by:
            stmt.order_by = self._parse_order_by()
        if self.peek().is_kw("LIMIT") and stmt.limit is None:
            stmt.limit, stmt.offset = self._parse_limit()
        return stmt

    def _parse_query_term(self, allow_order: bool = True) -> SelectStmt:
        """One operand of a set-operation chain: a SELECT body or a
        parenthesized query expression `( query )` (q38/q87 shape).

        A parenthesized operand that carries its own set-op chain, ORDER
        BY/LIMIT, or WITH clause wraps into `SELECT * FROM (query)` — the
        outer chain's left-associative splicing would otherwise regroup
        non-associative EXCEPT/INTERSECT or misattach the inner clauses."""
        if self.peek().kind == "punct" and self.peek().value == "(":
            self.next()
            sub = self.parse_query()
            self.expect_punct(")")
            if sub.set_op or sub.order_by or sub.limit is not None or sub.ctes:
                self._wrap_counter = getattr(self, "_wrap_counter", 0) + 1
                wrapped = SelectStmt()
                wrapped.projections = [Column("*")]
                wrapped.from_tables = [
                    DerivedTable(sub, f"__setwrap{self._wrap_counter}")]
                return wrapped
            return sub
        return self._parse_select_body(allow_order=allow_order)

    def _parse_select_body(self, allow_order: bool = True) -> SelectStmt:
        self.expect_kw("SELECT")
        stmt = SelectStmt()
        stmt.distinct = self.accept_kw("DISTINCT")
        self.accept_kw("ALL")
        # projections
        while True:
            if self.peek().kind == "op" and self.peek().value == "*":
                self.next()
                stmt.projections.append(Column("*"))
            else:
                e = self.parse_expr()
                if self.accept_kw("AS"):
                    e = Alias(e, self.expect_ident().lower())
                elif self.peek().kind == "ident":
                    e = Alias(e, self.next().value.lower())
                stmt.projections.append(e)
            if not self.accept_punct(","):
                break
        if self.accept_kw("FROM"):
            stmt.from_tables.append(self._parse_table_ref())
            while self.accept_punct(","):
                stmt.from_tables.append(self._parse_table_ref())
        if self.accept_kw("WHERE"):
            stmt.where = self.parse_expr()
        if self.peek().is_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            if self.accept_kw("ROLLUP"):
                self.expect_punct("(")
                stmt.group_by = self._parse_group_exprs()
                self.expect_punct(")")
                k = len(stmt.group_by)
                stmt.grouping_sets = [list(range(i)) for i in range(k, -1, -1)]
            elif self.accept_kw("CUBE"):
                self.expect_punct("(")
                stmt.group_by = self._parse_group_exprs()
                self.expect_punct(")")
                k = len(stmt.group_by)
                if k > 5:
                    raise SqlParseError("CUBE over more than 5 keys")
                stmt.grouping_sets = [
                    [i for i in range(k) if m & (1 << i)] for m in range(2**k - 1, -1, -1)
                ]
            elif self.accept_kw("GROUPING"):
                self.expect_kw("SETS")
                self.expect_punct("(")
                sets: list[list[int]] = []
                order: list = []
                while True:
                    self.expect_punct("(")
                    one: list[int] = []
                    if not (self.peek().kind == "punct" and self.peek().value == ")"):
                        while True:
                            e = self.parse_expr()
                            if e not in order:
                                order.append(e)
                            one.append(order.index(e))
                            if not self.accept_punct(","):
                                break
                    self.expect_punct(")")
                    sets.append(one)
                    if not self.accept_punct(","):
                        break
                self.expect_punct(")")
                stmt.group_by = order
                stmt.grouping_sets = sets
            else:
                while True:
                    if self.peek().kind == "number":
                        stmt.group_by.append(int(self.next().value))
                    else:
                        stmt.group_by.append(self.parse_expr())
                    if not self.accept_punct(","):
                        break
        if self.accept_kw("HAVING"):
            stmt.having = self.parse_expr()
        if allow_order and self.peek().is_kw("ORDER"):
            stmt.order_by = self._parse_order_by()
        if allow_order and self.peek().is_kw("LIMIT"):
            stmt.limit, stmt.offset = self._parse_limit()
        return stmt

    def _parse_group_exprs(self) -> list:
        out = [self.parse_expr()]
        while self.accept_punct(","):
            out.append(self.parse_expr())
        return out

    def _parse_order_by(self) -> list[SortKey]:
        self.expect_kw("ORDER")
        self.expect_kw("BY")
        keys = []
        while True:
            if self.peek().kind == "number":
                e: Expr = Literal(int(self.next().value))  # ordinal, resolved by planner
            else:
                e = self.parse_expr()
            asc = True
            if self.accept_kw("DESC"):
                asc = False
            else:
                self.accept_kw("ASC")
            nulls_first = not asc
            if self.accept_kw("NULLS"):
                t = self.next()
                nulls_first = t.is_kw("FIRST")
            keys.append(SortKey(e, asc, nulls_first))
            if not self.accept_punct(","):
                break
        return keys

    def _parse_limit(self) -> tuple[int | None, int]:
        self.expect_kw("LIMIT")
        t = self.next()
        if t.kind != "number":
            raise SqlParseError("expected number after LIMIT")
        fetch = int(t.value)
        offset = 0
        if self.accept_kw("OFFSET"):
            o = self.next()
            offset = int(o.value)
        return fetch, offset

    # -- table refs ---------------------------------------------------------

    def _parse_table_ref(self) -> Any:
        left = self._parse_table_factor()
        while True:
            jt = None
            if self.peek().is_kw("JOIN"):
                jt = "inner"
                self.next()
            elif self.peek().is_kw("INNER"):
                self.next()
                self.expect_kw("JOIN")
                jt = "inner"
            elif self.peek().is_kw("LEFT"):
                self.next()
                self.accept_kw("OUTER")
                if self.accept_kw("SEMI"):
                    jt = "left_semi"
                elif self.accept_kw("ANTI"):
                    jt = "left_anti"
                else:
                    jt = "left"
                self.expect_kw("JOIN")
            elif self.peek().is_kw("RIGHT"):
                self.next()
                self.accept_kw("OUTER")
                jt = "right"
                self.expect_kw("JOIN")
            elif self.peek().is_kw("FULL"):
                self.next()
                self.accept_kw("OUTER")
                jt = "full"
                self.expect_kw("JOIN")
            elif self.peek().is_kw("CROSS"):
                self.next()
                self.expect_kw("JOIN")
                right = self._parse_table_factor()
                left = JoinClause(left, right, "cross", None)
                continue
            if jt is None:
                return left
            right = self._parse_table_factor()
            on = None
            if self.accept_kw("ON"):
                on = self.parse_expr()
            elif self.accept_kw("USING"):
                self.expect_punct("(")
                cols = [self.expect_ident().lower()]
                while self.accept_punct(","):
                    cols.append(self.expect_ident().lower())
                self.expect_punct(")")
                on = None
                for c in cols:
                    eq = BinaryExpr(Column(c, _qual_of(left)), "=", Column(c, _qual_of_right(right)))
                    on = eq if on is None else BinaryExpr(on, "and", eq)
            left = JoinClause(left, right, jt, on)

    def _parse_table_factor(self) -> Any:
        if self.accept_punct("("):
            if self.peek().is_kw("VALUES"):
                vc = self._parse_values()
                self.expect_punct(")")
                alias = None
                cols = None
                if self.accept_kw("AS"):
                    alias = self.expect_ident().lower()
                elif self.peek().kind == "ident":
                    alias = self.next().value.lower()
                if alias and self.accept_punct("("):
                    cols = [self.expect_ident().lower()]
                    while self.accept_punct(","):
                        cols.append(self.expect_ident().lower())
                    self.expect_punct(")")
                vc.alias = alias or vc.alias
                vc.column_names = cols
                return vc
            sub = self.parse_query()
            self.expect_punct(")")
            alias = None
            if self.accept_kw("AS"):
                alias = self.expect_ident().lower()
            elif self.peek().kind == "ident":
                alias = self.next().value.lower()
            return DerivedTable(sub, alias or "__subquery__")
        name = self._parse_dotted_name().lower()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect_ident().lower()
        elif self.peek().kind == "ident":
            alias = self.next().value.lower()
        return TableName(name, alias)

    def _parse_values(self):
        self.expect_kw("VALUES")
        rows = []
        while True:
            self.expect_punct("(")
            row = [self._parse_literal_value()]
            while self.accept_punct(","):
                row.append(self._parse_literal_value())
            self.expect_punct(")")
            rows.append(row)
            if not self.accept_punct(","):
                break
        if any(len(r) != len(rows[0]) for r in rows):
            raise SqlParseError("VALUES rows have differing arities")
        return ValuesClause(rows)

    # -- expressions (Pratt) -------------------------------------------------

    def parse_expr(self) -> Expr:
        return self._parse_or()

    def _parse_or(self) -> Expr:
        left = self._parse_and()
        while self.peek().is_kw("OR"):
            self.next()
            left = BinaryExpr(left, "or", self._parse_and())
        return left

    def _parse_and(self) -> Expr:
        left = self._parse_not()
        while self.peek().is_kw("AND"):
            self.next()
            left = BinaryExpr(left, "and", self._parse_not())
        return left

    def _parse_not(self) -> Expr:
        if self.accept_kw("NOT"):
            return Not(self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self) -> Expr:
        left = self._parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "<", "<=", ">", ">="):
            self.next()
            right = self._parse_additive()
            return BinaryExpr(left, t.value, right)
        negated = False
        if t.is_kw("NOT"):
            nxt = self.peek(1)
            if nxt.is_kw("IN", "LIKE", "BETWEEN"):
                self.next()
                negated = True
                t = self.peek()
        if t.is_kw("IN"):
            self.next()
            self.expect_punct("(")
            if self.peek().is_kw("SELECT", "WITH"):
                sub = self.parse_query()
                self.expect_punct(")")
                return InSubquery(left, sub, negated)
            vals = [self._parse_literal_value()]
            while self.accept_punct(","):
                vals.append(self._parse_literal_value())
            self.expect_punct(")")
            return InList(left, tuple(vals), negated)
        if t.is_kw("LIKE"):
            self.next()
            pat = self.next()
            if pat.kind != "string":
                raise SqlParseError("expected string pattern after LIKE")
            return Like(left, pat.value, negated)
        if t.is_kw("BETWEEN"):
            self.next()
            lo = self._parse_additive()
            self.expect_kw("AND")
            hi = self._parse_additive()
            return Between(left, lo, hi, negated)
        if t.is_kw("IS"):
            self.next()
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                return IsNotNull(left)
            self.expect_kw("NULL")
            return IsNull(left)
        return left

    def _parse_additive(self) -> Expr:
        left = self._parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                right = self._parse_multiplicative()
                left = BinaryExpr(left, t.value, right)
            elif t.kind == "op" and t.value == "||":
                self.next()
                right = self._parse_multiplicative()
                left = ScalarFunction("concat", (left, right))
            else:
                return left

    def _parse_multiplicative(self) -> Expr:
        left = self._parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = BinaryExpr(left, t.value, self._parse_unary())
            else:
                return left

    def _parse_unary(self) -> Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            return Negative(self._parse_unary())
        if t.kind == "op" and t.value == "+":
            self.next()
            return self._parse_unary()
        return self._parse_primary()

    def _parse_literal_value(self) -> Any:
        t = self.next()
        if t.kind == "string":
            return t.value
        if t.kind == "number":
            return _num(t.value)
        if t.is_kw("TRUE"):
            return True
        if t.is_kw("FALSE"):
            return False
        if t.is_kw("NULL"):
            return None
        if t.is_kw("DATE"):
            s = self.next()
            return _dt.date.fromisoformat(s.value)
        if t.kind == "op" and t.value == "-":
            v = self._parse_literal_value()
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise SqlParseError(f"cannot negate literal {v!r} at {t.pos}")
            return -v
        raise SqlParseError(f"expected literal, got {t.value!r} at {t.pos}")

    SOFT_KEYWORDS = ("ROLLUP", "CUBE", "GROUPING", "SETS")

    def _parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "kw" and t.value in self.SOFT_KEYWORDS:
            # contextual keywords: valid column/table names outside GROUP BY
            self.next()
            return self._parse_ident_expr_from(t.value.lower())
        if t.kind == "punct" and t.value == "(":
            self.next()
            if self.peek().is_kw("SELECT", "WITH"):
                sub = self.parse_query()
                self.expect_punct(")")
                return ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect_punct(")")
            return e
        if t.is_kw("EXISTS"):
            self.next()
            self.expect_punct("(")
            sub = self.parse_query()
            self.expect_punct(")")
            return Exists(sub)
        if t.is_kw("NOT"):
            # NOT EXISTS handled at _parse_not; here only for safety
            self.next()
            return Not(self._parse_primary())
        if t.is_kw("CASE"):
            return self._parse_case()
        if t.is_kw("CAST"):
            self.next()
            self.expect_punct("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            ty = self._parse_type()
            self.expect_punct(")")
            return Cast(e, ty)
        if t.is_kw("EXTRACT"):
            self.next()
            self.expect_punct("(")
            part = self.expect_ident() if self.peek().kind == "ident" else self.next().value
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_punct(")")
            return ScalarFunction(f"extract_{part.lower()}", (e,))
        if t.is_kw("SUBSTRING"):
            self.next()
            self.expect_punct("(")
            e = self.parse_expr()
            if self.accept_kw("FROM"):
                start = self.parse_expr()
                length = None
                if self.accept_kw("FOR"):
                    length = self.parse_expr()
            else:
                self.expect_punct(",")
                start = self.parse_expr()
                length = None
                if self.accept_punct(","):
                    length = self.parse_expr()
            self.expect_punct(")")
            args = (e, start) if length is None else (e, start, length)
            return ScalarFunction("substr", args)
        if t.is_kw("DATE"):
            self.next()
            s = self.next()
            if s.kind != "string":
                raise SqlParseError("expected string after DATE")
            return Literal(_dt.date.fromisoformat(s.value))
        if t.is_kw("INTERVAL"):
            self.next()
            s = self.next()
            # INTERVAL '3' MONTH  |  INTERVAL '1' YEAR  |  INTERVAL '90' DAY
            # also INTERVAL '3 month' (datafusion style)
            if s.kind != "string":
                raise SqlParseError("expected string after INTERVAL")
            text = s.value.strip()
            unit = None
            if self.peek().kind == "ident" and self.peek().value.upper() in (
                "DAY", "DAYS", "MONTH", "MONTHS", "YEAR", "YEARS",
            ):
                unit = self.next().value.upper()
            else:
                parts = text.split()
                if len(parts) == 2:
                    text, unit = parts[0], parts[1].upper()
            if unit is None:
                raise SqlParseError(f"cannot parse interval {s.value!r}")
            n = int(text)
            unit = unit.rstrip("S")
            return _IntervalLiteral(n, unit.lower())
        if t.is_kw("TRUE"):
            self.next()
            return Literal(True)
        if t.is_kw("FALSE"):
            self.next()
            return Literal(False)
        if t.is_kw("NULL"):
            self.next()
            return Literal(None)
        if t.kind == "string":
            self.next()
            return Literal(t.value)
        if t.kind == "number":
            self.next()
            return Literal(_num(t.value))
        if t.kind == "ident" or t.is_kw("LEFT", "RIGHT"):
            return self._parse_ident_expr()
        raise SqlParseError(f"unexpected token {t.value!r} at {t.pos}")

    def _parse_case(self) -> Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.peek().is_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("WHEN"):
            w = self.parse_expr()
            if operand is not None:
                w = BinaryExpr(operand, "=", w)
            self.expect_kw("THEN")
            th = self.parse_expr()
            branches.append((w, th))
        els = None
        if self.accept_kw("ELSE"):
            els = self.parse_expr()
        self.expect_kw("END")
        return Case(tuple(branches), els)

    def _parse_type(self) -> pa.DataType:
        t = self.next()
        name = t.value.upper()
        ty = _TYPE_NAMES.get(name)
        if ty is None:
            raise SqlParseError(f"unknown type {t.value!r}")
        # optional (p[,s]) — ignored (decimal policy / varchar length)
        if self.accept_punct("("):
            self.next()
            if self.accept_punct(","):
                self.next()
            self.expect_punct(")")
        return ty

    def _parse_ident_expr(self) -> Expr:
        return self._parse_ident_expr_from(self.next().value)

    def _parse_ident_expr_from(self, name: str) -> Expr:
        # function call?
        if self.peek().kind == "punct" and self.peek().value == "(":
            return self._parse_function(name)
        if self.accept_punct("."):
            col = self.expect_ident()
            return Column(col.lower(), name.lower())
        return Column(name.lower())

    def _parse_function(self, name: str) -> Expr:
        up = name.upper()
        self.expect_punct("(")
        if up == "COUNT":
            if self.peek().kind == "op" and self.peek().value == "*":
                self.next()
                self.expect_punct(")")
                return self._maybe_window(AggregateFunction("count", None))
            if self.accept_kw("DISTINCT"):
                arg = self.parse_expr()
                self.expect_punct(")")
                return self._maybe_window(AggregateFunction("count_distinct", arg, True))
            arg = self.parse_expr()
            self.expect_punct(")")
            return self._maybe_window(AggregateFunction("count", arg))
        if up in AGGREGATES:
            distinct = self.accept_kw("DISTINCT")
            arg = self.parse_expr()
            self.expect_punct(")")
            canonical = _AGG_CANONICAL.get(up.lower(), up.lower())
            return self._maybe_window(AggregateFunction(canonical, arg, distinct))
        args: list[Expr] = []
        if not (self.peek().kind == "punct" and self.peek().value == ")"):
            args.append(self.parse_expr())
            while self.accept_punct(","):
                args.append(self.parse_expr())
        self.expect_punct(")")
        canonical = SCALAR_FUNCS.get(up)
        if canonical is None:
            canonical = name.lower()
        if canonical == "strpos" and up == "POSITION":
            args = [args[1], args[0]] if len(args) == 2 else args
        return self._maybe_window(ScalarFunction(canonical, tuple(args)))

    def _maybe_window(self, fn: Expr) -> Expr:
        """fn(...) OVER (PARTITION BY ... ORDER BY ...) → WindowFunction."""
        if not self.accept_kw("OVER"):
            if isinstance(fn, ScalarFunction) and fn.name in (
                "row_number", "rank", "dense_rank", "lag", "lead"
            ):
                raise SqlParseError(f"{fn.name}() requires an OVER clause")
            return fn
        self.expect_punct("(")
        partition_by: list[Expr] = []
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self.parse_expr())
            while self.accept_punct(","):
                partition_by.append(self.parse_expr())
        order_by: list[SortKey] = []
        if self.peek().is_kw("ORDER"):
            order_by = self._parse_order_by()
        frame = self._maybe_frame()
        self.expect_punct(")")
        if isinstance(fn, AggregateFunction):
            if fn.distinct or fn.func == "count_distinct":
                raise SqlParseError("DISTINCT window aggregates are unsupported")
            if fn.func not in WINDOW_FUNCS:
                raise SqlParseError(f"{fn.func}() is not supported as a window function")
            func = fn.func
            args: tuple = (fn.arg,) if fn.arg is not None else ()
        elif isinstance(fn, ScalarFunction) and fn.name in WINDOW_FUNCS:
            func, args = fn.name, fn.args
        else:
            raise SqlParseError(f"{fn} is not a window function")
        if func in ("lag", "lead") and not (1 <= len(args) <= 3):
            raise SqlParseError(f"{func} takes 1-3 arguments, got {len(args)}")
        if func in ("row_number", "rank", "dense_rank") and args:
            raise SqlParseError(f"{func} takes no arguments")
        if frame is not None and func not in ("sum", "avg", "min", "max", "count"):
            raise SqlParseError(f"{func} does not take a frame clause")
        return WindowFunction(func, args, tuple(partition_by), tuple(order_by), frame)

    def _maybe_frame(self):
        """ROWS BETWEEN <bound> AND <bound> (contextual words — ROWS /
        UNBOUNDED / PRECEDING / FOLLOWING lex as identifiers, so columns
        with those names stay usable). RANGE frames with offsets are
        unsupported; the default RANGE UNBOUNDED..CURRENT is frame=None."""
        t = self.peek()
        word = t.value.upper() if t.kind == "ident" else ""
        if word not in ("ROWS", "RANGE"):
            return None
        self.next()
        if word == "RANGE":
            raise SqlParseError("explicit RANGE frames are unsupported (use ROWS)")

        def bound(is_start: bool) -> int | None:
            b = self.next()
            w = b.value.upper() if b.kind in ("ident", "number") else b.value
            if w == "UNBOUNDED":
                side = self.next().value.upper()
                # direction is positional: only UNBOUNDED PRECEDING can open
                # a frame, only UNBOUNDED FOLLOWING can close one
                want = "PRECEDING" if is_start else "FOLLOWING"
                if side != want:
                    raise SqlParseError(
                        f"UNBOUNDED {side} is invalid as a frame "
                        f"{'start' if is_start else 'end'} (expected {want})"
                    )
                return None
            if w == "CURRENT":
                nxt = self.next()
                if nxt.value.upper() != "ROW":
                    raise SqlParseError("expected ROW after CURRENT")
                return 0
            if b.kind == "number":
                side = self.next().value.upper()
                try:
                    off = int(b.value)
                except ValueError:
                    raise SqlParseError(f"frame offset must be an integer, got {b.value!r}") from None
                if side == "PRECEDING":
                    return -off
                if side == "FOLLOWING":
                    return off
                raise SqlParseError("expected PRECEDING/FOLLOWING after frame offset")
            raise SqlParseError(f"bad frame bound {b.value!r}")

        if self.accept_kw("BETWEEN"):
            start = bound(True)
            self.expect_kw("AND")
            end = bound(False)
        else:
            start = bound(True)
            end = 0  # single-bound form: <bound> .. CURRENT ROW
        return ("rows", start, end)


def _num(s: str):
    if "e" in s or "E" in s:
        return float(s)  # scientific notation: approximate by intent
    if "." in s:
        # exact decimal policy: plain decimal literals carry minimal
        # precision/scale (0.06 → decimal(2,2)) so money arithmetic stays
        # exact; Arrow promotes them transparently in float contexts
        import decimal

        return decimal.Decimal(s)
    return int(s)


class _IntervalLiteral(Literal):
    """Interval literal (days/months/years); arithmetic handled by engines."""

    def __init__(self, n: int, unit: str):
        super().__init__((n, unit))
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "unit", unit)

    def data_type(self, schema):
        return pa.duration("s")  # placeholder; date arithmetic handled specially

    def __str__(self) -> str:
        return f"INTERVAL '{self.n}' {self.unit.upper()}"


def _qual_of(ref: Any) -> str | None:
    from ballista_tpu_torch.sql.ast import DerivedTable, JoinClause, TableName

    if isinstance(ref, TableName):
        return ref.alias or ref.name
    if isinstance(ref, DerivedTable):
        return ref.alias
    return None


def _qual_of_right(ref: Any) -> str | None:
    return _qual_of(ref)


def parse_sql(sql: str) -> Any:
    p = Parser(sql)
    stmt = p.parse_statement()
    p.accept_punct(";")
    t = p.peek()
    if t.kind != "eof":
        raise SqlParseError(f"unexpected trailing input at {t.pos}: {t.value!r}")
    return stmt
