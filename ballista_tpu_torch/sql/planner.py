"""SQL planner (binder): AST → LogicalPlan.

Responsibilities:
- resolve table names (catalog + CTE environment) and aliases,
- plan FROM (comma refs become CrossJoins; explicit JOIN ... ON splits into
  equi keys + residual filter),
- detect aggregates and rewrite post-aggregation expressions to reference
  aggregate outputs,
- plan subqueries recursively (correlated columns stay unresolved inside the
  subplan; the decorrelation optimizer turns them into joins),
- resolve ORDER BY aliases/ordinals against the projection output.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.expressions import (
    AggregateFunction,
    Alias,
    BinaryExpr,
    Column,
    Exists,
    Expr,
    InSubquery,
    Literal,
    ScalarSubquery,
    SortKey,
    WindowFunction,
    collect_columns,
    split_conjunction,
    transform_expr,
)
from ballista_tpu_torch.plan.logical import (
    Aggregate,
    CrossJoin,
    Distinct,
    EmptyRelation,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Sort,
    SubqueryAlias,
    TableScan,
    Union,
    Window,
)
from ballista_tpu_torch.sql.ast import DerivedTable, JoinClause, SelectStmt, TableName


class SqlPlanner:
    def __init__(self, catalog):
        self.catalog = catalog

    def plan_query(self, stmt: SelectStmt, cte_env: dict[str, LogicalPlan] | None = None) -> LogicalPlan:
        cte_env = dict(cte_env or {})
        for name, sub in stmt.ctes:
            cte_env[name] = self.plan_query(sub, cte_env)
        # a trailing ORDER BY / LIMIT of a set-operation chain orders the
        # WHOLE union, not the first branch — defer them past the Union
        defer = stmt.set_op is not None
        plan = self._plan_select(stmt, cte_env, defer_order=defer)
        if stmt.set_op is not None:
            # LEFT-associative chain walk: `a UNION ALL b UNION c` dedups
            # the whole accumulated left side, never just a branch
            # collect the chain, then apply SQL precedence: INTERSECT
            # binds tighter than UNION/EXCEPT
            chain = [(None, plan)]
            cur = stmt
            while cur.set_op is not None:
                op, rhs = cur.set_op
                chain.append((op, self._plan_select(rhs, cte_env, defer_order=True)))
                cur = rhs
            terms: list[tuple[str | None, LogicalPlan]] = []
            for op, p_ in chain:
                if op in ("intersect", "intersect_all") and terms:
                    lop, lp = terms[-1]
                    terms[-1] = (lop, self._set_op_join(lp, p_, op))
                else:
                    terms.append((op, p_))
            plan = terms[0][1]
            for op, p_ in terms[1:]:
                if op in ("union", "union_all"):
                    plan = Union([plan, p_], all=(op == "union_all"))
                    if op == "union":
                        plan = Distinct(plan)
                else:  # except / except_all
                    plan = self._set_op_join(plan, p_, op)
            if stmt.order_by:
                keys = []
                for sk in stmt.order_by:
                    e = sk.expr
                    if isinstance(e, Literal) and isinstance(e.value, int):
                        e = Column(plan.schema.field(e.value - 1).name)
                    keys.append(SortKey(e, sk.ascending, sk.nulls_first))
                plan = Sort(plan, keys, fetch=None)
            if stmt.limit is not None or stmt.offset:
                if isinstance(plan, Sort):
                    plan = replace(
                        plan,
                        fetch=(stmt.limit + stmt.offset) if stmt.limit is not None else None,
                    )
                    plan.__post_init__()
                plan = Limit(plan, stmt.limit, stmt.offset)
        return plan

    # ------------------------------------------------------------------

    def _plan_select(self, stmt: SelectStmt, cte_env: dict[str, LogicalPlan],
                     defer_order: bool = False) -> LogicalPlan:
        # FROM
        if stmt.from_tables:
            plan = self._plan_table_ref(stmt.from_tables[0], cte_env)
            for ref in stmt.from_tables[1:]:
                plan = CrossJoin(plan, self._plan_table_ref(ref, cte_env))
        else:
            plan = EmptyRelation(produce_one_row=True)

        # WHERE
        if stmt.where is not None:
            pred = self._bind_subqueries(stmt.where, cte_env)
            plan = Filter(plan, pred)

        # projections: expand *, bind subqueries
        projections: list[Expr] = []
        for e in stmt.projections:
            if isinstance(e, Column) and e.name == "*":
                for f in plan.schema:
                    projections.append(Column(f.name, f.qualifier))
            else:
                projections.append(self._bind_subqueries(e, cte_env))

        having = self._bind_subqueries(stmt.having, cte_env) if stmt.having is not None else None

        # GROUP BY (ordinals refer to select list)
        group_exprs: list[Expr] = []
        for g in stmt.group_by:
            if isinstance(g, int):
                e = projections[g - 1]
                group_exprs.append(e.expr if isinstance(e, Alias) else e)
            else:
                ge = self._bind_subqueries(g, cte_env)
                # GROUP BY may name a select alias
                ge = self._substitute_select_alias(ge, projections)
                group_exprs.append(ge)

        agg_funcs = _collect_aggs(projections + ([having] if having is not None else []))

        if stmt.grouping_sets is not None:
            plan = self._plan_grouping_sets(
                plan, stmt.grouping_sets, group_exprs, agg_funcs, projections, having
            )
            # first branch's projection stands in for ORDER BY resolution
            proj = plan.inputs[0] if isinstance(plan, Union) else plan
        else:
            if group_exprs or agg_funcs:
                agg = Aggregate(plan, group_exprs, agg_funcs)
                rewrite = lambda e: _rewrite_post_agg(e, group_exprs, agg_funcs)
                projections = [rewrite(p) for p in projections]
                plan = agg
                if having is not None:
                    plan = Filter(plan, rewrite(having))

            # window functions compute over the (post-aggregation) input;
            # each unique window expr becomes a __win{i} column
            window_exprs = _collect_windows(projections)
            if window_exprs:
                win = Window(plan, window_exprs)

                def rewrite_win(e: Expr) -> Expr:
                    def repl(x: Expr) -> Expr:
                        if isinstance(x, WindowFunction):
                            return Column(f"__win{window_exprs.index(x)}")
                        return x

                    return transform_expr(e, repl)

                projections = [rewrite_win(p) for p in projections]
                plan = win

            proj = Projection(plan, projections)
            plan = proj

        if stmt.distinct:
            plan = Distinct(plan)

        if defer_order:
            return plan  # union chain: ORDER BY/LIMIT applied above the Union

        # ORDER BY against projection output
        if stmt.order_by:
            keys = []
            for sk in stmt.order_by:
                e = sk.expr
                if isinstance(e, Literal) and isinstance(e.value, int):
                    e = Column(plan.schema.field(e.value - 1).name)
                else:
                    e = self._resolve_order_expr(e, proj, cte_env)
                keys.append(SortKey(e, sk.ascending, sk.nulls_first))
            plan = Sort(plan, keys, fetch=None)

        if stmt.limit is not None or stmt.offset:
            if isinstance(plan, Sort):
                plan = replace(plan, fetch=(stmt.limit + stmt.offset) if stmt.limit is not None else None)
                plan.__post_init__()
            plan = Limit(plan, stmt.limit, stmt.offset)
        return plan

    def _set_op_join(self, left: LogicalPlan, right: LogicalPlan, op: str) -> LogicalPlan:
        """INTERSECT = distinct left SEMI-joined to right on every column;
        EXCEPT = distinct left ANTI-joined. The ALL (bag) forms number
        duplicate rows per side with row_number() partitioned by the whole
        row and include the number in the join key — the k-th copy on the
        left matches only a k-th copy on the right (standard lowering).
        Keys are null-safe: each column contributes (IS NULL flag,
        COALESCE(col, typed default)) so NULLs compare equal per SQL set
        semantics without sentinel collisions."""
        import datetime as _dt

        import pyarrow as _pa

        from ballista_tpu_torch.plan.expressions import IsNull, ScalarFunction, WindowFunction
        from ballista_tpu_torch.plan.logical import Window

        if len(left.schema.fields) != len(right.schema.fields):
            raise PlanningError(f"{op.upper()} arity mismatch")
        for side in (left, right):
            names = [f.name for f in side.schema.fields]
            if len(set(names)) != len(names):
                raise PlanningError(
                    f"{op.upper()} requires distinct output column names; "
                    f"alias the duplicates ({names})"
                )

        def default_for(t):
            if _pa.types.is_floating(t):
                return Literal(0.0)
            if _pa.types.is_integer(t):
                return Literal(0)
            if _pa.types.is_boolean(t):
                return Literal(False)
            if _pa.types.is_date(t):
                return Literal(_dt.date(1970, 1, 1))
            return Literal("")

        bag = op.endswith("_all")
        n_cols = len(left.schema.fields)

        def numbered(side: LogicalPlan) -> LogicalPlan:
            part = tuple(Column(f.name, f.qualifier) for f in side.schema.fields)
            w = Window(side, [WindowFunction("row_number", (), part, ())])
            # __win0 → a stable name distinct from user columns
            return Projection(w, [Column(f.name, f.qualifier)
                                  for f in side.schema.fields]
                              + [Alias(Column("__win0"), "__dup_n")])

        if bag:
            lw = SubqueryAlias(numbered(left), "__setl")
            rw = SubqueryAlias(numbered(right), "__setr")
        else:
            lw = SubqueryAlias(Distinct(left), "__setl")
            rw = SubqueryAlias(right, "__setr")
        on = []
        for lf, rf in list(zip(lw.schema.fields, rw.schema.fields))[:n_cols]:
            lc, rc = Column(lf.name, "__setl"), Column(rf.name, "__setr")
            on.append((IsNull(lc), IsNull(rc)))
            on.append((ScalarFunction("coalesce", (lc, default_for(lf.dtype))),
                       ScalarFunction("coalesce", (rc, default_for(rf.dtype)))))
        if bag:
            on.append((Column("__dup_n", "__setl"), Column("__dup_n", "__setr")))
        jt = "left_semi" if op.startswith("intersect") else "left_anti"
        joined = Join(lw, rw, on, jt, None)
        return Projection(joined, [
            Alias(Column(f.name, "__setl"), f.name)
            for f in lw.schema.fields[:n_cols]
        ])

    def _plan_grouping_sets(self, plan: LogicalPlan, sets: list[list[int]],
                            group_exprs: list[Expr], agg_funcs: list[Expr],
                            projections: list[Expr], having) -> LogicalPlan:
        """ROLLUP/CUBE/GROUPING SETS lowering: one Aggregate branch per
        grouping set, grouped-out keys projected as typed NULLs, branches
        UNION ALLed (the standard expansion; DataFusion lowers the same
        way behind the reference)."""
        from ballista_tpu_torch.plan.expressions import Cast, ScalarFunction

        # window exprs compute AFTER the union (over all grouping-set rows);
        # inside branches they are replaced by their (aggregate) inputs'
        # outputs, referenced by name post-union
        window_exprs = _collect_windows(projections)

        branches: list[LogicalPlan] = []
        for s in sets:
            set_exprs = [group_exprs[i] for i in s]
            dropped = [g for i, g in enumerate(group_exprs) if i not in s]

            def per_branch(e: Expr) -> Expr:
                # grouping(col): 1 when col is grouped-out in this set
                # (constant per branch — the SQL grouping() marker fn);
                # grouped-out OUTPUT keys become typed NULLs; aggregate
                # arguments keep seeing real values and agg subtrees stay
                # structurally identical for _rewrite_post_agg to match
                if isinstance(e, ScalarFunction) and e.name == "grouping" and len(e.args) == 1:
                    arg = e.args[0]
                    if any(_group_key_matches(arg, d) for d in dropped):
                        return Literal(1)
                    if any(_group_key_matches(arg, g) for g in group_exprs):
                        return Literal(0)
                    raise PlanningError(f"grouping({arg}) is not a GROUP BY expression")
                if isinstance(e, AggregateFunction):
                    return e
                for d in dropped:
                    if e == d:
                        return Cast(Literal(None), d.data_type(plan.schema))
                kids = e.children()
                if kids:
                    new_kids = [per_branch(k) for k in kids]
                    if new_kids != kids:
                        return e.with_children(new_kids)
                return e

            node: LogicalPlan = Aggregate(plan, set_exprs, agg_funcs)
            if having is not None:
                node = Filter(node, _rewrite_post_agg(per_branch(having), set_exprs, agg_funcs))
            branch_projs: list[Expr] = []
            for p in projections:
                name = p.name if isinstance(p, Alias) else p.output_name()
                inner = p.expr if isinstance(p, Alias) else p
                if window_exprs:
                    inner = _strip_windows(inner)
                pe = _rewrite_post_agg(per_branch(inner), set_exprs, agg_funcs)
                branch_projs.append(Alias(pe, name))
            branches.append(Projection(node, branch_projs))
        out: LogicalPlan = Union(branches, all=True)

        if window_exprs:
            # rebuild the window exprs against the UNION output (aggregate
            # and grouped-key references resolve by projection name), wrap a
            # Window node, and project the final select list
            name_of = {}
            for p in projections:
                name = p.name if isinstance(p, Alias) else p.output_name()
                inner = p.expr if isinstance(p, Alias) else p
                name_of[str(_strip_windows(inner))] = name

            def to_union_cols(e: Expr) -> Expr:
                key = str(e)
                if key in name_of:
                    return Column(name_of[key])
                # unresolvable aggregate/grouping markers must error BEFORE
                # child remapping could disguise them as evaluable exprs
                if isinstance(e, AggregateFunction) or (
                    isinstance(e, ScalarFunction) and e.name == "grouping"
                ):
                    raise PlanningError(
                        f"window input {e} must appear in the SELECT list when "
                        "windowing over GROUPING SETS"
                    )
                kids = e.children()
                if kids:
                    nk = [to_union_cols(k) for k in kids]
                    if nk != kids:
                        return e.with_children(nk)
                return e

            uwindows = []
            for w in window_exprs:
                uwindows.append(WindowFunction(
                    w.func,
                    tuple(to_union_cols(a) for a in w.args),
                    tuple(to_union_cols(pb) for pb in w.partition_by),
                    tuple(SortKey(to_union_cols(k.expr), k.ascending, k.nulls_first)
                          for k in w.order_by),
                    w.frame,
                ))
            win = Window(out, uwindows)
            final_projs: list[Expr] = []
            for p in projections:
                name = p.name if isinstance(p, Alias) else p.output_name()
                inner = p.expr if isinstance(p, Alias) else p

                def repl(x: Expr) -> Expr:
                    if isinstance(x, WindowFunction):
                        return Column(f"__win{window_exprs.index(x)}")
                    return x

                mapped = transform_expr(inner, repl)
                # non-window parts now reference the union columns by name
                def nonwin(x: Expr) -> Expr:
                    key = str(x)
                    if key in name_of and not isinstance(x, Column):
                        return Column(name_of[key])
                    return x

                mapped = transform_expr(mapped, nonwin)
                _assert_fully_resolved(mapped)
                final_projs.append(Alias(mapped, name))
            out = Projection(win, final_projs)
        return out

    def _resolve_order_expr(self, e: Expr, proj: Projection, cte_env) -> Expr:
        out_schema = proj.schema
        if isinstance(e, Column) and e.qualifier is None:
            if out_schema.maybe_index_of(e.name) is not None:
                return e
        # structural match against a projection expr (e.g. ORDER BY sum(x))
        bound = self._bind_subqueries(e, cte_env)
        for p in proj.exprs:
            inner = p.expr if isinstance(p, Alias) else p
            if inner == bound:
                return Column(p.output_name())
        # falls through: expression over projection-output columns
        return bound

    def _substitute_select_alias(self, e: Expr, projections: list[Expr]) -> Expr:
        if isinstance(e, Column) and e.qualifier is None:
            for p in projections:
                if isinstance(p, Alias) and p.name == e.name:
                    return p.expr
        return e

    # ------------------------------------------------------------------

    def _plan_table_ref(self, ref: Any, cte_env: dict[str, LogicalPlan]) -> LogicalPlan:
        if isinstance(ref, TableName):
            if ref.name in cte_env:
                return SubqueryAlias(cte_env[ref.name], ref.alias or ref.name)
            provider = self.catalog.get(ref.name)
            if provider is None:
                raise PlanningError(f"table not found: {ref.name}")
            return TableScan(ref.name, provider, alias=ref.alias)
        if isinstance(ref, DerivedTable):
            return SubqueryAlias(self.plan_query(ref.select, cte_env), ref.alias)
        from ballista_tpu_torch.sql.ast import ValuesClause

        if isinstance(ref, ValuesClause):
            from ballista_tpu_torch.plan.logical import Values

            # schema derives from the FIRST row: later rows must agree (a
            # clean error beats an opaque ArrowInvalid at execution); None
            # is compatible with anything
            first = ref.rows[0]
            for r in ref.rows[1:]:
                for a, b in zip(first, r):
                    if a is None or b is None:
                        continue
                    ta = float if isinstance(a, float) else type(a)
                    tb = float if isinstance(b, float) else type(b)
                    if isinstance(a, bool) != isinstance(b, bool) or (
                        ta is not tb and not ({ta, tb} == {int, float})
                    ):
                        raise PlanningError(
                            f"VALUES rows mix types: {a!r} vs {b!r}"
                        )
                    if {ta, tb} == {int, float}:
                        raise PlanningError(
                            f"VALUES rows mix int and float ({a!r} vs {b!r}); "
                            "write consistent numeric literals"
                        )
            if any(v is None for v in first):
                raise PlanningError(
                    "NULL in the first VALUES row leaves its column untyped; "
                    "put a typed value first"
                )
            node: LogicalPlan = Values(ref.rows)
            if ref.column_names:
                if len(ref.column_names) != len(node.schema.fields):
                    raise PlanningError(
                        f"VALUES arity {len(node.schema.fields)} != column list "
                        f"{len(ref.column_names)}"
                    )
                node = Projection(node, [
                    Alias(Column(f.name), cn)
                    for f, cn in zip(node.schema.fields, ref.column_names)
                ])
            return SubqueryAlias(node, ref.alias)
        if isinstance(ref, JoinClause):
            left = self._plan_table_ref(ref.left, cte_env)
            right = self._plan_table_ref(ref.right, cte_env)
            if ref.join_type == "cross" or ref.on is None:
                return CrossJoin(left, right)
            on = self._bind_subqueries(ref.on, cte_env)
            keys, residual = split_join_condition(on, left.schema, right.schema)
            return Join(left, right, keys, ref.join_type, residual)
        raise PlanningError(f"unsupported table ref {ref!r}")

    # ------------------------------------------------------------------

    def _bind_subqueries(self, e: Expr, cte_env: dict[str, LogicalPlan]) -> Expr:
        """Replace raw SelectStmt payloads inside subquery exprs with planned
        LogicalPlans. Correlated outer columns remain unresolved names."""

        def fn(x: Expr) -> Expr:
            if isinstance(x, ScalarSubquery) and isinstance(x.plan, SelectStmt):
                return ScalarSubquery(self.plan_query(x.plan, cte_env))
            if isinstance(x, InSubquery) and isinstance(x.plan, SelectStmt):
                return InSubquery(x.expr, self.plan_query(x.plan, cte_env), x.negated)
            if isinstance(x, Exists) and isinstance(x.plan, SelectStmt):
                return Exists(self.plan_query(x.plan, cte_env), x.negated)
            return x

        return transform_expr(e, fn)


# -- helpers ----------------------------------------------------------------


def _group_key_matches(arg: Expr, key: Expr) -> bool:
    """grouping() argument vs a GROUP BY expression: structural equality,
    with qualifier-tolerant Column matching (grouping(t.a) vs GROUP BY a)."""
    if arg == key:
        return True
    if isinstance(arg, Column) and isinstance(key, Column) and arg.name == key.name:
        return arg.qualifier is None or key.qualifier is None or arg.qualifier == key.qualifier
    return False


def _assert_fully_resolved(e: Expr) -> None:
    """Post-union projections must not retain aggregate/grouping nodes —
    they are only evaluable inside the per-set branches."""
    from ballista_tpu_torch.plan.expressions import ScalarFunction

    if isinstance(e, AggregateFunction) or (
        isinstance(e, ScalarFunction) and e.name == "grouping"
    ):
        raise PlanningError(
            f"{e} must appear in the SELECT list to be referenced alongside a "
            "window over GROUPING SETS"
        )
    for c in e.children():
        _assert_fully_resolved(c)


def _strip_windows(e: Expr) -> Expr:
    """Inside grouping-set branches a window expr contributes nothing —
    replace with a typed NULL placeholder (the post-union Window recomputes
    the real value; the final projection overwrites this column)."""
    from ballista_tpu_torch.plan.expressions import Cast

    def repl(x: Expr) -> Expr:
        if isinstance(x, WindowFunction):
            import pyarrow as _pa

            return Cast(Literal(None), _pa.float64())
        return x

    return transform_expr(e, repl)


def _collect_windows(exprs: list[Expr]) -> list[Expr]:
    """Unique WindowFunction expressions, in first-appearance order."""
    seen: list[Expr] = []

    def walk(e: Expr) -> None:
        if isinstance(e, WindowFunction):
            if e not in seen:
                seen.append(e)
            return
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return seen


def _collect_aggs(exprs: list[Expr]) -> list[Expr]:
    """Unique aggregate function expressions, in first-appearance order."""
    seen: list[Expr] = []

    def walk(e: Expr) -> None:
        if isinstance(e, AggregateFunction):
            if e not in seen:
                seen.append(e)
            return  # no nested aggs
        for c in e.children():
            walk(c)
        if isinstance(e, (ScalarSubquery, InSubquery, Exists)):
            pass  # subquery aggs belong to the subquery

    for e in exprs:
        walk(e)
    return seen


def _rewrite_post_agg(e: Expr, group_exprs: list[Expr], agg_funcs: list[Expr]) -> Expr:
    """Rewrite an expression evaluated above an Aggregate so every group-expr
    / agg-func occurrence becomes a column reference to the aggregate output."""

    def rec(x: Expr) -> Expr:
        if isinstance(x, Alias):
            return Alias(rec(x.expr), x.name)
        for g in group_exprs:
            if x == g:
                return Column(g.output_name(), g.qualifier if isinstance(g, Column) else None)
        if isinstance(x, AggregateFunction):
            for a in agg_funcs:
                if x == a:
                    return Column(a.output_name())
            raise PlanningError(f"aggregate {x} not in aggregate node")
        kids = x.children()
        if kids:
            return x.with_children([rec(k) for k in kids])
        return x

    return rec(e)


def split_join_condition(on: Expr, left_schema, right_schema):
    """Split an ON condition into equi-key pairs and a residual filter."""
    keys: list[tuple[Expr, Expr]] = []
    residual: list[Expr] = []
    for c in split_conjunction(on):
        pair = _as_equi_pair(c, left_schema, right_schema)
        if pair is not None:
            keys.append(pair)
        else:
            residual.append(c)
    res = None
    if residual:
        from ballista_tpu_torch.plan.expressions import and_

        res = and_(*residual)
    return keys, res


def _resolves(e: Expr, schema) -> bool:
    cols = collect_columns(e)
    if not cols:
        return False  # constants belong in residual
    return all(schema.maybe_index_of(c.name, c.qualifier) is not None for c in cols)


def _as_equi_pair(c: Expr, left_schema, right_schema):
    if isinstance(c, BinaryExpr) and c.op == "=":
        l, r = c.left, c.right
        if _resolves(l, left_schema) and _resolves(r, right_schema):
            return (l, r)
        if _resolves(r, left_schema) and _resolves(l, right_schema):
            return (r, l)
    return None
