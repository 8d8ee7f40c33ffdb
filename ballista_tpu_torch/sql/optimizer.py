"""Logical optimizer.

Passes, in order:
1. fold_constants     — literal arithmetic, date ± interval
2. factor_or          — (A∧X)∨(A∧Y) → A ∧ (X∨Y)   (q19's join key extraction)
3. decorrelate        — scalar/IN/EXISTS subqueries → joins
4. extract_joins      — Filter over CrossJoin chains → greedy left-deep Joins
5. push_filters       — single-side conjuncts below joins, scan-level
                        predicates into TableScan.filters
6. prune_columns      — projection pushdown into TableScan

The reference gets all of this from DataFusion's optimizer; the shapes the
distributed planner expects downstream (stage boundaries around joins and
aggregates) are the same.

NULL-semantics caveat: NOT IN (subquery) lowers to an anti join, which is
only equivalent when neither side of the key is NULL (true for every TPC-H
key column). A general three-valued-logic rewrite is future work.
"""

from __future__ import annotations

import datetime as _dt



from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.expressions import (
    Alias,
    Between,
    BinaryExpr,
    Column,
    Exists,
    Expr,
    InList,
    InSubquery,
    IsNotNull,
    IsNull,
    Literal,
    Negative,
    Not,
    ScalarFunction,
    ScalarSubquery,
    and_,
    collect_columns,
    expr_any,
    split_conjunction,
    transform_expr,
)
from ballista_tpu_torch.plan.logical import (
    Aggregate,
    CrossJoin,
    Distinct,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Sort,
    SubqueryAlias,
    TableScan,
    Union,
    transform_plan_up,
    Window,
)


def optimize(plan: LogicalPlan) -> LogicalPlan:
    plan = rewrite_exprs(plan, fold_constants)
    plan = rewrite_exprs(plan, factor_or)
    plan = Decorrelator().run(plan)
    plan = transform_plan_up(plan, extract_joins)
    plan = push_filters(plan)
    plan = prune_columns(plan)
    return plan


# -- 1. constant folding ----------------------------------------------------


def fold_constants(e: Expr) -> Expr:
    def fn(x: Expr) -> Expr:
        if isinstance(x, BinaryExpr) and isinstance(x.left, Literal) and isinstance(x.right, Literal):
            lv, rv = x.left.value, x.right.value
            # date ± interval
            if isinstance(lv, _dt.date) and isinstance(rv, tuple):
                return Literal(_date_add(lv, rv, -1 if x.op == "-" else 1))
            if isinstance(rv, _dt.date) and isinstance(lv, tuple) and x.op == "+":
                return Literal(_date_add(rv, lv, 1))
            import decimal as _dec

            if (isinstance(lv, (int, _dec.Decimal)) and isinstance(rv, (int, _dec.Decimal))
                    and (isinstance(lv, _dec.Decimal) or isinstance(rv, _dec.Decimal))
                    and not isinstance(lv, bool) and not isinstance(rv, bool)):
                # exact decimal folding for +,-,* at decimal256's 76-digit
                # cap (Python's default 28-digit context would silently
                # round wide folds the runtime computes exactly); division
                # folds nothing — the engine plans it as float64
                with _dec.localcontext() as ctx76:
                    ctx76.prec = 76
                    if x.op == "+":
                        return Literal(lv + rv)
                    if x.op == "-":
                        return Literal(lv - rv)
                    if x.op == "*":
                        return Literal(lv * rv)
                return x
            if isinstance(lv, (int, float)) and isinstance(rv, (int, float)) and not isinstance(lv, bool) and not isinstance(rv, bool):
                try:
                    if x.op == "+":
                        return Literal(lv + rv)
                    if x.op == "-":
                        return Literal(lv - rv)
                    if x.op == "*":
                        return Literal(lv * rv)
                    if x.op == "/":
                        return Literal(lv / rv)
                except ZeroDivisionError:
                    return x
        if isinstance(x, Negative) and isinstance(x.expr, Literal):
            import decimal as _dec

            if isinstance(x.expr.value, (int, float, _dec.Decimal)):
                return Literal(-x.expr.value)
        return x

    return transform_expr(e, fn)


def _date_add(d: _dt.date, interval: tuple, sign: int) -> _dt.date:
    n, unit = interval
    n *= sign
    if unit == "day":
        return d + _dt.timedelta(days=n)
    if unit in ("month", "year"):
        months = n * 12 if unit == "year" else n
        total = d.year * 12 + (d.month - 1) + months
        y, m = divmod(total, 12)
        day = min(d.day, _days_in_month(y, m + 1))
        return _dt.date(y, m + 1, day)
    raise PlanningError(f"bad interval unit {unit}")


def _days_in_month(y: int, m: int) -> int:
    if m == 12:
        return 31
    return (_dt.date(y, m + 1, 1) - _dt.timedelta(days=1)).day


# -- 2. OR factoring --------------------------------------------------------


def factor_or(e: Expr) -> Expr:
    def fn(x: Expr) -> Expr:
        if isinstance(x, BinaryExpr) and x.op == "or":
            branches = _split_disjunction(x)
            if len(branches) < 2:
                return x
            conj_sets = [split_conjunction(b) for b in branches]
            common = [c for c in conj_sets[0] if all(c in cs for cs in conj_sets[1:])]
            if not common:
                return x
            remainders = []
            for cs in conj_sets:
                rem = [c for c in cs if c not in common]
                remainders.append(and_(*rem) if rem else Literal(True))
            out = and_(*common)
            rem_or = remainders[0]
            for r in remainders[1:]:
                rem_or = BinaryExpr(rem_or, "or", r)
            if not all(isinstance(r, Literal) and r.value is True for r in remainders):
                out = BinaryExpr(out, "and", rem_or)
            return out
        return x

    return transform_expr(e, fn)


def _split_disjunction(e: Expr) -> list[Expr]:
    if isinstance(e, BinaryExpr) and e.op == "or":
        return _split_disjunction(e.left) + _split_disjunction(e.right)
    return [e]


# -- expression rewriting over a whole plan ---------------------------------


def rewrite_exprs(plan: LogicalPlan, fn) -> LogicalPlan:
    def node(p: LogicalPlan) -> LogicalPlan:
        if isinstance(p, Filter):
            return Filter(p.input, fn(p.predicate))
        if isinstance(p, Projection):
            return Projection(p.input, [fn(e) for e in p.exprs])
        if isinstance(p, Aggregate):
            return Aggregate(p.input, [fn(e) for e in p.group_exprs], [fn(e) for e in p.agg_exprs])
        if isinstance(p, Join) and p.filter is not None:
            return replace_join(p, filter=fn(p.filter))
        return p

    # also rewrite inside subquery plans
    def node_with_subqueries(p: LogicalPlan) -> LogicalPlan:
        p = node(p)
        return p

    return transform_plan_up(plan, node_with_subqueries)


def replace_join(j: Join, **kw) -> Join:
    out = Join(
        kw.get("left", j.left),
        kw.get("right", j.right),
        kw.get("on", j.on),
        kw.get("join_type", j.join_type),
        kw.get("filter", j.filter),
    )
    return out


# -- 3. decorrelation -------------------------------------------------------


class Decorrelator:
    def __init__(self):
        self.counter = 0

    def run(self, plan: LogicalPlan) -> LogicalPlan:
        def fn(p: LogicalPlan) -> LogicalPlan:
            if isinstance(p, Filter) and _has_subquery(p.predicate):
                return self.rewrite_filter(p)
            if isinstance(p, Projection) and any(_has_subquery(e) for e in p.exprs):
                return self.rewrite_projection(p)
            return p

        return transform_plan_up(plan, fn)

    def rewrite_projection(self, proj: Projection) -> LogicalPlan:
        """Scalar subqueries in the SELECT list (q9's CASE-of-aggregates
        shape): each lowers exactly like a WHERE-clause scalar — join/
        cross-join against the projection's input."""
        input_plan: LogicalPlan = proj.input
        new_exprs: list[Expr] = []
        for e in proj.exprs:
            if _has_subquery(e):
                orig_name = e.output_name()
                for sq in _collect_scalar_subqueries(e):
                    input_plan, repl = self._plan_scalar(
                        input_plan, self.run(sq.plan), join_type="left")
                    e = _replace_node(e, sq, repl)
                if _has_subquery(e):
                    raise PlanningError(
                        "only scalar subqueries are supported in the SELECT list")
                if e.output_name() != orig_name:  # don't leak __value
                    e = Alias(e, orig_name)
            new_exprs.append(e)
        return Projection(input_plan, new_exprs)

    def rewrite_filter(self, f: Filter) -> LogicalPlan:
        # Build the join tree from subquery-free conjuncts FIRST so the
        # subquery joins attach on top of a proper join tree instead of
        # burying the cross-join chain beneath them.
        conjs = split_conjunction(f.predicate)
        plain = [c for c in conjs if not _has_subquery(c)]
        with_sq = [c for c in conjs if _has_subquery(c)]
        input_plan: LogicalPlan = f.input
        if plain:
            input_plan = extract_joins(Filter(input_plan, and_(*plain)))
        remaining: list[Expr] = []
        for conj in with_sq:
            input_plan, kept = self.rewrite_conjunct(input_plan, conj)
            if kept is not None:
                remaining.append(kept)
        if remaining:
            return Filter(input_plan, and_(*remaining))
        return input_plan

    def rewrite_conjunct(self, outer: LogicalPlan, conj: Expr):
        # EXISTS / NOT EXISTS → semi / anti join, conjunct consumed
        if isinstance(conj, Exists) or (isinstance(conj, Not) and isinstance(conj.expr, Exists)):
            negated = isinstance(conj, Not) or (isinstance(conj, Exists) and conj.negated)
            ex = conj.expr if isinstance(conj, Not) else conj
            sub = self.run(ex.plan)
            keys, residual, sub = self._extract_correlation(sub, outer.schema, exists=True)
            if not keys and residual is None:
                raise PlanningError("uncorrelated EXISTS not supported")
            jt = "left_anti" if negated else "left_semi"
            return Join(outer, sub, keys, jt, residual), None
        # IN / NOT IN subquery → semi / anti join on first output column
        if isinstance(conj, InSubquery):
            sub = self.run(conj.plan)
            keys, residual, sub = self._extract_correlation(sub, outer.schema)
            f0 = sub.schema.field(0)
            keys = [(conj.expr, Column(f0.name, f0.qualifier))] + keys
            jt = "left_anti" if conj.negated else "left_semi"
            return Join(outer, sub, keys, jt, residual), None
        # scalar subqueries anywhere inside the conjunct
        if _has_subquery(conj):
            new_conj = conj
            subs = _collect_scalar_subqueries(conj)
            for sq in subs:
                outer, repl = self._plan_scalar(outer, self.run(sq.plan))
                new_conj = _replace_node(new_conj, sq, repl)
            # EXISTS nested under OR/NOT (not a top-level conjunct, so the
            # semi/anti-join lowering can't consume it) → MARK join: LEFT
            # JOIN a deduped projection of the correlation keys and replace
            # the EXISTS with a match-marker null test (the reference gets
            # this from DataFusion's mark-join decorrelation)
            for ex in _collect_exists(new_conj):
                outer, repl = self._plan_mark_exists(outer, ex)
                new_conj = _replace_node(new_conj, ex, repl)
            # IN (subquery) nested under OR/NOT: an UNCORRELATED subquery
            # evaluates EAGERLY at planning time and inlines as a literal
            # IN list (q45's `zip IN (...) OR item_id IN (subq)`); a
            # correlated one takes the mark-join path like EXISTS
            for isq in _collect_in_subqueries(new_conj):
                sub = self.run(isq.plan)
                # exists=True drops projections above the correlated filter so
                # correlation keys keep their qualified below-projection form;
                # the IN value is the projection's first expr, inlined
                keys, residual, sub2 = self._extract_correlation(
                    sub, outer.schema, exists=True)
                if not keys and residual is None:
                    values = _eval_uncorrelated_column(sub)
                    new_conj = _replace_node(
                        new_conj, isq, InList(isq.expr, tuple(values), isq.negated))
                else:
                    keys = [(isq.expr, _first_output_expr(sub))] + keys
                    outer, repl = self._plan_mark(outer, sub2, keys, residual,
                                                  negated=isq.negated)
                    new_conj = _replace_node(new_conj, isq, repl)
            return outer, new_conj
        return outer, conj

    def _plan_mark_exists(self, outer: LogicalPlan, ex: Exists):
        sub = self.run(ex.plan)
        keys, residual, sub2 = self._extract_correlation(sub, outer.schema, exists=True)
        if not keys and residual is None:
            raise PlanningError("uncorrelated EXISTS not supported")
        return self._plan_mark(outer, sub2, keys, residual, negated=ex.negated)

    def _plan_mark(self, outer: LogicalPlan, sub2: LogicalPlan, keys, residual,
                   negated: bool):
        """LEFT JOIN `outer` against the deduped correlation keys of `sub2`;
        the join's key columns double as the match marker. NULL-semantics
        caveat (same as the NOT IN inline path): a NULL probe key yields
        false where SQL says NULL — indistinguishable under WHERE unless
        wrapped in NOT."""
        if residual is not None:
            raise PlanningError(
                "correlated subquery under OR with non-equi correlation is unsupported")
        self.counter += 1
        alias = f"__mark{self.counter}"
        proj = Projection(sub2, [Alias(ik, f"__mk{i}") for i, (_, ik) in enumerate(keys)])
        build = SubqueryAlias(Distinct(proj), alias)
        join_on = [(ok, Column(f"__mk{i}", alias)) for i, (ok, _) in enumerate(keys)]
        new_outer = Join(outer, build, join_on, "left", None)
        mark = Column("__mk0", alias)
        return new_outer, (IsNull(mark) if negated else IsNotNull(mark))

    # ------------------------------------------------------------------

    def _extract_correlation(self, sub: LogicalPlan, outer_schema, exists: bool = False):
        """Pull conjuncts referencing outer columns out of the subplan's
        top-reachable Filter. Returns (equi_keys, residual_filter, new_sub).

        For EXISTS the select list is semantically void (only row existence
        matters), so Projection/Distinct nodes ABOVE the correlated Filter
        are DROPPED — `EXISTS (SELECT 1 FROM t WHERE t.k = outer.k)` must
        not narrow the build side to the literal and lose the correlation
        columns. Projections BELOW the filter stay: a derived table's
        renames/computed columns are what the extracted keys reference."""
        keys: list[tuple[Expr, Expr]] = []
        residual: list[Expr] = []

        def walk(p: LogicalPlan, above_filter: bool = True) -> LogicalPlan:
            if exists and above_filter and isinstance(p, (Projection, Distinct)):
                return walk(p.children()[0], above_filter)
            if isinstance(p, (Projection, SubqueryAlias, Distinct)):
                inner = walk(p.children()[0], above_filter)
                out = p.with_children([inner])
                return out
            if isinstance(p, Filter):
                inner_schema = p.input.schema
                keep: list[Expr] = []
                for c in split_conjunction(p.predicate):
                    if _references_outer(c, inner_schema):
                        pair = _corr_equi_pair(c, inner_schema, outer_schema)
                        if pair is not None:
                            keys.append(pair)
                        else:
                            residual.append(c)
                    else:
                        keep.append(c)
                new_input = walk(p.input, False)
                if keep:
                    return Filter(new_input, and_(*keep))
                return new_input
            return p

        new_sub = walk(sub)
        res = and_(*residual) if residual else None
        return keys, res, new_sub

    def _plan_scalar(self, outer: LogicalPlan, sub: LogicalPlan,
                     join_type: str = "inner"):
        """Turn a scalar subquery into a join; returns (new_outer, replacement).

        join_type: WHERE-context callers keep "inner" (a no-match row's NULL
        comparison filters it anyway); SELECT-list callers must pass "left"
        — the outer row survives with a NULL value."""
        self.counter += 1
        alias_name = f"__sq{self.counter}"
        # locate [Projection] -> Aggregate -> [Filter] -> input
        proj, agg, below = _find_agg_pattern(sub)
        if (agg is not None and join_type == "inner"
                and not agg.group_exprs and _is_count_only(agg)):
            # the inner-join premise (no-match NULL filters the row anyway)
            # is FALSE for COUNT: its no-match value is 0, so e.g.
            # `WHERE (SELECT count(*) ...) = 0` must keep the row
            join_type = "left"
        if agg is None:
            if not _plan_references_outer(sub, outer.schema):
                # uncorrelated non-aggregate subquery (e.g. SELECT col FROM
                # cte_that_aggregates): evaluate eagerly like the inline IN
                # path — this is also where SQL's one-row contract is
                # enforced (on ROWS, not distinct values) instead of
                # silently multiplying outer rows
                vals = _eval_uncorrelated_column(
                    sub, dedup=False, max_values=1, what="scalar subquery",
                    overflow_hint=" (SQL allows at most one row)")
                return outer, Literal(vals[0] if vals else None)
            raise PlanningError(f"scalar subquery must aggregate:\n{sub.display()}")
        corr_keys: list[tuple[Expr, Expr]] = []
        new_below = below
        if isinstance(below, Filter):
            inner_schema = below.input.schema
            keep = []
            for c in split_conjunction(below.predicate):
                if _references_outer(c, inner_schema):
                    pair = _corr_equi_pair(c, inner_schema, outer.schema)
                    if pair is None:
                        raise PlanningError(f"unsupported correlated predicate {c}")
                    corr_keys.append(pair)
                else:
                    keep.append(c)
            new_below = Filter(below.input, and_(*keep)) if keep else below.input

        value_expr: Expr = (
            proj.exprs[0] if proj is not None else Column(agg.schema.field(len(agg.group_exprs)).name)
        )
        if isinstance(value_expr, Alias):
            value_expr = value_expr.expr

        if not corr_keys:
            new_agg = Aggregate(new_below, list(agg.group_exprs), list(agg.agg_exprs))
            if agg.group_exprs:
                # grouped: may yield 0 or >1 rows — evaluate eagerly so an
                # empty result becomes NULL (a CrossJoin would wipe every
                # outer row) and >1 rows raises per SQL
                vals = _eval_uncorrelated_column(
                    Projection(new_agg, [Alias(value_expr, "__value")]),
                    dedup=False, max_values=1, what="scalar subquery",
                    overflow_hint=" (SQL allows at most one row)")
                return outer, Literal(vals[0] if vals else None)
            # ungrouped aggregate: exactly one row, cross join
            value = Projection(new_agg, [Alias(value_expr, "__value")])
            aliased = SubqueryAlias(value, alias_name)
            return CrossJoin(outer, aliased), Column("__value", alias_name)

        inner_cols = [ik for (_, ik) in corr_keys]
        if agg.group_exprs and any(g not in inner_cols for g in agg.group_exprs):
            # grouping by anything beyond the correlation keys can yield
            # several rows per outer row; the join lowering would silently
            # duplicate outer rows instead of raising SQL's one-row error
            raise PlanningError(
                "correlated scalar subquery with GROUP BY over "
                "non-correlation columns may return more than one row")
        group_exprs = list(agg.group_exprs) + [c for c in inner_cols if c not in agg.group_exprs]
        new_agg = Aggregate(new_below, group_exprs, list(agg.agg_exprs))
        # correlation keys get INTERNAL names: re-exposing e.g. `k` through
        # the __sqN alias makes any later unqualified `k` ambiguous
        proj_exprs: list[Expr] = [
            Alias(Column(c.output_name(), c.qualifier if isinstance(c, Column) else None),
                  f"__ck{i}")
            for i, c in enumerate(inner_cols)
        ]
        count_fallback = (
            join_type == "left" and not agg.group_exprs and _is_count_only(agg)
        )
        if count_fallback:
            # COUNT over no matching rows is 0, not NULL — but the 0 must
            # feed the subquery's post-aggregate computation (count(*)+1
            # over no rows is 1, not 0), so the subquery side exports the
            # RAW count columns and the value expression re-evaluates above
            # the join over coalesced counts. A user-grouped subquery
            # (agg.group_exprs non-empty) keeps NULL: its empty group set
            # yields no row at all per SQL.
            out_names = [
                new_agg.schema.field(len(group_exprs) + i).name
                for i in range(len(agg.agg_exprs))
            ]
            av_map = {nm: f"__av{i}" for i, nm in enumerate(out_names)}
            for nm, av in av_map.items():
                proj_exprs.append(Alias(Column(nm), av))

            def _coalesced(e: Expr) -> Expr:
                if isinstance(e, Column) and e.output_name() in av_map:
                    return ScalarFunction(
                        "coalesce",
                        (Column(av_map[e.output_name()], alias_name), Literal(0)),
                    )
                return e

            repl = transform_expr(value_expr, _coalesced)
        else:
            proj_exprs.append(Alias(value_expr, "__value"))
            repl = Column("__value", alias_name)
        value = Projection(new_agg, proj_exprs)
        aliased = SubqueryAlias(value, alias_name)
        join_on = [
            (ok, Column(f"__ck{i}", alias_name))
            for i, (ok, _) in enumerate(corr_keys)
        ]
        return Join(outer, aliased, join_on, join_type, None), repl


def _is_count_only(agg: Aggregate) -> bool:
    """True when every aggregate in the node is a count (the no-match value
    under a left join must then be 0, not NULL)."""
    from ballista_tpu_torch.plan.expressions import AggregateFunction

    def fn(e: Expr):
        e = e.expr if isinstance(e, Alias) else e
        return isinstance(e, AggregateFunction) and e.func in ("count", "count_distinct")

    return bool(agg.agg_exprs) and all(fn(a) for a in agg.agg_exprs)


def _find_agg_pattern(sub: LogicalPlan):
    proj = None
    p = sub
    while isinstance(p, (SubqueryAlias,)):
        p = p.children()[0]
    if isinstance(p, Projection):
        proj = p
        p = p.input
    if isinstance(p, Aggregate):
        return proj, p, p.input
    return proj, None, None


def _has_subquery(e: Expr) -> bool:
    return expr_any(e, lambda x: isinstance(x, (ScalarSubquery, InSubquery, Exists)))


def _collect_nodes(e: Expr, cls, out: list | None = None) -> list:
    if out is None:
        out = []
    if isinstance(e, cls):
        out.append(e)
    for c in e.children():
        _collect_nodes(c, cls, out)
    return out


def _collect_scalar_subqueries(e: Expr) -> list:
    return _collect_nodes(e, ScalarSubquery)


def _collect_in_subqueries(e: Expr) -> list:
    return _collect_nodes(e, InSubquery)


def _first_output_expr(sub: LogicalPlan) -> Expr:
    """First output column of `sub` as an expression over the schema that
    remains after _extract_correlation(exists=True) drops the top
    Projection/Distinct wrappers."""
    p = sub
    while isinstance(p, (SubqueryAlias, Distinct)):
        p = p.children()[0]
    if isinstance(p, Projection):
        e = p.exprs[0]
        return e.expr if isinstance(e, Alias) else e
    f0 = p.schema.field(0)
    return Column(f0.name, f0.qualifier)


def _collect_exists(e: Expr) -> list:
    return _collect_nodes(e, Exists)


_EAGER_IN_MAX_VALUES = 10_000


def _eval_uncorrelated_column(
    sub: LogicalPlan,
    dedup: bool = True,
    max_values: int = _EAGER_IN_MAX_VALUES,
    what: str = "IN subquery inside a disjunction",
    overflow_hint: str = "; rewrite as a join",
) -> list:
    """Execute an uncorrelated subplan locally and return its first column's
    values (deduped + null-stripped for IN lists; raw rows for scalar
    callers, whose one-row contract counts rows, not distinct values). A
    correlated subplan fails binding (its outer columns don't resolve) and
    surfaces as a clean planning error."""
    from ballista_tpu_torch.engine.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.plan.physical import TaskContext

    try:
        # run the full rewrite pipeline on the subplan: it was extracted from
        # an expression, so the plan-tree passes (join extraction, pushdown)
        # never saw it — planning it raw would execute comma-joins as
        # cartesian products
        phys = PhysicalPlanner().plan(optimize(sub))
        ctx = TaskContext()
        vals: list = []
        for p in range(phys.output_partition_count()):
            for b in phys.execute(p, ctx):
                vals.extend(b.column(0).to_pylist())
                if len(vals) > max_values:
                    raise PlanningError(
                        f"{what} yielded more than {max_values} "
                        f"value(s){overflow_hint}")
        if not dedup:
            return vals
        return sorted({v for v in vals if v is not None})
    except PlanningError:
        raise
    except Exception as e:  # noqa: BLE001
        raise PlanningError(f"cannot evaluate {what} (correlated?): {e}") from None


def _replace_node(e: Expr, target: Expr, repl: Expr) -> Expr:
    if e is target:
        return repl
    kids = e.children()
    if not kids:
        return e
    return e.with_children([_replace_node(k, target, repl) for k in kids])


def _references_outer(e: Expr, inner_schema) -> bool:
    cols = collect_columns(e)
    return any(inner_schema.maybe_index_of(c.name, c.qualifier) is None for c in cols)


def _plan_references_outer(plan: LogicalPlan, outer_schema) -> bool:
    """True if any Filter in `plan` references a column that does not
    resolve against its own input but DOES resolve against the outer query
    (a column resolving against neither is a plain unknown-column error and
    must not be classified as correlation)."""
    found = False

    def walk(p: LogicalPlan):
        nonlocal found
        if found:
            return
        if isinstance(p, Filter):
            for c in collect_columns(p.predicate):
                if (p.input.schema.maybe_index_of(c.name, c.qualifier) is None
                        and outer_schema.maybe_index_of(c.name, c.qualifier) is not None):
                    found = True
                    return
        for ch in p.children():
            walk(ch)

    walk(plan)
    return found


def _corr_equi_pair(c: Expr, inner_schema, outer_schema):
    """outer_expr = inner_expr pattern → (outer_expr, inner_expr)."""
    if isinstance(c, BinaryExpr) and c.op == "=":
        sides = [c.left, c.right]
        for i in (0, 1):
            a, b = sides[i], sides[1 - i]
            a_cols, b_cols = collect_columns(a), collect_columns(b)
            if not a_cols or not b_cols:
                continue
            a_outer = all(inner_schema.maybe_index_of(x.name, x.qualifier) is None for x in a_cols)
            b_inner = all(inner_schema.maybe_index_of(x.name, x.qualifier) is not None for x in b_cols)
            if a_outer and b_inner:
                return (a, b)
    return None


# -- 4. cross-join elimination ----------------------------------------------


def extract_joins(plan: LogicalPlan) -> LogicalPlan:
    if not isinstance(plan, Filter):
        return plan
    rels = _flatten_cross(plan.input)
    if len(rels) < 2:
        return plan
    conjs = split_conjunction(plan.predicate)

    local: list[Expr] = []  # single-relation or non-equi predicates
    edges: list[tuple[int, int, Expr, Expr]] = []  # (rel_a, rel_b, expr_a, expr_b)
    for c in conjs:
        edge = _classify_edge(c, rels)
        if edge is None:
            local.append(c)
        else:
            edges.append(edge)

    joined = {0}
    acc = rels[0]
    remaining = list(range(1, len(rels)))
    while remaining:
        pick = None
        for idx in remaining:
            if any((a in joined and b == idx) or (b in joined and a == idx) for a, b, _, _ in edges):
                pick = idx
                break
        if pick is None:
            pick = remaining[0]
            acc = CrossJoin(acc, rels[pick])
        else:
            keys = []
            for a, b, ea, eb in edges:
                if a in joined and b == pick:
                    keys.append((ea, eb))
                elif b in joined and a == pick:
                    keys.append((eb, ea))
            acc = Join(acc, rels[pick], keys, "inner", None)
        joined.add(pick)
        remaining.remove(pick)

    if local:
        return Filter(acc, and_(*local))
    return acc


def _flatten_cross(p: LogicalPlan) -> list[LogicalPlan]:
    if isinstance(p, CrossJoin):
        return _flatten_cross(p.left) + _flatten_cross(p.right)
    return [p]


def _rel_of(e: Expr, rels: list[LogicalPlan]) -> int | None:
    """Index of the single relation resolving ALL columns of e, else None."""
    cols = collect_columns(e)
    if not cols:
        return None
    owner = None
    for c in cols:
        found = None
        for i, r in enumerate(rels):
            if r.schema.maybe_index_of(c.name, c.qualifier) is not None:
                found = i
                break
        if found is None:
            return None
        if owner is None:
            owner = found
        elif owner != found:
            return -1  # spans multiple relations
    return owner


def _classify_edge(c: Expr, rels: list[LogicalPlan]):
    if isinstance(c, BinaryExpr) and c.op == "=":
        ra = _rel_of(c.left, rels)
        rb = _rel_of(c.right, rels)
        if ra is not None and rb is not None and ra >= 0 and rb >= 0 and ra != rb:
            return (ra, rb, c.left, c.right)
    return None


# -- 5. filter pushdown ------------------------------------------------------


def push_filters(plan: LogicalPlan) -> LogicalPlan:
    def fn(p: LogicalPlan) -> LogicalPlan:
        if not isinstance(p, Filter):
            return p
        return _push_filter_once(p)

    # run to fixpoint (filters migrate down one node per pass)
    prev = None
    while prev is not plan:
        prev = plan
        plan = transform_plan_up(plan, fn)
        if plan.display() == prev.display():
            break
    return plan


def _push_filter_once(f: Filter) -> LogicalPlan:
    child = f.input
    conjs = split_conjunction(f.predicate)

    if isinstance(child, Filter):
        return Filter(child.input, and_(*(conjs + split_conjunction(child.predicate))))

    if isinstance(child, (Join, CrossJoin)):
        left, right = child.children()
        jt = child.join_type if isinstance(child, Join) else "inner"
        push_left, push_right, keep = [], [], []
        allow_left = jt in ("inner", "left", "left_semi", "left_anti", "cross")
        allow_right = jt in ("inner", "right", "right_semi", "right_anti", "cross")
        if isinstance(child, CrossJoin):
            allow_left = allow_right = True
        for c in conjs:
            if _resolves_all(c, left.schema) and allow_left:
                push_left.append(c)
            elif _resolves_all(c, right.schema) and allow_right:
                push_right.append(c)
            else:
                keep.append(c)
        if not push_left and not push_right:
            return f
        nl = Filter(left, and_(*push_left)) if push_left else left
        nr = Filter(right, and_(*push_right)) if push_right else right
        new_child = child.with_children([nl, nr])
        return Filter(new_child, and_(*keep)) if keep else new_child

    if isinstance(child, Projection):
        # substitute projection defs into the predicate and push below
        mapping: dict[tuple[str, str | None], Expr] = {}
        for e in child.exprs:
            inner = e.expr if isinstance(e, Alias) else e
            key = (e.output_name(), inner.qualifier if isinstance(inner, Column) else None)
            mapping[(e.output_name(), None)] = inner
            mapping[key] = inner
        ok = True
        new_conjs = []
        for c in conjs:
            try:
                new_conjs.append(_substitute_cols(c, mapping))
            except KeyError:
                ok = False
                break
        if ok:
            return Projection(Filter(child.input, and_(*new_conjs)), child.exprs)
        return f

    if isinstance(child, SubqueryAlias):
        inner_schema = child.input.schema
        mapping = {}
        for i, fld in enumerate(child.schema.fields):
            inner_f = inner_schema.field(i)
            mapping[(fld.name, child.alias)] = Column(inner_f.name, inner_f.qualifier)
            mapping[(fld.name, None)] = Column(inner_f.name, inner_f.qualifier)
        try:
            new_conjs = [_substitute_cols(c, mapping) for c in conjs]
        except KeyError:
            return f
        return SubqueryAlias(Filter(child.input, and_(*new_conjs)), child.alias)

    if isinstance(child, Aggregate):
        group_ok, keep = [], []
        group_names = {g.output_name() for g in child.group_exprs}
        for c in conjs:
            cols = collect_columns(c)
            if cols and all(col.name in group_names for col in cols):
                mapping = {}
                for g in child.group_exprs:
                    mapping[(g.output_name(), None)] = g
                    if isinstance(g, Column):
                        mapping[(g.output_name(), g.qualifier)] = g
                try:
                    group_ok.append(_substitute_cols(c, mapping))
                    continue
                except KeyError:
                    pass
            keep.append(c)
        if group_ok:
            new_agg = Aggregate(Filter(child.input, and_(*group_ok)), child.group_exprs, child.agg_exprs)
            return Filter(new_agg, and_(*keep)) if keep else new_agg
        return f

    if isinstance(child, TableScan):
        pushable, keep = [], []
        for c in conjs:
            if _scan_pushable(c):
                pushable.append(c)
            else:
                keep.append(c)
        if pushable:
            new_scan = TableScan(
                child.table_name, child.provider, child.projection,
                child.filters + pushable, child.alias,
            )
            return Filter(new_scan, and_(*keep)) if keep else new_scan
        return f

    return f


def _resolves_all(e: Expr, schema) -> bool:
    cols = collect_columns(e)
    return bool(cols) and all(schema.maybe_index_of(c.name, c.qualifier) is not None for c in cols)


def _substitute_cols(e: Expr, mapping: dict) -> Expr:
    if isinstance(e, Column):
        key = (e.name, e.qualifier)
        if key in mapping:
            return mapping[key]
        if (e.name, None) in mapping:
            return mapping[(e.name, None)]
        raise KeyError(key)
    kids = e.children()
    if not kids:
        return e
    return e.with_children([_substitute_cols(k, mapping) for k in kids])


def _scan_pushable(c: Expr) -> bool:
    """Exactly-evaluable at scan time (column vs literal comparisons)."""
    if isinstance(c, BinaryExpr) and c.op in ("=", "<>", "<", "<=", ">", ">="):
        return (isinstance(c.left, Column) and isinstance(c.right, Literal)) or (
            isinstance(c.right, Column) and isinstance(c.left, Literal)
        )
    if isinstance(c, InList):
        return isinstance(c.expr, Column)
    if isinstance(c, Between):
        return (
            isinstance(c.expr, Column)
            and isinstance(c.low, Literal)
            and isinstance(c.high, Literal)
        )
    return False


# -- 6. column pruning -------------------------------------------------------


def prune_columns(plan: LogicalPlan) -> LogicalPlan:
    required = [Column(f.name, f.qualifier) for f in plan.schema]
    return _prune(plan, required)


def _expr_cols(exprs) -> list[Column]:
    out: list[Column] = []
    seen = set()
    for e in exprs:
        for c in collect_columns(e):
            k = (c.name, c.qualifier)
            if k not in seen:
                seen.add(k)
                out.append(c)
    return out


def _side_split(cols, left_schema, right_schema):
    l, r = [], []
    for c in cols:
        if left_schema.maybe_index_of(c.name, c.qualifier) is not None:
            l.append(c)
        elif right_schema.maybe_index_of(c.name, c.qualifier) is not None:
            r.append(c)
    return l, r


def _prune(plan: LogicalPlan, required: list[Column]) -> LogicalPlan:
    if isinstance(plan, Projection):
        needed = _expr_cols(plan.exprs)
        return Projection(_prune(plan.input, needed), plan.exprs)
    if isinstance(plan, Filter):
        needed = _dedup(required + _expr_cols([plan.predicate]))
        return Filter(_prune(plan.input, needed), plan.predicate)
    if isinstance(plan, Aggregate):
        needed = _expr_cols(plan.group_exprs + plan.agg_exprs)
        return Aggregate(_prune(plan.input, needed), plan.group_exprs, plan.agg_exprs)
    if isinstance(plan, Sort):
        needed = _dedup(required + _expr_cols([k.expr for k in plan.keys]))
        return Sort(_prune(plan.input, needed), plan.keys, plan.fetch)
    if isinstance(plan, Window):
        win_cols = _expr_cols([
            e for w in plan.window_exprs
            for e in (list(w.args) + list(w.partition_by) + [k.expr for k in w.order_by])
        ])
        # __win{i} outputs are produced here, not read from the child
        passthrough = [c for c in required if not c.name.startswith("__win")]
        needed = _dedup(passthrough + win_cols)
        return Window(_prune(plan.input, needed), plan.window_exprs)
    if isinstance(plan, (Limit, Distinct)):
        if isinstance(plan, Distinct):
            required = [Column(f.name, f.qualifier) for f in plan.schema]
        return plan.with_children([_prune(plan.children()[0], required)])
    if isinstance(plan, SubqueryAlias):
        inner_schema = plan.input.schema
        inner_req = []
        for c in required:
            i = plan.schema.maybe_index_of(c.name, c.qualifier)
            if i is None:
                i = plan.schema.maybe_index_of(c.name, None)
            if i is not None:
                f = inner_schema.field(i)
                inner_req.append(Column(f.name, f.qualifier))
        # keep full schema shape: SubqueryAlias renames positionally
        if len(inner_req) < len(inner_schema):
            inner_req = [Column(f.name, f.qualifier) for f in inner_schema]
        return SubqueryAlias(_prune(plan.input, inner_req), plan.alias)
    if isinstance(plan, Join):
        key_cols = _expr_cols([e for pair in plan.on for e in pair])
        filt_cols = _expr_cols([plan.filter]) if plan.filter is not None else []
        all_cols = _dedup(required + key_cols + filt_cols)
        lcols, rcols = _side_split(all_cols, plan.left.schema, plan.right.schema)
        return Join(
            _prune(plan.left, lcols), _prune(plan.right, rcols), plan.on, plan.join_type, plan.filter
        )
    if isinstance(plan, CrossJoin):
        lcols, rcols = _side_split(_dedup(required), plan.left.schema, plan.right.schema)
        return CrossJoin(_prune(plan.left, lcols), _prune(plan.right, rcols))
    if isinstance(plan, Union):
        return Union([_prune(c, required) for c in plan.inputs], plan.all)
    if isinstance(plan, TableScan):
        filter_cols = _expr_cols(plan.filters)
        idxs = []
        full = plan.provider.df_schema().with_qualifier(plan.alias or plan.table_name)
        for c in _dedup(required + filter_cols):
            i = full.maybe_index_of(c.name, c.qualifier)
            if i is None:
                i = full.maybe_index_of(c.name, None)
            if i is not None and i not in idxs:
                idxs.append(i)
        idxs.sort()
        if not idxs:
            idxs = [0]  # count(*)-style scans still need one column
        return TableScan(plan.table_name, plan.provider, idxs, plan.filters, plan.alias)
    return plan.with_children([_prune(c, [Column(f.name, f.qualifier) for f in c.schema]) for c in plan.children()])


def _dedup(cols: list[Column]) -> list[Column]:
    out, seen = [], set()
    for c in cols:
        k = (c.name, c.qualifier)
        if k not in seen:
            seen.add(k)
            out.append(c)
    return out
