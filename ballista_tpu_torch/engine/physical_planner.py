"""Physical planner: LogicalPlan → ExecutionPlan.

Performs what the reference delegates to DataFusion's physical planner plus
the scheduler-side JoinSelection rule
(scheduler/src/physical_optimizer/join_selection.rs): build-side choice by
estimated size, broadcast (CollectLeft) vs partitioned joins by threshold,
two-phase aggregation with hash exchanges, avg/count-distinct
decomposition, and sort/limit lowering.

RepartitionExec nodes inserted here are the stage boundaries the
distributed planner later splits at (scheduler/src/planner.rs:108).
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ballista_tpu_torch.config import (
    AQE_DYNAMIC_JOIN_SELECTION,
    AQE_JOIN_HEDGE_FACTOR,
    BROADCAST_JOIN_ROWS_THRESHOLD,
    BROADCAST_JOIN_THRESHOLD,
    BROADCAST_SEMI_KEYS_THRESHOLD,
    DEFAULT_SHUFFLE_PARTITIONS,
    EXECUTOR_ENGINE,
    PLANNER_ADAPTIVE_ENABLED,
    TARGET_PARTITIONS,
    BallistaConfig,
)
from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.expressions import (
    AggregateFunction,
    Alias,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Expr,
    Literal,
    ScalarFunction,
    VARIANCE_FUNCS,
    to_field,
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
    Values,
    Window,
)
from ballista_tpu_torch.plan.physical import (
    AggDesc,
    CoalescePartitionsExec,
    CrossJoinExec,
    EmptyExec,
    ExecutionPlan,
    FilterExec,
    GlobalLimitExec,
    HashAggregateExec,
    HashJoinExec,
    LocalLimitExec,
    MemoryScanExec,
    ParquetScanExec,
    ProjectionExec,
    RepartitionExec,
    SortExec,
    SortPreservingMergeExec,
    UnionExec,
)
from ballista_tpu_torch.plan.provider import AppendedTable, MemoryTable, ParquetTable
from ballista_tpu_torch.plan.schema import DFField, DFSchema


class PhysicalPlanner:
    def __init__(self, config: BallistaConfig | None = None):
        self.config = config or BallistaConfig()
        self.shuffle_partitions = int(self.config.get(DEFAULT_SHUFFLE_PARTITIONS))
        self.target_partitions = int(self.config.get(TARGET_PARTITIONS))
        self.broadcast_rows = int(self.config.get(BROADCAST_JOIN_ROWS_THRESHOLD))
        self.device_engine = str(self.config.get(EXECUTOR_ENGINE)) == "tpu"
        if self.device_engine:
            # device joins probe an HBM-resident sorted build: the collect
            # budget scales to HBM, not to the CPU broadcast wire budget —
            # and only collect-build chains compile into device stages.
            # If the device stage is later DECLINED, the oversized
            # collect_left runs on the host; HashJoinExec._build_table
            # warns when the built table exceeds the CPU rows threshold
            from ballista_tpu_torch.config import (
                TPU_BROADCAST_JOIN_ROWS,
                TPU_HBM_BUDGET_BYTES,
                TPU_HBM_GRACE_DEPTH,
            )

            self.broadcast_rows = max(
                self.broadcast_rows, int(self.config.get(TPU_BROADCAST_JOIN_ROWS)))
            # out-of-core seam: a tight EXPLICIT HBM budget with grace
            # splitting disabled leaves no fallback between "build fits"
            # and CPU demotion, so don't let the TPU threshold raise collect
            # sizes the device can never admit. ~16 B/row is the widest
            # single-column build footprint (i64 key + i64 payload); with
            # grace enabled the admission ladder handles oversize builds.
            budget = int(self.config.get(TPU_HBM_BUDGET_BYTES))
            if budget > 0 and int(self.config.get(TPU_HBM_GRACE_DEPTH)) <= 0:
                self.broadcast_rows = min(
                    self.broadcast_rows, max(budget // 16, 1))

    def plan(self, logical: LogicalPlan) -> ExecutionPlan:
        return self._plan(logical)

    # ------------------------------------------------------------------

    def _plan(self, node: LogicalPlan) -> ExecutionPlan:
        if isinstance(node, TableScan):
            return self._plan_scan(node)
        if isinstance(node, Projection):
            child = self._plan(node.input)
            return ProjectionExec(child, node.exprs, _rebind_schema(node.schema))
        if isinstance(node, Filter):
            return FilterExec(self._plan(node.input), node.predicate)
        if isinstance(node, Aggregate):
            return self._plan_aggregate(node)
        if isinstance(node, Join):
            return self._plan_join(node)
        if isinstance(node, CrossJoin):
            left = self._plan(node.left)
            right = self._plan(node.right)
            if estimate_rows(node.left) > estimate_rows(node.right):
                # build (collected) side should be the small one
                right_first = CrossJoinExec(right, left, node.right.schema.merge(node.left.schema))
                order = [
                    Column(f.name, f.qualifier) for f in node.schema
                ]
                return ProjectionExec(right_first, order, node.schema)
            return CrossJoinExec(left, right, node.schema)
        if isinstance(node, Window):
            return self._plan_window(node)
        if isinstance(node, Sort):
            child = self._plan(node.input)
            # large full sorts scale out via the dynamic range-repartition
            # pipeline: stats tap → dam → quantile-cut router → per-range
            # sorts whose in-order concatenation IS the total order
            big = estimate_rows(node.input) > 2_000_000
            if node.fetch is None and big and child.output_partition_count() > 1 and node.keys:
                from ballista_tpu_torch.ops.cpu.range_repartition import (
                    BufferExec,
                    RuntimeStatsExec,
                    UnorderedRangeRepartitionExec,
                )

                tapped = RuntimeStatsExec(child, node.keys[0].expr)
                dammed = BufferExec(tapped)
                ranged = UnorderedRangeRepartitionExec(
                    dammed, node.keys[0], child.output_partition_count()
                )
                return CoalescePartitionsExec(SortExec(ranged, node.keys, None))
            s = SortExec(child, node.keys, node.fetch)
            if child.output_partition_count() > 1:
                return SortPreservingMergeExec(s, node.keys, node.fetch)
            return s
        if isinstance(node, Limit):
            child = self._plan(node.input)
            fetch, skip = node.fetch, node.skip
            if child.output_partition_count() > 1:
                if fetch is not None:
                    child = LocalLimitExec(child, fetch + skip)
                child = CoalescePartitionsExec(child)
            return GlobalLimitExec(child, fetch, skip)
        if isinstance(node, Distinct):
            agg = Aggregate(node.input, [Column(f.name, f.qualifier) for f in node.schema], [])
            return self._plan_aggregate(agg)
        if isinstance(node, SubqueryAlias):
            child = self._plan(node.input)
            # carry the alias-qualified schema so parent expressions binding
            # against `alias.column` resolve (planner-created nodes are not
            # shared, so re-stamping the output schema in place is safe)
            child.df_schema = node.schema
            return child
        if isinstance(node, Union):
            return UnionExec([self._plan(c) for c in node.inputs], node.schema)
        if isinstance(node, Values):
            cols = list(zip(*node.rows)) if node.rows else []
            arrays = [pa.array(list(c)) for c in cols]
            batch = pa.RecordBatch.from_arrays(arrays, schema=node.schema.to_arrow())
            return MemoryScanExec(node.schema, [batch])
        if isinstance(node, EmptyRelation):
            return EmptyExec(node.schema, node.produce_one_row)
        raise PlanningError(f"cannot lower {type(node).__name__}")

    # ------------------------------------------------------------------

    def _plan_scan(self, node: TableScan) -> ExecutionPlan:
        provider = node.provider
        if isinstance(provider, AppendedTable):
            return self._plan_appended_scan(node, provider)
        if isinstance(provider, MemoryTable):
            child = MemoryScanExec(node.schema, provider.batches, provider.partitions)
            if node.filters:
                from ballista_tpu_torch.plan.expressions import and_

                return FilterExec(child, and_(*node.filters))
            return child
        partitions = provider.scan_partitions(self.target_partitions)
        proj_names = [f.name for f in node.schema]
        # scan output schema must include filter-only columns for evaluation
        filter_cols: list[str] = []
        from ballista_tpu_torch.plan.expressions import collect_columns

        for f in node.filters:
            for c in collect_columns(f):
                if c.name not in proj_names and c.name not in filter_cols:
                    filter_cols.append(c.name)
        if filter_cols:
            full = provider.df_schema().with_qualifier(node.alias or node.table_name)
            read_fields = list(node.schema.fields) + [
                full.field(full.index_of(n)) for n in filter_cols
            ]
            read_schema = DFSchema(read_fields)
            scan = ParquetScanExec(
                read_schema, partitions, [f.name for f in read_fields], node.filters, node.table_name
            )
            keep = [Column(f.name, f.qualifier) for f in node.schema]
            return ProjectionExec(scan, keep, node.schema)
        return ParquetScanExec(node.schema, partitions, proj_names, node.filters, node.table_name)

    def _plan_appended_scan(self, node: TableScan, provider: AppendedTable) -> ExecutionPlan:
        """Base scan ∪ memory scan of the append overlay (local-mode
        ingestion). The delta leg re-applies the scan's predicates — the
        base leg gets them via pushdown — and mirrors the parquet branch's
        filter-only-column handling."""
        import copy

        base_node = copy.copy(node)
        base_node.provider = provider.base
        base_plan = self._plan_scan(base_node)
        if not provider.batches:
            return base_plan
        from ballista_tpu_torch.plan.expressions import and_, collect_columns

        proj_names = [f.name for f in node.schema]
        filter_cols: list[str] = []
        for f in node.filters:
            for c in collect_columns(f):
                if c.name not in proj_names and c.name not in filter_cols:
                    filter_cols.append(c.name)
        if filter_cols:
            full = provider.df_schema().with_qualifier(node.alias or node.table_name)
            read_fields = list(node.schema.fields) + [
                full.field(full.index_of(n)) for n in filter_cols
            ]
            delta: ExecutionPlan = MemoryScanExec(DFSchema(read_fields), provider.batches, 1)
            delta = FilterExec(delta, and_(*node.filters))
            keep = [Column(f.name, f.qualifier) for f in node.schema]
            delta = ProjectionExec(delta, keep, node.schema)
        else:
            delta = MemoryScanExec(node.schema, provider.batches, 1)
            if node.filters:
                delta = FilterExec(delta, and_(*node.filters))
        return UnionExec([base_plan, delta], node.schema)

    # ------------------------------------------------------------------

    def _plan_window(self, node: Window) -> ExecutionPlan:
        """Window partition-key groups must be partition-local: windows
        sharing PARTITION BY keys stack over one exchange; differing key
        sets chain (each WindowExec appends its __win columns).

        The reference gets this layout from DataFusion's
        BoundedWindowAggExec + its repartition rules; here the hash
        exchange doubles as the distributed stage boundary."""
        from ballista_tpu_torch.plan.physical import WindowExec

        child = self._plan(node.input)
        groups: dict[tuple, list] = {}
        order: list[tuple] = []
        for w in node.window_exprs:
            key = tuple(str(e) for e in w.partition_by)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(w)

        from ballista_tpu_torch.plan.schema import DFField, DFSchema

        cur = child
        cur_fields = list(node.input.schema.fields)
        for key in order:
            ws = groups[key]
            pby = list(ws[0].partition_by)
            if pby and cur.output_partition_count() > 1:
                cur = RepartitionExec(cur, "hash", self.shuffle_partitions, pby)
            elif not pby and cur.output_partition_count() > 1:
                cur = CoalescePartitionsExec(cur)
            for w in ws:
                i = node.window_exprs.index(w)
                cur_fields.append(DFField(f"__win{i}", w.data_type(node.input.schema)))
            cur = WindowExec(cur, ws, DFSchema(list(cur_fields)))
        return cur

    def _plan_aggregate(self, node: Aggregate) -> ExecutionPlan:
        child = self._plan(node.input)
        in_schema = node.input.schema
        group_exprs = node.group_exprs
        n_group = len(group_exprs)

        # count(distinct x) → dedup-then-count (two stacked aggregates)
        if any(isinstance(a, AggregateFunction) and a.func == "count_distinct" for a in node.agg_exprs):
            if not all(
                isinstance(a, AggregateFunction) and a.func == "count_distinct"
                for a in node.agg_exprs
            ):
                return self._plan_mixed_distinct(node)
            args = [a.arg for a in node.agg_exprs]
            inner = Aggregate(node.input, list(group_exprs) + args, [])
            inner_planned = self._plan_aggregate(inner)
            # outer: group by original keys, count the deduped arg
            outer_group = [Column(g.output_name()) for g in group_exprs]
            outer_aggs: list[AggDesc] = []
            result_exprs: list[Expr] = list(outer_group)
            for a, arg in zip(node.agg_exprs, args):
                outer_aggs.append(AggDesc("count", Column(arg.output_name()), a.output_name()))
                result_exprs.append(Column(a.output_name()))
            inner_logical_schema = inner.schema
            return self._two_phase(
                inner_planned,
                inner_logical_schema,
                outer_group,
                outer_aggs,
                node,
                result_exprs_override=None,
            )

        # decompose logical aggs into accumulator descriptors
        partial_aggs: list[AggDesc] = []
        result_exprs: list[Expr] = [
            Column(g.output_name(), g.qualifier if isinstance(g, Column) else None)
            for g in group_exprs
        ]
        acc_fields: list[DFField] = []
        welford_triples: dict[str, tuple[str, str, str]] = {}
        i = 0
        for a in node.agg_exprs:
            out_name = a.output_name()
            if isinstance(a, Alias):  # composed rewrites name their aggs
                a = a.expr
            assert isinstance(a, AggregateFunction), a
            if a.func == "avg":
                sname, cname = f"__acc{i}_sum", f"__acc{i}_cnt"
                partial_aggs.append(AggDesc("sum", a.arg, sname))
                partial_aggs.append(AggDesc("count", a.arg, cname))
                sum_t = _sum_type(a.arg.data_type(in_schema))
                acc_fields.append(DFField(sname, sum_t, True))
                acc_fields.append(DFField(cname, pa.int64(), False))
                result_exprs.append(
                    Alias(BinaryExpr(Column(sname), "/", Column(cname)), out_name)
                )
            elif a.func == "sum":
                nm = f"__acc{i}"
                partial_aggs.append(AggDesc("sum", a.arg, nm))
                acc_fields.append(DFField(nm, _sum_type(a.arg.data_type(in_schema)), True))
                result_exprs.append(Alias(Column(nm), out_name))
            elif a.func in ("min", "max"):
                nm = f"__acc{i}"
                partial_aggs.append(AggDesc(a.func, a.arg, nm))
                acc_fields.append(DFField(nm, a.arg.data_type(in_schema), True))
                result_exprs.append(Alias(Column(nm), out_name))
            elif a.func == "count":
                nm = f"__acc{i}"
                if a.arg is None:
                    partial_aggs.append(AggDesc("count_all", None, nm))
                else:
                    partial_aggs.append(AggDesc("count", a.arg, nm))
                acc_fields.append(DFField(nm, pa.int64(), False))
                result_exprs.append(Alias(Column(nm), out_name))
            elif a.func in VARIANCE_FUNCS:
                # Welford-style decomposition: per-partition (count, mean, M2)
                # partials — the same accumulator DataFusion's variance kernels
                # use — merged at the final phase with the mean-centered
                # formula M2 = ΣM2_i + Σn_i·(mean_i − mean)². A naive
                # sum-of-squares decomposition (q − s²/n) catastrophically
                # cancels for large-magnitude data (e.g. epoch-microsecond
                # columns); the centered form never builds huge intermediates.
                # The triple MUST stay adjacent in (cnt, mean, m2) order:
                # HashAggregateExec's final mode merges them as a unit.
                if a.distinct:
                    raise PlanningError(f"{a.func}(DISTINCT) is unsupported")
                # var_samp(v), var_pop(v), stddev(v) over the same argument
                # share ONE (cnt, mean, m2) accumulator triple — the final
                # expressions differ only in denominator/sqrt
                cached = welford_triples.get(str(a.arg))
                if cached is not None:
                    cname, mname, qname = cached
                else:
                    cname, mname, qname = f"__acc{i}_cnt", f"__acc{i}_mean", f"__acc{i}_m2"
                    x = Cast(a.arg, pa.float64())
                    partial_aggs.append(AggDesc("count", a.arg, cname))
                    partial_aggs.append(AggDesc("welford_mean", x, mname))
                    partial_aggs.append(AggDesc("welford_m2", x, qname))
                    acc_fields.append(DFField(cname, pa.int64(), False))
                    acc_fields.append(DFField(mname, pa.float64(), True))
                    acc_fields.append(DFField(qname, pa.float64(), True))
                    welford_triples[str(a.arg)] = (cname, mname, qname)
                n_f = Cast(Column(cname), pa.float64())
                denom = (
                    n_f if a.func in ("var_pop", "stddev_pop")
                    else BinaryExpr(n_f, "-", Literal(1.0))
                )
                var = BinaryExpr(Column(qname), "/", denom)
                if a.func in ("stddev_samp", "stddev_pop"):
                    var = ScalarFunction("sqrt", (var,))
                # SQL: sample forms need n>=2, population forms n>=1 (count=0
                # gives NULL sums already, but 0/0 must not leak a NaN)
                min_n = 1 if a.func in ("var_pop", "stddev_pop") else 2
                guarded = Case(
                    ((BinaryExpr(Column(cname), ">=", Literal(min_n)), var),),
                    None,
                )
                result_exprs.append(Alias(guarded, out_name))
            else:
                raise PlanningError(f"unsupported aggregate {a.func}")
            i += 1

        group_fields = [to_field(g, in_schema) for g in group_exprs]
        acc_schema = DFSchema(group_fields + acc_fields)

        partial = HashAggregateExec(child, list(group_exprs), partial_aggs, "partial", acc_schema)

        if n_group == 0:
            merged = CoalescePartitionsExec(partial)
        else:
            n = self.shuffle_partitions
            keys = [Column(f.name, f.qualifier) for f in group_fields]
            merged = RepartitionExec(partial, "hash", n, keys)

        final_group = [Column(f.name, f.qualifier) for f in group_fields]
        final_aggs = [
            AggDesc(_merge_func(d.func), Column(d.name), d.name) for d in partial_aggs
        ]
        final = HashAggregateExec(merged, final_group, final_aggs, "final", acc_schema)
        return ProjectionExec(final, result_exprs, _rebind_schema(node.schema))

    def _plan_mixed_distinct(self, node: Aggregate) -> ExecutionPlan:
        """count(DISTINCT x) mixed with mergeable aggregates — the standard
        single-distinct expansion (Spark/DataFusion do the same rewrite):

            inner:  GROUP BY keys, x  →  partials of the other aggregates
            outer:  GROUP BY keys     →  count(x) + merge of the partials

        Lowered as composed LOGICAL aggregates so the normal planner
        machinery (avg decomposition, two-phase exchange) applies at each
        level. Reference shape: q16/q94's `count(distinct order_number),
        sum(ship_cost), sum(net_profit)`."""
        distinct_aggs = [a for a in node.agg_exprs if a.func == "count_distinct"]
        dargs = {str(a.arg) for a in distinct_aggs}
        if len(dargs) > 1:
            raise PlanningError(
                "multiple DISTINCT columns mixed with other aggregates are unsupported")
        mergeable = {"sum", "count", "min", "max", "avg"}
        bad = [a.func for a in node.agg_exprs
               if a.func != "count_distinct" and a.func not in mergeable]
        if bad:
            raise PlanningError(f"count(DISTINCT) mixed with {bad[0]} is unsupported")
        darg = distinct_aggs[0].arg
        if any(str(darg) == str(g) for g in node.group_exprs):
            raise PlanningError("count(DISTINCT <group key>) is unsupported")

        inner_aggs: list[Expr] = []
        outer_aggs: list[Expr] = []
        # final projection refs are UNQUALIFIED (the outer aggregate's output
        # fields carry no qualifier); the original qualified schema is
        # re-imposed on the ProjectionExec below
        final_exprs: list[Expr] = [Column(g.output_name()) for g in node.group_exprs]
        for i, a in enumerate(node.agg_exprs):
            out_name = a.output_name()
            if a.func == "count_distinct":
                outer_aggs.append(Alias(
                    AggregateFunction("count", Column(darg.output_name())), out_name))
                final_exprs.append(Column(out_name))
            elif a.func in ("min", "max", "sum", "count"):
                nm = f"__d{i}"
                inner_aggs.append(Alias(AggregateFunction(a.func, a.arg), nm))
                outer_fn = "sum" if a.func == "count" else a.func
                outer_aggs.append(Alias(AggregateFunction(outer_fn, Column(nm)), out_name))
                final_exprs.append(Column(out_name))
            else:  # avg: sum-of-sums / sum-of-counts at the final projection
                sn, cn = f"__d{i}_s", f"__d{i}_c"
                inner_aggs.append(Alias(AggregateFunction("sum", a.arg), sn))
                inner_aggs.append(Alias(AggregateFunction("count", a.arg), cn))
                outer_aggs.append(Alias(AggregateFunction("sum", Column(sn)), sn))
                outer_aggs.append(Alias(AggregateFunction("sum", Column(cn)), cn))
                final_exprs.append(Alias(
                    BinaryExpr(Cast(Column(sn), pa.float64()), "/",
                               Cast(Column(cn), pa.float64())), out_name))

        inner = Aggregate(node.input, list(node.group_exprs) + [darg], inner_aggs)
        outer_group = [Column(g.output_name()) for g in node.group_exprs]
        outer = Aggregate(inner, outer_group, outer_aggs)
        outer_planned = self._plan_aggregate(outer)
        return ProjectionExec(outer_planned, final_exprs, _rebind_schema(node.schema))

    def _two_phase(self, inner_planned, inner_schema, outer_group, outer_aggs, node, result_exprs_override):
        """Lower the count-distinct outer aggregate over a pre-deduped input."""
        acc_fields = [to_field(g, inner_schema) for g in outer_group] + [
            DFField(d.name, pa.int64(), False) for d in outer_aggs
        ]
        acc_schema = DFSchema(acc_fields)
        partial = HashAggregateExec(inner_planned, list(outer_group), outer_aggs, "partial", acc_schema)
        if outer_group:
            keys = [Column(f.name, f.qualifier) for f in acc_fields[: len(outer_group)]]
            merged = RepartitionExec(partial, "hash", self.shuffle_partitions, keys)
        else:
            merged = CoalescePartitionsExec(partial)
        final_aggs = [AggDesc("sum", Column(d.name), d.name) for d in outer_aggs]
        final_group = [Column(f.name, f.qualifier) for f in acc_fields[: len(outer_group)]]
        final = HashAggregateExec(merged, final_group, final_aggs, "final", acc_schema)
        result_exprs = list(final_group) + [Alias(Column(d.name), d.name) for d in outer_aggs]
        return ProjectionExec(final, result_exprs, _rebind_schema(node.schema))

    # ------------------------------------------------------------------

    def _plan_join(self, node: Join) -> ExecutionPlan:
        from ballista_tpu_torch.plan.logical import Filter as LFilter

        jt = node.join_type
        join_filter = node.filter
        # ON-clause predicates that touch only the NULL-SUPPLYING side of a
        # one-sided outer join are equivalent to pre-filtering that input
        # (a failing row can never match; it is not itself emitted). Pushing
        # them down clears the join filter — which also unlocks the device
        # outer-join lift. Invalid for FULL (both sides emit unmatched).
        if join_filter is not None and jt in ("left", "right"):
            null_side = node.right if jt == "left" else node.left
            other = node.left if jt == "left" else node.right
            if _refs_only(join_filter, null_side.schema, other.schema):
                filtered = LFilter(null_side, join_filter)
                if jt == "left":
                    node = Join(node.left, filtered, node.on, jt, None)
                else:
                    node = Join(filtered, node.right, node.on, jt, None)
                join_filter = None

        left = self._plan(node.left)
        right = self._plan(node.right)
        l_rows = estimate_rows(node.left)
        r_rows = estimate_rows(node.right)

        semi_keys_rows = int(self.config.get(BROADCAST_SEMI_KEYS_THRESHOLD))
        # choose build side (exec always builds its LEFT input)
        swap = False
        if jt in ("inner", "full"):
            swap = r_rows < l_rows
        elif jt in ("left", "right"):
            swap = r_rows < l_rows
            # engine=tpu prefers the null-supplying side as the BUILD so the
            # emitted side stays a probe-driven device chain (right outer on
            # device: unmatched probe rows gather NULL build columns) —
            # worth it when the null-supplying side is collectable
            if str(self.config.get(EXECUTOR_ENGINE)) == "tpu" and join_filter is None:
                # outer builds ship FULL payload columns, so only the normal
                # row-broadcast budget applies (not the keys-only relaxation)
                null_rows = r_rows if jt == "left" else l_rows
                if null_rows <= self.broadcast_rows:
                    swap = jt == "left"  # build must end up the null side
        elif jt in ("left_semi", "left_anti"):
            swap = True  # build the (usually small) subquery side, probe outer
            if r_rows > l_rows * 4:
                swap = False
            # engine=tpu: filterless semi/anti builds ship membership keys
            # only (the device build skips payload encode), so the collect
            # threshold relaxes — keep the subquery side as build whenever
            # its keys still fit (q4: orders SEMI lineitem). The CPU engine
            # collects full rows, so it keeps the strict rules.
            if (not swap and join_filter is None and r_rows <= semi_keys_rows
                    and str(self.config.get(EXECUTOR_ENGINE)) == "tpu"):
                swap = True
        elif jt in ("right_semi", "right_anti"):
            swap = False

        if swap:
            build, probe = right, left
            build_rows = r_rows
            on = [(r, l) for (l, r) in node.on]
            exec_jt = _swap_join_type(jt)
            build_schema, probe_schema = node.right.schema, node.left.schema
        else:
            build, probe = left, right
            build_rows = l_rows
            on = list(node.on)
            exec_jt = jt
            build_schema, probe_schema = node.left.schema, node.right.schema

        broadcast = build_rows <= self.broadcast_rows or probe.output_partition_count() == 1
        if (exec_jt in ("right_semi", "right_anti") and node.filter is None
                and build_rows <= semi_keys_rows
                and str(self.config.get(EXECUTOR_ENGINE)) == "tpu"):
            broadcast = True  # membership keys only: relaxed collect budget

        # build-side-emitting joins (left/full/left_semi/left_anti after the
        # swap) need every probe row to pass through ONE join instance before
        # the unmatched-build tail can be emitted. Distributed tasks each
        # decode their own plan copy, so CollectLeft is only sound when the
        # probe is a single partition; otherwise co-hash-partition both sides
        # and let each task own its build partition outright.
        build_emitting = exec_jt in ("left", "full", "left_semi", "left_anti")
        if build_emitting and probe.output_partition_count() > 1:
            broadcast = False

        adaptive_defer = (
            bool(self.config.get(PLANNER_ADAPTIVE_ENABLED))
            and bool(self.config.get(AQE_DYNAMIC_JOIN_SELECTION))
            and int(self.config.get(BROADCAST_JOIN_THRESHOLD)) > 0
        )
        # HEDGE: a broadcast whose build ESTIMATE lands within
        # `aqe.join.hedge.factor` of the threshold is one bad cardinality
        # guess away from collecting an oversized build on every probe task.
        # When AQE can re-decide with actual sizes, keep the co-partitioned
        # layout and defer: the node resolves to collect_left when the build
        # truly fits (broadcast confirmed / promoted) or to a partitioned
        # join when it came in oversized (broadcast DEMOTED,
        # aqe_stats.broadcast_demotions). Never hedge a single-partition
        # probe (collect there is free and sometimes the only legal mode)
        # or the keys-only semi relaxation (its build intentionally exceeds
        # the row budget). Never hedge under engine=tpu either: only
        # collect-build chains compile into device stages, so demoting a
        # near-threshold broadcast there trades a compilable plan for a
        # host-only one — the out-of-core admission ladder already covers
        # oversized device builds.
        hedged = (
            broadcast and adaptive_defer
            and not self.device_engine
            and probe.output_partition_count() > 1
            and exec_jt in ("inner", "right", "right_semi", "right_anti")
            and 0 < build_rows <= self.broadcast_rows
            and build_rows * float(self.config.get(AQE_JOIN_HEDGE_FACTOR))
            > self.broadcast_rows
        )
        if broadcast and not hedged:
            mode = "collect_left"
        else:
            mode = "partitioned"
            n = self.shuffle_partitions
            build = RepartitionExec(build, "hash", n, [l for l, _ in on])
            probe = RepartitionExec(probe, "hash", n, [r for _, r in on])

        exec_schema = _join_exec_schema(build_schema, probe_schema, exec_jt)
        if mode == "partitioned" and adaptive_defer:
            # the partitioned decision rests on row ESTIMATES: defer it.
            # The node resolves to a concrete join either at stage
            # resolution (stats known, scheduler/aqe/rules.py) or at
            # first-batch time inside the stage (ops/cpu/dynamic_join.py) —
            # the reference's DelayJoinSelectionRule + dynamic_join.rs pair.
            from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec

            j: ExecutionPlan = DynamicJoinSelectionExec(
                build, probe, on, exec_jt, node.filter, exec_schema,
                planned_mode="collect_left" if hedged else "partitioned")
        else:
            j = HashJoinExec(build, probe, on, exec_jt, node.filter, mode, exec_schema)

        if swap and exec_jt in ("inner", "left", "right", "full"):
            order = [Column(f.name, f.qualifier) for f in node.schema]
            return ProjectionExec(j, order, node.schema)
        return j


def _refs_only(e: Expr, inside, outside) -> bool:
    """True iff every Column in `e` resolves in `inside` and none resolve in
    `outside` (conservative: an ambiguous name blocks the pushdown)."""
    cols: list[Column] = []

    def walk(x: Expr):
        if isinstance(x, Column):
            cols.append(x)
        for c in x.children():
            walk(c)

    walk(e)
    for c in cols:
        if inside.maybe_index_of(c.name, c.qualifier) is None:
            return False
        if outside.maybe_index_of(c.name, c.qualifier) is not None:
            return False
    return True


def _swap_join_type(jt: str) -> str:
    return {
        "inner": "inner", "left": "right", "right": "left", "full": "full",
        "left_semi": "right_semi", "left_anti": "right_anti",
        "right_semi": "left_semi", "right_anti": "left_anti",
    }[jt]


def _join_exec_schema(build_schema: DFSchema, probe_schema: DFSchema, jt: str) -> DFSchema:
    if jt in ("left_semi", "left_anti"):
        return build_schema
    if jt in ("right_semi", "right_anti"):
        return probe_schema
    return build_schema.merge(probe_schema)


def _sum_type(t: pa.DataType) -> pa.DataType:
    from ballista_tpu_torch.plan.expressions import sum_result_type

    return sum_result_type(t)


def _merge_func(f: str) -> str:
    return {"sum": "sum", "min": "min", "max": "max", "count": "count",
            "count_all": "count_all", "welford_mean": "welford_mean",
            "welford_m2": "welford_m2"}[f]


def _rebind_schema(s: DFSchema) -> DFSchema:
    return s


# -- crude cardinality estimator (join selection / broadcast decisions) -----

from ballista_tpu_torch.utils.lru import LruDict

_EST_CACHE = LruDict(max_entries=4096)


def estimate_rows(node: LogicalPlan) -> float:
    # id()-keyed memo MUST validate identity: CPython recycles addresses,
    # so a freed plan node's id can alias a new node and return a stale
    # estimate (observed as join-mode flapping between runs). The weakref
    # proves the cached entry belongs to THIS object.
    import weakref

    key = id(node)
    hit = _EST_CACHE.get(key)
    if hit is not None and hit[1]() is node:
        return hit[0]
    v = _estimate(node)
    try:
        ref = weakref.ref(node)
    except TypeError:  # un-weakrefable: skip caching
        return v
    _EST_CACHE[key] = (v, ref)
    return v


def _estimate(node: LogicalPlan) -> float:
    if isinstance(node, TableScan):
        stats = node.provider.statistics()
        base = float(stats.num_rows) if stats.num_rows is not None else 1e6
        return max(1.0, base * (0.3 ** len(node.filters)))
    if isinstance(node, Filter):
        return max(1.0, estimate_rows(node.input) * 0.3)
    if isinstance(node, Join):
        l, r = estimate_rows(node.left), estimate_rows(node.right)
        if node.join_type in ("left_semi", "left_anti"):
            return max(1.0, l * 0.5)
        if node.join_type in ("right_semi", "right_anti"):
            return max(1.0, r * 0.5)
        return max(l, r)
    if isinstance(node, CrossJoin):
        return max(1.0, min(estimate_rows(node.left) * estimate_rows(node.right), 1e12))
    if isinstance(node, Aggregate):
        if not node.group_exprs:
            return 1.0
        return max(1.0, estimate_rows(node.input) * 0.1)
    if isinstance(node, Distinct):
        return max(1.0, estimate_rows(node.input) * 0.5)
    if isinstance(node, Limit):
        base = estimate_rows(node.input)
        return min(base, node.fetch if node.fetch is not None else base)
    if isinstance(node, Union):
        return sum(estimate_rows(c) for c in node.inputs)
    kids = node.children()
    if kids:
        return estimate_rows(kids[0])
    return 1.0
