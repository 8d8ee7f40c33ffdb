"""Device engine: rewrite supported subtrees of a physical plan into
device stages on the CUDA card.

Counterpart of the JAX package's engine/tpu_engine.py — the seam the
reference exposes as `ExecutionEngine`
(ballista/executor/src/execution_engine.rs:51): given a query stage's
physical plan, produce the executor that runs it. `ballista.executor.engine
= tpu` (the key and value kept as in the JAX package) routes stages
through here; unsupported subtrees keep their CPU operators (per-subtree
dispatch like execution_engine.rs:124-147).

It claims the shapes the reference's `walk` claims, in its order:
final-aggregate + ORDER BY stages (TpuFinalStageExec), partial aggregates
over a Filter/Projection/collected-join chain (TpuStageExec), then, behind
`ballista.tpu.sort.enabled`, the standalone ORDER BY [LIMIT] stages
(TpuSortStageExec) and window stages (TpuWindowStageExec) of the sort
family (ops/cuda/sort_window.py). Where the plan's root is a shuffle
writer hash-partitioning a TpuStageExec's group columns, the stage emits
the partition ids itself (_wire_device_routing). An AQE resolve-time
stamp of the observed input bytes on the root reaches every TpuStageExec's
admission (_wire_observed_bytes).
"""

from __future__ import annotations

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.plan.physical import (
    CoalesceBatchesExec,
    ExecutionPlan,
    FilterExec,
    HashAggregateExec,
    MemoryScanExec,
    ParquetScanExec,
    ProjectionExec,
)


def _concretize_dynamic_joins(node: ExecutionPlan) -> ExecutionPlan:
    """Rewrite every DynamicJoinSelectionExec into its planned HashJoinExec
    before device compilation. The deferral exists so the CPU engine can
    promote to a collected broadcast at first-batch time — but a deferred
    node is opaque to the stage compiler, which silently pushes the whole
    join chain back to the host (measured round 5: q3/q5/q9/q14/q19 hot
    ran at ~1x the CPU engine while q1/q6 ran 40-100x). The device join
    (direct-table gathers against an HBM-resident build) is what the
    deferral would be deciding toward anyway; subtrees the device rejects
    still fall back per-subtree, where the CPU join runs as planned."""
    from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec
    from ballista_tpu_torch.plan.physical import HashJoinExec

    kids = node.children()
    new_kids = [_concretize_dynamic_joins(c) for c in kids]
    if any(a is not b for a, b in zip(new_kids, kids)):
        node = node.with_children(new_kids)
    if isinstance(node, DynamicJoinSelectionExec):
        node = HashJoinExec(node.left, node.right, node.on, node.join_type,
                            node.filter, node.mode, node.df_schema)
    return node


def maybe_compile_tpu(physical: ExecutionPlan, config: BallistaConfig) -> ExecutionPlan:
    from ballista_tpu_torch.config import TPU_COMPILE_CACHE_DIR
    from ballista_tpu_torch.ops.cuda import runtime
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec, match_final_stage
    from ballista_tpu_torch.ops.cuda.sort_window import (
        TpuSortStageExec,
        TpuWindowStageExec,
        sort_family_enabled,
        sort_static_ok,
        window_static_ok,
    )
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import SortExec, WindowExec

    # the kernel build directory (the reference's persistent XLA cache dir)
    cc_dir = str(config.get(TPU_COMPILE_CACHE_DIR) or "")
    if cc_dir:
        runtime.init_compile_cache(cc_dir)

    # capture the AQE resolve-time stamp before any rewrite rebuilds the
    # root node (with_children does not carry ad-hoc attributes)
    observed_bytes = int(getattr(physical, "hbm_observed_input_bytes", 0) or 0)
    physical = _concretize_dynamic_joins(physical)
    sort_on = sort_family_enabled(config)

    def walk(node: ExecutionPlan) -> ExecutionPlan:
        fs = match_final_stage(node)
        if fs is not None:
            # final-agg/sort stage shape: merge partials + ORDER BY/LIMIT on
            # the card; the child keeps its own device opportunities
            sort, post_ops, agg, child, coalesce = fs
            return TpuFinalStageExec(sort, post_ops, agg, walk(child), config, coalesce)
        if isinstance(node, HashAggregateExec) and node.mode == "partial":
            chain = _match_chain(node.input)
            if chain is not None:
                ops, scan = chain
                if _static_ok(node):
                    return TpuStageExec(node, ops, scan, config)
                hoisted = _hoist_expr_group_keys(node)
                if hoisted is not None and _static_ok(hoisted.input):
                    inner = TpuStageExec(hoisted.input, ops, scan, config)
                    return hoisted.with_children([inner])
            elif _static_ok(node):
                # a UNION on the probe chain blocks the single-scan stage
                # form — push the partial agg through the union so each
                # branch compiles its own device chain
                pushed = _push_agg_through_union(node)
                if pushed is not None:
                    return walk(pushed)
        if (sort_on and isinstance(node, SortExec)
                and sort_static_ok(node.keys, node.input.df_schema)):
            # standalone ORDER BY [LIMIT] (final-stage shapes were claimed
            # above): device permutation, host take — cost model picks the
            # rung per shape at run time
            return node._keep_stamp(TpuSortStageExec(walk(node.input), node.keys,
                                                     node.fetch, config))
        if (sort_on and isinstance(node, WindowExec)
                and window_static_ok(node.window_exprs, node.input.df_schema)):
            return TpuWindowStageExec(walk(node.input), node.window_exprs,
                                      node.df_schema, config)
        kids = node.children()
        if not kids:
            return node
        new_kids = [walk(c) for c in kids]
        if all(a is b for a, b in zip(new_kids, kids)):
            return node
        return node.with_children(new_kids)

    out = walk(physical)
    _wire_device_routing(out)
    _wire_observed_bytes(observed_bytes, out)
    return out


def _wire_observed_bytes(observed: int, out: ExecutionPlan) -> None:
    """Copy the AQE resolve-time stamp (`hbm_observed_input_bytes`, the
    input volume the finished producers observed) from the stage root onto
    every compiled TpuStageExec, where admission uses it as a floor under
    the build-size estimate. Plain attributes on both sides: sub-plans
    never cross the wire."""
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    if observed <= 0:
        return

    def walk(node: ExecutionPlan) -> None:
        if isinstance(node, TpuStageExec):
            node.hbm_observed_input_bytes = observed
        for c in node.children():
            walk(c)

    walk(out)


def _wire_device_routing(root: ExecutionPlan) -> None:
    """When a stage's root shuffle writer hash-partitions on columns of a
    TpuStageExec's output, tell the stage to emit a device-computed __pid
    column (the writer consumes it and skips host hashing). Sorted-path
    stages honor it; others ignore it."""
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.expressions import Alias as _Alias
    from ballista_tpu_torch.plan.expressions import Column as _Column
    from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec

    if not isinstance(root, ShuffleWriterExec) or root.output_partitions <= 0:
        return
    # the stage must feed the writer DIRECTLY: an intervening operator
    # (CoalesceBatches etc.) re-asserts its declared schema and would choke
    # on the extra __pid column
    node = root.input
    if not isinstance(node, TpuStageExec):
        return
    schema = node.df_schema
    if any(f.name == "__pid" for f in schema):
        return  # never shadow a user column
    n_group = len(node.partial_agg.group_exprs)
    idxs: list[int] = []
    for k in root.keys:
        kc = k.expr if isinstance(k, _Alias) else k
        if not isinstance(kc, _Column):
            return
        i = schema.maybe_index_of(kc.name, kc.qualifier)
        if i is None:
            i = schema.maybe_index_of(kc.name, None)
        if i is None or i >= n_group:
            return  # key is not a group output column
        idxs.append(i)
    if idxs:
        node.emit_pid = (idxs, root.output_partitions)
        root.device_routed = True  # writer honors __pid only when flagged


def _match_chain(node: ExecutionPlan):
    """Descend the PROBE path through Filter/Projection/CoalesceBatches and
    CollectLeft inner hash joins to a scan; return (dataflow-ordered op
    list, scan) or None. Join build sides stay CPU-side subplans executed
    at stage start; probe-side rows never leave the device."""
    from ballista_tpu_torch.plan.physical import HashJoinExec

    ops: list[ExecutionPlan] = []
    cur = node
    while True:
        if isinstance(cur, (ParquetScanExec, MemoryScanExec)):
            ops.reverse()
            return ops, cur
        if isinstance(cur, (FilterExec, ProjectionExec, CoalesceBatchesExec)):
            ops.append(cur)
            cur = cur.children()[0]
            continue
        if (
            isinstance(cur, HashJoinExec)
            and cur.mode == "collect_left"
            and (
                (cur.join_type in ("inner", "right") and cur.filter is None)
                or cur.join_type in ("right_semi", "right_anti")
            )
        ):
            # inner: build-column gathers join the chain; right (outer):
            # every probe row emits, unmatched gathers are NULL (validity
            # planes); right_semi/right_anti emit probe rows only — the
            # match mask IS the filter, and a join filter (e.g. q21's
            # l_suppkey <> l1.l_suppkey) ORs across build match lanes
            ops.append(cur)
            cur = cur.right  # probe side continues the device chain
            continue
        return None


def _hoist_expr_group_keys(agg: HashAggregateExec):
    """Rewrite a partial agg whose group keys are single-column expressions
    (TPC-DS q62/q99's `substr(w_warehouse_name, 1, 20)`) so the DEVICE
    groups by the raw column — a strict refinement — and the expression is
    applied by a tiny CPU projection over the (few) partial group rows.
    Correct because the FINAL aggregation re-groups by the expression's
    value and every partial accumulator (sum/min/max/count and the Welford
    triple) merges across the finer groups. Returns the projection node
    (child = the rewritten partial agg) or None."""
    from ballista_tpu_torch.plan.expressions import Alias, Column, transform_expr
    from ballista_tpu_torch.plan.schema import DFField, DFSchema

    in_schema = agg.input.df_schema
    new_groups = []
    post_exprs = []
    group_fields = []
    changed = False
    for i, g in enumerate(agg.group_exprs):
        out_name = g.output_name()
        out_field = agg.df_schema.field(i)
        inner = g.expr if isinstance(g, Alias) else g
        if isinstance(inner, Column):
            new_groups.append(g)
            group_fields.append(out_field)
            post_exprs.append(Alias(Column(out_name), out_name))
            continue
        cols = [e for e in _walk_exprs(inner) if isinstance(e, Column)]
        if len({(c.name, c.qualifier) for c in cols}) != 1:
            return None  # multi-column or constant group expr: no raw key
        raw = cols[0]
        raw_field = in_schema.field(in_schema.index_of(raw.name, raw.qualifier))
        gk = f"__gk{i}"
        new_groups.append(Alias(Column(raw.name, raw.qualifier), gk))
        group_fields.append(DFField(gk, raw_field.dtype, raw_field.nullable))
        rewritten = transform_expr(
            inner, lambda e: Column(gk) if isinstance(e, Column) else e)
        post_exprs.append(Alias(rewritten, out_name))
        changed = True
    if not changed:
        return None
    n_group = len(agg.group_exprs)
    acc_fields = list(agg.df_schema)[n_group:]
    inner_schema = DFSchema(group_fields + acc_fields)
    for f in acc_fields:
        post_exprs.append(Alias(Column(f.name), f.name))
    new_agg = HashAggregateExec(agg.input, new_groups, agg.aggs, "partial", inner_schema)
    return ProjectionExec(new_agg, post_exprs, agg.df_schema)


def _walk_exprs(e):
    yield e
    for c in e.children():
        yield from _walk_exprs(c)


def _push_agg_through_union(agg: HashAggregateExec):
    """HashAgg(partial) over [ops...] over Union(b1..bn) →
    Union(HashAgg(partial) over [ops...] over b_i). Applied only when every
    branch schema matches the union schema exactly (names + types), so
    dropping the union's per-branch alignment cast changes nothing."""
    from ballista_tpu_torch.plan.physical import HashJoinExec, UnionExec

    path: list[ExecutionPlan] = []  # chain nodes, agg-side first
    cur = agg.input
    while not isinstance(cur, UnionExec):
        if isinstance(cur, (FilterExec, ProjectionExec, CoalesceBatchesExec)):
            path.append(cur)
            cur = cur.children()[0]
        elif (
            isinstance(cur, HashJoinExec)
            and cur.mode == "collect_left"
            and cur.join_type in ("inner", "right", "right_semi", "right_anti")
        ):
            # probe-side-emitting joins only: cloning a build-side-emitting
            # join (left/full/left_semi/left_anti) per union branch would
            # emit the unmatched-build tail once per branch
            path.append(cur)
            cur = cur.right
        else:
            return None
    union = cur
    us = union.schema()
    for b in union.inputs:
        bs = b.schema()
        if [(f.name, f.type) for f in bs] != [(f.name, f.type) for f in us]:
            return None
    branch_aggs = []
    for b in union.inputs:
        node: ExecutionPlan = b
        for p in reversed(path):
            if isinstance(p, HashJoinExec):
                node = p.with_children([p.left, node])
            else:
                node = p.with_children([node])
        branch_aggs.append(
            HashAggregateExec(node, agg.group_exprs, agg.aggs, "partial", agg.df_schema))
    return UnionExec(branch_aggs, agg.df_schema)


def _static_ok(agg: HashAggregateExec) -> bool:
    from ballista_tpu_torch.plan.expressions import Alias, Column

    for g in agg.group_exprs:
        inner = g.expr if isinstance(g, Alias) else g
        if not isinstance(inner, Column):
            return False
    for d in agg.aggs:
        if d.func not in ("sum", "min", "max", "count", "count_all",
                          "welford_mean", "welford_m2"):
            return False
    return True
