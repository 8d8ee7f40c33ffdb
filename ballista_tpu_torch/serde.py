"""Plan codec: physical plans and expressions ↔ protobuf.

Rebuild of BallistaCodec / BallistaPhysicalExtensionCodec
(ballista/core/src/serde/mod.rs:140,355): every operator the executor can
run round-trips through ballista.proto's PhysicalPlanNode, including the
distributed nodes (ShuffleWriter/ShuffleReader/UnresolvedShuffle). The
scheduler serializes per-task plans into TaskDefinition
(state/task_manager.rs:767); executors decode and hand the plan to the
configured engine.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import io
from typing import Optional

import pyarrow as pa
import pyarrow.ipc as ipc

from ballista_tpu_torch.errors import GeneralError
from ballista_tpu_torch.plan.expressions import (
    AggregateFunction,
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
    SortKey,
    WindowFunction,
)
from ballista_tpu_torch.plan.physical import (
    AggDesc,
    CoalesceBatchesExec,
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
    WindowExec,
    SortPreservingMergeExec,
    UnionExec,
)
from ballista_tpu_torch.ops.cpu.range_repartition import (
    BufferExec,
    RuntimeStatsExec,
    UnorderedRangeRepartitionExec,
)
from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec
from ballista_tpu_torch.plan.schema import DFField, DFSchema
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec, UnresolvedShuffleExec
from ballista_tpu_torch.shuffle.types import PartitionLocation, PartitionStats
from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec

# -- schema -------------------------------------------------------------------

_TYPE_TO_STR = {
    pa.int64(): "int64", pa.int32(): "int32", pa.int16(): "int16",
    pa.int8(): "int8", pa.float64(): "float64", pa.float32(): "float32",
    pa.string(): "utf8", pa.large_string(): "large_utf8", pa.date32(): "date32",
    pa.bool_(): "bool", pa.timestamp("us"): "timestamp_us", pa.null(): "null",
}
_STR_TO_TYPE = {v: k for k, v in _TYPE_TO_STR.items()}


def type_to_str(t: pa.DataType) -> str:
    s = _TYPE_TO_STR.get(t)
    if s is None:
        # parameterized tags (exact decimal policy: money survives the wire)
        if pa.types.is_decimal128(t):
            return f"decimal128({t.precision},{t.scale})"
        if pa.types.is_decimal256(t):
            return f"decimal256({t.precision},{t.scale})"
        raise GeneralError(f"unserializable arrow type {t}")
    return s


def str_to_type(s: str) -> pa.DataType:
    t = _STR_TO_TYPE.get(s)
    if t is None:
        if s.startswith("decimal128(") or s.startswith("decimal256("):
            p, sc = s[s.index("(") + 1:-1].split(",")
            mk = pa.decimal128 if s.startswith("decimal128") else pa.decimal256
            return mk(int(p), int(sc))
        raise GeneralError(f"unknown arrow type tag {s}")
    return t


def encode_schema(s: DFSchema) -> pb.SchemaProto:
    out = pb.SchemaProto()
    for f in s:
        out.fields.append(
            pb.FieldProto(name=f.name, arrow_type=type_to_str(f.dtype),
                          nullable=f.nullable, qualifier=f.qualifier or "")
        )
    return out


def decode_schema(p: pb.SchemaProto) -> DFSchema:
    return DFSchema(
        [DFField(f.name, str_to_type(f.arrow_type), f.nullable, f.qualifier or None) for f in p.fields]
    )


# -- expressions --------------------------------------------------------------


def encode_literal(v) -> pb.LiteralProto:
    out = pb.LiteralProto()
    if v is None:
        out.null_v = True
    elif isinstance(v, bool):
        out.bool_v = v
    elif isinstance(v, int):
        out.int_v = v
    elif isinstance(v, float):
        out.float_v = v
    elif isinstance(v, str):
        out.string_v = v
    elif isinstance(v, _dt.date):
        out.date_days = (v - _dt.date(1970, 1, 1)).days
    elif isinstance(v, _decimal.Decimal):
        out.decimal_v = str(v)  # exact text round-trip
    elif isinstance(v, tuple) and len(v) == 2:
        out.interval.n = v[0]
        out.interval.unit = v[1]
    else:
        raise GeneralError(f"unserializable literal {v!r}")
    return out


def decode_literal(p: pb.LiteralProto):
    which = p.WhichOneof("value")
    if which == "null_v" or which is None:
        return None
    if which == "bool_v":
        return p.bool_v
    if which == "int_v":
        return p.int_v
    if which == "float_v":
        return p.float_v
    if which == "string_v":
        return p.string_v
    if which == "date_days":
        return _dt.date(1970, 1, 1) + _dt.timedelta(days=p.date_days)
    if which == "decimal_v":
        return _decimal.Decimal(p.decimal_v)
    if which == "interval":
        return (p.interval.n, p.interval.unit)
    raise GeneralError(f"bad literal {p}")


def encode_expr(e: Expr) -> pb.ExprProto:
    out = pb.ExprProto()
    if isinstance(e, Column):
        out.column.name = e.name
        out.column.qualifier = e.qualifier or ""
    elif isinstance(e, Literal):
        out.literal.CopyFrom(encode_literal(e.value))
    elif isinstance(e, BinaryExpr):
        out.binary.left.CopyFrom(encode_expr(e.left))
        out.binary.op = e.op
        out.binary.right.CopyFrom(encode_expr(e.right))
    elif isinstance(e, Not):
        out.__getattribute__("not").expr.CopyFrom(encode_expr(e.expr))
    elif isinstance(e, Negative):
        out.negative.expr.CopyFrom(encode_expr(e.expr))
    elif isinstance(e, IsNull):
        out.is_null.expr.CopyFrom(encode_expr(e.expr))
    elif isinstance(e, IsNotNull):
        out.is_not_null.expr.CopyFrom(encode_expr(e.expr))
    elif isinstance(e, Alias):
        out.alias.expr.CopyFrom(encode_expr(e.expr))
        out.alias.name = e.name
    elif isinstance(e, Cast):
        out.cast.expr.CopyFrom(encode_expr(e.expr))
        out.cast.arrow_type = type_to_str(e.to)
    elif isinstance(e, Like):
        out.like.expr.CopyFrom(encode_expr(e.expr))
        out.like.pattern = e.pattern
        out.like.negated = e.negated
    elif isinstance(e, InList):
        out.in_list.expr.CopyFrom(encode_expr(e.expr))
        for v in e.values:
            out.in_list.values.append(encode_literal(v))
        out.in_list.negated = e.negated
    elif isinstance(e, Between):
        out.between.expr.CopyFrom(encode_expr(e.expr))
        out.between.low.CopyFrom(encode_expr(e.low))
        out.between.high.CopyFrom(encode_expr(e.high))
        out.between.negated = e.negated
    elif isinstance(e, Case):
        for w, t in e.branches:
            br = out.case_expr.branches.add()
            br.when.CopyFrom(encode_expr(w))
            br.then.CopyFrom(encode_expr(t))
        if e.else_expr is not None:
            out.case_expr.else_expr.CopyFrom(encode_expr(e.else_expr))
    elif isinstance(e, ScalarFunction):
        out.scalar_fn.name = e.name
        for a in e.args:
            out.scalar_fn.args.append(encode_expr(a))
    elif isinstance(e, WindowFunction):
        out.window_fn.func = e.func
        for a in e.args:
            out.window_fn.args.append(encode_expr(a))
        for pe in e.partition_by:
            out.window_fn.partition_by.append(encode_expr(pe))
        for k in e.order_by:
            out.window_fn.order_by.append(encode_sort_key(k))
        if e.frame is not None:
            out.window_fn.has_frame = True
            out.window_fn.start_unbounded = e.frame[1] is None
            out.window_fn.frame_start = e.frame[1] or 0
            out.window_fn.end_unbounded = e.frame[2] is None
            out.window_fn.frame_end = e.frame[2] or 0
    elif isinstance(e, AggregateFunction):
        out.agg_fn.func = e.func
        out.agg_fn.distinct = e.distinct
        if e.arg is None:
            out.agg_fn.no_arg = True
        else:
            out.agg_fn.arg.CopyFrom(encode_expr(e.arg))
    else:
        raise GeneralError(f"unserializable expr {type(e).__name__}: {e}")
    return out


def decode_expr(p: pb.ExprProto) -> Expr:
    which = p.WhichOneof("expr_type")
    if which == "column":
        return Column(p.column.name, p.column.qualifier or None)
    if which == "literal":
        return Literal(decode_literal(p.literal))
    if which == "binary":
        return BinaryExpr(decode_expr(p.binary.left), p.binary.op, decode_expr(p.binary.right))
    if which == "not":
        return Not(decode_expr(getattr(p, "not").expr))
    if which == "negative":
        return Negative(decode_expr(p.negative.expr))
    if which == "is_null":
        return IsNull(decode_expr(p.is_null.expr))
    if which == "is_not_null":
        return IsNotNull(decode_expr(p.is_not_null.expr))
    if which == "alias":
        return Alias(decode_expr(p.alias.expr), p.alias.name)
    if which == "cast":
        return Cast(decode_expr(p.cast.expr), str_to_type(p.cast.arrow_type))
    if which == "like":
        return Like(decode_expr(p.like.expr), p.like.pattern, p.like.negated)
    if which == "in_list":
        return InList(
            decode_expr(p.in_list.expr),
            tuple(decode_literal(v) for v in p.in_list.values),
            p.in_list.negated,
        )
    if which == "between":
        return Between(
            decode_expr(p.between.expr), decode_expr(p.between.low),
            decode_expr(p.between.high), p.between.negated,
        )
    if which == "case_expr":
        branches = tuple(
            (decode_expr(b.when), decode_expr(b.then)) for b in p.case_expr.branches
        )
        els = decode_expr(p.case_expr.else_expr) if p.case_expr.HasField("else_expr") else None
        return Case(branches, els)
    if which == "scalar_fn":
        return ScalarFunction(p.scalar_fn.name, tuple(decode_expr(a) for a in p.scalar_fn.args))
    if which == "window_fn":
        frame = None
        if p.window_fn.has_frame:
            frame = (
                "rows",
                None if p.window_fn.start_unbounded else p.window_fn.frame_start,
                None if p.window_fn.end_unbounded else p.window_fn.frame_end,
            )
        return WindowFunction(
            p.window_fn.func,
            tuple(decode_expr(a) for a in p.window_fn.args),
            tuple(decode_expr(a) for a in p.window_fn.partition_by),
            tuple(decode_sort_key(k) for k in p.window_fn.order_by),
            frame,
        )
    if which == "agg_fn":
        arg = None if p.agg_fn.no_arg else decode_expr(p.agg_fn.arg)
        return AggregateFunction(p.agg_fn.func, arg, p.agg_fn.distinct)
    raise GeneralError(f"bad expr proto {which}")


def encode_sort_key(k: SortKey) -> pb.SortKeyProto:
    return pb.SortKeyProto(expr=encode_expr(k.expr), ascending=k.ascending, nulls_first=k.nulls_first)


def decode_sort_key(p: pb.SortKeyProto) -> SortKey:
    return SortKey(decode_expr(p.expr), p.ascending, p.nulls_first)


# -- partition locations ------------------------------------------------------


def encode_location(l: PartitionLocation) -> pb.PartitionLocationProto:
    return pb.PartitionLocationProto(
        map_partition=l.map_partition, job_id=l.job_id, stage_id=l.stage_id,
        output_partition=l.output_partition, executor_id=l.executor_id,
        host=l.host, flight_port=l.flight_port, path=l.path, layout=l.layout,
        stats=pb.PartitionStatsProto(
            num_rows=l.stats.num_rows, num_batches=l.stats.num_batches, num_bytes=l.stats.num_bytes
        ),
    )


def decode_location(p: pb.PartitionLocationProto) -> PartitionLocation:
    return PartitionLocation(
        map_partition=p.map_partition, job_id=p.job_id, stage_id=p.stage_id,
        output_partition=p.output_partition, executor_id=p.executor_id,
        host=p.host, flight_port=p.flight_port, path=p.path, layout=p.layout or "hash",
        stats=PartitionStats(p.stats.num_rows, p.stats.num_batches, p.stats.num_bytes),
    )


# -- physical plan ------------------------------------------------------------


def _is_dynamic_join(plan) -> bool:
    from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec

    return isinstance(plan, DynamicJoinSelectionExec)


def encode_plan(plan: ExecutionPlan) -> pb.PhysicalPlanNode:
    out = pb.PhysicalPlanNode()
    if isinstance(plan, ParquetScanExec):
        n = out.parquet_scan
        n.schema.CopyFrom(encode_schema(plan.df_schema))
        for part in plan.partitions:
            sp = n.partitions.add()
            sp.memory_partition = -1
            for f in part.get("files", []):
                fp = sp.files.add()
                fp.file = f["file"]
                if f.get("row_groups") is None:
                    fp.all_row_groups = True
                else:
                    fp.row_groups.extend(f["row_groups"])
        n.projection.extend(plan.projection)
        for f in plan.filters:
            n.filters.append(encode_expr(f))
        n.table_name = plan.table_name
    elif isinstance(plan, MemoryScanExec):
        n = out.memory_scan
        n.schema.CopyFrom(encode_schema(plan.df_schema))
        sink = io.BytesIO()
        from ballista_tpu_torch.plan.physical import _align_batch

        with ipc.new_stream(sink, plan.schema()) as w:
            for b in plan.batches:
                # stored batches may be wider than the (pruned) scan schema
                w.write_batch(_align_batch(b, plan.schema()))
        n.arrow_ipc = sink.getvalue()
        n.partitions = plan.partitions
    elif isinstance(plan, FilterExec):
        out.filter.input.CopyFrom(encode_plan(plan.input))
        out.filter.predicate.CopyFrom(encode_expr(plan.predicate))
    elif isinstance(plan, ProjectionExec):
        out.projection.input.CopyFrom(encode_plan(plan.input))
        for e in plan.exprs:
            out.projection.exprs.append(encode_expr(e))
        out.projection.schema.CopyFrom(encode_schema(plan.df_schema))
    elif isinstance(plan, HashAggregateExec):
        n = out.aggregate
        n.input.CopyFrom(encode_plan(plan.input))
        for g in plan.group_exprs:
            n.group_exprs.append(encode_expr(g))
        for d in plan.aggs:
            dp = n.aggs.add()
            dp.func = d.func
            dp.name = d.name
            if d.expr is None:
                dp.no_arg = True
            else:
                dp.expr.CopyFrom(encode_expr(d.expr))
        n.mode = plan.mode
        n.schema.CopyFrom(encode_schema(plan.df_schema))
    elif isinstance(plan, HashJoinExec) or _is_dynamic_join(plan):
        n = out.hash_join
        n.left.CopyFrom(encode_plan(plan.left))
        n.right.CopyFrom(encode_plan(plan.right))
        for l, r in plan.on:
            kp = n.on.add()
            kp.left.CopyFrom(encode_expr(l))
            kp.right.CopyFrom(encode_expr(r))
        n.join_type = plan.join_type
        if plan.filter is not None:
            n.filter.CopyFrom(encode_expr(plan.filter))
        n.mode = plan.mode
        if _is_dynamic_join(plan) and getattr(plan, "planned_mode", "") == "collect_left":
            # a hedged broadcast's planned strategy rides the mode string
            # (frozen proto): the executor-side resolution needs it to tell
            # a demotion from a plain partitioned decision
            n.mode = f"{plan.mode}:planned=collect_left"
        n.schema.CopyFrom(encode_schema(plan.df_schema))
        n.dynamic = _is_dynamic_join(plan)
    elif isinstance(plan, CrossJoinExec):
        out.cross_join.left.CopyFrom(encode_plan(plan.left))
        out.cross_join.right.CopyFrom(encode_plan(plan.right))
        out.cross_join.schema.CopyFrom(encode_schema(plan.df_schema))
    elif isinstance(plan, SortPreservingMergeExec):
        n = out.sort_preserving_merge
        n.input.CopyFrom(encode_plan(plan.input))
        for k in plan.keys:
            n.keys.append(encode_sort_key(k))
        n.fetch = -1 if plan.fetch is None else plan.fetch
    elif isinstance(plan, WindowExec):
        n = out.window
        n.input.CopyFrom(encode_plan(plan.input))
        for w in plan.window_exprs:
            n.window_exprs.append(encode_expr(w))
        n.schema.CopyFrom(encode_schema(plan.df_schema))
    elif isinstance(plan, SortExec):
        n = out.sort
        n.input.CopyFrom(encode_plan(plan.input))
        for k in plan.keys:
            n.keys.append(encode_sort_key(k))
        n.fetch = -1 if plan.fetch is None else plan.fetch
    elif isinstance(plan, CoalescePartitionsExec):
        out.coalesce_partitions.input.CopyFrom(encode_plan(plan.input))
    elif isinstance(plan, CoalesceBatchesExec):
        out.coalesce_batches.input.CopyFrom(encode_plan(plan.input))
        out.coalesce_batches.target_rows = plan.target_rows
    elif isinstance(plan, LocalLimitExec):
        out.local_limit.input.CopyFrom(encode_plan(plan.input))
        out.local_limit.fetch = plan.fetch
    elif isinstance(plan, GlobalLimitExec):
        out.global_limit.input.CopyFrom(encode_plan(plan.input))
        out.global_limit.fetch = -1 if plan.fetch is None else plan.fetch
        out.global_limit.skip = plan.skip
    elif isinstance(plan, RepartitionExec):
        n = out.repartition
        n.input.CopyFrom(encode_plan(plan.input))
        n.scheme = plan.scheme
        n.n = plan.n
        for k in plan.keys:
            n.keys.append(encode_expr(k))
    elif isinstance(plan, MeshExchangeExec):
        # wire form: a repartition node with scheme "mesh_exchange" — the
        # checked-in generated proto predates the mesh node (and the image
        # carries no protoc to extend it); the scheme string disambiguates
        # losslessly since planner-made RepartitionExec schemes are a closed
        # set ("hash"/"round_robin")
        n = out.repartition
        n.input.CopyFrom(encode_plan(plan.producer))
        # an AQE demotion verdict (skew, oversized input) must survive the
        # wire — the executor-side exchange takes the host path and reports
        # the scheduler's reason, instead of re-litigating the device ladder
        n.scheme = ("mesh_exchange" if not plan.demote_reason
                    else f"mesh_exchange:demoted={plan.demote_reason}")
        n.n = plan.file_partitions
        for k in plan.keys:
            n.keys.append(encode_expr(k))
    elif isinstance(plan, UnorderedRangeRepartitionExec):
        # the dynamic range-repartition pipeline rides the repartition
        # oneof too (same frozen-proto constraint as mesh_exchange); the
        # SortKey's direction flags travel in the scheme string
        n = out.repartition
        n.input.CopyFrom(encode_plan(plan.input))
        n.scheme = (f"range_unordered:asc={int(plan.key.ascending)},"
                    f"nulls_first={int(plan.key.nulls_first)}")
        n.n = plan.n
        n.keys.append(encode_expr(plan.key.expr))
    elif isinstance(plan, RuntimeStatsExec):
        n = out.repartition
        n.input.CopyFrom(encode_plan(plan.input))
        n.scheme = "runtime_stats"
        n.n = 0
        if plan.sort_expr is not None:
            n.keys.append(encode_expr(plan.sort_expr))
    elif isinstance(plan, BufferExec):
        n = out.repartition
        n.input.CopyFrom(encode_plan(plan.input))
        n.scheme = "buffer"
        n.n = plan.max_bytes
    elif isinstance(plan, UnionExec):
        for c in plan.inputs:
            out.union.inputs.append(encode_plan(c))
        out.union.schema.CopyFrom(encode_schema(plan.df_schema))
    elif isinstance(plan, EmptyExec):
        out.empty.schema.CopyFrom(encode_schema(plan.df_schema))
        out.empty.produce_one_row = plan.produce_one_row
    elif isinstance(plan, ShuffleWriterExec):
        n = out.shuffle_writer
        n.input.CopyFrom(encode_plan(plan.input))
        n.job_id = plan.job_id
        n.stage_id = plan.stage_id
        n.output_partitions = plan.output_partitions
        for k in plan.keys:
            n.keys.append(encode_expr(k))
        n.sort_shuffle = plan.sort_shuffle
    elif isinstance(plan, ShuffleReaderExec):
        n = out.shuffle_reader
        n.schema.CopyFrom(encode_schema(plan.df_schema))
        for part in plan.partition_locations:
            pl = n.partition_locations.add()
            for loc in part:
                pl.locations.append(encode_location(loc))
        n.broadcast = plan.broadcast
    elif isinstance(plan, UnresolvedShuffleExec):
        n = out.unresolved_shuffle
        n.stage_id = plan.stage_id
        n.schema.CopyFrom(encode_schema(plan.df_schema))
        n.output_partitions = plan.output_partitions
        n.broadcast = plan.broadcast
    else:
        raise GeneralError(f"unserializable plan node {type(plan).__name__}")
    return out


def decode_plan(p: pb.PhysicalPlanNode) -> ExecutionPlan:
    which = p.WhichOneof("plan_type")
    if which == "parquet_scan":
        n = p.parquet_scan
        parts = []
        for sp in n.partitions:
            files = []
            for f in sp.files:
                files.append(
                    {"file": f.file, "row_groups": None if f.all_row_groups else list(f.row_groups)}
                )
            parts.append({"files": files})
        return ParquetScanExec(decode_schema(n.schema), parts, list(n.projection),
                               [decode_expr(f) for f in n.filters], n.table_name)
    if which == "memory_scan":
        n = p.memory_scan
        schema = decode_schema(n.schema)
        batches = []
        if n.arrow_ipc:
            reader = ipc.open_stream(pa.BufferReader(n.arrow_ipc))
            batches = list(reader)
        return MemoryScanExec(schema, batches, n.partitions or 1)
    if which == "filter":
        return FilterExec(decode_plan(p.filter.input), decode_expr(p.filter.predicate))
    if which == "projection":
        return ProjectionExec(
            decode_plan(p.projection.input),
            [decode_expr(e) for e in p.projection.exprs],
            decode_schema(p.projection.schema),
        )
    if which == "aggregate":
        n = p.aggregate
        aggs = [
            AggDesc(d.func, None if d.no_arg else decode_expr(d.expr), d.name) for d in n.aggs
        ]
        return HashAggregateExec(
            decode_plan(n.input), [decode_expr(g) for g in n.group_exprs], aggs,
            n.mode, decode_schema(n.schema),
        )
    if which == "hash_join":
        n = p.hash_join
        on = [(decode_expr(kp.left), decode_expr(kp.right)) for kp in n.on]
        filt = decode_expr(n.filter) if n.HasField("filter") else None
        if n.dynamic:
            from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec

            mode, _, planned = n.mode.partition(":planned=")
            return DynamicJoinSelectionExec(
                decode_plan(n.left), decode_plan(n.right), on, n.join_type, filt,
                decode_schema(n.schema), mode, planned or "partitioned",
            )
        return HashJoinExec(
            decode_plan(n.left), decode_plan(n.right), on, n.join_type, filt,
            n.mode, decode_schema(n.schema),
        )
    if which == "cross_join":
        return CrossJoinExec(
            decode_plan(p.cross_join.left), decode_plan(p.cross_join.right),
            decode_schema(p.cross_join.schema),
        )
    if which == "window":
        return WindowExec(
            decode_plan(p.window.input),
            [decode_expr(w) for w in p.window.window_exprs],
            decode_schema(p.window.schema),
        )
    if which == "sort":
        n = p.sort
        return SortExec(decode_plan(n.input), [decode_sort_key(k) for k in n.keys],
                        None if n.fetch < 0 else n.fetch)
    if which == "sort_preserving_merge":
        n = p.sort_preserving_merge
        return SortPreservingMergeExec(decode_plan(n.input), [decode_sort_key(k) for k in n.keys],
                                       None if n.fetch < 0 else n.fetch)
    if which == "coalesce_partitions":
        return CoalescePartitionsExec(decode_plan(p.coalesce_partitions.input))
    if which == "coalesce_batches":
        return CoalesceBatchesExec(decode_plan(p.coalesce_batches.input), p.coalesce_batches.target_rows)
    if which == "local_limit":
        return LocalLimitExec(decode_plan(p.local_limit.input), p.local_limit.fetch)
    if which == "global_limit":
        n = p.global_limit
        return GlobalLimitExec(decode_plan(n.input), None if n.fetch < 0 else n.fetch, n.skip)
    if which == "repartition":
        n = p.repartition
        if n.scheme == "mesh_exchange" or n.scheme.startswith("mesh_exchange:"):
            ex = MeshExchangeExec(decode_plan(n.input), [decode_expr(k) for k in n.keys], n.n)
            if n.scheme.startswith("mesh_exchange:demoted="):
                ex.demote_reason = n.scheme.split("demoted=", 1)[1]
            return ex
        if n.scheme.startswith("range_unordered:"):
            flags = dict(kv.split("=") for kv in n.scheme.split(":", 1)[1].split(","))
            key = SortKey(decode_expr(n.keys[0]), ascending=flags["asc"] == "1",
                          nulls_first=flags["nulls_first"] == "1")
            return UnorderedRangeRepartitionExec(decode_plan(n.input), key, n.n)
        if n.scheme == "runtime_stats":
            expr = decode_expr(n.keys[0]) if n.keys else None
            return RuntimeStatsExec(decode_plan(n.input), expr)
        if n.scheme == "buffer":
            return BufferExec(decode_plan(n.input), n.n)
        return RepartitionExec(decode_plan(n.input), n.scheme, n.n, [decode_expr(k) for k in n.keys])
    if which == "union":
        return UnionExec([decode_plan(c) for c in p.union.inputs], decode_schema(p.union.schema))
    if which == "empty":
        return EmptyExec(decode_schema(p.empty.schema), p.empty.produce_one_row)
    if which == "shuffle_writer":
        n = p.shuffle_writer
        return ShuffleWriterExec(
            decode_plan(n.input), n.job_id, n.stage_id, n.output_partitions,
            [decode_expr(k) for k in n.keys], n.sort_shuffle,
        )
    if which == "shuffle_reader":
        n = p.shuffle_reader
        locs = [[decode_location(l) for l in part.locations] for part in n.partition_locations]
        return ShuffleReaderExec(decode_schema(n.schema), locs, n.broadcast)
    if which == "unresolved_shuffle":
        n = p.unresolved_shuffle
        return UnresolvedShuffleExec(n.stage_id, decode_schema(n.schema), n.output_partitions, n.broadcast)
    raise GeneralError(f"bad plan proto: {which}")


def plan_to_bytes(plan: ExecutionPlan) -> bytes:
    return encode_plan(plan).SerializeToString()


def plan_from_bytes(data: bytes) -> ExecutionPlan:
    p = pb.PhysicalPlanNode()
    p.ParseFromString(data)
    return decode_plan(p)
