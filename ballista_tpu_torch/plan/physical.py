"""Physical execution plan: Volcano-style over Arrow RecordBatches.

Each node implements `execute(partition, ctx) -> Iterator[RecordBatch]`.
This is the CPU engine — the parity baseline standing in for the
reference's DataFusion operator set (SURVEY.md §1 "engine under it all").
The TPU engine (engine/tpu_engine.py) compiles supported subtrees of THIS
plan to XLA and falls back here per-subtree.

Partitioning model mirrors the reference: a node has N output partitions;
`RepartitionExec` is the in-process exchange that the distributed planner
replaces with shuffle writer/reader pairs at stage boundaries
(reference: scheduler/src/planner.rs:108).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from ballista_tpu_torch.config import BATCH_SIZE, BallistaConfig
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.cpu.join_kernel import match_pairs
from ballista_tpu_torch.ops.hashing import partition_indices
from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
from ballista_tpu_torch.plan.expressions import Expr, SortKey
from ballista_tpu_torch.plan.schema import DFSchema

log = logging.getLogger(__name__)


class Metrics:
    def __init__(self):
        self.output_rows = 0
        self.output_batches = 0
        self.elapsed_ns = 0
        # operator-specific counters (spilled_bytes, spill_count, ...) —
        # the reference's labeled MetricsSet values beyond the core trio
        self.extra: dict[str, int] = {}

    def as_dict(self) -> dict:
        return {
            "output_rows": self.output_rows,
            "output_batches": self.output_batches,
            "elapsed_ns": self.elapsed_ns,
            **self.extra,
        }


class TaskContext:
    def __init__(self, config: BallistaConfig | None = None, task_id: str = "", work_dir: str = ""):
        self.config = config or BallistaConfig()
        self.task_id = task_id
        self.work_dir = work_dir
        self.batch_size = int(self.config.get(BATCH_SIZE))
        # session-shared MemoryPool (try_grow semantics) when running under
        # an executor; None = static per-task limits only
        self.memory_pool = None
        # per-chip pinning: jax device ordinal this task must dispatch to
        # (-1 = unpinned); set by Executor.execute_task from its metadata
        self.device_ordinal = -1
        # straggler-defense plumbing, set by Executor.execute_task:
        # which attempt of the task this is (speculative duplicates > 0),
        # a callable polled by long-running operators to honor preemptive
        # cancels, and the absolute wall-clock deadline (0.0 = none)
        self.task_attempt = 0
        self.cancel_check = None
        self.deadline_at = 0.0


class ExecutionPlan:
    """Base physical operator."""

    def __init__(self, df_schema: DFSchema):
        self.df_schema = df_schema
        self.metrics = Metrics()

    def schema(self) -> pa.Schema:
        return self.df_schema.to_arrow()

    def children(self) -> list["ExecutionPlan"]:
        return []

    def with_children(self, children: list["ExecutionPlan"]) -> "ExecutionPlan":
        raise NotImplementedError(type(self).__name__)

    def output_partition_count(self) -> int:
        return self.children()[0].output_partition_count()

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        raise NotImplementedError

    def node_str(self) -> str:
        return type(self).__name__

    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [pad + self.node_str()]
        for c in self.children():
            lines.append(c.display(indent + 1))
        return "\n".join(lines)

    def _timed(self, it: Iterator[pa.RecordBatch]) -> Iterator[pa.RecordBatch]:
        m = self.metrics
        while True:
            t0 = time.perf_counter_ns()
            try:
                b = next(it)
            except StopIteration:
                m.elapsed_ns += time.perf_counter_ns() - t0
                return
            m.elapsed_ns += time.perf_counter_ns() - t0
            m.output_rows += b.num_rows
            m.output_batches += 1
            yield b


def collect_metrics(plan: ExecutionPlan, out: list | None = None, depth: int = 0) -> list:
    """Recursive metrics harvest (reference: utils.rs collect_plan_metrics)."""
    if out is None:
        out = []
    out.append((depth, plan.node_str(), plan.metrics.as_dict()))
    for c in plan.children():
        collect_metrics(c, out, depth + 1)
    return out


def _empty_batch(schema: pa.Schema) -> pa.RecordBatch:
    return pa.RecordBatch.from_arrays([pa.array([], f.type) for f in schema], schema=schema)


def _concat(batches: list[pa.RecordBatch], schema: pa.Schema) -> pa.Table:
    if not batches:
        return pa.table({f.name: pa.array([], f.type) for f in schema}, schema=schema)
    return pa.Table.from_batches(batches, schema=schema)


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


class ParquetScanExec(ExecutionPlan):
    """Parquet scan over (file, row-group) partitions with exact filter
    application post-read and row-group pruning via parquet min/max stats."""

    def __init__(self, df_schema: DFSchema, partitions: list[dict], projection: list[str],
                 filters: list[Expr], table_name: str = ""):
        super().__init__(df_schema)
        self.partitions = partitions
        self.projection = projection
        self.filters = filters
        self.table_name = table_name

    def output_partition_count(self) -> int:
        return max(1, len(self.partitions))

    def with_children(self, c):
        assert not c
        return self

    def node_str(self) -> str:
        f = f" filters={[str(x) for x in self.filters]}" if self.filters else ""
        return (
            f"ParquetScanExec: {self.table_name} partitions={len(self.partitions)} "
            f"projection={self.projection}{f}"
        )

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(self._run(partition, ctx))

    def _run(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if not self.partitions:
            yield _empty_batch(self.schema())
            return
        part = self.partitions[partition]
        preds = [bind_expr(f, self.df_schema) for f in self.filters]
        out_schema = self.schema()
        produced = False
        for fdesc in part.get("files", []):
            fpath = fdesc["file"]
            if fpath.startswith("s3://"):
                from ballista_tpu_torch.plan.object_store import resolve_filesystem

                fs, inner = resolve_filesystem(fpath)
                pf = pq.ParquetFile(inner, filesystem=fs)
            else:
                pf = pq.ParquetFile(fpath)
            rgs = fdesc.get("row_groups")
            if rgs is None:
                rgs = list(range(pf.metadata.num_row_groups))
            rgs = [rg for rg in rgs if not self._prunable(pf.metadata, rg)]
            if not rgs:
                continue
            for batch in pf.iter_batches(batch_size=ctx.batch_size, row_groups=rgs, columns=self.projection):
                batch = _align_batch(batch, out_schema)
                for p in preds:
                    mask = evaluate_to_array(p, batch)
                    batch = batch.filter(pc.fill_null(mask, False))
                    if batch.num_rows == 0:
                        break
                if batch.num_rows:
                    produced = True
                    yield batch
        if not produced:
            yield _empty_batch(out_schema)

    def _prunable(self, md, rg_idx: int) -> bool:
        """True if min/max stats prove no row in this group can pass."""
        if not self.filters:
            return False
        from ballista_tpu_torch.plan.expressions import Between, BinaryExpr, Column, Literal

        rg = md.row_group(rg_idx)
        col_stats = {}
        for ci in range(rg.num_columns):
            col = rg.column(ci)
            st = col.statistics
            if st is not None and st.has_min_max:
                col_stats[col.path_in_schema] = (st.min, st.max)
        for f in self.filters:
            name, op, val = None, None, None
            if isinstance(f, BinaryExpr) and isinstance(f.left, Column) and isinstance(f.right, Literal):
                name, op, val = f.left.name, f.op, f.right.value
            elif isinstance(f, BinaryExpr) and isinstance(f.right, Column) and isinstance(f.left, Literal):
                flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "<>": "<>"}
                name, op, val = f.right.name, flip[f.op], f.left.value
            elif isinstance(f, Between) and isinstance(f.expr, Column) and not f.negated \
                    and isinstance(f.low, Literal) and isinstance(f.high, Literal):
                if f.expr.name in col_stats:
                    mn, mx = col_stats[f.expr.name]
                    lo, hi = _stat_val(f.low.value), _stat_val(f.high.value)
                    try:
                        if _stat_val(mx) < lo or _stat_val(mn) > hi:
                            return True
                    except TypeError:
                        pass
                continue
            if name is None or name not in col_stats or val is None:
                continue
            mn, mx = _stat_val(col_stats[name][0]), _stat_val(col_stats[name][1])
            v = _stat_val(val)
            try:
                if op == "=" and (v < mn or v > mx):
                    return True
                if op in ("<", "<=") and mn > v:
                    return True
                if op in (">", ">=") and mx < v:
                    return True
            except TypeError:
                continue
        return False


def _stat_val(v):
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        return v.date()
    return v


def _align_batch(batch: pa.RecordBatch, schema: pa.Schema) -> pa.RecordBatch:
    """Reorder/cast columns read from parquet to the node's output schema.
    Where the names already line up, columns are taken by position: a name
    may repeat (a.x and b.x), and a lookup by name finds none of them."""
    in_order = batch.schema.names == schema.names
    cols = []
    for i, f in enumerate(schema):
        arr = batch.column(i if in_order else batch.schema.get_field_index(f.name))
        if arr.type != f.type:
            arr = arr.cast(f.type)
        cols.append(arr)
    return pa.RecordBatch.from_arrays(cols, schema=schema)


_MEM_SCAN_COUNTER = iter(range(1, 1 << 62))


class MemoryScanExec(ExecutionPlan):
    def __init__(self, df_schema: DFSchema, batches: list[pa.RecordBatch], partitions: int = 1):
        super().__init__(df_schema)
        self.batches = batches
        self.partitions = max(1, partitions)
        # collision-free cache identity (id() recycles addresses)
        self.mem_token = next(_MEM_SCAN_COUNTER)

    def output_partition_count(self) -> int:
        return self.partitions

    def with_children(self, c):
        return self

    def execute(self, partition: int, ctx: TaskContext):
        sel = [b for i, b in enumerate(self.batches) if i % self.partitions == partition]
        schema = self.schema()
        sel = [_align_batch(b, schema) for b in sel]
        if not sel:
            sel = [_empty_batch(schema)]
        return self._timed(iter(sel))

    def node_str(self) -> str:
        rows = sum(b.num_rows for b in self.batches)
        return f"MemoryScanExec: rows={rows} partitions={self.partitions}"


class EmptyExec(ExecutionPlan):
    def __init__(self, df_schema: DFSchema, produce_one_row: bool = False):
        super().__init__(df_schema)
        self.produce_one_row = produce_one_row

    def output_partition_count(self) -> int:
        return 1

    def with_children(self, c):
        return self

    def execute(self, partition: int, ctx: TaskContext):
        schema = self.schema()
        if self.produce_one_row:
            if len(schema) == 0:
                # a 1-row batch needs at least one column in Arrow; SELECTs
                # without FROM project literals over this placeholder
                schema = pa.schema([pa.field("__placeholder", pa.null())])
            arrays = [pa.nulls(1, f.type) for f in schema]
            return iter([pa.RecordBatch.from_arrays(arrays, schema=schema)])
        return iter([_empty_batch(schema)])


# ---------------------------------------------------------------------------
# row pipeline operators
# ---------------------------------------------------------------------------


class FilterExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, predicate: Expr):
        super().__init__(input.df_schema)
        self.input = input
        self.predicate = predicate

    def children(self):
        return [self.input]

    def with_children(self, c):
        return FilterExec(c[0], self.predicate)

    def node_str(self) -> str:
        return f"FilterExec: {self.predicate}"

    def execute(self, partition: int, ctx: TaskContext):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        pred = bind_expr(self.predicate, self.df_schema)
        for batch in self.input.execute(partition, ctx):
            mask = evaluate_to_array(pred, batch)
            out = batch.filter(pc.fill_null(mask, False))
            if out.num_rows:
                yield out


class ProjectionExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, exprs: list[Expr], df_schema: DFSchema):
        super().__init__(df_schema)
        self.input = input
        self.exprs = exprs

    def children(self):
        return [self.input]

    def with_children(self, c):
        return ProjectionExec(c[0], self.exprs, self.df_schema)

    def node_str(self) -> str:
        return f"ProjectionExec: {', '.join(str(e) for e in self.exprs)}"

    def execute(self, partition: int, ctx: TaskContext):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        bound = [bind_expr(e, self.input.df_schema) for e in self.exprs]
        schema = self.schema()
        for batch in self.input.execute(partition, ctx):
            arrays = []
            for pe, f in zip(bound, schema):
                arr = evaluate_to_array(pe, batch)
                if arr.type != f.type:
                    arr = arr.cast(f.type)
                arrays.append(arr)
            yield pa.RecordBatch.from_arrays(arrays, schema=schema)


class CoalesceBatchesExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, target_rows: int = 64 * 1024):
        super().__init__(input.df_schema)
        self.input = input
        self.target_rows = target_rows

    def children(self):
        return [self.input]

    def with_children(self, c):
        return CoalesceBatchesExec(c[0], self.target_rows)

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        buf: list[pa.RecordBatch] = []
        rows = 0
        schema = self.schema()
        for b in self.input.execute(partition, ctx):
            if b.num_rows == 0:
                continue
            buf.append(b)
            rows += b.num_rows
            if rows >= self.target_rows:
                yield _concat(buf, schema).combine_chunks().to_batches()[0]
                buf, rows = [], 0
        if buf:
            yield _concat(buf, schema).combine_chunks().to_batches()[0]
        elif rows == 0:
            yield _empty_batch(schema)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def _as_py_scalar(v):
    return v.as_py() if isinstance(v, pa.Scalar) else v


def _welford_merge_lists(n_lists, mean_lists, m2_lists):
    """Merge per-group lists of Welford partials (one element per upstream
    partial row) with the mean-centered formula:

        N = Σn_i;  mean = Σ n_i·mean_i / N
        M2 = Σ M2_i + Σ n_i·(mean_i − mean)²

    Centering before squaring keeps intermediates at data scale — this is
    why the decomposition survives large-magnitude columns where the naive
    q − s²/n form catastrophically cancels. Vectorized over groups via
    flattened values + reduceat (list lengths are identical across the three
    columns: each upstream partial row contributes one slot to each list).
    """
    def _la(col):
        col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        return col

    n_la, mean_la, m2_la = _la(n_lists), _la(mean_lists), _la(m2_lists)
    off = n_la.offsets.to_numpy()
    starts = off[:-1]
    lens = np.diff(off)
    n_flat = n_la.flatten().to_numpy(zero_copy_only=False).astype(np.float64)
    mean_flat = mean_la.flatten().to_numpy(zero_copy_only=False)
    m2_flat = m2_la.flatten().to_numpy(zero_copy_only=False)
    # partials are null only when n==0 (zero contribution); with n>0 a NaN is
    # genuine data NaN and must propagate, matching single-partition results
    mean_flat = np.where(n_flat > 0, mean_flat, 0.0)
    m2_flat = np.where(n_flat > 0, m2_flat, 0.0)
    n_groups = len(lens)
    if len(n_flat) == 0:
        empty = pa.nulls(n_groups, pa.float64())
        return empty, empty
    N = np.add.reduceat(n_flat, starts)
    wsum = np.add.reduceat(n_flat * mean_flat, starts)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_g = wsum / N
    mean_rep = np.repeat(np.nan_to_num(mean_g), lens)
    centered = n_flat * (mean_flat - mean_rep) ** 2
    M2 = np.add.reduceat(m2_flat + centered, starts)
    valid = N > 0
    mean_arr = pa.array(np.where(valid, mean_g, 0.0), pa.float64(), mask=~valid)
    m2_arr = pa.array(np.where(valid, M2, 0.0), pa.float64(), mask=~valid)
    return mean_arr, m2_arr


@dataclass
class AggDesc:
    func: str  # sum | min | max | count | count_all
    expr: Optional[Expr]  # None for count_all
    name: str  # output column name


class HashAggregateExec(ExecutionPlan):
    """Two-phase hash aggregation.

    partial: groups within one input partition, emits accumulator columns.
    final:   merges accumulator columns (after a hash repartition on keys).
    single:  both at once (single-partition plans).
    """

    def __init__(self, input: ExecutionPlan, group_exprs: list[Expr], aggs: list[AggDesc],
                 mode: str, df_schema: DFSchema):
        super().__init__(df_schema)
        self.input = input
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.mode = mode  # partial | final | single

    def children(self):
        return [self.input]

    def with_children(self, c):
        return HashAggregateExec(c[0], self.group_exprs, self.aggs, self.mode, self.df_schema)

    def node_str(self) -> str:
        g = ", ".join(str(e) for e in self.group_exprs)
        a = ", ".join(f"{d.func}({d.expr if d.expr is not None else '*'})" for d in self.aggs)
        return f"HashAggregateExec: mode={self.mode}, gby=[{g}], aggr=[{a}]"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        schema = self.schema()
        in_schema = self.input.df_schema
        batches = [b for b in self.input.execute(partition, ctx) if b.num_rows]
        n_group = len(self.group_exprs)

        if self.mode in ("partial", "single"):
            group_bound = [bind_expr(e, in_schema) for e in self.group_exprs]
            agg_bound = [bind_expr(d.expr, in_schema) if d.expr is not None else None for d in self.aggs]
            gcols: dict[str, list] = {f"__g{i}": [] for i in range(n_group)}
            acols: dict[str, list] = {f"__a{i}": [] for i in range(len(self.aggs))}
            ones_needed = any(d.func == "count_all" for d in self.aggs)
            for b in batches:
                for i, ge in enumerate(group_bound):
                    gcols[f"__g{i}"].append(evaluate_to_array(ge, b))
                for i, (d, ab) in enumerate(zip(self.aggs, agg_bound)):
                    if d.func == "count_all":
                        acols[f"__a{i}"].append(pa.array(np.ones(b.num_rows, dtype=np.int64)))
                    else:
                        acols[f"__a{i}"].append(evaluate_to_array(ab, b))
            if not batches:
                tbl = None
            else:
                cols = {k: pa.chunked_array(v) for k, v in {**gcols, **acols}.items()}
                tbl = pa.table(cols)
            pairs = []
            for i, d in enumerate(self.aggs):
                fn = {"sum": "sum", "min": "min", "max": "max", "count": "count",
                      "count_all": "sum", "welford_mean": "mean",
                      "welford_m2": "variance"}[d.func]
                pairs.append((f"__a{i}", fn))
        else:  # final: input columns are [groups..., accumulators...]
            tbl = _concat(batches, self.input.schema()) if batches else None
            if tbl is not None:
                names = [f"__g{i}" for i in range(n_group)] + [f"__a{i}" for i in range(len(self.aggs))]
                tbl = tbl.rename_columns(names)
            pairs = []
            for i, d in enumerate(self.aggs):
                # welford partials merge as a (cnt, mean, m2) unit: list-collect
                # the per-partition values, merged below with the mean-centered
                # formula (numerically stable — no sum-of-squares cancellation)
                fn = {"sum": "sum", "min": "min", "max": "max", "count": "sum",
                      "count_all": "sum", "welford_mean": "list",
                      "welford_m2": "list"}[d.func]
                pairs.append((f"__a{i}", fn))

        if tbl is None or tbl.num_rows == 0:
            if n_group == 0:
                yield self._empty_global_row(schema)
            else:
                yield _empty_batch(schema)
            return

        if n_group == 0:
            arrays = []
            welford_global: dict[int, tuple] = {}  # mean-desc idx → (mean, m2)
            for i, ((cname, fn), d, f) in enumerate(zip(pairs, self.aggs, schema)):
                col = tbl.column(cname)
                if d.func == "welford_mean" and self.mode == "final":
                    welford_global[i] = self._welford_merge_global(tbl, i - 1)
                    v = welford_global[i][0]
                elif d.func == "welford_m2" and self.mode == "final":
                    v = welford_global[i - 1][1]
                elif d.func == "welford_mean":
                    v = pc.mean(col)
                elif d.func == "welford_m2":
                    n = len(col) - col.null_count
                    var = pc.variance(col, ddof=0).as_py() if n else None
                    v = pa.scalar(None if var is None else var * n, pa.float64())
                elif fn == "sum":
                    v = pc.sum(col)
                elif fn == "min":
                    v = pc.min(col)
                elif fn == "max":
                    v = pc.max(col)
                elif fn == "count":
                    v = pa.scalar(len(col) - col.null_count, pa.int64())
                arr = pa.array([_as_py_scalar(v)], f.type)
                arrays.append(arr)
            yield pa.RecordBatch.from_arrays(arrays, schema=schema)
            return

        keys = [f"__g{i}" for i in range(n_group)]
        agg_calls: list = []
        for (cname, fn), d in zip(pairs, self.aggs):
            if fn == "variance":
                agg_calls.append((cname, "variance", pc.VarianceOptions(ddof=0)))
                agg_calls.append((cname, "count"))  # for m2 = var_pop * n
            else:
                agg_calls.append((cname, fn))
        for i, d in enumerate(self.aggs):
            if self.mode == "final" and d.func == "welford_mean":
                agg_calls.append((f"__a{i - 1}", "list"))  # the triple's counts
        grouped = tbl.group_by(keys, use_threads=False).aggregate(agg_calls)
        # grouped columns: [agg outputs named __aI_fn ..., keys...] (pyarrow puts
        # aggregates first or keys first depending on version) — map by name.
        out_arrays = []
        for i in range(n_group):
            out_arrays.append(grouped.column(f"__g{i}"))
        welford_cache: dict[int, tuple] = {}  # mean-desc idx → (mean_arr, m2_arr)
        for i, ((cname, fn), d) in enumerate(zip(pairs, self.aggs)):
            if fn == "variance":  # partial welford_m2: m2 = var_pop * n
                var = pc.cast(grouped.column(f"{cname}_variance"), pa.float64())
                n = pc.cast(grouped.column(f"{cname}_count"), pa.float64())
                out_arrays.append(pc.multiply(var, n))
            elif fn == "list" and d.func == "welford_mean":
                merged = _welford_merge_lists(
                    grouped.column(f"__a{i - 1}_list"),
                    grouped.column(f"__a{i}_list"),
                    grouped.column(f"__a{i + 1}_list"),
                )
                welford_cache[i] = merged
                out_arrays.append(merged[0])
            elif fn == "list" and d.func == "welford_m2":
                out_arrays.append(welford_cache[i - 1][1])
            else:
                out_arrays.append(grouped.column(f"{cname}_{fn}"))
        casted = []
        for arr, f in zip(out_arrays, schema):
            a = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
            if a.type != f.type:
                a = a.cast(f.type)
            casted.append(a)
        yield pa.RecordBatch.from_arrays(casted, schema=schema)

    def _welford_merge_global(self, tbl: pa.Table, cnt_idx: int):
        """Merge all partial (count, mean, m2) rows into one global pair.
        Columns __a{cnt_idx}, __a{cnt_idx+1}, __a{cnt_idx+2} hold the triple."""
        n = tbl.column(f"__a{cnt_idx}").to_numpy(zero_copy_only=False).astype(np.float64)
        mean = tbl.column(f"__a{cnt_idx + 1}").to_numpy(zero_copy_only=False)
        m2 = tbl.column(f"__a{cnt_idx + 2}").to_numpy(zero_copy_only=False)
        # null partials ⟺ n==0; NaN with n>0 is data NaN and must propagate
        mean = np.where(n > 0, mean, 0.0)
        m2 = np.where(n > 0, m2, 0.0)
        total = n.sum()
        if total <= 0:
            return None, None
        g_mean = float((n * mean).sum() / total)
        g_m2 = float(m2.sum() + (n * (mean - g_mean) ** 2).sum())
        return g_mean, g_m2

    def _empty_global_row(self, schema: pa.Schema) -> pa.RecordBatch:
        arrays = []
        for d, f in zip(self.aggs, schema):
            if d.func in ("count", "count_all"):
                arrays.append(pa.array([0], f.type))
            else:
                arrays.append(pa.nulls(1, f.type))
        return pa.RecordBatch.from_arrays(arrays, schema=schema)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


class HashJoinExec(ExecutionPlan):
    """Hash equi-join; builds LEFT side, probes RIGHT side.

    mode='collect_left' broadcasts the whole left input to every probe
    partition (reference: CollectLeft); mode='partitioned' assumes both
    sides are co-hash-partitioned on the join keys.
    """

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 on: list[tuple[Expr, Expr]], join_type: str, filter: Optional[Expr],
                 mode: str, df_schema: DFSchema):
        super().__init__(df_schema)
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.filter = filter
        self.mode = mode
        self._build_cache: dict[int, pa.Table] = {}
        self._lock = threading.Lock()
        # collect_left + build-side-emitting join types (left/full/semi/anti)
        # need matched-bitmap coordination across probe partitions: every
        # partition sees the SAME build table, so tail emission must happen
        # exactly once, after the LAST probe partition drains (the reference
        # relies on DataFusion's shared bitmap for CollectLeft likewise).
        self._shared_matched: np.ndarray | None = None
        self._done_partitions = 0

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return HashJoinExec(c[0], c[1], self.on, self.join_type, self.filter, self.mode, self.df_schema)

    def output_partition_count(self) -> int:
        return self.right.output_partition_count()

    def node_str(self) -> str:
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        f = f", filter={self.filter}" if self.filter is not None else ""
        return f"HashJoinExec: mode={self.mode}, type={self.join_type}, on=[{on}]{f}"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _build_table(self, partition: int, ctx: TaskContext) -> pa.Table:
        key = -1 if self.mode == "collect_left" else partition
        with self._lock:
            if key in self._build_cache:
                return self._build_cache[key]
        if self.mode == "collect_left":
            batches = []
            for p in range(self.left.output_partition_count()):
                batches.extend(b for b in self.left.execute(p, ctx) if b.num_rows)
        else:
            batches = [b for b in self.left.execute(partition, ctx) if b.num_rows]
        tbl = _concat(batches, self.left.schema()).combine_chunks()
        if self.mode == "collect_left":
            # a collect_left planned under the tpu engine's HBM-scaled
            # threshold can land here when the device stage is declined —
            # EVERY probe task then collects this table into host memory.
            # The cliff is survivable but must not be silent.
            from ballista_tpu_torch.config import BROADCAST_JOIN_ROWS_THRESHOLD
            cpu_threshold = int(ctx.config.get(BROADCAST_JOIN_ROWS_THRESHOLD))
            if tbl.num_rows > cpu_threshold:
                log.warning(
                    "collect_left join build side has %d rows, exceeding the CPU "
                    "broadcast threshold of %d (%s); this join was likely planned "
                    "for a device stage that fell back to host execution — every "
                    "probe task materializes the full build table in host memory",
                    tbl.num_rows, cpu_threshold, BROADCAST_JOIN_ROWS_THRESHOLD)
        with self._lock:
            self._build_cache[key] = tbl
        return tbl

    def _run(self, partition, ctx):
        build = self._build_table(partition, ctx)
        lschema, rschema = self.left.df_schema, self.right.df_schema
        lkeys = [bind_expr(l, lschema) for l, _ in self.on]
        rkeys = [bind_expr(r, rschema) for _, r in self.on]
        combined_schema = lschema.merge(rschema)
        filt = bind_expr(self.filter, combined_schema) if self.filter is not None else None
        out_schema = self.schema()

        build_batch = (
            build.to_batches()[0] if build.num_rows else _empty_batch(self.left.schema())
        )
        if build.num_rows:
            build_batch = build.combine_chunks().to_batches()[0]
        build_key_arrays = [evaluate_to_array(k, build_batch) for k in lkeys]

        # prepare the build ONCE per execution: dictionary-encode + sort the
        # build keys a single time, then map every probe batch into that id
        # space (re-encoding a large build per batch dominated join time).
        # Both sides cast to a common key type first so the shared id space
        # is lossless.
        from ballista_tpu_torch.ops.cpu.join_kernel import PreparedBuild, _common_type

        key_types: list = []
        if build.num_rows:
            probe_schema = self.right.schema()
            prep_cols = []
            for k_expr, arr in zip(rkeys, build_key_arrays):
                a = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
                try:
                    p_type = evaluate_to_array(
                        k_expr, _empty_batch(self.right.df_schema)
                    ).type
                except Exception:  # noqa: BLE001 — fall back to the build type
                    p_type = a.type
                common = _common_type(a.type, p_type)
                key_types.append(common)
                prep_cols.append(a.cast(common) if a.type != common else a)
            prepared = PreparedBuild(prep_cols)
        else:
            prepared = None

        jt = self.join_type
        build_emitting = jt in ("left", "full", "left_semi", "left_anti")
        shared = self.mode == "collect_left" and build_emitting and self.right.output_partition_count() > 1
        if shared:
            with self._lock:
                if self._shared_matched is None:
                    self._shared_matched = np.zeros(build.num_rows, dtype=bool)
            matched_build = np.zeros(build.num_rows, dtype=bool)
        else:
            matched_build = np.zeros(build.num_rows, dtype=bool)
        produced = False

        for probe in self.right.execute(partition, ctx):
            if probe.num_rows == 0:
                continue
            probe_keys = [evaluate_to_array(k, probe) for k in rkeys]
            if prepared is not None:
                cast_keys = [
                    (a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a)
                    for a in probe_keys
                ]
                cast_keys = [
                    a.cast(ty) if a.type != ty else a
                    for a, ty in zip(cast_keys, key_types)
                ]
                bi, pi = prepared.match(cast_keys)
            else:
                bi = pi = np.zeros(0, dtype=np.int64)
            if filt is not None and len(bi):
                pair_batch = _pair_batch(build_batch, bi, probe, pi, combined_schema)
                mask = evaluate_to_array(filt, pair_batch)
                keep = pc.fill_null(mask, False).to_numpy(zero_copy_only=False)
                bi, pi = bi[keep], pi[keep]
            if len(bi):
                matched_build[bi] = True
            if jt == "inner":
                if len(bi):
                    produced = True
                    yield _emit_pairs(build_batch, bi, probe, pi, out_schema)
            elif jt in ("right", "full"):
                pm = np.zeros(probe.num_rows, dtype=bool)
                if len(pi):
                    pm[pi] = True
                out = []
                if len(bi):
                    out.append(_emit_pairs(build_batch, bi, probe, pi, out_schema))
                un = np.nonzero(~pm)[0]
                if len(un):
                    out.append(_emit_null_left(build_batch.schema, probe, un, out_schema))
                for b in out:
                    produced = True
                    yield b
            elif jt == "left":
                if len(bi):
                    produced = True
                    yield _emit_pairs(build_batch, bi, probe, pi, out_schema)
            elif jt == "right_semi":
                pm = np.zeros(probe.num_rows, dtype=bool)
                if len(pi):
                    pm[pi] = True
                sel = np.nonzero(pm)[0]
                if len(sel):
                    produced = True
                    yield _take_batch(probe, sel, out_schema)
            elif jt == "right_anti":
                pm = np.zeros(probe.num_rows, dtype=bool)
                if len(pi):
                    pm[pi] = True
                sel = np.nonzero(~pm)[0]
                if len(sel):
                    produced = True
                    yield _take_batch(probe, sel, out_schema)
            elif jt in ("left_semi", "left_anti"):
                pass  # emitted at end from matched_build
            else:
                raise ExecutionError(f"join type {jt} not supported")

        # end-of-probe emissions from the build side
        emit_tail = build_emitting
        if shared:
            with self._lock:
                self._shared_matched |= matched_build
                self._done_partitions += 1
                emit_tail = self._done_partitions == self.right.output_partition_count()
                if emit_tail:
                    matched_build = self._shared_matched
        if emit_tail and jt in ("left", "full"):
            un = np.nonzero(~matched_build)[0]
            if len(un):
                produced = True
                yield _emit_null_right(build_batch, un, self.right.schema(), out_schema)
        elif emit_tail and jt == "left_semi":
            sel = np.nonzero(matched_build)[0]
            if len(sel):
                produced = True
                yield _take_batch(build_batch, sel, out_schema)
        elif emit_tail and jt == "left_anti":
            sel = np.nonzero(~matched_build)[0]
            if len(sel):
                produced = True
                yield _take_batch(build_batch, sel, out_schema)
        if not produced:
            yield _empty_batch(out_schema)


def _take_batch(batch: pa.RecordBatch, idx: np.ndarray, out_schema: pa.Schema) -> pa.RecordBatch:
    t = batch.take(pa.array(idx))
    return pa.RecordBatch.from_arrays([c for c in t.columns], schema=out_schema)


def _pair_batch(build: pa.RecordBatch, bi, probe: pa.RecordBatch, pi, combined: DFSchema) -> pa.RecordBatch:
    bcols = build.take(pa.array(bi)).columns
    pcols = probe.take(pa.array(pi)).columns
    return pa.RecordBatch.from_arrays(list(bcols) + list(pcols), schema=combined.to_arrow())


def _emit_pairs(build, bi, probe, pi, out_schema) -> pa.RecordBatch:
    bcols = build.take(pa.array(bi)).columns
    pcols = probe.take(pa.array(pi)).columns
    return pa.RecordBatch.from_arrays(list(bcols) + list(pcols), schema=out_schema)


def _emit_null_left(build_schema: pa.Schema, probe, idx, out_schema) -> pa.RecordBatch:
    n = len(idx)
    bcols = [pa.nulls(n, f.type) for f in build_schema]
    pcols = probe.take(pa.array(idx)).columns
    return pa.RecordBatch.from_arrays(bcols + list(pcols), schema=out_schema)


def _emit_null_right(build, idx, right_schema: pa.Schema, out_schema) -> pa.RecordBatch:
    bcols = build.take(pa.array(idx)).columns
    n = len(idx)
    pcols = [pa.nulls(n, f.type) for f in right_schema]
    return pa.RecordBatch.from_arrays(list(bcols) + pcols, schema=out_schema)


class CrossJoinExec(ExecutionPlan):
    def __init__(self, left: ExecutionPlan, right: ExecutionPlan, df_schema: DFSchema):
        super().__init__(df_schema)
        self.left = left
        self.right = right
        self._cache: pa.Table | None = None
        self._lock = threading.Lock()

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return CrossJoinExec(c[0], c[1], self.df_schema)

    def output_partition_count(self) -> int:
        return self.right.output_partition_count()

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        with self._lock:
            if self._cache is None:
                batches = []
                for p in range(self.left.output_partition_count()):
                    batches.extend(b for b in self.left.execute(p, ctx) if b.num_rows)
                self._cache = _concat(batches, self.left.schema()).combine_chunks()
        build = self._cache
        out_schema = self.schema()
        produced = False
        nb = build.num_rows
        if nb == 0:
            yield _empty_batch(out_schema)
            return
        build_batch = build.to_batches()[0]
        for probe in self.right.execute(partition, ctx):
            if probe.num_rows == 0:
                continue
            npr = probe.num_rows
            bi = np.repeat(np.arange(nb, dtype=np.int64), npr)
            pi = np.tile(np.arange(npr, dtype=np.int64), nb)
            produced = True
            yield _emit_pairs(build_batch, bi, probe, pi, out_schema)
        if not produced:
            yield _empty_batch(out_schema)


# ---------------------------------------------------------------------------
# sort / limit / exchange
# ---------------------------------------------------------------------------


def _sort_table(tbl: pa.Table, df_schema: DFSchema, keys: list[SortKey]) -> pa.Table:
    if tbl.num_rows == 0:
        return tbl
    sort_cols = []
    aux = {}
    batch = tbl.combine_chunks().to_batches()[0]
    for i, k in enumerate(keys):
        pe = bind_expr(k.expr, df_schema)
        arr = evaluate_to_array(pe, batch)
        if arr.null_count:
            # null placement without the SortOptions kwarg: pyarrow ≥25
            # deprecates the global null_placement (the FutureWarning that
            # flooded the multichip dryrun tail) and older releases have no
            # per-key form — a leading is-null flag column expresses the
            # same order on every version, and honors nulls_first PER KEY
            # instead of only key 0's setting
            aux[f"__n{i}"] = pc.is_null(arr)
            sort_cols.append((f"__n{i}", "descending" if k.nulls_first else "ascending"))
        aux[f"__s{i}"] = arr
        sort_cols.append((f"__s{i}", "ascending" if k.ascending else "descending"))
    aux_tbl = pa.table(aux)
    idx = pc.sort_indices(aux_tbl, sort_keys=sort_cols)
    return tbl.take(idx)


class WindowExec(ExecutionPlan):
    """Computes window expressions, appending __win{i} columns.

    Contract: rows sharing a window PARTITION BY key never span physical
    partitions (the planner hash-repartitions on those keys, or coalesces
    to one partition when there are none), so partitions are independent.
    """

    def __init__(self, input: ExecutionPlan, window_exprs: list, df_schema: DFSchema):
        super().__init__(df_schema)
        self.input = input
        self.window_exprs = window_exprs

    def children(self):
        return [self.input]

    def with_children(self, c):
        return WindowExec(c[0], self.window_exprs, self.df_schema)

    def output_partition_count(self) -> int:
        return self.input.output_partition_count()

    def node_str(self) -> str:
        return f"WindowExec: [{', '.join(map(str, self.window_exprs))}]"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        from ballista_tpu_torch.ops.cpu.window import compute_windows

        batches = [b for b in self.input.execute(partition, ctx) if b.num_rows]
        if not batches:
            yield _empty_batch(self.schema())
            return
        tbl = _concat(batches, self.input.schema())
        batch = tbl.combine_chunks().to_batches()[0] if tbl.num_rows else None
        if batch is None:
            yield _empty_batch(self.schema())
            return
        wins = compute_windows(batch, self.window_exprs, self.input.df_schema)
        arrays = [batch.column(i) for i in range(batch.num_columns)] + wins
        out = pa.RecordBatch.from_arrays(arrays, schema=self.schema())
        n = out.num_rows
        for off in range(0, n, ctx.batch_size):
            yield out.slice(off, min(ctx.batch_size, n - off))


class SortExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, keys: list[SortKey], fetch: Optional[int] = None):
        super().__init__(input.df_schema)
        self.input = input
        self.keys = keys
        self.fetch = fetch

    def children(self):
        return [self.input]

    def with_children(self, c):
        return SortExec(c[0], self.keys, self.fetch)

    def node_str(self) -> str:
        k = ", ".join(str(x) for x in self.keys)
        f = f", fetch={self.fetch}" if self.fetch is not None else ""
        return f"SortExec: [{k}]{f}"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        batches = [b for b in self.input.execute(partition, ctx) if b.num_rows]
        tbl = _concat(batches, self.schema())
        tbl = _sort_table(tbl, self.df_schema, self.keys)
        if self.fetch is not None:
            tbl = tbl.slice(0, self.fetch)
        if tbl.num_rows == 0:
            yield _empty_batch(self.schema())
            return
        for b in tbl.combine_chunks().to_batches(max_chunksize=ctx.batch_size):
            yield b


class SortPreservingMergeExec(ExecutionPlan):
    """N sorted partitions → 1 sorted partition. Implemented as gather +
    re-sort: simpler than a streaming k-way merge and equivalent because
    every input partition is already fully materialized by SortExec."""

    def __init__(self, input: ExecutionPlan, keys: list[SortKey], fetch: Optional[int] = None):
        super().__init__(input.df_schema)
        self.input = input
        self.keys = keys
        self.fetch = fetch

    def children(self):
        return [self.input]

    def with_children(self, c):
        return SortPreservingMergeExec(c[0], self.keys, self.fetch)

    def output_partition_count(self) -> int:
        return 1

    def node_str(self) -> str:
        return f"SortPreservingMergeExec: [{', '.join(str(k) for k in self.keys)}]"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        batches = []
        for p in range(self.input.output_partition_count()):
            batches.extend(b for b in self.input.execute(p, ctx) if b.num_rows)
        tbl = _sort_table(_concat(batches, self.schema()), self.df_schema, self.keys)
        if self.fetch is not None:
            tbl = tbl.slice(0, self.fetch)
        if tbl.num_rows == 0:
            yield _empty_batch(self.schema())
            return
        for b in tbl.combine_chunks().to_batches(max_chunksize=ctx.batch_size):
            yield b


class CoalescePartitionsExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan):
        super().__init__(input.df_schema)
        self.input = input

    def children(self):
        return [self.input]

    def with_children(self, c):
        return CoalescePartitionsExec(c[0])

    def output_partition_count(self) -> int:
        return 1

    def execute(self, partition, ctx):
        return self._timed(self._run(ctx))

    def _run(self, ctx):
        for p in range(self.input.output_partition_count()):
            yield from self.input.execute(p, ctx)


class LocalLimitExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, fetch: int):
        super().__init__(input.df_schema)
        self.input = input
        self.fetch = fetch

    def children(self):
        return [self.input]

    def with_children(self, c):
        return LocalLimitExec(c[0], self.fetch)

    def node_str(self) -> str:
        return f"LocalLimitExec: fetch={self.fetch}"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        left = self.fetch
        for b in self.input.execute(partition, ctx):
            if left <= 0:
                return
            if b.num_rows > left:
                yield b.slice(0, left)
                return
            left -= b.num_rows
            yield b


class GlobalLimitExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, fetch: Optional[int], skip: int = 0):
        super().__init__(input.df_schema)
        self.input = input
        self.fetch = fetch
        self.skip = skip

    def children(self):
        return [self.input]

    def with_children(self, c):
        return GlobalLimitExec(c[0], self.fetch, self.skip)

    def output_partition_count(self) -> int:
        return 1

    def node_str(self) -> str:
        return f"GlobalLimitExec: fetch={self.fetch}, skip={self.skip}"

    def execute(self, partition, ctx):
        return self._timed(self._run(ctx))

    def _run(self, ctx):
        skip = self.skip
        left = self.fetch if self.fetch is not None else None
        assert self.input.output_partition_count() == 1
        for b in self.input.execute(0, ctx):
            if skip:
                if b.num_rows <= skip:
                    skip -= b.num_rows
                    continue
                b = b.slice(skip)
                skip = 0
            if left is None:
                yield b
                continue
            if left <= 0:
                return
            if b.num_rows > left:
                yield b.slice(0, left)
                return
            left -= b.num_rows
            yield b


class RepartitionExec(ExecutionPlan):
    """In-process exchange. scheme='hash' routes rows by the shared
    deterministic key hash (ops/hashing.py); 'round_robin' balances batches.
    The distributed planner replaces these with shuffle boundaries."""

    def __init__(self, input: ExecutionPlan, scheme: str, n: int, keys: list[Expr] | None = None):
        super().__init__(input.df_schema)
        self.input = input
        self.scheme = scheme
        self.n = n
        self.keys = keys or []
        self._cache: list[list[pa.RecordBatch]] | None = None
        self._lock = threading.Lock()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return RepartitionExec(c[0], self.scheme, self.n, self.keys)

    def output_partition_count(self) -> int:
        return self.n

    def node_str(self) -> str:
        k = f"({', '.join(str(e) for e in self.keys)})" if self.keys else ""
        return f"RepartitionExec: {self.scheme}{k}, n={self.n}"

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _materialize(self, ctx) -> list[list[pa.RecordBatch]]:
        with self._lock:
            if self._cache is not None:
                return self._cache
            outs: list[list[pa.RecordBatch]] = [[] for _ in range(self.n)]
            bound = [bind_expr(k, self.input.df_schema) for k in self.keys]
            rr = 0
            for p in range(self.input.output_partition_count()):
                for b in self.input.execute(p, ctx):
                    if b.num_rows == 0:
                        continue
                    if self.scheme == "round_robin":
                        outs[rr % self.n].append(b)
                        rr += 1
                    else:
                        from ballista_tpu_torch.ops.hashing import split_batch_by_partition

                        key_arrays = [evaluate_to_array(k, b) for k in bound]
                        for k, part in split_batch_by_partition(b, key_arrays, self.n):
                            outs[k].append(part)
            self._cache = outs
            return outs

    def _run(self, partition, ctx):
        outs = self._materialize(ctx)
        batches = outs[partition]
        if not batches:
            yield _empty_batch(self.schema())
            return
        yield from batches


class UnionExec(ExecutionPlan):
    def __init__(self, inputs: list[ExecutionPlan], df_schema: DFSchema):
        super().__init__(df_schema)
        self.inputs = inputs

    def children(self):
        return list(self.inputs)

    def with_children(self, c):
        return UnionExec(c, self.df_schema)

    def output_partition_count(self) -> int:
        return sum(c.output_partition_count() for c in self.inputs)

    def execute(self, partition, ctx):
        off = partition
        for c in self.inputs:
            n = c.output_partition_count()
            if off < n:
                schema = self.schema()
                return self._timed(
                    (_align_batch(b, schema) for b in c.execute(off, ctx))
                )
            off -= n
        raise ExecutionError("bad union partition")
