"""Session context + DataFrame front end.

The reference's client surface (ballista/client/src/extension.rs) with SQL
and DataFrame entry points. Modes here:

- "local":      plan and execute in this process (DataFusion-alone analog).
- "standalone": `SessionContext.standalone()`: an in-process scheduler and
                executors over the real task/shuffle machinery (reference:
                standalone.rs). The scheduler splits the plan into stages at
                its shuffle boundaries and ships one task per partition;
                with `ballista.executor.engine=tpu` each executor hands its
                stage to the CUDA engine (engine/cuda_engine.py). Stages
                exchange Arrow IPC shuffle files, read locally or over the
                in-process Flight server, and the client fetches the final
                stage's partitions. On a machine without a card, call
                `ops.cuda.runtime.use_cpu()` first.
- "remote":     `SessionContext.remote("host:50050")`: gRPC to an external
                scheduler daemon (`python -m ballista_tpu_torch.scheduler`)
                whose executor daemons (`python -m ballista_tpu_torch.executor
                --engine tpu --device-ordinal k`, one per card) run the
                stages; results are fetched over Flight from the executors
                or through the scheduler's result proxy.

Prepared statements, continuous queries and appends through the scheduler
are not ported yet (ROADMAP A9): `prepare` and `append` raise in the
standalone and remote modes.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import Any, Optional

import pyarrow as pa

from ballista_tpu_torch.config import BallistaConfig, EXECUTOR_ENGINE
from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.ids import SessionId, new_session_id
from ballista_tpu_torch.plan.logical import Explain, LogicalPlan
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext
from ballista_tpu_torch.plan.provider import Catalog, MemoryTable, ParquetTable, TableProvider
from ballista_tpu_torch.sql.ast import (
    CreateExternalTable,
    DropTable,
    ShowColumns,
    ExplainStmt,
    SelectStmt,
    SetVariable,
    ShowTables,
)
from ballista_tpu_torch.sql.optimizer import optimize
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import SqlPlanner


class SessionContext:
    def __init__(self, config: BallistaConfig | None = None, mode: str = "local",
                 num_executors: int = 1, vcores: int = 4, scheduler_url: str = ""):
        self.config = config or BallistaConfig()
        self.mode = mode
        self.catalog = Catalog()
        self.session_id: SessionId = new_session_id()
        self._cluster = None  # StandaloneCluster (standalone mode)
        self._remote = None  # RemoteSchedulerClient (remote mode)
        self._num_executors = num_executors
        self._vcores = vcores
        self._scheduler_url = scheduler_url

    @classmethod
    def standalone(cls, config: BallistaConfig | None = None, num_executors: int = 1,
                   vcores: int = 4) -> "SessionContext":
        """In-process scheduler + executors over the real task/shuffle
        machinery (reference: SessionContextExt::standalone(),
        client/src/extension.rs:146)."""
        return cls(config, mode="standalone", num_executors=num_executors, vcores=vcores)

    @classmethod
    def remote(cls, scheduler_url: str, config: BallistaConfig | None = None) -> "SessionContext":
        """Connect to an external scheduler over gRPC
        (reference: SessionContextExt::remote())."""
        return cls(config, mode="remote", scheduler_url=scheduler_url)

    def _ensure_cluster(self):
        if self._cluster is None:
            from ballista_tpu_torch.executor.standalone import StandaloneCluster

            self._cluster = StandaloneCluster(self._num_executors, self._vcores, config=self.config)
        return self._cluster

    def _ensure_remote(self):
        if self._remote is None:
            from ballista_tpu_torch.client.remote import RemoteSchedulerClient

            self._remote = RemoteSchedulerClient(self._scheduler_url, self.config)
        return self._remote

    def shutdown(self) -> None:
        if self._cluster is not None:
            self._cluster.shutdown()
            self._cluster = None

    # -- registration -------------------------------------------------------

    def register_table(self, name: str, provider: TableProvider) -> None:
        self.catalog.register(name, provider)
        if isinstance(provider, ParquetTable):
            # ship the registration with the session so remote planning sees it
            self.config.set(f"ballista.catalog.table.{name.lower()}", provider.path)

    def _has_memory_tables(self) -> bool:
        from ballista_tpu_torch.plan.provider import MemoryTable

        return any(isinstance(p, MemoryTable) for p in self.catalog.tables.values())

    def register_udf(self, name: str, fn, return_type) -> None:
        """Register a scalar UDF for this session (BallistaFunctionRegistry
        analog). Local execution resolves it immediately; for remote
        clusters the defining module is recorded in the session config and
        imported by executors (functions ship by reference, like the
        reference's code-registered function sets)."""
        from ballista_tpu_torch import udf

        u = udf.register_udf(name, fn, return_type)
        if u.module:
            existing = self.config.get(udf.UDF_MODULES) or ""
            mods = [m for m in existing.split(",") if m]
            if u.module not in mods:
                mods.append(u.module)
                self.config.set(udf.UDF_MODULES, ",".join(mods))

    def register_parquet(self, name: str, path: str) -> None:
        self.catalog.register(name, ParquetTable(path))
        # ship the registration with the session so remote planning sees it
        self.config.set(f"ballista.catalog.table.{name.lower()}", path)

    def register_record_batches(self, name: str, batches: list[pa.RecordBatch]) -> None:
        self.catalog.register(name, MemoryTable(batches))

    def register_arrow_table(self, name: str, table: pa.Table, partitions: int = 1) -> None:
        self.catalog.register(name, MemoryTable.from_table(table, partitions))

    def deregister_table(self, name: str) -> None:
        self.catalog.deregister(name)

    # -- append ingestion ----------------------------------------------------

    def append(self, table: str, data) -> dict:
        """Append rows to a registered table without rewriting its files.

        Bumps the table's version: cached results over the table either
        maintain incrementally from the retained delta or recompute
        (docs/streaming.md). `data` is a pa.Table, RecordBatch, or list of
        batches; columns match the table schema by name and are cast to its
        types. Returns {"table", "version", "rows"}.
        """
        if self.mode != "local":
            raise NotImplementedError(
                "append through the scheduler is not ported to ballista_tpu_torch "
                "yet (ROADMAP A9); append in local mode")
        name = table.lower()
        provider = self.catalog.get(name)
        schema = provider.arrow_schema() if provider is not None else None
        batches = conform_append_batches(data, schema)
        rows = sum(b.num_rows for b in batches)
        # local mode: overlay the registered provider in place; the planner
        # unions the base scan with the overlay (AppendedTable)
        if provider is None:
            raise PlanningError(f"table not found: {table}")
        from ballista_tpu_torch.plan.provider import AppendedTable

        if not isinstance(provider, AppendedTable):
            provider = AppendedTable(provider)
            self.catalog.register(name, provider)
        version = provider.append(batches)
        return {"table": name, "version": version, "rows": rows}

    # -- SQL ---------------------------------------------------------------

    def sql(self, query: str) -> "DataFrame":
        stmt = parse_sql(query)
        if isinstance(stmt, CreateExternalTable):
            self.register_parquet(stmt.name, stmt.location)
            return DataFrame._empty(self, f"created table {stmt.name}")
        if isinstance(stmt, DropTable):
            self.deregister_table(stmt.name)
            return DataFrame._empty(self, f"dropped table {stmt.name}")
        if isinstance(stmt, ShowColumns):
            provider = self.catalog.get(stmt.table)
            if provider is None:
                raise PlanningError(f"table not found: {stmt.table}")
            from ballista_tpu_torch.plan.logical import TableScan
            from ballista_tpu_torch.plan.provider import MemoryTable as MT

            sch = provider.df_schema()
            tbl = pa.table({
                "column_name": pa.array([f.name for f in sch]),
                "data_type": pa.array([str(f.dtype) for f in sch]),
                "is_nullable": pa.array(["YES" if f.nullable else "NO" for f in sch]),
            })
            return DataFrame(self, TableScan("columns", MT.from_table(tbl)))
        if isinstance(stmt, ShowTables):
            tbl = pa.table({"table_name": pa.array(self.catalog.names())})
            from ballista_tpu_torch.plan.logical import TableScan
            from ballista_tpu_torch.plan.provider import MemoryTable as MT

            return DataFrame(self, TableScan("tables", MT.from_table(tbl)))
        if isinstance(stmt, SetVariable):
            self.config.set(stmt.key, stmt.value)
            return DataFrame._empty(self, f"set {stmt.key}")
        if isinstance(stmt, ExplainStmt):
            inner = SqlPlanner(self.catalog).plan_query(stmt.inner)
            return DataFrame(self, Explain(inner, stmt.analyze, stmt.verbose))
        if isinstance(stmt, SelectStmt):
            plan = SqlPlanner(self.catalog).plan_query(stmt)
            return DataFrame(self, plan, sql_text=query)
        raise PlanningError(f"unsupported statement {type(stmt).__name__}")

    def prepare(self, query: str):
        """Prepared statements (the serving tier's surface) are not ported
        yet (ROADMAP A9)."""
        raise NotImplementedError(
            "prepared statements are not ported to ballista_tpu_torch yet (ROADMAP A9)")

    def table(self, name: str) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import TableScan

        provider = self.catalog.get(name)
        if provider is None:
            raise PlanningError(f"table not found: {name}")
        return DataFrame(self, TableScan(name, provider))

    # -- planning / execution ----------------------------------------------

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        return optimize(plan)

    def create_physical_plan(self, plan: LogicalPlan) -> ExecutionPlan:
        from ballista_tpu_torch.engine.physical_planner import PhysicalPlanner

        optimized = optimize(plan)
        return PhysicalPlanner(self.config).plan(optimized)

    def execute_collect(self, physical: ExecutionPlan) -> pa.Table:
        engine_name = str(self.config.get(EXECUTOR_ENGINE))
        if engine_name == "tpu":
            from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

            physical = maybe_compile_tpu(physical, self.config)
        ctx = TaskContext(self.config)
        n = physical.output_partition_count()
        batches: list[pa.RecordBatch] = []
        if n == 1:
            batches.extend(physical.execute(0, ctx))
        else:
            with _fut.ThreadPoolExecutor(max_workers=min(n, 16)) as pool:
                futs = [pool.submit(lambda p=p: list(physical.execute(p, ctx))) for p in range(n)]
                for f in futs:
                    batches.extend(f.result())
        batches = [b for b in batches if b.num_rows]
        schema = physical.schema()
        if not batches:
            return pa.table({f.name: pa.array([], f.type) for f in schema}, schema=schema)
        return pa.Table.from_batches(batches, schema=schema)


class DataFrame:
    """Lazy logical-plan wrapper (reference: DataFusion DataFrame surface
    re-exported through ballista's prelude)."""

    def __init__(self, ctx: SessionContext, plan: LogicalPlan, sql_text: str | None = None):
        self.ctx = ctx
        self.plan = plan
        self.sql_text = sql_text

    @classmethod
    def _empty(cls, ctx: SessionContext, note: str) -> "DataFrame":
        tbl = pa.table({"result": pa.array([note])})
        from ballista_tpu_torch.plan.logical import TableScan
        from ballista_tpu_torch.plan.provider import MemoryTable as MT

        return cls(ctx, TableScan("result", MT.from_table(tbl)))

    # -- transformations ----------------------------------------------------

    def select(self, *exprs) -> "DataFrame":
        from ballista_tpu_torch.plan.expressions import col as _col
        from ballista_tpu_torch.plan.logical import Projection

        es = [(_col(e) if isinstance(e, str) else e) for e in exprs]
        return DataFrame(self.ctx, Projection(self.plan, es))

    def filter(self, predicate) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Filter as F

        return DataFrame(self.ctx, F(self.plan, predicate))

    def aggregate(self, group_exprs, agg_exprs) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Aggregate as A

        return DataFrame(self.ctx, A(self.plan, list(group_exprs), list(agg_exprs)))

    def sort(self, *keys) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Sort as S

        return DataFrame(self.ctx, S(self.plan, list(keys)))

    def limit(self, fetch: int, skip: int = 0) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Limit as L

        return DataFrame(self.ctx, L(self.plan, fetch, skip))

    def join(self, other: "DataFrame", on: list, how: str = "inner") -> "DataFrame":
        from ballista_tpu_torch.plan.expressions import col as _col
        from ballista_tpu_torch.plan.logical import Join as J

        pairs = []
        for item in on:
            if isinstance(item, str):
                pairs.append((_col(item), _col(item)))
            else:
                l, r = item
                pairs.append((_col(l) if isinstance(l, str) else l, _col(r) if isinstance(r, str) else r))
        return DataFrame(self.ctx, J(self.plan, other.plan, pairs, how))

    # -- actions ------------------------------------------------------------

    def logical_plan(self) -> LogicalPlan:
        return self.plan

    def optimized_plan(self) -> LogicalPlan:
        return self.ctx.optimize(self.plan)

    def explain_text(self) -> str:
        logical = self.ctx.optimize(self.plan)
        physical = self.ctx.create_physical_plan(self.plan)
        return f"logical plan:\n{logical.display()}\nphysical plan:\n{physical.display()}"

    def collect(self) -> pa.Table:
        if isinstance(self.plan, Explain):
            return self._collect_explain()
        if self.ctx.mode == "standalone":
            return self._collect_standalone()
        if self.ctx.mode == "remote":
            return self.ctx._ensure_remote().collect(self)
        physical = self.ctx.create_physical_plan(self.plan)
        return self.ctx.execute_collect(physical)

    def _collect_standalone(self) -> pa.Table:
        """Submit through the in-process scheduler: real stages, real
        shuffle files, results fetched from the final stage's partitions
        (the DistributedQueryExec flow, distributed_query.rs:211)."""
        from ballista_tpu_torch.errors import ExecutionError

        cluster = self.ctx._ensure_cluster()
        scheduler = cluster.scheduler
        session_id = scheduler.sessions.create_or_update(
            self.ctx.config.to_key_value_pairs(), str(self.ctx.session_id)
        )
        if self.sql_text is not None and not self.ctx._has_memory_tables():
            # inline_results: this process can accept a result table right
            # in the status dict (serving-tier result-cache hits)
            job_id = scheduler.submit_sql(self.sql_text, session_id, inline_results=True)
        else:
            # in-memory tables can't be re-resolved from SQL on the
            # scheduler: plan CLIENT-side and submit the physical plan
            # (MemoryScanNode ships the batches as IPC bytes) — the
            # reference's BallistaQueryPlanner flow
            physical = self.ctx.create_physical_plan(self.plan)
            job_id = scheduler.submit_physical_plan(physical, session_id)
        from ballista_tpu_torch.config import CLIENT_JOB_TIMEOUT_S

        status = scheduler.wait_for_job(
            job_id, timeout=float(self.ctx.config.get(CLIENT_JOB_TIMEOUT_S)))
        if status["state"] != "successful":
            raise ExecutionError(f"job {job_id} {status['state']}: {status.get('error', '')}")
        return fetch_job_results(status, self.ctx.config)

    def _collect_explain(self) -> pa.Table:
        assert isinstance(self.plan, Explain)
        logical = self.ctx.optimize(self.plan.input)
        physical = self.ctx.create_physical_plan(self.plan.input)
        types = ["logical_plan", "physical_plan"]
        plans = [logical.display(), physical.display()]
        if self.plan.analyze and self.ctx.mode == "standalone":
            # distributed EXPLAIN ANALYZE: run the job through the cluster,
            # then render per-stage operator metrics from the scheduler
            # (reference: DistributedExplainAnalyzeExec + GetJobMetrics)
            inner = DataFrame(self.ctx, self.plan.input)
            inner.collect()
            sched = self.ctx._cluster.scheduler
            with sched._jobs_lock:
                g = list(sched.jobs.values())[-1]
            lines = []
            for sid in sorted(g.stage_metrics):
                lines.append(f"stage {sid}:")
                for m in g.stage_metrics[sid][:100]:
                    lines.append(
                        f"  {'  ' * int(m.get('depth', 0))}{m.get('name', '')}: "
                        f"rows={m.get('output_rows', 0)} "
                        f"elapsed_ms={m.get('elapsed_ns', 0) / 1e6:.2f}"
                    )
            types.append("analyzed_plan (distributed)")
            plans.append("\n".join(lines))
        elif self.plan.analyze and self.ctx.mode == "remote":
            # remote EXPLAIN ANALYZE: submit the physical plan, then fetch
            # per-stage operator metrics over the GetJobMetrics rpc
            from ballista_tpu_torch.errors import ExecutionError

            client = self.ctx._ensure_remote()
            job_id = client.execute_physical(physical)
            status = client.wait_for_job(job_id)
            if status["state"] != "successful":
                raise ExecutionError(
                    f"job {job_id} {status['state']}: {status.get('error', '')}"
                )
            metrics = client.job_metrics(job_id)
            lines = []
            for sp in metrics.stages:
                lines.append(f"stage {sp.stage_id}:")
                for m in list(sp.metrics)[:100]:
                    lines.append(
                        f"  {'  ' * m.depth}{m.name}: rows={m.output_rows} "
                        f"elapsed_ms={m.elapsed_ns / 1e6:.2f}"
                    )
            types.append("analyzed_plan (distributed)")
            plans.append("\n".join(lines))
        elif self.plan.analyze:
            # compile FIRST so the analyzed tree is the executed tree —
            # execute_collect compiles a local copy, which would leave the
            # displayed plan with empty metrics (and hide the TPU stages)
            if str(self.ctx.config.get(EXECUTOR_ENGINE)) == "tpu":
                from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

                physical = maybe_compile_tpu(physical, self.ctx.config)
            self.ctx.execute_collect(physical)
            from ballista_tpu_torch.plan.physical import collect_metrics

            lines = []
            for depth, name, m in collect_metrics(physical):
                lines.append(f"{'  ' * depth}{name}: rows={m['output_rows']} elapsed_ms={m['elapsed_ns'] / 1e6:.2f}")
            types.append("analyzed_plan")
            plans.append("\n".join(lines))
        return pa.table({"plan_type": pa.array(types), "plan": pa.array(plans)})

    def to_pandas(self):
        return self.collect().to_pandas()

    def count(self) -> int:
        return self.collect().num_rows

    def show(self, n: int = 20) -> None:
        print(self.collect().slice(0, n).to_pandas().to_string())


def conform_append_batches(data, schema: pa.Schema | None) -> list[pa.RecordBatch]:
    """Normalize append input (Table / RecordBatch / list of batches) to
    record batches conforming to the table schema: columns match by NAME
    (not position) and cast to the declared types, so callers can append a
    column subset order-independently. Missing columns are an explicit
    error rather than a silent null fill — appends must be self-complete.
    With no schema (table unknown client-side) the rows ship as-is and the
    server-side scan alignment does the work."""
    if isinstance(data, pa.RecordBatch):
        tbl = pa.Table.from_batches([data])
    elif isinstance(data, pa.Table):
        tbl = data
    else:
        batches = list(data)
        if not batches:
            raise PlanningError("append needs at least one row batch")
        tbl = pa.Table.from_batches(batches)
    if schema is None:
        return tbl.combine_chunks().to_batches()
    cols = []
    for f in schema:
        idx = tbl.schema.get_field_index(f.name)
        if idx < 0:
            raise PlanningError(f"append is missing column {f.name!r}")
        cols.append(tbl.column(idx).cast(f.type))
    return pa.Table.from_arrays(cols, schema=schema).combine_chunks().to_batches()


def fetch_job_results(status: dict, config: BallistaConfig) -> pa.Table:
    """Fetch a successful job's final-stage partitions (local fast path or
    Flight) and assemble the client result table."""
    from ballista_tpu_torch.plan.physical import TaskContext
    from ballista_tpu_torch.shuffle.reader import fetch_partition

    from ballista_tpu_torch.config import FLIGHT_PROXY, SHUFFLE_READER_FORCE_REMOTE

    # serving-tier result-cache hit: the table rode back in the status
    # dict; nothing to fetch
    inline = status.get("inline_result")
    if inline is not None:
        return inline
    schema = status["schema"].to_arrow() if status.get("schema") is not None else None
    locs = sorted(status.get("partitions", []), key=lambda l: (l.output_partition, l.map_partition))
    ctx = TaskContext(config)
    # a configured Flight proxy implies executors are not client-reachable:
    # never take the same-path local shortcut (it only holds when the client
    # shares the executor's filesystem)
    force = bool(config.get(SHUFFLE_READER_FORCE_REMOTE)) or bool(config.get(FLIGHT_PROXY))
    batches = []
    for loc in locs:
        for b in fetch_partition(loc, ctx, force_remote=force):
            if b.num_rows:
                batches.append(b)
    if not batches:
        if schema is None:
            return pa.table({})
        return pa.table({f.name: pa.array([], f.type) for f in schema}, schema=schema)
    return pa.Table.from_batches(batches, schema=batches[0].schema)
