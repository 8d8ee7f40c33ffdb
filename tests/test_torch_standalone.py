"""The port's distributed standalone mode on the CPU.

`SessionContext.standalone()` runs an in-process scheduler and executors:
the plan splits into stages at its shuffle boundaries, every partition is
one task, each executor hands its stage to the port's CUDA engine (here
after runtime.use_cpu(), so every kernel wrapper takes its plain form), and
the stages exchange Arrow IPC shuffle files, read locally or over the
in-process Flight server. Held here against the port's own local mode on
TPC-H SF0.01 (the session's `tpch_dir`, 2 files per table).
"""

import sys
import threading

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan, tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
QUERIES = [1, 3, 4, 5, 6, 12, 13, 21]


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _ctx(tpch_dir, standalone=True, num_executors=1, vcores=4, **extra):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    cfg = BallistaConfig({**BASE_CFG, **extra})
    ctx = (SessionContext.standalone(cfg, num_executors=num_executors, vcores=vcores)
           if standalone else SessionContext(cfg))
    register_tpch(ctx, tpch_dir)
    return ctx


def assert_same_answer(got: pa.Table, want: pa.Table) -> None:
    """PERF.md §2's rule: integers, dates and strings exact, aggregated
    floats within rtol 1e-9, rows in order."""
    assert got.schema.equals(want.schema)
    assert got.num_rows == want.num_rows
    for name, f in zip(want.column_names, want.schema):
        a = got.column(name).combine_chunks()
        b = want.column(name).combine_chunks()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(a.to_numpy(zero_copy_only=False),
                                       b.to_numpy(zero_copy_only=False),
                                       rtol=1e-9, atol=0.0, equal_nan=True)
        else:
            assert a.equals(b), name


@pytest.fixture(scope="module")
def cluster(tpch_dir):
    ctx = _ctx(tpch_dir)
    yield ctx
    ctx.shutdown()


@pytest.fixture(scope="module")
def runs(cluster, tpch_dir):
    """Each query once through the standalone cluster: (answer, per-stage
    stats), and the port's local answer beside it."""
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    local = _ctx(tpch_dir, standalone=False)
    out = {}
    for q in QUERIES:
        got = cluster.sql(tpch_query(q)).collect()
        stats = stage_stats(last_job(cluster._cluster.scheduler))
        out[q] = (got, stats, local.sql(tpch_query(q)).collect())
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_standalone_equals_local(q, runs):
    got, _stats, want = runs[q]
    assert want.num_rows > 0
    assert_same_answer(got, want)


@pytest.mark.parametrize("q", QUERIES)
def test_device_stages_one_pass_per_task_without_fallback(q, runs):
    # every device node of every stage ran on the device path in each of
    # its stage's tasks: one whole-stage pass per task (the reference's
    # design: max_partitions_per_task = 1, each task prepares its stage),
    # and no CPU fallback summed over the tasks
    _got, stats, _want = runs[q]
    device = {sid: s for sid, s in stats.items() if s["device"]}
    assert any("TpuStageExec" in s["device"] for s in device.values())
    for sid, s in device.items():
        assert s["fallbacks"] == 0, (sid, s)
        for kind, (nodes, passes, _fb) in s["device"].items():
            assert nodes == s["tasks"], (sid, kind, s)
            assert passes == s["tasks"], (sid, kind, s)
        assert s["shuffle_bytes_written"] > 0


def test_q3_every_shuffle_read_over_flight(tpch_dir, runs):
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    ctx = _ctx(tpch_dir, num_executors=2,
               **{"ballista.shuffle.reader.force_remote_read": True})
    try:
        srv = ctx._ensure_cluster().flight_server
        before = dict(srv.stats)
        got = ctx.sql(tpch_query(3)).collect()
        stats = stage_stats(last_job(ctx._cluster.scheduler))
        served = {k: srv.stats[k] - before[k] for k in before}
    finally:
        ctx.shutdown()
    assert_same_answer(got, runs[3][2])
    readers = [s for s in stats.values() if s["fetch_rpcs"]]
    assert readers
    assert sum(s["bytes_read_local"] for s in stats.values()) == 0
    assert sum(s["bytes_fetched_remote"] for s in stats.values()) > 0
    assert served["bytes_served"] > 0
    assert served["do_get"] + served["coalesced_rpc"] + served["block_rpc"] > 0


@pytest.mark.parametrize("q", [1, 3, 5])
def test_four_vcores_equal_one_bit_for_bit(q, tpch_dir):
    # four tasks of a stage run at once, each a whole-stage pass on one
    # device, with the table fill, the join builds and the LUTs shared
    parts = {"ballista.shuffle.partitions": 4}
    answers = []
    for vcores in (4, 1):
        from ballista_tpu_torch.ops.cuda.stage_compiler import clear_device_caches

        clear_device_caches()
        ctx = _ctx(tpch_dir, vcores=vcores, **parts)
        try:
            answers.append(ctx.sql(tpch_query(q)).collect())
        finally:
            ctx.shutdown()
    assert answers[0].equals(answers[1])


@pytest.mark.parametrize("shape", ["one_stage_four_threads", "four_stages_four_threads"])
def test_concurrent_passes_of_one_prepared_stage(shape, tpch_dir):
    # a prepared device stage run by four threads at once (one instance
    # serving its partitions, or one instance per thread as four tasks of
    # a stage are) gives the serial result; every cache starts cold so the
    # fills, builds and LUTs race
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec, clear_device_caches
    from ballista_tpu_torch.plan.physical import TaskContext

    ctx = _ctx(tpch_dir, standalone=False)
    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(tpch_query(5)).plan), ctx.config)
    stage = next(n for n in iter_plan(phys) if isinstance(n, TpuStageExec))
    parts = list(range(stage.output_partition_count()))
    tctx = TaskContext(ctx.config)

    def fresh():
        return stage.with_children([stage.scan])

    def run_all(s, ps):
        return {p: pa.Table.from_batches(list(s.execute(p, tctx)), schema=s.schema())
                for p in ps}

    serial = run_all(fresh(), parts)
    clear_device_caches()
    results, errors = [], []
    barrier = threading.Barrier(4)
    shared = fresh()

    def worker(i):
        try:
            barrier.wait(timeout=30)
            if shape == "one_stage_four_threads":
                results.append(run_all(shared, [p for p in parts if p % 4 == i]))
            else:
                results.append(run_all(fresh(), parts))
        except BaseException as e:  # noqa: BLE001 — re-raised by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 4
    seen = {}
    for r in results:
        for p, tbl in r.items():
            assert tbl.equals(serial[p]), p
            seen[p] = True
    assert sorted(seen) == parts
    if shape == "one_stage_four_threads":
        assert shared.tpu_count == 1 and shared.fallback_count == 0


def test_device_routed_shuffle_files_follow_host_hashing(tpch_dir):
    # q3's partial aggregate groups on l_orderkey, o_orderdate and
    # o_shippriority under a writer that hash-partitions on them: the stage
    # emits its __pid on the device, and every row it wrote lies in the
    # bucket ops/hashing gives its key
    from ballista_tpu_torch.executor.executor import ExecutionEngine
    from ballista_tpu_torch.executor.standalone import StandaloneCluster
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.ops.hashing import partition_indices
    from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
    from ballista_tpu_torch.plan.physical import TaskContext
    from ballista_tpu_torch.shuffle.reader import fetch_partition
    from ballista_tpu_torch.testing.standalone_stats import last_job

    prepared, lock = [], threading.Lock()

    class Recording(ExecutionEngine):
        def create_query_stage_exec(self, plan, config, stage_attempt=0):
            out = super().create_query_stage_exec(plan, config, stage_attempt)
            with lock:
                prepared.append(out)
            return out

    ctx = _ctx(tpch_dir)
    ctx._cluster = StandaloneCluster(1, 4, config=ctx.config, engine_factory=Recording)
    try:
        ctx.sql(tpch_query(3)).collect()
        graph = last_job(ctx._cluster.scheduler)
        routed = [w for w in prepared if isinstance(w.input, TpuStageExec)
                  and w.input.emit_pid is not None]
        assert routed and all(w.input.pid_emitted > 0 for w in routed)
        sid = routed[0].stage_id
        writer = graph.stages[sid].spec.plan
        keys = [bind_expr(k, writer.input.df_schema) for k in writer.keys]
        k = writer.output_partitions
        rows = 0
        tctx = TaskContext(ctx.config)
        for locs in graph.stages[sid].completed.values():
            for loc in locs:
                for b in fetch_partition(loc, tctx):
                    if not b.num_rows:
                        continue
                    pids = partition_indices([evaluate_to_array(e, b) for e in keys], k)
                    assert (pids == loc.output_partition).all()
                    rows += b.num_rows
        assert rows > 0
    finally:
        ctx.shutdown()


def test_mesh_refused_at_planning(tpch_dir):
    # the mesh exchange is not ported (ROADMAP A6): the planner raises
    # rather than demoting the exchange to somewhere other than the card
    from ballista_tpu_torch.errors import ExecutionError, PlanningError
    from ballista_tpu_torch.scheduler.planner import DistributedPlanner, merge_mesh_stages

    mesh = {"ballista.tpu.mesh.enabled": True}
    local = _ctx(tpch_dir, standalone=False, **mesh)
    stages = DistributedPlanner("job").plan_query_stages(
        local.create_physical_plan(local.sql(tpch_query(3)).plan))
    with pytest.raises(PlanningError, match="ROADMAP A6"):
        merge_mesh_stages(stages, local.config)
    off = _ctx(tpch_dir, standalone=False).config
    assert merge_mesh_stages(stages, off) is stages
    ctx = _ctx(tpch_dir, **mesh)
    try:
        with pytest.raises(ExecutionError, match="mesh exchange is not ported"):
            ctx.sql(tpch_query(3)).collect()
    finally:
        ctx.shutdown()


def test_modes_not_ported_raise(tpch_dir):
    # appends and prepared statements go through the scheduler in the
    # standalone mode and answer as local mode does; the appended table is
    # one of this test's own, so the module's other queries see no delta
    import os

    rows = pa.table({"n_nationkey": [99], "n_name": ["ATLANTIS"], "n_regionkey": [0],
                     "n_comment": ["appended"]})
    sql = "select n_regionkey, count(*) c from nation_a9 group by n_regionkey order by n_regionkey"
    stmt = "select n_name from nation_a9 where n_nationkey = 1"
    answers = []
    for standalone in (True, False):
        ctx = _ctx(tpch_dir, standalone=standalone)
        try:
            ctx.register_parquet("nation_a9", os.path.join(tpch_dir, "nation"))
            out = ctx.append("nation_a9", rows)
            assert out["table"] == "nation_a9" and out["rows"] == 1
            ps = ctx.prepare(stmt)
            assert ps.num_params == 1
            answers.append((ctx.sql(sql).collect(), ps.execute([99]), ps.execute([2])))
            ps.close()
        finally:
            ctx.shutdown()
    for got, want in zip(*answers):
        assert got.equals(want)
    assert answers[0][0].column("c").to_pylist()[0] == 6
    assert answers[0][1].column("n_name").to_pylist() == ["ATLANTIS"]


def test_device_error_fails_the_job(tpch_dir, monkeypatch):
    # a failed kernel launch in a task fails the task, the scheduler fails
    # the job, and collect() raises: nothing reruns the stage on the CPU
    from ballista_tpu_torch.errors import ExecutionError
    from ballista_tpu_torch.ops.cuda import cuda_kernels
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    def failed_launch(vals, gid, mask, num_groups):
        raise RuntimeError("masked_group_reduce launch failed: CUDA error 719")

    monkeypatch.setattr(cuda_kernels, "masked_group_reduce", failed_launch)
    ctx = _ctx(tpch_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
    try:
        with pytest.raises(ExecutionError, match="launch failed"):
            ctx.sql(tpch_query(4)).collect()
        graph = last_job(ctx._cluster.scheduler)
        assert sum(st.task_failures for st in graph.stages.values()) >= 1
        assert all(s["fallbacks"] == 0 for s in stage_stats(graph).values())
    finally:
        ctx.shutdown()


def test_distributed_explain_analyze_shows_device_stages(cluster):
    out = cluster.sql("EXPLAIN ANALYZE " + tpch_query(6)).collect()
    kinds = out.column("plan_type").to_pylist()
    assert "analyzed_plan (distributed)" in kinds
    text = out.column("plan").to_pylist()[kinds.index("analyzed_plan (distributed)")]
    assert "TpuStageExec" in text and "device_runs=1 cpu_fallbacks=0" in text


def test_stage_verifiers_pass_on_port_plans(tpch_dir):
    # the ported plan_check verifiers, run at submit time under
    # ballista.debug.plan.verify, hold on every query's stages
    from ballista_tpu_torch.analysis.plan_check import check_stages, verify_stages
    from ballista_tpu_torch.scheduler.planner import DistributedPlanner

    local = _ctx(tpch_dir, standalone=False)
    for q in QUERIES:
        stages = DistributedPlanner(f"job{q}").plan_query_stages(
            local.create_physical_plan(local.sql(tpch_query(q)).plan))
        assert verify_stages(stages) == []
        check_stages(stages)
    ctx = _ctx(tpch_dir, **{"ballista.debug.plan.verify": True})
    try:
        assert ctx.sql(tpch_query(3)).collect().num_rows > 0
    finally:
        ctx.shutdown()


def test_cpu_engine_tasks_in_worker_processes(tpch_dir):
    # engine=cpu sessions may isolate each task in a spawned worker; the
    # worker runs the port's CPU engine (device stages always stay in-thread)
    ctx = _ctx(tpch_dir, **{"ballista.executor.engine": "cpu",
                            "ballista.executor.task.isolation": "process"})
    try:
        got = ctx.sql(tpch_query(6)).collect()
    finally:
        ctx.shutdown()
    want = _ctx(tpch_dir, standalone=False,
                **{"ballista.executor.engine": "cpu"}).sql(tpch_query(6)).collect()
    assert_same_answer(got, want)
