"""The port's mesh-wide stage against the JAX package's.

The reference runs its mesh on 8 virtual CPU devices
(`--xla_force_host_platform_device_count=8`, tests/conftest.py); the port
runs after `runtime.use_cpu(devices=8)`, its mesh 8 simulated CPU devices.
Held: the planner's merge, the serde and the graph's one-task handout, the
exchange node's buckets (device rung against the host split and against the
reference's device buckets), the demotion ladder, TPC-H through the
standalone mode with the mesh on, and C25 (a date column through the
exchange's codec)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from ballista_tpu_torch.config import (
    EXECUTOR_ENGINE,
    MAX_PARTITIONS_PER_TASK,
    TPU_MESH_ENABLED,
    TPU_MESH_EXCHANGE_CAPACITY,
    TPU_MESH_MIN_ROWS,
    TPU_MIN_ROWS,
    BallistaConfig,
)
from ballista_tpu_torch.ops.cuda import mesh_stage as tms
from ballista_tpu_torch.ops.cuda import runtime
from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec, contains_mesh_exchange
from ballista_tpu_torch.scheduler.planner import DistributedPlanner, merge_mesh_stages

from .conftest import iter_plan, tpch_query

N_DEVICES = 8


@pytest.fixture(scope="module", autouse=True)
def _eight_devices():
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu(devices=N_DEVICES)
    yield
    runtime.use_cpu(*prev)


# -- C25: the codec's temporal columns -------------------------------------------


TEMPORAL = [
    pa.array([0, 9000, None, -5], pa.date32()),
    pa.array([0, 86400000 * 3, None, 1], pa.date64()),
    pa.array([1, None, 3, -7], pa.timestamp("us")),
    pa.array([1, None, 3, -7], pa.timestamp("ns", tz="UTC")),
]


@pytest.mark.parametrize("col", TEMPORAL, ids=lambda c: str(c.type))
def test_codec_round_trips_temporal_columns(col):
    # a date32 column is carried through its int32 storage, date64 and
    # timestamps through their int64 storage; the decode rebuilds the type
    lanes, valid, meta = tms._encode_column(col)
    assert len(lanes) == 1 and lanes[0].dtype == np.int64
    assert (valid == np.asarray(col.is_valid())).all()
    want = np.asarray(col.cast(pa.int32() if pa.types.is_date32(col.type) else pa.int64())
                      .fill_null(0)).astype(np.int64)
    assert (lanes[0] == want).all()
    back = tms._decode_column(col.type, lanes, valid, meta)
    assert back.type == col.type
    assert back.equals(col)


# -- the port on 8 simulated devices -----------------------------------------------


def _mesh_cfg(**over) -> BallistaConfig:
    base = {EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0, TPU_MESH_ENABLED: True}
    base.update(over)
    return BallistaConfig(base)


def _port_ctx(tpch_dir, cfg=None):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(cfg)
    register_tpch(ctx, tpch_dir)
    return ctx


def _q_stages(ctx, q=1, job="jm"):
    physical = ctx.create_physical_plan(ctx.sql(tpch_query(q)).plan)
    return DistributedPlanner(job).plan_query_stages(physical)


@pytest.fixture(scope="module")
def port_ctx(tpch_dir):
    return _port_ctx(tpch_dir)


# -- planner merge ------------------------------------------------------------


def test_merge_requires_tpu_engine_and_flag(port_ctx):
    stages = _q_stages(port_ctx)
    # flag off → untouched
    same = merge_mesh_stages(list(stages), BallistaConfig({EXECUTOR_ENGINE: "tpu"}))
    assert len(same) == len(stages)
    # flag on but CPU engine → untouched (per-partition tasks gain nothing)
    same = merge_mesh_stages(list(stages), BallistaConfig({TPU_MESH_ENABLED: True}))
    assert len(same) == len(stages)
    assert not any(s.mesh for s in same)


def test_merge_fuses_single_consumer_hash_edge(port_ctx):
    from ballista_tpu_torch.scheduler.planner import _find_input_stages

    stages = _q_stages(port_ctx)
    producer_ids = {s.stage_id for s in stages if s.plan.sort_shuffle and s.plan.keys}
    assert producer_ids, "q1 should have a hash-exchange stage"
    merged = merge_mesh_stages(list(stages), _mesh_cfg())
    assert len(merged) < len(stages)
    merged_ids = {s.stage_id for s in merged}
    assert producer_ids - merged_ids, "a hash-exchange producer stage must be gone"
    mesh_stages = [s for s in merged if s.mesh]
    assert len(mesh_stages) == 1
    ms = mesh_stages[0]
    nodes = [n for n in iter_plan(ms.plan) if isinstance(n, MeshExchangeExec)]
    assert len(nodes) == 1
    # the exchange node carries the producer's reduce-bucket shape and keys
    assert nodes[0].file_partitions == ms.partitions
    assert nodes[0].keys
    # input edges recomputed over the fused plan
    assert ms.input_stage_ids == _find_input_stages(ms.plan)


def test_merge_leaves_broadcast_edges(port_ctx):
    stages = _q_stages(port_ctx, 3, "jb")
    n_broadcast = sum(1 for s in stages if s.broadcast)
    assert n_broadcast >= 1
    merged = merge_mesh_stages(list(stages), _mesh_cfg())
    # broadcast build stages must survive — their edge is read-in-full by
    # every probe task, never a hash exchange
    assert sum(1 for s in merged if s.broadcast) == n_broadcast


def test_choose_mesh_mode_reasons(port_ctx):
    from ballista_tpu_torch.scheduler.planner import choose_mesh_mode
    from ballista_tpu_torch.shuffle.reader import UnresolvedShuffleExec

    stages = _q_stages(port_ctx)
    producer = next(s for s in stages if s.plan.sort_shuffle and s.plan.keys)
    consumer = next(s for s in stages if producer.stage_id in s.input_stage_ids)
    leaves = [
        n for n in iter_plan(consumer.plan)
        if isinstance(n, UnresolvedShuffleExec) and n.stage_id == producer.stage_id
    ]
    cfg = _mesh_cfg()
    ok, reason = choose_mesh_mode(producer, [(consumer, leaves)], cfg)
    assert ok and reason == "mesh"
    # two consumers of one producer: keep the file path
    ok, reason = choose_mesh_mode(
        producer, [(consumer, leaves), (consumer, leaves)], cfg)
    assert not ok and reason.startswith("consumers")
    # a non-hash (passthrough) writer never merges
    final = stages[-1]
    assert not final.plan.sort_shuffle
    ok, reason = choose_mesh_mode(final, [(consumer, leaves)], cfg)
    assert not ok and reason == "not-hash-exchange"


@pytest.mark.parametrize("q", [1, 3, 4, 12, 13])
def test_merged_dag_equals_reference(q, tpch_dir, port_ctx, tpch_ctx):
    # the same stage ids, partitions, edges and node strings, and plans that
    # encode to the same protobuf bytes
    from ballista_tpu import serde as jserde
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu.scheduler.planner import DistributedPlanner as JPlanner
    from ballista_tpu.scheduler.planner import merge_mesh_stages as jmerge
    from ballista_tpu_torch import serde as tserde

    jcfg = JConfig({EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0, TPU_MESH_ENABLED: True})
    jphys = tpch_ctx.create_physical_plan(tpch_ctx.sql(tpch_query(q)).plan)
    jst = jmerge(JPlanner("job").plan_query_stages(jphys), jcfg)
    tst = merge_mesh_stages(_q_stages(port_ctx, q, "job"), _mesh_cfg())
    assert any(s.mesh for s in tst)
    assert [s.stage_id for s in tst] == [s.stage_id for s in jst]
    for js, ts in zip(jst, tst):
        assert (ts.partitions, ts.output_partitions, ts.input_stage_ids, ts.broadcast,
                ts.mesh) == (js.partitions, js.output_partitions, js.input_stage_ids,
                             js.broadcast, js.mesh)
        assert ts.display() == js.display()
        assert tserde.encode_plan(ts.plan).SerializeToString(deterministic=True) == \
            jserde.encode_plan(js.plan).SerializeToString(deterministic=True)


# -- serde + graph plumbing ---------------------------------------------------


def test_mesh_exchange_serde_round_trip(port_ctx):
    from ballista_tpu_torch.serde import plan_from_bytes, plan_to_bytes

    merged = merge_mesh_stages(_q_stages(port_ctx), _mesh_cfg())
    ms = next(s for s in merged if s.mesh)
    back = plan_from_bytes(plan_to_bytes(ms.plan))
    nodes = [n for n in iter_plan(back) if isinstance(n, MeshExchangeExec)]
    assert len(nodes) == 1
    orig = next(n for n in iter_plan(ms.plan) if isinstance(n, MeshExchangeExec))
    assert nodes[0].file_partitions == orig.file_partitions
    assert len(nodes[0].keys) == len(orig.keys)
    assert type(nodes[0].producer).__name__ == type(orig.producer).__name__
    assert contains_mesh_exchange(back)


def test_from_proto_recovers_mesh_flag(port_ctx):
    from ballista_tpu_torch.scheduler.state.execution_graph import ExecutionGraph

    merged = merge_mesh_stages(_q_stages(port_ctx), _mesh_cfg())
    g = ExecutionGraph("jp", "", "s1", merged, _mesh_cfg())
    g2 = ExecutionGraph.from_proto(g.to_proto())
    flags = {sid: st.spec.mesh for sid, st in g2.stages.items()}
    want = {s.stage_id: s.mesh for s in merged}
    assert any(flags.values())
    assert flags == want


def test_mesh_stage_pops_as_one_task(port_ctx):
    from ballista_tpu_torch.scheduler.state.execution_graph import ExecutionGraph

    merged = merge_mesh_stages(_q_stages(port_ctx), _mesh_cfg())
    cfg = _mesh_cfg(**{MAX_PARTITIONS_PER_TASK: 1})
    g = ExecutionGraph("jt", "", "s1", merged, cfg)
    ms = next(st for st in g.stages.values() if st.spec.mesh)
    assert ms.is_runnable, "the merged stage should resolve immediately (leaf scans)"
    task = g.pop_next_task("e1")
    assert task is not None
    assert task.stage_id == ms.stage_id
    # ONE task spanning every reduce bucket — MAX_PARTITIONS_PER_TASK=1
    # must NOT slice a mesh stage
    assert task.partitions == list(range(ms.spec.partitions))
    assert not ms.pending


# -- the exchange node directly (byte parity + demotion ladder) ---------------


def _producer_table(n=4000, with_nulls=True, with_dates=False):
    rng = np.random.default_rng(17)
    k = rng.choice([f"key{i:03d}" for i in range(60)], n)
    v = rng.uniform(-50, 50, n)
    cols = {
        "k": pa.array(k),
        "v": pa.array(v),
        "q": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
    }
    if with_nulls:
        vmask = rng.random(n) < 0.05
        cols["v"] = pc.if_else(pa.array(vmask), pa.nulls(n, pa.float64()),
                               pa.array(v))
        kmask = rng.random(n) < 0.03
        cols["k"] = pc.if_else(pa.array(kmask), pa.nulls(n, pa.string()),
                               pa.array(k))
    if with_dates:
        # C25: a date32 column (nullable) and a timestamp ride the exchange
        d = pa.array(rng.integers(8000, 10000, n).astype(np.int32), pa.int32()).cast(pa.date32())
        cols["d"] = pc.if_else(pa.array(rng.random(n) < 0.04), pa.nulls(n, pa.date32()), d)
        cols["ts"] = pa.array(rng.integers(0, 1 << 40, n), pa.int64()).cast(pa.timestamp("us"))
    return pa.table(cols)


def _scan_of(tbl: pa.Table, partitions: int, pkg: str = "port"):
    if pkg == "port":
        from ballista_tpu_torch.plan.physical import MemoryScanExec
        from ballista_tpu_torch.plan.schema import DFSchema
    else:
        from ballista_tpu.plan.physical import MemoryScanExec
        from ballista_tpu.plan.schema import DFSchema
    schema = DFSchema.from_arrow(tbl.schema)
    batches = tbl.combine_chunks().to_batches(
        max_chunksize=max(1, tbl.num_rows // partitions))
    return MemoryScanExec(schema, batches, partitions)


def _mesh_exchange_over(tbl: pa.Table, partitions=4, file_partitions=8):
    from ballista_tpu_torch.plan.expressions import Column

    return MeshExchangeExec(_scan_of(tbl, partitions), [Column("k")], file_partitions)


def _collect_buckets(node: MeshExchangeExec, cfg: BallistaConfig):
    from ballista_tpu_torch.plan.physical import TaskContext

    ctx = TaskContext(cfg)
    return [list(node.execute(p, ctx)) for p in range(node.output_partition_count())]


def _bucket_tables(buckets, schema):
    return [
        pa.Table.from_batches(bs, schema=schema) if bs
        else pa.table({f.name: pa.array([], f.type) for f in schema}, schema=schema)
        for bs in buckets
    ]


@pytest.mark.parametrize("with_dates", [False, True], ids=["reference-table", "dates"])
def test_device_and_host_buckets_byte_identical(with_dates):
    """The on-device all_to_all produces buckets byte-identical to the host
    split (the writer's routing minus the files) — same rows, same order,
    nulls/strings/floats/ints (and, since C25's repair, dates and
    timestamps) all round-tripped."""
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    tbl = _producer_table(with_dates=with_dates)
    schema = tbl.schema
    RUN_STATS.clear()
    mesh_buckets = _collect_buckets(_mesh_exchange_over(tbl), _mesh_cfg())
    stats = RUN_STATS.snapshot()
    assert stats.get("mesh_mode_reason") == "mesh"
    assert stats.get("mesh_devices") == N_DEVICES
    assert stats.get("exchange_bytes_on_device", 0) > 0
    # force the host split via the min-rows demotion rung
    RUN_STATS.clear()
    host_buckets = _collect_buckets(
        _mesh_exchange_over(tbl), _mesh_cfg(**{TPU_MESH_MIN_ROWS: 10**9}))
    assert RUN_STATS.snapshot().get("mesh_mode_reason") == "demoted:small-input"

    assert [len(bs) for bs in mesh_buckets] == [len(bs) for bs in host_buckets]
    for p, (mt, ht) in enumerate(zip(_bucket_tables(mesh_buckets, schema),
                                     _bucket_tables(host_buckets, schema))):
        assert mt.equals(ht), f"device bucket {p} diverges from host split"
    # every input row landed in exactly one bucket
    total = sum(b.num_rows for bs in mesh_buckets for b in bs)
    assert total == tbl.num_rows


def _same_batch(x: pa.RecordBatch, y: pa.RecordBatch) -> bool:
    """Equal batches, float columns compared by their bits."""
    if not x.schema.equals(y.schema) or x.num_rows != y.num_rows:
        return False
    for a, b in zip(x.columns, y.columns):
        if pa.types.is_floating(a.type):
            if not (a.is_valid().equals(b.is_valid()) and (
                    np.asarray(a.fill_null(0.0)).view(np.int64)
                    == np.asarray(b.fill_null(0.0)).view(np.int64)).all()):
                return False
        elif not a.equals(b):
            return False
    return True


def test_device_exchange_buckets_equal_reference_device_buckets():
    # the same producer partitions through each package's device rung on 8
    # devices: the same buckets, batch for batch, and the same stats
    import jax

    from ballista_tpu.ops.tpu import mesh_stage as jms
    from ballista_tpu.parallel.exchange import make_mesh as jmake_mesh
    from ballista_tpu.plan.expressions import Column as JColumn
    from ballista_tpu_torch.parallel.exchange import make_mesh

    assert len(jax.devices()) >= N_DEVICES
    tbl = _producer_table()
    parts = [tbl.slice(o, 1000) for o in range(0, 4000, 1000)]
    jnode = jms.MeshExchangeExec(_scan_of(tbl, 4, "jax"), [JColumn("k")], 8)
    tnode = _mesh_exchange_over(tbl)
    jrec, trec = {}, {}
    want = jnode._device_exchange(parts, jmake_mesh(N_DEVICES), 1 << 20, jrec)
    got = tnode._device_exchange(parts, make_mesh(N_DEVICES), 1 << 20, trec)
    host = tnode._host_split(parts)
    for g, w, h in zip(got, want, host):
        assert [b.num_rows for b in g] == [b.num_rows for b in w] == [b.num_rows for b in h]
        assert all(_same_batch(x, y) for x, y in zip(g, w))
        assert all(_same_batch(x, y) for x, y in zip(g, h))
    assert trec["mesh_devices"] == jrec["mesh_devices"] == N_DEVICES
    assert trec["exchange_bytes_on_device"] == jrec["exchange_bytes_on_device"]


def test_capacity_overflow_demotes_with_reason():
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    tbl = _producer_table()
    RUN_STATS.clear()
    buckets = _collect_buckets(
        _mesh_exchange_over(tbl), _mesh_cfg(**{TPU_MESH_EXCHANGE_CAPACITY: 1}))
    assert RUN_STATS.snapshot().get("mesh_mode_reason") == "demoted:capacity"
    # the demoted path still serves every row — no silent truncation
    assert sum(b.num_rows for bs in buckets for b in bs) == tbl.num_rows


def test_unsupported_dtype_demotes_with_reason():
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    tbl = _producer_table(n=500, with_nulls=False)
    tbl = tbl.append_column("blob", pa.array([b"x"] * 500, type=pa.binary()))
    RUN_STATS.clear()
    buckets = _collect_buckets(_mesh_exchange_over(tbl), _mesh_cfg())
    reason = RUN_STATS.snapshot().get("mesh_mode_reason", "")
    assert reason.startswith("demoted:dtype")
    assert sum(b.num_rows for bs in buckets for b in bs) == tbl.num_rows


def test_aqe_demote_reason_forces_host_path():
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    node = _mesh_exchange_over(_producer_table(n=400, with_nulls=False))
    node.demote_reason = "aqe:input-bytes(9>1)"
    RUN_STATS.clear()
    _collect_buckets(node, _mesh_cfg())
    assert RUN_STATS.snapshot().get("mesh_mode_reason") == "demoted:aqe:input-bytes(9>1)"


@pytest.mark.parametrize("rung", ["capacity", "dtype", "aqe", "single-device", "no-mesh"])
def test_demotion_reasons_equal_reference(rung):
    # each rung of the ladder names itself as the reference's does
    import jax

    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu.config import TPU_MESH_DEVICES as J_DEVICES
    from ballista_tpu.ops.tpu import mesh_stage as jms
    from ballista_tpu.ops.tpu.stage_compiler import RUN_STATS as JSTATS
    from ballista_tpu.plan.expressions import Column as JColumn
    from ballista_tpu.plan.physical import TaskContext as JTaskContext
    from ballista_tpu_torch.config import TPU_MESH_DEVICES
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    assert len(jax.devices()) == N_DEVICES
    tbl = _producer_table(n=600, with_nulls=False)
    if rung == "dtype":
        tbl = tbl.append_column("blob", pa.array([b"x"] * 600, type=pa.binary()))
    over = {"capacity": {TPU_MESH_EXCHANGE_CAPACITY: 1}, "single-device": {TPU_MESH_DEVICES: 1},
            "no-mesh": {TPU_MESH_DEVICES: N_DEVICES + 1}}.get(rung, {})
    base = {EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0, TPU_MESH_ENABLED: True}
    reasons = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            node = jms.MeshExchangeExec(_scan_of(tbl, 4, "jax"), [JColumn("k")], 8)
            cfg = JConfig({**base, **{J_DEVICES if k == TPU_MESH_DEVICES else k: v
                                      for k, v in over.items()}})
            stats, task = JSTATS, JTaskContext(cfg)
        else:
            from ballista_tpu_torch.plan.physical import TaskContext

            node = _mesh_exchange_over(tbl)
            cfg = BallistaConfig({**base, **over})
            stats, task = RUN_STATS, TaskContext(cfg)
        if rung == "aqe":
            node.demote_reason = "aqe:input-bytes(9>1)"
        stats.clear()
        buckets = [list(node.execute(p, task)) for p in range(8)]
        assert sum(b.num_rows for bs in buckets for b in bs) == tbl.num_rows
        reasons.append(stats.snapshot().get("mesh_mode_reason"))
    assert reasons[0] == reasons[1]
    assert reasons[1].startswith("demoted:")


# -- end to end through the real scheduler ------------------------------------


_E2E_SQL = ("select k, sum(v) s, count(*) c, min(q) mn "
            "from t where q < 700 group by k order by k")


def _shuffle_stage_dirs(work_dir: str) -> dict[str, set[int]]:
    """job_id → set of stage ids that wrote shuffle files."""
    out: dict[str, set[int]] = {}
    for job in os.listdir(work_dir):
        jp = os.path.join(work_dir, job)
        if not os.path.isdir(jp):
            continue
        out[job] = {int(d) for d in os.listdir(jp) if d.isdigit()}
    return out


def _last_graph(ctx):
    sched = ctx._cluster.scheduler
    with sched._jobs_lock:
        return list(sched.jobs.values())[-1]


def _run_standalone(tbl, mesh: bool, **over):
    from ballista_tpu_torch.client.context import SessionContext

    cfg = _mesh_cfg(**{TPU_MESH_ENABLED: mesh, **over})
    ctx = SessionContext.standalone(cfg, num_executors=1, vcores=2)
    try:
        ctx.register_arrow_table("t", tbl, partitions=4)
        out = ctx.sql(_E2E_SQL).collect()
        graph = _last_graph(ctx)
        stage_dirs = _shuffle_stage_dirs(ctx._cluster.work_dir).get(graph.job_id, set())
        return out, graph, stage_dirs
    finally:
        ctx.shutdown()


def test_e2e_mesh_parity_and_zero_shuffle_files():
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec

    tbl = _producer_table(n=12_000)

    ref, ref_graph, ref_dirs = _run_standalone(tbl, mesh=False)

    RUN_STATS.clear()
    got, graph, dirs = _run_standalone(tbl, mesh=True)
    stats = RUN_STATS.snapshot()

    # byte parity against the per-partition path
    assert got.equals(ref), "mesh-mode result diverges from per-partition path"

    # the fused stage ran with the on-device exchange, spanning the mesh
    assert stats.get("mesh_mode_reason") == "mesh"
    assert stats.get("mesh_devices") == N_DEVICES
    assert stats.get("exchange_bytes_on_device", 0) > 0
    assert stats.get("exchange_s", 0) > 0

    # the exchange edge vanished from the stage DAG: fewer stages, and the
    # merged stage's plan reads no shuffle files at all
    assert len(graph.stages) < len(ref_graph.stages)
    mesh_stage = next(s for s in graph.stages.values() if s.spec.mesh)
    plan = mesh_stage.resolved_plan or mesh_stage.spec.plan
    readers = [n for n in iter_plan(plan) if isinstance(n, ShuffleReaderExec)]
    assert not readers, "fused edge must not read shuffle files"
    # zero shuffle-file writes for the fused edge: the eliminated producer
    # stage wrote files in the reference run and has NO directory now
    gone = {s.stage_id for s in ref_graph.stages.values()} - set(graph.stages)
    assert gone and gone <= ref_dirs
    assert not (gone & dirs), "mesh run must not write files for the fused edge"
    # what remains on disk is exactly the surviving stages' outputs
    assert dirs <= set(graph.stages)


def test_e2e_capacity_demotion_stays_correct():
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    tbl = _producer_table(n=6_000)
    ref, _, _ = _run_standalone(tbl, mesh=False)
    RUN_STATS.clear()
    got, graph, _ = _run_standalone(tbl, mesh=True,
                                    **{TPU_MESH_EXCHANGE_CAPACITY: 1})
    assert RUN_STATS.snapshot().get("mesh_mode_reason") == "demoted:capacity"
    assert got.equals(ref), "capacity-demoted mesh stage diverges"


# -- TPC-H through the standalone mode, against the reference ------------------


MESH_STATS = ("mesh_mode_reason", "mesh_devices", "exchange_bytes_on_device")


@pytest.fixture(scope="module")
def tpch_runs(tpch_dir):
    """(answer or error, mesh stats, stages, shuffle stage dirs) per
    (package, mesh on, query): one standalone cluster per package and mode,
    each query once."""
    from ballista_tpu.client.context import SessionContext as JContext
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu.ops.tpu.stage_compiler import RUN_STATS as JSTATS
    from ballista_tpu.testing.tpchgen import register_tpch as jregister
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    clusters, cache = {}, {}

    def get(pkg, mesh, q):
        key = (pkg, mesh, q)
        if key in cache:
            return cache[key]
        if (pkg, mesh) not in clusters:
            settings = {EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0, TPU_MESH_ENABLED: mesh}
            if pkg == "jax":
                ctx = JContext.standalone(JConfig(settings), num_executors=1, vcores=2)
                jregister(ctx, tpch_dir)
            else:
                ctx = SessionContext.standalone(BallistaConfig(settings),
                                                num_executors=1, vcores=2)
                register_tpch(ctx, tpch_dir)
            clusters[(pkg, mesh)] = ctx
        ctx = clusters[(pkg, mesh)]
        stats = JSTATS if pkg == "jax" else RUN_STATS
        stats.clear()
        try:
            out = ctx.sql(tpch_query(q)).collect()
        except Exception as e:  # noqa: BLE001 — a failed job is a result here
            out = e
        snap = stats.snapshot()
        graph = _last_graph(ctx)
        dirs = _shuffle_stage_dirs(ctx._cluster.work_dir).get(graph.job_id, set())
        cache[key] = (out, {k: snap.get(k) for k in MESH_STATS},
                      {sid: st.spec.mesh for sid, st in graph.stages.items()}, dirs)
        return cache[key]

    yield get
    for ctx in clusters.values():
        ctx.shutdown()


@pytest.mark.parametrize("q", [1, 4, 12, 13])
def test_tpch_mesh_byte_identical_to_reference_and_mesh_off(q, tpch_runs):
    got, stats, stages, dirs = tpch_runs("port", True, q)
    want, jstats, jstages, _ = tpch_runs("jax", True, q)
    off, _, off_stages, off_dirs = tpch_runs("port", False, q)
    assert got.num_rows > 0
    assert got.equals(want), "diverges from the reference's mesh run"
    assert got.equals(off), "diverges from the port's mesh-off run"
    assert stats == jstats
    assert stats["mesh_mode_reason"] == "mesh" and stats["mesh_devices"] == N_DEVICES
    # the merged stage is one stage fewer, and its fused edge wrote no files
    assert stages == jstages and any(stages.values())
    assert len(stages) < len(off_stages)
    gone = set(off_stages) - set(stages)
    assert gone and gone <= off_dirs and not (gone & dirs)


def test_c25_date_column_crosses_the_mesh(tpch_runs, tpch_dir):
    # TPC-H q3's merged edge carries o_orderdate (date32): the port answers
    # as its mesh-off run and its CPU engine do, through the device rung;
    # the reference's codec casts date32 straight to int64, which Arrow
    # does not implement, and the job fails (C25 stands there)
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    got, stats, stages, _ = tpch_runs("port", True, 3)
    off, _, off_stages, _ = tpch_runs("port", False, 3)
    assert not isinstance(got, Exception), got
    assert got.num_rows > 0
    assert got.equals(off)
    assert stats["mesh_mode_reason"] == "mesh" and stats["mesh_devices"] == N_DEVICES
    assert len(stages) < len(off_stages)
    cpu = SessionContext(BallistaConfig({EXECUTOR_ENGINE: "cpu"}))
    register_tpch(cpu, tpch_dir)
    want = cpu.sql(tpch_query(3)).collect()
    assert got.schema.equals(want.schema)
    for name in want.column_names:
        a, b = got.column(name).combine_chunks(), want.column(name).combine_chunks()
        if pa.types.is_floating(a.type):
            np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-9, atol=0.0)
        else:
            assert a.equals(b), name
    err, jstats, _, _ = tpch_runs("jax", True, 3)
    assert isinstance(err, Exception)
    assert "ArrowNotImplementedError" in str(err)
    assert "date32" in str(err)
