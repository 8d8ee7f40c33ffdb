"""The port's standalone mode against the JAX package's, on the CPU.

Both packages run `SessionContext.standalone(..., engine=tpu)` over the same
TPC-H SF0.01 parquet (the session's `tpch_dir`): the port after
runtime.use_cpu(), the JAX package with JAX_PLATFORMS=cpu (its Pallas
kernels in interpret mode). Their answers must be byte-identical, their
distributed planners must cut the same stages (the same protobuf bytes,
each package decoding the other's), and their engines must claim and
decline the same stages.
"""

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
QUERIES = [1, 3, 4, 5, 6, 12, 13]
PALLAS = {"ballista.tpu.fusion.mode": "fused_pallas"}


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _port_ctx(tpch_dir, standalone=True, **extra):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    cfg = BallistaConfig({**BASE_CFG, **extra})
    ctx = SessionContext.standalone(cfg) if standalone else SessionContext(cfg)
    register_tpch(ctx, tpch_dir)
    return ctx


def _jax_ctx(tpch_dir, standalone=True, **extra):
    from ballista_tpu.client.context import SessionContext
    from ballista_tpu.config import BallistaConfig
    from ballista_tpu.testing.tpchgen import register_tpch

    cfg = BallistaConfig({**BASE_CFG, **extra})
    ctx = SessionContext.standalone(cfg) if standalone else SessionContext(cfg)
    register_tpch(ctx, tpch_dir)
    return ctx


def _claims(graph):
    """Per stage: each device node kind the engine claimed, with its nodes,
    device passes and fallbacks summed over the stage's tasks."""
    from ballista_tpu_torch.testing.standalone_stats import stage_stats

    return {sid: (s["tasks"], s["device"]) for sid, s in stage_stats(graph).items()}


@pytest.fixture(scope="module")
def clusters(tpch_dir):
    made = {}

    def get(pkg, mode):
        key = (pkg, mode)
        if key not in made:
            extra = PALLAS if mode == "fused_pallas" else {}
            made[key] = (_port_ctx if pkg == "port" else _jax_ctx)(tpch_dir, **extra)
        return made[key]

    yield get
    for ctx in made.values():
        ctx.shutdown()


@pytest.fixture(scope="module")
def runs(clusters):
    """(answer, claims) per (package, mode, query), each query run once."""
    from ballista_tpu_torch.testing.standalone_stats import last_job

    cache = {}

    def get(pkg, mode, q):
        key = (pkg, mode, q)
        if key not in cache:
            ctx = clusters(pkg, mode)
            tbl = ctx.sql(tpch_query(q)).collect()
            cache[key] = (tbl, _claims(last_job(ctx._cluster.scheduler)))
        return cache[key]

    return get


@pytest.mark.parametrize("mode,q", [("auto", q) for q in QUERIES]
                         + [("fused_pallas", 5), ("fused_pallas", 12)])
def test_standalone_byte_identical_to_jax_standalone(mode, q, runs):
    want, _ = runs("jax", mode, q)
    got, _ = runs("port", mode, q)
    assert want.num_rows > 0
    assert got.schema.equals(want.schema)
    assert got.equals(want)


@pytest.mark.parametrize("q", QUERIES)
def test_engines_claim_and_decline_the_same_stages(q, runs):
    _, want = runs("jax", "auto", q)
    _, got = runs("port", "auto", q)
    assert any(dev for _tasks, dev in want.values())
    assert got == want


@pytest.mark.parametrize("q", QUERIES)
def test_distributed_plans_encode_identically(q, tpch_dir):
    # the stages each package's DistributedPlanner cuts encode to the same
    # protobuf bytes (the wire format is shared, message for message), and
    # each package decodes the other's bytes into the same plan
    from ballista_tpu import serde as jserde
    from ballista_tpu.scheduler.planner import DistributedPlanner as JPlanner
    from ballista_tpu.scheduler.planner import merge_mesh_stages as jmerge
    from ballista_tpu_torch import serde as tserde
    from ballista_tpu_torch.proto import pb as tpb
    from ballista_tpu_torch.scheduler.planner import DistributedPlanner as TPlanner
    from ballista_tpu_torch.scheduler.planner import merge_mesh_stages as tmerge

    jctx = _jax_ctx(tpch_dir, standalone=False)
    tctx = _port_ctx(tpch_dir, standalone=False)
    jst = jmerge(JPlanner("job").plan_query_stages(
        jctx.create_physical_plan(jctx.sql(tpch_query(q)).plan)), jctx.config)
    tst = tmerge(TPlanner("job").plan_query_stages(
        tctx.create_physical_plan(tctx.sql(tpch_query(q)).plan)), tctx.config)
    assert [s.stage_id for s in tst] == [s.stage_id for s in jst]
    assert len(tst) > 1
    for js, ts in zip(jst, tst):
        jb = jserde.encode_plan(js.plan).SerializeToString(deterministic=True)
        tb = tserde.encode_plan(ts.plan).SerializeToString(deterministic=True)
        assert tb == jb, js.stage_id
        assert (ts.partitions, ts.output_partitions, ts.input_stage_ids, ts.broadcast) == \
            (js.partitions, js.output_partitions, js.input_stage_ids, js.broadcast)
        assert ts.display() == js.display()
        from_jax = tserde.decode_plan(tpb.PhysicalPlanNode.FromString(jb))
        assert from_jax.display() == js.plan.display()
        from_port = jserde.decode_plan(tpb.PhysicalPlanNode.FromString(tb))
        assert from_port.display() == ts.plan.display()


def _same_bits(a: pa.Array, b: pa.Array) -> bool:
    """Equal arrays, NaN payloads compared by their bits."""
    if not pa.types.is_floating(a.type):
        return a.equals(b)
    return (a.type == b.type and a.is_valid().equals(b.is_valid())
            and (np.asarray(a.fill_null(0.0)).view(np.int64)
                 == np.asarray(b.fill_null(0.0)).view(np.int64)).all())


def test_mesh_exchange_host_split_and_codecs_match_reference():
    # the mesh node the codec and AQE name: its column codecs and its host
    # split (the exchange AQE demoted) equal the reference's
    from ballista_tpu.ops.tpu import mesh_stage as jms
    from ballista_tpu.plan.expressions import col as jcol
    from ballista_tpu.plan.physical import MemoryScanExec as JScan
    from ballista_tpu.plan.schema import DFSchema as JSchema
    from ballista_tpu_torch.ops.cuda import mesh_stage as tms
    from ballista_tpu_torch.plan.expressions import col as tcol
    from ballista_tpu_torch.plan.physical import MemoryScanExec as TScan
    from ballista_tpu_torch.plan.schema import DFSchema as TSchema

    rng = np.random.default_rng(9)
    n = 500
    keys = rng.integers(0, 50, n)
    tbl = pa.table({
        "k": pa.array(keys, pa.int64()),
        "f": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.random(n) * 100)),
        "s": pa.array([None if i % 17 == 0 else f"v{i % 23}" for i in range(n)]),
    })
    for col in tbl.columns:
        jl, jv, jm = jms._encode_column(col)
        tl, tv, tm = tms._encode_column(col)
        assert all((a == b).all() for a, b in zip(jl, tl))
        assert (jv is None and tv is None) or (jv == tv).all()
        back = tms._decode_column(col.type, tl, tv, tm)
        assert _same_bits(back, jms._decode_column(col.type, jl, jv, jm))
        assert _same_bits(back, col.combine_chunks())
    parts = [tbl.slice(0, 200), tbl.slice(200)]
    jscan = JScan(JSchema.from_arrow(tbl.schema), tbl.to_batches())
    tscan = TScan(TSchema.from_arrow(tbl.schema), tbl.to_batches())
    jb = jms.MeshExchangeExec(jscan, [jcol("k")], 4)._host_split(parts)
    tb = tms.MeshExchangeExec(tscan, [tcol("k")], 4)._host_split(parts)
    assert len(tb) == len(jb) == 4
    for jbucket, tbucket in zip(jb, tb):
        assert [b.num_rows for b in tbucket] == [b.num_rows for b in jbucket]
        for x, y in zip(tbucket, jbucket):
            assert x.schema.equals(y.schema)
            assert all(_same_bits(c, d) for c, d in zip(x.columns, y.columns))
