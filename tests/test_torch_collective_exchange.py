"""The partition-sharded stage (`ballista.tpu.collective.exchange`) against
the JAX package's.

The reference shards a stage's device table by partition across its 8
virtual CPU devices and GSPMD inserts the collectives
(tests/test_tpu_engine.py `test_collective_exchange_mesh_execution`). The
port, after `runtime.use_cpu(devices=8)`, shards the same table across 8
simulated devices and runs the pass once per device (the sorted mode over
the gathered shards). Local TPC-H SF0.01: the answers equal the
reference's sharded run byte for byte and the CPU oracle, and the cached
table is sharded across all 8 devices."""

import numpy as np
import pytest

from ballista_tpu_torch.ops.cuda import runtime
from ballista_tpu_torch.testing.reference import compare_results, run_reference

from .conftest import iter_plan, tpch_query

N_DEVICES = 8
CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0,
       "ballista.tpu.collective.exchange": True}


@pytest.fixture(scope="module", autouse=True)
def _eight_devices():
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu(devices=N_DEVICES)
    yield
    runtime.use_cpu(*prev)


@pytest.fixture(scope="module")
def port_ref_tables(tpch_dir):
    from ballista_tpu_torch.testing.reference import load_tables

    return load_tables(tpch_dir)


def _ctx(pkg, tpch_dir, **over):
    if pkg == "jax":
        from ballista_tpu.client.context import SessionContext
        from ballista_tpu.config import BallistaConfig
        from ballista_tpu.testing.tpchgen import register_tpch
    else:
        from ballista_tpu_torch.client.context import SessionContext
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.testing.tpchgen import register_tpch
    ctx = SessionContext(BallistaConfig({**CFG, **over}))
    register_tpch(ctx, tpch_dir)
    return ctx


@pytest.mark.parametrize("q", [1, 3])
def test_collective_exchange_mesh_execution(q, tpch_dir, port_ref_tables):
    """q1: the unrolled path; q3: the sorted path with a join — both through
    the mesh, equal to the reference's sharded run, to the unsharded run
    and to the CPU oracle."""
    import jax

    assert len(jax.devices()) >= N_DEVICES, "the reference's 8 virtual devices"
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc

    calls = []
    run_pass = sc._run_pass

    def spy(fn, mode, dt, luts, builds):
        calls.append((mode, None if dt.mesh is None else dt.mesh.size))
        return run_pass(fn, mode, dt, luts, builds)

    sc._run_pass = spy
    try:
        got = _ctx("port", tpch_dir).sql(tpch_query(q)).collect()
    finally:
        sc._run_pass = run_pass
    assert calls and all(size == N_DEVICES for _, size in calls)
    want = _ctx("jax", tpch_dir).sql(tpch_query(q)).collect()
    assert got.equals(want), "diverges from the reference's sharded run"
    unsharded = _ctx("port", tpch_dir, **{"ballista.tpu.collective.exchange": False})
    assert got.equals(unsharded.sql(tpch_query(q)).collect())
    problems = compare_results(got, run_reference(q, port_ref_tables), q)
    assert not problems, "\n".join(problems)


def test_cached_table_sharded_across_the_mesh(tpch_dir):
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.plan.physical import TaskContext

    ctx = _ctx("port", tpch_dir)
    cfg = ctx.config
    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(tpch_query(1)).plan), cfg)
    stages = [n for n in iter_plan(phys) if isinstance(n, sc.TpuStageExec)]
    assert stages
    tc = TaskContext(cfg)
    for p in range(phys.output_partition_count()):
        list(phys.execute(p, tc))
    assert stages[0].tpu_count >= 1 and stages[0].fallback_count == 0
    # the cached device table is sharded across every device of the mesh:
    # P padded to a multiple of 8, one shard of partitions per device
    want = [f"cpu:{i}" for i in range(N_DEVICES)]
    sharded = [dt for dt in sc.DEVICE_CACHE._cache.values()
               if dt.mesh is not None and list(dt.mesh.key()) == want]
    assert sharded, "no mesh-sharded device table in cache"
    dt = sharded[-1]
    P = dt.shape[0]
    assert P % N_DEVICES == 0
    for c in dt.cols + [dt.mask]:
        assert c.sharded and len(c.shards) == N_DEVICES
        assert all(s.shape[0] == P // N_DEVICES for s in c.shards)
    # padding partitions are empty and fully masked
    assert sum(dt.part_rows) == int(np.asarray(dt.mask).sum())


def test_stage_mesh_needs_the_key_and_two_devices():
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc
    from ballista_tpu_torch.config import BallistaConfig

    on = BallistaConfig(CFG)
    assert sc._stage_mesh(on).size == N_DEVICES
    assert sc._stage_mesh(BallistaConfig({**CFG, "ballista.tpu.collective.exchange": False})) is None
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu(devices=1)
    try:
        assert sc._stage_mesh(on) is None  # one device: the unsharded pass
    finally:
        runtime.use_cpu(*prev)


def test_fused_pallas_clamps_under_the_mesh(tpch_dir):
    # the kernels take one device's tensors: a fused_pallas request runs the
    # torch form over the shards, and says so, as the reference clamps
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc

    sc.RUN_STATS.clear()
    ctx = _ctx("port", tpch_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
    got = ctx.sql(tpch_query(4)).collect()
    recs = [r for r in sc.RUN_STATS.stages().values() if "fusion_reason" in r]
    assert recs and all(r["fusion_mode"] == "fused_xla" for r in recs)
    assert all("clamped: collective-exchange mesh" in r["fusion_reason"] for r in recs)
    want = _ctx("jax", tpch_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
    assert got.equals(want.sql(tpch_query(4)).collect())
