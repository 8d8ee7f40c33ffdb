"""The PyTorch port's SQL path against the JAX package, on the CPU.

The port runs with an explicit CPU device (runtime.use_cpu()); the JAX
package runs with JAX_PLATFORMS=cpu (tests/conftest.py), its Pallas kernel
in interpret mode. Both read the same TPC-H SF0.01 parquet (the session's
`tpch_dir`) with one config dict, since the port keeps every key and value.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan, tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}


@pytest.fixture(autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _port_ctx(tpch_dir, **extra):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({**BASE_CFG, **extra}))
    register_tpch(ctx, tpch_dir)
    return ctx


def _jax_ctx(tpch_dir, **extra):
    from ballista_tpu.client.context import SessionContext
    from ballista_tpu.config import BallistaConfig
    from ballista_tpu.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({**BASE_CFG, **extra}))
    register_tpch(ctx, tpch_dir)
    return ctx


@pytest.fixture(scope="module")
def port_cpu_answers(tpch_dir):
    """Every TPC-H query through the port's engine=cpu, once per module."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(ctx, tpch_dir)
    return {q: ctx.sql(tpch_query(q)).collect() for q in range(1, 23)}


@pytest.mark.parametrize("q", [1, 4, 6])
def test_tpch_byte_identical_to_jax_engine(q, tpch_dir):
    # money stays exact int64 cents on both sides and every float op is the
    # same IEEE operation, so the Arrow tables agree byte for byte
    want = _jax_ctx(tpch_dir).sql(tpch_query(q)).collect()
    got = _port_ctx(tpch_dir).sql(tpch_query(q)).collect()
    assert got.schema.equals(want.schema)
    assert got.equals(want)


def test_f64_sums_under_fused_pallas_match_jax():
    # the synthetic true-f64 shape of test_tpu_engine.py's Pallas test:
    # float sums route through masked_group_reduce (f32 sums, rtol 1e-4 —
    # the kernel's bound), counts and keys exact
    rng = np.random.default_rng(21)
    n = 30_000
    tbl = pa.table({
        "cat": rng.choice(["a", "b", "c", "d", "e"], n),
        "w": rng.uniform(0.0, 10.0, n),
        "qty": rng.integers(1, 50, n),
    })
    sql = "select cat, sum(w) s, count(*) c from t where qty > 10 group by cat order by cat"
    outs = []
    for pkg in ("ballista_tpu", "ballista_tpu_torch"):
        ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
        cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
        ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(
            {**BASE_CFG, "ballista.tpu.fusion.mode": "fused_pallas"}))
        ctx.register_arrow_table("t", tbl, partitions=4)
        outs.append(ctx.sql(sql).collect())
    want, got = outs
    assert got.column("cat").equals(want.column("cat"))
    assert got.column("c").equals(want.column("c"))
    np.testing.assert_allclose(got.column("s").to_numpy(), want.column("s").to_numpy(),
                               rtol=1e-4)


def _partial_stage(pkg_engine, stage_cls, ctx, q):
    phys = pkg_engine.maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(tpch_query(q)).plan),
                                        ctx.config)
    stages = [n for n in iter_plan(phys) if isinstance(n, stage_cls)]
    assert len(stages) == 1
    return stages[0]


def test_q4_partial_stage_on_carried_device_state(tpch_dir):
    """Fill the JAX DeviceTable for orders, carry it across with
    device_table_from_arrays, run q4's partial stage in both packages under
    fused_pallas, and compare the raw stage outputs exactly (count-only)."""
    import ballista_tpu.engine.tpu_engine as jeng
    import ballista_tpu.ops.tpu.stage_compiler as jsc
    import ballista_tpu_torch.engine.cuda_engine as teng
    import ballista_tpu_torch.ops.cuda.stage_compiler as tsc
    from ballista_tpu.ops.tpu.runtime import ensure_jax
    from ballista_tpu.plan.physical import TaskContext as JTask
    from ballista_tpu_torch.ops.cuda.state import device_table_from_arrays
    from ballista_tpu_torch.plan.physical import TaskContext as TTask

    jnp = ensure_jax().numpy
    mode = {"ballista.tpu.fusion.mode": "fused_pallas"}
    jctx, tctx = _jax_ctx(tpch_dir, **mode), _port_ctx(tpch_dir, **mode)
    jst = _partial_stage(jeng, jsc.TpuStageExec, jctx, 4)
    tst = _partial_stage(teng, tsc.TpuStageExec, tctx, 4)
    jtask, ttask = JTask(jctx.config), TTask(tctx.config)

    jdt = jsc.DEVICE_CACHE.get(jst.scan, jst.buckets, jtask, 1 << 40)
    jkey = jsc.DEVICE_CACHE.key_of(jst.scan)
    jjoins = [op for op in jst.ops if type(op).__name__ == "HashJoinExec"]
    jbuilds = [jst._prepare_build(op, i, jtask, jkey) for i, op in enumerate(jjoins)]
    (fn, lowering, meta, _), _, _ = jst._compile_locked(jdt, jbuilds, {}, "fused_pallas")
    luts = [jnp.asarray(a) for a in lowering.build_luts(jdt.dicts, [b.dicts for b in jbuilds])]
    jouts = [np.asarray(o) for o in fn(jdt.flat_cols(), luts, jdt.mask,
                                       [b.flat_arrays() for b in jbuilds])]
    assert meta["fusion_mode"] == "fused_pallas"

    cpu = torch.device("cpu")
    tdt = device_table_from_arrays(
        [np.asarray(c) for c in jdt.cols],
        [None if v is None else np.asarray(v) for v in jdt.valids],
        np.asarray(jdt.mask), jdt.part_rows, jdt.kinds, jdt.scales, jdt.dicts, cpu)
    tkey = tsc.DEVICE_CACHE.key_of(tst.scan)
    tjoins = [op for op in tst.ops if type(op).__name__ == "HashJoinExec"]
    tbuilds = [tst._prepare_build(op, i, ttask, tkey, cpu) for i, op in enumerate(tjoins)]
    rec: dict = {}
    tmeta, touts = tst._run_stage(tdt, tbuilds, tkey, rec, "fused_pallas")
    assert tmeta["fusion_mode"] == "fused_pallas"
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_tpch_device_engine_matches_cpu_engine(q, tpch_dir, port_cpu_answers):
    # stages the slice does not carry fall back to the CPU engine, counted;
    # floats within rtol 1e-9 (the CPU engine sums money in float64, the
    # device path in exact int64 cents)
    from ballista_tpu.testing.reference import compare_results

    got = _port_ctx(tpch_dir).sql(tpch_query(q)).collect()
    want = port_cpu_answers[q]
    assert got.schema.equals(want.schema)
    problems = compare_results(got, want.to_pandas(date_as_object=False), q, rtol=1e-9)
    assert not problems, "\n".join(problems)


@pytest.mark.parametrize("q", [1, 4, 6])
def test_device_stages_ran_without_fallback(q, tpch_dir):
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import TaskContext

    ctx = _port_ctx(tpch_dir)
    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(tpch_query(q)).plan), ctx.config)
    stages = [n for n in iter_plan(phys) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
    assert any(isinstance(s, TpuStageExec) for s in stages)
    task = TaskContext(ctx.config)
    for p in range(phys.output_partition_count()):
        list(phys.execute(p, task))
    for s in stages:
        assert s.tpu_count >= 1, s.node_str()
        assert s.fallback_count == 0, s.node_str()


def test_query_raises_without_cuda_unless_cpu_requested(tpch_dir, monkeypatch):
    # the engine never answers on the host when the card is missing: the
    # device stage's error propagates out of collect()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime.use_cpu(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_ctx(tpch_dir).sql(tpch_query(1)).collect()


def _run_stages(ctx, q):
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(tpch_query(q)).plan), ctx.config)
    stages = [n for n in iter_plan(phys) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
    return phys, stages


def test_kernel_launch_failure_raises_out_of_collect(tpch_dir, monkeypatch):
    # a failed launch of masked_group_reduce (the wrapper's RuntimeError on a
    # non-zero CUDA status) fails the query instead of re-running it on the
    # CPU engine
    from ballista_tpu_torch.ops.cuda import cuda_kernels
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    def failed_launch(vals, gid, mask, num_groups):
        raise RuntimeError("masked_group_reduce launch failed: CUDA error 719")

    monkeypatch.setattr(cuda_kernels, "masked_group_reduce", failed_launch)
    ctx = _port_ctx(tpch_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
    phys, stages = _run_stages(ctx, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        ctx.execute_collect(phys)
    partial = [s for s in stages if isinstance(s, TpuStageExec)]
    assert partial
    assert all(s.fallback_count == 0 for s in stages)


def test_final_stage_device_error_raises_out_of_collect(tpch_dir, monkeypatch):
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec

    def device_error(self, ctx):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(TpuFinalStageExec, "_tpu_run_all", device_error)
    ctx = _port_ctx(tpch_dir)
    phys, stages = _run_stages(ctx, 1)
    assert any(isinstance(s, TpuFinalStageExec) for s in stages)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ctx.execute_collect(phys)
    assert all(s.fallback_count == 0 for s in stages)
