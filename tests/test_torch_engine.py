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


# every TPC-H query whose partial stages the JAX package runs on the device
# (q16 and q18 decline in both packages: an empty build side at SF0.01)
DEVICE_QUERIES = [q for q in range(1, 23) if q not in (16, 18)]


@pytest.mark.parametrize("q", DEVICE_QUERIES)
def test_tpch_byte_identical_to_jax_engine(q, tpch_dir):
    # money stays exact int64 cents on both sides, every float op is the
    # same IEEE operation, and the sorted aggregation keeps tied rows in
    # input order as the reference's sort does, so the Arrow tables agree
    # byte for byte
    want = _jax_ctx(tpch_dir).sql(tpch_query(q)).collect()
    got = _port_ctx(tpch_dir).sql(tpch_query(q)).collect()
    assert got.schema.equals(want.schema)
    assert got.equals(want)


@pytest.mark.parametrize("q", [5, 12, 14, 19])
def test_tpch_joins_byte_identical_to_jax_under_fused_pallas(q, tpch_dir):
    # the kernel rung: q5's small unique tables go through hash_probe, the
    # string predicates of q12/q14/q19 through dict_filter
    mode = {"ballista.tpu.fusion.mode": "fused_pallas"}
    want = _jax_ctx(tpch_dir, **mode).sql(tpch_query(q)).collect()
    got = _port_ctx(tpch_dir, **mode).sql(tpch_query(q)).collect()
    assert got.schema.equals(want.schema)
    assert got.equals(want)


@pytest.mark.parametrize("q", [12, 14, 19])
def test_dict_filter_calls_take_int32_codes_and_no_mask(q, tpch_dir, monkeypatch):
    # every TPC-H column is non-null: where the reference hands its kernel
    # an all-true mask the port hands it none, and the codes arrive as the
    # kernel reads them (int32, contiguous), so no conversion pass runs
    # before it; the answers stay the JAX engine's (the test above)
    from ballista_tpu_torch.ops.cuda import cuda_kernels as tck

    calls = []
    real = tck.dict_filter

    def recording(codes, lut, mask=None):
        calls.append((codes.dtype, codes.is_contiguous(), mask))
        return real(codes, lut, mask)

    monkeypatch.setattr(tck, "dict_filter", recording)
    ctx = _port_ctx(tpch_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
    ctx.sql(tpch_query(q)).collect()
    assert calls
    assert all(dtype == torch.int32 and contiguous and mask is None
               for dtype, contiguous, mask in calls)


@pytest.mark.parametrize("q,kernel", [(5, "hash_probe"), (12, "dict_filter"),
                                      (14, "dict_filter"), (19, "dict_filter")])
def test_kernel_calls_per_run_match_jax(q, kernel, tpch_dir, monkeypatch):
    # one stage run calls the kernel wrapper as often as the JAX package
    # calls its Pallas kernel per trace: the port memoizes each join's
    # lookup per run and lane, as XLA's CSE and the reference's memo do
    import ballista_tpu.ops.tpu.pallas_kernels as jpk
    import ballista_tpu.ops.tpu.stage_compiler as jsc
    from ballista_tpu_torch.ops.cuda import cuda_kernels as tck

    calls = {"jax": 0, "port": 0}

    def counting(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jpk, kernel, counting("jax", getattr(jpk, kernel)))
    monkeypatch.setattr(tck, kernel, counting("port", getattr(tck, kernel)))
    mode = {"ballista.tpu.fusion.mode": "fused_pallas"}
    jsc.clear_device_caches()  # a fresh trace: JAX calls the kernel while tracing
    _jax_ctx(tpch_dir, **mode).sql(tpch_query(q)).collect()
    _port_ctx(tpch_dir, **mode).sql(tpch_query(q)).collect()
    assert calls["jax"] >= 1
    assert calls["port"] == calls["jax"]


@pytest.mark.parametrize("q", [5, 12])
def test_fusion_decision_matches_jax_on_the_card_platform(q, tpch_dir):
    # with the platform set to the kernel family's (tpu / cuda), q5 asks
    # for fused_pallas (G=32) and q12 for fused_xla (expansion lanes), with
    # the reference's reasons
    import ballista_tpu.engine.tpu_engine as jeng
    import ballista_tpu.ops.tpu.fusion as jfus
    import ballista_tpu.ops.tpu.stage_compiler as jsc
    import ballista_tpu_torch.engine.cuda_engine as teng
    import ballista_tpu_torch.ops.cuda.fusion as tfus
    import ballista_tpu_torch.ops.cuda.stage_compiler as tsc
    from ballista_tpu.plan.physical import TaskContext as JTask
    from ballista_tpu_torch.plan.physical import TaskContext as TTask

    decisions = []
    for eng, sc, fus, mk, task_cls, platform in (
            (jeng, jsc, jfus, _jax_ctx, JTask, "tpu"),
            (teng, tsc, tfus, _port_ctx, TTask, "cuda")):
        ctx = mk(tpch_dir)
        st = _partial_stage(eng, sc.TpuStageExec, ctx, q)
        task = task_cls(ctx.config)
        if platform == "tpu":
            dt = sc.DEVICE_CACHE.get(st.scan, st.buckets, task, 1 << 40)
            builds = [st._prepare_build(op, i, task, sc.DEVICE_CACHE.key_of(st.scan))
                      for i, op in enumerate(o for o in st.ops
                                             if type(o).__name__ == "HashJoinExec")]
        else:
            cpu = torch.device("cpu")
            dt = sc.DEVICE_CACHE.get(st.scan, st.buckets, task, 1 << 40, cpu)
            builds = [st._prepare_build(op, i, task, sc.DEVICE_CACHE.key_of(st.scan), cpu)
                      for i, op in enumerate(o for o in st.ops
                                             if type(o).__name__ == "HashJoinExec")]
        est = fus.estimate_stage(st.scan, st.ops, st.partial_agg, dt, builds)
        cm = fus.CostModel.from_config(ctx.config)
        cm.platform = platform
        dec = cm.choose(est)
        decisions.append((dec.mode, dec.reason, est.lanes, est.group_domain,
                          est.max_probe_table))
    assert decisions[1] == decisions[0]
    if q == 5:
        assert decisions[1][:2] == ("fused_pallas",
                                    "grouped agg, G=32 fits the kernel family")
    else:
        assert decisions[1][0] == "fused_xla" and "expansion lanes" in decisions[1][1]


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


@pytest.mark.parametrize("q", DEVICE_QUERIES)
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


@pytest.mark.parametrize("q,kernel", [(5, "hash_probe"), (12, "dict_filter")])
def test_gather_kernel_launch_failure_raises_out_of_collect(q, kernel, tpch_dir,
                                                             monkeypatch):
    # a failed launch of hash_probe / dict_filter (the wrapper's
    # RuntimeError on a non-zero CUDA status) fails the query instead of
    # re-running the stage on the CPU engine
    from ballista_tpu_torch.ops.cuda import cuda_kernels
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    def failed_launch(*args):
        raise RuntimeError(f"{kernel} launch failed: CUDA error 719")

    monkeypatch.setattr(cuda_kernels, kernel, failed_launch)
    ctx = _port_ctx(tpch_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
    phys, stages = _run_stages(ctx, q)
    with pytest.raises(RuntimeError, match="launch failed"):
        ctx.execute_collect(phys)
    assert any(isinstance(s, TpuStageExec) for s in stages)
    assert all(s.fallback_count == 0 for s in stages)


def test_filtered_nan_row_stays_out_of_every_group_under_fused_pallas(monkeypatch):
    # ROADMAP C4: a NaN row that the WHERE clause removes must not reach any
    # group's SUM through masked_group_reduce; the device engine answers as
    # the port's CPU engine does. Values are halves, so the kernel's f32
    # sums are exact and the answers equal.
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import cuda_kernels

    rng = np.random.default_rng(4)
    n = 2000
    x = rng.integers(-40, 40, n) / 2.0
    keep = rng.random(n) < 0.8
    x[17], keep[17] = np.nan, False
    tbl = pa.table({"k": rng.choice(["a", "b", "c", "d", "e"], n), "x": x,
                    "keep": keep.astype(np.int64)})
    sql = "select k, sum(x) s, count(*) c from t where keep = 1 group by k order by k"
    calls = []
    real = cuda_kernels.masked_group_reduce

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(cuda_kernels, "masked_group_reduce", counting)
    answers = []
    for engine in ("tpu", "cpu"):
        ctx = SessionContext(BallistaConfig({**BASE_CFG, "ballista.executor.engine": engine,
                                             "ballista.tpu.fusion.mode": "fused_pallas"}))
        ctx.register_arrow_table("t", tbl, partitions=2)
        answers.append(ctx.sql(sql).collect())
    got, want = answers
    assert calls, "masked_group_reduce was not called"
    assert not np.isnan(got.column("s").to_numpy()).any()
    assert got.equals(want)


# -- the JAX package's join tests (tests/test_tpu_engine.py), on the port --
#
# Each runs the port's engine=tpu in auto mode with the device path asserted
# (no CPU fallback), and compares with the port's engine=cpu and with the
# JAX package's engine=tpu on the same tables, grouped as the JAX tests
# group them (int64 keys go through the sorted aggregation).


def _oracle(sql, tables):
    """(port tpu, port cpu, jax tpu) answers for `sql` over `tables`."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import TaskContext

    out = []
    for pkg, engine in (("ballista_tpu_torch", "tpu"), ("ballista_tpu_torch", "cpu"),
                        ("ballista_tpu", "tpu")):
        ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
        cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
        ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(
            {**BASE_CFG, "ballista.executor.engine": engine}))
        for name, tbl in tables.items():
            ctx.register_arrow_table(name, tbl, partitions=2)
        out.append(ctx.sql(sql).collect())
        if pkg == "ballista_tpu_torch" and engine == "tpu":
            phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
            stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
            assert stages, "no device stage compiled"
            task = TaskContext(ctx.config)
            for p in range(phys.output_partition_count()):
                list(phys.execute(p, task))
            assert sum(s.tpu_count for s in stages) >= 1
            assert sum(s.fallback_count for s in stages) == 0, "cpu fallback"
    return out


def test_q5_join_pipeline_on_device(tpch_dir):
    # q5's 4-join probe chain compiles into one device stage and runs there
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import TaskContext

    ctx = _port_ctx(tpch_dir)
    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(tpch_query(5)).plan), ctx.config)
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages
    joins = [op for s in stages for op in s.ops if type(op).__name__ == "HashJoinExec"]
    assert len(joins) >= 3
    task = TaskContext(ctx.config)
    for p in range(phys.output_partition_count()):
        list(phys.execute(p, task))
    assert sum(s.tpu_count for s in stages) >= 1
    assert sum(s.fallback_count for s in stages) == 0


def test_expansion_join_on_device(tpch_dir, port_cpu_answers):
    # q12's build side (filtered lineitem) has duplicate join keys: the
    # expansion lanes keep it on the device, with the CPU engine's answer
    from ballista_tpu.testing.reference import compare_results
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    ctx = _port_ctx(tpch_dir)
    phys, stages = _run_stages(ctx, 12)
    got = ctx.execute_collect(phys)
    want = port_cpu_answers[12]
    problems = compare_results(got, want.to_pandas(date_as_object=False), 12, rtol=1e-9)
    assert not problems, "\n".join(problems)
    partial = [s for s in stages if isinstance(s, TpuStageExec)]
    assert partial and all(s.tpu_count >= 1 and s.fallback_count == 0 for s in partial)
    # the lineitem build of q12 repeats its keys: the stage unrolled lanes
    import zlib

    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    rec = RUN_STATS.stages()[f"stage_{zlib.crc32(partial[0].fingerprint.encode()):08x}"]
    assert "expansion lanes" in rec["fusion_reason"]


def test_nullable_probe_key_join_on_device():
    """Inner join whose probe key has NULLs: null keys match nothing."""
    rng = np.random.default_rng(5)
    n = 4000
    key = rng.integers(0, 100, n).astype("int64")
    null_key = rng.random(n) < 0.25
    probe = pa.table({
        "fk": pa.array([None if m else int(v) for v, m in zip(key, null_key)], pa.int64()),
        "amt": np.round(rng.uniform(1, 10, n), 2),
    })
    build = pa.table({
        "id": pa.array(np.arange(100), pa.int64()),
        "cat": pa.array([f"c{i % 5}" for i in range(100)]),
    })
    sql = ("SELECT cat, count(*) AS c, sum(amt) AS s FROM probe "
           "JOIN build ON fk = id GROUP BY cat ORDER BY cat")
    tpu, cpu, jax_tpu = _oracle(sql, {"probe": probe, "build": build})
    assert tpu.equals(jax_tpu)
    tp, cp = tpu.to_pandas(), cpu.to_pandas()
    assert tp.cat.tolist() == cp.cat.tolist()
    assert tp.c.tolist() == cp.c.tolist()
    assert np.allclose(tp.s.values, cp.s.values, atol=1e-6)


def test_right_outer_join_on_device():
    """Right outer join (emit every probe row; NULL build columns on miss):
    unmatched rows ride lane 0 with invalid gathers, count(build_col)
    skips them."""
    rng = np.random.default_rng(3)
    n = 6000
    probe = pa.table({
        "ck": rng.integers(0, 200, n).astype("int64"),  # some keys miss
        "amt": np.round(rng.uniform(1, 10, n), 2),
    })
    build = pa.table({
        "id": pa.array(np.arange(0, 120), pa.int64()),   # ids 120..199 unmatched
        "grp": pa.array([f"g{i % 4}" for i in range(120)]),
        "w": pa.array(np.arange(0, 120).astype("float64") / 2),
    })
    sql = ("SELECT ck, count(w) AS cw, count(*) AS c, sum(amt) AS s "
           "FROM build RIGHT JOIN probe ON id = ck GROUP BY ck ORDER BY ck")
    tpu, cpu, jax_tpu = _oracle(sql, {"probe": probe, "build": build})
    assert tpu.equals(jax_tpu)
    tp, cp = tpu.to_pandas(), cpu.to_pandas()
    assert tp.ck.tolist() == cp.ck.tolist()
    assert tp.cw.tolist() == cp.cw.tolist()
    assert tp.c.tolist() == cp.c.tolist()
    assert np.allclose(tp.s.values, cp.s.values, atol=1e-6)
    # the miss range exists, so count(w) < count(*) somewhere
    assert (tp.cw.values < tp.c.values).any()


def test_filtered_semi_anti_join_on_device():
    """EXISTS / NOT EXISTS with a correlated residual predicate (the q21
    shape: l2.l_suppkey <> l1.l_suppkey) lowers to an OR across build match
    lanes on the device."""
    rng = np.random.default_rng(9)
    n = 5000
    t1 = pa.table({
        "ok": rng.integers(0, 400, n).astype("int64"),
        "sk": rng.integers(0, 10, n).astype("int64"),
        "v": np.round(rng.uniform(1, 5, n), 2),
    })
    m = 2000
    t2 = pa.table({
        "ok2": rng.integers(0, 400, m).astype("int64"),
        "sk2": rng.integers(0, 10, m).astype("int64"),
    })
    for kw in ("EXISTS", "NOT EXISTS"):
        sql = (f"SELECT sk, count(*) AS c, sum(v) AS s FROM t1 WHERE {kw} "
               f"(SELECT 1 FROM t2 WHERE ok2 = ok AND sk2 <> sk) "
               f"GROUP BY sk ORDER BY sk")
        tpu, cpu, jax_tpu = _oracle(sql, {"t1": t1, "t2": t2})
        assert tpu.equals(jax_tpu), kw
        tp, cp = tpu.to_pandas(), cpu.to_pandas()
        assert tp.sk.tolist() == cp.sk.tolist(), kw
        assert tp.c.tolist() == cp.c.tolist(), kw
        assert np.allclose(tp.s.values, cp.s.values, atol=1e-6), kw


def test_aggregate_through_join_multiplicity():
    """count(build_col) through a dup >> 16 expansion join uses match-count
    gathers (no lane unrolling, no MAX_JOIN_DUP ceiling): the q13 shape."""
    rng = np.random.default_rng(21)
    n = 3000
    build = pa.table({
        "fk": rng.integers(0, 60, n).astype("int64"),  # up to ~70 dups per key
        "bid": pa.array(np.arange(n), pa.int64()),
    })
    probe = pa.table({
        "id": pa.array(np.arange(80), pa.int64()),     # ids 60..79 unmatched
        "grp": pa.array([i % 7 for i in range(80)], pa.int64()),
    })
    for jt, sqljoin in (("inner", "JOIN"), ("outer", "RIGHT JOIN")):
        sql = (f"SELECT grp, count(bid) AS cb, count(*) AS c FROM build "
               f"{sqljoin} probe ON fk = id GROUP BY grp ORDER BY grp")
        tpu, cpu, jax_tpu = _oracle(sql, {"probe": probe, "build": build})
        assert tpu.equals(jax_tpu), jt
        tp, cp = tpu.to_pandas(), cpu.to_pandas()
        assert tp.grp.tolist() == cp.grp.tolist(), jt
        assert tp.cb.tolist() == cp.cb.tolist(), jt
        assert tp.c.tolist() == cp.c.tolist(), jt


def test_same_shape_stages_with_different_builds_do_not_collide():
    """Two stages identical except for the FILTER on a join's build side
    must not share build tables: the stage fingerprint carries the full
    build subtree."""
    rng = np.random.default_rng(41)
    n = 5000
    fact = pa.table({
        "fk": rng.integers(0, 200, n).astype("int64"),
        "v": rng.integers(0, 100, n).astype("int64"),
    })
    dim = pa.table({
        "id": pa.array(np.arange(200), pa.int64()),
        "moy": pa.array((np.arange(200) % 12) + 1, pa.int64()),
    })
    t1 = "SELECT count(*) c, sum(v) s FROM fact JOIN dim ON fk = id WHERE moy = 1"
    t2 = "SELECT count(*) c, sum(v) s FROM fact JOIN dim ON fk = id WHERE moy = 2"
    tpu1, cpu1, jax1 = _oracle(t1, {"fact": fact, "dim": dim})
    tpu2, cpu2, jax2 = _oracle(t2, {"fact": fact, "dim": dim})
    assert tpu1.equals(jax1) and tpu2.equals(jax2)
    p1, p2 = tpu1.to_pandas(), tpu2.to_pandas()
    assert p1.c[0] == cpu1.to_pandas().c[0]
    assert p2.c[0] == cpu2.to_pandas().c[0]
    assert (p1.c[0], p1.s[0]) != (p2.c[0], p2.s[0])
