"""The reference's device-engine checks that had no port counterpart, run
through the port and held against the JAX package where both can run:

- the mesh AQE rungs (tests/test_aqe.py `test_mesh_aqe_demote_vs_replan`):
  a hot bucket demotes the fused exchange, a uniformly small input replans
  its bucket count, a demoted exchange is left alone, through the port's
  `scheduler/aqe/rules.py` `apply_aqe` and `MeshExchangeExec`;
- engine=tpu's collect budget (tests/test_dynamic_join.py
  `test_tpu_engine_raises_collect_budget`): a 5M-row build plans as a
  collect build under engine=tpu and is deferred under engine=cpu;
- process isolation (tests/test_process_isolation.py): engine=tpu stays
  in-thread, and under engine=cpu a task that kills its worker (`hard_crash`
  from the port's testing/udf_fixtures.py) fails retryably while the
  cluster serves on;
- the decimal money lane (tests/test_decimal_exact.py
  `test_tpu_engine_decimal_money_lane`);
- variance under engine=tpu (tests/test_variance.py
  `test_variance_tpu_engine_correct`);
- device scans stay whole in the task builder (tests/test_task_builder.py
  `test_tpu_engine_keeps_full_scans`).

`tests/test_device_binding.py` has no counterpart here: two in-process
executors pinned to two cards need a multi-card host (ROADMAP). The port's
device engine runs its CPU forms (runtime.use_cpu()). Where no tolerance is
stated, comparisons are exact.
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan, tpch_query

D = decimal.Decimal


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _mod(pkg: str, path: str, *names):
    """`path` under `pkg`, with `ops.cuda` for the reference's `ops.tpu`."""
    if pkg == "ballista_tpu_torch":
        path = path.replace("ops.tpu", "ops.cuda").replace("engine.tpu_engine",
                                                            "engine.cuda_engine")
    return __import__(f"{pkg}.{path}", fromlist=list(names) or ["__name__"])


# ------------------------------------------------------------- mesh rungs


def _mesh_stage_plan(pkg: str, buckets: int = 8):
    MeshExchangeExec = _mod(pkg, "ops.tpu.mesh_stage").MeshExchangeExec
    Column = _mod(pkg, "plan.expressions").Column
    MemoryScanExec = _mod(pkg, "plan.physical").MemoryScanExec
    DFSchema = _mod(pkg, "plan.schema").DFSchema
    ShuffleWriterExec = _mod(pkg, "shuffle.writer").ShuffleWriterExec

    t = pa.table({"k": np.arange(64, dtype="int64")})
    scan = MemoryScanExec(DFSchema.from_arrow(t.schema), t.to_batches(), 4)
    ex = MeshExchangeExec(scan, [Column("k")], buckets)
    return ShuffleWriterExec(ex, "jm", 2, buckets, [Column("k")]), ex


def _mesh_stats(pkg: str, bucket_bytes):
    InputStageStats = _mod(pkg, "scheduler.aqe.rules").InputStageStats
    return {1: InputStageStats(
        stage_id=1, total_rows=sum(bucket_bytes) // 8,
        total_bytes=sum(bucket_bytes), bucket_bytes=list(bucket_bytes),
        broadcast=False)}


def _mesh_rungs(pkg: str) -> list:
    """The three rungs of the reference's test in `pkg`: per rung the
    new partition count, whether a report came back, the exchange's demote
    reason and file partitions, and the replan counter's growth."""
    cfg_mod = _mod(pkg, "config")
    apply_aqe = _mod(pkg, "scheduler.aqe.rules").apply_aqe
    MeshExchangeExec = _mod(pkg, "ops.tpu.mesh_stage").MeshExchangeExec
    RUN_STATS = _mod(pkg, "ops.tpu.stage_compiler").RUN_STATS

    def replans() -> int:
        return int(RUN_STATS.snapshot().get("aqe_mesh_replans", 0) or 0)

    cfg = cfg_mod.BallistaConfig({
        cfg_mod.PLANNER_ADAPTIVE_ENABLED: True,
        cfg_mod.AQE_SKEW_MIN_BYTES: 1024,
        cfg_mod.AQE_TARGET_PARTITION_BYTES: 64 * 1024,
    })
    out = []
    before = replans()
    for rung, bucket_bytes in (("hot", [4096] * 7 + [1 << 20]), ("small", [8192] * 8),
                               ("demoted", [8192] * 8)):
        plan, ex = _mesh_stage_plan(pkg)
        if rung == "demoted":
            ex.demote_reason = "capacity"
        new_plan, new_parts, report = apply_aqe(plan, _mesh_stats(pkg, bucket_bytes), cfg,
                                                stage_partitions=8)
        (node,) = [n for n in iter_plan(new_plan) if isinstance(n, MeshExchangeExec)]
        out.append((rung, new_parts, report is None, node.demote_reason or "",
                    node.file_partitions, replans() - before))
    return out


def test_mesh_aqe_demote_vs_replan():
    """Rung 1: a hot bucket demotes the exchange (aqe:skew) instead of
    splitting under it; rung 2: a uniformly small input replans the device
    bucket count; rung 3: an exchange demoted for capacity is left alone.
    The port's outcomes are the reference's."""
    port = _mesh_rungs("ballista_tpu_torch")
    (hot, small, demoted) = port
    assert hot[1] is None and hot[2] and hot[3] == "aqe:skew" and hot[5] == 1
    assert small[2] and small[1] is not None and 0 < small[1] <= 4
    assert small[4] == small[1] and small[3] == "" and small[5] == 2
    assert demoted[1] is None and demoted[2] and demoted[3] == "capacity" and demoted[5] == 2
    assert port == _mesh_rungs("ballista_tpu")


# ------------------------------------------------------- collect budget


def _join_plan(pkg: str, engine: str) -> list:
    ctx_mod = _mod(pkg, "client.context")
    cfg_mod = _mod(pkg, "config")
    prov = _mod(pkg, "plan.provider")

    class BigStats(prov.MemoryTable):
        def __init__(self, batches, schema=None, partitions=1, rows=0):
            super().__init__(batches, schema, partitions)
            self._rows = rows

        def statistics(self):
            return prov.TableStats(num_rows=self._rows, total_bytes=self._rows * 64)

    build = pa.table({"k": np.arange(100, dtype="int64"), "v": np.arange(100.0)})
    probe = pa.table({"k": np.arange(100, dtype="int64"), "w": np.arange(100.0)})
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig({cfg_mod.EXECUTOR_ENGINE: engine}))
    # build 5M rows: past the CPU 1M-row broadcast cap, well under the 16M
    # tpu collect budget; probe 40M keeps the build side the build
    ctx.register_table("b", BigStats(build.to_batches(), build.schema,
                                     partitions=4, rows=5_000_000))
    ctx.register_table("p", BigStats(probe.to_batches(), probe.schema,
                                     partitions=4, rows=40_000_000))
    sql = "SELECT sum(w + v) AS s FROM p JOIN b ON p.k = b.k"
    return [(type(n).__name__, getattr(n, "mode", None))
            for n in iter_plan(ctx.create_physical_plan(ctx.sql(sql).plan))]


@pytest.mark.parametrize("engine", ["tpu", "cpu"])
def test_tpu_engine_raises_collect_budget(engine):
    """engine=tpu plans the 5M-row build as a collect build, the only shape
    a device stage takes; engine=cpu defers it to runtime selection. The
    port plans every node as the reference does."""
    nodes = _join_plan("ballista_tpu_torch", engine)
    joins = [mode for name, mode in nodes if name == "HashJoinExec"]
    dynamic = any(name == "DynamicJoinSelectionExec" for name, _ in nodes)
    if engine == "tpu":
        assert joins and all(m == "collect_left" for m in joins), nodes
        assert not dynamic
    else:
        assert dynamic, nodes
    assert nodes == _join_plan("ballista_tpu", engine)


# ---------------------------------------------------- process isolation


@pytest.fixture()
def two_tables(tmp_path):
    rng = np.random.default_rng(3)
    n = 20000
    t = pa.table({
        "k": rng.integers(0, 50, n).astype("int64"),
        "v": np.round(rng.random(n) * 100, 3),
    })
    (tmp_path / "t").mkdir()
    pq.write_table(t, str(tmp_path / "t" / "part-0.parquet"))
    return str(tmp_path / "t")


def test_tpu_engine_stays_in_thread(two_tables):
    """engine=tpu never spawns per-task workers (each would claim the card
    again and rebuild the device caches): the dispatch stays in-thread and
    the query answers."""
    from unittest import mock

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import EXECUTOR_ENGINE, EXECUTOR_TASK_ISOLATION, BallistaConfig

    cfg = BallistaConfig({EXECUTOR_TASK_ISOLATION: "process", EXECUTOR_ENGINE: "tpu"})
    ctx = SessionContext.standalone(cfg, num_executors=1, vcores=2)
    try:
        ctx.register_parquet("t", two_tables)
        with mock.patch(
                "ballista_tpu_torch.executor.process_worker.run_task_in_subprocess",
                side_effect=AssertionError("device task must not spawn")) as m:
            out = ctx.sql("SELECT count(*) AS c FROM t").collect()
        assert out.column("c").to_pylist() == [20000]
        assert m.call_count == 0
    finally:
        ctx.shutdown()


def test_worker_crash_contained(two_tables):
    """Under engine=cpu with process isolation, a task that kills its
    interpreter (`hard_crash`) fails as a retryable task error, and the
    executor, scheduler and cluster serve the next query."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import EXECUTOR_TASK_ISOLATION, BallistaConfig
    from ballista_tpu_torch.errors import ExecutionError
    from ballista_tpu_torch.testing.udf_fixtures import hard_crash

    cfg = BallistaConfig({EXECUTOR_TASK_ISOLATION: "process"})
    ctx = SessionContext.standalone(cfg, num_executors=1, vcores=2)
    try:
        ctx.register_parquet("t", two_tables)
        ctx.register_udf("hard_crash", hard_crash, pa.int64())
        with pytest.raises(ExecutionError) as ei:
            ctx.sql("SELECT sum(hard_crash(k)) FROM t").collect()
        assert "worker died" in str(ei.value)
        out = ctx.sql("SELECT count(*) AS c FROM t").collect()
        assert out.column("c").to_pylist() == [20000]
    finally:
        ctx.shutdown()


# ----------------------------------------------------- decimal money lane


@pytest.fixture(scope="module")
def dec_tpch_dir(tmp_path_factory, tpch_dir):
    """TPC-H SF0.01 with the money columns cast to decimal(15,2)."""
    import glob
    import os

    out = tmp_path_factory.mktemp("dec_tpch")
    money = {
        "lineitem": ["l_extendedprice", "l_discount", "l_tax", "l_quantity"],
        "orders": ["o_totalprice"], "customer": ["c_acctbal"],
        "supplier": ["s_acctbal"], "part": ["p_retailprice"],
        "partsupp": ["ps_supplycost"], "nation": [], "region": [],
    }
    for table, cols in money.items():
        os.makedirs(out / table, exist_ok=True)
        for i, f in enumerate(sorted(glob.glob(f"{tpch_dir}/{table}/*.parquet"))):
            t = pq.read_table(f)
            for c in cols:
                if c in t.column_names:
                    t = t.set_column(t.column_names.index(c), c,
                                     t.column(c).cast(pa.decimal128(15, 2)))
            pq.write_table(t, out / table / f"part{i}.parquet")
    return str(out)


def _tpch_ctx(pkg: str, data_dir: str, engine: str):
    ctx_mod = _mod(pkg, "client.context")
    cfg_mod = _mod(pkg, "config")
    gen = _mod(pkg, "testing.tpchgen")
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(
        {cfg_mod.EXECUTOR_ENGINE: engine, cfg_mod.TPU_MIN_ROWS: 0}))
    gen.register_tpch(ctx, data_dir)
    return ctx


def test_tpu_engine_decimal_money_lane(dec_tpch_dir):
    """Decimal columns ride the device as unscaled int64 (exact, no float
    sniffing); q6 and q1 agree with the CPU engine (decimals within 2 units
    of their scale, floats rtol 1e-9, the rest exact), and the port's
    device answers equal the reference's device answers byte for byte."""
    from ballista_tpu_torch.ops.cuda.columnar import encode_column

    col = encode_column(pa.array([D("10.25"), None, D("7.75")], pa.decimal128(15, 2)))
    assert col is not None and col.kind == "money" and col.scale == 2
    assert list(col.data) == [1025, 0, 775] and list(col.valid) == [True, False, True]

    tpu = _tpch_ctx("ballista_tpu_torch", dec_tpch_dir, "tpu")
    cpu = _tpch_ctx("ballista_tpu_torch", dec_tpch_dir, "cpu")
    ref = _tpch_ctx("ballista_tpu", dec_tpch_dir, "tpu")
    for q in (6, 1):
        got_tbl = tpu.sql(tpch_query(q)).collect()
        got, want = got_tbl.to_pandas(), cpu.sql(tpch_query(q)).collect().to_pandas()
        assert len(got) == len(want)
        for c in want.columns:
            gv, wv = got[c].values, want[c].values
            if want[c].dtype.kind == "f":
                assert np.allclose(gv.astype(float), wv.astype(float), rtol=1e-9), c
            elif want[c].dtype == object and len(wv) and isinstance(wv[0], D):
                for g, w in zip(gv, wv):
                    assert abs(D(str(g)) - w) <= D("0.01") * 2, (c, g, w)
            else:
                assert (gv == wv).all(), c
        want_ref = ref.sql(tpch_query(q)).collect()
        assert got_tbl.schema.equals(want_ref.schema)
        assert got_tbl.equals(want_ref)


# -------------------------------------------------------------- variance


def _variance_answer(pkg: str, engine: str) -> pa.Table:
    ctx_mod = _mod(pkg, "client.context")
    cfg_mod = _mod(pkg, "config")
    prov = _mod(pkg, "plan.provider")
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(
        {cfg_mod.EXECUTOR_ENGINE: engine, cfg_mod.TPU_MIN_ROWS: 0}))
    rng = np.random.default_rng(7)
    k = rng.integers(0, 5, 2000)
    v = rng.normal(100.0, 25.0, 2000)
    t = pa.table({"k": pa.array(k, pa.int64()), "v": pa.array(v, pa.float64())})
    ctx.register_table("t", prov.MemoryTable(t.to_batches()))
    return ctx.sql(
        "select k, stddev(v) as sd, var_pop(v) as vp from t group by k order by k"
    ).collect()


def test_variance_tpu_engine_correct():
    """Welford partials are not lifted to the device: engine=tpu answers
    stddev and var_pop within 1e-9 of pandas through its CPU fallback, and
    byte-identically to the reference's engine=tpu."""
    got = _variance_answer("ballista_tpu_torch", "tpu")
    rng = np.random.default_rng(7)
    k = rng.integers(0, 5, 2000)
    v = rng.normal(100.0, 25.0, 2000)
    import pandas as pd

    g = pd.DataFrame({"k": k, "v": v}).groupby("k")["v"]
    out = got.to_pandas()
    for i in range(5):
        assert abs(out.sd[i] - g.std().iloc[i]) < 1e-9
        assert abs(out.vp[i] - g.var(ddof=0).iloc[i]) < 1e-9
    assert got.equals(_variance_answer("ballista_tpu", "tpu"))


# ---------------------------------------------------------- task builder


def _restricted(pkg: str, engine: str | None) -> tuple:
    cfg_mod = _mod(pkg, "config")
    phys = _mod(pkg, "plan.physical")
    DFSchema = _mod(pkg, "plan.schema").DFSchema
    Column = _mod(pkg, "plan.expressions").Column
    ShuffleReaderExec = _mod(pkg, "shuffle.reader").ShuffleReaderExec
    types = _mod(pkg, "shuffle.types")
    restrict = _mod(pkg, "scheduler.task_builder").restrict_plan_to_partitions

    schema = DFSchema.from_arrow(pa.schema([("k", pa.int64()), ("v", pa.float64())]), "t")
    locs = [[types.PartitionLocation(
        map_partition=m, job_id="j", stage_id=1, output_partition=p,
        executor_id=f"e{m}", host=f"host-{m}.example.com", flight_port=50051,
        path=f"/work/j/1/{p}/data-{m}.arrow", layout="hash",
        stats=types.PartitionStats(100, 1000)) for m in range(2)] for p in range(8)]
    scan = phys.ParquetScanExec(schema, [{"files": [{"file": f"/d/{i}.parquet"}]}
                                         for i in range(8)], ["k", "v"], [], "t")
    reader = ShuffleReaderExec(schema, locs)
    join = phys.HashJoinExec(scan, reader, [(Column("k", "t"), Column("k", "t"))],
                             "inner", None, "partitioned", schema.merge(schema))
    cfg = cfg_mod.BallistaConfig({cfg_mod.EXECUTOR_ENGINE: engine} if engine else {})
    out = restrict(join, [2], cfg)
    return ([len(p["files"]) for p in out.children()[0].partitions],
            [len(loc) for loc in out.children()[1].partition_locations])


def test_tpu_engine_keeps_full_scans():
    """engine=tpu keeps a device scan whole (the device table is keyed on
    the scan's file set) while the reader's list still shrinks; the CPU
    engine restricts both. The same lists as the reference's."""
    tpu = _restricted("ballista_tpu_torch", "tpu")
    assert tpu == ([1] * 8, [0, 0, 2, 0, 0, 0, 0, 0])
    cpu = _restricted("ballista_tpu_torch", None)
    assert cpu[0] == [0, 0, 1, 0, 0, 0, 0, 0]
    assert (tpu, cpu) == (_restricted("ballista_tpu", "tpu"), _restricted("ballista_tpu", None))
