"""The port's serving surface against the JAX package's, on the CPU.

Plan normalization (`lift_parameters`, `bind_logical`) over TPC-H q1-q22,
the serving submit path against the plan-cache-off path, the fast lane
against the full DAG, and prepared statements in the local, standalone
and remote modes. The port runs after runtime.use_cpu() with engine=tpu
and `fusion.mode=fused_pallas`, so its device stages run and the kernel
wrappers take their plain forms; the JAX package runs its local mode with
JAX_PLATFORMS=cpu (Pallas in interpret mode). Every prepared execution
binds its values into the cached template, in the order A, B, A: each
answer must be byte-identical to a fresh non-prepared run of the same text
with those literals in the same mode, and to the JAX package's prepared
answer in its local mode (floats within rtol 1e-9 for a distributed run).
"""

import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import tpch_query
from .test_torch_standalone import assert_same_answer

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0,
            "ballista.tpu.fusion.mode": "fused_pallas"}

# (statement, the B text's replacements, the kernel wrapper it reaches):
# q6's dates, discount and quantity; q5's region name, a filter on a join's
# build side (hash_probe); q12 with its ship modes as `=` predicates, which
# reach dict_filter's LUTs. An IN list's values are part of the plan's
# shape in both packages (InList holds plain values, not Literal slots).
Q12_OR = tpch_query(12).replace("l_shipmode in ('MAIL', 'SHIP')",
                                "(l_shipmode = 'MAIL' or l_shipmode = 'SHIP')")
YEAR_ON = [("date '1995-01-01'", "date '1996-01-01'"),
           ("date '1994-01-01'", "date '1995-01-01'")]
STATEMENTS = {
    "q6": (tpch_query(6), YEAR_ON + [("0.05 and 0.07", "0.04 and 0.06"), ("< 24", "< 30")],
           None),
    "q5": (tpch_query(5), [("'ASIA'", "'EUROPE'")] + YEAR_ON, "hash_probe"),
    "q12": (Q12_OR, [("'MAIL'", "'AIR'"), ("'SHIP'", "'RAIL'")], "dict_filter"),
}


def _b_text(name):
    text, reps, _ = STATEMENTS[name]
    for a, b in reps:
        assert a in text, (name, a)
        text = text.replace(a, b)
    return text


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _ctx(pkg, tpch_dir, mode="local", addr="", executors=1, **extra):
    if pkg == "port":
        from ballista_tpu_torch.client.context import SessionContext
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.testing.tpchgen import register_tpch
    else:
        from ballista_tpu.client.context import SessionContext
        from ballista_tpu.config import BallistaConfig
        from ballista_tpu.testing.tpchgen import register_tpch
    cfg = BallistaConfig({**BASE_CFG, **extra})
    if mode == "standalone":
        ctx = SessionContext.standalone(cfg, num_executors=executors, vcores=4)
    elif mode == "remote":
        ctx = SessionContext.remote(addr, cfg)
    else:
        ctx = SessionContext(cfg)
    register_tpch(ctx, tpch_dir)
    return ctx


def _lift(pkg, ctx, sql):
    if pkg == "port":
        from ballista_tpu_torch.serving.normalize import lift_parameters
        from ballista_tpu_torch.sql.optimizer import optimize
        from ballista_tpu_torch.sql.parser import parse_sql
        from ballista_tpu_torch.sql.planner import SqlPlanner
    else:
        from ballista_tpu.serving.normalize import lift_parameters
        from ballista_tpu.sql.optimizer import optimize
        from ballista_tpu.sql.parser import parse_sql
        from ballista_tpu.sql.planner import SqlPlanner
    return lift_parameters(optimize(SqlPlanner(ctx.catalog).plan_query(parse_sql(sql))))


@pytest.fixture(scope="module")
def local_ctxs(tpch_dir):
    return {pkg: _ctx(pkg, tpch_dir) for pkg in ("port", "jax")}


# -- plan normalization -----------------------------------------------------


@pytest.mark.parametrize("q", range(1, 23))
def test_lift_and_bind_match_reference(q, local_ctxs):
    from ballista_tpu.serving.normalize import bind_logical as jbind
    from ballista_tpu_torch.serving.normalize import bind_logical

    sql = tpch_query(q)
    got = _lift("port", local_ctxs["port"], sql)
    want = _lift("jax", local_ctxs["jax"], sql)
    assert (got.cacheable, got.reason) == (want.cacheable, want.reason)
    assert got.type_tags == want.type_tags
    assert got.values == want.values
    assert got.tables == want.tables
    assert got.key == want.key  # the same masked shape, hashed
    if got.cacheable:
        assert bind_logical(got.tagged, got.values).display() == \
            jbind(want.tagged, want.values).display()


# -- the serving submit path and the fast lane --------------------------------


def _sorted(tbl):
    return tbl.sort_by([(n, "ascending") for n in tbl.column_names])


@pytest.fixture(scope="module")
def standalone(tpch_dir):
    ctx = _ctx("port", tpch_dir, "standalone")
    yield ctx
    ctx.shutdown()


@pytest.mark.parametrize("q", [1, 6])
def test_serving_path_equals_plan_cache_off(q, standalone, tpch_dir):
    off = _ctx("port", tpch_dir, "standalone", **{"ballista.serving.plan.cache.enabled": False})
    try:
        sql = tpch_query(q)
        cold = standalone.sql(sql).collect()
        warm = standalone.sql(sql).collect()  # rides the plan cache
        plain = off.sql(sql).collect()
        assert cold.equals(plain) and warm.equals(plain)
        assert standalone._cluster.scheduler.serving.snapshot()["plan_cache"]["hits"] >= 1
        assert off._cluster.scheduler.serving.snapshot()["plan_cache"]["misses"] == 0
    finally:
        off.shutdown()


def test_fast_lane_equals_full_dag(tpch_dir):
    # a single-stage plan takes the fast lane when every partition finds a
    # slot at once (lineitem's partitions need the two executors' slots)
    sql = "SELECT l_orderkey, l_partkey, l_quantity FROM lineitem WHERE l_quantity < 3"
    fast = _ctx("port", tpch_dir, "standalone", executors=2)
    slow = _ctx("port", tpch_dir, "standalone", executors=2,
                **{"ballista.serving.fast.lane.enabled": False})
    try:
        got = [fast.sql(sql).collect() for _ in range(2)]
        full = slow.sql(sql).collect()
        for r in got:
            assert _sorted(r).equals(_sorted(full))
        assert fast._cluster.scheduler.serving.snapshot()["fast_lane"]["executed"] >= 1, \
            "the fast lane never engaged"
        assert slow._cluster.scheduler.serving.snapshot()["fast_lane"]["executed"] == 0
    finally:
        fast.shutdown()
        slow.shutdown()


# -- prepared statements in every mode -----------------------------------------


@pytest.fixture(scope="module")
def remote_addr():
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1,
                             flight_proxy_port=-1)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    ex = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1",
                         engine="tpu", vcores=2, flight_impl="python")
    ex.start()
    yield addr
    ex.shutdown()
    sched.shutdown()


@pytest.fixture(scope="module")
def params(local_ctxs):
    """A's and B's slot values, as each text lifts in the port (and the
    same in the JAX package)."""
    out = {}
    for name, (text, _reps, _k) in STATEMENTS.items():
        a = _lift("port", local_ctxs["port"], text).values
        b = _lift("port", local_ctxs["port"], _b_text(name)).values
        assert a != b and len(a) == len(b)
        assert _lift("jax", local_ctxs["jax"], _b_text(name)).values == b
        out[name] = (a, b, a)
    return out


@pytest.fixture(scope="module")
def reference_answers(local_ctxs, params):
    """The JAX package's prepared statements in its local mode, A then B
    then A. (Its standalone mode answers B with A's rows under engine=tpu:
    ROADMAP C18, repaired in the port.)"""
    out = {}
    for name, (text, _reps, _k) in STATEMENTS.items():
        ps = local_ctxs["jax"].prepare(text)
        out[name] = [ps.execute(list(p)) for p in params[name]]
    return out


@pytest.mark.parametrize("mode", ["local", "standalone", "remote"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_prepared_binds_fresh_values(mode, name, tpch_dir, local_ctxs, standalone,
                                     remote_addr, params, reference_answers, monkeypatch):
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    calls = {"n": 0}
    kernel = STATEMENTS[name][2]
    if kernel is not None:
        fn = getattr(ck, kernel)

        def counting(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)

        monkeypatch.setattr(ck, kernel, counting)
    ctx = {"local": local_ctxs["port"], "standalone": standalone,
           "remote": _ctx("port", tpch_dir, "remote", remote_addr)}[mode]
    text = STATEMENTS[name][0]
    ps = ctx.prepare(text)
    assert ps.num_params == len(params[name][0])
    try:
        got = [ps.execute(list(p)) for p in params[name]]
    finally:
        ps.close()
    # the executors of every mode run in this process: the wrapper counts
    # the stages' kernel calls (3 executions, at least one call each)
    if kernel is not None:
        assert calls["n"] >= 3, calls
    fresh = [ctx.sql(t).collect() for t in (text, _b_text(name), text)]
    for i, tbl in enumerate(got):
        assert tbl.num_rows > 0
        assert tbl.equals(fresh[i]), f"execution {i} differs from a fresh run"
        want = reference_answers[name][i]
        if mode == "local":
            assert tbl.equals(want), f"execution {i} differs from the JAX package"
        else:
            # a distributed plan merges one partial per partition: its
            # float sums may associate differently from a local run's
            assert_same_answer(tbl, want)
    assert not got[0].equals(got[1])
    if mode == "standalone":
        snap = standalone._cluster.scheduler.serving.snapshot()
        assert snap["plan_cache"]["hits"] >= 3
        assert snap["prepared_statements"] == 0  # close() dropped it


@pytest.mark.parametrize("mode", ["local", "standalone", "remote"])
def test_prepared_arity_is_checked(mode, tpch_dir, local_ctxs, standalone, remote_addr):
    from ballista_tpu_torch.errors import BallistaError, PlanningError

    ctx = {"local": local_ctxs["port"], "standalone": standalone,
           "remote": _ctx("port", tpch_dir, "remote", remote_addr)}[mode]
    ps = ctx.prepare("SELECT l_orderkey FROM lineitem WHERE l_quantity < 3")
    try:
        assert ps.num_params == 1 and ps.type_tags == ["int64"]
        assert ps.execute([7]).num_rows > ps.execute().num_rows > 0
        with pytest.raises((PlanningError, BallistaError)):
            ps.execute([1, 2])
    finally:
        ps.close()


@pytest.mark.parametrize("mode", ["local", "standalone", "remote"])
def test_prepare_rejects_non_select(mode, tpch_dir, local_ctxs, standalone, remote_addr):
    from ballista_tpu_torch.errors import BallistaError, PlanningError

    ctx = {"local": local_ctxs["port"], "standalone": standalone,
           "remote": _ctx("port", tpch_dir, "remote", remote_addr)}[mode]
    with pytest.raises((PlanningError, BallistaError)):
        ctx.prepare("CREATE EXTERNAL TABLE x STORED AS PARQUET LOCATION '/tmp/x'")


def test_local_prepared_stage_runs_on_the_device(local_ctxs):
    # engine=tpu: the bound plan goes through the device rewrite, so a
    # local prepared statement's partial aggregate is a device stage
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.plan.physical import TaskContext
    from ballista_tpu_torch.serving.normalize import bind_logical

    from .conftest import iter_plan

    ctx = local_ctxs["port"]
    ps = ctx.prepare(tpch_query(6))
    bound = bind_logical(ps._local_lift.tagged, ps._local_lift.values)
    phys = maybe_compile_tpu(ctx.create_physical_plan(bound), ctx.config)
    rows = sum(b.num_rows for p in range(phys.output_partition_count())
               for b in phys.execute(p, TaskContext(ctx.config)))
    assert rows == 1
    stages = [n for n in iter_plan(phys) if type(n).__name__ == "TpuStageExec"]
    assert stages and all(s.tpu_count == 1 and s.fallback_count == 0 for s in stages)
