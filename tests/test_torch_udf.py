"""Scalar UDFs through the port (the counterpart of tests/test_udf.py),
with the port's copy of the importable fixtures (testing/udf_fixtures.py).

Beyond the reference's two tests: a device stage whose expressions call a
UDF (`double_it`, `shout`) declines in both packages, the port records the
reason on the stage (`TpuStageExec.decline_reason`), and the query answers
as engine=cpu does, byte-identically to the JAX package. The port's device
engine runs its CPU forms (runtime.use_cpu()).
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime

TPU_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def test_udf_local_sql():
    from ballista_tpu_torch.client.context import SessionContext

    ctx = SessionContext()
    ctx.register_arrow_table("t", pa.table({"x": [1, 2, 3], "s": ["a", "b", "c"]}))

    def triple(a):
        return pc.multiply(pc.cast(a, pa.int64()), 3)

    ctx.register_udf("triple", triple, pa.int64())
    out = ctx.sql("select triple(x) t3 from t where triple(x) > 3 order by t3").collect()
    assert out.column("t3").to_pylist() == [6, 9]


def test_udf_ships_module_to_remote_cluster(tmp_path):
    """UDFs from an importable module run on real remote executors: the
    session config carries the module name, executors import it."""
    import time

    from ballista_tpu_torch import udf as udf_mod
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess
    from ballista_tpu_torch.testing.udf_fixtures import double_it, shout

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1, flight_proxy_port=-1)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    ex = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1", vcores=2)
    ex.start()
    time.sleep(0.2)
    try:
        ctx = SessionContext.remote(addr)
        pq.write_table(pa.table({"x": [5, 6], "s": ["hey", "yo"]}), str(tmp_path / "t.parquet"))
        ctx.register_parquet("t", str(tmp_path / "t.parquet"))
        ctx.register_udf("double_it", double_it, pa.int64())
        ctx.register_udf("shout", shout, pa.string())
        assert "udf_fixtures" in (ctx.config.get(udf_mod.UDF_MODULES) or "")
        out = ctx.sql("select double_it(x) d, shout(s) u from t order by d").collect()
        assert out.column("d").to_pylist() == [10, 12]
        assert out.column("u").to_pylist() == ["HEY!", "YO!"]
    finally:
        ex.shutdown()
        sched.shutdown()


def _table() -> pa.Table:
    rng = np.random.default_rng(5)
    n = 3000
    return pa.table({
        "flag": pa.array(rng.choice(["A", "N", "R"], n)),
        "qty": pa.array(rng.integers(1, 50, n), pa.int64()),
        "name": pa.array(rng.choice(["ab", "cd", "ef", "gh"], n)),
    })


def _session(pkg: str, cfg: dict):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    fx = __import__(f"{pkg}.testing.udf_fixtures", fromlist=["double_it"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(dict(cfg)))
    ctx.register_arrow_table("t", _table(), partitions=3)
    ctx.register_udf("double_it", fx.double_it, pa.int64())
    ctx.register_udf("shout", fx.shout, pa.string())
    return ctx


UDF_QUERIES = {
    "double_it": "SELECT flag, sum(double_it(qty)) AS s, count(*) AS c FROM t "
                 "GROUP BY flag ORDER BY flag",
    "shout": "SELECT flag, sum(qty) AS s FROM t WHERE shout(name) <> 'AB!' "
             "GROUP BY flag ORDER BY flag",
}


@pytest.mark.parametrize("fn", sorted(UDF_QUERIES))
def test_udf_stage_declines_in_both_packages(fn):
    """The device stage holding the UDF declines in both packages (the
    port records why), each of its 3 partitions runs on the CPU engine, and
    the answer equals engine=cpu's and the JAX package's byte for byte."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import TaskContext

    from .conftest import iter_plan

    sql = UDF_QUERIES[fn]
    port = _session("ballista_tpu_torch", TPU_CFG)
    phys = maybe_compile_tpu(port.create_physical_plan(port.sql(sql).plan), port.config)
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages, "no device stage claimed the UDF's aggregate"
    task = TaskContext(port.config)
    batches = [b for p in range(phys.output_partition_count())
               for b in phys.execute(p, task) if b.num_rows]
    got = pa.Table.from_batches(batches, schema=phys.schema())
    (stage,) = stages
    assert stage.tpu_count == 0 and stage.fallback_count == 3
    assert stage.decline_reason == f"scalar fn {fn}"

    want_cpu = _session("ballista_tpu_torch", {}).sql(sql).collect()
    assert got.equals(want_cpu)
    from ballista_tpu.engine.tpu_engine import maybe_compile_tpu as ref_compile
    from ballista_tpu.ops.tpu.stage_compiler import TpuStageExec as RefStage
    from ballista_tpu.plan.physical import TaskContext as RefTask

    ref = _session("ballista_tpu", TPU_CFG)
    rphys = ref_compile(ref.create_physical_plan(ref.sql(sql).plan), ref.config)
    rtask = RefTask(ref.config)
    rbatches = [b for p in range(rphys.output_partition_count())
                for b in rphys.execute(p, rtask) if b.num_rows]
    want = pa.Table.from_batches(rbatches, schema=rphys.schema())
    (rstage,) = [n for n in iter_plan(rphys) if isinstance(n, RefStage)]
    assert rstage.tpu_count == 0 and rstage.fallback_count == 3
    assert got.schema.equals(want.schema)
    assert got.equals(want)
