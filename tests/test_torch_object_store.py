"""S3 scans through the port (the counterpart of tests/test_object_store.py),
over the port's copy of the in-process S3 shim (testing/mini_s3.py): the
real pyarrow S3FileSystem client end to end, registration discovery
(ListObjectsV2), schema reads and ranged GETs.

Beyond the reference's two tests: an `s3://` table reaches the port's
device stage (engine=tpu on the CPU forms, runtime.use_cpu()) and answers
byte-identically to the JAX package's device run over the same objects;
ROADMAP C26, an object rewritten under its key and registered again in a
fresh session, answers the new data in the port, while a test pins that
the reference still serves its stale device table; and the stamp costs one
HEAD request a file per stage run. Comparisons are exact (Arrow `equals`)
unless a tolerance is stated.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime

TPU_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
SUMS_SQL = "SELECT k, sum(v) AS s FROM t GROUP BY k ORDER BY k"


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _serve(root, monkeypatch):
    from ballista_tpu_torch.testing.mini_s3 import start_mini_s3

    srv, endpoint = start_mini_s3(str(root))
    monkeypatch.setenv("AWS_ENDPOINT_URL", endpoint)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test")
    monkeypatch.setenv("AWS_ALLOW_HTTP", "true")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    return srv


@pytest.fixture()
def s3_env(tmp_path, monkeypatch):
    bucket = tmp_path / "test-bucket" / "sales"
    bucket.mkdir(parents=True)
    tbl = pa.table({
        "id": pa.array(range(1000), pa.int64()),
        "region": pa.array([f"r{i % 4}" for i in range(1000)]),
        "amount": pa.array([round(0.25 * (i % 97), 2) for i in range(1000)]),
    })
    pq.write_table(tbl.slice(0, 500), bucket / "part-0.parquet")
    pq.write_table(tbl.slice(500), bucket / "part-1.parquet")
    srv = _serve(tmp_path, monkeypatch)
    yield "s3://test-bucket/sales", tbl
    srv.shutdown()


def _ctx(pkg: str, cfg: dict | None = None):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    return ctx_mod.SessionContext(cfg_mod.BallistaConfig(dict(cfg or {})))


def _stages(physical, name: str) -> list:
    from .conftest import iter_plan

    return [n for n in iter_plan(physical) if type(n).__name__ == name]


def _compiled(ctx, sql: str):
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

    return maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)


def _collect(physical, config) -> pa.Table:
    """What SessionContext.execute_collect does with a compiled plan."""
    from ballista_tpu_torch.plan.physical import TaskContext

    task = TaskContext(config)
    batches = [b for p in range(physical.output_partition_count())
               for b in physical.execute(p, task) if b.num_rows]
    return pa.Table.from_batches(batches, schema=physical.schema())


def _run(ctx, sql: str):
    physical = _compiled(ctx, sql)
    return _collect(physical, ctx.config), physical


def test_s3_scan_end_to_end(s3_env):
    uri, tbl = s3_env
    ctx = _ctx("ballista_tpu_torch")
    ctx.register_parquet("sales", uri)
    out = ctx.sql(
        "SELECT region, count(*) AS c, sum(amount) AS s FROM sales "
        "GROUP BY region ORDER BY region"
    ).collect().to_pandas()
    assert out.region.tolist() == ["r0", "r1", "r2", "r3"]
    assert int(out.c.sum()) == 1000
    df = tbl.to_pandas().groupby("region")["amount"].sum()
    assert np.allclose(out.s.values, df.sort_index().values, atol=1e-9)


def test_s3_scan_distributed_standalone(s3_env):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig

    uri, _ = s3_env
    ctx = SessionContext.standalone(BallistaConfig(), num_executors=1, vcores=2)
    try:
        ctx.register_parquet("sales", uri)
        out = ctx.sql("SELECT count(*) AS c FROM sales WHERE id < 250").collect()
        assert out.column("c").to_pylist() == [250]
    finally:
        ctx.shutdown()


def test_s3_table_through_device_stage_matches_reference(s3_env):
    """An s3:// table fills the port's device table through the object
    store and runs its partial aggregate on the device path with no
    fallback; the answer is byte-identical to the JAX package's device run
    and equal to the port's engine=cpu answer."""
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    uri, _ = s3_env
    sql = ("SELECT region, count(*) AS c, sum(id) AS s FROM sales WHERE id >= 100 "
           "GROUP BY region ORDER BY region")
    sc.RUN_STATS.clear()
    port = _ctx("ballista_tpu_torch", TPU_CFG)
    port.register_parquet("sales", uri)
    got, physical = _run(port, sql)
    (stage,) = _stages(physical, "TpuStageExec")
    assert stage.tpu_count == 1 and stage.fallback_count == 0, stage.decline_reason
    key = sc.DEVICE_CACHE.key_of(stage.scan)
    assert all(f[0].startswith("s3://") and len(f[2]) == 2 for part in key[0] for f in part)
    assert any(r.get("device_bytes") for r in sc.RUN_STATS.stages().values())

    ref = _ctx("ballista_tpu", TPU_CFG)
    ref.register_parquet("sales", uri)
    want = ref.sql(sql).collect()
    assert got.schema.equals(want.schema)
    assert got.equals(want)
    cpu = _ctx("ballista_tpu_torch")
    cpu.register_parquet("sales", uri)
    assert got.equals(cpu.sql(sql).collect())


def _write_kv(path, factor: int) -> None:
    i = np.arange(1000, dtype=np.int64)
    pq.write_table(pa.table({"k": i % 4, "v": i * factor}), path)


@pytest.fixture()
def rewritable(tmp_path, monkeypatch):
    """One object `s3://bkt/t/part-0.parquet`: k = i mod 4, v = i over
    1000 rows; the caller rewrites it with v = 3i (the shim reports one
    mtime for every object, so the rewrite changes the object's size)."""
    d = tmp_path / "bkt" / "t"
    d.mkdir(parents=True)
    path = d / "part-0.parquet"
    _write_kv(path, 1)
    srv = _serve(tmp_path, monkeypatch)
    yield "s3://bkt/t", path
    srv.shutdown()


OLD_SUMS = [124500, 124750, 125000, 125250]
NEW_SUMS = [373500, 374250, 375000, 375750]


def _sums(pkg: str, uri: str, cfg: dict) -> list:
    ctx = _ctx(pkg, cfg)
    ctx.register_parquet("t", uri)
    return ctx.sql(SUMS_SQL).collect().column("s").to_pylist()


def test_rewritten_object_is_another_device_table(rewritable):
    """ROADMAP C26: after the object is rewritten and registered again in
    a fresh session, engine=tpu answers the new data, as engine=cpu does;
    the device table's key and a join build's leaf key both change."""
    import os

    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    uri, path = rewritable
    assert _sums("ballista_tpu_torch", uri, TPU_CFG) == OLD_SUMS
    ctx = _ctx("ballista_tpu_torch", TPU_CFG)
    ctx.register_parquet("t", uri)
    (stage,) = _stages(_compiled(ctx, SUMS_SQL), "TpuStageExec")
    before = (sc.DEVICE_CACHE.key_of(stage.scan), sc._build_leaf_keys([_JoinOver(stage.scan)]))
    size0 = os.path.getsize(path)
    _write_kv(path, 3)
    assert os.path.getsize(path) != size0
    after = (sc.DEVICE_CACHE.key_of(stage.scan), sc._build_leaf_keys([_JoinOver(stage.scan)]))
    assert before[0] != after[0] and before[1] != after[1]
    assert _sums("ballista_tpu_torch", uri, TPU_CFG) == NEW_SUMS
    assert _sums("ballista_tpu_torch", uri, {}) == NEW_SUMS


class _JoinOver:
    """A join whose build side is `scan` (what _build_leaf_keys walks)."""

    def __init__(self, scan):
        self.left = scan


def test_reference_still_serves_the_stale_table(rewritable):
    """The fault stands in the JAX package (its key_of names a file by its
    path alone): on the same input its engine=tpu answers the old sums
    after the rewrite, while its engine=cpu answers the new ones."""
    uri, path = rewritable
    assert _sums("ballista_tpu", uri, TPU_CFG) == OLD_SUMS
    _write_kv(path, 3)
    assert _sums("ballista_tpu", uri, TPU_CFG) == OLD_SUMS
    assert _sums("ballista_tpu", uri, {}) == NEW_SUMS


def test_stamp_is_one_head_request_a_file_per_stage_run(rewritable, monkeypatch):
    """A warm run over the object re-reads its size and mtime (never a
    cached stamp) with one HEAD request a file per device stage run. (The
    planner stamps each file as well, before the stage runs, and reads its
    footer again only when the stamp moves.)"""
    from ballista_tpu_torch.testing import mini_s3

    uri, _ = rewritable
    ctx = _ctx("ballista_tpu_torch", TPU_CFG)
    ctx.register_parquet("t", uri)
    assert ctx.sql(SUMS_SQL).collect().column("s").to_pylist() == OLD_SUMS
    heads = []
    real = mini_s3._Handler.do_HEAD

    def counted(self):
        heads.append(self.path)
        return real(self)

    monkeypatch.setattr(mini_s3._Handler, "do_HEAD", counted)
    physical = _compiled(ctx, SUMS_SQL)
    heads.clear()
    got = _collect(physical, ctx.config)
    (stage,) = _stages(physical, "TpuStageExec")
    assert got.column("s").to_pylist() == OLD_SUMS
    assert stage.tpu_count == 1 and stage.fallback_count == 0
    assert heads == ["/bkt/t/part-0.parquet"]
