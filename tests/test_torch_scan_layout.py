"""The planner's row-group sizes kept by file stamp (`ParquetTable.scan_partitions`,
plan/provider.py), on the CPU forms, over TPC-H SF0.01 lineitem laid out
like the benchmark's SF10 tables: several files of several row groups each.
The JAX package's `ParquetTable` over the same files, which parses every
footer on every call, is the reference for layouts and answers.

- the layout is the reference's, descriptor for descriptor, for several
  `target_partitions`, on a first call and on later ones, and a caller
  that changes the descriptors it got does not change the next call's;
- a second call parses no footer (`footer_reads` unchanged); registration
  fills the sizes, so the first call parses none either;
- the device table's key of a planned scan is the one the reference's
  layout gives, so the resident tables keep hitting;
- three threads and more planning q1 and q6 at once get the reference's
  layout, and parse no footer;
- a file rewritten under its name with another row-group count is read
  again, that footer alone, its layout shows the new row groups, and q6
  over the rewritten files answers as the JAX package's session does;
  likewise an `s3://` object rewritten under its key (the in-process S3
  shim) and a GROUP BY over it.
"""

import os
import shutil
import sys
import threading

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime
from ballista_tpu_torch.plan.provider import ParquetTable
from ballista_tpu_torch.utils.run_stats import RUN_STATS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_CFG = {"ballista.executor.engine": "tpu", "ballista.serving.result.cache.enabled": False,
           "ballista.tpu.min.rows": 0}
TARGETS = [1, 3, 8, 13, 1000]


def _query(n: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{n}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def lineitem_dir(tmp_path_factory):
    from ballista_tpu_torch.testing.tpchgen import generate_tpch

    d = str(tmp_path_factory.mktemp("tpch_layout") / "sf001")
    # lineitem: 8 files of 7,500 rows, 4 row groups each of unequal bytes
    generate_tpch(d, scale=0.01, seed=42, files_per_table=2, row_group_rows=2048)
    return os.path.join(d, "lineitem")


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu()
    yield
    runtime.use_cpu(*prev)


def _reference(path: str, target_partitions: int) -> list[dict]:
    """The JAX package's layout of the same files: every footer read, every
    row group LPT-packed by bytes."""
    from ballista_tpu.plan.provider import ParquetTable as JParquetTable

    return JParquetTable(path).scan_partitions(target_partitions)


def _reads(before: dict) -> int:
    return RUN_STATS.counters()["footer_reads"] - before["footer_reads"]


def test_fixture_is_laid_out_like_sf10(lineitem_dir):
    t = ParquetTable(lineitem_dir)
    groups = [pq.read_metadata(f).num_row_groups for f in t.files]
    assert len(t.files) == 8 and min(groups) >= 3


@pytest.mark.parametrize("target", TARGETS)
def test_layout_is_the_reference_packing(lineitem_dir, target):
    t = ParquetTable(lineitem_dir)
    want = _reference(lineitem_dir, target)
    first = t.scan_partitions(target)
    second = t.scan_partitions(target)
    assert first == want and second == want
    assert len(want) == min(target, 32)


@pytest.mark.parametrize("collect_statistics", [True, False])
def test_second_call_reads_no_footer(lineitem_dir, collect_statistics):
    before = RUN_STATS.counters()
    t = ParquetTable(lineitem_dir, collect_statistics=collect_statistics)
    assert _reads(before) == (8 if collect_statistics else 0)
    t.scan_partitions(8)
    assert _reads(before) == 8
    t.scan_partitions(8)
    t.scan_partitions(3)  # another target packs again from the kept sizes
    assert _reads(before) == 8


def test_descriptors_a_caller_changes_leave_the_next_call_alone(lineitem_dir):
    t = ParquetTable(lineitem_dir)
    want = _reference(lineitem_dir, 8)
    for _ in range(2):
        got = t.scan_partitions(8)
        got[0]["files"][0]["row_groups"].append(99)
        got[1]["files"].clear()
        got.pop()
        assert t.scan_partitions(8) == want


def _ctx(table):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig

    ctx = SessionContext(BallistaConfig(dict(TPU_CFG)))
    ctx.register_table("lineitem", table)
    return ctx


def _reference_answer(path: str, sql: str) -> pa.Table:
    """`sql` through the JAX package's session over its own `ParquetTable`
    of `path`, on the device path as the port's session runs it."""
    from ballista_tpu.client.context import SessionContext as JContext
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu.plan.provider import ParquetTable as JParquetTable

    ctx = JContext(JConfig(dict(TPU_CFG)))
    ctx.register_table("lineitem", JParquetTable(path))
    return ctx.sql(sql).collect()


def _stage_scan(ctx, q: int):
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

    from .conftest import iter_plan

    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(_query(q)).plan), ctx.config)
    (stage,) = [n for n in iter_plan(physical) if type(n).__name__ == "TpuStageExec"]
    return stage.scan


@pytest.mark.parametrize("q", [1, 6])
def test_device_table_key_is_the_reference_layouts(lineitem_dir, q):
    from ballista_tpu_torch.ops.cuda.stage_compiler import DEVICE_CACHE
    from ballista_tpu_torch.plan.physical import ParquetScanExec

    ctx = _ctx(ParquetTable(lineitem_dir))
    first = _stage_scan(ctx, q)
    before = RUN_STATS.counters()
    again = _stage_scan(ctx, q)
    assert _reads(before) == 0
    oracle = ParquetScanExec(first.df_schema, _reference(lineitem_dir, 8), first.projection, [],
                             first.table_name)
    assert len(first.partitions) == 8 and first.partitions == oracle.partitions
    assert DEVICE_CACHE.key_of(first) == DEVICE_CACHE.key_of(again) == DEVICE_CACHE.key_of(oracle)


def test_threads_plan_identical_layouts(lineitem_dir):
    # the benchmark's three streams and more: more threads than cores, a
    # short switch interval; every plan gets the reference's layout and
    # none parses a footer
    ctx = _ctx(ParquetTable(lineitem_dir))
    want = _reference(lineitem_dir, 8)
    n_threads, per, got, errors = max(3, (os.cpu_count() or 1) + 2), 6, [], []

    def stream(k: int):
        try:
            for i in range(per):
                got.append(_stage_scan(ctx, (1, 6)[(i + k) % 2]).partitions)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    before = RUN_STATS.counters()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=stream, args=(k,), daemon=True)
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads) and not errors
    assert len(got) == n_threads * per and all(p == want for p in got)
    assert _reads(before) == 0


def _rewrite_fewer_rows(path: str, row_group_rows: int) -> None:
    """The file's first two thirds, under its name, in groups of
    `row_group_rows` rows."""
    tbl = pq.read_table(path)
    pq.write_table(tbl.slice(0, 2 * tbl.num_rows // 3), path, row_group_size=row_group_rows,
                   compression="zstd")


def test_rewritten_file_is_read_again_and_answers_follow(lineitem_dir, tmp_path):
    from ballista_tpu_torch.plan.object_store import file_stamp

    d = str(tmp_path / "lineitem")
    shutil.copytree(lineitem_dir, d)
    table = ParquetTable(d)
    ctx = _ctx(table)
    old = ctx.sql(_query(6)).collect()
    victim = table.files[3]
    groups0 = pq.read_metadata(victim).num_row_groups
    stamp0 = file_stamp(victim)
    _rewrite_fewer_rows(victim, 1000)
    assert file_stamp(victim) != stamp0
    assert pq.read_metadata(victim).num_row_groups != groups0

    before = RUN_STATS.counters()
    parts = table.scan_partitions(8)
    assert _reads(before) == 1
    assert parts == _reference(d, 8)
    rgs = sorted(rg for p in parts for f in p["files"] if f["file"] == victim
                 for rg in f["row_groups"])
    assert rgs == list(range(pq.read_metadata(victim).num_row_groups))
    table.scan_partitions(8)
    assert _reads(before) == 1

    got = ctx.sql(_query(6)).collect()
    want = _reference_answer(d, _query(6))
    assert got.schema.equals(want.schema) and got.equals(want)
    assert not got.equals(old)


def test_rewritten_object_is_read_again(tmp_path, monkeypatch):
    from ballista_tpu_torch.testing.mini_s3 import start_mini_s3

    d = tmp_path / "bkt" / "t"
    d.mkdir(parents=True)
    data = pa.table({"k": pa.array([i % 4 for i in range(6000)], pa.int64()),
                     "v": pa.array(range(6000), pa.int64())})
    for i in range(2):
        pq.write_table(data.slice(3000 * i, 3000), d / f"part-{i}.parquet", row_group_size=1000)
    srv, endpoint = start_mini_s3(str(tmp_path))
    for k, v in {"AWS_ENDPOINT_URL": endpoint, "AWS_ACCESS_KEY_ID": "test",
                 "AWS_SECRET_ACCESS_KEY": "test", "AWS_ALLOW_HTTP": "true",
                 "AWS_REGION": "us-east-1"}.items():
        monkeypatch.setenv(k, v)
    uri = "s3://bkt/t"
    try:
        before = RUN_STATS.counters()
        table = ParquetTable(uri)
        assert table.scan_partitions(4) == table.scan_partitions(4) == _reference(uri, 4)
        assert _reads(before) == 2
        # the shim gives every object one mtime: the rewrite changes the size
        _rewrite_fewer_rows(str(d / "part-1.parquet"), 500)
        parts = table.scan_partitions(4)
        assert _reads(before) == 3
        assert parts == _reference(uri, 4)
        assert sum(len(f["row_groups"]) for p in parts for f in p["files"]) == 7
        sql = "SELECT k, sum(v) AS s FROM lineitem GROUP BY k ORDER BY k"
        got = _ctx(table).sql(sql).collect()
        want = _reference_answer(uri, sql)
        assert got.equals(want)
        assert want.num_rows == 4 and sum(want.column("s").to_pylist()) == sum(range(5000))
    finally:
        srv.shutdown()
