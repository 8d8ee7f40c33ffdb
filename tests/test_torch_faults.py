"""Faults found in the port against the reference (ROADMAP §C), pinned on
the CPU.

The port runs after runtime.use_cpu(), the JAX package with
JAX_PLATFORMS=cpu (tests/conftest.py). C12: a join probed with a key
gathered from an earlier expansion join must look up each lane of that
join on its own (the join lookup memo of `stage_compiler`). C14: a final
stage whose input repeats a field name declines to the CPU engine, as the
reference's does; a join build that repeats one declines too (C15).
"""

import pyarrow as pa
import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan, tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
MODES = ["auto", "staged", "fused_xla", "fused_pallas"]


@pytest.fixture(autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _ctx(pkg: str, tables: dict, **cfg):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig({**BASE_CFG, **cfg}))
    for name, tbl in tables.items():
        ctx.register_arrow_table(name, tbl, partitions=2)
    return ctx


def _run(ctx, sql):
    """(answer, compiled plan) of one local run through the device engine."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    return ctx.execute_collect(phys), phys


def _i64(xs):
    return pa.array(xs, pa.int64())


# ROADMAP C12's smallest input: TPC-DS q93's shape over three tables. The
# store_sales row of customer 1 has two returns (reasons 28 and 12): the
# LEFT JOIN expands it into two lanes, and the reason join is probed with
# each lane's own sr_reason_sk
Q93_TABLES = {
    "store_sales": pa.table({
        "ss_item_sk": _i64([96, 96, 5]), "ss_ticket_number": _i64([49, 49, 7]),
        "ss_customer_sk": _i64([1, 1, 2]), "ss_quantity": _i64([10, 10, 3]),
        "ss_sales_price": pa.array([2.0, 2.0, 1.0])}),
    "store_returns": pa.table({
        "sr_item_sk": _i64([96, 96, 5]), "sr_ticket_number": _i64([49, 49, 7]),
        "sr_reason_sk": _i64([28, 12, 28]), "sr_return_quantity": _i64([4, 1, 1])}),
    "reason": pa.table({"r_reason_sk": _i64([12, 28]),
                        "r_reason_desc": pa.array(["reason 12", "reason 28"])}),
}
Q93_SQL = (
    "SELECT ss_customer_sk, sum((ss_quantity - sr_return_quantity) * ss_sales_price) AS s "
    "FROM store_sales LEFT JOIN store_returns "
    "ON sr_item_sk = ss_item_sk AND sr_ticket_number = ss_ticket_number, reason "
    "WHERE sr_reason_sk = r_reason_sk AND r_reason_desc = 'reason 28' "
    "GROUP BY ss_customer_sk ORDER BY ss_customer_sk")


@pytest.mark.parametrize("mode", MODES)
def test_lookup_after_expansion_join_uses_its_own_lane(mode):
    # customer 1: (10 - 4) * 2.0 twice over the reason-28 lane only; the
    # reason-12 lane must not pass the filter with lane 0's reason
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    cpu = _ctx("ballista_tpu_torch", Q93_TABLES,
               **{"ballista.executor.engine": "cpu"}).sql(Q93_SQL).collect()
    got, phys = _run(_ctx("ballista_tpu_torch", Q93_TABLES,
                          **{"ballista.tpu.fusion.mode": mode}), Q93_SQL)
    assert got.to_pylist() == [{"ss_customer_sk": 1, "s": 24.0},
                               {"ss_customer_sk": 2, "s": 2.0}]
    assert got.equals(cpu)
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages and all(s.tpu_count >= 1 and s.fallback_count == 0 for s in stages)


def test_lookup_after_expansion_join_equals_reference_auto_mode():
    # the reference's auto mode has no lookup memo and answers right: the
    # port is held to it byte for byte (its fused_pallas memo keeps C12)
    want = _ctx("ballista_tpu", Q93_TABLES).sql(Q93_SQL).collect()
    got = _ctx("ballista_tpu_torch", Q93_TABLES).sql(Q93_SQL).collect()
    assert got.schema.equals(want.schema)
    assert got.equals(want)


# the counter's shape: the LAST join (reason, whose keys repeat) consumes
# only count(build column), so the stage aggregates through it with match
# counts, probed with the sr_reason_sk of each store_returns lane
COUNTER_TABLES = {
    "store_sales": pa.table({
        "ss_item_sk": _i64([96, 96, 5] + [1000 + i for i in range(40)]),
        "ss_ticket_number": _i64([49, 49, 7] + list(range(40))),
        "ss_customer_sk": _i64([1, 1, 2] + [3] * 40)}),
    "store_returns": Q93_TABLES["store_returns"],
    "reason": pa.table({"r_reason_sk": _i64([12, 12, 12, 28]),
                        "r_reason_desc": pa.array(["a", "b", "c", "d"])}),
}
COUNTER_SQL = (
    "SELECT ss_customer_sk, count(r_reason_desc) AS n, count(*) AS c "
    "FROM store_sales LEFT JOIN store_returns "
    "ON sr_item_sk = ss_item_sk AND sr_ticket_number = ss_ticket_number "
    "JOIN reason ON sr_reason_sk = r_reason_sk "
    "GROUP BY ss_customer_sk ORDER BY ss_customer_sk")


@pytest.mark.parametrize("mode", MODES)
def test_match_count_after_expansion_join_uses_its_own_lane(mode):
    # customer 1: two sales, each with a reason-28 return (1 match) and a
    # reason-12 return (3 matches): 8 rows, where lane 0's count alone
    # would give 4
    import zlib

    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec

    cpu = _ctx("ballista_tpu_torch", COUNTER_TABLES,
               **{"ballista.executor.engine": "cpu"}).sql(COUNTER_SQL).collect()
    got, phys = _run(_ctx("ballista_tpu_torch", COUNTER_TABLES,
                          **{"ballista.tpu.fusion.mode": mode}), COUNTER_SQL)
    assert got.to_pylist()[0] == {"ss_customer_sk": 1, "n": 8, "c": 8}
    assert got.equals(cpu)
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages and all(s.tpu_count >= 1 and s.fallback_count == 0 for s in stages)
    if mode == "auto":
        rec = RUN_STATS.stages()[f"stage_{zlib.crc32(stages[0].fingerprint.encode()):08x}"]
        assert "aggregate-through-join weights" in rec["fusion_reason"]
        assert got.equals(_ctx("ballista_tpu", COUNTER_TABLES).sql(COUNTER_SQL).collect())


def _count_lookups(monkeypatch):
    """{id(probe expressions): calls}: every join lookup (finder or counter)
    evaluates its probe key once, so this counts the lookups a run makes."""
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    calls: dict = {}
    real = sc._probe_key

    def counting(cols, luts, probe_fns, shifts):
        calls[id(probe_fns)] = calls.get(id(probe_fns), 0) + 1
        return real(cols, luts, probe_fns, shifts)

    monkeypatch.setattr(sc, "_probe_key", counting)
    return calls


@pytest.mark.parametrize("mode", ["fused_xla", "fused_pallas"])
def test_unique_key_joins_look_up_once_per_run(mode, monkeypatch):
    # a probe through two unique-key joins: one lookup per join per run,
    # however many build columns each join's gathers read
    rng_rows = 64
    tables = {
        "fact": pa.table({"fk": _i64([i % 10 for i in range(rng_rows)]),
                          "v": _i64(list(range(rng_rows)))}),
        "d1": pa.table({"id": _i64(list(range(10))), "k2": _i64([i % 4 for i in range(10)]),
                        "x": _i64([i * 3 for i in range(10)])}),
        "d2": pa.table({"id2": _i64(list(range(4))), "y": _i64([7, 8, 9, 10]),
                        "z": _i64([1, 2, 3, 4])}),
    }
    sql = ("SELECT sum(v) AS s, sum(x) AS sx, sum(y) AS sy, sum(z) AS sz, count(*) AS c "
           "FROM fact JOIN d1 ON fk = id JOIN d2 ON k2 = id2")
    ctx = _ctx("ballista_tpu_torch", tables, **{"ballista.tpu.fusion.mode": mode})
    calls = _count_lookups(monkeypatch)
    got, _ = _run(ctx, sql)
    assert got.equals(_ctx("ballista_tpu_torch", tables,
                           **{"ballista.executor.engine": "cpu"}).sql(sql).collect())
    assert sorted(calls.values()) == [1, 1]


def test_join_after_expansion_join_looks_up_once_per_lane(monkeypatch):
    # C12's shape: the store_returns join expands into 2 lanes; it is
    # looked up once per lane, and the reason join, whose key comes from
    # those lanes, once per lane of that join (not once for both)
    ctx = _ctx("ballista_tpu_torch", Q93_TABLES)
    calls = _count_lookups(monkeypatch)
    _run(ctx, Q93_SQL)
    assert sorted(calls.values()) == [2, 2]


@pytest.mark.parametrize("q", [5, 21])
def test_tpch_lookups_per_run_unchanged(q, tpch_dir, monkeypatch):
    # TPC-H's probed joins are unique or last: every lookup runs once per
    # lane of its own join, so each of q5's and q21's runs one lookup per
    # join (the hash_probe launches per run under fused_pallas stay as the
    # reference's, test_torch_engine.test_kernel_calls_per_run_match_jax)
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import HashJoinExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({**BASE_CFG, "ballista.tpu.fusion.mode": "fused_pallas"}))
    register_tpch(ctx, tpch_dir)
    calls = _count_lookups(monkeypatch)
    _, phys = _run(ctx, tpch_query(q))
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages and all(s.tpu_count == 1 and s.fallback_count == 0 for s in stages)
    probed = [op for s in stages for op in s.ops if isinstance(op, HashJoinExec)]
    # q21's filtered semi/anti joins look up once per dup lane of their
    # build (an OR over the lanes), every other join once
    assert len(calls) >= 2
    if q == 5:
        assert sorted(calls.values()) == [1] * len(probed)
    else:
        assert min(calls.values()) == 1


def _two_name_tables():
    fact = pa.table({"fk": _i64([i % 10 for i in range(40)]), "v": _i64(list(range(40)))})
    d1 = pa.table({"id": _i64(list(range(10))), "x": _i64([i % 3 for i in range(10)])})
    d2 = pa.table({"id": _i64(list(range(10))), "x": _i64([i % 2 for i in range(10)])})
    return {"fact": fact, "d1": d1, "d2": d2}


def test_final_stage_over_repeated_field_names_falls_back():
    # C14 (TPC-DS q64's two ca_street_number columns): the final stage's
    # input holds a.x and b.x, both named x; it declines with the reason,
    # as the reference's final stage does, and the CPU engine aggregates
    # the input the attempt read. C16: that input is taken by position
    # (the reference's fallback gives every x the last column's values)
    import ballista_tpu.engine.tpu_engine as jeng
    import ballista_tpu.ops.tpu.final_stage as jfs
    from ballista_tpu.plan.physical import TaskContext as JTask
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec

    sql = ("SELECT a.x AS ax, b.x AS bx, count(*) AS c, sum(v) AS s FROM fact "
           "JOIN d1 a ON fk = a.id JOIN d2 b ON fk = b.id "
           "GROUP BY a.x, b.x ORDER BY ax, bx")
    tables = _two_name_tables()
    got, phys = _run(_ctx("ballista_tpu_torch", tables), sql)
    cpu = _ctx("ballista_tpu_torch", tables,
               **{"ballista.executor.engine": "cpu"}).sql(sql).collect()
    assert got.equals(cpu)
    assert got.column("bx").to_pylist() == [0, 1, 0, 1, 0, 1]
    finals = [n for n in iter_plan(phys) if isinstance(n, TpuFinalStageExec)]
    assert len(finals) == 1
    assert finals[0].tpu_count == 0 and finals[0].fallback_count >= 1
    assert finals[0].decline_reason == "duplicate input field names ['x']"

    jctx = _ctx("ballista_tpu", tables)
    jphys = jeng.maybe_compile_tpu(jctx.create_physical_plan(jctx.sql(sql).plan), jctx.config)
    task = JTask(jctx.config)
    for p in range(jphys.output_partition_count()):
        list(jphys.execute(p, task))
    jfinals = [n for n in iter_plan(jphys) if isinstance(n, jfs.TpuFinalStageExec)]
    assert [(n.tpu_count, n.fallback_count) for n in jfinals] == [
        (0, finals[0].fallback_count)]


def test_build_with_repeated_field_names_declines():
    # C15: the build of the fact join is d1 LEFT JOIN d2, whose columns
    # a.x and b.x share a name; encoding its payloads by name would hand
    # a.x the values of b.x (both packages did), so the port declines and
    # the CPU engine answers
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    tables = _two_name_tables()
    tables["d1"] = pa.table({"id": _i64(list(range(10))), "x": _i64([i * 100 for i in range(10)])})
    sql = ("SELECT sum(a.x) AS sx, sum(b.x) AS sb, count(*) AS c "
           "FROM d1 a LEFT JOIN d2 b ON a.id = b.id JOIN fact ON fk = a.id")
    got, phys = _run(_ctx("ballista_tpu_torch", tables), sql)
    assert got.to_pylist() == [{"sx": 18000, "sb": 20, "c": 40}]
    assert got.equals(_ctx("ballista_tpu_torch", tables,
                           **{"ballista.executor.engine": "cpu"}).sql(sql).collect())
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages and all(s.tpu_count == 0 and s.fallback_count >= 1 for s in stages)


@pytest.mark.parametrize("build", ["memory", "parquet"])
def test_build_over_other_data_of_the_same_shape_is_not_reused(build, tmp_path):
    # C18: a join build is cached under the probe table and the stage's
    # display, which names a memory scan by its row count and a parquet
    # scan by its table name. The dimension re-registered with other rows
    # of that shape was served the first build's payloads (both packages);
    # the port keys each build on the tables it reads
    import pyarrow.parquet as pq

    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    # the probe side a parquet table: its cache key outlives one plan
    fact = pa.table({"k": _i64([1, 2, 3, 4] * 10), "v": _i64(list(range(40)))})
    (tmp_path / "t").mkdir()
    pq.write_table(fact, str(tmp_path / "t" / "t.parquet"))
    sql = ("SELECT u.g, count(*) AS c, sum(t.v) AS s FROM t JOIN u ON t.k = u.k "
           "GROUP BY u.g ORDER BY u.g")
    ctx = _ctx("ballista_tpu_torch", {})
    ctx.register_parquet("t", str(tmp_path / "t"))
    for i, g in enumerate(([1, 1, 2, 2], [1, 2, 2, 2], [3, 3, 3, 1])):
        dim = pa.table({"k": _i64([1, 2, 3, 4]), "g": _i64(g)})
        if build == "memory":
            ctx.register_arrow_table("u", dim)
        else:  # a new file under its own directory each time
            path = tmp_path / f"u{i}"
            path.mkdir()
            pq.write_table(dim, str(path / "u.parquet"))
            ctx.register_parquet("u", str(path))
        got, phys = _run(ctx, sql)
        cpu = _ctx("ballista_tpu_torch", {"t": fact, "u": dim},
                   **{"ballista.executor.engine": "cpu"})
        assert got.equals(cpu.sql(sql).collect()), g
        stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
        assert stages and all(s.tpu_count == 1 and s.fallback_count == 0 for s in stages)


def test_min_max_over_strings_declines():
    # C21: the device stage reduced a dictionary-coded string column's
    # codes and decoded the code as the answer ('2' for 'z'; both
    # packages); the port declines MIN and MAX over a string column and
    # the CPU engine answers
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    tables = {"t": pa.table({"k": ["a", "b", "a", None, "c", "b"],
                             "s": ["x", "y", "z", "x", None, "y"],
                             "v": _i64([1, 2, 3, 4, 5, 6])})}
    sql = ("SELECT k, max(s) AS hi, min(s) AS lo, sum(v) AS sv FROM t "
           "GROUP BY k ORDER BY k")
    got, phys = _run(_ctx("ballista_tpu_torch", tables), sql)
    want = _ctx("ballista_tpu_torch", tables,
                **{"ballista.executor.engine": "cpu"}).sql(sql).collect()
    assert got.equals(want)
    assert got.column("hi").to_pylist() == ["z", "y", None, "x"]
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages and all(s.tpu_count == 0 and s.fallback_count >= 1 for s in stages)
    # a numeric MIN and MAX stay on the device
    got, phys = _run(_ctx("ballista_tpu_torch", tables),
                     "SELECT k, max(v) AS hi, min(v) AS lo FROM t GROUP BY k ORDER BY k")
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    assert stages and all(s.tpu_count == 1 and s.fallback_count == 0 for s in stages)


def test_shuffle_reader_counts_every_partition_it_reads(tmp_path):
    # C27: a ShuffleReaderExec that executes several partitions in one task
    # (a single-task stage under CoalescePartitionsExec) kept the last
    # partition's data-plane counters, so a read that answered rows could
    # report none (both packages); the port sums them over its partitions
    import pyarrow.ipc as ipc

    from ballista_tpu_torch.plan.physical import TaskContext
    from ballista_tpu_torch.plan.schema import DFSchema
    from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec
    from ballista_tpu_torch.shuffle.types import PartitionLocation

    tbl = pa.table({"x": _i64([1, 2, 3])})
    locs = []
    for p in range(2):
        path = tmp_path / f"data-{p}.arrow"
        with ipc.new_stream(str(path), tbl.schema) as w:
            w.write_table(tbl)
        locs.append([PartitionLocation(p, "job", 1, p, path=str(path))])
    locs.append([])  # the last partition reads nothing
    reader = ShuffleReaderExec(DFSchema.from_arrow(tbl.schema), locs)
    ctx = TaskContext()
    read = [b for p in range(3) for b in reader.execute(p, ctx) if b.num_rows]
    assert sum(b.num_rows for b in read) == 6
    assert reader.metrics.extra["bytes_read_local"] == sum(b.nbytes for b in read) > 0
    assert reader.metrics.extra["fetch_rpcs"] == 0
