"""The port's incremental views, appends and continuous queries against
the JAX package's, on the CPU.

The same tables, appends and statements go through both packages: the
eligibility ladder (`analyze_plan`) must decide the same and give the same
reason; the delta registry must keep, fold and serve the same ranges; a
maintained refresh must be byte-identical to the JAX package's maintained
refresh and to a from-scratch run, with the same serving counters; and a
continuous query must push a fresh result per bump in the standalone and
the remote mode. The port runs after runtime.use_cpu() with engine=tpu and
`tpu.min.rows=0`, so its delta stages run on the device path in their
plain forms; the JAX package plans with the same config and answers on
its CPU engine with JAX_PLATFORMS=cpu, as its own tests do.

Also: no refresh may be served a resident device table of an earlier
version (a spool part rewritten under its old name, a delta build of the
same row count as the last one; ROADMAP C18).
"""

import gc
import hashlib
import os
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0,
            "ballista.serving.result.cache.enabled": True}

BASE_T = pa.table({
    "k": ["a", "b", "a", None, "c", "b"],
    "v": [1, 2, 3, 4, None, 6],
    "s": ["x", "y", "z", "x", None, "y"],
})
DELTA_T = pa.table({
    "k": ["a", None, "d", "b"],
    "v": [10, 20, None, 40],
    "s": [None, "x", "q", "y"],
})
DIM_U = pa.table({"k": ["a", "b", "c", "d"], "w": [100, 200, 300, 400]})
FLOATS_F = pa.table({"k": ["a", "b"], "x": [1.5, 2.5]})
PKGS = ("port", "jax")


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _fingerprint(tbl: pa.Table) -> str:
    """Order-independent byte fingerprint (the JAX package's test's)."""
    rows = sorted(str(r) for r in tbl.to_pylist())
    return hashlib.sha256("\n".join(rows).encode()).hexdigest()


def _write(root, name: str, tbl: pa.Table) -> str:
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    pq.write_table(tbl, os.path.join(d, f"{name}.parquet"))
    return d


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("inc")
    return {n: _write(root, n, t) for n, t in
            (("t", BASE_T), ("u", DIM_U), ("f", FLOATS_F))}


def _ctx(pkg, mode="local", addr="", **extra):
    if pkg == "port":
        from ballista_tpu_torch.client.context import SessionContext
        from ballista_tpu_torch.config import BallistaConfig
    else:
        from ballista_tpu.client.context import SessionContext
        from ballista_tpu.config import BallistaConfig
    cfg = BallistaConfig({**BASE_CFG, **extra})
    if mode == "standalone":
        return SessionContext.standalone(cfg, num_executors=1, vcores=2)
    if mode == "remote":
        return SessionContext.remote(addr, cfg)
    return SessionContext(cfg)


# where the JAX package answers, it runs on its CPU engine, as its own
# tests do (its device stage answers MIN/MAX over a string column with
# dictionary codes, ROADMAP C21), and off the fast lane (where an
# append-mode refresh can serve the delta rows alone, C22)
JAX_RUN = {"ballista.executor.engine": "cpu", "ballista.serving.fast.lane.enabled": False}


def _cluster(pkg, tables, names=("t", "u"), **extra):
    ctx = _ctx(pkg, "standalone", **(JAX_RUN if pkg == "jax" else {}), **extra)
    for n in names:
        ctx.register_parquet(n, tables[n])
    return ctx


def _counters(ctx) -> dict:
    return ctx._cluster.scheduler.serving.snapshot()["incremental"]


# -- the eligibility ladder -----------------------------------------------------

ELIGIBILITY = [
    "SELECT k, SUM(v) AS s FROM t GROUP BY k",
    "SELECT k, COUNT(*) AS c, MIN(v) AS lo, MAX(v) AS hi FROM t GROUP BY k",
    "SELECT k, AVG(v) AS a FROM t GROUP BY k",
    "SELECT SUM(v) AS s FROM t",
    "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k LIMIT 3",
    "SELECT k, v FROM t WHERE v > 1",
    "SELECT t.k, SUM(t.v) AS s FROM t JOIN u ON t.k = u.k GROUP BY t.k",
    "SELECT k, SUM(x) AS s FROM f GROUP BY k",
    "SELECT k, STDDEV(v) AS d FROM t GROUP BY k",
    "SELECT a.k, SUM(a.v) AS s FROM t a JOIN t b ON a.k = b.k GROUP BY a.k",
    "SELECT k, v FROM t ORDER BY v",
    "SELECT COUNT(*) AS n FROM t",
    "SELECT t.k, SUM(t.v * u.w) AS s FROM t JOIN u ON t.k = u.k GROUP BY t.k ORDER BY t.k",
]


@pytest.fixture(scope="module")
def local_ctxs(tables):
    out = {}
    for pkg in PKGS:
        ctx = _ctx(pkg)
        for n, path in tables.items():
            ctx.register_parquet(n, path)
        out[pkg] = ctx
    return out


def _decision(pkg, ctx, sql):
    if pkg == "port":
        from ballista_tpu_torch.serving.incremental import analyze_plan
        from ballista_tpu_torch.sql.optimizer import optimize
        from ballista_tpu_torch.sql.parser import parse_sql
        from ballista_tpu_torch.sql.planner import SqlPlanner
    else:
        from ballista_tpu.serving.incremental import analyze_plan
        from ballista_tpu.sql.optimizer import optimize
        from ballista_tpu.sql.parser import parse_sql
        from ballista_tpu.sql.planner import SqlPlanner
    d = analyze_plan(ctx.create_physical_plan(
        optimize(SqlPlanner(ctx.catalog).plan_query(parse_sql(sql)))))
    return d.mode, d.reason, tuple(d.tables)


@pytest.mark.parametrize("sql", ELIGIBILITY)
def test_analyze_plan_matches_reference(sql, local_ctxs):
    got = _decision("port", local_ctxs["port"], sql)
    assert got == _decision("jax", local_ctxs["jax"], sql)
    assert got[0] in ("aggregate", "append", "none")


@pytest.mark.parametrize("q", [1, 3, 4, 5, 6, 12])
def test_analyze_plan_on_tpch_matches_reference(q, tpch_dir):
    from ballista_tpu.testing.tpchgen import register_tpch as jreg
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    from .conftest import tpch_query

    port, jax_ = _ctx("port"), _ctx("jax")
    register_tpch(port, tpch_dir)
    jreg(jax_, tpch_dir)
    assert _decision("port", port, tpch_query(q)) == _decision("jax", jax_, tpch_query(q))


# -- the delta registry ----------------------------------------------------------


def _registry_run(pkg, scenario, spool):
    if pkg == "port":
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.serving.incremental import DeltaRegistry
    else:
        from ballista_tpu.config import BallistaConfig
        from ballista_tpu.serving.incremental import DeltaRegistry

    def batches(n):
        return pa.table({"k": ["x"] * n, "v": list(range(n))}).to_batches()

    def rows(got):
        return None if got is None else sum(b.num_rows for b in got)

    cfg = BallistaConfig()
    cfg.set("ballista.ingest.compaction.dir", str(spool))
    out = []
    if scenario == "ranges":
        reg = DeltaRegistry()
        reg.append("t", 2, batches(3))
        reg.append("t", 3, batches(5))
        for a, b in ((1, 3), (2, 3), (0, 2), (3, 3)):
            got, why = reg.range("t", a, b)
            out.append((a, b, rows(got), why))
    elif scenario == "missing":
        reg = DeltaRegistry()
        reg.append("t", 5, batches(1))
        got, why = reg.range("t", 3, 5)
        out.append((rows(got), why))
    elif scenario == "version_cap":
        cfg.set("ballista.ingest.delta.retained.max.versions", "2")
        reg = DeltaRegistry(cfg)
        for v in range(1, 6):
            reg.append("t", v, batches(4))
        view = reg.view()["t"]
        out.append((sum(pq.read_table(f).num_rows for f in view.folded_files),
                    sum(b.num_rows for b in view.batches)))
        for a, b in ((1, 5), (3, 5)):
            got, why = reg.range("t", a, b)
            out.append((rows(got), why))
    elif scenario == "byte_budget":
        cfg.set("ballista.ingest.delta.retained.max.bytes", "1")
        reg = DeltaRegistry(cfg)
        reg.append("t", 1, batches(100))
        reg.append("t", 2, batches(100))
        view = reg.view()["t"]
        out.append((sum(pq.read_table(f).num_rows for f in view.folded_files),
                    sum(b.num_rows for b in view.batches)))
    elif scenario == "reset":
        reg = DeltaRegistry()
        reg.append("t", 1, batches(2))
        reg.reset("t")
        out.append((reg.empty(), reg.range("t", 0, 1)[0]))
    snap = dict(reg.snapshot())
    snap.pop("spool_dir", None)
    return out, snap


@pytest.mark.parametrize("scenario", ["ranges", "missing", "version_cap", "byte_budget", "reset"])
def test_delta_registry_matches_reference(scenario, tmp_path):
    got = _registry_run("port", scenario, tmp_path / "port")
    want = _registry_run("jax", scenario, tmp_path / "jax")
    assert got == want
    if scenario == "version_cap":
        assert got[0][0] == (12, 8) and got[0][1] == (None, "delta-compacted")
    if scenario == "byte_budget":
        assert sum(got[0][0]) == 200  # folded, never dropped


# -- maintained refreshes, held to the reference and to a from-scratch run -----

AGG = ("SELECT k, SUM(v) AS sv, COUNT(*) AS c, COUNT(s) AS cs, "
       "MIN(v) AS lo, MAX(s) AS hi, AVG(v) AS av FROM t GROUP BY k ORDER BY k")
REPEATED = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
GLOBAL = "SELECT SUM(v) AS s, COUNT(*) AS c FROM t"
DELTA_JOIN = ("SELECT t.k, SUM(t.v * u.w) AS s FROM t JOIN u ON t.k = u.k "
              "GROUP BY t.k ORDER BY t.k")
APPEND_MODE = "SELECT k, v FROM t WHERE v > 1"
SELF_JOIN = ("SELECT a.k, SUM(a.v) AS s FROM t a JOIN t b ON a.k = b.k "
             "GROUP BY a.k ORDER BY a.k")


def _appends(case):
    if case == "repeated":
        return [("t", pa.table({"k": ["a", "e"], "v": [i, 2 * i], "s": [None, "n"]}))
                for i in range(3)]
    return [("t", DELTA_T)]


CASES = {  # name: (sql, extra config, counters that must read so)
    "aggregate": (AGG, {}, {"maintained": 1, "recomputes": 0, "bootstraps": 1}),
    "repeated": (REPEATED, {}, {"maintained": 3}),
    "global": (GLOBAL, {}, {"maintained": 1}),
    "delta_join": (DELTA_JOIN, {}, {"maintained": 1}),
    "append_mode": (APPEND_MODE, {}, {"maintained": 1}),
    "self_join": (SELF_JOIN, {}, {"maintained": 0}),
    "compacted": (REPEATED, {"ballista.ingest.delta.retained.max.versions": 1},
                  {"maintained": 0}),
    "knob_off": (REPEATED, {"ballista.serving.incremental.enabled": False},
                 {"maintained": 0, "bootstraps": 0}),
}


def _maintain_run(pkg, case, tables):
    """The statement's executions before and after each append, the serving
    counters after the last, and from-scratch answers: the port's
    engine=cpu in local mode with the same appends (a query through the
    cluster itself could hit the result cache, filled asynchronously)."""
    sql, extra, _ = CASES[case]
    ctx = _cluster(pkg, tables, **extra)
    scratch = _ctx("port", **{"ballista.executor.engine": "cpu"})
    scratch.register_parquet("t", tables["t"])
    scratch.register_parquet("u", tables["u"])
    try:
        stmt = ctx.prepare(sql)
        outs = [stmt.execute()]
        fulls = []
        appends = _appends(case)
        if case == "compacted":  # two appends before the refresh: the older folds
            appends = [("t", DELTA_T), ("t", DELTA_T)]
        for i, (name, data) in enumerate(appends):
            ctx.append(name, data)
            scratch.append(name, data)
            if case == "compacted" and i == 0:
                continue
            outs.append(stmt.execute())
            fulls.append(scratch.sql(sql).collect())
        counters = _counters(ctx)
        modes = sorted((m["mode"], m["reason"]) for m in counters["modes"].values())
        return outs, fulls, counters, modes
    finally:
        ctx.shutdown()


@pytest.fixture(scope="module")
def maintained(tables):
    return {(pkg, case): _maintain_run(pkg, case, tables)
            for pkg in PKGS for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_maintained_refresh_matches_reference_and_scratch(case, maintained):
    outs, fulls, counters, modes = maintained["port", case]
    j_outs, _j_fulls, j_counters, j_modes = maintained["jax", case]
    assert len(outs) == len(j_outs) >= 2
    for got, want in zip(outs, j_outs):
        if "ORDER BY" in CASES[case][0]:
            assert got.equals(want)
        else:
            assert _fingerprint(got) == _fingerprint(want)
    for got, full in zip(outs[1:], fulls):
        assert _fingerprint(got) == _fingerprint(full)
        assert got.to_pydict() == full.to_pydict() or "ORDER BY" not in CASES[case][0]
    for key in ("maintained", "bootstraps", "recomputes", "state_renders",
                "recompute_reasons"):
        assert counters[key] == j_counters[key], key
    assert modes == j_modes
    for key, want in CASES[case][2].items():
        assert counters[key] == want, (key, counters)
    if case == "self_join":
        assert modes == [("none", "self-join")]
        assert "self-join" in counters["recompute_reasons"]
    if case == "compacted":
        assert counters["recompute_reasons"].get("delta-compacted", 0) >= 1


def test_state_render_after_result_cache_loss(tables):
    # the result cache evicted, the accumulator state current: the refresh
    # renders the finisher locally, with no dispatched job
    got = {}
    for pkg in PKGS:
        ctx = _cluster(pkg, tables)
        try:
            stmt = ctx.prepare(REPEATED)
            stmt.execute()
            ctx.append("t", DELTA_T)
            want = stmt.execute()
            ctx._cluster.scheduler.serving.result_cache.clear()
            again = stmt.execute()
            assert again.equals(want)
            assert _counters(ctx)["state_renders"] == 1
            got[pkg] = again
        finally:
            ctx.shutdown()
    assert got["port"].equals(got["jax"])


def test_delta_stage_runs_on_the_device(tables):
    # a maintained refresh's partial stage over the new delta rows is a
    # device stage (tpu.min.rows=0 here; at the default 8192 a small delta
    # stays on the CPU engine)
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    ctx = _cluster("port", tables)
    try:
        stmt = ctx.prepare(REPEATED)
        stmt.execute()
        ctx.append("t", pa.table({"k": ["a", "b"] * 8, "v": list(range(16)),
                                  "s": ["x"] * 16}))
        stmt.execute()
        assert _counters(ctx)["maintained"] == 1
        stats = stage_stats(last_job(ctx._cluster.scheduler))
        device = [d for s in stats.values() for d in s["device"].values()]
        assert device and all(passes >= 1 and fb == 0 for _n, passes, fb in device)
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("lane", ["fast", "graph"])
def test_append_refresh_never_serves_the_raw_delta(lane, tables, monkeypatch):
    # C22: an append-mode refresh's job outputs only the delta rows, which
    # the fill concatenates onto the cached result. The fast lane marked
    # its job successful before the fill ran, so a client polling then
    # fetched the delta alone; a slow fill (1 s, past wait_for_job's 0.5 s
    # poll) forces that interleaving. Both lanes must serve base + delta.
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    finish = SchedulerServer._finish_fill

    def slow_finish(self, fill, tbl, cfg):
        if fill.kind == "append":
            time.sleep(1.0)
        return finish(self, fill, tbl, cfg)

    monkeypatch.setattr(SchedulerServer, "_finish_fill", slow_finish)
    extra = {} if lane == "fast" else {"ballista.serving.fast.lane.enabled": False}
    ctx = _cluster("port", tables, **extra)
    try:
        stmt = ctx.prepare(APPEND_MODE)
        first = stmt.execute()
        ctx.append("t", DELTA_T)
        got = stmt.execute()
        counters = _counters(ctx)
        assert counters["maintained"] == 1
        assert got.num_rows == first.num_rows + 3  # DELTA_T's rows with v > 1
        fast = ctx._cluster.scheduler.serving.snapshot()["fast_lane"]["executed"]
        assert (fast > 0) == (lane == "fast")
    finally:
        ctx.shutdown()


# -- concurrency ---------------------------------------------------------------------


def test_refreshes_are_monotonic_under_concurrent_appends(tables):
    ctx = _cluster("port", tables)
    try:
        sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM t"
        stmt = ctx.prepare(sql)
        stmt.execute()
        n_appends = 12
        done = threading.Event()

        def feeder():
            try:
                for i in range(n_appends):
                    ctx.append("t", pa.table({"k": ["p", "q"], "v": [i, i], "s": ["w", None]}))
                    time.sleep(0.005)
            finally:
                done.set()

        t = threading.Thread(target=feeder)
        t.start()
        counts = []
        while not done.is_set():
            counts.append(stmt.execute().to_pydict()["n"][0])
        t.join(timeout=60)
        assert not t.is_alive()
        valid = {BASE_T.num_rows + 2 * i for i in range(n_appends + 1)}
        assert set(counts) <= valid, counts
        assert counts == sorted(counts), "refresh results went backwards"
        assert _fingerprint(stmt.execute()) == _fingerprint(ctx.sql(sql).collect())
    finally:
        ctx.shutdown()


# -- continuous queries --------------------------------------------------------------


def test_push_on_every_bump(tables):
    ctx = _cluster("port", tables)
    try:
        stmt = ctx.prepare("SELECT COUNT(*) AS n FROM t")
        sub = stmt.subscribe()
        try:
            assert sub.next(timeout=30).to_pydict()["n"] == [BASE_T.num_rows]
            ctx.append("t", DELTA_T)
            nxt = sub.next(timeout=30)
            assert nxt.to_pydict()["n"] == [BASE_T.num_rows + DELTA_T.num_rows]
        finally:
            sub.close()
        snap = ctx._cluster.scheduler.subscriptions.snapshot()
        assert snap["active"] == 0 and snap["pushed"] >= 2
    finally:
        ctx.shutdown()


def test_unrelated_table_does_not_wake_subscription(tables):
    import queue

    ctx = _cluster("port", tables)
    try:
        sub = ctx.prepare("SELECT COUNT(*) AS n FROM u").subscribe()
        try:
            sub.next(timeout=30)
            ctx.append("t", DELTA_T)
            with pytest.raises(queue.Empty):
                sub._sub.queue.get(timeout=1.0)
        finally:
            sub.close()
        with pytest.raises(Exception):
            ctx._cluster.scheduler.subscribe_statement("no-such-stmt", None, "")
    finally:
        ctx.shutdown()


def test_continuous_query_in_remote_mode(tables):
    # the SubscribeQuery push stream and AppendData over gRPC, against an
    # in-process scheduler and executor daemon; a from-scratch run after
    # every push, and no push for another table
    from ballista_tpu_torch.errors import ExecutionError
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1,
                             flight_proxy_port=-1)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    ex = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1",
                         engine="tpu", vcores=2, flight_impl="python")
    ex.start()
    try:
        ctx = _ctx("port", "remote", addr)
        for n in ("t", "u"):
            ctx.register_parquet(n, tables[n])
        sql = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"
        sub = ctx.prepare(sql).subscribe()
        try:
            first = sub.next(timeout=30)
            assert first.equals(ctx.sql(sql).collect())
            out = ctx.append("t", DELTA_T)
            assert out["table"] == "t" and out["rows"] == DELTA_T.num_rows
            pushed = sub.next(timeout=30)
            assert pushed.equals(ctx.sql(sql).collect())
            assert sum(pushed.column("c").to_pylist()) == BASE_T.num_rows + DELTA_T.num_rows
            ctx.append("u", pa.table({"k": ["e"], "w": [500]}))
            with pytest.raises(ExecutionError, match="no refresh"):
                sub.next(timeout=1.0)
        finally:
            sub.close()
    finally:
        ex.shutdown()
        sched.shutdown()


# -- local append -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["overlay", "conform", "missing_column", "unknown_table"])
def test_local_append_matches_reference(case, tables):
    got = {}
    for pkg in PKGS:
        ctx = _ctx(pkg, **(JAX_RUN if pkg == "jax" else {}))
        ctx.register_parquet("t", tables["t"])
        try:
            if case == "overlay":
                out = ctx.append("t", DELTA_T)
                res = (out, ctx.sql(REPEATED).collect(),
                       ctx.sql("SELECT COUNT(*) AS n FROM t").collect())
            elif case == "conform":
                ctx.append("t", pa.table({"s": pa.array(["m"]), "v": pa.array([7], pa.int32()),
                                          "k": pa.array(["e"])}))
                res = (ctx.sql("SELECT v FROM t WHERE k = 'e'").collect(),)
            elif case == "missing_column":
                ctx.append("t", pa.table({"k": ["e"]}))
            else:
                ctx.append("nope", pa.table({"k": ["e"], "v": [1], "s": ["x"]}))
        except Exception as e:  # noqa: BLE001 — both packages must raise alike
            res = (type(e).__name__, str(e))
        got[pkg] = res
    for a, b in zip(got["port"], got["jax"]):
        assert a.equals(b) if isinstance(a, pa.Table) else a == b
    if case == "overlay":
        assert got["port"][0] == {"table": "t", "version": 1, "rows": DELTA_T.num_rows}
        assert got["port"][2].to_pydict()["n"] == [BASE_T.num_rows + DELTA_T.num_rows]
    if case in ("missing_column", "unknown_table"):
        assert got["port"][0] == "PlanningError"


# -- no stale resident table (C18) ---------------------------------------------------


def test_refresh_after_spool_rewrite_reads_the_new_part(tables, tmp_path):
    # a scheduler restarted over the same compaction dir numbers its
    # versions from 1 again, so its folded parts reuse the old file names;
    # the device table cache (one per process) must not serve the old part
    spool = str(tmp_path / "spool")
    sql = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"
    extra = {"ballista.ingest.compaction.dir": spool,
             "ballista.ingest.delta.retained.max.versions": 1}
    names = []
    for round_, rows in enumerate((4, 9)):
        ctx = _cluster("port", tables, names=("t",), **extra)
        cpu = _ctx("port", **{"ballista.executor.engine": "cpu"})
        cpu.register_parquet("t", tables["t"])
        try:
            for _ in range(2):  # the second append folds the first into the spool
                delta = pa.table({"k": [f"r{round_}"] * rows, "v": list(range(rows)),
                                  "s": ["x"] * rows})
                ctx.append("t", delta)
                cpu.append("t", delta)
            names.append(sorted(os.listdir(spool)))
            got = ctx.sql(sql).collect()
            assert got.equals(cpu.sql(sql).collect()), f"round {round_}"
        finally:
            ctx.shutdown()
    assert names[0] == names[1] and len(names[0]) == 1  # the same part name, rewritten


def test_delta_build_of_the_same_size_is_not_reused(tmp_path):
    # the appended table is the join's build side: every maintained
    # refresh's delta query builds over a fresh 4-row delta, and the stage
    # must run on the device with that delta's rows, never an earlier one's
    from ballista_tpu_torch.testing.standalone_stats import stage_stats

    # integer keys: a string join key declines the device stage
    fact = _write(tmp_path, "g", pa.table({"k": [1, 2, 3, 4] * 5, "v": list(range(20))}))
    dim = _write(tmp_path, "u", pa.table({"k": [1, 2, 3, 4], "w": [100, 200, 300, 400]}))
    sql = ("SELECT u.k, SUM(g.v) AS s, COUNT(*) AS c FROM g JOIN u ON g.k = u.k "
           "GROUP BY u.k ORDER BY u.k")
    ctx = _ctx("port", "standalone")
    cpu = _ctx("port", **{"ballista.executor.engine": "cpu"})
    for c in (ctx, cpu):
        c.register_parquet("g", fact)
        c.register_parquet("u", dim)
    try:
        stmt = ctx.prepare(sql)
        stmt.execute()
        sched = ctx._cluster.scheduler
        for keys in ([1, 2, 3, 9], [2, 3, 7, 8], [1, 1, 1, 3]):
            delta = pa.table({"k": keys, "w": [1, 2, 3, 4]})
            ctx.append("u", delta)
            cpu.append("u", delta)
            gc.collect()  # the last delta's scan objects go; their ids may return
            seen = set(sched.jobs)
            got = stmt.execute()
            assert got.equals(cpu.sql(sql).collect()), keys
            new = [j for jid, j in sched.jobs.items() if jid not in seen]
            device = [d for j in new if isinstance(getattr(j, "stages", None), dict)
                      for st in stage_stats(j).values() for d in st["device"].values()]
            assert device and all(passes >= 1 and fb == 0 for _n, passes, fb in device)
        assert _counters(ctx)["maintained"] == 3
    finally:
        ctx.shutdown()
