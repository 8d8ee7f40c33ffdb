"""The port's statement spans and host-sync counter (`utils/run_stats.py`)
on the CPU forms, over TPC-H SF0.01 run locally:

- each statement's spans form one tree under its `collect` root (beside
  the `plan.sql` root of `ctx.sql()`), every child inside its parent, the
  stage, the final stage and their phases named;
- spans from the final stage's reader threads and the stage they run
  carry their statement's id; concurrent statements never share one;
- off, nothing is recorded and `span()` allocates nothing; a torch
  profiler turns them on for the statements it sees;
- `host_syncs` counts one for every wait and every fetch, the ring counts
  what it pushes out in `spans_dropped`, collections are `gc` spans;
- the heartbeat exports no gauge the port never sets.

On the card (marker `gpu`): a span around a sleeping kernel, closed after
a synchronize, holds the profiler's event for that kernel: the spans and
the device trace share one clock.
"""

import gc
import os
import subprocess
import sys
import threading
import tracemalloc

import pytest

from ballista_tpu_torch.utils.run_stats import RUN_STATS, RunStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"ballista.executor.engine": "tpu", "ballista.serving.result.cache.enabled": False,
       "ballista.tpu.min.rows": 0}  # the final stage on the device path too


def _query(n: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{n}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def lineitem_dir(tmp_path_factory):
    from ballista_tpu_torch.testing.tpchgen import generate_tpch

    d = str(tmp_path_factory.mktemp("tpch_spans") / "sf001")
    generate_tpch(d, scale=0.01, seed=42, files_per_table=4)
    return os.path.join(d, "lineitem")


@pytest.fixture
def ctx(lineitem_dir):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import runtime
    from ballista_tpu_torch.plan.provider import ParquetTable

    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu()
    c = SessionContext(BallistaConfig(dict(CFG)))
    c.register_table("lineitem", ParquetTable(lineitem_dir))
    for q in (1, 6):  # the table resident before any span is read
        c.sql(_query(q)).collect()
    yield c
    RUN_STATS.trace(False)
    runtime.use_cpu(*prev)


def _traced(ctx, queries):
    RUN_STATS.trace(True)
    for q in queries:
        ctx.sql(_query(q)).collect()
    RUN_STATS.trace(False)
    return RUN_STATS.spans()


def _by_statement(spans) -> dict:
    """Records by statement; a collection in a thread with no statement
    open (statement 0) is no statement's."""
    out: dict = {}
    for r in spans:
        if r[0]:
            out.setdefault(r[0], []).append(r)
    return out


def _check_tree(recs) -> dict:
    """Every record's parent in the statement, every child inside its
    parent; returns span id -> record."""
    by_id = {r[1]: r for r in recs}
    roots = [r for r in recs if r[2] == 0]
    assert sorted(r[3] for r in roots) == ["collect", "plan.sql"]
    for r in recs:
        if r[2] == 0:
            continue
        parent = by_id[r[2]]  # the parent is in the same statement
        assert parent[5] <= r[5] <= r[6] <= parent[6], (parent, r)
        top = r
        while top[2]:
            top = by_id[top[2]]
        # `plan.sql` has no child spans; a collection that starts while it
        # is open is recorded under it (test_collection_in_sql_planning_...)
        assert top[3] == "collect" or (r[3] == "gc" and parent[3] == "plan.sql"), r
    return by_id


@pytest.mark.parametrize("q,phases", [
    (1, {"plan.physical", "plan.device", "final", "final.input", "final.encode",
         "final.lower", "final.upload", "final.pass", "final.wait", "final.decode", "stage",
         "stage.table", "stage.plan", "stage.lower", "stage.luts", "stage.pass",
         "stage.wait", "stage.fetch", "stage.decode", "collect.arrow"}),
    (6, {"plan.physical", "plan.device", "stage", "stage.table", "stage.plan", "stage.lower",
         "stage.luts", "stage.pass", "stage.wait", "stage.fetch", "stage.decode",
         "collect.arrow"}),
], ids=["q1", "q6"])
def test_statement_spans_form_one_tree_under_collect(ctx, q, phases):
    stmts = _by_statement(_traced(ctx, [q, q]))
    assert len(stmts) == 2
    for recs in stmts.values():
        _check_tree(recs)
        assert phases <= {r[3] for r in recs} - {"gc"}
        assert {r[3] for r in recs} - {"gc", "collect", "plan.sql"} <= phases | {"final.cpu"}


def test_pool_thread_spans_carry_their_statement(ctx):
    (sid, recs), = _by_statement(_traced(ctx, [1])).items()
    by_name = {r[3]: r for r in recs}
    by_id = _check_tree(recs)
    # the stage runs on one of the final stage's reader threads, under
    # final.input, and is filed under the statement of the collect
    stage = by_name["stage"]
    assert stage[4] != by_name["collect"][4]
    assert by_id[stage[2]][3] == "final.input"
    assert all(r[0] == sid for r in recs)


def test_concurrent_statements_never_share_an_id(ctx):
    RUN_STATS.trace(True)
    errors = []

    def stream(qs):
        try:
            for q in qs:
                ctx.sql(_query(q)).collect()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=stream, args=(qs,))
               for qs in ([1, 6, 1], [6, 1, 6], [6, 6, 1])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    RUN_STATS.trace(False)
    assert not errors
    stmts = _by_statement(RUN_STATS.spans())
    assert len(stmts) == 9  # nine statements, nine ids
    for recs in stmts.values():
        _check_tree(recs)
        assert sum(r[3] == "collect" for r in recs) == 1
        assert sum(r[3] == "stage" for r in recs) == 1


def test_spans_off_record_nothing(ctx):
    RUN_STATS.trace(False)
    before = RUN_STATS.spans()
    ctx.sql(_query(6)).collect()
    assert RUN_STATS.spans() == before
    assert RUN_STATS.span("stage") is RUN_STATS.span("final")
    assert RUN_STATS.statement(RUN_STATS.new_statement()) is RUN_STATS.span("x")


def test_span_off_allocates_nothing():
    RUN_STATS.trace(False)
    span = RUN_STATS.span
    with span("warm"):
        pass
    here = tracemalloc.Filter(True, sys.modules[RunStats.__module__].__file__)
    tracemalloc.start()
    try:
        first = tracemalloc.take_snapshot().filter_traces([here])
        for _ in range(1000):
            with span("stage.wait"):
                pass
        second = tracemalloc.take_snapshot().filter_traces([here])
    finally:
        tracemalloc.stop()
    grown = [d for d in second.compare_to(first, "lineno") if d.size_diff > 0]
    assert not grown, grown


def test_spans_outside_a_statement_record_nothing():
    rs = RunStats()
    rs.trace(True)
    with rs.span("stage"):
        pass
    assert rs.spans() == []


def test_a_profiler_turns_spans_on_for_the_statements_it_sees(ctx):
    from torch.profiler import ProfilerActivity, profile

    RUN_STATS.trace(False)
    with profile(activities=[ProfilerActivity.CPU]):
        ctx.sql(_query(6)).collect()
    stmts = _by_statement(RUN_STATS.spans())
    assert len(stmts) == 1
    _check_tree(next(iter(stmts.values())))
    ctx.sql(_query(6)).collect()  # no profiler: this statement turns them off
    assert RUN_STATS.span("stage") is RUN_STATS.span("final")
    assert len(_by_statement(RUN_STATS.spans())) == 1


def test_host_syncs_count_every_wait_and_fetch(ctx, monkeypatch):
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    fetches = []
    real = sc._fetch

    def counted(t):
        fetches.append(1)
        return real(t)

    monkeypatch.setattr(sc, "_fetch", counted)
    for q in (1, 6):
        fetches.clear()
        before = RUN_STATS.counters()["host_syncs"]
        recs = _traced(ctx, [q])
        syncs = RUN_STATS.counters()["host_syncs"] - before
        waits = sum(r[3] in ("stage.wait", "final.wait") for r in recs)
        assert fetches and waits
        assert syncs == len(fetches) + waits
        assert RUN_STATS.counters(since_trace=True)["host_syncs"] == syncs


def test_host_sync_sites_count_one_each():
    import torch

    from ballista_tpu_torch.ops.cuda import final_stage as fs
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    t = torch.arange(4)
    for site in (lambda: sc._synchronize(torch.device("cpu")), lambda: sc._fetch(t),
                 lambda: fs._host_int(t.sum()), lambda: fs._wait_stream(torch.device("cpu"))):
        before = RUN_STATS.counters()["host_syncs"]
        site()
        assert RUN_STATS.counters()["host_syncs"] == before + 1


def test_spans_dropped_counts_what_the_ring_pushes_out():
    class Small(RunStats):
        SPAN_RING = 4

    rs = Small()
    rs.trace(True)
    with rs.statement(rs.new_statement()):
        for _ in range(9):
            with rs.span("stage"):
                pass
    # ten records (nine spans and the root) through a ring of four
    assert len(rs.spans()) == 4 and rs.counters()["spans_dropped"] == 6
    assert rs.spans()[-1][3] == "collect"
    rs.trace(False)
    rs.trace(True)  # turning them on again starts a new window
    assert rs.spans() == [] and rs.counters()["spans_dropped"] == 0


def test_spans_lose_nothing_under_many_threads_and_collections():
    # more threads than cores, a short switch interval and a collection
    # every few allocations (its callback records while a thread is inside
    # the ring's lock): no thread hangs and no record or sync is lost
    rs = RunStats()
    rs.trace(True)
    n_threads, per = 4 * (os.cpu_count() or 1) + 2, 300

    def work():
        with rs.statement(rs.new_statement()):
            for _ in range(per):
                with rs.span("stage"):
                    rs.count_sync()

    prev, thresholds = sys.getswitchinterval(), gc.get_threshold()
    sys.setswitchinterval(1e-6)
    gc.set_threshold(5)
    try:
        threads = [threading.Thread(target=work, daemon=True) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
        gc.set_threshold(*thresholds)
        rs.trace(False)
    assert not any(t.is_alive() for t in threads)
    recs = rs.spans()
    assert rs.counters()["spans_dropped"] == 0
    assert sum(r[3] != "gc" for r in recs) == n_threads * (per + 1)
    assert any(r[3] == "gc" for r in recs)
    assert rs.counters()["host_syncs"] == n_threads * per
    assert len({r[0] for r in recs if r[3] == "collect"}) == n_threads


def test_collections_are_gc_spans_inside_the_innermost_span():
    rs = RunStats()
    rs.trace(True)
    try:
        sid = rs.new_statement()
        with rs.statement(sid):
            with rs.span("stage.decode"):
                gc.collect()
        gc.collect()  # no statement open: not recorded
    finally:
        rs.trace(False)
    recs = rs.spans()
    by_id = {r[1]: r for r in recs}
    gcs = [r for r in recs if r[3] == "gc"]
    assert gcs and all(r[0] == sid and by_id[r[2]][3] == "stage.decode" for r in gcs)
    assert gc.callbacks.count(rs._on_gc) == 0


def test_collection_in_sql_planning_is_a_gc_span_under_plan_sql(ctx, monkeypatch):
    # a collection can start while `ctx.sql()` parses and plans: it is filed
    # under `plan.sql`, the innermost span open, inside its interval
    from ballista_tpu_torch.client import context

    parse = context.parse_sql

    def parse_and_collect(text):
        gc.collect()
        return parse(text)

    monkeypatch.setattr(context, "parse_sql", parse_and_collect)
    (recs,) = _by_statement(_traced(ctx, [6])).values()
    by_id = _check_tree(recs)
    (plan_sql,) = [r for r in recs if r[3] == "plan.sql"]
    gcs = [r for r in recs if r[3] == "gc" and by_id[r[2]] is plan_sql]
    assert gcs and all(plan_sql[5] <= r[5] <= r[6] <= plan_sql[6] for r in gcs)


def test_run_stats_and_the_client_leave_torch_unloaded():
    code = ("import sys; import ballista_tpu_torch.utils.run_stats; "
            "import ballista_tpu_torch.client.context; "
            "assert 'torch' not in sys.modules, 'torch loaded'")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert r.returncode == 0, r.stderr


def test_heartbeat_exports_no_gauge_the_port_never_sets():
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    rs = sc.RUN_STATS
    saved = rs.snapshot()
    try:
        rs.set("compile_s", 1.0)
        rs.set("compile_overlap_s", 1.0)
        rs.set("exec_s", 0.5)
        names = {n for n, _ in ExecutorProcess._tpu_metrics()}
    finally:
        rs.clear()
        for k, v in saved.items():
            rs.set(k, v)
    assert "tpu_exec_s" in names
    assert not {"tpu_compile_s", "tpu_compile_overlap_s"} & names


@pytest.mark.gpu
def test_spans_share_the_profilers_clock():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.cuda._sleep(1000)  # the context and the kernel's first launch
    torch.cuda.synchronize()
    rs = RunStats()
    rs.trace(True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with rs.statement(rs.new_statement()):
            with rs.span("sleep"):
                torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock
                torch.cuda.synchronize()
    rs.trace(False)
    span = next(r for r in rs.spans() if r[3] == "sleep")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name()]
    assert len(events) == 1, [e.name() for e in prof.profiler.kineto_results.events()]
    start = events[0].start_ns()
    end = start + events[0].duration_ns()
    slack = 1_000_000
    assert end - start > 5_000_000, "the kernel slept less than 5 ms"
    assert span[5] - slack <= start and end <= span[6] + slack, (span[5:], start, end)
