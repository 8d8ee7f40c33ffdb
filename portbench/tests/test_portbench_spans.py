"""The readers of the port's spans (`harness/spans.py`, the six span and
counter metrics), on synthetic spans and on whole traced runs of a cell on
the CPU (SF0.01): with the port's spans, the run's line carries the six
metrics; with a port that has no span module, the line is what it was."""

import io
import json
import sys

import pytest

from portbench.harness import spans, spec
from portbench.harness.main import run
from portbench.harness.reading import Query, Traced

NEW = ["physical_plan_ms", "stage_host_ms_per_query", "final_stage_host_ms_per_query",
       "card_wait_ms_per_query", "gc_pause_ms_per_query", "host_syncs_per_query"]
MS = 1_000_000
T0 = 1_700_000_000 * 10**9  # the window opens here (Unix ns)


def _stmt(sid, base, t0):
    """One statement's spans: ids base+0 .. base+11; times in ms after t0."""
    def rec(i, parent, name, s, e, thread=1):
        return (sid, base + i, parent and base + parent, name, thread, t0 + s * MS, t0 + e * MS)

    return [
        rec(0, 0, "plan.sql", 0, 1),
        rec(1, 0, "collect", 1, 101),
        rec(2, 1, "plan.physical", 1, 3),
        rec(3, 1, "plan.device", 3, 4),
        rec(4, 1, "final", 4, 96),
        rec(5, 4, "final.input", 4, 60),
        rec(6, 5, "stage", 5, 59, thread=2),
        rec(7, 6, "stage.wait", 20, 50, thread=2),
        rec(8, 4, "final.encode", 60, 70),
        rec(9, 4, "final.wait", 70, 80),
        rec(10, 4, "final.decode", 80, 96),
        rec(11, 1, "collect.arrow", 96, 100),
    ]


def _view(n=2):
    recs = []
    for k in range(n):
        recs += _stmt(k + 1, 100 * k + 1, T0 + k * 200 * MS)
    recs.append((1, 999, 9, "gc", 1, T0 + 62 * MS, T0 + 65 * MS))
    recs.append((0, 998, 0, "gc", 3, T0 + 150 * MS, T0 + 152 * MS))  # no statement open there
    view = Traced(start=T0 / 1e9, stop=(T0 + n * 200 * MS) / 1e9,
                  queries=[Query(0, "q1", 0, 0, 0)] * n, events=None)
    return view, recs


@pytest.fixture
def synthetic(monkeypatch):
    view, recs = _view()
    monkeypatch.setattr(spans, "port_spans", lambda: (recs, {"host_syncs": 14, "spans_dropped": 0}))
    return view


@pytest.mark.parametrize("name,want", [
    ("physical_plan_ms", 3.0),                 # 2 + 1
    ("stage_host_ms_per_query", 24.0),         # 54 - 30
    ("final_stage_host_ms_per_query", 26.0),   # 92 - 56 - 10
    ("card_wait_ms_per_query", 40.0),          # 30 + 10
    ("gc_pause_ms_per_query", 2.5),            # (3 + 2) / 2
    ("host_syncs_per_query", 7.0),             # 14 / 2
])
def test_reader_arithmetic_on_synthetic_spans(synthetic, name, want):
    assert spec.metric_reader(name).read(synthetic) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_spans(monkeypatch, name):
    view, _ = _view()
    monkeypatch.setattr(spans, "port_spans", lambda: None)
    assert spec.metric_reader(name).read(view) is None


def test_dropped_spans_or_no_span_module_give_nothing(monkeypatch):
    from ballista_tpu_torch.utils.run_stats import RUN_STATS

    monkeypatch.setattr(RUN_STATS, "spans", lambda: [(1, 1, 0, "collect", 1, 0, 1)])
    monkeypatch.setattr(RUN_STATS, "counters",
                        lambda since_trace=False: {"host_syncs": 0, "spans_dropped": 0})
    assert spans.port_spans() is not None
    monkeypatch.setattr(RUN_STATS, "counters",
                        lambda since_trace=False: {"host_syncs": 0, "spans_dropped": 3})
    assert spans.port_spans() is None
    monkeypatch.setitem(sys.modules, "ballista_tpu_torch.utils.run_stats", None)
    assert spans.port_spans() is None


def test_statements_outside_the_window_are_left_out(synthetic):
    short = Traced(start=synthetic.start, stop=synthetic.start + 0.15, queries=synthetic.queries,
                   events=None)
    assert list(spans.window_statements(short)) == [1]


def test_gap_label_names_the_innermost_spans_open_at_its_middle():
    _, recs = _view()
    # at 30 ms: statement 1's stage.wait (its stage, final.input, final and
    # collect are open around it); at 64 ms: the gc inside final.encode
    assert spans.label("collect:3", recs, (T0 + 30 * MS) / 1e9) == "collect:3 | stage.wait:1"
    assert spans.label("collect:3", recs, (T0 + 64 * MS) / 1e9) == "collect:3 | gc:1"
    assert spans.label("wait", recs, (T0 + 150 * MS) / 1e9) == "wait | gc:1"
    assert spans.label("wait", recs, (T0 + 180 * MS) / 1e9) == "wait"


def test_collect_coverage_and_the_report(synthetic):
    from portbench import span_report

    stmts = spans.window_statements(synthetic)
    # collect 1..101: children cover 1..4, 4..96 and 96..100 of it
    assert spans.collect_coverage(stmts) == pytest.approx(99 / 100)
    rep = span_report.report(synthetic)
    assert rep["statements"] == 2 and rep["spans_per_statement"] == pytest.approx(12.5)
    assert rep["ms_per_statement"]["collect"] == pytest.approx(100.0)
    cost = span_report.span_cost_ns(1000)
    assert cost["on"] > 0 and cost["off"] > 0


def _traced_line(root):
    out = io.StringIO()
    rc = run(["--workload", "tpch10_local_scanagg", "--seed", str(2**31 + 7), "--seconds", "2",
              "--trace", "1"], root=root, need_card=False, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_traced_run_reads_the_ports_spans(bench_root, cpu_port):
    from ballista_tpu_torch.utils.run_stats import RUN_STATS

    RUN_STATS.trace(True)  # on the card the run's profiler turns them on
    try:
        res = _traced_line(bench_root)
    finally:
        RUN_STATS.trace(False)
    assert res["correct"] is True
    assert set(NEW) <= set(res["metrics"])
    for name in NEW:
        assert res["metrics"][name]["value"] >= 0
    assert res["metrics"]["stage_host_ms_per_query"]["value"] > 0
    assert res["metrics"]["host_syncs_per_query"]["value"] >= 2  # a wait and a fetch a stage


def test_traced_run_without_the_ports_span_module_is_as_before(bench_root, cpu_port, monkeypatch):
    monkeypatch.setitem(sys.modules, "ballista_tpu_torch.utils.run_stats", None)
    res = _traced_line(bench_root)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"latency_p95_s.closed_loop", "sql_plan_ms",
                                   "table_fills_per_query"}
