"""A traced run of a cell with the port's spans laid over its device trace.

    python3 portbench/span_report.py --workload <cell> --seed <n> --seconds <s>

Runs the cell's traced run (`run.py ... --trace 1`) in this process. The
port records its spans while the run's profiler records (from the window's
first statement on), so the result line, printed as run.py prints it,
carries the span readers' metrics; here each idle gap of its `breakdown`
is labelled as well with the port's innermost spans open at the gap's
middle (`collect:3 | stage.wait:1,final.encode:2`). A last line, `spans`,
gives each span name's ms per statement of the window, the share of the
statements' summed `collect` time that its child spans cover, and what one
span costs on this host with spans on and off.
"""

import time

T_START = time.time()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main, spans  # noqa: E402
from portbench.harness.trace import busy_intervals, idle_gaps  # noqa: E402


def span_cost_ns(n: int = 100_000) -> dict:
    """ns of one `with span(...)` on this host, spans on (inside a
    statement) and off, on a RunStats of its own."""
    from ballista_tpu_torch.utils.run_stats import RunStats

    out = {}
    for on in (False, True):
        rs = RunStats()
        rs.trace(on)
        with rs.statement(rs.new_statement()):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with rs.span("x"):
                    pass
            out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
        rs.trace(False)
    return out


def report(view) -> dict:
    """Per span name, ms per statement of the window; the coverage of
    `collect` by its children; spans per statement."""
    stmts = spans.window_statements(view)
    if stmts is None:
        return {"statements": 0}
    ms: dict[str, float] = {}
    n_spans = 0
    for recs in stmts.values():
        for r in recs:
            ms[r[3]] = ms.get(r[3], 0.0) + (r[6] - r[5]) / 1e6
            n_spans += 1
    n = len(stmts)
    return {"statements": n, "spans_per_statement": n_spans / n,
            "collect_covered": spans.collect_coverage(stmts),
            "ms_per_statement": {k: v / n for k, v in sorted(ms.items(), key=lambda kv: -kv[1])}}


def run(argv) -> int:
    seen = {}
    breakdown, traced_view = main.breakdown, main.traced_view

    def view_kept(*a, **k):
        seen["view"] = traced_view(*a, **k)
        return seen["view"]

    def labelled(view, records):
        out = breakdown(view, records)
        got = spans.port_spans()
        if got is not None:
            gaps = sorted(idle_gaps(busy_intervals(view.events), view.start, view.stop),
                          key=lambda g: g[0] - g[1])[:10]
            out["idle_gaps"] = [[spans.label(lbl, got[0], (s + e) / 2), d]
                                for (lbl, d), (s, e) in zip(out["idle_gaps"], gaps)]
        return out

    main.breakdown, main.traced_view = labelled, view_kept
    try:
        rc = main.run(list(argv) + ["--trace", "1"], t_start=T_START)
    finally:
        main.breakdown, main.traced_view = breakdown, traced_view
    if rc == 0 and "view" in seen:
        line = report(seen["view"])
        line["span_ns"] = span_cost_ns()
        print(json.dumps({"spans": line}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
