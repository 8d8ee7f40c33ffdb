"""One run of one cell: set up, open the window, close it, check, print.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up (`setup_s`, from process start to the window's open): the card
   check, the tables (generated on a checkout's first run, reused after),
   the session through the configuration's front door, the statements
   drawn from the seed, and the warm-up: two rounds of all streams
   together, each stream running its statements once a round.
2. The window: the mix's streams in a closed loop for `--seconds`; with
   `--trace 1` the profiler records the card from the open until every
   stream has drained.
3. After the close: the peak device memory, the session closed, the
   reference over every statement and the comparison of every answer
   collected, the per-layer readers (traced run), and the check that no
   module of JAX or of the JAX package was loaded (exit 3 and no result
   otherwise). The last line of standard output is the result; the
   compared numbers and their limits are the last lines of standard error.

A run without a card, or with fewer cards than the cell asks for, exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

from portbench.harness import check, program, qgen, spec
from portbench.harness.data import ensure
from portbench.harness.reading import Query, Traced
from portbench.harness.trace import DeviceTrace, busy_intervals, idle_gaps
from portbench.harness.window import run_streams, warm_up


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def walls(records) -> str:
    """Per query: statements run, and their median and largest wall."""
    by: dict[str, list[float]] = {}
    for r in records:
        by.setdefault(r.query, []).append(r.done - r.submit)
    return ", ".join(f"{q} n={len(w)} med={statistics.median(w):.3f} max={max(w):.3f}"
                     for q, w in sorted(by.items()))


def tables_of(queries: dict, root: str) -> dict[str, list[str]]:
    """The columns every query's reference reads, by table."""
    need: dict[str, set] = {}
    for q in queries:
        for t, cols in spec.reference_module(q, root).COLUMNS.items():
            need.setdefault(t, set()).update(cols)
    return {t: sorted(c) for t, c in need.items()}


def references(statements: list[dict], data_dir: str, root: str, log=None) -> dict[str, dict]:
    """The reference's answer to every statement, by its key."""
    from portbench.reference.common import Db

    t0 = time.time()
    db = Db(data_dir, tables_of({s["query"] for s in statements}, root))
    spent = {"load": time.time() - t0}
    out = {}
    for s in statements:
        t = time.time()
        out[s["key"]] = spec.reference_module(s["query"], root).answer(db, s["params"])
        spent[s["query"]] = spent.get(s["query"], 0.0) + time.time() - t
    if log is not None:
        log("reference seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))
    return out


def traced_view(window, records, trace, counters) -> Traced:
    done = [r for r in records if r.error is None]
    queries = [Query(r.stream, r.query, r.submit, r.planned, r.done) for r in done]
    return Traced(start=window.open, stop=window.drained, queries=queries,
                  events=None if trace is None else trace.events, counters=counters)


def breakdown(view: Traced, records) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, named by the host spans open at their middle."""
    by_name: dict[str, float] = {}
    for name, _, s, e in view.events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(busy_intervals(view.events), view.start, view.stop),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        open_spans: dict[str, int] = {}
        for r in records:
            kind = ("sql" if r.submit <= mid < r.planned else
                    "collect" if r.planned <= mid < r.done else None)
            if kind:
                open_spans[kind] = open_spans.get(kind, 0) + 1
        label = ",".join(f"{k}:{n}" for k, n in sorted(open_spans.items())) or "wait"
        named.append([label, e - s])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": named}


def run(argv=None, *, root: str = spec.ROOT, need_card: bool = True, t_start: float | None = None,
        out=None) -> int:
    """One run; returns the exit code. `need_card=False` skips the card
    check (the CPU tests, which ask the port for its CPU forms first)."""
    t_start = time.time() if t_start is None else t_start
    out = out or sys.stdout
    args = parse(argv)
    cell = spec.load_cell(args.workload, root)
    chips = cell.chips
    program.pin_cache_dirs(root)
    card = None
    if need_card:
        problem = program.card_problem(chips)
        if problem:
            log(f"no result: {problem}")
            return 2
        card = True
    if not program.port_is_from_checkout():
        log("no result: ballista_tpu_torch is not the checkout's own")
        return 2

    config = cell.config
    log(f"{args.workload} seed {args.seed}: started {time.time() - t_start:.1f} s ago")
    data_dir, manifest = ensure(config, f"{root}/portbench", log=log)
    statements = qgen.streams(cell.queries, int(cell.traffic["streams"]), args.seed,
                              scale=float(config["scale_factor"]))
    flat = [s for st in statements for s in st]
    door = spec.front_door(config["front_door"], root)
    session = door.open_session(config, data_dir, sorted(config["columns"]))
    log(f"session open at {time.time() - t_start:.1f} s")
    if card:
        import torch

        torch.cuda.reset_peak_memory_stats()
    warm = warm_up(session, statements)
    warm_errors = [r for r in warm if r.error]
    log(f"warm-up done at {time.time() - t_start:.1f} s: {walls(warm)}; "
        f"table cache {session.counters().get('table_cache')}, {program.cache_sizes()}")
    if warm_errors:
        log(f"warm-up: {len(warm_errors)} statements failed; the first:\n{warm_errors[0].error}")

    trace = DeviceTrace() if (args.trace and card) else None
    before = session.counters()
    setup_s = None

    def on_open():
        nonlocal setup_s
        if trace is not None:
            trace.start()
        setup_s = time.time() - t_start

    window = run_streams(session, statements, args.seconds, on_open=on_open)
    if trace is not None:
        trace.stop()
    counters = program.counter_delta(before, session.counters())
    log(f"window: {walls(window.records)}; table cache {counters.get('table_cache')}, "
        f"{program.cache_sizes()}; stuck streams {window.stuck}")

    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if card:
        import torch

        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    records = window.records
    in_window = [r for r in records if r.error is None and r.done <= window.close]
    failed = [r for r in records if r.error is not None]
    view = traced_view(window, records, trace, counters)
    session.close()
    del session
    gc.collect()

    t_ref = time.time()
    refs = references(flat, data_dir, root, log=log)
    answers = [(r.key, check.as_columns(r.table)) for r in records if r.error is None]
    # a statement that failed in the warm-up or the window, or never came back
    values, notes = check.readings(answers, refs, len(warm_errors) + len(failed) + window.stuck)
    ok, checks = check.verdict(values, check.LIMITS)
    log(f"reference over {len(refs)} statements and {len(answers)} answers in "
        f"{time.time() - t_ref:.1f} s")
    for line in notes:
        log(f"differs: {line}")
    for r in failed[:3]:
        log(f"failed: {r.key}\n{r.error}")

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m.name, root).read(view)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        lat = [r.done - r.submit for r in in_window]
        e2e = {"setup_s": setup_s,
               "queries_per_s": len(in_window) / args.seconds,
               "latency_p50_s": statistics.median(lat) if lat else None,
               "latency_p95_s": percentile(lat, 95) if lat else None}
        for m in cell.end_to_end:
            if e2e.get(m.name) is not None:
                metrics[m.name] = {"value": e2e[m.name], "unit": m.unit}
    if trace is not None:
        busy = sum(e - s for s, e in busy_intervals(trace.events))
        device.update(busy_s=busy, window_s=view.seconds)

    result = {"correct": bool(ok), "attempted": len(records) + window.stuck,
              "failed": len(failed) + window.stuck, "metrics": metrics, "device": device}
    if trace is not None and trace.events:
        result["breakdown"] = breakdown(view, records)
    result["run"] = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
                     "trace": args.trace, "completed_in_window": len(in_window),
                     "statements": len(flat),
                     "data_bytes": manifest["bytes"], "generate_s": manifest["generate_s"]}
    result["checks"] = checks
    found = program.forbidden_modules()
    if found:
        log(f"no result: loaded {found}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), file=out, flush=True)
    return 0
