"""The port's own spans in a traced window, read from the process they ran in.

The port records, while a torch profiler records the process (the traced
run's device trace), one span per phase of each local statement on the
Unix clock of the device events: `(statement, span_id, parent_id, name,
thread, start_ns, end_ns)`, in `ballista_tpu_torch.utils.run_stats`. A
port without that module, or a window whose spans overflowed the port's
ring, gives nothing to read: every function here then returns None.

This module imports the port's torch-free span module and nothing else of
it; the per-layer readers read the port through it.
"""

from __future__ import annotations


def port_spans():
    """(records, counters) of the port's span ring, or None where the port
    has no spans, recorded none, or dropped some."""
    try:
        from ballista_tpu_torch.utils.run_stats import RUN_STATS
    except ImportError:
        return None
    counters = RUN_STATS.counters(since_trace=True)
    records = RUN_STATS.spans()
    if not records or counters["spans_dropped"]:
        return None
    return records, counters


def window_statements(w, got=None) -> dict[int, list[tuple]] | None:
    """The spans of each statement whose `collect` span lies in the traced
    window, by statement; None without any."""
    got = port_spans() if got is None else got
    if got is None:
        return None
    lo, hi = int(w.start * 1e9), int(w.stop * 1e9)
    by: dict[int, list[tuple]] = {}
    for r in got[0]:
        by.setdefault(r[0], []).append(r)
    out = {sid: recs for sid, recs in by.items() if sid
           and any(r[3] == "collect" and r[2] == 0 and lo <= r[5] and r[6] <= hi for r in recs)}
    return out or None


def ms_per_statement(w, plus: tuple[str, ...], minus: tuple[str, ...] = ()) -> float | None:
    """Per statement of the window, in ms: the spans named in `plus`
    summed, less those named in `minus`."""
    stmts = window_statements(w)
    if stmts is None:
        return None
    total = 0
    for recs in stmts.values():
        for r in recs:
            if r[3] in plus:
                total += r[6] - r[5]
            elif r[3] in minus:
                total -= r[6] - r[5]
    return total / 1e6 / len(stmts)


def gc_ms_per_statement(w) -> float | None:
    """Python's collections inside the window, in ms, per statement of the
    window: a collection holds every thread, so each counts once."""
    got = port_spans()
    stmts = window_statements(w, got)
    if stmts is None:
        return None
    lo, hi = int(w.start * 1e9), int(w.stop * 1e9)
    total = sum(r[6] - r[5] for r in got[0] if r[3] == "gc" and lo <= r[5] and r[6] <= hi)
    return total / 1e6 / len(stmts)


def syncs_per_statement() -> float | None:
    """The port's host syncs since its spans were turned on, per statement
    recorded since then."""
    got = port_spans()
    if got is None:
        return None
    n = sum(1 for r in got[0] if r[3] == "collect" and r[2] == 0)
    return got[1]["host_syncs"] / n if n else None


def innermost_at(records, t_ns: int) -> dict[str, int]:
    """The spans open at `t_ns` that have no child open then, counted by
    name."""
    open_ = [r for r in records if r[5] <= t_ns < r[6]]
    parents = {r[2] for r in open_}
    out: dict[str, int] = {}
    for r in open_:
        if r[1] not in parents:
            out[r[3]] = out.get(r[3], 0) + 1
    return out


def label(harness_label: str, records, mid_s: float) -> str:
    """A gap's harness label with the port's innermost spans at its middle
    appended: `collect:3 | stage.wait:1,final.encode:2`."""
    inner = innermost_at(records, int(mid_s * 1e9))
    if not inner:
        return harness_label
    return harness_label + " | " + ",".join(f"{k}:{n}" for k, n in sorted(inner.items()))


def collect_coverage(stmts: dict[int, list[tuple]]) -> float | None:
    """The share of the statements' summed `collect` time that the union
    of its child spans covers."""
    covered = whole = 0
    for recs in stmts.values():
        root = next((r for r in recs if r[3] == "collect" and r[2] == 0), None)
        if root is None:
            continue
        kids = sorted((max(r[5], root[5]), min(r[6], root[6])) for r in recs if r[2] == root[1])
        reach = root[5]
        for s, e in kids:
            s = max(s, reach)
            if e > s:
                covered += e - s
                reach = e
        whole += root[6] - root[5]
    return covered / whole if whole else None
