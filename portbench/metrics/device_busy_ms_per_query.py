"""device_busy_ms_per_query: the union of the device events' intervals in
the traced window, in ms, per statement completed in it. Layer: card."""

from portbench.harness.trace import busy_intervals


def read(w):
    if not w.events or not w.queries:
        return None
    return 1e3 * sum(e - s for s, e in busy_intervals(w.events)) / len(w.queries)
