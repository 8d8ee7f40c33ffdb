"""footer_reads_per_query: the port's footer_reads counter (every parquet
footer its planner parsed) since its spans turned on at the window's first
statement, per statement recorded since then. A port without the counter
gives nothing. Layer: client and SQL planner."""

from portbench.harness.spans import port_spans


def read(w):
    got = port_spans()
    if got is None or "footer_reads" not in got[1]:
        return None
    n = sum(1 for r in got[0] if r[3] == "collect" and r[2] == 0)
    return got[1]["footer_reads"] / n if n else None
