"""latency_p95_s.closed_loop: the 95th percentile, submission to the last
row, of every statement completed in the traced window of a closed loop.
Its spread between runs (the host's speed, which moves the tail most) is
too wide for a bound, so it is read here beside the bounded median.
Layer: report streams."""

from portbench.harness.main import percentile


def read(w):
    if not w.queries:
        return None
    return percentile([q.done - q.submit for q in w.queries], 95)
