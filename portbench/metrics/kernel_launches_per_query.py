"""kernel_launches_per_query: the CUDA kernel events (not copies or fills)
in the profiler's trace of the window, per statement completed in it.
Layer: device stage."""


def read(w):
    if w.events is None or not w.queries:
        return None
    return sum(1 for e in w.events if e[1] == "kernel") / len(w.queries)
