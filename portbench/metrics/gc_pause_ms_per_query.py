"""gc_pause_ms_per_query: Python's collections in the traced window (the
port's `gc` spans, each once: a collection holds every thread), in ms, per
statement completed in the window. Layer: host process."""

from portbench.harness.spans import gc_ms_per_statement


def read(w):
    return gc_ms_per_statement(w)
