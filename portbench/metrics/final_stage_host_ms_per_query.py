"""final_stage_host_ms_per_query: the port's `final` spans (the device
final stage) less `final.input` (the reader pool over the child stage,
whose own time the stage's spans hold) and `final.wait` (the host blocked
on the card), plus `final.cpu` (the final stage's CPU form, where the
device stage declined: q1's 32 partial rows are below
ballista.tpu.min.rows), in ms, per statement completed in the traced
window. Layer: device stage."""

from portbench.harness.spans import ms_per_statement


def read(w):
    return ms_per_statement(w, ("final", "final.cpu"), ("final.input", "final.wait"))
