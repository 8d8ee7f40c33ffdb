"""physical_plan_ms: the port's `plan.physical` (create_physical_plan) and
`plan.device` (maybe_compile_tpu) spans, in ms, per statement completed in
the traced window. Layer: client and SQL planner."""

from portbench.harness.spans import ms_per_statement


def read(w):
    return ms_per_statement(w, ("plan.physical", "plan.device"))
