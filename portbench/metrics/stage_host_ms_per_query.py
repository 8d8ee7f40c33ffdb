"""stage_host_ms_per_query: the port's `stage` spans (TpuStageExec's whole
dispatch: table lookup, LUTs, lowering, enqueue, fetch, decode) less their
`stage.wait` (the host blocked on the card), in ms, per statement
completed in the traced window. Layer: device stage."""

from portbench.harness.spans import ms_per_statement


def read(w):
    return ms_per_statement(w, ("stage",), ("stage.wait",))
