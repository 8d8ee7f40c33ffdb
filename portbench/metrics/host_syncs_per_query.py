"""host_syncs_per_query: the port's host_syncs counter (every synchronize,
event wait and blocking fetch of a port thread) since its spans turned on
at the window's first statement, per statement traced. Layer: device
stage."""

from portbench.harness.spans import syncs_per_statement


def read(w):
    return syncs_per_statement()
