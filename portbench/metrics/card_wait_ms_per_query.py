"""card_wait_ms_per_query: the port's `stage.wait` and `final.wait` spans,
the host threads blocked on the card, in ms, per statement completed in
the traced window. Layer: card."""

from portbench.harness.spans import ms_per_statement


def read(w):
    return ms_per_statement(w, ("stage.wait", "final.wait"))
