"""device_idle_share: 100 * (1 - the union of the device events'
intervals / the traced window's wall). Layer: card."""

from portbench.harness.trace import busy_intervals


def read(w):
    if not w.events or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - sum(e - s for s, e in busy_intervals(w.events)) / w.seconds)
