"""The device's side of a traced window, from torch.profiler.

`DeviceTrace` records the card's activity (kernels, copies, fills) from
just before the streams are released until every stream has drained.
Event times are Unix seconds, the clock of the host spans. Nothing here
imports the port.
"""

from __future__ import annotations

import time


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.start_s = self.stop_s = 0.0
        self.events: list[tuple[str, str, float, float]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_s = time.time()

    def stop(self) -> None:
        """Wait for the card, stop, and keep the device events as
        (name, kind, start_s, end_s); kind is "kernel", "memcpy" or
        "memset" (from the event's name where the profiler gives none)."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.stop_s = time.time()
        self._prof.__exit__(None, None, None)
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            start = e.start_ns() / 1e9
            out.append((name, _kind(name), start, start + e.duration_ns() / 1e9))
        out.sort(key=lambda ev: ev[2])
        self.events = out
        self._prof = None


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def busy_intervals(events) -> list[tuple[float, float]]:
    """The union of the events' intervals, as disjoint (start, end) pairs."""
    out: list[list[float]] = []
    for _, _, s, e in sorted(events, key=lambda ev: ev[2]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: list[tuple[float, float]], start: float, stop: float) -> list[tuple[float, float]]:
    """The stretches of [start, stop] in which the card ran nothing."""
    gaps, reach = [], start
    for s, e in busy:
        if s > reach:
            gaps.append((reach, min(s, stop)))
        reach = max(reach, e)
    if reach < stop:
        gaps.append((reach, stop))
    return [(s, e) for s, e in gaps if e > s]
