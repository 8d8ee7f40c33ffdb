"""On the card: the traced window's busy time, held against CUDA events.

Run on a machine with a card: python -m pytest portbench/tests -m gpu
"""

import pytest

from portbench.harness.trace import DeviceTrace, busy_intervals


@pytest.mark.gpu
def test_trace_busy_time_agrees_with_cuda_events(card):
    import torch

    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    trace = DeviceTrace()
    trace.start()
    start.record()
    for _ in range(10):
        dst.copy_(src)
    end.record()
    trace.stop()
    events_s = start.elapsed_time(end) / 1e3
    busy_s = sum(e - s for s, e in busy_intervals(trace.events))
    floor_s = 10 * 2 * src.numel() * 4 / 3.35e12  # bytes read and written at the peak
    assert trace.events and all(start_s >= trace.start_s - 1 for _, _, start_s, _ in trace.events)
    assert abs(busy_s - events_s) <= 0.1 * events_s
    assert min(busy_s, events_s) >= floor_s
