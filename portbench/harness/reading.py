"""What a per-layer metric reads: one traced window, reduced to plain data.

Each `metrics/<name>.py` has `read(w: Traced) -> float | None`. A reader
that finds nothing to read returns None and the metric is left out of the
result line. Readers import nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM5 80GB, dense, at its 700 W limit (NVIDIA's data sheet)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12, "tf32_flops": 495e12,
         "bf16_flops": 989e12, "fp8_flops": 1979e12, "int8_ops": 1979e12,
         "memory_bytes": 80e9}


@dataclass
class Query:
    stream: int
    name: str      # the query, as in the mix: "q5"
    submit: float  # host seconds (Unix)
    planned: float  # end of the `sql` span
    done: float    # last row collected


@dataclass
class Traced:
    start: float                 # the traced window: streams released ...
    stop: float                  # ... to every stream drained
    queries: list[Query]         # every statement completed in it
    events: list | None          # device events (name, kind, start, end); None without a card trace
    counters: dict = field(default_factory=dict)  # the port's kernel counters, window deltas

    @property
    def seconds(self) -> float:
        return self.stop - self.start
