"""Engine-specific analysis passes.

Each module defines one `AnalysisPass` subclass; `ALL_PASSES` is the
registry the CLI and the tier-1 gate run. Order is reporting order only —
passes are independent.
"""

from ballista_tpu_torch.analysis.passes.bounded_cache import BoundedCachePass
from ballista_tpu_torch.analysis.passes.event_loop import EventLoopHygienePass
from ballista_tpu_torch.analysis.passes.knob_sync import KnobSyncPass
from ballista_tpu_torch.analysis.passes.serde_sync import SerdeCompletenessPass
from ballista_tpu_torch.analysis.passes.stats_sync import StatsRegistrySyncPass
from ballista_tpu_torch.analysis.passes.torch_guard import TorchGuardPass

ALL_PASSES = [
    KnobSyncPass(),
    BoundedCachePass(),
    TorchGuardPass(),
    SerdeCompletenessPass(),
    StatsRegistrySyncPass(),
    EventLoopHygienePass(),
]

__all__ = [
    "ALL_PASSES",
    "BoundedCachePass",
    "EventLoopHygienePass",
    "KnobSyncPass",
    "SerdeCompletenessPass",
    "StatsRegistrySyncPass",
    "TorchGuardPass",
]
