"""High-QPS serving tier: plan cache, prepared statements, result cache.

The scheduler-side machinery that turns repeated small queries from a
full parse→optimize→plan→DAG round trip into a cache hit:

- `normalize`: lift literals out of an optimized logical plan into
  parameter slots, fingerprint the shape, and bind values back into a
  cached physical-plan template.
- `tier`: the `ServingTier` facade owning the LRU-bounded plan/result
  caches, table-version invalidation, and prepared-statement registry.
- `incremental`: delta maintenance over append ingestion — eligibility
  analysis, retained-delta registry, maintain-plan construction, and
  continuous-query subscriptions (docs/streaming.md).
"""

from ballista_tpu_torch.serving.incremental import (
    DeltaRegistry,
    IncrementalDecision,
    Subscription,
    SubscriptionRegistry,
    analyze_plan,
    build_maintain_plan,
    decide,
    graft_append_scans,
    graft_delta_scan,
    render_finisher,
    split_finisher,
)
from ballista_tpu_torch.serving.normalize import (
    LiftResult,
    bind_logical,
    bind_physical,
    collect_physical_params,
    collect_scan_tables,
    config_fingerprint,
    decode_params,
    encode_params,
    lift_parameters,
)
from ballista_tpu_torch.serving.tier import PlanTemplate, PreparedStatement, ServingTier, StateEntry

__all__ = [
    "DeltaRegistry",
    "IncrementalDecision",
    "LiftResult",
    "PlanTemplate",
    "PreparedStatement",
    "ServingTier",
    "StateEntry",
    "Subscription",
    "SubscriptionRegistry",
    "analyze_plan",
    "bind_logical",
    "bind_physical",
    "build_maintain_plan",
    "collect_physical_params",
    "collect_scan_tables",
    "config_fingerprint",
    "decide",
    "decode_params",
    "encode_params",
    "graft_append_scans",
    "graft_delta_scan",
    "lift_parameters",
    "render_finisher",
    "split_finisher",
]
