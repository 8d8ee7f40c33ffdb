"""AQE decision counters: RunStats emissions from the replanning seam.

The scheduler's adaptive rules (scheduler/aqe/) run outside any RUN_STATS
run scope, so each helper here writes straight into the merged gauges —
the same store the executor heartbeat ships to /api/executors
(executor_process._tpu_metrics). Standalone mode runs the scheduler
in-process, so these scheduler-side decisions surface in the exact same
gauge pipeline as device-side stats.

Every helper is deliberately best-effort: a stats failure must never turn
a replan into a scheduling error. Keys stay literal per function so the
stats-sync analysis pass can match emissions against the consumer list.
"""

from __future__ import annotations


def _stats():
    try:
        from ballista_tpu_torch.ops.cuda import stage_compiler

        return stage_compiler.RUN_STATS
    except Exception:  # pragma: no cover — stats must never break scheduling
        return None


def note_skew_splits(n: int = 1) -> None:
    """Hot reduce partitions split into slice tasks at stage resolution."""
    stats = _stats()
    if stats is None:
        return
    try:
        stats.set("skew_splits", int(stats.snapshot().get("skew_splits", 0) or 0) + n)
    except Exception:
        pass


def note_coalesced_partitions(n: int) -> None:
    """Reduce partitions merged away by AQE coalescing (old count - new)."""
    stats = _stats()
    if stats is None or n <= 0:
        return
    try:
        stats.set("coalesced_partitions",
                  int(stats.snapshot().get("coalesced_partitions", 0) or 0) + n)
    except Exception:
        pass


def note_broadcast_promotion(n: int = 1) -> None:
    """Hash joins promoted to broadcast from observed build-side size."""
    stats = _stats()
    if stats is None:
        return
    try:
        stats.set("broadcast_promotions",
                  int(stats.snapshot().get("broadcast_promotions", 0) or 0) + n)
    except Exception:
        pass


def note_broadcast_demotion(n: int = 1) -> None:
    """Planned broadcasts demoted to partitioned joins (build oversized)."""
    stats = _stats()
    if stats is None:
        return
    try:
        stats.set("broadcast_demotions",
                  int(stats.snapshot().get("broadcast_demotions", 0) or 0) + n)
    except Exception:
        pass


def note_mesh_replan(n: int = 1) -> None:
    """Mesh stages AQE acted on: bucket-count replan or skew demotion."""
    stats = _stats()
    if stats is None:
        return
    try:
        stats.set("aqe_mesh_replans",
                  int(stats.snapshot().get("aqe_mesh_replans", 0) or 0) + n)
    except Exception:
        pass
