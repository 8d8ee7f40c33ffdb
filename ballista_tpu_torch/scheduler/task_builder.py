"""Per-task plan restriction.

Rebuild of the reference's task-plan rewriter
(scheduler/src/state/task_builder.rs:18-64): every task of a stage shares
the stage plan, but a task executing partitions {p} only needs the scan
file-groups and shuffle-reader location lists of those partitions. Without
restriction, task protos grow as O(partitions × locations) — the
reference's own SF1000 baseline failed Q11/Q21/Q22 on a 16 MiB plan-size
ceiling even WITH restriction (BASELINE.md), so shipping full plans hits
that wall far sooner.

Restriction preserves GLOBAL partition indexing: non-task slots become
empty (no files / no locations), they are never removed, so `execute(p)`
addressing is unchanged.

Scoping (the task_builder.rs trap): leaves under a COLLAPSE — an operator
whose execute(k) consumes child partitions other than k — must keep full
input:
- collect_left HashJoin build sides (read in full by every task)
- CrossJoin left sides
- SortPreservingMerge / CoalescePartitions / Union / Repartition children
- broadcast shuffle readers (every partition reads everything)

Under `ballista.executor.engine = tpu`, Parquet scans are NOT restricted:
the executor's engine seam lifts scan-rooted chains into whole-table
device stages whose [P, N] device cache is keyed on the scan's file set —
per-task file subsets would defeat that cache (one device encode per task
instead of one per table). Reader location lists, which dominate plan
size, are still restricted.
"""

from __future__ import annotations

from ballista_tpu_torch.config import EXECUTOR_ENGINE, BallistaConfig
from ballista_tpu_torch.plan.physical import (
    CoalescePartitionsExec,
    CrossJoinExec,
    ExecutionPlan,
    HashJoinExec,
    ParquetScanExec,
    RepartitionExec,
    SortPreservingMergeExec,
    UnionExec,
)
from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec
from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec
from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec

_COLLAPSE_ALL_CHILDREN = (
    SortPreservingMergeExec,
    CoalescePartitionsExec,
    UnionExec,
    RepartitionExec,
)


def restrict_plan_to_partitions(plan: ExecutionPlan, partitions: list[int],
                                config: BallistaConfig | None = None) -> ExecutionPlan:
    keep = set(partitions)
    restrict_scans = True
    if config is not None and str(config.get(EXECUTOR_ENGINE)) == "tpu":
        restrict_scans = False

    def walk(node: ExecutionPlan, scoped: bool) -> ExecutionPlan:
        if isinstance(node, ShuffleReaderExec):
            if not scoped or node.broadcast:
                return node
            new_locs = [
                locs if i in keep else []
                for i, locs in enumerate(node.partition_locations)
            ]
            out = ShuffleReaderExec(node.df_schema, new_locs, node.broadcast)
            return out
        if isinstance(node, ParquetScanExec):
            if not scoped or not restrict_scans:
                return node
            new_parts = [
                p if i in keep else {"files": []}
                for i, p in enumerate(node.partitions)
            ]
            return ParquetScanExec(
                node.df_schema, new_parts, node.projection, node.filters, node.table_name
            )
        kids = node.children()
        if not kids:
            return node
        new_kids = []
        for idx, c in enumerate(kids):
            child_scoped = scoped
            if isinstance(node, _COLLAPSE_ALL_CHILDREN):
                child_scoped = False
            elif isinstance(node, MeshExchangeExec):
                # the fused exchange consumes EVERY producer partition in its
                # one device dispatch; scoping its input would starve the
                # all_to_all of rows
                child_scoped = False
            elif isinstance(node, HashJoinExec) and node.mode == "collect_left" and idx == 0:
                child_scoped = False
            elif isinstance(node, DynamicJoinSelectionExec):
                # the deferred decision may promote EITHER side to a
                # collected build at first-batch time — both children keep
                # full location lists (restriction is a size optimization,
                # never a correctness requirement)
                child_scoped = False
            elif isinstance(node, CrossJoinExec) and idx == 0:
                child_scoped = False
            new_kids.append(walk(c, child_scoped))
        if all(a is b for a, b in zip(new_kids, kids)):
            return node
        return node.with_children(new_kids)

    return walk(plan, True)
