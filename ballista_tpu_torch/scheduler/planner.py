"""Distributed planner: split a physical plan into query stages.

Rebuild of DefaultDistributedPlanner::plan_query_stages
(scheduler/src/planner.rs:108): walk the plan, cut a stage at every
exchange —

- RepartitionExec(hash K)      → ShuffleWriterExec(K, keys) stage +
                                 UnresolvedShuffleExec leaf downstream
- CoalescePartitionsExec /     → passthrough ShuffleWriterExec stage (the
  SortPreservingMergeExec        downstream single task reads every map
                                 output partition)
- HashJoin/CrossJoin build side (collect_left) → broadcast stage
  (maybe_promote_to_broadcast, planner.rs:286): written once, read in full
  by every probe task via the reader's broadcast flag

The job's root plan gains a passthrough writer too: the final stage's
shuffle files ARE the query result the client fetches.

`remove_unresolved_shuffles` (planner.rs:568) swaps resolved readers in
when input stages complete — that lives in the ExecutionGraph here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ballista_tpu_torch.plan.physical import (
    CoalescePartitionsExec,
    CrossJoinExec,
    ExecutionPlan,
    HashJoinExec,
    RepartitionExec,
    SortPreservingMergeExec,
)
from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec, UnresolvedShuffleExec
from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec


@dataclass
class QueryStage:
    stage_id: int
    plan: ShuffleWriterExec  # root is always a shuffle writer
    partitions: int  # number of map tasks (input partitions of the writer)
    output_partitions: int  # reduce-side partition count
    input_stage_ids: list[int] = field(default_factory=list)
    broadcast: bool = False  # consumed as a broadcast input
    # mesh-wide stage (merge_mesh_stages): the stage contains a
    # MeshExchangeExec and must ship as ONE task spanning every partition —
    # the exchange runs once, on-device, and serves all reduce buckets
    mesh: bool = False

    def display(self) -> str:
        mesh = " mesh" if self.mesh else ""
        return f"Stage {self.stage_id} [partitions={self.partitions} → {self.output_partitions}{mesh}]\n" + self.plan.display(1)


class DistributedPlanner:
    def __init__(self, job_id: str):
        self.job_id = job_id
        self.next_stage_id = 1
        self.stages: list[QueryStage] = []

    def plan_query_stages(self, plan: ExecutionPlan) -> list[QueryStage]:
        root, _ = self._walk(plan)
        # final stage: passthrough writer over the root
        final = ShuffleWriterExec(root, self.job_id, self.next_stage_id, 0, [], sort_shuffle=False)
        self._add_stage(final, root.output_partition_count(), root.output_partition_count())
        return self.stages

    # ------------------------------------------------------------------

    def _add_stage(self, writer: ShuffleWriterExec, partitions: int, output_partitions: int,
                   broadcast: bool = False) -> QueryStage:
        stage = QueryStage(
            stage_id=self.next_stage_id,
            plan=writer,
            partitions=partitions,
            output_partitions=output_partitions,
            input_stage_ids=_find_input_stages(writer),
            broadcast=broadcast,
        )
        self.stages.append(stage)
        self.next_stage_id += 1
        return stage

    def _walk(self, node: ExecutionPlan) -> tuple[ExecutionPlan, bool]:
        """Returns (rewritten node, changed)."""
        if isinstance(node, RepartitionExec) and node.scheme == "hash":
            child, _ = self._walk(node.input)
            writer = ShuffleWriterExec(
                child, self.job_id, self.next_stage_id, node.n, node.keys, sort_shuffle=True
            )
            stage = self._add_stage(writer, child.output_partition_count(), node.n)
            return (
                UnresolvedShuffleExec(stage.stage_id, node.df_schema, node.n, broadcast=False),
                True,
            )
        if isinstance(node, (CoalescePartitionsExec, SortPreservingMergeExec)):
            child, _ = self._walk(node.children()[0])
            if child.output_partition_count() <= 1:
                return node.with_children([child]), True
            writer = ShuffleWriterExec(
                child, self.job_id, self.next_stage_id, 0, [], sort_shuffle=False
            )
            stage = self._add_stage(writer, child.output_partition_count(), child.output_partition_count())
            reader_leaf = UnresolvedShuffleExec(
                stage.stage_id, child.df_schema, child.output_partition_count(), broadcast=False
            )
            return node.with_children([reader_leaf]), True
        if isinstance(node, (HashJoinExec, CrossJoinExec)) and getattr(node, "mode", "collect_left") == "collect_left":
            left, right = node.children()
            left, _ = self._walk(left)
            right, _ = self._walk(right)
            # broadcast promotion: build side materialized once (unless it is
            # already a single in-stage partition, e.g. a tiny dimension scan)
            if left.output_partition_count() > 1 or _contains_shuffle(left):
                writer = ShuffleWriterExec(
                    left, self.job_id, self.next_stage_id, 0, [], sort_shuffle=False
                )
                stage = self._add_stage(
                    writer, left.output_partition_count(), left.output_partition_count(), broadcast=True
                )
                left = UnresolvedShuffleExec(
                    stage.stage_id, left.df_schema, left.output_partition_count(), broadcast=True
                )
            return node.with_children([left, right]), True
        kids = node.children()
        if not kids:
            return node, False
        new_kids = []
        changed = False
        for k in kids:
            nk, ch = self._walk(k)
            new_kids.append(nk)
            changed = changed or ch
        if changed:
            return node.with_children(new_kids), True
        return node, False


# -- mesh-wide stage merging ---------------------------------------------------
#
# A hash exchange between two stages of the SAME host round-trips through
# Arrow IPC files and Flight RPCs even though both sides run on chips of one
# device mesh. When the shape allows, the producer stage is merged INTO its
# consumer: the producer's ShuffleWriterExec(hash K) and the consumer's
# reader leaf collapse into a MeshExchangeExec, and the merged stage ships
# as one mesh-wide task whose repartition is an on-device all_to_all
# (ops/cuda/mesh_stage.py). Stages that don't fit the shape keep the file
# path — this is an optimization pass, never a correctness requirement.


def choose_mesh_mode(producer: QueryStage, consumers: list[tuple[QueryStage, list]],
                     config) -> tuple[bool, str]:
    """The planner's side of the mesh cost model: is this exchange edge
    mergeable at all? Returns (ok, reason); runtime demotion (capacity,
    devices, dtypes, AQE input-bytes) happens later with real data in hand.
    """
    if producer.broadcast:
        return False, "broadcast-producer"
    if not producer.plan.sort_shuffle or not producer.plan.keys:
        return False, "not-hash-exchange"
    if producer.output_partitions < 1:
        return False, "no-output-partitions"
    if producer.mesh:
        return False, "producer-already-mesh"
    if len(consumers) != 1:
        return False, f"consumers:{len(consumers)}"
    consumer, leaves = consumers[0]
    if len(leaves) != 1:
        return False, f"leaves:{len(leaves)}"
    if leaves[0].broadcast:
        return False, "broadcast-edge"
    if consumer.partitions != producer.output_partitions:
        # the merged stage's ONE task must cover exactly the reduce buckets
        # the exchange produces; a mismatched consumer keeps the file path
        return False, "partition-mismatch"
    return True, "mesh"


def merge_mesh_stages(stages: list[QueryStage], config) -> list[QueryStage]:
    """Fuse single-consumer hash-exchange edges into mesh-wide stages.

    Runs to a fixpoint so a chain of exchanges (partial agg → repartition →
    final agg → repartition → sort) can collapse into one mesh stage. Only
    active under `ballista.tpu.mesh.enabled` with the TPU executor engine —
    per-partition CPU tasks gain nothing from a collective exchange."""
    import logging

    from ballista_tpu_torch.config import EXECUTOR_ENGINE, TPU_MESH_ENABLED

    log = logging.getLogger(__name__)
    if config is None or not bool(config.get(TPU_MESH_ENABLED)):
        return stages
    if str(config.get(EXECUTOR_ENGINE)) != "tpu":
        return stages

    from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec

    def leaves_for(stage: QueryStage, producer_id: int):
        out = []

        def walk(n):
            if isinstance(n, UnresolvedShuffleExec) and n.stage_id == producer_id:
                out.append(n)
            for c in n.children():
                walk(c)

        walk(stage.plan)
        return out

    changed = True
    while changed:
        changed = False
        for producer in list(stages):
            consumers = []
            for s in stages:
                if s.stage_id == producer.stage_id:
                    continue
                leaves = leaves_for(s, producer.stage_id)
                if leaves:
                    consumers.append((s, leaves))
            if not consumers:
                continue  # the final stage: its files ARE the result
            ok, reason = choose_mesh_mode(producer, consumers, config)
            if not ok:
                log.debug("mesh merge skipped stage %d: %s", producer.stage_id, reason)
                continue
            consumer, (leaf,) = consumers[0]
            exchange = MeshExchangeExec(
                producer.plan.input, producer.plan.keys, producer.output_partitions
            )

            def swap(n):
                if n is leaf:
                    return exchange
                kids = n.children()
                if not kids:
                    return n
                new_kids = [swap(c) for c in kids]
                if all(a is b for a, b in zip(new_kids, kids)):
                    return n
                return n.with_children(new_kids)

            consumer.plan = swap(consumer.plan)
            consumer.mesh = True
            consumer.input_stage_ids = _find_input_stages(consumer.plan)
            stages = [s for s in stages if s.stage_id != producer.stage_id]
            log.info(
                "mesh merge: stage %d (hash exchange, %d buckets) fused into "
                "stage %d as an on-device all_to_all",
                producer.stage_id, producer.output_partitions, consumer.stage_id,
            )
            changed = True
            break
    return stages


def _find_input_stages(plan: ExecutionPlan) -> list[int]:
    out: list[int] = []

    def walk(n: ExecutionPlan):
        if isinstance(n, UnresolvedShuffleExec):
            out.append(n.stage_id)
        for c in n.children():
            walk(c)

    walk(plan)
    return sorted(set(out))


def _contains_shuffle(plan: ExecutionPlan) -> bool:
    if isinstance(plan, (UnresolvedShuffleExec, ShuffleReaderExec)):
        return True
    return any(_contains_shuffle(c) for c in plan.children())


def remove_unresolved_shuffles(plan: ExecutionPlan, resolved: dict[int, ShuffleReaderExec]) -> ExecutionPlan:
    """Swap UnresolvedShuffleExec leaves for concrete readers
    (reference: planner.rs:568)."""
    if isinstance(plan, UnresolvedShuffleExec):
        reader = resolved.get(plan.stage_id)
        if reader is None:
            raise RuntimeError(f"stage {plan.stage_id} not resolved yet")
        return reader
    kids = plan.children()
    if not kids:
        return plan
    return plan.with_children([remove_unresolved_shuffles(c, resolved) for c in kids])
