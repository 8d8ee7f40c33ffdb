"""The adaptive replanning pass: one pipeline, run over the remaining plan.

Reference shape (scheduler/src/state/aqe/planner.rs:304): after every stage
finalizes, `replan_stages` re-runs a physical-optimizer pipeline over the
plan that has NOT yet executed, with the finished stages' actual statistics
bound; actionable outcomes become resolved stages, obsolete ones are
cancelled. Round 2 of this build carried the same behaviors as three ad-hoc
hooks inlined in ExecutionGraph; this module restructures them as rules in
an explicit pipeline so the pass composes and grows the way the
reference's does.

Two pipeline points, both invoked by ExecutionGraph under its lock:

- `replan_after_finalize` — a stage just became SUCCESSFUL. Rules walk the
  REMAINING plan (every still-unresolved stage spec, leaves =
  UnresolvedShuffleExec placeholders) to fixpoint:
    1. EmptyPropagationRule  — collapse joins against proven-empty inputs,
       complete provably-empty stages without scheduling (skip), which can
       cascade further finalizations.
    2. RuntimeJoinSelectionRule — a partitioned join whose build input
       finished tiny becomes CollectLeft over a broadcast read, and the
       not-yet-started probe stage's hash shuffle is rewritten to a
       passthrough (probe-side shuffle elision — the rewrite only an
       incremental replanner can reach).
  then obsolete stages (no remaining consumer) are cancelled.

- `replan_at_resolution` — a stage's inputs all finished; before readers
  are built:
    3. AlterFanoutRule — shrink the stage's hash fan-out K when observed
       input volume proves the planned bucket count absurd, repartitioning
       the still-unresolved consumer chain.
  Reader-level rules (resolution-time empty propagation, join selection
  with actual sizes, partition coalescing with merged-factor/small-tail
  bin-packing) then run in `aqe.rules.apply_aqe` over the resolved plan.

Exchange insertion is the one reference rule with no analog here by
design: stage boundaries are fixed at static planning time, and runtime
exchange changes are expressed as boundary REWRITES (passthrough elision,
fan-out alteration) rather than insertions.
"""

from __future__ import annotations

import logging

from ballista_tpu_torch.config import (
    AQE_ALTER_FANOUT,
    AQE_DYNAMIC_JOIN_SELECTION,
    AQE_EMPTY_PROPAGATION,
    AQE_TARGET_PARTITION_BYTES,
    BROADCAST_JOIN_ROWS_THRESHOLD,
    BROADCAST_JOIN_THRESHOLD,
    PLANNER_ADAPTIVE_ENABLED,
)
from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec

log = logging.getLogger(__name__)

# runtime broadcast decisions apply this safety factor to the configured
# planner threshold (the elision rewrites TWO stages; fire conservatively)
ELISION_MARGIN = 8


class EmptyPropagationRule:
    """Collapse join shapes in unresolved stage specs against inputs that
    finished with ZERO rows; stages thereby proven empty complete without
    scheduling a single task (reference: PropagateEmptyExecRule over the
    remaining plan + stage skipping, state/aqe/planner.rs:349)."""

    def on_finalize(self, graph, finished, events: list[str]) -> bool:
        from ballista_tpu_torch.scheduler.aqe.rules import (
            propagate_empty_unresolved,
            provably_empty,
        )
        from ballista_tpu_torch.scheduler.planner import _find_input_stages
        from ballista_tpu_torch.scheduler.state.execution_graph import JobState, StageState

        if not bool(graph.config.get(AQE_EMPTY_PROPAGATION)):
            return False

        empty_ids = {
            sid for sid, s in graph.stages.items()
            if s.state is StageState.SUCCESSFUL
            and not any(l.stats.num_rows for l in s.output_locations())
        }
        if not empty_ids:
            return False

        changed = False
        for s in graph.stages.values():
            if graph.status is not JobState.RUNNING:
                break
            if s.state is not StageState.UNRESOLVED:
                continue
            new_plan = propagate_empty_unresolved(s.spec.plan, empty_ids)
            if new_plan is s.spec.plan:
                continue
            s.spec.plan = new_plan
            s.spec.input_stage_ids = _find_input_stages(s.spec.plan)
            changed = True
            if s.stage_id != graph.final_stage_id and provably_empty(s.spec.plan.input):
                log.info(
                    "AQE replan: stage %d proven empty after stage %d finished "
                    "with 0 rows — skipped without scheduling",
                    s.stage_id, finished.stage_id,
                )
                graph.complete_stage_skipped(s, events)
            else:
                # the collapse may have removed the LAST pending input (e.g.
                # a group-less aggregate over the emptied join still has to
                # run to emit its zero-count row): nothing else will trigger
                # resolution, so try it here
                graph._try_resolve(s)
        return changed


class RuntimeJoinSelectionRule:
    """Replan partitioned joins whose BUILD input just finished tiny while
    the PROBE-side hash shuffle hasn't started: the join becomes CollectLeft
    over a broadcast build, and the probe stage's hash writer is rewritten
    to a passthrough, ELIDING the probe-side shuffle entirely. This is the
    win resolution-time rewrites cannot reach: by resolution the probe rows
    have already been hashed, bucketed, and written (reference:
    DelayJoinSelectionRule/SelectJoinRule via AdaptivePlanner::replan_stages,
    state/aqe/planner.rs:304, execution_plan/dynamic_join.rs)."""

    def on_finalize(self, graph, finished, events: list[str]) -> bool:
        from ballista_tpu_torch.plan.physical import HashJoinExec
        from ballista_tpu_torch.scheduler.state.execution_graph import StageState
        from ballista_tpu_torch.shuffle.reader import UnresolvedShuffleExec
        from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec

        if not bool(graph.config.get(AQE_DYNAMIC_JOIN_SELECTION)):
            return False
        threshold = int(graph.config.get(BROADCAST_JOIN_ROWS_THRESHOLD)) // ELISION_MARGIN
        byte_limit = int(graph.config.get(BROADCAST_JOIN_THRESHOLD)) // ELISION_MARGIN

        def passthrough(writer: ShuffleWriterExec) -> ShuffleWriterExec:
            return ShuffleWriterExec(
                writer.input, graph.job_id, writer.stage_id, 0, [], sort_shuffle=False
            )

        def reader_refs(pid: int) -> int:
            """How many shuffle-reader leaves across live stage specs read
            stage `pid`. The elision rewrites the PRODUCERS (probe writer →
            passthrough, build stage → broadcast), so it is only sound when
            this join holds the sole reference — a second consumer would
            keep expecting the original hash layout (the q68 shape: one
            producer fans out to two join stages)."""
            n = 0
            for s in graph.stages.values():
                if s.state is StageState.SUCCESSFUL:
                    continue

                def walk(node):
                    nonlocal n
                    if isinstance(node, UnresolvedShuffleExec) and node.stage_id == pid:
                        n += 1
                    for c in node.children():
                        walk(c)

                walk(s.spec.plan)
            return n

        any_changed = False
        for stage in graph.stages.values():
            if stage.state is not StageState.UNRESOLVED:
                continue

            def rewrite(node):
                changed = False
                kids = node.children()
                if kids:
                    new_kids = []
                    for c in kids:
                        nc, ch = rewrite(c)
                        new_kids.append(nc)
                        changed = changed or ch
                    if changed:
                        node = node.with_children(new_kids)
                # the planner's deferred-decision node carries the same join
                # fields as a partitioned HashJoinExec; the cascade rewrite
                # concretizes either into a CollectLeft broadcast
                if (
                    isinstance(node, (HashJoinExec, DynamicJoinSelectionExec))
                    and node.mode == "partitioned"
                    and node.join_type in ("inner", "right", "right_semi", "right_anti")
                    and isinstance(node.left, UnresolvedShuffleExec)
                    and isinstance(node.right, UnresolvedShuffleExec)
                    and node.left.stage_id != node.right.stage_id
                ):
                    build = graph.stages.get(node.left.stage_id)
                    probe = graph.stages.get(node.right.stage_id)
                    if build is None or probe is None or build.state is not StageState.SUCCESSFUL:
                        return node, changed
                    if (
                        probe.running or probe.completed
                        or probe.state not in (StageState.UNRESOLVED, StageState.RESOLVED)
                        or probe.spec.plan.output_partitions <= 0
                    ):
                        return node, changed  # probe started (or already passthrough)
                    rows = sum(loc.stats.num_rows for loc in build.output_locations())
                    nbytes = sum(loc.stats.num_bytes for loc in build.output_locations())
                    # byte-aware as well as row-aware: the collected build
                    # ships to every probe task, so wide payloads that
                    # squeak under the row budget must still stay put
                    if rows > threshold or nbytes > byte_limit:
                        return node, changed
                    if reader_refs(probe.stage_id) != 1 or reader_refs(build.stage_id) != 1:
                        return node, changed
                    probe.spec.plan = passthrough(probe.spec.plan)
                    probe.spec.output_partitions = probe.spec.partitions
                    if probe.resolved_plan is not None:
                        probe.resolved_plan = passthrough(probe.resolved_plan)
                    build.spec.broadcast = True
                    new_left = UnresolvedShuffleExec(
                        build.stage_id, node.left.df_schema, node.left.output_partitions,
                        broadcast=True,
                    )
                    new_right = UnresolvedShuffleExec(
                        probe.stage_id, node.right.df_schema, probe.spec.partitions,
                        broadcast=False,
                    )
                    log.info(
                        "AQE replan: build stage %d finished with %d rows / %d "
                        "bytes → CollectLeft broadcast; probe stage %d hash "
                        "shuffle elided (passthrough, %d partitions)",
                        build.stage_id, rows, nbytes, probe.stage_id,
                        probe.spec.partitions,
                    )
                    from ballista_tpu_torch.ops.cuda import aqe_stats

                    aqe_stats.note_broadcast_promotion()
                    return (
                        HashJoinExec(
                            new_left, new_right, node.on, node.join_type, node.filter,
                            "collect_left", node.df_schema,
                        ),
                        True,
                    )
                return node, changed

            new_plan, changed = rewrite(stage.spec.plan)
            if changed:
                stage.spec.plan = new_plan
                stage.spec.partitions = new_plan.input.output_partition_count()
                stage.pending = list(range(stage.spec.partitions))
                stage.effective_partitions = stage.spec.partitions
                any_changed = True
        return any_changed


class AlterFanoutRule:
    """Stage-alteration replanning at resolution (state/aqe/planner.rs:349,
    alter_stages analog): after this stage's inputs finished but before any
    of its tasks launch, shrink its hash fan-out K when the observed input
    volume proves the planned bucket count absurd, and patch the
    still-unresolved consumers' leaves to the new K. Read-side coalescing
    (CoalescePartitionsRule in apply_aqe) already merges tiny reduce reads;
    this removes the WRITE-side cost: K sort-shuffle buckets, K index
    entries, K files per map task.

    Guards: every transitive consumer must still be UNRESOLVED and have
    this stage as its ONLY input, so co-partitioned join alignment (two
    producers hashed to the same K) can never break."""

    def on_resolve(self, graph, stage, inputs) -> None:
        from ballista_tpu_torch.scheduler.state.execution_graph import StageState
        from ballista_tpu_torch.shuffle.reader import UnresolvedShuffleExec
        from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec

        if not bool(graph.config.get(AQE_ALTER_FANOUT)):
            return
        writer = stage.spec.plan
        if not isinstance(writer, ShuffleWriterExec) or writer.output_partitions <= 1:
            return
        if stage.spec.broadcast:
            return

        def leaves(node):
            kids = node.children()
            if not kids:
                yield node
            for c in kids:
                yield from leaves(c)

        # every leaf must be a shuffle input: a stage that also SCANS a
        # table (e.g. broadcast-join probe) has volume the input stats
        # cannot see
        if any(not isinstance(l, UnresolvedShuffleExec) for l in leaves(writer.input)):
            return
        # transitively collect the consumers whose task count must follow
        # the altered output count: a PASSTHROUGH consumer's own output
        # count equals its task count (one file per task), so ITS consumers
        # — e.g. a join stage left behind by broadcast elision — must be
        # repartitioned too, or they schedule tasks past the shrunken
        # reader. Abort entirely if any transitive consumer fails the
        # safety guards (unresolved + single-input): a half-patched chain
        # would execute partitions that no longer exist.
        affected: list[tuple[int, object]] = []  # (producer_id, consumer)
        bcast_readers: list[tuple[int, int]] = []  # (producer_id, consumer_id)
        seen: set[int] = set()
        frontier = [(stage.stage_id, cid) for cid in graph.output_links.get(stage.stage_id, [])]
        if not frontier:
            return
        while frontier:
            pid, cid = frontier.pop(0)
            c = graph.stages.get(cid)
            if (c is None or cid in seen
                    or c.state is not StageState.UNRESOLVED
                    or set(c.spec.input_stage_ids) != {pid}):
                return
            seen.add(cid)
            affected.append((pid, c))
            if c.spec.plan.output_partitions <= 0:
                nxt = [(cid, g) for g in graph.output_links.get(cid, [])]
                if not c.spec.broadcast:
                    frontier.extend(nxt)
                else:
                    # broadcast outputs are read whole regardless of count,
                    # so consumers past a broadcast passthrough keep their
                    # task layout — but their reader leaves still advertise
                    # the producer's count, which must follow the new K or
                    # the plan verifier sees a phantom partition mismatch
                    bcast_readers.extend(nxt)
        for _, cid in bcast_readers:
            c = graph.stages.get(cid)
            if c is None or c.state is not StageState.UNRESOLVED:
                return  # can't patch a built reader: abort before mutating
        total_bytes = sum(
            l.stats.num_bytes for inp in inputs for l in inp.output_locations()
        )
        target = max(1, int(graph.config.get(AQE_TARGET_PARTITION_BYTES)))
        # input volume bounds this stage's output for scan/filter/agg
        # pipelines; expansion joins can exceed it, so shrink only with a
        # 2x margin and only when the drop is at least 2x (mis-guessing low
        # costs read-side balance, never correctness)
        k = writer.output_partitions
        new_k = max(1, -(-2 * total_bytes // target))  # ceil(2·bytes/target)
        if new_k > k // 2:
            return
        stage.spec.plan = ShuffleWriterExec(
            writer.input, graph.job_id, writer.stage_id, new_k, writer.keys,
            writer.sort_shuffle,
        )
        stage.spec.output_partitions = new_k

        def patch(node, pid: int, count: int, bcast: bool = False):
            if (isinstance(node, UnresolvedShuffleExec)
                    and node.stage_id == pid and bool(node.broadcast) == bcast):
                return UnresolvedShuffleExec(
                    node.stage_id, node.df_schema, count, broadcast=bcast)
            kids = node.children()
            if not kids:
                return node
            new_kids = [patch(c, pid, count, bcast) for c in kids]
            if all(a is b for a, b in zip(new_kids, kids)):
                return node
            return node.with_children(new_kids)

        new_out = {stage.stage_id: new_k}
        for pid, c in affected:
            from ballista_tpu_torch.ops.cpu.range_repartition import retarget_routers

            c.spec.plan = retarget_routers(
                patch(c.spec.plan, pid, new_out[pid]), new_out[pid])
            new_parts = c.spec.plan.input.output_partition_count()
            c.spec.partitions = new_parts
            if c.spec.plan.output_partitions <= 0:
                # passthrough writers materialize one output per task: the
                # advertised output count must follow the new task count or
                # downstream readers size against the stale K
                c.spec.output_partitions = new_parts
                new_out[c.stage_id] = new_parts
            c.pending = list(range(new_parts))
            c.effective_partitions = new_parts
        for pid, cid in bcast_readers:
            c = graph.stages[cid]
            c.spec.plan = patch(c.spec.plan, pid, new_out[pid], bcast=True)
        log.info(
            "AQE replan: stage %d inputs totalled %d bytes — hash fan-out "
            "altered %d → %d buckets (consumers repartitioned)",
            stage.stage_id, total_bytes, k, new_k,
        )


class HbmPrePlanRule:
    """Out-of-core pre-planning at resolution: once a stage's producers
    have finished, its observed input volume is ground truth — stamp it on
    the stage plan so the executor's HBM admission (ops/tpu/hbm.plan_stage)
    floors its build-size estimate with reality instead of encode-time
    guesses. This is what lets a RETRIED stage whose first attempt brushed
    the budget pre-plan a grace split up front rather than rediscover the
    overflow at dispatch. The stamp is a plain plan attribute, deliberately
    outside the proto (the ISSUE 12 serde note: grace sub-plans are
    executor-local and only stage stats ride heartbeats) — a multi-process
    cluster that drops it on the wire simply falls back to estimate-only
    admission, which is always safe.

    Runs AFTER AlterFanoutRule: fan-out alteration rebuilds the writer
    node, which would shed an earlier stamp."""

    def on_resolve(self, graph, stage, inputs) -> None:
        try:
            total = sum(
                l.stats.num_bytes for inp in inputs for l in inp.output_locations()
            )
        except Exception:  # noqa: BLE001 — a hint, never a scheduling failure
            return
        if total > 0:
            stage.spec.plan.hbm_observed_input_bytes = int(total)


class AdaptiveReplanner:
    """The pipeline driver. Owned by ExecutionGraph; every entry point runs
    under the graph lock."""

    def __init__(self):
        self.finalize_rules = [EmptyPropagationRule(), RuntimeJoinSelectionRule()]
        self.resolve_rules = [AlterFanoutRule(), HbmPrePlanRule()]

    def replan_after_finalize(self, graph, finished, events: list[str]) -> None:
        from ballista_tpu_torch.scheduler.state.execution_graph import JobState

        if not bool(graph.config.get(PLANNER_ADAPTIVE_ENABLED)):
            return
        changed = True
        while changed and graph.status is JobState.RUNNING:
            changed = False
            for rule in self.finalize_rules:
                changed = rule.on_finalize(graph, finished, events) or changed
        graph._rebuild_output_links()
        graph._cancel_obsolete_stages(events)

    def replan_at_resolution(self, graph, stage, inputs) -> None:
        if not bool(graph.config.get(PLANNER_ADAPTIVE_ENABLED)):
            return
        for rule in self.resolve_rules:
            rule.on_resolve(graph, stage, inputs)
