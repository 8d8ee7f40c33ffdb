"""Mid-stage dynamic join selection.

Rebuild of the reference's deferred-join-decision node
(scheduler/src/state/aqe/execution_plan/dynamic_join.rs:53 +
optimizer_rule/join_selection.rs). The reference's operator is a pure
placeholder — an AQE optimizer rule must replace it at stage resolution or
execute() errors (dynamic_join.rs:104-115). This engine keeps the
resolution-time path (scheduler/aqe/rules.py resolves the node when input
stats are known) but the operator is ALSO executable: when a stage runs
with unknown input sizes, it observes its inputs at first-batch time —
BufferExec's dam semantics (ops/cpu/range_repartition.py:79) applied to
both join inputs — and only then instantiates the concrete HashJoinExec.

Decision matrix (mirrors dynamic_join.rs:214-330's to_actual_join):
 * build side = the smaller side whose TOTAL size the dam proved (a side
   that exhausted under the byte budget has exact bytes/rows; one that
   overflowed is only known to be "big");
 * collect_left (broadcast-style collected build) when the chosen build
   fits the broadcast byte threshold AND the row threshold AND the
   (possibly swapped) join type only emits probe-side rows — the same
   safety rule the static planner applies (physical_planner.py:548-550,
   reference collect_left_broadcast_safe);
 * otherwise a partitioned hash join, swapped onto the proven-smaller
   build side when one exists;
 * both sides overflowed ⇒ the planned partitioned join runs unchanged.

Observed batches are never re-read from the child: replay sources hand
them back to the concrete join, then continue the live iterators.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator, Optional

import pyarrow as pa

from ballista_tpu_torch.config import (
    BROADCAST_JOIN_ROWS_THRESHOLD,
    BROADCAST_JOIN_THRESHOLD,
)
from ballista_tpu_torch.plan.expressions import Column, Expr
from ballista_tpu_torch.plan.physical import (
    ExecutionPlan,
    HashJoinExec,
    ProjectionExec,
    TaskContext,
)
from ballista_tpu_torch.plan.schema import DFSchema

log = logging.getLogger(__name__)

# join types whose collected build may be shared by independently decoded
# probe tasks: they never emit rows on BEHALF of the build side
_COLLECT_SAFE = frozenset({"inner", "right", "right_semi", "right_anti"})

_SWAP = {
    "inner": "inner", "full": "full", "left": "right", "right": "left",
    "left_semi": "right_semi", "right_semi": "left_semi",
    "left_anti": "right_anti", "right_anti": "left_anti",
}


def select_strategy(l_bytes: int, l_rows: int, l_known: bool,
                    r_bytes: int, r_rows: int, r_known: bool,
                    join_type: str, probe_single_partition: bool,
                    byte_thr: int, rows_thr: int) -> tuple[str, bool, str]:
    """The decision matrix, pure (dynamic_join.rs:214-330's to_actual_join).

    `*_known` = the side's TOTAL size is proven (stage stats at resolution
    time, or the dam exhausted the side at first-batch time). Returns
    (decision_label, swap, mode). A byte threshold of 0 disables promotion
    entirely; the row threshold is a conjunct, mirroring the static planner.
    """
    if byte_thr <= 0 or (not l_known and not r_known):
        return "AsPlanned", False, "partitioned"
    if l_known and r_known:
        swap = r_bytes < l_bytes
    else:
        swap = r_known  # only one side proven: build from it
    b_bytes, b_rows = (r_bytes, r_rows) if swap else (l_bytes, l_rows)
    jt = _SWAP[join_type] if swap else join_type
    collect = (
        b_bytes <= byte_thr
        and b_rows <= rows_thr
        and (jt in _COLLECT_SAFE or probe_single_partition)
    )
    if collect:
        return ("BroadcastSwapped" if swap else "Broadcast"), swap, "collect_left"
    return ("PartitionedSwapped" if swap else "Partitioned"), swap, "partitioned"


class _Observation:
    """One side's dam result: buffered batches per partition plus any
    still-open iterator, with exact totals when the side exhausted."""

    def __init__(self):
        self.buffered: dict[int, list[pa.RecordBatch]] = {}
        self.open_iters: dict[int, Iterator[pa.RecordBatch]] = {}
        self.nbytes = 0
        self.rows = 0
        self.complete = False


def _observe(child: ExecutionPlan, ctx: TaskContext, budget: int) -> _Observation:
    """BufferExec's dam applied across ALL partitions of one input: buffer
    until the byte budget overflows or the side exhausts. An exhausted side
    has exact size; an overflowed one is proven bigger than the budget."""
    obs = _Observation()
    for p in range(child.output_partition_count()):
        it = iter(child.execute(p, ctx))
        obs.buffered[p] = []
        for b in it:
            obs.buffered[p].append(b)
            obs.nbytes += b.nbytes
            obs.rows += b.num_rows
            if obs.nbytes > budget:
                obs.open_iters[p] = it
                return obs
    obs.complete = True
    return obs


class _ReplaySource(ExecutionPlan):
    """Serves a child's partitions, replaying what the dam buffered before
    continuing the live iterator (partitions the dam never started execute
    fresh). Buffers are handed out once and released."""

    def __init__(self, child: ExecutionPlan, obs: _Observation):
        super().__init__(child.df_schema)
        self.child = child
        self.obs = obs
        self._lock = threading.Lock()

    def children(self):
        return [self.child]

    def with_children(self, c):
        return _ReplaySource(c[0], self.obs)

    def output_partition_count(self) -> int:
        return self.child.output_partition_count()

    def node_str(self) -> str:
        return "ReplaySource"

    def execute(self, partition: int, ctx: TaskContext):
        with self._lock:
            held = self.obs.buffered.pop(partition, None)
            live = self.obs.open_iters.pop(partition, None)
        if held is None:
            yield from self.child.execute(partition, ctx)
            return
        yield from held
        if live is not None:
            yield from live


class DynamicJoinSelectionExec(ExecutionPlan):
    """Deferred join decision (reference dynamic_join.rs:53). `mode` is the
    planner's fallback (always 'partitioned' at insertion); the concrete
    join is chosen at stage resolution (aqe/rules.py, stats known) or at
    first-batch time right here (stats unknown)."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 on: list[tuple[Expr, Expr]], join_type: str,
                 filter: Optional[Expr], df_schema: DFSchema,
                 mode: str = "partitioned", planned_mode: str = "partitioned"):
        super().__init__(df_schema)
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.filter = filter
        self.mode = mode
        # what the STATIC planner would have committed to without the
        # deferral — "collect_left" marks a hedged broadcast whose build
        # estimate sat inside the hedge band; runtime resolution against it
        # is what distinguishes a broadcast DEMOTION from a confirmation
        self.planned_mode = planned_mode
        self._lock = threading.Lock()
        self._resolved: ExecutionPlan | None = None
        self.decision: str = ""  # Broadcast | BroadcastSwapped | Partitioned | PartitionedSwapped | AsPlanned

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return DynamicJoinSelectionExec(
            c[0], c[1], self.on, self.join_type, self.filter, self.df_schema,
            self.mode, self.planned_mode)

    def output_partition_count(self) -> int:
        return self.right.output_partition_count()

    def node_str(self) -> str:
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        d = f" decision={self.decision}" if self.decision else ""
        h = " planned=collect_left" if self.planned_mode == "collect_left" else ""
        return f"DynamicJoinSelectionExec: type={self.join_type}, on=[{on}]{h}{d}"

    def _note_switch(self, mode: str) -> None:
        """Count a runtime reversal of the planned strategy (best-effort)."""
        from ballista_tpu_torch.ops.cuda import aqe_stats

        if self.planned_mode == "collect_left" and mode == "partitioned":
            aqe_stats.note_broadcast_demotion()
        elif self.planned_mode != "collect_left" and mode == "collect_left":
            aqe_stats.note_broadcast_promotion()

    # ------------------------------------------------------------- execute

    def execute(self, partition: int, ctx: TaskContext):
        with self._lock:
            if self._resolved is None:
                self._resolved = self._decide(ctx)
        return self._timed(self._resolved.execute(partition, ctx))

    def _decide(self, ctx: TaskContext) -> ExecutionPlan:
        byte_thr = int(ctx.config.get(BROADCAST_JOIN_THRESHOLD))
        rows_thr = int(ctx.config.get(BROADCAST_JOIN_ROWS_THRESHOLD))
        if byte_thr <= 0:
            # a 0 byte threshold disables dynamic promotion entirely — the
            # same contract as the reference's static planner and AQE
            # (dynamic_join.rs:266-270)
            self.decision = "AsPlanned"
            return self._as_planned(None, None)

        probe_single = self.right.output_partition_count() == 1
        l_obs = _observe(self.left, ctx, byte_thr)
        # short-circuit: when the planned build alone already proves an
        # as-is Broadcast, observing the probe could only trade it for a
        # marginally smaller swapped build at the cost of buffering (and,
        # in a partition-sliced task, re-fetching) up to another byte_thr
        # of probe data that the replay may never hand out
        if select_strategy(l_obs.nbytes, l_obs.rows, l_obs.complete,
                           0, 0, False, self.join_type, probe_single,
                           byte_thr, rows_thr)[0] == "Broadcast":
            r_obs = _Observation()  # untouched: replays nothing, child runs fresh
        else:
            r_obs = _observe(self.right, ctx, byte_thr)

        # the dam proved exact totals only for sides that exhausted;
        # build from the proven-smaller side (dynamic_join.rs:246-255:
        # measure the input the executor actually builds from)
        # probe partition count: the two sides are co-partitioned at
        # insertion, so the unswapped probe's count answers for both
        # orientations
        self.decision, swap, mode = select_strategy(
            l_obs.nbytes, l_obs.rows, l_obs.complete,
            r_obs.nbytes, r_obs.rows, r_obs.complete,
            self.join_type,
            probe_single,
            byte_thr, rows_thr,
        )
        self._note_switch(mode)
        if self.decision == "AsPlanned":
            out = self._as_planned(l_obs, r_obs)
        else:
            out = self._concrete(swap, mode, _ReplaySource(self.left, l_obs),
                                 _ReplaySource(self.right, r_obs))
        log.info(
            "dynamic join decision: %s (left: %d bytes/%d rows%s, right: %d bytes/%d "
            "rows%s, byte_thr=%d, rows_thr=%d)",
            self.decision, l_obs.nbytes, l_obs.rows, "" if l_obs.complete else "+",
            r_obs.nbytes, r_obs.rows, "" if r_obs.complete else "+", byte_thr, rows_thr,
        )
        return out

    def _as_planned(self, l_obs, r_obs) -> ExecutionPlan:
        left = _ReplaySource(self.left, l_obs) if l_obs is not None else self.left
        right = _ReplaySource(self.right, r_obs) if r_obs is not None else self.right
        return HashJoinExec(left, right, self.on, self.join_type, self.filter,
                            self.mode, self.df_schema)

    def resolve_with_stats(self, l_bytes: int, l_rows: int,
                           r_bytes: int, r_rows: int,
                           byte_thr: int, rows_thr: int) -> ExecutionPlan:
        """Resolution-time form (the reference's optimizer-rule replacement,
        optimizer_rule/join_selection.rs): both input sizes are exact stage
        stats, so the concrete join is built over the ORIGINAL children —
        no dam, no replay. Called by scheduler/aqe/rules.py."""
        self.decision, swap, mode = select_strategy(
            l_bytes, l_rows, True, r_bytes, r_rows, True, self.join_type,
            self.right.output_partition_count() == 1, byte_thr, rows_thr,
        )
        self._note_switch(mode)
        if self.decision == "AsPlanned":
            return self._as_planned(None, None)
        return self._concrete(swap, mode, self.left, self.right)

    def _concrete(self, swap: bool, mode: str, left: ExecutionPlan,
                  right: ExecutionPlan) -> ExecutionPlan:
        from ballista_tpu_torch.engine.physical_planner import _join_exec_schema

        if not swap:
            return HashJoinExec(left, right, self.on, self.join_type, self.filter,
                                mode, self.df_schema)
        jt = _SWAP[self.join_type]
        on = [(r, l) for (l, r) in self.on]
        schema = _join_exec_schema(right.df_schema, left.df_schema, jt)
        j = HashJoinExec(right, left, on, jt, self.filter, mode, schema)
        if jt in ("inner", "left", "right", "full"):
            # the merged output is the other orientation's permutation:
            # restore the declared column order (planner swap pattern,
            # physical_planner.py:563-565)
            order = [Column(f.name, f.qualifier) for f in self.df_schema]
            return ProjectionExec(j, order, self.df_schema)
        return j
