"""Per-job execution graph: the stage DAG state machine.

Rebuild of ExecutionGraph / ExecutionStage
(scheduler/src/state/execution_graph.rs:103, execution_stage.rs):

stage lifecycle  UNRESOLVED → RESOLVED → RUNNING → SUCCESSFUL | FAILED
- a stage resolves when every input stage is successful: its
  UnresolvedShuffleExec leaves are swapped for ShuffleReaderExec carrying
  the input stages' partition locations (remove_unresolved_shuffles)
- tasks are handed out per partition SLICE (PendingPartitions::next_slice,
  max_partitions_per_task)
- failure handling: bounded per-stage retries with attempt counters and
  failure dedup (execution_stage.rs:142); executor loss rolls running
  stages back and reruns successful stages whose shuffle outputs were on
  the lost executor (reset_stages_on_lost_executor :180,
  rerun_successful_stage :216 — ResultLost recompute)
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ballista_tpu_torch.config import MAX_PARTITIONS_PER_TASK, BallistaConfig
from ballista_tpu_torch.scheduler.planner import QueryStage, remove_unresolved_shuffles
from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec
from ballista_tpu_torch.shuffle.types import PartitionLocation

log = logging.getLogger(__name__)

MAX_STAGE_ATTEMPTS = 4
MAX_TASK_FAILURES = 4


class StageState(Enum):
    UNRESOLVED = "unresolved"
    RESOLVED = "resolved"
    RUNNING = "running"
    SUCCESSFUL = "successful"
    FAILED = "failed"


class JobState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUCCESSFUL = "successful"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class TaskDescription:
    job_id: str
    stage_id: int
    stage_attempt: int
    task_id: int
    partitions: list[int]
    plan: object  # ExecutionPlan (stage plan with resolved readers)
    session_id: str
    # 0 = original attempt; >0 = speculative duplicate of another task
    # covering the same partition slice
    task_attempt: int = 0
    # hard wall-clock budget (seconds, 0 = none); the executor aborts at
    # the deadline and reports a retryable timeout
    deadline_seconds: float = 0.0
    # serving tier: dispatched straight from the submit path (single-stage
    # plan, no execution graph); executors count these for heartbeat gauges
    fast_lane: bool = False


@dataclass
class RunningTask:
    task_id: int
    partitions: list[int]
    executor_id: str
    launched_at: float = field(default_factory=time.time)
    task_attempt: int = 0
    deadline_seconds: float = 0.0
    # the OTHER in-flight attempt of the same slice (original ↔ speculative);
    # first success wins and queues the rival for CancelTasks
    rival_task_id: int | None = None


class ExecutionStage:
    def __init__(self, stage: QueryStage):
        self.spec = stage
        self.stage_id = stage.stage_id
        self.state = StageState.UNRESOLVED if stage.input_stage_ids else StageState.RESOLVED
        self.attempt = 0
        self.resolved_plan = stage.plan if not stage.input_stage_ids else None
        self.pending: list[int] = list(range(stage.partitions))
        # may shrink via AQE coalescing or GROW via skew splitting
        self.effective_partitions = stage.partitions
        # SkewSplitReport when AQE split hot reduce partitions at this
        # stage's resolution; plan_check verifies the slice readers against
        # it (cover / no-overlap / order)
        self.skew_report = None
        self.running: dict[int, RunningTask] = {}
        # map_partition → locations published by the finished task
        self.completed: dict[int, list[PartitionLocation]] = {}
        self.failure_reasons: set[str] = set()
        self.task_failures = 0
        self.skipped = False  # completed by AQE pruning, never scheduled
        # wall-clock durations of this attempt's completed tasks — the
        # sample the speculation trigger and adaptive deadlines derive
        # their median from
        self.task_durations: list[float] = []
        # partition → failed/expired attempts so far: a relaunched slice
        # carries task_attempt = prior attempts, letting the executor side
        # distinguish a retry from a first run (chaos straggler mode only
        # delays attempt 0 — a retry must be able to escape the injected
        # fault, same as a speculative duplicate)
        self.retry_counts: dict[int, int] = {}

    @property
    def is_runnable(self) -> bool:
        return self.state in (StageState.RESOLVED, StageState.RUNNING) and bool(self.pending)

    def all_done(self) -> bool:
        return not self.pending and not self.running and len(self.completed) == self.effective_partitions

    def reset_for_retry(self) -> None:
        self.attempt += 1
        self.pending = list(range(self.spec.partitions))
        self.effective_partitions = self.spec.partitions
        self.skew_report = None
        self.running.clear()
        self.completed.clear()
        self.task_durations = []
        self.retry_counts = {}
        self.state = StageState.UNRESOLVED if self.spec.input_stage_ids else StageState.RESOLVED
        if not self.spec.input_stage_ids:
            self.resolved_plan = self.spec.plan

    def output_locations(self) -> list[PartitionLocation]:
        out: list[PartitionLocation] = []
        for locs in self.completed.values():
            out.extend(locs)
        return out


class ExecutionGraph:
    def __init__(self, job_id: str, job_name: str, session_id: str, stages: list[QueryStage],
                 config: BallistaConfig | None = None):
        self.job_id = job_id
        self.job_name = job_name
        self.session_id = session_id
        self.config = config or BallistaConfig()
        self.stages: dict[int, ExecutionStage] = {s.stage_id: ExecutionStage(s) for s in stages}
        self.final_stage_id = max(self.stages) if self.stages else 0
        self.status = JobState.RUNNING
        self.error: str = ""
        self.next_task_id = 0
        self.queued_at = time.time()
        self.ended_at: float | None = None
        self.output_links: dict[int, list[int]] = {sid: [] for sid in self.stages}
        for s in stages:
            for inp in s.input_stage_ids:
                self.output_links[inp].append(s.stage_id)
        self._lock = threading.RLock()
        # the adaptive replanning pipeline (reference: AdaptivePlanner,
        # state/aqe/planner.rs) — invoked after finalizations and at
        # resolution, always under self._lock
        from ballista_tpu_torch.scheduler.aqe.replanner import AdaptiveReplanner

        self.replanner = AdaptiveReplanner()
        self.stage_metrics: dict[int, list] = {}
        # (executor_id, task_id, stage_id) of tasks obsoleted by incremental
        # replanning or job cancellation, awaiting a CancelTasks rpc
        # (drained by the scheduler server)
        self.cancelled_tasks: list[tuple[str, int, int]] = []

    def drain_cancelled_tasks(self) -> list[tuple[str, int, int]]:
        with self._lock:
            out = self.cancelled_tasks
            self.cancelled_tasks = []
            return out

    # ------------------------------------------------------------------

    def available_task_count(self) -> int:
        with self._lock:
            if self.status is not JobState.RUNNING:
                return 0
            return sum(len(s.pending) for s in self.stages.values() if s.is_runnable)

    def pop_next_task(self, executor_id: str) -> Optional[TaskDescription]:
        """Hand out one task (a slice of a runnable stage's partitions)."""
        with self._lock:
            if self.status is not JobState.RUNNING:
                return None
            slice_size = max(1, int(self.config.get(MAX_PARTITIONS_PER_TASK)))
            for stage in sorted(self.stages.values(), key=lambda s: s.stage_id):
                if not stage.is_runnable:
                    continue
                # a mesh stage's exchange runs ONCE and serves every reduce
                # bucket from one device dispatch — it must ship as a single
                # mesh-wide task, never be sliced across executors
                n = len(stage.pending) if stage.spec.mesh else slice_size
                parts = stage.pending[:n]
                stage.pending = stage.pending[n:]
                self.next_task_id += 1
                deadline = self._deadline_seconds(stage)
                attempt = max((stage.retry_counts.get(p, 0) for p in parts), default=0)
                task = TaskDescription(
                    job_id=self.job_id,
                    stage_id=stage.stage_id,
                    stage_attempt=stage.attempt,
                    task_id=self.next_task_id,
                    partitions=parts,
                    plan=stage.resolved_plan,
                    session_id=self.session_id,
                    task_attempt=attempt,
                    deadline_seconds=deadline,
                )
                stage.running[task.task_id] = RunningTask(
                    task.task_id, parts, executor_id, task_attempt=attempt,
                    deadline_seconds=deadline)
                stage.state = StageState.RUNNING
                return task
            return None

    @staticmethod
    def _median_duration(stage: ExecutionStage) -> float:
        durs = sorted(stage.task_durations)
        return durs[len(durs) // 2] if durs else 0.0

    def _deadline_seconds(self, stage: ExecutionStage) -> float:
        """Effective per-task deadline: the configured floor, raised by the
        adaptive multiplier × observed median once enough samples exist."""
        from ballista_tpu_torch.config import TASK_DEADLINE_MULTIPLIER, TASK_DEADLINE_S

        floor = float(self.config.get(TASK_DEADLINE_S))
        mult = float(self.config.get(TASK_DEADLINE_MULTIPLIER))
        if mult > 0 and len(stage.task_durations) >= 3:
            adaptive = mult * self._median_duration(stage)
            return max(floor, adaptive) if adaptive > 0 else floor
        return floor

    def return_task(self, task: TaskDescription) -> None:
        """Un-pop a task (no executor could take it): partitions go back to
        pending, the running entry is dropped."""
        with self._lock:
            stage = self.stages.get(task.stage_id)
            if stage is None:
                return
            stage.running.pop(task.task_id, None)
            stage.pending = list(task.partitions) + stage.pending
            if not stage.running and stage.state is StageState.RUNNING:
                stage.state = StageState.RESOLVED

    def reassign_running(self, task_id: int, stage_id: int, executor_id: str) -> None:
        """Late-bind a popped task to the executor the distribution policy
        chose (consistent-hash binds after the pop)."""
        with self._lock:
            stage = self.stages.get(stage_id)
            if stage is not None and task_id in stage.running:
                stage.running[task_id].executor_id = executor_id

    # ------------------------------------------------------------------

    def update_task_status(self, task_id: int, stage_id: int, stage_attempt: int,
                           state: str, partitions: list[int],
                           locations: list[PartitionLocation],
                           error: str = "", retryable: bool = False,
                           metrics: list | None = None,
                           fetch_failed_executor_id: str = "",
                           fetch_failed_stage_id: int = 0,
                           timed_out: bool = False,
                           fetch_failed_cause: str = "") -> list[str]:
        """Ingest one task status; returns job-level events
        ('stage_completed', 'job_finished', 'job_failed')."""
        events: list[str] = []
        with self._lock:
            stage = self.stages.get(stage_id)
            if stage is None or self.status is not JobState.RUNNING:
                return events
            if stage_attempt != stage.attempt:
                return events  # stale attempt
            if stage.state in (StageState.SUCCESSFUL, StageState.FAILED):
                # finalized (normally, or skipped/cancelled by incremental
                # replanning): a doomed task racing the CancelTasks rpc must
                # not overwrite the finalized outputs or re-fire completion
                return events
            running = stage.running.pop(task_id, None)
            if state == "success":
                # FIRST ATTEMPT WINS: a duplicate (speculative) attempt
                # finishing second must not replace the winner's committed
                # locations — downstream readers may already hold them
                fresh = [p for p in partitions if p not in stage.completed]
                for p in fresh:
                    stage.completed[p] = [l for l in locations if l.map_partition == p]
                if running is not None:
                    stage.task_durations.append(max(0.0, time.time() - running.launched_at))
                    self._cancel_rival(stage, running)
                if metrics and fresh:
                    self.stage_metrics.setdefault(stage_id, []).extend(metrics)
                if stage.all_done():
                    stage.state = StageState.SUCCESSFUL
                    events.append("stage_completed")
                    self._on_stage_success(stage, events)
            elif state in ("failed", "cancelled"):
                if running is None and not fetch_failed_executor_id:
                    # unknown/already-settled attempt (cancelled speculation
                    # loser, deadline-swept task reporting late): its slice
                    # is covered elsewhere — don't burn retry budget on it
                    return events
                if running is not None:
                    self._unlink_rival(stage, running)
                    self._repend_uncovered(stage, running.partitions)
                if error:
                    stage.failure_reasons.add(error.splitlines()[0][:200])
                if fetch_failed_executor_id and fetch_failed_stage_id in self.stages:
                    # ResultLost: the UPSTREAM stage's shuffle output is gone —
                    # drop that executor's outputs and recompute the upstream
                    # stage (+ roll back its consumers) instead of burning
                    # this task's retry budget (execution_graph.rs:216)
                    up = self.stages[fetch_failed_stage_id]
                    up.completed = {
                        p: locs for p, locs in up.completed.items()
                        if not any(l.executor_id == fetch_failed_executor_id for l in locs)
                    }
                    self._rerun_stage_tree(fetch_failed_stage_id, cause=fetch_failed_cause)
                    if self.status is JobState.FAILED:
                        events.append("job_failed")
                    return events
                stage.task_failures += 1
                if state == "cancelled":
                    pass
                elif not retryable or stage.task_failures > MAX_TASK_FAILURES:
                    self._fail_job(f"stage {stage_id} failed: {error}")
                    events.append("job_failed")
            return events

    def _cancel_rival(self, stage: ExecutionStage, winner: RunningTask) -> None:
        """The other attempt of the winner's slice loses: drop it from
        running and queue a CancelTasks push."""
        if winner.rival_task_id is None:
            return
        rival = stage.running.pop(winner.rival_task_id, None)
        if rival is not None:
            log.info("task %d won over attempt %d of stage %d; cancelling the loser on %s",
                     winner.task_id, rival.task_id, stage.stage_id, rival.executor_id)
            self.cancelled_tasks.append((rival.executor_id, rival.task_id, stage.stage_id))

    @staticmethod
    def _unlink_rival(stage: ExecutionStage, task: RunningTask) -> None:
        """A failed/cancelled attempt leaves its rival as the sole owner of
        the slice (free to fail, finish, or be speculated again)."""
        if task.rival_task_id is not None:
            rival = stage.running.get(task.rival_task_id)
            if rival is not None:
                rival.rival_task_id = None

    @staticmethod
    def _repend_uncovered(stage: ExecutionStage, partitions: list[int]) -> None:
        """Re-queue only the partitions no completed output or other running
        attempt covers (a speculation rival may still be computing them)."""
        covered = set(stage.completed)
        for rt in stage.running.values():
            covered.update(rt.partitions)
        covered.update(stage.pending)
        fresh = [p for p in partitions if p not in covered]
        for p in fresh:
            stage.retry_counts[p] = stage.retry_counts.get(p, 0) + 1
        stage.pending.extend(fresh)

    # -- straggler defense (speculation + deadline sweep) ------------------

    def speculation_candidates(self, now: float) -> list[tuple[int, int, str]]:
        """Running tasks eligible for a speculative duplicate:
        [(stage_id, task_id, executor_id)]. A stage qualifies once ≥ the
        configured quantile of its partitions completed and it has no
        pending work; a task qualifies once it ran past
        max(min_runtime, multiplier × median completed duration) and has
        no duplicate in flight yet."""
        from ballista_tpu_torch.config import (
            SPECULATION_ENABLED,
            SPECULATION_MIN_RUNTIME_S,
            SPECULATION_MULTIPLIER,
            SPECULATION_QUANTILE,
        )

        with self._lock:
            if self.status is not JobState.RUNNING:
                return []
            if not bool(self.config.get(SPECULATION_ENABLED)):
                return []
            quantile = float(self.config.get(SPECULATION_QUANTILE))
            mult = float(self.config.get(SPECULATION_MULTIPLIER))
            min_runtime = float(self.config.get(SPECULATION_MIN_RUNTIME_S))
            out: list[tuple[int, int, str]] = []
            for stage in self.stages.values():
                if stage.state is not StageState.RUNNING or not stage.running:
                    continue
                if stage.pending:
                    continue  # schedule fresh work before duplicating old
                done_frac = len(stage.completed) / max(1, stage.effective_partitions)
                if done_frac < quantile:
                    continue
                median = self._median_duration(stage)
                if median <= 0.0:
                    continue
                threshold = max(min_runtime, mult * median)
                for t in stage.running.values():
                    if t.rival_task_id is not None:
                        continue
                    if now - t.launched_at >= threshold:
                        out.append((stage.stage_id, t.task_id, t.executor_id))
            return out

    def register_speculative(self, stage_id: int, task_id: int,
                             executor_id: str) -> Optional[TaskDescription]:
        """Create the duplicate attempt of a running task on `executor_id`.
        Returns None if the original settled (or already has a rival) in
        the window since speculation_candidates picked it."""
        with self._lock:
            stage = self.stages.get(stage_id)
            if stage is None or self.status is not JobState.RUNNING:
                return None
            if stage.state is not StageState.RUNNING:
                return None
            orig = stage.running.get(task_id)
            if orig is None or orig.rival_task_id is not None:
                return None
            self.next_task_id += 1
            deadline = self._deadline_seconds(stage)
            task = TaskDescription(
                job_id=self.job_id,
                stage_id=stage_id,
                stage_attempt=stage.attempt,
                task_id=self.next_task_id,
                partitions=list(orig.partitions),
                plan=stage.resolved_plan,
                session_id=self.session_id,
                task_attempt=orig.task_attempt + 1,
                deadline_seconds=deadline,
            )
            dup = RunningTask(task.task_id, list(orig.partitions), executor_id,
                              task_attempt=orig.task_attempt + 1,
                              deadline_seconds=deadline,
                              rival_task_id=orig.task_id)
            orig.rival_task_id = task.task_id
            stage.running[task.task_id] = dup
            return task

    def expire_overdue_tasks(self, now: float, grace_s: float = 2.0) -> tuple[list[tuple[str, int, int]], bool]:
        """Scheduler-side deadline backstop: tasks past deadline + grace
        (executor unresponsive or ignoring its own enforcement) are dropped
        from running, queued for CancelTasks, and their uncovered partitions
        re-queued. Returns ([(executor_id, task_id, stage_id)], job_failed)."""
        expired: list[tuple[str, int, int]] = []
        job_failed = False
        with self._lock:
            if self.status is not JobState.RUNNING:
                return expired, job_failed
            for stage in self.stages.values():
                if stage.state is not StageState.RUNNING:
                    continue
                overdue = [
                    t for t in stage.running.values()
                    if t.deadline_seconds > 0
                    and now - t.launched_at > t.deadline_seconds + max(grace_s, 0.5 * t.deadline_seconds)
                ]
                for t in overdue:
                    stage.running.pop(t.task_id, None)
                    self._unlink_rival(stage, t)
                    self._repend_uncovered(stage, t.partitions)
                    stage.failure_reasons.add(
                        f"task {t.task_id} missed its {t.deadline_seconds:.1f}s deadline (swept)")
                    stage.task_failures += 1
                    self.cancelled_tasks.append((t.executor_id, t.task_id, stage.stage_id))
                    expired.append((t.executor_id, t.task_id, stage.stage_id))
                    if stage.task_failures > MAX_TASK_FAILURES:
                        self._fail_job(
                            f"stage {stage.stage_id} exceeded {MAX_TASK_FAILURES} task "
                            f"failures (deadline sweep)")
                        job_failed = True
                        return expired, job_failed
        return expired, job_failed

    def _on_stage_success(self, stage: ExecutionStage, events: list[str]) -> None:
        if stage.stage_id == self.final_stage_id:
            self.status = JobState.SUCCESSFUL
            self.ended_at = time.time()
            events.append("job_finished")
            return
        # the adaptive replanning pass over the remaining plan (empty
        # propagation → runtime join selection → obsolete-stage
        # cancellation); no-op unless ballista.planner.adaptive.enabled
        self.replanner.replan_after_finalize(self, stage, events)
        self._maybe_verify(f"replan after stage {stage.stage_id} finalized")
        if self.status is not JobState.RUNNING:
            return
        for out_id in self.output_links.get(stage.stage_id, []):
            consumer = self.stages.get(out_id)
            if consumer is None:
                continue
            self._try_resolve(consumer)

    def complete_stage_skipped(self, stage: ExecutionStage, events: list[str]) -> None:
        """Finalize a stage the replanner proved empty: it completes with
        zero-row outputs without ever scheduling a task."""
        stage.pending = []
        stage.completed = {p: [] for p in range(stage.effective_partitions)}
        stage.state = StageState.SUCCESSFUL
        stage.skipped = True
        events.append("stage_completed")
        self._on_stage_success(stage, events)

    def _rebuild_output_links(self) -> None:
        self.output_links = {sid: [] for sid in self.stages}
        for s in self.stages.values():
            for inp in s.spec.input_stage_ids:
                if inp in self.output_links:
                    self.output_links[inp].append(s.stage_id)

    def _cancel_obsolete_stages(self, events: list[str]) -> None:
        """A stage no consumer references (after join collapses rewired the
        graph) is dead weight: drop its pending work and queue its running
        tasks for a CancelTasks rpc."""
        referenced: set[int] = {self.final_stage_id}
        for s in self.stages.values():
            if s.state in (StageState.UNRESOLVED, StageState.RESOLVED, StageState.RUNNING):
                referenced.update(s.spec.input_stage_ids)
        for s in self.stages.values():
            if s.stage_id in referenced or s.state is StageState.SUCCESSFUL:
                continue
            if not s.pending and not s.running:
                continue
            log.info("incremental AQE: stage %d is no longer consumed — cancelled", s.stage_id)
            s.pending = []
            if s.running:
                self.cancelled_tasks.extend(
                    (t.executor_id, t.task_id, s.stage_id) for t in s.running.values()
                )
                s.running.clear()
            s.state = StageState.SUCCESSFUL
            s.skipped = True
            s.completed = {p: [] for p in range(s.effective_partitions)}
            events.append("stage_cancelled")

    def _try_resolve(self, stage: ExecutionStage) -> None:
        if stage.state is not StageState.UNRESOLVED:
            return
        inputs = [self.stages[i] for i in stage.spec.input_stage_ids]
        if not all(i.state is StageState.SUCCESSFUL for i in inputs):
            return
        # stage-alteration replanning (fan-out shrink) before readers build
        self.replanner.replan_at_resolution(self, stage, inputs)
        resolved: dict[int, ShuffleReaderExec] = {}
        for inp in inputs:
            resolved[inp.stage_id] = self._build_reader(inp)
        plan = remove_unresolved_shuffles(stage.spec.plan, resolved)

        # adaptive replanning with the inputs' ACTUAL statistics
        from ballista_tpu_torch.scheduler.aqe.rules import InputStageStats, apply_aqe

        from ballista_tpu_torch.utils.tdigest import TDigest

        stats: dict[int, InputStageStats] = {}
        for inp in inputs:
            locs = inp.output_locations()
            k = max(1, inp.spec.output_partitions)
            buckets = [0] * k
            for l in locs:
                if l.output_partition < k:
                    buckets[l.output_partition] += l.stats.num_bytes
            digest = TDigest()
            if buckets:
                import numpy as np

                digest.add_array(np.asarray(buckets, dtype=np.float64))
            stats[inp.stage_id] = InputStageStats(
                stage_id=inp.stage_id,
                total_rows=sum(l.stats.num_rows for l in locs),
                total_bytes=sum(l.stats.num_bytes for l in locs),
                bucket_bytes=buckets,
                broadcast=inp.spec.broadcast,
                bytes_digest=digest,
            )
        unconsumed = not self.output_links.get(stage.spec.stage_id)
        plan, new_parts, report = apply_aqe(
            plan, stats, self.config, stage.spec.partitions,
            stage_unconsumed=unconsumed,
        )
        stage.resolved_plan = plan
        stage.skew_report = report
        if new_parts is not None and new_parts != stage.spec.partitions:
            stage.pending = list(range(new_parts))
            stage.effective_partitions = new_parts
        stage.state = StageState.RESOLVED
        self._maybe_verify(f"stage {stage.stage_id} resolution")

    def _build_reader(self, inp: ExecutionStage) -> ShuffleReaderExec:
        # deterministic location order: completed.values() is task-ARRIVAL
        # order, which varies run to run (and between two evaluations of
        # the same subtree in one query, e.g. a CTE referenced twice).
        # Float aggregation is order-sensitive, so downstream merges must
        # see a stable order or q15-style self-equality comparisons break.
        locs = sorted(
            inp.output_locations(),
            key=lambda l: (l.output_partition, l.map_partition, l.path),
        )
        k = inp.spec.output_partitions
        by_output: list[list[PartitionLocation]] = [[] for _ in range(max(1, k))]
        for l in locs:
            by_output[l.output_partition].append(l)
        schema = inp.spec.plan.input.df_schema
        reader = ShuffleReaderExec(schema, by_output, broadcast=inp.spec.broadcast)
        reader.source_stage_id = inp.stage_id  # AQE stats lookup tag
        return reader

    def _maybe_verify(self, context: str) -> None:
        """Re-check DAG invariants after a rewrite, failing the job rather
        than executing a corrupt graph. Gated on ballista.debug.plan.verify."""
        from ballista_tpu_torch.config import DEBUG_PLAN_VERIFY

        if not bool(self.config.get(DEBUG_PLAN_VERIFY)):
            return
        from ballista_tpu_torch.analysis.plan_check import verify_graph

        violations = verify_graph(self)
        if violations:
            detail = "; ".join(x.render() for x in violations)
            log.error("plan verification failed after %s: %s", context, detail)
            self._fail_job(f"plan verification failed after {context}: {detail}")

    def _fail_job(self, error: str) -> None:
        self.status = JobState.FAILED
        self.error = error
        self.ended_at = time.time()

    def cancel(self) -> list[RunningTask]:
        with self._lock:
            self.status = JobState.CANCELLED
            self.ended_at = time.time()
            out = []
            for s in self.stages.values():
                self.cancelled_tasks.extend(
                    (t.executor_id, t.task_id, s.stage_id) for t in s.running.values()
                )
                out.extend(s.running.values())
                s.running.clear()
                s.pending.clear()
            return out

    # ------------------------------------------------------------------

    def reset_stages_on_lost_executor(self, executor_id: str) -> int:
        """Roll back running tasks on the executor and rerun successful
        stages whose shuffle outputs lived there (ResultLost recompute)."""
        with self._lock:
            if self.status is not JobState.RUNNING:
                return 0
            affected = 0
            lost_output_stages: set[int] = set()
            for stage in self.stages.values():
                # running tasks on the lost executor → back to pending
                dead = [t for t in stage.running.values() if t.executor_id == executor_id]
                for t in dead:
                    stage.running.pop(t.task_id, None)
                    self._unlink_rival(stage, t)
                    self._repend_uncovered(stage, t.partitions)
                    affected += 1
                # successful outputs on the lost executor → stage rerun
                if stage.state is StageState.SUCCESSFUL and any(
                    l.executor_id == executor_id for l in stage.output_locations()
                ):
                    lost_output_stages.add(stage.stage_id)
            for sid in lost_output_stages:
                self._rerun_stage_tree(sid)
                affected += 1
            return affected

    def _rerun_stage_tree(self, stage_id: int, cause: str = "") -> None:
        """Rerun a successful stage; downstream stages that already consumed
        it roll back to unresolved. MAX_STAGE_ATTEMPTS bounds the recompute
        loop; when the budget dies to corruption, the job failure says so —
        persistent checksum mismatches mean bad hardware (or a bad writer),
        and an unbounded rerun would never converge."""
        stage = self.stages[stage_id]
        if stage.attempt + 1 > MAX_STAGE_ATTEMPTS:
            if cause == "corruption":
                self._fail_job(
                    f"stage {stage_id} exceeded {MAX_STAGE_ATTEMPTS} attempts: "
                    "repeated shuffle data corruption (checksum mismatches "
                    "survived refetch and recompute — suspect failing disks "
                    "on the serving executors; see corruption strikes in "
                    "/api/executors)")
            else:
                self._fail_job(f"stage {stage_id} exceeded {MAX_STAGE_ATTEMPTS} attempts")
            return
        stage.reset_for_retry()
        # try re-resolving immediately (inputs may still be intact)
        self._try_resolve(stage)
        for out_id in self.output_links.get(stage_id, []):
            out = self.stages[out_id]
            if out.state in (StageState.RESOLVED, StageState.RUNNING, StageState.SUCCESSFUL):
                out.reset_for_retry()

    # ------------------------------------------------------------------

    def job_status(self) -> dict:
        with self._lock:
            final = self.stages.get(self.final_stage_id)
            done = sum(1 for s in self.stages.values() if s.state is StageState.SUCCESSFUL)
            out = {
                "job_id": self.job_id,
                "job_name": self.job_name,
                "state": self.status.value,
                "error": self.error,
                "completed_stages": done,
                "total_stages": len(self.stages),
                "queued_at": self.queued_at,
                "ended_at": self.ended_at,
            }
            if final is not None:
                out["schema"] = final.spec.plan.input.df_schema
            if self.status is JobState.SUCCESSFUL and final is not None:
                out["partitions"] = final.output_locations()
            if getattr(self, "inline_result", None) is not None:
                # an incremental render attached the served table — clients
                # take it over the raw stage partitions (accumulator state)
                out["inline_result"] = self.inline_result
                out["partitions"] = []
            return out

    def display(self) -> str:
        with self._lock:
            lines = [f"Job {self.job_id} [{self.status.value}]"]
            for sid in sorted(self.stages):
                s = self.stages[sid]
                lines.append(
                    f"  stage {sid}: {s.state.value} attempt={s.attempt} "
                    f"pending={len(s.pending)} running={len(s.running)} done={len(s.completed)}"
                )
            return "\n".join(lines)

    # -- externalization (reference: ExecutionGraph proto, ballista.proto:185;
    #    enables JobState persistence / scheduler fail-over) -----------------

    def to_proto(self):
        from ballista_tpu_torch.proto import pb
        from ballista_tpu_torch.serde import encode_location, encode_plan

        with self._lock:
            out = pb.ExecutionGraphProto(
                job_id=self.job_id, job_name=self.job_name,
                session_id=self.session_id, status=self.status.value,
            )
            for k, v in self.config.to_key_value_pairs():
                out.settings.add(key=k, value=v)
            for sid in sorted(self.stages):
                s = self.stages[sid]
                sp = out.stages.add()
                sp.stage_id = sid
                sp.state = s.state.value
                sp.partitions = s.spec.partitions
                sp.attempt = s.attempt
                sp.plan.CopyFrom(encode_plan(s.spec.plan))
                sp.output_links.extend(self.output_links.get(sid, []))
                for l in s.output_locations():
                    sp.completed.append(encode_location(l))
            return out

    @classmethod
    def from_proto(cls, proto, config: BallistaConfig | None = None) -> "ExecutionGraph":
        """Rebuild a graph from its externalized form. Successful stages keep
        their completed locations; anything mid-flight restarts (the durable
        unit is the materialized shuffle output, SURVEY.md §5)."""
        from ballista_tpu_torch.scheduler.planner import QueryStage
        from ballista_tpu_torch.serde import decode_location, decode_plan

        if config is None and proto.settings:
            # recovery must resume under the job's session settings, not
            # defaults (task slicing / AQE thresholds would silently change)
            config = BallistaConfig.from_key_value_pairs(
                [(kv.key, kv.value) for kv in proto.settings]
            )
        from ballista_tpu_torch.ops.cuda.mesh_stage import contains_mesh_exchange
        from ballista_tpu_torch.scheduler.planner import _find_input_stages
        from ballista_tpu_torch.shuffle.reader import UnresolvedShuffleExec

        plans: dict[int, object] = {sp.stage_id: decode_plan(sp.plan) for sp in proto.stages}
        # the proto has no per-stage flags; the plans themselves are the
        # durable record. A stage is a broadcast producer iff some consumer
        # reads it through a broadcast leaf — without this a recovered
        # broadcast stage would be read partition-wise and lose rows.
        broadcast_ids: set[int] = set()
        for plan in plans.values():
            def walk(n):
                if isinstance(n, UnresolvedShuffleExec) and n.broadcast:
                    broadcast_ids.add(n.stage_id)
                for c in n.children():
                    walk(c)
            walk(plan)
        stages = []
        links: dict[int, list[int]] = {}
        for sp in proto.stages:
            plan = plans[sp.stage_id]
            stages.append(
                QueryStage(
                    stage_id=sp.stage_id, plan=plan,
                    partitions=sp.partitions,
                    output_partitions=plan.output_partitions or sp.partitions,
                    input_stage_ids=_find_input_stages(plan),
                    broadcast=sp.stage_id in broadcast_ids,
                    # a recovered mesh stage must keep its single-task shape
                    mesh=contains_mesh_exchange(plan),
                )
            )
            links[sp.stage_id] = list(sp.output_links)
        g = cls(proto.job_id, proto.job_name, proto.session_id, stages, config)
        g.status = JobState(proto.status) if proto.status else JobState.RUNNING
        for sp in proto.stages:
            if sp.state == "successful":
                st = g.stages[sp.stage_id]
                for lp in sp.completed:
                    loc = decode_location(lp)
                    st.completed.setdefault(loc.map_partition, []).append(loc)
                st.pending = []
                st.state = StageState.SUCCESSFUL
                st.attempt = sp.attempt
        # re-resolve downstream stages from recovered outputs
        for st in g.stages.values():
            g._try_resolve(st)
        return g
