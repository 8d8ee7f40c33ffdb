"""Fast-lane job record: a single-stage job with no execution graph.

The short-query fast lane dispatches a single-stage plan straight from
the submit path to warm executors and collects task results on the
executor's reporting thread — the scheduler event loop never sees the
job. `FastJob` stands in for `ExecutionGraph` in the scheduler's jobs
dict, so everything that enumerates jobs (REST handlers, sweeps, offer
rotation, EXPLAIN ANALYZE) keeps working; the graph-shaped methods it
exposes are deliberate no-ops because a fast job has no stage state to
mutate. On failure or timeout the scheduler demotes the job to a real
ExecutionGraph built from the same stages (`FastJob.stages_for_fallback`).
"""

from __future__ import annotations

import threading
import time

from ballista_tpu_torch.scheduler.state.execution_graph import JobState, StageState

# fast-lane task ids start far above any graph-assigned id so a stale
# fast result arriving after a fallback can never collide with a task of
# the replacement graph
FAST_TASK_ID_BASE = 1_000_000


class _FastStageView:
    """StageRecord lookalike for the single live stage of a fast job, so
    the REST /stages, /graph and dot endpoints render fast-lane jobs the
    same way as queued ones. Fast tasks launch immediately, so nothing is
    ever `pending` — unfinished partitions show as `running`."""

    pending: frozenset = frozenset()

    def __init__(self, job: "FastJob", spec):
        self._job = job
        self.spec = spec
        self.attempt = 0

    @property
    def state(self) -> StageState:
        st = self._job.status
        if st is JobState.RUNNING:
            return StageState.RUNNING
        if st is JobState.SUCCESSFUL:
            return StageState.SUCCESSFUL
        return StageState.FAILED

    @property
    def running(self) -> frozenset:
        if self._job.status is JobState.RUNNING:
            return frozenset(self._job._pending)
        return frozenset()

    @property
    def completed(self) -> frozenset:
        return frozenset(set(range(self.spec.partitions)) - self._job._pending)


class FastJob:
    def __init__(self, job_id: str, job_name: str, session_id: str, config,
                 stages=None, rc_key=None, inline_result=None):
        self.job_id = job_id
        self.job_name = job_name
        self.session_id = session_id
        self.config = config
        self.queued_at = time.time()
        self.started_at = self.queued_at
        self.ended_at = 0.0
        self.error = ""
        # graph-shaped surface for REST /stages, /graph, dot rendering
        self.stages: dict = {}
        self.stage_metrics: dict[int, list] = {}
        self.output_links: dict[int, list[int]] = {}
        self.rc_key = rc_key  # result-cache slot to fill on success
        self.inline_result = inline_result  # pa.Table served without a fetch
        self._lock = threading.Lock()
        self._stages = list(stages or [])
        self._pending: set[int] = set()
        self._locations: list = []
        self._failed = False
        if inline_result is not None:
            # a result-cache hit is born terminal
            self.status = JobState.SUCCESSFUL
            self.ended_at = self.queued_at
        else:
            self.status = JobState.RUNNING
            stage = self._stages[0]
            self._pending = set(range(stage.partitions))
            self._df_schema = stage.plan.input.df_schema
            self.stages = {stage.stage_id: _FastStageView(self, stage)}

    # -- result ingestion (executor reporting threads) ---------------------

    def on_result(self, r) -> str | None:
        """Fold one TaskResult in; returns "finished" when the last
        partition landed, "failed" on the first failure, else None."""
        with self._lock:
            if self.status is not JobState.RUNNING:
                return None
            if r.metrics:
                self.stage_metrics.setdefault(self._stages[0].stage_id, []).extend(r.metrics)
            if r.state == "success":
                self._locations.extend(r.locations or [])
                self._pending -= set(r.partitions or [])
                if not self._pending:
                    self.status = JobState.SUCCESSFUL
                    self.ended_at = time.time()
                    return "finished"
                return None
            if r.state == "failed":
                self._failed = True
                self.error = r.error or "fast-lane task failed"
                return "failed"
            return None

    def demote(self) -> list:
        """Hand back the stages for a full-DAG fallback; the record itself
        is replaced in the jobs dict by the new ExecutionGraph."""
        with self._lock:
            return list(self._stages)

    def expired(self, now: float, timeout_s: float) -> bool:
        with self._lock:
            return (self.status is JobState.RUNNING
                    and now - self.started_at > timeout_s)

    # -- graph-shaped surface ----------------------------------------------

    def job_status(self) -> dict:
        with self._lock:
            out = {
                "job_id": self.job_id,
                "job_name": self.job_name,
                "state": self.status.value,
                "error": self.error,
                "completed_stages": 1 if self.status is JobState.SUCCESSFUL else 0,
                "total_stages": 1 if self._stages else 0,
                "queued_at": self.queued_at,
                "ended_at": self.ended_at,
                "fast_lane": True,
            }
            if self.inline_result is not None:
                out["inline_result"] = self.inline_result
                out["partitions"] = []
            elif self._stages:
                out["schema"] = self._df_schema
                if self.status is JobState.SUCCESSFUL:
                    out["partitions"] = sorted(
                        self._locations,
                        key=lambda l: (l.output_partition, l.map_partition))
            return out

    def cancel(self) -> None:
        with self._lock:
            if self.status is JobState.RUNNING:
                self.status = JobState.CANCELLED
                self.ended_at = time.time()

    # no stage state to offer, expire, speculate on, or roll back
    def available_task_count(self) -> int:
        return 0

    def pop_next_task(self, executor_id: str):
        return None

    def return_task(self, task) -> None:
        return

    def expire_overdue_tasks(self, now: float):
        return [], False

    def speculation_candidates(self, now: float):
        return []

    def drain_cancelled_tasks(self):
        return []

    def reset_stages_on_lost_executor(self, executor_id: str) -> int:
        return 0

    def update_task_status(self, *args, **kwargs):
        # stale duplicate result after the job went terminal: nothing to do
        return []
