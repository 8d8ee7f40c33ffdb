"""Job-level admission control and overload state machine.

The scheduler's `jobs` dict and event queue were unbounded: one burst of
submissions (or one runaway client loop) grew control-plane state without
limit and degraded every tenant. This module puts a bounded admission
gate in front of `submit_sql`/`submit_physical_plan`:

- a cluster-wide cap on in-flight (queued or running) jobs
  (`ballista.admission.max.pending.jobs`);
- a per-session in-flight quota
  (`ballista.admission.max.inflight.per.session`) so one tenant cannot
  consume the whole admission budget;
- an overload state machine `normal → shedding → draining` driven by
  three pressure signals: admission depth, scheduler event-loop lag, and
  the aggregate memory-pressure score executors piggyback on heartbeats.
  Shedding halves every session quota; draining rejects all new work
  until depth falls back under the drain threshold.

Rejections are typed (`ClusterOverloaded`) and carry a `retry_after_ms`
hint computed from the observed drain rate: if the cluster has been
finishing `r` jobs/second and the caller is `k` jobs over budget, the
hint is ~`k / r` seconds — enough for the backlog the caller would have
joined to clear. Clients (see `client/remote.py`) honor the hint with
jittered exponential backoff, which turns a thundering herd into a
paced trickle.

State here is intentionally scheduler-local (like the slot ledger in
`ExecutorManager`): admission is advisory flow control, not a durable
ledger, so a scheduler failover simply starts with a fresh gate.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ballista_tpu_torch.config import (
    ADMISSION_DRAIN_DEPTH,
    ADMISSION_ENABLED,
    ADMISSION_INTERACTIVE_MAX_PENDING,
    ADMISSION_MAX_INFLIGHT_PER_SESSION,
    ADMISSION_MAX_PENDING_JOBS,
    ADMISSION_MIN_RETRY_AFTER_MS,
    ADMISSION_SHED_DEPTH,
    ADMISSION_SHED_LOOP_LAG_S,
    ADMISSION_SHED_MEMORY_PRESSURE,
    BallistaConfig,
)
from ballista_tpu_torch.errors import ClusterOverloaded

NORMAL = "normal"
SHEDDING = "shedding"
DRAINING = "draining"

# admission lanes (serving tier): interactive = known-short repeat work
# (single-stage plan-cache hits, prepared executions); batch = everything
# else. Overload postures degrade the batch lane first.
LANE_BATCH = "batch"
LANE_INTERACTIVE = "interactive"

# drain-rate estimation window: recent finishes only, so the hint tracks
# the cluster's *current* throughput, not its lifetime average
_DRAIN_WINDOW_S = 30.0
_DRAIN_SAMPLES = 256


class AdmissionController:
    """Bounded admission gate + overload posture for one scheduler.

    Thread-safe: `admit` runs on gRPC/REST handler threads, `finish` and
    `update` on the scheduler event loop.
    """

    def __init__(self,
                 enabled: bool | None = None,
                 max_pending: int | None = None,
                 per_session_quota: int | None = None,
                 shed_depth: int | None = None,
                 drain_depth: int | None = None,
                 shed_loop_lag_s: float | None = None,
                 shed_memory_pressure: float | None = None,
                 min_retry_after_ms: int | None = None,
                 interactive_max_pending: int | None = None):
        defaults = BallistaConfig()
        self.enabled = bool(defaults.get(ADMISSION_ENABLED)) if enabled is None else enabled
        self.max_pending = int(defaults.get(ADMISSION_MAX_PENDING_JOBS)) if max_pending is None else max_pending
        self.per_session_quota = (int(defaults.get(ADMISSION_MAX_INFLIGHT_PER_SESSION))
                                  if per_session_quota is None else per_session_quota)
        self.shed_depth = int(defaults.get(ADMISSION_SHED_DEPTH)) if shed_depth is None else shed_depth
        self.drain_depth = int(defaults.get(ADMISSION_DRAIN_DEPTH)) if drain_depth is None else drain_depth
        self.shed_loop_lag_s = (float(defaults.get(ADMISSION_SHED_LOOP_LAG_S))
                                if shed_loop_lag_s is None else shed_loop_lag_s)
        self.shed_memory_pressure = (float(defaults.get(ADMISSION_SHED_MEMORY_PRESSURE))
                                     if shed_memory_pressure is None else shed_memory_pressure)
        self.min_retry_after_ms = (int(defaults.get(ADMISSION_MIN_RETRY_AFTER_MS))
                                   if min_retry_after_ms is None else min_retry_after_ms)
        self.interactive_max_pending = (int(defaults.get(ADMISSION_INTERACTIVE_MAX_PENDING))
                                        if interactive_max_pending is None
                                        else interactive_max_pending)
        self._lock = threading.Lock()
        self._inflight: dict[str, str] = {}  # job_id -> session_id
        self._per_session: dict[str, int] = {}
        # per-lane bookkeeping (serving tier): shedding and draining are
        # evaluated per lane so interactive traffic survives batch overload
        self._job_lane: dict[str, str] = {}  # job_id -> lane
        self._lane_inflight: dict[str, int] = {}
        self._lane_admitted: dict[str, int] = {}
        self._lane_shed: dict[str, int] = {}
        self._finishes: deque[float] = deque(maxlen=_DRAIN_SAMPLES)
        self._state = NORMAL
        self._rejected = 0
        # last pressure signals, for the REST /state posture snapshot
        self._last_loop_lag_s = 0.0
        self._last_memory_pressure = 0.0

    # -- admission ---------------------------------------------------------

    def admit(self, session_id: str, job_id: str, lane: str = LANE_BATCH) -> None:
        """Claim an admission slot for `job_id` or raise ClusterOverloaded.

        Raising means NO state was recorded: the caller must not create
        the job. Shedding is per lane: the batch lane carries the original
        posture semantics untouched, while the interactive lane (serving
        tier: known-short repeat queries) only sheds against its own depth
        cap — halved while draining — so short queries keep flowing when a
        batch backlog trips the state machine."""
        if not self.enabled:
            with self._lock:
                self._record_admit_locked(session_id, job_id, lane)
            return
        with self._lock:
            depth = len(self._inflight)
            state = self._state
            used = self._per_session.get(session_id, 0)
            if lane == LANE_INTERACTIVE:
                cap = self.interactive_max_pending
                if state == DRAINING:
                    cap = max(1, cap // 2)
                lane_depth = self._lane_inflight.get(lane, 0)
                if lane_depth >= cap:
                    self._shed_locked(
                        lane, "draining" if state == DRAINING else "depth",
                        f"interactive lane has {lane_depth} jobs in flight "
                        f"(cap {cap}{' while draining' if state == DRAINING else ''})",
                        lane_depth - cap + 1)
                if used >= self.per_session_quota:
                    self._shed_locked(
                        lane, "quota",
                        f"session {session_id} has {used} jobs in flight "
                        f"(quota {self.per_session_quota})",
                        used - self.per_session_quota + 1)
                self._record_admit_locked(session_id, job_id, lane)
                return
            if state == DRAINING:
                self._shed_locked(
                    lane, "draining",
                    f"cluster is draining (depth={depth} >= {self.drain_depth}); "
                    "rejecting all new work until the backlog clears",
                    max(1, depth - self.shed_depth))
            quota = self.per_session_quota
            if state == SHEDDING:
                # graceful degradation: shedding halves every tenant's quota
                # instead of rejecting everyone outright
                quota = max(1, quota // 2)
            if used >= quota:
                self._shed_locked(
                    lane, "shedding" if state == SHEDDING else "quota",
                    f"session {session_id} has {used} jobs in flight "
                    f"(quota {quota}{' while shedding' if state == SHEDDING else ''})",
                    used - quota + 1)
            if depth >= self.max_pending:
                self._shed_locked(
                    lane, "depth",
                    f"cluster has {depth} jobs in flight (max pending {self.max_pending})",
                    depth - self.max_pending + 1)
            self._record_admit_locked(session_id, job_id, lane)

    def _record_admit_locked(self, session_id: str, job_id: str, lane: str) -> None:
        self._inflight[job_id] = session_id
        self._per_session[session_id] = self._per_session.get(session_id, 0) + 1
        self._job_lane[job_id] = lane
        self._lane_inflight[lane] = self._lane_inflight.get(lane, 0) + 1
        self._lane_admitted[lane] = self._lane_admitted.get(lane, 0) + 1

    def _shed_locked(self, lane: str, reason: str, msg: str, excess: int) -> None:
        self._rejected += 1
        self._lane_shed[lane] = self._lane_shed.get(lane, 0) + 1
        raise ClusterOverloaded(
            msg,
            retry_after_ms=self._retry_after_ms_locked(max(1, excess)),
            reason=reason,
        )

    def lane_of(self, job_id: str) -> str | None:
        with self._lock:
            return self._job_lane.get(job_id)

    def finish(self, job_id: str) -> None:
        """Release `job_id`'s admission slot (idempotent — terminal events
        can reach the gate through more than one path)."""
        with self._lock:
            session_id = self._inflight.pop(job_id, None)
            if session_id is None:
                return
            n = self._per_session.get(session_id, 0) - 1
            if n <= 0:
                self._per_session.pop(session_id, None)
            else:
                self._per_session[session_id] = n
            lane = self._job_lane.pop(job_id, LANE_BATCH)
            ln = self._lane_inflight.get(lane, 0) - 1
            if ln <= 0:
                self._lane_inflight.pop(lane, None)
            else:
                self._lane_inflight[lane] = ln
            self._finishes.append(time.monotonic())

    # -- overload state machine --------------------------------------------

    def update(self, loop_lag_s: float, memory_pressure: float) -> str | None:
        """Re-evaluate the overload posture from the three pressure signals.
        Returns the new state if it changed, else None. Called from the
        scheduler event loop (sweep cadence)."""
        with self._lock:
            depth = len(self._inflight)
            self._last_loop_lag_s = loop_lag_s
            self._last_memory_pressure = memory_pressure
            old = self._state
            pressured = (loop_lag_s >= self.shed_loop_lag_s
                         or memory_pressure >= self.shed_memory_pressure)
            if depth >= self.drain_depth:
                new = DRAINING
            elif depth >= self.shed_depth or pressured:
                new = SHEDDING
            elif old != NORMAL:
                # hysteresis: leave shedding/draining only once depth falls
                # to half the shed threshold AND lag/pressure recovered —
                # no flapping at the boundary
                if depth <= self.shed_depth // 2 and not pressured:
                    new = NORMAL
                elif old == DRAINING and depth < self.drain_depth:
                    new = SHEDDING  # step down through shedding, never jump
                else:
                    new = old
            else:
                new = NORMAL
            if new != old:
                self._state = new
                return new
            return None

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)

    def retry_after_ms(self, excess: int = 1) -> int:
        with self._lock:
            return self._retry_after_ms_locked(excess)

    def _retry_after_ms_locked(self, excess: int) -> int:
        """Backoff hint from the observed drain rate: with `r` jobs/s
        finishing, `excess` jobs over budget clear in ~excess/r seconds."""
        now = time.monotonic()
        recent = [t for t in self._finishes if now - t <= _DRAIN_WINDOW_S]
        if len(recent) >= 2:
            span = max(now - recent[0], 0.001)
            rate = len(recent) / span  # jobs per second
            hint_ms = int(max(1, excess) / rate * 1000.0)
        else:
            # no drain signal yet: fall back to a fixed second
            hint_ms = 1000
        return max(self.min_retry_after_ms, min(hint_ms, 60_000))

    def snapshot(self) -> dict:
        """Overload posture for REST /api/state and push-stream events."""
        with self._lock:
            return {
                "state": self._state,
                "enabled": self.enabled,
                "inflight_jobs": len(self._inflight),
                "max_pending_jobs": self.max_pending,
                "per_session_quota": self.per_session_quota,
                "sessions_with_inflight": len(self._per_session),
                "rejected_total": self._rejected,
                "loop_lag_s": round(self._last_loop_lag_s, 3),
                "memory_pressure": round(self._last_memory_pressure, 3),
                "retry_after_ms": self._retry_after_ms_locked(1),
                "lanes": {
                    lane: {
                        "inflight": self._lane_inflight.get(lane, 0),
                        "admitted_total": self._lane_admitted.get(lane, 0),
                        "shed_total": self._lane_shed.get(lane, 0),
                        "cap": (self.interactive_max_pending
                                if lane == LANE_INTERACTIVE else self.max_pending),
                    }
                    for lane in (LANE_BATCH, LANE_INTERACTIVE)
                },
            }
