"""Scheduler metrics collection.

Rebuild of SchedulerMetricsCollector (scheduler/src/metrics/mod.rs:64):
Noop + in-memory implementations, with a Prometheus text exposition
renderer (metrics/prometheus.rs:42 equivalent — histograms for job
execution/planning, counters for outcomes, pending-tasks gauge) served by
the REST API at /api/metrics.
"""

from __future__ import annotations

import threading
import time


class SchedulerMetricsCollector:
    def record_submitted(self, job_id: str) -> None: ...

    def record_completed(self, job_id: str, exec_seconds: float) -> None: ...

    def record_failed(self, job_id: str) -> None: ...

    def record_cancelled(self, job_id: str) -> None: ...

    def record_planning_ms(self, job_id: str, ms: float) -> None: ...

    def set_pending_tasks(self, n: int) -> None: ...

    def record_protocol_mismatch(self) -> None: ...

    def record_speculative_launched(self, job_id: str, stage_id: int) -> None: ...

    def record_task_timeout(self, executor_id: str) -> None: ...

    def set_quarantined_executors(self, n: int) -> None: ...

    def record_job_rejected(self, reason: str, lane: str = "batch") -> None: ...

    def set_overload_state(self, state: str) -> None: ...

    def record_pressure_rejection(self, executor_id: str) -> None: ...

    # -- serving tier (plan/result caches, fast lane, lanes) ---------------

    def record_plan_cache(self, hit: bool) -> None: ...

    def record_result_cache(self, hit: bool) -> None: ...

    def record_fast_lane(self, outcome: str) -> None: ...

    def record_lane_admitted(self, lane: str) -> None: ...

    # -- direct-dispatch leases (scheduler scale-out) ----------------------

    def record_lease(self, event: str) -> None: ...

    def record_direct_dispatch(self, outcome: str) -> None: ...

    # -- incremental maintenance (append ingestion, delta refresh) ---------

    def record_append(self, rows: int) -> None: ...

    def record_incremental(self, outcome: str) -> None: ...


class NoopMetricsCollector(SchedulerMetricsCollector):
    pass


_LATENCY_BUCKETS = [0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0]
_PLANNING_BUCKETS = [1.0, 5.0, 25.0, 100.0, 500.0, 2500.0, 10000.0]


class _Histogram:
    def __init__(self, buckets: list[float]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.n += 1
        self.total += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def render(self, name: str, help_: str) -> list[str]:
        out = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        acc = 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append(f'{name}_bucket{{le="{b}"}} {acc}')
        out.append(f'{name}_bucket{{le="+Inf"}} {self.n}')
        out.append(f"{name}_sum {self.total}")
        out.append(f"{name}_count {self.n}")
        return out


class InMemoryMetricsCollector(SchedulerMetricsCollector):
    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.protocol_mismatches = 0
        self.pending_tasks = 0
        self.speculative_launched = 0
        self.task_timeouts = 0
        self.quarantined_executors = 0
        # overload protection: rejections by reason + current posture
        self.jobs_rejected: dict[str, int] = {}
        self.jobs_rejected_by_lane: dict[str, int] = {}
        self.overload_state = "normal"
        self.pressure_rejections = 0
        # serving tier: cache outcomes, fast-lane outcomes, lane admissions
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self.result_cache_hits = 0
        self.result_cache_misses = 0
        self.fast_lane: dict[str, int] = {}  # executed | fallback
        self.lane_admitted: dict[str, int] = {}
        # direct dispatch: lease lifecycle + dispatch outcomes
        self.lease_events: dict[str, int] = {}  # minted | revoked | expired
        self.direct_dispatch: dict[str, int] = {}  # dispatched | reconciled | demoted
        # incremental maintenance: appends + refresh outcomes
        self.appends = 0
        self.appended_rows = 0
        self.incremental: dict[str, int] = {}  # maintained | state_render | bootstrap | recompute
        self.exec_hist = _Histogram(_LATENCY_BUCKETS)
        self.plan_hist = _Histogram(_PLANNING_BUCKETS)

    def record_submitted(self, job_id: str) -> None:
        with self._lock:
            self.submitted += 1

    def record_completed(self, job_id: str, exec_seconds: float) -> None:
        with self._lock:
            self.completed += 1
            self.exec_hist.observe(exec_seconds)

    def record_failed(self, job_id: str) -> None:
        with self._lock:
            self.failed += 1

    def record_cancelled(self, job_id: str) -> None:
        with self._lock:
            self.cancelled += 1

    def record_planning_ms(self, job_id: str, ms: float) -> None:
        with self._lock:
            self.plan_hist.observe(ms)

    def set_pending_tasks(self, n: int) -> None:
        with self._lock:
            self.pending_tasks = n

    def record_protocol_mismatch(self) -> None:
        with self._lock:
            self.protocol_mismatches += 1

    def record_speculative_launched(self, job_id: str, stage_id: int) -> None:
        with self._lock:
            self.speculative_launched += 1

    def record_task_timeout(self, executor_id: str) -> None:
        with self._lock:
            self.task_timeouts += 1

    def set_quarantined_executors(self, n: int) -> None:
        with self._lock:
            self.quarantined_executors = n

    def record_job_rejected(self, reason: str, lane: str = "batch") -> None:
        with self._lock:
            self.jobs_rejected[reason] = self.jobs_rejected.get(reason, 0) + 1
            self.jobs_rejected_by_lane[lane] = self.jobs_rejected_by_lane.get(lane, 0) + 1

    def record_plan_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.plan_cache_hits += 1
            else:
                self.plan_cache_misses += 1

    def record_result_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.result_cache_hits += 1
            else:
                self.result_cache_misses += 1

    def record_fast_lane(self, outcome: str) -> None:
        with self._lock:
            self.fast_lane[outcome] = self.fast_lane.get(outcome, 0) + 1

    def record_lane_admitted(self, lane: str) -> None:
        with self._lock:
            self.lane_admitted[lane] = self.lane_admitted.get(lane, 0) + 1

    def record_lease(self, event: str) -> None:
        with self._lock:
            self.lease_events[event] = self.lease_events.get(event, 0) + 1

    def record_direct_dispatch(self, outcome: str) -> None:
        with self._lock:
            self.direct_dispatch[outcome] = self.direct_dispatch.get(outcome, 0) + 1

    def record_append(self, rows: int) -> None:
        with self._lock:
            self.appends += 1
            self.appended_rows += rows

    def record_incremental(self, outcome: str) -> None:
        with self._lock:
            self.incremental[outcome] = self.incremental.get(outcome, 0) + 1

    def set_overload_state(self, state: str) -> None:
        with self._lock:
            self.overload_state = state

    def record_pressure_rejection(self, executor_id: str) -> None:
        with self._lock:
            self.pressure_rejections += 1

    def jobs_rejected_total(self) -> int:
        with self._lock:
            return sum(self.jobs_rejected.values())

    def render_prometheus(self) -> str:
        with self._lock:
            lines = []
            for name, v, help_ in [
                ("ballista_scheduler_jobs_submitted_total", self.submitted, "Jobs submitted"),
                ("ballista_scheduler_jobs_completed_total", self.completed, "Jobs completed"),
                ("ballista_scheduler_jobs_failed_total", self.failed, "Jobs failed"),
                ("ballista_scheduler_jobs_cancelled_total", self.cancelled, "Jobs cancelled"),
                ("ballista_scheduler_protocol_mismatch_total", self.protocol_mismatches, "Executor wire-version mismatches"),
                ("ballista_scheduler_speculative_tasks_total", self.speculative_launched, "Speculative task attempts launched"),
                ("ballista_scheduler_task_timeouts_total", self.task_timeouts, "Tasks expired past their deadline"),
                ("ballista_scheduler_pending_tasks", self.pending_tasks, "Pending task gauge"),
                ("ballista_scheduler_quarantined_executors", self.quarantined_executors, "Executors in quarantine/probation"),
                ("ballista_scheduler_pressure_rejections_total", self.pressure_rejections, "Tasks rejected by saturated executor memory pools"),
            ]:
                lines.append(f"# HELP {name} {help_}")
                kind = "gauge" if name.endswith(("pending_tasks", "quarantined_executors")) else "counter"
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {v}")
            lines.append("# HELP ballista_scheduler_jobs_rejected_total Jobs shed by admission control, by reason")
            lines.append("# TYPE ballista_scheduler_jobs_rejected_total counter")
            for reason in sorted(self.jobs_rejected):
                lines.append(f'ballista_scheduler_jobs_rejected_total{{reason="{reason}"}} {self.jobs_rejected[reason]}')
            lines.append("# HELP ballista_scheduler_jobs_rejected_by_lane_total Jobs shed by admission control, by lane")
            lines.append("# TYPE ballista_scheduler_jobs_rejected_by_lane_total counter")
            for lane in sorted(self.jobs_rejected_by_lane):
                lines.append(f'ballista_scheduler_jobs_rejected_by_lane_total{{lane="{lane}"}} {self.jobs_rejected_by_lane[lane]}')
            lines.append("# HELP ballista_scheduler_jobs_admitted_by_lane_total Jobs admitted, by lane")
            lines.append("# TYPE ballista_scheduler_jobs_admitted_by_lane_total counter")
            for lane in sorted(self.lane_admitted):
                lines.append(f'ballista_scheduler_jobs_admitted_by_lane_total{{lane="{lane}"}} {self.lane_admitted[lane]}')
            lines.append("# HELP ballista_scheduler_plan_cache_total Serving plan-cache lookups, by outcome")
            lines.append("# TYPE ballista_scheduler_plan_cache_total counter")
            lines.append(f'ballista_scheduler_plan_cache_total{{outcome="hit"}} {self.plan_cache_hits}')
            lines.append(f'ballista_scheduler_plan_cache_total{{outcome="miss"}} {self.plan_cache_misses}')
            lines.append("# HELP ballista_scheduler_result_cache_total Serving result-cache lookups, by outcome")
            lines.append("# TYPE ballista_scheduler_result_cache_total counter")
            lines.append(f'ballista_scheduler_result_cache_total{{outcome="hit"}} {self.result_cache_hits}')
            lines.append(f'ballista_scheduler_result_cache_total{{outcome="miss"}} {self.result_cache_misses}')
            lines.append("# HELP ballista_scheduler_fast_lane_total Fast-lane dispatches, by outcome")
            lines.append("# TYPE ballista_scheduler_fast_lane_total counter")
            for outcome in sorted(self.fast_lane):
                lines.append(f'ballista_scheduler_fast_lane_total{{outcome="{outcome}"}} {self.fast_lane[outcome]}')
            lines.append("# HELP ballista_scheduler_lease_events_total Direct-dispatch lease lifecycle events, by kind")
            lines.append("# TYPE ballista_scheduler_lease_events_total counter")
            for event in sorted(self.lease_events):
                lines.append(f'ballista_scheduler_lease_events_total{{event="{event}"}} {self.lease_events[event]}')
            lines.append("# HELP ballista_scheduler_direct_dispatch_total Direct-dispatch jobs, by outcome")
            lines.append("# TYPE ballista_scheduler_direct_dispatch_total counter")
            for outcome in sorted(self.direct_dispatch):
                lines.append(f'ballista_scheduler_direct_dispatch_total{{outcome="{outcome}"}} {self.direct_dispatch[outcome]}')
            lines.append("# HELP ballista_scheduler_appends_total Append-ingestion calls accepted")
            lines.append("# TYPE ballista_scheduler_appends_total counter")
            lines.append(f"ballista_scheduler_appends_total {self.appends}")
            lines.append("# HELP ballista_scheduler_appended_rows_total Rows accepted by append ingestion")
            lines.append("# TYPE ballista_scheduler_appended_rows_total counter")
            lines.append(f"ballista_scheduler_appended_rows_total {self.appended_rows}")
            lines.append("# HELP ballista_scheduler_incremental_total Version-bumped serving refreshes, by outcome")
            lines.append("# TYPE ballista_scheduler_incremental_total counter")
            for outcome in sorted(self.incremental):
                lines.append(f'ballista_scheduler_incremental_total{{outcome="{outcome}"}} {self.incremental[outcome]}')
            lines.append("# HELP ballista_scheduler_overload_state Overload posture (0=normal 1=shedding 2=draining)")
            lines.append("# TYPE ballista_scheduler_overload_state gauge")
            state_code = {"normal": 0, "shedding": 1, "draining": 2}.get(self.overload_state, 0)
            lines.append(f"ballista_scheduler_overload_state {state_code}")
            lines.extend(self.exec_hist.render(
                "ballista_scheduler_job_exec_time_seconds", "Job execution wall time"))
            lines.extend(self.plan_hist.render(
                "ballista_scheduler_planning_time_ms", "Job planning time"))
            return "\n".join(lines) + "\n"
