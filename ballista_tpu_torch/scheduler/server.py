"""Scheduler server core: job state machine + event loop + task binding.

Rebuild of SchedulerServer / QueryStageScheduler / SchedulerState
(scheduler/src/scheduler_server/mod.rs:75, query_stage_scheduler.rs:96,
state/mod.rs:98):

- events (JobQueued, JobSubmitted, TaskUpdating, ReviveOffers,
  ExecutorLost, JobFinished/Failed, CancelJob) flow through a single
  bounded event loop; PLANNING runs on a spawned thread so the loop never
  blocks (query_stage_scheduler.rs:372);
- ReviveOffers: reserve executor slots → pop runnable tasks from job
  graphs → hand to the TaskLauncher (push mode); pull-mode executors call
  `poll_work` which pops directly from the same state;
- the TaskLauncher seam is what the virtual-cluster test harness fakes
  (reference: VirtualTaskLauncher, test_utils.rs:349).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ballista_tpu_torch.config import (
    SERVING_FAST_LANE,
    SERVING_FAST_LANE_TIMEOUT_S,
    SERVING_INCREMENTAL,
    SERVING_PLAN_CACHE,
    SERVING_RESULT_CACHE,
    SERVING_SUBSCRIPTION_QUEUE,
    BallistaConfig,
)
from ballista_tpu_torch.errors import BallistaError, ClusterOverloaded, PlanningError
from ballista_tpu_torch.executor.executor import ExecutorMetadata, TaskResult
from ballista_tpu_torch.ids import JobId, new_job_id
from ballista_tpu_torch.scheduler.admission import LANE_BATCH, LANE_INTERACTIVE, AdmissionController
from ballista_tpu_torch.scheduler.metrics import NoopMetricsCollector, SchedulerMetricsCollector
from ballista_tpu_torch.scheduler.planner import DistributedPlanner
from ballista_tpu_torch.scheduler.shard import SchedulerShard, shard_of
from ballista_tpu_torch.scheduler.state.execution_graph import (
    ExecutionGraph,
    JobState,
    TaskDescription,
)
from ballista_tpu_torch.scheduler.state.executor_manager import ExecutorManager
from ballista_tpu_torch.scheduler.state.session_manager import SessionManager
from ballista_tpu_torch.serving.fast_lane import FAST_TASK_ID_BASE, FastJob
from ballista_tpu_torch.serving.incremental import (
    DeltaRegistry,
    SubscriptionRegistry,
    build_maintain_plan,
    decide,
    graft_append_scans,
    graft_delta_scan,
    render_finisher,
    split_finisher,
)
from ballista_tpu_torch.serving.lease import (
    DEFAULT_LEASE_SLOTS, DEFAULT_LEASE_TTL_S, ExecutorLease, LeaseRegistry)
from ballista_tpu_torch.serving.normalize import (
    bind_logical,
    bind_physical,
    collect_physical_params,
    config_fingerprint,
    lift_parameters,
)
from ballista_tpu_torch.serving.tier import (
    PlanTemplate,
    PreparedStatement,
    ServingTier,
    StateEntry,
)

log = logging.getLogger(__name__)


class TaskLauncher:
    """Seam for pushing bound tasks to executors."""

    def launch(self, executor_id: str, tasks: list[TaskDescription], server: "SchedulerServer") -> None:
        raise NotImplementedError

    def cancel_tasks(self, executor_id: str, job_id: str,
                     items: list[tuple[int, int]], server: "SchedulerServer") -> None:
        """Best-effort CancelTasks push: items = [(task_id, stage_id)].
        In-process/virtual launchers may ignore it (their tasks either
        finish instantly or are synthetic)."""
        return

    def remove_job_data(self, executor_id: str, job_id: str,
                        server: "SchedulerServer") -> None:
        """Best-effort shuffle-GC push for a finished/cleaned job."""
        return

    def grant_lease(self, executor_id: str, lease, server: "SchedulerServer") -> None:
        """Push a freshly minted direct-dispatch lease to the executor's
        lease table (in-process launchers set it directly; gRPC/Flight
        launchers ship the wire form)."""
        return

    def migrate_partitions(self, src_executor_id: str, dest_executor_id: str,
                           locations: list, server: "SchedulerServer") -> tuple[int, int]:
        """Drain handoff (docs/lifecycle.md): move `locations` (shuffle map
        outputs held by the draining source) to the destination executor
        and rewrite each PartitionLocation in place. Returns
        (migrated_count, migrated_bytes). The default launcher migrates
        nothing — the drain then falls back to the recompute path exactly
        like an executor loss."""
        return 0, 0

    def revoke_lease(self, executor_id: str, lease_id: str,
                     server: "SchedulerServer") -> None:
        """Best-effort revocation push; the executor-side expiry check is
        the backstop when this never arrives."""
        return


@dataclass
class Event:
    kind: str  # job_queued | revive | task_update | executor_lost | cancel | shutdown
    payload: object = None
    # stamped at post time; dequeue-time minus this is the event-loop lag
    # that feeds the overload state machine
    posted_at: float = field(default_factory=time.monotonic)


@dataclass
class _RcFill:
    """What to do with a dispatched job's output before serving it.

    kind "plain": the output IS the result — store under `rkey`.
    kind "state": the output is accumulator state (the plan was truncated
    at the final aggregate) — persist it as a StateEntry, render the
    finisher chain over it, and serve/store the rendered table. The job
    must not look successful until the render lands (`_rc_render_pending`
    masks `job_status`), or clients would fetch raw accumulators.
    kind "append": the output is the delta rows of an append-maintained
    plan — concatenate onto `base` (the cached prior result), persist,
    serve.
    """

    rkey: tuple
    kind: str = "plain"  # plain | state | append
    template_key: str = ""
    values: tuple = ()
    vector: tuple = ()  # table-version vector snapshotted at submit
    finisher: list = field(default_factory=list)
    final: object = None  # the final HashAggregateExec (kind "state")
    base: object = None  # prior result table (kind "append" maintain)
    mode: str = ""  # maintained | bootstrap
    inline_result: object = None  # set when no job needs dispatching


class SchedulerServer:
    def __init__(self, launcher: TaskLauncher | None = None,
                 metrics: SchedulerMetricsCollector | None = None,
                 task_distribution: str = "bias",
                 executor_timeout_s: float = 180.0,
                 scheduler_id: str = "scheduler-0",
                 job_state=None,
                 quarantine_threshold: float = 0.5,
                 quarantine_min_events: float = 4.0,
                 health_half_life_s: float = 60.0,
                 probe_backoff_s: float = 10.0,
                 sweep_interval_s: float = 0.5,
                 admission: AdmissionController | None = None,
                 shards: int = 1):
        from ballista_tpu_torch.scheduler.state.job_state import InMemoryJobState

        self.scheduler_id = scheduler_id
        self.executors = ExecutorManager(
            task_distribution, executor_timeout_s,
            quarantine_threshold=quarantine_threshold,
            quarantine_min_events=quarantine_min_events,
            health_half_life_s=health_half_life_s,
            probe_backoff_s=probe_backoff_s,
        )
        self.sweep_interval_s = sweep_interval_s
        self.sessions = SessionManager()
        self.jobs: dict[str, ExecutionGraph] = {}
        self.job_state = job_state or InMemoryJobState()
        self.launcher = launcher
        self.metrics = metrics or NoopMetricsCollector()
        self.admission = admission or AdmissionController()
        # sharded event loops: job ownership partitions by
        # shard_of(job_id) % num_shards; each shard has its own bounded
        # queue and lag EWMA (fleet lag = max over shards)
        self.num_shards = max(1, int(shards))
        self._shards = [SchedulerShard(self, i) for i in range(self.num_shards)]
        # heartbeat fan-in accounting: executor signals arrive ONCE and
        # fleet-scoped events multicast to the shards owning work
        self._fanin = {"heartbeats": 0, "events_multicast": 0}
        # direct-dispatch lease ledger (capacity slices on warm executors)
        self.leases = LeaseRegistry()
        self._jobs_lock = threading.RLock()
        self._job_rr = 0  # round-robin offer fairness across jobs
        self._running = False
        self._watchers: dict[str, list[threading.Event]] = {}
        # serving tier: plan/result caches + fast-lane jobs executing
        # outside the execution-graph machinery (keyed by job_id)
        self.serving = ServingTier()
        self._fast_jobs: dict[str, FastJob] = {}
        # graph jobs whose results should fill a result-cache slot on finish
        self._rc_pending: dict[str, _RcFill] = {}
        # jobs whose terminal transition is owned by the post-finish render
        # (incremental state/append fills): job_status masks success until
        # the rendered result is attached
        self._rc_render_pending: set[str] = set()
        # streaming ingestion: retained append deltas + continuous queries
        self.ingest = DeltaRegistry()
        self.subscriptions = SubscriptionRegistry()
        # lifecycle (docs/lifecycle.md): drains in flight (guards against
        # duplicate heartbeat triggers) + fleet drain/GC counters surfaced
        # on /api/state
        self._drains_inflight: set[str] = set()
        self._drain_lock = threading.Lock()
        self.lifecycle_stats = {"drains": 0, "drain_kills": 0,
                                "migrated_partitions": 0, "migrated_bytes": 0,
                                "gc_swept_jobs": 0}
        # catalog changes orphan the table's cached results AND its
        # retained deltas (new lineage), and wake continuous queries
        self.sessions.on_catalog_change = self._on_catalog_change

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        for sh in self._shards:
            sh.start()
        if self.sweep_interval_s > 0:
            threading.Thread(target=self._sweep_timer, daemon=True, name="straggler-sweep").start()

    def _sweep_timer(self) -> None:
        """Periodic straggler sweep: deadline expiry, speculative launches,
        quarantine probes. Posted as an event so all graph mutation stays on
        the single event loop."""
        while self._running:
            time.sleep(self.sweep_interval_s)
            if not self._running:
                return
            self.post(Event("sweep"))

    def stop(self) -> None:
        self._running = False
        for sh in self._shards:
            sh.post(Event("shutdown"))
        for sh in self._shards:
            sh.join(timeout=5)

    @property
    def _loop_lag_s(self) -> float:
        """Fleet admission-lag signal: the WORST shard's EWMA (one wedged
        shard must still trip the overload state machine)."""
        return max(sh.loop_lag_s for sh in self._shards)

    def _shard_for(self, job_id: str) -> SchedulerShard:
        return self._shards[shard_of(job_id, self.num_shards)]

    def post(self, ev: Event) -> None:
        """Route an event to its owning shard. Job-scoped events go to
        hash(job_id) % N; fleet-scoped events (revive / sweep /
        executor_lost / shutdown) fan in once here and multicast."""
        if self.num_shards == 1:
            self._shards[0].post(ev)
            return
        if ev.kind == "job_queued":
            self._shard_for(ev.payload[0]).post(ev)
        elif ev.kind == "cancel":
            self._shard_for(ev.payload).post(ev)
        elif ev.kind == "revive" and ev.payload is not None:
            # job-scoped revive (a specific job became runnable): only its
            # owning shard can offer it; multicasting would make every
            # dispatch cost N offer scans
            self._shard_for(ev.payload).post(ev)
        elif ev.kind == "task_update":
            executor_id, results = ev.payload
            by_shard: dict[int, list] = {}
            for r in results:
                by_shard.setdefault(shard_of(r.job_id, self.num_shards), []).append(r)
            for idx, rs in by_shard.items():
                self._shards[idx].post(
                    Event("task_update", (executor_id, rs), posted_at=ev.posted_at))
        else:
            self._fanin["events_multicast"] += 1
            for sh in self._shards:
                sh.post(Event(ev.kind, ev.payload, posted_at=ev.posted_at))

    def _handle(self, ev: Event, shard: SchedulerShard | None = None) -> None:
        """Per-event dispatch, scoped to `shard`'s slice of the jobs dict
        (None = unsharded view, e.g. direct calls from tests)."""
        if ev.kind == "shutdown":
            return
        if ev.kind == "job_queued":
            # planning off the event loop (query_stage_scheduler.rs:372)
            threading.Thread(target=self._plan_job, args=(ev.payload,), daemon=True).start()
        elif ev.kind == "revive":
            self._offer_reservation(shard)
        elif ev.kind == "task_update":
            executor_id, results = ev.payload
            self._apply_task_updates(executor_id, results)
            self._offer_reservation(shard)
            # the completions above freed slots OTHER shards' starved jobs
            # may be waiting on, and those shards see no event for it.
            # Nudge idle peers ONLY while slots stay free after our own
            # offer: under saturation the gate stays shut, so the nudge
            # never turns one completion into N offer scans
            if (shard is not None and self.num_shards > 1
                    and self.executors.free_slot_count() > 0):
                for sh in self._shards:
                    if sh.shard_id != shard.shard_id and sh.queue_depth() == 0:
                        sh.post(Event("revive"))
        elif ev.kind == "executor_lost":
            self._on_executor_lost(ev.payload, shard)
            self._offer_reservation(shard)
        elif ev.kind == "cancel":
            self._cancel_job(ev.payload)
        elif ev.kind == "sweep":
            self._sweep_stragglers(shard)

    def shards_snapshot(self) -> list[dict]:
        """Per-shard queue depth / lag / owned-job counts (REST + KEDA)."""
        counts: dict[int, int] = {}
        with self._jobs_lock:
            for job_id in self.jobs:
                idx = shard_of(job_id, self.num_shards)
                counts[idx] = counts.get(idx, 0) + 1
        return [{
            "shard": sh.shard_id,
            "queue_depth": sh.queue_depth(),
            "loop_lag_s": round(sh.loop_lag_s, 4),
            "handled": sh.handled,
            "jobs": counts.get(sh.shard_id, 0),
        } for sh in self._shards]

    # -- job submission --------------------------------------------------------

    def _admit_or_shed(self, session_id: str, job_id: str, lane: str = LANE_BATCH) -> None:
        """Admission gate in front of every submit path. A rejection
        happens BEFORE any job state exists, so a shed submission costs
        one dict lookup — the whole point of admission control. Lanes shed
        independently: interactive (fast-lane) traffic has its own cap and
        keeps flowing while batch drains, and vice versa."""
        try:
            self.admission.admit(session_id, job_id, lane=lane)
        except ClusterOverloaded as e:
            self.metrics.record_job_rejected(e.reason, lane=lane)
            log.warning("shed %s-lane job %s from session %s (%s, retry_after=%dms)",
                        lane, job_id, session_id, e.reason, e.retry_after_ms)
            raise
        self.metrics.record_lane_admitted(lane)

    def submit_sql(self, sql: str, session_id: str, job_name: str = "",
                   inline_results: bool = False) -> str:
        """SQL entry point. With the serving tier enabled, planning runs
        synchronously on the submit thread through the plan cache (a hit
        skips parse+optimize+physical planning entirely); single-stage
        plans then dispatch on the fast lane without ever touching the
        event loop. `inline_results` marks an in-process caller that can
        accept a result table in the status dict (result-cache hits)."""
        cfg = self.sessions.get(session_id) or BallistaConfig()
        if not bool(cfg.get(SERVING_PLAN_CACHE)):
            job_id = str(new_job_id())
            self._admit_or_shed(session_id, job_id)
            with self._jobs_lock:
                self.jobs[job_id] = ExecutionGraph(job_id, job_name, session_id, [],
                                                   self.sessions.get(session_id))
                self.jobs[job_id].status = JobState.QUEUED
            self.metrics.record_submitted(job_id)
            self.post(Event("job_queued", (job_id, "sql", sql, session_id)))
            return job_id
        return self._submit_serving(sql, session_id, job_name, cfg, inline_results)

    def _enqueue_legacy_sql(self, job_id: str, sql: str, session_id: str,
                            job_name: str) -> str:
        with self._jobs_lock:
            self.jobs[job_id] = ExecutionGraph(job_id, job_name, session_id, [],
                                               self.sessions.get(session_id))
            self.jobs[job_id].status = JobState.QUEUED
        self.post(Event("job_queued", (job_id, "sql", sql, session_id)))
        return job_id

    def _submit_serving(self, sql: str, session_id: str, job_name: str,
                        cfg: BallistaConfig, inline_results: bool) -> str:
        from ballista_tpu_torch.engine.physical_planner import PhysicalPlanner
        from ballista_tpu_torch.sql.ast import CreateExternalTable, DropTable, SelectStmt
        from ballista_tpu_torch.sql.optimizer import optimize
        from ballista_tpu_torch.sql.parser import parse_sql
        from ballista_tpu_torch.sql.planner import SqlPlanner

        cfg_fp = config_fingerprint(cfg)
        hit = self.serving.lookup_text(sql, cfg_fp)
        job_id = str(new_job_id())
        # lane choice must precede admission; only a cache hit knows the
        # stage count up front, so first-time shapes ride the batch lane
        lane = LANE_BATCH
        if hit is not None and hit[2].single_stage:
            lane = LANE_INTERACTIVE
        self._admit_or_shed(session_id, job_id, lane=lane)
        self.metrics.record_submitted(job_id)
        t0 = time.time()
        try:
            if hit is not None:
                key, values, template = hit
                self.metrics.record_plan_cache(True)
                template.hits += 1
            else:
                stmt = parse_sql(sql)
                if not isinstance(stmt, SelectStmt):
                    # DDL / utility statements take the legacy queued path
                    # (the planning context handles them); catalog-visible
                    # DDL orphans the table's cached results
                    if isinstance(stmt, (CreateExternalTable, DropTable)):
                        self._on_catalog_change(stmt.name.lower())
                    return self._enqueue_legacy_sql(job_id, sql, session_id, job_name)
                ctx = self.sessions.create_planning_context(session_id)
                optimized = optimize(SqlPlanner(ctx.catalog).plan_query(stmt))
                lift = lift_parameters(optimized)
                if not lift.cacheable:
                    self.serving.note_uncacheable()
                    log.debug("job %s uncacheable (%s); planning directly", job_id, lift.reason)
                    physical = PhysicalPlanner(cfg).plan(optimized)
                    self.metrics.record_planning_ms(job_id, (time.time() - t0) * 1000)
                    return self._dispatch_serving(job_id, job_name, session_id, cfg,
                                                  physical, None, (), inline_results)
                key = f"{lift.key}:{cfg_fp}"
                values = lift.values
                template = self.serving.lookup_template(key, values)
                self.metrics.record_plan_cache(template is not None)
                if template is None:
                    tagged_physical = PhysicalPlanner(cfg).plan(lift.tagged)
                    bindable = set(range(len(values))) <= collect_physical_params(tagged_physical)
                    template = PlanTemplate(key=key, physical=tagged_physical,
                                            type_tags=lift.type_tags, values=values,
                                            tables=lift.tables, bindable=bindable)
                    self.serving.store_template(template)
                self.serving.remember_text(sql, cfg_fp, key, values)
            if (bool(cfg.get(SERVING_RESULT_CACHE)) and inline_results):
                rkey = self.serving.result_key(template.key, values, template.tables)
                cached = self.serving.lookup_result(rkey)
                self.metrics.record_result_cache(cached is not None)
                if cached is not None:
                    job = FastJob(job_id, job_name, session_id, cfg, inline_result=cached)
                    with self._jobs_lock:
                        self.jobs[job_id] = job
                    self.metrics.record_completed(job_id, 0.0)
                    self._notify(job_id)
                    return job_id
            else:
                rkey = None
            bound = bind_physical(template.physical, values)
            physical, fill = self._incremental_or_plain(template, values, bound,
                                                        rkey, cfg)
            self.metrics.record_planning_ms(job_id, (time.time() - t0) * 1000)
            if physical is None:
                # cached state already covers the current versions
                self.serving.store_result(rkey, fill.inline_result)
                return self._serve_inline(job_id, job_name, session_id, cfg,
                                          fill.inline_result)
            return self._dispatch_serving(job_id, job_name, session_id, cfg,
                                          physical, template, values,
                                          inline_results, fill=fill)
        except BaseException as e:  # noqa: BLE001 — same contract as _plan_job
            log.warning("serving submit failed for %s: %s", job_id, e, exc_info=True)
            with self._jobs_lock:
                g = ExecutionGraph(job_id, job_name, session_id, [], cfg)
                g.status = JobState.FAILED
                g.error = f"planning failed: {e}"
                g.ended_at = time.time()
                self.jobs[job_id] = g
            self.metrics.record_failed(job_id)
            self._notify(job_id)
            return job_id

    def _dispatch_serving(self, job_id: str, job_name: str, session_id: str,
                          cfg: BallistaConfig, physical, template, values,
                          inline_results: bool, fill: _RcFill | None = None) -> str:
        """Stage the bound plan and dispatch: fast lane for single-stage
        plans with slots available, the ordinary execution graph otherwise."""
        from ballista_tpu_torch.scheduler.planner import merge_mesh_stages

        physical = self._graft_deltas(physical)
        stages = merge_mesh_stages(DistributedPlanner(job_id).plan_query_stages(physical), cfg)
        self._maybe_verify_stages(stages, cfg, job_id)
        if template is not None and template.single_stage is None:
            template.single_stage = len(stages) == 1
        if (len(stages) == 1 and self.launcher is not None
                and bool(cfg.get(SERVING_FAST_LANE))
                and self._try_fast_lane(job_id, job_name, session_id, cfg, stages, fill)):
            return job_id
        graph = ExecutionGraph(job_id, job_name, session_id, stages, cfg)
        with self._jobs_lock:
            self.jobs[job_id] = graph
            if fill is not None:
                self._rc_pending[job_id] = fill
                if fill.kind != "plain":
                    self._rc_render_pending.add(job_id)
        if self.job_state.acquire(job_id, self.scheduler_id):
            self.job_state.save_graph(graph)
        self.post(Event("revive", job_id))
        return job_id

    @staticmethod
    def _maybe_verify_stages(stages, cfg: BallistaConfig, job_id: str) -> None:
        """Static plan verification behind ballista.debug.plan.verify: a
        violated DAG invariant fails the job at submit time (the raise
        propagates into the planning-failure path) instead of executing a
        corrupt plan. Off by default — the golden plan-stability tests run
        the same checks unconditionally."""
        from ballista_tpu_torch.config import DEBUG_PLAN_VERIFY

        if cfg is not None and bool(cfg.get(DEBUG_PLAN_VERIFY)):
            from ballista_tpu_torch.analysis.plan_check import check_stages

            log.debug("plan verify: %d stages of %s", len(stages), job_id)
            check_stages(stages)

    def _try_fast_lane(self, job_id: str, job_name: str, session_id: str,
                       cfg: BallistaConfig, stages, fill) -> bool:
        """Dispatch a single-stage job straight to warm executors from the
        submit thread — no graph, no event-loop round trip. Declines (and
        the caller falls back to the graph) unless every partition gets a
        slot NOW: a partially-dispatched fast job would just be a worse
        execution graph."""
        stage = stages[0]
        n = stage.partitions
        reservations = self.executors.reserve_slots(n)
        granted = sum(c for _, c in reservations)
        if granted < n:
            for executor_id, count in reservations:
                self.executors.free_slot(executor_id, count)
            return False
        job = FastJob(job_id, job_name, session_id, cfg, stages=stages, rc_key=fill)
        with self._jobs_lock:
            self.jobs[job_id] = job
            self._fast_jobs[job_id] = job
            if fill is not None and fill.kind != "plain":
                # the partitions hold delta rows or accumulator state, not
                # the answer: clients poll until the fill renders it, as on
                # the graph path (ROADMAP C22)
                self._rc_render_pending.add(job_id)
        parts = list(range(n))
        i = 0
        for executor_id, count in reservations:
            chunk, i = parts[i:i + count], i + count
            tasks = [TaskDescription(
                job_id=job_id, stage_id=stage.stage_id, stage_attempt=0,
                task_id=FAST_TASK_ID_BASE + p, partitions=[p], plan=stage.plan,
                session_id=session_id, fast_lane=True,
            ) for p in chunk]
            if tasks:
                self._spawn_launch(executor_id, tasks)
        self.serving.note_fast_lane("executed")
        self.metrics.record_fast_lane("executed")
        return True

    # -- streaming ingestion + incremental maintenance ------------------------

    def _on_catalog_change(self, table: str) -> None:
        self.serving.table_versions.bump(table)
        self.ingest.reset(table)
        self._notify_subscriptions(table)

    def append_data(self, table: str, batches, session_id: str = "") -> dict:
        """Append-oriented ingestion: bump the table's version AND retain
        the delta batches under the new version, so eligible cached
        results maintain instead of recomputing. Every read path sees the
        appended rows immediately via the dispatch-time scan graft."""
        table = str(table).lower()
        rows = int(sum(b.num_rows for b in batches))
        cfg = self.sessions.get(session_id)
        if cfg is not None:
            self.ingest.configure(cfg)
        version = self.serving.table_versions.bump(table)
        self.ingest.append(table, version, list(batches))
        self.serving.note_append(rows)
        self.metrics.record_append(rows)
        self._notify_subscriptions(table)
        log.debug("append %d rows to %s -> version %d", rows, table, version)
        return {"table": table, "version": version, "rows": rows}

    def _graft_deltas(self, physical):
        """Bind-time delta stamping: planning contexts and cached templates
        stay base-only; every dispatch path unions named scans with the
        ingest registry's folded parts + retained appends. Stage planning
        runs AFTER the graft, so AQE and plan verification see the real
        DAG."""
        if self.ingest.empty():
            return physical
        return graft_append_scans(physical, self.ingest.view())

    def _serve_inline(self, job_id: str, job_name: str, session_id: str,
                      cfg: BallistaConfig, result) -> str:
        """Finish a submission whose result exists without dispatching."""
        job = FastJob(job_id, job_name, session_id, cfg, inline_result=result)
        with self._jobs_lock:
            self.jobs[job_id] = job
        self.metrics.record_completed(job_id, 0.0)
        self._notify(job_id)
        return job_id

    def _incremental_or_plain(self, template: PlanTemplate, values: tuple,
                              bound, rkey, cfg: BallistaConfig):
        """The maintain-on-bump ladder for a result-cache miss. Returns
        (physical_to_dispatch, fill); physical is None when the cached
        state already covers the current versions (fill.inline_result is
        the rendered answer, no job needed)."""
        if rkey is None:
            return bound, None
        fill = _RcFill(rkey=rkey)
        if not bool(cfg.get(SERVING_INCREMENTAL)):
            return bound, fill
        decision = decide(template)
        if decision.mode == "none":
            self.serving.note_incremental("recompute", decision.reason)
            self.metrics.record_incremental("recompute")
            return bound, fill
        vector = rkey[2]  # version vector snapshotted into the result key
        fill.template_key, fill.values, fill.vector = template.key, values, vector
        entry = self.serving.lookup_state(template.key, values)
        stale = entry if (entry is not None and entry.kind != decision.mode) else None
        if stale is not None:
            entry = None  # template re-analyzed differently; state unusable
        changed = None
        if entry is not None and len(entry.vector) == len(vector):
            changed = [(t, old, new) for (t, old), (_, new)
                       in zip(entry.vector, vector) if new != old]
        if decision.mode == "aggregate":
            final, chain = split_finisher(bound)
            fill.kind, fill.final, fill.finisher = "state", final, chain
            if changed is not None and not changed:
                # result cache evicted but state is current: render only
                result = render_finisher(chain, final, entry.table.to_batches(), cfg)
                self.serving.note_incremental("state_render")
                self.metrics.record_incremental("state_render")
                fill.inline_result = result
                return None, fill
            if changed is not None and len(changed) == 1 and changed[0][2] > changed[0][1]:
                t, old, new = changed[0]
                deltas, why = self.ingest.range(t, old, new)
                if deltas is not None:
                    plan = build_maintain_plan(bound, t, deltas,
                                               entry.table.to_batches())
                    fill.mode = "maintained"
                    self.serving.note_incremental("maintained")
                    self.metrics.record_incremental("maintained")
                    return plan, fill
                self.serving.note_incremental("recompute", why)
                self.metrics.record_incremental("recompute")
            elif changed is not None:
                reason = ("multi-table-append" if len(changed) > 1
                          else "version-regressed")
                self.serving.note_incremental("recompute", reason)
                self.metrics.record_incremental("recompute")
            # bootstrap: run the state computation once so the NEXT bump
            # maintains; the finisher renders scheduler-side either way
            fill.mode = "bootstrap"
            if changed is None:  # fallbacks above already counted recompute
                self.serving.note_incremental("bootstrap")
                self.metrics.record_incremental("bootstrap")
            return final, fill
        # decision.mode == "append": stateless plans maintain by
        # concatenating the delta query's rows onto the cached result
        fill.kind = "append"
        if changed is not None and not changed:
            self.serving.note_incremental("state_render")
            self.metrics.record_incremental("state_render")
            fill.inline_result = entry.table
            return None, fill
        if changed is not None and len(changed) == 1 and changed[0][2] > changed[0][1]:
            t, old, new = changed[0]
            deltas, why = self.ingest.range(t, old, new)
            if deltas is not None:
                fill.base, fill.mode = entry.table, "maintained"
                self.serving.note_incremental("maintained")
                self.metrics.record_incremental("maintained")
                return graft_delta_scan(bound, t, deltas), fill
            self.serving.note_incremental("recompute", why)
            self.metrics.record_incremental("recompute")
        elif changed is not None:
            self.serving.note_incremental("recompute", "multi-table-append")
            self.metrics.record_incremental("recompute")
        fill.mode = "bootstrap"
        if changed is None:
            self.serving.note_incremental("bootstrap")
            self.metrics.record_incremental("bootstrap")
        return bound, fill

    def _finish_fill(self, fill: _RcFill, tbl, cfg) -> object:
        """Turn a finished job's fetched output into the served result per
        the fill kind, persisting maintenance state for the next bump."""
        if fill.kind == "state":
            result = render_finisher(fill.finisher, fill.final,
                                     tbl.to_batches(), cfg)
            self.serving.store_state(fill.template_key, fill.values,
                                     StateEntry(fill.vector, tbl, "aggregate"))
            self.serving.store_result(fill.rkey, result)
            return result
        if fill.kind == "append":
            import pyarrow as pa

            if fill.base is not None:
                result = pa.concat_tables(
                    [fill.base, tbl.cast(fill.base.schema)]).combine_chunks()
            else:
                result = tbl
            self.serving.store_state(fill.template_key, fill.values,
                                     StateEntry(fill.vector, result, "append"))
            self.serving.store_result(fill.rkey, result)
            return result
        self.serving.store_result(fill.rkey, tbl)
        return tbl

    # -- continuous queries ----------------------------------------------------

    def subscribe_statement(self, statement_id: str, params=None,
                            session_id: str = "",
                            inline_results: bool = True):
        """Continuous-query mode: re-execute a prepared statement
        (incrementally when eligible) on every bump of its tables, pushing
        fresh results into the subscription's queue. Returns the
        Subscription; the gRPC push stream drains its queue."""
        stmt = self.serving.get_prepared(statement_id)
        if stmt is None:
            raise BallistaError(f"unknown prepared statement {statement_id}")
        sid = session_id or stmt.session_id
        cfg = self.sessions.get(sid) or BallistaConfig()
        template = self.serving.plan_cache.get(stmt.key)
        tables = template.tables if template is not None else ()
        sub = self.subscriptions.register(
            statement_id, tuple(params) if params is not None else None,
            sid, tables, int(cfg.get(SERVING_SUBSCRIPTION_QUEUE)),
            inline_results)
        # push the current result immediately so subscribers start warm
        self._spawn_subscription_refresh(sub)
        return sub

    def unsubscribe(self, sub_id: str) -> None:
        self.subscriptions.remove(sub_id)

    def _notify_subscriptions(self, table: str) -> None:
        for sub in self.subscriptions.for_table(table):
            self._spawn_subscription_refresh(sub)

    def _spawn_subscription_refresh(self, sub) -> None:
        if not sub.begin_refresh():
            return  # in-flight refresh absorbs the bump (dirty mark)

        def run():
            while True:
                try:
                    job_id = self.execute_prepared(
                        sub.statement_id, sub.params, session_id=sub.session_id,
                        inline_results=sub.inline)
                    st = self.wait_for_job(job_id, timeout=300.0)
                    st = dict(st)
                    st["subscription_id"] = sub.sub_id
                    sub.offer(st)
                    if not sub.tables:
                        stmt = self.serving.get_prepared(sub.statement_id)
                        peek = (self.serving.plan_cache.get(stmt.key)
                                if stmt is not None else None)
                        if peek is not None and peek.tables:
                            self.subscriptions.bind_tables(sub, peek.tables)
                except BaseException as e:  # noqa: BLE001 — push the error, keep the stream
                    log.warning("subscription %s refresh failed: %s",
                                sub.sub_id, e)
                    sub.note_error(str(e))
                if not sub.end_refresh():
                    return

        threading.Thread(target=run, daemon=True,
                         name=f"subscription-{sub.sub_id}").start()

    # -- prepared statements ---------------------------------------------------

    def prepare_statement(self, sql: str, session_id: str) -> dict:
        """Parse + optimize + physical-plan ONCE; later execute() calls
        bind new parameter values into the cached template. Returns the
        statement id and the slot signature (count + arrow types)."""
        from ballista_tpu_torch.engine.physical_planner import PhysicalPlanner
        from ballista_tpu_torch.sql.ast import SelectStmt
        from ballista_tpu_torch.sql.optimizer import optimize
        from ballista_tpu_torch.sql.parser import parse_sql
        from ballista_tpu_torch.sql.planner import SqlPlanner

        cfg = self.sessions.get(session_id) or BallistaConfig()
        stmt = parse_sql(sql)
        if not isinstance(stmt, SelectStmt):
            raise PlanningError("only SELECT statements can be prepared")
        ctx = self.sessions.create_planning_context(session_id)
        lift = lift_parameters(optimize(SqlPlanner(ctx.catalog).plan_query(stmt)))
        if not lift.cacheable:
            raise PlanningError(f"statement cannot be parameterized: {lift.reason}")
        key = f"{lift.key}:{config_fingerprint(cfg)}"
        if self.serving.plan_cache.get(key) is None:
            physical = PhysicalPlanner(cfg).plan(lift.tagged)
            bindable = set(range(len(lift.values))) <= collect_physical_params(physical)
            self.serving.store_template(PlanTemplate(
                key=key, physical=physical, type_tags=lift.type_tags,
                values=lift.values, tables=lift.tables, bindable=bindable))
        statement_id = f"stmt-{new_job_id()}"
        self.serving.register_prepared(PreparedStatement(
            statement_id, sql, session_id, key, lift.type_tags, lift.values))
        return {"statement_id": statement_id,
                "num_params": len(lift.values),
                "type_tags": list(lift.type_tags)}

    def execute_prepared(self, statement_id: str, params=None, session_id: str = "",
                         job_name: str = "", inline_results: bool = False) -> str:
        """Bind params into a prepared statement's template and dispatch.
        Survives template eviction (re-plans from the retained SQL) and
        non-bindable templates (binds at the logical level instead)."""
        from ballista_tpu_torch.engine.physical_planner import PhysicalPlanner
        from ballista_tpu_torch.sql.optimizer import optimize
        from ballista_tpu_torch.sql.parser import parse_sql
        from ballista_tpu_torch.sql.planner import SqlPlanner

        stmt = self.serving.get_prepared(statement_id)
        if stmt is None:
            raise BallistaError(f"unknown prepared statement {statement_id}")
        sid = session_id or stmt.session_id
        cfg = self.sessions.get(sid) or BallistaConfig()
        values = tuple(params) if params is not None else stmt.default_values
        if len(values) != len(stmt.type_tags):
            raise PlanningError(
                f"statement {statement_id} takes {len(stmt.type_tags)} "
                f"parameters, got {len(values)}")
        job_id = str(new_job_id())
        peek = self.serving.plan_cache.get(stmt.key)
        lane = LANE_INTERACTIVE if (peek is not None and peek.single_stage) else LANE_BATCH
        self._admit_or_shed(sid, job_id, lane=lane)
        self.metrics.record_submitted(job_id)
        t0 = time.time()
        try:
            template = self.serving.lookup_template(stmt.key, values)
            self.metrics.record_plan_cache(template is not None)
            if (bool(cfg.get(SERVING_RESULT_CACHE)) and inline_results
                    and template is not None):
                rkey = self.serving.result_key(stmt.key, values, template.tables)
                cached = self.serving.lookup_result(rkey)
                self.metrics.record_result_cache(cached is not None)
                if cached is not None:
                    job = FastJob(job_id, job_name, sid, cfg, inline_result=cached)
                    with self._jobs_lock:
                        self.jobs[job_id] = job
                    self.metrics.record_completed(job_id, 0.0)
                    self._notify(job_id)
                    return job_id
            else:
                rkey = None
            if template is not None:
                bound = bind_physical(template.physical, values)
            else:
                # evicted, or non-bindable with new values: re-lift from
                # the retained SQL and bind at the logical level
                ctx = self.sessions.create_planning_context(sid)
                lift = lift_parameters(optimize(
                    SqlPlanner(ctx.catalog).plan_query(parse_sql(stmt.sql))))
                if not lift.cacheable or len(lift.values) != len(values):
                    raise PlanningError(
                        f"statement {statement_id} no longer parameterizes "
                        f"the same way ({lift.reason or 'slot count changed'})")
                bound = PhysicalPlanner(cfg).plan(bind_logical(lift.tagged, values))
                physical = PhysicalPlanner(cfg).plan(lift.tagged)
                bindable = set(range(len(values))) <= collect_physical_params(physical)
                template = PlanTemplate(
                    key=stmt.key, physical=physical, type_tags=lift.type_tags,
                    values=lift.values, tables=lift.tables, bindable=bindable)
                self.serving.store_template(template)
            physical, fill = self._incremental_or_plain(template, values, bound,
                                                        rkey, cfg)
            self.metrics.record_planning_ms(job_id, (time.time() - t0) * 1000)
            if physical is None:
                self.serving.store_result(rkey, fill.inline_result)
                return self._serve_inline(job_id, job_name, sid, cfg,
                                          fill.inline_result)
            return self._dispatch_serving(job_id, job_name, sid, cfg, physical,
                                          template, values, inline_results,
                                          fill=fill)
        except BaseException as e:  # noqa: BLE001 — same contract as _plan_job
            log.warning("execute_prepared failed for %s: %s", job_id, e, exc_info=True)
            with self._jobs_lock:
                g = ExecutionGraph(job_id, job_name, sid, [], cfg)
                g.status = JobState.FAILED
                g.error = f"planning failed: {e}"
                g.ended_at = time.time()
                self.jobs[job_id] = g
            self.metrics.record_failed(job_id)
            self._notify(job_id)
            return job_id

    def close_prepared(self, statement_id: str) -> None:
        self.serving.close_prepared(statement_id)

    def submit_physical_plan(self, plan, session_id: str, job_name: str = "") -> str:
        job_id = str(new_job_id())
        self._admit_or_shed(session_id, job_id)
        with self._jobs_lock:
            self.jobs[job_id] = ExecutionGraph(job_id, job_name, session_id, [],
                                               self.sessions.get(session_id))
            self.jobs[job_id].status = JobState.QUEUED
        self.metrics.record_submitted(job_id)
        self.post(Event("job_queued", (job_id, "physical", plan, session_id)))
        return job_id

    def _plan_job(self, payload) -> None:
        job_id, kind, body, session_id = payload
        t0 = time.time()
        try:
            ctx = self.sessions.create_planning_context(session_id)
            if kind == "sql":
                df = ctx.sql(body)
                physical = ctx.create_physical_plan(df.plan)
            else:
                physical = body
            physical = self._graft_deltas(physical)
            stages = DistributedPlanner(job_id).plan_query_stages(physical)
            cfg = self.sessions.get(session_id) or BallistaConfig()
            from ballista_tpu_torch.scheduler.planner import merge_mesh_stages

            stages = merge_mesh_stages(stages, cfg)
            self._maybe_verify_stages(stages, cfg, job_id)
            old = self.jobs.get(job_id)
            graph = ExecutionGraph(job_id, old.job_name if old else "", session_id, stages, cfg)
            with self._jobs_lock:
                self.jobs[job_id] = graph
            if self.job_state.acquire(job_id, self.scheduler_id):
                self.job_state.save_graph(graph)
            else:
                # never clobber a peer's checkpoint on an id collision
                log.warning("job %s is owned by another scheduler; not persisting", job_id)
            self.metrics.record_planning_ms(job_id, (time.time() - t0) * 1000)
            self.post(Event("revive", job_id))
        except BaseException as e:  # noqa: BLE001
            log.warning("planning failed for %s: %s", job_id, e, exc_info=True)
            with self._jobs_lock:
                g = self.jobs.get(job_id)
                if g is not None:
                    g.status = JobState.FAILED
                    g.error = f"planning failed: {e}"
                    g.ended_at = time.time()
            self.metrics.record_failed(job_id)
            self._notify(job_id)

    # -- scheduling (push mode) -------------------------------------------------

    def _running_jobs_rotated(self, shard: SchedulerShard | None = None) -> list:
        """Round-robin fairness across jobs: each offer starts at a rotating
        position, so a long job can no longer starve later submissions
        (the reference round-robins offers across jobs). With a shard scope,
        only that shard's slice is enumerated — the offer scan is O(jobs/N)
        per event instead of O(jobs)."""
        with self._jobs_lock:
            running = [g for g in self.jobs.values() if g.status is JobState.RUNNING]
            if shard is not None and self.num_shards > 1:
                running = [g for g in running if shard.owns(g.job_id)]
            if len(running) > 1:
                off = self._job_rr % len(running)
                self._job_rr += 1
                running = running[off:] + running[:off]
        return running

    def _offer_reservation(self, shard: SchedulerShard | None = None) -> None:
        """Bind runnable tasks to free executor slots and launch them
        (state/mod.rs:181-221: offer → bind → launch → unbind leftovers).
        Launches leave the event loop immediately: one slow executor's gRPC
        round trip must never stall scheduling for the rest of the cluster
        (the reference spawns launch_tasks). The slot ledger is shared, so
        concurrent shard offers stay safe."""
        if self.launcher is None:
            return
        running = self._running_jobs_rotated(shard)
        demand = sum(g.available_task_count() for g in running)
        if demand == 0:
            return
        self._offer_probes(running)
        if self.executors.task_distribution == "consistent-hash":
            self._offer_consistent(running)
            return
        reservations = self.executors.reserve_slots(demand)
        for executor_id, count in reservations:
            tasks: list[TaskDescription] = []
            for g in running:
                while len(tasks) < count:
                    t = g.pop_next_task(executor_id)
                    if t is None:
                        break
                    tasks.append(t)
                if len(tasks) >= count:
                    break
            unused = count - len(tasks)
            if unused:
                self.executors.free_slot(executor_id, unused)
            if tasks:
                self._spawn_launch(executor_id, tasks)

    def _offer_probes(self, running: list) -> None:
        """Bind ONE real task to each quarantined executor whose probe
        backoff elapsed; its outcome decides re-admission vs re-quarantine."""
        for executor_id, _count in self.executors.probe_reservations():
            probe: list[TaskDescription] = []
            for g in running:
                t = g.pop_next_task(executor_id)
                if t is not None:
                    probe.append(t)
                    break
            if probe:
                log.info("probing quarantined executor %s with task %d", executor_id, probe[0].task_id)
                self._spawn_launch(executor_id, probe)
            else:
                # nothing to bind: cancel_probe returns the slot itself
                self.executors.cancel_probe(executor_id)

    def _offer_consistent(self, running: list) -> None:
        """Consistent-hash binding: each task's (job, stage, partition)
        identity picks its executor on the ring — sticky placement."""
        by_exec: dict[str, list[TaskDescription]] = {}
        for g in running:
            while True:
                peek = g.pop_next_task("")  # bound to a concrete executor below
                if peek is None:
                    break
                key = f"{peek.job_id}/{peek.stage_id}/{peek.partitions[0] if peek.partitions else 0}"
                executor_id = self.executors.pick_consistent(key)
                if executor_id is None:
                    # no free slot anywhere: return the work and stop
                    g.return_task(peek)
                    break
                g.reassign_running(peek.task_id, peek.stage_id, executor_id)
                by_exec.setdefault(executor_id, []).append(peek)
        for executor_id, tasks in by_exec.items():
            self._spawn_launch(executor_id, tasks)

    def _spawn_launch(self, executor_id: str, tasks: list[TaskDescription]) -> None:
        def run():
            try:
                self.launcher.launch(executor_id, tasks, self)
            except Exception as e:  # noqa: BLE001
                log.warning("launch to %s failed: %s", executor_id, e)
                self.post(Event("executor_lost", executor_id))

        threading.Thread(target=run, daemon=True, name=f"launch-{executor_id}").start()

    # -- pull mode ---------------------------------------------------------------

    def poll_work(self, metadata: ExecutorMetadata, can_accept: bool, free_slots: int,
                  results: list[TaskResult]) -> list[TaskDescription]:
        """PollWork doubles as heartbeat + status sink + task source
        (scheduler_server/grpc.rs:92)."""
        if not self.executors.heartbeat(metadata.id):
            self.executors.register(metadata)
        if results:
            fast, results = self._split_fast(results)
            if fast:
                self._fast_update(metadata.id, fast)
        if results:
            # frees the ledger slots taken at handout below
            self._apply_task_updates(metadata.id, results, free_slots_managed=True)
        out: list[TaskDescription] = []
        if can_accept:
            # debit the SHARED slot ledger for pull handouts, or a mixed
            # push+pull cluster double-books the same vcores
            granted = self.executors.take_slots(metadata.id, free_slots)
            running = self._running_jobs_rotated()
            for g in running:
                while len(out) < granted:
                    t = g.pop_next_task(metadata.id)
                    if t is None:
                        break
                    out.append(t)
                if len(out) >= granted:
                    break
            if granted > len(out):
                self.executors.free_slot(metadata.id, granted - len(out))
        return out

    # -- status ingestion ----------------------------------------------------------

    def update_task_status(self, executor_id: str, results: list[TaskResult]) -> None:
        fast, rest = self._split_fast(results)
        if fast:
            # fast-lane results complete on the reporting thread: the whole
            # point of the lane is that short queries never wait behind the
            # event-loop queue
            self._fast_update(executor_id, fast)
        if rest:
            self.post(Event("task_update", (executor_id, rest)))

    def _split_fast(self, results: list[TaskResult]) -> tuple[list, list]:
        with self._jobs_lock:
            fast_ids = set(self._fast_jobs)
        fast = [r for r in results if r.job_id in fast_ids]
        rest = [r for r in results if r.job_id not in fast_ids]
        return fast, rest

    def _fast_update(self, executor_id: str, results: list[TaskResult]) -> None:
        for r in results:
            self.executors.free_slot(executor_id, 1)
            if r.state in ("success", "failed"):
                transition = self.executors.record_task_result(
                    executor_id, ok=(r.state == "success"),
                    timed_out=bool(getattr(r, "timed_out", False)))
                if transition is not None:
                    self.metrics.set_quarantined_executors(self.executors.quarantined_count())
            with self._jobs_lock:
                job = self._fast_jobs.get(r.job_id)
            if job is None:
                continue
            outcome = job.on_result(r)
            if outcome == "finished":
                with self._jobs_lock:
                    self._fast_jobs.pop(r.job_id, None)
                self.metrics.record_completed(job.job_id, time.time() - job.queued_at)
                self._maybe_cache_result(job)
                with self._jobs_lock:
                    self._rc_render_pending.discard(job.job_id)
                self._notify(job.job_id)
            elif outcome == "failed":
                self._fast_fallback(job, job.error)
        self.post(Event("revive"))  # freed slots may unblock queued graph work

    def _fast_fallback(self, job: FastJob, reason: str) -> None:
        """Demote a failed/timed-out fast job to an ordinary execution
        graph built from the same stages — it gets retries, speculation,
        and deadline sweeps like any other job. Idempotent per job."""
        with self._jobs_lock:
            if self._fast_jobs.pop(job.job_id, None) is None:
                return  # raced another fallback / completion
            graph = ExecutionGraph(job.job_id, job.job_name, job.session_id,
                                   job.demote(), job.config)
            self.jobs[job.job_id] = graph
            if job.rc_key is not None:
                # the graph path finishes the fill the fast job carried
                self._rc_pending[job.job_id] = job.rc_key
        self.serving.note_fast_lane("fallback")
        self.metrics.record_fast_lane("fallback")
        log.warning("fast lane fell back to full DAG for %s: %s",
                    job.job_id, reason.splitlines()[0][:200] if reason else "timeout")
        self.post(Event("revive", job.job_id))

    def _maybe_cache_result(self, job: FastJob) -> None:
        """Fetch a finished fast job's partitions and finish its fill
        (cache store + any incremental render), also serving THIS
        submission inline (the fetch already ran). Runs before the
        terminal notify, so incremental outputs never leak raw."""
        fill = job.rc_key
        if fill is None:
            return
        try:
            from ballista_tpu_torch.client.context import fetch_job_results

            tbl = fetch_job_results(job.job_status(), job.config)
            job.inline_result = self._finish_fill(fill, tbl, job.config)
        except Exception as e:  # noqa: BLE001 — plain cache fill is best-effort
            if fill.kind != "plain":
                # the fetched bytes are accumulator state / delta rows,
                # not the answer: fail rather than serve them
                job.status = JobState.FAILED
                job.error = f"incremental render failed: {e}"
                log.warning("incremental render for %s failed: %s", job.job_id, e)
            else:
                log.debug("result-cache fill for %s failed: %s", job.job_id, e)

    def _fill_result_cache_from_graph(self, g) -> bool:
        """Graph-path fill: on job_finished, fetch the final partitions off
        the event loop and finish the fill. Returns True when the job's
        terminal notify is DEFERRED to the fill thread — incremental
        state/append outputs must render into `g.inline_result` before
        clients observe success (`job_status` masks until then)."""
        with self._jobs_lock:
            fill = self._rc_pending.pop(g.job_id, None)
        if fill is None:
            return False
        deferred = fill.kind != "plain"

        def run():
            try:
                from ballista_tpu_torch.client.context import fetch_job_results

                tbl = fetch_job_results(g.job_status(), g.config)
                result = self._finish_fill(fill, tbl, g.config)
                if deferred:
                    g.inline_result = result
            except Exception as e:  # noqa: BLE001
                if deferred:
                    g.status = JobState.FAILED
                    g.error = f"incremental render failed: {e}"
                    log.warning("incremental render for %s failed: %s", g.job_id, e)
                else:
                    log.debug("result-cache fill for %s failed: %s", g.job_id, e)
            finally:
                if deferred:
                    with self._jobs_lock:
                        self._rc_render_pending.discard(g.job_id)
                    self._notify(g.job_id)

        threading.Thread(target=run, daemon=True, name="result-cache-fill").start()
        return deferred

    def _apply_task_updates(self, executor_id: str, results: list[TaskResult],
                            free_slots_managed: bool = True) -> None:
        for r in results:
            if free_slots_managed:
                self.executors.free_slot(executor_id, 1)
            timed_out = bool(getattr(r, "timed_out", False))
            # cancelled tasks say nothing about executor health; success and
            # failure (incl. timeout) feed the decayed quarantine score
            if r.state in ("success", "failed"):
                if timed_out:
                    self.metrics.record_task_timeout(executor_id)
                transition = self.executors.record_task_result(
                    executor_id, ok=(r.state == "success"), timed_out=timed_out)
                if transition is not None:
                    log.warning("executor %s %s (failure_rate over window: %s)",
                                executor_id, transition,
                                self.executors.health_snapshot().get(executor_id, {}).get("failure_rate"))
                    self.metrics.set_quarantined_executors(self.executors.quarantined_count())
            fetch_cause = str(getattr(r, "fetch_failed_cause", "") or "")
            if fetch_cause == "corruption" and r.fetch_failed_executor_id:
                # blame the SERVING executor, not the fetcher: its stored
                # bytes failed verification twice. Repeated strikes push it
                # through the same quarantine machinery as task failures.
                transition = self.executors.record_corruption_strike(
                    r.fetch_failed_executor_id)
                log.warning(
                    "corruption strike against executor %s (reported by %s, "
                    "%s/%s)%s", r.fetch_failed_executor_id, executor_id,
                    r.job_id, r.fetch_failed_stage_id,
                    f" — {transition}" if transition else "")
                if transition is not None:
                    self.metrics.set_quarantined_executors(
                        self.executors.quarantined_count())
            with self._jobs_lock:
                g = self.jobs.get(r.job_id)
            if g is None:
                continue
            events = g.update_task_status(
                r.task_id, r.stage_id, r.stage_attempt, r.state, r.partitions,
                r.locations, r.error, r.retryable, r.metrics,
                r.fetch_failed_executor_id, r.fetch_failed_stage_id,
                timed_out=timed_out, fetch_failed_cause=fetch_cause,
            )
            if events:
                # checkpoint the graph at every stage/terminal transition:
                # the durable unit is the materialized shuffle output, so a
                # recovering scheduler resumes from the last finished stage
                self.job_state.save_graph(g)
            for ev in events:
                if ev == "job_finished":
                    self.metrics.record_completed(g.job_id, time.time() - g.queued_at)
                    if not self._fill_result_cache_from_graph(g):
                        self._notify(g.job_id)
                elif ev == "job_failed":
                    self.metrics.record_failed(g.job_id)
                    self._notify(g.job_id)
            self._push_cancellations(g)

    def _push_cancellations(self, g) -> None:
        """Fan CancelTasks out to the executors running tasks that
        incremental replanning (or a job cancel) obsoleted. Off the event
        loop: a dead executor's rpc timeout must not stall scheduling."""
        doomed = g.drain_cancelled_tasks()
        if not doomed or self.launcher is None:
            return
        by_exec: dict[str, list[tuple[int, int]]] = {}
        for executor_id, task_id, stage_id in doomed:
            by_exec.setdefault(executor_id, []).append((task_id, stage_id))

        def run():
            for executor_id, items in by_exec.items():
                try:
                    self.launcher.cancel_tasks(executor_id, g.job_id, items, self)
                except Exception as e:  # noqa: BLE001 — best-effort; expiry sweeps catch leaks
                    log.warning("CancelTasks to %s failed: %s", executor_id, e)

        threading.Thread(target=run, daemon=True, name="cancel-push").start()

    # -- straggler defense -------------------------------------------------------------

    def _sweep_stragglers(self, shard: SchedulerShard | None = None) -> None:
        """Event-loop sweep: (1) expire tasks past deadline+grace (backstop
        for executors too wedged to self-report the timeout), (2) launch
        speculative duplicates of a nearly-done stage's slowest tasks on a
        DIFFERENT executor, (3) re-offer when quarantine probes come due.
        Each shard sweeps only the jobs it owns; fleet-scoped work (lease
        expiry, admission update) runs once, on shard 0."""
        now = time.time()
        scoped = shard is not None and self.num_shards > 1
        with self._jobs_lock:
            fast = list(self._fast_jobs.values())
            running = [g for g in self.jobs.values()
                       if g.status is JobState.RUNNING and not isinstance(g, FastJob)]
            if scoped:
                fast = [j for j in fast if shard.owns(j.job_id)]
                running = [g for g in running if shard.owns(g.job_id)]
        for job in fast:
            # backstop for fast jobs whose executor died or wedged: demote
            # to a full graph, which has retries and deadline machinery
            if job.expired(now, float(job.config.get(SERVING_FAST_LANE_TIMEOUT_S))):
                self._fast_fallback(job, "fast-lane timeout")
        for g in running:
            expired, job_failed = g.expire_overdue_tasks(now)
            if expired:
                for executor_id, task_id, stage_id in expired:
                    log.warning("task %d of %s/%d on %s expired past deadline",
                                task_id, g.job_id, stage_id, executor_id)
                    self.executors.free_slot(executor_id, 1)
                    self.metrics.record_task_timeout(executor_id)
                    self.executors.record_task_result(executor_id, ok=False, timed_out=True)
                self._push_cancellations(g)
                if job_failed:
                    self.job_state.save_graph(g)
                    self.metrics.record_failed(g.job_id)
                    self._notify(g.job_id)
                else:
                    # expired partitions re-pended on this specific graph
                    self.post(Event("revive", g.job_id))
            if self.launcher is None:
                continue  # speculation is push-only; pull executors can't be targeted
            for stage_id, task_id, victim in g.speculation_candidates(now):
                executor_id = self.executors.reserve_one_avoiding({victim})
                if executor_id is None:
                    break  # no healthy slot anywhere else; retry next sweep
                task = g.register_speculative(stage_id, task_id, executor_id)
                if task is None:
                    self.executors.free_slot(executor_id, 1)
                    continue
                log.info("speculative attempt %d of %s/%d task %d → %s (straggling on %s)",
                         task.task_id, g.job_id, stage_id, task_id, executor_id, victim)
                self.metrics.record_speculative_launched(g.job_id, stage_id)
                self._spawn_launch(executor_id, [task])
        # cross-shard slot-release backstop: slots freed by another shard's
        # completions (or by lease expiry) generate no event on this shard,
        # so every sweep re-offers this shard's slice; zero demand exits in
        # one pass over the scoped jobs
        if scoped:
            self._offer_reservation(shard)
        if shard is not None and shard.shard_id != 0:
            return  # fleet-scoped sweep work below runs once per round
        if self.executors.probes_due():
            self._offer_reservation(shard)
        self._sweep_leases(now)
        self._sweep_job_data_ttl(now)
        self.metrics.set_quarantined_executors(self.executors.quarantined_count())
        pressure = self.executors.aggregate_pressure()
        transition = self.admission.update(self._loop_lag_s, pressure)
        if transition is not None:
            log.warning("overload state -> %s (inflight=%d, loop_lag=%.2fs, memory_pressure=%.2f)",
                        transition, self.admission.depth(), self._loop_lag_s, pressure)
            self.metrics.set_overload_state(transition)
            if transition in ("shedding", "draining"):
                # give the shed its headroom: drop the serving caches so
                # memory-pressure recovery isn't fighting cached results
                self.serving.clear()

    def _sweep_job_data_ttl(self, now: float) -> None:
        """Orphaned-data GC, scheduler-driven half (docs/lifecycle.md#gc):
        terminal jobs past their `ballista.executor.data.ttl.seconds` get
        their scheduler state dropped and a shuffle-GC RPC fanned out over
        the existing remove_job_data seam. Per-job TTL (it is a session
        knob); 0 disables. Bounded work: clean_job_data fans the executor
        RPCs off-thread, so the sweep itself never blocks the loop."""
        from ballista_tpu_torch.config import EXECUTOR_DATA_TTL_S

        with self._jobs_lock:
            terminal = [g for g in self.jobs.values()
                        if g.status in (JobState.SUCCESSFUL, JobState.FAILED,
                                        JobState.CANCELLED)
                        and not isinstance(g, FastJob)]
        for g in terminal:
            try:
                ttl = float(g.config.get(EXECUTOR_DATA_TTL_S))
            except Exception:  # noqa: BLE001 — a broken config must not kill the sweep
                continue
            ended = float(g.ended_at or 0.0)
            if ttl <= 0 or not ended or now - ended < ttl:
                continue
            log.info("job %s terminal for %.0fs (ttl %.0fs): sweeping its data",
                     g.job_id, now - ended, ttl)
            self.lifecycle_stats["gc_swept_jobs"] += 1
            self.clean_job_data(g.job_id)

    # -- executor lifecycle -----------------------------------------------------------

    def register_executor(self, metadata: ExecutorMetadata) -> None:
        self.executors.register(metadata)
        self.post(Event("revive"))

    def executor_heartbeat(self, executor_id: str,
                           metrics: dict[str, float] | None = None) -> bool:
        """Heartbeat + overload-signal ingestion. `metrics` is the decoded
        HeartBeatParams.metrics map (memory_pressure et al.); the
        pressure feeds the admission state machine on the next sweep.
        Fans in ONCE: shards never see heartbeats directly — executor
        state lives in the shared ExecutorManager, and only the derived
        executor_lost events multicast."""
        self._fanin["heartbeats"] += 1
        if metrics and metrics.get("pressure_rejections"):
            # gauge, not delta: only count growth over the last report
            prev = self.executors.get(executor_id)
            prev_n = prev.pressure_rejections if prev is not None else 0.0
            grown = int(metrics["pressure_rejections"] - prev_n)
            for _ in range(max(0, grown)):
                self.metrics.record_pressure_rejection(executor_id)
        known = self.executors.heartbeat(executor_id, metrics)
        if known and metrics and float(metrics.get("lifecycle_draining", 0.0)) >= 1.0:
            # SIGTERM-initiated drain announcement: run the drain state
            # machine off-thread (it waits on running tasks and migrates
            # files — never on a caller's RPC thread or the event loop)
            self._spawn_drain(executor_id)
        return known

    # -- drain state machine (docs/lifecycle.md#drain-protocol) ---------------

    def _spawn_drain(self, executor_id: str) -> None:
        with self._drain_lock:
            if executor_id in self._drains_inflight:
                return
            self._drains_inflight.add(executor_id)

        def run():
            try:
                self.drain_executor(executor_id)
            except Exception:  # noqa: BLE001 — a died drain must not leak the guard
                log.exception("drain of %s failed", executor_id)
            finally:
                with self._drain_lock:
                    self._drains_inflight.discard(executor_id)

        threading.Thread(target=run, daemon=True, name=f"drain-{executor_id}").start()

    def _executor_has_running(self, executor_id: str) -> bool:
        with self._jobs_lock:
            graphs = [g for g in self.jobs.values()
                      if g.status is JobState.RUNNING and not isinstance(g, FastJob)]
        for g in graphs:
            with g._lock:
                for s in g.stages.values():
                    if any(t.executor_id == executor_id for t in s.running.values()):
                        return True
        return False

    def _locations_on(self, executor_id: str) -> list:
        """Every completed PartitionLocation a draining executor still
        holds — across RUNNING graphs (partial stage outputs included: a
        running stage's finished map tasks are exactly what downstream
        readers will fetch) and SUCCESSFUL ones (clients fetch final-stage
        partitions after the job ends)."""
        out = []
        with self._jobs_lock:
            graphs = [g for g in self.jobs.values()
                      if g.status in (JobState.RUNNING, JobState.SUCCESSFUL)
                      and not isinstance(g, FastJob)]
        for g in graphs:
            with g._lock:
                for s in g.stages.values():
                    for locs in s.completed.values():
                        out.extend(l for l in locs if l.executor_id == executor_id)
        return out

    def drain_executor(self, executor_id: str, timeout_s: float | None = None) -> dict:
        """Graceful decommission (docs/lifecycle.md): stop offering to the
        executor, revoke its direct-dispatch leases, wait (bounded) for its
        running tasks, hand its map outputs off to a survivor, then retire
        it with a `drained` ledger entry. The closing `executor_lost` event
        is the safety net: fully migrated locations no longer name the
        executor (zero stage reruns), while anything left behind — hard
        kill mid-migration, no survivor, launcher without a migration
        path — recomputes through today's recovery machinery, byte-
        identical. MUST run off the event loop (it sleeps)."""
        slot = self.executors.get(executor_id)
        if slot is None or not self.executors.begin_drain(executor_id):
            return {"executor_id": executor_id, "status": "unknown"}
        log.info("draining executor %s", executor_id)
        self.lifecycle_stats["drains"] += 1
        for lease in [l for l in self.leases.active() if l.executor_id == executor_id]:
            self.revoke_executor_lease(lease.lease_id)
        if timeout_s is None:
            from ballista_tpu_torch.config import EXECUTOR_DRAIN_TIMEOUT_S

            timeout_s = float(BallistaConfig().get(EXECUTOR_DRAIN_TIMEOUT_S))
        deadline = time.time() + max(0.0, timeout_s)
        while time.time() < deadline and self._executor_has_running(executor_id):
            time.sleep(0.05)
        locations = self._locations_on(executor_id)
        migrated = migrated_bytes = 0
        status = "drained"
        if locations and self.launcher is not None:
            survivors = [e for e in self.executors.alive_executors()
                         if e.schedulable and e.metadata.id != executor_id]
            if survivors:
                dest = max(survivors, key=lambda e: e.free_slots)
                try:
                    migrated, migrated_bytes = self.launcher.migrate_partitions(
                        executor_id, dest.metadata.id, locations, self)
                except Exception as e:  # noqa: BLE001 — hard-kill fallback is the contract
                    status = "drain-killed"
                    self.lifecycle_stats["drain_kills"] += 1
                    log.warning("drain of %s died mid-migration (%s); unmigrated "
                                "outputs fall back to recompute", executor_id, e)
            else:
                log.warning("drain of %s found no survivor; %d locations fall "
                            "back to recompute", executor_id, len(locations))
        if migrated:
            log.info("drain of %s migrated %d/%d locations (%d bytes)",
                     executor_id, migrated, len(locations), migrated_bytes)
        self.lifecycle_stats["migrated_partitions"] += migrated
        self.lifecycle_stats["migrated_bytes"] += migrated_bytes
        self.executors.mark_drained(executor_id, migrated, migrated_bytes, reason=status)
        # safety net + remainder recovery: locations rewritten by the
        # migration no longer match the lost executor id
        self.post(Event("executor_lost", executor_id))
        return {"executor_id": executor_id, "status": status,
                "locations": len(locations), "migrated_partitions": migrated,
                "migrated_bytes": migrated_bytes}

    def _on_executor_lost(self, executor_id: str,
                          shard: SchedulerShard | None = None) -> None:
        # deregister is idempotent: the event multicasts, every shard rolls
        # back only its own jobs' stages
        self.executors.deregister(executor_id)
        with self._jobs_lock:
            graphs = list(self.jobs.values())
            if shard is not None and self.num_shards > 1:
                graphs = [g for g in graphs if shard.owns(g.job_id)]
        for g in graphs:
            n = g.reset_stages_on_lost_executor(executor_id)
            if n:
                log.info("rolled back %d task/stage units of %s after losing %s", n, g.job_id, executor_id)

    def check_expired_executors(self) -> None:
        for eid in self.executors.expire_dead():
            log.warning("executor %s expired (no heartbeat)", eid)
            self.post(Event("executor_lost", eid))

    def resubmit_stuck_jobs(self) -> None:
        """ballista.scheduler.job.resubmit.interval.ms: periodically re-offer
        jobs holding runnable-but-unscheduled tasks (missed offers, executors
        that freed slots without an event, scale-out while idle) — the
        reference's job-resubmit behavior for jobs that couldn't schedule.
        In a multi-scheduler deployment this is also the orphan reviver:
        jobs whose owner died mid-flight sit in the shared store with a
        stale lease until a live peer's sweep adopts them here."""
        from ballista_tpu_torch.config import JOB_RESUBMIT_INTERVAL_MS

        try:
            orphans = self.recover_jobs(only_active=True)
        except Exception:  # noqa: BLE001 — a wedged store must not kill the sweep
            log.exception("orphan recovery sweep failed")
            orphans = []
        for job_id in orphans:
            log.warning("adopted orphaned job %s (owner lease expired)", job_id)
        with self._jobs_lock:
            running = [g for g in self.jobs.values() if g.status is JobState.RUNNING]
        stuck = []
        for g in running:
            interval = int(g.config.get(JOB_RESUBMIT_INTERVAL_MS))
            if interval > 0 and g.available_task_count() > 0:
                stuck.append(g)
        if not stuck:
            return
        # diagnose WHY work sat unscheduled, so an overload incident is
        # readable from logs alone: every slot busy (no-capacity) vs slots
        # exist but their executors are quarantined (quarantine-starved)
        alive = self.executors.alive_executors()
        free_any = sum(e.free_slots for e in alive)
        free_healthy = sum(e.free_slots for e in alive if e.schedulable)
        if free_any == 0:
            reason = "no-capacity"
        elif free_healthy == 0:
            reason = "quarantine-starved"
        else:
            reason = "missed-offer"
        for g in stuck:
            log.info("resubmitting stuck job %s (%d runnable tasks, cause: %s)",
                     g.job_id, g.available_task_count(), reason)
        self.post(Event("revive"))

    # -- direct-dispatch leases ----------------------------------------------------------

    def mint_executor_lease(self, session_id: str, slots: int | None = None,
                            ttl_s: float | None = None,
                            band_size: int | None = None) -> "ExecutorLease | None":
        """Mint a revocable direct-dispatch lease on ONE warm executor: a
        capacity slice (slots), an expiry, and a reserved task-id band.
        Slots come out of the shared ledger up front, so graph scheduling
        and direct dispatch can never oversubscribe the same executor.
        Returns None (and counts a denial) when no single executor has
        the headroom — callers fall back to the scheduled path."""
        want = DEFAULT_LEASE_SLOTS if slots is None else max(1, int(slots))
        ttl = DEFAULT_LEASE_TTL_S if ttl_s is None else float(ttl_s)
        candidates = [e for e in self.executors.alive_executors()
                      if e.schedulable and e.free_slots >= want]
        if not candidates:
            self.leases.denied += 1
            return None
        best = max(candidates, key=lambda e: e.free_slots)
        eid = best.metadata.id
        if self.executors.take_slots(eid, want) < want:
            self.leases.denied += 1
            return None
        lease = self.leases.mint(
            executor_id=eid, host=best.metadata.host,
            flight_port=best.metadata.flight_port, session_id=session_id,
            slots=want, ttl_s=ttl, band_size=band_size)
        self.metrics.record_lease("minted")
        if self.launcher is not None:
            try:
                self.launcher.grant_lease(eid, lease, self)
            except Exception as e:  # noqa: BLE001 — executor admits nothing it wasn't granted
                log.warning("lease grant push to %s failed: %s", eid, e)
                self.executors.free_slot(eid, want)
                self.leases.revoke(lease.lease_id)
                self.leases.denied += 1
                return None
        return lease

    def revoke_executor_lease(self, lease_id: str) -> bool:
        """Revoke a lease: return its slots to the ledger and push the
        revocation to the executor off-thread (best effort — the
        executor-side expiry check is the backstop)."""
        lease = self.leases.revoke(lease_id)
        if lease is None:
            return False
        self.executors.free_slot(lease.executor_id, lease.slots)
        self.metrics.record_lease("revoked")
        self._push_lease_revocations([lease])
        # graph work queued behind the leased slots sees no other event
        # (ROADMAP C20)
        self.post(Event("revive"))
        return True

    def _sweep_leases(self, now: float) -> None:
        """Sweep-time backstop: expired leases return their slots and get a
        best-effort revocation push (clients normally stop first — the
        token itself rejects past expiry)."""
        expired = self.leases.expire(now)
        for lease in expired:
            self.executors.free_slot(lease.executor_id, lease.slots)
            self.metrics.record_lease("expired")
        if expired:
            self._push_lease_revocations(expired)
            self.post(Event("revive"))

    def _push_lease_revocations(self, leases: list) -> None:
        if self.launcher is None:
            return

        def run():
            for lease in leases:
                try:
                    self.launcher.revoke_lease(lease.executor_id, lease.lease_id, self)
                except Exception as e:  # noqa: BLE001 — expiry at the executor is the backstop
                    log.debug("lease revoke push to %s failed: %s", lease.executor_id, e)

        threading.Thread(target=run, daemon=True, name="lease-revoke-push").start()

    def reconcile_direct_dispatch(self, record: dict) -> None:
        """Asynchronous reconciliation: the client already has its bytes;
        the scheduler just folds the completed direct-dispatch work into
        its ledgers (job accounting, KEDA counters) after the fact."""
        tasks = int(record.get("tasks", 1))
        self.leases.note_reconciled(record.get("lease_id"), tasks)
        self.metrics.record_direct_dispatch("reconciled")

    # -- job control ---------------------------------------------------------------------

    def _cancel_job(self, job_id: str) -> None:
        with self._jobs_lock:
            g = self.jobs.get(job_id)
        if g is not None:
            g.cancel()
            self._push_cancellations(g)
            self.job_state.save_graph(g)  # terminal transition: checkpoint
            self.metrics.record_cancelled(job_id)
            self._notify(job_id)

    def cancel_job(self, job_id: str) -> None:
        self.post(Event("cancel", job_id))

    def job_status(self, job_id: str) -> dict | None:
        with self._jobs_lock:
            g = self.jobs.get(job_id)
            pending_render = job_id in self._rc_render_pending
        if g is None:
            return None
        st = g.job_status()
        if pending_render and st.get("state") == "successful":
            # an incremental fill owns the terminal transition: the stage
            # partitions hold raw accumulator state, not the result —
            # clients must keep polling until the render attaches it
            st = dict(st)
            st["state"] = "running"
            st.pop("partitions", None)
        return st

    def wait_for_job(self, job_id: str, timeout: float = 300.0) -> dict:
        ev = threading.Event()
        with self._jobs_lock:
            self._watchers.setdefault(job_id, []).append(ev)
        st = self.job_status(job_id)
        if st is not None and st["state"] in ("successful", "failed", "cancelled"):
            return st
        deadline = time.time() + timeout
        while time.time() < deadline:
            if ev.wait(timeout=0.5):
                break
            st = self.job_status(job_id)
            if st and st["state"] in ("successful", "failed", "cancelled"):
                break
        st = self.job_status(job_id)
        if st is None:
            raise BallistaError(f"unknown job {job_id}")
        return st

    def _notify(self, job_id: str) -> None:
        # _notify fires on every terminal transition (finished / failed /
        # cancelled / planning error), so it doubles as the single release
        # point for the job's admission slot; finish() is idempotent.
        self.admission.finish(job_id)
        with self._jobs_lock:
            for ev in self._watchers.pop(job_id, []):
                ev.set()

    def clean_job_data(self, job_id: str) -> None:
        """Drop scheduler-side job state AND fan a shuffle-GC rpc out to
        every live executor (reference: ExecutorManager::clean_up_job_data,
        state/executor_manager.rs — otherwise shuffle files linger until
        the work-dir TTL sweep)."""
        with self._jobs_lock:
            self.jobs.pop(job_id, None)
            self._fast_jobs.pop(job_id, None)
            self._rc_pending.pop(job_id, None)
            self._rc_render_pending.discard(job_id)
        self.admission.finish(job_id)  # backstop; no-op if already released
        self.job_state.remove_job(job_id)
        if self.launcher is None:
            return
        executors = [e.metadata.id for e in self.executors.alive_executors()]

        def run():
            for executor_id in executors:
                try:
                    self.launcher.remove_job_data(executor_id, job_id, self)
                except Exception as e:  # noqa: BLE001 — TTL sweep catches leftovers
                    log.debug("RemoveJobData to %s failed: %s", executor_id, e)

        threading.Thread(target=run, daemon=True, name="job-gc").start()

    # -- fail-over recovery ------------------------------------------------

    def recover_jobs(self, force: bool = False,
                     only_active: bool = False) -> list[str]:
        """Adopt persisted job graphs (scheduler restart / standby takeover).
        Successful stages resume from their materialized shuffle outputs;
        mid-flight work recomputes. Jobs owned by a LIVE peer are skipped
        unless force (the reference's JobAcquired/JobReleased arbitration,
        cluster/mod.rs:221). `only_active` is the periodic orphan sweep in
        a multi-scheduler deployment: adopt only non-terminal jobs whose
        owner's lease went stale (a peer died mid-job), and release
        terminal graphs back rather than hoarding them."""
        recovered = []
        for job_id in self.job_state.list_jobs():
            with self._jobs_lock:
                if job_id in self.jobs:
                    continue
            if not self.job_state.acquire(job_id, self.scheduler_id, force=force):
                if not only_active:
                    log.info("job %s owned by another scheduler; skipping", job_id)
                continue
            g = self.job_state.load_graph(job_id)
            if g is None:
                continue
            if only_active and g.status in (
                    JobState.SUCCESSFUL, JobState.FAILED, JobState.CANCELLED):
                self.job_state.release(job_id, self.scheduler_id)
                continue
            with self._jobs_lock:
                self.jobs[job_id] = g
            # re-register the session so later planning/launches see the
            # job's settings (the graph proto carries the config snapshot)
            self.sessions.create_or_update(g.config.to_key_value_pairs(), g.session_id)
            recovered.append(job_id)
            log.info("recovered job %s (status=%s)", job_id, g.status.value)
        if recovered:
            self.post(Event("revive"))
        return recovered
