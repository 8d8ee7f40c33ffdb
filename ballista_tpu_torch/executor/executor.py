"""Executor core: run one query-stage task and publish shuffle outputs.

Rebuild of Executor::execute_query_stage + the ExecutionEngine seam
(ballista/executor/src/executor.rs:226, execution_engine.rs:51):

- `ExecutionEngine.create_query_stage_exec` prepares a stage plan for this
  executor: stamps the work dir, and (tpu engine) compiles supported
  subtrees into device stages on the CUDA card (engine/cuda_engine.py);
- `execute_query_stage` drives the stage's ShuffleWriterExec for every
  partition in the task's slice, converts metadata batches to
  PartitionLocations (zero-byte outputs dropped — the reference's
  sentinel rule, execution_engine.rs:336), catches panics, and returns a
  TaskStatus-shaped result;
- cancellation via a cooperative flag checked between partitions.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import traceback
from dataclasses import dataclass, field

from ballista_tpu_torch.config import EXECUTOR_ENGINE, BallistaConfig
from ballista_tpu_torch.errors import BallistaError, Cancelled, error_to_proto_kind
from ballista_tpu_torch.ids import ExecutorId, new_executor_id
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext, collect_metrics
from ballista_tpu_torch.scheduler.state.execution_graph import TaskDescription
from ballista_tpu_torch.shuffle.types import PartitionLocation
from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec, metadata_to_locations
from ballista_tpu_torch.version import WIRE_PROTOCOL_VERSION

log = logging.getLogger(__name__)


@dataclass
class ExecutorMetadata:
    id: str
    host: str = "localhost"
    grpc_port: int = 0
    flight_port: int = 0
    vcores: int = 4
    wire_version: str = WIRE_PROTOCOL_VERSION
    # chip this executor is pinned to (-1 = unpinned); when pinned with
    # engine=tpu the daemon defaults vcores to 1 so scheduler slots = chips
    device_ordinal: int = -1


@dataclass
class TaskResult:
    task_id: int
    job_id: str
    stage_id: int
    stage_attempt: int
    partitions: list[int]
    state: str  # success | failed | cancelled
    locations: list[PartitionLocation] = field(default_factory=list)
    error: str = ""
    error_kind: str = ""
    retryable: bool = False
    metrics: list = field(default_factory=list)
    # ResultLost identity when a shuffle fetch failed
    fetch_failed_executor_id: str = ""
    fetch_failed_stage_id: int = 0
    # why the fetch failed ("corruption" = checksum mismatch survived the
    # retry-once refetch; rides error_kind as "FetchPartitionError:<cause>"
    # on the wire so no proto change is needed)
    fetch_failed_cause: str = ""
    # the failure was a per-task deadline expiry (feeds quarantine scoring)
    timed_out: bool = False


class ExecutionEngine:
    """THE seam (execution_engine.rs:51): prepare a stage plan to run here."""

    def create_query_stage_exec(self, plan: ExecutionPlan, config: BallistaConfig,
                                stage_attempt: int = 0) -> ExecutionPlan:
        from ballista_tpu_torch.executor.chaos import maybe_inject_chaos

        plan = maybe_inject_chaos(plan, config, stage_attempt)
        engine = str(config.get(EXECUTOR_ENGINE))
        if engine == "tpu":
            from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

            return maybe_compile_tpu(plan, config)
        return plan


class Executor:
    def __init__(self, work_dir: str, metadata: ExecutorMetadata | None = None,
                 engine: ExecutionEngine | None = None,
                 config: BallistaConfig | None = None):
        self.work_dir = work_dir
        self.metadata = metadata or ExecutorMetadata(id=new_executor_id())
        self.engine = engine or ExecutionEngine()
        self.default_config = config or BallistaConfig()
        # (job_id, stage_id, task_id); task_id -1 cancels the whole stage.
        # Task granularity matters for speculation: cancelling the LOSING
        # attempt must not kill its sibling tasks on the same stage.
        self._cancelled: set[tuple[str, int, int]] = set()
        self._lock = threading.Lock()
        self.tasks_run = 0
        self.tasks_failed = 0
        # serving tier: tasks dispatched on the short-query fast lane
        # (single-stage, no execution graph); reported in heartbeats
        self.fast_lane_tasks = 0
        # tasks turned away at admission because the session pool was
        # already saturated (reported in heartbeats; scheduler retries
        # them elsewhere)
        self.pressure_rejections = 0
        # lifecycle & storage counters (docs/lifecycle.md), mirrored onto
        # the heartbeat by the executor process: tasks rejected past the
        # disk high watermark, map outputs handed off by a drain, and
        # bytes reclaimed by the GC sweeps
        self.disk_rejections = 0
        self.migrated_partitions = 0
        self.migrated_bytes = 0
        self.gc_reclaimed_bytes = 0
        self.orphans_reclaimed = 0
        # set while a drain is in progress (SIGTERM or scheduler-initiated);
        # surfaces as lifecycle_state=draining on the heartbeat
        self.draining = False
        self.memory_limit_per_task = 0  # bytes; set by the executor process
        # "thread" (in-process, shared GIL) or "process" (spawned worker per
        # task: true parallelism, crash isolation, preemptive cancel —
        # DedicatedExecutor parity, see process_worker.py)
        self.isolation = "thread"
        # session-shared pools (runtime_cache.rs:59): set by the executor
        # process once the executor-wide capacity is known
        self.session_pools = None  # SessionPoolRegistry | None
        # direct-dispatch lease enforcement: the scheduler pushes grants/
        # revocations here; admit() gates every scheduler-less task. The
        # generation probe fences leases against a silently restarted
        # device daemon (the client module makes no CUDA call: it only
        # reads its attach cache; "" when not attached)
        from ballista_tpu_torch.device_daemon import client as _dclient
        from ballista_tpu_torch.serving.lease import LeaseTable
        self.lease_table = LeaseTable(generation_probe=_dclient.attached_generation)
        self._warned_tpu_downgrade = False
        # process-isolated tasks currently inflight (spill budget is split
        # across them; see process_worker.run_task_in_subprocess)
        self.active_process_tasks = 0

    # ------------------------------------------------------------------

    def cancel_task(self, job_id: str, stage_id: int, task_id: int | None = None) -> None:
        with self._lock:
            self._cancelled.add((job_id, stage_id, -1 if task_id is None else task_id))

    def clear_cancellations(self, job_id: str) -> None:
        with self._lock:
            self._cancelled = {c for c in self._cancelled if c[0] != job_id}

    def _is_cancelled(self, job_id: str, stage_id: int, task_id: int = -1) -> bool:
        with self._lock:
            return ((job_id, stage_id, -1) in self._cancelled
                    or (task_id != -1 and (job_id, stage_id, task_id) in self._cancelled))

    # ------------------------------------------------------------------

    def run_task(self, task: TaskDescription, config: BallistaConfig | None = None) -> TaskResult:
        """Dispatch honoring the isolation mode: in-thread, or a spawned
        worker process (DedicatedExecutor parity). A session may OPT IN to
        process isolation via ballista.executor.task.isolation (strictly
        safer than threads); it cannot opt a daemon out of it."""
        cfg = config or self.default_config
        if getattr(task, "fast_lane", False):
            self.fast_lane_tasks += 1
        rejected = self._reject_if_saturated(task)
        if rejected is None:
            rejected = self._reject_if_disk_full(task, cfg)
        if rejected is not None:
            return rejected
        iso = self.isolation
        if iso != "process":
            from ballista_tpu_torch.config import EXECUTOR_TASK_ISOLATION

            iso = str(cfg.get(EXECUTOR_TASK_ISOLATION))
        if iso == "process":
            if str(cfg.get(EXECUTOR_ENGINE)) == "tpu":
                # a spawned worker would re-claim the (exclusively owned)
                # chip and rebuild the device caches per task; device
                # stages stay in-thread where the claim and caches live
                if self.isolation == "process" and not self._warned_tpu_downgrade:
                    # daemon-forced isolation being silently weakened is an
                    # operator surprise; say it loudly, once per executor
                    self._warned_tpu_downgrade = True
                    log.warning(
                        "daemon-forced --task-isolation process is downgraded to "
                        "in-thread for engine=tpu tasks (the spawned worker cannot "
                        "share the parent's TPU runtime); crash isolation and "
                        "preemptive cancel do NOT apply to device stages")
                iso = "thread"
            elif type(self.engine) is not ExecutionEngine:
                # a custom engine seam can't be reconstructed in the child;
                # silently different lowering would be worse than the GIL
                log.warning(
                    "task %s/%s: custom ExecutionEngine %s is not available "
                    "under process isolation; running in-thread",
                    task.job_id, task.task_id, type(self.engine).__name__)
            else:
                from ballista_tpu_torch.executor.process_worker import run_task_in_subprocess

                return run_task_in_subprocess(self, task, cfg)
        return self.execute_task(task, config)

    def _reject_if_saturated(self, task: TaskDescription) -> TaskResult | None:
        """Executor-side admission gate: a task whose session pool is
        already at/over capacity is rejected retryably INSTEAD of starting
        life overcommitted (grow_wait's deadline backstop would force the
        reservation through and deepen the spiral). The failure is
        retryable, so the scheduler re-pends the partition and the health
        scoring steers the retry toward a less-pressured executor."""
        if self.session_pools is None:
            return None
        pool = self.session_pools.get(task.session_id)
        if not pool.saturated:
            return None
        self.pressure_rejections += 1
        log.warning(
            "rejecting task %s/%s at admission: session %s pool saturated "
            "(%.0f%% of %d bytes reserved)", task.job_id, task.task_id,
            task.session_id, pool.pressure() * 100, pool.capacity)
        return TaskResult(
            task_id=task.task_id, job_id=task.job_id, stage_id=task.stage_id,
            stage_attempt=task.stage_attempt, partitions=list(task.partitions),
            state="failed",
            error=(f"executor {self.metadata.id} rejected task at admission: "
                   f"session memory pool saturated ({pool.reserved}/{pool.capacity} bytes)"),
            error_kind="ResourceExhausted", retryable=True,
        )

    def _reject_if_disk_full(self, task: TaskDescription, cfg: BallistaConfig) -> TaskResult | None:
        """High-watermark admission gate (docs/lifecycle.md#watermark-ladder):
        a task admitted onto a nearly-full disk would ENOSPC mid-shuffle-
        write anyway — reject it up front, typed and retryable, so the
        scheduler re-pends the slice and the heartbeat disk gauges steer
        the retry toward an executor with headroom."""
        from ballista_tpu_torch.executor import disk

        if not disk.admission_blocked(cfg, self.work_dir):
            return None
        self.disk_rejections += 1
        used_frac, used, free = disk.disk_status(self.work_dir)
        log.warning(
            "rejecting task %s/%s at admission: disk %.0f%% used (%d bytes free) "
            "is past the high watermark", task.job_id, task.task_id,
            used_frac * 100, free)
        return TaskResult(
            task_id=task.task_id, job_id=task.job_id, stage_id=task.stage_id,
            stage_attempt=task.stage_attempt, partitions=list(task.partitions),
            state="failed",
            error=(f"executor {self.metadata.id} rejected task at admission: "
                   f"disk {used_frac * 100:.0f}% used ({free} bytes free) past "
                   "the high watermark"),
            error_kind="DiskExhausted", retryable=True,
        )

    def execute_task(self, task: TaskDescription, config: BallistaConfig | None = None) -> TaskResult:
        cfg = config or self.default_config
        from ballista_tpu_torch import udf

        udf.load_modules(cfg.get(udf.UDF_MODULES))
        if self.memory_limit_per_task:
            # executor-sized spill budget (cgroup/host-aware, see
            # executor_process.detect_memory_limit) unless the session set
            # one explicitly — the reference's per-executor MemoryPool role
            # (executor_process.rs:465-480)
            from ballista_tpu_torch.config import SORT_SHUFFLE_MEMORY_LIMIT

            cfg.set_default_if_unset(SORT_SHUFFLE_MEMORY_LIMIT, self.memory_limit_per_task)
        base = TaskResult(
            task_id=task.task_id, job_id=task.job_id, stage_id=task.stage_id,
            stage_attempt=task.stage_attempt, partitions=list(task.partitions), state="failed",
        )
        start = time.time()
        deadline = float(getattr(task, "deadline_seconds", 0.0) or 0.0)
        deadline_at = start + deadline if deadline > 0 else 0.0
        try:
            plan = task.plan
            assert isinstance(plan, ShuffleWriterExec), f"stage root must be a shuffle writer: {plan}"
            prepared = self.engine.create_query_stage_exec(plan, cfg, task.stage_attempt)
            locations: list[PartitionLocation] = []
            for p in task.partitions:
                if self._is_cancelled(task.job_id, task.stage_id, task.task_id):
                    raise Cancelled(f"task {task.task_id} cancelled")
                if deadline_at and time.time() > deadline_at:
                    self.tasks_failed += 1
                    base.error = (f"task {task.task_id} exceeded its {deadline:.1f}s deadline "
                                  f"after {time.time() - start:.1f}s")
                    base.error_kind = "ExecutionError"
                    base.retryable = True
                    base.timed_out = True
                    log.warning("task %s/%s timed out: %s", task.job_id, task.task_id, base.error)
                    return base
                ctx = TaskContext(cfg, task_id=f"{task.task_id}", work_dir=self.work_dir)
                ctx.device_ordinal = self.metadata.device_ordinal
                ctx.task_attempt = int(getattr(task, "task_attempt", 0))
                ctx.deadline_at = deadline_at
                # long-running operators (and chaos stragglers) poll this so
                # a CancelTasks push preempts mid-partition, not between
                ctx.cancel_check = (
                    lambda j=task.job_id, s=task.stage_id, t=task.task_id: self._is_cancelled(j, s, t)
                )
                if self.session_pools is not None:
                    # concurrent tasks of one session share the pool: idle
                    # tasks lend spill budget to a heavy sort (try_grow)
                    ctx.memory_pool = self.session_pools.get(task.session_id)
                    if str(cfg.get(EXECUTOR_ENGINE)) == "tpu":
                        # attach the device-side ledger: HBM headroom is
                        # split-accounted from the host spill budget (the
                        # stage compiler resyncs device_reserved from the
                        # device-cache residency each run)
                        from ballista_tpu_torch.ops.cuda import hbm

                        ctx.memory_pool.set_device_capacity(
                            hbm.resolve_hbm_budget(cfg))
                for meta_batch in prepared.execute(p, ctx):
                    locations.extend(
                        metadata_to_locations(
                            meta_batch, task.job_id, task.stage_id, p,
                            self.metadata.id, self.metadata.host, self.metadata.flight_port,
                        )
                    )
            base.state = "success"
            base.locations = locations
            base.metrics = [
                {"depth": d, "name": n, **m} for d, n, m in collect_metrics(prepared)
            ]
            self.tasks_run += 1
            return base
        except Cancelled as e:
            base.state = "cancelled"
            base.error = str(e)
            return base
        except BaseException as e:  # noqa: BLE001 — catch_unwind parity
            from ballista_tpu_torch.errors import FetchFailed

            self.tasks_failed += 1
            base.error = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=8)}"
            base.error_kind = error_to_proto_kind(e)
            base.retryable = bool(getattr(e, "retryable", False))
            base.timed_out = bool(getattr(e, "timed_out", False))
            if isinstance(e, FetchFailed):
                base.fetch_failed_executor_id = e.executor_id
                base.fetch_failed_stage_id = e.stage_id
                base.fetch_failed_cause = getattr(e, "cause", "")
            log.warning("task %s/%s failed: %s", task.job_id, task.task_id, e)
            return base
