"""Lease-based direct dispatch: the prepared-statement hot path goes
scheduler-less.

The serving tier's fast lane still pays one scheduler round trip per
query (submit → plan-cache hit → slot reservation → launch). With a
lease (`ballista_tpu_torch/serving/lease.py`) the scheduler leaves the hot
path entirely: it mints a revocable capacity slice on one warm executor
ONCE, and the client — which already holds the bound plan template via
its prepared statement — binds parameters, allocates task ids from the
lease's reserved band, and runs the single-stage job straight against
the executor (in-process seam or the executor's Flight endpoint). The
scheduler only hears about completed work afterwards, through
`SchedulerServer.reconcile_direct_dispatch`.

Demotion contract: ANY rejection (revoked/expired lease, band
exhausted, capacity, multi-stage plan, no executor headroom) falls back
to `SchedulerServer.execute_prepared` — the ordinary graph path — and
returns byte-identical results, because both paths execute the same
bound plan and fetch through `fetch_job_results`.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import BallistaError, ExecutionError
from ballista_tpu_torch.ids import new_job_id
from ballista_tpu_torch.scheduler.state.execution_graph import TaskDescription

log = logging.getLogger(__name__)


class LeaseRejected(Exception):
    """A direct-dispatch admission check failed; carries the reason the
    executor (or transport) gave. The dispatcher demotes on it."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class LocalLeaseTransport:
    """In-process transport: admission through the executor's LeaseTable,
    execution via Executor.run_task — the standalone-mode seam the
    Flight transport mirrors on the wire."""

    def __init__(self, executors: dict):
        self.executors = executors

    def run(self, lease, task: TaskDescription, config=None):
        ex = self.executors.get(lease.executor_id)
        if ex is None:
            raise LeaseRejected("unknown-executor")
        reason = ex.lease_table.admit(lease.lease_id, task.task_id)
        if reason is not None:
            raise LeaseRejected(reason)
        try:
            return ex.run_task(task, config)
        finally:
            ex.lease_table.release(lease.lease_id)


class FlightLeaseTransport:
    """Wire transport: one `lease_dispatch` Flight action per task against
    the executor endpoint named in the lease (header line + proto)."""

    def __init__(self):
        self._conns: dict[str, object] = {}
        self._lock = threading.Lock()

    def _connect(self, lease):
        import pyarrow.flight as flight

        key = f"{lease.host}:{lease.flight_port}"
        with self._lock:
            conn = self._conns.get(key)
            if conn is None:
                conn = self._conns[key] = flight.connect(f"grpc://{key}")
            return conn

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()

    def run(self, lease, task: TaskDescription, config=None):
        import pyarrow.flight as flight

        from ballista_tpu_torch.executor.executor import ExecutorMetadata
        from ballista_tpu_torch.proto import pb
        from ballista_tpu_torch.serde_control import (
            decode_task_status, encode_task_definition)

        head = json.dumps({"lease_id": lease.lease_id,
                           "executor_id": lease.executor_id}).encode()
        proto = encode_task_definition(task, config)
        if config is not None:
            # the session's settings ride with the task, as LaunchMultiTask
            # sends them: without them the executor ran it under its default
            # config (ROADMAP C19)
            for k, v in config.to_key_value_pairs():
                proto.props.add(key=k, value=v)
        payload = proto.SerializeToString()
        conn = self._connect(lease)
        results = list(conn.do_action(
            flight.Action("lease_dispatch", head + b"\n" + payload)))
        header = json.loads(results[0].body.to_pybytes().decode())
        if "rejected" in header:
            raise LeaseRejected(str(header["rejected"]))
        status = pb.TaskStatusProto.FromString(results[1].body.to_pybytes())
        meta = ExecutorMetadata(id=lease.executor_id, host=lease.host,
                                flight_port=lease.flight_port)
        return decode_task_status(status, meta)


class DirectDispatcher:
    """Client-side direct-dispatch driver for one prepared statement.

    The scheduler stays on the CONTROL path only: `prepare` registers the
    statement, `_lease` mints/refreshes the capacity token, demotions go
    back through `execute_prepared`, and every completed direct job is
    reconciled after the client already has its bytes."""

    def __init__(self, scheduler, transport, session_id: str,
                 slots: int | None = None, ttl_s: float | None = None):
        self.scheduler = scheduler
        self.transport = transport
        self.session_id = session_id
        self.slots = slots
        self.ttl_s = ttl_s
        self.statement_id: str | None = None
        self._stmt_key: str | None = None
        self._lease = None
        self._lock = threading.Lock()
        # outcome counters: the qps exercise's direct_dispatch_rate reads
        # direct / (direct + demoted)
        self.stats = {"direct": 0, "demoted": 0, "tasks": 0}

    # -- control path (scheduler) ------------------------------------------

    def prepare(self, sql: str) -> str:
        out = self.scheduler.prepare_statement(sql, self.session_id)
        self.statement_id = out["statement_id"]
        stmt = self.scheduler.serving.get_prepared(self.statement_id)
        self._stmt_key = stmt.key
        return self.statement_id

    def _acquire_lease(self):
        with self._lock:
            if self._lease is not None and self._lease.rejection() is None:
                return self._lease
            self._lease = self.scheduler.mint_executor_lease(
                self.session_id, slots=self.slots, ttl_s=self.ttl_s)
            return self._lease

    def invalidate_lease(self) -> None:
        with self._lock:
            self._lease = None

    def _demote(self, params, reason: str):
        """Byte-identical fallback: the ordinary prepared-statement path
        through the scheduler (graph or fast lane)."""
        log.debug("direct dispatch demoted (%s); falling back to scheduler", reason)
        self.invalidate_lease()
        self.scheduler.leases.note_demoted()
        self.scheduler.metrics.record_direct_dispatch("demoted")
        self.stats["demoted"] += 1
        job_id = self.scheduler.execute_prepared(
            self.statement_id, params, session_id=self.session_id)
        status = self.scheduler.wait_for_job(job_id)
        if status["state"] != "successful":
            raise ExecutionError(
                f"job {job_id} {status['state']}: {status.get('error', '')}")
        return status

    # -- hot path (scheduler-less) -----------------------------------------

    def _bind_single_stage(self, params, job_id: str):
        """Bind params into the cached template and stage it; None unless
        the plan is single-stage (direct dispatch is the fast lane's
        contract: one stage, no shuffle dependencies)."""
        from ballista_tpu_torch.scheduler.planner import DistributedPlanner, merge_mesh_stages
        from ballista_tpu_torch.serving.normalize import bind_physical

        template = self.scheduler.serving.lookup_template(
            self._stmt_key, tuple(params) if params is not None else ())
        if template is None:
            return None, None
        cfg = self.scheduler.sessions.get(self.session_id) or BallistaConfig()
        bound = bind_physical(template.physical, tuple(params or ()))
        stages = merge_mesh_stages(
            DistributedPlanner(job_id).plan_query_stages(bound), cfg)
        if len(stages) != 1:
            return None, cfg
        return stages[0], cfg

    def execute(self, params=None):
        """Run one bound query: direct against the leased executor when
        everything lines up, demoted to the scheduler path otherwise.
        Returns the job-status dict (same shape both ways)."""
        if self.statement_id is None:
            raise BallistaError("prepare() first")
        job_id = f"direct-{new_job_id()}"
        try:
            stage, cfg = self._bind_single_stage(params, job_id)
        except Exception as e:  # noqa: BLE001 — planning trouble → scheduler owns it
            return self._demote(params, f"bind-failed: {e}")
        if stage is None:
            return self._demote(params, "not-single-stage" if cfg else "template-evicted")
        # append ingestion: retained deltas live on the scheduler and graft
        # at dispatch time — a direct launch of the cached template would
        # scan stale base files, so any appended table demotes
        if not self.scheduler.ingest.empty():
            from ballista_tpu_torch.serving.normalize import collect_scan_tables

            touched = collect_scan_tables(stage.plan)
            if touched & self.scheduler.ingest.tables_with_deltas():
                return self._demote(params, "appended-table")
        lease = self._acquire_lease()
        if lease is None:
            return self._demote(params, "no-lease")
        locations = []
        try:
            for p in range(stage.partitions):
                task_id = lease.take_task_id()
                if task_id is None:
                    raise LeaseRejected("band-exhausted")
                task = TaskDescription(
                    job_id=job_id, stage_id=stage.stage_id, stage_attempt=0,
                    task_id=task_id, partitions=[p], plan=stage.plan,
                    session_id=self.session_id, fast_lane=True)
                result = self.transport.run(lease, task, cfg)
                if result.state != "success":
                    raise LeaseRejected(f"task-failed: {result.error}")
                locations.extend(result.locations or [])
        except LeaseRejected as e:
            return self._demote(params, e.reason)
        self.stats["direct"] += 1
        self.stats["tasks"] += stage.partitions
        self.scheduler.metrics.record_direct_dispatch("dispatched")
        # asynchronous reconciliation: the client already has its result
        # locations; the scheduler folds the accounting in after the fact
        self.scheduler.reconcile_direct_dispatch(
            {"lease_id": lease.lease_id, "job_id": job_id,
             "tasks": stage.partitions})
        return {
            "job_id": job_id, "job_name": "", "state": "successful",
            "error": "", "completed_stages": 1, "total_stages": 1,
            "queued_at": time.time(), "ended_at": time.time(),
            "fast_lane": True, "direct_dispatch": True,
            "schema": stage.plan.input.df_schema,
            "partitions": sorted(
                locations, key=lambda l: (l.output_partition, l.map_partition)),
        }

    def direct_dispatch_rate(self) -> float:
        total = self.stats["direct"] + self.stats["demoted"]
        return self.stats["direct"] / total if total else 0.0
