"""In-process executors + task launcher (standalone mode).

Rebuild of the standalone helpers (scheduler/src/standalone.rs:47,
executor/src/standalone.rs:51): a real SchedulerServer and real Executors
in one process — the full task/shuffle machinery with no gRPC in between.
This is both the `SessionContext::standalone()` backend and the
virtual-cluster layer integration tests build on.
"""

from __future__ import annotations

import concurrent.futures as fut
import tempfile
import threading

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.executor import Executor, ExecutorMetadata
from ballista_tpu_torch.ids import new_executor_id
from ballista_tpu_torch.scheduler.server import SchedulerServer, TaskLauncher
from ballista_tpu_torch.scheduler.state.execution_graph import TaskDescription


class InProcessTaskLauncher(TaskLauncher):
    """Runs launched tasks on local Executor objects via a thread pool and
    feeds TaskResults straight back into the scheduler (push-mode shape)."""

    def __init__(self, executors: dict[str, Executor], max_workers: int = 16):
        self.executors = executors
        self.pool = fut.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="task")

    def launch(self, executor_id: str, tasks: list[TaskDescription], server: SchedulerServer) -> None:
        ex = self.executors[executor_id]

        def run(task: TaskDescription) -> None:
            cfg = server.sessions.get(task.session_id)
            result = ex.run_task(task, cfg)
            server.update_task_status(executor_id, [result])

        for t in tasks:
            self.pool.submit(run, t)

    def cancel_tasks(self, executor_id: str, job_id: str,
                     items: list, server: SchedulerServer) -> None:
        """Propagate CancelTasks to the in-process executor exactly like the
        daemon rpc does (preemptive for process-isolated tasks)."""
        ex = self.executors.get(executor_id)
        if ex is not None:
            for task_id, stage_id in items:
                ex.cancel_task(job_id, stage_id, task_id)

    def remove_job_data(self, executor_id: str, job_id: str, server: SchedulerServer) -> None:
        """Shuffle-GC push, mirroring the daemon's RemoveJobData rpc
        (executor_server.py): containment-checked rmtree of the job dir +
        cancellation-ledger cleanup, with reclaimed bytes counted."""
        import os
        import shutil

        from ballista_tpu_torch.executor.lifecycle import _dir_bytes
        from ballista_tpu_torch.shuffle.paths import contained_path, job_dir, validate_job_id

        ex = self.executors.get(executor_id)
        if ex is None:
            return
        try:
            d = contained_path(ex.work_dir, job_dir(ex.work_dir, validate_job_id(job_id)))
        except (ValueError, PermissionError):
            return
        if os.path.isdir(d):
            ex.gc_reclaimed_bytes += _dir_bytes(d)
            shutil.rmtree(d, ignore_errors=True)
        ex.clear_cancellations(job_id)

    def grant_lease(self, executor_id: str, lease, server: SchedulerServer) -> None:
        ex = self.executors.get(executor_id)
        if ex is not None:
            ex.lease_table.grant(lease)

    def revoke_lease(self, executor_id: str, lease_id: str, server: SchedulerServer) -> None:
        ex = self.executors.get(executor_id)
        if ex is not None:
            ex.lease_table.revoke(lease_id)

    def migrate_partitions(self, src_executor_id: str, dest_executor_id: str,
                           locations: list, server: SchedulerServer) -> tuple[int, int]:
        """Drain handoff for in-process fleets (docs/lifecycle.md). With
        per-executor work dirs + data planes the destination pulls the
        ranges over the real migrate_pull Flight path; with ONE shared
        work dir + data plane (the classic standalone shape) the files are
        already readable by the surviving endpoint, so the handoff is pure
        relabeling."""
        from ballista_tpu_torch.executor import lifecycle

        src = self.executors.get(src_executor_id)
        dest = self.executors.get(dest_executor_id)
        if dest is None or not locations:
            return 0, 0
        if (src is not None and src.work_dir != dest.work_dir
                and src.metadata.flight_port and dest.metadata.flight_port):
            count, nbytes = lifecycle.migrate_via_flight(
                f"{src.metadata.host}:{src.metadata.flight_port}",
                f"{dest.metadata.host}:{dest.metadata.flight_port}",
                locations, dest.metadata)
        else:
            count, nbytes = lifecycle.migrate_local(locations, dest.metadata)
        dest.migrated_partitions += count
        dest.migrated_bytes += nbytes
        return count, nbytes


class StandaloneCluster:
    def __init__(self, num_executors: int = 1, vcores: int = 4,
                 work_dir: str | None = None, config: BallistaConfig | None = None,
                 with_flight: bool = True, engine_factory=None,
                 shards: int | None = None, job_state=None,
                 per_executor_work_dirs: bool = False):
        import os

        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-tpu-")
        self.per_executor_work_dirs = per_executor_work_dirs
        self.flight_server = None
        # per-executor data planes: each executor owns a work-dir subtree
        # and its own Flight server, so drain migration moves real bytes
        # between endpoints (the distributed shape, in-process)
        self.flight_servers: dict[str, object] = {}
        flight_port = 0
        if with_flight and not per_executor_work_dirs:
            from ballista_tpu_torch.flight.server import start_flight_server

            self.flight_server, flight_port = start_flight_server(self.work_dir, "localhost")
        self._shared_flight_port = flight_port
        self.executors: dict[str, Executor] = {}
        for _ in range(num_executors):
            eid = str(new_executor_id())
            ex_work_dir = self.work_dir
            if per_executor_work_dirs:
                ex_work_dir = os.path.join(self.work_dir, eid)
                os.makedirs(ex_work_dir, exist_ok=True)
                if with_flight:
                    from ballista_tpu_torch.flight.server import start_flight_server

                    srv, flight_port = start_flight_server(ex_work_dir, "localhost")
                    self.flight_servers[eid] = srv
            meta = ExecutorMetadata(id=eid, vcores=vcores,
                                    host="localhost", flight_port=flight_port)
            # engine_factory: the ExecutionEngine extension seam
            # (execution_engine.rs:51) for library embedders
            eng = engine_factory() if engine_factory is not None else None
            ex = Executor(ex_work_dir, meta, config=config, engine=eng)
            if config is not None:
                from ballista_tpu_torch.config import EXECUTOR_TASK_ISOLATION

                ex.isolation = str(config.get(EXECUTOR_TASK_ISOLATION))
            self.executors[meta.id] = ex
            if self.flight_server is not None:
                # direct-dispatch target: lease grants + scheduler-less
                # task execution arrive as Flight actions
                self.flight_server.attach_executor(ex)
            elif eid in self.flight_servers:
                self.flight_servers[eid].attach_executor(ex)
        self.launcher = InProcessTaskLauncher(self.executors)
        if shards is None and config is not None:
            from ballista_tpu_torch.config import SCHEDULER_SHARDS

            shards = int(config.get(SCHEDULER_SHARDS))
        self.scheduler = SchedulerServer(self.launcher, job_state=job_state,
                                         shards=shards or 1)
        self.scheduler.start()
        for ex in self.executors.values():
            self.scheduler.register_executor(ex.metadata)

    def add_executor(self, vcores: int = 4, config: BallistaConfig | None = None,
                     engine_factory=None) -> str:
        """Join a fresh executor to the running fleet (the rolling-restart
        harness: drain a node, then add_executor() is its replacement).
        Honors the cluster's data-plane shape — own work dir + Flight
        server under per_executor_work_dirs, shared otherwise."""
        import os

        eid = str(new_executor_id())
        ex_work_dir = self.work_dir
        flight_port = 0
        if self.per_executor_work_dirs:
            ex_work_dir = os.path.join(self.work_dir, eid)
            os.makedirs(ex_work_dir, exist_ok=True)
            from ballista_tpu_torch.flight.server import start_flight_server

            srv, flight_port = start_flight_server(ex_work_dir, "localhost")
            self.flight_servers[eid] = srv
        elif self.flight_server is not None:
            flight_port = self._shared_flight_port
        meta = ExecutorMetadata(id=eid, vcores=vcores,
                                host="localhost", flight_port=flight_port)
        eng = engine_factory() if engine_factory is not None else None
        ex = Executor(ex_work_dir, meta, config=config, engine=eng)
        self.executors[eid] = ex
        if self.flight_server is not None:
            self.flight_server.attach_executor(ex)
        elif eid in self.flight_servers:
            self.flight_servers[eid].attach_executor(ex)
        self.scheduler.register_executor(meta)
        return eid

    def shutdown(self) -> None:
        self.scheduler.stop()
        self.launcher.pool.shutdown(wait=False)
        if self.flight_server is not None:
            self.flight_server.shutdown()
        for srv in self.flight_servers.values():
            srv.shutdown()


class MultiSchedulerCluster:
    """N real SchedulerServer instances over ONE shared executor fleet and
    ONE shared FileJobState directory — the in-process shape of a
    multi-scheduler deployment behind the Flight/gRPC proxy. Clients may
    submit to any live instance (`pick()` round-robins); a killed
    instance's jobs sit in the shared store until a live peer's orphan
    sweep (`resubmit_stuck_jobs` → `recover_jobs(only_active=True)`)
    adopts their stale ownership lease and resumes from the last
    checkpointed stage."""

    def __init__(self, num_schedulers: int = 2, num_executors: int = 2,
                 vcores: int = 4, work_dir: str | None = None,
                 config: BallistaConfig | None = None,
                 lease_s: float = 2.0, shards: int = 1,
                 sweep_interval_s: float = 0.5):
        import os

        from ballista_tpu_torch.scheduler.state.job_state import FileJobState

        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-tpu-")
        self.state_dir = os.path.join(self.work_dir, "job-state")
        self.executors: dict[str, Executor] = {}
        for _ in range(num_executors):
            meta = ExecutorMetadata(id=str(new_executor_id()), vcores=vcores,
                                    host="localhost")
            self.executors[meta.id] = Executor(self.work_dir, meta, config=config)
        self.launcher = InProcessTaskLauncher(self.executors)
        self.schedulers: list[SchedulerServer] = []
        for i in range(num_schedulers):
            # each instance gets its OWN FileJobState handle on the SHARED
            # dir: ownership arbitration runs through the on-disk markers,
            # exactly like separate scheduler processes
            s = SchedulerServer(
                self.launcher, scheduler_id=f"scheduler-{i}",
                job_state=FileJobState(self.state_dir, lease_s=lease_s),
                shards=shards)
            s.start()
            for ex in self.executors.values():
                s.register_executor(ex.metadata)
            self.schedulers.append(s)
        self._rr = 0
        self._killed: set[int] = set()
        self._sweeping = True
        self._sweeper = threading.Thread(
            target=self._sweep_loop, args=(sweep_interval_s,), daemon=True,
            name="multi-scheduler-sweep")
        self._sweeper.start()

    def _sweep_loop(self, interval_s: float) -> None:
        # stands in for SchedulerProcess._expiry_loop: live instances
        # periodically revive stuck jobs and adopt orphans
        import time as _time

        while self._sweeping:
            _time.sleep(interval_s)
            for i, s in enumerate(self.schedulers):
                if i in self._killed:
                    continue
                try:
                    s.resubmit_stuck_jobs()
                except Exception:  # noqa: BLE001 — sweep must survive a flaky store
                    pass

    def alive(self) -> list[SchedulerServer]:
        return [s for i, s in enumerate(self.schedulers) if i not in self._killed]

    def pick(self) -> SchedulerServer:
        live = self.alive()
        self._rr += 1
        return live[self._rr % len(live)]

    def kill(self, i: int) -> None:
        """Chaos-kill instance i: its loops stop AND it loses the shared
        store (a dead process can't write late checkpoints over its
        successor's progress)."""
        from ballista_tpu_torch.scheduler.state.job_state import InMemoryJobState

        self._killed.add(i)
        s = self.schedulers[i]
        s.stop()
        s.job_state = InMemoryJobState()

    def shutdown(self) -> None:
        self._sweeping = False
        for i in range(len(self.schedulers)):
            if i not in self._killed:
                self.schedulers[i].stop()
        self.launcher.pool.shutdown(wait=False)
