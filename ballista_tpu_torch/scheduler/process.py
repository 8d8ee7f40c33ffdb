"""Scheduler daemon process.

Rebuild of scheduler/src/scheduler_process.rs + bin/main.rs: gRPC server
with the full SchedulerGrpc surface, push-mode task launching over gRPC to
executors, dead-executor expiry sweep, REST API + Prometheus metrics.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time
from concurrent import futures

import grpc

from ballista_tpu_torch.executor.executor_server import executor_stub
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.grpc_service import SchedulerGrpcService, add_scheduler_service
from ballista_tpu_torch.scheduler.metrics import InMemoryMetricsCollector
from ballista_tpu_torch.scheduler.server import SchedulerServer, TaskLauncher
from ballista_tpu_torch.scheduler.state.execution_graph import TaskDescription
from ballista_tpu_torch.serde_control import encode_task_definition

log = logging.getLogger(__name__)

EXPIRY_CHECK_S = 15.0
RESUBMIT_CHECK_S = 3.0


class GrpcTaskLauncher(TaskLauncher):
    """Push mode: LaunchMultiTask to the executor's gRPC endpoint
    (reference: executor_manager.rs:406)."""

    def __init__(self, tls_config=None):
        self._stubs: dict[str, object] = {}
        self._lock = threading.Lock()
        self._tls_config = tls_config  # BallistaConfig carrying tls paths

    def _stub_for(self, addr: str):
        with self._lock:
            s = self._stubs.get(addr)
            if s is None:
                from ballista_tpu_torch.utils.grpc_util import create_channel

                s = executor_stub(create_channel(addr, self._tls_config))
                self._stubs[addr] = s
            return s

    def launch(self, executor_id: str, tasks: list[TaskDescription], server: SchedulerServer) -> None:
        slot = server.executors.get(executor_id)
        if slot is None:
            raise RuntimeError(f"unknown executor {executor_id}")
        addr = f"{slot.metadata.host}:{slot.metadata.grpc_port}"
        req = pb.LaunchMultiTaskParams(scheduler_id=server.scheduler_id)
        for t in tasks:
            cfg = server.sessions.get(t.session_id)
            tp = encode_task_definition(t, cfg)
            if cfg is not None:
                for k, v in cfg.to_key_value_pairs():
                    tp.props.add(key=k, value=v)
            req.tasks.append(tp)
        stub = self._stub_for(addr)
        stub.LaunchMultiTask(req, timeout=30)

    def cancel_tasks(self, executor_id: str, job_id: str, items, server) -> None:
        slot = server.executors.get(executor_id)
        if slot is None:
            return
        addr = f"{slot.metadata.host}:{slot.metadata.grpc_port}"
        req = pb.CancelTasksParams()
        for task_id, stage_id in items:
            req.tasks.add(task_id=task_id, job_id=job_id, stage_id=stage_id)
        stub = self._stub_for(addr)
        stub.CancelTasks(req, timeout=10)

    def remove_job_data(self, executor_id: str, job_id: str, server) -> None:
        slot = server.executors.get(executor_id)
        if slot is None:
            return
        addr = f"{slot.metadata.host}:{slot.metadata.grpc_port}"
        stub = self._stub_for(addr)
        stub.RemoveJobData(pb.RemoveJobDataParams(job_id=job_id), timeout=10)


class SchedulerProcess:
    def __init__(self, bind_host: str = "0.0.0.0", port: int = 50050,
                 task_distribution: str = "bias", executor_timeout_s: float = 180.0,
                 rest_port: int = 0, flight_proxy_port: int = 0,
                 job_state_dir: str | None = None, scheduler_id: str = "scheduler-0",
                 force_recover: bool = False,
                 tls_cert: str | None = None, tls_key: str | None = None,
                 tls_client_ca: str | None = None,
                 quarantine_threshold: float = 0.5,
                 quarantine_min_events: float = 4.0,
                 health_half_life_s: float = 60.0,
                 probe_backoff_s: float = 10.0,
                 shards: int = 1):
        self.metrics = InMemoryMetricsCollector()
        job_state = None
        if job_state_dir:
            from ballista_tpu_torch.scheduler.state.job_state import FileJobState

            job_state = FileJobState(job_state_dir)
        launcher_tls = None
        if tls_client_ca or tls_cert:
            from ballista_tpu_torch.config import (
                GRPC_TLS_CA,
                GRPC_TLS_CERT,
                GRPC_TLS_KEY,
                BallistaConfig,
            )

            launcher_tls = BallistaConfig({
                GRPC_TLS_CA: tls_client_ca or "",
                GRPC_TLS_CERT: tls_cert or "",
                GRPC_TLS_KEY: tls_key or "",
            })
        self.scheduler = SchedulerServer(
            GrpcTaskLauncher(launcher_tls), self.metrics, task_distribution, executor_timeout_s,
            scheduler_id=scheduler_id, job_state=job_state,
            quarantine_threshold=quarantine_threshold,
            quarantine_min_events=quarantine_min_events,
            health_half_life_s=health_half_life_s,
            probe_backoff_s=probe_backoff_s,
            shards=shards,
        )
        from ballista_tpu_torch.utils.grpc_util import server_options

        self.grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=32), options=server_options()
        )
        self.service = SchedulerGrpcService(self.scheduler)
        add_scheduler_service(self.grpc_server, self.service)
        from ballista_tpu_torch.scheduler.external_scaler import (
            ExternalScalerService,
            add_external_scaler_service,
        )

        # KEDA autoscaling endpoint on the same port (external_scaler.rs)
        add_external_scaler_service(
            self.grpc_server, ExternalScalerService(self.scheduler))
        from ballista_tpu_torch.utils.grpc_util import bind_server_port

        self.tls = (tls_cert, tls_key, tls_client_ca)
        self.port = bind_server_port(
            self.grpc_server, f"{bind_host}:{port}", tls_cert, tls_key, tls_client_ca
        )
        self._stopping = threading.Event()
        self.rest_server = None
        self.rest_port = 0
        if rest_port >= 0:
            from ballista_tpu_torch.scheduler.api.rest import start_rest_api

            self.rest_server, self.rest_port = start_rest_api(
                self.scheduler, self.metrics, bind_host, rest_port
            )
        self.force_recover = force_recover
        self.flight_proxy = None
        self.flight_proxy_port = 0
        if flight_proxy_port >= 0:
            from ballista_tpu_torch.flight.proxy import start_flight_proxy

            self.flight_proxy, self.flight_proxy_port = start_flight_proxy(
                bind_host, flight_proxy_port,
                tls_cert=tls_cert, tls_key=tls_key, tls_client_ca=tls_client_ca,
            )
            self.scheduler.flight_proxy_port = self.flight_proxy_port

    def start(self) -> None:
        self.scheduler.start()
        recovered = self.scheduler.recover_jobs(force=self.force_recover)
        if recovered:
            log.info("recovered %d persisted jobs: %s", len(recovered), recovered)
        self.grpc_server.start()
        threading.Thread(target=self._expiry_loop, daemon=True, name="executor-expiry").start()
        log.info("scheduler up: grpc=%d rest=%s", self.port, self.rest_port or "off")

    def _expiry_loop(self) -> None:
        ticks = 0
        while not self._stopping.wait(RESUBMIT_CHECK_S):
            ticks += 1
            self.scheduler.resubmit_stuck_jobs()
            if ticks % int(EXPIRY_CHECK_S / RESUBMIT_CHECK_S) == 0:
                self.scheduler.check_expired_executors()

    def shutdown(self) -> None:
        self._stopping.set()
        self.scheduler.stop()
        self.grpc_server.stop(grace=2)
        if self.rest_server is not None:
            self.rest_server.shutdown()
        if self.flight_proxy is not None:
            try:
                self.flight_proxy.shutdown()
            except Exception:
                pass

    def wait(self) -> None:
        try:
            while not self._stopping.wait(1.0):
                pass
        except KeyboardInterrupt:
            self.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ballista_tpu_torch scheduler daemon")
    ap.add_argument("--bind-host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=50050)
    ap.add_argument("--rest-port", type=int, default=50080)
    ap.add_argument("--flight-proxy-port", type=int, default=50051,
                    help="Flight result proxy port (-1 disables; 0 = ephemeral)")
    ap.add_argument("--job-state-dir", default=None,
                    help="persist job graphs here for fail-over recovery")
    ap.add_argument("--scheduler-id", default="scheduler-0")
    ap.add_argument("--shards", type=int, default=1,
                    help="event-loop shard count: jobs partition by crc32(job_id) mod N")
    ap.add_argument("--tls-cert", default=None, help="server certificate chain (PEM) — enables TLS")
    ap.add_argument("--tls-key", default=None, help="server private key (PEM)")
    ap.add_argument("--tls-client-ca", default=None,
                    help="CA to verify client certs (enables mTLS; also used to dial executors)")
    ap.add_argument("--force-recover", action="store_true",
                    help="adopt persisted jobs even if owned by another scheduler id "
                         "(standby takeover after the owner died)")
    ap.add_argument("--task-distribution", choices=("bias", "round-robin", "consistent-hash"),
                    default="bias")
    ap.add_argument("--executor-timeout-seconds", type=float, default=180.0)
    ap.add_argument("--quarantine-threshold", type=float, default=0.5,
                    help="decayed failure rate at which an executor stops receiving "
                         "offers (0 disables quarantine)")
    ap.add_argument("--quarantine-min-events", type=float, default=4.0,
                    help="minimum decayed task outcomes before the threshold applies")
    ap.add_argument("--health-half-life-seconds", type=float, default=60.0,
                    help="half-life of the decayed per-executor failure/success counters")
    ap.add_argument("--probe-backoff-seconds", type=float, default=10.0,
                    help="how long a quarantined executor waits before a probe task")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--log-file", default=None, help="also log to this file (rotating)")
    ap.add_argument("--log-rotation", choices=("never", "minutely", "hourly", "daily"),
                    default="daily", help="rotation policy for --log-file")
    args = ap.parse_args(argv)
    from ballista_tpu_torch.utils.log_util import init_logging

    init_logging(args.log_level, args.log_file, args.log_rotation)

    proc = SchedulerProcess(
        args.bind_host, args.port,
        args.task_distribution,
        args.executor_timeout_seconds, args.rest_port, args.flight_proxy_port,
        job_state_dir=args.job_state_dir, scheduler_id=args.scheduler_id,
        force_recover=args.force_recover,
        tls_cert=args.tls_cert, tls_key=args.tls_key, tls_client_ca=args.tls_client_ca,
        quarantine_threshold=args.quarantine_threshold,
        quarantine_min_events=args.quarantine_min_events,
        health_half_life_s=args.health_half_life_seconds,
        probe_backoff_s=args.probe_backoff_seconds,
        shards=args.shards,
    )
    signal.signal(signal.SIGTERM, lambda *_: proc.shutdown())
    proc.start()
    proc.wait()


if __name__ == "__main__":
    main()
