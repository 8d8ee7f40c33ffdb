"""Executor daemon process.

Rebuild of executor/src/executor_process.rs: registers with the scheduler
(wire-version gated), serves ExecutorGrpc + the Flight shuffle server,
heartbeats, optionally runs the pull-mode poll loop
(execution_loop.rs:88 — PollWork doubles as heartbeat), sweeps expired
job dirs by TTL (:1042), drains gracefully on SIGTERM.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import socket
import tempfile
import threading
import time
from concurrent import futures

import grpc

from ballista_tpu_torch.config import BallistaConfig, EXECUTOR_ENGINE
from ballista_tpu_torch.executor.executor import Executor, ExecutorMetadata
from ballista_tpu_torch.executor.executor_server import ExecutorGrpcService, add_executor_service
from ballista_tpu_torch.flight.server import start_flight_server
from ballista_tpu_torch.ids import new_executor_id
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.grpc_service import scheduler_stub
from ballista_tpu_torch.serde_control import encode_executor_metadata, encode_task_status

log = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_S = 5.0
POLL_INTERVAL_S = 0.25
DIR_TTL_CHECK_S = 300.0


def detect_memory_limit() -> int:
    """Container/host memory in bytes: cgroup v2 → v1 → /proc/meminfo
    (the reference's fraction-of-cgroup/host autodetect,
    executor_process.rs:465-480)."""
    for path in ("/sys/fs/cgroup/memory.max", "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                raw = f.read().strip()
            if raw != "max":
                v = int(raw)
                if 0 < v < (1 << 60):  # v1 reports ~int64.max when unlimited
                    return v
        except (OSError, ValueError):
            continue
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 4 * 1024**3


def _ensure_native_flight_binary() -> str | None:
    """Build native/ballista-flight-server if missing. flock-serialized
    (concurrent executors on one host must not race g++ over the same
    output) with a negative-result marker so hosts where the build fails
    pay the compile attempt once, not per executor start."""
    import fcntl
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    native = os.path.join(repo, "native")
    bin_path = os.path.join(native, "ballista-flight-server")
    build = os.path.join(native, "build.sh")
    src = os.path.join(native, "flight_shuffle.cpp")

    def fresh() -> bool:
        try:
            return os.path.getmtime(bin_path) >= os.path.getmtime(src)
        except OSError:
            return False

    if os.path.exists(bin_path) and fresh():
        return bin_path
    if not os.path.exists(build):
        return None
    marker = os.path.join(native, ".flight_build_failed")

    def marker_current() -> bool:
        # a failure marker older than the source is void: the code changed
        # since that build failed, so the compile deserves another attempt
        try:
            return os.path.getmtime(marker) >= os.path.getmtime(src)
        except OSError:
            return False

    try:
        with open(os.path.join(native, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(bin_path) and fresh():
                return bin_path
            if marker_current():
                return None
            r = subprocess.run(["sh", build], capture_output=True, timeout=300, check=False)
            if os.path.exists(bin_path) and fresh():
                return bin_path
            with open(marker, "w") as f:
                f.write(r.stderr.decode(errors="replace")[-2000:])
            return None
    except Exception:  # noqa: BLE001
        return None


def start_native_flight_server(work_dir: str, bind_host: str, port: int):
    """Spawn the C++ Flight data plane (native/flight_shuffle.cpp — same
    wire contract as flight/server.py). Returns (proc, bound_port) or None
    when the binary is missing or fails to come up."""
    import subprocess

    bin_path = _ensure_native_flight_binary()
    if bin_path is None:
        return None
    try:
        proc = subprocess.Popen(
            [bin_path, "--host", bind_host, "--port", str(port), "--work-dir", work_dir],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        # bounded wait for the PORT line: a wedged bind must not hang startup
        import select

        ready, _, _ = select.select([proc.stdout], [], [], 20.0)
        if not ready:
            proc.terminate()
            return None
        line = proc.stdout.readline().strip()
        if not line.startswith("PORT "):
            proc.terminate()
            return None
        return proc, int(line.split()[1])
    except Exception:  # noqa: BLE001
        return None


class ExecutorProcess:
    def __init__(self, scheduler_addr: str, bind_host: str = "0.0.0.0",
                 external_host: str | None = None, grpc_port: int = 0,
                 flight_port: int = 0, vcores: int | None = None,
                 work_dir: str | None = None, engine: str = "cpu",
                 policy: str = "push", work_dir_ttl_s: float = 4 * 3600,
                 memory_pool_bytes: int = 0, memory_fraction: float = 0.6,
                 flight_impl: str = "auto", device_ordinal: int = -1,
                 tls_cert: str | None = None, tls_key: str | None = None,
                 tls_ca: str | None = None, task_isolation: str = "thread"):
        self.scheduler_addr = scheduler_addr
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-tpu-executor-")
        self.policy = policy
        self.work_dir_ttl_s = work_dir_ttl_s
        if vcores is None and engine == "tpu" and device_ordinal >= 0:
            # one executor per chip ⇒ scheduler slot = chip (SURVEY §7 step
            # 7; reference vcore slot model, executor_process.rs:261): a
            # pinned device runs one stage task at a time
            vcores = 1
        vcores = vcores or (os.cpu_count() or 4)
        host = external_host or socket.gethostname()

        config = BallistaConfig({EXECUTOR_ENGINE: engine})
        if tls_ca:
            from ballista_tpu_torch.config import GRPC_TLS_CA, GRPC_TLS_CERT, GRPC_TLS_KEY

            config.set(GRPC_TLS_CA, tls_ca)
            config.set(GRPC_TLS_CERT, tls_cert or "")
            config.set(GRPC_TLS_KEY, tls_key or "")
        self.flight_server = None
        self.native_flight_proc = None
        # With mTLS configured the data plane must not stay plaintext: the
        # native C++ server has no TLS support yet, so TLS forces the Python
        # Flight server, which serves with the same certificates + required
        # client verification as the control plane.
        flight_tls = bool(tls_cert and tls_key)
        if flight_impl == "native" and flight_tls:
            raise RuntimeError("native flight server does not support TLS; use flight_impl=python")
        if flight_impl in ("auto", "native") and not flight_tls:
            native = start_native_flight_server(self.work_dir, bind_host, flight_port)
            if native is not None:
                self.native_flight_proc, bound_flight = native
                log.info("native C++ flight data plane on :%d", bound_flight)
            elif flight_impl == "native":
                raise RuntimeError("native flight server requested but unavailable")
        if self.native_flight_proc is None:
            self.flight_server, bound_flight = start_flight_server(
                self.work_dir, bind_host, flight_port,
                tls_cert=tls_cert, tls_key=tls_key, tls_client_ca=tls_ca,
            )

        self.memory_pool_bytes = memory_pool_bytes or int(detect_memory_limit() * memory_fraction)
        self.metadata = ExecutorMetadata(
            id=str(new_executor_id()), host=host, flight_port=bound_flight, vcores=vcores,
            device_ordinal=device_ordinal,
        )
        self.config = config
        self.executor = Executor(self.work_dir, self.metadata, config=config)
        self.executor.isolation = task_isolation
        if self.flight_server is not None:
            # the data plane serves lease_grant / lease_dispatch for this
            # executor: direct dispatch over Flight (client/direct.py); the
            # native server has no such actions, and its leases demote
            self.flight_server.attach_executor(self.executor)
        # startup orphan sweep: a crashed prior incarnation that reused this
        # work dir leaves job dirs no scheduler will remove_job_data for;
        # age-gated by the same TTL the background sweep uses, so a fresh
        # restart never races live job files (docs/lifecycle.md#gc)
        from ballista_tpu_torch.executor import lifecycle

        orphans, freed = lifecycle.sweep_stale_dirs(self.work_dir, self.work_dir_ttl_s)
        self.executor.orphans_reclaimed += orphans
        self.executor.gc_reclaimed_bytes += freed
        # per-task static floor (backstop when no session pool is present)
        self.executor.memory_limit_per_task = max(
            64 * 1024 * 1024, self.memory_pool_bytes // max(1, vcores)
        )
        # session-shared pool with try_grow semantics: concurrent tasks of a
        # session draw from ONE executor-sized budget, so idle tasks lend
        # headroom to a heavy sort (runtime_cache.rs:59)
        from ballista_tpu_torch.executor.memory_pool import SessionPoolRegistry

        self.executor.session_pools = SessionPoolRegistry(self.memory_pool_bytes)

        from ballista_tpu_torch.utils.grpc_util import create_channel

        self._channel = create_channel(scheduler_addr, config)
        self._scheduler = scheduler_stub(self._channel)
        self._stopping = threading.Event()
        self._stopped = threading.Event()  # set once shutdown() has finished
        self._pending_status: list = []
        self._status_lock = threading.Lock()

        from ballista_tpu_torch.utils.grpc_util import server_options

        self.grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8), options=server_options(config)
        )
        self.service = ExecutorGrpcService(self.executor, self._send_status, self.shutdown)
        add_executor_service(self.grpc_server, self.service)
        from ballista_tpu_torch.utils.grpc_util import bind_server_port

        self.grpc_port = bind_server_port(
            self.grpc_server, f"{bind_host}:{grpc_port}", tls_cert, tls_key,
            tls_ca if tls_cert else None,
        )
        self.metadata.grpc_port = self.grpc_port

        from ballista_tpu_torch.executor.health import start_health_server

        self.health_server, self.health_port = start_health_server(
            self.executor, self._stopping, bind_host
        )

    # ------------------------------------------------------------------

    def start(self) -> None:
        self.grpc_server.start()
        self._register()
        threading.Thread(target=self._heartbeat_loop, daemon=True, name="heartbeat").start()
        threading.Thread(target=self._dir_ttl_loop, daemon=True, name="dir-ttl").start()
        if self.policy == "pull":
            threading.Thread(target=self._poll_loop, daemon=True, name="poll").start()
        log.info(
            "executor %s up: grpc=%d flight=%d vcores=%d device=%s work_dir=%s",
            self.metadata.id, self.grpc_port, self.metadata.flight_port,
            self.metadata.vcores,
            self.metadata.device_ordinal if self.metadata.device_ordinal >= 0 else "unpinned",
            self.work_dir,
        )

    def _register(self) -> None:
        req = pb.RegisterExecutorParams(metadata=encode_executor_metadata(self.metadata))
        for attempt in range(30):
            try:
                resp = self._scheduler.RegisterExecutor(req, timeout=5)
                if not resp.success:
                    raise RuntimeError(f"registration rejected: {resp.error}")
                return
            except grpc.RpcError:
                time.sleep(min(2.0, 0.2 * (attempt + 1)))
        raise RuntimeError(f"cannot reach scheduler at {self.scheduler_addr}")

    def _send_status(self, results) -> None:
        if self.policy == "pull":
            with self._status_lock:
                self._pending_status.extend(results)
            return
        req = pb.UpdateTaskStatusParams(executor_id=self.metadata.id)
        for r in results:
            req.task_status.append(encode_task_status(r, self.metadata.id))
        self._scheduler.UpdateTaskStatus(req, timeout=30)

    def _overload_metrics(self) -> list[tuple[str, float]]:
        """Pressure signals piggybacked on the heartbeat's existing
        repeated ExecutorMetricProto field (no wire change): pool
        saturation, lifetime forced-overcommit bytes, admission
        rejections, and local task-queue depth."""
        pools = self.executor.session_pools
        from ballista_tpu_torch.shuffle.integrity import INTEGRITY

        integrity = INTEGRITY.snapshot()
        metrics = [
            ("memory_pressure", pools.aggregate_pressure() if pools else 0.0),
            ("pool_overcommitted_bytes", float(pools.total_overcommitted()) if pools else 0.0),
            ("pressure_rejections", float(self.executor.pressure_rejections)),
            ("queued_tasks", float(self.service._queue.qsize())),
            # serving tier: fast-lane dispatches seen by this executor
            ("fast_lane_tasks", float(self.executor.fast_lane_tasks)),
            # direct dispatch: granted leases + scheduler-less tasks run
            ("active_leases", float(self.executor.lease_table.active_count())),
            ("direct_dispatch_tasks", float(self.executor.lease_table.tasks_total)),
            # shuffle-integrity counters (reader-side verification outcomes)
            ("checksum_failures", float(integrity["checksum_failures"])),
            ("corruption_retries", float(integrity["corruption_retries"])),
        ]
        # lifecycle + disk-pressure gauges (docs/lifecycle.md): the
        # scheduler derives lifecycle_state, steers placement away from
        # full nodes, and triggers the drain state machine off these
        from ballista_tpu_torch.executor import disk as _disk

        _frac, used_b, free_b = _disk.disk_status(self.work_dir)
        metrics.extend([
            ("lifecycle_draining", 1.0 if self.executor.draining else 0.0),
            ("disk_used_bytes", float(used_b)),
            ("disk_free_bytes", float(free_b)),
            ("disk_rejecting",
             1.0 if _disk.admission_blocked(self.config, self.work_dir) else 0.0),
            ("disk_rejections", float(self.executor.disk_rejections)),
            ("migrated_partitions", float(self.executor.migrated_partitions)),
            ("migrated_bytes", float(self.executor.migrated_bytes)),
            ("gc_reclaimed_bytes", float(self.executor.gc_reclaimed_bytes)),
            ("orphans_reclaimed", float(self.executor.orphans_reclaimed)),
        ])
        metrics.extend(self._tpu_metrics())
        return metrics

    @staticmethod
    def _tpu_metrics() -> list[tuple[str, float]]:
        """Device cold-path gauges from the engine's merged RUN_STATS plus the
        kernel build directory's load counters (runtime.compile_cache_stats:
        loads, and loads that found the library built). Guarded on
        sys.modules so a CPU-engine executor never pulls in the CUDA engine
        just to heartbeat; absent RUN_STATS keys are skipped."""
        import sys

        sc = sys.modules.get("ballista_tpu_torch.ops.cuda.stage_compiler")
        if sc is None:
            return []
        out = []
        stats = sc.RUN_STATS.snapshot()
        for key in ("fill_s", "encode_s", "upload_s", "exec_s", "device_bytes",
                    "fused_spans", "fused_kernel_s",
                    "mesh_devices", "exchange_bytes_on_device", "exchange_s",
                    "hbm_budget_bytes", "hbm_spill_bytes", "hbm_spill_events",
                    "hbm_reupload_events", "grace_splits", "hbm_oom_retries",
                    "sort_kernel_s", "sort_invocations", "topk_invocations",
                    "topk_rows_kept", "window_invocations",
                    "window_partitions", "sort_full_materializations",
                    "delta_fill_rows",
                    "daemon_attached", "init_platform_probe_s",
                    "init_cuda_devices_s", "init_first_launch_s"):
            if key in stats:
                out.append((f"tpu_{key}", float(stats[key])))
        if "hbm_plan" in stats:
            # gauges are floats: the admission ladder's rungs in demotion
            # order (the string hbm_plan_reason stays in RUN_STATS)
            code = {"run_whole": 0.0, "spill_colds": 1.0, "grace_split": 2.0,
                    "cpu_demote": 3.0}
            out.append(("tpu_hbm_plan", code.get(str(stats["hbm_plan"]), -1.0)))
        if "fusion_mode" in stats:
            # gauges are floats: staged=0, fused_xla=1, fused_pallas=2
            code = {"staged": 0.0, "fused_xla": 1.0, "fused_pallas": 2.0}
            out.append(("tpu_fusion_mode",
                        code.get(str(stats["fusion_mode"]), -1.0)))
        # AQE decision counters likewise keep their RUN_STATS names (no
        # tpu_ prefix: they count scheduler replans — skew splits, join
        # mode switches, mesh replans — not this executor's device work)
        for key in ("skew_splits", "coalesced_partitions",
                    "broadcast_promotions", "broadcast_demotions",
                    "aqe_mesh_replans"):
            if key in stats:
                out.append((key, float(stats[key])))
        # warm-daemon multiplexing gauges keep their RUN_STATS names (no
        # tpu_ prefix: they describe the shared daemon, not this
        # executor's own device work — tpu_daemon_attached above says
        # whether THIS process rode it)
        if "daemon_sessions" in stats:
            out.append(("daemon_sessions", float(stats["daemon_sessions"])))
        if "daemon_queue_depth" in stats:
            out.append(("daemon_queue_depth",
                        float(stats["daemon_queue_depth"])))
        # daemon failure-domain recovery counters (ops/cuda/daemon_route.py
        # mirrors the client's process-lifetime totals into RUN_STATS);
        # RUN_STATS names, no tpu_ prefix — they count daemon incarnations
        # and quarantine events, not this executor's device work
        if "daemon_restarts" in stats:
            out.append(("daemon_restarts", float(stats["daemon_restarts"])))
        if "daemon_crashes_detected" in stats:
            out.append(("daemon_crashes_detected",
                        float(stats["daemon_crashes_detected"])))
        if "watchdog_kills" in stats:
            out.append(("watchdog_kills", float(stats["watchdog_kills"])))
        if "poisoned_stages" in stats:
            out.append(("poisoned_stages", float(stats["poisoned_stages"])))
        if "mesh_mode_reason" in stats:
            # gauges are floats: 1 = the collective exchange ran on-device,
            # 0 = demoted to the host split (the string reason stays in
            # RUN_STATS for bench/exercise output)
            mesh = 1.0 if str(stats["mesh_mode_reason"]) == "mesh" else 0.0
            out.append(("tpu_mesh_mode", mesh))
        from ballista_tpu_torch.ops.cuda import runtime

        cc = runtime.compile_cache_stats()
        if cc["dir"]:
            out.append(("tpu_persist_cache_requests", float(cc["requests"])))
            out.append(("tpu_persist_cache_hits", float(cc["hits"])))
        return out

    def _heartbeat_once(self) -> bool:
        """One heartbeat round-trip. Returns the scheduler's reregister
        flag; while draining we do NOT act on it — the scheduler pops a
        drained executor from its fleet, so reregister-while-draining
        means the handoff finished, not that we should rejoin."""
        req = pb.HeartBeatParams(
            executor_id=self.metadata.id,
            metadata=encode_executor_metadata(self.metadata),
            status="active",
        )
        for name, value in self._overload_metrics():
            req.metrics.add(name=name, value=value)
        resp = self._scheduler.HeartBeatFromExecutor(req, timeout=5)
        if resp.reregister and not self.executor.draining:
            self._register()
        return bool(resp.reregister)

    def _heartbeat_loop(self) -> None:
        while not self._stopping.wait(HEARTBEAT_INTERVAL_S):
            try:
                self._heartbeat_once()
            except grpc.RpcError as e:
                log.warning("heartbeat failed: %s", e.code() if hasattr(e, "code") else e)

    def _poll_loop(self) -> None:
        """Pull mode: PollWork carries statuses and pulls new tasks."""
        from ballista_tpu_torch.serde_control import decode_task_definition

        while not self._stopping.wait(POLL_INTERVAL_S):
            with self._status_lock:
                statuses, self._pending_status = self._pending_status, []
            free = max(0, self.metadata.vcores - self.service._queue.qsize())
            req = pb.PollWorkParams(
                metadata=encode_executor_metadata(self.metadata),
                can_accept_task=free > 0,
                free_slots=free,
            )
            for r in statuses:
                req.task_status.append(encode_task_status(r, self.metadata.id))
            try:
                resp = self._scheduler.PollWork(req, timeout=10)
            except grpc.RpcError as e:
                log.warning("poll failed: %s", e)
                continue
            for tp in resp.tasks:
                task = decode_task_definition(tp)
                cfg = BallistaConfig.from_key_value_pairs(
                    [(kv.key, kv.value) for kv in tp.props], scrub_restricted=True
                )
                self.service._queue.put((task, cfg))

    def _dir_ttl_loop(self) -> None:
        from ballista_tpu_torch.executor.lifecycle import _dir_bytes

        while not self._stopping.wait(DIR_TTL_CHECK_S):
            cutoff = time.time() - self.work_dir_ttl_s
            try:
                for name in os.listdir(self.work_dir):
                    p = os.path.join(self.work_dir, name)
                    if os.path.isdir(p) and os.path.getmtime(p) < cutoff:
                        nbytes = _dir_bytes(p)
                        shutil.rmtree(p, ignore_errors=True)
                        self.executor.gc_reclaimed_bytes += nbytes
                        log.info("TTL-swept job dir %s (%d bytes)", p, nbytes)
            except OSError:
                pass

    def drain(self, timeout_s: float | None = None) -> None:
        """SIGTERM-initiated graceful drain (docs/lifecycle.md
        #drain-protocol). Advertises lifecycle_draining=1 on an immediate
        heartbeat — the scheduler's heartbeat handler runs the drain state
        machine (lease revocation, bounded wait, shuffle handoff) — then
        keeps the data plane up until the scheduler drops us from its
        fleet (reregister-while-draining) or the drain timeout lapses,
        and finally shuts down. A second SIGTERM hard-stops immediately;
        anything not handed off recovers via the recompute path."""
        if self._stopping.is_set():
            return
        if self.executor.draining:
            log.info("second SIGTERM during drain: hard stop")
            self.shutdown()
            return
        self.executor.draining = True
        log.info("draining executor %s (SIGTERM)", self.metadata.id)
        if timeout_s is None:
            from ballista_tpu_torch.config import EXECUTOR_DRAIN_TIMEOUT_S

            timeout_s = float(BallistaConfig().get(EXECUTOR_DRAIN_TIMEOUT_S))
        deadline = time.time() + max(0.0, timeout_s)
        while time.time() < deadline and not self._stopping.is_set():
            try:
                dropped = self._heartbeat_once()
            except grpc.RpcError:
                dropped = False
            if dropped and self.service._queue.unfinished_tasks == 0:
                log.info("drain handoff complete; shutting down")
                break
            time.sleep(1.0)
        self.shutdown()

    def shutdown(self) -> None:
        if self._stopping.is_set():
            return
        self._stopping.set()
        try:
            try:
                self._scheduler.ExecutorStopped(
                    pb.ExecutorStoppedParams(executor_id=self.metadata.id, reason="shutdown"),
                    timeout=3,
                )
            except grpc.RpcError:
                pass
            self.service.stop()
            self.grpc_server.stop(grace=2)
            if self.flight_server is not None:
                self.flight_server.shutdown()
            if self.native_flight_proc is not None:
                self.native_flight_proc.terminate()
                try:
                    self.native_flight_proc.wait(timeout=5)
                except Exception:  # noqa: BLE001
                    self.native_flight_proc.kill()
            self.health_server.shutdown()
        finally:
            self._stopped.set()

    def wait(self) -> None:
        """Until shutdown() has finished, not merely begun: the daemon's
        SIGTERM drain runs shutdown() on a daemon thread, and a main thread
        that returned at its start would exit before the native Flight
        server was stopped, leaving it orphaned (ROADMAP C11)."""
        try:
            while not self._stopped.wait(1.0):
                pass
        except KeyboardInterrupt:
            self.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ballista_tpu_torch executor daemon")
    ap.add_argument("--scheduler", default="localhost:50050", help="scheduler host:port")
    ap.add_argument("--bind-host", default="0.0.0.0")
    ap.add_argument("--external-host", default=None)
    ap.add_argument("--grpc-port", type=int, default=0)
    ap.add_argument("--flight-port", type=int, default=0)
    ap.add_argument("--concurrent-tasks", type=int, default=None, help="vcores (default: all)")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--engine", choices=("cpu", "tpu"), default="cpu")
    ap.add_argument("--policy", choices=("push", "pull"), default="push")
    ap.add_argument("--tls-cert", default=None, help="server certificate chain (PEM)")
    ap.add_argument("--tls-key", default=None, help="server private key (PEM)")
    ap.add_argument("--tls-ca", default=None,
                    help="CA for verifying the scheduler and requiring client certs (mTLS)")
    ap.add_argument("--flight-server", choices=("auto", "python", "native"), default="auto",
                    help="shuffle data plane: native C++ (preferred), python, or auto-fallback")
    ap.add_argument("--task-isolation", choices=("thread", "process"), default="thread",
                    help="process: run each task in a spawned worker — true multi-core "
                         "parallelism, native-crash isolation, preemptive cancel "
                         "(DedicatedExecutor parity); thread: in-process (default)")
    ap.add_argument("--device-ordinal", type=int,
                    default=int(os.environ.get("BALLISTA_DEVICE_ORDINAL", "-1")),
                    help="pin this executor to one accelerator chip (one executor per "
                         "chip; defaults vcores to 1 with --engine tpu). -1 = unpinned")
    ap.add_argument("--memory-pool-bytes", type=int, default=0,
                    help="fixed memory pool size (0 = fraction of cgroup/host)")
    ap.add_argument("--memory-fraction", type=float, default=0.6,
                    help="fraction of detected cgroup/host memory for the pool")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--log-file", default=None, help="also log to this file (rotating)")
    ap.add_argument("--log-rotation", choices=("never", "minutely", "hourly", "daily"),
                    default="daily", help="rotation policy for --log-file")
    args = ap.parse_args(argv)
    from ballista_tpu_torch.utils.log_util import init_logging

    init_logging(args.log_level, args.log_file, args.log_rotation)

    if args.device_ordinal >= 0:
        # must happen before this process creates a CUDA context: a pinned
        # daemon narrows its visible cards to its own one, which it then
        # sees as cuda:0 (runtime.device resolves its ordinal there)
        from ballista_tpu_torch.ops.cuda.runtime import bind_process_ordinal

        if bind_process_ordinal(args.device_ordinal):
            log.info("process bound to device ordinal %d", args.device_ordinal)

    proc = ExecutorProcess(
        args.scheduler, args.bind_host, args.external_host, args.grpc_port,
        args.flight_port, args.concurrent_tasks, args.work_dir, args.engine, args.policy,
        memory_pool_bytes=args.memory_pool_bytes, memory_fraction=args.memory_fraction,
        flight_impl=args.flight_server, device_ordinal=args.device_ordinal,
        tls_cert=args.tls_cert, tls_key=args.tls_key, tls_ca=args.tls_ca,
        task_isolation=args.task_isolation,
    )
    # SIGTERM = graceful drain (handoff shuffle outputs, then exit); a
    # second SIGTERM hard-stops. The handler must not block, so the drain
    # state machine runs on its own thread.
    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=proc.drain, daemon=True,
                                              name="drain").start())
    proc.start()
    proc.wait()


if __name__ == "__main__":
    main()
