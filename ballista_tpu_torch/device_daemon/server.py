"""The device-runtime daemon process.

Counterpart of the JAX package's device_daemon/server.py. One long-lived
process owns the CUDA card: it binds its unix socket FIRST (ping/status
answer while init is still running — a watcher can follow the claim phase
by phase), then runs device init as a supervised, phase-instrumented
state machine:

    platform_probe   import torch and the port's runtime (pure host)
    cuda_devices     bind the ordinal (runtime.bind_process_ordinal) and
                     create the CUDA context on the card
    first_launch     build or load the kernel libraries (ops/cuda/build.py:
                     a library already built under the source hash loads
                     with no nvcc), then launch masked_group_reduce once and
                     hold it against its plain form

Each phase runs under a bounded wall-clock ceiling
(BALLISTA_TPU_DAEMON_INIT_TIMEOUT_S). The probe report at
<socket>.probe.json is rewritten (tmp+rename) on every transition, so
the on-disk record always names the phase in flight and how long it has
been there. On overrun the supervisor dumps every thread's stack into
the report via faulthandler and exits the process: a hang inside a C
extension cannot be cancelled, so the honest move is to die with a
diagnosis instead of holding the socket open forever. A phase that FAILS
(no card, and no BALLISTA_TORCH_PLATFORM=cpu asking for the CPU forms)
names itself in the report and the daemon exits 3 as well: it never
serves from the CPU unless asked to.

After init the daemon serves stage execution: a client ships a
serde-encoded raw stage subtree + its session config; the daemon runs it
through the SAME maybe_compile_tpu entry the in-process engine uses
(byte parity by construction), under the client session's device quota
(hbm.session_quota), and streams the result batches back as Arrow IPC.
Device dispatch is serialized — one stage on the device at a time — and
the wait count is exported as daemon_queue_depth.

The RUNTIME failure domain mirrors the init one
(docs/device_daemon.md#failure-domain): every execute runs under a
per-request watchdog whose deadline the client derived from the stage's
byte estimate (protocol.derive_execute_timeout_s, floored/capped by
ballista.tpu.daemon.execute.timeout.s). A request that overruns is
wedged inside an uncancellable device call, so the watchdog dumps every
thread's stack plus the offending request header into
<socket>.crash.json and exits nonzero — the card must not be held
hostage. A boot GENERATION token minted at bind time is echoed in every
ping/status/execute response: clients key their attach cache on it
(recycled pids cannot alias daemons) and the serving tier's leases
carry it to fence direct dispatch against a silently restarted daemon.
Stages quarantined in <socket>.poison.json by a client that watched
them kill two daemon incarnations are refused outright — a respawned
daemon never crash-loops on a poison stage.

Beyond the reference's ops, `profile` turns a torch.profiler trace of
each execute on or off; status reports the traced executes' device busy
time (the union of their device events).
"""

from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import logging
import os
import socket
import sys
import threading
import time
import traceback

# pyarrow is imported here, on the main thread, before any worker thread
# starts. Imported first on the short-lived init thread (through the
# engine's modules), Arrow's default mimalloc pool dies with that thread
# and the first routed final stage crashes with SIGSEGV in
# combine_chunks on a handler thread (pyarrow 25.0.0; ROADMAP C17, the
# JAX package's daemon's crash).
import pyarrow  # noqa: F401

from ballista_tpu_torch.device_daemon import protocol

log = logging.getLogger(__name__)

INIT_PHASES = ("platform_probe", "cuda_devices", "first_launch")
_INIT_TIMEOUT_S = int(os.environ.get("BALLISTA_TPU_DAEMON_INIT_TIMEOUT_S", "240"))
_IDLE_TIMEOUT_S = int(os.environ.get("BALLISTA_TPU_DAEMON_IDLE_TIMEOUT_S", "0"))
# a session with no execute for this long is dropped from the registry
SESSION_TTL_S = 300.0


class DaemonServer:
    def __init__(self, socket_path: str, *, parent_pid: int = 0,
                 device_ordinal: int = -1, work_dir: str = "",
                 init_timeout_s: int = _INIT_TIMEOUT_S,
                 idle_timeout_s: int = _IDLE_TIMEOUT_S):
        self.socket_path = socket_path
        self.report_path = protocol.probe_report_path(socket_path)
        self.crash_path = protocol.crash_report_path(socket_path)
        self.parent_pid = parent_pid
        self.device_ordinal = device_ordinal
        self.work_dir = work_dir or os.path.join(
            os.path.dirname(socket_path) or ".", "daemon_work")
        self.init_timeout_s = init_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.started_at = time.time()
        self.last_request_at = time.time()
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        # init state machine
        self._init_lock = threading.Lock()
        self._phases: dict[str, dict] = {
            p: {"name": p, "status": "pending", "s": 0.0} for p in INIT_PHASES}
        self._phase_started_at = 0.0
        self._current_phase: str | None = None
        self._init_ok = False
        self._init_error: str | None = None
        self._init_done = threading.Event()
        self._probe_extra: dict = {}
        self._exit_code = 0
        # torch.profiler around each execute while on (the `profile` op):
        # the traced executes' device busy milliseconds, summed
        self._profile = False
        self.device_busy_ms = 0.0
        self.traced_executes = 0
        # execution
        self._exec_lock = threading.Lock()  # one stage on the device at a time
        self._queue_depth = 0
        self._counters_lock = threading.Lock()
        self.execute_count = 0
        self.clear_count = 0
        self._sessions: dict[str, dict] = {}
        # boot generation token: minted at bind, echoed in every response.
        # Empty until the socket is bound — a daemon that never owned the
        # address has no incarnation to name.
        self.generation = ""
        # per-request execute watchdog: in-flight requests keyed by a
        # monotonic id; the watchdog thread kills the process (with a
        # crash artifact) when one overruns its deadline
        self._inflight_lock = threading.Lock()
        self._inflight: dict[int, dict] = {}
        self._inflight_seq = 0

    # ---------------------------------------------------------- init phases

    def _phase(self, name: str):
        server = self

        class _Scope:
            def __enter__(self):
                with server._init_lock:
                    server._current_phase = name
                    server._phase_started_at = time.time()
                    server._phases[name]["status"] = "running"
                server._write_report()
                return self

            def __exit__(self, et, ev, tb):
                dt = time.time() - server._phase_started_at
                with server._init_lock:
                    server._phases[name]["s"] = round(dt, 3)
                    server._phases[name]["status"] = "error" if et else "ok"
                    if et:
                        server._phases[name]["error"] = f"{et.__name__}: {ev}"[:500]
                    server._current_phase = None
                server._write_report()
                return False

        return _Scope()

    def _init_main(self) -> None:
        try:
            with self._phase("platform_probe"):
                import torch

                from ballista_tpu_torch.ops.cuda import runtime

                self._probe_extra["torch_version"] = torch.__version__
                self._probe_extra["torch_cuda"] = torch.version.cuda
                self._probe_extra["platform_request"] = (
                    os.environ.get(runtime.PLATFORM_ENV) or "(card)")
            with self._phase("cuda_devices"):
                dev = self._claim_device(torch, runtime)
            with self._phase("first_launch"):
                self._first_launch(torch, dev)
            from ballista_tpu_torch.config import BallistaConfig
            from ballista_tpu_torch.ops.cuda import hbm

            # the budget every session's admission starts from (before its
            # quota): sized from the whole card, so whatever else holds
            # memory on it when the daemon starts is not counted
            self._probe_extra["budget_bytes"] = hbm.resolve_hbm_budget(BallistaConfig())
            self._init_ok = True
        except Exception:  # noqa: BLE001 — the report is the diagnosis
            self._init_error = traceback.format_exc(limit=20)
        finally:
            self._init_done.set()
            self._write_report()
            if not self._init_ok and not self._stop.is_set():
                # no card (or a failed first launch): never serve from the
                # CPU unless BALLISTA_TORCH_PLATFORM=cpu asked for it
                log.error("init failed — exiting; report in %s", self.report_path)
                self._exit_code = 3
                self.shutdown()

    def _claim_device(self, torch, runtime):
        """Phase cuda_devices: bind the ordinal before the first CUDA call,
        then create the context. With BALLISTA_TORCH_PLATFORM=cpu the
        device engine runs its CPU forms and no context is made."""
        if runtime.cpu_requested():
            self._probe_extra.update(platform="cpu", device_kind="cpu", device_count=0)
            return torch.device("cpu")
        if self.device_ordinal >= 0:
            runtime.bind_process_ordinal(self.device_ordinal)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (set BALLISTA_TORCH_PLATFORM=cpu to "
                "serve the CPU forms)")
        dev = runtime.device(self.device_ordinal)
        torch.zeros(1, device=dev)  # the context
        torch.cuda.synchronize(dev)
        props = torch.cuda.get_device_properties(dev)
        self._probe_extra.update(
            platform="cuda", device_kind=torch.cuda.get_device_name(dev),
            device_count=torch.cuda.device_count(), device_memory_bytes=int(props.total_memory),
            cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"))
        return dev

    def _first_launch(self, torch, dev) -> None:
        """Phase first_launch: build (or load, when the build directory
        holds them under the sources' hash) every kernel library, launch
        masked_group_reduce once and hold it against its plain form. The
        launch is not counted: the counts start at 0 for served work."""
        from ballista_tpu_torch.ops.cuda import build, runtime
        from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

        if dev.type == "cuda":
            t0 = time.time()
            build.build_all()
            self._probe_extra["kernels_built"] = sorted(build.LOGS)  # nvcc runs here
            self._probe_extra["build_s"] = round(time.time() - t0, 3)
        g = torch.Generator().manual_seed(0)
        vals = torch.rand((2, 4099), generator=g)
        gid = torch.randint(0, 8, (2, 4099), generator=g, dtype=torch.int32)
        mask = torch.rand((2, 4099), generator=g) < 0.5
        vals, gid, mask = vals.to(dev), gid.to(dev), mask.to(dev)
        sums, cnts = ck.masked_group_reduce(vals, gid, mask, 8)
        want_s, want_c = ck.masked_group_reduce_plain(vals, gid, mask, 8)
        if not (torch.equal(cnts, want_c)
                and torch.allclose(sums, want_s, rtol=1e-4, atol=1e-4)):
            raise RuntimeError("masked_group_reduce disagrees with its plain form")
        ck.reset_launches()
        self._probe_extra["kernel_loads"] = runtime.compile_cache_stats()

    def _supervise_init(self) -> None:
        """Watch the init thread against the per-phase ceiling. A phase
        that overruns cannot be cancelled (it is wedged inside a C
        extension), so: snapshot every thread's stack into the probe
        report, then exit the process with a distinct code."""
        while not self._init_done.wait(1.0):
            with self._init_lock:
                phase, t0 = self._current_phase, self._phase_started_at
            if phase and time.time() - t0 > self.init_timeout_s:
                buf = io.StringIO()
                faulthandler.dump_traceback(file=buf)
                with self._init_lock:
                    self._phases[phase]["status"] = "timeout"
                    self._phases[phase]["s"] = round(time.time() - t0, 3)
                self._probe_extra["stack"] = buf.getvalue()[-8000:]
                self._init_error = (
                    f"init phase {phase!r} exceeded {self.init_timeout_s}s")
                self._write_report()
                log.error("%s — exiting with stack snapshot in %s",
                          self._init_error, self.report_path)
                os._exit(3)

    def _write_report(self) -> None:
        with self._init_lock:
            report = {
                "pid": os.getpid(),
                "socket": self.socket_path,
                "ok": self._init_ok,
                "error": self._init_error,
                "phases": [dict(self._phases[p]) for p in INIT_PHASES],
                "phase_timeout_s": self.init_timeout_s,
                "written_at": round(time.time() - self.started_at, 3),
            }
            report.update(self._probe_extra)
        tmp = self.report_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, self.report_path)
        except OSError:  # report is best-effort; never kill init over it
            log.warning("could not write probe report %s", self.report_path,
                        exc_info=True)

    # ------------------------------------------------------------- serving

    def _bind(self) -> socket.socket:
        # stale-socket handling daemon-side: if the path exists, probe it.
        # A live daemon answering ping means we must NOT steal the address;
        # a dead one (connection refused) gets unlinked.
        if os.path.exists(self.socket_path):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(1.0)
                probe.connect(self.socket_path)
                probe.close()
                raise RuntimeError(
                    f"daemon already serving {self.socket_path}")
            except (ConnectionRefusedError, socket.timeout, FileNotFoundError,
                    OSError):
                probe.close()
                with contextlib.suppress(OSError):
                    os.unlink(self.socket_path)
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(self.socket_path)
        lst.listen(16)
        # the address is ours: mint this incarnation's generation token
        # (time + pid — unique even across pid recycling) and remove the
        # previous corpse's artifacts, so post-mortem tooling never reads
        # a stale probe/crash report as if it were this daemon's
        self.generation = f"{int(time.time() * 1e6):x}-{os.getpid():x}"
        for stale in (self.report_path, self.crash_path):
            with contextlib.suppress(OSError):
                os.unlink(stale)
        return lst

    def serve_forever(self) -> int:
        os.makedirs(self.work_dir, exist_ok=True)
        self._listener = self._bind()
        # mark this process so clear_device_caches() inside the daemon
        # never tries to route back to a daemon (self-attach recursion)
        from ballista_tpu_torch.device_daemon import client as dclient

        dclient.mark_in_daemon()
        self._write_report()
        threading.Thread(target=self._init_main, name="daemon-init",
                         daemon=True).start()
        threading.Thread(target=self._supervise_init, name="daemon-init-watch",
                         daemon=True).start()
        threading.Thread(target=self._reaper, name="daemon-reaper",
                         daemon=True).start()
        threading.Thread(target=self._watchdog, name="daemon-exec-watch",
                         daemon=True).start()
        log.info("device daemon pid=%d serving %s", os.getpid(), self.socket_path)
        self._listener.settimeout(1.0)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            with contextlib.suppress(OSError):
                self._listener.close()
            with contextlib.suppress(OSError):
                os.unlink(self.socket_path)
        return self._exit_code

    def _reaper(self) -> None:
        """Parent-death + idle watchdog: a daemon spawned for a bench leg
        or a test must not outlive its reason to exist and sit on the
        device claim forever."""
        while not self._stop.wait(2.0):
            if self.parent_pid:
                try:
                    os.kill(self.parent_pid, 0)
                except OSError:
                    log.info("parent pid %d gone; exiting", self.parent_pid)
                    self.shutdown()
                    return
            if (self.idle_timeout_s > 0
                    and time.time() - self.last_request_at > self.idle_timeout_s):
                log.info("idle for %ds; exiting", self.idle_timeout_s)
                self.shutdown()
                return

    def shutdown(self) -> None:
        self._stop.set()
        with contextlib.suppress(OSError):
            if self._listener is not None:
                self._listener.close()

    # ------------------------------------------------- execute watchdog

    @contextlib.contextmanager
    def _watched(self, header: dict, deadline_s: float):
        """Register one execute request with the watchdog for its on-device
        span. The entry carries everything the post-mortem needs: the
        request header (minus the bulky config pairs), the session, and a
        mutable phase the handler advances (recompile → execute → pack)."""
        entry = {
            "header": {k: v for k, v in header.items() if k != "pairs"},
            "session": str(header.get("session") or "anonymous"),
            "phase": "recompile",
            "started": time.time(),
            "deadline_s": float(deadline_s),
        }
        with self._inflight_lock:
            self._inflight_seq += 1
            rid = self._inflight_seq
            self._inflight[rid] = entry
        try:
            yield entry
        finally:
            with self._inflight_lock:
                self._inflight.pop(rid, None)

    def _watchdog(self) -> None:
        """Kill the process when an in-flight execute overruns its
        deadline. Same rationale as the init supervisor: a wedged device call
        cannot be cancelled, so the honest move is a diagnosed death — the
        crash artifact names the offending request, and the client's
        respawn ladder (plus the poison quarantine on a repeat) takes it
        from there."""
        while not self._stop.wait(0.5):
            now = time.time()
            with self._inflight_lock:
                overrun = [dict(e) for e in self._inflight.values()
                           if e["deadline_s"] > 0
                           and now - e["started"] > e["deadline_s"]]
            if overrun:
                worst = max(overrun, key=lambda e: now - e["started"])
                self._write_crash_report("watchdog", worst)
                log.error(
                    "execute watchdog: request %s overran %.1fs deadline in "
                    "phase %s — exiting with crash report at %s",
                    worst["header"].get("tag"), worst["deadline_s"],
                    worst["phase"], self.crash_path)
                os._exit(4)

    def _write_crash_report(self, kind: str, entry: dict) -> None:
        """<socket>.crash.json: every thread's stack (faulthandler), the
        offending request header, session, phase, and process rusage —
        written tmp+rename immediately before the process exits."""
        from ballista_tpu_torch.ops.cuda import runtime

        # faulthandler writes at the fd level (it must work even when the
        # interpreter is wedged), so dump through a real file, not StringIO
        stacks = ""
        try:
            with open(self.crash_path + ".stacks", "w+") as f:
                faulthandler.dump_traceback(file=f)
                f.seek(0)
                stacks = f.read()
            os.unlink(self.crash_path + ".stacks")
        except Exception:  # noqa: BLE001 — post-mortem must still be written
            stacks = "".join(
                f"\nThread {tid}:\n" + "".join(traceback.format_stack(frame))
                for tid, frame in sys._current_frames().items())
        report = {
            "kind": kind,
            "pid": os.getpid(),
            "generation": self.generation,
            "socket": self.socket_path,
            "request": entry.get("header", {}),
            "session": entry.get("session"),
            "phase": entry.get("phase"),
            "deadline_s": entry.get("deadline_s"),
            "elapsed_s": round(time.time() - entry.get("started", time.time()), 3),
            "rusage": runtime.process_rusage(),
            "stacks": stacks[-16000:],
            "written_at": time.time(),
        }
        tmp = self.crash_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, self.crash_path)
        except OSError:
            log.warning("could not write crash report %s", self.crash_path,
                        exc_info=True)

    # ---------------------------------------------------- chaos arming

    def _maybe_chaos(self, cfg, point: str) -> None:
        """Deterministic daemon-fault injection (executor/chaos.py modes
        daemon_crash / daemon_hang). Armed through the session config the
        client already ships, at exactly one arming point
        (ballista.chaos.daemon.arm). With ballista.chaos.daemon.once a
        marker file next to the socket limits the fault to the FIRST
        armed request PER SOCKET — the marker survives respawns, so the
        retry against the fresh daemon succeeds (the recovery test);
        without it every incarnation dies and the poison quarantine is
        what breaks the crash loop (the quarantine test)."""
        from ballista_tpu_torch.config import (
            CHAOS_DAEMON_ARM,
            CHAOS_DAEMON_ONCE,
            CHAOS_ENABLED,
            CHAOS_MODE,
        )

        if not bool(cfg.get(CHAOS_ENABLED)):
            return
        mode = str(cfg.get(CHAOS_MODE))
        if mode not in ("daemon_crash", "daemon_hang"):
            return
        if str(cfg.get(CHAOS_DAEMON_ARM)) != point:
            return
        if bool(cfg.get(CHAOS_DAEMON_ONCE)):
            marker = f"{self.socket_path}.chaos.{mode}.{point}"
            try:
                os.close(os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            except FileExistsError:
                return  # already fired once for this socket
            except OSError:
                pass  # unmarkable filesystem: fire anyway, stay deterministic
        if mode == "daemon_crash":
            log.error("chaos: daemon_crash armed at %s — dying uncleanly", point)
            os._exit(137)  # SIGKILL's exit code: an undiagnosed death
        log.error("chaos: daemon_hang armed at %s — wedging the execute "
                  "thread until the watchdog fires", point)
        while True:  # the watchdog converts this into a diagnosed kill
            time.sleep(0.25)

    @contextlib.contextmanager
    def _traced(self):
        """A torch.profiler trace (CUDA activity) of one execute while the
        `profile` op has it on; yields None otherwise."""
        if not self._profile:
            yield None
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        on_card = torch.cuda.is_initialized()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            yield prof
            if on_card:
                torch.cuda.synchronize()

    def _note_busy(self, prof) -> None:
        """Add one trace's device busy milliseconds: the union of its device
        events' intervals (kernels, copies, fills)."""
        from torch.autograd import DeviceType

        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, reach = 0.0, float("-inf")
        for start, end in spans:
            if end > reach:
                busy_us += end - max(start, reach)
                reach = end
        with self._counters_lock:
            self.device_busy_ms += busy_us / 1e3
            self.traced_executes += 1

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                header, body = protocol.recv_msg(conn)
                self.last_request_at = time.time()
                resp_header, resp_body = self._dispatch(header, body)
                protocol.send_msg(conn, resp_header, resp_body)
        except protocol.ProtocolError:
            pass  # client went away mid-frame; its problem, not ours
        except Exception:  # noqa: BLE001 — one bad request must not kill serving
            log.warning("request failed", exc_info=True)
            with contextlib.suppress(Exception):
                protocol.send_msg(conn, {"ok": False,
                                         "error": traceback.format_exc(limit=5)})

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, header: dict, body: bytes) -> tuple[dict, bytes]:
        op = header.get("op")
        if header.get("v", protocol.PROTOCOL_VERSION) != protocol.PROTOCOL_VERSION:
            return {"ok": False, "error": "protocol version mismatch"}, b""
        if op == "ping":
            return {"ok": True, "pid": os.getpid(), "gen": self.generation,
                    "ready": self._init_ok}, b""
        if op == "status":
            return {"ok": True, **self._status()}, b""
        if op == "shutdown":
            self.shutdown()
            return {"ok": True}, b""
        if op == "clear_caches":
            return self._handle_clear()
        if op == "profile":
            with self._counters_lock:
                self._profile = bool(header.get("on"))
            return {"ok": True, "profile": self._profile}, b""
        if op == "execute":
            return self._handle_execute(header, body)
        return {"ok": False, "error": f"unknown op {op!r}"}, b""

    def _status(self) -> dict:
        with self._init_lock:
            init = {
                "ok": self._init_ok,
                "error": self._init_error,
                "phases": [dict(self._phases[p]) for p in INIT_PHASES],
                "current": self._current_phase,
            }
        self._prune_sessions()
        with self._counters_lock:
            sessions = {sid: {"quota_bytes": s["quota_bytes"],
                              "executes": s["executes"]}
                        for sid, s in self._sessions.items()}
        device: dict = {}
        if self._init_ok:
            import ballista_tpu_torch.ops.cuda.stage_compiler as sc
            from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
            from ballista_tpu_torch.ops.cuda import runtime

            device = {
                "resident_tables": len(sc.DEVICE_CACHE),
                "resident_bytes": sc.DEVICE_CACHE.resident_bytes(),
                "table_fills": sc.DEVICE_CACHE.fills,
                "table_hits": sc.DEVICE_CACHE.hits,
                "lut_entries": len(sc._LUT_CACHE),
                "build_entries": len(sc._BUILD_CACHE),
                "launches": dict(ck.LAUNCHES),
                "persist_cache": runtime.compile_cache_stats(),
                "budget_bytes": self._probe_extra.get("budget_bytes"),
                "device_busy_ms": self.device_busy_ms,
                "traced_executes": self.traced_executes,
            }
        return {
            "pid": os.getpid(),
            "gen": self.generation,
            "uptime_s": round(time.time() - self.started_at, 1),
            "ready": self._init_ok,
            "init": init,
            "sessions": len(sessions),
            "session_detail": sessions,
            "queue_depth": self._queue_depth,
            "execute_count": self.execute_count,
            "clear_count": self.clear_count,
            "platform": self._probe_extra.get("platform"),
            "device_kind": self._probe_extra.get("device_kind"),
            **device,
        }

    def _prune_sessions(self) -> None:
        cutoff = time.time() - SESSION_TTL_S
        with self._counters_lock:
            for sid in [s for s, v in self._sessions.items()
                        if v["last_used"] < cutoff]:
                del self._sessions[sid]

    def _handle_clear(self) -> tuple[dict, bytes]:
        if not self._init_ok:
            return {"ok": True, "note": "init incomplete; nothing resident"}, b""
        import ballista_tpu_torch.ops.cuda.stage_compiler as sc

        sc.clear_device_caches()
        with self._counters_lock:
            self.clear_count += 1
        return {"ok": True}, b""

    def _handle_execute(self, header: dict, body: bytes) -> tuple[dict, bytes]:
        # block until init lands (bounded: the supervisor kills the process
        # on a hung phase, which drops this connection — the client sees
        # the error and falls back in-process)
        self._init_done.wait()
        if not self._init_ok:
            return {"ok": False,
                    "error": f"daemon init failed: {self._init_error}"}, b""
        from ballista_tpu_torch import serde
        from ballista_tpu_torch.config import (
            TPU_DAEMON_ENABLED,
            TPU_DAEMON_EXECUTE_TIMEOUT_S,
            TPU_DAEMON_POISON_TTL_S,
            TPU_DAEMON_SESSION_QUOTA_BYTES,
            BallistaConfig,
        )
        import ballista_tpu_torch.ops.cuda.stage_compiler as sc
        from ballista_tpu_torch.device_daemon import client as dclient
        from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
        from ballista_tpu_torch.ops.cuda import hbm
        from ballista_tpu_torch.plan.physical import TaskContext

        cfg = BallistaConfig.from_key_value_pairs(
            [(k, v) for k, v in header.get("pairs", [])], scrub_restricted=True)
        # never re-enter the daemon path from inside the daemon
        cfg.set(TPU_DAEMON_ENABLED, False)
        tag = str(header.get("tag", ""))
        poison_ttl = float(cfg.get(TPU_DAEMON_POISON_TTL_S))
        if tag and dclient.is_poisoned(self.socket_path, tag, poison_ttl):
            # this stage has killed two daemon incarnations already; refusing
            # it here is what breaks the crash loop — the client demotes it
            # to the in-process/CPU ladder
            return {"ok": False, "poisoned": True, "gen": self.generation,
                    "error": f"stage {tag} is quarantined in "
                             f"{protocol.poison_path(self.socket_path)}; "
                             "run it in-process"}, b""
        deadline_s = float(header.get("deadline_s") or 0.0)
        if deadline_s <= 0:
            deadline_s = protocol.derive_execute_timeout_s(
                float(cfg.get(TPU_DAEMON_EXECUTE_TIMEOUT_S)), 0)
        try:
            with self._watched(header, deadline_s) as went:
                self._maybe_chaos(cfg, "pre_execute")
                plan = serde.plan_from_bytes(body)
                compiled = maybe_compile_tpu(plan, cfg)
                emit_pid = header.get("emit_pid")
                if emit_pid is not None:
                    if not isinstance(compiled, sc.TpuStageExec):
                        return {"ok": False, "gen": self.generation, "error":
                                "device-routed stage did not recompile to a "
                                "device stage daemon-side; client must run it "
                                "locally"}, b""
                    compiled.emit_pid = (list(emit_pid[0]), int(emit_pid[1]))

                session = str(header.get("session") or "anonymous")
                quota = int(cfg.get(TPU_DAEMON_SESSION_QUOTA_BYTES))
                with self._counters_lock:
                    s = self._sessions.setdefault(
                        session, {"quota_bytes": quota, "executes": 0,
                                  "last_used": time.time()})
                    s["quota_bytes"] = quota
                    s["last_used"] = time.time()
                    s["executes"] += 1
                    self._queue_depth += 1
                try:
                    with self._exec_lock:
                        with self._counters_lock:
                            self._queue_depth -= 1
                        # the deadline covers the on-device span, not the
                        # queue wait behind other sessions: restart the
                        # clock now that the device is ours
                        went["phase"] = "execute"
                        went["started"] = time.time()
                        self._maybe_chaos(cfg, "mid_execute")
                        ctx = TaskContext(
                            cfg, task_id=f"daemon-{self.execute_count}",
                            work_dir=self.work_dir)
                        ctx.device_ordinal = self.device_ordinal
                        partitions = [int(p)
                                      for p in header.get("partitions", [])]
                        # snapshot the engine stats so the mirror below can
                        # diff: a routed final/mesh stage publishes its inner
                        # partial-stage recs under THEIR tags, not the
                        # request's
                        before = {t: dict(r)
                                  for t, r in sc.RUN_STATS.stages().items()}
                        with hbm.session_quota(quota), self._traced() as trace:
                            results = {p: list(compiled.execute(p, ctx))
                                       for p in partitions}
                        if trace is not None:
                            self._note_busy(trace)
                    with self._counters_lock:
                        self.execute_count += 1
                except Exception:  # noqa: BLE001
                    with self._counters_lock:
                        self._queue_depth = max(0, self._queue_depth)
                    return {"ok": False, "gen": self.generation,
                            "error": traceback.format_exc(limit=10)}, b""
                went["phase"] = "pack"
                segments, resp_body = protocol.pack_results(results)
                # mirror this run's engine stats back to the caller: the
                # client's RUN_STATS (heartbeat, bench events) reports the
                # device work even though it happened in this process. Merge
                # every rec the request CHANGED (a daemon-routed final/mesh
                # stage runs inner partial stages under their own tags), with
                # the request's own tag applied last so it wins collisions.
                stats: dict = {}
                after = sc.RUN_STATS.stages()
                changed = [t for t, r in after.items() if r != before.get(t)]
                for t in sorted(changed, key=lambda t: t == tag):
                    stats.update({k: v for k, v in after[t].items()
                                  if isinstance(v, (int, float, str, bool))})
                init_s = {p["name"]: p["s"]
                          for p in self._status()["init"]["phases"]}
                self._maybe_chaos(cfg, "post_execute")
                return {"ok": True, "segments": segments, "stats": stats,
                        "gen": self.generation,
                        "sessions": len(self._sessions),
                        "queue_depth": self._queue_depth,
                        "init_phase_s": init_s,
                        "device_runs": getattr(compiled, "tpu_count", 0),
                        "cpu_fallbacks": getattr(compiled, "fallback_count", 0),
                        }, resp_body
        except Exception:  # noqa: BLE001 — serde/compile failures pre-exec
            return {"ok": False, "gen": self.generation,
                    "error": traceback.format_exc(limit=10)}, b""


# ------------------------------------------------------- Flight variant

def serve_flight(server: DaemonServer, port: int):
    """Optional Flight `do_exchange` front-end over the same dispatcher,
    for callers that already speak Flight (the serving tier's proxies).
    The request header rides the descriptor command; result batches
    stream back with the partition index in app_metadata and the stats
    header as a trailing metadata-only message. Returns the running
    Flight server, or None when the Flight stack is not importable."""
    try:
        import pyarrow.flight as flight
    except Exception:  # noqa: BLE001 — optional dependency surface
        log.info("pyarrow.flight unavailable; UDS only")
        return None

    class _DaemonFlight(flight.FlightServerBase):
        def __init__(self):
            super().__init__(f"grpc://127.0.0.1:{port}")

        def do_exchange(self, context, descriptor, reader, writer):
            header = json.loads(descriptor.command.decode())
            body = bytes.fromhex(header.pop("body_hex", ""))
            resp, resp_body = server._dispatch(header, body)
            results = (protocol.unpack_results(resp.get("segments", []), resp_body)
                       if resp.get("ok") and "segments" in resp else {})
            started = False
            for part in sorted(results):
                for b in results[part]:
                    if not started:
                        writer.begin(b.schema)
                        started = True
                    writer.write_with_metadata(b, str(part).encode())
            resp.pop("segments", None)
            writer.write_metadata(json.dumps(resp).encode())

    fs = _DaemonFlight()
    threading.Thread(target=fs.serve, daemon=True).start()
    return fs
