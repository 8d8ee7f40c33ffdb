"""Attach-first client for the device-runtime daemon.

This module makes no torch.cuda call and imports nothing that does: it is
reached (lazily) from the stage compiler and from the executor, and an
attached client process must end with `torch.cuda.is_initialized()` false
(the port's form of the JAX package's "an attached client never imports
jax"). Everything here is sockets + JSON + pyarrow IPC; the device
runtime lives daemon-side.

Attach policy (`attach(config)` under the ballista.tpu.daemon.* knobs):

1. daemon disabled          → (None, "in_process", "daemon disabled")
2. live daemon answers ping → (client, "attached", socket path)
3. stale socket (file exists, connect refused) → unlink it, then
4. spawn knob on            → spawn `python -m ballista_tpu_torch.device_daemon`
   detached (on the card this process is bound to, if any), wait for its
   socket within the attach timeout, adopt it
5. otherwise                → (None, "in_process", the failure reason)

The result is cached per (socket, daemon pid, generation token): a
process that attached once keeps its client until the daemon dies or is
replaced — a recycled pid alone cannot alias a NEW daemon onto an old
attachment, because the bind-time generation token must match too — at
which point the next attach retries the ladder from the top. Fallback
is never an error — the in-process engine is always behind it.

Failure domain (docs/device_daemon.md#failure-domain): a daemon that
dies mid-request surfaces as the typed `DaemonCrashed`; the stage
dispatcher (ops/cuda/daemon_route.py) respawns and retries ONCE per
stage fingerprint, and a second crash of the same fingerprint lands in
the on-disk poison quarantine (`<socket>.poison.json`) this module
maintains, so respawned daemons refuse the stage and it demotes to the
in-process/CPU ladder instead of crash-looping.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

from ballista_tpu_torch.device_daemon import protocol

# set inside the daemon process itself: clear_attached_caches() and
# attach() become no-ops there, so daemon-side stage execution can never
# recurse into another daemon
_IN_DAEMON = False

_CACHE_LOCK = threading.Lock()
# socket path → (DaemonClient, daemon_pid, generation) for processes that attached
# analysis: ignore[bounded-cache] one entry per daemon socket this process attaches to; bounded by deployment topology (typically 1)
_ATTACHED: dict[str, tuple["DaemonClient", int, str]] = {}
# socket path → the daemon process this process spawned last for it (the
# respawn leg of the ladder), so its owner can stop it and read its exit
# analysis: ignore[bounded-cache] one entry per daemon socket this process spawns for; bounded by deployment topology (typically 1)
_SPAWNED: dict[str, subprocess.Popen] = {}

# a stage fingerprint gets ONE respawn-and-retry; the second crash
# poisons it (docs/device_daemon.md#failure-domain)
POISON_CRASH_THRESHOLD = 2

# process-lifetime failure-domain counters, mirrored into RUN_STATS by
# ops/cuda/daemon_route.py so they ride the executor heartbeat
_COUNTERS_LOCK = threading.Lock()
_COUNTERS = {"daemon_restarts": 0, "daemon_crashes_detected": 0,
             "watchdog_kills": 0, "poisoned_stages": 0}


def mark_in_daemon() -> None:
    global _IN_DAEMON
    _IN_DAEMON = True


def reset_attach_cache() -> None:
    """Test hook: forget cached attachments (e.g. after killing a daemon)."""
    with _CACHE_LOCK:
        _ATTACHED.clear()


def drop_attached(path: str) -> None:
    """Forget one cached attachment (a detected crash invalidates it)."""
    with _CACHE_LOCK:
        _ATTACHED.pop(path, None)


def attached_generation(path: str | None = None) -> str:
    """Generation token of the daemon this process is attached to ("" when
    not attached). With no path, the most recent attachment wins — the
    common deployment has exactly one daemon per host. Used by the
    serving tier's lease fencing (serving/lease.py)."""
    with _CACHE_LOCK:
        if path is not None:
            cached = _ATTACHED.get(path)
            return cached[2] if cached else ""
        gen = ""
        for _, _, g in _ATTACHED.values():
            gen = g
        return gen


def bump_counter(key: str, n: int = 1) -> int:
    with _COUNTERS_LOCK:
        _COUNTERS[key] = _COUNTERS.get(key, 0) + n
        return _COUNTERS[key]


def failure_counters() -> dict:
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def reset_failure_counters() -> None:
    """Test hook."""
    with _COUNTERS_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


class DaemonUnavailable(RuntimeError):
    pass


class DaemonCrashed(DaemonUnavailable):
    """The daemon died (or stopped answering) MID-REQUEST: the request was
    sent and the reply never completed. Distinct from DaemonUnavailable's
    connect-time failure because the remediation differs — a crash mid-
    execute gets a bounded respawn-and-retry, a dead socket just falls
    back in-process. `reason` is one of eof/reset/timeout/send."""

    def __init__(self, msg: str, reason: str = "eof"):
        super().__init__(msg)
        self.reason = reason


class DaemonClient:
    """One request per connection; safe to share across threads."""

    # default request ceiling covers the cheap control ops (status, clear,
    # shutdown); execute always passes an explicit deadline derived from
    # the stage's byte estimate (protocol.derive_execute_timeout_s) — the
    # former 3600s blanket default let a wedged device call hold a client
    # for an hour. Attach liveness is separately bounded by ping's 2s.
    def __init__(self, socket_path: str, timeout_s: float = 60.0):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        # generation token of the daemon this client last spoke to;
        # refreshed by ping (attach stores it in the cache key)
        self.generation = ""

    def _request(self, header: dict, body: bytes = b"",
                 timeout_s: float | None = None) -> tuple[dict, bytes]:
        header = dict(header)
        header["v"] = protocol.PROTOCOL_VERSION
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sent = False
        try:
            sock.settimeout(timeout_s if timeout_s is not None else self.timeout_s)
            try:
                sock.connect(self.socket_path)
            except OSError as e:
                raise DaemonUnavailable(f"connect {self.socket_path}: {e}") from e
            try:
                protocol.send_msg(sock, header, body)
                sent = True
                resp, resp_body = protocol.recv_msg(sock)
            except socket.timeout as e:
                # past the derived deadline with no reply: the daemon-side
                # watchdog should already have killed the process — treat
                # the silence as a crash either way (same remediation)
                raise DaemonCrashed(
                    f"daemon unresponsive past deadline: {e}",
                    reason="timeout") from e
            except (protocol.ProtocolError, OSError) as e:
                # EOF / ECONNRESET after the request went out = the daemon
                # died mid-frame; before the send it's a plain availability
                # failure (attach-time, benign)
                if sent:
                    raise DaemonCrashed(
                        f"daemon hung up mid-request: {e}",
                        reason="reset" if isinstance(e, ConnectionResetError)
                        else "eof") from e
                raise DaemonCrashed(f"daemon refused request: {e}",
                                    reason="send") from e
        finally:
            sock.close()
        return resp, resp_body

    def ping(self, timeout_s: float = 2.0) -> dict:
        resp, _ = self._request({"op": "ping"}, timeout_s=timeout_s)
        self.generation = str(resp.get("gen", ""))
        return resp

    def status(self) -> dict:
        resp, _ = self._request({"op": "status"})
        if not resp.get("ok"):
            raise DaemonUnavailable(resp.get("error", "status failed"))
        return resp

    def wait_ready(self, timeout_s: float, poll_s: float = 0.5) -> dict:
        """Poll status until init lands; raises with the init report's
        last phase on timeout or daemon death. Tolerates the socket not
        being bound yet (a just-spawned daemon binds before init, but the
        bind itself takes a beat)."""
        deadline = time.time() + timeout_s
        last: dict = {}
        while time.time() < deadline:
            try:
                last = self.status()
            except DaemonUnavailable as e:
                last = {"init": {"current": f"socket not up ({e})"}}
                time.sleep(poll_s)
                continue
            if last.get("ready"):
                return last
            init = last.get("init") or {}
            if init.get("error"):
                raise DaemonUnavailable(f"daemon init failed: {init['error']}")
            time.sleep(poll_s)
        phase = ((last.get("init") or {}).get("current")) or "unknown"
        raise DaemonUnavailable(
            f"daemon not ready within {timeout_s}s (init phase: {phase})")

    def execute(self, plan_bytes: bytes, pairs: list, partitions: list,
                *, emit_pid=None, session: str = "", tag: str = "",
                deadline_s: float = 0.0,
                timeout_s: float | None = None) -> tuple[dict, dict]:
        """Ship one stage; returns ({partition: [batches]}, response header
        with daemon-side stats). Raises DaemonCrashed when the daemon dies
        mid-request (the caller's respawn/quarantine ladder handles it),
        DaemonUnavailable on connect failure, and RuntimeError when the
        daemon reports an execution error — the last two mean 'run it
        in-process instead'. `deadline_s` rides the header so the daemon's
        watchdog enforces the SAME bound server-side; the client socket
        waits a little longer, so the watchdog's diagnosed kill (crash
        artifact + nonzero exit) wins the race against a bare timeout."""
        header = {
            "op": "execute",
            "pairs": [[str(k), str(v)] for k, v in pairs],
            "partitions": [int(p) for p in partitions],
            "session": session or f"{socket.gethostname()}:{os.getpid()}",
            "tag": tag,
        }
        if deadline_s > 0:
            header["deadline_s"] = round(float(deadline_s), 3)
            if timeout_s is None:
                timeout_s = deadline_s * 1.25 + 15.0
        if emit_pid is not None:
            header["emit_pid"] = [list(emit_pid[0]), int(emit_pid[1])]
        resp, body = self._request(header, plan_bytes, timeout_s=timeout_s)
        if not resp.get("ok"):
            err = RuntimeError(f"daemon execute failed: {resp.get('error')}")
            # a respawned daemon refusing a quarantined stage is a clean
            # demotion signal, not a crash — mark it so the dispatcher
            # doesn't count it against the fingerprint again
            err.poisoned = bool(resp.get("poisoned"))
            raise err
        return protocol.unpack_results(resp.get("segments", []), body), resp

    def profile(self, on: bool) -> None:
        """Turn the daemon's torch.profiler trace of each execute on or off;
        status() then reports the traced executes' device busy ms."""
        resp, _ = self._request({"op": "profile", "on": bool(on)})
        if not resp.get("ok"):
            raise RuntimeError(f"daemon profile failed: {resp.get('error')}")

    def clear_caches(self) -> None:
        resp, _ = self._request({"op": "clear_caches"})
        if not resp.get("ok"):
            raise RuntimeError(f"daemon clear failed: {resp.get('error')}")

    def shutdown(self) -> None:
        try:
            self._request({"op": "shutdown"}, timeout_s=2.0)
        except DaemonUnavailable:
            pass  # already gone — the goal state


# --------------------------------------------------------------- attach

def resolve_socket(config) -> str:
    from ballista_tpu_torch.config import TPU_DAEMON_SOCKET

    return str(config.get(TPU_DAEMON_SOCKET)) or protocol.default_socket_path()


def _clean_stale_socket(path: str) -> bool:
    """A socket file nobody answers on is litter from a dead daemon:
    unlink it so a spawn (ours or a later one) can bind. True if the path
    was stale and removed."""
    if not os.path.exists(path):
        return False
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.settimeout(1.0)
        probe.connect(path)
        return False  # something is listening; not stale
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            return False
        return True
    finally:
        probe.close()


def _bound_ordinal() -> int:
    """The card this process is bound to (runtime.bind_process_ordinal), or
    -1; read without importing the runtime where nothing loaded it yet."""
    rt = sys.modules.get("ballista_tpu_torch.ops.cuda.runtime")
    return rt.bound_ordinal() if rt is not None else -1


def spawn_daemon(socket_path: str, *, parent_pid: int = 0,
                 idle_timeout_s: int | None = None, device_ordinal: int = -1,
                 env: dict | None = None) -> subprocess.Popen:
    """Start a detached daemon process; stdout/stderr land next to the
    socket at <socket>.log. `device_ordinal` >= 0 binds the daemon to that
    card before its first CUDA call. The caller still has to wait for the
    socket."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = pkg_root + os.pathsep + e.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "ballista_tpu_torch.device_daemon",
           "--socket", socket_path]
    if parent_pid:
        cmd += ["--parent-pid", str(parent_pid)]
    if idle_timeout_s is not None:
        cmd += ["--idle-timeout-s", str(idle_timeout_s)]
    if device_ordinal >= 0:
        cmd += ["--device-ordinal", str(device_ordinal)]
    logf = open(protocol.daemon_log_path(socket_path), "ab")
    try:
        proc = subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=logf,
                                stderr=logf, start_new_session=True, env=e)
    finally:
        logf.close()
    with _CACHE_LOCK:
        _SPAWNED[socket_path] = proc
    return proc


def spawned_daemon(path: str) -> subprocess.Popen | None:
    """The daemon process this process spawned last for `path`, or None."""
    with _CACHE_LOCK:
        return _SPAWNED.get(path)


def attach(config) -> tuple[DaemonClient | None, str, str]:
    """The attach-first ladder. Returns (client|None, mode, reason) where
    mode is "attached" or "in_process"; never raises."""
    from ballista_tpu_torch.config import (
        TPU_DAEMON_ATTACH_TIMEOUT_MS,
        TPU_DAEMON_ENABLED,
        TPU_DAEMON_SPAWN,
    )

    if _IN_DAEMON:
        return None, "in_process", "inside daemon"
    if not config.get(TPU_DAEMON_ENABLED):
        return None, "in_process", "daemon disabled"
    path = resolve_socket(config)
    timeout_s = int(config.get(TPU_DAEMON_ATTACH_TIMEOUT_MS)) / 1000.0

    with _CACHE_LOCK:
        cached = _ATTACHED.get(path)
    if cached is not None:
        client, pid, gen = cached
        try:
            p = client.ping()
            # a recycled pid can alias a NEW daemon onto an old
            # attachment — the bind-time generation token cannot. Both
            # must match, else the ladder reruns and re-keys the cache.
            if p.get("pid") == pid and str(p.get("gen", "")) == gen:
                return client, "attached", path
        except DaemonUnavailable:
            pass
        with _CACHE_LOCK:  # daemon died or was replaced; retry the ladder
            _ATTACHED.pop(path, None)

    client = DaemonClient(path)
    deadline = time.time() + timeout_s
    try:
        p = client.ping(timeout_s=max(0.2, timeout_s))
        with _CACHE_LOCK:
            _ATTACHED[path] = (client, int(p.get("pid", 0)),
                               str(p.get("gen", "")))
        return client, "attached", path
    except DaemonUnavailable as e:
        reason = str(e)

    stale = _clean_stale_socket(path)
    if stale:
        reason = f"stale socket removed: {path}"
    if not config.get(TPU_DAEMON_SPAWN):
        return None, "in_process", f"attach_failed: {reason}"

    try:
        spawn_daemon(path, device_ordinal=_bound_ordinal())
    except OSError as e:
        return None, "in_process", f"spawn_failed: {e}"
    while time.time() < deadline:
        try:
            p = client.ping(timeout_s=0.5)
            with _CACHE_LOCK:
                _ATTACHED[path] = (client, int(p.get("pid", 0)),
                                   str(p.get("gen", "")))
            return client, "attached", f"spawned: {path}"
        except DaemonUnavailable:
            time.sleep(0.1)
    return None, "in_process", (
        f"spawn_timeout: daemon socket {path} did not come up within "
        f"{timeout_s:.1f}s")


def clear_attached_caches() -> bool:
    """Route clear_device_caches() through to any daemon this process is
    attached to: an attached executor's clear must evict DAEMON-resident
    device state, not just its own (empty) in-process caches. Best-effort;
    True when at least one daemon acknowledged. No-op inside the daemon
    itself (the daemon's own clear already ran locally)."""
    if _IN_DAEMON:
        return False
    with _CACHE_LOCK:
        clients = [c for c, _, _ in _ATTACHED.values()]
    ok = False
    for c in clients:
        try:
            c.clear_caches()
            ok = True
        except (DaemonUnavailable, RuntimeError):
            pass
    return ok


# ------------------------------------------------ poison-stage quarantine

def _load_poison(path: str, ttl_s: float) -> dict:
    """Read + TTL-prune the quarantine next to `path`'s socket. Never
    raises: a corrupt or missing file is an empty quarantine."""
    try:
        with open(protocol.poison_path(path)) as f:
            entries = json.load(f).get("entries", {})
    except (OSError, ValueError):
        return {}
    cutoff = time.time() - max(1.0, float(ttl_s))
    return {t: e for t, e in entries.items()
            if isinstance(e, dict) and float(e.get("updated", 0)) >= cutoff}


def _store_poison(path: str, entries: dict) -> None:
    tmp = protocol.poison_path(path) + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"entries": entries}, f, indent=1)
        os.replace(tmp, protocol.poison_path(path))
    except OSError:
        pass  # quarantine is best-effort; a lost write costs one retry


def record_stage_crash(path: str, tag: str, fingerprint: str,
                       ttl_s: float) -> int:
    """Count one daemon crash against a stage fingerprint; returns the
    crash count within the TTL window. At POISON_CRASH_THRESHOLD the
    stage is quarantined: respawned daemons refuse it and clients demote
    it straight to the in-process ladder until the entry expires."""
    entries = _load_poison(path, ttl_s)
    e = entries.setdefault(tag, {"crashes": 0, "fingerprint": fingerprint[:300]})
    e["crashes"] = int(e.get("crashes", 0)) + 1
    e["updated"] = time.time()
    _store_poison(path, entries)
    return e["crashes"]


def is_poisoned(path: str, tag: str, ttl_s: float) -> bool:
    e = _load_poison(path, ttl_s).get(tag)
    return e is not None and int(e.get("crashes", 0)) >= POISON_CRASH_THRESHOLD


def clear_poison(path: str) -> None:
    """Test hook: lift the quarantine for a socket."""
    try:
        os.unlink(protocol.poison_path(path))
    except OSError:
        pass


def read_crash_report(path: str) -> dict | None:
    """The watchdog's post-mortem artifact (<socket>.crash.json), or None.
    Fresh daemon binds remove stale ones, so an existing report belongs
    to the most recent corpse."""
    try:
        with open(protocol.crash_report_path(path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
