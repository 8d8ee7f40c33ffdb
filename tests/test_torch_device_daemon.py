"""The port's warm device daemon on the CPU: lifecycle, parity, quotas,
fallback and the failure domain.

One test here for each of tests/test_device_daemon.py's, held against the
port's in-process path (the oracle: the daemon runs the same
maybe_compile_tpu), plus the protocol against the JAX package's, one
query byte for byte against the JAX package's in-process engine=tpu
answer, and the daemon's refusal to serve without a card. Spawned daemons
get BALLISTA_TORCH_PLATFORM=cpu (the port's request for the CPU forms, as
the reference's tests force JAX_PLATFORMS=cpu); the tests that let the
attach ladder respawn one set it in this process's environment, which the
respawn inherits. Every wait has its own limit, every daemon this file
spawns has a parent pid or an idle timeout, and the module's teardown
stops whatever is left.
"""

import io
import json
import os
import socket as socketlib
import time

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu_torch.config import (
    CHAOS_DAEMON_ARM,
    CHAOS_DAEMON_ONCE,
    CHAOS_ENABLED,
    CHAOS_MODE,
    EXECUTOR_ENGINE,
    TPU_DAEMON_ATTACH_TIMEOUT_MS,
    TPU_DAEMON_ENABLED,
    TPU_DAEMON_EXECUTE_TIMEOUT_S,
    TPU_DAEMON_SESSION_QUOTA_BYTES,
    TPU_DAEMON_SOCKET,
    TPU_DAEMON_SPAWN,
    TPU_MIN_ROWS,
    BallistaConfig,
)
from ballista_tpu_torch.device_daemon import client as dclient
from ballista_tpu_torch.device_daemon import protocol as dproto
from ballista_tpu_torch.ops.cuda import runtime

SQL = ("SELECT cat, sum(price) AS s, count(*) AS c, avg(qty) AS q "
       "FROM t GROUP BY cat ORDER BY cat")
IDLE_S = 120  # a spawned daemon outlives its last request by this much at most


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)
    # daemons the attach ladder spawned (respawns) and any a test left
    for path, proc in list(dclient._SPAWNED.items()):
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    dclient._SPAWNED.clear()


@pytest.fixture()
def respawn_env(monkeypatch):
    """The environment a daemon respawned by the attach ladder inherits:
    the CPU forms and an idle timeout."""
    monkeypatch.setenv(runtime.PLATFORM_ENV, "cpu")
    monkeypatch.setenv("BALLISTA_TPU_DAEMON_IDLE_TIMEOUT_S", str(IDLE_S))


def _table(n=20_000, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({
        "cat": rng.choice([f"c{i}" for i in range(7)], n),
        "price": np.round(rng.uniform(1, 100, n), 2),
        "qty": rng.integers(1, 50, n),
    })


def _run_query(tbl, **cfg_extra):
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc
    from ballista_tpu_torch.client.context import SessionContext

    cfg = BallistaConfig({EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0, **cfg_extra})
    ctx = SessionContext(cfg)
    ctx.register_arrow_table("t", tbl, partitions=3)
    sc.RUN_STATS.clear()
    out = ctx.sql(SQL).collect()
    return out, sc.RUN_STATS.snapshot()


def _spawn_and_wait(sock_path, timeout_s=60.0):
    env = dict(os.environ, **{runtime.PLATFORM_ENV: "cpu"})
    proc = dclient.spawn_daemon(sock_path, parent_pid=os.getpid(),
                                idle_timeout_s=IDLE_S, env=env)
    client = dclient.DaemonClient(sock_path)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon died rc={proc.returncode}: "
                + open(dproto.daemon_log_path(sock_path)).read()[-2000:])
        try:
            client.wait_ready(timeout_s=5.0, poll_s=0.2)
            return proc, client
        except dclient.DaemonUnavailable:
            time.sleep(0.2)
    proc.kill()
    raise RuntimeError(f"daemon not ready in {timeout_s}s")


def _stop(proc, client=None):
    if client is not None:
        client.shutdown()
    try:
        return proc.wait(timeout=15)
    except Exception:  # noqa: BLE001
        proc.kill()
        return proc.wait(timeout=10)


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("daemon") / "d.sock")
    proc, client = _spawn_and_wait(sock)
    yield sock, client
    _stop(proc, client)
    dclient.reset_attach_cache()


@pytest.fixture(autouse=True)
def _clean_attach_cache():
    yield
    dclient.reset_attach_cache()


def _daemon_cfg(sock, **extra):
    return {TPU_DAEMON_ENABLED: True, TPU_DAEMON_SOCKET: sock,
            TPU_DAEMON_ATTACH_TIMEOUT_MS: 10_000, **extra}


def _ipc_bytes(t):
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue()


# ------------------------------------------------------------- lifecycle

def test_spawn_attach_status(daemon):
    sock, client = daemon
    st = client.status()
    assert st["ready"] is True
    phases = {p["name"]: p for p in st["init"]["phases"]}
    assert set(phases) == {"platform_probe", "cuda_devices", "first_launch"}
    assert all(p["status"] == "ok" for p in phases.values())
    assert st["platform"] == "cpu"
    # probe report persisted next to the socket, matching status
    report = json.load(open(dproto.probe_report_path(sock)))
    assert report["ok"] is True
    assert report["pid"] == st["pid"]
    assert report["platform_request"] == "cpu"


def test_attach_is_cached_and_reattaches(daemon):
    sock, _ = daemon
    cfg = BallistaConfig(_daemon_cfg(sock))
    c1, mode1, _ = dclient.attach(cfg)
    assert mode1 == "attached" and c1 is not None
    c2, mode2, _ = dclient.attach(cfg)
    assert c2 is c1  # cached per (socket, pid, generation)
    # a client that lost its state re-runs the ladder and lands on the
    # same live daemon without spawning a second one
    dclient.reset_attach_cache()
    c3, mode3, _ = dclient.attach(cfg)
    assert mode3 == "attached"
    assert c3.ping()["pid"] == c1.ping()["pid"]


def test_daemon_survives_client_crash_mid_frame(daemon):
    sock, client = daemon
    # a client that dies mid-message must not take the daemon down
    raw = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    raw.connect(sock)
    raw.sendall(b"\x00\x00\x10\x00garbage-partial-frame")
    raw.close()
    time.sleep(0.2)
    assert client.ping()["pid"] > 0
    out, stats = _run_query(_table(), **_daemon_cfg(sock))
    assert stats.get("daemon_mode") == "attached"
    assert out.num_rows == 7


def test_daemon_without_a_card_fails_at_cuda_devices(tmp_path):
    # no card visible and no request for the CPU forms: init fails in
    # cuda_devices, the probe report names it, and the daemon exits 3
    # instead of serving from the CPU
    sock = str(tmp_path / "nocard.sock")
    env = {k: v for k, v in os.environ.items() if k != runtime.PLATFORM_ENV}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = dclient.spawn_daemon(sock, parent_pid=os.getpid(), idle_timeout_s=IDLE_S,
                                env=env)
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 3
    report = json.load(open(dproto.probe_report_path(sock)))
    status = {p["name"]: p["status"] for p in report["phases"]}
    assert status == {"platform_probe": "ok", "cuda_devices": "error",
                      "first_launch": "pending"}
    assert report["ok"] is False and "no CUDA device" in report["error"]
    assert not os.path.exists(sock)


# ---------------------------------------------------------------- parity

def test_attached_byte_identical_to_in_process(daemon):
    sock, client = daemon
    tbl = _table()
    base, base_stats = _run_query(tbl)
    att, att_stats = _run_query(tbl, **_daemon_cfg(sock))
    assert att_stats.get("daemon_mode") == "attached"
    assert att_stats.get("daemon_attached") == 1.0
    assert "daemon_mode" not in base_stats
    assert att.equals(base)
    assert _ipc_bytes(att) == _ipc_bytes(base)
    # the daemon mirrored its engine stats into the client's RUN_STATS
    assert att_stats.get("exec_s") is not None
    # daemon-side init phase timings rode back for the heartbeat gauges
    assert att_stats.get("init_cuda_devices_s") is not None
    assert att_stats.get("init_first_launch_s") is not None


def test_attached_byte_identical_to_jax_package(daemon):
    # the same query through the JAX package's in-process device engine
    # on the CPU: the daemon's answer is byte for byte the reference's
    from ballista_tpu.client.context import SessionContext as JaxSession
    from ballista_tpu.config import BallistaConfig as JaxConfig

    sock, _ = daemon
    tbl = _table(seed=23)
    jctx = JaxSession(JaxConfig({"ballista.executor.engine": "tpu",
                                 "ballista.tpu.min.rows": 0}))
    jctx.register_arrow_table("t", tbl, partitions=3)
    ref = jctx.sql(SQL).collect()
    att, stats = _run_query(tbl, **_daemon_cfg(sock))
    assert stats.get("daemon_mode") == "attached"
    assert _ipc_bytes(att) == _ipc_bytes(ref)


def test_protocol_matches_jax_package():
    from ballista_tpu.device_daemon import protocol as jproto

    assert dproto.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION
    for floor in (0, 0.5, 1, 10, 120, 3600):
        for est in (0, 1, 1 << 20, 1 << 30, 1 << 40, -5):
            assert (dproto.derive_execute_timeout_s(floor, est)
                    == jproto.derive_execute_timeout_s(floor, est))
    tbl = _table(n=1000)
    batches = tbl.to_batches(max_chunksize=300)
    results = {2: batches[:2], 0: batches[2:], 1: [], 5: batches[1:2]}
    assert dproto.pack_results(results) == jproto.pack_results(results)
    assert dproto.pack_results({0: [], 1: []}) == jproto.pack_results({0: [], 1: []})
    segments, body = dproto.pack_results(results)
    back = dproto.unpack_results(segments, body)
    assert sorted(back) == [0, 1, 2, 5]
    assert pa.Table.from_batches(back[0]).equals(pa.Table.from_batches(batches[2:]))
    assert back[1] == []


def test_executor_heartbeat_exports_daemon_gauges(daemon):
    sock, _ = daemon
    _run_query(_table(), **_daemon_cfg(sock))
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess

    metrics = dict(ExecutorProcess._tpu_metrics())
    assert metrics.get("tpu_daemon_attached") == 1.0
    assert "daemon_sessions" in metrics
    assert "daemon_queue_depth" in metrics
    assert "tpu_init_cuda_devices_s" in metrics
    assert "tpu_init_first_launch_s" in metrics


# ------------------------------------------------------- session quotas

def test_session_quota_clamps_budget():
    from ballista_tpu_torch.config import TPU_HBM_BUDGET_BYTES
    from ballista_tpu_torch.ops.cuda import hbm

    cfg = BallistaConfig({TPU_HBM_BUDGET_BYTES: 1 << 30})
    assert hbm.resolve_hbm_budget(cfg) == 1 << 30
    with hbm.session_quota(1 << 20):
        assert hbm.resolve_hbm_budget(cfg) == 1 << 20
        with hbm.session_quota(0):  # inner scope: no ceiling
            assert hbm.resolve_hbm_budget(cfg) == 1 << 30
    assert hbm.resolve_hbm_budget(cfg) == 1 << 30


def test_session_quota_forces_spill_plan():
    from ballista_tpu_torch.config import TPU_HBM_BUDGET_BYTES
    from ballista_tpu_torch.ops.cuda import hbm
    from ballista_tpu_torch.ops.cuda.fusion import StageEstimate

    est = StageEstimate(
        rows=1 << 20, partitions=2, group_domain=8, n_group_keys=1, lanes=1,
        has_mult=False, n_filters=0, n_projections=0, n_joins=0,
        max_probe_table=0, table_bytes=4 << 20, dict_bytes=1 << 20)
    cfg = BallistaConfig({TPU_HBM_BUDGET_BYTES: 1 << 30})
    roomy = hbm.plan_stage(est, hbm.resolve_hbm_budget(cfg),
                           grace_eligible=True, grace_fanout=8,
                           grace_max_depth=2, resident_other=2 << 20)
    assert roomy.decision == hbm.RUN_WHOLE
    # same stage, same knobs, but admitted under a 6 MiB session quota:
    # the cold residents no longer fit beside it — spill becomes the plan
    with hbm.session_quota(6 << 20):
        tight = hbm.plan_stage(est, hbm.resolve_hbm_budget(cfg),
                               grace_eligible=True, grace_fanout=8,
                               grace_max_depth=2, resident_other=2 << 20)
    assert tight.decision == hbm.SPILL_COLDS


def test_session_quota_enforced_through_daemon(daemon):
    sock, client = daemon
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc

    quota = 2 << 20
    _, stats = _run_query(
        _table(), **_daemon_cfg(sock, **{TPU_DAEMON_SESSION_QUOTA_BYTES: quota}))
    assert stats.get("daemon_mode") == "attached"
    # the daemon-side admission ran against the clamped budget (its partial
    # stage on a pool thread of the routed final stage included) and
    # mirrored it back into the attached stage's record
    attached = [r for r in sc.RUN_STATS.stages().values()
                if r.get("daemon_mode") == "attached"]
    assert attached and attached[-1].get("hbm_budget_bytes") == quota
    st = client.status()
    sess = [s for s in st["session_detail"].values()
            if s["quota_bytes"] == quota]
    assert sess and sess[0]["executes"] >= 1


# ------------------------------------------------- stale socket + fallback

def test_stale_socket_cleanup(tmp_path):
    stale = str(tmp_path / "stale.sock")
    lst = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    lst.bind(stale)
    lst.close()  # the path stays behind: classic dead-daemon litter
    assert os.path.exists(stale)
    cfg = BallistaConfig(_daemon_cfg(stale, **{TPU_DAEMON_SPAWN: False,
                                               TPU_DAEMON_ATTACH_TIMEOUT_MS: 500}))
    c, mode, reason = dclient.attach(cfg)
    assert c is None and mode == "in_process"
    assert "stale socket removed" in reason
    assert not os.path.exists(stale)


def test_graceful_fallback_when_no_daemon(tmp_path):
    sock = str(tmp_path / "nobody-home.sock")
    tbl = _table()
    base, _ = _run_query(tbl)
    out, stats = _run_query(
        tbl, **_daemon_cfg(sock, **{TPU_DAEMON_ATTACH_TIMEOUT_MS: 300}))
    assert out.num_rows == 7  # the query still ran, in-process
    assert _ipc_bytes(out) == _ipc_bytes(base)
    assert stats.get("daemon_mode") == "in_process"
    assert str(stats.get("daemon_mode_reason", "")).startswith("attach_failed")
    assert stats.get("daemon_attached") == 0.0


# -------------------------------------------------------- cache clearing

def test_clear_device_caches_routes_to_daemon(daemon):
    sock, client = daemon
    import ballista_tpu_torch.ops.cuda.stage_compiler as sc

    _run_query(_table(), **_daemon_cfg(sock))
    before = client.status()
    assert before["resident_tables"] >= 1
    clears = before["clear_count"]
    sc.clear_device_caches()  # attached process: must forward to the daemon
    after = client.status()
    assert after["clear_count"] == clears + 1
    assert after["resident_tables"] == 0
    assert after["lut_entries"] == 0 and after["build_entries"] == 0


def test_profile_op_traces_executes(daemon):
    # the daemon traces each execute while profiling is on and sums the
    # device busy time of the traces (none on the CPU forms)
    sock, client = daemon
    before = client.status()
    client.profile(True)
    try:
        _, stats = _run_query(_table(), **_daemon_cfg(sock))
    finally:
        client.profile(False)
    assert stats.get("daemon_mode") == "attached"
    mid = client.status()
    assert mid["traced_executes"] == before["traced_executes"] + 1
    assert mid["device_busy_ms"] == before["device_busy_ms"] == 0.0
    _run_query(_table(), **_daemon_cfg(sock))
    assert client.status()["traced_executes"] == mid["traced_executes"]


# ------------------------------------------------------- failure domain

def _chaos_cfg(sock, mode, arm="mid_execute", once=True, **extra):
    # spawn=True so the respawn-and-retry leg of the ladder can bring a
    # fresh daemon back after the injected crash; generous attach timeout
    # because each respawn pays a cold torch import
    return _daemon_cfg(sock, **{
        TPU_DAEMON_SPAWN: True, TPU_DAEMON_ATTACH_TIMEOUT_MS: 60_000,
        CHAOS_ENABLED: True, CHAOS_MODE: mode,
        CHAOS_DAEMON_ARM: arm, CHAOS_DAEMON_ONCE: once, **extra})


def _shutdown_daemon(sock):
    """Best-effort cleanup of a per-test daemon (alive or already dead)."""
    try:
        dclient.DaemonClient(sock, timeout_s=5.0).shutdown()
    except Exception:  # noqa: BLE001 — a corpse is fine, that's the point
        pass
    proc = dclient.spawned_daemon(sock)
    if proc is not None:
        _stop(proc)


def test_derived_execute_deadline():
    assert dproto.derive_execute_timeout_s(120, 0) == 120.0
    # +1s per 16 MiB of stage input
    assert dproto.derive_execute_timeout_s(120, 1 << 30) == 184.0
    assert dproto.derive_execute_timeout_s(10, 1 << 40) == 80.0  # cap: 8x floor
    assert dproto.derive_execute_timeout_s(0, 0) == 1.0  # floor clamp


def test_generation_token_minted_and_echoed(daemon, tmp_path):
    sock, client = daemon
    gen = client.ping().get("gen")
    assert gen  # minted at bind time
    assert client.status().get("gen") == gen
    cfg = BallistaConfig(_daemon_cfg(sock))
    c, mode, _ = dclient.attach(cfg)
    assert mode == "attached"
    assert dclient.attached_generation(sock) == gen
    # the executor's lease table fences on the same token
    from ballista_tpu_torch.executor.executor import Executor

    probe = Executor(str(tmp_path)).lease_table._generation_probe
    assert probe() == gen


def test_watchdog_kills_wedged_execute(tmp_path):
    """daemon_hang wedges the execute thread before serde decode; the
    watchdog overruns the shipped deadline, writes the post-mortem, and
    exits 4 — the client sees a typed DaemonCrashed."""
    sock = str(tmp_path / "hang.sock")
    # a leftover post-mortem from a previous corpse must not survive a
    # fresh bind (it would misclassify the NEXT crash as a watchdog kill)
    with open(dproto.crash_report_path(sock), "w") as f:
        f.write("{}")
    proc, client = _spawn_and_wait(sock)
    try:
        assert not os.path.exists(dproto.crash_report_path(sock))
        gen = client.ping()["gen"]
        cfg = BallistaConfig(_chaos_cfg(sock, "daemon_hang", arm="pre_execute"))
        with pytest.raises(dclient.DaemonCrashed):
            client.execute(b"never-decoded", cfg.to_key_value_pairs(), [0],
                           tag="stage_deadbeef", deadline_s=2.0)
        assert proc.wait(timeout=30) == 4  # diagnosed death, not a raw abort
        report = dclient.read_crash_report(sock)
        assert report is not None
        assert report["kind"] == "watchdog"
        assert report["generation"] == gen
        # the offending request header rode into the post-mortem — minus
        # the bulky config pairs
        assert report["request"]["tag"] == "stage_deadbeef"
        assert "pairs" not in report["request"]
        assert report["deadline_s"] == 2.0
        assert report["stacks"]  # every thread's stack, via faulthandler
    finally:
        _shutdown_daemon(sock)
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("mode", ["daemon_crash", "daemon_hang"])
def test_crash_recovery_respawn_byte_parity(tmp_path, mode, respawn_env):
    """One injected daemon death mid-query (SIGKILL-style exit or a hang
    the watchdog converts to one): the stage ladder respawns, retries
    once, and the answer is byte-identical to the in-process run."""
    sock = str(tmp_path / f"{mode}.sock")
    tbl = _table()
    base, _ = _run_query(tbl)
    dclient.reset_failure_counters()
    extra = {}
    if mode == "daemon_hang":
        # short deadline so the watchdog converts the hang into a death
        # quickly; roomy enough that the retry's execute fits
        extra[TPU_DAEMON_EXECUTE_TIMEOUT_S] = 8
    try:
        out, stats = _run_query(tbl, **_chaos_cfg(sock, mode, **extra))
        assert out.equals(base)
        assert _ipc_bytes(out) == _ipc_bytes(base)
        c = dclient.failure_counters()
        assert c["daemon_crashes_detected"] == 1
        assert c["daemon_restarts"] == 1  # the respawn leg recovered it
        assert c["poisoned_stages"] == 0  # once-armed: no quarantine
        if mode == "daemon_hang":
            # classified from the <socket>.crash.json post-mortem
            assert c["watchdog_kills"] == 1
        # the recovery is visible in the run's stats (→ heartbeat gauges)
        assert stats.get("daemon_restarts", 0) == 1
        assert stats.get("daemon_mode") == "attached"
        import ballista_tpu_torch.ops.cuda.stage_compiler as sc
        recs = sc.RUN_STATS.stages().values()
        assert any(r.get("daemon_failover") == "daemon_restarted"
                   for r in recs)
    finally:
        _shutdown_daemon(sock)


def test_poison_quarantine_demotes_after_second_crash(tmp_path, respawn_env):
    """Without once-arming every daemon incarnation dies on the stage:
    the second crash per fingerprint quarantines it and the stage demotes
    to the in-process ladder — byte-identically, with no crash loop."""
    sock = str(tmp_path / "poison.sock")
    tbl = _table()
    base, _ = _run_query(tbl)
    dclient.reset_failure_counters()
    try:
        out, stats = _run_query(
            tbl, **_chaos_cfg(sock, "daemon_crash", once=False))
        assert out.equals(base)
        assert _ipc_bytes(out) == _ipc_bytes(base)
        c = dclient.failure_counters()
        assert c["daemon_crashes_detected"] >= 2
        assert c["poisoned_stages"] >= 1
        assert stats.get("daemon_failover") == "poisoned"
        # the quarantine is on disk, keyed by stage tag, TTL'd
        entries = json.load(
            open(dproto.poison_path(sock))).get("entries", {})
        assert any(t.startswith(("stage_", "final_")) for t in entries)
        assert all(e["crashes"] >= dclient.POISON_CRASH_THRESHOLD
                   for e in entries.values())
        # second run: quarantined stages demote WITHOUT touching a daemon
        # (no new crashes, no respawn storm — the loop is broken)
        before = dclient.failure_counters()["daemon_crashes_detected"]
        out2, stats2 = _run_query(
            tbl, **_chaos_cfg(sock, "daemon_crash", once=False))
        assert _ipc_bytes(out2) == _ipc_bytes(base)
        assert stats2.get("daemon_mode") == "in_process"
        assert stats2.get("daemon_failover") == "poisoned"
        assert dclient.failure_counters()["daemon_crashes_detected"] == before
    finally:
        _shutdown_daemon(sock)
        dclient.clear_poison(sock)


def test_poison_entries_expire_after_ttl(tmp_path):
    sock = str(tmp_path / "ttl.sock")
    assert dclient.record_stage_crash(sock, "stage_oldwound", "fp", 600) == 1
    assert not dclient.is_poisoned(sock, "stage_oldwound", 600)  # 1 < threshold
    assert dclient.record_stage_crash(sock, "stage_oldwound", "fp", 600) == 2
    assert dclient.is_poisoned(sock, "stage_oldwound", 600)
    # age the entry past the TTL window: the quarantine lifts
    p = dproto.poison_path(sock)
    data = json.load(open(p))
    data["entries"]["stage_oldwound"]["updated"] = time.time() - 10_000
    with open(p, "w") as f:
        json.dump(data, f)
    assert not dclient.is_poisoned(sock, "stage_oldwound", 600)
    # and the count restarts from scratch — old crashes don't haunt
    assert dclient.record_stage_crash(sock, "stage_oldwound", "fp", 600) == 1


def test_lease_stale_generation_fences_direct_dispatch():
    from ballista_tpu_torch.serving.lease import ExecutorLease, LeaseRegistry, LeaseTable

    live = {"gen": "boot-1"}
    table = LeaseTable(generation_probe=lambda: live["gen"])
    reg = LeaseRegistry()
    lease = reg.mint("exec-1", "h", 50050, "s", slots=2, ttl_s=30.0)
    assert lease.daemon_generation == ""  # scheduler can't see the daemon
    # the generation survives the wire round trip (Flight action body)
    assert ExecutorLease.from_wire(lease.to_wire()).daemon_generation == ""
    table.grant(lease)  # executor stamps its live generation at grant
    tid = lease.take_task_id()
    assert table.admit(lease.lease_id, tid) is None
    table.release(lease.lease_id)
    live["gen"] = "boot-2"  # the daemon silently restarted
    tid2 = lease.take_task_id()
    assert table.admit(lease.lease_id, tid2) == "stale-daemon-generation"
    assert table.rejections >= 1
    # an unfenced lease (executor not attached at grant time) never fences
    live["gen"] = ""
    table2 = LeaseTable(generation_probe=lambda: live["gen"])
    lease2 = reg.mint("exec-2", "h", 50051, "s", slots=2, ttl_s=30.0)
    table2.grant(lease2)
    live["gen"] = "boot-9"
    assert table2.admit(lease2.lease_id, lease2.take_task_id()) is None
