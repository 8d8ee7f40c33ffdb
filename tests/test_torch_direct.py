"""Lease-based direct dispatch in the port, on the CPU.

`client/direct.py` binds a prepared single-stage statement's parameters
and runs its tasks straight against a leased executor, through the
in-process seam (`LocalLeaseTransport`) or the executor's Flight endpoint
(`FlightLeaseTransport`); any rejection demotes to `execute_prepared` on
the graph path. Held here against the graph path and the JAX package's
dispatcher over TPC-H SF0.01: the port after runtime.use_cpu() with
engine=tpu, the JAX package with JAX_PLATFORMS=cpu. Also: revocation,
expiry and a changed device-daemon generation demote cleanly, a one-slot
executor is never oversubscribed, the leases' task-id bands hold
`verify_lease_bands`, and a remote executor daemon takes grants and
dispatches over Flight (ROADMAP C19).
"""

import hashlib
import time

import pytest

from ballista_tpu_torch.ops.cuda import runtime

FILTER_SQL = ("SELECT l_orderkey, l_partkey, l_quantity FROM lineitem "
              "WHERE l_quantity < 10")
BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0,
            "ballista.shuffle.partitions": 2, "ballista.scheduler.lease.enabled": True}
PARAMS = (3, 10, 24)


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _fingerprint(tbl) -> bytes:
    cols = sorted(tbl.column_names)
    rows = sorted(zip(*(tbl.column(c).to_pylist() for c in cols)))
    return hashlib.sha256(repr((cols, rows)).encode()).digest()


def _mods(pkg):
    root = "ballista_tpu_torch" if pkg == "port" else "ballista_tpu"
    imp = lambda m: __import__(f"{root}.{m}", fromlist=["x"])  # noqa: E731
    return (imp("client.context"), imp("client.direct"), imp("config"),
            imp("executor.standalone"), imp("testing.tpchgen"))


def _session_cfg(pkg, tpch_dir):
    ctx_mod, _d, cfg_mod, _s, gen = _mods(pkg)
    cfg = cfg_mod.BallistaConfig(dict(BASE_CFG))
    gen.register_tpch(ctx_mod.SessionContext(cfg), tpch_dir)
    return cfg


def _cluster(pkg, tpch_dir, executors=2, vcores=4, with_flight=False):
    _c, _d, _cfg, standalone, _g = _mods(pkg)
    cfg = _session_cfg(pkg, tpch_dir)
    cluster = standalone.StandaloneCluster(num_executors=executors, vcores=vcores,
                                           config=cfg, with_flight=with_flight)
    sid = cluster.scheduler.sessions.create_or_update(cfg.to_key_value_pairs(), "s-direct")
    return cluster, cfg, sid


def _dispatcher(pkg, cluster, sid, transport=None, **kw):
    _c, direct, _cfg, _s, _g = _mods(pkg)
    d = direct.DirectDispatcher(
        cluster.scheduler, transport or direct.LocalLeaseTransport(cluster.executors),
        sid, **kw)
    d.prepare(FILTER_SQL)
    return d


def _fetch(pkg, status, cfg):
    return _mods(pkg)[0].fetch_job_results(status, cfg)


@pytest.fixture(scope="module")
def direct_cluster(tpch_dir):
    cluster, cfg, sid = _cluster("port", tpch_dir)
    try:
        yield cluster, cfg, sid
    finally:
        cluster.shutdown()


@pytest.fixture(scope="module")
def reference_direct(tpch_dir):
    """The JAX package's direct answers for PARAMS."""
    cluster, cfg, sid = _cluster("jax", tpch_dir)
    try:
        d = _dispatcher("jax", cluster, sid)
        out = {}
        for k in PARAMS:
            st = d.execute((k,))
            assert st.get("direct_dispatch") is True
            out[k] = _fingerprint(_fetch("jax", st, cfg))
        return out
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("k", PARAMS)
def test_direct_equals_graph_path_and_reference(k, direct_cluster, reference_direct):
    from ballista_tpu_torch.testing.standalone_stats import stage_stats

    cluster, cfg, sid = direct_cluster
    scheduler = cluster.scheduler
    d = _dispatcher("port", cluster, sid)
    before = scheduler.leases.snapshot()["direct_jobs_reconciled"]
    st = d.execute((k,))
    assert st.get("direct_dispatch") is True and d.stats == {
        "direct": 1, "demoted": 0, "tasks": d.stats["tasks"]}
    jid = scheduler.execute_prepared(d.statement_id, (k,), session_id=sid)
    graph = scheduler.wait_for_job(jid, timeout=120)
    assert graph["state"] == "successful", graph
    got = _fingerprint(_fetch("port", st, cfg))
    assert got == _fingerprint(_fetch("port", graph, cfg)) == reference_direct[k]
    assert scheduler.leases.snapshot()["direct_jobs_reconciled"] == before + 1
    if hasattr(scheduler.jobs.get(jid), "stages"):
        assert all(not s["device"] or s["fallbacks"] == 0
                   for s in stage_stats(scheduler.jobs[jid]).values())
    assert scheduler.revoke_executor_lease(d._lease.lease_id)


def _await_revoked(cluster, lease):
    ex = cluster.executors[lease.executor_id]
    deadline = time.time() + 5
    while time.time() < deadline:
        if ex.lease_table.admit(lease.lease_id, lease.band_start + 9000) is not None:
            return
        ex.lease_table.release(lease.lease_id)
        time.sleep(0.05)
    raise AssertionError("the executor never saw the revocation")


def test_revocation_demotes_then_a_fresh_lease_restores(direct_cluster):
    cluster, cfg, sid = direct_cluster
    scheduler = cluster.scheduler
    d = _dispatcher("port", cluster, sid)
    st = d.execute((10,))
    assert st.get("direct_dispatch") is True
    baseline = _fingerprint(_fetch("port", st, cfg))
    lease = d._lease
    assert scheduler.revoke_executor_lease(lease.lease_id)
    _await_revoked(cluster, lease)
    # the client still holds a copy that looks valid: the executor rejects
    # it, the dispatcher demotes to the graph path, and a fresh lease
    # restores direct service
    d._lease = lease.clone()
    d._lease.revoked = False
    d._lease.expires_at = time.time() + 60
    st2 = d.execute((10,))
    assert not st2.get("direct_dispatch")
    assert _fingerprint(_fetch("port", st2, cfg)) == baseline
    st3 = d.execute((10,))
    assert st3.get("direct_dispatch") is True
    assert _fingerprint(_fetch("port", st3, cfg)) == baseline
    assert d.stats["demoted"] == 1 and d.stats["direct"] == 2
    assert scheduler.leases.snapshot()["direct_jobs_demoted"] >= 1
    assert scheduler.revoke_executor_lease(d._lease.lease_id)


def test_expiry_demotes_cleanly(direct_cluster):
    cluster, cfg, sid = direct_cluster
    # a TTL the first execution outlives on a loaded host: it must run
    # direct before the lease expires
    d = _dispatcher("port", cluster, sid, ttl_s=1.0)
    st = d.execute((10,))
    assert st.get("direct_dispatch") is True
    baseline = _fingerprint(_fetch("port", st, cfg))
    time.sleep(1.2)
    # a detached client copy past expiry: only the executor's check fires
    d._lease = d._lease.clone()
    d._lease.revoked = False
    d._lease.expires_at = time.time() + 60
    st2 = d.execute((10,))
    assert not st2.get("direct_dispatch")
    assert _fingerprint(_fetch("port", st2, cfg)) == baseline
    assert d.stats["demoted"] == 1


def test_changed_daemon_generation_demotes(direct_cluster, monkeypatch):
    # an executor attached to a device daemon stamps each grant with the
    # daemon's generation; once the daemon restarts (a new generation) its
    # lease no longer admits, the dispatcher demotes, and a fresh lease
    # (stamped with the new generation) restores direct service
    from ballista_tpu_torch.device_daemon import client as dclient

    cluster, cfg, sid = direct_cluster
    monkeypatch.setattr(dclient, "_ATTACHED", {"/daemon.sock": (None, 1, "gen-1")})
    d = _dispatcher("port", cluster, sid)
    st = d.execute((3,))
    assert st.get("direct_dispatch") is True
    baseline = _fingerprint(_fetch("port", st, cfg))
    monkeypatch.setattr(dclient, "_ATTACHED", {"/daemon.sock": (None, 2, "gen-2")})
    ex = cluster.executors[d._lease.executor_id]
    assert ex.lease_table.admit(d._lease.lease_id, d._lease.band_start) == "stale-daemon-generation"
    st2 = d.execute((3,))
    assert not st2.get("direct_dispatch")
    assert _fingerprint(_fetch("port", st2, cfg)) == baseline
    st3 = d.execute((3,))
    assert st3.get("direct_dispatch") is True
    assert _fingerprint(_fetch("port", st3, cfg)) == baseline
    assert d.stats == {"direct": 2, "demoted": 1, "tasks": d.stats["tasks"]}
    cluster.scheduler.revoke_executor_lease(d._lease.lease_id)


def test_one_slot_executor_is_never_oversubscribed(tpch_dir):
    # an executor bound to a card has one slot: a lease of that slot takes
    # it out of the ledger, so a second lease is denied and a graph job
    # waits until the lease gives the slot back
    cluster, cfg, sid = _cluster("port", tpch_dir, executors=1, vcores=1)
    try:
        scheduler = cluster.scheduler
        d = _dispatcher("port", cluster, sid, slots=1)
        st = d.execute((10,))
        assert st.get("direct_dispatch") is True
        baseline = _fingerprint(_fetch("port", st, cfg))
        assert scheduler.mint_executor_lease(sid, slots=1) is None
        assert scheduler.leases.snapshot()["denied"] >= 1
        jid = scheduler.execute_prepared(d.statement_id, (10,), session_id=sid)
        time.sleep(0.5)
        assert scheduler.job_status(jid)["state"] != "successful"
        assert scheduler.revoke_executor_lease(d._lease.lease_id)
        graph = scheduler.wait_for_job(jid, timeout=60)
        assert graph["state"] == "successful", graph
        assert _fingerprint(_fetch("port", graph, cfg)) == baseline
    finally:
        cluster.shutdown()


def test_mint_denied_without_headroom(tpch_dir):
    cluster, _cfg, sid = _cluster("port", tpch_dir, executors=1, vcores=2)
    try:
        a = cluster.scheduler.mint_executor_lease(sid, slots=2)
        assert a is not None
        assert cluster.scheduler.mint_executor_lease(sid, slots=1) is None
        assert cluster.scheduler.leases.snapshot()["denied"] == 1
        assert cluster.scheduler.revoke_executor_lease(a.lease_id)
        assert cluster.scheduler.mint_executor_lease(sid, slots=2) is not None
    finally:
        cluster.shutdown()


def test_flight_transport_in_standalone(tpch_dir):
    # the standalone cluster's shared Flight server has its executors
    # attached: the wire transport runs the same tasks as the local seam
    _c, direct, _cfg, _s, _g = _mods("port")
    cluster, cfg, sid = _cluster("port", tpch_dir, with_flight=True)
    transport = direct.FlightLeaseTransport()
    try:
        wire = _dispatcher("port", cluster, sid, transport=transport)
        local = _dispatcher("port", cluster, sid)
        for k in (3, 24):
            a, b = wire.execute((k,)), local.execute((k,))
            assert a.get("direct_dispatch") is True and b.get("direct_dispatch") is True
            assert _fingerprint(_fetch("port", a, cfg)) == _fingerprint(_fetch("port", b, cfg))
        assert cluster.flight_server.stats["lease_dispatch"] >= 2
    finally:
        transport.close()
        cluster.shutdown()


def test_flight_transport_against_an_executor_daemon(tpch_dir):
    # C19: a remote executor daemon gets its lease over Flight and serves
    # lease_dispatch with the session's settings (engine=tpu: its device
    # stage runs); the JAX package's daemon rejects every direct dispatch
    from ballista_tpu_torch.client.direct import DirectDispatcher, FlightLeaseTransport
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    cfg = _session_cfg("port", tpch_dir)
    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1,
                             flight_proxy_port=-1)
    sched.start()
    ex = ExecutorProcess(f"127.0.0.1:{sched.port}", bind_host="127.0.0.1",
                         external_host="127.0.0.1", engine="tpu", vcores=1,
                         flight_impl="python")
    ex.start()
    transport = FlightLeaseTransport()
    try:
        scheduler = sched.scheduler
        deadline = time.time() + 30
        while not scheduler.executors.alive_executors() and time.time() < deadline:
            time.sleep(0.05)
        sid = scheduler.sessions.create_or_update(cfg.to_key_value_pairs(), "s-wire")
        d = DirectDispatcher(scheduler, transport, sid, slots=1)
        d.prepare(FILTER_SQL)
        for k in (3, 10):
            st = d.execute((k,))
            assert st.get("direct_dispatch") is True, d.stats
        # the lease holds the executor's one slot: the graph path runs once
        # it is revoked
        got = _fingerprint(_fetch("port", st, cfg))
        assert ex.flight_server.stats["lease_dispatch"] == d.stats["tasks"] > 0
        assert ex.executor.lease_table.tasks_total == d.stats["tasks"]
        lease = d._lease
        assert scheduler.revoke_executor_lease(lease.lease_id)
        deadline = time.time() + 5
        while ex.executor.lease_table.active_count() and time.time() < deadline:
            time.sleep(0.05)
        assert ex.executor.lease_table.active_count() == 0  # the revocation arrived
        jid = scheduler.execute_prepared(d.statement_id, (10,), session_id=sid)
        graph = scheduler.wait_for_job(jid, timeout=60)
        assert graph["state"] == "successful", graph
        assert _fingerprint(_fetch("port", graph, cfg)) == got
    finally:
        transport.close()
        ex.shutdown()
        sched.shutdown()


def test_verify_lease_bands():
    from ballista_tpu_torch.analysis.plan_check import (
        PlanVerificationError,
        check_lease_bands,
        verify_lease_bands,
    )
    from ballista_tpu_torch.serving.lease import (
        DIRECT_TASK_ID_BASE,
        ExecutorLease,
        LeaseRegistry,
    )

    def mk(lease_id, start, size, cursor=0):
        return ExecutorLease(
            lease_id=lease_id, executor_id="e1", host="", flight_port=0,
            session_id="s", slots=1, expires_at=time.time() + 60,
            band_start=start, band_size=size, next_offset=cursor)

    base = DIRECT_TASK_ID_BASE
    assert verify_lease_bands([mk("a", base, 100), mk("b", base + 100, 100, cursor=50)]) == []
    for bad in ([mk("a", base, 100), mk("b", base + 50, 100)], [mk("a", base - 10, 100)],
                [mk("a", base, 100, cursor=101)]):
        assert any(v.code == "lease-band" for v in verify_lease_bands(bad))
    with pytest.raises(PlanVerificationError):
        check_lease_bands([mk("a", base, 0)])
    reg = LeaseRegistry()
    minted = [reg.mint(executor_id="e1", host="", flight_port=0, session_id="s",
                       slots=1, ttl_s=60) for _ in range(5)]
    assert verify_lease_bands(minted) == []
