"""The port's remote mode on the CPU.

A scheduler daemon and executor daemons talk gRPC over 127.0.0.1:
`SchedulerProcess` (gRPC, REST, the KEDA scaler, the Flight result proxy),
one push and one pull `ExecutorProcess` at engine=tpu (each serving its
shuffle files over Flight), and `SessionContext.remote(addr)` on the client.
The port runs after runtime.use_cpu(), so every kernel wrapper takes its
plain form; the JAX package runs an in-process cluster with JAX_PLATFORMS=cpu
(its Pallas kernels in interpret mode) whose second executor is a push
executor: the reference's PollWork sends a pulled task without its
session's settings, so its pull executor runs the task on the CPU engine
(ROADMAP C10, repaired in the port). Answers must be byte-identical to the
JAX package's remote mode, and equal to the port's local mode under
PERF.md §2's rule (a distributed plan merges one partial per partition, so
its float sums may associate differently).

Also: binding a process to one card (`runtime.bind_process_ordinal`),
the CPU requested through BALLISTA_TORCH_PLATFORM across a process
boundary, and a real executor daemon started with
`python -m ballista_tpu_torch.executor`.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from types import SimpleNamespace

import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import tpch_query
from .test_tls import _gen_certs
from .test_torch_standalone import assert_same_answer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
PALLAS = {"ballista.tpu.fusion.mode": "fused_pallas"}
# (fusion mode, query); on the CPU only fused_pallas reaches the kernel
# wrappers: q4 masked_group_reduce, q5 hash_probe, q12 dict_filter
RUNS = ([("auto", q) for q in (1, 3, 4, 5, 13, 22)]
        + [("fused_pallas", q) for q in (4, 5, 12)])
KERNELS = {4: "masked_group_reduce", 5: "hash_probe", 12: "dict_filter"}
DEADLINE_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


# -- binding a process to one card -----------------------------------------


@pytest.fixture()
def one_visible_card(monkeypatch):
    monkeypatch.setattr(runtime, "_cpu_requested", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_bound_process_maps_its_ordinal_to_the_one_visible_card(one_visible_card, monkeypatch):
    # an executor started with --device-ordinal 1 on a host of several cards
    # binds CUDA_VISIBLE_DEVICES=1 and sees that card as cuda:0
    monkeypatch.setattr(runtime, "_bound_ordinal", 1)
    assert runtime.device(1) == torch.device("cuda", 0)
    assert runtime.device(-1) == torch.device("cuda", 0)


def test_unbound_process_never_aliases_an_ordinal(one_visible_card, monkeypatch):
    monkeypatch.setattr(runtime, "_bound_ordinal", -1)
    assert runtime.device(0) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="device ordinal 1 out of range: 1 cards"):
        runtime.device(1)


def test_bind_process_ordinal_sets_the_visible_card(monkeypatch):
    monkeypatch.setattr(runtime, "_bound_ordinal", -1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")  # inherited: the ordinal wins
    assert not runtime.bind_process_ordinal(-1)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    assert runtime.bind_process_ordinal(2)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2"
    assert runtime.bound_ordinal() == 2


def test_bind_process_ordinal_refuses_once_a_context_exists(monkeypatch):
    monkeypatch.setattr(runtime, "_bound_ordinal", -1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert not runtime.bind_process_ordinal(1)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert runtime.bound_ordinal() == -1


@pytest.mark.parametrize("value,cpu", [("cpu", True), ("CPU", True), ("cuda", False),
                                       ("", False), (None, False)])
def test_cpu_requested_through_the_environment(value, cpu, monkeypatch):
    monkeypatch.setattr(runtime, "_cpu_requested", None)  # use_cpu() never called
    if value is None:
        monkeypatch.delenv(runtime.PLATFORM_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.PLATFORM_ENV, value)
    assert runtime.cpu_requested() is cpu
    runtime.use_cpu(False)  # an explicit call wins over the environment
    assert runtime.cpu_requested() is False


def test_kernel_loads_counted_against_the_build_directory(monkeypatch, tmp_path):
    # the executor's tpu_persist_cache_* gauges: loads, and loads that
    # found the library built
    from ballista_tpu_torch.ops.cuda import build

    monkeypatch.setattr(runtime, "_build_dir", str(tmp_path))
    monkeypatch.setattr(runtime, "_cc_counts", {"requests": 0, "hits": 0})
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "ctypes", SimpleNamespace(CDLL=lambda path: path))

    def fake_build(names=build.SOURCES):
        paths = {n: build._target(n)[1] for n in names}
        for p in paths.values():
            open(p, "wb").close()
        return paths

    monkeypatch.setattr(build, "build_all", fake_build)
    build.load("dict_filter")  # built here: a miss
    build.load("dict_filter")  # loaded already: not counted again
    build._libs.clear()
    build.load("dict_filter")  # found built: a hit
    assert runtime.compile_cache_stats() == {
        "dir": str(tmp_path), "requests": 2, "hits": 1, "misses": 1}


# -- an in-process cluster over real sockets --------------------------------


def _cluster(pkg: str, work_root: str, policies=("push", "pull")):
    """A scheduler (REST and the Flight proxy on), a push executor pinned
    to ordinal 0 (one slot) and an unpinned executor of two slots, both at
    engine=tpu, under `policies`."""
    if pkg == "port":
        from ballista_tpu_torch.executor.executor_process import ExecutorProcess
        from ballista_tpu_torch.scheduler.process import SchedulerProcess
    else:
        from ballista_tpu.executor.executor_process import ExecutorProcess
        from ballista_tpu.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    execs = [ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1",
                             engine="tpu", policy=policy, work_dir=os.path.join(work_root, pkg, name),
                             **({"device_ordinal": 0} if name == "pinned" else {"vcores": 2}))
             for name, policy in zip(("pinned", "wide"), policies)]
    for ex in execs:
        ex.start()
    return sched, addr, execs


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("remote"))
    made = {"port": _cluster("port", root), "jax": _cluster("jax", root, ("push", "push"))}
    yield made
    for sched, _addr, execs in made.values():
        for ex in execs:
            ex.shutdown()
        sched.shutdown()


def _remote_ctx(pkg, addr, tpch_dir, **extra):
    if pkg == "port":
        from ballista_tpu_torch.client.context import SessionContext
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.testing.tpchgen import register_tpch
    else:
        from ballista_tpu.client.context import SessionContext
        from ballista_tpu.config import BallistaConfig
        from ballista_tpu.testing.tpchgen import register_tpch
    ctx = SessionContext.remote(addr, BallistaConfig({**BASE_CFG, **extra}))
    register_tpch(ctx, tpch_dir)
    return ctx


def _local_ctx(tpch_dir, **extra):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({**BASE_CFG, **extra}))
    register_tpch(ctx, tpch_dir)
    return ctx


def _claims(graph):
    from ballista_tpu_torch.testing.standalone_stats import stage_stats

    return {sid: (s["tasks"], s["device"]) for sid, s in stage_stats(graph).items()}


@pytest.fixture(scope="module")
def runs(clusters, tpch_dir):
    """Each (mode, query) of RUNS once through each package's cluster:
    (answer, per-stage claims, kernel wrapper calls of the port's run)."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.testing.standalone_stats import last_job

    calls = dict.fromkeys(KERNELS.values(), 0)
    wrapped = {}
    for name in KERNELS.values():
        def counting(*a, _fn=getattr(ck, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        wrapped[name] = getattr(ck, name)
        setattr(ck, name, counting)
    out = {}
    try:
        for pkg in ("port", "jax"):
            sched, addr, _ = clusters[pkg]
            ctxs = {mode: _remote_ctx(pkg, addr, tpch_dir, **(PALLAS if mode != "auto" else {}))
                    for mode in ("auto", "fused_pallas")}
            for mode, q in RUNS:
                before = dict(calls)
                tbl = ctxs[mode].sql(tpch_query(q)).collect()
                out[pkg, mode, q] = (tbl, _claims(last_job(sched.scheduler)),
                                     {k: calls[k] - before[k] for k in calls})
    finally:
        for name, fn in wrapped.items():
            setattr(ck, name, fn)
    return out


@pytest.mark.parametrize("mode,q", RUNS)
def test_remote_byte_identical_to_jax_remote(mode, q, runs):
    want = runs["jax", mode, q][0]
    got = runs["port", mode, q][0]
    assert want.num_rows > 0
    assert got.schema.equals(want.schema)
    assert got.equals(want)


@pytest.mark.parametrize("mode,q", RUNS)
def test_remote_equals_local_mode(mode, q, runs, tpch_dir):
    local = _local_ctx(tpch_dir, **(PALLAS if mode != "auto" else {}))
    assert_same_answer(runs["port", mode, q][0], local.sql(tpch_query(q)).collect())


@pytest.mark.parametrize("mode,q", RUNS)
def test_device_stages_ran_in_every_task_without_fallback(mode, q, runs):
    # the stages the JAX package's cluster claims for the device, each node
    # one device pass per task and no CPU fallback
    claims = runs["port", mode, q][1]
    assert claims == runs["jax", mode, q][1]
    assert any(dev for _tasks, dev in claims.values())
    for tasks, dev in claims.values():
        for nodes, passes, fallbacks in dev.values():
            assert nodes == passes == tasks and fallbacks == 0


def test_job_metrics_reply_gives_the_graphs_device_counts(clusters, tpch_dir):
    # what chip_smoke.py reads from a scheduler daemon in another process
    from ballista_tpu_torch.testing.standalone_stats import (
        job_metrics_stats, last_job, stage_stats)

    sched, addr, _ = clusters["port"]
    ctx = _remote_ctx("port", addr, tpch_dir)
    ctx.sql(tpch_query(1)).collect()
    graph = last_job(sched.scheduler)
    got = job_metrics_stats(ctx._ensure_remote().job_metrics(graph.job_id))
    want = stage_stats(graph)
    keys = ("tasks", "device", "device_passes", "fallbacks")
    assert {sid: [s[k] for k in keys] for sid, s in got.items()} == \
        {sid: [s[k] for k in keys] for sid, s in want.items()}
    assert any(s["device_passes"] for s in got.values())


@pytest.mark.parametrize("q", sorted(KERNELS))
def test_kernel_wrappers_called_under_fused_pallas(q, runs):
    calls = runs["port", "fused_pallas", q][2]
    assert calls[KERNELS[q]] >= 1, calls


def test_both_executors_ran_tasks(clusters, runs):
    sched, _, execs = clusters["port"]
    ran = [len(os.listdir(ex.work_dir)) for ex in execs]
    assert all(ran), ran  # job dirs of shuffle output under each work dir


def test_pull_executor_runs_with_the_session_config(tmp_path, tpch_dir, runs):
    # C10: a pulled task carries its session's settings, as a pushed one
    # does: engine=tpu (every device stage on the card's engine) and
    # force_remote_read (every read over Flight, even from this executor's
    # own files)
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    sched, addr, execs = _cluster("port", str(tmp_path), ("pull", "pull"))
    try:
        ctx = _remote_ctx("port", addr, tpch_dir,
                          **{"ballista.shuffle.reader.force_remote_read": True})
        got = ctx.sql(tpch_query(3)).collect()
        stats = stage_stats(last_job(sched.scheduler))
    finally:
        for ex in execs:
            ex.shutdown()
        sched.shutdown()
    assert got.equals(runs["jax", "auto", 3][0])
    assert any(s["device"] for s in stats.values())
    for s in stats.values():
        for nodes, passes, fallbacks in s["device"].values():
            assert nodes == passes == s["tasks"] and fallbacks == 0
    assert sum(s["bytes_read_local"] for s in stats.values()) == 0
    assert sum(s["bytes_fetched_remote"] for s in stats.values()) > 0


def test_force_remote_read_over_flight(clusters, tpch_dir, runs):
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    sched, addr, _ = clusters["port"]
    ctx = _remote_ctx("port", addr, tpch_dir,
                      **{"ballista.shuffle.reader.force_remote_read": True})
    got = ctx.sql(tpch_query(3)).collect()
    assert got.equals(runs["jax", "auto", 3][0])
    stats = stage_stats(last_job(sched.scheduler))
    assert sum(s["bytes_read_local"] for s in stats.values()) == 0
    assert sum(s["bytes_fetched_remote"] for s in stats.values()) > 0


def test_flight_result_proxy(clusters, tpch_dir):
    sched, addr, _ = clusters["port"]
    assert sched.flight_proxy_port > 0
    ctx = _remote_ctx("port", addr, tpch_dir,
                      **{"ballista.client.flight.proxy": f"127.0.0.1:{sched.flight_proxy_port}"})
    out = ctx.sql("select r_name, count(*) c from nation, region "
                  "where n_regionkey = r_regionkey group by r_name order by r_name").collect()
    assert out.column("c").to_pylist() == [5, 5, 5, 5, 5]


def test_rest_executors_and_jobs(clusters, runs):
    sched, _, _ = clusters["port"]
    base = f"http://127.0.0.1:{sched.rest_port}"
    execs = json.load(urllib.request.urlopen(f"{base}/api/executors", timeout=5))
    by_slots = sorted((e["total_slots"], e["device_ordinal"]) for e in execs)
    assert by_slots == [(1, 0), (2, -1)]  # the pinned push executor has one slot
    jobs = json.load(urllib.request.urlopen(f"{base}/api/jobs", timeout=5))
    assert len(jobs) >= len(RUNS)
    assert all(j["state"] == "successful" for j in jobs[:len(RUNS)])
    stages = json.load(urllib.request.urlopen(
        f"{base}/api/job/{jobs[0]['job_id']}/stages", timeout=5))
    assert stages and "plan" in stages[0]


def test_keda_external_scaler(clusters):
    import grpc

    from ballista_tpu_torch.proto import keda_pb2 as kpb
    from ballista_tpu_torch.scheduler.external_scaler import external_scaler_stub

    _, addr, _ = clusters["port"]
    with grpc.insecure_channel(addr) as ch:
        stub = external_scaler_stub(ch)
        assert stub.IsActive(kpb.ScaledObjectRef(name="x")).result is True
        spec = stub.GetMetricSpec(kpb.ScaledObjectRef(name="x"))
        assert [(m.metricName, m.targetSize) for m in spec.metricSpecs] == [
            ("pending_jobs", 1), ("shard_queue_depth", 1)]
        vals = {m.metricName: m.metricValue
                for m in stub.GetMetrics(kpb.GetMetricsRequest()).metricValues}
        assert vals["pending_jobs"] == 0 and vals["running_jobs"] == 0


def test_cancel_job(clusters, tpch_dir):
    _, addr, _ = clusters["port"]
    client = _remote_ctx("port", addr, tpch_dir)._ensure_remote()
    job_id = client.execute_sql(tpch_query(9))
    client.cancel_job(job_id)
    status = client.wait_for_job(job_id, timeout=30)
    assert status["state"] in ("cancelled", "successful")  # may finish first


def test_remote_explain_analyze(clusters, tpch_dir):
    _, addr, _ = clusters["port"]
    out = _remote_ctx("port", addr, tpch_dir).sql(
        "explain analyze select n_regionkey, count(*) from nation group by n_regionkey"
    ).collect()
    plans = dict(zip(out.column("plan_type").to_pylist(), out.column("plan").to_pylist()))
    body = plans.get("analyzed_plan (distributed)", "")
    assert "stage" in body and "elapsed_ms" in body, plans


def test_heartbeat_carries_the_device_gauges(clusters, runs):
    _, _, execs = clusters["port"]
    gauges = dict(execs[0]._overload_metrics())
    for key in ("tpu_exec_s", "tpu_fill_s", "tpu_persist_cache_requests",
                "tpu_persist_cache_hits"):
        assert key in gauges, sorted(gauges)
    assert gauges["tpu_persist_cache_hits"] <= gauges["tpu_persist_cache_requests"]


def test_append_and_prepare_raise_in_remote_mode(clusters, tpch_dir):
    # AppendData and PrepareStatement / ExecutePrepared over gRPC answer as
    # local mode does; the appended table is this test's own, so the
    # module's other queries over nation see no delta
    _, addr, _ = clusters["port"]
    rows = pa.table({"n_nationkey": [99], "n_name": ["ATLANTIS"], "n_regionkey": [0],
                     "n_comment": ["appended"]})
    sql = "select n_regionkey, count(*) c from nation_a9 group by n_regionkey order by n_regionkey"
    answers = []
    for ctx in (_remote_ctx("port", addr, tpch_dir), _local_ctx(tpch_dir)):
        ctx.register_parquet("nation_a9", os.path.join(tpch_dir, "nation"))
        out = ctx.append("nation_a9", rows)
        assert out["table"] == "nation_a9" and out["rows"] == 1
        ps = ctx.prepare("select n_name from nation_a9 where n_nationkey = 1")
        answers.append((ctx.sql(sql).collect(), ps.execute([99]), ps.execute([2])))
        ps.close()
    for got, want in zip(*answers):
        assert got.equals(want)
    assert answers[0][0].column("c").to_pylist()[0] == 6
    assert answers[0][1].column("n_name").to_pylist() == ["ATLANTIS"]


# -- real daemons -----------------------------------------------------------


def _spawn_executor(addr: str, work_dir: str, cpu: bool):
    """`python -m ballista_tpu_torch.executor` pinned to ordinal 0; its
    stderr goes to a file (a pipe nobody drains could wedge it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(runtime.PLATFORM_ENV, None)
    if cpu:
        env[runtime.PLATFORM_ENV] = "cpu"
    os.makedirs(work_dir, exist_ok=True)
    err = os.path.join(work_dir, "daemon.stderr")
    p = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--scheduler", addr,
         "--bind-host", "127.0.0.1", "--external-host", "127.0.0.1", "--engine", "tpu",
         "--device-ordinal", "0", "--work-dir", work_dir, "--flight-server", "python",
         "--log-level", "WARNING"],
        env=env, stdout=subprocess.DEVNULL, stderr=open(err, "wb"))
    p.stderr_path = err
    return p


def _tail(p) -> str:
    with open(p.stderr_path, "rb") as f:
        return f.read()[-2000:].decode(errors="replace")


def _wait_registered(sched, p) -> list:
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{sched.rest_port}/api/executors", timeout=5) as r:
            info = json.load(r)
        if info:
            return info
        assert p.poll() is None, _tail(p)
        time.sleep(0.3)
    raise AssertionError("the executor daemon did not register in time:\n" + _tail(p))


def test_executor_daemon_subprocess(tmp_path, tpch_dir):
    """Two real daemons at once, each under its own scheduler: one with the
    CPU requested through BALLISTA_TORCH_PLATFORM answers q6 as local mode
    does, registered with ordinal 0 and one slot, and drains on SIGTERM;
    one without that request on a machine without a card fails the job:
    its device stages raise, nothing runs quietly on the CPU."""
    from ballista_tpu_torch.errors import ExecutionError
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    scheds = [SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0,
                               flight_proxy_port=-1) for _ in range(2)]
    procs = []
    try:
        for s in scheds:
            s.start()
        procs = [_spawn_executor(f"127.0.0.1:{s.port}", str(tmp_path / f"ex{i}"), cpu=i == 0)
                 for i, s in enumerate(scheds)]
        for s, p in zip(scheds, procs):
            info = _wait_registered(s, p)
            assert [(e["device_ordinal"], e["total_slots"]) for e in info] == [(0, 1)]
        got = _remote_ctx("port", f"127.0.0.1:{scheds[0].port}", tpch_dir).sql(
            tpch_query(6)).collect()
        assert_same_answer(got, _local_ctx(tpch_dir).sql(tpch_query(6)).collect())
        if not torch.cuda.is_available():
            with pytest.raises(ExecutionError, match="no CUDA device"):
                _remote_ctx("port", f"127.0.0.1:{scheds[1].port}", tpch_dir).sql(
                    tpch_query(6)).collect()
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=DEADLINE_S) == 0, _tail(procs[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for s in scheds:
            s.shutdown()


def test_executor_wait_returns_once_shutdown_has_finished():
    """C11: the daemon's SIGTERM drain runs shutdown() on a daemon thread
    while main() sits in wait(). wait() must return only after shutdown()
    has stopped the native Flight server: returning when shutdown() begins
    lets the process exit with that server still running, orphaned."""
    import threading

    from ballista_tpu_torch.executor.executor_process import ExecutorProcess

    stopped = []
    ex = ExecutorProcess.__new__(ExecutorProcess)
    ex._stopping, ex._stopped = threading.Event(), threading.Event()
    ex.metadata = SimpleNamespace(id="e0")
    # the scheduler's ExecutorStopped RPC takes its time, as over a network
    ex._scheduler = SimpleNamespace(ExecutorStopped=lambda *a, **k: time.sleep(0.5))
    ex.service = SimpleNamespace(stop=lambda: None)
    ex.grpc_server = SimpleNamespace(stop=lambda grace: None)
    ex.flight_server = None
    ex.native_flight_proc = SimpleNamespace(terminate=lambda: stopped.append("native"),
                                            wait=lambda timeout: 0)
    ex.health_server = SimpleNamespace(shutdown=lambda: None)
    drain = threading.Thread(target=ex.shutdown, daemon=True)
    drain.start()
    ex.wait()
    assert stopped == ["native"]
    drain.join()


def test_mtls_cluster_end_to_end(tmp_path, tpch_dir):
    # every gRPC hop and the Flight data plane authenticated from one CA; a
    # pinned engine=tpu executor answers q6
    import grpc

    from ballista_tpu_torch.config import GRPC_TLS_CA, GRPC_TLS_CERT, GRPC_TLS_KEY
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler.grpc_service import scheduler_stub
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    certs = _gen_certs(str(tmp_path))
    sched = SchedulerProcess(
        bind_host="127.0.0.1", port=0, rest_port=-1, flight_proxy_port=-1,
        tls_cert=certs["server_crt"], tls_key=certs["server_key"],
        tls_client_ca=certs["ca"])
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    ex = ExecutorProcess(
        addr, bind_host="127.0.0.1", external_host="127.0.0.1", engine="tpu",
        device_ordinal=0, work_dir=str(tmp_path / "ex"),
        tls_cert=certs["server_crt"], tls_key=certs["server_key"], tls_ca=certs["ca"])
    ex.start()
    try:
        assert ex.flight_server is not None  # TLS serves the Python Flight server
        ctx = _remote_ctx("port", addr, tpch_dir, **{
            GRPC_TLS_CA: certs["ca"], GRPC_TLS_CERT: certs["client_crt"],
            GRPC_TLS_KEY: certs["client_key"]})
        got = ctx.sql(tpch_query(6)).collect()
        assert_same_answer(got, _local_ctx(tpch_dir).sql(tpch_query(6)).collect())
        bare = scheduler_stub(grpc.insecure_channel(addr))
        with pytest.raises(grpc.RpcError):
            bare.GetJobStatus(pb.GetJobStatusParams(job_id="x"), timeout=5)
    finally:
        ex.shutdown()
        sched.shutdown()


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
def test_pinned_daemon_runs_its_stages_on_the_card(tmp_path, tpch_dir):
    """A real executor daemon pinned to card 0 (the card requested, not the
    CPU) answers q1 and q6 as the card's local mode does, and is the only
    process of the test holding the new CUDA context."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0, flight_proxy_port=-1)
    sched.start()
    p = _spawn_executor(f"127.0.0.1:{sched.port}", str(tmp_path / "ex"), cpu=False)
    prev = runtime.cpu_requested()
    try:
        info = _wait_registered(sched, p)
        assert [(e["device_ordinal"], e["total_slots"]) for e in info] == [(0, 1)]
        for q in (1, 6):
            got = _remote_ctx("port", f"127.0.0.1:{sched.port}", tpch_dir).sql(
                tpch_query(q)).collect()
            runtime.use_cpu(False)
            want = _local_ctx(tpch_dir).sql(tpch_query(q)).collect()
            runtime.use_cpu(prev)
            assert_same_answer(got, want)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=DEADLINE_S) == 0, _tail(p)
    finally:
        runtime.use_cpu(prev)
        if p.poll() is None:
            p.kill()
        p.wait()
        sched.shutdown()


@pytest.mark.gpu
def test_bind_process_ordinal_in_a_fresh_process_on_the_card():
    """A fresh process binds to the host's last card and sees it as cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from ballista_tpu_torch.ops.cuda import runtime\n"
        f"assert runtime.bind_process_ordinal({torch.cuda.device_count() - 1})\n"
        "assert torch.cuda.device_count() == 1\n"
        f"d = runtime.device({torch.cuda.device_count() - 1})\n"
        "x = torch.ones(4, device=d)\n"
        "assert d == torch.device('cuda', 0) and float(x.sum()) == 4.0\n"
        "assert not runtime.bind_process_ordinal(0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=DEADLINE_S)
    assert r.returncode == 0, r.stderr[-2000:]
