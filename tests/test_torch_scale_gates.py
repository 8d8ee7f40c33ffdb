"""The port's TPC-H scale gates: the counterpart of tests/test_scale_gates.py.

Every gate carries `slow` beside its own marker, so the bounded run
(`-m 'not slow'`) never collects them, and pytest.ini's addopts leave them
out of a run that names no marker. Run one explicitly:

    python -m pytest -m sf1 tests/test_torch_scale_gates.py      # all 22, 2 executors
    python -m pytest -m pinned8 tests/test_torch_scale_gates.py  # all 22, pinned daemons
    python -m pytest -m sf10 tests/test_torch_scale_gates.py     # q1, q3, q6, q9 at SF10

Without a card, set BALLISTA_TORCH_PLATFORM=cpu: the device stages then run
their CPU forms, in this process and in every daemon it starts. On a host
whose Python has no jax, add `--noconftest`: this file imports nothing of
the JAX package or of tests/conftest.py.

Each answer is held to the port's own pandas oracle
(`ballista_tpu_torch/testing/reference.py`). The data is generated once
(seed 1, 8 files a table) under build/tpch_gates/ in the checkout, or in
$TPCH_DATA, and reused.
"""

import gc
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAEMON_DEADLINE_S = 180


def _query(q: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        return f.read()


def _dataset(scale: float, tag: str) -> str:
    from ballista_tpu_torch.testing.tpchgen import generate_tpch

    d = os.environ.get("TPCH_DATA", os.path.join(ROOT, "build", "tpch_gates", tag))
    if not os.path.isdir(os.path.join(d, "lineitem")):
        generate_tpch(d, scale=scale, seed=1, files_per_table=8)
    return d


_SF1_REF: dict = {}


def _sf1_reference(q: int):
    from ballista_tpu_torch.testing.reference import load_tables, run_reference

    if not _SF1_REF:
        _SF1_REF.update(load_tables(_dataset(1.0, "sf1")))
    return run_reference(q, _SF1_REF)


def _hold(got, want, q: int) -> None:
    from ballista_tpu_torch.testing.reference import compare_results

    problems = compare_results(got, want, q)
    assert not problems, "\n".join(problems)


@pytest.fixture(scope="module")
def sf1_cluster():
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    ex1 = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1", vcores=4)
    ex2 = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1",
                          vcores=4, policy="pull")
    ex1.start()
    ex2.start()
    time.sleep(0.3)
    yield addr
    ex1.shutdown()
    ex2.shutdown()
    sched.shutdown()


@pytest.mark.sf1
@pytest.mark.parametrize("q", range(1, 23))
def test_sf1_all22_distributed(q, sf1_cluster):
    """All 22 over two in-process executors (push and pull) with every
    shuffle read over Flight, each held to the pandas oracle at SF1."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import (
        CLIENT_JOB_TIMEOUT_S,
        SHUFFLE_READER_FORCE_REMOTE,
        BallistaConfig,
    )
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    data = _dataset(1.0, "sf1")
    want = _sf1_reference(q)
    ctx = SessionContext.remote(sf1_cluster, BallistaConfig(
        {SHUFFLE_READER_FORCE_REMOTE: True, CLIENT_JOB_TIMEOUT_S: 2400}))
    register_tpch(ctx, data)
    _hold(ctx.sql(_query(q)).collect(), want, q)


def _daemon_count() -> int:
    """8 daemons on the CPU forms, as the reference gate runs on its 8
    devices; on a card host one a visible card, at most 8 (two daemons on
    one card are not the deployment shape)."""
    from ballista_tpu_torch.ops.cuda import runtime

    if runtime.cpu_requested():
        return 8
    import torch

    return min(8, torch.cuda.device_count())


def _spawn_executor_daemon(addr: str, ordinal: int, work_dir: str):
    """`python -m ballista_tpu_torch.executor` pinned to `ordinal`; its
    stderr goes to a file (a pipe nobody drains could wedge it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(work_dir, exist_ok=True)
    err = os.path.join(work_dir, "daemon.stderr")
    p = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--scheduler", addr,
         "--bind-host", "127.0.0.1", "--external-host", "127.0.0.1", "--engine", "tpu",
         "--device-ordinal", str(ordinal), "--work-dir", work_dir,
         "--flight-server", "python", "--log-level", "WARNING"],
        env=env, stdout=subprocess.DEVNULL, stderr=open(err, "wb"))
    p.stderr_path = err
    return p


def _tail(p) -> str:
    try:
        with open(p.stderr_path, "rb") as f:
            return f.read()[-2000:].decode(errors="replace")
    except OSError:
        return "<no stderr captured>"


@pytest.fixture(scope="module")
def pinned_cluster(tmp_path_factory):
    """One executor daemon subprocess a card (8 on the CPU forms), each
    pinned to its own ordinal with one slot, under an in-process scheduler."""
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    n = _daemon_count()
    assert n >= 1, "no card is visible and BALLISTA_TORCH_PLATFORM is not cpu"
    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    root = tmp_path_factory.mktemp("pinned")
    procs = [_spawn_executor_daemon(addr, i, str(root / f"ex{i}")) for i in range(n)]
    try:
        deadline = time.time() + DAEMON_DEADLINE_S
        info: list = []
        while time.time() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{sched.rest_port}/api/executors", timeout=5) as r:
                info = json.load(r)
            if len(info) == n:
                break
            dead = [_tail(p) for p in procs if p.poll() is not None]
            assert not dead, f"daemon(s) died during startup: {dead}"
            time.sleep(1.0)
        assert len(info) == n, (f"only {len(info)}/{n} pinned daemons registered; "
                                f"stderr tails: {[_tail(p) for p in procs]}")
        assert sorted(e["device_ordinal"] for e in info) == list(range(n))
        yield addr
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        sched.shutdown()


@pytest.mark.pinned8
@pytest.mark.parametrize("q", range(1, 23))
def test_pinned_all22_sf1(q, pinned_cluster):
    """All 22 at SF1 over the pinned executor daemons with engine=tpu, each
    held to the pandas oracle."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import CLIENT_JOB_TIMEOUT_S, EXECUTOR_ENGINE, BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    data = _dataset(1.0, "sf1")
    want = _sf1_reference(q)
    ctx = SessionContext.remote(pinned_cluster, BallistaConfig(
        {EXECUTOR_ENGINE: "tpu", CLIENT_JOB_TIMEOUT_S: 2400}))
    register_tpch(ctx, data)
    _hold(ctx.sql(_query(q)).collect(), want, q)


SF10_QUERIES = [1, 3, 6, 9]
_SF10_WANTS: dict = {}


@pytest.fixture(scope="module")
def sf10_wants():
    """Every oracle answer first, then the pandas tables freed before any
    engine run: the two are never resident together."""
    from ballista_tpu_torch.testing.reference import load_tables, run_reference

    # the columns q1, q3, q6 and q9 read: the whole SF10 tables would take
    # about 40 GB (comment strings) before any merge
    cols = {
        "lineitem": ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
                     "l_extendedprice", "l_discount", "l_tax", "l_orderkey",
                     "l_partkey", "l_suppkey"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
        "customer": ["c_custkey", "c_mktsegment"],
        "part": ["p_partkey", "p_name"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "nation": ["n_nationkey", "n_name"],
    }
    if not _SF10_WANTS:
        tables = load_tables(_dataset(10.0, "sf10"), columns=cols)
        for q in SF10_QUERIES:
            _SF10_WANTS[q] = run_reference(q, tables)
        del tables
        gc.collect()
    return _SF10_WANTS


@pytest.mark.sf10
@pytest.mark.parametrize("q", SF10_QUERIES)
def test_sf10_single_query(q, sf10_wants):
    """q1 and q6 (scan and aggregate), q3 and q9 (joins and aggregate) at
    SF10 through the standalone mode with engine=tpu, held to the pandas
    oracle; the device caches are dropped after each query."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import CLIENT_JOB_TIMEOUT_S, EXECUTOR_ENGINE, BallistaConfig
    from ballista_tpu_torch.ops.cuda.stage_compiler import clear_device_caches
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    data = _dataset(10.0, "sf10")
    ctx = SessionContext.standalone(
        BallistaConfig({EXECUTOR_ENGINE: "tpu", CLIENT_JOB_TIMEOUT_S: 3600}),
        num_executors=2, vcores=2)
    register_tpch(ctx, data)
    try:
        got = ctx.sql(_query(q)).collect()
    finally:
        ctx.shutdown()
        clear_device_caches()
        gc.collect()
    _hold(got, sf10_wants[q], q)
