"""Boundaries of the PyTorch/CUDA port (ballista_tpu_torch).

The port stands alone: no file of it, nor chip_smoke.py, imports jax,
jaxlib or any module of the JAX package; every `ballista_tpu_torch`
import names a module the port has; running a query through the port,
in local mode, in the standalone mode (scheduler, executors, shuffle
files, Flight, the serving surface and direct dispatch) and in the remote
mode (daemons over gRPC), loads nothing
of the JAX package; importing the daemons, the client and the device
daemon's client side makes no torch.cuda call (an executor daemon binds its card before its first
one); and without CUDA the device engine raises unless the CPU was asked
for.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ballista_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ballista_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dp, _dn, fns in os.walk(PORT):
        out.extend(os.path.join(dp, f) for f in fns if f.endswith(".py"))
    return sorted(out)


def _imports(path):
    """(lineno, module, names) for every absolute import in the file,
    lazy ones inside functions included."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name, ()
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module, tuple(a.name for a in node.names)


def _module_path(mod):
    base = os.path.join(ROOT, *mod.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def test_port_sources_found():
    srcs = _sources()
    assert len(srcs) > 40
    assert any(p.endswith(os.path.join("ops", "cuda", "stage_compiler.py")) for p in srcs)
    assert any(p.endswith(os.path.join("client", "direct.py")) for p in srcs)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_every_port_import_resolves(path):
    for lineno, mod, names in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path}:{lineno} imports {mod}"
        if top != "ballista_tpu_torch":
            continue
        target = _module_path(mod)
        assert target is not None, f"{path}:{lineno}: no module {mod}"
        if target.endswith("__init__.py"):
            # `from pkg import name`: a submodule, or a name the package defines
            init_src = open(target).read()
            for n in names:
                assert _module_path(f"{mod}.{n}") is not None or n in init_src, \
                    f"{path}:{lineno}: {mod} has no {n}"


def test_query_loads_nothing_of_the_jax_package(tpch_dir):
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import pyarrow as pa
from ballista_tpu_torch.ops.cuda import runtime
runtime.use_cpu()
from ballista_tpu_torch.client.context import SessionContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.testing.tpchgen import register_tpch
ctx = SessionContext(BallistaConfig({{"ballista.executor.engine": "tpu",
                                      "ballista.tpu.min.rows": 0}}))
register_tpch(ctx, {tpch_dir!r})
sql = open({os.path.join(ROOT, "benchmarks", "tpch", "queries", "q4.sql")!r}).read()
assert ctx.sql(sql).collect().num_rows > 0
# the standalone mode: scheduler, executors, shuffle files and every read
# over the in-process Flight server
sa = SessionContext.standalone(BallistaConfig({{
    "ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0,
    "ballista.shuffle.reader.force_remote_read": True}}), num_executors=2)
register_tpch(sa, {tpch_dir!r})
q3 = open({os.path.join(ROOT, "benchmarks", "tpch", "queries", "q3.sql")!r}).read()
assert sa.sql(q3).collect().num_rows > 0
assert sa._cluster.flight_server.stats["bytes_served"] > 0
# the serving surface: a prepared statement, an append, a continuous
# query, and direct dispatch over a lease
ps = sa.prepare("select count(*) n from nation where n_regionkey = 1")
assert ps.execute([2]).num_rows == 1
sub = ps.subscribe([2])
assert sub.next(timeout=30).num_rows == 1
sa.append("nation", pa.table({{"n_nationkey": [99], "n_name": ["X"], "n_regionkey": [2],
                               "n_comment": ["x"]}}))
assert sub.next(timeout=30).column("n").to_pylist() == [6]
sub.close()
from ballista_tpu_torch.client.direct import DirectDispatcher, LocalLeaseTransport
sched = sa._cluster.scheduler
sid = sched.sessions.create_or_update(sa.config.to_key_value_pairs(), str(sa.session_id))
d = DirectDispatcher(sched, LocalLeaseTransport(sa._cluster.executors), sid)
d.prepare("select r_name from region where r_regionkey < 3")
assert d.execute((2,))["direct_dispatch"] is True
sa.shutdown()
# the remote mode: scheduler and executor daemons over gRPC on 127.0.0.1
from ballista_tpu_torch.executor.executor_process import ExecutorProcess
from ballista_tpu_torch.scheduler.process import SchedulerProcess
sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1, flight_proxy_port=-1)
sched.start()
ex = ExecutorProcess(f"127.0.0.1:{{sched.port}}", bind_host="127.0.0.1",
                     external_host="127.0.0.1", engine="tpu", device_ordinal=0,
                     flight_impl="python")
ex.start()
rc = SessionContext.remote(f"127.0.0.1:{{sched.port}}", BallistaConfig({{
    "ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}}))
register_tpch(rc, {tpch_dir!r})
assert rc.sql(sql).collect().num_rows > 0
ex.shutdown()
sched.shutdown()
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "ballista_tpu") or m.startswith(("jax.", "jaxlib.", "ballista_tpu.")))
print("LOADED", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


def test_daemon_and_client_imports_make_no_cuda_call():
    # a torch.cuda query before bind_process_ordinal would fix the process's
    # visible cards (CUDA reads CUDA_VISIBLE_DEVICES once), and the
    # scheduler must create no CUDA context: importing the daemons, the
    # remote client and the engine calls nothing of torch.cuda, nor does
    # importing the device daemon's client, its protocol and the route an
    # attached process ships its stages through
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch
calls = []
for name in ("is_available", "device_count", "init", "_lazy_init", "current_device",
             "get_device_properties", "get_device_name", "mem_get_info", "synchronize"):
    setattr(torch.cuda, name, lambda *a, _n=name, **k: calls.append(_n))
import ballista_tpu_torch.executor.executor_process
import ballista_tpu_torch.scheduler.process
import ballista_tpu_torch.client.remote
import ballista_tpu_torch.client.context
import ballista_tpu_torch.client.direct
import ballista_tpu_torch.engine.cuda_engine
import ballista_tpu_torch.ops.cuda.stage_compiler
import ballista_tpu_torch.ops.cuda.cuda_kernels
import ballista_tpu_torch.device_daemon.client
import ballista_tpu_torch.device_daemon.protocol
import ballista_tpu_torch.ops.cuda.daemon_route
print("CALLS", calls)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CALLS []" in out.stdout, out.stdout[-2000:]


def test_runtime_raises_without_cuda_unless_cpu_requested(monkeypatch):
    import torch

    from ballista_tpu_torch.ops.cuda import runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = runtime.cpu_requested()
    try:
        runtime.use_cpu(False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.device()
        runtime.use_cpu(True)
        assert runtime.device() == torch.device("cpu")
        assert runtime.device_kind() == "cpu"
    finally:
        runtime.use_cpu(prev)


def test_cuda_wrapper_never_falls_back_to_the_plain_form():
    # a tensor on a device with no kernel raises instead of quietly taking
    # the plain path (only CPU tensors take it)
    import torch

    from ballista_tpu_torch.ops.cuda.cuda_kernels import masked_group_reduce

    meta = torch.zeros((2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        masked_group_reduce(meta, meta.to(torch.int32), meta.to(torch.bool), 4)
