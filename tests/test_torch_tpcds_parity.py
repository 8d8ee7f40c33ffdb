"""TPC-DS through the port against the JAX package's device engine, on the
CPU: byte-identical answers (Arrow IPC) and the same device claims.

Both packages read one TPC-DS SF0.1 directory (seed 17, 2 files per sales
table, as tests/test_tpcds.py) with engine=tpu and ballista.tpu.min.rows 0:
the port after runtime.use_cpu(), the JAX package with JAX_PLATFORMS=cpu
(its Pallas kernels in interpret mode). The shapes are the ones the JAX
package's own device tests pin (tests/test_tpcds.py's
test_tpcds_tpu_engine and test_tpcds_sort_window_device_stages), with
q93 (ROADMAP C12) and q64, whose final stage falls back in both (C14).
The rollup-rank shapes, whose XLA compiles cost the reference most, are
in test_torch_tpcds_parity_rollup.py, so the two files run apart.
"""

import os

import pyarrow as pa
import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
# star joins, date filters, returns chains (test_tpcds.py:58), the moving
# window of q47 and the window over an aggregate of q98 (:87), q64
SHAPES = [3, 7, 19, 25, 42, 43, 47, 52, 55, 64, 68, 93, 98, 99]
DEVICE_NODES = ("TpuStageExec", "TpuFinalStageExec", "TpuSortStageExec",
                "TpuWindowStageExec")


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


@pytest.fixture(scope="module")
def tpcds_dir(tmp_path_factory):
    from ballista_tpu_torch.testing.tpcdsgen import generate_tpcds

    d = str(tmp_path_factory.mktemp("tpcds_parity") / "sf01")
    generate_tpcds(d, scale=0.1, seed=17, files_per_table=2)
    return d


def _run(pkg: str, tpcds_dir: str, q: int, **cfg):
    """(answer, [(device node kind, device runs, fallbacks)] in plan order)
    of one local run through `pkg`'s device engine."""
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    gen_mod = __import__(f"{pkg}.testing.tpcdsgen", fromlist=["register_tpcds"])
    eng_mod = __import__(
        f"{pkg}.engine.{'cuda' if pkg.endswith('torch') else 'tpu'}_engine",
        fromlist=["maybe_compile_tpu"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig({**TPU_CFG, **cfg}))
    gen_mod.register_tpcds(ctx, tpcds_dir)
    with open(os.path.join(ROOT, "benchmarks", "tpcds", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    phys = eng_mod.maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    out = ctx.execute_collect(phys)
    claims = [(type(n).__name__, n.tpu_count, n.fallback_count)
              for n in iter_plan(phys) if type(n).__name__ in DEVICE_NODES]
    return out, claims


def _ipc(tbl: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl.combine_chunks())
    return sink.getvalue().to_pybytes()


def check_parity(q: int, tpcds_dir: str, **cfg) -> None:
    want, want_claims = _run("ballista_tpu", tpcds_dir, q, **cfg)
    got, claims = _run("ballista_tpu_torch", tpcds_dir, q, **cfg)
    assert got.schema.equals(want.schema, check_metadata=True)
    assert _ipc(got) == _ipc(want), f"q{q}: answers differ"
    assert claims == want_claims
    assert any(runs for _, runs, _ in claims), f"q{q}: no device stage ran"


@pytest.mark.parametrize("q", SHAPES)
def test_tpcds_byte_identical_to_jax_engine(q, tpcds_dir):
    check_parity(q, tpcds_dir)


def test_tpcds_float32_kernel_lanes_byte_identical_under_fused_pallas(tpcds_dir):
    # q18's averages go through masked_group_reduce's float32 sums where
    # the cost model picks the kernel family (as auto mode does on the
    # card): they differ from the CPU engine's float64 by up to 1e-7, and
    # equal the JAX package's Pallas kernel bit for bit
    check_parity(18, tpcds_dir, **{"ballista.tpu.fusion.mode": "fused_pallas"})
