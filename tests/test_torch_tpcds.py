"""TPC-DS through the port on the CPU, against its own pandas oracle.

Data: the port's generator at SF0.1, seed 17, 2 files per sales table, as
tests/test_tpcds.py makes it for the JAX package. Every one of the 99
queries runs through `SessionContext` with engine=tpu (ballista.tpu.min.rows
0, so small final stages stay on the device engine too) after
runtime.use_cpu(), and is compared with `testing.tpcds_reference`. q4, q11
and q74 raise one SchemaError under engine=tpu in both packages (ROADMAP
C13) and answer under engine=cpu. The port's generator and oracle are
copies of the JAX package's: they must write and answer the same bytes.
"""

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
C13 = (4, 11, 74)


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


@pytest.fixture(scope="module")
def tpcds_dir(tmp_path_factory):
    from ballista_tpu_torch.testing.tpcdsgen import generate_tpcds

    d = str(tmp_path_factory.mktemp("tpcds_port") / "sf01")
    generate_tpcds(d, scale=0.1, seed=17, files_per_table=2)
    return d


@pytest.fixture(scope="module")
def oracle_tables(tpcds_dir):
    from ballista_tpu_torch.testing.tpcds_reference import load_tables

    return load_tables(tpcds_dir)


@pytest.fixture(scope="module")
def jax_oracle_tables(tpcds_dir):
    from ballista_tpu.testing.tpcds_reference import load_tables

    return load_tables(tpcds_dir)


def tpcds_query(q: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpcds", "queries", f"q{q}.sql")) as f:
        return f.read()


def _port_ctx(tpcds_dir, **cfg):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpcdsgen import register_tpcds

    ctx = SessionContext(BallistaConfig({**TPU_CFG, **cfg}))
    register_tpcds(ctx, tpcds_dir)
    return ctx


@pytest.mark.parametrize("q", [q for q in range(1, 100) if q not in C13])
def test_tpcds_device_engine_matches_oracle(q, tpcds_dir, oracle_tables):
    from ballista_tpu_torch.testing.tpcds_reference import compare_results, run_reference

    out = _port_ctx(tpcds_dir).sql(tpcds_query(q)).collect()
    problems = compare_results(out, run_reference(q, oracle_tables), q)
    assert not problems, "\n".join(problems)


@pytest.mark.parametrize("q", C13)
def test_c13_same_schema_error_as_reference(q, tpcds_dir, oracle_tables):
    # both packages plan the query and raise the same error when the plan
    # executes; the CPU engine answers it
    from ballista_tpu.client.context import SessionContext as JaxSession
    from ballista_tpu.config import BallistaConfig as JaxConfig
    from ballista_tpu.errors import SchemaError as JaxSchemaError
    from ballista_tpu.testing.tpcdsgen import register_tpcds as jax_register
    from ballista_tpu_torch.errors import SchemaError
    from ballista_tpu_torch.testing.tpcds_reference import compare_results, run_reference

    with pytest.raises(SchemaError) as port_err:
        _port_ctx(tpcds_dir).sql(tpcds_query(q)).collect()
    jctx = JaxSession(JaxConfig(dict(TPU_CFG)))
    jax_register(jctx, tpcds_dir)
    with pytest.raises(JaxSchemaError) as jax_err:
        jctx.sql(tpcds_query(q)).collect()
    assert str(port_err.value) == str(jax_err.value)
    assert "no column t_s_firstyear.customer_id" in str(port_err.value)

    out = _port_ctx(tpcds_dir, **{"ballista.executor.engine": "cpu"}).sql(
        tpcds_query(q)).collect()
    problems = compare_results(out, run_reference(q, oracle_tables), q)
    assert not problems, "\n".join(problems)


def test_generator_writes_the_reference_bytes(tpcds_dir, tmp_path):
    from ballista_tpu.testing.tpcdsgen import TPCDS_TABLES as JAX_TABLES
    from ballista_tpu.testing.tpcdsgen import generate_tpcds as jax_generate
    from ballista_tpu_torch.testing.tpcdsgen import TPCDS_TABLES

    assert TPCDS_TABLES == JAX_TABLES
    ref_dir = str(tmp_path / "ref")
    jax_generate(ref_dir, scale=0.1, seed=17, files_per_table=2)
    for t in TPCDS_TABLES:
        names = sorted(os.listdir(os.path.join(tpcds_dir, t)))
        assert names == sorted(os.listdir(os.path.join(ref_dir, t))), t
        for n in names:
            with open(os.path.join(tpcds_dir, t, n), "rb") as a, \
                    open(os.path.join(ref_dir, t, n), "rb") as b:
                assert a.read() == b.read(), f"{t}/{n}"
    assert pq.read_table(os.path.join(tpcds_dir, "store_sales")).num_rows > 10_000


@pytest.mark.parametrize("q", [3, 36, 64, 67, 93, 98])
def test_oracle_answers_as_the_reference(q, oracle_tables, jax_oracle_tables):
    from ballista_tpu.testing.tpcds_reference import run_reference as jax_reference
    from ballista_tpu_torch.testing.tpcds_reference import run_reference

    got = run_reference(q, oracle_tables)
    want = jax_reference(q, jax_oracle_tables)
    assert list(got.columns) == list(want.columns)
    assert pa.Table.from_pandas(got).equals(pa.Table.from_pandas(want))
