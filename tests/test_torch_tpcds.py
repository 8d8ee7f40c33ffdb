"""TPC-DS through the port on the CPU, against its own pandas oracle.

Data: the port's generator at SF0.1, seed 17, 2 files per sales table, as
tests/test_tpcds.py makes it for the JAX package. Every one of the 99
queries runs through `SessionContext` with engine=tpu (ballista.tpu.min.rows
0, so small final stages stay on the device engine too) after
runtime.use_cpu(), and is compared with `testing.tpcds_reference`. q4, q11
and q74 alias one CTE several times and join it to itself: the JAX package
raises a SchemaError there under engine=tpu (ROADMAP C13), the port
answers. The port's generator and oracle are copies of the JAX package's:
they must write and answer the same bytes.
"""

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.ops.cuda import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}


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


@pytest.mark.parametrize("q", range(1, 100))
def test_tpcds_device_engine_matches_oracle(q, tpcds_dir, oracle_tables):
    from ballista_tpu_torch.testing.tpcds_reference import compare_results, run_reference

    out = _port_ctx(tpcds_dir).sql(tpcds_query(q)).collect()
    problems = compare_results(out, run_reference(q, oracle_tables), q)
    assert not problems, "\n".join(problems)


def test_aliased_cte_self_join_matches_cpu_engine():
    # ROADMAP C13's shape at its smallest: one CTE over a UNION, aliased
    # twice, each alias filtered and the two joined. The device rewrite
    # rebuilds the filters over the aliased union; they must keep the alias
    # qualifier, or `a.k` no longer binds in the join above them.
    import numpy as np

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig

    rng = np.random.default_rng(5)
    n = 400
    t = pa.table({"k": rng.integers(0, 40, n), "yr": rng.integers(2000, 2002, n),
                  "v": rng.integers(1, 100, n)})
    sql = ("WITH tot AS (SELECT k, yr, sum(v) AS s FROM t WHERE v < 50 GROUP BY k, yr "
           "UNION ALL SELECT k, yr, sum(v) AS s FROM t WHERE v >= 50 GROUP BY k, yr) "
           "SELECT a.k, a.s AS s0, b.s AS s1 FROM tot a, tot b "
           "WHERE a.k = b.k AND a.yr = 2000 AND b.yr = 2001 AND a.s > 0 "
           "ORDER BY a.k, s0, s1")
    answers = []
    for engine in ("tpu", "cpu"):
        ctx = SessionContext(BallistaConfig({**TPU_CFG, "ballista.executor.engine": engine}))
        ctx.register_arrow_table("t", t, partitions=2)
        answers.append(ctx.sql(sql).collect())
    assert answers[0].num_rows > 0
    assert answers[0].equals(answers[1])


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
