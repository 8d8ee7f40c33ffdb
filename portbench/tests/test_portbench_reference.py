"""The plain references against the port's CPU forms at SF0.01, and the
frozen generator against the port's own."""

import os
import subprocess
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest

from portbench.harness import check, qgen, spec
from portbench.harness.data import ensure
from portbench.reference.common import Db

QUERIES = ("q1", "q3", "q4", "q5", "q6", "q12")


@pytest.fixture(scope="module")
def tiny(bench_root):
    cell = spec.load_cell("tpch10_local_mix6", bench_root)
    data_dir, _ = ensure(cell.config, os.path.join(bench_root, "portbench"))
    cols = {}
    for q in QUERIES:
        for t, c in spec.reference_module(q, bench_root).COLUMNS.items():
            cols.setdefault(t, set()).update(c)
    return cell, data_dir, Db(data_dir, {t: sorted(c) for t, c in cols.items()})


@pytest.mark.parametrize("engine", ["tpu", "cpu"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11, 77])
def test_reference_matches_the_port(tiny, cpu_port, seed, engine):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.plan.provider import ParquetTable

    cell, data_dir, db = tiny
    ctx = SessionContext(BallistaConfig({"ballista.executor.engine": engine}))
    for t in cell.config["columns"]:
        ctx.register_table(t, ParquetTable(os.path.join(data_dir, t)))
    for stmts in qgen.streams(cell.queries, 3, seed, scale=0.01):
        for s in stmts:
            want = spec.reference_module(s["query"]).answer(db, s["params"])
            got = check.as_columns(ctx.sql(s["sql"]).collect())
            same, gap, why = check.compare(got, want)
            assert same, f"{s['key']} {s['params']}: {why}"
            assert gap < check.LIMITS["float_gap"], f"{s['key']}: {gap}"


def test_control_in_float32_differs_from_the_reference(tiny):
    cell, data_dir, db = tiny
    low = db.with_dtype(np.float32)
    p = {"SHIPDATE": "1998-09-02"}
    q1 = spec.reference_module("q1")
    same, gap, _ = check.compare(q1.answer(low, p), q1.answer(db, p))
    assert same and gap > 1e-8


def test_frozen_generator_writes_what_the_port_generator_writes(tmp_path):
    from ballista_tpu_torch.testing.tpchgen import generate_tpch as port_gen

    from portbench.datagen.tpchgen import TPCH_TABLES, generate_tpch

    cols = {"lineitem": ["l_orderkey", "l_shipmode", "l_comment", "l_shipdate"],
            "orders": ["o_clerk", "o_orderpriority", "o_comment"],
            "part": ["p_name", "p_brand", "p_container"],
            "customer": ["c_phone", "c_mktsegment"], "supplier": ["s_name", "s_comment"]}
    port_gen(str(tmp_path / "port"), 0.002, 5, 2)
    written = generate_tpch(str(tmp_path / "frozen"), 0.002, 5, 2, columns=cols)
    assert sorted(written) == sorted(cols)
    for t in TPCH_TABLES:
        if t not in cols:
            assert not os.path.exists(tmp_path / "frozen" / t)
            continue
        a = pq.read_table(tmp_path / "frozen" / t)
        b = pq.read_table(tmp_path / "port" / t, columns=cols[t])
        assert a.column_names == cols[t] and a.equals(b), t
    every = generate_tpch(str(tmp_path / "all"), 0.002, 5, 2)
    for t in every:
        assert pq.read_table(tmp_path / "all" / t).equals(pq.read_table(tmp_path / "port" / t))


def test_reference_imports_nothing_of_the_port_or_jax(tiny):
    _, data_dir, _ = tiny
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.harness import spec\n"
        "from portbench.reference.common import Db\n"
        "for q in %r:\n"
        "    m = spec.reference_module(q)\n"
        "    m.answer(Db(%r, m.COLUMNS), {'SHIPDATE': '1998-09-02', 'SEGMENT': 'BUILDING',"
        " 'DATE': '1995-03-15', 'DATE_END': '1996-01-01', 'REGION': 'ASIA',"
        " 'DISCOUNT_LO': '0.05', 'DISCOUNT_HI': '0.07', 'QUANTITY': '24',"
        " 'SHIPMODE1': 'MAIL', 'SHIPMODE2': 'SHIP'})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'ballista_tpu', 'ballista_tpu_torch', 'torch'))\n"
        "print(bad)\n"
    ) % (spec.ROOT, QUERIES, data_dir)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
