"""The port's staged TPC-H plans against the JAX package's approved goldens.

All 22 distributed plans are planned over dataless tables that carry exact
SF100 statistics at target_partitions=16, under `cpu` and `tpu` planning,
and each must equal the golden the reference's own suite approves
(`tests/tpch_plan_stability/approved/{cpu,tpu}/q*.txt`). The goldens are
read in place, never copied: a change to a stage boundary, a join mode, a
broadcast promotion or a partition count in either package shows here.

The stats tables and `staged_plan_text` are the port's own copies of the
reference fixtures (`tests/tpch_plan_stability/fixtures.py`), built from the
port's provider, planner and plan checker.
"""

import os

import pyarrow as pa
import pytest

from ballista_tpu_torch.plan.provider import TableProvider, TableStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPROVED = os.path.join(ROOT, "tests", "tpch_plan_stability", "approved")

# exact TPC-H SF100 cardinalities
SF100_ROWS = {
    "lineitem": 600_037_902,
    "orders": 150_000_000,
    "partsupp": 80_000_000,
    "part": 20_000_000,
    "customer": 15_000_000,
    "supplier": 1_000_000,
    "nation": 25,
    "region": 5,
}

_D = pa.date32()
_S = pa.string()
_I = pa.int64()
_F = pa.float64()

SCHEMAS = {
    "lineitem": [("l_orderkey", _I), ("l_partkey", _I), ("l_suppkey", _I),
                 ("l_linenumber", _I), ("l_quantity", _F), ("l_extendedprice", _F),
                 ("l_discount", _F), ("l_tax", _F), ("l_returnflag", _S),
                 ("l_linestatus", _S), ("l_shipdate", _D), ("l_commitdate", _D),
                 ("l_receiptdate", _D), ("l_shipinstruct", _S), ("l_shipmode", _S),
                 ("l_comment", _S)],
    "orders": [("o_orderkey", _I), ("o_custkey", _I), ("o_orderstatus", _S),
               ("o_totalprice", _F), ("o_orderdate", _D), ("o_orderpriority", _S),
               ("o_clerk", _S), ("o_shippriority", _I), ("o_comment", _S)],
    "customer": [("c_custkey", _I), ("c_name", _S), ("c_address", _S),
                 ("c_nationkey", _I), ("c_phone", _S), ("c_acctbal", _F),
                 ("c_mktsegment", _S), ("c_comment", _S)],
    "part": [("p_partkey", _I), ("p_name", _S), ("p_mfgr", _S), ("p_brand", _S),
             ("p_type", _S), ("p_size", _I), ("p_container", _S),
             ("p_retailprice", _F), ("p_comment", _S)],
    "partsupp": [("ps_partkey", _I), ("ps_suppkey", _I), ("ps_availqty", _I),
                 ("ps_supplycost", _F), ("ps_comment", _S)],
    "supplier": [("s_suppkey", _I), ("s_name", _S), ("s_address", _S),
                 ("s_nationkey", _I), ("s_phone", _S), ("s_acctbal", _F),
                 ("s_comment", _S)],
    "nation": [("n_nationkey", _I), ("n_name", _S), ("n_regionkey", _I),
               ("n_comment", _S)],
    "region": [("r_regionkey", _I), ("r_name", _S), ("r_comment", _S)],
}


class TpchStatsTable(TableProvider):
    """Schema and injected stats, no data: planned, never executed."""

    def __init__(self, name: str):
        self.name = name
        self._schema = pa.schema(SCHEMAS[name])
        self._rows = SF100_ROWS[name]

    def arrow_schema(self) -> pa.Schema:
        return self._schema

    def statistics(self) -> TableStats:
        return TableStats(num_rows=self._rows, total_bytes=self._rows * 100)

    def scan_partitions(self, target_partitions: int) -> list[dict]:
        n = min(target_partitions, max(1, self._rows // 1_000_000)) or 1
        return [
            {"files": [{"file": f"tpch-sf100/{self.name}/part-{i:03d}.parquet"}]}
            for i in range(int(n))
        ]


def stats_context(engine: str):
    """The port's SessionContext over the dataless SF100 tables at
    target_partitions=16."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import EXECUTOR_ENGINE, TARGET_PARTITIONS, BallistaConfig

    ctx = SessionContext(BallistaConfig({TARGET_PARTITIONS: 16, EXECUTOR_ENGINE: engine}))
    for name in SF100_ROWS:
        ctx.register_table(name, TpchStatsTable(name))
    return ctx


def staged_plan_text(ctx, sql: str) -> str:
    """SQL → optimized logical → physical → distributed stages → the text
    the goldens hold; every plan must also pass the static stage checks."""
    from ballista_tpu_torch.analysis.plan_check import check_stages
    from ballista_tpu_torch.scheduler.planner import DistributedPlanner

    physical = ctx.create_physical_plan(ctx.sql(sql).plan)
    stages = DistributedPlanner("golden").plan_query_stages(physical)
    check_stages(stages)
    out = []
    for s in stages:
        flag = " [broadcast]" if s.broadcast else ""
        out.append(
            f"=== Stage {s.stage_id} partitions={s.partitions} -> "
            f"{s.output_partitions} inputs={s.input_stage_ids}{flag}\n"
            + s.plan.display(0)
        )
    return "\n".join(out).rstrip() + "\n"


@pytest.fixture(scope="module", params=["cpu", "tpu"])
def golden_ctx(request):
    return request.param, stats_context(request.param)


@pytest.mark.parametrize("q", range(1, 23))
def test_staged_plan_equals_reference_golden(golden_ctx, q):
    engine, ctx = golden_ctx
    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    got = staged_plan_text(ctx, sql)
    with open(os.path.join(APPROVED, engine, f"q{q}.txt")) as f:
        want = f.read()
    assert got == want, (f"the port's staged plan for q{q} ({engine} planning) differs "
                         f"from the reference's golden\n--- golden\n{want}\n--- port\n{got}")
