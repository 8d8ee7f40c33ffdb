"""The port's out-of-core execution against the JAX package on the CPU.

Admission (`plan_stage`), the grace hash and its postconditions, the host
spill pool, device-table spill and re-upload, grace-split join stages, the
out-of-memory spill-and-retry rung of both stage kinds, the routed-stage
fallback layout and the AQE admission floor.

The port runs after runtime.use_cpu(); the JAX package with
JAX_PLATFORMS=cpu (tests/conftest.py). Where a test states no tolerance,
the comparison is exact (Arrow `equals`, numpy bit equality). A grace run
is held bit for bit against the reference's grace run, and against the
port's own whole run with integers, strings and dates exact and floats
within rtol 1e-9: the grace run feeds the final aggregate one partial row
per group and sub-bucket, so its float64 sums may associate differently
(TPC-H q5 at SF0.01 shows it in both packages).
"""

import dataclasses
import os
import re
import zlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.ops.tpu import hbm as jhbm
from ballista_tpu.ops.tpu.fusion import StageEstimate as JStageEstimate
from ballista_tpu_torch.ops.cuda import hbm, runtime
from ballista_tpu_torch.ops.cuda.fusion import StageEstimate

from .conftest import iter_plan, tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
BUDGET = "ballista.tpu.hbm.budget.bytes"
GRACE_DEPTH = "ballista.tpu.hbm.grace.max.depth"


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    # module scope: the module's shared fixtures run the port too
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    hbm.disarm_chaos()
    jhbm.disarm_chaos()


def _sc(pkg):
    return __import__(
        f"{pkg}.ops.{'cuda' if pkg.endswith('torch') else 'tpu'}.stage_compiler",
        fromlist=["RUN_STATS"])


def _ctx(pkg, engine="tpu", tables=None, tpch_dir=None, **extra):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(
        {**BASE_CFG, "ballista.executor.engine": engine, **extra}))
    for name, (tbl, parts) in (tables or {}).items():
        ctx.register_arrow_table(name, tbl, partitions=parts)
    if tpch_dir is not None:
        reg = __import__(f"{pkg}.testing.tpchgen", fromlist=["register_tpch"])
        reg.register_tpch(ctx, tpch_dir)
    return ctx


def _collect(pkg, sql, **kw):
    """Run `sql` from cold caches; return (answer, per-stage records)."""
    sc = _sc(pkg)
    sc.clear_device_caches()
    sc.RUN_STATS.clear()
    out = _ctx(pkg, **kw).sql(sql).collect()
    return out, sc.RUN_STATS.stages()


def _join_rec(stages: dict) -> dict:
    """The record of the admission-planned join stage with the largest
    working set (the final stage states its own reason)."""
    recs = [r for r in stages.values()
            if re.search(r"working set (\d+) B", r.get("hbm_plan_reason", ""))]
    assert recs, f"no admission-planned stage in {list(stages)}"
    return max(recs, key=_working_set)


def _working_set(rec: dict) -> int:
    return int(re.search(r"working set (\d+) B", rec["hbm_plan_reason"]).group(1))


def _split_bytes(rec: dict) -> int:
    return int(re.search(r"grace-splitting build \d+ \((\d+) B\)",
                         rec["hbm_plan_reason"]).group(1))


def _assert_close(got: pa.Table, want: pa.Table):
    """Exact on every column but floats, which agree within rtol 1e-9."""
    assert got.schema == want.schema and got.num_rows == want.num_rows
    for name, f in zip(got.column_names, got.schema):
        a, b = got.column(name).combine_chunks(), want.column(name).combine_chunks()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(a.to_numpy(zero_copy_only=False),
                                       b.to_numpy(zero_copy_only=False), rtol=1e-9, atol=0)
        else:
            assert a.equals(b), name


# -- admission ------------------------------------------------------------------


def _est(cls, table=1000, dicts=0, build=4000, jidx=0, has_mult=False):
    return cls(
        rows=100, partitions=2, group_domain=64, n_group_keys=1, lanes=1,
        has_mult=has_mult, n_filters=0, n_projections=0, n_joins=1,
        max_probe_table=0, table_bytes=table, dict_bytes=dicts,
        build_bytes=build, max_build_bytes=build, max_build_jidx=jidx)


# every case of tests/test_out_of_core.py::TestAdmission: (estimate, budget,
# plan_stage keywords)
ADMISSION = {
    "exact_fit_runs_whole": ({}, 5000, {}),
    "one_byte_over_grace_splits": ({}, 4999, {}),
    "unbudgeted_runs_whole": ({}, 0, {}),
    "cold_residents_force_spill": ({}, 6000, {"resident_other": 2000}),
    "cold_residents_both_fit": ({}, 8000, {"resident_other": 2000}),
    "depth_escalation": ({}, 1500, {}),
    "depth_cap_demotes_to_cpu": ({}, 1010, {}),
    "fixed_bytes_over_budget_demote": ({}, 900, {}),
    "ineligible_join_demotes": ({}, 4999, {"grace_eligible": False}),
    "no_build_demotes": ({"build": 0, "jidx": -1}, 999, {}),
    "grace_disabled_demotes": ({}, 4999, {"grace_max_depth": 0}),
    "post_oom_hint_prefers_grace": ({}, 10_000, {"force_grace": True}),
    "post_oom_hint_without_build_reruns_whole": (
        {"build": 0, "jidx": -1}, 10_000, {"force_grace": True}),
    "post_oom_hint_grace_disabled_reruns_whole": (
        {}, 10_000, {"force_grace": True, "grace_max_depth": 0}),
    "observed_bytes_floor_the_estimate": ({"build": 10}, 2000, {"observed_bytes": 5000}),
}


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_plan_stage_matches_reference(case):
    est_kw, budget, kw = ADMISSION[case]
    kw = {"grace_eligible": True, "grace_fanout": 4, "grace_max_depth": 2, **kw}
    got = hbm.plan_stage(_est(StageEstimate, **est_kw), budget, **kw)
    want = jhbm.plan_stage(_est(JStageEstimate, **est_kw), budget, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_stage_reaches_every_decision():
    decisions = set()
    for est_kw, budget, kw in ADMISSION.values():
        kw = {"grace_eligible": True, "grace_fanout": 4, "grace_max_depth": 2, **kw}
        decisions.add(hbm.plan_stage(_est(StageEstimate, **est_kw), budget, **kw).decision)
    assert decisions == {hbm.RUN_WHOLE, hbm.SPILL_COLDS, hbm.GRACE_SPLIT, hbm.CPU_DEMOTE}


def test_hbm_carries_every_public_name_of_the_reference():
    import inspect

    names = {n for n, v in vars(jhbm).items()
             if not n.startswith("_") and not inspect.ismodule(v)
             and getattr(v, "__module__", jhbm.__name__) == jhbm.__name__}
    assert names - set(vars(hbm)) == set()
    for n in ("GRACE_SALT", "RUN_WHOLE", "SPILL_COLDS", "GRACE_SPLIT", "CPU_DEMOTE"):
        assert getattr(hbm, n) == getattr(jhbm, n)
    assert [f.name for f in dataclasses.fields(hbm.HbmPlan)] == \
        [f.name for f in dataclasses.fields(jhbm.HbmPlan)]


def test_session_quota_clamps_the_budget():
    from ballista_tpu_torch.config import BallistaConfig

    cfg = BallistaConfig({BUDGET: 10_000})
    assert hbm.resolve_hbm_budget(cfg) == 10_000
    with hbm.session_quota(4096):
        assert hbm.active_session_quota() == 4096
        assert hbm.resolve_hbm_budget(cfg) == 4096
        hbm.arm_chaos(1 << 20)
        assert hbm.resolve_hbm_budget(cfg) == 4096  # chaos cannot dodge a quota
        hbm.disarm_chaos()
    assert hbm.active_session_quota() == 0


def test_oom_hints_drain_once():
    before = hbm.oom_retry_count()
    hbm.note_oom("stage-x")
    assert hbm.oom_retry_count() == before + 1
    assert hbm.consume_oom_hint("stage-x") is True
    assert hbm.consume_oom_hint("stage-x") is False


def test_is_resource_exhausted_classifies_only_out_of_memory():
    from ballista_tpu_torch.ops.cuda import cuda_kernels

    assert hbm.is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert hbm.is_resource_exhausted(hbm.InjectedResourceExhausted("RESOURCE_EXHAUSTED: x"))
    assert hbm.is_resource_exhausted(RuntimeError("XlaRuntimeError: RESOURCE_EXHAUSTED"))
    alloc = cuda_kernels._launch_error("hash_probe", hbm.CUDA_ERROR_MEMORY_ALLOCATION)
    assert isinstance(alloc, hbm.DeviceAllocationError) and hbm.is_resource_exhausted(alloc)
    assert not hbm.is_resource_exhausted(cuda_kernels._launch_error("hash_probe", 700))
    assert not hbm.is_resource_exhausted(RuntimeError("out of memory somewhere else"))
    assert not hbm.is_resource_exhausted(MemoryError())


# -- the grace hash and its postconditions -----------------------------------------


@pytest.mark.parametrize("n_buckets", [2, 4, 16])
def test_grace_bucket_of_bits_equal_reference(n_buckets):
    rng = np.random.default_rng(n_buckets)
    extremes = np.array([0, 1, -1, 2**63 - 1, -(2**63), 2**62, -(2**62), 7, 7],
                        dtype=np.int64)
    keys = np.concatenate([extremes, rng.integers(-(2**63), 2**63 - 1, 100_000 - 9,
                                                  dtype=np.int64, endpoint=True)])
    got = hbm.grace_bucket_of(keys, n_buckets)
    np.testing.assert_array_equal(got, jhbm.grace_bucket_of(keys, n_buckets))
    assert got.dtype == np.int64 and got.min() == 0 and got.max() == n_buckets - 1


# every case of tests/test_out_of_core.py::TestGracePostconditions
GRACE_REPORTS = {
    "good": ({}, set()),
    "missing_bucket": ({"buckets_run": [0, 1], "buckets_empty": [2]}, {"grace-cover"}),
    "overlap": ({"buckets_run": [0, 1, 2, 3], "buckets_empty": [2]}, {"grace-cover"}),
    "non_producer_order": ({"merge": "bucket-major-shuffled"}, {"grace-order"}),
    "depth_over_cap": ({"depth": 3, "max_depth": 2, "n_buckets": 64,
                        "buckets_run": list(range(64)), "buckets_empty": []},
                       {"grace-depth"}),
    "fanout_mismatch": ({"n_buckets": 5, "buckets_run": [0, 1, 2, 3, 4],
                         "buckets_empty": []}, {"grace-depth"}),
}


@pytest.mark.parametrize("case", sorted(GRACE_REPORTS))
def test_check_grace_matches_reference(case):
    from ballista_tpu.analysis.plan_check import check_grace as jcheck
    from ballista_tpu_torch.analysis.plan_check import check_grace

    over, codes = GRACE_REPORTS[case]
    kw = dict(stage_tag="s", n_buckets=4, fanout=4, depth=1, max_depth=2,
              buckets_run=[0, 1, 3], buckets_empty=[2])
    kw.update(over)
    got = check_grace(hbm.GraceReport(**kw))
    want = jcheck(jhbm.GraceReport(**kw))
    assert {v.code for v in got} == codes
    assert [(v.code, v.stage_id, v.message) for v in got] == \
        [(v.code, v.stage_id, v.message.replace(
            "producer-order reunification is byte-identical",
            "producer-order reunification keeps the partials' order")) for v in want]


# -- the host spill pool -----------------------------------------------------------


def test_host_tier_roundtrip_preserves_none_slots():
    pool = hbm.HostSpillPool(max_host_bytes=1 << 20)
    arrays = [np.arange(10, dtype=np.int64), None, np.ones((3, 3), dtype=bool)]
    nb = sum(a.nbytes for a in arrays if a is not None)
    pool.put(("k",), ("meta", 1), arrays, nb)
    st = pool.stats()
    assert st["spill_events"] == 1 and st["spill_bytes"] == nb
    assert st["host_bytes"] == nb
    meta, back = pool.pop(("k",))
    assert meta == ("meta", 1)
    assert back[1] is None
    assert np.array_equal(back[0], arrays[0])
    assert np.array_equal(back[2], arrays[2])
    assert pool.stats()["reupload_events"] == 1
    assert pool.pop(("k",)) is None


def test_disk_tier_tmp_rename_discipline(tmp_path):
    pool = hbm.HostSpillPool(max_host_bytes=0, spill_dir=str(tmp_path))
    arrays = [np.arange(100, dtype=np.float64), None]
    pool.put(("d",), "m", arrays, arrays[0].nbytes)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".npz")
    assert not any(f.endswith(".tmp") for f in files)
    meta, back = pool.pop(("d",))
    assert meta == "m"
    assert back[1] is None
    assert np.array_equal(back[0], arrays[0])
    assert os.listdir(tmp_path) == []  # consumed


def test_host_overflow_demotes_coldest_to_disk(tmp_path):
    pool = hbm.HostSpillPool(max_host_bytes=100, spill_dir=str(tmp_path))
    a1 = [np.zeros(10, dtype=np.int64)]  # 80 B
    a2 = [np.ones(10, dtype=np.int64)]
    pool.put(("one",), "m1", a1, 80)
    pool.put(("two",), "m2", a2, 80)
    assert len(pool) == 2
    assert pool.stats()["host_bytes"] <= 100
    assert len(os.listdir(tmp_path)) == 1  # the cold entry hit disk
    _, b1 = pool.pop(("one",))
    _, b2 = pool.pop(("two",))
    assert np.array_equal(b1[0], a1[0]) and np.array_equal(b2[0], a2[0])


def test_clear_removes_disk_files(tmp_path):
    pool = hbm.HostSpillPool(max_host_bytes=0, spill_dir=str(tmp_path))
    pool.put(("x",), "m", [np.arange(5)], 40)
    assert os.listdir(tmp_path)
    pool.clear()
    assert os.listdir(tmp_path) == []
    assert len(pool) == 0


def test_disk_tier_full_disk_raises_typed_and_leaves_no_tmp(tmp_path, monkeypatch):
    import errno

    from ballista_tpu_torch.errors import DiskExhausted

    def full(*_a, **_k):
        raise OSError(errno.ENOSPC, "No space left on device")

    pool = hbm.HostSpillPool(max_host_bytes=0, spill_dir=str(tmp_path))
    monkeypatch.setattr(np, "savez", full)
    with pytest.raises(DiskExhausted):
        pool.put(("x",), "m", [np.arange(5)], 40)
    assert os.listdir(tmp_path) == []


# -- device-table spill and re-upload ------------------------------------------------


def _mixed_table(n: int = 5_000) -> pa.Table:
    rng = np.random.default_rng(11)
    qty = rng.integers(1, 50, n).astype(np.int64)
    return pa.table({
        "qty": qty,
        "price": np.round(rng.uniform(1, 1000, n), 2),  # money lane
        "flag": rng.choice(["A", "N", "R"], n),  # dictionary codes
        "day": pa.array(rng.integers(8000, 11000, n).astype(np.int32), pa.date32()),
        "weight": rng.uniform(0.0, 1.0, n),  # true f64
        "ok": rng.random(n) > 0.5,
        "maybe": pa.array([None if i % 7 == 0 else int(v) for i, v in enumerate(qty)],
                          pa.int64()),  # validity plane
    })


def _port_scan(tbl: pa.Table, partitions: int = 3):
    from ballista_tpu_torch.plan.physical import MemoryScanExec
    from ballista_tpu_torch.plan.schema import DFSchema

    batches = tbl.to_batches(max_chunksize=max(1, tbl.num_rows // (partitions * 2)))
    return MemoryScanExec(DFSchema.from_arrow(tbl.schema), batches, partitions)


def _planes(dt):
    """Every plane of a DeviceTable as numpy, None validity slots kept."""
    return ([c.numpy() for c in dt.cols] + [dt.mask.numpy()]
            + [None if v is None else v.numpy() for v in dt.valids])


def _assert_tables_bitwise(a, b):
    assert (a.kinds, a.scales, a.dicts, a.part_rows, a.nbytes) == \
        (b.kinds, b.scales, b.dicts, b.part_rows, b.nbytes)
    pa_, pb = _planes(a), _planes(b)
    assert [x is None for x in pa_] == [x is None for x in pb]
    for x, y in zip(pa_, pb):
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_device_table_spill_touch_reupload_bitwise(tier, tmp_path):
    # a table demoted to the pool and re-fetched on its next touch is
    # bitwise the table that was spilled, through either tier; eviction by
    # a second table's fill spills too
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.plan.physical import TaskContext

    sc.clear_device_caches()
    pool = hbm.HostSpillPool(max_host_bytes=(1 << 30) if tier == "host" else 0,
                             spill_dir=str(tmp_path))
    ctx = TaskContext(BallistaConfig({}))
    dev = torch.device("cpu")
    buckets = [1 << 12, 1 << 14, 1 << 16]
    scan = _port_scan(_mixed_table())
    dt = sc.DEVICE_CACHE.get(scan, buckets, ctx, 1 << 30, dev, spill_pool=pool)
    before = [None if x is None else x.copy() for x in _planes(dt)]
    assert any(v is None for v in dt.valids) and any(v is not None for v in dt.valids)
    freed = sc.DEVICE_CACHE.ensure_headroom(0, None, pool)
    assert freed == dt.nbytes
    assert pool.stats()["spill_events"] == 1 and pool.stats()["spill_bytes"] == dt.nbytes
    assert sc.DEVICE_CACHE.resident_bytes() == 0
    assert len(os.listdir(tmp_path)) == (1 if tier == "disk" else 0)
    rec: dict = {}
    dt2 = sc.DEVICE_CACHE.get(scan, buckets, ctx, 1 << 30, dev, spill_pool=pool, stats=rec)
    assert pool.stats()["reupload_events"] == 1 and len(pool) == 0
    assert "encode_s" not in rec  # restored, not re-encoded
    _assert_tables_bitwise(dt, dt2)
    for x, y in zip(before, _planes(dt2)):
        assert (x is None and y is None) or x.tobytes() == y.tobytes()
    assert os.listdir(tmp_path) == []

    # eviction: a second table whose fill does not fit beside the first
    # spills the first; touching the first restores it and spills the second
    other = _port_scan(_mixed_table(3_000))
    sc.DEVICE_CACHE.get(other, buckets, ctx, dt.nbytes + 1, dev, spill_pool=pool)
    assert pool.stats()["spill_events"] == 2 and len(pool) == 1
    dt3 = sc.DEVICE_CACHE.get(scan, buckets, ctx, dt.nbytes + 1, dev, spill_pool=pool)
    assert pool.stats()["reupload_events"] == 2
    _assert_tables_bitwise(dt, dt3)
    sc.clear_device_caches()


def test_spill_all_then_clear_device_caches_empties_the_pool():
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.plan.physical import TaskContext

    sc.clear_device_caches()
    ctx = TaskContext(BallistaConfig({}))
    for n in (1000, 2000):
        sc.DEVICE_CACHE.get(_port_scan(_mixed_table(n)), [1 << 12], ctx, 1 << 30,
                            torch.device("cpu"))
    sc.DEVICE_CACHE.spill_all(hbm.SPILL_POOL)
    assert sc.DEVICE_CACHE.resident_bytes() == 0 and len(hbm.SPILL_POOL) == 2
    sc.clear_device_caches()
    assert len(hbm.SPILL_POOL) == 0


# -- grace-split join stages ---------------------------------------------------------


def _skewed_tables():
    """tests/test_out_of_core.py's skewed join: 70% of keys in 10 hot keys,
    NULL probe keys, dictionary strings on both sides, money amounts, and
    probe keys with no dim match."""
    rng = np.random.default_rng(7)
    n = 30_000
    keys = np.where(rng.random(n) < 0.7, rng.integers(0, 10, n),
                    rng.integers(0, 1200, n)).astype(np.int64)
    fact = pa.table({
        "k": pa.array([None if i % 23 == 0 else int(k) for i, k in enumerate(keys)],
                      pa.int64()),
        "flag": pa.array(rng.choice(["x", "y", "z", "w"], n)),
        "amount": np.round(rng.uniform(0, 100, n), 2),
    })
    dk = np.arange(1000, dtype=np.int64)  # keys 1000..1199 unmatched
    dim = pa.table({"dk": dk, "name": pa.array([f"seg{int(v) % 5}" for v in dk])})
    return {"fact": (fact, 3), "dim": (dim, 2)}


ORACLE_SQL = (
    "select f.flag, d.name, count(*) c, sum(f.amount) s "
    "from fact f join dim d on f.k = d.dk "
    "group by f.flag, d.name order by f.flag, d.name")


@pytest.fixture(scope="module")
def skewed():
    """The skewed join's answers: the CPU engine's, the port's whole device
    run and its working set and split bytes."""
    tables = _skewed_tables()
    cpu, _ = _collect("ballista_tpu_torch", ORACLE_SQL, engine="cpu", tables=tables)
    whole, stages = _collect("ballista_tpu_torch", ORACLE_SQL, tables=tables)
    rec = _join_rec(stages)
    assert rec["hbm_plan"] == hbm.RUN_WHOLE
    ws = _working_set(rec)
    _, stages = _collect("ballista_tpu_torch", ORACLE_SQL, tables=tables, **{BUDGET: ws - 1})
    return tables, cpu, whole, ws, _split_bytes(_join_rec(stages))


@pytest.mark.parametrize("depth", [1, 2])
def test_grace_skewed_join_matches_reference(depth, skewed):
    tables, cpu, whole, ws, split = skewed
    fixed = ws - split
    # depth 1: one byte over; depth 2: 4 sub-buckets still over, 16 fit
    budget = ws - 1 if depth == 1 else fixed + (split // 16 + split // 4) // 2
    runs = {pkg: _collect(pkg, ORACLE_SQL, tables=tables, **{BUDGET: budget})
            for pkg in ("ballista_tpu_torch", "ballista_tpu")}
    (got, gst), (want, wst) = runs["ballista_tpu_torch"], runs["ballista_tpu"]
    g, w = _join_rec(gst), _join_rec(wst)
    assert g["hbm_plan"] == w["hbm_plan"] == hbm.GRACE_SPLIT, g["hbm_plan_reason"]
    assert g["hbm_plan_reason"] == w["hbm_plan_reason"]
    assert f"into {4 ** depth} sub-buckets (depth {depth})" in g["hbm_plan_reason"]
    assert g["grace_splits"] == w["grace_splits"] >= 2
    assert got.equals(want)
    assert got.equals(whole)  # this join's float sums associate alike
    _assert_close(got, cpu)


def test_spill_colds_demotes_a_cold_resident_like_the_reference(skewed):
    # a cold resident table that fits beside the stage's table but not
    # beside its whole working set (tables + LUTs + builds): the fill keeps
    # it, admission plans spill_colds and demotes it before the pass
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu.plan.physical import TaskContext as JTaskContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.plan.physical import TaskContext

    from .test_tpu_fill import _mixed_table as j_mixed_table
    from .test_tpu_fill import _scan as j_scan

    tables, cpu, whole, ws, _split = skewed
    _, stages = _collect("ballista_tpu_torch", ORACLE_SQL, tables=tables)
    table_bytes = _join_rec(stages)["device_bytes"]
    runs = {}
    for pkg in ("ballista_tpu_torch", "ballista_tpu"):
        sc = _sc(pkg)
        sc.clear_device_caches()
        sc.RUN_STATS.clear()
        if pkg == "ballista_tpu_torch":
            cold = sc.DEVICE_CACHE.get(_port_scan(_mixed_table()), [1 << 12], TaskContext(
                BallistaConfig({})), 1 << 30, torch.device("cpu"))
            pool = hbm.SPILL_POOL
        else:
            cold = sc.DEVICE_CACHE.get(j_scan(j_mixed_table()), [1 << 12], JTaskContext(
                JConfig({})), 1 << 30, None)
            pool = jhbm.SPILL_POOL
        assert cold.nbytes > ws - table_bytes
        events = pool.stats()["spill_events"]
        out = _ctx(pkg, tables=tables, **{BUDGET: cold.nbytes + table_bytes}).sql(
            ORACLE_SQL).collect()
        (rec,) = [r for r in sc.RUN_STATS.stages().values() if "device_bytes" in r]
        runs[pkg] = (out, rec, pool.stats()["spill_events"] - events)
        assert sc.DEVICE_CACHE.resident_bytes() == table_bytes  # the cold table left
        sc.clear_device_caches()
    (got, g, g_spills), (want, w, w_spills) = runs["ballista_tpu_torch"], runs["ballista_tpu"]
    assert g["hbm_plan"] == w["hbm_plan"] == hbm.SPILL_COLDS
    assert g["hbm_plan_reason"] == w["hbm_plan_reason"]
    assert g_spills == w_spills == 1
    assert g["hbm_spill_events"] >= 1
    assert got.equals(want) and got.equals(whole)


def _layout_tables(layout):
    """A join whose build takes the expansion layout (repeated keys under
    the direct table) or the sorted layout (combined keys past 2^27, each
    repeated twice); integer aggregates, so every answer is exact."""
    rng = np.random.default_rng(21)
    n = 20_000
    if layout == "expansion":
        build = pa.table({"ba": rng.integers(0, 500, 2_000), "bb": np.zeros(2_000, np.int64),
                          "w": rng.integers(1, 10, 2_000)})
        pa_, pb = rng.integers(0, 600, n), np.zeros(n, np.int64)
    else:
        nb = 300
        a = rng.choice(1 << 20, nb, replace=False).astype(np.int64)
        b = rng.integers(0, 1 << 12, nb).astype(np.int64)
        build = pa.table({"ba": np.repeat(a, 2), "bb": np.repeat(b, 2),
                          "w": rng.integers(1, 50, 2 * nb)})
        pick = rng.integers(0, nb, n)
        hit = rng.random(n) < 0.7
        pa_ = np.where(hit, a[pick], rng.integers(0, 1 << 20, n))
        pb = np.where(hit, b[pick], rng.integers(0, 1 << 12, n))
    probe = pa.table({"pa": pa.array(pa_, mask=rng.random(n) < 0.05), "pb": pb,
                      "g": rng.integers(0, 3000, n), "v": rng.integers(1, 100, n)})
    return {"probe": (probe, 4), "build": (build, 1)}


@pytest.mark.parametrize("layout", ["expansion", "sorted"])
def test_grace_split_of_each_build_layout(layout):
    # the grace filter runs on the combined key before np.unique, so the
    # expansion layout's lo/cnt tables and the sorted layout's searched keys
    # are built per sub-bucket; the answers equal the reference's grace
    # run, the whole run and the CPU engine's
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    tables = _layout_tables(layout)
    sql = ("SELECT g, count(*) c, sum(v * w) s, max(w) mw FROM probe "
           "JOIN build ON pa = ba AND pb = bb GROUP BY g ORDER BY g")
    cpu, _ = _collect("ballista_tpu_torch", sql, engine="cpu", tables=tables)
    whole, stages = _collect("ballista_tpu_torch", sql, tables=tables)
    ws = _working_set(_join_rec(stages))
    runs = {pkg: _collect(pkg, sql, tables=tables, **{BUDGET: ws - 1})
            for pkg in ("ballista_tpu", "ballista_tpu_torch")}
    subs = [bt for k, (bt, _size) in sc._BUILD_CACHE._od.items() if k[-1] is not None]
    assert len(subs) == 4
    if layout == "expansion":
        assert all(bt.mode == "direct" and bt.dup > 1 for bt in subs)
    else:
        assert all(bt.mode == "sorted" for bt in subs)
    (got, gst), (want, wst) = runs["ballista_tpu_torch"], runs["ballista_tpu"]
    g, w = _join_rec(gst), _join_rec(wst)
    assert g["hbm_plan"] == w["hbm_plan"] == hbm.GRACE_SPLIT
    assert g["grace_splits"] == w["grace_splits"] == 4
    assert got.equals(want) and got.equals(whole) and got.equals(cpu)
    assert got.num_rows > 100


def test_grace_depth_zero_demotes_both_packages_to_cpu(skewed):
    tables, cpu, _whole, ws, _split = skewed
    runs = {pkg: _collect(pkg, ORACLE_SQL, tables=tables, **{BUDGET: ws - 1, GRACE_DEPTH: 0})
            for pkg in ("ballista_tpu_torch", "ballista_tpu")}
    for pkg, (out, stages) in runs.items():
        rec = _join_rec(stages)
        assert rec["hbm_plan"] == hbm.CPU_DEMOTE, pkg
        assert "grace disabled" in rec["hbm_plan_reason"]
        _assert_close(out, cpu)


def test_grace_sub_builds_never_alias_the_whole_build(skewed):
    # the grace tuple is part of the build cache key: a grace run followed
    # by a whole run (caches kept) serves the whole run from whole builds
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    tables, _cpu, whole, ws, _split = skewed
    sc.clear_device_caches()
    _ctx("ballista_tpu_torch", tables=tables, **{BUDGET: ws - 1}).sql(ORACLE_SQL).collect()
    graces = {k[-1] for k in sc._BUILD_CACHE._od}
    assert None in graces and {(b, 4) for b in range(4)} & graces
    again = _ctx("ballista_tpu_torch", tables=tables).sql(ORACLE_SQL).collect()
    assert again.equals(whole)
    sc.clear_device_caches()


def test_observed_bytes_reach_every_stage_and_move_admission(skewed):
    # the AQE floor: a plan stamped with hbm_observed_input_bytes hands it to
    # every TpuStageExec, where it raises the working set past the budget
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    tables, cpu, _whole, ws, split = skewed
    ctx = _ctx("ballista_tpu_torch", tables=tables, **{BUDGET: ws})
    runs = {}
    for observed in (0, split + 4096):
        sc.clear_device_caches()
        sc.RUN_STATS.clear()
        physical = ctx.create_physical_plan(ctx.sql(ORACLE_SQL).plan)
        physical.hbm_observed_input_bytes = observed
        compiled = maybe_compile_tpu(physical, ctx.config)
        stages = [n for n in iter_plan(compiled) if isinstance(n, sc.TpuStageExec)]
        assert stages
        assert all(getattr(s, "hbm_observed_input_bytes", 0) == observed for s in stages)
        out = ctx.execute_collect(compiled)
        runs[observed] = (_join_rec(sc.RUN_STATS.stages()), out)
    (plain, plain_out), (floored, floored_out) = runs[0], runs[split + 4096]
    assert plain["hbm_plan"] == hbm.RUN_WHOLE and _working_set(plain) == ws
    assert floored["hbm_plan"] == hbm.GRACE_SPLIT
    assert _working_set(floored) == ws + 4096
    _assert_close(plain_out, cpu)
    _assert_close(floored_out, cpu)


@pytest.mark.parametrize("q", [3, 5])
def test_tpch_grace_matches_reference_grace(q, tpch_dir):
    sql = tpch_query(q)
    whole, stages = _collect("ballista_tpu_torch", sql, tpch_dir=tpch_dir)
    ws = _working_set(_join_rec(stages))
    ref_whole, _ = _collect("ballista_tpu", sql, tpch_dir=tpch_dir)
    assert whole.equals(ref_whole)
    runs = {pkg: _collect(pkg, sql, tpch_dir=tpch_dir, **{BUDGET: ws - 1})
            for pkg in ("ballista_tpu_torch", "ballista_tpu")}
    (got, gst), (want, wst) = runs["ballista_tpu_torch"], runs["ballista_tpu"]
    g, w = _join_rec(gst), _join_rec(wst)
    assert g["hbm_plan"] == w["hbm_plan"] == hbm.GRACE_SPLIT
    assert g["grace_splits"] == w["grace_splits"] == 4
    assert got.equals(want)  # bit for bit against the reference's grace run
    _assert_close(got, whole)
    if q == 5:
        # C8: the reference's grace q5 is not its whole run bit for bit (a
        # revenue sum associates per sub-bucket partial); the port
        # reproduces the reference's grace bits, not its whole run's
        assert not want.equals(ref_whole)
        assert not got.equals(whole)


def test_grace_sorted_stage_with_emit_pid_matches_reference(tmp_path):
    # a sorted-aggregation join stage under a hash shuffle writer emits
    # __pid in every grace sub-run; its written buckets equal the
    # reference's, every row routes on the host to its own bucket, and the
    # rows merge to the engine=cpu answer
    import glob

    import pyarrow.ipc as ipc

    from ballista_tpu_torch.ops.hashing import partition_indices

    tables = _skewed_tables()
    sql = ("select f.k, d.name, sum(f.amount) s, count(*) c "
           "from fact f join dim d on f.k = d.dk group by f.k, d.name")
    k = 8

    def routed(pkg, work, **extra):
        eng = __import__(f"{pkg}.engine.{'cuda' if pkg.endswith('torch') else 'tpu'}_engine",
                         fromlist=["maybe_compile_tpu"])
        phys_mod = __import__(f"{pkg}.plan.physical", fromlist=["RepartitionExec"])
        writer_mod = __import__(f"{pkg}.shuffle.writer", fromlist=["ShuffleWriterExec"])
        sc = _sc(pkg)
        sc.clear_device_caches()
        sc.RUN_STATS.clear()
        ctx = _ctx(pkg, tables=tables, **extra)
        phys = ctx.create_physical_plan(ctx.sql(sql).plan)
        rep = [n for n in iter_plan(phys) if isinstance(n, phys_mod.RepartitionExec)
               and n.scheme == "hash"][0]
        writer = writer_mod.ShuffleWriterExec(rep.input, "gpid", 1, k, rep.keys,
                                              sort_shuffle=False)
        compiled = eng.maybe_compile_tpu(writer, ctx.config)
        stage = [n for n in iter_plan(compiled) if isinstance(n, sc.TpuStageExec)][0]
        task = phys_mod.TaskContext(ctx.config, task_id="t0", work_dir=work)
        for p in range(compiled.output_partition_count()):
            list(compiled.execute(p, task))
        out = {}
        for f in glob.glob(os.path.join(work, "gpid", "1", "*", "*.arrow")):
            with open(f, "rb") as fh:
                out[int(os.path.basename(os.path.dirname(f)))] = ipc.open_stream(fh).read_all()
        tag = f"stage_{zlib.crc32(stage.fingerprint.encode()):08x}"
        return stage, out, sc.RUN_STATS.stages()[tag]

    _, whole, rec = routed("ballista_tpu_torch", str(tmp_path / "whole"))
    assert rec["hbm_plan"] == hbm.RUN_WHOLE and rec.get("n_seg")
    budget = _working_set(rec) - 1
    runs = {pkg: routed(pkg, str(tmp_path / pkg), **{BUDGET: budget})
            for pkg in ("ballista_tpu_torch", "ballista_tpu")}
    stage, got, grec = runs["ballista_tpu_torch"]
    _, want, wrec = runs["ballista_tpu"]
    assert grec["hbm_plan"] == wrec["hbm_plan"] == hbm.GRACE_SPLIT
    assert grec["grace_splits"] == wrec["grace_splits"] >= 2
    assert stage.emit_pid is not None and stage.pid_emitted == grec["grace_splits"]
    assert stage.fallback_count == 0
    assert sorted(got) == sorted(want) and len(got) > 1
    for pid, t in got.items():
        assert "__pid" not in t.column_names
        host = partition_indices([t.column("k").combine_chunks(),
                                  t.column("name").combine_chunks()], k)
        assert (host == pid).all()
        assert t.equals(want[pid])
    # the partial rows (k, name, sum and count accumulators) of all buckets
    # merge to the CPU engine's groups
    rows = pa.concat_tables(got.values())
    acc_s, acc_c = rows.column_names[2:4]
    merged = (rows.group_by(["k", "name"]).aggregate([(acc_s, "sum"), (acc_c, "sum")])
              .sort_by([("k", "ascending")]))
    cpu = _ctx("ballista_tpu_torch", "cpu", tables=tables).sql(
        sql + " order by f.k").collect()
    assert merged.column("k").to_pylist() == cpu.column("k").to_pylist()
    assert merged.column(f"{acc_c}_sum").to_pylist() == cpu.column("c").to_pylist()
    np.testing.assert_allclose(merged.column(f"{acc_s}_sum").to_numpy(),
                               cpu.column("s").to_numpy(), rtol=1e-9, atol=0)
    # the group key holds the join key, so each group lives in one
    # sub-bucket: the buckets hold the whole run's rows, in another order
    assert sorted(whole) == sorted(got)
    order = [("k", "ascending"), ("name", "ascending")]
    for pid, t in got.items():
        assert t.sort_by(order).equals(whole[pid].sort_by(order))


# -- the out-of-memory rung (C7) ------------------------------------------------------


def _device_stages(ctx, sql):
    """Compile `sql` for the port's device engine and run it; return the
    answer with its TpuStageExecs and TpuFinalStageExecs."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    compiled = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    out = ctx.execute_collect(compiled)
    stages = [n for n in iter_plan(compiled) if isinstance(n, TpuStageExec)]
    finals = [n for n in iter_plan(compiled) if isinstance(n, TpuFinalStageExec)]
    return out, stages, finals


@pytest.fixture(scope="module")
def q3_ref(tpch_dir):
    """TPC-H q3 at SF0.01: the reference's device answer and the port's CPU
    engine answer."""
    ref, _ = _collect("ballista_tpu", tpch_query(3), tpch_dir=tpch_dir)
    cpu, _ = _collect("ballista_tpu_torch", tpch_query(3), engine="cpu", tpch_dir=tpch_dir)
    return ref, cpu


def test_injected_oom_spill_retry_converges_like_the_reference(tpch_dir, q3_ref):
    # C7: an injected device OOM on the first upload spills every resident
    # table and retries once (pre-planned as a grace split); the answer is
    # the reference's under the same chaos, bit for bit
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    ref, _cpu = q3_ref
    runs = {}
    for pkg, mod in (("ballista_tpu_torch", hbm), ("ballista_tpu", jhbm)):
        _sc(pkg).clear_device_caches()
        _sc(pkg).RUN_STATS.clear()
        mod.arm_chaos(1 << 30, oom_n=1)
        try:
            ctx = _ctx(pkg, tpch_dir=tpch_dir)
            if pkg == "ballista_tpu_torch":
                before = hbm.oom_retry_count()
                out, stages, _finals = _device_stages(ctx, tpch_query(3))
            else:
                out = ctx.sql(tpch_query(3)).collect()
        finally:
            mod.disarm_chaos()
        runs[pkg] = (out, _sc(pkg).RUN_STATS.stages())
    got, gst = runs["ballista_tpu_torch"]
    want, wst = runs["ballista_tpu"]
    assert hbm.oom_retry_count() == before + 1
    (g,), (w,) = ([r for r in st.values() if "hbm_oom_retries" in r] for st in (gst, wst))
    assert g["hbm_oom_retries"] >= 1 and w["hbm_oom_retries"] >= 1
    assert g["hbm_plan"] == w["hbm_plan"] == hbm.GRACE_SPLIT
    assert "post-OOM pre-plan" in g["hbm_plan_reason"]
    assert g["grace_splits"] == w["grace_splits"]
    assert all(s.tpu_count >= 1 and s.fallback_count == 0 for s in stages)
    assert got.equals(want) and got.equals(ref)
    sc.clear_device_caches()


def _oom_always(monkeypatch, exc):
    """Make every partial-stage attempt of the port raise `exc`; returns
    the call count."""
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    calls = [0]

    def boom(self, ctx, rec):
        calls[0] += 1
        raise exc

    monkeypatch.setattr(sc.TpuStageExec, "_tpu_run_all_inner", boom)
    return calls


def test_second_oom_demotes_to_the_cpu_engine(tpch_dir, q3_ref, monkeypatch):
    _ref, cpu = q3_ref
    calls = _oom_always(monkeypatch, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    before = hbm.oom_retry_count()
    out, stages, _finals = _device_stages(_ctx("ballista_tpu_torch", tpch_dir=tpch_dir),
                                          tpch_query(3))
    assert calls[0] == 2  # the first attempt and its one retry
    assert hbm.oom_retry_count() == before + 1
    assert stages and all(s.fallback_count >= 1 and s.tpu_count == 0 for s in stages)
    _assert_close(out, cpu)


def test_non_oom_error_still_propagates(tpch_dir, monkeypatch):
    calls = _oom_always(monkeypatch, RuntimeError("hash_probe launch failed: CUDA error 700"))
    before = hbm.oom_retry_count()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _device_stages(_ctx("ballista_tpu_torch", tpch_dir=tpch_dir), tpch_query(3))
    assert calls[0] >= 1
    assert hbm.oom_retry_count() == before  # no spill-and-retry


def test_final_stage_oom_on_upload_retries_once(tpch_dir, q3_ref):
    # with the partial stage's table, builds and LUTs cached, the first
    # upload of a second run is the final stage's: it runs out of memory,
    # spills the resident table and retries, re-reading its child (whose
    # table is restored from the pool)
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    ref, _cpu = q3_ref
    sc.clear_device_caches()
    ctx = _ctx("ballista_tpu_torch", tpch_dir=tpch_dir)
    _device_stages(ctx, tpch_query(3))
    before = hbm.oom_retry_count()
    reuploads = hbm.SPILL_POOL.stats()["reupload_events"]
    hbm.arm_chaos(1 << 30, oom_n=1)
    try:
        out, stages, finals = _device_stages(ctx, tpch_query(3))
    finally:
        hbm.disarm_chaos()
    assert hbm.oom_retry_count() == before + 1
    assert finals and all(f.tpu_count >= 1 and f.fallback_count == 0 for f in finals)
    assert all(s.fallback_count == 0 for s in stages)
    assert hbm.SPILL_POOL.stats()["reupload_events"] == reuploads + 1
    assert out.equals(ref)
    sc.clear_device_caches()


def test_final_stage_second_oom_falls_back_with_the_materialized_input(tpch_dir, q3_ref,
                                                                       monkeypatch):
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    _ref, cpu = q3_ref
    sc.clear_device_caches()
    ctx = _ctx("ballista_tpu_torch", tpch_dir=tpch_dir)
    _device_stages(ctx, tpch_query(3))  # warm: the partial stage uploads nothing

    def no_memory(arr, device):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(sc, "_put", no_memory)
    out, stages, finals = _device_stages(ctx, tpch_query(3))
    assert finals and all(f.fallback_count >= 1 and f.tpu_count == 0 for f in finals)
    # the final stage's spill demoted the partial stage's table, whose
    # restore then ran out of memory twice: it fell back too
    assert all(s.fallback_count >= 1 for s in stages)
    _assert_close(out, cpu)
    sc.clear_device_caches()


# -- the routed-stage fallback layout ---------------------------------------------------


def test_routed_stage_decline_on_redispatch_counts_every_group_once(monkeypatch):
    # a routed (emit_pid) stage serves every group through partition 0 and
    # empties the others; when a consumer re-reads a served partition and
    # the re-dispatch declines, the CPU fallback must keep that layout, or
    # the groups of that partition are counted twice
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.ops.cuda.kernels import Unsupported
    from ballista_tpu_torch.plan.physical import RepartitionExec, TaskContext

    fact, _ = _skewed_tables()["fact"]
    # three batches: every input partition holds rows
    tables = {"fact": (pa.Table.from_batches(fact.to_batches(max_chunksize=10_000)), 3)}
    sql = "select f.k, sum(f.amount) s, count(*) c from fact f group by f.k"
    sc.clear_device_caches()
    ctx = _ctx("ballista_tpu_torch", tables=tables)
    phys = ctx.create_physical_plan(ctx.sql(sql).plan)
    rep = [n for n in iter_plan(phys) if isinstance(n, RepartitionExec)
           and n.scheme == "hash"][0]
    stage = [n for n in iter_plan(maybe_compile_tpu(rep.input, ctx.config))
             if isinstance(n, sc.TpuStageExec)][0]
    stage.emit_pid = ([0], 8)
    task = TaskContext(ctx.config)
    P = stage.output_partition_count()
    assert P == 3
    raw = stage.partial_agg.with_children([stage._raw_chain()])
    assert all(sum(b.num_rows for b in raw.execute(p, task)) > 0 for p in range(P))
    served = {p: pa.Table.from_batches(list(stage.execute(p, task))) for p in range(P)}
    assert stage.tpu_count == 1 and served[0].num_rows > 0
    assert all(served[p].num_rows == 0 for p in range(1, P))

    def decline(self, ctx):
        raise Unsupported("declined on re-dispatch")

    monkeypatch.setattr(sc.TpuStageExec, "_dispatch_all", decline)
    again = {p: pa.Table.from_batches(list(stage.execute(p, task)),
                                      schema=stage.schema()) for p in (1, 2)}
    assert stage.fallback_count == 2
    assert all(t.num_rows == 0 for t in again.values())
    parts = [served[0].drop_columns(["__pid"])] + list(again.values())
    acc_c = stage.schema().names[2]  # k, then the sum and count accumulators
    merged = (pa.concat_tables(parts).group_by("k").aggregate([(acc_c, "sum")])
              .sort_by([("k", "ascending")]))
    cpu = _ctx("ballista_tpu_torch", "cpu", tables=tables).sql(sql + " order by f.k").collect()
    assert merged.column("k").to_pylist() == cpu.column("k").to_pylist()
    assert merged.column(f"{acc_c}_sum").to_pylist() == cpu.column("c").to_pylist()
    # and the fallback of partition 0 itself aggregates the whole input
    zero = pa.Table.from_batches(list(stage.execute(0, task)))
    assert zero.num_rows == cpu.num_rows
    assert sorted(zero.column(acc_c).to_pylist()) == sorted(cpu.column("c").to_pylist())
    sc.clear_device_caches()
