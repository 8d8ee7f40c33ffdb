"""The port's sorted large-domain aggregation, sorted-mode join build,
device shuffle routing and staged fusion mode, against the JAX package on
the CPU.

The port runs after runtime.use_cpu(); the JAX package with
JAX_PLATFORMS=cpu (tests/conftest.py). Tolerances, where a test states
none, are exact: integers, money, codes, dates, null masks and float sums
of the sorted path agree bit for bit with the reference (both keep tied
rows in input order and scan in the same association order).
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan, tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}


@pytest.fixture(autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _ctx(pkg, engine="tpu", tables=None, parts=2, tpch_dir=None, **extra):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(
        {**BASE_CFG, "ballista.executor.engine": engine, **extra}))
    for name, tbl in (tables or {}).items():
        if isinstance(tbl, tuple):
            tbl, p = tbl
        else:
            p = parts
        ctx.register_arrow_table(name, tbl, partitions=p)
    if tpch_dir is not None:
        reg = __import__(f"{pkg}.testing.tpchgen", fromlist=["register_tpch"])
        reg.register_tpch(ctx, tpch_dir)
    return ctx


def _port_stages(ctx, sql):
    """Compile and run `sql` on the port's device engine; return the
    TpuStageExecs (every partition executed)."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import TaskContext

    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    stages = [n for n in iter_plan(phys) if isinstance(n, TpuStageExec)]
    task = TaskContext(ctx.config)
    for p in range(phys.output_partition_count()):
        list(phys.execute(p, task))
    return stages


def _stage_recs(stages):
    import zlib

    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    recs = RUN_STATS.stages()
    return [recs.get(f"stage_{zlib.crc32(s.fingerprint.encode()):08x}", {}) for s in stages]


def _oracle(sql, tables, parts=2, **extra):
    """(port tpu, port cpu, jax tpu) answers, with the port's device path
    asserted: every partial stage ran on the device with no fallback, and
    at least one took the sorted path."""
    got = _ctx("ballista_tpu_torch", tables=tables, parts=parts, **extra)
    stages = _port_stages(got, sql)
    assert stages, "no device stage compiled"
    assert sum(s.tpu_count for s in stages) >= 1
    assert sum(s.fallback_count for s in stages) == 0, "cpu fallback"
    assert any(r.get("n_seg") is not None for r in _stage_recs(stages)), "no sorted stage"
    return (got.sql(sql).collect(),
            _ctx("ballista_tpu_torch", "cpu", tables, parts, **extra).sql(sql).collect(),
            _ctx("ballista_tpu", "tpu", tables, parts, **extra).sql(sql).collect())


# -- the device key hash -----------------------------------------------------


def test_hash64_parity_with_numpy_and_jax():
    # splitmix64 and the boost combine over int64 lanes, bit-exact with the
    # port's ops/hashing.py and the JAX package's kernels at the extremes
    from ballista_tpu.ops.tpu.kernels import hash64 as jax_hash64
    from ballista_tpu.ops.tpu.kernels import hash_combine_jax
    from ballista_tpu.ops.tpu.runtime import ensure_jax
    from ballista_tpu_torch.ops.cuda.kernels import hash64, hash_combine, umod
    from ballista_tpu_torch.ops.hashing import hash_combine as np_combine
    from ballista_tpu_torch.ops.hashing import splitmix64

    jnp = ensure_jax().numpy
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.array([0, 1, 2, 12345678901234, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64),
        rng.integers(0, 2**64 - 1, 4000, dtype=np.uint64, endpoint=True)])
    np_h = splitmix64(x)
    got = hash64(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, np_h)
    np.testing.assert_array_equal(got, np.asarray(jax_hash64(jnp.asarray(x))))
    rev = np_h[::-1].copy()
    got_c = hash_combine(torch.from_numpy(np_h.view(np.int64)),
                         torch.from_numpy(rev.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got_c, np_combine(np_h, rev))
    np.testing.assert_array_equal(
        got_c, np.asarray(hash_combine_jax(jnp.asarray(np_h), jnp.asarray(rev))))
    for k in (1, 2, 7, 16, 1000, 2**31 - 1):
        np.testing.assert_array_equal(
            umod(torch.from_numpy(got_c.view(np.int64)), k).numpy(),
            (got_c % np.uint64(k)).astype(np.int64))


# -- the sorted aggregation ---------------------------------------------------


def test_large_domain_groupby_on_device(tpch_dir):
    # q3's group-by (l_orderkey × build-side keys) takes the sorted path on
    # the device, with the reference's answer byte for byte
    sql = tpch_query(3)
    port = _ctx("ballista_tpu_torch", tpch_dir=tpch_dir)
    stages = _port_stages(port, sql)
    assert stages and sum(s.tpu_count for s in stages) >= 1
    assert sum(s.fallback_count for s in stages) == 0
    assert _stage_recs(stages)[0]["n_seg"] > 64
    want = _ctx("ballista_tpu", tpch_dir=tpch_dir).sql(sql).collect()
    assert port.sql(sql).collect().equals(want)


def test_sorted_path_min_max_sum_count_oracle():
    # every agg func through the sorted path: money sums exact int64 cents,
    # true f64 sums through the segmented scan — equal to the reference bit
    # for bit (tied rows keep their input order in both sorts), within
    # rtol 1e-12 of pandas, which sums in another order
    rng = np.random.default_rng(7)
    n = 20_000
    tbl = pa.table({
        "k": rng.integers(0, 3000, n),
        "price": np.round(rng.uniform(1, 100, n), 2),
        "weight": rng.uniform(0.0, 1.0, n),
        "qty": rng.integers(1, 50, n),
    })
    sql = ("SELECT k, sum(price) AS s, sum(weight) AS w, count(*) AS c, "
           "min(qty) AS mn, max(qty) AS mx FROM t WHERE qty > 5 GROUP BY k ORDER BY k")
    tpu, cpu, jax_tpu = _oracle(sql, {"t": tbl}, parts=4)
    assert tpu.equals(jax_tpu)
    df = tbl.to_pandas()
    g = (df[df.qty > 5].groupby("k")
         .agg(s=("price", "sum"), w=("weight", "sum"), c=("price", "size"),
              mn=("qty", "min"), mx=("qty", "max"))
         .reset_index().sort_values("k").reset_index(drop=True))
    out = tpu.to_pandas()
    assert (out.k.values == g.k.values).all()
    np.testing.assert_allclose(out.s.values, g.s.values, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out.w.values, g.w.values, rtol=1e-12)
    assert (out.c.values == g.c.values).all()
    assert (out.mn.values == g.mn.values).all() and (out.mx.values == g.mx.values).all()
    assert cpu.column("c").equals(tpu.column("c"))


def _assert_partials_bits_equal(sql, tbl, parts):
    """Run the partial stage of `sql` in both packages and hold the raw
    partial rows (before the final merge) equal: nulls exact, floats bit
    for bit, everything else exact."""
    import ballista_tpu.engine.tpu_engine as jeng
    import ballista_tpu.ops.tpu.stage_compiler as jsc
    import ballista_tpu_torch.engine.cuda_engine as teng
    import ballista_tpu_torch.ops.cuda.stage_compiler as tsc
    from ballista_tpu.plan.physical import TaskContext as JTask
    from ballista_tpu_torch.plan.physical import TaskContext as TTask

    outs = []
    for pkg, eng, sc, task_cls in (("ballista_tpu", jeng, jsc, JTask),
                                   ("ballista_tpu_torch", teng, tsc, TTask)):
        ctx = _ctx(pkg, tables={"t": tbl}, parts=parts)
        phys = eng.maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        st = [nd for nd in iter_plan(phys) if isinstance(nd, sc.TpuStageExec)][0]
        task = task_cls(ctx.config)
        outs.append(pa.Table.from_batches(
            [b for p in range(st.output_partition_count()) for b in st.execute(p, task)]))
        assert st.fallback_count == 0
    want, got = outs
    assert got.schema.equals(want.schema)
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        a, b = got.column(name).combine_chunks(), want.column(name).combine_chunks()
        assert a.is_null().equals(b.is_null()), name
        if pa.types.is_floating(a.type):
            np.testing.assert_array_equal(
                a.fill_null(0.0).to_numpy().view(np.uint64),
                b.fill_null(0.0).to_numpy().view(np.uint64), err_msg=name)
        else:
            assert a.equals(b), name
    return got


@pytest.mark.parametrize("seed,n,keys", [(1, 5000, 40), (2, 30_000, 7), (3, 2_000, 1500)])
def test_sorted_float_partials_bits_equal_reference(seed, n, keys):
    # f64 sums over heavy ties, min/max with NaN and ±0.0, f64 Welford
    # mean/M2: the sorted stage's partial rows bit for bit
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1e3, n)
    x[rng.random(n) < 0.02] = -0.0
    x[rng.random(n) < 0.01] = np.nan
    tbl = pa.table({"k": rng.integers(0, keys, n),
                    "x": pa.array(x, mask=rng.random(n) < 0.1)})
    got = _assert_partials_bits_equal(
        "SELECT k, sum(x) s, min(x) mn, max(x) mx, var_samp(x) v, avg(x) a FROM t GROUP BY k",
        tbl, 3)
    assert got.num_rows > 0


@pytest.mark.parametrize("f", [1, 7])
def test_sorted_one_or_no_live_row_matches_reference(f):
    # one live row of -0.0 among four (the reference's scan still meets a
    # combine there and returns +0.0), and no live row at all; x is no
    # fixed-point column, so it stays f64 (money would make -0.0 cents 0)
    tbl = pa.table({"k": np.array([5, 6, 7, 8]),
                    "x": np.array([-0.0, 0.123456789, 2.000000001, 3.333333333]),
                    "f": np.array([1, 0, 0, 0])})
    got = _assert_partials_bits_equal(
        f"SELECT k, sum(x) s, min(x) mn, max(x) mx, var_pop(x) v FROM t WHERE f = {f} "
        "GROUP BY k", tbl, 1)
    assert got.num_rows == (1 if f == 1 else 0)


def test_expansion_join_with_large_domain_groupby():
    # duplicate build keys AND a large int group domain: the expansion lanes
    # concatenate into one sorted row set (all integer: exact)
    rng = np.random.default_rng(11)
    n_fact, n_dim = 30_000, 2_000
    fact = pa.table({
        "fk": rng.integers(0, 500, n_fact),
        "gk": rng.integers(0, 4000, n_fact),
        "v": rng.integers(1, 100, n_fact),
    })
    dim = pa.table({"dk": rng.integers(0, 500, n_dim), "w": rng.integers(1, 10, n_dim)})
    sql = ("SELECT gk, sum(v * w) AS s, count(*) AS c FROM fact, dim "
           "WHERE fk = dk GROUP BY gk ORDER BY gk")
    tables = {"fact": (fact, 4), "dim": (dim, 1)}
    tpu, cpu, jax_tpu = _oracle(sql, tables)
    assert tpu.equals(jax_tpu) and tpu.equals(cpu)
    df = fact.to_pandas().merge(dim.to_pandas(), left_on="fk", right_on="dk")
    df["p"] = df.v * df.w
    g = df.groupby("gk").agg(s=("p", "sum"), c=("p", "size")).reset_index()
    out = tpu.to_pandas()
    assert (out.gk.values == g.gk.values).all()
    assert (out.s.values == g.s.values).all() and (out.c.values == g.c.values).all()


def _null_table(n=8000, seed=11):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n).astype("int64")
    price = np.round(rng.uniform(1, 100, n), 2)
    qty = rng.integers(1, 50, n).astype("int64")
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.1),
        "price": pa.array(price, mask=rng.random(n) < 0.3),
        "qty": pa.array(qty, mask=rng.random(n) < 0.2),
        "flag": rng.integers(0, 2, n).astype(bool),
    })


def test_nullable_group_key_on_device():
    # a nullable GROUP BY key: NULL forms its own group through the null
    # marker sort operand
    sql = ("SELECT k, count(*) AS c, sum(price) AS s FROM t "
           "WHERE qty >= 1 GROUP BY k ORDER BY k NULLS LAST")
    tpu, cpu, jax_tpu = _oracle(sql, {"t": _null_table()})
    assert tpu.equals(jax_tpu)
    tp, cp = tpu.to_pandas(), cpu.to_pandas()
    assert tp.k.isna().tolist() == cp.k.isna().tolist()
    assert tp.k.isna().sum() == 1
    assert tp.k.fillna(-1).tolist() == cp.k.fillna(-1).tolist()
    assert (tp.c.values == cp.c.values).all()
    # the CPU engine sums money in float64, the device in int64 cents
    np.testing.assert_allclose(tp.s.values, cp.s.values, rtol=1e-12)


def test_all_null_group_aggregates_to_null_on_device():
    # a group whose agg inputs are all NULL yields NULL (not 0 / ±inf): the
    # valid-count companions
    tbl = pa.table({
        "g": pa.array([1, 1, 2, 2, 3], pa.int64()),
        "v": pa.array([None, None, 5.25, 7.75, None], pa.float64()),
        "q": pa.array([None, None, 4, 2, 9], pa.int64()),
    })
    sql = ("SELECT g, sum(v) AS s, min(q) AS mn, max(q) AS mx, count(q) AS c "
           "FROM t GROUP BY g ORDER BY g")
    tpu, cpu, jax_tpu = _oracle(sql, {"t": tbl})
    assert tpu.equals(jax_tpu) and tpu.equals(cpu)
    tp = tpu.to_pandas()
    assert tp.s.isna().tolist() == [True, False, True]
    assert tp.mn.isna().tolist() == [True, False, False]
    assert float(tp.s[1]) == 13.0 and int(tp.mn[1]) == 2 and int(tp.mx[1]) == 4
    assert tp.c.tolist() == [0, 2, 1]


def test_variance_on_device_sorted_path():
    # var/stddev partials (the Welford (cnt, mean, M2) triple) through the
    # sorted two-pass, with an all-NULL group and a one-row group: equal to
    # the reference bit for bit, within rtol 1e-9 of the CPU engine's
    # one-pass Welford
    rng = np.random.default_rng(17)
    n = 6000
    g = rng.integers(0, 40, n).astype("int64")
    v = np.round(rng.normal(1000.0, 25.0, n), 4)
    null_v = rng.random(n) < 0.25
    null_v[g == 39] = True
    one = np.nonzero(g == 38)[0]
    null_v[one] = True
    null_v[one[0]] = False
    tbl = pa.table({"g": pa.array(g, pa.int64()), "v": pa.array(v, pa.float64(), mask=null_v)})
    sql = ("SELECT g, var_samp(v) AS vs, var_pop(v) AS vp, "
           "stddev(v) AS sd, count(v) AS c FROM t GROUP BY g ORDER BY g")
    tpu, cpu, jax_tpu = _oracle(sql, {"t": tbl})
    assert tpu.equals(jax_tpu)
    tp, cp = tpu.to_pandas(), cpu.to_pandas()
    assert tp.g.tolist() == cp.g.tolist() and tp.c.tolist() == cp.c.tolist()
    for col in ("vs", "vp", "sd"):
        assert tp[col].isna().tolist() == cp[col].isna().tolist()
        np.testing.assert_allclose(tp[col].fillna(0).values, cp[col].fillna(0).values,
                                   rtol=1e-9, atol=1e-9)


def test_expression_group_key_hoisted_to_device():
    # substr(w, 1, 11) group keys hoist: the device groups by the raw column
    # (30 dictionary codes, more than the unrolled form's 64-lane budget
    # allows with its pow2 padding), a CPU projection applies the
    # expression, the final agg merges the finer groups
    rng = np.random.default_rng(47)
    n = 6000
    names = [f"warehouse-{i:02d}-site" for i in range(30)]
    tbl = pa.table({
        "w": pa.array([names[i] for i in rng.integers(0, 30, n)]),
        "v": rng.integers(0, 100, n).astype("int64"),
        "x": rng.integers(0, 3000, n).astype("int64"),
    })
    sql = ("SELECT substr(w, 1, 11) wk, x, count(*) c, sum(v) s "
           "FROM t GROUP BY substr(w, 1, 11), x ORDER BY wk, x")
    tpu, cpu, jax_tpu = _oracle(sql, {"t": tbl})
    assert tpu.equals(jax_tpu) and tpu.equals(cpu)
    assert set(tpu.column("wk").to_pylist()) == {"warehouse-0", "warehouse-1", "warehouse-2"}


def test_capacity_overflow_falls_back_with_the_right_answer(monkeypatch):
    # more groups than the capacity C: the stage raises Unsupported from the
    # device run and re-runs on the CPU engine, counted in fallback_count
    import ballista_tpu_torch.ops.cuda.stage_compiler as tsc

    monkeypatch.setattr(tsc, "SORTED_MAX_GROUPS", 64)
    rng = np.random.default_rng(5)
    tbl = pa.table({"k": rng.integers(0, 500, 4000), "v": rng.integers(0, 9, 4000)})
    sql = "SELECT k, sum(v) s, count(*) c FROM t GROUP BY k ORDER BY k"
    ctx = _ctx("ballista_tpu_torch", tables={"t": tbl})
    stages = _port_stages(ctx, sql)
    assert len(stages) == 1
    assert stages[0].fallback_count >= 1 and stages[0].tpu_count == 0
    got = ctx.sql(sql).collect()
    assert got.equals(_ctx("ballista_tpu_torch", "cpu", {"t": tbl}).sql(sql).collect())
    assert got.num_rows > 64


# -- the sorted-mode join build ------------------------------------------------


@pytest.mark.parametrize("dup", [1, 3])
def test_sorted_mode_build_past_the_direct_table(dup):
    # combined keys past DIRECT_TABLE_MAX (2^27) take the sorted layout:
    # binary search, unique and expansion, NULL probe keys match nothing
    from ballista_tpu_torch.ops.cuda.stage_compiler import _BUILD_CACHE

    rng = np.random.default_rng(60 + dup)
    nb = 300
    a = rng.choice(1 << 20, nb, replace=False).astype(np.int64)  # a << shift | b
    b = rng.integers(0, 1 << 12, nb).astype(np.int64)
    build = pa.table({"ba": np.repeat(a, dup), "bb": np.repeat(b, dup),
                      "w": rng.integers(1, 50, nb * dup)})
    n = 5000
    pick = rng.integers(0, nb, n)
    hit = rng.random(n) < 0.7
    pa_ = np.where(hit, a[pick], rng.integers(0, 1 << 20, n))
    probe = pa.table({
        "pa": pa.array(pa_, mask=rng.random(n) < 0.1),
        "pb": np.where(hit, b[pick], rng.integers(0, 1 << 12, n)),
        "g": rng.integers(0, 2000, n),
        "v": rng.integers(1, 100, n),
    })
    sql = ("SELECT g, count(*) c, sum(v * w) s, max(w) mw FROM probe "
           "JOIN build ON pa = ba AND pb = bb GROUP BY g ORDER BY g")
    _BUILD_CACHE.clear()
    tpu, cpu, jax_tpu = _oracle(sql, {"probe": probe, "build": (build, 1)})
    assert {bt.mode for bt, _size in _BUILD_CACHE._od.values()} == {"sorted"}
    assert tpu.equals(jax_tpu) and tpu.equals(cpu)
    assert tpu.num_rows > 100


# -- device shuffle routing -----------------------------------------------------


def _routed_buckets(pkg, tbl, sql, k, work):
    """Run the partial stage of `sql` under a hand-built hash-layout
    ShuffleWriterExec (`pkg`'s own classes), as a distributed plan's first
    stage would; return (the stage, {partition: table})."""
    eng = __import__(f"{pkg}.engine.{'cuda' if pkg.endswith('torch') else 'tpu'}_engine",
                     fromlist=["maybe_compile_tpu"])
    phys_mod = __import__(f"{pkg}.plan.physical", fromlist=["RepartitionExec", "TaskContext"])
    writer_mod = __import__(f"{pkg}.shuffle.writer", fromlist=["ShuffleWriterExec"])
    sc_mod = __import__(
        f"{pkg}.ops.{'cuda' if pkg.endswith('torch') else 'tpu'}.stage_compiler",
        fromlist=["TpuStageExec"])
    ctx = _ctx(pkg, tables={"t": tbl}, parts=3)
    phys = ctx.create_physical_plan(ctx.sql(sql).plan)
    rep = [n for n in iter_plan(phys) if isinstance(n, phys_mod.RepartitionExec)
           and n.scheme == "hash"][0]
    writer = writer_mod.ShuffleWriterExec(rep.input, "jpid", 1, k, rep.keys,
                                          sort_shuffle=False)
    compiled = eng.maybe_compile_tpu(writer, ctx.config)
    stage = [n for n in iter_plan(compiled) if isinstance(n, sc_mod.TpuStageExec)][0]
    task = phys_mod.TaskContext(ctx.config, task_id="t0", work_dir=work)
    for p in range(compiled.output_partition_count()):
        list(compiled.execute(p, task))
    out = {}
    for f in glob.glob(os.path.join(work, "jpid", "1", "*", "*.arrow")):
        with open(f, "rb") as fh:
            out[int(os.path.basename(os.path.dirname(f)))] = ipc.open_stream(fh).read_all()
    return stage, out


def _routing_table(n=6000, seed=5):
    rng = np.random.default_rng(seed)
    extremes = np.array([0, -1, 2**63 - 1, -(2**63), 2**62, -12345], dtype=np.int64)
    i64 = np.concatenate([extremes, rng.integers(-(2**62), 2**62, n - len(extremes))])
    return pa.table({
        "i": pa.array(i64, mask=rng.random(n) < 0.05),
        "s": pa.array([f"k{v}" for v in rng.integers(0, 900, n)], mask=rng.random(n) < 0.05),
        "m": pa.array(np.round(rng.uniform(-50, 50, n), 2)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32)).cast(pa.date32()),
        "v": rng.integers(1, 100, n),
    })


@pytest.mark.parametrize("keys", ["i", "s", "d", "i, s", "s, d, i"])
def test_device_side_shuffle_routing(keys, tmp_path):
    # the sorted path emits __pid (bit-exact hash twin) and the writer
    # routes by it: every written row hashes on the host, through
    # ops/hashing.partition_indices, to its own partition; the ids equal
    # the JAX package's, row for row
    from ballista_tpu_torch.ops.hashing import partition_indices

    tbl = _routing_table()
    sql = f"SELECT {keys}, sum(v) sv, count(*) c FROM t GROUP BY {keys}"
    names = [k.strip() for k in keys.split(",")]
    k = 16
    runs = {}
    for pkg in ("ballista_tpu_torch", "ballista_tpu"):
        stage, buckets = _routed_buckets(pkg, tbl, sql, k, str(tmp_path / pkg))
        assert stage.emit_pid is not None and stage.pid_emitted >= 1
        assert stage.fallback_count == 0
        runs[pkg] = buckets
    got, want = runs["ballista_tpu_torch"], runs["ballista_tpu"]
    assert sorted(got) == sorted(want) and len(got) > 1
    for pid, t in got.items():
        assert "__pid" not in t.column_names
        host = partition_indices([t.column(c).combine_chunks() for c in names], k)
        assert (host == pid).all()
        assert t.equals(want[pid])
    assert sum(t.num_rows for t in got.values()) == len(
        tbl.select(names).to_pandas().drop_duplicates())


def test_device_routing_money_key_follows_host_hashing(tmp_path):
    # a money key hashes through the bits of its DECODED float64 (cents /
    # 100, as the decode divides), so every written row hashes on the host
    # to its own partition. The reference's XLA program multiplies by 0.01
    # instead, which rounds differently for some cents (ROADMAP C6): its
    # ids differ on those rows, while the written rows are the same.
    from ballista_tpu_torch.ops.hashing import partition_indices

    tbl = _routing_table()
    sql = "SELECT m, sum(v) sv FROM t GROUP BY m"
    k = 16
    _, got = _routed_buckets("ballista_tpu_torch", tbl, sql, k, str(tmp_path / "port"))
    _, want = _routed_buckets("ballista_tpu", tbl, sql, k, str(tmp_path / "jax"))
    for pid, t in got.items():
        host = partition_indices([t.column("m").combine_chunks()], k)
        assert (host == pid).all()
    misrouted = sum(int((partition_indices([t.column("m").combine_chunks()], k) != pid).sum())
                    for pid, t in want.items())
    assert misrouted > 0  # the reference's fault, pinned
    rows = lambda b: pa.concat_tables(b.values()).sort_by("m")  # noqa: E731
    assert rows(got).equals(rows(want))
    cents = np.round(np.unique(tbl.column("m").to_numpy()) * 100).astype(np.int64)
    assert (cents / 100 != cents * 0.01).any()  # the data holds such cents


# -- the staged fusion mode ------------------------------------------------------


def _run_mode(sql, mode, tables=None, tpch_dir=None, parts=2, **extra):
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    ctx = _ctx("ballista_tpu_torch", tables=tables, parts=parts, tpch_dir=tpch_dir,
               **{"ballista.tpu.fusion.mode": mode, **extra})
    RUN_STATS.clear()
    out = ctx.sql(sql).collect()
    return out, RUN_STATS.snapshot()


def _synth(n=50_000, seed=5, cats=5):
    rng = np.random.default_rng(seed)
    names = [f"c{i:04d}" for i in range(cats)]
    return pa.table({
        "cat": rng.choice(names, n),
        "price": np.round(rng.uniform(1, 100, n), 2),
        "w": rng.uniform(0.0, 10.0, n),
        "qty": rng.integers(1, 50, n),
    })


@pytest.mark.parametrize("q", [1, 6, 12, 19])
def test_tpch_parity_staged_vs_fused(q, tpch_dir):
    # staged and fused_xla run the same torch expressions over the same
    # inputs: byte-identical; q1/q6 really run staged, with the span split
    sql = tpch_query(q)
    fused, s_f = _run_mode(sql, "fused_xla", tpch_dir=tpch_dir)
    staged, s_s = _run_mode(sql, "staged", tpch_dir=tpch_dir)
    assert s_f.get("fusion_mode") == "fused_xla"
    assert s_s.get("fusion_mode") in ("staged", "fused_xla")
    assert staged.combine_chunks().equals(fused.combine_chunks())
    if q in (1, 6):
        assert s_s.get("fusion_mode") == "staged"
        assert set(s_s.get("span_s", {})) == {"predicate", "project", "aggregate"}
        assert s_s.get("fused_spans") == 0
        assert s_f.get("fused_spans", 0) >= 2


def test_parity_with_join_filter_project(tpch_dir):
    # filter → project → join probe → partial agg (q14): staged through the
    # probe gathers too, byte-identical
    sql = tpch_query(14)
    fused, _ = _run_mode(sql, "fused_xla", tpch_dir=tpch_dir)
    staged, s_s = _run_mode(sql, "staged", tpch_dir=tpch_dir)
    assert staged.combine_chunks().equals(fused.combine_chunks())
    assert s_s.get("fusion_mode") == "staged"


def test_parity_synthetic_all_agg_funcs():
    sql = ("select cat, sum(price) s, sum(w) ws, count(*) c, min(qty) mn, "
           "max(qty) mx from t where qty > 7 group by cat order by cat")
    tbl = _synth()
    fused, _ = _run_mode(sql, "fused_xla", {"t": tbl}, parts=4)
    staged, s_s = _run_mode(sql, "staged", {"t": tbl}, parts=4)
    assert s_s.get("fusion_mode") == "staged"
    assert staged.combine_chunks().equals(fused.combine_chunks())
    # the reference's staged answer: exact but for the true-f64 sum, which
    # torch and XLA reduce in different orders (rtol 1e-12)
    jax = _ctx("ballista_tpu", tables={"t": tbl}, parts=4,
               **{"ballista.tpu.fusion.mode": "staged"}).sql(sql).collect()
    assert staged.drop(["ws"]).equals(jax.drop(["ws"]))
    np.testing.assert_allclose(staged.column("ws").to_numpy(), jax.column("ws").to_numpy(),
                               rtol=1e-12)


def test_auto_small_input_staged():
    # auto mode below ballista.tpu.fusion.min.rows picks staged, with the
    # reason recorded; above it the same shape fuses
    sql = "select cat, sum(w) s, count(*) c from t group by cat order by cat"
    out, stats = _run_mode(sql, "auto", {"t": _synth(n=2_000, seed=9)})
    assert stats.get("fusion_mode") == "staged"
    assert "fusion.min.rows" in stats.get("fusion_reason", "")
    out2, stats2 = _run_mode(sql, "auto", {"t": _synth(n=20_000, seed=9)})
    assert stats2.get("fusion_mode") == "fused_xla"


def test_fusion_disabled_lands_staged():
    sql = "select cat, sum(w) s from t group by cat order by cat"
    out, stats = _run_mode(sql, "auto", {"t": _synth(n=20_000, seed=2)},
                           **{"ballista.tpu.fusion.enabled": False})
    assert stats.get("fusion_mode") == "staged"
    assert "disabled" in stats.get("fusion_reason", "")
