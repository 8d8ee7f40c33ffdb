"""The port's ORDER BY / top-k / window stages against the JAX package's.

Each case of tests/test_tpu_sort_window.py builds one plan from each
package's own classes and runs it in each of the three fusion modes. Held
equal, per column over Arrow IPC stream bytes (NaN payloads and zero signs
included): the port's device stage and the JAX package's, and the port's
device stage and the port's CPU operator. Under `fused_pallas` the port's
kernel wrappers (their plain forms here, on the CPU) are called as often as
the JAX package calls its Pallas kernels (interpret mode).
"""

import decimal
import io
import types

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import iter_plan

MODES = ("staged", "fused_xla", "fused_pallas")
KERNELS = ("segmented_sort", "topk_select", "segmented_scan")


@pytest.fixture(autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _pkg(name):
    """The classes and modules of one package under one namespace."""
    if name == "jax":
        import ballista_tpu.config as config
        import ballista_tpu.ops.tpu.fusion as fusion
        import ballista_tpu.ops.tpu.pallas_kernels as kernels
        import ballista_tpu.ops.tpu.sort_window as sort_window
        import ballista_tpu.plan.expressions as expressions
        import ballista_tpu.plan.physical as physical
        import ballista_tpu.plan.schema as schema
        from ballista_tpu.ops.tpu.stage_compiler import RUN_STATS
    else:
        import ballista_tpu_torch.config as config
        import ballista_tpu_torch.ops.cuda.cuda_kernels as kernels
        import ballista_tpu_torch.ops.cuda.fusion as fusion
        import ballista_tpu_torch.ops.cuda.sort_window as sort_window
        import ballista_tpu_torch.plan.expressions as expressions
        import ballista_tpu_torch.plan.physical as physical
        import ballista_tpu_torch.plan.schema as schema
        from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    return types.SimpleNamespace(
        config=config, fusion=fusion, kernels=kernels, sw=sort_window,
        ex=expressions, ph=physical, DFSchema=schema.DFSchema, RUN_STATS=RUN_STATS)


PKGS = {name: _pkg(name) for name in ("jax", "port")}


def _src(pk, tbl, chunk=97):
    class _Src(pk.ph.ExecutionPlan):
        def __init__(self):
            super().__init__(pk.DFSchema.from_arrow(tbl.schema))

        def children(self):
            return []

        def output_partition_count(self):
            return 1

        def execute(self, partition, ctx):
            yield from tbl.to_batches(max_chunksize=chunk)

    return _Src()


def _cfg(pk, mode, **extra):
    c = pk.config
    settings = {c.TPU_MIN_ROWS: 0, c.TPU_FUSION_MODE: mode}
    settings.update({getattr(c, k): v for k, v in extra.items()})
    return c.BallistaConfig(settings)


def _collect(pk, plan, cfg):
    batches = list(plan.execute(0, pk.ph.TaskContext(cfg)))
    return pa.Table.from_batches(batches, schema=plan.schema())


def _column_bytes(tbl):
    out = []
    for c in tbl.column_names:
        one = pa.table({c: tbl.column(c).combine_chunks()})
        buf = io.BytesIO()
        with ipc.new_stream(buf, one.schema) as w:
            w.write_table(one)
        out.append(buf.getvalue())
    return out


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the sort-family kernel calls per package: the JAX
    package's Pallas functions, the port's wrappers."""
    calls = {side: dict.fromkeys(KERNELS, 0) for side in PKGS}

    def counting(side, name, fn):
        def wrapped(*a, **k):
            calls[side][name] += 1
            return fn(*a, **k)
        return wrapped

    for side, pk in PKGS.items():
        for name in KERNELS:
            monkeypatch.setattr(pk.kernels, name,
                                counting(side, name, getattr(pk.kernels, name)))
    return calls


def _parity(make_dev, make_cpu, mode, calls=None, **cfg_extra):
    """Run the plan `make_dev(pk, cfg)` in both packages and the port's CPU
    operator `make_cpu(pk)`; hold all three byte-identical."""
    outs = {}
    for side, pk in PKGS.items():
        cfg = _cfg(pk, mode, **cfg_extra)
        dev = make_dev(pk, cfg)
        outs[side] = _collect(pk, dev, cfg)
        assert dev.tpu_count >= 1, f"{side}: device path did not run"
        assert dev.fallback_count == 0, f"{side}: device path fell back"
    port = PKGS["port"]
    cpu = _collect(port, make_cpu(port), _cfg(port, mode))
    assert _column_bytes(outs["port"]) == _column_bytes(outs["jax"])
    assert _column_bytes(outs["port"]) == _column_bytes(cpu)
    if calls is not None:
        assert calls["port"] == calls["jax"]
        if mode == "fused_pallas":
            assert sum(calls["port"].values()) >= 1
        else:
            assert sum(calls["port"].values()) == 0
    return outs["port"]


def _adversarial_table(n=384):
    rng = np.random.default_rng(11)
    f = rng.integers(-40, 40, n).astype(np.float64)
    f[::7] = np.nan
    f[::11] = 0.0
    f[1::11] = -0.0
    return pa.table({
        "f": pa.array(f),
        "i": pa.array(rng.integers(0, 12, n), pa.int64()),
        "inull": pa.array(
            [None if j % 5 == 0 else int(v)
             for j, v in enumerate(rng.integers(0, 7, n))], pa.int32()),
        "s": pa.array([["aa", "b", "aa", "zz", "m"][j % 5] if j % 13 else None
                       for j in range(n)]),
    })


def _keysets(pk):
    SK, C = pk.ex.SortKey, pk.ex.Column
    return [
        [SK(C("i")), SK(C("f"), ascending=False, nulls_first=True)],
        [SK(C("inull"), nulls_first=True)],
        [SK(C("inull"), ascending=False, nulls_first=False)],
        [SK(C("s")), SK(C("i"), ascending=False)],
        [SK(C("f"))],
    ]


@pytest.mark.parametrize("mode", MODES)
def test_sort_parity_adversarial(mode, kernel_calls):
    """NULLS FIRST/LAST per key, NaN and ±0.0 ordering, string keys, multi
    key DESC, with and without LIMIT."""
    tbl = _adversarial_table()
    for j in range(len(_keysets(PKGS["port"]))):
        for fetch in (None, 10):
            _parity(
                lambda pk, cfg: pk.sw.TpuSortStageExec(_src(pk, tbl), _keysets(pk)[j], fetch, cfg),
                lambda pk: pk.ph.SortExec(_src(pk, tbl), _keysets(pk)[j], fetch),
                mode, kernel_calls)
    if mode == "fused_pallas":
        # three single-key LIMITs through top-k; a two-key LIMIT demotes to
        # fused_xla (no kernel); the sorts take one pass per key
        assert kernel_calls["port"]["topk_select"] == 3
        assert kernel_calls["port"]["segmented_sort"] == 2 + 1 + 1 + 2 + 1


@pytest.mark.parametrize("mode", MODES)
def test_topk_ties_at_cut_boundary(mode, kernel_calls):
    """Every key value appears 20 times, so each LIMIT cuts inside a tie
    run: the top-k keeps exactly the rows the stable full sort keeps."""
    n = 300
    tbl = pa.table({
        "k": pa.array([j % 15 for j in range(n)], pa.int64()),
        "payload": pa.array(range(n), pa.int64()),
    })
    for fetch in (7, 20, 33):
        _parity(
            lambda pk, cfg: pk.sw.TpuSortStageExec(
                _src(pk, tbl), [pk.ex.SortKey(pk.ex.Column("k"))], fetch, cfg),
            lambda pk: pk.ph.SortExec(_src(pk, tbl), [pk.ex.SortKey(pk.ex.Column("k"))], fetch),
            mode, kernel_calls)
    if mode == "fused_pallas":
        assert kernel_calls["port"]["topk_select"] == 3


@pytest.mark.parametrize("mode", ("staged", "fused_pallas"))
def test_sort_dictionary_duplicate_values(mode):
    """Duplicate strings in a dictionary share a rank, so ties fall to the
    next key as in the CPU sort of the decoded column."""
    codes = pa.array([0, 1, 2, 3, 4, 0, 2, 1, 3, 0] * 30, pa.int32())
    dup = pa.DictionaryArray.from_arrays(codes, pa.array(["b", "aa", "b", "c", "aa"]))
    payload = pa.array(range(300), pa.int64())
    tbl = pa.table({"s": dup, "p": payload})
    dec = pa.table({"s": dup.cast(pa.string()), "p": payload})
    outs = {}
    for side, pk in PKGS.items():
        keys = [pk.ex.SortKey(pk.ex.Column("s"), ascending=False),
                pk.ex.SortKey(pk.ex.Column("p"))]
        cfg = _cfg(pk, mode)
        devp = pk.sw.TpuSortStageExec(_src(pk, tbl), keys, None, cfg)
        outs[side] = _collect(pk, devp, cfg)
        assert devp.tpu_count == 1 and devp.fallback_count == 0
    assert _column_bytes(outs["port"]) == _column_bytes(outs["jax"])
    port = PKGS["port"]
    keys = [port.ex.SortKey(port.ex.Column("s"), ascending=False),
            port.ex.SortKey(port.ex.Column("p"))]
    cpu = _collect(port, port.ph.SortExec(_src(port, dec), keys, None), _cfg(port, mode))
    assert (outs["port"].column("s").cast(pa.string()).combine_chunks().to_pylist()
            == cpu.column("s").combine_chunks().to_pylist())
    assert outs["port"].column("p").combine_chunks().equals(cpu.column("p").combine_chunks())


def _window_schema(pk, tbl, wexprs):
    schema = pk.DFSchema.from_arrow(tbl.schema)
    return pk.DFSchema.from_arrow(pa.schema(
        list(tbl.schema)
        + [pa.field(f"w{j}", w.data_type(schema)) for j, w in enumerate(wexprs)]))


def _window_parity(tbl, make_wexprs, mode, calls=None):
    def dev(pk, cfg):
        w = make_wexprs(pk)
        return pk.sw.TpuWindowStageExec(_src(pk, tbl), w, _window_schema(pk, tbl, w), cfg)

    def cpu(pk):
        w = make_wexprs(pk)
        return pk.ph.WindowExec(_src(pk, tbl), w, _window_schema(pk, tbl, w))

    return _parity(dev, cpu, mode, calls)


@pytest.mark.parametrize("mode", MODES)
def test_window_parity_adversarial(mode, kernel_calls):
    """row_number/rank/count/sum/min/max over partition+order with NaN
    order keys, nullable int arguments, float min, and peer groups whose
    order values repeat across partition boundaries (scan resets must
    isolate partitions)."""
    rng = np.random.default_rng(23)
    n = 384
    f = rng.integers(-10, 10, n).astype(np.float64)
    f[::9] = np.nan
    tbl = pa.table({
        "g": pa.array(rng.integers(0, 8, n), pa.int64()),
        "o": pa.array(rng.integers(0, 3, n), pa.int64()),
        "f": pa.array(f),
        "vnull": pa.array(
            [None if j % 4 == 0 else int(v)
             for j, v in enumerate(rng.integers(-50, 50, n))], pa.int64()),
    })

    def wexprs(pk):
        WF, C, SK = pk.ex.WindowFunction, pk.ex.Column, pk.ex.SortKey
        over = ([C("g")], [SK(C("o"))])
        return [
            WF("row_number", [], *over, None),
            WF("rank", [], *over, None),
            WF("count", [C("vnull")], *over, None),
            WF("sum", [C("vnull")], *over, None),
            WF("min", [C("f")], [C("g")], [SK(C("f"), nulls_first=True)], None),
            WF("max", [C("vnull")], [], [SK(C("o"), ascending=False)], None),
        ]

    _window_parity(tbl, wexprs, mode, kernel_calls)
    if mode == "fused_pallas":
        # three frames of two, two and one sort keys; scans: row_number 1,
        # rank 1, count 1, sum 2, min 2, max 2
        assert kernel_calls["port"]["segmented_sort"] == 5
        assert kernel_calls["port"]["segmented_scan"] == 9


def test_window_decimal_sum_and_int_min_max(kernel_calls):
    """sum over a decimal column (the exact money lane) and min/max over an
    int column, under fused_pallas."""
    rng = np.random.default_rng(5)
    n = 200
    tbl = pa.table({
        "g": pa.array(rng.integers(0, 6, n), pa.int64()),
        "o": pa.array(rng.integers(0, 50, n), pa.int64()),
        "d": pa.array([None if j % 7 == 0 else decimal.Decimal(int(v)).scaleb(-2)
                       for j, v in enumerate(rng.integers(-99999, 99999, n))],
                      pa.decimal128(12, 2)),
        "i": pa.array(rng.integers(-1000, 1000, n), pa.int32()),
    })

    def wexprs(pk):
        WF, C, SK = pk.ex.WindowFunction, pk.ex.Column, pk.ex.SortKey
        over = ([C("g")], [SK(C("o"))])
        return [WF("sum", [C("d")], *over, None),
                WF("min", [C("i")], *over, None),
                WF("max", [C("i")], *over, None)]

    _window_parity(tbl, wexprs, "fused_pallas", kernel_calls)
    assert kernel_calls["port"]["segmented_scan"] == 6


@pytest.mark.parametrize("mode", ("fused_xla", "fused_pallas"))
def test_window_empty_and_all_null_partitions(mode, kernel_calls):
    """Partitions of one row and partitions whose argument is all NULL
    (SQL: an aggregate over zero valid rows is NULL)."""
    g = pa.array([0] * 50 + [1] + [2] * 49 + [3], pa.int64())
    v = pa.array([None] * 50 + [7] + [int(x) for x in range(49)] + [None], pa.int64())
    tbl = pa.table({"g": g, "v": v})

    def wexprs(pk):
        WF, C, SK = pk.ex.WindowFunction, pk.ex.Column, pk.ex.SortKey
        over = ([C("g")], [SK(C("v"), nulls_first=True)])
        return [WF("sum", [C("v")], *over, None),
                WF("min", [C("v")], *over, None),
                WF("count", [C("v")], *over, None),
                WF("rank", [], *over, None)]

    _window_parity(tbl, wexprs, mode, kernel_calls)


def test_zero_row_input():
    tbl = pa.table({"a": pa.array([], pa.int64())})
    for side, pk in PKGS.items():
        cfg = _cfg(pk, "fused_pallas")
        keys = [pk.ex.SortKey(pk.ex.Column("a"))]
        out = _collect(pk, pk.sw.TpuSortStageExec(_src(pk, tbl), keys, 5, cfg), cfg)
        assert out.num_rows == 0, side
        wexprs = [pk.ex.WindowFunction("row_number", [], [], keys, None)]
        out = _collect(pk, pk.sw.TpuWindowStageExec(
            _src(pk, tbl), wexprs, _window_schema(pk, tbl, wexprs), cfg), cfg)
        assert out.num_rows == 0 and out.num_columns == 2, side


@pytest.mark.parametrize("mode", ("fused_xla", "fused_pallas"))
def test_estimate_covers_device_bytes(mode):
    """estimate_sort_stage prices at least the bytes the stage shipped
    (RUN_STATS device_bytes), for a sort, a top-k and a window stage; the
    port ships what the JAX package ships and estimates what it estimates."""
    tbl = _adversarial_table()
    n = tbl.num_rows
    batch = tbl.combine_chunks().to_batches()[0]
    shipped = {}
    for side, pk in PKGS.items():
        SK, C, WF = pk.ex.SortKey, pk.ex.Column, pk.ex.WindowFunction
        cfg = _cfg(pk, mode)
        keys = [SK(C("inull"), nulls_first=True), SK(C("f"), ascending=False)]
        _, key_meta = pk.sw._encode_key_arrays(
            [batch.column("inull"), batch.column("f")],
            [(k.ascending, k.nulls_first) for k in keys])
        for fetch in (None, 8):
            devp = pk.sw.TpuSortStageExec(_src(pk, tbl), keys, fetch, cfg)
            _collect(pk, devp, cfg)
            assert devp.tpu_count == 1
            actual = int(pk.RUN_STATS.snapshot()["device_bytes"])
            est = pk.fusion.estimate_sort_stage(n, key_meta, fetch=None)
            assert est.table_bytes >= actual > 0, (side, est.table_bytes, actual)
            shipped[side, fetch] = (actual, est.table_bytes)
        wexprs = [WF("sum", [C("i")], [C("i")], [SK(C("f"))], None),
                  WF("rank", [], [C("i")], [SK(C("f"))], None)]
        devp = pk.sw.TpuWindowStageExec(_src(pk, tbl), wexprs,
                                        _window_schema(pk, tbl, wexprs), cfg)
        _collect(pk, devp, cfg)
        assert devp.tpu_count == 1
        actual = int(pk.RUN_STATS.snapshot()["device_bytes"])
        _, wmeta = pk.sw._encode_key_arrays([batch.column("i"), batch.column("f")],
                                            [(True, False), (True, False)])
        west = pk.fusion.estimate_sort_stage(n, wmeta, window_funcs=len(wexprs))
        assert west.table_bytes >= actual > 0, (side, west.table_bytes, actual)
        shipped[side, "window"] = (actual, west.table_bytes)
    for key in (None, 8, "window"):
        assert shipped["port", key] == shipped["jax", key]


def test_demotion_reason_recorded():
    """A forced fused_pallas sort over the lane ceiling demotes to fused_xla
    with the cost model's reason, in both packages alike."""
    tbl = pa.table({"a": pa.array(range(600), pa.int64())})
    stats = {}
    for side, pk in PKGS.items():
        cfg = _cfg(pk, "fused_pallas", TPU_SORT_PALLAS_MAX_ROWS=128)
        devp = pk.sw.TpuSortStageExec(_src(pk, tbl), [pk.ex.SortKey(pk.ex.Column("a"))],
                                      None, cfg)
        _collect(pk, devp, cfg)
        assert devp.tpu_count == 1 and devp.fallback_count == 0
        stats[side] = pk.RUN_STATS.snapshot()
        assert stats[side]["fusion_mode"] == "fused_xla"
        assert "forced fused_pallas but" in stats[side]["fusion_reason"]
    assert stats["port"]["fusion_reason"] == stats["jax"]["fusion_reason"]


@pytest.mark.parametrize("platform,want", [("cuda", "fused_pallas"), ("cpu", "fused_xla")])
def test_choose_sort_auto_mode_on_the_card(platform, want):
    """Auto mode earns the kernel rung on the card ("cuda" where the JAX
    package says "tpu"), with the JAX package's reason strings."""
    port, jax_pkg = PKGS["port"], PKGS["jax"]
    jax_platform = {"cuda": "tpu", "cpu": "cpu"}[platform]
    cases = [(1000, [("i64", False)], None, 0), (1000, [("f64", True)], 100, 0),
             (1 << 18, [("i64", False), ("f64", False)], None, 4),
             (5000, [("i64", False), ("code", False)], 10, 0), (600, [("i64", False)], 2000, 0)]
    for rows, meta, fetch, wf in cases:
        decs = []
        for pk, plat in ((port, platform), (jax_pkg, jax_platform)):
            cm = pk.fusion.CostModel.from_config(pk.config.BallistaConfig(
                {pk.config.TPU_SORT_PALLAS_MAX_ROWS: 1 << 20}))
            cm.platform = plat
            decs.append(cm.choose_sort(pk.fusion.estimate_sort_stage(
                rows, meta, fetch=fetch, window_funcs=wf)))
        (pd, jd) = decs
        assert pd.mode == jd.mode
        assert pd.reason == jd.reason.replace("platform=tpu", "platform=cuda")
    assert decs[0].mode in (want, "fused_xla")


def test_engine_wiring_and_knob_gate():
    """maybe_compile_tpu wraps SortExec/WindowExec when the family knob is
    on, and leaves the plan untouched when it is off."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import EXECUTOR_ENGINE, TPU_MIN_ROWS, TPU_SORT_ENABLED, BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.sort_window import TpuSortStageExec, TpuWindowStageExec

    rng = np.random.default_rng(3)
    t = pa.table({
        "g": pa.array(rng.integers(0, 5, 500), pa.int64()),
        "v": pa.array(rng.integers(0, 99, 500), pa.int64()),
    })
    sql = ("SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v) rk "
           "FROM t ORDER BY v DESC, g LIMIT 20")
    for enabled in (True, False):
        cfg = BallistaConfig({EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0,
                              TPU_SORT_ENABLED: enabled})
        ctx = SessionContext(cfg)
        ctx.register_arrow_table("t", t, partitions=2)
        phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), cfg)
        nodes = [nd for nd in iter_plan(phys)
                 if isinstance(nd, (TpuSortStageExec, TpuWindowStageExec))]
        if enabled:
            assert {type(nd) for nd in nodes} == {TpuSortStageExec, TpuWindowStageExec}
            cpu = SessionContext(BallistaConfig({EXECUTOR_ENGINE: "cpu"}))
            cpu.register_arrow_table("t", t, partitions=2)
            assert ctx.execute_collect(phys).equals(cpu.sql(sql).collect())
        else:
            assert not nodes, phys.display()


def test_topk_knob_disables_fused_cut():
    """ballista.tpu.topk.enabled=false: a LIMIT sort still runs on the
    device, through the full sort (sort_full_materializations counts it)."""
    tbl = _adversarial_table()
    port = PKGS["port"]
    before = port.sw.counters_snapshot()["sort_full_materializations"]
    _parity(
        lambda pk, cfg: pk.sw.TpuSortStageExec(
            _src(pk, tbl), [pk.ex.SortKey(pk.ex.Column("i"))], 5, cfg),
        lambda pk: pk.ph.SortExec(_src(pk, tbl), [pk.ex.SortKey(pk.ex.Column("i"))], 5),
        "fused_pallas", TPU_TOPK_ENABLED=False)
    assert port.sw.counters_snapshot()["sort_full_materializations"] == before + 1


def test_device_error_in_sort_propagates(monkeypatch):
    """Only Unsupported falls back to the CPU operator: any other error in
    the device sort (a failed kernel launch) fails the query."""
    from ballista_tpu_torch.ops.cuda import sort_window

    def failed_launch(*a, **k):
        raise RuntimeError("segmented_sort launch failed: CUDA error 719")

    monkeypatch.setattr(sort_window, "_perm_full", failed_launch)
    port = PKGS["port"]
    tbl = _adversarial_table()
    cfg = _cfg(port, "fused_pallas")
    keys = [port.ex.SortKey(port.ex.Column("i")), port.ex.SortKey(port.ex.Column("f"))]
    devp = port.sw.TpuSortStageExec(_src(port, tbl), keys, None, cfg)
    with pytest.raises(RuntimeError, match="launch failed"):
        _collect(port, devp, cfg)
    assert devp.fallback_count == 0 and devp.tpu_count == 0
    wexprs = [port.ex.WindowFunction("rank", [], [port.ex.Column("i")], keys[1:], None)]
    devw = port.sw.TpuWindowStageExec(_src(port, tbl), wexprs,
                                      _window_schema(port, tbl, wexprs), cfg)
    with pytest.raises(RuntimeError, match="launch failed"):
        _collect(port, devw, cfg)
    assert devw.fallback_count == 0


def test_sort_stage_raises_without_cuda_unless_cpu_requested(monkeypatch):
    port = PKGS["port"]
    runtime.use_cpu(False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tbl = _adversarial_table()
    cfg = _cfg(port, "fused_xla")
    devp = port.sw.TpuSortStageExec(_src(port, tbl), [port.ex.SortKey(port.ex.Column("i"))],
                                    None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _collect(port, devp, cfg)
    assert devp.fallback_count == 0


# ---------------------------------------------------------------------------
# the whole slice: three SQL queries through both packages' SessionContext

SLICE_QUERIES = {
    "win_orders": (
        "SELECT o_orderkey, o_custkey, o_orderdate, o_totalprice, "
        "row_number() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rn, "
        "rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rk, "
        "count(*) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS cnt, "
        "max(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS mx "
        "FROM orders"),
    "topk_partsupp": (
        "SELECT ps_partkey, ps_suppkey, ps_supplycost, ps_availqty FROM partsupp "
        "ORDER BY ps_supplycost LIMIT 100"),
    "sort_customer": (
        "SELECT c_custkey, c_name, c_nationkey, c_acctbal FROM customer "
        "ORDER BY c_nationkey, c_acctbal DESC"),
}
# kernel calls per run at 8 files per table and 16 shuffle partitions
SLICE_CALLS = {
    "win_orders": {"segmented_sort": 32, "topk_select": 0, "segmented_scan": 80},
    "topk_partsupp": {"segmented_sort": 0, "topk_select": 8, "segmented_scan": 0},
    "sort_customer": {"segmented_sort": 16, "topk_select": 0, "segmented_scan": 0},
}
SLICE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0,
             "ballista.tpu.fusion.mode": "fused_pallas",
             "ballista.tpu.sort.pallas.max.rows": 1 << 20}


@pytest.fixture(scope="module")
def tpch8_dir(tmp_path_factory):
    """TPC-H SF0.01, seed 42, 8 files per table (the layout chip_smoke.py
    reads at SF10)."""
    from ballista_tpu_torch.testing.tpchgen import generate_tpch

    d = tmp_path_factory.mktemp("tpch8") / "sf001"
    generate_tpch(str(d), scale=0.01, seed=42, files_per_table=8)
    return str(d)


@pytest.mark.parametrize("name", list(SLICE_QUERIES))
def test_slice_queries_byte_identical_to_jax(name, tpch8_dir, kernel_calls):
    from ballista_tpu.client.context import SessionContext as JaxContext
    from ballista_tpu.config import BallistaConfig as JaxConfig
    from ballista_tpu.testing.tpchgen import register_tpch as jax_register
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.sort_window import TpuSortStageExec, TpuWindowStageExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql = SLICE_QUERIES[name]
    jctx = JaxContext(JaxConfig(dict(SLICE_CFG)))
    jax_register(jctx, tpch8_dir)
    want = jctx.sql(sql).collect()
    ctx = SessionContext(BallistaConfig(dict(SLICE_CFG)))
    register_tpch(ctx, tpch8_dir)
    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    got = ctx.execute_collect(phys)
    assert _column_bytes(got) == _column_bytes(want)
    stages = [n for n in iter_plan(phys)
              if isinstance(n, (TpuSortStageExec, TpuWindowStageExec))]
    assert stages
    for s in stages:
        assert s.tpu_count == s.output_partition_count() and s.fallback_count == 0
    assert kernel_calls["jax"] == SLICE_CALLS[name]
    assert kernel_calls["port"] == SLICE_CALLS[name]
    cpu = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(cpu, tpch8_dir)
    assert got.equals(cpu.sql(sql).collect())
