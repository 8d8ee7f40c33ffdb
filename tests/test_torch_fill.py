"""The port's cold path (the counterpart of tests/test_tpu_fill.py) on the
CPU forms (runtime.use_cpu()).

- the pipelined fill and the chunked upload (`ballista.tpu.fill.chunk_rows`,
  here 7 rows a slice through the two staging buffers) are byte-identical
  to the strict serial, whole-column fill; the fill records its encode and
  upload split; an unencodable column raises Unsupported from the pipeline;
- with `ballista.tpu.compile.overlap` on, every join build is prepared on
  a pool thread bound to the executor's card while the probe table fills,
  and on the caller's thread, after the fill, when it is off; TPC-H q3,
  q5 and q21 at SF0.01 answer byte-identically to the JAX package under
  every overlap and chunk setting and across settings;
- an Unsupported raised in a build, and an injected device OOM during a
  build, behave as on the serial path (the decline with its reason; the
  spill-and-retry rung);
- chunk_rows is ignored under a mesh (use_cpu(devices=8) with
  `ballista.tpu.collective.exchange`): sharded puts stay whole;
- RunStats keeps concurrent stage runs apart; the cold-path knobs are
  registered with the reference's defaults.

No counterpart: the reference's `on_spec` callback, its compile-ahead
thread (`test_compile_overlaps_slow_fill`, compile_overlap_s) and its
persistent XLA compile cache (`test_persistent_cache_roundtrip`) belong to
XLA, and the port compiles no stage program. Comparisons are exact (Arrow
`equals`, numpy bit equality).
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu_torch.config import (
    EXECUTOR_ENGINE,
    TPU_COMPILE_CACHE_DIR,
    TPU_COMPILE_OVERLAP,
    TPU_FILL_CHUNK_ROWS,
    TPU_FILL_THREADS,
    TPU_MIN_ROWS,
    BallistaConfig,
)
from ballista_tpu_torch.ops.cuda import hbm, runtime
from ballista_tpu_torch.ops.cuda import stage_compiler as sc
from ballista_tpu_torch.plan.physical import MemoryScanExec, TaskContext
from ballista_tpu_torch.plan.schema import DFSchema

from .conftest import iter_plan, tpch_query

BASE_CFG = {EXECUTOR_ENGINE: "tpu", TPU_MIN_ROWS: 0}


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu()
    yield
    runtime.use_cpu(*prev)


@pytest.fixture(autouse=True)
def _no_chaos_left():
    yield
    hbm.disarm_chaos()
    hbm._OOM_HINTS.clear()


def _mixed_table(n: int = 5_000) -> pa.Table:
    rng = np.random.default_rng(11)
    price = np.round(rng.uniform(1, 1000, n), 2)
    qty = rng.integers(1, 50, n).astype(np.int64)
    flag = rng.choice(["A", "N", "R"], n)
    day = rng.integers(8000, 11000, n).astype(np.int32)
    weight = rng.uniform(0.0, 1.0, n)
    ok = rng.random(n) > 0.5
    nullable = pa.array(
        [None if i % 7 == 0 else int(v) for i, v in enumerate(qty)], pa.int64()
    )
    return pa.table({
        "qty": qty,
        "price": price,                       # money lane (2-decimal f64)
        "flag": flag,                         # dictionary codes + LUT
        "day": pa.array(day, pa.date32()),
        "weight": weight,                     # true f64
        "ok": ok,
        "maybe": nullable,                    # validity plane
    })


def _scan(tbl: pa.Table, partitions: int = 3) -> MemoryScanExec:
    batches = tbl.to_batches(max_chunksize=max(1, tbl.num_rows // (partitions * 2)))
    return MemoryScanExec(DFSchema.from_arrow(tbl.schema), batches, partitions)


def _load(scan, **kw):
    ctx = TaskContext(BallistaConfig({}))
    return sc.DEVICE_CACHE._load(scan, [1 << 12, 1 << 14, 1 << 16], ctx,
                                 runtime.device(), **kw)


def _assert_tables_identical(a, b):
    assert a.kinds == b.kinds
    assert a.scales == b.scales
    assert a.dicts == b.dicts
    assert a.part_rows == b.part_rows
    assert a.nbytes == b.nbytes
    assert np.array_equal(a.mask.numpy(), b.mask.numpy())
    for ca, cb in zip(a.cols, b.cols):
        assert ca.dtype == cb.dtype and ca.shape == cb.shape
        assert np.array_equal(ca.numpy(), cb.numpy())
    for va, vb in zip(a.valids, b.valids):
        assert (va is None) == (vb is None)
        if va is not None:
            assert np.array_equal(va.numpy(), vb.numpy())


def test_pipelined_fill_byte_identical_to_serial():
    tbl = _mixed_table()
    serial = _load(_scan(tbl), fill_threads=1)
    piped = _load(_scan(tbl), fill_threads=4)
    _assert_tables_identical(serial, piped)


def test_chunked_upload_byte_identical(monkeypatch):
    slices = []
    real = sc._copy_slice

    def counted(src, dst, staging, device):
        slices.append(src.shape)
        return real(src, dst, staging, device)

    monkeypatch.setattr(sc, "_copy_slice", counted)
    tbl = _mixed_table()
    whole = _load(_scan(tbl), fill_threads=1)
    assert not slices
    chunked = _load(_scan(tbl), fill_threads=4, chunk_rows=7)
    _assert_tables_identical(whole, chunked)
    # every column and validity plane in [P, 7] slices, the last narrower
    P, N = whole.mask.shape
    planes = len(whole.cols) + sum(v is not None for v in whole.valids)
    assert len(slices) == planes * -(-N // 7)
    assert {s[0] for s in slices} == {P} and max(s[1] for s in slices) == 7


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_rows", [7, 1000, 1 << 12])
def test_chunked_upload_byte_identical_on_the_card(chunk_rows):
    """On the card the slices go through pinned buffers with asynchronous
    copies and per-buffer events: the table is bit-identical to the whole
    upload's, and the staging buffers are pinned."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    ctx = TaskContext(BallistaConfig({}))
    buckets = [1 << 12, 1 << 14, 1 << 16]
    tbl = _mixed_table(40_000)
    whole = sc.DEVICE_CACHE._load(_scan(tbl), buckets, ctx, dev, fill_threads=1)
    chunked = sc.DEVICE_CACHE._load(_scan(tbl), buckets, ctx, dev, fill_threads=4,
                                    chunk_rows=chunk_rows)
    staging = sc._Staging(dev)
    _, buf = staging.acquire(64)
    assert staging.cuda and buf.is_pinned()
    for a, b in zip(whole.cols + [whole.mask], chunked.cols + [chunked.mask]):
        assert a.device == b.device == dev
        assert torch.equal(a, b)
    for va, vb in zip(whole.valids, chunked.valids):
        assert (va is None) == (vb is None)
        if va is not None:
            assert torch.equal(va, vb)


def test_staging_buffers_alternate_and_grow():
    staging = sc._Staging(runtime.device())
    assert not staging.cuda
    s0, b0 = staging.acquire(64)
    s1, b1 = staging.acquire(32)
    s2, b2 = staging.acquire(128)
    assert (s0, s1, s2) == (0, 1, 0)
    assert b0.numel() == 64 and b1.numel() == 32 and b2.numel() == 128
    s3, b3 = staging.acquire(16)
    assert s3 == 1 and b3.data_ptr() == b1.data_ptr()


def test_fill_records_encode_upload_split():
    rec: dict = {}
    _load(_scan(_mixed_table()), fill_threads=2, stats=rec)
    assert rec["encode_s"] >= 0
    assert rec["upload_s"] >= 0


def test_unencodable_column_raises_unsupported_in_pipeline():
    from ballista_tpu_torch.ops.cuda.kernels import Unsupported

    tbl = pa.table({
        "a": np.arange(100, dtype=np.int64),
        "bad": pa.array([[1, 2]] * 100, pa.list_(pa.int64())),
    })
    with pytest.raises(Unsupported):
        _load(_scan(tbl), fill_threads=4)
    with pytest.raises(Unsupported):
        _load(_scan(tbl), fill_threads=4, chunk_rows=7)


def _ctx(pkg: str, tpch_dir: str, **extra):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    gen = __import__(f"{pkg}.testing.tpchgen", fromlist=["register_tpch"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig({**BASE_CFG, **extra}))
    gen.register_tpch(ctx, tpch_dir)
    return ctx


def _cold(pkg: str) -> None:
    """Drop the resident tables, builds and LUTs, so the next run fills
    and builds again (the reference keeps its compiled programs)."""
    if pkg == "ballista_tpu_torch":
        sc.clear_device_caches()
    else:
        import ballista_tpu.ops.tpu.stage_compiler as jsc

        jsc.DEVICE_CACHE.clear()
        jsc._LUT_CACHE.clear()
        jsc._BUILD_CACHE.clear()


def test_overlap_off_is_serial_and_correct(tpch_dir):
    from ballista_tpu_torch.testing.reference import compare_results, load_tables, run_reference

    sc.clear_device_caches()
    ctx = _ctx("ballista_tpu_torch", tpch_dir,
               **{TPU_COMPILE_OVERLAP: False, TPU_FILL_THREADS: 1})
    eng = ctx.sql(tpch_query(6)).collect()
    ref = run_reference(6, load_tables(tpch_dir))
    problems = compare_results(eng, ref, 6)
    assert not problems, "\n".join(problems)


SETTINGS = [(False, 0), (True, 0), (False, 7), (True, 7)]
_BASELINE: dict = {}  # q → the port's answer with overlap off, whole columns


@pytest.mark.parametrize("overlap,chunk", SETTINGS, ids=[f"overlap{int(o)}-chunk{c}"
                                                          for o, c in SETTINGS])
@pytest.mark.parametrize("q", [3, 5, 21])
def test_tpch_byte_identical_to_reference_under_cold_path_settings(q, overlap, chunk, tpch_dir):
    """Cold runs (every table filled and every build prepared anew) in both
    packages under one setting: the port's answer equals the reference's
    byte for byte, and the port's answer with overlap off and whole
    columns."""
    knobs = {TPU_COMPILE_OVERLAP: overlap, TPU_FILL_CHUNK_ROWS: chunk}
    if q not in _BASELINE:
        _cold("ballista_tpu_torch")
        _BASELINE[q] = _ctx("ballista_tpu_torch", tpch_dir,
                            **{TPU_COMPILE_OVERLAP: False}).sql(tpch_query(q)).collect()
    _cold("ballista_tpu_torch")
    got = _ctx("ballista_tpu_torch", tpch_dir, **knobs).sql(tpch_query(q)).collect()
    _cold("ballista_tpu")
    want = _ctx("ballista_tpu", tpch_dir, **knobs).sql(tpch_query(q)).collect()
    assert got.schema.equals(want.schema)
    assert got.equals(want)
    assert got.equals(_BASELINE[q])


def _stage_runs(ctx, sql: str):
    """Compile `sql`, run every partition; (answer, the device stages)."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

    phys = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    task = TaskContext(ctx.config)
    batches = [b for p in range(phys.output_partition_count())
               for b in phys.execute(p, task) if b.num_rows]
    stages = [n for n in iter_plan(phys) if isinstance(n, sc.TpuStageExec)]
    return pa.Table.from_batches(batches, schema=phys.schema()), stages


@pytest.mark.parametrize("overlap", [True, False])
def test_builds_run_beside_the_fill_on_the_card(overlap, tpch_dir, monkeypatch):
    """Overlap on: each of q5's builds runs on a `cuda-build` pool thread,
    inside the executor's card scope, and starts before the probe table's
    fill returns. Off: on the stage's own thread, after the fill."""
    events = []
    lock = threading.Lock()
    real_prepare = sc.TpuStageExec._prepare_build
    real_get = sc.DEVICE_CACHE.get
    real_on_card = sc._on_card

    def prepare(self, join, jidx, ctx, table_key, device, grace=None):
        with lock:
            events.append(("build", jidx, threading.current_thread().name))
        time.sleep(0.05)
        return real_prepare(self, join, jidx, ctx, table_key, device, grace)

    def get(*a, **k):
        with lock:
            events.append(("fill", None, threading.current_thread().name))
        time.sleep(0.2)  # a slow fill: the builds start under it
        out = real_get(*a, **k)
        with lock:
            events.append(("filled", None, threading.current_thread().name))
        return out

    cards = []

    def on_card(card):
        cards.append(card)
        return real_on_card(card)

    monkeypatch.setattr(sc.TpuStageExec, "_prepare_build", prepare)
    monkeypatch.setattr(sc.DEVICE_CACHE, "get", get)
    monkeypatch.setattr(sc, "_on_card", on_card)
    sc.clear_device_caches()
    ctx = _ctx("ballista_tpu_torch", tpch_dir, **{TPU_COMPILE_OVERLAP: overlap})
    _, stages = _stage_runs(ctx, tpch_query(5))
    assert sum(s.tpu_count for s in stages) >= 1
    assert sum(s.fallback_count for s in stages) == 0
    builds = [e for e in events if e[0] == "build"]
    assert len(builds) >= 4
    fill_threads = {e[2] for e in events if e[0] == "fill"}
    if overlap:
        assert all(name.startswith("cuda-build") for _, _, name in builds)
        assert cards and all(c == runtime.device(0) for c in cards)
        assert len(cards) == len(builds)
        # every build of the join stage was under way before its fill ended
        i_filled = max(i for i, e in enumerate(events) if e[0] == "filled")
        assert all(events.index(b) < i_filled for b in builds)
    else:
        assert not cards
        assert {name for _, _, name in builds} <= fill_threads
        # serial: the stage's fill ends before its first build
        first_build = events.index(builds[0])
        assert any(e[0] == "filled" for e in events[:first_build])


def test_build_records_its_wall_beside_fill(tpch_dir):
    """build_s is the builds' wall from the first submit to the last
    result; fill_s and build_modes are recorded as on the serial path."""
    for overlap in (False, True):
        sc.clear_device_caches()
        sc.RUN_STATS.clear()
        ctx = _ctx("ballista_tpu_torch", tpch_dir, **{TPU_COMPILE_OVERLAP: overlap})
        ctx.sql(tpch_query(5)).collect()
        recs = [r for r in sc.RUN_STATS.stages().values() if r.get("build_modes")]
        assert recs, overlap
        for r in recs:
            assert r["build_s"] >= 0 and r["fill_s"] >= 0
            assert all(m in ("direct", "sorted") for m in r["build_modes"])


@pytest.mark.parametrize("overlap", [True, False])
def test_unsupported_build_declines_as_on_the_serial_path(overlap, tpch_dir, monkeypatch):
    """An Unsupported raised in q5's second build declines the stage with
    that reason, whether the build ran on a pool thread or in turn; the
    query answers as engine=cpu does, and no build thread is left."""
    from ballista_tpu_torch.ops.cuda.kernels import Unsupported

    real_prepare = sc.TpuStageExec._prepare_build

    def prepare(self, join, jidx, ctx, table_key, device, grace=None):
        if jidx == 1:
            raise Unsupported("injected build decline")
        return real_prepare(self, join, jidx, ctx, table_key, device, grace)

    monkeypatch.setattr(sc.TpuStageExec, "_prepare_build", prepare)
    sc.clear_device_caches()
    ctx = _ctx("ballista_tpu_torch", tpch_dir, **{TPU_COMPILE_OVERLAP: overlap})
    got, stages = _stage_runs(ctx, tpch_query(5))
    declined = [s for s in stages if s.fallback_count]
    assert declined and all(s.decline_reason == "injected build decline" for s in declined)
    assert not [t for t in threading.enumerate() if t.name.startswith("cuda-build")]
    want = _ctx("ballista_tpu_torch", tpch_dir,
                **{EXECUTOR_ENGINE: "cpu"}).sql(tpch_query(5)).collect()
    assert got.equals(want)


def test_oom_in_a_build_retries_as_on_the_serial_path(tpch_dir, monkeypatch):
    """A device OOM injected in q5's first build (the chaos hbm_oom fault,
    armed from inside the build) takes the spill-and-retry rung with
    overlap on exactly as with it off: one retry, the stage on the device,
    and the same answer bit for bit."""
    real_encode = sc.TpuStageExec._encode_build
    fired = []

    def encode(self, join, ctx, device, grace):
        if not fired:
            fired.append(threading.current_thread().name)
            hbm.arm_chaos(1 << 40, oom_n=1)
            hbm.maybe_chaos_oom()
        return real_encode(self, join, ctx, device, grace)

    monkeypatch.setattr(sc.TpuStageExec, "_encode_build", encode)
    out = {}
    for overlap in (True, False):
        fired.clear()
        hbm.disarm_chaos()
        hbm._OOM_HINTS.clear()
        sc.clear_device_caches()
        sc.RUN_STATS.clear()
        ctx = _ctx("ballista_tpu_torch", tpch_dir, **{TPU_COMPILE_OVERLAP: overlap})
        got, stages = _stage_runs(ctx, tpch_query(5))
        assert fired and fired[0].startswith("cuda-build") == overlap
        assert sum(s.fallback_count for s in stages) == 0
        assert any(r.get("hbm_oom_retries") for r in sc.RUN_STATS.stages().values())
        out[overlap] = got
    assert out[True].equals(out[False])


def test_chunk_rows_ignored_under_a_mesh(tpch_dir, monkeypatch):
    """Under use_cpu(devices=8) with collective.exchange the stage's table
    shards by partition and its puts stay whole (no slice is staged); the
    answer is the unsharded, chunked run's."""
    slices = []
    real = sc._copy_slice

    def counted(*a):
        slices.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(sc, "_copy_slice", counted)
    knobs = {TPU_FILL_CHUNK_ROWS: 7}
    sc.clear_device_caches()
    flat = _ctx("ballista_tpu_torch", tpch_dir, **knobs).sql(tpch_query(1)).collect()
    assert slices
    slices.clear()
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu(devices=8)
    try:
        sc.clear_device_caches()
        ctx = _ctx("ballista_tpu_torch", tpch_dir,
                   **{**knobs, "ballista.tpu.collective.exchange": True})
        got, stages = _stage_runs(ctx, tpch_query(1))
        assert any(s.tpu_count for s in stages)
        resident = [sc.DEVICE_CACHE.peek(s.scan, sc._stage_mesh(ctx.config)) for s in stages]
        assert any(dt is not None and dt.mesh is not None for dt in resident)
    finally:
        runtime.use_cpu(*prev)
        sc.clear_device_caches()
    assert not slices
    assert got.equals(flat)


def test_run_stats_isolation_across_concurrent_stages():
    from ballista_tpu_torch.ops.cuda.stage_compiler import RunStats

    rs = RunStats()
    barrier = threading.Barrier(2)

    def stage(tag, key, value):
        with rs.run(tag) as rec:
            barrier.wait()
            rs.set(key, value, rec=rec)
            time.sleep(0.01)
            # thread-local routing: a bare set() lands in THIS run
            rs.set(f"{key}_tls", value + 1)

    t1 = threading.Thread(target=stage, args=("stage_a", "fill_s", 1.0))
    t2 = threading.Thread(target=stage, args=("stage_b", "exec_s", 2.0))
    t1.start(); t2.start(); t1.join(); t2.join()

    stages = rs.stages()
    assert stages["stage_a"] == {"fill_s": 1.0, "fill_s_tls": 2.0}
    assert stages["stage_b"] == {"exec_s": 2.0, "exec_s_tls": 3.0}
    merged = rs.snapshot()
    assert merged["fill_s"] == 1.0 and merged["exec_s"] == 2.0
    # outside a run scope a set() lands in the merged view (the port's
    # RunStats has no Mapping view or item assignment)
    rs.set("device_bytes", 7)
    assert rs.snapshot()["device_bytes"] == 7
    rs.clear()
    assert not rs.snapshot() and not rs.stages()


def test_fill_and_cache_knobs_registered():
    cfg = BallistaConfig({})
    assert int(cfg.get(TPU_FILL_THREADS)) == 0
    assert int(cfg.get(TPU_FILL_CHUNK_ROWS)) == 0
    assert bool(cfg.get(TPU_COMPILE_OVERLAP)) is True
    assert str(cfg.get(TPU_COMPILE_CACHE_DIR) or "") == ""


def test_concurrent_builds_of_one_key_make_one_entry():
    """The build and LUT caches fill one key at a time: 64 racing callers
    over 4 keys (more threads than cores, a short switch interval) run one
    fill a key and share its entry; a failed fill leaves the key free for
    the next caller."""
    import sys

    from ballista_tpu_torch.utils.lru import LruDict

    cache = LruDict(8)
    fills = sc._KeyedFills()
    calls = []
    got = []
    lock = threading.Lock()

    def fill(key):
        with lock:
            calls.append(key)
        time.sleep(0.01)
        return object()

    def caller(key):
        out = fills.get(cache, key, lambda: fill(key))
        with lock:
            got.append((key, out))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(i % 4,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert sorted(calls) == [0, 1, 2, 3] and len(cache) == 4
    assert len(got) == 64
    assert all(out is cache.get(key) for key, out in got)

    def boom():
        raise RuntimeError("fill failed")

    with pytest.raises(RuntimeError):
        fills.get(cache, "j", boom)
    assert fills.get(cache, "j", lambda: 5) == 5
