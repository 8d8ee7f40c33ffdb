#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ballista_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ballista_tpu_torch/ops/cuda/csrc with nvcc
   for sm_90a (one nvcc per source, started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (masked_group_reduce: q4's P=8, N=262144, G=8, and a
   multi-tile G=300): counts exact, sums within rtol 1e-4 / atol 1e-4 (the
   JAX package's own kernel bound), two runs bitwise identical; time the
   kernel, its plain version and one library call (torch.bincount) with
   CUDA events;
4. generate TPC-H with the port's generator (SF10 for q1/q6, SF1 for q4,
   seed 42; reused when a matching manifest exists) and run q1, q6 and q4
   through SessionContext with engine=tpu on the card — one warm-up, best
   of 3 — checking each answer against the port's engine=cpu (ints, dates
   and strings exact; float columns, which the CPU engine sums in float64
   where the card sums exact int64 cents, within rtol 1e-9), that every
   device stage ran on the card with no CPU fallback, that q4 launched the
   kernel, and that the fusion modes are the reference's (q4 fused_pallas,
   q1 fused_xla after the money gate); one more traced run per query gives
   the card's busy time and idle share (torch.profiler, checked first
   against CUDA events on a copy of known size; "null" when unchecked);
5. print one JSON line of kernel numbers, the card line, and last
   {"ok": true, "device": {...}}.

Options: --scale (q1/q6 scale factor, default 10), --q4-scale (default 1),
--data-dir (default build/tpch, listed in .gitignore).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 42
FILES_PER_TABLE = 8  # as bench.py generates its TPC-H data
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
QUERY_CONFIG = {
    "ballista.executor.engine": "tpu",
    # final merges are a few hundred partial rows: without this the final
    # stage declines to the CPU engine by design (ballista.tpu.min.rows)
    "ballista.tpu.min.rows": 0,
}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- data

def _manifest(scale: float) -> dict:
    return {"generator": "ballista_tpu_torch.testing.tpchgen", "scale": scale,
            "seed": SEED, "files_per_table": FILES_PER_TABLE}


def data_ready(path: str, scale: float) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f) == _manifest(scale)
    except (OSError, ValueError):
        return False


def start_generate(path: str, scale: float) -> subprocess.Popen | None:
    """Generate TPC-H at `scale` into `path` in a child process (None when a
    matching manifest says it is there already). The manifest is written
    last, so a cut run never looks complete."""
    if data_ready(path, scale):
        return None
    code = (
        "import json, os, sys\n"
        "from ballista_tpu_torch.testing.tpchgen import generate_tpch\n"
        "path, scale, seed, fpt, manifest = sys.argv[1], float(sys.argv[2]), "
        "int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]\n"
        "generate_tpch(path, scale=scale, seed=seed, files_per_table=fpt)\n"
        "with open(os.path.join(path, 'manifest.json.tmp'), 'w') as f:\n"
        "    f.write(manifest)\n"
        "os.replace(os.path.join(path, 'manifest.json.tmp'), "
        "os.path.join(path, 'manifest.json'))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, path, str(scale), str(SEED),
         str(FILES_PER_TABLE), json.dumps(_manifest(scale))], cwd=ROOT)


def wait_generate(proc: subprocess.Popen | None, path: str, scale: float) -> None:
    if proc is not None and proc.wait() != 0:
        raise RuntimeError(f"TPC-H generation at SF{scale} exited {proc.returncode}")
    if not data_ready(path, scale):
        raise RuntimeError(f"TPC-H data at {path} is incomplete")


# ---------------------------------------------------------------- kernels

def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_busy_ms(fn, iters: int = 1) -> float | None:
    """Milliseconds in which the card ran at least one kernel, copy or fill
    while `fn` ran `iters` times: the union of the device events of a
    torch.profiler trace taken with CPU and CUDA activity. None when the
    trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us / 1e3 if spans else None


def check_busy_method(dev) -> bool:
    """Hold device_busy_ms against CUDA events on copies of 1 GiB, where
    launch gaps are negligible: the two must agree within 10%, and neither
    may beat the copy's byte floor."""
    import torch

    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    events_ms = cuda_ms(lambda: dst.copy_(src), 10)
    busy = device_busy_ms(lambda: dst.copy_(src), 10)
    floor_ms = 2 * src.numel() * 4 / HBM_BYTES_PER_S * 1e3
    del src, dst
    ok = (busy is not None and abs(busy / 10 - events_ms) <= 0.1 * events_ms
          and min(busy / 10, events_ms) >= floor_ms)
    log(f"profiler busy check on a 1 GiB copy: events {events_ms:.4f} ms, profiler "
        f"{'none' if busy is None else f'{busy / 10:.4f}'} ms, byte floor {floor_ms:.4f} ms"
        f" -> {'trusted' if ok else 'NOT trusted: busy times reported as null'}")
    return ok


def kernel_phase(dev, busy_ok: bool) -> dict:
    """masked_group_reduce against its plain form at q4's shape and at a
    multi-tile G. Returns the q4-shape timing record."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    rng = np.random.default_rng(7)
    record = None
    for P, N, G in ((8, 262144, 8), (8, 262144, 300)):
        vals = torch.as_tensor(rng.uniform(-5, 5, (P, N)).astype(np.float32), device=dev)
        gid = torch.as_tensor(rng.integers(0, G, (P, N)).astype(np.int32), device=dev)
        mask = torch.as_tensor(rng.random((P, N)) < 0.7, device=dev)
        s1, c1 = ck.masked_group_reduce(vals, gid, mask, G)
        s2, c2 = ck.masked_group_reduce(vals, gid, mask, G)
        sp, cp = ck.masked_group_reduce_plain(vals, gid, mask, G)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(c1, c2)):
            raise AssertionError(f"masked_group_reduce G={G}: two runs differ bitwise")
        if not torch.equal(c1, cp):
            raise AssertionError(f"masked_group_reduce G={G}: counts differ from the plain form")
        if not torch.allclose(s1, sp, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"masked_group_reduce G={G}: sums differ from the plain form")
        err = float((s1 - sp).abs().max())
        log(f"masked_group_reduce P={P} N={N} G={G}: counts exact, "
            f"max_abs_err={err:.3e}, reruns bitwise identical")
        if record is not None:
            continue
        key = (gid.long() + torch.arange(P, device=dev)[:, None] * G).flatten()
        weights = torch.where(mask, vals, 0.0).flatten()
        ms = cuda_ms(lambda: ck.masked_group_reduce(vals, gid, mask, G), 50)
        plain_ms = cuda_ms(lambda: ck.masked_group_reduce_plain(vals, gid, mask, G), 10)
        library_ms = cuda_ms(lambda: torch.bincount(key, weights, minlength=P * G), 50)
        # the events above time the stream, launch gaps included; the
        # profiler gives the kernels' own device time
        busy = (device_busy_ms(lambda: ck.masked_group_reduce(vals, gid, mask, G), 20)
                if busy_ok else None)
        device_ms = None if busy is None else busy / 20
        n_bytes = P * N * (4 + 4 + 1) + P * G * (4 + 4)
        n_ops = 2 * P * N  # one f32 add and one int add per row
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        record = {
            "name": "masked_group_reduce", "route": "cuda",
            "source": "ballista_tpu_torch/ops/cuda/csrc/masked_group_reduce.cu",
            "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:125",
            "shape": [P, N, G], "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }
    return record


# ---------------------------------------------------------------- path

def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def compare_answers(dev_tbl, cpu_tbl, q: int) -> None:
    import numpy as np
    import pyarrow as pa

    if dev_tbl.schema != cpu_tbl.schema:
        raise AssertionError(f"q{q}: schema {dev_tbl.schema} != {cpu_tbl.schema}")
    if dev_tbl.num_rows != cpu_tbl.num_rows:
        raise AssertionError(f"q{q}: {dev_tbl.num_rows} rows != {cpu_tbl.num_rows}")
    for name, f in zip(dev_tbl.column_names, dev_tbl.schema):
        a = dev_tbl.column(name).combine_chunks()
        b = cpu_tbl.column(name).combine_chunks()
        if pa.types.is_floating(f.type):
            x = a.to_numpy(zero_copy_only=False)
            y = b.to_numpy(zero_copy_only=False)
            if not np.allclose(x, y, rtol=1e-9, atol=0.0, equal_nan=True):
                raise AssertionError(f"q{q}: column {name} differs: {x[:4]} vs {y[:4]}")
        elif not a.equals(b):
            raise AssertionError(f"q{q}: column {name} differs exactly")


def run_query(q: int, data_dir: str, dev, busy_ok: bool) -> dict:
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import DEVICE_CACHE, RUN_STATS, TpuStageExec
    from ballista_tpu_torch.plan.physical import HashJoinExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    cpu_ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(cpu_ctx, data_dir)
    t0 = time.time()
    cpu_tbl = cpu_ctx.sql(sql).collect()
    cpu_s = time.time() - t0

    ctx = SessionContext(BallistaConfig(dict(QUERY_CONFIG)))
    register_tpch(ctx, data_dir)
    rows = ctx.catalog.get("lineitem").statistics().num_rows or 0
    launches0 = ck.LAUNCHES["masked_group_reduce"]
    times, plan_times, runs = [], [], []
    for i in range(4):  # one warm-up, then best of 3
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        stages = [n for n in _walk(physical)
                  if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
        recs = RUN_STATS.stages()
        runs.append((stages, {s.fingerprint: dict(recs.get(_tag(s), {}))
                              for s in stages if isinstance(s, TpuStageExec)}))
        if i:
            times.append(wall)
            plan_times.append(plan_s)
        else:
            cold_wall = wall
        compare_answers(tbl, cpu_tbl, q)
    stages = [s for st, _ in runs for s in st]
    partial = [s for s in runs[0][0] if isinstance(s, TpuStageExec)]
    if not partial:
        raise AssertionError(f"q{q}: no device partial stage was planned")
    for s in stages:
        if s.tpu_count < 1 or s.fallback_count != 0:
            raise AssertionError(f"q{q}: {s.node_str()} did not run on the card "
                                 f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
    launches = ck.LAUNCHES["masked_group_reduce"] - launches0
    cold = runs[0][1][partial[0].fingerprint]
    best = min(range(3), key=lambda k: times[k])
    warm = runs[best + 1][1][partial[0].fingerprint]
    mode = warm.get("fusion_mode")
    want = {1: "fused_xla", 4: "fused_pallas", 6: "fused_xla"}[q]
    if mode != want:
        raise AssertionError(f"q{q}: fusion_mode {mode!r}, the reference picks {want!r}")
    if q == 4:
        if launches < 1:
            raise AssertionError("q4: masked_group_reduce was never launched")
        if not any(isinstance(op, HashJoinExec) for op in partial[0].ops):
            raise AssertionError("q4: the semi-join build was not collected onto the device stage")
    dt = DEVICE_CACHE.peek(partial[0].scan, dev)

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    # a warm run reads every column of the stage's cached table at least
    # once: a busy time below that byte floor means dropped events
    busy_floor_ms = (cold.get("device_bytes") or 0) / HBM_BYTES_PER_S * 1e3
    t0 = time.time()
    busy = device_busy_ms(one_run) if busy_ok else None
    traced_wall = time.time() - t0
    if busy is not None and busy < busy_floor_ms:
        log(f"q{q}: profiler busy {busy:.4f} ms is below the table's byte floor "
            f"{busy_floor_ms:.4f} ms: reported as null")
        busy = None
    return {
        "query": f"q{q}", "wall_s": times[best], "times_s": times,
        "plan_s": plan_times[best],
        "lineitem_rows": rows, "lineitem_rows_per_s": rows / times[best],
        "cold_wall_s": cold_wall, "fill_s": cold.get("fill_s"), "encode_s": cold.get("encode_s"),
        "upload_s": cold.get("upload_s"), "exec_s": warm.get("exec_s"),
        "fused_kernel_s": warm.get("fused_kernel_s"),
        "device_bytes": cold.get("device_bytes"), "fusion_mode": mode,
        "fusion_reason": warm.get("fusion_reason"),
        "stage_shape": list(dt.shape) if dt is not None else None,
        "kernel_launches": launches, "cpu_engine_s": cpu_s,
        "traced_wall_s": traced_wall, "device_busy_ms": busy,
        "busy_floor_ms": busy_floor_ms,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }


def _tag(stage) -> str:
    import zlib

    return f"stage_{zlib.crc32(stage.fingerprint.encode()):08x}"


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--q4-scale", type=float, default=1.0)
    ap.add_argument("--data-dir", default=os.path.join(ROOT, "build", "tpch"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this script runs the port on the card only")
        return 2
    sys.path.insert(0, ROOT)
    try:
        from ballista_tpu_torch.ops.cuda import build, cuda_kernels
    except ImportError as e:
        log(f"the port is not importable ({e}): run from the root of a checkout")
        return 2

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    scale_s = f"{args.scale:g}"
    big_dir = os.path.join(args.data_dir, f"sf{scale_s}")
    q4_dir = os.path.join(args.data_dir, f"sf{args.q4_scale:g}")
    procs = []
    try:
        t0 = time.time()
        big = start_generate(big_dir, args.scale)
        procs.append(big)
        small = (start_generate(q4_dir, args.q4_scale)
                 if q4_dir != big_dir else None)
        procs.append(small)

        tb = time.time()
        build.build_all()
        build_s = time.time() - tb
        for name, text in build.LOGS.items():
            for line in text.splitlines():
                log(f"nvcc {name}: {line}")
        log(f"kernels built in {build_s:.1f}s")

        busy_ok = check_busy_method(dev)
        krec = kernel_phase(dev, busy_ok)
        log(f"kernel phase done at {time.time() - t0:.1f}s")

        wait_generate(big, big_dir, args.scale)
        wait_generate(small, q4_dir, args.q4_scale)
        log(f"data ready at {time.time() - t0:.1f}s")

        # the main path: counts start at 0 here and are read just after
        cuda_kernels.reset_launches()
        results = [run_query(1, big_dir, dev, busy_ok), run_query(6, big_dir, dev, busy_ok),
                   run_query(4, q4_dir, dev, busy_ok)]
        launches = dict(cuda_kernels.LAUNCHES)
        scales = {"q1": args.scale, "q6": args.scale, "q4": args.q4_scale}
        for r in results:
            r["scale"] = scales[r["query"]]
            r["card"] = card
            print(json.dumps(r), flush=True)
        krec["launches"] = launches["masked_group_reduce"]
        if krec["launches"] < 1:
            raise AssertionError("the main path launched masked_group_reduce no time")
        log(f"path phase done at {time.time() - t0:.1f}s")
    except Exception:  # noqa: BLE001 — every phase failure is fatal
        traceback.print_exc()
        return 1
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    print(json.dumps({"kernels": [krec]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
