#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ballista_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ballista_tpu_torch/ops/cuda/csrc with nvcc
   for sm_90a (one nvcc per source, started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, two runs bitwise identical, and time the kernel,
   its plain version and one library call with CUDA events:
   masked_group_reduce at q4's P=8, N=262144, G=8 and at G=1, 32, 33, 300
   and 4096, P=1, N no multiple of a block's span or below one chunk, every
   row masked out, NaN/inf rows and ids outside [0, G) (counts exact, sums
   within rtol 1e-4 / atol 1e-4, the JAX package's own kernel bound, NaN
   exactly where the plain form has it; timed at G=8 and G=4096, library
   call torch.bincount); hash_probe at q5's
   P=8, N=8388608, T=32 (table in shared memory) and T=1<<18 with 30%
   absent keys (table read through the read-only cache), exact (library
   call torch.take); dict_filter at q12's P=8, N=2097152, T=8, and T=4096
   and T=1<<17 (the global-LUT regime), exact (library call torch.take);
   segmented_sort at the window shape [1, 2^20], at [1, 2^18] and
   [4, 4096], with ties and padding sentinels, and at the edges (rows
   below the 2048-lane tile, an odd count of merge passes, P > 1, rows of
   sentinels only, ties everywhere), exact, at most 12 launches a call
   (library: two stable torch.sort passes); topk_select at [1, 2^20] with
   k = 1, 100, 1000 and 4096 (through the full sort) and ties at the cut,
   and at P=3 over random, descending, all-tie and all-sentinel rows of
   1 to 2^20 lanes with k = 1, 100, 1000, 1024, 3000, 4096, exact, timed
   at k=100 on the top-k stage's operands and on descending keys
   (library: torch.topk(largest=False) of the key, timing only);
   segmented_scan at [1, 2^20]: i64 sum and max with a boundary about
   every 15 lanes, f64 max and min over NaN/+-0/+-inf, a row with no
   boundary, a boundary on every lane, and P > 1, rows below the tile
   and one lane, bitwise, one kernel and one memset a call; f32/f64
   sums within rtol 1e-5 / 1e-12 of the segment's sum of |v| (library:
   unsegmented torch.cumsum / cummax);
4. generate TPC-H with the port's generator (SF10 for q1/q6/q5/q12, SF1
   for q4, seed 42; reused when a matching manifest exists) and run q1,
   q6, q5 (auto mode), q12 (ballista.tpu.fusion.mode=fused_pallas) and q4
   through SessionContext with engine=tpu on the card — one warm-up, best
   of 3 — checking each answer against the port's engine=cpu (ints, dates
   and strings exact; float columns, which the CPU engine sums in float64
   where the card sums exact int64 cents, within rtol 1e-9), that every
   device stage ran on the card with no CPU fallback, that the device
   stage holds the expected joins, that the kernels of each path were
   launched (q4: masked_group_reduce; q5: hash_probe at least twice per
   run; q12: dict_filter at least once per run), and that the fusion
   modes are the reference's (q4 fused_pallas; q1, q6 fused_xla; q5
   requests fused_pallas and reports fused_xla after the money gate; q12
   fused_xla); the launch counts are set to 0 just before each query and
   read just after; one more traced run per query gives the card's busy
   time, idle share and six largest device ops (torch.profiler, checked
   first against CUDA events on a copy of known size; "null" when
   unchecked);
5. run the sort family at the same scale with
   ballista.tpu.sort.pallas.max.rows=1048576, fusion mode auto: win_orders
   (row_number, rank, count and max over PARTITION BY o_custkey ORDER BY
   o_orderdate), topk_partsupp (ORDER BY ps_supplycost LIMIT 100) and
   sort_customer (ORDER BY c_nationkey, c_acctbal DESC) — one warm-up,
   best of 3, one traced run — checking each answer equal to the port's
   engine=cpu answer exactly, in row order; every TpuWindowStageExec /
   TpuSortStageExec on the card for each of its partitions with no
   fallback; fused_pallas chosen by auto mode; and the launches of every
   run: 32 segmented_sort + 80 segmented_scan, 8 topk_select, 16
   segmented_sort;
6. print one JSON line of kernel numbers, the card line, and last
   {"ok": true, "device": {...}}.

Options: --scale (q1/q6/q5/q12 scale factor, default 10), --q4-scale
(default 1), --data-dir (default build/tpch, listed in .gitignore).
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


def device_busy_ms(fn, iters: int = 1, by_name: dict | None = None) -> float | None:
    """Milliseconds in which the card ran at least one kernel, copy or fill
    while `fn` ran `iters` times: the union of the device events of a
    torch.profiler trace taken with CPU and CUDA activity. None when the
    trace holds no device event. `by_name`, when given, receives each
    device event name's [total ms, count]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if by_name is not None:
        for e in events:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += (e.time_range.end - e.time_range.start) / 1e3
            acc[1] += 1
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


def _bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _timings(kernel, plain, library, busy_ok: bool, plain_iters: int = 10) -> dict:
    """CUDA-event means of the kernel's wrapper (50 launches), its plain
    form (`plain_iters`) and the library call (50); the device times of the kernel
    and of the library call from the checked profiler method (20 calls
    each), None when unchecked, with the kernel's device events per call
    by name (its launches, memsets and copies)."""
    by_name: dict = {}
    busy = device_busy_ms(kernel, 20, by_name=by_name) if busy_ok else None
    lib_busy = device_busy_ms(library, 20) if busy_ok else None
    return {"ms": cuda_ms(kernel, 50), "device_ms": None if busy is None else busy / 20,
            "plain_ms": cuda_ms(plain, plain_iters, warmup=1), "library_ms": cuda_ms(library, 50),
            "library_device_ms": None if lib_busy is None else lib_busy / 20,
            "device_events_per_call": {n[:60]: c / 20 for n, (_, c) in by_name.items()}}


def _kernel_launches(rec: dict) -> float | None:
    """Kernel launches per call in the traced timing, memsets and copies
    left out; None when the trace was not taken."""
    events = rec.get("device_events_per_call")
    if not events:
        return None
    return sum(c for n, c in events.items() if not n.startswith(("Memset", "Memcpy")))


def gather_phase(dev, busy_ok: bool) -> list[dict]:
    """hash_probe and dict_filter against their plain forms: exact, reruns
    bitwise identical, at the main path's shapes and at large tables.
    Returns one record per kernel (main-path shape, with the large-table
    timing under "large")."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    rng = np.random.default_rng(11)
    records = []
    smem = {k: ck.smem_max_entries(k) for k in ("hash_probe", "dict_filter")}
    # (P, N, T, share of table slots present): q5's nation join, and the
    # largest table the engine sends the kernel (pallas.max.probe.rows)
    # with 30% of its keys absent
    hp = {}
    for P, N, T, present in ((8, 8388608, 32, 25 / 32), (8, 8388608, 1 << 18, 0.7)):
        table_np = np.full(T, -1, np.int32)
        slots = rng.choice(T, size=int(T * present), replace=False)
        table_np[slots] = rng.permutation(len(slots)).astype(np.int32)
        table = torch.as_tensor(table_np, device=dev)
        keys = torch.randint(0, T, (P, N), dtype=torch.int32, device=dev)
        mask = torch.rand((P, N), device=dev) < 0.9
        r1, m1 = ck.hash_probe(keys, table, mask)
        r2, m2 = ck.hash_probe(keys, table, mask)
        rp, mp = ck.hash_probe_plain(keys, table, mask)
        torch.cuda.synchronize()
        if not (torch.equal(r1, r2) and torch.equal(m1, m2)):
            raise AssertionError(f"hash_probe T={T}: two runs differ bitwise")
        if not (torch.equal(r1, rp) and torch.equal(m1, mp)):
            raise AssertionError(f"hash_probe T={T}: differs from the plain form")
        regime = "shared" if T <= smem["hash_probe"] else "global"
        log(f"hash_probe P={P} N={N} T={T} ({regime} table): exact, reruns bitwise identical")
        keys_l = keys.long()
        rec = _timings(lambda: ck.hash_probe(keys, table, mask),
                       lambda: ck.hash_probe_plain(keys, table, mask),
                       lambda: torch.take(table, keys_l), busy_ok)
        # keys (4 B) and mask (1 B) read, rows (4 B) and matched (1 B)
        # written per row, the table read once; a compare and a select per row
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 10 + T * 4, 2 * P * N)
        rec.update(shape=[P, N, T], table=regime)
        hp[T] = rec
        del keys, keys_l, mask, r1, r2, rp, m1, m2, mp
    main = hp[32]
    main["large"] = hp[1 << 18]
    records.append({"name": "hash_probe", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/hash_probe.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:185",
                    "max_abs_err": 0.0, **main})

    df = {}
    for P, N, T in ((8, 2097152, 8), (8, 2097152, 4096), (8, 2097152, 1 << 17)):
        lut = torch.as_tensor(rng.random(T) < 0.4, device=dev)
        codes = torch.randint(0, T, (P, N), dtype=torch.int32, device=dev)
        mask = torch.rand((P, N), device=dev) < 0.9
        k1 = ck.dict_filter(codes, lut, mask)
        k2 = ck.dict_filter(codes, lut, mask)
        kp = ck.dict_filter_plain(codes, lut, mask)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"dict_filter T={T}: two runs differ bitwise")
        if not torch.equal(k1, kp):
            raise AssertionError(f"dict_filter T={T}: differs from the plain form")
        regime = "shared" if T <= smem["dict_filter"] else "global"
        log(f"dict_filter P={P} N={N} T={T} ({regime} LUT): exact, reruns bitwise identical")
        if T == 4096:
            continue
        codes_l = codes.long()
        rec = _timings(lambda: ck.dict_filter(codes, lut, mask),
                       lambda: ck.dict_filter_plain(codes, lut, mask),
                       lambda: torch.take(lut, codes_l), busy_ok)
        # codes (4 B) and mask (1 B) read, keep (1 B) written per row, the
        # LUT read once; a compare and an and per row
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 6 + T, 2 * P * N)
        rec.update(shape=[P, N, T], table=regime)
        df[T] = rec
    main = df[8]
    main["large"] = df[1 << 17]
    records.append({"name": "dict_filter", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/dict_filter.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:467",
                    "max_abs_err": 0.0, **main})
    return records


def _mgr_inputs(P: int, N: int, G: int, dev, rng, kind: str = "random"):
    """masked_group_reduce inputs: "random" (ids in [0, G), 70% of rows
    kept); "none" (every row masked out); "special" (NaN and +-inf
    values, some masked out); "outside" (ids below 0 and at or past G)."""
    import numpy as np
    import torch

    vals = rng.uniform(-5, 5, (P, N)).astype(np.float32)
    gid = rng.integers(0, G, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.7
    if kind == "none":
        mask[:] = False
    elif kind == "special":
        for v, share in ((np.nan, 0.001), (np.inf, 0.001), (-np.inf, 0.001)):
            vals[rng.random((P, N)) < share] = v
    elif kind == "outside":
        gid[rng.random((P, N)) < 0.2] = G
        gid[rng.random((P, N)) < 0.1] = -1
    return tuple(torch.as_tensor(x, device=dev) for x in (vals, gid, mask))


def kernel_phase(dev, busy_ok: bool) -> dict:
    """masked_group_reduce against its plain form at q4's shape and at the
    edges (G = 1, 8, 32, 33, 300, 4096; P = 1 and 8; N no multiple of a
    block's span, below one chunk; every row masked out; NaN and inf rows;
    ids outside [0, G)): counts exact, sums within rtol 1e-4 with NaN
    exactly where the plain form has it, reruns bitwise identical. Times
    G = 8 (q4) and G = 4096 (the engine's cap), each beside its bound and
    torch.bincount. Returns the q4-shape record, G = 4096 under "also"."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    rng = np.random.default_rng(7)
    timed = {}
    cases = [(8, 262144, G, "random") for G in (8, 4096, 1, 32, 33, 300)]
    cases += [(1, 262144, 33, "random"), (8, 100003, 8, "random"), (8, 100003, 4096, "random"),
              (3, 7, 8, "random"), (3, 7, 300, "random"), (8, 65536, 8, "none"),
              (8, 65536, 4096, "none"), (8, 65536, 8, "special"), (8, 65536, 300, "special"),
              (2, 65537, 8, "outside"), (2, 65537, 4096, "outside")]
    for P, N, G, kind in cases:
        vals, gid, mask = _mgr_inputs(P, N, G, dev, rng, kind)
        s1, c1 = ck.masked_group_reduce(vals, gid, mask, G)
        s2, c2 = ck.masked_group_reduce(vals, gid, mask, G)
        sp, cp = ck.masked_group_reduce_plain(vals, gid, mask, G)
        torch.cuda.synchronize()
        what = f"masked_group_reduce P={P} N={N} G={G} {kind}"
        if not (torch.equal(s1.view(torch.int32), s2.view(torch.int32)) and torch.equal(c1, c2)):
            raise AssertionError(f"{what}: two runs differ bitwise")
        if not torch.equal(c1, cp):
            raise AssertionError(f"{what}: counts differ from the plain form")
        if not (torch.equal(torch.isnan(s1), torch.isnan(sp))
                and torch.allclose(s1, sp, rtol=1e-4, atol=1e-4, equal_nan=True)):
            raise AssertionError(f"{what}: sums differ from the plain form")
        finite = torch.isfinite(sp)
        err = float((s1 - sp)[finite].abs().max()) if bool(finite.any()) else 0.0
        log(f"{what}: counts exact, max_abs_err={err:.3e}, reruns bitwise identical")
        if kind != "random" or P != 8 or N != 262144 or G not in (8, 4096):
            continue
        key = (gid.long() + torch.arange(P, device=dev)[:, None] * G).flatten()
        weights = torch.where(mask, vals, 0.0).flatten()
        rec = _timings(lambda: ck.masked_group_reduce(vals, gid, mask, G),
                       lambda: ck.masked_group_reduce_plain(vals, gid, mask, G),
                       lambda: torch.bincount(key, weights, minlength=P * G), busy_ok,
                       plain_iters=10 if G <= 32 else 2)
        # value, id and mask read (9 B a row), a sum and a count written a
        # cell; one f32 add and one int add per row
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 9 + P * G * 8, 2 * P * N)
        rec.update(shape=[P, N, G], max_abs_err=err)
        rec["launches_per_call"] = _kernel_launches(rec)
        timed[G] = rec
    main = timed[8]
    main["also"] = timed[4096]
    return {"name": "masked_group_reduce", "route": "cuda",
            "source": "ballista_tpu_torch/ops/cuda/csrc/masked_group_reduce.cu",
            "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:125", **main}


def _sort_inputs(P: int, N: int, dev, seed: int, a_hi: int = 1000, kind: str = "random"):
    """Triples with ties on a and on (a, b), positions 0..N-1 and a tail of
    (i64 max, i64 max) padding sentinels, as the sort stage pads. kind
    "ties": every lane equal but for pos; "sentinels": every lane a
    padding sentinel, pos included; "descending": a zero (the null-rank
    plane of a non-null key) and b falling, so every lane is a new
    minimum; "path": the top-k stage's operands, a zero and b a key in
    [0, a_hi), with 1,000,000 real rows (one partsupp file at SF10) when
    N = 2^20."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randint(0, a_hi, (P, N), generator=g, dtype=torch.int64)
    b = torch.randint(0, 3, (P, N), generator=g, dtype=torch.int64)
    pos = torch.arange(N, dtype=torch.int32).repeat(P, 1)
    if kind == "path":
        a[:] = 0
        b = torch.randint(0, a_hi, (P, N), generator=g, dtype=torch.int64)
    pad = N - 1_000_000 if kind == "path" and N > 1_000_000 else N // 8
    if pad:
        a[:, -pad:] = 2**63 - 1
        b[:, -pad:] = 2**63 - 1
    if kind == "ties":
        a[:] = 7
        b[:] = 3
    elif kind == "descending":
        a[:] = 0
        b[:] = torch.arange(N, 0, -1)
    elif kind == "sentinels":
        a[:] = 2**63 - 1
        b[:] = 2**63 - 1
        pos[:] = 2**31 - 1
    return a.to(dev), b.to(dev), pos.to(dev)


def _scan_inputs(N: int, dev, seed: int, dtype, p_boundary: float, specials: bool, P: int = 1):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if dtype in (torch.int32, torch.int64):
        v = rng.integers(-10**6, 10**6, (P, N))
    else:
        v = rng.uniform(-100.0, 100.0, (P, N))
        if specials:
            for val, share in ((np.nan, 0.01), (0.0, 0.02), (-0.0, 0.02),
                               (np.inf, 0.005), (-np.inf, 0.005)):
                v[rng.random((P, N)) < share] = val
    return (torch.as_tensor(v).to(dtype).to(dev),
            torch.as_tensor(rng.random((P, N)) < p_boundary).to(dev))


def _equal_bits(x, y) -> bool:
    import torch

    if x.dtype.is_floating_point:
        bits = torch.int32 if x.element_size() == 4 else torch.int64
        return torch.equal(x.view(bits), y.view(bits))
    return torch.equal(x, y)


def sort_family_phase(dev, busy_ok: bool) -> list[dict]:
    """segmented_sort, topk_select and segmented_scan against their plain
    forms at the sort family's path shapes: exact (float sums within rtol
    of the segment's sum of |v|), reruns bitwise identical. Returns one
    timing record per kernel, at the window path's shape."""
    import math

    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    records = []
    sort = {}
    # the path's shapes, then the edges: rows below the tile, an odd count
    # of merge passes, P > 1, rows of sentinels only, ties everywhere
    for P, N, kind in ((1, 1 << 20, "random"), (1, 1 << 18, "random"), (4, 4096, "random"),
                       (3, 512, "random"), (2, 2, "random"), (3, 1, "random"),
                       (1, 16384, "random"), (3, 1 << 15, "random"),
                       (2, 1 << 16, "sentinels"), (1, 1 << 20, "ties")):
        a, b, pos = _sort_inputs(P, N, dev, seed=N + P, kind=kind)
        r1 = ck.segmented_sort(a, b, pos)
        r2 = ck.segmented_sort(a, b, pos)
        rp = ck.segmented_sort_plain(a, b, pos)
        torch.cuda.synchronize()
        what = f"segmented_sort [{P}, {N}] {kind}"
        if not all(torch.equal(x, y) for x, y in zip(r1, r2)):
            raise AssertionError(f"{what}: two runs differ bitwise")
        if not all(torch.equal(x, y) for x, y in zip(r1, rp)):
            raise AssertionError(f"{what}: differs from the plain form")
        log(f"{what} ({ck.sort_plan(N)[1]} merge passes): exact, reruns bitwise identical")
        if P != 1 or kind != "random" or N < 1 << 18:
            continue

        def two_pass(a=a, b=b):  # two stable torch.sort passes, b then a
            i1 = torch.sort(b, dim=-1, stable=True).indices
            i2 = torch.sort(torch.gather(a, -1, i1), dim=-1, stable=True).indices
            return torch.gather(i1, -1, i2)

        rec = _timings(lambda a=a, b=b, pos=pos: ck.segmented_sort(a, b, pos),
                       lambda a=a, b=b, pos=pos: ck.segmented_sort_plain(a, b, pos),
                       two_pass, busy_ok)
        # each lane read once and written once (20 B each way); N log2 N
        # compares, the least any comparison sort needs, as operations
        rec["comparisons"] = P * N * int(math.log2(N))
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 40, rec["comparisons"])
        rec["shape"] = [P, N]
        rec["launches_per_call"] = _kernel_launches(rec)
        if rec["launches_per_call"] is not None and rec["launches_per_call"] > 12:
            raise AssertionError(f"segmented_sort [{P}, {N}]: {rec['launches_per_call']} "
                                 "launches a call, at most 12 expected")
        sort[N] = rec
        del a, b, pos, r1, r2, rp
    main = sort[1 << 20]
    main["also"] = sort[1 << 18]
    records.append({"name": "segmented_sort", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/segmented_sort.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:284",
                    "max_abs_err": 0.0, **main})

    # the path's shape with ties at every cut (50 values), then the edges:
    # random, descending, all ties and all sentinels; P = 3; rows from one
    # lane to 2^20; C from 128 to 2048 through the filter, 4096 through the
    # full sort
    N = 1 << 20
    cases = [(1, N, "random", (1, 100, 1000, 4096), 50)]
    cases += [(3, n, kind, (1, 100, 1000, 1024, 3000, 4096), 1000)
              for kind in ("random", "descending", "ties", "sentinels")
              for n in (1, 2, 512, 2048, 4096, N)]
    for P, n, kind, ks, a_hi in cases:
        a, b, pos = _sort_inputs(P, n, dev, seed=n + P + len(kind), a_hi=a_hi, kind=kind)
        for k in ks:
            r1 = ck.topk_select(a, b, pos, k)
            r2 = ck.topk_select(a, b, pos, k)
            rp = ck.topk_select_plain(a, b, pos, k)
            torch.cuda.synchronize()
            what = f"topk_select [{P}, {n}] {kind} k={k}"
            if not all(torch.equal(x, y) for x, y in zip(r1, r2)):
                raise AssertionError(f"{what}: two runs differ bitwise")
            if not all(x.shape == (P, min(k, n)) and torch.equal(x, y) for x, y in zip(r1, rp)):
                raise AssertionError(f"{what}: differs from the plain form")
        log(f"topk_select [{P}, {n}] {kind} k={ks}: exact, reruns bitwise identical")
        del a, b, pos
    # timed on the top-k stage's operands (a zero for a non-null key, b the
    # key: ps_supplycost in cents, pos the position), and on descending b
    topk = {}
    for kind in ("path", "descending"):
        a, b, pos = _sort_inputs(1, N, dev, seed=5, a_hi=100_000, kind=kind)
        k = 100
        rec = _timings(lambda: ck.topk_select(a, b, pos, k),
                       lambda: ck.topk_select_plain(a, b, pos, k),
                       lambda: torch.topk(b, k, dim=-1, largest=False), busy_ok)
        c = ck._topk_chunk(k, N)
        # a and b of every lane read (a is the null-rank plane, so b decides,
        # and pos is needed only where (a, b) passes), C triples written; one
        # compare a lane. PR 3's bound read pos too: 20 B a lane.
        rec["bound_ms"], rec["bound_by"] = _bound(N * 16 + c * 20, N)
        rec["bound_ms_20B_a_lane"] = _bound(N * 20 + k * 20, N)[0]
        rec.update(shape=[1, N], k=k, input=kind)
        rec["launches_per_call"] = _kernel_launches(rec)
        topk[kind] = rec
        del a, b, pos
    main = topk["path"]
    main["also"] = topk["descending"]
    records.append({"name": "topk_select", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/topk_select.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:351",
                    "max_abs_err": 0.0, **main})

    scan = {}
    sum_err = {}
    # (dtype, func, boundary share, specials, P, N): the path's shape, no
    # boundary across 256 tiles, then the edges: a boundary on every lane,
    # P > 1 over several tiles, rows below the tile, one lane
    cases = [(torch.int64, "sum", 1 / 15, False), (torch.int64, "max", 1 / 15, False),
             (torch.int64, "sum", 0.0, False), (torch.float64, "max", 1 / 15, True),
             (torch.float64, "min", 1 / 15, True), (torch.float64, "max", 0.0, True),
             (torch.float32, "sum", 1 / 15, False), (torch.float64, "sum", 1 / 15, False),
             (torch.float32, "sum", 0.0, False), (torch.float64, "sum", 0.0, False),
             (torch.int64, "sum", 1.0, False), (torch.float64, "max", 1.0, True),
             (torch.int32, "min", 0.001, False, 3, 1 << 14),
             (torch.float32, "max", 0.001, True, 3, 1 << 14),
             (torch.float64, "sum", 0.15, False, 3, 1024), (torch.int64, "max", 0.0, False, 2, 1)]
    for i, (dtype, func, p_b, specials, *shape) in enumerate(cases):
        P, n = shape or (1, N)
        v, f = _scan_inputs(n, dev, 30 + i, dtype, p_b, specials, P=P)
        r1 = ck.segmented_scan(v, f, func)
        r2 = ck.segmented_scan(v, f, func)
        rp = ck.segmented_scan_plain(v, f, func)
        torch.cuda.synchronize()
        what = (f"segmented_scan [{P}, {n}] {str(dtype)[6:]} {func} "
                f"boundary share {p_b:.4f}")
        if not _equal_bits(r1, r2):
            raise AssertionError(f"{what}: two runs differ bitwise")
        if func == "sum" and dtype.is_floating_point:
            rtol = 1e-5 if dtype == torch.float32 else 1e-12
            scale = ck.segmented_scan_plain(v.abs(), f, "sum")
            err = (r1 - rp).abs()
            if not bool((err <= rtol * scale).all()):
                raise AssertionError(f"{what}: beyond rtol {rtol} of the segment's sum of |v|")
            sum_err[f"[{P}, {n}] {str(dtype)[6:]} boundary share {p_b:.4f}"] = float(err.max())
            log(f"{what}: max_abs_err={float(err.max()):.3e} within rtol {rtol} "
                "of the segment's sum of |v|, reruns bitwise identical")
        else:
            if not _equal_bits(r1, rp):
                raise AssertionError(f"{what}: differs from the plain form")
            log(f"{what}{' (NaN, +-0, +-inf)' if specials else ''}: bitwise equal, "
                "reruns bitwise identical")
        if (dtype, func, p_b) in ((torch.int64, "sum", 1 / 15), (torch.float64, "max", 1 / 15)):
            # one kernel launch and one memset of the tile counters a call
            library = ((lambda v=v: torch.cumsum(v, dim=1)) if func == "sum"
                       else (lambda v=v: torch.cummax(v, dim=1)))
            rec = _timings(lambda v=v, f=f, func=func: ck.segmented_scan(v, f, func),
                           lambda v=v, f=f, func=func: ck.segmented_scan_plain(v, f, func),
                           library, busy_ok)
            # value (8 B) and flag (1 B) read, value (8 B) written; one op a lane
            rec["bound_ms"], rec["bound_by"] = _bound(N * 17, N)
            rec.update(shape=[1, N], dtype=str(dtype)[6:], func=func)
            rec["launches_per_call"] = _kernel_launches(rec)
            events = rec["device_events_per_call"]
            if events and (rec["launches_per_call"] > 1 or sum(
                    c for name, c in events.items() if name.startswith(("Memset", "Memcpy"))) > 1):
                raise AssertionError(f"{what}: device events per call {events}, one kernel "
                                     "and at most one memset expected")
            scan[(dtype, func)] = rec
        del v, f, r1, r2, rp
    main = scan[(torch.int64, "sum")]
    main["also"] = scan[(torch.float64, "max")]
    main["float_sum_max_abs_err"] = sum_err
    records.append({"name": "segmented_scan", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/segmented_scan.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:421",
                    "max_abs_err": 0.0, **main})
    return records


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


# per query: the fusion mode the reference reports, the config it runs
# with, the HashJoinExecs its device stage must hold (None: at least one),
# and the kernel each of its runs must launch, with the least count
PATHS = {
    1: ("fused_xla", {}, 0, None),
    6: ("fused_xla", {}, 0, None),
    # requests fused_pallas; the money sums fail the kernel's gate, while
    # hash_probe still runs for the nation (T=32) and region (T=4) joins
    5: ("fused_xla", {}, 4, ("hash_probe", 2)),
    12: ("fused_xla", {"ballista.tpu.fusion.mode": "fused_pallas"}, 1, ("dict_filter", 1)),
    4: ("fused_pallas", {}, None, ("masked_group_reduce", 1)),
}


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

    want, extra_cfg, n_joins, kernel = PATHS[q]
    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **extra_cfg}))
    register_tpch(ctx, data_dir)
    rows = ctx.catalog.get("lineitem").statistics().num_rows or 0
    times, plan_times, runs, run_launches = [], [], [], []
    for i in range(4):  # one warm-up, then best of 3
        before = dict(ck.LAUNCHES)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        run_launches.append({k: ck.LAUNCHES[k] - before[k] for k in before})
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
    cold = runs[0][1][partial[0].fingerprint]
    best = min(range(3), key=lambda k: times[k])
    warm = runs[best + 1][1][partial[0].fingerprint]
    mode = warm.get("fusion_mode")
    if mode != want:
        raise AssertionError(f"q{q}: fusion_mode {mode!r}, the reference picks {want!r}")
    if q == 5 and warm.get("fusion_reason") != "grouped agg, G=32 fits the kernel family":
        raise AssertionError(f"q5: fusion_reason {warm.get('fusion_reason')!r}")
    joins = sum(isinstance(op, HashJoinExec) for op in partial[0].ops)
    if (joins < 1) if n_joins is None else (joins != n_joins):
        raise AssertionError(f"q{q}: the device stage holds {joins} joins, "
                             f"expected {n_joins or 'at least 1'}")
    if kernel is not None:
        name, least = kernel
        per_run = [r[name] for r in run_launches]
        if min(per_run) < least:
            raise AssertionError(f"q{q}: {name} launched {per_run} times per run, "
                                 f"at least {least} expected")
    dt = DEVICE_CACHE.peek(partial[0].scan, dev)

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    # a warm run reads every column of the stage's cached table at least
    # once: a busy time below that byte floor means dropped events
    busy_floor_ms = (cold.get("device_bytes") or 0) / HBM_BYTES_PER_S * 1e3
    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    # where the traced run's device time went: the six largest event names
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
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
        "upload_s": cold.get("upload_s"), "build_s": cold.get("build_s"),
        "warm_build_s": warm.get("build_s"), "exec_s": warm.get("exec_s"),
        "fused_kernel_s": warm.get("fused_kernel_s"),
        "device_bytes": cold.get("device_bytes"), "fusion_mode": mode,
        "fusion_reason": warm.get("fusion_reason"),
        "stage_shape": list(dt.shape) if dt is not None else None,
        "kernel_launches_per_run": run_launches, "cpu_engine_s": cpu_s,
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "busy_floor_ms": busy_floor_ms,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }


# the sort family's queries, with the kernel launches each run must make
# (8 files per table, 16 shuffle partitions): win_orders has 16 window
# stages of two LSD sort passes and five scans each, topk_partsupp one
# top-k per file partition, sort_customer two passes per file partition
SORT_QUERIES = {
    "win_orders": (
        "SELECT o_orderkey, o_custkey, o_orderdate, o_totalprice, "
        "row_number() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rn, "
        "rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rk, "
        "count(*) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS cnt, "
        "max(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS mx "
        "FROM orders",
        {"segmented_sort": 32, "topk_select": 0, "segmented_scan": 80}),
    "topk_partsupp": (
        "SELECT ps_partkey, ps_suppkey, ps_supplycost, ps_availqty FROM partsupp "
        "ORDER BY ps_supplycost LIMIT 100",
        {"segmented_sort": 0, "topk_select": 8, "segmented_scan": 0}),
    "sort_customer": (
        "SELECT c_custkey, c_name, c_nationkey, c_acctbal FROM customer "
        "ORDER BY c_nationkey, c_acctbal DESC",
        {"segmented_sort": 16, "topk_select": 0, "segmented_scan": 0}),
}
SORT_CONFIG = {**QUERY_CONFIG, "ballista.tpu.sort.pallas.max.rows": 1 << 20}


def run_sort_query(name: str, data_dir: str, dev, busy_ok: bool) -> dict:
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.sort_window import TpuSortStageExec, TpuWindowStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql, want_launches = SORT_QUERIES[name]
    cpu_ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(cpu_ctx, data_dir)
    t0 = time.time()
    cpu_tbl = cpu_ctx.sql(sql).collect()
    cpu_s = time.time() - t0
    del cpu_ctx

    ctx = SessionContext(BallistaConfig(dict(SORT_CONFIG)))
    register_tpch(ctx, data_dir)
    times, plan_times, kernel_s, run_launches, modes = [], [], [], [], []
    for i in range(4):  # one warm-up, then best of 3
        ck.reset_launches()
        k0 = RUN_STATS.snapshot().get("sort_kernel_s", 0.0)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        run_launches.append(dict(ck.LAUNCHES))
        stats = RUN_STATS.snapshot()
        kernel_s.append(stats.get("sort_kernel_s", 0.0) - k0)
        modes.append((stats.get("fusion_mode"), stats.get("fusion_reason")))
        stages = [n for n in _walk(physical)
                  if isinstance(n, (TpuSortStageExec, TpuWindowStageExec))]
        if not stages:
            raise AssertionError(f"{name}: no sort or window stage was claimed")
        for st in stages:
            if st.tpu_count != st.output_partition_count() or st.fallback_count != 0:
                raise AssertionError(
                    f"{name}: {st.node_str()} ran {st.tpu_count} of "
                    f"{st.output_partition_count()} partitions on the card, "
                    f"{st.fallback_count} on the CPU")
        if not tbl.equals(cpu_tbl):
            raise AssertionError(f"{name}: the answer differs from the CPU engine's")
        got = {k: run_launches[-1][k] for k in want_launches}
        if got != want_launches:
            raise AssertionError(f"{name}: launches {got}, expected {want_launches}")
        if modes[-1][0] != "fused_pallas":
            raise AssertionError(f"{name}: auto mode chose {modes[-1]}, expected fused_pallas")
        if i:
            times.append(wall)
            plan_times.append(plan_s)
        else:
            cold_wall = wall
    log(f"{name}: equal to the CPU engine in row order, {len(stages)} stage(s) x "
        f"{stages[0].output_partition_count()} partitions on the card, "
        f"fused_pallas ({modes[-1][1]}), launches per run {got}")
    best = min(range(3), key=lambda k: times[k])

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    t0 = time.time()
    by_name: dict = {}
    ck.reset_launches()
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    traced_launches = dict(ck.LAUNCHES)
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    return {
        "query": name, "wall_s": times[best], "times_s": times, "plan_s": plan_times[best],
        "cold_wall_s": cold_wall, "sort_kernel_s": kernel_s[best + 1],
        "sort_kernel_s_runs": kernel_s, "rows_out": cpu_tbl.num_rows,
        "fusion_mode": modes[best + 1][0], "fusion_reason": modes[best + 1][1],
        "kernel_launches_per_run": run_launches, "traced_launches": traced_launches,
        "cpu_engine_s": cpu_s, "traced_wall_s": traced_wall, "device_busy_ms": busy,
        "top_device_ops": top_ops,
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
        krecs = ([kernel_phase(dev, busy_ok)] + gather_phase(dev, busy_ok)
                 + sort_family_phase(dev, busy_ok))
        log(f"kernel phase done at {time.time() - t0:.1f}s")

        wait_generate(big, big_dir, args.scale)
        wait_generate(small, q4_dir, args.q4_scale)
        log(f"data ready at {time.time() - t0:.1f}s")

        # the main paths: the counts are set to 0 just before each query
        # and read just after it
        launches = {}
        for q, path_dir, scale in ((1, big_dir, args.scale), (6, big_dir, args.scale),
                                   (5, big_dir, args.scale), (12, big_dir, args.scale),
                                   (4, q4_dir, args.q4_scale)):
            cuda_kernels.reset_launches()
            r = run_query(q, path_dir, dev, busy_ok)
            r["launches"] = launches[q] = dict(cuda_kernels.LAUNCHES)
            r["scale"] = scale
            r["card"] = card
            print(json.dumps(r), flush=True)
            log(f"q{q} done at {time.time() - t0:.1f}s")
        # the sort family, same data; counts set to 0 just before each run
        for name in SORT_QUERIES:
            cuda_kernels.reset_launches()
            r = run_sort_query(name, big_dir, dev, busy_ok)
            # every run's launches, the traced run's included
            r["launches"] = launches[name] = {
                k: sum(run[k] for run in r["kernel_launches_per_run"]) + r["traced_launches"][k]
                for k in cuda_kernels.LAUNCHES}
            r["scale"] = args.scale
            r["card"] = card
            print(json.dumps(r), flush=True)
            log(f"{name} done at {time.time() - t0:.1f}s")
        path_of = {"masked_group_reduce": (4,), "hash_probe": (5,), "dict_filter": (12,),
                   "segmented_sort": ("win_orders", "sort_customer"),
                   "topk_select": ("topk_partsupp",), "segmented_scan": ("win_orders",)}
        for krec in krecs:
            krec["launches"] = sum(launches[q][krec["name"]] for q in path_of[krec["name"]])
            if krec["launches"] < 1:
                raise AssertionError(f"the main path launched {krec['name']} no time")
        log(f"path phase done at {time.time() - t0:.1f}s")
    except Exception:  # noqa: BLE001 — every phase failure is fatal
        traceback.print_exc()
        return 1
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    print(json.dumps({"kernels": krecs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
