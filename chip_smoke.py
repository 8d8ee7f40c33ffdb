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
   P=8, N=8388608, T=32, at q21's supplier join at SF1 (its stage's
   [8, 2^20], T=2^14, 10,000 keys present) and at SF10 (T=2^17, 100,000
   keys), at T=2^18 with 30% absent keys (the engine's cap), and on both
   sides of every regime boundary (T = 12288, S, 9/4 S and 8S, S one
   block's opt-in shared memory in entries), each in the regime
   hash_probe_regime picks, exact (library call torch.take); dict_filter
   at q12's P=8, N=2097152, T=8, and T=4096
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
6. the sorted aggregation: q3, q10 and q13 at --scale, q9 and q21 at
   --q4-scale (SORTED_QUERIES says why), auto mode but q21 under
   fused_pallas — one warm-up, best of 3, one traced run — each answer
   checked against the port's engine=cpu as in phase 4, every device
   stage on the card with no fallback, at least one partial stage of each
   run sorted, q9 holding a sorted-mode join build and q21 launching
   hash_probe in every run; the stages' group counts, capacities, live
   rows and sort times recorded; then q1 under
   ballista.tpu.fusion.mode=staged, byte-identical to fused_xla with its
   span times, and device shuffle routing: lineitem grouped by l_orderkey
   under a hand-built hash ShuffleWriterExec of 16 partitions, every
   written row hashing on the host (ops/hashing) to its own partition and
   the rows together equal to the engine=cpu answer (both at --q4-scale);
   then q21 at --scale under fused_pallas, cold and best of 3 warm, its
   answer equal to fused_xla's on the card exactly (rows and order), its
   supplier probe (T=2^17 at SF10) launching hash_probe in the regime
   hash_probe_regime picks in every run, with the (P, N, T, regime, C) of
   each launch recorded;
   phases 4-6 run with the host spill pool off, so an evicted table is
   dropped as before the pool existed;
7. out of core, with the spill pool on: (a) q3 with hbm_oom chaos armed
   (the first upload raises once) spills, retries once and answers as in
   phase 6 (floats within rtol 1e-9), its peak device memory recorded;
   (b) a real torch.cuda.OutOfMemoryError: q1's and q6's tables resident,
   one blocker tensor holding the card's free memory less a margin between
   (a)'s peak less the residents and a cold whole q3 run's peak, q3's
   first attempt runs out of memory, the spill of the residents makes room
   and the retry answers as in phase 6; (c) q1, q6,
   q1 under a budget that holds one of their tables: q6's fill spills q1's
   table to host buffers and the second q1 restores it with no encode,
   every plane's CRC-32 unchanged, answers equal to phase 4's exactly;
   (d) q5 at its working set (phase 4's admission reason) less 1 byte: a
   grace split into 4 sub-buckets, one cold run, best of 3, one traced
   run, answers equal to phase 4's device and CPU answers (revenue within
   rtol 1e-9), no fallback, hash_probe twice per sub-run; then at
   --q4-scale (e) q5 at a budget that needs 16 sub-buckets (depth 2),
   equal to its whole run, and (f) the round trip of (c) through the disk
   tier (host tier cut to 1 byte), leaving no .tmp file. Chaos is disarmed,
   the blocker freed and every cache cleared in `finally`;
8. print one JSON line of kernel numbers, the card line, and last
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
    # phases 4-6 evict cold tables by dropping them, as they did before the
    # spill pool existed; phase 7 turns the pool on where it tests it
    "ballista.tpu.hbm.spill.enabled": False,
}
# phase 7's spill pool: on, with host buffers large enough that no table
# reaches the disk tier unless a check asks for it
SPILL_CONFIG = {**QUERY_CONFIG, "ballista.tpu.hbm.spill.enabled": True,
                "ballista.tpu.hbm.spill.host.bytes": 64 << 30}


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
    Returns one record per kernel at its main-path shape, with hash_probe's
    other tables under "tables" and dict_filter's large LUT under "large"."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    rng = np.random.default_rng(11)
    records = []
    optin = ck.hash_probe_smem_optin(dev)
    s_max = ck.hash_probe_block_max(optin)
    cut = s_max * ck.HP_SPLIT_MAX_QUARTERS // 4  # the split/cluster boundary
    log(f"hash_probe: opt-in shared memory {optin} B a block, S = {s_max} entries")
    # (label, P, N, T, share of table slots present): q5's nation join;
    # q21's supplier join at SF1 (its stage's [8, 2^20] lineitem stack,
    # 10,000 suppliers in 2^14 slots), the same table at [8, 2^23], and at
    # SF10 (100,000 suppliers in 2^17 slots); the largest table the engine
    # sends the kernel (pallas.max.probe.rows) with 30% of its keys absent;
    # and a table on each side of every regime boundary
    cases = [("q5_nation", 8, 8388608, 32, 25 / 32),
             ("q21_supplier_sf1", 8, 1048576, 1 << 14, 10000 / (1 << 14)),
             ("T=2^14", 8, 8388608, 1 << 14, 10000 / (1 << 14)),
             ("q21_supplier_sf10", 8, 8388608, 1 << 17, 100000 / (1 << 17)),
             ("engine_cap", 8, 8388608, 1 << 18, 0.7)]
    cases += [(f"edge {label}", 8, 8388608, T, 0.7) for label, T in (
        ("12288", 12288), ("12289", 12289), ("S", s_max), ("S+1", s_max + 1),
        ("9S/4", cut), ("9S/4+1", cut + 1), ("8S", 8 * s_max), ("8S+1", 8 * s_max + 1))]
    hp = {}
    for label, P, N, T, present in cases:
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
            raise AssertionError(f"hash_probe {label} T={T}: two runs differ bitwise")
        if not (torch.equal(r1, rp) and torch.equal(m1, mp)):
            raise AssertionError(f"hash_probe {label} T={T}: differs from the plain form")
        regime, cluster = ck.hash_probe_regime(T, optin)
        log(f"hash_probe {label} P={P} N={N} T={T} ({regime} regime, C={cluster}): exact, "
            "reruns bitwise identical")
        keys_l = keys.long()
        rec = _timings(lambda: ck.hash_probe(keys, table, mask),
                       lambda: ck.hash_probe_plain(keys, table, mask),
                       lambda: torch.take(table, keys_l), busy_ok)
        # keys (4 B) and mask (1 B) read, rows (4 B) and matched (1 B)
        # written per row, the table read once; a compare and a select per row
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 10 + T * 4, 2 * P * N)
        rec.update(label=label, shape=[P, N, T], regime=regime, cluster=cluster,
                   present=len(slots))
        log(f"hash_probe {label}: {rec['ms']:.4f} ms (device {rec['device_ms']}), bound "
            f"{rec['bound_ms']:.4f} ms, torch.take {rec['library_ms']:.4f} ms (device "
            f"{rec['library_device_ms']})")
        hp[label] = rec
        del keys, keys_l, mask, r1, r2, rp, m1, m2, mp
    main = hp.pop("q5_nation")
    main["tables"] = list(hp.values())
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
        regime = "shared" if T <= ck.smem_max_entries("dict_filter") else "global"
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


def run_query(q: int, data_dir: str, dev, busy_ok: bool, answers: dict | None = None) -> dict:
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
    if answers is not None:
        answers[q] = (tbl, cpu_tbl)  # the device answer of the last timed run
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
        "hbm_plan_reason": cold.get("hbm_plan_reason"),
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


# the sorted aggregation's queries, auto mode, with the data they run on
# ("big": --scale; "small": the q4 data, --q4-scale) and their config.
# q9 and q21 run on the small data: the port's engine=cpu takes 26 s (q9)
# and 17 s (q21) for their reference answers at SF1 on the H100 machine's
# host, and grows about tenfold to SF10, more than the run's time limit
# holds beside the other phases. q21 runs under
# fused_pallas: its group key s_name has 10,000 names at SF1 (100,000 at
# SF10), past the kernel family's 4096 groups, so auto mode takes fused_xla,
# which probes through plain gathers; fused_pallas sends its supplier and
# nation probes through hash_probe.
SORTED_QUERIES = {
    3: ("big", {}),
    9: ("small", {}),
    10: ("big", {}),
    13: ("big", {}),
    21: ("small", {"ballista.tpu.fusion.mode": "fused_pallas"}),
}


def run_sorted_query(q: int, data_dir: str, dev, busy_ok: bool, extra_cfg: dict,
                     answers: dict | None = None) -> dict:
    """One query of the sorted aggregation's phase: the port's engine=cpu
    answer, then one warm-up and best of 3 with engine=tpu, each checked
    against it, every device stage on the card with no fallback and at
    least one partial stage sorted; one more, traced, run."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    cpu_ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(cpu_ctx, data_dir)
    t0 = time.time()
    cpu_tbl = cpu_ctx.sql(sql).collect()
    cpu_s = time.time() - t0
    del cpu_ctx

    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **extra_cfg}))
    register_tpch(ctx, data_dir)
    times, plan_times, run_launches, sorted_recs = [], [], [], []
    for i in range(4):  # one warm-up, then best of 3
        before = dict(ck.LAUNCHES)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        run_launches.append({k: ck.LAUNCHES[k] - before[k] for k in before})
        compare_answers(tbl, cpu_tbl, q)
        stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
        partial = [s for s in stages if isinstance(s, TpuStageExec)]
        if not partial:
            raise AssertionError(f"q{q}: no device partial stage was planned")
        for s in stages:
            if s.tpu_count < 1 or s.fallback_count != 0:
                raise AssertionError(f"q{q}: {s.node_str()} did not run on the card "
                                     f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
        recs = RUN_STATS.stages()
        srt = [dict(recs[_tag(s)]) for s in partial if "n_seg" in recs.get(_tag(s), {})]
        if not srt:
            raise AssertionError(f"q{q}: no partial stage took the sorted aggregation")
        sorted_recs.append(srt)
        if i:
            times.append(wall)
            plan_times.append(plan_s)
        else:
            cold_wall = wall
    best = min(range(3), key=lambda k: times[k])
    warm = sorted_recs[best + 1]
    if q == 9 and not any("sorted" in r.get("build_modes", ()) for r in warm):
        raise AssertionError(f"q9: no sorted-mode join build ({[r.get('build_modes') for r in warm]})")
    if q == 21 and min(r["hash_probe"] for r in run_launches) < 1:
        raise AssertionError(f"q21: hash_probe launched {[r['hash_probe'] for r in run_launches]}"
                             " times per run, at least 1 expected")
    log(f"q{q}: equal to the CPU engine, {len(warm)} sorted stage(s) "
        f"(n_seg {[r['n_seg'] for r in warm]}, C {[r['seg_capacity'] for r in warm]}, "
        f"builds {[r.get('build_modes') for r in warm]}), launches per run "
        f"{[{k: v for k, v in r.items() if v} for r in run_launches]}")

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    keep = ("n_seg", "seg_capacity", "live_rows", "sort_s", "fused_kernel_s", "exec_s",
            "build_s", "build_modes", "fusion_mode", "fusion_reason")
    if answers is not None:
        answers[q] = (tbl, cpu_tbl)
    return {
        "query": f"q{q}", "wall_s": times[best], "times_s": times, "plan_s": plan_times[best],
        "cold_wall_s": cold_wall, "rows_out": cpu_tbl.num_rows,
        "sorted_stages": [{k: r.get(k) for k in keep} for r in warm],
        "cold_sorted_stages": [{k: r.get(k) for k in keep} for r in sorted_recs[0]],
        "kernel_launches_per_run": run_launches, "cpu_engine_s": cpu_s,
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }


def q21_large_check(data_dir: str, scale: float, dev, busy_ok: bool) -> dict:
    """q21 at --scale (SF10: 100,000 suppliers, a 2^17-entry supplier
    table) under ballista.tpu.fusion.mode=fused_pallas, against the same
    query under fused_xla on the card, whose probes are plain gathers: the
    engine=cpu answer takes about 170 s at SF10, and q21's answer is counts
    and names, so the two must be equal exactly, rows and order. The
    fused_xla reference runs first, both with a device collect budget of
    2^26 build rows; then the launch counts are set to 0
    and fused_pallas runs cold, three times warm (best of 3) and once
    traced, each answer checked, every device stage on the card with no
    fallback, and the supplier probe launching hash_probe with its table in
    the regime hash_probe_regime picks for it, in every run."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", "q21.sql")) as f:
        sql = f.read()

    def session(mode: str):
        # the semi and anti subqueries build over lineitem with a join
        # filter (60M rows at SF10): past the default collect budget of
        # 16M rows they become partitioned joins, which no device stage
        # claims; at 2^26 rows they collect, as they do at SF1
        ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, "ballista.tpu.fusion.mode": mode,
                                             "ballista.tpu.broadcast.join.threshold.rows": 1 << 26}))
        register_tpch(ctx, data_dir)
        return ctx

    def run(ctx):
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
        partial = [st for st in stages if isinstance(st, TpuStageExec)]
        if not partial:
            raise AssertionError("q21 large: no device partial stage was planned")
        for st in stages:
            if st.tpu_count < 1 or st.fallback_count != 0:
                raise AssertionError(f"q21 large: {st.node_str()} did not run on the card "
                                     f"(device_runs={st.tpu_count}, "
                                     f"fallbacks={st.fallback_count})")
        recs = RUN_STATS.stages()
        return tbl, wall, [dict(recs.get(_tag(st), {})) for st in partial]

    ref, ref_wall, _ = run(session("fused_xla"))
    ctx = session("fused_pallas")
    T = 1 << int(10000 * scale).bit_length()  # the direct table over s_suppkey 1..10000 SF
    want = ck.hash_probe_regime(T, ck.hash_probe_smem_optin(dev))
    ck.reset_launches()
    walls, run_probes, stage_recs = [], [], []
    for i in range(4):  # cold, then best of 3
        before = dict(ck.HASH_PROBE_LAUNCHES)
        tbl, wall, recs = run(ctx)
        probes = {k: v - before.get(k, 0) for k, v in ck.HASH_PROBE_LAUNCHES.items()
                  if v != before.get(k, 0)}
        if not tbl.equals(ref):
            raise AssertionError(f"q21 large: run {i} under fused_pallas differs from fused_xla")
        if not any(k[2] == T and k[3:] == want for k in probes):
            raise AssertionError(f"q21 large: no hash_probe launch at T={T} in the {want} "
                                 f"regime in run {i}: {probes}")
        walls.append(wall)
        run_probes.append([[*k, v] for k, v in sorted(probes.items())])
        stage_recs.append(recs)
    best = min(range(1, 4), key=lambda k: walls[k])

    def one_run():
        run(ctx)

    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    launches = dict(ck.LAUNCHES)
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    keep = ("n_seg", "seg_capacity", "live_rows", "sort_s", "fused_kernel_s", "exec_s",
            "build_s", "build_modes", "fusion_mode", "fusion_reason", "device_bytes")
    log(f"q21 large: fused_pallas equal to fused_xla in every run (rows {ref.num_rows}), "
        f"cold {walls[0]:.2f}s, warm {walls[1:]}, hash_probe launches (P, N, T, regime, C, "
        f"count) per run {run_probes}")
    return {
        "query": "q21_large", "supplier_table": T, "wall_s": walls[best], "times_s": walls[1:],
        "cold_wall_s": walls[0], "fused_xla_cold_wall_s": ref_wall, "rows_out": ref.num_rows,
        "hash_probe_per_run": run_probes, "supplier_regime": list(want),
        "stages": [{k: r.get(k) for k in keep} for r in stage_recs[best]],
        "cold_stages": [{k: r.get(k) for k in keep} for r in stage_recs[0]],
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
        "launches": launches,
    }


def staged_check(data_dir: str) -> dict:
    """q1 under ballista.tpu.fusion.mode=staged on the card: byte-identical
    to the same query under fused_xla, with the per-span split recorded."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", "q1.sql")) as f:
        sql = f.read()
    out = {}
    for mode in ("fused_xla", "staged"):
        ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, "ballista.tpu.fusion.mode": mode}))
        register_tpch(ctx, data_dir)
        RUN_STATS.clear()
        t0 = time.time()
        tbl = ctx.sql(sql).collect()
        out[mode] = (tbl, RUN_STATS.snapshot(), time.time() - t0)
    (fused, _, fused_s), (staged, stats, staged_s) = out["fused_xla"], out["staged"]
    if stats.get("fusion_mode") != "staged" or set(stats.get("span_s", {})) != {
            "predicate", "project", "aggregate"}:
        raise AssertionError(f"q1 staged: fusion_mode {stats.get('fusion_mode')!r}, "
                             f"span_s {stats.get('span_s')!r}")
    if not staged.equals(fused):
        raise AssertionError("q1 staged: the answer differs from fused_xla's")
    log(f"q1 staged: byte-identical to fused_xla, span_s {stats['span_s']}")
    return {"query": "q1_staged", "span_s": stats["span_s"],
            "fused_kernel_s": stats.get("fused_kernel_s"), "staged_wall_s": staged_s,
            "fused_xla_wall_s": fused_s}


def routing_check(data_dir: str, k: int = 16) -> dict:
    """One sorted stage (lineitem grouped by l_orderkey) under a hand-built
    hash-layout ShuffleWriterExec, as a distributed plan's first stage:
    the stage emits __pid on the card and the writer routes by it. Every
    written row must hash on the host, through ops/hashing, to its own
    partition, and the rows together must be the engine=cpu answer."""
    import shutil

    import numpy as np
    import pyarrow as pa
    import pyarrow.ipc as ipc

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.ops.hashing import partition_indices
    from ballista_tpu_torch.plan.physical import RepartitionExec, TaskContext
    from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql = ("SELECT l_orderkey, sum(l_quantity) AS q, count(*) AS c FROM lineitem "
           "GROUP BY l_orderkey")
    ctx = SessionContext(BallistaConfig(dict(QUERY_CONFIG)))
    register_tpch(ctx, data_dir)
    phys = ctx.create_physical_plan(ctx.sql(sql).plan)
    rep = [n for n in _walk(phys) if isinstance(n, RepartitionExec) and n.scheme == "hash"][0]
    writer = ShuffleWriterExec(rep.input, "route", 1, k, rep.keys, sort_shuffle=False)
    compiled = maybe_compile_tpu(writer, ctx.config)
    stage = [n for n in _walk(compiled) if isinstance(n, TpuStageExec)][0]
    if stage.emit_pid != ([0], k):
        raise AssertionError(f"routing: emit_pid {stage.emit_pid!r}")
    work = os.path.join(ROOT, "build", "route_check")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.time()
        task = TaskContext(ctx.config, task_id="t0", work_dir=work)
        for p in range(compiled.output_partition_count()):
            list(compiled.execute(p, task))
        write_s = time.time() - t0
        if stage.pid_emitted < 1 or stage.fallback_count != 0 or stage.tpu_count < 1:
            raise AssertionError(f"routing: {stage.node_str()} pid_emitted={stage.pid_emitted}")
        tables = {}
        for pid_dir in sorted(os.listdir(os.path.join(work, "route", "1"))):
            parts = []
            for name in os.listdir(os.path.join(work, "route", "1", pid_dir)):
                if name.endswith(".arrow"):
                    with open(os.path.join(work, "route", "1", pid_dir, name), "rb") as fh:
                        parts.append(ipc.open_stream(fh).read_all())
            tables[int(pid_dir)] = pa.concat_tables(parts)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for pid, t in tables.items():
        if "__pid" in t.column_names:
            raise AssertionError("routing: a written bucket kept the __pid column")
        host = partition_indices([t.column("l_orderkey").combine_chunks()], k)
        if not (host == pid).all():
            raise AssertionError(f"routing: {int((host != pid).sum())} rows of bucket {pid} "
                                 "hash elsewhere on the host")
    # the written partial rows (key, sum, count accumulators), one per group
    written = pa.concat_tables(tables.values()).sort_by("l_orderkey")
    cpu_ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(cpu_ctx, data_dir)
    want = cpu_ctx.sql(sql).collect().sort_by("l_orderkey")
    if written.num_rows != want.num_rows or not written.column(0).equals(
            want.column(0)) or not written.column(2).equals(want.column(2)):
        raise AssertionError("routing: the written rows are not the engine=cpu answer")
    if not np.allclose(written.column(1).to_numpy(), want.column(1).to_numpy(),
                       rtol=1e-9, atol=0.0):
        raise AssertionError("routing: the written sums differ from the engine=cpu answer")
    log(f"routing: {written.num_rows} groups in {len(tables)} of {k} buckets, every row "
        f"hashes on the host to its own bucket, equal to the engine=cpu answer")
    return {"query": "route_l_orderkey", "groups": written.num_rows, "buckets": len(tables),
            "k": k, "write_s": write_s, "pid_emitted": stage.pid_emitted}


# ---------------------------------------------------------------- out of core

def _ooc_run(data_dir: str, q: int, cfg: dict):
    """One run of TPC-H q`q` through SessionContext with engine=tpu and
    `cfg`: (answer, the partial stages' records, every device stage, wall s)."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    ctx = SessionContext(BallistaConfig(cfg))
    register_tpch(ctx, data_dir)
    t0 = time.time()
    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    tbl = ctx.execute_collect(physical)
    wall = time.time() - t0
    stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
    recs = RUN_STATS.stages()
    partial = [s for s in stages if isinstance(s, TpuStageExec)]
    if not partial:
        raise AssertionError(f"q{q}: no device partial stage was planned")
    for s in stages:
        if s.tpu_count < 1 or s.fallback_count != 0:
            raise AssertionError(f"q{q}: {s.node_str()} did not run on the card "
                                 f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
    return tbl, [dict(recs.get(_tag(s), {})) for s in partial], partial, wall


def _fresh_card() -> None:
    """Drop every cached table, build, LUT and spilled table, and hand the
    allocator's cached blocks back to the card."""
    import torch

    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, clear_device_caches

    clear_device_caches()
    RUN_STATS.clear()
    torch.cuda.empty_cache()


def _digest(dt) -> list:
    """Per plane of a device table (columns, row mask, validity planes, None
    slots kept): dtype, shape and the CRC-32 of its bytes."""
    import zlib

    import numpy as np

    out = []
    for t in list(dt.cols) + [dt.mask] + list(dt.valids):
        if t is None:
            out.append(None)
            continue
        a = np.ascontiguousarray(t.cpu().numpy()).reshape(-1).view(np.uint8)
        out.append((str(t.dtype), tuple(t.shape), zlib.crc32(a)))
    return out


def _grace_rec(recs: list, q: str) -> dict:
    got = [r for r in recs if r.get("hbm_plan") == "grace_split"]
    if len(got) != 1:
        raise AssertionError(f"{q}: {len(got)} grace-split stages, expected 1: "
                             f"{[r.get('hbm_plan_reason') for r in recs]}")
    return got[0]


def _working_set(reason: str) -> int:
    import re

    m = re.search(r"working set (\d+) B", reason or "")
    if m is None:
        raise AssertionError(f"no working set in the admission reason {reason!r}")
    return int(m.group(1))


def spill_touch_check(data_dir: str, tier: str, ref: dict, dev) -> dict:
    """q1, then q6, then q1 again under a device budget that holds either
    lineitem table but not both: q6's fill demotes q1's table to the spill
    pool (`tier` "host": host buffers; "disk": npz files, the host tier cut
    to 1 byte), and the second q1 restores it with no encode. Each answer
    equals `ref`'s device answer exactly; the restored planes equal the
    spilled ones (CRC-32 per plane); the disk tier leaves no .tmp file.
    `ref` maps 1 and 6 to (answer, device bytes)."""
    import shutil

    from ballista_tpu_torch.ops.cuda import hbm
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    b1, b6 = ref[1][1], ref[6][1]
    spill_dir = os.path.join(ROOT, "build", "hbm_spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    cfg = {**SPILL_CONFIG, "ballista.tpu.hbm.budget.bytes": max(b1, b6) + min(b1, b6) // 2,
           "ballista.tpu.hbm.spill.host.bytes": 2 * max(b1, b6) if tier == "host" else 1,
           "ballista.tpu.hbm.spill.dir": spill_dir}

    def files():
        names = os.listdir(spill_dir) if os.path.isdir(spill_dir) else []
        if any(n.endswith(".tmp") for n in names):
            raise AssertionError(f"spill {tier}: a .tmp file was left behind: {names}")
        return [n for n in names if n.endswith(".npz")]

    spills = []
    orig = sc._spill_device_table

    def timed_spill(pool, key, dt):
        t0 = time.time()
        orig(pool, key, dt)
        spills.append((dt.nbytes, time.time() - t0))

    _fresh_card()
    sc._spill_device_table = timed_spill
    try:
        st0 = hbm.SPILL_POOL.stats()
        t1, r1, s1, w1 = _ooc_run(data_dir, 1, cfg)
        q1_scan = s1[0].scan
        before = _digest(sc.DEVICE_CACHE.peek(q1_scan, dev))
        t6, r6, _s6, w6 = _ooc_run(data_dir, 6, cfg)
        st6 = hbm.SPILL_POOL.stats()
        if sc.DEVICE_CACHE.peek(q1_scan, dev) is not None or not spills or spills[0][0] != b1:
            raise AssertionError(f"spill {tier}: q6's fill did not demote q1's table "
                                 f"({spills}, {st6})")
        if tier == "disk" and len(files()) != 1:
            raise AssertionError(f"spill disk: {files()} after q1's demotion")
        t1b, r1b, _s1b, w1b = _ooc_run(data_dir, 1, cfg)
        st1 = hbm.SPILL_POOL.stats()
        after = _digest(sc.DEVICE_CACHE.peek(q1_scan, dev))
    finally:
        sc._spill_device_table = orig
    if st1["reupload_events"] != st0["reupload_events"] + 1 or "encode_s" in r1b[0]:
        raise AssertionError(f"spill {tier}: q1 was not restored from the pool ({st1}, {r1b[0]})")
    if after != before:
        raise AssertionError(f"spill {tier}: the restored planes differ from the spilled ones")
    for name, got, want in (("q1", t1, ref[1][0]), ("q6", t6, ref[6][0]), ("q1 restored", t1b,
                                                                           ref[1][0])):
        if not got.equals(want):
            raise AssertionError(f"spill {tier}: {name}'s answer differs from the reference run")
    n_files = len(files()) if tier == "disk" else None  # q6's table, demoted by q1's restore
    if tier == "disk" and n_files != 1:
        raise AssertionError(f"spill disk: {n_files} npz files after the restore, expected 1")
    log(f"spill {tier}: q1 ({b1} B) spilled in {spills[0][1]:.3f}s and restored bitwise in "
        f"fill_s {r1b[0].get('fill_s')} (cold fill_s {r1[0].get('fill_s')}); answers exact")
    return {"query": f"spill_touch_{tier}", "q1_bytes": b1, "q6_bytes": b6,
            "budget_bytes": cfg["ballista.tpu.hbm.budget.bytes"],
            "spills": [{"bytes": b, "spill_s": t} for b, t in spills],
            "spill_bytes": st1["spill_bytes"] - st0["spill_bytes"],
            "spill_events": st1["spill_events"] - st0["spill_events"],
            "reupload_events": st1["reupload_events"] - st0["reupload_events"],
            "cold_fill_s": r1[0].get("fill_s"), "cold_encode_s": r1[0].get("encode_s"),
            "reupload_fill_s": r1b[0].get("fill_s"), "q6_plan": r6[0].get("hbm_plan"),
            "walls_s": {"q1_cold": w1, "q6": w6, "q1_restored": w1b}, "npz_files_after": n_files,
            "digest_planes": len(before)}


def grace_q5_check(data_dir: str, whole_rec: dict, answers: tuple, busy_ok: bool) -> dict:
    """q5 in auto mode under a budget of its working set (phase 4's
    admission reason) less 1 byte: a grace split into 4 sub-buckets at depth
    1, one cold run, best of 3 warm, one traced. Every answer equals phase
    4's device and engine=cpu answers (strings and ints exact, revenue within
    rtol 1e-9), every stage on the card, and every run launches hash_probe
    twice (nation, region) per sub-run."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    ws = _working_set(whole_rec["hbm_plan_reason"])
    cfg = {**SPILL_CONFIG, "ballista.tpu.hbm.budget.bytes": ws - 1}
    _fresh_card()
    dev_tbl, cpu_tbl = answers
    times, run_launches, recs = [], [], []
    for i in range(4):  # cold, then best of 3
        ck.reset_launches()
        tbl, prs, _stages, wall = _ooc_run(data_dir, 5, cfg)
        run_launches.append(dict(ck.LAUNCHES))
        rec = _grace_rec(prs, "q5 grace")
        if "into 4 sub-buckets (depth 1)" not in rec["hbm_plan_reason"] or \
                rec.get("grace_splits") != 4:
            raise AssertionError(f"q5 grace: {rec.get('grace_splits')} sub-runs, "
                                 f"{rec['hbm_plan_reason']!r}")
        if run_launches[-1]["hash_probe"] < 2 * rec["grace_splits"]:
            raise AssertionError(f"q5 grace: hash_probe launched {run_launches[-1]['hash_probe']}"
                                 f" times over {rec['grace_splits']} sub-runs")
        compare_answers(tbl, dev_tbl, 5)
        compare_answers(tbl, cpu_tbl, 5)
        recs.append(rec)
        if i:
            times.append(wall)
        else:
            cold_wall = wall

    def one_run():
        _ooc_run(data_dir, 5, cfg)

    t0 = time.time()
    ck.reset_launches()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    traced_launches = dict(ck.LAUNCHES)
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    best = min(range(3), key=lambda k: times[k])
    warm = recs[best + 1]
    log(f"q5 grace: 4 sub-runs, answers equal to phase 4's and the CPU engine's; cold "
        f"{cold_wall:.2f}s, warm {times}, hash_probe per run "
        f"{[r['hash_probe'] for r in run_launches]}")
    keep = ("fill_s", "build_s", "exec_s", "fused_kernel_s", "grace_splits", "hbm_plan",
            "hbm_plan_reason", "hbm_budget_bytes", "fusion_mode")
    return {"query": "q5_grace", "working_set_bytes": ws, "wall_s": times[best], "times_s": times,
            "cold_wall_s": cold_wall, "cold": {k: recs[0].get(k) for k in keep},
            "warm": {k: warm.get(k) for k in keep},
            "kernel_launches_per_run": run_launches, "traced_launches": traced_launches,
            "launches": {k: sum(r[k] for r in run_launches) + traced_launches[k]
                         for k in traced_launches},
            "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
            "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall}


def grace_depth2_check(data_dir: str) -> dict:
    """q5 at a budget between fixed + split/16 and fixed + split/4 (fixed and
    split read from the admission reasons of a whole run and of a run one
    byte over): 16 sub-buckets at depth 2, each answer equal to the whole
    run's (floats within rtol 1e-9), hash_probe in every sub-run."""
    import re

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    _fresh_card()
    whole, prs, _st, w_whole = _ooc_run(data_dir, 5, SPILL_CONFIG)
    ws = _working_set(prs[0]["hbm_plan_reason"])
    out = {"query": "q5_grace_depth2", "working_set_bytes": ws, "whole_wall_s": w_whole}
    budgets = {4: ws - 1}
    for n in (4, 16):
        _fresh_card()
        ck.reset_launches()
        tbl, prs, _st, wall = _ooc_run(
            data_dir, 5, {**SPILL_CONFIG, "ballista.tpu.hbm.budget.bytes": budgets[n]})
        rec = _grace_rec(prs, f"q5 grace {n}")
        depth = 1 if n == 4 else 2
        if f"into {n} sub-buckets (depth {depth})" not in rec["hbm_plan_reason"] or \
                rec.get("grace_splits") != n or ck.LAUNCHES["hash_probe"] < 2 * n:
            raise AssertionError(f"q5 grace {n}: {rec.get('grace_splits')} sub-runs, hash_probe "
                                 f"{ck.LAUNCHES['hash_probe']}, {rec['hbm_plan_reason']!r}")
        compare_answers(tbl, whole, 5)
        if n == 4:
            split = int(re.search(r"grace-splitting build \d+ \((\d+) B\)",
                                  rec["hbm_plan_reason"]).group(1))
            fixed = ws - split
            budgets[16] = fixed + (-(-split // 16) + -(-split // 4)) // 2
            out.update(split_bytes=split, fixed_bytes=fixed)
        out[f"grace{n}"] = {"budget_bytes": budgets[n], "cold_wall_s": wall,
                            "grace_splits": rec["grace_splits"],
                            "hash_probe": ck.LAUNCHES["hash_probe"],
                            "exec_s": rec.get("exec_s"), "build_s": rec.get("build_s")}
    log(f"q5 grace depth 2: 16 sub-runs, equal to the whole run (budget {budgets[16]} B)")
    return out


class _Warnings:
    """Collect the stage compiler's warnings (the OOM rung's)."""

    def __enter__(self):
        import logging

        self.records = []
        self.logger = logging.getLogger("ballista_tpu_torch.ops.cuda.stage_compiler")
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda r: self.records.append(r.getMessage())
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def oom_injected_check(data_dir: str, answer, dev) -> dict:
    """q3 with hbm_oom chaos armed (budget 1 TiB, the first upload raises
    RESOURCE_EXHAUSTED once): the stage spills, retries once (pre-planned
    as a grace split) and answers as phase 6 did (floats within rtol 1e-9).
    Also measures the retry's peak device memory, which sizes the real-OOM
    check's margin."""
    from ballista_tpu_torch.ops.cuda import hbm

    _fresh_card()
    retries0 = hbm.oom_retry_count()
    hbm.arm_chaos(1 << 40, oom_n=1)
    try:
        with _Warnings() as warned:
            (tbl, prs, _st, wall), peak = _peak_run(data_dir, 3, SPILL_CONFIG, dev)
    finally:
        hbm.disarm_chaos()
    rec = max(prs, key=lambda r: r.get("device_bytes") or 0)
    if hbm.oom_retry_count() != retries0 + 1 or rec.get("hbm_oom_retries", 0) < 1 or \
            not any("InjectedResourceExhausted" in w for w in warned):
        raise AssertionError(f"oom injected: no spill-and-retry ({rec}, {warned})")
    compare_answers(tbl, answer, 3)
    log(f"oom injected: q3 retried once ({rec.get('hbm_plan')}, grace_splits "
        f"{rec.get('grace_splits')}), equal to phase 6; peak {peak} B")
    return {"query": "oom_injected_q3", "wall_s": wall, "hbm_plan": rec.get("hbm_plan"),
            "hbm_plan_reason": rec.get("hbm_plan_reason"), "grace_splits": rec.get("grace_splits"),
            "hbm_oom_retries": rec.get("hbm_oom_retries"), "peak_allocated_bytes": peak,
            "q3_table_bytes": rec.get("device_bytes")}


def _peak_run(data_dir: str, q: int, cfg: dict, dev):
    """_ooc_run with the device memory it allocated at its peak above what
    was allocated before it."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = _ooc_run(data_dir, q, cfg)
    return out, torch.cuda.max_memory_allocated(dev) - base


def oom_real_check(data_dir: str, answer, dev, first_need: int, retry_need: int,
                   q3_bytes: int, q16_bytes: int) -> dict:
    """A real torch.cuda.OutOfMemoryError: q1's and q6's tables resident (no
    budget; `q16_bytes` between them), one blocker tensor holds the card's
    free memory less a margin, and q3 runs. The margin lies between what
    the retry needs once the residents are spilled (`retry_need`, the
    injected check's peak, for the retry is pre-planned as a grace split,
    less the residents) and the whole first attempt's peak (`first_need`,
    a cold q3 run's): so the first attempt runs out of memory, the spill
    of the residents makes room, and the retry answers as phase 6 did. The
    blocker is freed in `finally`."""
    import torch

    from ballista_tpu_torch.ops.cuda import hbm
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    _ooc_run(data_dir, 1, SPILL_CONFIG)  # both from the cache or the spill pool
    _ooc_run(data_dir, 6, SPILL_CONFIG)
    resident = sc.DEVICE_CACHE.resident_bytes()
    if resident != q16_bytes:
        raise AssertionError(f"oom real: {resident} B resident, expected q1's and q6's "
                             f"{q16_bytes} B")
    lo, hi = retry_need - resident, first_need
    if hi - lo < 256 << 20:
        raise AssertionError(f"oom real: no room for a margin: the retry needs {retry_need} B, "
                             f"the residents hold {resident} B, the first attempt {first_need} B")
    margin = (max(lo, 0) + hi) // 2
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"oom real: first attempt needs {first_need} B, the retry {retry_need} B, residents "
        f"{resident} B, q3's table {q3_bytes} B, free {free} of {total} B: margin {margin} B")
    spilled0 = hbm.SPILL_POOL.stats()
    retries0 = hbm.oom_retry_count()
    blocker = torch.empty(free - margin, dtype=torch.uint8, device=dev)
    try:
        with _Warnings() as warned:
            tbl, prs, _st, wall = _ooc_run(data_dir, 3, SPILL_CONFIG)
    finally:
        del blocker
        torch.cuda.empty_cache()
    spilled = hbm.SPILL_POOL.stats()
    rec = max(prs, key=lambda r: r.get("device_bytes") or 0)
    if hbm.oom_retry_count() != retries0 + 1 or \
            not any("OutOfMemoryError" in w for w in warned):
        raise AssertionError(f"oom real: no real out-of-memory retry ({warned})")
    if spilled["spill_bytes"] - spilled0["spill_bytes"] < resident:
        raise AssertionError(f"oom real: the rung spilled {spilled}, not the residents")
    compare_answers(tbl, answer, 3)
    log(f"oom real: q3 ran out of memory, spilled "
        f"{spilled['spill_bytes'] - spilled0['spill_bytes']} B and retried "
        f"({rec.get('hbm_plan')}), equal to phase 6")
    return {"query": "oom_real_q3", "wall_s": wall, "first_need_bytes": first_need,
            "retry_need_bytes": retry_need, "margin_bytes": margin, "resident_bytes": resident,
            "q3_table_bytes": q3_bytes, "free_bytes": free, "total_bytes": total,
            "spilled_bytes": spilled["spill_bytes"] - spilled0["spill_bytes"],
            "hbm_plan": rec.get("hbm_plan"), "grace_splits": rec.get("grace_splits"),
            "hbm_oom_retries": rec.get("hbm_oom_retries"), "warning": warned[:1]}


def out_of_core_phase(big_dir: str, q4_dir: str, dev, busy_ok: bool, recs: dict,
                      answers: dict) -> list[dict]:
    """Phase 7, the out-of-core rungs: the injected and the real
    out-of-memory retry on q3, the spill round trip on q1/q6 through the
    host tier, the grace split of q5 (all at --scale), then grace at depth 2
    and the disk tier at --q4-scale. Chaos is disarmed, the blocker freed
    and the caches cleared whatever happens."""
    from ballista_tpu_torch.ops.cuda import hbm

    out = []
    try:
        inj = oom_injected_check(big_dir, answers[3][0], dev)
        out.append(inj)
        # the whole first attempt's peak, which with (a)'s sizes the real
        # OOM's margin
        _fresh_card()
        (_t, prs, _s, _w), first_need = _peak_run(big_dir, 3, SPILL_CONFIG, dev)
        # the host round trip leaves q1's table resident and q6's spilled:
        # the real OOM check restores q6 beside it
        out.append(spill_touch_check(
            big_dir, "host", {q: (answers[q][0], recs[q]["device_bytes"]) for q in (1, 6)}, dev))
        out.append(oom_real_check(
            big_dir, answers[3][0], dev, first_need, inj["peak_allocated_bytes"],
            max(r.get("device_bytes") or 0 for r in prs),
            recs[1]["device_bytes"] + recs[6]["device_bytes"]))
        out.append(grace_q5_check(big_dir, recs[5], answers[5], busy_ok))
        out.append(grace_depth2_check(q4_dir))
        _fresh_card()
        small = {}
        for q in (1, 6):
            tbl, prs, _st, _w = _ooc_run(q4_dir, q, QUERY_CONFIG)
            small[q] = (tbl, prs[0]["device_bytes"])
        out.append(spill_touch_check(q4_dir, "disk", small, dev))
    finally:
        hbm.disarm_chaos()
        _fresh_card()
    return out


def _probe_launches() -> list:
    """hash_probe's launches since the counts were last set to 0, as
    [P, N, T, regime, cluster size, launches] rows."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    return [[*k, v] for k, v in sorted(ck.HASH_PROBE_LAUNCHES.items())]


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
        recs, answers = {}, {}  # phase 7 reads phases 4 and 6

        def emit(r: dict, scale: float) -> None:
            r["scale"] = scale
            r["card"] = card
            print(json.dumps(r), flush=True)

        def path_query(q: int, path_dir: str, scale: float) -> None:
            cuda_kernels.reset_launches()
            r = recs[q] = run_query(q, path_dir, dev, busy_ok, answers)
            r["launches"] = launches[q] = dict(cuda_kernels.LAUNCHES)
            r["hash_probe_launches"] = _probe_launches()
            emit(r, scale)
            log(f"q{q} done at {time.time() - t0:.1f}s")

        def sorted_query(q: int, path_dir: str, scale: float, extra: dict) -> None:
            cuda_kernels.reset_launches()
            r = run_sorted_query(q, path_dir, dev, busy_ok, extra, answers)
            r["launches"] = launches[q] = dict(cuda_kernels.LAUNCHES)
            r["hash_probe_launches"] = _probe_launches()
            emit(r, scale)
            log(f"q{q} (sorted) done at {time.time() - t0:.1f}s")

        for q, path_dir, scale in ((1, big_dir, args.scale), (6, big_dir, args.scale),
                                   (5, big_dir, args.scale), (12, big_dir, args.scale),
                                   (4, q4_dir, args.q4_scale)):
            path_query(q, path_dir, scale)
        # the sort family, same data; counts set to 0 just before each run
        for name in SORT_QUERIES:
            cuda_kernels.reset_launches()
            r = run_sort_query(name, big_dir, dev, busy_ok)
            # every run's launches, the traced run's included
            r["launches"] = launches[name] = {
                k: sum(run[k] for run in r["kernel_launches_per_run"]) + r["traced_launches"][k]
                for k in cuda_kernels.LAUNCHES}
            emit(r, args.scale)
            log(f"{name} done at {time.time() - t0:.1f}s")
        # the sorted aggregation, then the staged mode and device routing
        for q, (which, extra) in SORTED_QUERIES.items():
            path_dir, scale = ((big_dir, args.scale) if which == "big"
                               else (q4_dir, args.q4_scale))
            sorted_query(q, path_dir, scale, extra)
        for check in (staged_check, routing_check):
            r = check(q4_dir)
            emit(r, args.q4_scale)
            log(f"{r['query']} done at {time.time() - t0:.1f}s")
        # q21 at --scale: its supplier table (2^17 entries at SF10) through
        # hash_probe's shared-memory regimes; the counts are set to 0 inside,
        # just before its fused_pallas runs, and read just after them
        r = q21_large_check(big_dir, args.scale, dev, busy_ok)
        launches["q21_large"] = r["launches"]
        emit(r, args.scale)
        log(f"q21 at SF{scale_s} done at {time.time() - t0:.1f}s")
        # out of core: the launch counts of the grace q5 runs are set to 0
        # just before each run and read just after it
        t7 = time.time()
        for r in out_of_core_phase(big_dir, q4_dir, dev, busy_ok, recs, answers):
            if r["query"] == "q5_grace":
                launches["q5_grace"] = r["launches"]
            r["scale"] = args.q4_scale if r["query"] in (
                "q5_grace_depth2", "spill_touch_disk") else args.scale
            r["card"] = card
            print(json.dumps(r), flush=True)
        log(f"out-of-core phase took {time.time() - t7:.1f}s, done at {time.time() - t0:.1f}s")
        path_of = {"masked_group_reduce": (4,), "hash_probe": (5, 21, "q21_large", "q5_grace"),
                   "dict_filter": (12,),
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
