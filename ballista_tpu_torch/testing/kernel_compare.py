"""Time the kernels of several checkouts on one card.

    python -m ballista_tpu_torch.testing.kernel_compare PARENT . . PARENT

Each argument is the root of a checkout of this repository (unpack another
commit with `git archive <commit> | tar -x -C <dir>`). Each runs in its own
process, in the order given, so alternate them (parent, change, change,
parent) to see the spread of one card. For each checkout it builds the
kernels from that checkout's sources and times, at the main path's
shapes, `segmented_sort` at [1, 2^20] and [1, 2^18], `segmented_scan`
(int64 sum, float64 max, a boundary about every 15 lanes) at [1, 2^20],
`topk_select` at [1, 2^20], k=100, on the top-k stage's operands (a zero,
b a key in [0, 100000), 1,000,000 real rows) and on descending keys, and
`masked_group_reduce` at q4's [8, 262144] with G=8 and G=4096 (70% of
rows kept), and `hash_probe` at [8, 2^23] over tables of T = 32 (q5's
nation), 2^14 and 2^17 (q21's supplier at SF1 and SF10) and 2^18 (the
engine's cap; 70% of slots present), keys in [0, T), 90% of the mask
set: CUDA-event ms per call over 50 calls through the wrapper,
device ms per call from a torch.profiler trace of 20 calls (the union of
the device events, memsets included) and the host's ms per call to
enqueue them (the least of 5 batches of 40 calls). The same for the
library yardsticks `torch.topk`, `torch.bincount` and `torch.take` on the
same inputs, under "library".
Where the checkout has hash_probe's regimes, each hash_probe
entry names the regime T chose, and the tables on both sides of the
split/cluster boundary (T = 9/4 S and one more) are timed too. Then
`dict_filter` at q12's [8, 2097152] over LUTs of T = 8 (q12), 2^17 and
2^22, 90% of the mask set, with `torch.take` beside each T; where the
checkout has `dict_filter_regime`, at T = 8 without a mask too, each
entry naming the regime T chose. Last, the host's microseconds a call of
each public way to reach the current stream's handle (`stream_call_us`). Prints one
JSON line per checkout, after the card's name and power limit. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r'''
import json, sys, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

root = sys.argv[1]
sys.path.insert(0, root)
from ballista_tpu_torch.ops.cuda import build, cuda_kernels as ck

assert ck.__file__.startswith(root), ck.__file__
build.build_all()
dev = torch.device("cuda", 0)


def events_ms(fn, iters=50):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, reach = 0.0, float("-inf")
    for s, e in spans:
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return busy / 1e3 / iters if spans else None


def host_ms(fn, batches=5, iters=40):
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t) / iters * 1e3)
    torch.cuda.synchronize()
    return best


def times(fn):
    fn()
    torch.cuda.synchronize()
    return {"ms": events_ms(fn), "device_ms": device_ms(fn), "host_ms": host_ms(fn)}


rng = np.random.default_rng(1)
out = {"checkout": root}
for n in (1 << 20, 1 << 18):
    a = torch.as_tensor(rng.integers(0, 1000, (1, n)), device=dev)
    b = torch.as_tensor(rng.integers(0, 3, (1, n)), device=dev)
    a[:, -(n // 8):] = 2**63 - 1
    b[:, -(n // 8):] = 2**63 - 1
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    out[f"segmented_sort [1, {n}]"] = times(lambda: ck.segmented_sort(a, b, pos))
n = 1 << 20
f = torch.as_tensor(rng.random((1, n)) < 1 / 15, device=dev)
for dtype, func in ((torch.int64, "sum"), (torch.float64, "max")):
    v = torch.as_tensor(rng.integers(-10**6, 10**6, (1, n)), device=dev).to(dtype)
    out[f"segmented_scan [1, {n}] {str(dtype)[6:]} {func}"] = times(
        lambda: ck.segmented_scan(v, f, func))
N = 1 << 20
lib = out["library"] = {}
for kind in ("path", "descending"):
    a = torch.zeros((1, N), dtype=torch.int64, device=dev)
    b = (torch.as_tensor(rng.integers(0, 100_000, (1, N)), device=dev) if kind == "path"
         else torch.arange(N, 0, -1, device=dev)[None, :])
    if kind == "path":  # one partsupp file at SF10, padded to 2^20
        a[:, 1_000_000:] = 2**63 - 1
        b[:, 1_000_000:] = 2**63 - 1
    pos = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    out[f"topk_select [1, {N}] k=100 {kind}"] = times(lambda: ck.topk_select(a, b, pos, 100))
    lib[f"torch.topk [1, {N}] k=100 {kind}"] = times(
        lambda: torch.topk(b, 100, dim=-1, largest=False))
P, n = 8, 262144
for G in (8, 4096):
    vals = torch.as_tensor(rng.uniform(-5, 5, (P, n)).astype(np.float32), device=dev)
    gid = torch.as_tensor(rng.integers(0, G, (P, n)).astype(np.int32), device=dev)
    mask = torch.as_tensor(rng.random((P, n)) < 0.7, device=dev)
    out[f"masked_group_reduce [{P}, {n}] G={G}"] = times(
        lambda: ck.masked_group_reduce(vals, gid, mask, G))
    key = (gid.long() + torch.arange(P, device=dev)[:, None] * G).flatten()
    w = torch.where(mask, vals, 0.0).flatten()
    lib[f"torch.bincount [{P}, {n}] G={G}"] = times(
        lambda: torch.bincount(key, w, minlength=P * G))
P, n = 8, 1 << 23
hp_rng = np.random.default_rng(11)
regimes = hasattr(ck, "hash_probe_regime")
optin = ck.hash_probe_smem_optin(dev) if regimes else None
tables = [(32, 25 / 32), (1 << 14, 10000 / (1 << 14)), (1 << 17, 100000 / (1 << 17)),
          (1 << 18, 0.7)]
if regimes:  # the split/cluster boundary
    cut = ck.hash_probe_block_max(optin) * ck.HP_SPLIT_MAX_QUARTERS // 4
    tables += [(cut, 0.7), (cut + 1, 0.7)]
for T, present in tables:
    table_np = np.full(T, -1, np.int32)
    slots = hp_rng.choice(T, size=int(T * present), replace=False)
    table_np[slots] = hp_rng.permutation(len(slots)).astype(np.int32)
    table = torch.as_tensor(table_np, device=dev)
    keys = torch.as_tensor(hp_rng.integers(0, T, (P, n), dtype=np.int32), device=dev)
    mask = torch.as_tensor(hp_rng.random((P, n), dtype=np.float32) < 0.9, device=dev)
    got, want = ck.hash_probe(keys, table, mask), ck.hash_probe_plain(keys, table, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), T
    name = f"hash_probe [{P}, {n}] T={T}"
    out[name] = times(lambda: ck.hash_probe(keys, table, mask))
    if regimes:
        out[name]["regime"] = ck.hash_probe_regime(T, optin)
    keys_l = keys.long()
    lib[f"torch.take [{P}, {n}] T={T}"] = times(lambda: torch.take(table, keys_l))
    del keys, keys_l, mask, got, want
P, n = 8, 2097152
df_rng = np.random.default_rng(18)
df_regimes = hasattr(ck, "dict_filter_regime")
dmask = torch.as_tensor(df_rng.random((P, n), dtype=np.float32) < 0.9, device=dev)
for T in (8, 1 << 17, 1 << 22):
    lut = torch.as_tensor(df_rng.random(T) < 0.4, device=dev)
    codes = torch.as_tensor(df_rng.integers(0, T, (P, n), dtype=np.int32), device=dev)
    for m in ((dmask, None) if df_regimes and T == 8 else (dmask,)):
        got, want = ck.dict_filter(codes, lut, m), ck.dict_filter_plain(codes, lut, m)
        assert torch.equal(got, want), T
        name = f"dict_filter [{P}, {n}] T={T}" + ("" if m is not None else " no mask")
        out[name] = times(lambda: ck.dict_filter(codes, lut, m))
        if df_regimes:
            out[name]["regime"] = ck.dict_filter_regime(T, ck.dict_filter_smem_optin(dev))
    codes_l = codes.long()
    lib[f"torch.take [{P}, {n}] T={T}"] = times(lambda: torch.take(lut, codes_l))
    del codes, codes_l, got, want


def per_call_us(fn, iters=20000):
    fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters * 1e6


out["stream_call_us"] = {
    "torch.cuda.current_stream(dev).cuda_stream":
        per_call_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
    "torch.cuda.current_stream(0).cuda_stream":
        per_call_us(lambda: torch.cuda.current_stream(0).cuda_stream),
    "torch.cuda.current_stream().cuda_stream":
        per_call_us(lambda: torch.cuda.current_stream().cuda_stream),
}
print(json.dumps(out), flush=True)
'''


def main(argv=None) -> int:
    roots = [os.path.abspath(r) for r in (argv if argv is not None else sys.argv[1:])]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _RUN, root], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
