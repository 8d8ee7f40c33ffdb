"""Hand-written Hopper kernels of the device engine, with their plain forms.

Each replaces the Pallas kernel of the same name in
ballista_tpu/ops/tpu/pallas_kernels.py, with the same contract. The CUDA
sources are under csrc/, built for sm_90a by build.py and called through
their C interfaces.

- `masked_group_reduce` (:125): per-(partition, group) masked f32 sums
  and exact int32 counts over [P, N] lanes, for G up to MAX_GROUPS.
  Bound: bytes, P*N*(4 + 4 + 1) read once and P*G*(4 + 4) written; its one
  add per row is far below the f32 rate. The design (since PR 5) streams
  each block's span once with 16-byte loads, in work that does not grow
  with G: register accumulators for every group up to G = 32, per-warp
  shared-memory bins (lanes of one group combined with __match_any_sync)
  above; the blocks' partials are summed in block order by a second
  launch. No float atomics, so reruns are bitwise identical. A row adds
  only into its own group (the reference's one-hot dot leaks NaN × 0 into
  every group: ROADMAP C4).
- `hash_probe` (:185): the direct-mode join probe, rows = table[keys]
  fused with the probe mask. Bound: bytes, P*N*(4 + 1) read, P*N*(4 + 1)
  written, the [T] table read once. The table sits in shared memory as
  far as it fits, in a regime chosen from T
  (`hash_probe_regime`): every block holds all of it (up to the default
  48 KB, or the opt-in 227 KB) or its first 227 KB, or a cluster of two
  CTAs holds twice that, reading each other's halves through distributed
  shared memory; what no block holds is read through L2.
- `dict_filter` (:467): a string predicate over dictionary codes,
  keep = mask & lut[codes]. Bound: bytes, P*N*(4 + 1) read, P*N written.
  It stages a small LUT (up to 48 KB) into shared memory once per block
  and reads a larger one through the read-only cache.
- `segmented_sort` (:284): a per-row ascending sort of [P, N] triples
  (i64 a, i64 b, i32 pos), N a power of two. Bound: bytes, P*N*20 read
  and written; one row of 2^20 lanes is 20 MB, far beyond one block's
  shared memory, so 2048-lane tiles are sorted in shared memory and
  merged pairwise by merge-path passes (csrc/mergesort3.cuh): 10 launches
  at 2^20, each over the row once.
- `topk_select` (:351): the k smallest triples per row, in order, by a
  threshold filter (since PR 5): blocks stream the row, compact the lanes
  below their C-th best into a shared buffer and merge it in when it is
  full; the blocks' lists then meet in a tournament of ticketed merges
  (fan-in 2048 / C). One memset and one kernel a call; C > 2048 sorts the
  row through segmented_sort's merge sort. Bound: bytes, P*N*16 read
  (pos only where (a, b) passes), P*C*20 written.
- `segmented_scan` (:421): an inclusive segmented sum/min/max per row,
  reset at boundary lanes, in one launch that reads and writes every lane
  once: each tile publishes its aggregate and looks back over its
  predecessors' aggregates in a fixed order. Bound: bytes,
  P*N*(itemsize + 1) read, P*N*itemsize written.

Each kernel has one wrapper. On a CPU tensor the wrapper runs the plain
PyTorch version (the tests' path); on a CUDA tensor it launches the kernel
or raises — it never falls back. `LAUNCHES[name]` counts launches, and only
the wrapper adds to it, where it launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from ballista_tpu_torch.ops.cuda import hbm
from ballista_tpu_torch.ops.cuda.kernels import take
from ballista_tpu_torch.utils.lru import LruDict

MAX_GROUPS = 4096  # the Pallas kernel's multi-tile ceiling (32 x 128 lanes)
MAX_SORT_LANES = 1 << 20  # absolute ceiling of the sort family; the cost model caps lower

LAUNCHES = {"masked_group_reduce": 0, "hash_probe": 0, "dict_filter": 0,
            "segmented_sort": 0, "topk_select": 0, "segmented_scan": 0}
# hash_probe's launches by (P, N, T, regime, cluster size): which regime
# served which table on a path; the shapes grow with the tables a
# long-lived executor or daemon probes, so the oldest shape goes first
HASH_PROBE_LAUNCHES = LruDict(1024)
_count_lock = threading.Lock()


def _launch_error(name: str, rc: int) -> RuntimeError:
    """The error a launch that returned CUDA error `rc` raises: an
    allocation failure is hbm.DeviceAllocationError, which the stages'
    out-of-memory rung classifies; any other code is a RuntimeError."""
    cls = (hbm.DeviceAllocationError if rc == hbm.CUDA_ERROR_MEMORY_ALLOCATION
           else RuntimeError)
    return cls(f"{name} launch failed: CUDA error {rc}")


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        HASH_PROBE_LAUNCHES.clear()


def _count(name: str, shape: tuple | None = None) -> None:
    with _count_lock:
        LAUNCHES[name] += 1
        if shape is not None:
            HASH_PROBE_LAUNCHES[shape] = HASH_PROBE_LAUNCHES.get(shape, 0) + 1


def masked_group_reduce_plain(vals, gid, mask, num_groups: int):
    """Plain PyTorch form: one masked sum and count per group, G passes."""
    if num_groups > MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} > {MAX_GROUPS}")
    v = vals.to(torch.float32)
    g = gid.to(torch.int32)
    m = mask.to(torch.bool)
    P = v.shape[0]
    sums = torch.zeros((P, num_groups), dtype=torch.float32, device=v.device)
    cnts = torch.zeros((P, num_groups), dtype=torch.int32, device=v.device)
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    for k in range(num_groups):
        sel = m & (g == k)
        sums[:, k] = torch.where(sel, v, zero).sum(dim=1)
        cnts[:, k] = sel.sum(dim=1).to(torch.int32)
    return sums, cnts


# analysis: ignore[bounded-cache] one entry per C function of the six kernel libraries
_fns: dict = {}
_lib_lock = threading.Lock()
_VP = ctypes.c_void_p
_INT_P = ctypes.POINTER(ctypes.c_int)


def _bind(name: str, fn: str, argtypes: list):
    """The C function `fn` of kernel library `name` (built at first use),
    its argument types set once; every function returns an int."""
    with _lib_lock:
        f = _fns.get((name, fn))
        if f is None:
            from ballista_tpu_torch.ops.cuda import build

            f = getattr(build.load(name), fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _fns[(name, fn)] = f
        return f


# analysis: ignore[bounded-cache] one entry per card ordinal of this host
_SMS: dict = {}


def _num_sms(dev) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _on(dev):
    """The device context a launch needs: none when `dev` is current."""
    return (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


MGR_CHUNK = 16  # lanes a kernel thread reads a step (kItems: four 16-byte loads)


@functools.cache
def _mgr_launch():
    """The kernel's launch function, bound once: later calls take no lock."""
    return _bind("masked_group_reduce", "mgr_launch",
                 [_VP] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, _VP])


def mgr_plan(P: int, N: int, G: int, sms: int) -> tuple[int, int]:
    """The kernel's blocks per row and the lanes each takes (a multiple of
    its chunk): about two blocks an SM over all rows for G <= 32
    (registers), one for larger G (shared-memory bins)."""
    per_row = max(1, (2 if G <= 32 else 1) * sms // max(P, 1))
    span = -(-N // per_row)
    span = -(-span // MGR_CHUNK) * MGR_CHUNK
    return -(-N // span), span


def masked_group_reduce(vals, gid, mask, num_groups: int):
    """Per-(partition, group) masked (sum, count) over [P, N] lanes.

    vals: float [P, N]; gid: int [P, N]; mask: bool [P, N]. Rows whose
    group id lies outside [0, num_groups) count nowhere, and a row adds
    only into its own group (a NaN or inf value leaks into no other).
    Returns (sums f32 [P, G], counts i32 [P, G]).
    """
    if num_groups > MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} > {MAX_GROUPS}")
    if vals.device.type == "cpu":
        return masked_group_reduce_plain(vals, gid, mask, num_groups)
    if vals.device.type != "cuda":
        raise RuntimeError(f"masked_group_reduce: no kernel for {vals.device}")
    if vals.dim() != 2 or gid.shape != vals.shape or mask.shape != vals.shape:
        raise ValueError("masked_group_reduce: vals, gid and mask must share one [P, N] shape")
    if gid.device != vals.device or mask.device != vals.device:
        raise ValueError("masked_group_reduce: inputs on different devices")
    dev = vals.device
    P, N = vals.shape
    if P == 0 or N == 0 or num_groups == 0:  # nothing to reduce, nothing launched
        return (torch.zeros((P, num_groups), dtype=torch.float32, device=dev),
                torch.zeros((P, num_groups), dtype=torch.int32, device=dev))
    # the kernel's 16-byte loads: values, ids and mask words
    v = _aligned(vals.to(torch.float32), 16)
    g = _aligned(gid.to(torch.int32), 16)
    m = _aligned(mask.to(torch.bool), 16).view(torch.uint8)
    blocks, span = mgr_plan(P, N, num_groups, _num_sms(dev))
    # every (partition, group) cell is written by the kernel's second launch
    sums = torch.empty((P, num_groups), dtype=torch.float32, device=dev)
    cnts = torch.empty((P, num_groups), dtype=torch.int32, device=dev)
    # the blocks' partial sums, then their counts, in one allocation
    n_part = P * blocks * num_groups
    part = torch.empty(2 * n_part, dtype=torch.int32, device=dev)
    with _on(dev):
        rc = _mgr_launch()(v.data_ptr(), g.data_ptr(), m.data_ptr(), part.data_ptr(),
                        part.data_ptr() + 4 * n_part, sums.data_ptr(), cnts.data_ptr(),
                        P, N, num_groups, blocks, span,
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _launch_error("masked_group_reduce", rc)
    _count("masked_group_reduce")
    return sums, cnts


def hash_probe_plain(keys, table, mask):
    """Plain PyTorch form of `hash_probe`: rows = table[keys] (the engine's
    clamping gather), matched = mask & (rows >= 0), rows = 0 where
    unmatched."""
    rows = take(table.to(torch.int32), keys)
    matched = mask.to(torch.bool) & (rows >= 0)
    return torch.where(matched, rows, torch.zeros((), dtype=torch.int32,
                                                  device=rows.device)), matched


def dict_filter_plain(codes, lut, mask):
    """Plain PyTorch form of `dict_filter`: keep = mask & lut[codes] (the
    engine's clamping gather)."""
    return mask.to(torch.bool) & take(lut.to(torch.bool), codes)


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """`t` contiguous and starting on an `align`-byte boundary (the
    kernels' vector loads); a fresh allocation always is."""
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def _check_gather_args(name: str, idx, table, mask) -> None:
    if idx.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {idx.device}")
    if idx.dim() != 2 or mask.shape != idx.shape or table.dim() != 1:
        raise ValueError(f"{name}: index and mask must share one [P, N] shape, "
                         "the table must be 1-D")
    if table.device != idx.device or mask.device != idx.device:
        raise ValueError(f"{name}: inputs on different devices")
    if table.shape[0] < 1 or table.shape[0] >= 2**31:
        raise ValueError(f"{name}: table length {table.shape[0]} out of range")


HP_SHARED_MAX = 12288  # entries of the shared regime: 48 KB, the default limit (hp_smem_max_entries())
HP_CLUSTER = 2  # CTAs of a cluster launch (hash_probe.cu kCluster): the two SMs of a TPC
# the split regime's ceiling, in quarters of S: past it the cluster regime
# is faster (the crossover measured on an H100 by
# testing/hash_probe_crossover.py, PERF.md)
HP_SPLIT_MAX_QUARTERS = 9
_HP_REGIMES = ("shared", "block", "split", "cluster", "global")  # hash_probe.cu's Regime


def hash_probe_block_max(smem_optin_bytes: int) -> int:
    """S: the most table entries one block stages, its opt-in shared
    memory in whole 32-byte granules (the kernel keeps nothing else there)."""
    return smem_optin_bytes // 32 * 8


def hash_probe_regime(T: int, smem_optin_bytes: int) -> tuple[str, int]:
    """Where `hash_probe` keeps a table of T entries, from T alone: (regime,
    cluster size). "shared": T <= 12288 (48 KB), every block stages it;
    "block": T <= S (one block's opt-in shared memory), every block of a
    persistent grid stages it; "split": T <= 9/4 S, every block stages
    the first S entries and reads the rest through L2; "cluster": T <= 8 S,
    pairs of CTAs stage S entries each and read the rest through L2;
    "global": larger, all read through L2."""
    s = hash_probe_block_max(smem_optin_bytes)
    if T <= HP_SHARED_MAX:
        return "shared", 1
    if T <= s:
        return "block", 1
    if T <= s * HP_SPLIT_MAX_QUARTERS // 4:
        return "split", 1
    if T <= 8 * s:
        return "cluster", HP_CLUSTER
    return "global", 1


@functools.cache
def _hp_lib():
    """(hp_launch, hp_prepare, hp_max_ctas, hp_smem_optin), bound once."""
    return (_bind("hash_probe", "hp_launch",
                  [_VP, _VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _VP]),
            _bind("hash_probe", "hp_prepare", [ctypes.c_int] * 2),
            _bind("hash_probe", "hp_max_ctas", [ctypes.c_int] * 3 + [_INT_P]),
            _bind("hash_probe", "hp_smem_optin", [ctypes.c_int, _INT_P]))


def _hp_query(name: str, fn, *args) -> int:
    out = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"hash_probe: {name} failed: CUDA error {rc}")
    return out.value


# analysis: ignore[bounded-cache] one entry per card ordinal of this host
_HP_OPTIN: dict = {}
# analysis: ignore[bounded-cache] one entry per (card ordinal, staged regime): three regimes a card
_HP_PREPARED: set = set()
# the grid of each (card, table length, regime): table lengths grow with
# the workload
_HP_CTAS = LruDict(1024)


def hash_probe_smem_optin(dev) -> int:
    """The opt-in shared memory of one block on card `dev`, in bytes."""
    n = _HP_OPTIN.get(dev.index)
    if n is None:
        n = _HP_OPTIN[dev.index] = _hp_query("hp_smem_optin", _hp_lib()[3], dev.index)
    return n


def _hp_cap(dev, T: int, regime: str, optin: int) -> int:
    """The most blocks a launch takes: 8 an SM in the shared and global
    regimes (the first kernel's grid); in the staged regimes (block, split,
    cluster) the persistent grid, every CTA the card holds at once (its
    occupancy at the CTA's shared memory; a cluster it cannot schedule
    raises). The staged kernel is readied for its shared memory once per
    card, the grid sized once per table; `dev` is current."""
    if regime in ("shared", "global"):
        return _num_sms(dev) * 8
    n = _HP_CTAS.get((dev.index, T, regime))
    if n is None:
        lib, r = _hp_lib(), _HP_REGIMES.index(regime)
        if (dev.index, regime) not in _HP_PREPARED:
            rc = lib[1](r, optin)
            if rc != 0:
                raise RuntimeError(f"hash_probe: hp_prepare failed: CUDA error {rc}")
            _HP_PREPARED.add((dev.index, regime))
        n = _HP_CTAS[(dev.index, T, regime)] = _hp_query("hp_max_ctas", lib[2], T, r, optin)
    return n


def hash_probe(keys, table, mask):
    """Direct-mode join probe: rows = table[keys], fused with the probe
    predicate mask.

    keys: int [P, N], pre-clamped into [0, T); table: i32 [T] (key → build
    row, -1 absent); mask: bool [P, N] (in-range AND probe-key-valid).
    Returns (rows i32 [P, N] — 0 where unmatched — and matched bool
    [P, N]). The regime comes from T (`hash_probe_regime`).
    """
    if keys.device.type == "cpu":
        return hash_probe_plain(keys, table, mask)
    _check_gather_args("hash_probe", keys, table, mask)
    dev = keys.device
    k = _aligned(keys.to(torch.int32), 16)
    m = _aligned(mask.to(torch.bool), 4)
    tab = _aligned(table.to(torch.int32), 16)  # the staging's 16-byte loads
    rows = torch.empty(k.shape, dtype=torch.int32, device=dev)
    matched = torch.empty(k.shape, dtype=torch.bool, device=dev)
    if k.numel() == 0:  # nothing to probe, nothing launched
        return rows, matched
    T = int(tab.shape[0])
    with _on(dev):
        optin = hash_probe_smem_optin(dev)
        regime, cluster = hash_probe_regime(T, optin)
        cap = _hp_cap(dev, T, regime, optin)
        rc = _hp_lib()[0](k.data_ptr(), m.data_ptr(), tab.data_ptr(), T, rows.data_ptr(),
                          matched.data_ptr(), k.numel(), _HP_REGIMES.index(regime), optin, cap,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _launch_error("hash_probe", rc)
    _count("hash_probe", (*k.shape, T, regime, cluster))
    return rows, matched


def dict_filter(codes, lut, mask):
    """String predicate over dictionary codes: keep = mask & lut[codes].

    codes: int [P, N] dictionary indices (pre-clamped into [0, T)); lut:
    bool [T], the host-compiled truth table (pow2-padded); mask: bool
    [P, N]. Returns keep bool [P, N].
    """
    if codes.device.type == "cpu":
        return dict_filter_plain(codes, lut, mask)
    _check_gather_args("dict_filter", codes, lut, mask)
    dev = codes.device
    c = _aligned(codes.to(torch.int32), 16)
    m = _aligned(mask.to(torch.bool), 4)
    tab = lut.to(torch.bool).contiguous()
    keep = torch.empty(c.shape, dtype=torch.bool, device=dev)
    if c.numel() == 0:  # nothing to filter, nothing launched
        return keep
    launch = _bind("dict_filter", "df_launch",
                   [_VP, _VP, _VP, ctypes.c_int, _VP, ctypes.c_longlong, ctypes.c_int, _VP])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(c.data_ptr(), m.data_ptr(), tab.data_ptr(), int(tab.shape[0]),
                    keep.data_ptr(), c.numel(), _num_sms(dev), stream)
    if rc != 0:
        raise _launch_error("dict_filter", rc)
    _count("dict_filter")
    return keep


def smem_max_entries(name: str) -> int:
    """Largest table (entries) every block of the kernel stages within the
    default 48 KB of shared memory: dict_filter reads a larger LUT through
    the read-only cache; hash_probe stages a larger one with the opt-in
    limit (hash_probe_regime)."""
    fn = {"hash_probe": "hp_smem_max_entries", "dict_filter": "df_smem_max_entries"}[name]
    return int(_bind(name, fn, [])())


# ---------------------------------------------------------------------------
# the ORDER BY family: segmented sort, top-k, segmented scan


def _check_pow2(name: str, n: int) -> None:
    if n & (n - 1):
        raise ValueError(f"{name} needs pow2 lanes, got {n}")


def segmented_sort_plain(a, b, pos):
    """Plain PyTorch form of `segmented_sort`: stable sorts taken least
    significant operand first (pos, then b, then a). The pos operand makes
    every real triple unique, so any correct sort gives these values."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    p = pos.to(torch.int32)
    perm = torch.argsort(p, dim=-1, stable=True)
    for key in (b, a):
        perm = torch.gather(perm, -1, torch.argsort(torch.gather(key, -1, perm), dim=-1,
                                                    stable=True))
    return tuple(torch.gather(t, -1, perm) for t in (a, b, p))


SORT_TILE = 2048  # lanes the sort's tile pass sorts in shared memory (ss_tile())


def sort_plan(n: int, tile: int = SORT_TILE) -> tuple[int, int, bool]:
    """How the kernel sorts rows of n lanes (n a power of two): (tile
    lanes, merge passes, whether the tile pass writes the output itself).
    The passes ping-pong between the output and one scratch triple, so the
    tile pass starts in the output when the merge passes are even in
    number and the last pass lands there; launches = 1 + merge passes."""
    t = min(n, tile)
    passes = (n // t).bit_length() - 1
    return t, passes, passes % 2 == 0


def _topk_chunk(k: int, n: int) -> int:
    """The Pallas kernel's chunk rule: C = min(max(pow2(k), 128), N)."""
    c = 1
    while c < max(k, 1):
        c *= 2
    return min(max(c, 128), n)


def topk_select_plain(a, b, pos, k: int):
    """Plain PyTorch form of `topk_select`: the first C triples of the
    sorted row, sliced to k."""
    c = _topk_chunk(k, a.shape[-1])
    sa, sb, sp = segmented_sort_plain(a, b, pos)
    return sa[:, :c][:, :k], sb[:, :c][:, :k], sp[:, :c][:, :k]


def _scan_identity(func: str, dtype: torch.dtype):
    if func == "sum":
        return 0
    floating = dtype.is_floating_point
    if func == "min":
        return float("inf") if floating else int(torch.iinfo(dtype).max)
    return float("-inf") if floating else int(torch.iinfo(dtype).min)


def xla_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.maximum` as XLA computes it: a NaN operand wins (the first
    one's payload when both are NaN), and +0.0 beats -0.0 in either order
    (torch.maximum returns its first operand on that tie)."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b)
    r = torch.where(b > a, b, a)
    r = torch.where((a == b) & torch.signbit(a), b, r)
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


def xla_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.minimum` as XLA computes it: a NaN operand wins, and -0.0
    beats +0.0 in either order."""
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b)
    r = torch.where(b < a, b, a)
    r = torch.where((a == b) & ~torch.signbit(a), b, r)
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


_SCAN_OPS = {"sum": torch.add, "min": xla_minimum, "max": xla_maximum}


def segmented_scan_plain(vals, boundary, func: str):
    """Plain PyTorch form of `segmented_scan`: the Pallas kernel's
    Hillis-Steele recursion step for step (identity padding, OR-propagated
    flags, where(f, v, op(v, pv))), so a float sum equals it bit for bit."""
    op = _SCAN_OPS[func]
    v = vals
    f = boundary.to(torch.bool)
    P, n = v.shape
    ident = torch.full((P, 1), _scan_identity(func, v.dtype), dtype=v.dtype, device=v.device)
    d = 1
    while d < n:
        pv = torch.cat([ident.expand(P, d), v[:, :-d]], dim=1)
        pf = torch.cat([torch.ones((P, d), dtype=torch.bool, device=v.device), f[:, :-d]], dim=1)
        v = torch.where(f, v, op(v, pv))
        f = f | pf
        d *= 2
    return v


def _check_triples(name: str, a, b, pos) -> None:
    if a.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {a.device}")
    if a.dim() != 2 or b.shape != a.shape or pos.shape != a.shape:
        raise ValueError(f"{name}: a, b and pos must share one [P, N] shape")
    if b.device != a.device or pos.device != a.device:
        raise ValueError(f"{name}: inputs on different devices")


def _triples(a, b, pos):
    return (a.to(torch.int64).contiguous(), b.to(torch.int64).contiguous(),
            pos.to(torch.int32).contiguous())


def _empty_triples(P: int, n: int, dev):
    return (torch.empty((P, n), dtype=torch.int64, device=dev),
            torch.empty((P, n), dtype=torch.int64, device=dev),
            torch.empty((P, n), dtype=torch.int32, device=dev))


def _ptrs(*ts) -> list:
    return [t.data_ptr() for t in ts]


def segmented_sort(a, b, pos):
    """Sort each row of [P, N] ascending by the triple (a, b, pos).

    a, b: i64 lanes (b the tiebreak operand); pos: i32 original
    positions. N must be a power of two; pad with (i64 max, i64 max,
    i32 max) sentinels, which sort after every real row. Returns the
    sorted triple; the permutation is the pos output.
    """
    P, N = a.shape
    _check_pow2("segmented_sort", N)
    if a.device.type == "cpu":
        return segmented_sort_plain(a, b, pos)
    _check_triples("segmented_sort", a, b, pos)
    dev = a.device
    ins = _triples(a, b, pos)
    outs = _empty_triples(P, N, dev)
    if P * N == 0:  # nothing to sort, nothing launched
        return outs
    _, passes, _ = sort_plan(N, _bind("segmented_sort", "ss_tile", [])())
    # held until the launch is enqueued: freed earlier, another thread's
    # allocation on the stream could take the memory before the kernel runs
    scratch = _empty_triples(P, N, dev) if passes else ()
    launch = _bind("segmented_sort", "ss_launch",
                   [_VP] * 9 + [ctypes.c_longlong, ctypes.c_longlong, _VP])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*_ptrs(*ins, *outs), *(_ptrs(*scratch) or [None] * 3), P, N, stream)
    if rc != 0:
        raise _launch_error("segmented_sort", rc)
    _count("segmented_sort")
    return outs


TOPK_CAP = 2048  # the largest C the filter takes (tk_cap()); above it, the full sort
TOPK_STEP = 1024  # lanes a filter block reads a step (tk_step())


@functools.cache
def _topk_lib():
    """(launch function, tk_cap(), tk_step()), bound and read once."""
    return (_bind("topk_select", "tk_launch",
                  [_VP] * 7 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_longlong, _VP]),
            _bind("topk_select", "tk_cap", [])(), _bind("topk_select", "tk_step", [])())


def topk_plan(P: int, N: int, C: int, sms: int, cap: int = TOPK_CAP,
              step: int = TOPK_STEP) -> tuple[int, int, int]:
    """How the kernel selects over [P, N] with C candidates: (filter
    blocks per row, lanes each takes, scratch bytes). About one block an
    SM over all rows, each span a multiple of the block's step. Scratch:
    the blocks' C-lane lists and the tournament's tickets, 16 levels of
    one a block (none for one block a row); for C > cap, the full sort's
    two triples instead. Every i64 array is rounded up to 16 bytes."""
    def even(n):
        return n + (n & 1)

    if C > cap:
        return 0, 0, 40 * even(P * N)
    per_row = max(1, sms // max(P, 1))
    span = -(-N // per_row)
    span = -(-span // step) * step
    blocks = -(-N // span)
    return blocks, span, (20 * even(P * blocks * C) + 64 * P * blocks) if blocks > 1 else 0


def topk_select(a, b, pos, k: int):
    """Per-row k smallest triples of [P, N] lanes, in sorted order: ORDER
    BY ... LIMIT without the full sort. Same operand contract and sentinel
    padding as segmented_sort. Returns [P, k] triples (fewer when N < k)."""
    P, N = a.shape
    _check_pow2("topk_select", N)
    if a.device.type == "cpu":
        return topk_select_plain(a, b, pos, k)
    _check_triples("topk_select", a, b, pos)
    dev = a.device
    c = _topk_chunk(k, N)
    # the filter's 16-byte loads of a and b
    ins = (_aligned(a.to(torch.int64), 16), _aligned(b.to(torch.int64), 16),
           pos.to(torch.int32).contiguous())
    outs = _empty_triples(P, c, dev)
    if P * N == 0:  # nothing to select, nothing launched
        return tuple(o[:, :k] for o in outs)
    launch, cap, step = _topk_lib()
    blocks, span, n_scratch = topk_plan(P, N, c, _num_sms(dev), cap, step)
    # held until the launch is enqueued (another thread's allocation on
    # the stream could otherwise take the memory before the kernel runs)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev) if n_scratch else None
    with _on(dev):
        rc = launch(*_ptrs(*ins, *outs), scratch.data_ptr() if n_scratch else None,
                        P, N, c, blocks, span, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _launch_error("topk_select", rc)
    _count("topk_select")
    return tuple(o[:, :k] for o in outs)


_SCAN_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}
_SCAN_FUNCS = {"sum": 0, "min": 1, "max": 2}
SCAN_TILE = 4096  # lanes one block of the scan kernel takes (sc_tile())


def scan_plan(P: int, N: int, tile: int = SCAN_TILE) -> tuple[int, int]:
    """The scan kernel's tiles over [P, N] and the bytes of its status
    buffer: 8 bytes of published aggregate a tile, then one u32 ticket and
    one u32 status word a tile (the part the launch zeroes)."""
    tiles = P * (N // min(N, tile))
    return tiles, tiles * 8 + (1 + tiles) * 4


def segmented_scan(vals, boundary, func: str):
    """Inclusive segmented sum/min/max over each [P, N] row: the scan
    resets wherever boundary is True (lane 0 is an implicit boundary).
    N must be a power of two; pad the tail with boundary=True lanes.
    Float min/max follow jnp.minimum/jnp.maximum (NaN wins, -0.0 < +0.0)."""
    P, N = vals.shape
    _check_pow2("segmented_scan", N)
    if func not in _SCAN_FUNCS:
        raise ValueError(f"segmented_scan: unknown func {func!r}")
    if vals.device.type == "cpu":
        return segmented_scan_plain(vals, boundary, func)
    if vals.device.type != "cuda":
        raise RuntimeError(f"segmented_scan: no kernel for {vals.device}")
    if vals.dim() != 2 or boundary.shape != vals.shape:
        raise ValueError("segmented_scan: vals and boundary must share one [P, N] shape")
    if boundary.device != vals.device:
        raise ValueError("segmented_scan: inputs on different devices")
    if vals.dtype not in _SCAN_DTYPES:
        raise TypeError(f"segmented_scan: no kernel for dtype {vals.dtype}")
    dev = vals.device
    v = _aligned(vals, 16)  # the kernel's 16-byte loads
    # one byte a lane, never widened: the bool lanes viewed as u8, no copy
    f = _aligned(boundary.to(torch.bool), 16).view(torch.uint8)
    out = torch.empty(v.shape, dtype=v.dtype, device=dev)
    if P * N == 0:  # nothing to scan, nothing launched
        return out
    _, n_status = scan_plan(P, N, _bind("segmented_scan", "sc_tile", [])())
    status = torch.empty(n_status, dtype=torch.uint8, device=dev)
    launch = _bind("segmented_scan", "sc_launch",
                   [ctypes.c_int, ctypes.c_int] + [_VP] * 4
                   + [ctypes.c_longlong, ctypes.c_longlong, _VP])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(_SCAN_DTYPES[v.dtype], _SCAN_FUNCS[func],
                    *_ptrs(v, f, out, status), P, N, stream)
    if rc != 0:
        raise _launch_error("segmented_scan", rc)
    _count("segmented_scan")
    return out
