"""Hand-written Hopper kernels of the device engine, with their plain forms.

Each replaces the Pallas kernel of the same name in
ballista_tpu/ops/tpu/pallas_kernels.py, with the same contract. The CUDA
sources are under csrc/, built for sm_90a by build.py and called through
their C interfaces.

- `masked_group_reduce` (:125): per-(partition, group) masked f32 sums
  and exact int32 counts over [P, N] lanes, for G up to MAX_GROUPS.
  Bound: bytes, P*N*(4 + 4 + 1) read once and P*G*(4 + 4) written; its one
  add per row is far below the f32 rate. The design reads every row from
  device memory exactly once (into registers), keeps the per-group
  accumulators in registers, and reduces across chunks in a second
  fixed-order pass: no atomics, so reruns are bitwise identical.
- `hash_probe` (:185): the direct-mode join probe, rows = table[keys]
  fused with the probe mask. Bound: bytes, P*N*(4 + 1) read, P*N*(4 + 1)
  written, the [T] table read once.
- `dict_filter` (:467): a string predicate over dictionary codes,
  keep = mask & lut[codes]. Bound: bytes, P*N*(4 + 1) read, P*N written.
  Both gathers stage a small table (up to 48 KB) into shared memory once
  per block and read a larger one through the read-only cache.

Each kernel has one wrapper. On a CPU tensor the wrapper runs the plain
PyTorch version (the tests' path); on a CUDA tensor it launches the kernel
or raises — it never falls back. `LAUNCHES[name]` counts launches, and only
the wrapper adds to it, where it launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ballista_tpu_torch.ops.cuda.kernels import take

MAX_GROUPS = 4096  # the Pallas kernel's multi-tile ceiling (32 x 128 lanes)

LAUNCHES = {"masked_group_reduce": 0, "hash_probe": 0, "dict_filter": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


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


_fns: dict = {}
_lib_lock = threading.Lock()
_VP = ctypes.c_void_p


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


def masked_group_reduce(vals, gid, mask, num_groups: int):
    """Per-(partition, group) masked (sum, count) over [P, N] lanes.

    vals: float [P, N]; gid: int [P, N]; mask: bool [P, N]. Rows whose
    group id lies outside [0, num_groups) count nowhere.
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
    v = vals.to(torch.float32).contiguous()
    g = gid.to(torch.int32).contiguous()
    m = mask.to(torch.bool).contiguous()
    if P == 0 or N == 0 or num_groups == 0:  # nothing to reduce, nothing launched
        return (torch.zeros((P, num_groups), dtype=torch.float32, device=dev),
                torch.zeros((P, num_groups), dtype=torch.int32, device=dev))
    # every (partition, group) cell is written by the kernel's second pass
    sums = torch.empty((P, num_groups), dtype=torch.float32, device=dev)
    cnts = torch.empty((P, num_groups), dtype=torch.int32, device=dev)
    # rows per block of the kernel's first pass
    n_chunks = -(-N // _bind("masked_group_reduce", "mgr_chunk_rows", [])())
    launch = _bind("masked_group_reduce", "mgr_launch",
                   [_VP] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, _VP])
    part_s = torch.empty((P, n_chunks, num_groups), dtype=torch.float32, device=dev)
    part_c = torch.empty((P, n_chunks, num_groups), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(v.data_ptr(), g.data_ptr(), m.data_ptr(),
                    part_s.data_ptr(), part_c.data_ptr(),
                    sums.data_ptr(), cnts.data_ptr(),
                    P, N, num_groups, n_chunks, stream)
    if rc != 0:
        raise RuntimeError(f"masked_group_reduce launch failed: CUDA error {rc}")
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


def _num_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def hash_probe(keys, table, mask):
    """Direct-mode join probe: rows = table[keys], fused with the probe
    predicate mask.

    keys: int [P, N], pre-clamped into [0, T); table: i32 [T] (key → build
    row, -1 absent); mask: bool [P, N] (in-range AND probe-key-valid).
    Returns (rows i32 [P, N] — 0 where unmatched — and matched bool
    [P, N]).
    """
    if keys.device.type == "cpu":
        return hash_probe_plain(keys, table, mask)
    _check_gather_args("hash_probe", keys, table, mask)
    dev = keys.device
    k = _aligned(keys.to(torch.int32), 16)
    m = _aligned(mask.to(torch.bool), 4)
    tab = table.to(torch.int32).contiguous()
    rows = torch.empty(k.shape, dtype=torch.int32, device=dev)
    matched = torch.empty(k.shape, dtype=torch.bool, device=dev)
    if k.numel() == 0:  # nothing to probe, nothing launched
        return rows, matched
    launch = _bind("hash_probe", "hp_launch",
                   [_VP, _VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_longlong,
                    ctypes.c_int, _VP])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(k.data_ptr(), m.data_ptr(), tab.data_ptr(), int(tab.shape[0]),
                    rows.data_ptr(), matched.data_ptr(), k.numel(), _num_sms(dev), stream)
    if rc != 0:
        raise RuntimeError(f"hash_probe launch failed: CUDA error {rc}")
    _count("hash_probe")
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
        raise RuntimeError(f"dict_filter launch failed: CUDA error {rc}")
    _count("dict_filter")
    return keep


def smem_max_entries(name: str) -> int:
    """Largest table (entries) the kernel stages into shared memory; larger
    ones are read through the read-only cache."""
    fn = {"hash_probe": "hp_smem_max_entries", "dict_filter": "df_smem_max_entries"}[name]
    return int(_bind(name, fn, [])())
