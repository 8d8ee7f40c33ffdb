"""Hand-written Hopper kernels of the device engine, with their plain forms.

`masked_group_reduce` replaces the Pallas kernel of the same name
(ballista_tpu/ops/tpu/pallas_kernels.py:125): per-(partition, group)
masked f32 sums and exact int32 counts over [P, N] lanes, for G up to
MAX_GROUPS. The CUDA source is csrc/masked_group_reduce.cu, built for
sm_90a by build.py and called through its C interface.

What bounds it on the card: bytes. It reads P*N*(4 + 4 + 1) bytes (f32
values, i32 group ids, bool mask) once and writes P*G*(4 + 4); at the
H100's 3.35 TB/s that is the floor, and its one add per row is far below
the f32 rate. The design reads every row from device memory exactly once
(into registers), keeps the per-group accumulators in registers, and
reduces across chunks in a second fixed-order pass: no atomics, so reruns
are bitwise identical.

Each kernel has one wrapper. On a CPU tensor the wrapper runs the plain
PyTorch version (the tests' path); on a CUDA tensor it launches the kernel
or raises — it never falls back. `LAUNCHES[name]` counts launches, and only
the wrapper adds to it, where it launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

MAX_GROUPS = 4096  # the Pallas kernel's multi-tile ceiling (32 x 128 lanes)

LAUNCHES = {"masked_group_reduce": 0}
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


_lib = None
_chunk_rows = 0  # rows per block of the kernel's first pass, read once from the library
_lib_lock = threading.Lock()


def _load_lib():
    global _lib, _chunk_rows
    with _lib_lock:
        if _lib is None:
            from ballista_tpu_torch.ops.cuda import build

            lib = build.load("masked_group_reduce")
            vp = ctypes.c_void_p
            lib.mgr_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, vp]
            lib.mgr_launch.restype = ctypes.c_int
            lib.mgr_chunk_rows.argtypes = []
            lib.mgr_chunk_rows.restype = ctypes.c_int
            _chunk_rows = lib.mgr_chunk_rows()
            _lib = lib
        return _lib


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
    lib = _load_lib()
    n_chunks = -(-N // _chunk_rows)
    part_s = torch.empty((P, n_chunks, num_groups), dtype=torch.float32, device=dev)
    part_c = torch.empty((P, n_chunks, num_groups), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mgr_launch(v.data_ptr(), g.data_ptr(), m.data_ptr(),
                            part_s.data_ptr(), part_c.data_ptr(),
                            sums.data_ptr(), cnts.data_ptr(),
                            P, N, num_groups, n_chunks, stream)
    if rc != 0:
        raise RuntimeError(f"masked_group_reduce launch failed: CUDA error {rc}")
    _count("masked_group_reduce")
    return sums, cnts
