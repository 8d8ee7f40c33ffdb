"""ctypes bindings for the native C++ runtime (native/row_router.cpp).

Loads native/libballista_native.so (built by native/build.sh; auto-built on
first use when a compiler is present). Falls back to the numpy
implementations transparently — the bit contract is identical and tested
(tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np
import pyarrow as pa

log = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libballista_native.so")


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    # BALLISTA_NATIVE_LIB: explicit .so override (the sanitizer leg points
    # this at an ASAN/TSAN build of the same source)
    override = os.environ.get("BALLISTA_NATIVE_LIB")
    so_path = override or _SO_PATH
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not override and not os.path.exists(so_path):
            build = os.path.join(_NATIVE_DIR, "build.sh")
            if os.path.exists(build):
                try:
                    subprocess.run(["sh", build], check=True, capture_output=True, timeout=120)
                except Exception as e:  # noqa: BLE001
                    log.info("native build unavailable (%s); using numpy paths", e)
                    return None
        if not os.path.exists(so_path):
            if override:
                log.warning("BALLISTA_NATIVE_LIB=%s does not exist; numpy fallback", so_path)
            return None
        try:
            lib = ctypes.CDLL(so_path)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.hash_mix_i64.argtypes = [u64p, i64p, u8p, ctypes.c_int64]
            lib.hash_mix_f64.argtypes = [u64p, f64p, u8p, ctypes.c_int64]
            lib.hash_mix_bytes.argtypes = [u64p, u8p, i64p, u8p, ctypes.c_int64]
            lib.route.argtypes = [u64p, ctypes.c_int64, ctypes.c_uint32, u32p, i64p, u32p]
            lib.route.restype = ctypes.c_int
            _lib = lib
        except OSError as e:
            log.info("native lib load failed (%s); using numpy paths", e)
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def hash_arrays_native(arrays: list[pa.Array]) -> np.ndarray | None:
    """Native row hash; None when a column type is unsupported here."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(arrays[0])
    h = np.zeros(n, dtype=np.uint64)
    for arr in arrays:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        t = arr.type
        valid = None
        if arr.null_count:
            valid = np.asarray(arr.is_valid()).astype(np.uint8)
        vp = _ptr(valid, ctypes.c_uint8) if valid is not None else None
        if pa.types.is_integer(t) or pa.types.is_boolean(t):
            import pyarrow.compute as pc

            fill = False if pa.types.is_boolean(t) else 0
            filled = pc.fill_null(arr, fill) if arr.null_count else arr
            v = np.ascontiguousarray(
                filled.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False).astype(np.int64)
            )
            lib.hash_mix_i64(_ptr(h, ctypes.c_uint64), _ptr(v, ctypes.c_int64), vp, n)
        elif pa.types.is_date(t):
            import pyarrow.compute as pc

            as_int = arr.cast(pa.int32() if pa.types.is_date32(t) else pa.int64(), safe=False)
            filled = pc.fill_null(as_int, 0) if arr.null_count else as_int
            v = np.ascontiguousarray(
                filled.cast(pa.int64()).to_numpy(zero_copy_only=False).astype(np.int64)
            )
            lib.hash_mix_i64(_ptr(h, ctypes.c_uint64), _ptr(v, ctypes.c_int64), vp, n)
        elif pa.types.is_floating(t):
            v = np.ascontiguousarray(arr.cast(pa.float64()).to_numpy(zero_copy_only=False))
            lib.hash_mix_f64(_ptr(h, ctypes.c_uint64), _ptr(v, ctypes.c_double), vp, n)
        elif pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t):
            data = arr.cast(pa.large_binary())
            bufs = data.buffers()
            offsets = np.frombuffer(bufs[1], dtype=np.int64, count=len(arr) + 1 + data.offset)
            offsets = np.ascontiguousarray(offsets[data.offset : data.offset + len(arr) + 1])
            raw = (
                np.frombuffer(bufs[2], dtype=np.uint8)
                if bufs[2] is not None
                else np.zeros(1, np.uint8)
            )
            lib.hash_mix_bytes(
                _ptr(h, ctypes.c_uint64), _ptr(np.ascontiguousarray(raw), ctypes.c_uint8),
                _ptr(offsets, ctypes.c_int64), vp, n,
            )
        else:
            if pa.types.is_dictionary(t):
                return hash_arrays_native([arr.cast(t.value_type)] ) if len(arrays) == 1 else None
            return None
    return h


def route_native(h: np.ndarray, k: int):
    """(pids, bounds, order): partition-grouped selection vectors in one pass."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(h)
    pids = np.empty(n, dtype=np.uint32)
    bounds = np.zeros(k + 1, dtype=np.int64)
    order = np.empty(n, dtype=np.uint32)
    lib.route(_ptr(np.ascontiguousarray(h), ctypes.c_uint64), n, k,
              _ptr(pids, ctypes.c_uint32), _ptr(bounds, ctypes.c_int64),
              _ptr(order, ctypes.c_uint32))
    return pids, bounds, order
