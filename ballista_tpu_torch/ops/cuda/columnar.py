"""Arrow → device columnar encoding.

Copied from the JAX package's ops/tpu/columnar.py: the host encoder is
unchanged, and `to_device` is the upload (`torch.as_tensor(...).to(dev)`).
The notes below speak of XLA and the TPU; the encoding rules hold as they
are for the CUDA card.

The central TPU-native design problem (SURVEY.md §7 hard-part #1/#2): Arrow
batches are ragged and typed for CPUs; XLA wants fixed shapes and hardware
lanes. Encoding rules:

- integers            → int64 device lanes (jax x64 enabled by the engine)
- date32              → int32 day counts (comparisons become int compares)
- float64 that proves to be N-decimal fixed-point (TPC-H money) → int64
  scaled integers: exact on-device arithmetic and overflow-safe to ~9.2e18
  scale units — beyond the SF1000 aggregate range at scale 1e6
- other float64       → float64 (XLA emulates f64 on TPU; correctness first,
  the money path is the fast path)
- strings             → dictionary codes (int32) + host-side dictionary; all
  string predicates become host-computed boolean LUTs over the dictionary,
  gathered on device (predicates never touch bytes on the TPU)
- booleans            → bool lanes
- NULLs               → per-column validity masks are NOT yet lowered; any
  nullable data falls back to the CPU engine at runtime

Rows are padded to the session's shape buckets with a row-validity mask so
one XLA compilation serves every batch in the bucket
(`ballista.tpu.shape.buckets`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch


@dataclass
class DeviceCol:
    kind: str  # i64 | f64 | money | date | code | bool
    data: Any  # np/jnp array, padded
    dictionary: Optional[list] = None  # for kind == "code"
    scale: int = 0  # for kind == "money": value = data / 10**scale
    valid: Optional[np.ndarray] = None  # bool validity plane; None = no nulls


@dataclass
class DeviceBatch:
    n_rows: int  # valid rows (<= padded length)
    columns: dict[str, DeviceCol]
    mask: Any  # bool[n_padded] row validity


def next_bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the largest bucket: round up to a multiple of it
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def repeated_names(names: list[str]) -> list[str]:
    """The names that occur more than once (a.x and b.x are both "x"): an
    encode that finds its columns by name must decline on them."""
    return sorted({n for n in names if names.count(n) > 1})


def _is_fixed_point(vals: np.ndarray, scale: int = 2) -> bool:
    if len(vals) == 0:
        return True
    m = 10**scale
    scaled = vals * m
    return bool(np.all(np.abs(scaled - np.rint(scaled)) < 1e-6))


def _narrow_int(vals: np.ndarray) -> np.ndarray:
    """Transfer-dtype narrowing: the PCIe/tunnel link is the bottleneck, so
    ship the smallest int that holds the range; device readers upcast to
    int64 in HBM (free relative to the link)."""
    if len(vals) == 0:
        return vals.astype(np.int32)
    lo, hi = int(vals.min()), int(vals.max())
    if -(2**15) <= lo and hi < 2**15:
        return vals.astype(np.int16)
    if -(2**31) <= lo and hi < 2**31:
        return vals.astype(np.int32)
    return vals.astype(np.int64)


def encode_column(arr: pa.Array) -> Optional[DeviceCol]:
    """Encode one Arrow column; None = not encodable (fallback to CPU).

    Nullable columns encode with a boolean VALIDITY PLANE riding alongside
    the value lane: null slots are filled with a type default (the plane,
    not the fill value, is what kernels consult) so stages over NULL-bearing
    data stay on device instead of falling back to the CPU engine."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    valid = np.asarray(arr.is_valid()) if arr.null_count else None

    def v(col: DeviceCol) -> DeviceCol:
        col.valid = valid
        return col

    if pa.types.is_dictionary(t):
        idx = arr.indices
        if idx.null_count:
            idx = pc.fill_null(idx, 0)
        codes = idx.to_numpy(zero_copy_only=False)
        return v(DeviceCol("code", _narrow_int(codes), dictionary=arr.dictionary.to_pylist()))
    if arr.null_count:
        if pa.types.is_boolean(t):
            arr = pc.fill_null(arr, False)
        elif pa.types.is_date(t):
            filled = pc.fill_null(arr.cast(pa.int32() if pa.types.is_date32(t) else pa.int64(),
                                           safe=False), 0)
            days = filled.to_numpy(zero_copy_only=False)
            if pa.types.is_date64(t):
                days = days // 86_400_000  # ms → days
            return v(DeviceCol("date", days.astype(np.int32)))
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            pass  # dictionary_encode keeps nulls in the index; filled below
        else:
            arr = pc.fill_null(arr, 0)
    if pa.types.is_integer(t):
        vals = arr.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False)
        return v(DeviceCol("i64", _narrow_int(vals.astype(np.int64, copy=False))))
    if pa.types.is_date(t):
        if pa.types.is_date64(t):
            ms = arr.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False)
            return v(DeviceCol("date", (ms // 86_400_000).astype(np.int32)))
        return v(DeviceCol("date", arr.cast(pa.int32(), safe=False).to_numpy(zero_copy_only=False)))
    if pa.types.is_boolean(t):
        return v(DeviceCol("bool", arr.to_numpy(zero_copy_only=False)))
    if pa.types.is_decimal(t):
        # exact decimal policy: unscaled int64 goes straight to the device
        # money lane — no float sniffing, the scale is declared. Wide or
        # deep-scaled decimals fall to f64 (lossy only past 2^53).
        s = t.scale
        if pa.types.is_decimal128(t) and 0 <= s <= 4 and t.precision - s <= 14:
            scaled = pc.multiply(arr, pa.scalar(10 ** s, pa.int64())) if s else arr
            vals = pc.cast(scaled, pa.int64()).to_numpy(zero_copy_only=False)
            return v(DeviceCol("money", _narrow_int(vals), scale=s))
        vals = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
        return v(DeviceCol("f64", vals))
    if pa.types.is_floating(t):
        vals = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
        if _is_fixed_point(vals, 2):
            return v(DeviceCol("money", _narrow_int(np.rint(vals * 100)), scale=2))
        return v(DeviceCol("f64", vals))
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        enc = pc.dictionary_encode(arr)
        if isinstance(enc, pa.ChunkedArray):
            enc = enc.combine_chunks()
        idx = enc.indices
        if idx.null_count:
            idx = pc.fill_null(idx, 0)
        codes = idx.to_numpy(zero_copy_only=False)
        return v(DeviceCol("code", _narrow_int(codes), dictionary=enc.dictionary.to_pylist()))
    return None


def encode_stacked(arr: pa.Array, part_rows: list[int], n_padded: int) -> Optional[DeviceCol]:
    """Encode one whole-scan column and lay it out as a [P, N] partition
    stack (row `off:off+part_rows[p]` of the flat encoding → `stack[p, :r]`,
    zero-padded). The single code path shared by the serial and pipelined
    device fills, so both are byte-identical by construction. The flat
    encoding is dropped before returning: peak host memory per column is
    one flat copy + one stack, not both for the table's lifetime."""
    dc = encode_column(arr)
    if dc is None:
        return None
    P = len(part_rows)
    stack = np.zeros((P, n_padded), dtype=dc.data.dtype)
    off = 0
    for p, r in enumerate(part_rows):
        stack[p, :r] = dc.data[off : off + r]
        off += r
    vstack = None
    if dc.valid is not None:
        vstack = np.zeros((P, n_padded), dtype=bool)
        off = 0
        for p, r in enumerate(part_rows):
            vstack[p, :r] = dc.valid[off : off + r]
            off += r
    return DeviceCol(dc.kind, stack, dictionary=dc.dictionary, scale=dc.scale,
                     valid=vstack)


def encode_table(tbl: pa.Table, buckets: list[int]) -> Optional[DeviceBatch]:
    n = tbl.num_rows
    padded = next_bucket(max(n, 1), buckets)
    cols: dict[str, DeviceCol] = {}
    for name, col in zip(tbl.column_names, tbl.columns):
        dc = encode_column(col)
        if dc is None:
            return None
        dc.data = _pad(dc.data, padded)
        cols[name] = dc
    mask = np.zeros(padded, dtype=bool)
    mask[:n] = True
    return DeviceBatch(n, cols, mask)


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) == n:
        return a
    out = np.zeros(n, dtype=a.dtype)
    out[: len(a)] = a
    return out


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Upload one encoded host array to `device`, keeping its dtype."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch tensors may not alias read-only memory
    return torch.as_tensor(arr).to(device)


def decode_value(val: float | int, kind: str, scale: int):
    if kind == "money":
        return val / (10**scale)
    return val
