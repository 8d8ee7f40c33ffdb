"""Deterministic row hashing for repartitioning.

THE WIRE CONTRACT: the hash of a row must be identical no matter which
engine (cpu numpy, tpu jax, native C++) computed it, or shuffled data lands
in the wrong partition. Mirrors the role of the reference's fixed-seed
ahash in RepartitionExec. Algorithm: per-column 64-bit mix (splitmix64 over
the canonical int64 encoding of the value), columns combined with a
boost-style hash_combine. Null hashes to a fixed tag.

The jax twin of this function lives in ops/tpu/kernels.py
(hash64/hash_combine) and tests assert they agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

_NULL_TAG = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer; x is uint64."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return (x ^ (x >> np.uint64(31))).astype(np.uint64)


def hash_combine(h: np.ndarray, v: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (h ^ (v + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2)))).astype(np.uint64)


def _int64_encoding(arr: pa.Array) -> tuple[np.ndarray, np.ndarray | None]:
    """Canonical int64 view of an array + validity mask (None = all valid)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    mask = None
    if arr.null_count:
        mask = np.asarray(arr.is_valid())
    if pa.types.is_dictionary(t):
        arr = arr.cast(t.value_type)
        return _int64_encoding(arr)
    # For every fixed-width branch: fill nulls BEFORE to_numpy. A nullable
    # array round-trips through float64 in to_numpy, which both loses int64
    # precision past 2^53 and (without an astype) would bit-reinterpret
    # float64 as uint64 — breaking the cross-engine wire contract with the
    # native router (ops/native.py fills then converts exactly). Null slots
    # are overridden to _NULL_TAG by the mask downstream, so the fill value
    # never reaches a hash.
    import pyarrow.compute as pc

    if pa.types.is_integer(t):
        filled = pc.fill_null(arr, 0) if arr.null_count else arr
        vals = filled.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False)
        return vals.astype(np.int64, copy=False).view(np.uint64), mask
    if pa.types.is_date(t):
        # date32 is days-int32, date64 is ms-int64; Arrow has no date64→int32
        as_int = arr.cast(pa.int32() if pa.types.is_date32(t) else pa.int64(), safe=False)
        filled = pc.fill_null(as_int, 0) if arr.null_count else as_int
        vals = filled.cast(pa.int64()).to_numpy(zero_copy_only=False)
        return vals.astype(np.int64, copy=False).view(np.uint64), mask
    if pa.types.is_boolean(t):
        filled = pc.fill_null(arr, False) if arr.null_count else arr
        vals = filled.cast(pa.int64()).to_numpy(zero_copy_only=False)
        return vals.astype(np.int64, copy=False).view(np.uint64), mask
    if pa.types.is_floating(t):
        filled = pc.fill_null(arr, 0.0) if arr.null_count else arr
        vals = filled.cast(pa.float64()).to_numpy(zero_copy_only=False)
        # normalize -0.0 to 0.0 so equal keys hash equal
        vals = np.where(vals == 0.0, 0.0, vals)
        return vals.view(np.uint64), mask
    if pa.types.is_decimal(t):
        # exact policy: decimal keys route by unscaled int64 when it fits;
        # wider decimals route by their float64 image (routing only needs
        # equal keys → equal hash, which a deterministic cast preserves)
        filled = pc.fill_null(arr, 0) if arr.null_count else arr
        if pa.types.is_decimal128(t) and t.precision <= 18:
            scaled = pc.multiply(filled, pa.scalar(10 ** t.scale, pa.int64())) \
                if t.scale else filled
            vals = pc.cast(scaled, pa.int64()).to_numpy(zero_copy_only=False)
            return vals.astype(np.int64, copy=False).view(np.uint64), mask
        vals = filled.cast(pa.float64()).to_numpy(zero_copy_only=False)
        vals = np.where(vals == 0.0, 0.0, vals)
        return vals.view(np.uint64), mask
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t):
        # FNV-1a over utf8 bytes, vectorized via offsets
        data = arr.cast(pa.large_binary())
        buffers = data.buffers()
        offsets = np.frombuffer(buffers[1], dtype=np.int64, count=len(arr) + 1 + (data.offset))
        offsets = offsets[data.offset : data.offset + len(arr) + 1]
        raw = np.frombuffer(buffers[2], dtype=np.uint8) if buffers[2] is not None else np.zeros(0, np.uint8)
        return _fnv1a_segments(raw, offsets), mask
    raise TypeError(f"unhashable key type {t}")


def fnv1a_str(s: str) -> int:
    """Scalar FNV-1a over utf8 bytes — the per-dictionary-entry twin of
    _fnv1a_segments, used to build device hash LUTs for string keys."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _fnv1a_segments(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """FNV-1a per segment. Vectorized over fixed byte positions: iterate
    max_len times over a (n,) lane, cheap because strings are short keys."""
    n = len(offsets) - 1
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    max_len = int(lens.max()) if n else 0
    with np.errstate(over="ignore"):
        for i in range(max_len):
            sel = lens > i
            idx = offsets[:-1][sel] + i
            h_sel = h[sel]
            h_sel = ((h_sel ^ data[idx].astype(np.uint64)) * np.uint64(0x100000001B3)).astype(np.uint64)
            h[sel] = h_sel
    return h


def hash_arrays(arrays: list[pa.Array]) -> np.ndarray:
    """Combined row hash over multiple key columns → uint64[n]."""
    n = len(arrays[0])
    out = np.zeros(n, dtype=np.uint64)
    for arr in arrays:
        enc, mask = _int64_encoding(arr)
        hv = splitmix64(enc)
        if mask is not None:
            hv = np.where(mask, hv, _NULL_TAG)
        out = hash_combine(out, hv)
    return out


def partition_indices(arrays: list[pa.Array], num_partitions: int) -> np.ndarray:
    """Row → output partition id (uint64 % K, same as the jax kernel)."""
    return (hash_arrays(arrays) % np.uint64(num_partitions)).astype(np.int64)


def split_batch_by_partition(batch: pa.RecordBatch, key_arrays: list[pa.Array], k: int,
                             precomputed_pids: np.ndarray | None = None):
    """Route a batch's rows into K partition sub-batches in one pass.

    Uses the native C++ router (hash + counting-sort grouping, then a single
    Arrow take + zero-copy slices) when available; numpy otherwise. When the
    producer already computed partition ids (device-side routing: the TPU
    stage emits a __pid column via the jax hash twin), they feed the router
    directly — pid < k, so routing on h=pid with h%k is the identity.
    Yields (partition_id, sub_batch) for non-empty partitions.
    """
    from ballista_tpu_torch.ops import native

    if precomputed_pids is not None:
        h = precomputed_pids.astype(np.uint64)
    else:
        h = native.hash_arrays_native(key_arrays)
        if h is None:
            h = hash_arrays(key_arrays)
    routed = native.route_native(h, k)
    if routed is not None:
        _, bounds, order = routed
        taken = batch.take(pa.array(order))
        for p in range(k):
            n = int(bounds[p + 1] - bounds[p])
            if n:
                yield p, taken.slice(int(bounds[p]), n)
        return
    pids = (h % np.uint64(k)).astype(np.int64)
    for p in np.unique(pids):
        sel = np.nonzero(pids == p)[0]
        yield int(p), batch.take(pa.array(sel))
