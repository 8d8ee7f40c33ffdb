"""Vectorized equi-join matching on the host.

Strategy: encode the join keys of both sides into one composite int64 id
space (joint dictionary-encode per column, then mix), then sort-probe with
searchsorted. Handles duplicate keys (full match expansion), NULL keys
(never match), and multi-column keys. This same algorithm — sorted build
side + binary-search probe — is what the TPU engine expresses in jax
(ops/tpu/kernels.py), so CPU and TPU joins share shape and semantics.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


def _combined_ids(build_cols: list[pa.Array], probe_cols: list[pa.Array]) -> tuple[np.ndarray, np.ndarray]:
    """Encode key columns of both sides into one id space.

    Returns (build_ids, probe_ids) int64, -1 marks NULL (never matches).
    """
    nb = len(build_cols[0])
    b_ids = np.zeros(nb, dtype=np.int64)
    p_ids = np.zeros(len(probe_cols[0]), dtype=np.int64)
    b_null = np.zeros(nb, dtype=bool)
    p_null = np.zeros(len(probe_cols[0]), dtype=bool)
    for bcol, pcol in zip(build_cols, probe_cols):
        if isinstance(bcol, pa.ChunkedArray):
            bcol = bcol.combine_chunks()
        if isinstance(pcol, pa.ChunkedArray):
            pcol = pcol.combine_chunks()
        if bcol.type != pcol.type:
            target = _common_type(bcol.type, pcol.type)
            bcol = bcol.cast(target)
            pcol = pcol.cast(target)
        both = pa.chunked_array([bcol, pcol]) if len(pcol) else pa.chunked_array([bcol])
        codes_arr = pc.dictionary_encode(both).combine_chunks()
        codes = codes_arr.indices.to_numpy(zero_copy_only=False)
        codes = np.where(np.isnan(codes), -1, codes).astype(np.int64) if codes.dtype.kind == "f" else codes.astype(np.int64)
        card = len(codes_arr.dictionary) + 1
        bc = codes[:nb]
        pc_ = codes[nb:] if len(pcol) else np.zeros(0, dtype=np.int64)
        b_null |= bc < 0
        p_null |= pc_ < 0
        b_ids = b_ids * card + (bc + 1)
        p_ids = p_ids * card + (pc_ + 1)
    b_ids[b_null] = -1
    p_ids[p_null] = -2  # distinct from build's null so they never match
    return b_ids, p_ids


# PreparedBuild's tables over a dense range (an integer key's codes, the
# match ranges of the build ids): used where the range spans at most this
# or 4x the build's rows
DENSE_IDS_MIN = 1 << 20


def _common_type(a: pa.DataType, b: pa.DataType) -> pa.DataType:
    if pa.types.is_floating(a) or pa.types.is_floating(b):
        return pa.float64()
    if pa.types.is_integer(a) and pa.types.is_integer(b):
        return pa.int64()
    if pa.types.is_string(a) or pa.types.is_string(b):
        return pa.string()
    return a


def _key_np(arr: pa.Array, target: pa.DataType):
    """(numpy values, null mask|None) for a join key column; values are
    comparable within one column's space (null slots hold fills)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if arr.type != target:
        arr = arr.cast(target, safe=False)
    null = np.asarray(pc.is_null(arr)) if arr.null_count else None
    t = arr.type
    if pa.types.is_date(t) or pa.types.is_timestamp(t):
        # pyarrow has no direct date32→int64 cast; hop through the storage int
        arr = arr.cast(pa.int32() if pa.types.is_date32(t) else pa.int64(), safe=False)
        t = arr.type
    if pa.types.is_integer(t) or pa.types.is_boolean(t):
        filled = pc.fill_null(arr, False if pa.types.is_boolean(t) else 0) if arr.null_count else arr
        return filled.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False), null
    if pa.types.is_floating(t):
        filled = pc.fill_null(arr, 0.0) if arr.null_count else arr
        return filled.cast(pa.float64()).to_numpy(zero_copy_only=False), null
    # strings / binary: object arrays (python compare); null slots fill ""
    filled = pc.fill_null(arr, "") if arr.null_count else arr
    return filled.to_numpy(zero_copy_only=False), null


def _is_bytes(t: pa.DataType) -> bool:
    return (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t))


def _key_arrow(arr, target: pa.DataType):
    """_key_np for a string or binary key column, kept in Arrow: (values
    with null slots filled "", null mask|None)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if arr.type != target:
        arr = arr.cast(target, safe=False)
    null = np.asarray(pc.is_null(arr)) if arr.null_count else None
    empty = b"" if pa.types.is_binary(target) or pa.types.is_large_binary(target) else ""
    return (pc.fill_null(arr, pa.scalar(empty, target)) if arr.null_count else arr), null


class PreparedBuild:
    """Build side encoded + sorted ONCE, probed many times.

    The join executes per probe batch; re-encoding a multi-million-row
    build side (or rebuilding a hash set of it, as pyarrow's index_in does
    per call) for every batch dominated q21's runtime. Preparation sorts
    each key column's distinct values once; probe batches map in with a
    pure-numpy binary search (a table over a dense integer range, an Arrow
    hash lookup for strings) — absent values get no code and never match."""

    def __init__(self, build_cols: list[pa.Array]):
        self.n = len(build_cols[0]) if build_cols else 0
        self.sorted_vals: list[np.ndarray] = []
        self.types: list[pa.DataType] = []
        self.cards: list[int] = []
        # per integer key column over a dense range: (its least value, the
        # code of each value in the range, -1 where absent)
        self.code_tables: list = []
        b_ids = np.zeros(self.n, dtype=np.int64)
        b_null = np.zeros(self.n, dtype=bool)
        for bcol in build_cols:
            t = bcol.type if not isinstance(bcol, pa.ChunkedArray) else bcol.combine_chunks().type
            self.types.append(t)
            dense = None
            if _is_bytes(t):
                # strings: Arrow's hash kernels, not numpy's sort and binary
                # search over Python objects (q47's string join keys)
                vals, null = _key_arrow(bcol, t)
                uniq = vals.unique()
                uniq = uniq.take(pc.array_sort_indices(uniq))
                codes = pc.index_in(vals, value_set=uniq).to_numpy(zero_copy_only=False)
            else:
                vals, null = _key_np(bcol, t)
                least = int(vals.min()) if vals.dtype.kind == "i" and len(vals) else None
                span = int(vals.max()) - least + 1 if least is not None else 0
                if least is not None and span <= max(DENSE_IDS_MIN, 4 * len(vals)):
                    # integers over a dense range: the distinct values and
                    # their codes from one count, no sort or binary search
                    present = np.bincount(vals - least, minlength=span) > 0
                    uniq = np.flatnonzero(present) + least
                    dense = (least, np.where(present, np.cumsum(present) - 1, -1))
                    codes = dense[1][vals - least]
                else:
                    uniq = np.unique(vals)
                    codes = np.searchsorted(uniq, vals)
            self.code_tables.append(dense)
            card = len(uniq) + 1
            self.sorted_vals.append(uniq)
            self.cards.append(card)
            if null is not None:
                b_null |= null
            b_ids = b_ids * card + (codes + 1)
        b_ids[b_null] = -1
        order = np.argsort(b_ids, kind="stable")
        sorted_ids = b_ids[order]
        start_valid = np.searchsorted(sorted_ids, 0, side="left")  # ids >= 0
        self.sorted_valid = sorted_ids[start_valid:]
        self.order_valid = order[start_valid:]
        # ids are mixed-radix codes, so a one-column key's lie in
        # [1, distinct values]: where they are that dense, a probe reads
        # its range [lo, lo + count) from two tables instead of two binary
        # searches
        self.lo_table = self.cnt_table = None
        n_valid = len(self.sorted_valid)
        if n_valid and int(self.sorted_valid[-1]) < max(DENSE_IDS_MIN, 4 * n_valid):
            self.cnt_table = np.bincount(self.sorted_valid)
            self.lo_table = np.cumsum(self.cnt_table) - self.cnt_table

    def probe_ids(self, probe_cols: list[pa.Array]) -> np.ndarray:
        p_ids = np.zeros(len(probe_cols[0]), dtype=np.int64)
        p_null = np.zeros(len(probe_cols[0]), dtype=bool)
        for pcol, uniq, card, t, dense in zip(probe_cols, self.sorted_vals, self.cards,
                                              self.types, self.code_tables):
            if _is_bytes(t):
                vals, null = _key_arrow(pcol, t)
                codes = pc.fill_null(pc.index_in(vals, value_set=uniq), -1)
                codes = codes.to_numpy(zero_copy_only=False).astype(np.int64)
            elif dense is not None:
                vals, null = _key_np(pcol, t)
                least, code_of = dense
                inside = (vals >= least) & (vals <= least + len(code_of) - 1)
                codes = np.where(inside, code_of[np.where(inside, vals - least, 0)], -1)
            else:
                vals, null = _key_np(pcol, t)
                pos = np.searchsorted(uniq, vals)
                posc = np.clip(pos, 0, max(len(uniq) - 1, 0))
                if len(uniq):
                    present = uniq[posc] == vals
                else:
                    present = np.zeros(len(vals), dtype=bool)
                codes = np.where(present, posc, -1)
            if null is not None:
                codes = np.where(null, -1, codes)
            p_null |= codes < 0  # input NULL or value absent from the build
            p_ids = p_ids * card + (codes + 1)
        p_ids[p_null] = -2
        return p_ids

    def match(self, probe_cols: list[pa.Array]):
        """All matching (build_idx, probe_idx) pairs for one probe batch."""
        p_ids = self.probe_ids(probe_cols)
        if self.cnt_table is not None:
            inside = (p_ids >= 0) & (p_ids < len(self.cnt_table))
            at = np.where(inside, p_ids, 0)
            lo = self.lo_table[at]
            counts = np.where(inside, self.cnt_table[at], 0)
        else:
            lo = np.searchsorted(self.sorted_valid, p_ids, side="left")
            hi = np.searchsorted(self.sorted_valid, p_ids, side="right")
            counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        probe_idx = np.repeat(np.arange(len(p_ids), dtype=np.int64), counts)
        # expand [lo, hi) ranges: standard cumsum trick
        offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
        flat = np.arange(total, dtype=np.int64) - np.repeat(offs, counts) + np.repeat(lo, counts)
        build_idx = self.order_valid[flat]
        return build_idx, probe_idx


def match_pairs(build_cols: list[pa.Array], probe_cols: list[pa.Array]):
    """All matching (build_idx, probe_idx) pairs.

    Returns (build_idx int64[M], probe_idx int64[M]); NULL keys never match.
    One-shot form; executors that probe many batches against one build use
    PreparedBuild directly."""
    b_ids, p_ids = _combined_ids(build_cols, probe_cols)
    order = np.argsort(b_ids, kind="stable")
    sorted_ids = b_ids[order]
    # exclude nulls from the probe-able range
    start_valid = np.searchsorted(sorted_ids, 0, side="left")  # ids >= 0
    sorted_valid = sorted_ids[start_valid:]
    order_valid = order[start_valid:]

    lo = np.searchsorted(sorted_valid, p_ids, side="left")
    hi = np.searchsorted(sorted_valid, p_ids, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    probe_idx = np.repeat(np.arange(len(p_ids), dtype=np.int64), counts)
    # expand [lo, hi) ranges: standard cumsum trick
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    flat = np.arange(total, dtype=np.int64) - np.repeat(offs, counts) + np.repeat(lo, counts)
    build_idx = order_valid[flat]
    return build_idx, probe_idx
