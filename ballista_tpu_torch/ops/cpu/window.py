"""Window function computation over one physical partition.

The operator contract (plan/physical.py::WindowExec): rows of one window
partition-key group never span physical partitions (the physical planner
hash-repartitions on PARTITION BY, or coalesces to one partition when
there is none), so each partition computes independently:

sort by (partition keys, order keys) → segment boundaries → vectorized
per-segment kernels → scatter results back to input row order. Window
expressions sharing a (PARTITION BY, ORDER BY) spec share one sort and
one set of boundaries.

Frames follow SQL defaults: aggregates with ORDER BY run RANGE UNBOUNDED
PRECEDING..CURRENT ROW (peer rows share a value — implemented by reading
the running value at each peer group's LAST row); without ORDER BY the
whole partition. The reference defers all of this to DataFusion's window
operators (SURVEY.md §1 layer 0 — engine under it all).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
from ballista_tpu_torch.plan.expressions import WindowFunction
from ballista_tpu_torch.plan.schema import DFSchema


@dataclass
class _Frame:
    """Shared per-(partition_by, order_by) sort state."""

    idx: np.ndarray        # sorted row order
    inv: np.ndarray        # inverse permutation: original pos → sorted pos
    new_part: np.ndarray   # bool: row starts a new window partition
    new_peer: np.ndarray   # bool: row starts a new peer group
    seg_start: np.ndarray  # per row: index of its partition's first row
    seg_end: np.ndarray    # per row: index of its partition's last row


def compute_windows(batch: pa.RecordBatch, window_exprs: list[WindowFunction],
                    schema: DFSchema) -> list[pa.Array]:
    frames: dict[tuple, _Frame] = {}
    out = []
    for w in window_exprs:
        key = (
            tuple(str(e) for e in w.partition_by),
            tuple(str(k) for k in w.order_by),
        )
        fr = frames.get(key)
        if fr is None:
            fr = _build_frame(batch, w, schema)
            frames[key] = fr
        out.append(_compute_one(batch, w, schema, fr))
    return out


def _sort_indices(key_arrays: list[pa.Array],
                  orders: list[tuple[bool, bool]]) -> np.ndarray:
    """Lexicographic sort honoring per-key nulls placement: each nullable
    key gets a null-rank prefix column, so NULLS FIRST/LAST is exact
    regardless of pyarrow's global null_placement."""
    cols: dict[str, pa.Array] = {}
    sort_keys = []
    for i, (a, (asc, nulls_first)) in enumerate(zip(key_arrays, orders)):
        if a.null_count:
            rank = pc.cast(a.is_null(), pa.int8())
            cols[f"n{i}"] = rank
            sort_keys.append((f"n{i}", "descending" if nulls_first else "ascending"))
        cols[f"k{i}"] = a
        sort_keys.append((f"k{i}", "ascending" if asc else "descending"))
    idx = pc.sort_indices(pa.table(cols), sort_keys=sort_keys)
    return idx.to_numpy(zero_copy_only=False).astype(np.int64)


def _changes(arrays: list[pa.Array], idx: np.ndarray) -> np.ndarray:
    """bool[n]: row i (in sorted order) starts a new group of the given
    keys. Row 0 is always True. Nulls compare equal for grouping."""
    n = len(idx)
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    out[0] = True
    for a in arrays:
        taken = a.take(pa.array(idx))
        neq = pc.fill_null(pc.not_equal(taken.slice(1), taken.slice(0, n - 1)), False)
        lv = taken.is_valid().to_numpy(zero_copy_only=False)
        neq_np = neq.to_numpy(zero_copy_only=False).astype(bool)
        valid_change = lv[1:] != lv[:-1]
        out[1:] |= neq_np | valid_change
    return out


def _build_frame(batch: pa.RecordBatch, w: WindowFunction, schema: DFSchema) -> _Frame:
    n = batch.num_rows
    part_arrays = [evaluate_to_array(bind_expr(e, schema), batch) for e in w.partition_by]
    order_arrays = [evaluate_to_array(bind_expr(k.expr, schema), batch) for k in w.order_by]
    keys = part_arrays + order_arrays
    orders = [(True, False)] * len(part_arrays) + [
        (k.ascending, k.nulls_first) for k in w.order_by
    ]
    idx = _sort_indices(keys, orders) if keys else np.arange(n, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[idx] = np.arange(n, dtype=np.int64)

    new_part = _changes(part_arrays, idx) if part_arrays else _first_only(n)
    new_peer = new_part | (_changes(order_arrays, idx) if order_arrays else np.zeros(n, bool))
    arange = np.arange(n, dtype=np.int64)
    seg_start = np.maximum.accumulate(np.where(new_part, arange, 0))
    starts = np.flatnonzero(new_part)
    ends = np.r_[starts[1:] - 1, n - 1] if len(starts) else np.array([], dtype=np.int64)
    counts = ends - starts + 1 if len(starts) else np.array([], dtype=np.int64)
    seg_end = np.repeat(ends, counts) if len(starts) else np.zeros(n, dtype=np.int64)
    return _Frame(idx, inv, new_part, new_peer, seg_start, seg_end)


def _compute_one(batch: pa.RecordBatch, w: WindowFunction, schema: DFSchema,
                 fr: _Frame) -> pa.Array:
    n = batch.num_rows
    out_type = w.data_type(schema)
    if n == 0:
        return pa.array([], out_type)

    arange = np.arange(n, dtype=np.int64)
    func = w.func
    if func == "row_number":
        out_sorted = arange - fr.seg_start + 1
    elif func == "rank":
        peer_start = np.maximum.accumulate(np.where(fr.new_peer, arange, 0))
        out_sorted = peer_start - fr.seg_start + 1
    elif func == "dense_rank":
        cum = np.cumsum(fr.new_peer.astype(np.int64))
        out_sorted = cum - cum[fr.seg_start] + 1
    elif func in ("lag", "lead"):
        return _lag_lead(batch, w, schema, fr, arange, n, out_type)
    elif func in ("sum", "avg", "min", "max", "count"):
        return _window_agg(batch, w, schema, fr, n, out_type)
    else:
        raise ExecutionError(f"unknown window function {func}")

    out = np.empty(n, dtype=np.int64)
    out[fr.idx] = out_sorted
    return pa.array(out, out_type)


def _first_only(n: int) -> np.ndarray:
    out = np.zeros(n, dtype=bool)
    if n:
        out[0] = True
    return out


def _peer_last(new_peer: np.ndarray, n: int) -> np.ndarray:
    """index of the LAST row of each row's peer group (sorted order)."""
    b = np.flatnonzero(new_peer)
    ends = np.r_[b[1:] - 1, n - 1]
    counts = ends - b + 1
    return np.repeat(ends, counts)


def _decimal_prepare(arr, w, out_type):
    """Exact decimal policy for window aggregates: narrow decimal128 input
    becomes unscaled int64 (exact sums/extremes in integer space; the
    emitter reconstructs the decimal); wide decimals and avg fall to
    float64. Returns (arr, dec_scale_or_None)."""
    t = arr.type
    if (w.func in ("sum", "min", "max") and pa.types.is_decimal128(t)
            and t.precision - t.scale <= 14 and pa.types.is_decimal(out_type)):
        filled = pc.fill_null(arr, 0)
        scaled = pc.multiply(filled, pa.scalar(10 ** t.scale, pa.int64())) if t.scale else filled
        return pc.cast(scaled, pa.int64()), t.scale
    return pc.cast(arr, pa.float64()), None


def _emit_agg(out: np.ndarray, out_type, mask, dec_scale):
    """Build the output array, reconstructing decimals from unscaled int64
    (via decimal256 headroom) or from the float fallback."""
    import decimal as _d

    if pa.types.is_decimal(out_type):
        if dec_scale is not None and out.dtype.kind == "i":
            a = pa.array(out, pa.int64(), mask=mask).cast(pa.decimal256(38, 0))
            if dec_scale:
                a = pc.multiply(a, pc.cast(pa.scalar(_d.Decimal(1).scaleb(-dec_scale)),
                                           pa.decimal256(1, dec_scale)))
            return pc.cast(a, out_type)
        return pa.array(out, pa.float64(), mask=mask).cast(out_type)
    return pa.array(out, out_type, mask=mask)


def _window_agg(batch, w, schema, fr: _Frame, n, out_type):
    seg_start = fr.seg_start
    dec_scale = None
    if w.args:
        arr = evaluate_to_array(bind_expr(w.args[0], schema), batch).take(pa.array(fr.idx))
        valid = arr.is_valid().to_numpy(zero_copy_only=False).astype(bool)
        if pa.types.is_decimal(arr.type):
            arr, dec_scale = _decimal_prepare(arr, w, out_type)
    else:  # count(*)
        arr = None
        valid = np.ones(n, dtype=bool)
    if w.frame is not None:
        return _rows_frame_agg(w, fr, arr, valid, n, out_type, dec_scale)
    last = _peer_last(fr.new_peer, n)

    if w.func == "count":
        cum = np.cumsum(valid.astype(np.int64))
        excl = cum[seg_start] - valid[seg_start]
        out_sorted = cum[last] - excl
        out = np.empty(n, dtype=np.int64)
        out[fr.idx] = out_sorted
        return pa.array(out, out_type)

    vals = arr.to_numpy(zero_copy_only=False)
    if w.func in ("sum", "avg"):
        as_float = (pa.types.is_floating(out_type) or w.func == "avg"
                    or np.issubdtype(np.asarray(vals).dtype, np.floating))
        v = np.asarray(vals, dtype=np.float64 if as_float else np.int64)
        v = np.where(valid, v, 0)
        cum = np.cumsum(v)
        excl = cum[seg_start] - v[seg_start]
        sums = cum[last] - excl
        ccum = np.cumsum(valid.astype(np.int64))
        cexcl = ccum[seg_start] - valid[seg_start]
        cnts = ccum[last] - cexcl
        if w.func == "avg":
            out_sorted = np.where(cnts > 0, sums / np.maximum(cnts, 1), np.nan)
        else:
            out_sorted = sums
        mask_sorted = cnts == 0  # SQL: aggregate over zero rows is NULL
    else:  # min / max: running extremes with segment resets (python per
        # segment boundary, vectorized inside via np.minimum.accumulate)
        fn = np.minimum if w.func == "min" else np.maximum
        is_f = np.issubdtype(np.asarray(vals).dtype, np.floating) or pa.types.is_floating(out_type)
        v = np.asarray(vals, dtype=np.float64 if is_f else np.int64)
        sentinel = np.inf if w.func == "min" else -np.inf
        if not is_f:
            sentinel = np.iinfo(np.int64).max if w.func == "min" else np.iinfo(np.int64).min
        v = np.where(valid, v, sentinel)
        out_sorted = np.empty_like(v)
        starts = np.flatnonzero(fr.new_part)
        bounds = np.r_[starts, n]
        for i in range(len(starts)):
            seg = slice(bounds[i], bounds[i + 1])
            out_sorted[seg] = fn.accumulate(v[seg])
        out_sorted = out_sorted[last]  # peers share
        ccum = np.cumsum(valid.astype(np.int64))
        cexcl = ccum[seg_start] - valid[seg_start]
        mask_sorted = (ccum[last] - cexcl) == 0

    out = np.empty(n, dtype=out_sorted.dtype)
    out[fr.idx] = out_sorted
    mask = np.empty(n, dtype=bool)
    mask[fr.idx] = mask_sorted
    return _emit_agg(out, out_type, mask, dec_scale)


def _rows_frame_agg(w, fr: _Frame, arr, valid, n, out_type, dec_scale=None):
    """Explicit ROWS BETWEEN frames: per-row [lo, hi] windows clipped to the
    partition; sums/counts via prefix differences, min/max via per-row
    slices (frames are exact row offsets — no peer sharing)."""
    _, start, end = w.frame
    arange = np.arange(n, dtype=np.int64)
    lo = fr.seg_start if start is None else np.maximum(fr.seg_start, arange + start)
    hi = fr.seg_end if end is None else np.minimum(fr.seg_end, arange + end)
    # frames wholly before/after the partition are EMPTY (0 / NULL) — decide
    # before clamping, or boundary rows would be dragged into range
    empty = hi < lo
    lo = np.clip(lo, fr.seg_start, fr.seg_end)
    hi = np.clip(hi, fr.seg_start, fr.seg_end)

    vcum = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    counts = np.where(empty, 0, vcum[np.clip(hi, 0, n - 1) + 1] - vcum[np.clip(lo, 0, n - 1)])

    if w.func == "count":
        out = np.empty(n, dtype=np.int64)
        out[fr.idx] = counts
        return pa.array(out, out_type)

    vals = arr.to_numpy(zero_copy_only=False)
    as_float = (pa.types.is_floating(out_type) or w.func == "avg"
                or np.issubdtype(np.asarray(vals).dtype, np.floating))
    if w.func in ("sum", "avg"):
        v = np.asarray(vals, dtype=np.float64 if as_float else np.int64)
        v = np.where(valid, v, 0)
        csum = np.concatenate([[0], np.cumsum(v)])
        sums = np.where(empty, 0, csum[np.clip(hi, 0, n - 1) + 1] - csum[np.clip(lo, 0, n - 1)])
        if w.func == "avg":
            out_sorted = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
        else:
            out_sorted = sums
    else:  # min / max: vectorized per SEGMENT (accumulate for one-sided
        # frames, sentinel-padded sliding windows for bounded ones)
        is_f = np.issubdtype(np.asarray(vals).dtype, np.floating) or pa.types.is_floating(out_type)
        v = np.asarray(vals, dtype=np.float64 if is_f else np.int64)
        sentinel = (np.inf if w.func == "min" else -np.inf) if is_f else (
            np.iinfo(np.int64).max if w.func == "min" else np.iinfo(np.int64).min
        )
        v = np.where(valid, v, sentinel)
        red = np.minimum if w.func == "min" else np.maximum
        out_sorted = np.full(n, sentinel, dtype=v.dtype)
        starts = np.flatnonzero(fr.new_part)
        seg_bounds = np.r_[starts, n]
        for si in range(len(starts)):
            s0, s1 = int(seg_bounds[si]), int(seg_bounds[si + 1])
            seg = v[s0:s1]
            local = np.arange(len(seg))
            if start is None and end is None:
                out_sorted[s0:s1] = red.reduce(seg)
            elif start is None:  # running extreme up to hi
                acc = red.accumulate(seg)
                out_sorted[s0:s1] = acc[np.clip(hi[s0:s1] - s0, 0, len(seg) - 1)]
            elif end is None:  # extreme from lo to segment end
                racc = red.accumulate(seg[::-1])[::-1]
                out_sorted[s0:s1] = racc[np.clip(lo[s0:s1] - s0, 0, len(seg) - 1)]
            else:
                width = end - start + 1
                if width >= 1:
                    pad = np.full(width - 1, sentinel, dtype=v.dtype)
                    padded = np.concatenate([pad, seg, pad])
                    sw = np.lib.stride_tricks.sliding_window_view(padded, width)
                    idxs = np.clip(local + start + (width - 1), 0, len(sw) - 1)
                    out_sorted[s0:s1] = red.reduce(sw[idxs], axis=1)
    mask_sorted = counts == 0
    out = np.empty(n, dtype=out_sorted.dtype)
    out[fr.idx] = out_sorted
    mask = np.empty(n, dtype=bool)
    mask[fr.idx] = mask_sorted
    return _emit_agg(out, out_type, mask, dec_scale)


def _lag_lead(batch, w, schema, fr: _Frame, arange, n, out_type):
    if not w.args:
        raise ExecutionError(f"{w.func} requires a value argument")
    arr = evaluate_to_array(bind_expr(w.args[0], schema), batch).take(pa.array(fr.idx))
    offset = int(_literal_value(w.args[1])) if len(w.args) > 1 else 1
    default = _literal_value(w.args[2]) if len(w.args) > 2 else None

    src = arange - offset if w.func == "lag" else arange + offset
    # guard BOTH bounds: a negative offset must not walk into a neighboring
    # window partition
    ok = (src >= fr.seg_start) & (src <= fr.seg_end)
    srcc = np.clip(src, 0, n - 1)
    shifted = arr.take(pa.array(srcc))
    if shifted.type != out_type:
        shifted = shifted.cast(out_type)
    from ballista_tpu_torch.ops.phys_expr import py_for_type

    res_sorted = pc.if_else(pa.array(ok), shifted, pa.scalar(py_for_type(default, out_type), out_type))
    # scatter back to original row order
    return res_sorted.take(pa.array(fr.inv))


def _literal_value(e):
    from ballista_tpu_torch.plan.expressions import Literal, Negative

    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Negative):
        return -_literal_value(e.expr)
    raise ExecutionError(f"lag/lead offset/default must be literal, got {e}")
