"""On-device ORDER BY / window / top-k stage family on the CUDA card.

Counterpart of the JAX package's ops/tpu/sort_window.py. The host parts
(key evaluation and encoding, static eligibility, the oracle-shared
frame and emit logic, the counters) are copied from it verbatim; the
device parts are PyTorch on the explicit device of
`runtime.device(ctx.device_ordinal)`:

- `fused_pallas` (the mode name kept) runs the hand-written Hopper
  kernels `segmented_sort` / `topk_select` / `segmented_scan`
  (ops/cuda/cuda_kernels.py);
- `fused_xla` and `staged` take stable `torch.sort` passes, least
  significant key first, which give the permutation of the JAX package's
  one lexicographic `lax.sort` (fused_xla) and per-key sorts (staged);
  their window scans are the final stage's `_segscan`.

`maybe_compile_tpu` wraps eligible SortExec / WindowExec subtrees in
TpuSortStageExec / TpuWindowStageExec (`ballista.tpu.sort.enabled`). The
split of labor is the parity contract:

- The HOST evaluates the sort-key expressions with the exact same
  `bind_expr`/`evaluate_to_array` calls the CPU oracle sorts, encodes them
  to order-preserving int64 lanes (ints/dates widened, floats bit-twiddled,
  strings as lexicographic-rank dictionary codes, NULLS FIRST/LAST as a
  leading null-rank operand), and applies the resulting PERMUTATION with
  `pa.Table.take` — payload columns never leave the host, so the output
  bytes are the CPU engine's bytes by construction.
- The DEVICE computes only the permutation (and, for windows, the
  segmented scans). `CostModel.choose_sort` picks the mode per shape with
  the demotion ladder; an ineligible shape raises Unsupported and the
  operator falls back to the CPU oracle over the SAME materialized input
  (never re-executing the child). Only Unsupported falls back: a kernel
  build or launch error, or a missing card, raises out of the query.

Order-preserving int64 encoding per key kind:

  i64 / date / money / bool  value (or unscaled cents) as int64 — exact
  f64                        -0.0 canonicalized to +0.0, NaN to INT64_MAX
                             (pyarrow sorts NaN greatest), then the
                             sign-fold bit twiddle: b >= 0 → b, else
                             ~b | sign bit — total order == float order
  code                       host-ranked dictionary codes; equal strings
                             under duplicate dictionary entries share one
                             rank so ties fall through to stability
  DESC                       bitwise NOT of the ascending lane (no
                             INT64_MIN negation overflow)
  NULLS FIRST/LAST           leading operand: nulls_first → 1 - is_valid
                             complement trick below keeps nulls ahead;
                             always sorted ascending

Window aggregates keep the CPU oracle's skeleton (ops/cpu/window.py):
boundary flags and peer-last sharing are computed with the oracle's own
`_changes`/`_peer_last` over the device permutation, the per-segment
cumulative state runs as device segmented scans, and the oracle's
`_emit_agg`/`_decimal_prepare` build the output arrays — so NULL masks,
decimal reconstruction, and NaN peer-splitting are shared code, not
reimplementations.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import torch

from ballista_tpu_torch.config import (
    BallistaConfig,
    TPU_MIN_ROWS,
    TPU_SORT_ENABLED,
    TPU_TOPK_ENABLED,
)
from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
from ballista_tpu_torch.ops.cuda.columnar import encode_column
from ballista_tpu_torch.ops.cuda import runtime
from ballista_tpu_torch.ops.cuda.kernels import Unsupported
from ballista_tpu_torch.plan.expressions import SortKey, WindowFunction
from ballista_tpu_torch.plan.physical import (
    ExecutionPlan,
    TaskContext,
    _concat,
    _empty_batch,
    _sort_table,
)
from ballista_tpu_torch.plan.schema import DFSchema

log = logging.getLogger(__name__)

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_SIGN = 1 << 63

_WINDOW_DEVICE_FUNCS = ("row_number", "rank", "count", "sum", "min", "max")


# ---------------------------------------------------------------------------
# cumulative kernel counters (heartbeat gauges; the hbm spill-counter
# pattern — later clean runs must not erase earlier evidence)

_CTR_LOCK = threading.Lock()
_COUNTERS = {
    "sort_invocations": 0,
    "topk_invocations": 0,
    "window_invocations": 0,
    "topk_rows_kept": 0,
    "window_partitions": 0,
    "sort_full_materializations": 0,
}
_KERNEL_S = [0.0]


def _count(key: str, delta: int = 1) -> int:
    with _CTR_LOCK:
        _COUNTERS[key] += int(delta)
        val = _COUNTERS[key]
    _publish_counters()
    return val


def _publish_counters() -> None:
    """Mirror the cumulative counters into RUN_STATS (literal keys — the
    stats-sync pass matches emit sites by string constant)."""
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    with _CTR_LOCK:
        snap = dict(_COUNTERS)
    RUN_STATS.set("sort_invocations", snap["sort_invocations"])
    RUN_STATS.set("topk_invocations", snap["topk_invocations"])
    RUN_STATS.set("window_invocations", snap["window_invocations"])
    RUN_STATS.set("topk_rows_kept", snap["topk_rows_kept"])
    RUN_STATS.set("window_partitions", snap["window_partitions"])
    RUN_STATS.set("sort_full_materializations",
                  snap["sort_full_materializations"])


def _note_kernel_s(dt: float) -> None:
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    with _CTR_LOCK:
        _KERNEL_S[0] += dt
        val = round(_KERNEL_S[0], 4)
    RUN_STATS.set("sort_kernel_s", val)


def counters_snapshot() -> dict:
    with _CTR_LOCK:
        return dict(_COUNTERS, sort_kernel_s=round(_KERNEL_S[0], 4))


# ---------------------------------------------------------------------------
# host-side key encoding


def _dict_ranks(dictionary: list) -> np.ndarray:
    """code → lexicographic rank; duplicate dictionary values (legal in
    user-supplied dictionary arrays) share one rank so equal strings tie
    exactly like the CPU comparator and fall through to the next key."""
    if any(v is None for v in dictionary):
        raise Unsupported("null entry in sort-key dictionary")
    ranks = np.zeros(max(len(dictionary), 1), dtype=np.int64)
    order = sorted(range(len(dictionary)), key=lambda j: dictionary[j])
    r = -1
    prev = object()
    for j in order:
        if dictionary[j] != prev:
            r += 1
            prev = dictionary[j]
        ranks[j] = r
    return ranks


def _order_lane(arr: pa.Array):
    """Encode one evaluated key column as an order-preserving int64 lane.
    Returns (lane i64[n], is_valid bool[n] | None, nan bool[n] | None,
    kind)."""
    dc = encode_column(arr)
    if dc is None:
        raise Unsupported(f"unencodable sort key type {arr.type}")
    nan = None
    if dc.kind in ("i64", "date", "money"):
        lane = dc.data.astype(np.int64, copy=False)
    elif dc.kind == "bool":
        lane = dc.data.astype(np.int64)
    elif dc.kind == "code":
        lane = _dict_ranks(dc.dictionary)[dc.data.astype(np.int64, copy=False)]
    elif dc.kind == "f64":
        v = dc.data + 0.0  # canonicalize -0.0 → +0.0
        bits = v.view(np.int64)
        lane = np.where(bits >= 0, bits, (~bits) | np.int64(-_SIGN))
        nan = np.isnan(v)  # placed after the direction flip, see caller
    else:
        raise Unsupported(f"sort key kind {dc.kind}")
    return np.ascontiguousarray(lane), dc.valid, nan, dc.kind


def _encode_key_arrays(arrays: list, orders: list) -> tuple[list, list]:
    """Encode evaluated key arrays into device sort operands.

    `orders` is [(ascending, nulls_first)] per array. Returns
    (key_ops, key_meta): key_ops is [(null_rank i64[n] | None, lane
    i64[n])] to be sorted ASCENDING lexicographically with a trailing
    position tiebreak; key_meta is [(kind, nullable)] for the estimate."""
    key_ops: list = []
    key_meta: list = []
    for arr, (asc, nulls_first) in zip(arrays, orders):
        lane, valid, nan, kind = _order_lane(arr)
        if not asc:
            lane = ~lane
        if nan is not None and nan.any():
            # pyarrow sorts NaN at the END of the non-null block in BOTH
            # directions (placement, not magnitude), so the override goes
            # on top of the flipped lane. I64_MAX-1 needs float bits of a
            # NaN payload to reach → no real value collides, and it stays
            # strictly below the I64_MAX pad sentinel of the pallas rung.
            lane = np.where(nan, np.int64(_I64_MAX - 1), lane)
        nrank = None
        if valid is not None:
            is_null = (~valid).astype(np.int64)
            nrank = (1 - is_null) if nulls_first else is_null
            nrank = np.ascontiguousarray(nrank)
        key_ops.append((nrank, lane))
        key_meta.append((kind, valid is not None))
    return key_ops, key_meta


# ---------------------------------------------------------------------------
# device permutation


def _sort_cost_model(config: BallistaConfig, device: torch.device):
    from ballista_tpu_torch.ops.cuda import fusion

    cm = fusion.CostModel.from_config(config)
    cm.platform = device.type
    return cm


def _admit(est, config: BallistaConfig) -> None:
    """HBM admission for a sort/window stage: no splittable build side, so
    the ladder is run-whole vs CPU demotion, reason recorded."""
    from ballista_tpu_torch.ops.cuda import hbm
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    budget = hbm.resolve_hbm_budget(config)
    plan = hbm.plan_stage(est, budget, grace_eligible=False, grace_fanout=2,
                          grace_max_depth=0)
    RUN_STATS.set("hbm_budget_bytes", budget)
    RUN_STATS.set("hbm_plan", plan.decision)
    RUN_STATS.set("hbm_plan_reason", plan.reason)
    if plan.decision == hbm.CPU_DEMOTE:
        raise Unsupported(f"hbm admission: {plan.reason}")


class _Uploads:
    """Tracks actual device bytes of every operand shipped for a stage, so
    the fill test can assert estimate >= actual (RUN_STATS device_bytes)."""

    def __init__(self, device: torch.device):
        self.bytes = 0
        self.device = device

    def put(self, arr: np.ndarray) -> torch.Tensor:
        self.bytes += int(arr.nbytes)
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)


def _perm_full(key_ops: list, n: int, mode: str, up: _Uploads) -> np.ndarray:
    """Full ordering permutation of n rows by the encoded key operands."""
    if mode == "fused_pallas":
        from ballista_tpu_torch.ops.cuda.cuda_kernels import segmented_sort

        L = _pow2(n)
        pos = torch.arange(L, dtype=torch.int32, device=up.device)
        perm = pos.long()
        # LSD passes, least-significant key first: the kernel's position
        # operand makes each pass a stable sort by (null rank, lane), so
        # earlier passes' order survives ties. Sentinel lanes (i64 max on
        # BOTH operands) sort strictly after every real row because real
        # null-rank operands are 0/1.
        for nrank, lane in reversed(key_ops):
            a = up.put(_pad_i64(nrank if nrank is not None else
                                np.zeros(n, np.int64), L))
            b = up.put(_pad_i64(lane, L))
            _, _, p = segmented_sort(a[perm][None, :], b[perm][None, :],
                                     pos[None, :])
            perm = perm[p[0].long()]
        return perm.cpu().numpy()[:n]
    flat: list = []
    for nrank, lane in key_ops:
        if nrank is not None:
            flat.append(up.put(nrank))
        flat.append(up.put(lane))
    up.bytes += n * 4
    # staged: one stable sort per key, least-significant key first;
    # fused_xla: every operand in one lexicographic order with the
    # position as the final key. Stable torch.sort passes over the
    # operands, least significant first, give that one permutation for
    # both (the JAX package's lax.sort calls agree on it).
    from ballista_tpu_torch.ops.cuda.final_stage import _lexsort

    return _lexsort(flat).cpu().numpy()


def _perm_topk(key_ops: list, n: int, k: int, up: _Uploads) -> np.ndarray:
    """First-k permutation via the fused top-k kernel (single key only;
    the full sort is never materialized)."""
    from ballista_tpu_torch.ops.cuda.cuda_kernels import topk_select

    (nrank, lane), = key_ops
    L = _pow2(n)
    a = up.put(_pad_i64(nrank if nrank is not None else np.zeros(n, np.int64), L))
    b = up.put(_pad_i64(lane, L))
    pos = torch.arange(L, dtype=torch.int32, device=up.device)
    up.bytes += L * 4
    kk = min(int(k), n)
    _, _, sp = topk_select(a[None, :], b[None, :], pos[None, :], kk)
    return sp[0].cpu().numpy()[:kk]


def _pad_i64(a: np.ndarray, L: int) -> np.ndarray:
    if len(a) == L:
        return np.ascontiguousarray(a, dtype=np.int64)
    out = np.full(L, _I64_MAX, dtype=np.int64)
    out[: len(a)] = a
    return out


def _pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


# ---------------------------------------------------------------------------
# static eligibility (plan-time; keeps ineligible stages unwrapped)


def _sortable_type(t: pa.DataType) -> bool:
    if (pa.types.is_integer(t) or pa.types.is_date(t) or pa.types.is_boolean(t)
            or pa.types.is_floating(t) or pa.types.is_string(t)
            or pa.types.is_large_string(t) or pa.types.is_dictionary(t)):
        return True
    if pa.types.is_decimal128(t):
        # the exact money lane; wide decimals would round through f64 and
        # could mis-order near-ties — those stay on the host comparator
        return 0 <= t.scale <= 4 and t.precision - t.scale <= 14
    return False


def sort_static_ok(keys: list, schema: DFSchema) -> bool:
    try:
        return all(_sortable_type(k.expr.data_type(schema)) for k in keys)
    except Exception:  # noqa: BLE001 — unresolvable expr: not ours to run
        return False


def _int_like(t: pa.DataType) -> bool:
    if pa.types.is_integer(t) or pa.types.is_boolean(t):
        return True
    return (pa.types.is_decimal128(t)
            and 0 <= t.scale <= 4 and t.precision - t.scale <= 14)


def window_static_ok(window_exprs: list, schema: DFSchema) -> bool:
    try:
        for w in window_exprs:
            if w.frame is not None or w.func not in _WINDOW_DEVICE_FUNCS:
                return False
            if not sort_static_ok(list(w.order_by), schema):
                return False
            if not all(_sortable_type(e.data_type(schema)) for e in w.partition_by):
                return False
            if w.func == "sum":
                # float sums take the oracle's sequential f64 cumsum; a
                # log-depth device scan would round differently — demote
                if not w.args or not _int_like(w.args[0].data_type(schema)):
                    return False
            elif w.func in ("min", "max"):
                t = w.args[0].data_type(schema) if w.args else None
                if t is None or not (_int_like(t) or pa.types.is_floating(t)):
                    return False
        return True
    except Exception:  # noqa: BLE001
        return False


# ---------------------------------------------------------------------------
# ORDER BY [LIMIT]


def _device_sort(tbl: pa.Table, df_schema: DFSchema, keys: list,
                 fetch: Optional[int], config: BallistaConfig,
                 device: torch.device, decisions: list) -> pa.Table:
    """The ordered (and cut) table; appends (mode, reason, rows) of the
    cost model's decision to `decisions`."""
    from ballista_tpu_torch.ops.cuda import fusion
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    n = tbl.num_rows
    if n == 0:
        return tbl
    if n < max(int(config.get(TPU_MIN_ROWS)), 1):
        raise Unsupported(f"only {n} rows (< tpu min)")
    batch = tbl.combine_chunks().to_batches()[0]
    arrays = [evaluate_to_array(bind_expr(k.expr, df_schema), batch)
              for k in keys]
    orders = [(k.ascending, k.nulls_first) for k in keys]
    key_ops, key_meta = _encode_key_arrays(arrays, orders)

    topk_wanted = fetch is not None and bool(config.get(TPU_TOPK_ENABLED))
    est = fusion.estimate_sort_stage(
        n, key_meta, fetch=fetch if topk_wanted else None)
    _admit(est, config)
    cm = _sort_cost_model(config, device)
    dec = cm.choose_sort(est)
    RUN_STATS.set("fusion_mode", dec.mode)
    RUN_STATS.set("fusion_reason", dec.reason)
    decisions.append((dec.mode, dec.reason, n))

    up = _Uploads(device)
    t0 = time.time()
    if dec.mode == "fused_pallas" and topk_wanted:
        # choose_sort only keeps topk_k on the pallas rung when the kernel
        # can take it (single key, k under the ceiling)
        perm = _perm_topk(key_ops, n, int(fetch), up)
        _count("topk_invocations")
        _count("topk_rows_kept", len(perm))
    else:
        perm = _perm_full(key_ops, n, dec.mode, up)
        _count("sort_invocations")
        if fetch is not None:
            _count("sort_full_materializations")
    _note_kernel_s(time.time() - t0)
    RUN_STATS.set("device_bytes", up.bytes)

    out = tbl.take(pa.array(perm))
    if fetch is not None:
        out = out.slice(0, int(fetch))
    return out


class TpuSortStageExec(ExecutionPlan):
    """SortExec on the device: materialize the child once, compute the
    ordering permutation on device, take on the host. Unsupported shapes
    host-sort the SAME materialized table (no child re-execution); any
    other error fails the query."""

    def __init__(self, input: ExecutionPlan, keys: list[SortKey],
                 fetch: Optional[int], config: BallistaConfig):
        super().__init__(input.df_schema)
        self.input = input
        self.keys = keys
        self.fetch = fetch
        self.config = config
        self.tpu_count = 0
        self.fallback_count = 0
        # (fusion mode, reason, rows) of every device sort this node ran
        self.decisions: list = []

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_children(self, c):
        return TpuSortStageExec(c[0], self.keys, self.fetch, self.config)

    def output_partition_count(self) -> int:
        return self.input.output_partition_count()

    def node_str(self) -> str:
        k = ", ".join(str(x) for x in self.keys)
        f = f", fetch={self.fetch}" if self.fetch is not None else ""
        extra = ""
        if self.tpu_count or self.fallback_count:
            extra = (f" device_runs={self.tpu_count}"
                     f" cpu_fallbacks={self.fallback_count}")
        return f"TpuSortStageExec: [{k}]{f}{extra}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(iter(self._run(partition, ctx)))

    def _run(self, partition: int, ctx: TaskContext):
        batches = [b for b in self.input.execute(partition, ctx) if b.num_rows]
        tbl = _concat(batches, self.schema())
        device = runtime.device(ctx.device_ordinal)
        try:
            out = _device_sort(tbl, self.df_schema, self.keys, self.fetch,
                               self.config, device, self.decisions)
            self.tpu_count += 1
        except Unsupported as e:
            # the declared ladder only: a build, launch or device error
            # propagates out of the query
            log.info("tpu sort fallback (%s)", e)
            out = self._host_sort(tbl)
        if out.num_rows == 0:
            yield _empty_batch(self.schema())
            return
        for b in out.combine_chunks().to_batches(max_chunksize=ctx.batch_size):
            yield b

    def _host_sort(self, tbl: pa.Table) -> pa.Table:
        self.fallback_count += 1
        out = _sort_table(tbl, self.df_schema, self.keys)
        if self.fetch is not None:
            out = out.slice(0, self.fetch)
        return out


# ---------------------------------------------------------------------------
# window aggregates


def _device_frame(batch: pa.RecordBatch, w: WindowFunction, schema: DFSchema,
                  config: BallistaConfig, window_funcs: int, up: "_Uploads"):
    """The oracle's _Frame, with the sort permutation computed on device.
    Boundary flags reuse the oracle's `_changes` (nulls equal, NaN splits
    peers) so peer semantics cannot drift. Returns (_Frame, decision)."""
    from ballista_tpu_torch.ops.cpu.window import _Frame, _changes, _first_only
    from ballista_tpu_torch.ops.cuda import fusion
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    n = batch.num_rows
    part_arrays = [evaluate_to_array(bind_expr(e, schema), batch)
                   for e in w.partition_by]
    order_arrays = [evaluate_to_array(bind_expr(k.expr, schema), batch)
                    for k in w.order_by]
    arrays = part_arrays + order_arrays
    orders = [(True, False)] * len(part_arrays) + [
        (k.ascending, k.nulls_first) for k in w.order_by
    ]
    key_ops, key_meta = _encode_key_arrays(arrays, orders)
    est = fusion.estimate_sort_stage(n, key_meta or [("i64", False)],
                                     window_funcs=max(window_funcs, 1))
    _admit(est, config)
    dec = _sort_cost_model(config, up.device).choose_sort(est)
    RUN_STATS.set("fusion_mode", dec.mode)
    RUN_STATS.set("fusion_reason", dec.reason)

    t0 = time.time()
    if key_ops:
        idx = _perm_full(key_ops, n, dec.mode, up).astype(np.int64)
    else:
        idx = np.arange(n, dtype=np.int64)
    _note_kernel_s(time.time() - t0)

    inv = np.empty(n, dtype=np.int64)
    inv[idx] = np.arange(n, dtype=np.int64)
    new_part = _changes(part_arrays, idx) if part_arrays else _first_only(n)
    new_peer = new_part | (_changes(order_arrays, idx) if order_arrays
                           else np.zeros(n, bool))
    arange = np.arange(n, dtype=np.int64)
    seg_start = np.maximum.accumulate(np.where(new_part, arange, 0))
    starts = np.flatnonzero(new_part)
    ends = np.r_[starts[1:] - 1, n - 1] if len(starts) else np.array([], np.int64)
    counts = ends - starts + 1 if len(starts) else np.array([], np.int64)
    seg_end = np.repeat(ends, counts) if len(starts) else np.zeros(n, np.int64)
    _count("window_partitions", int(len(starts)))
    return _Frame(idx, inv, new_part, new_peer, seg_start, seg_end), dec


def _seg_scan(vals: np.ndarray, boundary: np.ndarray, func: str, mode: str,
              up: _Uploads) -> np.ndarray:
    """Device inclusive segmented scan (reset at boundary lanes)."""
    n = len(vals)
    if mode == "fused_pallas":
        from ballista_tpu_torch.ops.cuda.cuda_kernels import segmented_scan

        L = _pow2(n)
        v = np.zeros(L, dtype=vals.dtype)
        v[:n] = vals
        f = np.ones(L, dtype=bool)  # padding lanes self-reset
        f[:n] = boundary
        out = segmented_scan(up.put(v)[None, :], up.put(f)[None, :], func)
        return out[0].cpu().numpy()[:n]
    from ballista_tpu_torch.ops.cuda.final_stage import _segscan

    out = _segscan(up.put(vals), up.put(boundary), func)
    return out.cpu().numpy()


def _device_compute_one(batch: pa.RecordBatch, w: WindowFunction,
                        schema: DFSchema, fr, mode: str,
                        up: _Uploads) -> pa.Array:
    """One window expression over a shared frame: device segmented scans
    inside the oracle's gather/scatter/emit skeleton."""
    from ballista_tpu_torch.ops.cpu.window import _decimal_prepare, _emit_agg, _peer_last

    n = batch.num_rows
    out_type = w.data_type(schema)
    if n == 0:
        return pa.array([], out_type)
    t0 = time.time()
    boundary = fr.new_part.copy()
    boundary[0] = True
    arange = np.arange(n, dtype=np.int64)

    if w.func == "row_number":
        out_sorted = _seg_scan(np.ones(n, np.int64), boundary, "sum", mode, up)
    elif w.func == "rank":
        marked = np.where(fr.new_peer, arange, np.int64(_I64_MIN))
        peer_start = _seg_scan(marked, boundary, "max", mode, up)
        out_sorted = peer_start - fr.seg_start + 1
    else:
        arr = _emit_scan_agg(batch, w, schema, fr, mode, boundary, up,
                             out_type, _decimal_prepare, _emit_agg,
                             _peer_last, n)
        _note_kernel_s(time.time() - t0)
        return arr
    _note_kernel_s(time.time() - t0)
    out = np.empty(n, dtype=np.int64)
    out[fr.idx] = out_sorted
    return pa.array(out, out_type)


def _emit_scan_agg(batch, w, schema, fr, mode, boundary, up, out_type,
                   _decimal_prepare, _emit_agg, _peer_last, n):
    import pyarrow.compute as pc  # noqa: F401 — _decimal_prepare path

    dec_scale = None
    if w.args:
        arr = evaluate_to_array(bind_expr(w.args[0], schema),
                                batch).take(pa.array(fr.idx))
        valid = arr.is_valid().to_numpy(zero_copy_only=False).astype(bool)
        if pa.types.is_decimal(arr.type):
            arr, dec_scale = _decimal_prepare(arr, w, out_type)
    else:  # count(*)
        arr = None
        valid = np.ones(n, dtype=bool)
    last = _peer_last(fr.new_peer, n)

    seg_cnt = _seg_scan(valid.astype(np.int64), boundary, "sum", mode, up)
    if w.func == "count":
        out = np.empty(n, dtype=np.int64)
        out[fr.idx] = seg_cnt[last]
        return pa.array(out, out_type)

    vals = arr.to_numpy(zero_copy_only=False)
    if w.func == "sum":
        # nullable ints come back from to_numpy as float64-with-NaN, and
        # the oracle then runs its cumsum in float64 — recover the exact
        # ints via fill_null and bound the magnitude so the float path is
        # exact too (every prefix sum < 2^53 → the two agree bit-for-bit)
        import pyarrow.compute as pc

        if pa.types.is_integer(arr.type) or pa.types.is_boolean(arr.type):
            v = pc.fill_null(arr, 0).cast(pa.int64()).to_numpy(
                zero_copy_only=False).astype(np.int64, copy=False)
        elif np.issubdtype(np.asarray(vals).dtype, np.integer):
            v = np.where(valid, np.asarray(vals, dtype=np.int64), 0)
        else:
            raise Unsupported("float window sum (sequential-cumsum parity)")
        if arr.null_count and n:
            m = int(np.abs(v).max())
            if m and m * n >= (1 << 53):
                raise Unsupported("window sum magnitude beyond exact-f64")
        out_sorted = _seg_scan(v, boundary, "sum", mode, up)[last]
    else:  # min / max
        is_f = (np.issubdtype(np.asarray(vals).dtype, np.floating)
                or pa.types.is_floating(out_type))
        v = np.asarray(vals, dtype=np.float64 if is_f else np.int64)
        if is_f:
            sentinel = np.inf if w.func == "min" else -np.inf
        else:
            sentinel = (np.iinfo(np.int64).max if w.func == "min"
                        else np.iinfo(np.int64).min)
        v = np.where(valid, v, sentinel)
        out_sorted = _seg_scan(v, boundary, w.func, mode, up)[last]
    mask_sorted = seg_cnt[last] == 0  # SQL: aggregate over zero rows is NULL

    out = np.empty(n, dtype=out_sorted.dtype)
    out[fr.idx] = out_sorted
    mask = np.empty(n, dtype=bool)
    mask[fr.idx] = mask_sorted
    return _emit_agg(out, out_type, mask, dec_scale)


def _device_windows(batch: pa.RecordBatch, window_exprs: list,
                    schema: DFSchema, config: BallistaConfig,
                    device: torch.device, decisions: list) -> list[pa.Array]:
    """Every window expression's column; appends (mode, reason, rows) of
    each frame's decision to `decisions`."""
    n = batch.num_rows
    if n < max(int(config.get(TPU_MIN_ROWS)), 1):
        raise Unsupported(f"only {n} rows (< tpu min)")
    if not window_static_ok(window_exprs, schema):
        raise Unsupported("window shape not device-eligible")
    groups: dict[tuple, int] = {}
    for w in window_exprs:
        key = (tuple(str(e) for e in w.partition_by),
               tuple(str(k) for k in w.order_by))
        groups[key] = groups.get(key, 0) + 1
    frames: dict[tuple, tuple] = {}
    out = []
    up = _Uploads(device)  # stage-total device bytes: sorts + scans (fill test)
    for w in window_exprs:
        key = (tuple(str(e) for e in w.partition_by),
               tuple(str(k) for k in w.order_by))
        if key not in frames:
            frames[key] = fr, dec = _device_frame(batch, w, schema, config,
                                                  groups[key], up)
            decisions.append((dec.mode, dec.reason, n))
        fr, dec = frames[key]
        out.append(_device_compute_one(batch, w, schema, fr, dec.mode, up))
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

    RUN_STATS.set("device_bytes", up.bytes)
    _count("window_invocations")
    return out


class TpuWindowStageExec(ExecutionPlan):
    """WindowExec on the device: sort permutation + segmented scans on
    device, boundary/emit logic shared with the CPU oracle. Ineligible
    shapes run `compute_windows` over the SAME materialized batch; any
    other error fails the query."""

    def __init__(self, input: ExecutionPlan, window_exprs: list,
                 df_schema: DFSchema, config: BallistaConfig):
        super().__init__(df_schema)
        self.input = input
        self.window_exprs = window_exprs
        self.config = config
        self.tpu_count = 0
        self.fallback_count = 0
        # (fusion mode, reason, rows) of every device frame this node sorted
        self.decisions: list = []

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_children(self, c):
        return TpuWindowStageExec(c[0], self.window_exprs, self.df_schema,
                                  self.config)

    def output_partition_count(self) -> int:
        return self.input.output_partition_count()

    def node_str(self) -> str:
        extra = ""
        if self.tpu_count or self.fallback_count:
            extra = (f" device_runs={self.tpu_count}"
                     f" cpu_fallbacks={self.fallback_count}")
        return (f"TpuWindowStageExec: "
                f"[{', '.join(map(str, self.window_exprs))}]{extra}")

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(iter(self._run(partition, ctx)))

    def _run(self, partition: int, ctx: TaskContext):
        batches = [b for b in self.input.execute(partition, ctx) if b.num_rows]
        if not batches:
            yield _empty_batch(self.schema())
            return
        tbl = _concat(batches, self.input.schema())
        batch = tbl.combine_chunks().to_batches()[0] if tbl.num_rows else None
        if batch is None:
            yield _empty_batch(self.schema())
            return
        device = runtime.device(ctx.device_ordinal)
        try:
            wins = _device_windows(batch, self.window_exprs,
                                   self.input.df_schema, self.config, device,
                                   self.decisions)
            self.tpu_count += 1
        except Unsupported as e:
            # the declared ladder only: a build, launch or device error
            # propagates out of the query
            log.info("tpu window fallback (%s)", e)
            wins = self._host_windows(batch)
        arrays = [batch.column(i) for i in range(batch.num_columns)] + wins
        out = pa.RecordBatch.from_arrays(arrays, schema=self.schema())
        for off in range(0, out.num_rows, ctx.batch_size):
            yield out.slice(off, min(ctx.batch_size, out.num_rows - off))

    def _host_windows(self, batch: pa.RecordBatch) -> list[pa.Array]:
        from ballista_tpu_torch.ops.cpu.window import compute_windows

        self.fallback_count += 1
        return compute_windows(batch, self.window_exprs, self.input.df_schema)


def sort_family_enabled(config: BallistaConfig) -> bool:
    return bool(config.get(TPU_SORT_ENABLED))
