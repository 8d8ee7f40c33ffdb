"""Device execution for final-aggregation / sort / top-K stage shapes.

Counterpart of the JAX package's ops/tpu/final_stage.py. This stage class
sits ABOVE the shuffle: merge the hash-partitioned partial accumulators on
the card, apply the post-aggregation projections and HAVING filters, and
run ORDER BY (+ LIMIT) — so only surviving rows come back to the host.

Stage shape handled (top-down):

    [SortExec(fetch?)]  [ProjectionExec|FilterExec]*  HashAggregateExec(final)
        [CoalesceBatchesExec|CoalescePartitionsExec]*  <child>

Execution model (same contract as TpuStageExec): the whole stage — all
partitions — runs as ONE device pass over a [P, N] layout; partition id
rides as the leading sort key so per-partition grouping and per-partition
top-K happen together. The final-mode merge semantics mirror
HashAggregateExec: sum/count partials add, min/max partials re-reduce,
NULL accumulators are skipped and an all-NULL group decodes to NULL.

The reference sorts with lexicographic `jax.lax.sort` calls outside any
Pallas kernel; here each becomes stable `torch.sort` passes taken least
significant key first. PyTorch runs eagerly, so the grouped space is
compacted to its real size instead of a static capacity (the capacity
check is kept, so the same stages fall back).

Fallback is runtime-adaptive like the partial path; `match_final_stage`
pre-lowers every expression at plan time with static kinds so stages that
CANNOT lower are never wrapped. A device out-of-memory error spills the
resident tables and retries once before the stage declines (_device_run).
"""

from __future__ import annotations

import concurrent.futures as _fut
import logging
import threading
from typing import Iterator

import numpy as np
import pyarrow as pa
import torch

from ballista_tpu_torch.config import TPU_MAX_DEVICE_BYTES, TPU_MIN_ROWS, BallistaConfig
from ballista_tpu_torch.ops.cuda import hbm, runtime
from ballista_tpu_torch.ops.cuda.columnar import encode_column, next_bucket, repeated_names
from ballista_tpu_torch.ops.cuda.kernels import DevVal, Lowering, Unsupported, lower_expr, take, true_mask
from ballista_tpu_torch.plan.physical import (
    CoalesceBatchesExec,
    CoalescePartitionsExec,
    ExecutionPlan,
    FilterExec,
    HashAggregateExec,
    ProjectionExec,
    SortExec,
    TaskContext,
    _concat,
    _empty_batch,
)

log = logging.getLogger(__name__)

MAX_CAPACITY = 1 << 22


def match_final_stage(node: ExecutionPlan):
    """Match the final-stage shape rooted at `node`; return
    (sort, post_ops top-down, agg, child, coalesce) or None. Conservative:
    only matches when every expression trial-lowers with static kinds, so a
    wrapped stage falls back only on genuinely runtime conditions."""
    sort = None
    cur = node
    if isinstance(cur, SortExec):
        sort = cur
        cur = cur.input
    post_ops: list[ExecutionPlan] = []
    while isinstance(cur, (ProjectionExec, FilterExec, CoalesceBatchesExec)):
        post_ops.append(cur)
        cur = cur.children()[0]
    if not isinstance(cur, HashAggregateExec) or cur.mode != "final":
        return None
    agg = cur
    if not agg.group_exprs:
        # global merges are a handful of rows — nothing for the device
        return None
    child = agg.input
    coalesce = False
    while isinstance(child, (CoalesceBatchesExec, CoalescePartitionsExec)):
        if isinstance(child, CoalescePartitionsExec):
            coalesce = True
        child = child.children()[0]
    if not _trial_lowerable(sort, post_ops, agg):
        return None
    return sort, post_ops, agg, child, coalesce


def _static_kind(t: pa.DataType):
    """Conservative (kind, scale) for trial lowering from an Arrow type.
    float64 is guessed f64 — the money refinement only changes arithmetic
    scales at runtime, never lowerability."""
    if pa.types.is_integer(t):
        return ("i64", 0)
    if pa.types.is_date(t):
        return ("date", 0)
    if pa.types.is_boolean(t):
        return ("bool", 0)
    if pa.types.is_floating(t):
        return ("f64", 0)
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_dictionary(t):
        return ("code", 0)
    return None


def _lower_chain(ctx: Lowering, sort, post_ops):
    """The ONE lowering walk shared by the plan-time matcher and the
    runtime compiler (so they cannot drift): rebinds the env through
    projections, collects filter predicates, and lowers the sort keys with
    their code→lexicographic-rank LUTs. Raises Unsupported when any piece
    cannot lower. Returns (keep_fns, sort_specs)."""
    from ballista_tpu_torch.ops.cuda.stage_compiler import _bind_env, _passthrough_meta

    cur_schema = ctx.schema
    keep_fns: list = []
    for op in reversed(post_ops):
        if isinstance(op, ProjectionExec):
            new_fns, new_meta = [], []
            for e in op.exprs:
                new_fns.append(lower_expr(e, ctx))
                new_meta.append(_passthrough_meta(e, ctx, cur_schema))
            ctx.env_fns, ctx.env_meta = new_fns, new_meta
            cur_schema = op.df_schema
            _bind_env(ctx, cur_schema)
        elif isinstance(op, FilterExec):
            keep_fns.append(lower_expr(op.predicate, ctx))
        # CoalesceBatchesExec: no-op

    sort_specs: list = []  # (fn, ascending, nulls_first, rank_lut_idx|None)
    if sort is not None:
        for k in sort.keys:
            kf = lower_expr(k.expr, ctx)
            m = _passthrough_meta(k.expr, ctx, cur_schema)
            lut_idx = None
            if m is not None and m[0] == "code":
                # dictionary codes are appearance-ordered, not collated:
                # sort through a host-built code→lexicographic-rank LUT
                if m[3] is None or not isinstance(m[3], int) or m[3] < 0:
                    raise Unsupported("string sort key without a slot")

                def rank_builder(dic):
                    ranks = np.zeros(max(len(dic or []), 1), dtype=np.int32)
                    if dic:
                        order = sorted(range(len(dic)), key=lambda j: dic[j])
                        for r, j in enumerate(order):
                            ranks[j] = r
                    return ranks

                lut_idx = ctx.add_lut(m[3], rank_builder)
            sort_specs.append((kf, k.ascending, k.nulls_first, lut_idx))
    return keep_fns, sort_specs


def _trial_lowerable(sort, post_ops, agg) -> bool:
    """Dry-run the shared lowering walk with static kinds. Lowered closures
    are never CALLED, so dummy readers suffice; Unsupported → False."""
    for d in agg.aggs:
        if d.func not in ("sum", "min", "max", "count", "count_all"):
            return False  # welford triples merge on cpu
    kinds: list = []
    for f in agg.df_schema:
        k = _static_kind(f.dtype)
        if k is None:
            return False
        kinds.append(k)
    try:
        ctx = Lowering(agg.df_schema, kinds, [[] if k[0] == "code" else None for k in kinds])
        ctx.env_fns = [lambda cols, luts: None] * len(kinds)
        ctx.env_meta = [
            (k[0], k[1], [] if k[0] == "code" else None, i) for i, k in enumerate(kinds)
        ]
        from ballista_tpu_torch.ops.cuda.stage_compiler import _bind_env

        _bind_env(ctx, agg.df_schema)
        _lower_chain(ctx, sort, post_ops)
    except Unsupported:
        return False
    return True


def _lexsort(keys: list) -> torch.Tensor:
    """Permutation ordering rows by `keys` (most significant first): stable
    sorts taken least significant key first, so ties keep row order."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _segscan(values: torch.Tensor, boundary: torch.Tensor, func: str) -> torch.Tensor:
    """Inclusive segmented sum/min/max scan with resets at boundary rows
    (row 0 must be a boundary). The combine is the segmented-scan monoid,
    applied in the association order of the reference's
    `jax.lax.associative_scan` (pairwise reduce, recurse, fill the even
    positions), so float sums agree with the JAX package bit for bit and
    reruns are bitwise identical.

    Two float details follow what the reference returns on the CPU: the
    op takes the later operand first, which decides the sign of a NaN
    that two NaNs (or inf - inf) leave; and once a combine has run (two
    rows or more) it returns no -0.0, so a float -0.0 result becomes +0.0
    there (every other bit is kept). One row is returned as it is."""
    op = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}[func]

    def combine(av, af, bv, bf):
        return torch.where(bf, bv, op(bv, av)), af | bf

    def scan(v, f):
        n = v.shape[0]
        if n < 2:
            return v, f
        odd_v, odd_f = scan(*combine(v[0:n - 1:2], f[0:n - 1:2], v[1::2], f[1::2]))
        if n % 2 == 0:
            ev, ef = combine(odd_v[:-1], odd_f[:-1], v[2::2], f[2::2])
        else:
            ev, ef = combine(odd_v, odd_f, v[2::2], f[2::2])
        ev = torch.cat([v[:1], ev])
        ef = torch.cat([f[:1], ef])
        out_v = torch.empty_like(v)
        out_f = torch.empty_like(f)
        out_v[0::2], out_v[1::2] = ev, odd_v
        out_f[0::2], out_f[1::2] = ef, odd_f
        return out_v, out_f

    out = scan(values, boundary)[0]
    if out.dtype.is_floating_point and out.shape[0] > 1:
        out = torch.where(out == 0, torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out


def _first_of_run(x: torch.Tensor) -> torch.Tensor:
    """True where a row differs from the row before it (and at row 0)."""
    out = torch.ones_like(x, dtype=torch.bool)
    out[1:] = x[1:] != x[:-1]
    return out


class TpuFinalStageExec(ExecutionPlan):
    """One-pass device execution of a final-agg/sort stage (see module
    docstring). Counters (device_runs / cpu_fallbacks) surface in EXPLAIN
    ANALYZE exactly like TpuStageExec's."""

    def __init__(self, sort, post_ops: list, agg: HashAggregateExec,
                 child: ExecutionPlan, config: BallistaConfig, coalesce: bool = False):
        top = sort if sort is not None else (post_ops[0] if post_ops else agg)
        super().__init__(top.df_schema)
        self.sort = sort
        self.post_ops = post_ops  # top-down Projection/Filter/CoalesceBatches
        self.agg = agg
        self.child = child
        self.config = config
        self.coalesce = coalesce  # True: all input partitions merge into one
        self.min_rows = int(config.get(TPU_MIN_ROWS))
        self.buckets = config.shape_buckets()
        self.tpu_count = 0
        self.fallback_count = 0
        self.decline_reason: str | None = None  # the last Unsupported's message
        self._results: dict[int, list[pa.RecordBatch]] | None = None
        self._results_lock = threading.Lock()
        self._device_ok = False
        # child output materialized by a device attempt that then declined:
        # (tables, child df_schema, merged?) — the CPU fallback aggregates
        # THESE instead of re-executing the whole child subtree
        self._mat_input: tuple | None = None
        self._mat_node = None
        # fallback partitions already served off the materialized copy; once
        # every expected partition has been read the copy is dropped
        self._mat_served: set[int] = set()
        self._mat_released_merged = False
        self._served_since_dispatch: set[int] = set()
        parts = [op.node_str() for op in ([sort] if sort else []) + post_ops]
        self.fingerprint = "|".join(
            parts + [agg.node_str(), repr(agg.input.df_schema), f"coalesce={coalesce}"]
        )

    def children(self) -> list[ExecutionPlan]:
        return [self.child]

    def with_children(self, c):
        return TpuFinalStageExec(self.sort, self.post_ops, self.agg, c[0],
                                 self.config, self.coalesce)

    def output_partition_count(self) -> int:
        return 1 if self.coalesce else self.child.output_partition_count()

    def node_str(self) -> str:
        extra = ""
        if self.tpu_count or self.fallback_count:
            extra = f" device_runs={self.tpu_count} cpu_fallbacks={self.fallback_count}"
        s = f" sort={self.sort.node_str()}" if self.sort is not None else ""
        return (f"TpuFinalStageExec: [{self.agg.node_str()}]"
                f" post_ops={len(self.post_ops)}{s}{extra}")

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(iter(self._run(partition, ctx)))

    # ------------------------------------------------------------------

    def _run(self, partition: int, ctx: TaskContext) -> list[pa.RecordBatch]:
        with self._results_lock:
            if self._results is None:
                try:
                    self._results = self._device_run(ctx)
                    self.tpu_count += 1
                    self._device_ok = True
                    self._mat_input = None  # success: release the host copy
                except Unsupported as e:
                    # only a declared decline falls back; a build, launch or
                    # device error propagates out of collect()
                    log.info("device final-stage fallback (%s): %s", e, self.agg.node_str())
                    self.decline_reason = str(e)
                    self._results = {}
            if partition not in self._results and self._device_ok:
                # results were already consumed (a consumer re-executed this
                # partition); re-running the device path costs one pass
                try:
                    self._results.update(self._device_run(ctx))
                    self.tpu_count += 1
                    self._mat_input = None
                    self._served_since_dispatch = set()
                    if partition in self._results:
                        out = list(self._results[partition])
                        self._note_served_locked(partition)
                        return out
                except Unsupported:
                    log.warning("device final-stage re-run declined; cpu fallback for %s",
                                self.agg.node_str(), exc_info=True)
                    self._device_ok = False
            if partition in self._results:
                out = self._results.pop(partition)
                self._note_served_locked(partition)
                return out
        return self._fallback(partition, ctx)

    def _device_run(self, ctx: TaskContext) -> dict[int, list[pa.RecordBatch]]:
        """_tpu_run_all with the final stage's out-of-memory rung: spill
        every resident table to the host pool and retry ONCE (re-reading
        the child, as a decline may); a second out-of-memory error declines
        with Unsupported, so the CPU engine aggregates the input the retry
        materialized. No grace rung here. Any other error propagates."""
        from ballista_tpu_torch.config import TPU_HBM_SPILL_ENABLED
        from ballista_tpu_torch.ops.cuda import stage_compiler as _sc

        try:
            return self._tpu_run_all(ctx)
        except Unsupported:
            raise
        except Exception as e:  # noqa: BLE001 — classified: only an OOM is caught
            if not hbm.is_resource_exhausted(e):
                raise
            first = f"{type(e).__name__}: {e}"
        # out of the handler: the failed attempt's device tensors are freed
        log.warning("final stage out of device memory; spilling + retrying once: %s", first)
        spill_pool = hbm.SPILL_POOL if bool(self.config.get(TPU_HBM_SPILL_ENABLED)) else None
        _sc.DEVICE_CACHE.spill_all(spill_pool)
        hbm.note_oom(self.fingerprint)
        hbm.consume_oom_hint(self.fingerprint)  # no grace rung to pre-plan
        try:
            res = self._tpu_run_all(ctx)
        except Exception as e2:  # noqa: BLE001 — classified: only an OOM is caught
            if hbm.is_resource_exhausted(e2):
                raise Unsupported(f"final stage OOM persisted after spill+retry: {e2}") from e2
            raise
        _sc.RUN_STATS.set("hbm_oom_retries", hbm.oom_retry_count())
        return res

    def _note_served_locked(self, partition: int) -> None:
        """Bound re-run retention (call under _results_lock): when every
        still-resident result has been served at least once since the last
        dispatch, drop them all — they only exist for re-read convenience."""
        self._served_since_dispatch.add(partition)
        if self._results and set(self._results) <= self._served_since_dispatch:
            self._results = {}

    def _materialized_scan(self):
        """Build (once) a MemoryScanExec over the child output a declined
        device attempt already read, so the CPU fallback never re-executes
        the child subtree. Returns (scan, merged?) or None."""
        with self._results_lock:
            if self._mat_node is None and self._mat_input is not None:
                from ballista_tpu_torch.plan.physical import MemoryScanExec

                tables, dfs, merged = self._mat_input
                batches = []
                for t in tables:
                    bs = t.combine_chunks().to_batches()
                    batches.append(bs[0] if bs else _empty_batch(t.schema))
                self._mat_node = (
                    MemoryScanExec(dfs, batches, partitions=len(batches)), merged)
                self._mat_input = None  # don't retain a second full copy
            return self._mat_node

    def _note_mat_served(self, partition: int, merged: bool) -> None:
        """Drop the materialized child copy once the LAST expected fallback
        partition has been served: merged/coalesced stages only ever serve
        partition 0; hash-placed stages serve every output partition."""
        with self._results_lock:
            if self._mat_node is None:
                return
            self._mat_served.add(partition)
            expected = ({0} if (merged or self.coalesce)
                        else set(range(self.output_partition_count())))
            if self._mat_served >= expected:
                self._mat_node = None
                self._mat_served.clear()
                self._mat_released_merged = merged

    def _fallback(self, partition: int, ctx: TaskContext) -> list[pa.RecordBatch]:
        self.fallback_count += 1
        mat = self._materialized_scan()
        merged_mat = False
        if mat is not None:
            node, merged = mat
            merged_mat = merged
            if merged:
                # bypass-read input is NOT hash-placed: merge globally and
                # emit on partition 0 (the device bypass contract)
                if partition != 0 and not self.coalesce:
                    return []
                node = CoalescePartitionsExec(node)
                partition = 0
            elif self.coalesce:
                node = CoalescePartitionsExec(node)
        else:
            node = self.child
            if self._mat_released_merged:
                # the merged host copy was served and released; bypass-read
                # input is not hash-placed, so a late re-read must re-merge
                # the child globally and still emit only on partition 0
                if partition != 0 and not self.coalesce:
                    return []
                node = CoalescePartitionsExec(node)
                partition = 0
            elif self.coalesce:
                node = CoalescePartitionsExec(node)
        node = self.agg.with_children([node])
        for op in reversed(self.post_ops):
            node = op.with_children([node])
        if self.sort is not None:
            node = self.sort.with_children([node])
        out = [b for b in node.execute(partition, ctx)]
        if mat is not None:
            self._note_mat_served(partition, merged_mat)
        return out

    # ------------------------------------------------------------------

    def _tpu_run_all(self, ctx: TaskContext) -> dict[int, list[pa.RecordBatch]]:
        from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, _put
        from ballista_tpu_torch.plan.physical import RepartitionExec

        child = self.child
        P_result = self.output_partition_count()
        bypass = False
        if isinstance(child, RepartitionExec) and child.scheme == "hash":
            # the host hash-radix between partial and final agg is pure
            # overhead here: the pass re-groups globally anyway. Read the
            # repartition's input directly and emit the merged result on
            # output partition 0 (others empty). CONTRACT (as in the
            # reference): output_partition_count() still advertises K, but
            # rows all land on partition 0 — sound because every
            # partition-sensitive consumer gets a fresh RepartitionExec from
            # the physical planner.
            child = child.input
            bypass = True
        P_in = child.output_partition_count()

        def read(p):
            return _concat([b for b in child.execute(p, ctx) if b.num_rows],
                           child.schema())

        with _fut.ThreadPoolExecutor(max_workers=min(max(P_in, 1), 8)) as pool:
            tables = list(pool.map(read, range(P_in)))
        # from here on the child's output is in hand: any decline below must
        # aggregate THESE tables on the CPU, not re-execute the child
        self._mat_input = (tables, child.df_schema, bypass)
        self._mat_node = None
        part_rows = [t.num_rows for t in tables]
        total = sum(part_rows)
        if total < max(self.min_rows, 1):
            raise Unsupported(f"only {total} rows (< tpu min)")
        device = runtime.device(ctx.device_ordinal)

        full = pa.concat_tables(tables)
        dup = repeated_names(full.column_names)
        if dup:
            # the encode below looks columns up by name (the reference's
            # does too, and its error makes it fall back): decline instead
            raise Unsupported(f"duplicate input field names {dup}")
        N = next_bucket(max(max(part_rows), 1), self.buckets)
        P = len(part_rows)

        # encode first (cheap dtype/validity info), then enforce the device
        # budget BEFORE any host stacking or upload
        encoded = []
        for name in full.column_names:
            dc = encode_column(full.column(name))
            if dc is None:
                raise Unsupported(f"unencodable column {name}")
            encoded.append(dc)
        cell_bytes = P * N
        proj_bytes = cell_bytes  # [P, N] bool row mask
        for dc in encoded:
            proj_bytes += cell_bytes * dc.data.dtype.itemsize
            if dc.valid is not None:
                proj_bytes += cell_bytes  # bool validity plane
        max_bytes = int(self.config.get(TPU_MAX_DEVICE_BYTES))
        budget = hbm.resolve_hbm_budget(self.config)
        if budget > 0:
            max_bytes = min(max_bytes, budget)
        RUN_STATS.set("hbm_budget_bytes", budget)
        if proj_bytes > max_bytes:
            RUN_STATS.set("hbm_plan", hbm.CPU_DEMOTE)
            RUN_STATS.set(
                "hbm_plan_reason",
                f"final stage needs {proj_bytes} B > budget {max_bytes} B")
            raise Unsupported(
                f"final stage needs {proj_bytes} device bytes (> cap {max_bytes})")
        RUN_STATS.set("hbm_plan", hbm.RUN_WHOLE)
        RUN_STATS.set("hbm_plan_reason",
                      f"final stage fits: {proj_bytes} B <= {max_bytes} B")

        kinds, scales, dicts, cols_np, valids_np = [], [], [], [], []
        for dc in encoded:
            kinds.append(dc.kind)
            scales.append(dc.scale)
            dicts.append(dc.dictionary)
            stack = np.zeros((P, N), dtype=dc.data.dtype)
            off = 0
            for p, r in enumerate(part_rows):
                stack[p, :r] = dc.data[off:off + r]
                off += r
            cols_np.append(stack)
            if dc.valid is None:
                valids_np.append(None)
            else:
                vstack = np.zeros((P, N), dtype=bool)
                off = 0
                for p, r in enumerate(part_rows):
                    vstack[p, :r] = dc.valid[off:off + r]
                    off += r
                valids_np.append(vstack)
        mask_np = np.zeros((P, N), dtype=bool)
        for p, r in enumerate(part_rows):
            mask_np[p, :r] = True

        # lowering builds closures only (PyTorch runs eagerly): a fresh
        # compile per run, no cache to key or lock
        fn, lowering, meta = self._compile(
            kinds, scales, dicts, valids_np, cols_np, P, N, merge_all=bypass)
        luts = [_put(l, device) for l in lowering.build_luts(dicts)]
        flat = [_put(c, device) for c in cols_np] + [
            _put(v, device) for v in valids_np if v is not None
        ]
        mask = _put(mask_np, device)
        outs = fn(flat, luts, mask)
        return self._decode(outs, meta, P_result, dicts)

    # ------------------------------------------------------------------

    def _compile(self, kinds, scales, dicts, valids_np, cols_np, P: int, N: int,
                 merge_all: bool = False):
        from ballista_tpu_torch.ops.cuda.stage_compiler import _bind_env, _pow2

        agg = self.agg
        n_group = len(agg.group_exprs)
        n_aggs = len(agg.aggs)
        if len(kinds) != n_group + n_aggs:
            raise Unsupported("final input is not [groups..., accumulators...]")
        for d in agg.aggs:
            if d.func not in ("sum", "min", "max", "count", "count_all"):
                raise Unsupported(f"final merge of {d.func}")
        for i in range(n_group):
            if kinds[i] == "f64":
                raise Unsupported("f64 group key")

        # flat-arg layout mirrors DeviceTable.flat_cols(): data cols, then
        # validity planes of nullable cols
        valid_idx: list = []
        nxt = len(cols_np)
        for v in valids_np:
            if v is None:
                valid_idx.append(None)
            else:
                valid_idx.append(nxt)
                nxt += 1

        M = P * N
        C = min(_pow2(M), MAX_CAPACITY)

        # ---- compacted-space env: post-op closures read segment results
        # from this cell, populated inside raw before they run
        cell: dict = {}

        def mk_key_reader(i):
            def run(cols, luts):
                return DevVal(kinds[i], cell["keys"][i], scales[i], dicts[i],
                              valid=cell["key_valid"][i])
            return run

        def mk_acc_reader(ai):
            def run(cols, luts):
                return DevVal(cell["acc_kind"][ai], cell["accs"][ai],
                              cell["acc_scale"][ai], None,
                              valid=cell["acc_valid"][ai])
            return run

        ctx = Lowering(agg.df_schema, list(zip(kinds, scales)), dicts)
        env_fns: list = []
        env_meta: list = []
        for i in range(n_group):
            env_fns.append(mk_key_reader(i))
            env_meta.append((kinds[i], scales[i], dicts[i], i))
        for ai, d in enumerate(agg.aggs):
            src = n_group + ai
            if d.func in ("count", "count_all"):
                k, s = "i64", 0
            else:
                k, s = kinds[src], scales[src]
            env_fns.append(mk_acc_reader(ai))
            env_meta.append((k, s, dicts[src], src))
        ctx.env_fns = env_fns
        ctx.env_meta = env_meta
        _bind_env(ctx, agg.df_schema)

        keep_fns, sort_specs = _lower_chain(ctx, self.sort, self.post_ops)
        out_fns = list(ctx.env_fns)
        out_slots = [m[3] if m is not None else None for m in ctx.env_meta]
        fetch = self.sort.fetch if self.sort is not None else None

        agg_descs = list(agg.aggs)
        coalesce = self.coalesce or merge_all
        meta: dict = {"C": C, "P_out": 1 if coalesce else P}

        def raw(cols, luts, mask):
            dev = mask.device
            if coalesce:
                pid = torch.zeros((M,), dtype=torch.int32, device=dev)
            else:
                pid = torch.arange(P, dtype=torch.int32, device=dev).repeat_interleave(N)
            valid = mask.reshape(-1)

            def read_col(i):
                arr = cols[i]
                if kinds[i] in ("i64", "money") and arr.dtype != torch.int64:
                    arr = arr.to(torch.int64)
                elif kinds[i] in ("code", "date") and arr.dtype != torch.int32:
                    arr = arr.to(torch.int32)
                vplane = cols[valid_idx[i]] if valid_idx[i] is not None else None
                return arr.reshape(-1), (None if vplane is None else vplane.reshape(-1))

            # ---- phase 1 sort: (invalid, pid, group keys) --------------
            keyops: list = []
            key_layout: list = []  # per group key: (marker_pos|None, value_pos)
            for i in range(n_group):
                arr, vplane = read_col(i)
                mpos = None
                if vplane is not None:
                    mpos = len(keyops)
                    keyops.append((~vplane).to(torch.int32))
                key_layout.append((mpos, len(keyops)))
                keyops.append(arr)

            pays: list = []
            pay_plan: list = []  # per agg: (pay_idx, ncnt_idx|None)
            for ai, d in enumerate(agg_descs):
                arr, vplane = read_col(n_group + ai)
                if d.func in ("count", "count_all"):
                    # partial counts are non-null; sum them exactly
                    a = arr.to(torch.int64)
                    if vplane is not None:
                        a = torch.where(vplane, a, 0)
                    pays.append(a)
                    pay_plan.append((len(pays) - 1, None))
                    continue
                ncnt_idx = None
                if vplane is not None:
                    if d.func == "sum":
                        neutral = 0
                    elif d.func == "min":
                        neutral = (torch.iinfo(arr.dtype).max
                                   if not arr.dtype.is_floating_point else float("inf"))
                    else:
                        neutral = (torch.iinfo(arr.dtype).min
                                   if not arr.dtype.is_floating_point else float("-inf"))
                    arr = torch.where(vplane, arr, neutral)
                    pays.append(vplane.to(torch.int64))
                    ncnt_idx = len(pays) - 1
                pays.append(arr)
                pay_plan.append((len(pays) - 1, ncnt_idx))

            perm = _lexsort([(~valid).to(torch.int32), pid] + keyops)
            n_valid = int(valid.sum())
            perm = perm[:n_valid]  # invalid rows sort last: drop them
            spid = pid[perm]
            skeys = [k[perm] for k in keyops]
            spays = [p_[perm] for p_ in pays]

            if n_valid:
                boundary = _first_of_run(spid)
                for k in skeys:
                    boundary |= _first_of_run(k)
            else:
                boundary = torch.zeros((0,), dtype=torch.bool, device=dev)
            is_end = torch.ones_like(boundary)
            is_end[:-1] = boundary[1:]
            n_seg = int(boundary.sum())
            if n_seg > C:
                raise Unsupported(f"group capacity overflow ({n_seg} > {C})")
            starts = torch.nonzero(boundary).flatten()
            ends = torch.nonzero(is_end).flatten()

            def int_segsum(sv):
                w = sv.to(torch.int64)
                csum = torch.cumsum(w, 0)
                return csum[ends] - csum[starts] + w[starts]

            pid_c = spid[ends]
            key_vals: list = []
            key_valid: list = []
            for (mpos, vpos) in key_layout:
                key_vals.append(skeys[vpos][ends])
                key_valid.append(None if mpos is None else skeys[mpos][ends] == 0)

            accs: list = []
            acc_valid: list = []
            acc_kind: list = []
            acc_scale: list = []
            for ai, (d, (pay_idx, ncnt_idx)) in enumerate(zip(agg_descs, pay_plan)):
                sv = spays[pay_idx]
                if d.func in ("count", "count_all"):
                    accs.append(int_segsum(sv))
                    acc_valid.append(None)
                    acc_kind.append("i64")
                    acc_scale.append(0)
                    continue
                src = n_group + ai
                if d.func == "sum" and not sv.dtype.is_floating_point:
                    accs.append(int_segsum(sv))
                else:
                    out = _segscan(sv, boundary, d.func)[ends]
                    if kinds[src] in ("i64", "money") and out.dtype != torch.int64:
                        out = out.to(torch.int64)
                    accs.append(out)
                if ncnt_idx is not None:
                    acc_valid.append(int_segsum(spays[ncnt_idx]) > 0)
                else:
                    acc_valid.append(None)
                acc_kind.append(kinds[src])
                acc_scale.append(scales[src])
            cell["keys"] = key_vals
            cell["key_valid"] = key_valid
            cell["accs"] = accs
            cell["acc_valid"] = acc_valid
            cell["acc_kind"] = acc_kind
            cell["acc_scale"] = acc_scale

            alive = torch.ones((n_seg,), dtype=torch.bool, device=dev)
            for kf in keep_fns:
                alive = alive & true_mask(kf(cols, luts))

            out_vals = [f(cols, luts) for f in out_fns]
            out_meta = []
            for v, slot in zip(out_vals, out_slots):
                if v.kind == "code" and (slot is None or not isinstance(slot, int)):
                    raise Unsupported("computed string output")
                out_meta.append((v.kind, v.scale, slot, v.valid is not None))
            meta["out"] = out_meta

            # ---- phase 2 sort: (dead, pid, user keys...), stable ---------
            ops2: list = [(~alive).to(torch.int32), pid_c]
            for (kf, asc, nf, lut_idx) in sort_specs:
                v = kf(cols, luts)
                arr = v.arr
                if v.kind == "code":
                    if lut_idx is None:
                        raise Unsupported("unranked string sort key")
                    arr = take(luts[lut_idx], arr)
                if arr.dtype == torch.bool:
                    arr = arr.to(torch.int32)
                arr = torch.broadcast_to(arr, (n_seg,))
                if not asc:
                    arr = -arr
                if v.valid is not None:
                    marker = torch.broadcast_to(~v.valid, (n_seg,)).to(torch.int32)
                    ops2.append(-marker if nf else marker)  # nulls first → ahead
                ops2.append(arr)
            perm2 = _lexsort(ops2) if n_seg else torch.zeros((0,), dtype=torch.int64, device=dev)
            alive_s = alive[perm2]
            spid2 = pid_c[perm2]
            keep_out = alive_s
            if fetch is not None and n_seg:
                first = torch.nonzero(_first_of_run(spid2)).flatten()
                run_id = torch.cumsum(_first_of_run(spid2).to(torch.int64), 0) - 1
                rank = torch.arange(n_seg, device=dev) - first[run_id]
                keep_out = keep_out & (rank < fetch)
            row_src = perm2[keep_out]
            pid_final = spid2[keep_out]
            n_out = int(row_src.shape[0])

            outs: list = []
            for v in out_vals:
                outs.append(torch.broadcast_to(v.arr, (n_seg,))[row_src])
            for v in out_vals:
                if v.valid is not None:
                    outs.append(torch.broadcast_to(v.valid, (n_seg,))[row_src])
            return tuple(outs) + (pid_final, n_seg, n_out)

        return raw, ctx, meta

    # ------------------------------------------------------------------

    def _decode(self, outs, meta: dict, P_result: int, dicts) -> dict[int, list[pa.RecordBatch]]:
        schema = self.schema()
        P_out = meta["P_out"]  # kernel pid space; ≤ P_result under bypass
        n_out = outs[-1]
        results = {p: [_empty_batch(schema)] for p in range(P_result)}
        if n_out == 0:
            return results
        data = [o.cpu().numpy() for o in outs[:-2]]
        out_meta = meta["out"]
        n_cols = len(out_meta)
        vals = data[:n_cols]
        valid_planes = data[n_cols:-1]
        pid = data[-1]
        vi = 0
        arrays: list[pa.Array] = []
        for (kind, scale, slot, has_valid), f in zip(out_meta, schema):
            v = vals[len(arrays)]
            null_mask = None
            if has_valid:
                null_mask = ~valid_planes[vi]
                vi += 1
            if kind == "code":
                dic = dicts[slot]
                py = [None if (null_mask is not None and null_mask[j]) else dic[int(c)]
                      for j, c in enumerate(v)]
                arr = pa.array(py, f.type)
            elif kind == "date":
                arr = pa.array(v.astype(np.int32), pa.int32(),
                               mask=null_mask).cast(pa.date32())
            elif kind == "money":
                arr = pa.array(v.astype(np.float64) / (10 ** scale), pa.float64(),
                               mask=null_mask)
            elif kind == "bool":
                arr = pa.array(v.astype(bool), mask=null_mask)
            else:
                arr = pa.array(v, mask=null_mask)
            if arr.type != f.type:
                arr = arr.cast(f.type)
            arrays.append(arr)
        for p in range(P_out):
            sel = np.nonzero(pid == p)[0]
            if not len(sel):
                continue
            # take preserves order: rows are already (pid, sort-key) ordered
            cols_p = [a.take(pa.array(sel, pa.int32())) for a in arrays]
            results[p] = [pa.RecordBatch.from_arrays(cols_p, schema=schema)]
        return results
