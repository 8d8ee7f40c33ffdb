"""Run physical-plan subtrees as PyTorch stages on the CUDA card.

Counterpart of the JAX package's ops/tpu/stage_compiler.py, cut to the
slice the port carries so far. TpuStageExec (the name kept, like every
config key) replaces a `HashAggregateExec(partial)` whose input chain is
Filter*/Projection*/CoalesceBatches* over a scan, with filterless semi and
anti joins on the probe chain. The execution model is the reference's:

- the WHOLE table (all scan partitions) is encoded once with UNIFIED
  dictionaries and cached on the card as [P, N] stacked columns
  (DeviceTableCache; LRU against ballista.tpu.max.device.bytes);
- scan filters, projections and semi/anti membership masks are lowered
  into closures that process all P partitions in one pass; the grouped
  reduction runs either as exact torch reductions (aggregate_lane) or,
  under `fused_pallas`, through the hand-written `masked_group_reduce`
  kernel (pallas_lane), behind the reference's `pallas_ok` gate;
- per query the host round trips are O(1): upload LUTs (cached), one
  pass, one batched fetch.

Output batches match the partial aggregate's schema exactly, so the
downstream repartition/final-aggregate machinery is engine-agnostic.

Any other shape raises `Unsupported` and the subtree re-runs on the CPU
engine, counted in `fallback_count`: inner and outer joins with payload
gathers, aggregate-through-join, semi/anti joins with a residual filter,
sorted-mode builds, the sorted large-domain aggregation, the staged mode,
the mesh, the daemon, and the spill and grace rungs. Only `Unsupported`
falls back: a kernel build or launch error, or a missing card, raises out
of the query.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import logging
import os
import threading
import time
import zlib
from typing import Iterator

import numpy as np
import pyarrow as pa
import torch

from ballista_tpu_torch.config import (
    TPU_COMPILE_CACHE_DIR,
    TPU_FILL_THREADS,
    TPU_FUSION_PALLAS_MAX_GROUPS,
    TPU_MAX_DEVICE_BYTES,
    TPU_MIN_ROWS,
    BallistaConfig,
    _env_int,
)
from ballista_tpu_torch.ops.cuda import hbm, runtime
from ballista_tpu_torch.ops.cuda.columnar import encode_stacked, next_bucket, to_device
from ballista_tpu_torch.ops.cuda.kernels import (
    DevVal,
    Lowering,
    Unsupported,
    lower_expr,
    take,
    true_mask,
)
from ballista_tpu_torch.plan.expressions import Alias, Column, Expr
from ballista_tpu_torch.plan.physical import (
    CoalesceBatchesExec,
    ExecutionPlan,
    FilterExec,
    HashAggregateExec,
    ParquetScanExec,
    ProjectionExec,
    TaskContext,
    _concat,
    _empty_batch,
)
from ballista_tpu_torch.plan.schema import DFSchema
from ballista_tpu_torch.utils.lru import LruDict

log = logging.getLogger(__name__)

MAX_SEGMENTS = 1 << 16

# Entry budgets (env-tunable safety rails for long-lived processes).
# (table_key, fingerprint, device) → device LUT tensors
_LUT_CACHE = LruDict(_env_int("BALLISTA_TPU_LUT_CACHE_ENTRIES", 256))
# (table_key, fingerprint, join_idx, device) → BuildTable
_BUILD_CACHE = LruDict(
    _env_int("BALLISTA_TPU_BUILD_CACHE_ENTRIES", 32),
    max_bytes=_env_int("BALLISTA_TPU_BUILD_CACHE_BYTES", 2 * 1024**3),
    sizer=lambda bt: sum(int(a.numel() * a.element_size()) for a in bt.flat_arrays()),
)


class RunStats:
    """Per-stage-run diagnostics.

    Every stage dispatch opens a `run(tag)` scope that collects into a
    private per-run dict and publishes atomically on exit: `snapshot()`
    is a consistent most-recent-run-wins view, and `stages()` keeps the
    last few per-stage records.

    Keys the port fills: fill_s (whole device fill), encode_s (host encode
    wall), upload_s (host→card copies), device_bytes, exec_s (dispatch +
    fetch + decode), fused_kernel_s (device seconds of the stage pass),
    fusion_mode (fused_xla | fused_pallas — the mode that actually ran),
    fusion_reason (the cost model's stated rationale), fused_spans
    (operator spans run in the stage pass), hbm_budget_bytes, hbm_plan
    (run_whole | cpu_demote) and hbm_plan_reason."""

    _MAX_STAGES = 32

    def __init__(self):
        import collections

        self._lock = threading.Lock()
        self._merged: dict = {}
        self._stages: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._tls = threading.local()

    @contextlib.contextmanager
    def run(self, tag: str):
        rec: dict = {}
        prev = getattr(self._tls, "rec", None)
        self._tls.rec = rec
        try:
            yield rec
        finally:
            self._tls.rec = prev
            self._publish(tag, rec)

    def _publish(self, tag: str, rec: dict) -> None:
        if not rec:
            return
        with self._lock:
            self._merged.update(rec)
            self._stages.pop(tag, None)
            self._stages[tag] = dict(rec)
            while len(self._stages) > self._MAX_STAGES:
                self._stages.popitem(last=False)

    def set(self, key: str, value, rec: dict | None = None) -> None:
        """Record one stat. With `rec` (a run's private dict, threadable to
        helper threads) the write lands in that run; otherwise in the
        calling thread's open run scope, else directly in the merged view."""
        if rec is None:
            rec = getattr(self._tls, "rec", None)
        if rec is not None:
            rec[key] = value
        else:
            with self._lock:
                self._merged[key] = value

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._merged)

    def stages(self) -> dict:
        with self._lock:
            return {t: dict(r) for t, r in self._stages.items()}


RUN_STATS = RunStats()

DIRECT_TABLE_MAX = 1 << 27  # 128M entries × int32 = 512 MB ceiling


class BuildTable:
    """A filterless semi/anti join's build side, keys only, for device
    membership probing (the 'direct' mode of the reference): a dense
    key→row int32 table [T] (-1 absent) — one gather per probe — or, when
    build keys repeat, lo/cnt tables [T] whose cnt > 0 marks membership.
    No payload columns: a membership probe never gathers build values."""

    def __init__(self, keys, n_rows, dup=1, cnt=None):
        self.mode = "direct"
        self.keys = keys  # int32 [T] row (dup == 1) or lo (dup > 1) table
        self.cnt = cnt  # int32 [T] per-key match count, dup > 1 only
        self.n_rows = n_rows
        self.dup = dup
        self.shifts: list[int] = []  # multi-key combine shifts (per extra key)
        self.kinds: list = []
        self.dicts: list = []

    def flat_arrays(self):
        """Device-arg layout: keys [, cnt] (offset contract shared with
        the finder closures)."""
        return [self.keys] + ([self.cnt] if self.cnt is not None else [])

    def shape_key(self):
        return (self.mode, int(self.keys.shape[0]), tuple(self.shifts), self.dup,
                self.cnt is not None)


class DeviceTable:
    """All partitions of one scan, device-resident as [P, N] stacks."""

    def __init__(self, kinds, scales, dicts, cols, mask, part_rows, nbytes,
                 valids=None):
        self.kinds = kinds  # per column
        self.scales = scales
        self.dicts = dicts  # unified (global) dictionaries
        self.cols = cols  # list of tensors [P, N]
        self.mask = mask  # bool tensor [P, N]
        self.part_rows = part_rows
        self.nbytes = nbytes
        # per column: bool [P, N] validity plane, or None (no nulls);
        # value slots under an invalid plane hold type-default fills
        self.valids = valids if valids is not None else [None] * len(cols)

    @property
    def shape(self):
        return tuple(self.mask.shape)

    def flat_cols(self):
        """Device-arg layout: data columns, then the validity planes of the
        nullable columns (offset contract shared with _mk_col_reader)."""
        return list(self.cols) + [v for v in self.valids if v is not None]

    def valid_flat_idx(self) -> list:
        """Per column: index of its validity plane in flat_cols(), or None."""
        out = []
        nxt = len(self.cols)
        for v in self.valids:
            if v is None:
                out.append(None)
            else:
                out.append(nxt)
                nxt += 1
        return out


class DeviceTableCache:
    def __init__(self):
        import collections

        self._cache: "collections.OrderedDict[tuple, DeviceTable]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._inflight: dict[tuple, threading.Event] = {}

    def table_key(self, scan, device) -> tuple:
        # the device in the key: tables committed to one card never serve
        # another (or the CPU)
        return self.key_of(scan) + (str(device),)

    def get(self, scan, buckets: list[int], ctx, max_bytes: int, device, *,
            fill_threads: int = 0, stats: dict | None = None) -> DeviceTable:
        key = self.table_key(scan, device)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
            ev = self._inflight.get(key)
            owner = ev is None
            if owner:
                ev = threading.Event()
                self._inflight[key] = ev
        if not owner:
            ev.wait()
            with self._lock:
                hit = self._cache.get(key)
            if hit is None:
                raise Unsupported("peer encode failed")
            return hit
        try:
            t0 = time.time()
            dt = self._load(scan, buckets, ctx, device, fill_threads=fill_threads,
                            stats=stats)
            RUN_STATS.set("fill_s", round(time.time() - t0, 3), rec=stats)
            RUN_STATS.set("device_bytes", dt.nbytes, rec=stats)
            with self._lock:
                total = sum(v.nbytes for v in self._cache.values())
                while self._cache and total + dt.nbytes > max_bytes:
                    _old_key, old = self._cache.popitem(last=False)
                    total -= old.nbytes
                self._cache[key] = dt
            return dt
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def peek(self, scan, device) -> DeviceTable | None:
        """The resident table for `scan` on `device`, or None (no fill)."""
        with self._lock:
            return self._cache.get(self.table_key(scan, device))

    def resident_bytes(self, exclude_key: tuple | None = None) -> int:
        """Device bytes held by cached tables other than `exclude_key`."""
        with self._lock:
            return sum(v.nbytes for k, v in self._cache.items() if k != exclude_key)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()

    def key_of(self, scan) -> tuple:
        if isinstance(scan, ParquetScanExec):
            files = tuple(
                tuple((f["file"], tuple(f.get("row_groups") or ())) for f in p.get("files", []))
                for p in scan.partitions
            )
            return (files, tuple(scan.projection))
        token = getattr(scan, "mem_token", None)
        if token is not None:
            return ("mem", token)  # monotonic: never aliases like id() does
        return ("obj", id(scan), id(type(scan)))

    def _load(self, scan, buckets: list[int], ctx, device, *,
              fill_threads: int = 0, stats: dict | None = None) -> DeviceTable:
        """Read, encode and upload the whole scan as [P, N] stacks.

        Columns encode on a small host pool while the caller thread copies
        each finished stack to the card in column order, so the encode of
        column k+1 overlaps the upload of column k; at most (threads + 2)
        encoded stacks are alive at once. `fill_threads` 0 = auto, 1 =
        strict serial."""
        if isinstance(scan, ParquetScanExec):
            raw = ParquetScanExec(scan.df_schema, scan.partitions, scan.projection, [], scan.table_name)
        else:
            raw = scan
        P = raw.output_partition_count()

        def read(p):
            return _concat([b for b in raw.execute(p, ctx) if b.num_rows], raw.schema())

        with _fut.ThreadPoolExecutor(max_workers=min(P, 8)) as pool:
            tables = list(pool.map(read, range(P)))
        part_rows = [t.num_rows for t in tables]
        full = pa.concat_tables(tables)
        del tables  # concat is zero-copy; the chunks live on via `full`
        N = next_bucket(max(max(part_rows), 1), buckets)

        names = list(full.column_names)
        n_cols = len(names)
        col_refs: list = [full.column(name) for name in names]
        del full

        threads = int(fill_threads)
        if threads <= 0:
            threads = min(8, max(2, (os.cpu_count() or 4) // 2), max(n_cols, 1))
        pipelined = threads > 1 and n_cols > 1

        kinds: list = [None] * n_cols
        scales: list = [0] * n_cols
        dicts: list = [None] * n_cols
        cols: list = [None] * n_cols
        valids: list = [None] * n_cols
        nbytes = 0
        t_enc0 = time.time()

        def encode_one(i: int):
            dc = encode_stacked(col_refs[i], part_rows, N)
            col_refs[i] = None  # release the arrow buffers
            if dc is None:
                raise Unsupported(f"unencodable column {names[i]}")
            kinds[i] = dc.kind
            scales[i] = dc.scale
            dicts[i] = dc.dictionary
            return dc

        t_up = 0.0

        def upload(i: int, dc) -> None:
            nonlocal nbytes, t_up
            t0u = time.time()
            cols[i] = _put(dc.data, device)
            nbytes += dc.data.nbytes
            if dc.valid is not None:
                valids[i] = _put(dc.valid, device)
                nbytes += dc.valid.nbytes
            t_up += time.time() - t0u

        if pipelined:
            window = threads + 2
            with _fut.ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="cuda-fill"
            ) as pool:
                pending: dict[int, _fut.Future] = {}
                nxt = 0
                for i in range(n_cols):
                    while nxt < n_cols and nxt < i + window:
                        pending[nxt] = pool.submit(encode_one, nxt)
                        nxt += 1
                    try:
                        dc = pending.pop(i).result()
                    except BaseException:
                        for f in pending.values():
                            f.cancel()
                        raise
                    upload(i, dc)
                    del dc
        else:
            for i in range(n_cols):
                upload(i, encode_one(i))
        RUN_STATS.set("encode_s", round(time.time() - t_enc0 - t_up, 3), rec=stats)

        mask_np = np.zeros((P, N), dtype=bool)
        for p, r in enumerate(part_rows):
            mask_np[p, :r] = True
        t0u = time.time()
        mask = _put(mask_np, device)
        nbytes += mask_np.nbytes
        if device.type == "cuda":
            # fill_s must mean "table resident", not "last copy enqueued"
            torch.cuda.synchronize(device)
        t_up += time.time() - t0u
        RUN_STATS.set("upload_s", round(t_up, 3), rec=stats)
        return DeviceTable(kinds, scales, dicts, cols, mask, part_rows, nbytes, valids)


DEVICE_CACHE = DeviceTableCache()


def clear_device_caches() -> None:
    """Release every module-level device cache: resident tables, string
    LUTs and join build tables."""
    DEVICE_CACHE.clear()
    _LUT_CACHE.clear()
    _BUILD_CACHE.clear()


class TpuStageExec(ExecutionPlan):
    def __init__(self, partial_agg: HashAggregateExec, ops: list, scan: ExecutionPlan,
                 config: BallistaConfig):
        super().__init__(partial_agg.df_schema)
        self.partial_agg = partial_agg
        self.ops = ops  # dataflow-ordered FilterExec/ProjectionExec/HashJoinExec nodes
        self.scan = scan
        self.config = config
        self.min_rows = int(config.get(TPU_MIN_ROWS))
        self.buckets = config.shape_buckets()
        self.fallback_count = 0
        self.tpu_count = 0
        self._results: dict[int, list[pa.RecordBatch]] | None = None
        self._results_lock = threading.Lock()
        # partitions served since the last (re-)dispatch: once every resident
        # result has been read at least once, the decoded host batches are
        # evicted instead of staying pinned for the stage's lifetime
        self._served_since_dispatch: set[int] = set()
        self._device_ok = False

        # structural fingerprint: identical stages across queries share
        # compiled entries. Join ops contribute their FULL build subtree, so
        # joins against differently filtered builds never share a build.
        def op_fp(op) -> str:
            from ballista_tpu_torch.plan.physical import HashJoinExec

            if isinstance(op, HashJoinExec):
                return op.node_str() + "«" + op.left.display() + "»"
            return op.node_str()

        self.fingerprint = "|".join(
            [partial_agg.node_str()]
            + [op_fp(op) for op in ops]
            + [scan.node_str(), repr(scan.df_schema)]
        )

    def children(self) -> list[ExecutionPlan]:
        return [self.scan]

    def with_children(self, c):
        return TpuStageExec(self.partial_agg, self.ops, c[0], self.config)

    def output_partition_count(self) -> int:
        return self.scan.output_partition_count()

    def node_str(self) -> str:
        # live counters surface in EXPLAIN ANALYZE / stage metrics so
        # operators can SEE whether the device path ran or fell back
        extra = ""
        if self.tpu_count or self.fallback_count:
            extra = f" device_runs={self.tpu_count} cpu_fallbacks={self.fallback_count}"
        return f"TpuStageExec: [{self.partial_agg.node_str()}] ops={len(self.ops)}{extra}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(iter(self._run(partition, ctx)))

    # ------------------------------------------------------------------

    def _run(self, partition: int, ctx: TaskContext) -> list[pa.RecordBatch]:
        with self._results_lock:
            if self._results is None:
                try:
                    self._results = self._dispatch_all(ctx)
                    self.tpu_count += 1
                    self._device_ok = True
                except Unsupported as e:
                    # the declared ladder only (an unported shape, an hbm
                    # demote): a build, launch or device error propagates
                    log.info("device fallback (%s): %s", e, self.partial_agg.node_str())
                    self._results = {}
            if partition not in self._results and self._device_ok:
                # a consumer re-executed a partition whose device result was
                # already popped: the table and compiled entry are hot, so a
                # re-dispatch costs ~the exec time — never a host re-scan
                try:
                    self._results.update(self._dispatch_all(ctx))
                    self.tpu_count += 1
                    self._served_since_dispatch = set()
                    if partition in self._results:
                        out = list(self._results[partition])
                        self._note_served_locked(partition)
                        return out
                except Unsupported:
                    log.warning("device stage re-run declined; cpu fallback for %s",
                                self.partial_agg.node_str(), exc_info=True)
                    self._device_ok = False
            if partition in self._results:
                out = self._results.pop(partition)
                self._note_served_locked(partition)
                return out
        return self._fallback(partition, ctx)

    def _note_served_locked(self, partition: int) -> None:
        """Bound re-run retention (call under _results_lock): when every
        still-resident result has been served at least once since the last
        dispatch, drop them all — they only exist for re-read convenience."""
        self._served_since_dispatch.add(partition)
        if self._results and set(self._results) <= self._served_since_dispatch:
            self._results = {}

    def _dispatch_all(self, ctx: TaskContext) -> dict[int, list[pa.RecordBatch]]:
        """One whole-stage dispatch on the task's card (or the CPU when the
        caller asked for it)."""
        tag = f"stage_{zlib.crc32(self.fingerprint.encode()):08x}"
        with RUN_STATS.run(tag) as rec:
            return self._tpu_run_all_inner(ctx, rec)

    def _raw_chain(self) -> ExecutionPlan:
        """The original pre-aggregation subtree this wrapper replaced,
        rebuilt from its pieces: what _fallback re-executes on the host."""
        from ballista_tpu_torch.plan.physical import HashJoinExec

        node: ExecutionPlan = self.scan
        for op in self.ops:
            if isinstance(op, HashJoinExec):
                node = op.with_children([op.left, node])
            else:
                node = op.with_children([node])
        return node

    def _fallback(self, partition: int, ctx: TaskContext) -> list[pa.RecordBatch]:
        """Re-run the original CPU subtree (scan filters applied on host)."""
        self.fallback_count += 1
        agg = self.partial_agg.with_children([self._raw_chain()])
        return [b for b in agg.execute(partition, ctx)]

    # ------------------------------------------------------------------

    def _prepare_build(self, join, jidx: int, ctx: TaskContext, table_key,
                       device) -> BuildTable:
        """Collect + encode a filterless semi/anti join's build keys for
        device membership probing."""
        from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array

        if join.join_type not in ("right_semi", "right_anti") or join.filter is not None:
            raise Unsupported(
                f"{join.join_type} join with payload gathers is not ported")
        cache_key = (table_key, self.fingerprint, jidx, str(device))
        hit = _BUILD_CACHE.get(cache_key)
        if hit is not None:
            return hit

        batches = []
        for p in range(join.left.output_partition_count()):
            batches.extend(b for b in join.left.execute(p, ctx) if b.num_rows)
        tbl = _concat(batches, join.left.schema()).combine_chunks()
        if tbl.num_rows:
            # a build row whose key is NULL can never match any probe row:
            # drop it before encoding
            import pyarrow.compute as _pc

            keep = None
            for l_expr, _ in join.on:
                arr = evaluate_to_array(
                    bind_expr(l_expr, join.left.df_schema), tbl.to_batches()[0]
                )
                if arr.null_count:
                    va = arr.is_valid()
                    keep = va if keep is None else _pc.and_(keep, va)
            if keep is not None:
                tbl = tbl.filter(keep).combine_chunks()
        if tbl.num_rows == 0:
            raise Unsupported("empty build side (let CPU/AQE handle it)")
        batch = tbl.to_batches()[0]

        # combined int64 key, range-guarded; each extra key gets the
        # smallest shift covering its build-side range
        key_np = None
        shifts: list[int] = []
        for l_expr, _ in join.on:
            arr = evaluate_to_array(bind_expr(l_expr, join.left.df_schema), batch)
            if arr.null_count:
                raise Unsupported("NULL build keys survived the pre-filter")
            t = arr.type
            if pa.types.is_date(t):
                vals = arr.cast(pa.int32()).cast(pa.int64()).to_numpy(zero_copy_only=False)
            elif pa.types.is_integer(t):
                vals = arr.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False)
            else:
                raise Unsupported(f"non-integer join key {t}")
            vals = vals.astype(np.int64)
            if key_np is None:
                key_np = vals
            else:
                if (vals < 0).any():
                    raise Unsupported("negative secondary join key")
                shift = max(1, int(vals.max()).bit_length())
                if (key_np < 0).any() or (int(key_np.max()) >> (62 - shift)) > 0:
                    raise Unsupported("primary join key out of combine range")
                key_np = (key_np << shift) | vals
                shifts.append(shift)
        uniq, counts = np.unique(key_np, return_counts=True)
        dup = int(counts.max())
        max_key = int(key_np.max())
        min_key = int(key_np.min())
        if not (min_key >= 0 and max_key + 1 <= DIRECT_TABLE_MAX):
            raise Unsupported("sorted-mode build (key range past the direct table) is not ported")
        T = _pow2(max_key + 1)
        if dup == 1:
            table = np.full(T, -1, dtype=np.int32)
            table[key_np] = np.arange(len(key_np), dtype=np.int32)
            bt = BuildTable(_put(table, device), len(key_np))
        else:
            # expansion layout: lo/cnt tables (payload order key-sorted); a
            # membership probe reads only cnt > 0
            sorted_keys = np.sort(key_np, kind="stable")
            lo_table = np.zeros(T, dtype=np.int32)
            cnt_table = np.zeros(T, dtype=np.int32)
            lo_table[uniq] = np.searchsorted(sorted_keys, uniq).astype(np.int32)
            cnt_table[uniq] = counts.astype(np.int32)
            bt = BuildTable(_put(lo_table, device), len(key_np), dup=dup,
                            cnt=_put(cnt_table, device))
        bt.shifts = shifts
        _BUILD_CACHE[cache_key] = bt
        return bt

    def _fusion_decision(self, dt: DeviceTable, builds: list[BuildTable]):
        """Run the fusion cost model over compile-time stage facts. The
        platform comes from the device the table lives on."""
        from ballista_tpu_torch.ops.cuda import fusion

        est = fusion.estimate_stage(self.scan, self.ops, self.partial_agg, dt, builds)
        cm = fusion.CostModel.from_config(self.config)
        cm.platform = dt.mask.device.type
        return cm.choose(est), est

    def _run_mode(self, dt: DeviceTable, builds: list[BuildTable], table_key,
                  rec: dict, mode_req: str):
        """Lower the stage for `mode_req` and run it once over the table.
        Lowering builds closures only (PyTorch runs eagerly), so nothing is
        cached but the device LUTs. Returns (meta, device outputs)."""
        fn, lowering, meta = self._compile(dt, builds, mode_req)
        lut_key = (table_key, self.fingerprint, str(dt.mask.device))
        luts = _LUT_CACHE.get(lut_key)
        if luts is None:
            luts = [_put(l, dt.mask.device)
                    for l in lowering.build_luts(dt.dicts, [b.dicts for b in builds])]
            _LUT_CACHE[lut_key] = luts
        t0 = time.time()
        outs, run_meta = fn(dt.flat_cols(), luts, dt.mask,
                            [b.flat_arrays() for b in builds])
        if dt.mask.device.type == "cuda":
            torch.cuda.synchronize(dt.mask.device)
        rec["fused_kernel_s"] = round(time.time() - t0, 6)
        return {**meta, **run_meta}, outs

    def _run_stage(self, dt: DeviceTable, builds: list[BuildTable], table_key,
                   rec: dict, mode_req: str):
        """The fallback ladder's top rung: a fused_pallas request whose
        stage turns out kernel-ineligible when it runs raises Unsupported
        — retry once as fused_xla instead of knocking the whole stage off
        the device."""
        try:
            return self._run_mode(dt, builds, table_key, rec, mode_req)
        except Unsupported:
            if mode_req != "fused_pallas":
                raise
            log.info("fused_pallas ineligible; retrying fused_xla")
            return self._run_mode(dt, builds, table_key, rec, "fused_xla")

    def _tpu_run_all_inner(self, ctx: TaskContext,
                           rec: dict) -> dict[int, list[pa.RecordBatch]]:
        """One dispatch + one fetch for every partition of this stage."""
        from ballista_tpu_torch.plan.physical import HashJoinExec

        device = runtime.device(ctx.device_ordinal)
        cc_dir = str(self.config.get(TPU_COMPILE_CACHE_DIR) or "")
        if cc_dir:
            runtime.init_compile_cache(cc_dir)
        max_bytes = int(self.config.get(TPU_MAX_DEVICE_BYTES))
        budget = hbm.resolve_hbm_budget(self.config)
        if budget > 0:
            # the cache cap never exceeds the admission budget
            max_bytes = min(max_bytes, budget)
        table_key = DEVICE_CACHE.key_of(self.scan)
        join_ops = [o for o in self.ops if isinstance(o, HashJoinExec)]
        dt = DEVICE_CACHE.get(self.scan, self.buckets, ctx, max_bytes, device,
                              fill_threads=int(self.config.get(TPU_FILL_THREADS)),
                              stats=rec)
        if sum(dt.part_rows) < self.min_rows:
            raise Unsupported(f"only {sum(dt.part_rows)} rows (< tpu min)")
        builds = [self._prepare_build(op, jidx, ctx, table_key, device)
                  for jidx, op in enumerate(join_ops)]

        dec, est = self._fusion_decision(dt, builds)
        rec["fusion_reason"] = dec.reason
        my_key = DEVICE_CACHE.table_key(self.scan, device)
        plan = hbm.plan_stage(
            est, budget,
            grace_eligible=(not est.has_mult and 0 <= est.max_build_jidx < len(join_ops)
                            and join_ops[est.max_build_jidx].join_type == "inner"),
            resident_other=DEVICE_CACHE.resident_bytes(exclude_key=my_key),
        )
        rec["hbm_budget_bytes"] = budget
        rec["hbm_plan"] = plan.decision
        rec["hbm_plan_reason"] = plan.reason
        if plan.decision == hbm.CPU_DEMOTE:
            raise Unsupported(f"hbm plan: {plan.reason}")

        t0 = time.time()
        meta, outs = self._run_stage(dt, builds, table_key, rec, dec.mode)
        rec["fusion_mode"] = meta.get("fusion_mode", "fused_xla")
        rec["fused_spans"] = meta.get("fused_spans", 0)
        outs = [o.cpu().numpy() for o in outs]  # one fetch per output
        res = self._decode_all(outs, meta, dt.shape[0], dt.dicts)
        rec["exec_s"] = round(time.time() - t0, 6)
        return res

    # ------------------------------------------------------------------

    def _compile(self, dt: DeviceTable, builds: list[BuildTable], mode_req: str):
        """Lower the stage into one closure over (cols, luts, mask, builds).
        Returns (fn, lowering, meta); `fn` returns (outputs, run meta)."""
        from ballista_tpu_torch.ops.cuda import fusion as _fusion
        from ballista_tpu_torch.ops.cuda.cuda_kernels import MAX_GROUPS as _KERNEL_MAX_G
        from ballista_tpu_torch.plan.physical import HashJoinExec

        if mode_req == "staged":
            raise Unsupported("the staged fusion mode is not ported")
        agg = self.partial_agg
        scan_schema = self.scan.df_schema
        kinds = list(zip(dt.kinds, dt.scales))
        dicts = dt.dicts
        P = dt.shape[0]
        spans = _fusion.plan_spans(
            len(getattr(self.scan, "filters", []) or []), self.ops, agg)
        use_pallas = mode_req == "fused_pallas"
        pallas_g_cap = min(int(self.config.get(TPU_FUSION_PALLAS_MAX_GROUPS)),
                           _KERNEL_MAX_G)

        ctx = Lowering(scan_schema, kinds, dicts)
        valid_idx = dt.valid_flat_idx()
        n_flat_cols = len(dt.cols) + sum(1 for v in dt.valids if v is not None)
        env_fns = []
        for i, (kind, scale) in enumerate(kinds):
            env_fns.append(_mk_col_reader(i, kind, scale, dicts[i], valid_idx[i]))
        env_meta = [(k, s, d, i) for i, ((k, s), d) in enumerate(zip(kinds, dicts))]
        ctx.env_fns = env_fns
        ctx.env_meta = env_meta
        filter_fns = []

        cur_schema = scan_schema
        _bind_env(ctx, cur_schema)
        # scan-level predicates run ON DEVICE (cache holds raw columns)
        for f in getattr(self.scan, "filters", []):
            filter_fns.append(lower_expr(f, ctx))

        jidx = 0
        for op in self.ops:
            _bind_env(ctx, cur_schema)
            if isinstance(op, FilterExec):
                filter_fns.append(lower_expr(op.predicate, ctx))
            elif isinstance(op, HashJoinExec):
                if op.join_type not in ("right_semi", "right_anti") or op.filter is not None:
                    raise Unsupported(
                        f"{op.join_type} join with payload gathers is not ported")
                bt = builds[jidx]
                # build arrays ride at the tail of the flattened cols list
                # (after the scan columns AND their validity planes)
                off = n_flat_cols + sum(len(builds[i].flat_arrays()) for i in range(jidx))
                probe_fns = [lower_expr(r, ctx) for (_, r) in op.on]
                finder = _mk_join_finder(off, probe_fns, bt)
                neg = op.join_type == "right_anti"
                # membership only: the match mask filters probe rows
                # (EXISTS / NOT IN after decorrelation) — no build columns,
                # no expansion lanes, schema unchanged
                filter_fns.append(
                    lambda cols, luts, _f=finder, _n=neg:
                    DevVal("bool", ~_f(cols, luts) if _n else _f(cols, luts))
                )
                jidx += 1
            elif isinstance(op, ProjectionExec):
                new_fns, new_meta = [], []
                for e in op.exprs:
                    new_fns.append(lower_expr(e, ctx))
                    new_meta.append(_passthrough_meta(e, ctx, cur_schema))
                ctx.env_fns, ctx.env_meta = new_fns, new_meta
                cur_schema = op.df_schema
            elif isinstance(op, CoalesceBatchesExec):
                pass
            else:
                raise Unsupported(f"op {type(op).__name__}")
        _bind_env(ctx, cur_schema)

        # Group-key strategy: small dictionary domains unroll into per-group
        # masked reductions. Everything else (int64 keys, composite keys,
        # big dictionaries) needs the sorted segmented reduction, which
        # is not ported.
        unrolled = True
        group_src_slots: list = []
        group_fns: list = []
        pad_sizes: list = []
        for g in agg.group_exprs:
            gc = g.expr if isinstance(g, Alias) else g
            if not isinstance(gc, Column):
                unrolled = False
                break
            i = cur_schema.index_of(gc.name, gc.qualifier)
            gmeta = ctx.env_meta[i]
            if gmeta is None or gmeta[0] != "code" or gmeta[2] is None:
                unrolled = False
                break
            if dt.valids[gmeta[3]] is not None:
                # a NULL group key needs its own group: the unrolled
                # code-domain form cannot tell null from code 0
                unrolled = False
                break
            group_fns.append(ctx.env_fns[i])
            group_src_slots.append(gmeta[3])
            pad_sizes.append(_pow2(len(gmeta[2])))

        G = 1
        for p in pad_sizes:
            G *= p
        G = max(G, 1)
        if unrolled and agg.group_exprs and (
            G > 64 or G * P > MAX_SEGMENTS * 16
        ):
            # beyond this budget the unrolled form stops scaling — UNLESS the
            # kernel rung was requested and the stage fits it: its one pass
            # carries all G groups, so the 64-group budget lifts to the
            # kernel ceiling. If the value lanes turn out ineligible when the
            # stage runs (money int64 sums, validity planes), raw() raises
            # Unsupported and the ladder retries as fused_xla.
            pallas_agg_ok = (
                use_pallas
                and G <= pallas_g_cap and G * P <= 1 << 22
                and all(d.func in ("sum", "count", "count_all")
                        for d in agg.aggs)
            )
            if not pallas_agg_ok:
                unrolled = False
        if not unrolled:
            raise Unsupported("sorted large-domain aggregation is not ported")

        agg_fns = []
        for d in agg.aggs:
            if d.func not in ("sum", "min", "max", "count", "count_all",
                              "welford_mean", "welford_m2"):
                raise Unsupported(f"agg {d.func}")
            agg_fns.append(lower_expr(d.expr, ctx) if d.expr is not None else None)

        meta = {
            "fused_spans": len(spans),
            "group_src_slots": group_src_slots,
            "pad_sizes": pad_sizes,
        }
        aggs = agg.aggs

        def eval_pred(cols, luts, mask):
            """predicate span: scan filters, FilterExec predicates, semi/
            anti membership masks — one [P, N] boolean."""
            m = mask
            for ff in filter_fns:
                m = m & true_mask(ff(cols, luts))
            return m

        def eval_proj(cols, luts):
            """project span: group-id composition and agg value lanes."""
            gid = None
            for gf, psz in zip(group_fns, pad_sizes):
                codes = gf(cols, luts).arr.to(torch.int32)
                gid = codes if gid is None else gid * psz + codes
            vs = [af(cols, luts) if af is not None else None for af in agg_fns]
            return gid, vs

        def aggregate_lane(m, gid, vs):
            """aggregate span: per-group masked reductions (the exact torch
            form)."""
            gmasks = [m & (gid == g) for g in range(G)] if gid is not None else [m]
            outs = []
            out_meta = []
            nullcnts = []
            nullcnt_map: dict[int, int] = {}
            for ai, (d, v) in enumerate(zip(aggs, vs)):
                if v is None:
                    out_meta.append(("i64", 0))
                else:
                    out_meta.append(("i64", 0) if d.func == "count" else (v.kind, v.scale))
                outs.append(torch.stack(
                    [_masked_reduce(v, gm, d.func) for gm in gmasks], dim=1))  # [P, G]
                if (v is not None and v.valid is not None
                        and d.func in ("sum", "min", "max",
                                       "welford_mean", "welford_m2")):
                    # valid-count companion: a group whose inputs are all
                    # NULL must decode to NULL, not 0 / ±inf
                    nullcnt_map[ai] = len(nullcnts)
                    nullcnts.append(torch.stack(
                        [(gm & v.valid).sum(dim=1) for gm in gmasks], dim=1))
            presence = torch.stack([gm.sum(dim=1) for gm in gmasks], dim=1)
            info = {"out": out_meta, "nullcnt_map": nullcnt_map, "fusion_mode": "fused_xla"}
            return outs + nullcnts + [presence], info

        def pallas_lane(m, gid, vs):
            """aggregate span, kernel form: `masked_group_reduce` computes
            ALL G masked sums + counts in one pass per float value lane
            (exact int64 money stays on the torch reductions in
            aggregate_lane)."""
            from ballista_tpu_torch.ops.cuda.cuda_kernels import masked_group_reduce

            # sums first: every sum's kernel call also yields the counts,
            # so count aggs never need a dedicated pass
            sum_results: dict[int, object] = {}
            counts = None
            for i_, (d, v) in enumerate(zip(aggs, vs)):
                if d.func == "sum":
                    arr = torch.broadcast_to(v.arr, m.shape)
                    s, c = masked_group_reduce(arr, gid, m, G)
                    sum_results[i_] = s
                    counts = c if counts is None else counts
            if counts is None:  # count-only aggregation
                _, counts = masked_group_reduce(
                    torch.zeros(m.shape, dtype=torch.float32, device=m.device), gid, m, G)
            outs = []
            out_meta = []
            for i_, d in enumerate(aggs):
                if d.func in ("count", "count_all"):
                    outs.append(counts.to(torch.int64))
                    out_meta.append(("i64", 0))
                else:
                    outs.append(sum_results[i_].to(torch.float64))
                    out_meta.append(("f64", 0))
            info = {"out": out_meta, "nullcnt_map": {}, "fusion_mode": "fused_pallas"}
            return outs + [counts], info

        def raw(cols, luts, mask, build_args):
            # keep [P, N]: partitions are the leading axis, reductions run
            # over dim=1. Build arrays are appended after the scan columns.
            # Returns the outputs (aggregates, null counts, presence) and
            # this run's output metadata.
            cols = list(cols) + [a for b in build_args for a in b]
            m = eval_pred(cols, luts, mask)
            gid, vs = eval_proj(cols, luts)
            pallas_ok = (
                use_pallas and gid is not None and aggs
                and G <= pallas_g_cap
                and all(v is None or v.valid is None for v in vs)
                and all(
                    d.func in ("count", "count_all")
                    or (d.func == "sum" and v is not None and v.kind == "f64")
                    for d, v in zip(aggs, vs)
                )
            )
            if pallas_ok:
                return pallas_lane(m, gid, vs)
            if use_pallas and (G > 64 or G * m.shape[0] > MAX_SEGMENTS * 16):
                # this stage only kept the unrolled form because the relaxed
                # kernel budget admitted it; its value lanes turned out
                # kernel-ineligible — refuse the G-wide unroll and let the
                # fallback ladder retry
                raise Unsupported(f"pallas-ineligible aggregation at G={G}")
            return aggregate_lane(m, gid, vs)

        return raw, ctx, meta

    def _decode_all(self, outs: list[np.ndarray], meta: dict, P: int,
                    dicts) -> dict[int, list[pa.RecordBatch]]:
        agg = self.partial_agg
        schema = self.schema()
        group_dicts = [dicts[s] for s in meta["group_src_slots"]]
        presence = outs[-1]  # [P, G]
        n_aggs = len(meta["out"])
        nullcnt_map = meta.get("nullcnt_map", {})
        nullcnt_outs = outs[n_aggs:-1]
        results: dict[int, list[pa.RecordBatch]] = {}
        n_group = len(agg.group_exprs)
        for p in range(P):
            sel = np.nonzero(presence[p] > 0)[0]
            if not len(sel):
                results[p] = [_empty_batch(schema)]
                continue
            arrays: list[pa.Array] = []
            gid = sel.astype(np.int64)
            comps = []
            for psz in reversed(meta["pad_sizes"]):
                comps.append(gid % psz)
                gid = gid // psz
            comps = list(reversed(comps))
            for comp, d, f in zip(comps, group_dicts, schema):
                arrays.append(pa.array([d[int(c)] for c in comp], f.type))
            for ai, (out, (kind, scale), f) in enumerate(
                zip(outs[:n_aggs], meta["out"], list(schema)[n_group:])
            ):
                vals = out[p][sel]
                null_mask = None
                if ai in nullcnt_map:
                    # all agg inputs in the group were NULL → the agg is NULL
                    null_mask = nullcnt_outs[nullcnt_map[ai]][p][sel] == 0
                if kind == "money":
                    arr = pa.array(vals.astype(np.float64) / (10**scale), pa.float64(),
                                   mask=null_mask)
                elif kind == "date":
                    arr = pa.array(vals.astype(np.int32), pa.int32(), mask=null_mask).cast(pa.date32())
                else:
                    arr = pa.array(vals, mask=null_mask)
                if arr.type != f.type:
                    arr = arr.cast(f.type)
                arrays.append(arr)
            results[p] = [pa.RecordBatch.from_arrays(arrays, schema=schema)]
        return results


def _put(arr: np.ndarray, device) -> torch.Tensor:
    """Place one host array on the stage's device: the single place that
    decides placement, and the one place chaos hbm_oom can fault an
    upload."""
    hbm.maybe_chaos_oom()
    return to_device(arr, device)


def _masked_reduce(v, gm, func: str):
    """One group's reduction over dim=1 of [P, N] lanes. SQL null-skipping:
    an agg input's validity plane joins the group mask — count(x) counts
    only non-null x, sum/min/max ignore null slots."""
    if func == "count_all" or (func == "count" and (v is None or v.valid is None)):
        return gm.sum(dim=1)
    if func == "count":
        return (gm & v.valid).sum(dim=1)
    arr = torch.broadcast_to(v.arr, gm.shape)
    if v.valid is not None:
        gm = gm & v.valid
    if func == "sum":
        return torch.where(gm, arr, torch.zeros((), dtype=arr.dtype, device=arr.device)).sum(dim=1)
    if func in ("welford_mean", "welford_m2"):
        # variance partials (physical_planner's (cnt, mean, M2) triple): the
        # true two-pass form — group mean first, then the mean-centered
        # square sum — numerically stable at f64 with no Welford recurrence
        arr = arr.to(torch.float64)
        c = gm.sum(dim=1)
        s = torch.where(gm, arr, 0.0).sum(dim=1)
        mean = s / torch.clamp(c, min=1)
        if func == "welford_mean":
            return mean
        d2 = (arr - mean[:, None]) ** 2
        return torch.where(gm, d2, 0.0).sum(dim=1)
    if func == "min":
        big = (torch.iinfo(arr.dtype).max if not arr.dtype.is_floating_point
               else float("inf"))
        return torch.where(gm, arr, big).amin(dim=1)
    if func == "max":
        small = (torch.iinfo(arr.dtype).min if not arr.dtype.is_floating_point
                 else float("-inf"))
        return torch.where(gm, arr, small).amax(dim=1)
    raise Unsupported(f"agg {func}")


def _pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def _mk_col_reader(i: int, kind: str, scale: int, dictionary, valid_idx=None):
    """Column reader with device-side upcast: columns ship narrow (int16/32)
    to spare the link, then widen on the card where bandwidth is cheap.
    Nullable columns read their validity plane from the flattened arg
    tail."""

    def run(cols, luts):
        arr = cols[i]
        if kind in ("i64", "money") and arr.dtype != torch.int64:
            arr = arr.to(torch.int64)
        elif kind in ("code", "date") and arr.dtype != torch.int32:
            arr = arr.to(torch.int32)
        valid = cols[valid_idx] if valid_idx is not None else None
        return DevVal(kind, arr, scale, dictionary, valid=valid)

    return run


def _mk_join_finder(off: int, probe_fns, bt: BuildTable):
    """Closure computing each probe row's build membership (bool [P, N]),
    'direct' mode. Unique keys: the build shipped a dense key→row int32
    table — ONE gather per probe, matched iff row >= 0. Repeated keys: the
    lo/cnt tables, matched iff cnt > 0. Multi-key probes combine as
    k1 << shift | k2 with device range guards mirroring the host-side
    guards, so out-of-range keys can never alias a real build key."""
    shifts = bt.shifts
    has_cnt = bt.cnt is not None

    def run(cols, luts):
        keys_arr = cols[off]
        valid = None
        k = None
        for i, pf in enumerate(probe_fns):
            v = pf(cols, luts)
            if v.kind not in ("i64", "date"):
                raise Unsupported(f"non-integer probe key kind {v.kind}")
            ki = v.arr.to(torch.int64)
            if i == 0:
                k = ki
                valid = ki >= 0
            else:
                shift = shifts[i - 1]
                valid = valid & (ki >= 0) & (ki < (1 << shift))
                k = (k << shift) | ki
            if v.valid is not None:
                valid = valid & v.valid  # a NULL probe key matches nothing
        in_range = valid & (k >= 0) & (k < keys_arr.shape[0])
        kc = torch.where(in_range, k, 0)
        if has_cnt:
            return in_range & (take(cols[off + 1], kc) > 0)
        return in_range & (take(keys_arr, kc) >= 0)

    return run


def _mult_shape_check(partial_agg, ops, join) -> dict | None:
    """Structural eligibility for aggregate-through-join: `join` must be the
    stage's LAST join (only pass-through projections may follow), inner or
    right with no residual filter, group keys probe-side, and every
    build-column use a bare count(col). Returns {agg index → build field
    index} (may be empty) or None if ineligible. The cost model reads it
    (fusion.estimate_stage); the port does not run that path yet."""
    from ballista_tpu_torch.plan.physical import ProjectionExec

    real_ops = [o for o in ops if not isinstance(o, CoalesceBatchesExec)]
    if join not in real_ops:
        return None
    if join.join_type not in ("inner", "right") or join.filter is not None:
        return None
    k = real_ops.index(join)
    n_build = len(join.left.df_schema)
    schema = join.df_schema
    # per current-schema field: originating build field index, or None
    build_of: list = [i if i < n_build else None for i in range(len(schema))]

    def refs_build(e) -> list[int]:
        refs: list[int] = []

        def walk(x):
            if isinstance(x, Column):
                i = schema.maybe_index_of(x.name, x.qualifier)
                if i is not None and build_of[i] is not None:
                    refs.append(build_of[i])
            for c in x.children():
                walk(c)

        walk(e)
        return refs

    for op in real_ops[k + 1:]:
        if not isinstance(op, ProjectionExec):
            return None  # a later join/filter may consume build values
        new_build: list = []
        for e in op.exprs:
            inner = e.expr if isinstance(e, Alias) else e
            if isinstance(inner, Column):
                i = schema.maybe_index_of(inner.name, inner.qualifier)
                if i is None:
                    return None
                new_build.append(build_of[i])
            else:
                if refs_build(inner):
                    return None  # computed expr over a build column
                new_build.append(None)
        schema = op.df_schema
        build_of = new_build

    for g in partial_agg.group_exprs:
        if refs_build(g.expr if isinstance(g, Alias) else g):
            return None
    out: dict[int, int] = {}
    for ai, d in enumerate(partial_agg.aggs):
        if d.expr is None:
            continue
        brefs = refs_build(d.expr)
        if not brefs:
            continue
        inner_e = d.expr.expr if isinstance(d.expr, Alias) else d.expr
        if d.func == "count" and isinstance(inner_e, Column) and len(brefs) == 1:
            out[ai] = brefs[0]
        else:
            return None
    return out


def _bind_env(ctx: Lowering, schema: DFSchema) -> None:
    """Point the Lowering at the current virtual schema: Column exprs now
    resolve through env_fns (projection rebinding) instead of raw columns."""
    ctx.schema = schema
    ctx.kinds = [
        (m[0], m[1]) if m is not None else ("?", 0) for m in ctx.env_meta
    ]
    ctx.dictionaries = [m[2] if m is not None else None for m in ctx.env_meta]
    ctx.slots = [m[3] if m is not None else -1 for m in ctx.env_meta]

    def col_index(c):
        return schema.index_of(c.name, c.qualifier)

    ctx.col_index = col_index  # type: ignore[assignment]


def _passthrough_meta(e: Expr, ctx: Lowering, schema: DFSchema):
    inner = e.expr if isinstance(e, Alias) else e
    if isinstance(inner, Column):
        i = schema.index_of(inner.name, inner.qualifier)
        return ctx.env_meta[i]
    return None
