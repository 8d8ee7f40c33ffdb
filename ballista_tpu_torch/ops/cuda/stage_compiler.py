"""Run physical-plan subtrees as PyTorch stages on the CUDA card.

Counterpart of the JAX package's ops/tpu/stage_compiler.py, cut to the
slice the port carries so far. TpuStageExec (the name kept, like every
config key) replaces a `HashAggregateExec(partial)` whose input chain is
Filter*/Projection*/CoalesceBatches*/HashJoin* over a scan. The execution
model is the reference's:

- the WHOLE table (all scan partitions) is encoded once with UNIFIED
  dictionaries and cached on the card as [P, N] stacked columns
  (DeviceTableCache; LRU against ballista.tpu.max.device.bytes);
- each join's build side is collected on the host, encoded into a direct
  key→row table (expansion joins: lo/cnt tables with key-sorted payloads)
  and cached on the card (_BUILD_CACHE), each on a thread of its own while
  the probe table fills (ballista.tpu.compile.overlap, _fill_beside_builds);
- scan filters, projections, join probes with their payload gathers
  (inner, right outer, semi/anti with or without a residual filter,
  aggregate-through-join) are lowered into closures that process all P
  partitions in one pass, once per expansion lane; the grouped reduction
  runs either as exact torch reductions (aggregate_lane) or, under
  `fused_pallas`, through the hand-written `masked_group_reduce` kernel
  (pallas_lane), behind the reference's `pallas_ok` gate. Under
  `fused_pallas` small unique join tables are probed by the `hash_probe`
  kernel and string predicates run through `dict_filter`;
- per query the host round trips are O(1): upload LUTs (cached), one
  pass, one batched fetch.

Output batches match the partial aggregate's schema exactly, so the
downstream repartition/final-aggregate machinery is engine-agnostic.

Group keys outside the small dictionary domains go through the sorted
segmented aggregation (_compile_sorted): a stable lexicographic sort of
the live rows, segment totals, one compaction, all partitions decoded into
output partition 0, with an optional device-computed `__pid` shuffle
column. `staged` mode runs the predicate, project and aggregate spans as
separate dispatches (_compile_staged).

Out of core (ops/cuda/hbm.py): every stage is admitted against the
device budget before its pass. Cold resident tables demote to the host
spill pool and re-upload on their next touch; a join stage over budget
grace-splits its largest inner-join build into sub-buckets run one after
another (_grace_run); a device out-of-memory error spills every resident
table and retries the stage once (_dispatch_all).

Any other shape raises `Unsupported` and the subtree re-runs on the CPU
engine, counted in `fallback_count`: a group capacity overflow, a stage
past the grace depth cap, a second out-of-memory error. Only `Unsupported`
falls back: a kernel build or launch error, or a missing card, raises out
of the query.

Partition-sharded stage (`ballista.tpu.collective.exchange`, the
reference's GSPMD mesh): with the key on and at least two devices visible
(_stage_mesh), the table's [P, N] stacks are split by partition across a
`parallel.exchange.Mesh` (P padded to a multiple of the device count with
empty, fully masked partitions), builds and LUTs are replicated on every
device, and the pass runs its closure once per device over that device's
partitions, the outputs gathered in partition order (_run_pass). The
sorted mode's global sort runs over the shards gathered onto the mesh's
first device, as GSPMD gathers a sort's operands. Under a mesh the stage
runs no hand-written kernel: `fused_pallas` clamps to `fused_xla`, as in
the reference, whose Pallas kernels are single-device.

Warm device daemon (device_daemon/, ops/cuda/daemon_route.py): a session
with ballista.tpu.daemon.enabled ships each stage's raw subtree to the
daemon process that owns the card first (_daemon_run_all); the daemon
runs it through the same maybe_compile_tpu. Where no daemon answers, the
stage runs here, with the reason in RUN_STATS daemon_mode_reason.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time
import zlib
from typing import Iterator

import numpy as np
import pyarrow as pa
import torch

from ballista_tpu_torch.config import (
    TPU_COLLECTIVE_EXCHANGE,
    TPU_COMPILE_CACHE_DIR,
    TPU_COMPILE_OVERLAP,
    TPU_FILL_CHUNK_ROWS,
    TPU_FILL_THREADS,
    TPU_FUSION_PALLAS_MAX_GROUPS,
    TPU_HBM_GRACE_BUCKETS,
    TPU_HBM_GRACE_DEPTH,
    TPU_HBM_SPILL_DIR,
    TPU_HBM_SPILL_ENABLED,
    TPU_HBM_SPILL_HOST_BYTES,
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
    hash64,
    hash_combine,
    lower_expr,
    take,
    true_mask,
    umod,
)
from ballista_tpu_torch.parallel.exchange import ByPartition, Mesh, MeshTensor
from ballista_tpu_torch.plan.expressions import Alias, Column, Expr
from ballista_tpu_torch.plan.physical import (
    CoalesceBatchesExec,
    CoalescePartitionsExec,
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
# table_key: (the probe scan's DEVICE_CACHE.key_of, _build_leaf_keys)
# (table_key, fingerprint, emit_pid, device or mesh) → device LUT tensors
_LUT_CACHE = LruDict(_env_int("BALLISTA_TPU_LUT_CACHE_ENTRIES", 256))
# (table_key, fingerprint, join_idx, device or mesh, grace) → BuildTable
_BUILD_CACHE = LruDict(
    _env_int("BALLISTA_TPU_BUILD_CACHE_ENTRIES", 32),
    max_bytes=_env_int("BALLISTA_TPU_BUILD_CACHE_BYTES", 2 * 1024**3),
    sizer=lambda bt: sum(int(a.numel() * a.element_size()) for a in bt.flat_arrays()),
)


class _KeyedFills:
    """One fill a key at a time for the build and LUT caches, which stage
    threads and overlapped build threads fill at once: a caller that finds
    its key being filled waits for that fill and takes its entry, so two
    concurrent builds of one key make one entry. A failed fill leaves the
    key free; each waiter then fills (and fails) on its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict = {}  # key → Event; bounded by the callers in flight

    def get(self, cache: LruDict, key, fill):
        while True:
            hit = cache.get(key)
            if hit is not None:
                return hit
            with self._lock:
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    break
            ev.wait()
        try:
            hit = cache.get(key)  # filled between the miss and the claim
            if hit is None:
                hit = cache[key] = fill()
            return hit
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()


_CACHE_FILLS = _KeyedFills()


class RunStats:
    """Per-stage-run diagnostics.

    Every stage dispatch opens a `run(tag)` scope that collects into a
    private per-run dict and publishes atomically on exit: `snapshot()`
    is a consistent most-recent-run-wins view, and `stages()` keeps the
    last few per-stage records.

    Keys the port fills: fill_s (whole device fill), encode_s (host encode
    wall), upload_s (host→card copies), device_bytes, build_s (join build
    sides: host collect + encode + upload, or the build-cache hits; under
    ballista.tpu.compile.overlap the builds' wall from the first submit to
    the last result, beside the fill), exec_s
    (dispatch + fetch + decode), build_modes (direct | sorted per join
    build), fused_kernel_s (device seconds of the
    stage pass), span_s (staged mode: predicate / project / aggregate
    seconds), fusion_mode (fused_xla | fused_pallas | staged — the mode
    that actually ran), fusion_reason (the cost model's stated rationale),
    fused_spans (operator spans run in the stage pass), hbm_budget_bytes,
    hbm_plan (run_whole | spill_colds | grace_split | cpu_demote),
    hbm_plan_reason, grace_splits (sub-buckets run), and the spill pool's
    cumulative hbm_spill_bytes, hbm_spill_events, hbm_reupload_events with
    hbm_oom_retries (the out-of-memory retries so far); the sorted
    aggregation adds sort_s (device seconds of its sort), live_rows (rows
    sorted), n_seg (groups) and seg_capacity (C). Warm-daemon routing
    (ops/cuda/daemon_route.py): daemon_mode ("attached" when the stage ran
    in the device daemon, "in_process" when the session opted in but it
    ran here) and daemon_mode_reason; daemon_attached, daemon_sessions,
    daemon_queue_depth and the daemon's init phase seconds
    (init_platform_probe_s, init_cuda_devices_s, init_first_launch_s);
    daemon_failover / daemon_failover_reason for a crash recovered by a
    respawn or a quarantined stage, and the process-lifetime counters
    daemon_restarts, daemon_crashes_detected, watchdog_kills and
    poisoned_stages."""

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

    def clear(self) -> None:
        with self._lock:
            self._merged.clear()
            self._stages.clear()


RUN_STATS = RunStats()

DIRECT_TABLE_MAX = 1 << 27  # 128M entries × int32 = 512 MB ceiling


MAX_JOIN_DUP = 16  # expansion joins unroll this many match lanes at most

SORTED_MAX_GROUPS = 1 << 22  # the sorted aggregation's group capacity ceiling


class BuildTable:
    """A join's build side, encoded for device probing.

    'direct' mode — keys are dense-enough ints → a [T] int32 lookup table
    (key → build row, -1 absent): ONE gather per probe. Non-unique build
    keys (dup > 1, "expansion joins"): the payloads are laid out key-sorted
    and the lookup yields (first row, count) from the lo/cnt tables; the
    probe pipeline unrolls dup match lanes (d < count masks) so each probe
    row can emit up to dup joined rows into the agg. 'sorted' mode (a key
    range past DIRECT_TABLE_MAX) — [B] int64 keys, sorted and padded with
    int64 max, payloads in the same order: probes binary-search."""

    def __init__(self, mode, keys, payloads, kinds, scales, dicts, n_rows,
                 dup=1, cnt=None, pay_valids=None):
        self.mode = mode  # direct | sorted
        # direct: int32 [T] row (dup == 1) or lo (dup > 1) table;
        # sorted: int64 [B] sorted keys
        self.keys = keys
        self.payloads = payloads  # per column, padded to B (unique: original order)
        self.kinds = kinds
        self.scales = scales
        self.dicts = dicts
        self.n_rows = n_rows
        self.dup = dup  # max duplicates per key (1 = unique fast paths)
        self.cnt = cnt  # int32 [T] per-key match count, dup > 1 only
        self.shifts: list[int] = []  # multi-key combine shifts (per extra key)
        # per payload column: bool [B] validity plane or None; padding slots
        # are invalid, so an outer join's unmatched gathers decode as NULL
        self.pay_valids = pay_valids if pay_valids is not None else [None] * len(payloads)
        # build-schema field index → position in payloads (None = column was
        # not encodable and not uploaded; only legal for semi/anti filters)
        self.pay_pos: list = list(range(len(payloads)))

    def flat_arrays(self):
        """Device-arg layout: keys [, cnt], payloads..., payload validity
        planes... (offset contract shared with the lowering closures)."""
        out = [self.keys]
        if self.cnt is not None:
            out.append(self.cnt)
        return out + list(self.payloads) + [v for v in self.pay_valids if v is not None]

    def pay_valid_flat_idx(self) -> list:
        """Per payload: index of its validity plane within flat_arrays()
        (relative to this build's block), or None."""
        out = []
        nxt = (2 if self.cnt is not None else 1) + len(self.payloads)
        for v in self.pay_valids:
            if v is None:
                out.append(None)
            else:
                out.append(nxt)
                nxt += 1
        return out

    def shape_key(self):
        return (
            self.mode, len(self.keys), tuple(self.shifts), self.dup,
            self.cnt is not None, self.padded_rows(),
            tuple(str(p.dtype) for p in self.payloads),
            tuple(v is not None for v in self.pay_valids),
            tuple(self.pay_pos),
            tuple(_pow2(len(d)) if d else 0 for d in self.dicts),
        )

    def padded_rows(self) -> int:
        """Padded payload length B: expansion-lane indices clip against
        it."""
        return self.payloads[0].shape[0] if self.payloads else _pow2(max(self.n_rows, 1))


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

    @property
    def mesh(self) -> Mesh | None:
        """The mesh the stacks are sharded over, or None (one device)."""
        return self.mask.mesh if isinstance(self.mask, MeshTensor) else None

    @property
    def where(self):
        """The table's placement: its mesh, or its one device."""
        return self.mesh if self.mesh is not None else self.mask.device

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


def _no_code_extreme(fn, func: str):
    """MIN and MAX over a dictionary-coded string column would reduce its
    codes and decode the code's digits as the answer; decline instead
    (ROADMAP C21), so the CPU engine answers."""

    def run(cols, luts):
        v = fn(cols, luts)
        if v.kind == "code":
            raise Unsupported(f"{func} over a string column")
        return v

    return run


def _file_stamp(path: str) -> tuple:
    """What names a file's contents beside its path: a local file's size,
    mtime and inode; an object's size and mtime, read with one HEAD
    request, so an object rewritten under the same key is another table
    (ROADMAP C26). Never cached: a cached stamp would hide the rewrite."""
    if path.startswith("s3://"):
        from ballista_tpu_torch.plan.object_store import resolve_filesystem

        fs, inner = resolve_filesystem(path)
        info = fs.get_file_info(inner)
        return (info.size, info.mtime_ns)
    try:
        st = os.stat(path)
    except (OSError, ValueError):
        return ()
    return (st.st_size, st.st_mtime_ns, st.st_ino)


def _build_leaf_keys(join_ops) -> tuple:
    """What every join's build side reads. The build's display (in the
    stage fingerprint) names a shuffle read by its partition counts, a
    parquet scan by its table name and a memory scan by its row count, so
    two builds of one shape over other data (another job's broadcast, a
    re-registered table, an appended delta) shared a cached build and its
    LUTs (ROADMAP C18)."""
    out = []

    def walk(node):
        kids = node.children()
        if not kids:
            locs = getattr(node, "partition_locations", None)  # ShuffleReaderExec
            if locs is not None:
                out.append(("shuffle", tuple((l.job_id, l.stage_id, l.map_partition,
                                              l.output_partition, l.path)
                                             for part in locs for l in part)))
            else:
                out.append(DEVICE_CACHE.key_of(node))
        for c in kids:
            walk(c)

    for op in join_ops:
        walk(op.left)
    return tuple(out)


class DeviceTableCache:
    def __init__(self):
        import collections

        self._cache: "collections.OrderedDict[tuple, DeviceTable]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._inflight: dict[tuple, threading.Event] = {}
        # lifetime counts: lookups served by a resident table, and fills
        # (read + encode + upload, or a restore from the spill pool)
        self.hits = 0
        self.fills = 0

    def table_key(self, scan, device) -> tuple:
        # the placement in the key: tables committed to one card never serve
        # another (or the CPU), nor a mesh a single device
        return self.key_of(scan) + (str(device),)

    def get(self, scan, buckets: list[int], ctx, max_bytes: int, device, *,
            fill_threads: int = 0, chunk_rows: int = 0, stats: dict | None = None,
            spill_pool=None, scan_key: tuple | None = None) -> DeviceTable:
        """The resident table for `scan` on `device` (a torch device, or a
        Mesh to shard its partitions over), filled on a miss. `scan_key`:
        the scan's key_of when the caller already holds it (an object
        store's files are stamped once a run)."""
        key = (self.key_of(scan) if scan_key is None else scan_key) + (str(device),)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self.hits += 1
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
            # a previously demoted table re-uploads from its host (or disk)
            # copy instead of re-running the read + encode fill: the
            # transparent-on-touch half of the spill contract
            restored = spill_pool.pop(key) if spill_pool is not None else None
            if restored is not None:
                dt = _restore_device_table(restored, device)
            else:
                dt = self._load(scan, buckets, ctx, device, fill_threads=fill_threads,
                                chunk_rows=chunk_rows, stats=stats)
            with self._lock:
                self.fills += 1
            RUN_STATS.set("fill_s", round(time.time() - t0, 3), rec=stats)
            RUN_STATS.set("device_bytes", dt.nbytes, rec=stats)
            if getattr(scan, "mem_token", None) is not None:
                # memory-backed fill = ingested delta rows riding a grafted
                # scan (serving/incremental.py), surfaced so operators can
                # watch delta volume reach the device tier
                RUN_STATS.set("delta_fill_rows",
                              int(sum(int(r) for r in dt.part_rows)), rec=stats)
            victims = []
            with self._lock:
                total = sum(v.nbytes for v in self._cache.values())
                while self._cache and total + dt.nbytes > max_bytes:
                    victims.append(self._cache.popitem(last=False))
                    total -= victims[-1][1].nbytes
                self._cache[key] = dt
            if spill_pool is not None:
                for old_key, old in victims:
                    _spill_device_table(spill_pool, old_key, old)
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
        """Device bytes held by cached tables other than `exclude_key`: the
        admission planner's `resident_other` (cold residency that
        spill_colds can reclaim)."""
        with self._lock:
            return sum(v.nbytes for k, v in self._cache.items() if k != exclude_key)

    def ensure_headroom(self, max_bytes: int, keep_key: tuple | None,
                        spill_pool=None) -> int:
        """Demote cold entries (all but `keep_key`), oldest first, until
        residency fits `max_bytes`. Returns bytes freed. The spill_colds
        admission rung."""
        freed = 0
        victims = []
        with self._lock:
            total = sum(v.nbytes for v in self._cache.values())
            for k in list(self._cache):
                if total <= max_bytes:
                    break
                if k == keep_key:
                    continue
                old = self._cache.pop(k)
                total -= old.nbytes
                freed += old.nbytes
                victims.append((k, old))
        if spill_pool is not None:
            for k, old in victims:
                _spill_device_table(spill_pool, k, old)
        return freed

    def spill_all(self, spill_pool=None) -> None:
        """Demote every resident table: the out-of-memory rung frees the
        whole card before its one retry."""
        with self._lock:
            items = list(self._cache.items())
            self._cache.clear()
        if spill_pool is not None:
            for k, old in items:
                _spill_device_table(spill_pool, k, old)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def key_of(self, scan) -> tuple:
        if isinstance(scan, ParquetScanExec):
            # a file's size, mtime and inode beside its path: a file
            # rewritten under the same name (an ingest spool part folded
            # again after a scheduler restart) is another table (ROADMAP C18)
            files = tuple(
                tuple((f["file"], tuple(f.get("row_groups") or ()), _file_stamp(f["file"]))
                      for f in p.get("files", []))
                for p in scan.partitions
            )
            return (files, tuple(scan.projection))
        token = getattr(scan, "mem_token", None)
        if token is not None:
            return ("mem", token)  # monotonic: never aliases like id() does
        return ("obj", id(scan), id(type(scan)))

    def _load(self, scan, buckets: list[int], ctx, device, *,
              fill_threads: int = 0, chunk_rows: int = 0,
              stats: dict | None = None) -> DeviceTable:
        """Read, encode and upload the whole scan as [P, N] stacks (over a
        Mesh `device`: P padded to a multiple of its size, sharded by
        partition).

        Columns encode on a small host pool while the caller thread copies
        each finished stack to the card in column order, so the encode of
        column k+1 overlaps the upload of column k; at most (threads + 2)
        encoded stacks are alive at once. `fill_threads` 0 = auto, 1 =
        strict serial. `chunk_rows` > 0 copies a stack wider than that in
        [P, chunk_rows] slices through two pinned buffers (_put_chunked);
        0, or a Mesh, keeps one copy per stack."""
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
        if isinstance(device, Mesh):
            # shard the partition axis across the mesh: pad P to a multiple
            # of the device count with empty (all-masked) partitions
            while len(part_rows) % device.size:
                part_rows.append(0)
        P = len(part_rows)
        stacks = _by_partition(device)

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
        staging = _Staging(stacks) if chunk_rows > 0 else None

        def upload(i: int, dc) -> None:
            nonlocal nbytes, t_up
            t0u = time.time()
            cols[i] = _put_chunked(dc.data, stacks, chunk_rows, staging)
            nbytes += dc.data.nbytes
            if dc.valid is not None:
                valids[i] = _put_chunked(dc.valid, stacks, chunk_rows, staging)
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
        mask = _put(mask_np, stacks)
        nbytes += mask_np.nbytes
        # fill_s must mean "table resident", not "last copy enqueued"
        _synchronize(device)
        t_up += time.time() - t0u
        RUN_STATS.set("upload_s", round(t_up, 3), rec=stats)
        return DeviceTable(kinds, scales, dicts, cols, mask, part_rows, nbytes, valids)


def _record_spill_stats(rec: dict, spill_pool) -> None:
    """Mirror the host spill pool's cumulative counters into the run
    record."""
    if spill_pool is None:
        return
    st = spill_pool.stats()
    RUN_STATS.set("hbm_spill_bytes", st["spill_bytes"], rec=rec)
    RUN_STATS.set("hbm_spill_events", st["spill_events"], rec=rec)
    RUN_STATS.set("hbm_reupload_events", st["reupload_events"], rec=rec)
    RUN_STATS.set("hbm_oom_retries", hbm.oom_retry_count(), rec=rec)


def _spill_device_table(pool, key: tuple, dt: DeviceTable) -> None:
    """Demote one cached DeviceTable to the host spill pool: copy every
    plane back to numpy and hand the flat list (cols, mask, valids, None
    slots kept) with the encode metadata to the pool, which owns the
    tiering (host buffers or tmp+rename disk files)."""
    flat = ([c.cpu().numpy() for c in dt.cols] + [dt.mask.cpu().numpy()]
            + [None if v is None else v.cpu().numpy() for v in dt.valids])
    meta = (list(dt.kinds), list(dt.scales), list(dt.dicts),
            list(dt.part_rows), int(dt.nbytes))
    pool.put(key, meta, flat, int(dt.nbytes))


def _restore_device_table(restored, device) -> DeviceTable:
    """Re-upload a spilled table: the inverse of _spill_device_table,
    through the same placement point (_put) as the cold fill."""
    meta, flat = restored
    kinds, scales, dicts, part_rows, nbytes = meta
    n = len(kinds)
    stacks = _by_partition(device)
    cols = [_put(a, stacks) for a in flat[:n]]
    mask = _put(flat[n], stacks)
    valids = [None if a is None else _put(a, stacks) for a in flat[n + 1:]]
    _synchronize(device)  # fill_s means "table resident", as in _load
    return DeviceTable(kinds, scales, dicts, cols, mask, part_rows, nbytes, valids)


DEVICE_CACHE = DeviceTableCache()


def clear_device_caches() -> None:
    """Release every module-level device cache: resident tables, string
    LUTs, join build tables and the tables spilled to the host pool.

    When this process is attached to a device daemon, the clear is also
    forwarded there: the state an attached process uses is daemon-resident.
    The forwarding is best-effort (a dead daemon has nothing resident) and
    a no-op inside the daemon itself."""
    DEVICE_CACHE.clear()
    _LUT_CACHE.clear()
    _BUILD_CACHE.clear()
    hbm.SPILL_POOL.clear()
    from ballista_tpu_torch.device_daemon import client as daemon_client

    daemon_client.clear_attached_caches()


def _on_card(card):
    """Make `card` the calling thread's current CUDA device (a fresh thread
    starts on device 0, and the kernels launch on the current one); a
    no-op for the CPU."""
    if isinstance(card, torch.device) and card.type == "cuda":
        return torch.cuda.device(card)
    return contextlib.nullcontext()


def _fill_beside_builds(fill, prepare, join_ops: list, card):
    """The cold-path pipeline (`ballista.tpu.compile.overlap`, the
    reference's `prep` threads): every join's build is prepared on a pool
    of its own, each thread on the executor's card, while this thread
    fills the probe table. Returns (table, builds in join order, the
    builds' wall from the first submit to the last result).

    An error of the fill or of a build reaches the caller as on the serial
    path (the fill's first, then the builds' in join order), and only once
    every build thread has finished: none is left running behind a failed
    stage, and the out-of-memory rung clears the caches after the last
    build has filled them."""

    def run(jidx: int, op):
        with _on_card(card):
            return prepare(jidx, op)

    pool = _fut.ThreadPoolExecutor(max_workers=len(join_ops), thread_name_prefix="cuda-build")
    futs: list = []
    try:
        t_b = time.time()
        futs = [pool.submit(run, jidx, op) for jidx, op in enumerate(join_ops)]
        dt = fill()
        builds = [f.result() for f in futs]
        build_s = time.time() - t_b
    except BaseException as first:
        pool.shutdown(wait=True)
        for f in futs:
            e = f.exception()
            if e is not None and e is not first:
                log.warning("join build failed beside the stage's first error (%r): %r",
                            first, e)
        raise
    pool.shutdown(wait=True)
    return dt, builds, build_s


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
        self.decline_reason: str | None = None  # the last Unsupported's message
        # device-side shuffle routing: (output-schema key indices, K) set by
        # the engine when the parent shuffle writer hash-partitions on group
        # columns; the sorted path then emits a __pid column
        self.emit_pid: tuple[list[int], int] | None = None
        self.pid_emitted = 0
        # a Mesh handed to this one stage (else _stage_mesh reads the config)
        self.stage_mesh: Mesh | None = None
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
                    self.decline_reason = str(e)
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
                except Unsupported as e:
                    log.warning("device stage re-run declined; cpu fallback for %s",
                                self.partial_agg.node_str(), exc_info=True)
                    self.decline_reason = str(e)
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

    def _spill_pool(self):
        """The host spill pool, or None when ballista.tpu.hbm.spill.enabled
        is off (evicted tables are then dropped)."""
        return hbm.SPILL_POOL if bool(self.config.get(TPU_HBM_SPILL_ENABLED)) else None

    def _dispatch_all(self, ctx: TaskContext) -> dict[int, list[pa.RecordBatch]]:
        """One whole-stage dispatch: the warm device daemon first when the
        session opted in, else on the task's card (or the CPU when the
        caller asked for it), with the out-of-memory rung: the estimate said
        the stage fits and the card disagreed. Spill every resident table
        (their fills are kept in the host pool), drop the LUT and build
        caches, hint the planner to pre-plan grace for this stage, and retry
        ONCE; a second out-of-memory error demotes the stage to the CPU
        engine. Any other error propagates."""
        out = self._daemon_run_all(ctx)
        if out is not None:
            return out
        tag = f"stage_{zlib.crc32(self.fingerprint.encode()):08x}"
        with RUN_STATS.run(tag) as rec:
            try:
                return self._tpu_run_all_inner(ctx, rec)
            except Unsupported:
                raise
            except Exception as e:  # noqa: BLE001 — classified: only an OOM is caught
                if not hbm.is_resource_exhausted(e):
                    raise
                first = f"{type(e).__name__}: {e}"
            # out of the handler: the failed attempt's frames (and the device
            # tensors they hold) are released before the retry allocates
            log.warning("device out of memory; spilling + retrying stage once: %s", first)
            DEVICE_CACHE.spill_all(self._spill_pool())
            _LUT_CACHE.clear()
            _BUILD_CACHE.clear()
            hbm.note_oom(self.fingerprint)
            rec["hbm_oom_retries"] = hbm.oom_retry_count()
            try:
                return self._tpu_run_all_inner(ctx, rec)
            except Exception as e2:  # noqa: BLE001 — classified: only an OOM is caught
                if hbm.is_resource_exhausted(e2):
                    raise Unsupported(
                        f"device OOM persisted after spill+retry: {e2}") from e2
                raise

    def _daemon_run_all(self, ctx: TaskContext) -> dict[int, list[pa.RecordBatch]] | None:
        """Ship this stage to the device daemon: the RAW rebuilt subtree
        (the chain _fallback re-executes) goes over the socket and the
        daemon runs it through the same maybe_compile_tpu entry, so an
        attached result is byte-identical to an in-process one. The failure
        domain (derived deadline, crash detection, respawn-and-retry,
        poison quarantine) lives in daemon_route.run_via_daemon; None means
        'run here', with the reason in RUN_STATS daemon_mode_reason."""
        from ballista_tpu_torch.ops.cuda import daemon_route

        return daemon_route.run_via_daemon(
            self.config,
            plan_builder=lambda: self.partial_agg.with_children([self._raw_chain()]),
            partitions=list(range(self.scan.output_partition_count())),
            tag=daemon_route.stage_tag("stage", self.fingerprint),
            fingerprint=self.fingerprint,
            emit_pid=self.emit_pid,
            est_bytes=int(getattr(self, "hbm_observed_input_bytes", 0) or 0))

    def _raw_chain(self) -> ExecutionPlan:
        """The original pre-aggregation subtree this wrapper replaced,
        rebuilt from its pieces: what _fallback re-executes on the host and
        what the daemon client serializes over the socket."""
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
        node = self._raw_chain()
        if self.emit_pid is not None:
            # device-routed layout: the device path ships every group through
            # partition 0 (__pid routing) and empties the others. A demotion
            # after some device partitions were served must keep that shape,
            # or a classic partition-p partial counts their groups twice:
            # partition 0 aggregates the whole input, the others stay empty.
            # The shuffle writer's host hash routes each group as __pid did.
            if partition != 0:
                return [_empty_batch(self.schema())]
            node = CoalescePartitionsExec(node)
        agg = self.partial_agg.with_children([node])
        return [b for b in agg.execute(partition, ctx)]

    # ------------------------------------------------------------------

    def _prepare_build(self, join, jidx: int, ctx: TaskContext, table_key,
                       device, grace: tuple[int, int] | None = None) -> BuildTable:
        """Collect + encode a join's build side for device probing: the
        direct unique, direct expansion and sorted layouts, with the payload
        columns the probe gathers (none for a filterless semi/anti join).
        Under a Mesh `device` every array is replicated on each device.

        `grace=(bucket, n_buckets)`: keep only the build rows whose combined
        key falls in that secondary-hash sub-bucket (the grace split).
        Sub-builds carry their bucket in the cache key: a sub-build and the
        whole build never alias."""
        cache_key = (table_key, self.fingerprint, jidx, str(device), grace)
        return _CACHE_FILLS.get(_BUILD_CACHE, cache_key,
                                lambda: self._encode_build(join, ctx, device, grace))

    def _encode_build(self, join, ctx: TaskContext, device,
                      grace: tuple[int, int] | None) -> BuildTable:
        """The uncached half of _prepare_build."""
        from ballista_tpu_torch.ops.cuda.columnar import encode_column, repeated_names
        from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array

        batches = []
        for p in range(join.left.output_partition_count()):
            batches.extend(b for b in join.left.execute(p, ctx) if b.num_rows)
        tbl = _concat(batches, join.left.schema()).combine_chunks()
        if tbl.num_rows:
            # a build row whose key is NULL can never match any probe row
            # (inner/semi/anti/outer alike): drop it before encoding
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
        # smallest shift covering its build-side range (keeps combined keys
        # dense enough for direct addressing)
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
        if grace is not None:
            bucket, n_buckets = grace
            sel = hbm.grace_bucket_of(key_np, n_buckets) == bucket
            if not sel.any():
                raise Unsupported(f"empty grace sub-bucket {bucket}/{n_buckets}")
            key_np = key_np[sel]
            tbl = tbl.filter(pa.array(sel)).combine_chunks()
            batch = tbl.to_batches()[0]
        uniq, counts = np.unique(key_np, return_counts=True)
        dup = int(counts.max())
        membership_only = join.join_type in ("right_semi", "right_anti") and join.filter is None
        cba = _mult_shape_check(self.partial_agg, self.ops, join)
        # mirror _compile's activation exactly (counted build columns must be
        # non-null): a looser exemption here would pay the full build
        # collect/encode/upload only to fall back at compile time anyway
        mult_shaped = cba is not None and all(
            tbl.column(fi).null_count == 0 for fi in cba.values()
        )
        if dup > MAX_JOIN_DUP and not membership_only and not mult_shaped:
            # filterless semi/anti probes only test membership, and
            # aggregate-through-join stages consume match COUNTS — neither
            # unrolls lanes, so any dup is fine there; inner/outer gathers
            # and semi/anti FILTERS unroll dup lanes and are budgeted
            raise Unsupported(f"build key multiplicity {dup} > {MAX_JOIN_DUP}")

        max_key = int(key_np.max())
        min_key = int(key_np.min())
        direct = min_key >= 0 and max_key + 1 <= DIRECT_TABLE_MAX
        cnt_np = None
        if dup == 1 and direct:
            T = _pow2(max_key + 1)
            table = np.full(T, -1, dtype=np.int32)
            table[key_np] = np.arange(len(key_np), dtype=np.int32)
            keys_np = table
            order = np.arange(len(key_np))
            mode = "direct"
        elif direct:
            # expansion layout: payloads key-sorted; lo/cnt tables give each
            # probe its first matching row and its match count
            order = np.argsort(key_np, kind="stable")
            sorted_keys = key_np[order]
            T = _pow2(max_key + 1)
            lo_table = np.zeros(T, dtype=np.int32)
            cnt_table = np.zeros(T, dtype=np.int32)
            lo_table[uniq] = np.searchsorted(sorted_keys, uniq).astype(np.int32)
            cnt_table[uniq] = counts.astype(np.int32)
            keys_np = lo_table
            cnt_np = cnt_table
            mode = "direct"
        else:
            # sorted layout, for key ranges past the direct table: the keys
            # sorted (stably, so payloads keep their order within a key) and
            # padded to a power of two with int64 max; probes binary-search
            order = np.argsort(key_np, kind="stable")
            sorted_keys = key_np[order]
            keys_np = np.full(_pow2(len(sorted_keys)), np.iinfo(np.int64).max, dtype=np.int64)
            keys_np[: len(sorted_keys)] = sorted_keys
            mode = "sorted"
        B = _pow2(len(key_np))

        kinds, scales, dicts, payloads, pay_valids, pay_pos = [], [], [], [], [], []
        if not membership_only:
            # membership-only joins never gather build columns: no payload
            # encode/upload (an unencodable non-key column must not knock a
            # semi join off the device). Semi/anti WITH a join filter only
            # gather the columns the filter touches: tolerate unencodable
            # columns with a None payload slot (lowering raises only if the
            # filter uses one)
            tolerate = join.join_type in ("right_semi", "right_anti")
            repeated = repeated_names(batch.schema.names)
            if repeated:
                # the encode below finds each payload by name, and a repeated
                # name would give every copy the last column's values
                raise Unsupported(f"duplicate build field names {repeated}")
            for name in batch.schema.names:
                dc = encode_column(batch.column(batch.schema.get_field_index(name)))
                if dc is None:
                    if not tolerate:
                        raise Unsupported(f"unencodable build column {name}")
                    kinds.append("?")
                    scales.append(0)
                    dicts.append(None)
                    pay_pos.append(None)
                    continue
                kinds.append(dc.kind)
                scales.append(dc.scale)
                dicts.append(dc.dictionary)
                padded = np.zeros(B, dtype=dc.data.dtype)
                padded[: len(order)] = dc.data[order]
                pay_pos.append(len(payloads))
                payloads.append(padded)
                if dc.valid is None:
                    pay_valids.append(None)
                else:
                    pv = np.zeros(B, dtype=bool)  # padding slots stay invalid
                    pv[: len(order)] = dc.valid[order]
                    pay_valids.append(pv)

        bt = BuildTable(
            mode, _put(keys_np, device), [_put(p, device) for p in payloads],
            kinds, scales, dicts, len(order), dup=dup,
            cnt=None if cnt_np is None else _put(cnt_np, device),
            pay_valids=[None if v is None else _put(v, device) for v in pay_valids],
        )
        bt.pay_pos = pay_pos
        bt.shifts = shifts
        return bt

    def _fusion_decision(self, dt: DeviceTable, builds: list[BuildTable]):
        """Run the fusion cost model over compile-time stage facts. The
        platform comes from the device the table lives on."""
        from ballista_tpu_torch.ops.cuda import fusion

        est = fusion.estimate_stage(self.scan, self.ops, self.partial_agg, dt, builds)
        cm = fusion.CostModel.from_config(self.config)
        cm.platform = dt.mask.device.type
        dec = cm.choose(est)
        if dec.mode == "fused_pallas" and dt.mesh is not None:
            # the kernels take one device's tensors: a partition-sharded
            # pass is the torch form, as the reference clamps its
            # single-device Pallas kernels under a mesh
            dec = fusion.FusionDecision(
                "fused_xla", dec.reason + "; clamped: collective-exchange mesh")
        return dec, est

    def _run_mode(self, dt: DeviceTable, builds: list[BuildTable], table_key,
                  rec: dict, mode_req: str, cache_luts: bool = True):
        """Lower the stage for `mode_req` and run it once over the table.
        Lowering builds closures only (PyTorch runs eagerly), so nothing is
        cached but the device LUTs, and not those of a grace sub-run
        (`cache_luts` False): a sub-build's dictionaries depend on its
        bucket, which the LUT key does not hold. Returns (meta, device
        outputs)."""
        fn, lowering, meta = self._compile(dt, builds, mode_req)
        emit_key = (tuple(self.emit_pid[0]), self.emit_pid[1]) if self.emit_pid else None
        lut_key = (table_key, self.fingerprint, emit_key, str(dt.where))

        def upload_luts():
            # replicated across a mesh, so probe gathers stay local
            return [_put(l, dt.where)
                    for l in lowering.build_luts(dt.dicts, [b.dicts for b in builds])]

        luts = (_CACHE_FILLS.get(_LUT_CACHE, lut_key, upload_luts) if cache_luts
                else upload_luts())
        t0 = time.time()
        outs, run_meta = _run_pass(fn, meta["mode"], dt, luts, builds)
        _synchronize(dt.where)
        span_s = run_meta.get("span_s")
        # device seconds of the stage pass: the synchronized dispatch, or
        # the staged spans' sum
        rec["fused_kernel_s"] = round(sum(span_s.values()) if span_s
                                      else time.time() - t0, 6)
        if span_s:
            rec["span_s"] = {k: round(v, 6) for k, v in span_s.items()}
        if meta["mode"] == "sorted":
            rec["sort_s"] = round(run_meta.pop("sort_clock")(), 6)
            rec["n_seg"] = run_meta["n_seg"]
            rec["seg_capacity"] = run_meta["C"]
            rec["live_rows"] = run_meta["live_rows"]
        return {**meta, **run_meta}, outs

    def _run_stage(self, dt: DeviceTable, builds: list[BuildTable], table_key,
                   rec: dict, mode_req: str, cache_luts: bool = True):
        """The fallback ladder's top rung: a fused_pallas request whose
        stage turns out kernel-ineligible when it runs raises Unsupported
        — retry once as fused_xla instead of knocking the whole stage off
        the device."""
        try:
            return self._run_mode(dt, builds, table_key, rec, mode_req, cache_luts)
        except Unsupported:
            if mode_req != "fused_pallas":
                raise
            log.info("fused_pallas ineligible; retrying fused_xla")
            return self._run_mode(dt, builds, table_key, rec, "fused_xla", cache_luts)

    def _tpu_run_all_inner(self, ctx: TaskContext,
                           rec: dict) -> dict[int, list[pa.RecordBatch]]:
        """One dispatch + one fetch for every partition of this stage."""
        from ballista_tpu_torch.plan.physical import HashJoinExec

        device = card = runtime.device(ctx.device_ordinal)
        mesh = self.stage_mesh if self.stage_mesh is not None else _stage_mesh(self.config)
        if mesh is not None:
            # the table sharded by partition, builds and LUTs replicated
            device = mesh
        cc_dir = str(self.config.get(TPU_COMPILE_CACHE_DIR) or "")
        if cc_dir:
            runtime.init_compile_cache(cc_dir)
        max_bytes = int(self.config.get(TPU_MAX_DEVICE_BYTES))
        budget = hbm.resolve_hbm_budget(self.config)
        if budget > 0:
            # the cache cap never exceeds the admission budget: a shrunk
            # budget drives real evictions (and so spills)
            max_bytes = min(max_bytes, budget)
        spill_pool = self._spill_pool()
        if spill_pool is not None:
            from ballista_tpu_torch.executor import disk as _disk

            sdir = str(self.config.get(TPU_HBM_SPILL_DIR) or "")
            spill_pool.configure(
                int(self.config.get(TPU_HBM_SPILL_HOST_BYTES)), sdir,
                # under disk pressure demotions stay in the host tier
                spill_gate=lambda: _disk.spill_allowed(self.config,
                                                       sdir or tempfile.gettempdir()))
        join_ops = [o for o in self.ops if isinstance(o, HashJoinExec)]
        # the build and LUT caches' key: the probe table and the tables
        # under each build side
        scan_key = DEVICE_CACHE.key_of(self.scan)
        table_key = (scan_key, _build_leaf_keys(join_ops))

        def fill() -> DeviceTable:
            dt = DEVICE_CACHE.get(
                self.scan, self.buckets, ctx, max_bytes, device,
                fill_threads=int(self.config.get(TPU_FILL_THREADS)),
                chunk_rows=int(self.config.get(TPU_FILL_CHUNK_ROWS)),
                stats=rec, spill_pool=spill_pool, scan_key=scan_key)
            if sum(dt.part_rows) < self.min_rows:
                raise Unsupported(f"only {sum(dt.part_rows)} rows (< tpu min)")
            return dt

        def prepare(jidx: int, op) -> BuildTable:
            return self._prepare_build(op, jidx, ctx, table_key, device)

        if join_ops and bool(self.config.get(TPU_COMPILE_OVERLAP)):
            dt, builds, build_s = _fill_beside_builds(fill, prepare, join_ops, card)
        else:
            dt = fill()
            t_b = time.time()
            builds = [prepare(jidx, op) for jidx, op in enumerate(join_ops)]
            build_s = time.time() - t_b
        rec["build_s"] = round(build_s, 6)
        rec["build_modes"] = [b.mode for b in builds]

        dec, est = self._fusion_decision(dt, builds)
        rec["fusion_reason"] = dec.reason

        # admission: every stage states its memory plan before the pass.
        # Splitting is only sound for an INNER join's build: a probe row's
        # whole match set shares its key's sub-bucket, so the other
        # sub-runs see it as an ordinary unmatched probe; outer/anti joins
        # would re-emit it once per bucket.
        grace_fanout = int(self.config.get(TPU_HBM_GRACE_BUCKETS))
        grace_depth_cap = int(self.config.get(TPU_HBM_GRACE_DEPTH))
        my_key = scan_key + (str(device),)
        plan = hbm.plan_stage(
            est, budget,
            grace_eligible=(not est.has_mult and 0 <= est.max_build_jidx < len(join_ops)
                            and join_ops[est.max_build_jidx].join_type == "inner"),
            grace_fanout=grace_fanout,
            grace_max_depth=grace_depth_cap,
            resident_other=DEVICE_CACHE.resident_bytes(exclude_key=my_key),
            observed_bytes=int(getattr(self, "hbm_observed_input_bytes", 0) or 0),
            force_grace=hbm.consume_oom_hint(self.fingerprint),
        )
        rec["hbm_budget_bytes"] = budget
        rec["hbm_plan"] = plan.decision
        rec["hbm_plan_reason"] = plan.reason
        if plan.decision == hbm.CPU_DEMOTE:
            _record_spill_stats(rec, spill_pool)
            raise Unsupported(f"hbm plan: {plan.reason}")
        if plan.decision == hbm.SPILL_COLDS:
            DEVICE_CACHE.ensure_headroom(max(budget - plan.working_set, 0), my_key,
                                         spill_pool)
        if plan.decision == hbm.GRACE_SPLIT:
            try:
                return self._grace_run(ctx, rec, dt, join_ops, builds, plan,
                                       grace_fanout, grace_depth_cap, table_key,
                                       device, dec)
            finally:
                _record_spill_stats(rec, spill_pool)

        t0 = time.time()
        meta, outs = self._run_stage(dt, builds, table_key, rec, dec.mode)
        rec["fusion_mode"] = meta.get("fusion_mode", "fused_xla")
        rec["fused_spans"] = meta.get("fused_spans", 0)
        res = self._fetch_decode(outs, meta, dt, builds)
        rec["exec_s"] = round(time.time() - t0, 6)
        _record_spill_stats(rec, spill_pool)
        return res

    def _fetch_decode(self, outs, meta: dict, dt: DeviceTable,
                      builds: list[BuildTable]) -> dict[int, list[pa.RecordBatch]]:
        """One fetch per device output, then the decode of the stage's
        mode into per-partition batches."""
        outs = [o.cpu().numpy() for o in outs]
        decode = self._decode_sorted if meta["mode"] == "sorted" else self._decode_all
        return decode(outs, meta, dt.shape[0], dt.dicts, [b.dicts for b in builds])

    def _grace_run(self, ctx: TaskContext, rec: dict, dt: DeviceTable,
                   join_ops: list, builds: list[BuildTable], plan,
                   fanout: int, depth_cap: int, table_key, device,
                   dec) -> dict[int, list[pa.RecordBatch]]:
        """Grace-partitioned execution of a budget-breaking hash-join stage.

        The split join's build side re-splits by a secondary hash of the
        combined int64 key (hbm.grace_bucket_of) into `plan.grace_buckets`
        sub-buckets, each run in turn over the full probe table through
        _run_stage, so the fused_pallas → fused_xla ladder still applies.
        Probe rows are never re-ordered: a row whose key lives in bucket b
        matches only in run b and is an ordinary unmatched probe in every
        other run, so the per-partition partial-aggregate batches,
        concatenated in bucket order, are the whole run's partials split by
        bucket; the final aggregate merges them. Their float sums associate
        per sub-bucket partial, so they may differ from the whole run's in
        the last bits. Empty sub-builds are skipped; the GraceReport
        postconditions are checked before anything is served."""
        from ballista_tpu_torch.analysis.plan_check import check_grace

        t0 = time.time()
        P = dt.shape[0]
        n_buckets = int(plan.grace_buckets)
        jsplit = int(plan.split_jidx)
        merged: dict[int, list[pa.RecordBatch]] = {p: [] for p in range(P)}
        buckets_run: list[int] = []
        buckets_empty: list[int] = []
        kernel_s = 0.0
        for b in range(n_buckets):
            try:
                sub_builds = [
                    self._prepare_build(op, j, ctx, table_key, device,
                                        grace=(b, n_buckets))
                    if j == jsplit else builds[j]
                    for j, op in enumerate(join_ops)
                ]
            except Unsupported as e:
                if "empty grace sub-bucket" in str(e):
                    buckets_empty.append(b)
                    continue
                raise
            meta, outs = self._run_stage(dt, sub_builds, table_key, rec, dec.mode,
                                         cache_luts=False)
            kernel_s += rec["fused_kernel_s"]
            rec["fusion_mode"] = meta.get("fusion_mode", "fused_xla")
            rec["fused_spans"] = meta.get("fused_spans", 0)
            res = self._fetch_decode(outs, meta, dt, sub_builds)
            for p, bl in res.items():
                merged[p].extend(x for x in bl if x.num_rows)
            buckets_run.append(b)

        report = hbm.GraceReport(
            stage_tag=f"stage_{zlib.crc32(self.fingerprint.encode()):08x}",
            n_buckets=n_buckets, fanout=max(2, int(fanout)),
            depth=int(plan.grace_depth), max_depth=int(depth_cap),
            buckets_run=buckets_run, buckets_empty=buckets_empty)
        violations = check_grace(report)
        if violations:
            # the merged output cannot be trusted: demote to the CPU engine
            # instead of serving it
            raise Unsupported("grace postcondition violated: "
                              + "; ".join(v.message for v in violations))
        rec["grace_splits"] = len(buckets_run)
        rec["fused_kernel_s"] = round(kernel_s, 6)  # summed over the sub-runs
        rec["exec_s"] = round(time.time() - t0, 6)  # sub-builds included
        schema = self.schema()
        return {p: (bl if bl else [_empty_batch(schema)])
                for p, bl in merged.items()}

    # ------------------------------------------------------------------

    def _compile(self, dt: DeviceTable, builds: list[BuildTable], mode_req: str):
        """Lower the stage into one closure over (cols, luts, mask, builds).
        Returns (fn, lowering, meta); `fn` returns (outputs, run meta)."""
        from ballista_tpu_torch.config import TPU_FUSION_PALLAS_MAX_PROBE
        from ballista_tpu_torch.ops.cuda import fusion as _fusion
        from ballista_tpu_torch.ops.cuda.cuda_kernels import MAX_GROUPS as _KERNEL_MAX_G
        from ballista_tpu_torch.plan.physical import HashJoinExec

        agg = self.partial_agg
        scan_schema = self.scan.df_schema
        kinds = list(zip(dt.kinds, dt.scales))
        dicts = dt.dicts
        P = dt.shape[0]
        spans = _fusion.plan_spans(
            len(getattr(self.scan, "filters", []) or []), self.ops, agg)
        # the kernels take one device's tensors: none under a stage mesh
        use_pallas = mode_req == "fused_pallas" and dt.mesh is None
        pallas_g_cap = min(int(self.config.get(TPU_FUSION_PALLAS_MAX_GROUPS)),
                           _KERNEL_MAX_G)
        pallas_probe_max = int(self.config.get(TPU_FUSION_PALLAS_MAX_PROBE))

        ctx = Lowering(scan_schema, kinds, dicts)
        ctx.pallas_dict_filter = use_pallas
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

        # one stage run's memo of join lookups: eager PyTorch has no CSE, so
        # every build-column gather would otherwise re-run its join's probe
        # (raw() clears it when the run ends)
        memo: dict = {}
        lane_cells = [{"d": 0} for _ in builds]
        lane_dups: list[int] = []  # per build: lanes to unroll (1 for semi/anti)
        outer_jidx: set[int] = set()  # joins whose build gathers are nullable-by-miss

        # Aggregate-through-join pre-scan: when the LAST op is an inner/right
        # join whose build columns appear ONLY as count(col) arguments (and
        # group keys are probe-side), the stage aggregates THROUGH the join
        # with per-row match counts — no dup-lane unrolling, no MAX_JOIN_DUP
        # ceiling (the q13 shape: count(o_orderkey) group by c_custkey).
        mult_jidx = None
        mult_outer = False
        count_build_aggs: dict[int, int] = {}  # agg idx → build field idx
        join_ops = [o for o in self.ops if isinstance(o, HashJoinExec)]
        if builds and join_ops:
            jop = join_ops[-1]
            bt_last = builds[-1]
            cba = _mult_shape_check(agg, self.ops, jop)
            if cba is not None and bt_last.dup > 1:
                ok = True
                for fi in cba.values():
                    pp = bt_last.pay_pos[fi] if fi < len(bt_last.pay_pos) else None
                    if pp is None or bt_last.pay_valids[pp] is not None:
                        ok = False  # nullable build col: match count ≠ count(col)
                if ok:
                    mult_jidx = len(builds) - 1
                    mult_outer = jop.join_type == "right"
                    count_build_aggs = cba
        mult_weight_fn = None
        jidx = 0
        for op in self.ops:
            _bind_env(ctx, cur_schema)
            if isinstance(op, FilterExec):
                filter_fns.append(lower_expr(op.predicate, ctx))
            elif isinstance(op, HashJoinExec):
                bt = builds[jidx]
                # build arrays ride at the tail of the flattened cols list
                # (after the scan columns AND their validity planes)
                off = n_flat_cols + sum(len(builds[i].flat_arrays()) for i in range(jidx))
                pay_off = off + (2 if bt.cnt is not None else 1)
                probe_fns = [lower_expr(r, ctx) for (_, r) in op.on]
                probe_pallas = (
                    use_pallas and bt.mode == "direct" and bt.cnt is None
                    and bt.dup == 1
                    and int(bt.keys.shape[0]) <= pallas_probe_max
                )
                finder = _mk_join_finder(off, probe_fns, bt, lane_cells[:jidx + 1], memo,
                                         pallas=probe_pallas)
                pv_idx = bt.pay_valid_flat_idx()
                if op.join_type in ("right_semi", "right_anti"):
                    neg = op.join_type == "right_anti"
                    if op.filter is None:
                        # membership only: the match mask filters probe rows
                        # (EXISTS / NOT IN after decorrelation) — no build
                        # columns, no expansion lanes, schema unchanged
                        filter_fns.append(
                            lambda cols, luts, _f=finder, _n=neg:
                            DevVal("bool", ~_f(cols, luts)[1].arr if _n else _f(cols, luts)[1].arr)
                        )
                    else:
                        # EXISTS with a correlated residual predicate (q21's
                        # l2.l_suppkey <> l1.l_suppkey): OR the filtered
                        # match across all dup lanes of the build key
                        if bt.dup > MAX_JOIN_DUP:
                            raise Unsupported(
                                f"semi/anti join filter over dup {bt.dup} > {MAX_JOIN_DUP}"
                            )
                        lane_preds = []
                        saved_fns, saved_meta = list(ctx.env_fns), list(ctx.env_meta)
                        combined_schema = op.left.df_schema.merge(cur_schema)
                        for d in range(bt.dup):
                            finder_d = _mk_join_finder(off, probe_fns, bt,
                                                       lane_cells[:jidx] + [{"d": d}], memo)
                            gfns, gmeta = [], []
                            for ci, pp in enumerate(bt.pay_pos):
                                if pp is None:
                                    gfns.append(_mk_raising(
                                        f"unencodable build column {ci} in join filter"))
                                    gmeta.append(None)
                                else:
                                    gfns.append(_mk_build_gather(
                                        pay_off, pp, bt.kinds[ci], bt.scales[ci],
                                        bt.dicts[ci], finder_d,
                                        None if pv_idx[pp] is None else off + pv_idx[pp]))
                                    gmeta.append((bt.kinds[ci], bt.scales[ci],
                                                  bt.dicts[ci], ("build", jidx, ci)))
                            ctx.env_fns = gfns + saved_fns
                            ctx.env_meta = gmeta + saved_meta
                            _bind_env(ctx, combined_schema)
                            lane_preds.append((finder_d, lower_expr(op.filter, ctx)))
                        ctx.env_fns, ctx.env_meta = saved_fns, saved_meta
                        _bind_env(ctx, cur_schema)

                        def run(cols, luts, _lp=lane_preds, _n=neg):
                            any_m = None
                            for fd, pf in _lp:
                                _, matched = fd(cols, luts)
                                md = true_mask(matched) & true_mask(pf(cols, luts))
                                any_m = md if any_m is None else any_m | md
                            return DevVal("bool", ~any_m if _n else any_m)

                        filter_fns.append(run)
                    lane_dups.append(1)
                    jidx += 1
                    continue
                if jidx == mult_jidx:
                    # aggregate-through-join: ONE count gather replaces all
                    # dup match lanes; build columns are never materialized
                    counter = _mk_join_counter(off, probe_fns, bt, lane_cells[:jidx + 1],
                                               memo)
                    if op.join_type == "inner":
                        filter_fns.append(
                            lambda cols, luts, _c=counter:
                            DevVal("bool", _c(cols, luts) > 0)
                        )
                    mult_weight_fn = counter
                    n_bf = len(op.left.df_schema)
                    ctx.env_fns = [
                        _mk_raising("build column consumed as a value in an "
                                    "aggregate-through-join stage")
                    ] * n_bf + list(ctx.env_fns)
                    ctx.env_meta = [None] * n_bf + list(ctx.env_meta)
                    cur_schema = op.df_schema
                    lane_dups.append(1)
                    jidx += 1
                    continue
                outer = op.join_type == "right"
                if outer:
                    outer_jidx.add(jidx)
                    # right outer: every probe row emits — on lane 0
                    # unconditionally (unmatched rows ride lane 0 with NULL
                    # build gathers), on later lanes only when matched
                    def emit(cols, luts, _f=finder, _cell=lane_cells[jidx]):
                        _, matched = _f(cols, luts)
                        if _cell["d"] == 0:
                            return DevVal("bool", torch.ones_like(matched.arr))
                        return matched

                    filter_fns.append(emit)
                else:
                    filter_fns.append(lambda cols, luts, _f=finder: _f(cols, luts)[1])
                lane_dups.append(bt.dup)
                build_fns = [
                    _mk_build_gather(pay_off, ci, bt.kinds[ci], bt.scales[ci], bt.dicts[ci],
                                     finder,
                                     None if pv_idx[ci] is None else off + pv_idx[ci],
                                     outer=outer)
                    for ci in range(len(bt.payloads))
                ]
                build_meta = [
                    (bt.kinds[ci], bt.scales[ci], bt.dicts[ci], ("build", jidx, ci))
                    for ci in range(len(bt.payloads))
                ]
                # exec output order: build fields then probe fields
                ctx.env_fns = build_fns + list(ctx.env_fns)
                ctx.env_meta = build_meta + list(ctx.env_meta)
                cur_schema = op.df_schema
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
        lane_sets = list(itertools.product(*[range(d) for d in lane_dups]))
        if len(lane_sets) > MAX_JOIN_DUP:
            raise Unsupported(f"{len(lane_sets)} expansion-join lanes > {MAX_JOIN_DUP}")

        # Group-key strategy: small dictionary domains unroll into per-group
        # masked reductions. Everything else (int64 keys like l_orderkey,
        # composite keys, big dictionaries, nullable keys) goes through the
        # sort-based segmented reduction (_compile_sorted).
        def _slot_nullable(slot) -> bool:
            if isinstance(slot, tuple) and slot[0] == "build":
                if slot[1] in outer_jidx:
                    return True  # unmatched outer gathers are NULL
                pp = builds[slot[1]].pay_pos[slot[2]]
                return pp is None or builds[slot[1]].pay_valids[pp] is not None
            return dt.valids[slot] is not None

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
            if _slot_nullable(gmeta[3]):
                # a NULL group key needs its own group: the sorted path
                # carries validity as an extra sort operand; the unrolled
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
        n_lanes = len(lane_sets)
        if unrolled and agg.group_exprs and (
            G * n_lanes > 64 or G * n_lanes * P > MAX_SEGMENTS * 16
        ):
            # the unrolled form materializes G masked reductions PER
            # expansion lane; beyond this budget it stops scaling — UNLESS
            # the kernel rung was requested and the stage fits it: its one
            # pass carries all G groups, so the 64-group budget lifts to the
            # kernel ceiling. If the value lanes turn out ineligible when the
            # stage runs (money int64 sums, validity planes), raw() raises
            # Unsupported and the ladder retries as fused_xla.
            pallas_agg_ok = (
                use_pallas and n_lanes == 1 and mult_jidx is None
                and G <= pallas_g_cap and G * P <= 1 << 22
                and all(d.func in ("sum", "count", "count_all")
                        for d in agg.aggs)
            )
            if not pallas_agg_ok:
                unrolled = False

        agg_fns = []
        agg_modes = []  # "row" | "build_cnt" (count of a mult-join build col)
        for ai, d in enumerate(agg.aggs):
            if d.func in ("welford_mean", "welford_m2"):
                # mean/M2 partials are not additive across expansion lanes and
                # have no weighted form: only plain (single-lane, unweighted)
                # stages carry variance on device
                if mult_weight_fn is not None or n_lanes != 1:
                    raise Unsupported("welford through expansion join")
            elif d.func not in ("sum", "min", "max", "count", "count_all"):
                raise Unsupported(f"agg {d.func}")
            if ai in count_build_aggs:
                agg_fns.append(None)
                agg_modes.append("build_cnt")
            else:
                fn = lower_expr(d.expr, ctx) if d.expr is not None else None
                if fn is not None and d.func in ("min", "max"):
                    fn = _no_code_extreme(fn, d.func)
                agg_fns.append(fn)
                agg_modes.append("row")

        if not unrolled:
            group_fns = [lower_expr(g, ctx) for g in agg.group_exprs]
            # each key's pre-run meta (kind, scale, dict, slot): the slot
            # resolves the live dictionary at decode, the dict the __pid
            # string LUT
            key_premeta: list = []
            for g in agg.group_exprs:
                gc = g.expr if isinstance(g, Alias) else g
                key_premeta.append(
                    ctx.env_meta[cur_schema.index_of(gc.name, gc.qualifier)]
                    if isinstance(gc, Column) else None)
            mult = (mult_weight_fn, mult_outer) if mult_weight_fn is not None else None
            fn_s, meta_s = self._compile_sorted(
                ctx, P * dt.shape[1], filter_fns, lane_sets, lane_cells, memo,
                group_fns, agg_fns, key_premeta, agg_modes, mult)
            meta_s["fusion_mode"] = "fused_xla"
            meta_s["fused_spans"] = len(spans)
            return fn_s, ctx, meta_s

        meta = {
            "mode": "unrolled",
            "fused_spans": len(spans),
            "group_src_slots": group_src_slots,
            "pad_sizes": pad_sizes,
        }
        aggs = agg.aggs

        def eval_pred(cols, luts, mask):
            """predicate span: scan filters, FilterExec predicates, semi/
            anti membership masks, join match masks — one [P, N] boolean."""
            m = mask
            for ff in filter_fns:
                m = m & true_mask(ff(cols, luts))
            return m

        def eval_proj(cols, luts):
            """project/probe span: group-id composition and agg value lanes
            (join-probe gathers ride inside the lowered column closures)."""
            gid = None
            for gf, psz in zip(group_fns, pad_sizes):
                codes = gf(cols, luts).arr.to(torch.int32)
                gid = codes if gid is None else gid * psz + codes
            vs = [af(cols, luts) if af is not None else None for af in agg_fns]
            return gid, vs

        def aggregate_lane(m, gid, vs, w, m_eff):
            """aggregate span, one expansion lane: per-group masked
            reductions (the exact torch form)."""
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
                cols_out = []
                for gm in gmasks:
                    if agg_modes[ai] == "build_cnt":
                        cols_out.append(torch.where(gm, w, 0).to(torch.int64).sum(dim=1))
                    elif m_eff is None:
                        cols_out.append(_masked_reduce(v, gm, d.func))
                    else:
                        cols_out.append(_masked_reduce_w(v, gm, d.func, m_eff))
                outs.append(torch.stack(cols_out, dim=1))  # [P, G]
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
            return outs, nullcnts, presence, info

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
            return outs, [], counts, info

        def run_lane(cols, luts, mask):
            m = eval_pred(cols, luts, mask)
            gid, vs = eval_proj(cols, luts)
            w = m_eff = None
            if mult_weight_fn is not None:
                w = torch.broadcast_to(mult_weight_fn(cols, luts), mask.shape)
                m_eff = torch.clamp(w, min=1) if mult_outer else w
            pallas_ok = (
                use_pallas and gid is not None and aggs
                and G <= pallas_g_cap and mult_weight_fn is None
                and all(v is None or v.valid is None for v in vs)
                and all(
                    d.func in ("count", "count_all")
                    or (d.func == "sum" and v is not None and v.kind == "f64")
                    for d, v in zip(aggs, vs)
                )
            )
            if pallas_ok:
                return pallas_lane(m, gid, vs)
            if use_pallas and (G * n_lanes > 64
                               or G * n_lanes * m.shape[0] > MAX_SEGMENTS * 16):
                # this stage only kept the unrolled form because the relaxed
                # kernel budget admitted it; its value lanes turned out
                # kernel-ineligible — refuse the G-wide unroll and let the
                # fallback ladder retry
                raise Unsupported(f"pallas-ineligible aggregation at G={G}")
            return aggregate_lane(m, gid, vs, w, m_eff)

        if mode_req == "staged" and n_lanes == 1 and mult_weight_fn is None:
            return self._compile_staged(eval_pred, eval_proj, aggregate_lane,
                                        lane_sets, lane_cells, memo, meta), ctx, meta

        def raw(cols, luts, mask, build_args):
            # keep [P, N]: partitions are the leading axis, reductions run
            # over dim=1. Build arrays are appended after the scan columns.
            # Expansion joins unroll match lanes: the pipeline runs once per
            # lane combination (the closures read each join's lane `d` from
            # its cell at run time) and reductions accumulate across lanes.
            # Returns the outputs (aggregates, null counts, presence) and
            # this run's output metadata.
            cols = list(cols) + [a for b in build_args for a in b]
            outs = presence = info = None
            nullcnts: list = []
            memo.clear()
            try:
                for lane in lane_sets:
                    for cell, d_ in zip(lane_cells, lane):
                        cell["d"] = d_
                    outs_l, nullcnt_l, presence_l, info = run_lane(cols, luts, mask)
                    if outs is None:
                        outs, presence, nullcnts = outs_l, presence_l, nullcnt_l
                        continue
                    merged = []
                    for d, prev, cur in zip(aggs, outs, outs_l):
                        if d.func == "min":
                            merged.append(torch.minimum(prev, cur))
                        elif d.func == "max":
                            merged.append(torch.maximum(prev, cur))
                        else:  # sum / count: additive across lanes
                            merged.append(prev + cur)
                    outs = merged
                    presence = presence + presence_l
                    nullcnts = [p_ + c_ for p_, c_ in zip(nullcnts, nullcnt_l)]
            finally:
                memo.clear()
            return list(outs) + list(nullcnts) + [presence], info

        return raw, ctx, meta

    def _compile_staged(self, eval_pred, eval_proj, aggregate_lane, lane_sets,
                        lane_cells, memo, meta):
        """Per-span dispatches — the always-available fallback mode and the
        roofline instrument.

        The predicate, project and aggregate spans run one after another,
        each synchronized, so `span_s` shows where a stage's time goes. The
        spans call the SAME closures the fused form composes (eval_pred /
        eval_proj / aggregate_lane), so staged and fused_xla results are
        byte-identical; the price is materializing the predicate mask and
        every projected value lane between the spans. Single expansion lane,
        no multiplicity weight (the caller's gate)."""
        meta.update({"fusion_mode": "staged", "fused_spans": 0})

        def staged(cols, luts, mask, build_args):
            cols = list(cols) + [a for b in build_args for a in b]
            for cell, d_ in zip(lane_cells, lane_sets[0]):
                cell["d"] = d_
            dev = mask.device

            def span(fn):
                memo.clear()  # no span reuses another's lookups
                t0 = time.time()
                out = fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return out, time.time() - t0

            try:
                m, t_pred = span(lambda: eval_pred(cols, luts, mask))

                def project():
                    gid, vs = eval_proj(cols, luts)
                    if gid is not None:
                        gid = torch.broadcast_to(gid, mask.shape).contiguous()
                    return gid, [
                        None if v is None else DevVal(
                            v.kind, torch.broadcast_to(v.arr, mask.shape).contiguous(),
                            v.scale, valid=None if v.valid is None else
                            torch.broadcast_to(v.valid, mask.shape).contiguous())
                        for v in vs]

                (gid, vs), t_proj = span(project)
                (outs, nullcnts, presence, info), t_agg = span(
                    lambda: aggregate_lane(m, gid, vs, None, None))
            finally:
                memo.clear()
            info = {**info, "fusion_mode": "staged",
                    "span_s": {"predicate": t_pred, "project": t_proj, "aggregate": t_agg}}
            return list(outs) + list(nullcnts) + [presence], info

        return staged

    def _compile_sorted(self, ctx: Lowering, PN: int, filter_fns, lane_sets, lane_cells,
                        memo, group_fns, agg_fns, key_premeta, agg_modes, mult):
        """Sort-based segmented reduction for large or non-dictionary group
        domains (the reference's _compile_sorted).

        Expansion lanes concatenate into one row set of M = P·N·lanes rows,
        flattened row-major. A lexicographic stable sort over (invalid,
        key operands...) carries the agg payloads; segment boundaries come
        from adjacent-key differences; integer sums and counts are exact
        int64 cumsum-subtracts, float sums, min and max the segmented scan
        in `jax.lax.associative_scan`'s association order, and Welford
        mean/M2 two passes over the segments. One compaction per output
        fills a capacity of C = min(pow2(M), 2^22) groups; more groups raise
        Unsupported (the stage re-runs on the CPU engine).

        The invalid flag is the most significant sort key, so the sort is
        taken as a stable partition (the live rows, in row order) followed
        by stable sorts of the live rows from the last key operand to the
        first. The dead rows sort last and touch no output, and every
        result at a live row depends only on the rows before it, so the
        outputs equal those of sorting all M rows. The sort, scans and
        compaction are plain torch calls (they are XLA operations, outside
        any Pallas kernel, in the reference)."""
        from ballista_tpu_torch.ops.cuda.final_stage import _lexsort, _segscan

        aggs = self.partial_agg.aggs
        key_slots = [pm[3] if pm is not None else None for pm in key_premeta]
        M = PN * len(lane_sets)
        C = min(_pow2(M), SORTED_MAX_GROUPS)
        # device-side shuffle routing: a __pid column over the compacted
        # rows (bit-exact twin of ops/hashing.py; string keys hash through
        # per-dictionary FNV LUTs, registered here, before the LUTs upload)
        emit_keys: list[int] | None = None
        emit_k = 0
        emit_luts: dict[int, int] = {}
        if self.emit_pid is not None:
            idxs, emit_k = self.emit_pid
            if all(0 <= i < len(group_fns) for i in idxs) and emit_k > 0:
                emit_keys = list(idxs)
                from ballista_tpu_torch.ops.hashing import fnv1a_str

                for ki in emit_keys:
                    pm = key_premeta[ki]
                    if pm is None:
                        emit_keys = None
                        break
                    if pm[0] == "code":
                        emit_luts[ki] = ctx.add_lut(
                            pm[3],
                            lambda dic: np.array(
                                [fnv1a_str(x) for x in (dic or [])], dtype=np.uint64
                            ).view(np.int64),
                        )

        def lane_rows(cols, luts, mask):
            """One expansion lane's (valid, key operands, payloads), each
            flattened to [P·N], with the key and payload plans."""
            m = mask
            for ff in filter_fns:
                m = m & true_mask(ff(cols, luts))
            keyops = []
            key_meta = []  # per key: (kind, scale, slot, has_null)
            for gf, slot in zip(group_fns, key_slots):
                v = gf(cols, luts)
                if v.kind == "f64":
                    raise Unsupported("f64 group key")
                if v.kind == "code" and slot is None:
                    raise Unsupported("code group key without a dictionary slot")
                arr = v.arr.to(torch.int32) if v.arr.dtype == torch.bool else v.arr
                has_null = v.valid is not None
                if has_null:
                    # a NULLABLE key contributes two operands — a null
                    # marker, then the (filled) value — so NULL forms its
                    # own group without a sentinel value
                    marker = ~torch.broadcast_to(v.valid, mask.shape)
                    keyops.append(marker.reshape(-1).to(torch.int32))
                keyops.append(torch.broadcast_to(arr, mask.shape).reshape(-1))
                key_meta.append((v.kind, v.scale, slot, has_null))
            w_b = m_eff = None
            if mult is not None:
                wfn, mouter = mult
                w_b = torch.broadcast_to(wfn(cols, luts), mask.shape)
                m_eff = torch.clamp(w_b, min=1) if mouter else w_b
            pays = []
            pay_plan = []  # per agg: (payload index | None, valid-count index | None)
            out_meta = []
            # the welford (mean, m2) pair shares one expression object: its
            # value and validity lanes ride through the sort once
            welford_pay: dict[int, tuple] = {}
            for ai, (d, af) in enumerate(zip(aggs, agg_fns)):
                if agg_modes[ai] == "build_cnt":
                    # count of a mult-join build column == match count
                    out_meta.append(("i64", 0))
                    pays.append(w_b.reshape(-1).to(torch.int64))
                    pay_plan.append((len(pays) - 1, None))
                    continue
                v = af(cols, luts) if af is not None else None
                if d.func in ("count", "count_all"):
                    out_meta.append(("i64", 0))
                    if v is None or v.valid is None:
                        if m_eff is None:
                            pay_plan.append((None, None))  # segment length
                        else:
                            pays.append(m_eff.reshape(-1).to(torch.int64))
                            pay_plan.append((len(pays) - 1, None))
                    else:
                        # count(x): the non-null x of the group, each probe
                        # row weighted by its join multiplicity
                        vb = torch.broadcast_to(v.valid, mask.shape)
                        cnt1 = m_eff if m_eff is not None else 1
                        pays.append(torch.where(vb, cnt1, 0).reshape(-1).to(torch.int64))
                        pay_plan.append((len(pays) - 1, None))
                    continue
                if d.func in ("welford_mean", "welford_m2") and id(d.expr) in welford_pay:
                    out_meta.append(("f64", 0))
                    pay_plan.append(welford_pay[id(d.expr)])
                    continue
                out_meta.append((v.kind, v.scale))
                arr = v.arr
                if m_eff is not None and d.func == "sum":
                    arr = arr * m_eff.to(arr.dtype)
                ncnt_idx = None
                if v.valid is not None:
                    # null-skip: neutralize invalid slots for the reduce and
                    # carry a valid count, so all-NULL groups decode to NULL
                    # rather than 0 / ±inf
                    if d.func in ("sum", "welford_mean", "welford_m2"):
                        neutral = 0
                    elif d.func == "min":
                        neutral = (float("inf") if arr.dtype.is_floating_point
                                   else torch.iinfo(arr.dtype).max)
                    else:
                        neutral = (float("-inf") if arr.dtype.is_floating_point
                                   else torch.iinfo(arr.dtype).min)
                    arr = torch.where(v.valid, arr,
                                      torch.tensor(neutral, dtype=arr.dtype, device=arr.device))
                    pays.append(torch.broadcast_to(v.valid, mask.shape).reshape(-1)
                                .to(torch.int64))
                    ncnt_idx = len(pays) - 1
                pays.append(torch.broadcast_to(arr, mask.shape).reshape(-1))
                pay_plan.append((len(pays) - 1, ncnt_idx))
                if d.func in ("welford_mean", "welford_m2"):
                    welford_pay[id(d.expr)] = pay_plan[-1]
            plan = {"key_meta": key_meta, "out": out_meta, "pay_plan": pay_plan}
            return m.reshape(-1), keyops, pays, plan

        def raw(cols, luts, mask, build_args):
            cols = list(cols) + [a for b in build_args for a in b]
            dev = mask.device
            lane_valid, lane_keyops, lane_pays = [], [], []
            memo.clear()
            try:
                for lane in lane_sets:
                    for cell, d_ in zip(lane_cells, lane):
                        cell["d"] = d_
                    valid_l, keyops_l, pays_l, plan = lane_rows(cols, luts, mask)
                    lane_valid.append(valid_l)
                    lane_keyops.append(keyops_l)
                    lane_pays.append(pays_l)
            finally:
                memo.clear()
            key_meta, pay_plan = plan["key_meta"], plan["pay_plan"]
            valid = torch.cat(lane_valid)
            n_keyops = len(lane_keyops[0])
            cat_keys = [torch.cat([lk[i] for lk in lane_keyops]) for i in range(n_keyops)]
            cat_pays = [torch.cat([lp[i] for lp in lane_pays]) for i in range(len(lane_pays[0]))]
            del lane_valid, lane_keyops, lane_pays

            clock = _Clock(dev)
            live = torch.nonzero(valid).squeeze(1)  # the stable partition
            n = int(live.shape[0])
            keys_live = [k[live] for k in cat_keys]
            perm = _lexsort(keys_live) if n else live
            rows = live[perm]
            skeys = [k[perm] for k in keys_live]
            spays = [p_[rows] for p_ in cat_pays]
            sort_t = clock.stop()
            del cat_keys, cat_pays, keys_live, perm, rows

            boundary = torch.zeros(n, dtype=torch.bool, device=dev)
            boundary[:1] = True
            for k in skeys:
                boundary[1:] |= k[1:] != k[:-1]
            is_end = torch.ones(n, dtype=torch.bool, device=dev)
            is_end[:-1] = boundary[1:]
            starts = torch.nonzero(boundary).squeeze(1)
            ends = torch.nonzero(is_end).squeeze(1)
            n_seg = int(starts.shape[0])
            if n_seg > C:
                raise Unsupported(f"group capacity overflow ({n_seg} > {C})")
            cp = min(_pow2(n_seg), C)  # the fetch covers the live groups only
            seg = torch.cumsum(boundary, 0) - 1

            def compact(src):
                out = torch.zeros(cp, dtype=src.dtype, device=dev)
                out[:n_seg] = src
                return out

            def seg_len():
                return compact((ends - starts + 1).to(torch.int64))

            def int_segsum(sv):
                # exact int64: global cumsum minus the prefix before each
                # segment's start
                w = sv.to(torch.int64)
                csum = torch.cumsum(w, 0)
                return compact(csum[ends] - (csum[starts] - w[starts]))

            def scan(sv, func):
                # the reference scans all M sorted rows, where a lone live
                # row still meets a combine: one dead row keeps that so
                if n == 1 and M > 1:
                    pad = torch.zeros(1, dtype=sv.dtype, device=dev)
                    return _segscan(torch.cat([sv, pad]),
                                    torch.cat([boundary, boundary[:1]]), func)[:1]
                return _segscan(sv, boundary, func)

            key_outs = [compact(k[ends]) for k in skeys]
            agg_outs = []
            ncnt_outs = []
            ncnt_map: dict[int, int] = {}
            welford_stats: dict[int, tuple] = {}  # pay_idx → (count, mean, ncnt pos)
            for ai, (d, (pay_idx, ncnt_idx)) in enumerate(zip(aggs, pay_plan)):
                if pay_idx is None:
                    agg_outs.append(seg_len())
                    continue
                sv = spays[pay_idx]
                if d.func in ("welford_mean", "welford_m2"):
                    # two-pass variance partial: the segment mean through
                    # the float segmented scan, then the mean-centred square
                    # sum; the (mean, m2) pair shares its payload and stats
                    if pay_idx in welford_stats:
                        c_c, mean_c, ncnt_pos = welford_stats[pay_idx]
                    else:
                        c_c = (int_segsum(spays[ncnt_idx]) if ncnt_idx is not None
                               else seg_len())
                        s1_c = compact(scan(sv, "sum")[ends])
                        mean_c = s1_c / torch.clamp(c_c, min=1).to(sv.dtype)
                        ncnt_pos = None
                        if ncnt_idx is not None:
                            ncnt_pos = len(ncnt_outs)
                            ncnt_outs.append(c_c)
                        welford_stats[pay_idx] = (c_c, mean_c, ncnt_pos)
                    if d.func == "welford_mean":
                        agg_outs.append(mean_c)
                    else:
                        dev_ = sv - mean_c[seg]
                        d2 = dev_ * dev_
                        if ncnt_idx is not None:
                            # null slots were sum-neutralized to 0: keep them
                            # out of the square sum too
                            d2 = torch.where(spays[ncnt_idx] > 0, d2,
                                             torch.zeros((), dtype=d2.dtype, device=dev))
                        agg_outs.append(compact(scan(d2, "sum")[ends]))
                    if ncnt_pos is not None:
                        ncnt_map[ai] = ncnt_pos
                    continue
                fname = "sum" if d.func in ("count", "count_all") else d.func
                if fname == "sum" and not sv.dtype.is_floating_point:
                    agg_outs.append(int_segsum(sv))
                else:
                    # float sums take the segmented scan too: a cumsum-
                    # subtract would difference two near-equal totals
                    agg_outs.append(compact(scan(sv, fname)[ends]))
                if ncnt_idx is not None:
                    ncnt_map[ai] = len(ncnt_outs)
                    ncnt_outs.append(int_segsum(spays[ncnt_idx]))

            outs = key_outs + agg_outs + ncnt_outs
            if emit_keys is not None:
                outs.append(_partition_ids(key_outs, key_meta, emit_keys, emit_luts,
                                           luts, emit_k))
            info = {"key_meta": key_meta, "out": plan["out"], "nullcnt_map": ncnt_map,
                    "n_seg": n_seg, "C": C, "live_rows": n, "sort_clock": sort_t}
            return outs, info

        return raw, {"mode": "sorted", "emit_pid": emit_keys is not None}

    def _decode_sorted(self, outs: list[np.ndarray], meta: dict, P: int, dicts,
                       build_dicts: list) -> dict[int, list[pa.RecordBatch]]:
        """Decode the sorted path's compacted outputs. Partial-agg results
        are mergeable, so all segments land in output partition 0 (deduplicated
        across input partitions); the other partitions emit empty."""
        schema = self.schema()
        key_meta = meta["key_meta"]
        n_keys = len(key_meta)
        n_keyops = sum(2 if km[3] else 1 for km in key_meta)
        n = meta["n_seg"]
        results = {p: [_empty_batch(schema)] for p in range(P)}
        if n == 0:
            return results
        host = outs[:-1] if meta.get("emit_pid") else outs
        nullcnt_map = meta.get("nullcnt_map", {})
        n_aggs = len(meta["out"])
        ncnt_host = host[n_keyops + n_aggs:]
        arrays: list[pa.Array] = []
        pos = 0
        for (kind, scale, slot, has_null), f in zip(key_meta, schema):
            null_mask = None
            if has_null:
                null_mask = host[pos][:n] != 0
                pos += 1
            vals = host[pos][:n]
            pos += 1
            if kind == "code":
                # the LIVE dictionary of this run's table or build
                if isinstance(slot, tuple) and slot[0] == "build":
                    dic = build_dicts[slot[1]][slot[2]]
                else:
                    dic = dicts[slot]
                arr = pa.array(dic, pa.string()).take(pa.array(vals, mask=null_mask))
            elif kind == "date":
                arr = pa.array(vals.astype(np.int32), pa.int32(), mask=null_mask).cast(pa.date32())
            elif kind == "money":
                arr = pa.array(vals.astype(np.float64) / (10**scale), pa.float64(),
                               mask=null_mask)
            else:
                arr = pa.array(vals, mask=null_mask)
            if arr.type != f.type:
                arr = arr.cast(f.type)
            arrays.append(arr)
        for ai, (out, (kind, scale), f) in enumerate(
            zip(host[n_keyops:n_keyops + n_aggs], meta["out"], list(schema)[n_keys:])
        ):
            vals = out[:n]
            null_mask = None
            if ai in nullcnt_map:
                # all of the group's agg inputs were NULL → the agg is NULL
                null_mask = ncnt_host[nullcnt_map[ai]][:n] == 0
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
        if meta.get("emit_pid"):
            # device-routed shuffle: the partition ids ride along; the
            # shuffle writer consumes and drops the __pid column
            arrays.append(pa.array(outs[-1][:n].astype(np.int32), pa.int32()))
            out_schema = pa.schema(list(schema) + [pa.field("__pid", pa.int32())])
            self.pid_emitted += 1
            results[0] = [pa.RecordBatch.from_arrays(arrays, schema=out_schema)]
            return results
        results[0] = [pa.RecordBatch.from_arrays(arrays, schema=schema)]
        return results

    def _decode_all(self, outs: list[np.ndarray], meta: dict, P: int, dicts,
                    build_dicts: list | None = None) -> dict[int, list[pa.RecordBatch]]:
        agg = self.partial_agg
        schema = self.schema()
        group_dicts = []
        for s in meta["group_src_slots"]:
            if isinstance(s, tuple) and s[0] == "build":
                group_dicts.append(build_dicts[s[1]][s[2]])
            else:
                group_dicts.append(dicts[s])
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


def _put(arr: np.ndarray, device):
    """Place one host array for the stage: on its device; over a Mesh,
    replicated on every device; at a ByPartition placement, split by its
    leading (partition) axis across the mesh. The single place that
    decides placement, and the one place chaos hbm_oom can fault an
    upload."""
    hbm.maybe_chaos_oom()
    if isinstance(device, Mesh):
        return device.replicate(arr)
    if isinstance(device, ByPartition):
        return device.mesh.shard(arr)
    return to_device(arr, device)


class _Staging:
    """The two host buffers that a chunked upload's [P, chunk] slices pass
    through: pinned when the target is a card, so each copy runs
    asynchronously on the caller's stream while the host fills the other
    buffer. An event per buffer, recorded after its copy, makes the host
    wait before it refills that buffer. On the CPU (the tests' form) the
    buffers are plain host memory and the copies synchronous. One caller
    thread uses it; its buffers grow to the largest slice and are reused."""

    def __init__(self, device):
        self.cuda = isinstance(device, torch.device) and device.type == "cuda"
        self._bufs: list = [None, None]
        self._events: list = [None, None]
        self._next = 0

    def acquire(self, nbytes: int) -> tuple[int, torch.Tensor]:
        """(slot, a host byte buffer of `nbytes` no copy still reads)."""
        i = self._next
        self._next ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cuda)
        return i, buf[:nbytes]

    def copied(self, slot: int, device) -> None:
        """Mark the copy just enqueued from `slot` on `device`'s stream."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            self._events[slot] = ev


def _put_chunked(arr: np.ndarray, device, chunk_rows: int, staging: _Staging | None):
    """Place one [P, N] stack in [P, chunk_rows] slices along N (the
    reference's `_put_chunked`): the stack is allocated once on the
    device, and each slice is staged through `staging`'s two buffers and
    copied with non_blocking=True, so slice k+1 is cut while slice k
    streams. A mesh placement, a 1-D array, a stack no wider than one
    chunk, or no staging (chunk_rows 0) takes the whole-array `_put`."""
    if (staging is None or not isinstance(device, torch.device)
            or arr.ndim != 2 or arr.shape[1] <= chunk_rows):
        return _put(arr, device)
    hbm.maybe_chaos_oom()
    P, N = arr.shape
    out = torch.empty((P, N), dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                      device=device)
    for o in range(0, N, chunk_rows):
        _copy_slice(arr[:, o:o + chunk_rows], out[:, o:o + chunk_rows], staging, device)
    return out


def _copy_slice(src: np.ndarray, dst: torch.Tensor, staging: _Staging, device) -> None:
    """One [P, c] slice: host slice → staging buffer → its place in `dst`."""
    slot, buf = staging.acquire(src.nbytes)
    staged = buf.view(dst.dtype).view(src.shape)
    staged.numpy()[...] = src
    dst.copy_(staged, non_blocking=staging.cuda)
    staging.copied(slot, device)


def _by_partition(device):
    """Where a table's [P, N] stacks go: split by partition over a mesh;
    the device itself otherwise."""
    return ByPartition(device) if isinstance(device, Mesh) else device


def _synchronize(device) -> None:
    """Wait for the card(s) `device` (a torch device or a Mesh) names."""
    devs = device.devices if isinstance(device, Mesh) else (device,)
    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _stage_mesh(config: BallistaConfig) -> Mesh | None:
    """1-D mesh over the partition axis when collective exchange is on and
    more than one device is visible: the stage's table shards by partition
    and the pass runs on every device (_run_pass). One executor process
    drives every visible card."""
    if not bool(config.get(TPU_COLLECTIVE_EXCHANGE)):
        return None
    devs = runtime.visible_devices()
    if len(devs) < 2:
        return None
    return Mesh(devs)


def _run_pass(fn, mode: str, dt: "DeviceTable", luts: list, builds: list):
    """Run a lowered stage closure over the table. On one device, once.
    Over a mesh, once per device on that device's partitions, builds and
    LUTs from its replica; every output is [P, ...] by partition, so the
    per-device outputs, in device order, are the whole pass's outputs in
    partition order. The sorted mode sorts every partition's rows
    together, so it runs once over the shards gathered onto the mesh's
    first device."""
    build_args = [b.flat_arrays() for b in builds]
    mesh = dt.mesh
    if mesh is None:
        return fn(dt.flat_cols(), luts, dt.mask, build_args)
    if mode == "sorted":
        d0 = mesh.devices[0]
        return fn([c.gather(d0) for c in dt.flat_cols()], [l.local(0) for l in luts],
                  dt.mask.gather(d0), [[a.local(0) for a in b] for b in build_args])
    runs = [fn([c.local(i) for c in dt.flat_cols()], [l.local(i) for l in luts],
               dt.mask.local(i), [[a.local(i) for a in b] for b in build_args])
            for i in range(mesh.size)]
    outs = [MeshTensor(mesh, [r[0][k] for r in runs], True) for k in range(len(runs[0][0]))]
    info = dict(runs[-1][1])
    if "span_s" in info:
        # staged spans ran once per device, one after another
        info["span_s"] = {k: sum(r[1]["span_s"][k] for r in runs) for k in info["span_s"]}
    return outs, info


def _masked_reduce_w(v, gm, func: str, m_eff):
    """Weighted reduction for aggregate-through-join: each probe row stands
    in for m_eff joined rows (match count; max(count, 1) under outer)."""
    if func == "count_all":
        return torch.where(gm, m_eff, 0).to(torch.int64).sum(dim=1)
    if func == "count":
        m2 = gm if (v is None or v.valid is None) else gm & v.valid
        return torch.where(m2, m_eff, 0).to(torch.int64).sum(dim=1)
    if func == "sum":
        arr = torch.broadcast_to(v.arr, gm.shape)
        if v.valid is not None:
            gm = gm & v.valid
        scaled = arr * m_eff.to(arr.dtype)
        return torch.where(gm, scaled, torch.zeros((), dtype=arr.dtype,
                                                    device=arr.device)).sum(dim=1)
    # min/max are multiplicity-invariant (w==0 rows are filtered for inner
    # joins; under outer every probe row legitimately appears)
    return _masked_reduce(v, gm, func)


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


class _Clock:
    """Seconds of device work from here to `stop()`: CUDA events on the
    card (read once the stage has synchronized, no sync of its own), the
    host clock on the CPU. `stop()` returns a callable giving the span."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            return lambda: self.start.elapsed_time(end) / 1e3
        span = time.perf_counter() - self.t0
        return lambda: span


_NULL_TAG = 0x9E3779B97F4A7C15 - (1 << 64)  # ops/hashing._NULL_TAG as int64


def _partition_ids(key_outs, key_meta, emit_keys, emit_luts, luts, k) -> torch.Tensor:
    """The shuffle partition of each compacted group row: ops/hashing's
    partition_indices over the decoded key columns, computed on the card.
    A string key hashes through its dictionary's FNV-1a LUT; a money key
    through the bits of its decoded float64 (value / 10^scale, as the
    decode divides, with -0.0 made +0.0); other keys through their int64
    value; a NULL key takes the NULL tag."""
    pos = 0
    key_pos = []  # per key: (marker position | None, value position)
    for (_k, _s, _slot, has_null) in key_meta:
        key_pos.append((pos if has_null else None, pos + (1 if has_null else 0)))
        pos += 2 if has_null else 1
    h = torch.zeros_like(key_outs[0], dtype=torch.int64)
    for ki in emit_keys:
        kind, scale, _slot, _hn = key_meta[ki]
        mpos, vpos = key_pos[ki]
        arr = key_outs[vpos]
        if kind == "code":
            enc = take(luts[emit_luts[ki]], arr)
        elif kind == "money":
            f = arr.to(torch.float64) / (10.0 ** scale)
            f = torch.where(f == 0.0, torch.zeros_like(f), f)
            enc = f.view(torch.int64)
        else:  # i64 / date / bool: the value's int64 bits
            enc = arr.to(torch.int64)
        hv = hash64(enc)
        if mpos is not None:
            hv = torch.where(key_outs[mpos] != 0,
                             torch.tensor(_NULL_TAG, dtype=torch.int64, device=hv.device), hv)
        h = hash_combine(h, hv)
    return umod(h, k).to(torch.int32)


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


def _probe_key(cols, luts, probe_fns, shifts):
    """The combined int64 probe key and its validity: multi-key probes
    combine as k1 << shift | k2 with device range guards mirroring the
    host-side guards, so out-of-range keys can never alias a real build
    key; a NULL probe key matches nothing."""
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
            valid = valid & v.valid
    return k, valid


def _memoized(memo: dict, key, cols, compute):
    """One stage run's memo (see _compile): the entry pins `cols`, so its
    id cannot be recycled while the entry lives, and the identity check
    makes a stale hit impossible."""
    hit = memo.get(key)
    if hit is None or hit[0] is not cols:
        hit = (cols, compute())
        memo[key] = hit
    return hit[1]


def _mk_join_finder(off: int, probe_fns, bt: BuildTable, cells: list, memo: dict,
                    pallas: bool = False):
    """Closure computing (clamped build index, matched mask) for one join.

    'direct' mode, unique keys: the build shipped a dense key→row int32
    table — ONE gather per probe, matched iff row >= 0. Repeated keys
    (dup > 1): the lo/cnt tables; the probe's match lane d (`cells[-1]["d"]`,
    set by the lane loop before each lane runs) selects row lo+d, matched
    iff d < cnt. 'sorted' mode: a binary search over the sorted keys (left
    for unique keys, left and right for expansion lanes), with the
    reference's clamps and match rules.

    `pallas=True` (unique keys only) routes the lookup through the
    hand-written `hash_probe` kernel, gather and match mask fused, with
    the table in shared memory up to the engine's cap
    (`cuda_kernels.hash_probe_regime` picks where it sits). Every
    build-column gather closure re-invokes the finder, so the result is
    memoized per stage run, keyed by the identity of the run's `cols` list
    and the lanes of every join up to and including this one (`cells`):
    a probe key gathered from an earlier expansion join differs per lane
    of that join, so one lookup (one kernel launch) per join per lane
    combination of the joins it depends on, and no more."""
    shifts = bt.shifts
    has_cnt = bt.cnt is not None
    b_static = bt.padded_rows()
    sorted_mode, dup = bt.mode == "sorted", bt.dup
    token = object()

    def find(cols, luts, d):
        keys_arr = cols[off]
        k, valid = _probe_key(cols, luts, probe_fns, shifts)
        if sorted_mode:
            last = keys_arr.shape[0] - 1
            if dup == 1:
                idxc = torch.searchsorted(keys_arr, k).clamp(0, last)
                return idxc, DevVal("bool", (take(keys_arr, idxc) == k) & valid)
            lo = torch.searchsorted(keys_arr, k, side="left")
            hi = torch.searchsorted(keys_arr, k, side="right")
            idxc = (lo + d).clamp(0, last).to(torch.int32)
            return idxc, DevVal("bool", valid & (lo + d < hi))
        in_range = valid & (k >= 0) & (k < keys_arr.shape[0])
        kc = torch.where(in_range, k, 0)
        if not has_cnt:
            if pallas:
                from ballista_tpu_torch.ops.cuda.cuda_kernels import hash_probe

                rows, matched = hash_probe(kc.to(torch.int32), keys_arr, in_range)
                return rows, DevVal("bool", matched)
            row = take(keys_arr, kc)
            matched = in_range & (row >= 0)
            return row.clamp(min=0).to(torch.int32), DevVal("bool", matched)
        lo = take(keys_arr, kc)
        c = take(cols[off + 1], kc)
        matched = in_range & (d < c)
        idxc = (lo + d).clamp(0, b_static - 1).to(torch.int32)
        return idxc, DevVal("bool", matched)

    def run(cols, luts):
        lanes = tuple(c["d"] for c in cells)
        return _memoized(memo, (token, id(cols), lanes), cols,
                         lambda: find(cols, luts, lanes[-1]))

    return run


def _mult_shape_check(partial_agg, ops, join) -> dict | None:
    """Structural eligibility for aggregate-through-join: `join` must be the
    stage's LAST join (only pass-through projections may follow), inner or
    right with no residual filter, group keys probe-side, and every
    build-column use a bare count(col). Returns {agg index → build field
    index} (may be empty) or None if ineligible. Shared by _prepare_build
    (to exempt such joins from the dup-lane cap), _compile (to activate the
    weight path) and the cost model (fusion.estimate_stage)."""
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


def _mk_join_counter(off: int, probe_fns, bt: BuildTable, cells: list, memo: dict):
    """Closure computing each probe row's MATCH COUNT against the build —
    the aggregate-through-join weight. Where every build-column use in the
    stage is multiplicity-shaped (count(col), count(*), probe-side sums),
    gathering the count replaces dup-lane unrolling entirely: one gather
    instead of dup lane passes, and no MAX_JOIN_DUP ceiling. Memoized as
    the finder is, under the lanes of the joins up to this one (`cells`)."""
    shifts = bt.shifts
    has_cnt = bt.cnt is not None
    sorted_mode = bt.mode == "sorted"
    token = object()

    def count(cols, luts):
        keys_arr = cols[off]
        k, valid = _probe_key(cols, luts, probe_fns, shifts)
        zero = torch.zeros((), dtype=torch.int32, device=k.device)
        if sorted_mode:
            lo = torch.searchsorted(keys_arr, k, side="left")
            hi = torch.searchsorted(keys_arr, k, side="right")
            return torch.where(valid, (hi - lo).to(torch.int32), zero)
        in_range = valid & (k >= 0) & (k < keys_arr.shape[0])
        kc = torch.where(in_range, k, 0)
        if has_cnt:
            return torch.where(in_range, take(cols[off + 1], kc), zero)
        row = take(keys_arr, kc)
        return (in_range & (row >= 0)).to(torch.int32)

    def run(cols, luts):
        lanes = tuple(c["d"] for c in cells)
        return _memoized(memo, (token, id(cols), lanes), cols, lambda: count(cols, luts))

    return run


def _mk_raising(msg: str):
    def run(cols, luts):
        raise Unsupported(msg)

    return run


def _mk_build_gather(pay_off: int, ci: int, kind: str, scale: int, dictionary, finder,
                     valid_abs_idx=None, outer=False):
    """Gather one build-payload column through the join finder. Nullable
    payloads gather their validity plane too; under an outer join the gather
    of an UNMATCHED probe row is NULL (valid = matched & payload-valid)."""

    def run(cols, luts):
        idxc, matched = finder(cols, luts)
        arr = take(cols[pay_off + ci], idxc)
        if kind in ("i64", "money") and arr.dtype != torch.int64:
            arr = arr.to(torch.int64)
        elif kind in ("code", "date") and arr.dtype != torch.int32:
            arr = arr.to(torch.int32)
        valid = take(cols[valid_abs_idx], idxc) if valid_abs_idx is not None else None
        if outer:
            m = true_mask(matched)
            valid = m if valid is None else valid & m
        return DevVal(kind, arr, scale, dictionary, valid=valid)

    return run


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
