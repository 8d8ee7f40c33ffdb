"""Mesh-wide stage execution: the on-device form of a hash exchange.

The distributed planner's mesh post-pass (scheduler/planner.py
merge_mesh_stages) fuses a hash-shuffle producer stage into its single
consumer: the producer's ShuffleWriterExec(hash K) and the consumer's
reader collapse into one `MeshExchangeExec` node inside ONE stage, and the
whole stage ships as ONE task spanning every partition. The exchange that
used to round-trip through Arrow IPC files and Flight RPCs becomes tensor
copies between the cards of one process over a `make_mesh()` device mesh
(parallel/exchange.py) — Theseus's thesis (arXiv:2508.05029): distributed
accelerator engines win or lose on data movement.

Execution ladder, most- to least-capable, every rung recorded as
`mesh_mode_reason` in RUN_STATS:

1. **mesh** — producer partitions run (device-compiled where the CUDA
   engine lowered them), output rows encode to int64 lanes, and one
   `hash_exchange_table` all_to_all routes them by the engine-wide row hash
   (ops/hashing.py `hash_arrays`, the bit-exact twin of the file shuffle's
   routing). Zero shuffle files, zero Flight fetches for this edge.
2. **demoted:…** — capacity overflow (`ExchangeCapacityExceeded`), too few
   devices, an un-encodable column dtype, a tiny input, or an AQE veto
   drop to the host split: the same `hash_arrays % K` routing the
   ShuffleWriterExec applies, minus the files. Results are identical either
   way — bucket p always holds exactly the rows whose key hashes to p, in
   producer row order.

No card at all, and the CPU not asked for (`runtime.use_cpu`), is not a
rung: the exchange raises, as every device stage does.

Byte parity with the per-partition path is by construction: the reader
orders bucket p's locations by map partition, so its row order is global
producer row order; the mesh path carries a row id through the exchange
and re-sorts, then re-splits batches at producer-partition boundaries so
even the consumer's chunking matches.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterator

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext

log = logging.getLogger(__name__)


class UnsupportedExchangeType(Exception):
    """A producer output column cannot be encoded to int64 exchange lanes."""


# ---------------------------------------------------------------------------
# column <-> int64-lane codecs
# ---------------------------------------------------------------------------


def _storage_type(t: pa.DataType) -> pa.DataType:
    """The integer type a temporal column is stored as: date32 in int32;
    date64 and timestamps in int64. Arrow casts a temporal type to and from
    its own storage type only (date32 to int64 is not implemented, C25)."""
    return pa.int32() if pa.types.is_date32(t) else pa.int64()


def _encode_column(arr: pa.Array) -> tuple[list[np.ndarray], np.ndarray | None, dict]:
    """Arrow column -> (int64 lanes, validity bool[n] or None, decode meta).

    Every supported type round-trips EXACTLY: ints widen to int64, dates
    and timestamps travel through their storage integers widened to int64,
    floats travel as bit-cast int64 (f32 upcast to f64 first — exact), and
    strings ship as dictionary codes against a host-side dictionary built
    over the whole producer output (one table, so the dictionary is global
    by construction)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if pa.types.is_dictionary(t):
        arr = arr.cast(t.value_type)
        t = arr.type
    valid = None
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
    if pa.types.is_integer(t) or pa.types.is_boolean(t):
        filled = arr.fill_null(0) if arr.null_count else arr
        lane = np.asarray(filled.cast(pa.int64())).astype(np.int64)
        return [lane], valid, {"kind": "int"}
    if pa.types.is_date(t) or pa.types.is_timestamp(t):
        storage = _storage_type(t)
        ints = arr.cast(storage)
        filled = ints.fill_null(0) if arr.null_count else ints
        lane = np.asarray(filled).astype(np.int64)
        return [lane], valid, {"kind": "int", "storage": storage}
    if pa.types.is_floating(t):
        filled = arr.fill_null(0.0) if arr.null_count else arr
        f64 = np.asarray(filled.cast(pa.float64())).astype(np.float64)
        return [f64.view(np.int64)], valid, {"kind": "float"}
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        dict_arr = arr.dictionary_encode()
        codes = dict_arr.indices.fill_null(0) if dict_arr.indices.null_count else dict_arr.indices
        lane = np.asarray(codes.cast(pa.int64())).astype(np.int64)
        return [lane], valid, {"kind": "dict", "dictionary": dict_arr.dictionary}
    raise UnsupportedExchangeType(str(t))


def _decode_column(field_type: pa.DataType, lanes: list[np.ndarray],
                   valid: np.ndarray | None, meta: dict) -> pa.Array:
    kind = meta["kind"]
    if kind == "float":
        values = pa.array(lanes[0].view(np.float64))
    elif kind == "dict":
        values = meta["dictionary"].take(pa.array(lanes[0]))
    elif "storage" in meta:
        # a temporal column: its storage integers, then the type
        values = pa.array(lanes[0], pa.int64()).cast(meta["storage"])
    else:
        values = pa.array(lanes[0])
    if valid is not None:
        mask = pa.array(~valid)
        values = pa.compute.if_else(mask, pa.nulls(len(valid), values.type), values)
    out_type = field_type
    if pa.types.is_dictionary(out_type):
        out_type = out_type.value_type
    return values.cast(out_type) if values.type != out_type else values


# ---------------------------------------------------------------------------
# the plan node
# ---------------------------------------------------------------------------


class MeshExchangeExec(ExecutionPlan):
    """Fused hash exchange inside a merged mesh stage.

    Stands where the consumer's ShuffleReaderExec stood: `execute(p)`
    serves reduce bucket p of the producer's hash-partitioned output. The
    exchange itself runs ONCE (first execute) — on the device mesh when the
    ladder allows, on the host split otherwise — and every bucket serves
    from the cached result, so a single task must cover all K partitions
    (the planner marks the merged stage `mesh=True` and the graph hands it
    out as one mesh-wide task)."""

    def __init__(self, producer: ExecutionPlan, keys: list, file_partitions: int):
        super().__init__(producer.df_schema)
        self.producer = producer
        self.keys = keys
        self.file_partitions = max(1, int(file_partitions))
        self._lock = threading.Lock()
        self._buckets: list[list[pa.RecordBatch]] | None = None
        # set by AQE at stage resolution to veto the device path from
        # observed input sizes; also carried through with_children
        self.demote_reason: str | None = None

    def children(self):
        return [self.producer]

    def with_children(self, c):
        out = MeshExchangeExec(c[0], self.keys, self.file_partitions)
        out.demote_reason = self.demote_reason
        return out

    def with_file_partitions(self, k: int) -> "MeshExchangeExec":
        """Fresh exchange at a different bucket count — AQE's mesh bucket
        replan. Hash routing is count-parametric (`h % K` on both the
        device and host paths), so any K yields a valid partitioning; a
        fresh node (new lock, empty cache) keeps the replan from aliasing
        a prior resolution's buckets."""
        out = MeshExchangeExec(self.producer, self.keys, k)
        out.demote_reason = self.demote_reason
        return out

    def output_partition_count(self) -> int:
        return self.file_partitions

    def node_str(self) -> str:
        k = ", ".join(str(e) for e in self.keys)
        why = f", demoted={self.demote_reason}" if self.demote_reason else ""
        return f"MeshExchangeExec: keys=[{k}], partitions={self.file_partitions}{why}"

    # ------------------------------------------------------------------

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        with self._lock:
            if self._buckets is None:
                self._buckets = self._exchange(ctx)
        yield from self._buckets[partition]

    # ------------------------------------------------------------------

    def _exchange(self, ctx: TaskContext) -> list[list[pa.RecordBatch]]:
        from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

        routed = self._daemon_exchange(ctx)
        if routed is not None:
            return routed

        part_tables: list[pa.Table] = []
        schema = self.producer.schema()
        for p in range(self.producer.output_partition_count()):
            batches = [b for b in self.producer.execute(p, ctx) if b.num_rows]
            part_tables.append(
                pa.Table.from_batches(batches, schema=schema) if batches
                else pa.table({f.name: pa.array([], f.type) for f in schema}, schema=schema)
            )

        with RUN_STATS.run("mesh_exchange") as rec:
            reason, buckets = self._try_device_exchange(part_tables, ctx, rec)
            if buckets is None:
                log.info("mesh exchange demoted to per-partition host split: %s", reason)
                buckets = self._host_split(part_tables)
            RUN_STATS.set("mesh_mode_reason", reason, rec=rec)
        return buckets

    def _daemon_exchange(self, ctx: TaskContext):
        """Route the whole mesh-wide stage (producer partitions + fused
        exchange) through the device daemon, which owns the device span
        the mesh pins. The request tag stays "mesh_exchange" so the
        daemon's mirrored rec — mesh_mode_reason included, capacity/dtype
        demotions and all — lands under the SAME stage key local runs
        use. None = run locally (daemon off, crashed out, quarantined, or
        an AQE veto already demoted the exchange)."""
        if self.demote_reason:
            return None
        from ballista_tpu_torch.ops.cuda import daemon_route

        fp = f"{self.node_str()}|{self.producer.node_str()}"
        results = daemon_route.run_via_daemon(
            ctx.config,
            plan_builder=lambda: self,
            partitions=list(range(self.file_partitions)),
            tag="mesh_exchange",
            fingerprint=fp)
        if results is None:
            return None
        return [results.get(p, []) for p in range(self.file_partitions)]

    # -- demotion ladder -------------------------------------------------

    def _try_device_exchange(self, part_tables, ctx, rec):
        """Returns (reason, buckets-or-None). None buckets = take the host
        path; the reason string says which rung of the ladder failed."""
        from ballista_tpu_torch.config import (
            TPU_MESH_DEVICES,
            TPU_MESH_EXCHANGE_CAPACITY,
            TPU_MESH_MIN_ROWS,
        )
        from ballista_tpu_torch.parallel.exchange import ExchangeCapacityExceeded

        if self.demote_reason:
            return f"demoted:{self.demote_reason}", None
        total_rows = sum(t.num_rows for t in part_tables)
        if total_rows < int(ctx.config.get(TPU_MESH_MIN_ROWS)):
            return "demoted:small-input", None
        from ballista_tpu_torch.ops.cuda import runtime
        from ballista_tpu_torch.parallel.exchange import make_mesh

        runtime.visible_devices()  # no card, and the CPU not asked for: raise
        try:
            want = int(ctx.config.get(TPU_MESH_DEVICES)) or None
            mesh = make_mesh(want)
        except RuntimeError as e:  # fewer devices than mesh.devices asks for
            return f"demoted:no-mesh({type(e).__name__})", None
        if mesh.devices.size < 2:
            return "demoted:single-device", None
        cap_limit = int(ctx.config.get(TPU_MESH_EXCHANGE_CAPACITY))
        try:
            buckets = self._device_exchange(part_tables, mesh, cap_limit, rec)
            return "mesh", buckets
        except ExchangeCapacityExceeded as e:
            log.warning("mesh exchange capacity overflow: %s", e)
            return "demoted:capacity", None
        except UnsupportedExchangeType as e:
            return f"demoted:dtype:{e}", None

    # -- the host (per-partition) path -----------------------------------

    def _row_hashes(self, tbl: pa.Table) -> np.ndarray:
        from ballista_tpu_torch.ops.hashing import hash_arrays

        if tbl.num_rows == 0:
            return np.zeros(0, dtype=np.uint64)
        batch = tbl.combine_chunks().to_batches()[0]
        bound = [bind_expr(k, self.df_schema) for k in self.keys]
        return hash_arrays([evaluate_to_array(b, batch) for b in bound])

    def _host_split(self, part_tables) -> list[list[pa.RecordBatch]]:
        """ShuffleWriterExec's routing without the files: per producer
        partition, in order, rows split by hash % K — location order and row
        order both match what the reader would have served."""
        k = self.file_partitions
        buckets: list[list[pa.RecordBatch]] = [[] for _ in range(k)]
        for tbl in part_tables:
            if tbl.num_rows == 0:
                continue
            h = self._row_hashes(tbl)
            pids = (h % np.uint64(k)).astype(np.int64)
            batch = tbl.combine_chunks().to_batches()[0]
            for p in range(k):
                sel = np.nonzero(pids == p)[0]
                if len(sel):
                    buckets[p].append(batch.take(pa.array(sel)))
        return buckets

    # -- the device (collective) path ------------------------------------

    def _device_exchange(self, part_tables, mesh, cap_limit, rec) -> list[list[pa.RecordBatch]]:
        from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
        from ballista_tpu_torch.parallel.exchange import (
            hash_exchange_table,
            require_exchange_capacity,
        )

        n = mesh.devices.size
        schema = self.producer.schema()
        combined = pa.concat_tables(part_tables).combine_chunks()
        rows = combined.num_rows
        hashes = self._row_hashes(combined)

        # encode every column to int64 lanes (raises UnsupportedExchangeType
        # before anything touches the device)
        col_lanes: list[list[np.ndarray]] = []
        col_valid: list[np.ndarray | None] = []
        col_meta: list[dict] = []
        for name in combined.column_names:
            lanes, valid, meta = _encode_column(combined.column(name))
            col_lanes.append(lanes)
            col_valid.append(valid)
            col_meta.append(meta)

        # pad to a multiple of the device count; padding rows are dead
        padded = rows + (-rows) % n
        local_rows = padded // n

        def _pad(a: np.ndarray, fill=0) -> np.ndarray:
            if len(a) == padded:
                return a
            out = np.full(padded, fill, dtype=a.dtype)
            out[: len(a)] = a
            return out

        live = _pad(np.ones(rows, dtype=bool), False)
        h_lane = _pad(hashes.view(np.int64))
        rowid = _pad(np.arange(rows, dtype=np.int64))

        # host gate BEFORE dispatch: per-sender shards are the contiguous
        # row ranges the mesh sharding assigns
        shards = [hashes[d * local_rows:(d + 1) * local_rows] for d in range(n)]
        required = require_exchange_capacity(shards, n, cap_limit, prehashed=True)
        cap = max(1, required)

        flat_lanes = [rowid]
        for lanes, valid in zip(col_lanes, col_valid):
            flat_lanes.extend(_pad(l) for l in lanes)
            if valid is not None:
                flat_lanes.append(_pad(valid.astype(np.int64)))

        t0 = time.time()
        h_out, lanes_out, valid_out = hash_exchange_table(
            h_lane, flat_lanes, live, mesh, capacity=cap)
        h_out = np.asarray(h_out)
        lanes_out = [np.asarray(l) for l in lanes_out]
        ok = np.asarray(valid_out)
        RUN_STATS.set("exchange_s", round(time.time() - t0, 4), rec=rec)
        RUN_STATS.set("mesh_devices", n, rec=rec)
        RUN_STATS.set(
            "exchange_bytes_on_device",
            int(ok.sum()) * 8 * (len(flat_lanes) + 1) + int(ok.sum()),
            rec=rec,
        )

        if int(ok.sum()) != rows:
            # the gate above makes this unreachable; never trade silence
            # for speed if it ever regresses
            raise RuntimeError(
                f"mesh exchange lost rows: sent {rows}, received {int(ok.sum())}")

        # decode: valid rows only, restored to global producer row order so
        # bucket contents are byte-identical to the file-shuffle reader
        h_recv = h_out[ok].view(np.uint64)
        recv = [l[ok] for l in lanes_out]
        order = np.argsort(recv[0], kind="stable")  # recv[0] is rowid
        h_recv = h_recv[order]
        recv = [l[order] for l in recv]

        k = self.file_partitions
        pids = (h_recv % np.uint64(k)).astype(np.int64)
        # producer-partition boundaries: split each bucket into one batch
        # per map partition, mirroring the reader's per-location batches
        offsets = np.cumsum([0] + [t.num_rows for t in part_tables])
        map_of_row = np.searchsorted(offsets, recv[0], side="right") - 1

        buckets: list[list[pa.RecordBatch]] = [[] for _ in range(k)]
        n_parts = len(part_tables)
        for p in range(k):
            in_p = pids == p
            for m in range(n_parts):
                sel = np.nonzero(in_p & (map_of_row == m))[0]
                if not len(sel):
                    continue
                arrays = []
                cursor = 1  # lane 0 is rowid
                for field, lanes, valid, meta in zip(
                        schema, col_lanes, col_valid, col_meta):
                    col_recv = [recv[cursor + i][sel] for i in range(len(lanes))]
                    cursor += len(lanes)
                    v = None
                    if valid is not None:
                        v = recv[cursor][sel].astype(bool)
                        cursor += 1
                    arrays.append(_decode_column(field.type, col_recv, v, meta))
                buckets[p].append(pa.RecordBatch.from_arrays(arrays, schema=schema))
        return buckets


def contains_mesh_exchange(plan: ExecutionPlan) -> bool:
    if isinstance(plan, MeshExchangeExec):
        return True
    return any(contains_mesh_exchange(c) for c in plan.children())
