"""Mesh-wide stage execution: the on-device form of a hash exchange.

In the reference, the distributed planner's mesh post-pass
(scheduler/planner.py merge_mesh_stages) fuses a hash-shuffle producer
stage into its single consumer: the producer's ShuffleWriterExec(hash K)
and the consumer's reader collapse into one `MeshExchangeExec` node inside
ONE stage, and the whole stage ships as ONE task spanning every partition;
its exchange runs as an on-device all_to_all over a device mesh.

That device exchange is not ported to the CUDA engine yet (ROADMAP A6), and
the port's planner refuses the mesh with the device engine. What is here is
what the plan codec, the task builder, AQE and the execution graph name:
the plan node, the int64-lane column codecs, `contains_mesh_exchange`, and
the host split, which serves an exchange that AQE demoted
(`demote_reason`): the same `hash_arrays % K` routing the
ShuffleWriterExec applies, minus the files. Bucket p holds exactly the rows
whose key hashes to p, in producer row order. A node that was not demoted
raises rather than running its exchange somewhere other than the cards.
"""

from __future__ import annotations

import logging
import threading
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


def _encode_column(arr: pa.Array) -> tuple[list[np.ndarray], np.ndarray | None, dict]:
    """Arrow column -> (int64 lanes, validity bool[n] or None, decode meta).

    Every supported type round-trips EXACTLY: ints/dates widen to int64,
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
    if pa.types.is_integer(t) or pa.types.is_boolean(t) or pa.types.is_date(t) \
            or pa.types.is_timestamp(t):
        lane_t = pa.int64()
        filled = arr.fill_null(0) if arr.null_count else arr
        lane = np.asarray(filled.cast(lane_t)).astype(np.int64)
        return [lane], valid, {"kind": "int"}
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
        from ballista_tpu_torch.errors import PlanningError
        from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS

        if not self.demote_reason:
            raise PlanningError(
                "MeshExchangeExec: the device exchange is not ported to the "
                "CUDA engine yet (ROADMAP A6)")
        part_tables: list[pa.Table] = []
        schema = self.producer.schema()
        for p in range(self.producer.output_partition_count()):
            batches = [b for b in self.producer.execute(p, ctx) if b.num_rows]
            part_tables.append(
                pa.Table.from_batches(batches, schema=schema) if batches
                else pa.table({f.name: pa.array([], f.type) for f in schema}, schema=schema)
            )

        with RUN_STATS.run("mesh_exchange") as rec:
            log.info("mesh exchange demoted to per-partition host split: %s",
                     self.demote_reason)
            buckets = self._host_split(part_tables)
            RUN_STATS.set("mesh_mode_reason", f"demoted:{self.demote_reason}", rec=rec)
        return buckets

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


def contains_mesh_exchange(plan: ExecutionPlan) -> bool:
    if isinstance(plan, MeshExchangeExec):
        return True
    return any(contains_mesh_exchange(c) for c in plan.children())
