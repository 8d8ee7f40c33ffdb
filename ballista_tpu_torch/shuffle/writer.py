"""Shuffle writers: the root operator of every intermediate stage.

ShuffleWriterExec rebuilds the reference's two writers behind one node:

- hash layout (ShuffleWriterExec, shuffle_writer.rs:305): rows routed by
  the engine-wide key hash into K output files per map task — used for
  passthrough/collapse stages (K=0 → one output mirroring the input
  partition) and small fan-outs.
- sort layout (SortShuffleWriterExec, sort_shuffle/writer.rs:179): one
  consolidated data file per map task containing K buckets sorted by
  output partition + an index file; buffered per-bucket batches spill to
  disk when `ballista.shuffle.sort.memory.limit` is exceeded and are
  merged at finish (2×M files instead of N×M).

execute(map_partition) drives the child and yields ONE metadata batch
(output_partition, path, rows, bytes, layout) — the same
results-as-metadata-batches contract the reference uses to report
ShuffleWritePartition summaries (execution_engine.rs:304).

On-device partitioning: when the child pipeline ran on the TPU engine the
hash is computed with the jax twin of ops/hashing.py; host and device
partitions are bit-identical so readers never care who wrote a file.
"""

from __future__ import annotations

import io
import os
import json
import uuid
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

from ballista_tpu_torch.config import (
    SHUFFLE_CHECKSUM_ENABLED,
    SHUFFLE_COMPRESSION_CODEC,
    SORT_SHUFFLE_MEMORY_LIMIT,
)
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.executor import disk
from ballista_tpu_torch.executor.chaos import maybe_disk_full
from ballista_tpu_torch.shuffle.integrity import ChecksumSink
from ballista_tpu_torch.ops.hashing import partition_indices
from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
from ballista_tpu_torch.plan.expressions import Expr
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext, _empty_batch
from ballista_tpu_torch.plan.schema import DFField, DFSchema
from ballista_tpu_torch.shuffle import paths
from ballista_tpu_torch.shuffle.types import PartitionStats


METADATA_SCHEMA = DFSchema(
    [
        DFField("output_partition", pa.int32(), False),
        DFField("path", pa.string(), False),
        DFField("num_rows", pa.int64(), False),
        DFField("num_batches", pa.int64(), False),
        DFField("num_bytes", pa.int64(), False),
        DFField("layout", pa.string(), False),
    ]
)


def _unlink_quiet(*ps: str) -> None:
    for p in ps:
        try:
            os.remove(p)
        except OSError:
            pass


def _checksum_on(ctx: TaskContext) -> bool:
    return bool(ctx.config.get(SHUFFLE_CHECKSUM_ENABLED))


def _write_crc_sidecar(data_path: str, digest: str | None) -> None:
    """Commit a hash-layout file's checksum sidecar (tmp + atomic rename,
    same discipline as the data file it describes). A None digest (knob
    off) writes nothing — absence means 'unchecked' to every reader."""
    if not digest:
        return
    cp = paths.crc_path(data_path)
    try:
        with open(cp + ".tmp", "w") as f:
            f.write(digest)
    except BaseException:
        _unlink_quiet(cp + ".tmp")
        raise
    os.replace(cp + ".tmp", cp)


def _codec(ctx: TaskContext) -> Optional[str]:
    c = str(ctx.config.get(SHUFFLE_COMPRESSION_CODEC))
    return None if c == "none" else c


def _ipc_options(ctx: TaskContext) -> ipc.IpcWriteOptions:
    return ipc.IpcWriteOptions(compression=_codec(ctx))


def write_ipc_stream(batches: list[pa.RecordBatch], schema: pa.Schema, sink, ctx: TaskContext) -> tuple[int, int]:
    """Write batches as one IPC stream; returns (rows, bytes_written)."""
    start = sink.tell()
    rows = 0
    with ipc.new_stream(sink, schema, options=_ipc_options(ctx)) as w:
        for b in batches:
            if b.num_rows:
                w.write_batch(b)
                rows += b.num_rows
    return rows, sink.tell() - start


class ShuffleWriterExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, job_id: str, stage_id: int,
                 output_partitions: int, keys: list[Expr] | None,
                 sort_shuffle: bool = True):
        super().__init__(METADATA_SCHEMA)
        self.input = input
        self.job_id = job_id
        self.stage_id = stage_id
        self.output_partitions = output_partitions  # 0 = passthrough
        self.keys = keys or []
        self.sort_shuffle = sort_shuffle and output_partitions > 0

    def children(self):
        return [self.input]

    def with_children(self, c):
        return ShuffleWriterExec(
            c[0], self.job_id, self.stage_id, self.output_partitions, self.keys, self.sort_shuffle
        )

    def output_partition_count(self) -> int:
        return self.input.output_partition_count()

    def input_schema(self) -> pa.Schema:
        return self.input.schema()

    def node_str(self) -> str:
        k = f" keys=[{', '.join(str(e) for e in self.keys)}]" if self.keys else ""
        mode = "sort" if self.sort_shuffle else "hash"
        return (
            f"ShuffleWriterExec: {self.job_id}/{self.stage_id} "
            f"out={self.output_partitions or 'passthrough'} layout={mode}{k}"
        )

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(iter([self._write(partition, ctx)]))

    # ------------------------------------------------------------------

    def _write(self, map_partition: int, ctx: TaskContext) -> pa.RecordBatch:
        if not ctx.work_dir:
            raise ExecutionError("shuffle writer needs a work_dir in TaskContext")
        task_id = ctx.task_id or f"{map_partition}-{uuid.uuid4().hex[:6]}"
        schema = self.input.schema()

        if self.output_partitions <= 0:
            # passthrough: stage collapse / preserved partitioning.
            # tmp + atomic rename: a task killed mid-write (deadline, cancel,
            # crash) must never leave a truncated file under the final name
            path = paths.hash_data_path(ctx.work_dir, self.job_id, self.stage_id, map_partition, task_id)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            maybe_disk_full(ctx.config, self.job_id, self.stage_id, map_partition,
                            ctx.task_attempt, "shuffle passthrough write")
            try:
                with open(path + ".tmp", "wb") as f:
                    sink = ChecksumSink(f, enabled=_checksum_on(ctx))
                    rows = 0
                    batches = 0
                    with ipc.new_stream(sink, schema, options=_ipc_options(ctx)) as w:
                        for b in self.input.execute(map_partition, ctx):
                            if b.num_rows:
                                w.write_batch(b)
                                rows += b.num_rows
                                batches += 1
                    nbytes = f.tell()
            except OSError as e:
                _unlink_quiet(path + ".tmp")
                typed = disk.wrap_enospc(e, f"shuffle write {self.job_id}/{self.stage_id}/{map_partition}")
                if typed is not None:
                    raise typed from e
                raise
            except BaseException:
                # an attempt killed mid-write (cancel, deadline, crash) must
                # not leave its .tmp around — it will never be renamed
                _unlink_quiet(path + ".tmp")
                raise
            _write_crc_sidecar(path, sink.digest())
            os.replace(path + ".tmp", path)
            return self._meta([(map_partition, path, rows, batches, nbytes, "hash")])

        bound = [bind_expr(k, self.input.df_schema) for k in self.keys]
        K = self.output_partitions
        buckets: list[list[pa.RecordBatch]] = [[] for _ in range(K)]
        bucket_rows = [0] * K
        bucket_batches = [0] * K
        buffered = 0
        spills: list[list[str]] = [[] for _ in range(K)]
        limit = int(ctx.config.get(SORT_SHUFFLE_MEMORY_LIMIT)) if self.sort_shuffle else 0
        # session-shared pool (try_grow semantics): when present, buffering
        # reserves against the SESSION's budget — concurrent tasks share it,
        # so idle tasks lend headroom to a heavy sort and a refusal means
        # "spill first" (the reference's per-session RuntimeEnv MemoryPool,
        # runtime_cache.rs:59)
        pool = ctx.memory_pool if self.sort_shuffle else None
        pool_held = 0

        def spill_largest() -> bool:
            nonlocal buffered, pool_held
            # low-watermark shed: spills are the OPTIONAL disk writes, so
            # they stop first under disk pressure. Returning False pushes
            # the caller onto the memory-overcommit ladder (grow_wait)
            # instead of filling the last of the disk.
            if not disk.spill_allowed(ctx.config, ctx.work_dir):
                return False
            k = max(range(K), key=lambda i: sum(b.nbytes for b in buckets[i]))
            if not buckets[k]:
                return False
            maybe_disk_full(ctx.config, self.job_id, self.stage_id, map_partition,
                            ctx.task_attempt, "sort-shuffle spill")
            sp = paths.sort_data_path(ctx.work_dir, self.job_id, self.stage_id, map_partition, task_id) + f".spill{len(spills[k])}.{k}"
            os.makedirs(os.path.dirname(sp), exist_ok=True)
            try:
                with open(sp, "wb") as f:
                    _, sp_bytes = write_ipc_stream(buckets[k], schema, f, ctx)
            except OSError as e:
                _unlink_quiet(sp)
                typed = disk.wrap_enospc(e, f"sort-shuffle spill {self.job_id}/{self.stage_id}/{map_partition}")
                if typed is not None:
                    raise typed from e
                raise
            spills[k].append(sp)
            freed = sum(b.nbytes for b in buckets[k])
            buffered -= freed
            # SpillManager-style accounting (sort_shuffle/spill.rs:46,110):
            # cumulative spilled volume surfaces in EXPLAIN ANALYZE metrics
            self.metrics.extra["spilled_bytes"] = (
                self.metrics.extra.get("spilled_bytes", 0) + sp_bytes)
            self.metrics.extra["spill_count"] = self.metrics.extra.get("spill_count", 0) + 1
            if pool is not None:
                pool.shrink(min(freed, pool_held))
                pool_held -= min(freed, pool_held)
            buckets[k] = []
            return True

        def reserve(nbytes: int) -> None:
            nonlocal pool_held
            if pool is None:
                return
            while not pool.try_grow(nbytes):
                if not spill_largest():
                    # nothing of ours left to spill: BLOCK with a deadline
                    # for peer tasks of this session to shrink (their next
                    # refusal makes them spill); only a deadline pass takes
                    # the headroom unaccounted — bounded liveness instead of
                    # the old unconditional grow()
                    from ballista_tpu_torch.config import SORT_SHUFFLE_POOL_WAIT_S

                    wait_s = float(ctx.config.get(SORT_SHUFFLE_POOL_WAIT_S))
                    if not pool.grow_wait(nbytes, timeout_s=wait_s):
                        import logging

                        logging.getLogger(__name__).warning(
                            "memory pool overcommitted by %d bytes after %.1fs "
                            "wait (session under real pressure)", nbytes, wait_s)
                    break
            pool_held += nbytes

        from ballista_tpu_torch.executor.chaos import skew_params, skew_remap_pids
        from ballista_tpu_torch.ops.hashing import hash_arrays, split_batch_by_partition

        skew = skew_params(ctx.config)
        try:
            for b in self.input.execute(map_partition, ctx):
                if b.num_rows == 0:
                    continue
                pids = None
                if getattr(self, "device_routed", False) and "__pid" in b.schema.names:
                    if skew is not None and bound:
                        # chaos skew reroutes by the row's KEY HASH, but the
                        # device only shipped final partition ids. Recompute
                        # the keys on the host (the jax hash is a bit-exact
                        # twin) so every writer of this exchange — host- or
                        # device-hashed — remaps the same rows.
                        key_arrays = [evaluate_to_array(kb, b) for kb in bound]
                        b = b.select([n for n in b.schema.names if n != "__pid"])
                    else:
                        # device-side routing: the TPU stage already hashed
                        # rows to partitions (bit-exact twin); consume and
                        # drop the column. Gated on the engine-set flag so a
                        # user column named __pid is never misinterpreted.
                        i = b.schema.get_field_index("__pid")
                        pids = b.column(i).to_numpy(zero_copy_only=False).astype(np.uint64)
                        b = b.select([n for n in b.schema.names if n != "__pid"])
                        key_arrays = []
                else:
                    key_arrays = [evaluate_to_array(kb, b) for kb in bound]
                if skew is not None and key_arrays:
                    pids = skew_remap_pids(hash_arrays(key_arrays), K, *skew)
                for k, part in split_batch_by_partition(b, key_arrays, K, precomputed_pids=pids):
                    reserve(part.nbytes)
                    buckets[k].append(part)
                    bucket_rows[k] += part.num_rows
                    bucket_batches[k] += 1
                    buffered += part.nbytes
                while limit and buffered > limit:
                    if not spill_largest():
                        break

            if self.sort_shuffle:
                return self._finish_sort(map_partition, task_id, schema, buckets, spills, bucket_rows, bucket_batches, ctx)
            return self._finish_hash(map_partition, task_id, schema, buckets, bucket_rows, bucket_batches, ctx)
        except BaseException:
            # consolidation removes spills as it streams them; an aborted
            # attempt has to sweep up whatever it spilled itself
            _unlink_quiet(*(sp for ks in spills for sp in ks))
            raise
        finally:
            if pool is not None and pool_held:
                pool.shrink(pool_held)

    def _finish_hash(self, map_partition, task_id, schema, buckets, rows, batches, ctx):
        """Drain the K bucket files CONCURRENTLY (the reference's K
        concurrent per-output drain tasks, shuffle_writer.rs:214-303):
        Arrow's IPC write releases the GIL for compression + IO, so the
        drains genuinely overlap."""
        import concurrent.futures as fut

        live = [k for k in range(len(buckets)) if rows[k]]
        if not live:
            return self._meta([])
        maybe_disk_full(ctx.config, self.job_id, self.stage_id, map_partition,
                        ctx.task_attempt, "hash-shuffle commit")

        def drain(k: int):
            path = paths.hash_data_path(ctx.work_dir, self.job_id, self.stage_id, k, task_id)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(path + ".tmp", "wb") as f:
                    sink = ChecksumSink(f, enabled=_checksum_on(ctx))
                    _, nbytes = write_ipc_stream(buckets[k], schema, sink, ctx)
            except OSError as e:
                _unlink_quiet(path + ".tmp")
                typed = disk.wrap_enospc(e, f"shuffle write {self.job_id}/{self.stage_id}/{k}")
                if typed is not None:
                    raise typed from e
                raise
            except BaseException:
                _unlink_quiet(path + ".tmp")
                raise
            _write_crc_sidecar(path, sink.digest())
            os.replace(path + ".tmp", path)
            return (k, path, rows[k], batches[k], nbytes, "hash")

        if len(live) == 1:
            return self._meta([drain(live[0])])
        with fut.ThreadPoolExecutor(max_workers=min(len(live), 8),
                                    thread_name_prefix="shuffle-drain") as pool:
            out = list(pool.map(drain, live))
        return self._meta(out)

    @staticmethod
    def _iter_bucket_batches(in_memory: list, spill_files: list[str]):
        """Stream a bucket's batches: in-memory first, then each spill file
        decoded ONE BATCH AT A TIME. Consolidation must never rebuffer what
        it spilled — that would peak at exactly the memory the spill
        existed to avoid (sort_shuffle/spill.rs:46 streams the same way)."""
        for b in in_memory:
            yield b
        for sp in spill_files:
            with open(sp, "rb") as sf:
                yield from ipc.open_stream(sf)
            os.remove(sp)

    def _finish_sort(self, map_partition, task_id, schema, buckets, spills, rows, batches, ctx):
        """Consolidate buckets (memory + spills) into one data file + index.

        The data file name is attempt-unique (task_id baked in) and both
        files commit via tmp + atomic rename, data BEFORE index: duplicate
        attempts of the same map partition (speculation) each produce a
        complete private file set, and whichever status reaches the
        scheduler first decides which set readers ever see."""
        data_path = paths.sort_data_path(ctx.work_dir, self.job_id, self.stage_id, map_partition, task_id)
        os.makedirs(os.path.dirname(data_path), exist_ok=True)
        maybe_disk_full(ctx.config, self.job_id, self.stage_id, map_partition,
                        ctx.task_attempt, "sort-shuffle commit")
        index: dict[str, list] = {}
        out = []
        idx_path = paths.index_path(data_path)
        try:
            with open(data_path + ".tmp", "wb") as f:
                sink = ChecksumSink(f, enabled=_checksum_on(ctx))
                for k in range(len(buckets)):
                    if not rows[k]:
                        continue
                    start = f.tell()
                    nrows = 0
                    # per-RANGE checksum: each bucket's byte range is the unit
                    # readers fetch and verify, so the digest resets here
                    sink.start_range()
                    with ipc.new_stream(sink, schema, options=_ipc_options(ctx)) as w:
                        for b in self._iter_bucket_batches(buckets[k], spills[k]):
                            if b.num_rows:
                                w.write_batch(b)
                                nrows += b.num_rows
                    length = f.tell() - start
                    crc = sink.digest()
                    entry: list = [start, length, nrows, length]
                    if crc:
                        entry.append(crc)
                    index[str(k)] = entry
                    out.append((k, data_path, nrows, batches[k], length, "sort"))
            os.replace(data_path + ".tmp", data_path)
            with open(idx_path + ".tmp", "w") as f:
                json.dump(index, f)
        except OSError as e:
            _unlink_quiet(data_path + ".tmp", idx_path + ".tmp")
            typed = disk.wrap_enospc(e, f"sort-shuffle commit {self.job_id}/{self.stage_id}/{map_partition}")
            if typed is not None:
                raise typed from e
            raise
        except BaseException:
            _unlink_quiet(data_path + ".tmp", idx_path + ".tmp")
            raise
        os.replace(idx_path + ".tmp", idx_path)
        return self._meta(out)

    def _meta(self, rows: list[tuple]) -> pa.RecordBatch:
        schema = self.schema()
        if not rows:
            return _empty_batch(schema)
        cols = list(zip(*rows))
        arrays = [
            pa.array(cols[0], pa.int32()),
            pa.array(cols[1], pa.string()),
            pa.array([int(x) for x in cols[2]], pa.int64()),
            pa.array([int(x) for x in cols[3]], pa.int64()),
            pa.array([int(x) for x in cols[4]], pa.int64()),
            pa.array(cols[5], pa.string()),
        ]
        return pa.RecordBatch.from_arrays(arrays, schema=schema)


def metadata_to_locations(batch: pa.RecordBatch, job_id: str, stage_id: int,
                          map_partition: int, executor_id: str, host: str, flight_port: int):
    """Convert a writer metadata batch into PartitionLocations
    (reference: drive_shuffle_writer_stage → ShuffleWritePartition,
    execution_engine.rs:304; zero-byte sentinels dropped :336)."""
    from ballista_tpu_torch.shuffle.types import PartitionLocation, PartitionStats

    out = []
    for i in range(batch.num_rows):
        if batch.column(2)[i].as_py() == 0:
            continue
        out.append(
            PartitionLocation(
                map_partition=map_partition,
                job_id=job_id,
                stage_id=stage_id,
                output_partition=batch.column(0)[i].as_py(),
                executor_id=executor_id,
                host=host,
                flight_port=flight_port,
                path=batch.column(1)[i].as_py(),
                layout=batch.column(5)[i].as_py(),
                stats=PartitionStats(
                    num_rows=batch.column(2)[i].as_py(),
                    num_batches=batch.column(3)[i].as_py(),
                    num_bytes=batch.column(4)[i].as_py(),
                ),
            )
        )
    return out
