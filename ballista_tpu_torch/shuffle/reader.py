"""Shuffle reader: the leaf of every downstream stage.

Rebuilds ShuffleReaderExec (core/src/execution_plans/shuffle_reader.rs:100):

- local fast path (:818): when the data file is on this host, read it
  directly (sort layout: byte-range via the index file);
- remote fetch (:762): Arrow Flight do_get against the owning executor,
  governed by a semaphore trio — max in-flight requests, max per address,
  in-flight byte budget — with bounded retries; a failed fetch raises
  FetchFailed carrying the map identity so the scheduler can recompute the
  upstream stage (ResultLost);
- broadcast mode (:110): every execute(p) reads ALL upstream partitions
  (build side of a broadcast join).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterator

import pyarrow as pa
import pyarrow.ipc as ipc

from ballista_tpu_torch.config import (
    IO_RETRIES,
    IO_RETRY_WAIT_MS,
    SHUFFLE_BLOCK_TRANSPORT,
    SHUFFLE_CHECKSUM_ENABLED,
    SHUFFLE_FETCH_COALESCE,
    SHUFFLE_MMAP,
    SHUFFLE_READER_FORCE_REMOTE,
    SHUFFLE_READER_MAX_PER_ADDR,
    SHUFFLE_READER_MAX_REQUESTS,
)
from ballista_tpu_torch.errors import DataCorrupted, FetchFailed
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext, _empty_batch
from ballista_tpu_torch.plan.schema import DFSchema
from ballista_tpu_torch.shuffle import paths
from ballista_tpu_torch.shuffle.integrity import INTEGRITY, verify_or_raise
from ballista_tpu_torch.shuffle.types import PartitionLocation
from ballista_tpu_torch.utils.lru import LruDict


# guards the read-add-write of a node's counters across partition threads
_COUNTERS_LOCK = threading.Lock()


class ShuffleReaderExec(ExecutionPlan):
    def __init__(self, df_schema: DFSchema, partition_locations: list[list[PartitionLocation]],
                 broadcast: bool = False):
        super().__init__(df_schema)
        self.partition_locations = partition_locations
        self.broadcast = broadcast

    def children(self):
        return []

    def with_children(self, c):
        assert not c
        return self

    def output_partition_count(self) -> int:
        if self.broadcast:
            # every partition reads everything; expose ONE so consumers
            # (CollectLeft builds) pull the full input exactly once
            return 1
        return max(1, len(self.partition_locations))

    def node_str(self) -> str:
        n = sum(len(l) for l in self.partition_locations)
        b = " broadcast" if self.broadcast else ""
        return f"ShuffleReaderExec: partitions={len(self.partition_locations)} locations={n}{b}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        return self._timed(self._run(partition, ctx))

    def _run(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if self.broadcast:
            locs = [l for part in self.partition_locations for l in part]
        else:
            locs = self.partition_locations[partition] if partition < len(self.partition_locations) else []
        force_remote = bool(ctx.config.get(SHUFFLE_READER_FORCE_REMOTE))
        produced = False
        gov = _governor(ctx)
        ctr = _FetchCounters()
        t0 = time.perf_counter_ns()
        if len(locs) > 1:
            stream = _stream_locations(locs, ctx, force_remote, gov, counters=ctr)
        else:
            stream = (b for loc in locs for b in fetch_partition(
                loc, ctx, force_remote=force_remote, governor=gov, counters=ctr))
        try:
            for b in stream:
                if b.num_rows:
                    if not produced:
                        self.metrics.extra["time_to_first_batch_ns"] = (
                            time.perf_counter_ns() - t0)
                    produced = True
                    yield b
        finally:
            # data-plane accounting for EXPLAIN ANALYZE / the scheduler's
            # task metrics: RPCs issued and bytes moved by provenance,
            # summed over every partition this node executes (C27: a task
            # that reads several partitions kept only the last one's)
            with _COUNTERS_LOCK:
                extra = self.metrics.extra
                for k, v in ctr.snapshot().items():
                    extra[k] = extra.get(k, 0) + v
        if not produced:
            yield _empty_batch(self.schema())


def split_location_ranges(locs: list[PartitionLocation], k: int) -> list[list[PartitionLocation]]:
    """Split one reduce partition's location list into k contiguous,
    byte-balanced sub-ranges — the unit AQE's skew defense hands to each
    partition-slice task.

    Contiguity over the scheduler's canonical (map_partition, path) order
    is the whole point: each slice reads a distinct sub-range of the hot
    partition's map outputs, so concatenating the slices in range order
    reproduces the unsplit read byte-for-byte (cover, no overlap, order —
    the postconditions plan_check's skew rule verifies). The greedy
    boundary walk balances bytes without ever reordering; k is clamped to
    the location count because a single map output is never subdivided."""
    k = max(1, min(int(k), len(locs)))
    if k <= 1:
        return [list(locs)]
    total = sum(max(0, l.stats.num_bytes) for l in locs)
    out: list[list[PartitionLocation]] = []
    cur: list[PartitionLocation] = []
    cur_bytes = 0
    done_bytes = 0
    for i, l in enumerate(locs):
        cur.append(l)
        cur_bytes += max(0, l.stats.num_bytes)
        locs_left = len(locs) - i - 1
        slices_after = k - len(out) - 1  # slices still owed after closing cur
        if slices_after <= 0:
            continue
        ideal = (total - done_bytes) / (slices_after + 1)
        if cur_bytes >= ideal or locs_left == slices_after:
            out.append(cur)
            done_bytes += cur_bytes
            cur, cur_bytes = [], 0
    if cur:
        out.append(cur)
    return out


class UnresolvedShuffleExec(ExecutionPlan):
    """Placeholder leaf: 'stage N's output, not yet materialized'
    (reference: unresolved_shuffle.rs:35). The scheduler swaps it for a
    ShuffleReaderExec when the upstream stage completes."""

    def __init__(self, stage_id: int, df_schema: DFSchema, output_partitions: int,
                 broadcast: bool = False):
        super().__init__(df_schema)
        self.stage_id = stage_id
        self.output_partitions = output_partitions
        self.broadcast = broadcast

    def children(self):
        return []

    def with_children(self, c):
        assert not c
        return self

    def output_partition_count(self) -> int:
        if self.broadcast:
            return 1
        return max(1, self.output_partitions)

    def node_str(self) -> str:
        b = " broadcast" if self.broadcast else ""
        return f"UnresolvedShuffleExec: stage={self.stage_id} out={self.output_partitions}{b}"

    def execute(self, partition: int, ctx: TaskContext):
        raise RuntimeError(f"UnresolvedShuffleExec(stage={self.stage_id}) is not executable")


# -- fetch machinery ---------------------------------------------------------


def _note_corruption(counters: "_FetchCounters | None", retried: bool) -> None:
    """Account one checksum failure (and, when it triggers an in-place
    refetch, one corruption retry) in both the per-execute counters and
    the process-wide INTEGRITY gauges the heartbeat ships."""
    INTEGRITY.add("checksum_failures")
    if counters:
        counters.add("checksum_failures")
    if retried:
        INTEGRITY.add("corruption_retries")
        if counters:
            counters.add("corruption_retries")


class _FetchCounters:
    """Per-execute data-plane accounting, mutated from fetch threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data = {"fetch_rpcs": 0, "bytes_fetched_remote": 0, "bytes_read_local": 0,
                      "checksum_failures": 0, "corruption_retries": 0}

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._data[key] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._data)


class FetchGovernor:
    """Reduce-side flow control (reference's 3-semaphore governor,
    shuffle_reader.rs:778): total request slots + per-address slots + an
    in-flight byte budget (fetches declare their expected size from the
    partition stats; oversized singletons are admitted alone rather than
    deadlocked)."""

    def __init__(self, max_requests: int, max_per_addr: int, max_bytes: int = 256 * 1024 * 1024):
        self.total = threading.Semaphore(max_requests)
        self.per_addr: dict[str, threading.Semaphore] = {}
        self.max_per_addr = max_per_addr
        self.max_bytes = max_bytes
        self.inflight_bytes = 0
        self._lock = threading.Lock()
        self._bytes_free = threading.Condition(self._lock)

    def acquire(self, addr: str, nbytes: int = 0):
        with self._lock:
            sem = self.per_addr.setdefault(addr, threading.Semaphore(self.max_per_addr))
        self.total.acquire()
        sem.acquire()
        nbytes = min(nbytes, self.max_bytes)  # oversized fetches admit alone
        with self._bytes_free:
            # strict notify-driven accounting: every release() notifies under
            # the lock (and runs in a finally), so no timed re-poll is needed
            while self.inflight_bytes > 0 and self.inflight_bytes + nbytes > self.max_bytes:
                self._bytes_free.wait()
            self.inflight_bytes += nbytes
        return (sem, nbytes)

    def release(self, addr: str, token):
        sem, nbytes = token
        with self._bytes_free:
            self.inflight_bytes -= nbytes
            self._bytes_free.notify_all()
        sem.release()
        self.total.release()


_GOV_CACHE = LruDict(max_entries=64)


def _governor(ctx: TaskContext) -> FetchGovernor:
    from ballista_tpu_torch.config import SHUFFLE_READER_MAX_BYTES

    # limits-derived key (id() aliases recycled addresses across configs)
    key = (
        int(ctx.config.get(SHUFFLE_READER_MAX_REQUESTS)),
        int(ctx.config.get(SHUFFLE_READER_MAX_PER_ADDR)),
        int(ctx.config.get(SHUFFLE_READER_MAX_BYTES)),
    )
    g = _GOV_CACHE.get(key)
    if g is not None:
        return g
    # setdefault is atomic: concurrent reduce tasks with the same limits
    # must share one governor or the global budgets mean nothing
    return _GOV_CACHE.setdefault(key, FetchGovernor(*key))


def _fetch_units(locs: list[PartitionLocation], remote: list[int],
                 budget: int, coalesce: bool) -> list[list[int]]:
    """Group remote location indices into fetch units: with coalescing, one
    unit per executor address (split so a unit's byte estimate stays under
    the reader budget) — a reduce task then issues ≈one RPC per executor
    instead of one per map output. Units are ordered by their first location
    index so the scheduler's prefix matches consumption order."""
    if not coalesce:
        return [[i] for i in remote]
    by_addr: dict[str, list[list[int]]] = {}
    for i in remote:
        addr = locs[i].addr
        chunks = by_addr.setdefault(addr, [[]])
        est = min(locs[i].stats.num_bytes, budget)
        cur_est = sum(min(locs[j].stats.num_bytes, budget) for j in chunks[-1])
        if chunks[-1] and cur_est + est > budget:
            chunks.append([])
        chunks[-1].append(i)
    units = [c for chunks in by_addr.values() for c in chunks]
    units.sort(key=lambda u: u[0])
    return units


def _stream_locations(locs: list[PartitionLocation], ctx: TaskContext,
                      force_remote: bool, gov: "FetchGovernor | None",
                      counters: "_FetchCounters | None" = None):
    """Bounded multi-location streaming merge (the reference's concurrent
    reduce-side reader, sort_shuffle/multi_stream_reader.rs).

    Remote locations prefetch concurrently in UNITS — with coalescing on,
    all of one executor's map outputs fetch in a single coalesced RPC —
    while LOCAL locations stream lazily inline when their turn comes (no
    buffering at all). Yield order stays location order, so order-sensitive
    float merges are deterministic. Fetched-but-unconsumed bytes are capped
    by the reader byte budget: a unit's result counts against the window
    until the CONSUMER drains it, and new units are only admitted under the
    cap — except that the unit holding the location the consumer is about
    to block on is always admitted (by-address grouping interleaves units
    with consumption order, so a hard cap could park the needed unit behind
    buffered bytes that can never drain; the budget is a soft bound there,
    like the oversized-singleton admission). Per-location buffering is
    retained — a retry around a half-yielded Flight stream would duplicate
    rows (shuffle_reader.rs:975)."""
    import concurrent.futures as fut
    from ballista_tpu_torch.config import SHUFFLE_READER_MAX_BYTES

    budget = int(ctx.config.get(SHUFFLE_READER_MAX_BYTES))
    remote = [
        i for i, loc in enumerate(locs)
        if force_remote or not (loc.path and os.path.exists(loc.path))
    ]
    remote_set = set(remote)
    if not remote:
        for loc in locs:
            yield from fetch_partition(loc, ctx, force_remote=force_remote,
                                       governor=gov, counters=counters)
        return

    coalesce = (bool(ctx.config.get(SHUFFLE_FETCH_COALESCE))
                and bool(ctx.config.get(SHUFFLE_BLOCK_TRANSPORT)))
    units = _fetch_units(locs, remote, budget, coalesce)
    unit_of = {i: u for u, unit in enumerate(units) for i in unit}

    def est_loc(i: int) -> int:
        return min(locs[i].stats.num_bytes, budget)

    cond = threading.Condition()
    results: dict[int, list | Exception] = {}
    state = {"buffered": 0, "next": 0}

    def publish(i: int, out) -> None:
        with cond:
            results[i] = out
            if not isinstance(out, Exception):
                # replace the stats estimate with actual bytes
                state["buffered"] += sum(b.nbytes for b in out) - est_loc(i)
            cond.notify_all()

    def fetch(i: int) -> None:
        try:
            out: list | Exception = list(
                fetch_partition(locs[i], ctx, force_remote=force_remote,
                                governor=gov, counters=counters))
        except Exception as e:  # noqa: BLE001 — surfaced at the consumer in order
            out = e
        publish(i, out)

    def fetch_unit(unit: list[int]) -> None:
        if len(unit) == 1:
            fetch(unit[0])
            return
        fallback = _fetch_unit_coalesced(unit, locs, ctx, gov, publish, counters)
        for i in fallback:
            fetch(i)

    pool = fut.ThreadPoolExecutor(
        max_workers=min(len(units), int(ctx.config.get(SHUFFLE_READER_MAX_REQUESTS))),
        thread_name_prefix="shuffle-fetch",
    )

    def submit_next_locked() -> None:
        u = state["next"]
        state["buffered"] += sum(est_loc(i) for i in units[u])
        state["next"] += 1
        pool.submit(fetch_unit, units[u])

    def top_up_locked() -> None:
        while state["next"] < len(units):
            est = sum(est_loc(i) for i in units[state["next"]])
            if state["buffered"] > 0 and state["buffered"] + est > budget:
                break
            submit_next_locked()

    try:
        with cond:
            top_up_locked()
        for i, loc in enumerate(locs):
            if i in remote_set:
                with cond:
                    # progress guarantee: the unit this wait depends on (and
                    # every unit before it) must be in flight
                    while state["next"] <= unit_of[i]:
                        submit_next_locked()
                    while i not in results:
                        cond.wait()
                    batches = results.pop(i)
                if isinstance(batches, Exception):
                    raise batches
                yield from batches
                with cond:
                    state["buffered"] -= sum(b.nbytes for b in batches)
                    top_up_locked()
            else:
                # local: stream straight off disk, nothing buffered
                yield from fetch_partition(loc, ctx, force_remote=False,
                                           governor=gov, counters=counters)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _fetch_unit_coalesced(unit: list[int], locs: list[PartitionLocation],
                          ctx: TaskContext, gov: "FetchGovernor | None",
                          publish, counters: "_FetchCounters | None") -> list[int]:
    """Fetch one executor's map outputs in a single coalesced RPC,
    publishing each location's batches as it completes. Retries re-request
    only the incomplete tail (completed locations were already published —
    exactly-once per location). After retries the FetchFailed carries the
    identity of the map output the last stream died on. Returns the indices
    to fall back on per-location (server without the coalesced action)."""
    from ballista_tpu_torch.flight.client import (
        CoalesceUnsupported,
        FetchStreamError,
        fetch_partitions_flight,
    )

    retries = int(ctx.config.get(IO_RETRIES))
    wait_ms = int(ctx.config.get(IO_RETRY_WAIT_MS))
    addr = locs[unit[0]].addr
    remaining = list(unit)
    failed = remaining[0]
    last: BaseException | None = None
    # locations that already burned their one free corruption refetch:
    # a second checksum failure on the same map output is persistent
    # (bad stored bytes), so escalate instead of spinning
    corrupted: set[int] = set()
    attempt = 0
    while attempt <= retries:
        sub = list(remaining)
        token = gov.acquire(addr, sum(locs[i].stats.num_bytes for i in sub)) if gov else None
        corrupt_retry = False
        try:
            if counters:
                counters.add("fetch_rpcs")
            try:
                for j, batches, nbytes in fetch_partitions_flight(
                        [locs[i] for i in sub], ctx):
                    if counters:
                        counters.add("bytes_fetched_remote", sum(b.nbytes for b in batches))
                    publish(sub[j], batches)
                    remaining.remove(sub[j])
                return []
            except CoalesceUnsupported:
                return remaining
            except FetchStreamError as e:
                failed = sub[min(e.loc_index, len(sub) - 1)]
                last = e.cause
                if isinstance(e.cause, DataCorrupted):
                    first = failed not in corrupted
                    _note_corruption(counters, retried=first)
                    if not first:
                        break  # persistent corruption: escalate now
                    corrupted.add(failed)
                    corrupt_retry = True
        finally:
            if gov:
                gov.release(addr, token)
        if corrupt_retry:
            # retry ONCE in place, immediately and without consuming the
            # generic IO budget — in-transit corruption heals on refetch
            continue
        time.sleep(wait_ms * (attempt + 1) / 1000.0)
        attempt += 1
    floc = locs[failed]
    cause = "corruption" if isinstance(last, DataCorrupted) else ""
    err = FetchFailed(floc.executor_id, floc.job_id, floc.stage_id,
                      floc.map_partition, str(last), cause=cause)
    for i in remaining:
        publish(i, err)
    return []


def fetch_partition(loc: PartitionLocation, ctx: TaskContext, force_remote: bool = False,
                    governor: FetchGovernor | None = None,
                    counters: _FetchCounters | None = None) -> Iterator[pa.RecordBatch]:
    local = not force_remote and loc.path and os.path.exists(loc.path)
    if local:
        verify = bool(ctx.config.get(SHUFFLE_CHECKSUM_ENABLED))
        corrupt_seen = False
        while True:
            try:
                served = 0
                for b in read_local_partition(
                        loc, use_mmap=bool(ctx.config.get(SHUFFLE_MMAP)), verify=verify):
                    served += b.nbytes
                    yield b
                if counters:
                    counters.add("bytes_read_local", served)
                return
            except DataCorrupted as e:
                # verification happens BEFORE the first batch decodes, so a
                # retry here cannot duplicate rows. One free re-read (a torn
                # page-cache read can heal); a second failure means the
                # stored bytes are bad — same escalation as a remote fetch,
                # blaming this executor's own disk
                first = not corrupt_seen
                _note_corruption(counters, retried=first)
                if not first:
                    raise FetchFailed(loc.executor_id, loc.job_id, loc.stage_id,
                                      loc.map_partition, str(e), cause="corruption") from e
                corrupt_seen = True
    retries = int(ctx.config.get(IO_RETRIES))
    wait_ms = int(ctx.config.get(IO_RETRY_WAIT_MS))
    addr = loc.addr
    last: Exception | None = None
    corrupt_seen = False
    attempt = 0
    while attempt <= retries:
        token = governor.acquire(addr, loc.stats.num_bytes) if governor else None
        try:
            from ballista_tpu_torch.flight.client import fetch_partition_flight

            if counters:
                counters.add("fetch_rpcs")
            # buffer the WHOLE partition before yielding anything: in
            # decoded (do_get) mode the flight client streams batches
            # incrementally, so a retry around a half-yielded stream would
            # duplicate the first attempt's rows downstream (the
            # reference's fetch_partition_buffered, shuffle_reader.rs:975)
            batches = list(fetch_partition_flight(loc, ctx))
        except DataCorrupted as e:
            last = e
            first = not corrupt_seen
            _note_corruption(counters, retried=first)
            if not first:
                break  # persistent corruption: escalate with blame
            corrupt_seen = True
            continue  # retry ONCE in place — no IO-budget charge, no sleep
        except Exception as e:  # noqa: BLE001 — retried, then surfaced as FetchFailed
            last = e
            time.sleep(wait_ms * (attempt + 1) / 1000.0)
            attempt += 1
            continue
        finally:
            if governor:
                governor.release(addr, token)
        if counters:
            counters.add("bytes_fetched_remote", sum(b.nbytes for b in batches))
        yield from batches
        return
    cause = "corruption" if isinstance(last, DataCorrupted) else ""
    raise FetchFailed(loc.executor_id, loc.job_id, loc.stage_id, loc.map_partition,
                      str(last), cause=cause)


def read_local_partition(loc: PartitionLocation, use_mmap: bool = True,
                         verify: bool = False) -> Iterator[pa.RecordBatch]:
    if verify:
        expected = paths.checksum_for(loc.path, loc.layout, loc.output_partition)
        if expected is not None:
            # buffered (NOT mmap) read: the verified copy is byte-for-byte
            # the copy the decoder consumes — with a live mapping the kernel
            # could re-fault a page from a bad disk between verify and
            # decode. Verification completes BEFORE the first yield, so the
            # caller's retry-once cannot duplicate rows.
            buf = paths.open_range_buffer(loc.path, loc.layout, loc.output_partition,
                                          use_mmap=False)
            if buf is None or buf.size == 0:
                return
            verify_or_raise([buf], expected, f"{loc.path}#p{loc.output_partition}")
            yield from ipc.open_stream(pa.BufferReader(buf))
            return
    if not use_mmap and not paths.is_sort_layout(loc.layout):
        # hash layout without mmap: stream straight off the open file
        with open(loc.path, "rb") as f:
            yield from ipc.open_stream(f)
        return
    # zero-copy: batches decode directly out of the page cache; the buffer
    # keeps the mapping alive for exactly as long as any batch references it
    buf = paths.open_range_buffer(loc.path, loc.layout, loc.output_partition,
                                  use_mmap=use_mmap)
    if buf is None or buf.size == 0:
        return
    yield from ipc.open_stream(pa.BufferReader(buf))
