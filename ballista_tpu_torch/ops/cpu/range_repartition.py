"""Runtime-statistics pipeline for dynamic range repartitioning.

Rebuild of the reference's distributed-sort trio
(core/src/execution_plans/{runtime_stats,buffer,unordered_range_repartition}.rs):

- RuntimeStatsExec: passthrough tap — per-partition row counts + a T-Digest
  sketch over the first sort key; snapshot readable mid-stream.
- BufferExec: flow-control dam — buffers input up to a byte budget before
  releasing, giving the stats tap time to observe data before routing
  decisions downstream.
- UnorderedRangeRepartitionExec: on first demand walks its subtree for the
  sibling RuntimeStatsExec, takes K-1 quantile cuts from the merged digest,
  and routes rows into K range buckets. Bucket i's values all sort before
  bucket i+1's, so per-bucket sorts concatenate into a total order without
  a merge (the distributed ORDER BY pattern).
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.phys_expr import bind_expr, evaluate_to_array
from ballista_tpu_torch.plan.expressions import Expr, SortKey
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext, _empty_batch
from ballista_tpu_torch.utils.tdigest import TDigest


def _as_float(arr: pa.Array) -> np.ndarray:
    t = arr.type
    if pa.types.is_date(t):
        arr = arr.cast(pa.int32())
    return arr.cast(pa.float64(), safe=False).to_numpy(zero_copy_only=False)


def _is_string_key(t: pa.DataType) -> bool:
    return (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_dictionary(t))


def _key_values(arr: pa.Array) -> np.ndarray:
    """Sort-key values for digesting/routing: float64 for orderable numeric
    and temporal types; object-dtype strings (lexicographic, NULL → "")
    for string keys — a T-Digest cannot hold strings, but exact
    quantile-position cuts over the dammed batches can."""
    if _is_string_key(arr.type):
        if pa.types.is_dictionary(arr.type):
            arr = arr.cast(arr.type.value_type)
        vals = arr.to_numpy(zero_copy_only=False)
        if arr.null_count:
            vals = np.array(["" if v is None else v for v in vals], dtype=object)
        return vals
    return _as_float(arr)


class RuntimeStatsExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, sort_expr: Optional[Expr] = None):
        super().__init__(input.df_schema)
        self.input = input
        self.sort_expr = sort_expr
        self._lock = threading.Lock()
        self.row_counts: dict[int, int] = {}
        self.digest = TDigest()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return RuntimeStatsExec(c[0], self.sort_expr)

    def node_str(self) -> str:
        s = f" sketch({self.sort_expr})" if self.sort_expr is not None else ""
        return f"RuntimeStatsExec:{s}"

    def snapshot(self) -> tuple[int, TDigest]:
        with self._lock:
            d = TDigest.from_list(self.digest.to_list())
            return sum(self.row_counts.values()), d

    def execute(self, partition: int, ctx: TaskContext):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        bound = bind_expr(self.sort_expr, self.df_schema) if self.sort_expr is not None else None
        for b in self.input.execute(partition, ctx):
            if b.num_rows:
                with self._lock:
                    self.row_counts[partition] = self.row_counts.get(partition, 0) + b.num_rows
                    if bound is not None:
                        vals = evaluate_to_array(bound, b)
                        # string keys can't be digested; the router computes
                        # exact positional cuts from the dammed batches
                        if not _is_string_key(vals.type):
                            self.digest.add_array(_as_float(vals))
            yield b


class BufferExec(ExecutionPlan):
    """Buffer-then-release dam (buffer.rs:125)."""

    def __init__(self, input: ExecutionPlan, max_bytes: int = 64 * 1024 * 1024):
        super().__init__(input.df_schema)
        self.input = input
        self.max_bytes = max_bytes

    def children(self):
        return [self.input]

    def with_children(self, c):
        return BufferExec(c[0], self.max_bytes)

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _run(self, partition, ctx):
        held: list[pa.RecordBatch] = []
        held_bytes = 0
        it = self.input.execute(partition, ctx)
        for b in it:
            held.append(b)
            held_bytes += b.nbytes
            if held_bytes > self.max_bytes:
                break
        yield from held
        yield from it


def retarget_routers(plan: ExecutionPlan, n: int) -> ExecutionPlan:
    """Rebuild every UnorderedRangeRepartitionExec in `plan` with `n`
    buckets. INVARIANT shared by all AQE rewrites that change a stage's
    task slate (reader coalescing, fan-out shrink): a passthrough task
    drains exactly its own router bucket, so the router's bucket count
    must equal the stage's task count or buckets >= that count are routed
    but never read (silent row loss)."""
    kids = plan.children()
    new_kids = [retarget_routers(c, n) for c in kids]
    if any(a is not b for a, b in zip(new_kids, kids)):
        plan = plan.with_children(new_kids)
    if isinstance(plan, UnorderedRangeRepartitionExec) and plan.n != n:
        plan = UnorderedRangeRepartitionExec(plan.input, plan.key, n)
    return plan


class UnorderedRangeRepartitionExec(ExecutionPlan):
    """Quantile-cut range router (unordered_range_repartition.rs:107)."""

    def __init__(self, input: ExecutionPlan, key: SortKey, n: int):
        super().__init__(input.df_schema)
        self.input = input
        self.key = key
        self.n = n
        self._lock = threading.Lock()
        self._cache: list[list[pa.RecordBatch]] | None = None

    def children(self):
        return [self.input]

    def with_children(self, c):
        return UnorderedRangeRepartitionExec(c[0], self.key, self.n)

    def output_partition_count(self) -> int:
        return self.n

    def node_str(self) -> str:
        return f"UnorderedRangeRepartitionExec: key={self.key}, n={self.n}"

    def _find_stats(self) -> RuntimeStatsExec | None:
        def walk(node):
            if isinstance(node, RuntimeStatsExec):
                return node
            for c in node.children():
                r = walk(c)
                if r is not None:
                    return r
            return None

        return walk(self.input)

    def execute(self, partition, ctx):
        return self._timed(self._run(partition, ctx))

    def _materialize(self, ctx):
        with self._lock:
            if self._cache is not None:
                return self._cache
            outs: list[list[pa.RecordBatch]] = [[] for _ in range(self.n)]
            bound = bind_expr(self.key.expr, self.input.df_schema)
            pending: list[pa.RecordBatch] = []
            # drain the input fully (the dam upstream bounds memory growth
            # before stats stabilize), then cut on the observed digest
            for p in range(self.input.output_partition_count()):
                pending.extend(b for b in self.input.execute(p, ctx) if b.num_rows)
            stats = self._find_stats()
            string_key = bool(pending) and _is_string_key(
                evaluate_to_array(bound, pending[0]).type)
            keyed: list[tuple] = []
            if string_key:
                # evaluate + convert each batch's key ONCE, reused for cuts
                # and routing (object-array conversion is Python-speed);
                # cuts are exact positional quantiles over the NON-NULL
                # values — nulls reroute to an end bucket below, and
                # counting them here would collapse leading cuts to "" and
                # starve buckets. The numeric path stays lazy-per-batch
                # (no up-front float copies of the whole pending set).
                keyed = [(b, evaluate_to_array(bound, b)) for b in pending]
                key_vals = [_key_values(arr) for _, arr in keyed]
                nn = [v[~np.asarray(arr.is_null())] if arr.null_count else v
                      for (_, arr), v in zip(keyed, key_vals)]
                svals = np.sort(np.concatenate(nn)) if nn else np.zeros(0, dtype=object)
                cuts = [svals[min(len(svals) - 1, (len(svals) * i) // self.n)]
                        for i in range(1, self.n)] if len(svals) else []
                routed = zip(keyed, key_vals)
            elif stats is not None and stats.digest.count > 0:
                # cuts come from the tap's digest: route lazily per batch,
                # no up-front float copy of the whole pending set
                cuts = stats.digest.quantile_cuts(self.n)

                def lazy():
                    for b in pending:
                        arr = evaluate_to_array(bound, b)
                        yield (b, arr), _as_float(arr)

                routed = lazy()
            else:
                # no digest: the cuts need every value anyway — evaluate
                # each batch ONCE and reuse the arrays for routing
                keyed = [(b, evaluate_to_array(bound, b)) for b in pending]
                key_vals = [_as_float(arr) for _, arr in keyed]
                vals = np.concatenate(key_vals) if key_vals else np.zeros(0)
                d = TDigest()
                d.add_array(vals)
                cuts = d.quantile_cuts(self.n) if len(vals) else []
                routed = zip(keyed, key_vals)
            cuts_arr = np.array(cuts, dtype=object if string_key else None)
            for (b, arr), v in routed:
                bucket = np.searchsorted(cuts_arr, v, side="right") if cuts else np.zeros(len(v), dtype=int)
                if not self.key.ascending:
                    bucket = (self.n - 1) - bucket
                if arr.null_count:
                    # concatenated-range order must equal the sort's null
                    # placement: nulls to the first or last FINAL bucket
                    nulls = np.asarray(arr.is_null())
                    bucket = np.where(
                        nulls, 0 if self.key.nulls_first else self.n - 1, bucket)
                for k in np.unique(bucket):
                    sel = np.nonzero(bucket == k)[0]
                    outs[int(k)].append(b.take(pa.array(sel)))
            self._cache = outs
            return outs

    def _run(self, partition, ctx):
        outs = self._materialize(ctx)
        if not outs[partition]:
            yield _empty_batch(self.schema())
            return
        yield from outs[partition]
