"""Incremental materialized views: delta-maintained serving results.

PR 8's result cache invalidates on every table-version bump, so an
append-heavy dashboard workload pays a full distributed recompute per
refresh. This module turns "invalidate on bump" into "maintain on bump":

- `DeltaRegistry`: the scheduler's retained append sets. `ctx.append`
  bumps the table's version AND retains the delta batches under that
  version; memory is bounded by the shared `LruDict` byte accounting —
  crossing the `ballista.ingest.*` budgets folds the oldest deltas into
  parquet spool parts (they are table content, never droppable), so
  memory cannot grow with append rate.
- `analyze_plan`: the merge-eligibility ladder. A cached plan template is
  incrementally maintainable when it is the standard two-phase aggregate
  (partial → hash exchange → final) over distributive/algebraic
  accumulators (SUM/COUNT/COUNT(*)/MIN/MAX; AVG arrives pre-decomposed as
  SUM÷COUNT) sourced from named scans — one table, or one inner equi-join
  of two tables (delta-join: Δ(A⋈B) = ΔA⋈B when only A appended). Plain
  filter/project trees maintain by concatenation ("append" mode).
  Everything else records a fallback reason (`incremental_mode` /
  `incremental_reason` in serving stats) and recomputes.
  SUM over floating accumulators is ineligible ("float-sum"): grouped
  float sums are not bit-stable under re-association, and maintained
  results must be byte-equivalent to a from-scratch execution. Exact
  types (ints, decimal128 — the TPC-H path) maintain; MIN/MAX/COUNT
  maintain for any type.
- graft transformers: planning contexts stay base-only; every dispatch
  path stamps scans at bind time. `graft_append_scans` unions a named
  scan with its folded parts + retained deltas (full current view);
  `graft_delta_scan` replaces a table's scan with ONLY its new deltas
  (the delta query of a maintained refresh).
- `split_finisher` / `render_finisher` / `build_maintain_plan`: a
  maintained refresh dispatches partial-aggregate work over the deltas,
  unions the cached accumulator state into the exchange, and re-merges
  through the template's own final aggregate — the dispatched plan is an
  ordinary two-phase stage DAG, so AQE and plan verification see a valid
  shape. The finisher (projection/HAVING/sort/limit) renders on the
  scheduler over the merged state, which is small by construction.
- `SubscriptionRegistry`: continuous queries. A prepared statement
  subscribes to its tables' versions and re-executes (incrementally when
  eligible) on every bump, pushing fresh results over a bounded
  freshest-wins queue.

See docs/streaming.md for the eligibility matrix and operational notes.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from dataclasses import dataclass, field

import pyarrow as pa

from ballista_tpu_torch.config import (
    INGEST_COMPACTION_DIR,
    INGEST_DELTA_RETAIN_BYTES,
    INGEST_DELTA_RETAIN_VERSIONS,
    BallistaConfig,
)
from ballista_tpu_torch.plan.physical import (
    CoalesceBatchesExec,
    CoalescePartitionsExec,
    FilterExec,
    GlobalLimitExec,
    HashAggregateExec,
    HashJoinExec,
    LocalLimitExec,
    MemoryScanExec,
    ParquetScanExec,
    ProjectionExec,
    RepartitionExec,
    SortExec,
    SortPreservingMergeExec,
    TaskContext,
    UnionExec,
)
from ballista_tpu_torch.utils.lru import LruDict

log = logging.getLogger(__name__)

# aggregate accumulators that merge by re-applying the final-phase merge
# function (sum-of-sums, min-of-mins, ...); welford triples merge
# nonlinearly over floats and count_distinct needs the dedup relation
MAINTAINABLE_FUNCS = {"sum", "count", "count_all", "min", "max"}

# single-child nodes allowed ABOVE the final aggregate (rendered on the
# scheduler over the merged state)
_FINISHER_NODES = (
    ProjectionExec, FilterExec, SortExec, SortPreservingMergeExec,
    GlobalLimitExec, LocalLimitExec, CoalescePartitionsExec,
    CoalesceBatchesExec, RepartitionExec,
)

# stateless row-wise nodes: results maintain by concatenating the delta
# query's rows onto the cached result (sorts/limits change membership
# or order under appends and fall back)
_APPEND_NODES = (
    ProjectionExec, FilterExec, CoalesceBatchesExec,
    CoalescePartitionsExec, RepartitionExec,
)

# wrappers that may sit between the partial aggregate and its scans
_SOURCE_WRAPPERS = (
    ProjectionExec, FilterExec, CoalesceBatchesExec, RepartitionExec,
)


# ---------------------------------------------------------------------------
# retained delta sets
# ---------------------------------------------------------------------------


@dataclass
class DeltaView:
    """One table's current overlay: folded parquet parts (oldest appends,
    compacted to disk) + still-in-memory batches in version order."""

    folded_files: list[str]
    batches: list[pa.RecordBatch]


class _TableDeltas:
    def __init__(self):
        self.versions: list[int] = []  # unfolded retained versions, ascending
        self.folded_files: list[str] = []
        self.folded_through = 0  # highest version folded into the base view


class DeltaRegistry:
    """Per-table retained append sets, bounded by the shared `LruDict`
    byte accounting. Deltas are the only copy of appended rows, so the
    budget is enforced by FOLDING the oldest versions into parquet spool
    parts (compaction), never by dropping. A maintained refresh that
    reaches past the fold horizon falls back with reason
    "delta-compacted"; the folded parts still serve every full read
    through the append graft."""

    def __init__(self, config: BallistaConfig | None = None):
        cfg = config or BallistaConfig()
        self.retain_bytes = int(cfg.get(INGEST_DELTA_RETAIN_BYTES))
        self.retain_versions = int(cfg.get(INGEST_DELTA_RETAIN_VERSIONS))
        self._spool = str(cfg.get(INGEST_COMPACTION_DIR) or "")
        # max_bytes stays 0: LruDict auto-eviction would DROP table content;
        # _enforce folds against retain_bytes using the same byte accounting
        self.retained: LruDict = LruDict(
            1 << 20, sizer=lambda bs: int(sum(b.nbytes for b in bs)))
        self._lock = threading.RLock()
        self._tables: dict[str, _TableDeltas] = {}
        self._fold_order: list[tuple[str, int]] = []  # arrival order
        self.appends = 0
        self.appended_rows = 0
        self.appended_bytes = 0
        self.folded_versions = 0
        self.folded_bytes = 0
        self.resets = 0

    def configure(self, cfg: BallistaConfig) -> None:
        """Adopt the appending session's retention budgets: the registry is
        scheduler-wide but the `ballista.ingest.*` knobs travel per-session
        (there is no global scheduler config), so each append re-reads
        them — last writer wins, matching every other session-scoped knob."""
        with self._lock:
            self.retain_bytes = int(cfg.get(INGEST_DELTA_RETAIN_BYTES))
            self.retain_versions = int(cfg.get(INGEST_DELTA_RETAIN_VERSIONS))
            spool = str(cfg.get(INGEST_COMPACTION_DIR) or "")
            if spool:
                self._spool = spool

    def spool_dir(self) -> str:
        with self._lock:
            if not self._spool:
                import tempfile

                self._spool = tempfile.mkdtemp(prefix="ballista-ingest-")
            os.makedirs(self._spool, exist_ok=True)
            return self._spool

    def empty(self) -> bool:
        with self._lock:
            return not self._tables

    def tables_with_deltas(self) -> set[str]:
        with self._lock:
            return {t for t, td in self._tables.items()
                    if td.versions or td.folded_files}

    def append(self, table: str, version: int, batches: list[pa.RecordBatch]) -> None:
        table = table.lower()
        with self._lock:
            td = self._tables.setdefault(table, _TableDeltas())
            td.versions.append(version)
            self._fold_order.append((table, version))
            self.appends += 1
            self.appended_rows += sum(b.num_rows for b in batches)
            self.appended_bytes += sum(b.nbytes for b in batches)
        self.retained[(table, version)] = list(batches)
        self._enforce()

    def reset(self, table: str) -> None:
        """Catalog re-registration/DDL: the table has a new lineage, so its
        retained deltas and folded parts no longer apply."""
        table = table.lower()
        with self._lock:
            td = self._tables.pop(table, None)
            if td is None:
                return
            for v in td.versions:
                self.retained.pop((table, v))
            self._fold_order = [(t, v) for t, v in self._fold_order if t != table]
            self.resets += 1

    def range(self, table: str, after: int, upto: int):
        """The delta batches for versions (after, upto], or (None, reason)
        when a maintained refresh cannot be served from memory."""
        table = table.lower()
        with self._lock:
            td = self._tables.get(table)
            if td is None:
                return None, "delta-unavailable"
            if td.folded_through > after:
                return None, "delta-compacted"
            have = set(td.versions)
        need = list(range(after + 1, upto + 1))
        if not set(need) <= have:
            # a version bumped without a retained delta (DDL raced in)
            return None, "delta-unavailable"
        out: list[pa.RecordBatch] = []
        for v in need:
            got = self.retained.get((table, v))
            if got is None:
                return None, "delta-evicted"
            out.extend(got)
        return out, ""

    def view(self) -> dict[str, DeltaView]:
        """Point-in-time overlay per table with any retained content —
        what the append graft unions into named scans."""
        with self._lock:
            items = [(t, list(td.folded_files), list(td.versions))
                     for t, td in self._tables.items()]
        out: dict[str, DeltaView] = {}
        for t, files, versions in items:
            batches: list[pa.RecordBatch] = []
            for v in versions:
                got = self.retained.get((t, v))
                if got:
                    batches.extend(got)
            if files or batches:
                out[t] = DeltaView(files, batches)
        return out

    def _enforce(self) -> None:
        """Fold oldest-first while over the byte budget or a table is over
        its version cap. Folding is the ONLY eviction: rows move to disk,
        never away."""
        while True:
            with self._lock:
                over = self.retain_bytes > 0 and self.retained.nbytes() > self.retain_bytes
                crowded = [t for t, td in self._tables.items()
                           if len(td.versions) > self.retain_versions]
                if crowded:
                    t = crowded[0]
                    v = self._tables[t].versions[0]
                elif over and self._fold_order:
                    t, v = self._fold_order[0]
                else:
                    return
            self._fold(t, v)

    def _fold(self, table: str, version: int) -> None:
        import pyarrow.parquet as pq

        batches = self.retained.pop((table, version))
        path = ""
        nbytes = 0
        if batches:
            path = os.path.join(self.spool_dir(), f"{table}-v{version}.parquet")
            tbl = pa.Table.from_batches(batches, batches[0].schema)
            pq.write_table(tbl, path)
            nbytes = int(tbl.nbytes)
        with self._lock:
            td = self._tables.get(table)
            if td is not None:
                if version in td.versions:
                    td.versions.remove(version)
                if path:
                    td.folded_files.append(path)
                td.folded_through = max(td.folded_through, version)
            if (table, version) in self._fold_order:
                self._fold_order.remove((table, version))
            self.folded_versions += 1
            self.folded_bytes += nbytes

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tables": len(self._tables),
                "retained_versions": len(self._fold_order),
                "retained_bytes": self.retained.nbytes(),
                "appends": self.appends,
                "appended_rows": self.appended_rows,
                "appended_bytes": self.appended_bytes,
                "folded_versions": self.folded_versions,
                "folded_bytes": self.folded_bytes,
                "resets": self.resets,
            }


# ---------------------------------------------------------------------------
# merge-eligibility ladder
# ---------------------------------------------------------------------------


@dataclass
class IncrementalDecision:
    mode: str  # "aggregate" | "append" | "none"
    reason: str = ""
    tables: tuple[str, ...] = ()


def _analyze_source(node):
    """Validate the subtree feeding the partial aggregate: named scans
    under stateless wrappers, at most one inner equi-join of two distinct
    tables. Returns (tables, reason)."""
    if isinstance(node, ParquetScanExec):
        if not node.table_name:
            return None, "unnamed-scan"
        return (node.table_name.lower(),), ""
    if isinstance(node, _SOURCE_WRAPPERS):
        return _analyze_source(node.children()[0])
    if isinstance(node, HashJoinExec):
        if node.join_type != "inner":
            # appends can flip null-extended rows of outer joins
            return None, f"join-{node.join_type}"
        lt, lr = _analyze_source(node.left)
        if lt is None:
            return None, lr
        rt, rr = _analyze_source(node.right)
        if rt is None:
            return None, rr
        if len(lt) > 1 or len(rt) > 1:
            return None, "multi-join"
        if set(lt) & set(rt):
            return None, "self-join"
        return lt + rt, ""
    if isinstance(node, MemoryScanExec):
        return None, "memory-table"
    return None, f"source-{type(node).__name__}"


def analyze_plan(physical) -> IncrementalDecision:
    """Classify a plan template: "aggregate" (delta partials merge into
    cached accumulator state), "append" (delta rows concatenate onto the
    cached result), or "none" with the fallback reason."""
    node = physical
    while isinstance(node, _FINISHER_NODES):
        node = node.children()[0]
    if isinstance(node, HashAggregateExec):
        if node.mode != "final":
            return IncrementalDecision("none", "single-phase-aggregate")
        merged = node.input
        if not isinstance(merged, (RepartitionExec, CoalescePartitionsExec)):
            return IncrementalDecision("none", "no-exchange")
        partial = merged.input
        if not (isinstance(partial, HashAggregateExec) and partial.mode == "partial"):
            return IncrementalDecision("none", "no-partial-phase")
        n_group = len(partial.group_exprs)
        for i, d in enumerate(partial.aggs):
            if d.func not in MAINTAINABLE_FUNCS:
                return IncrementalDecision("none", f"aggregate-{d.func}")
            acc = partial.df_schema.fields[n_group + i]
            if d.func == "sum" and pa.types.is_floating(acc.dtype):
                # float sums are not bit-stable under re-association;
                # byte-equivalence to full recompute would not hold
                return IncrementalDecision("none", "float-sum")
        tables, why = _analyze_source(partial.input)
        if tables is None:
            return IncrementalDecision("none", why)
        return IncrementalDecision("aggregate", "", tables)
    node = physical
    while isinstance(node, _APPEND_NODES):
        node = node.children()[0]
    if isinstance(node, ParquetScanExec) and node.table_name:
        return IncrementalDecision("append", "", (node.table_name.lower(),))
    return IncrementalDecision("none", f"shape-{type(node).__name__}")


def decide(template) -> IncrementalDecision:
    """Analyze once per template; the decision is recorded on the entry
    (`incremental_mode`/`incremental_reason`) so fallbacks are diagnosable
    from the serving snapshot."""
    if template.incremental_mode is None:
        d = analyze_plan(template.physical)
        template.incremental_mode = d.mode
        template.incremental_reason = d.reason
        template.incremental_tables = d.tables
    return IncrementalDecision(template.incremental_mode,
                               template.incremental_reason,
                               getattr(template, "incremental_tables", ()))


# ---------------------------------------------------------------------------
# scan grafts (bind-time delta stamping)
# ---------------------------------------------------------------------------


def _delta_leg(scan: ParquetScanExec, batches: list[pa.RecordBatch]):
    """A memory-scan stand-in for `scan` over delta batches. Full-schema
    batches align (select + cast) to the scan's projected schema by name;
    the scan's pushed-down predicates re-apply as a FilterExec."""
    from ballista_tpu_torch.plan.expressions import and_

    leg = MemoryScanExec(scan.df_schema, list(batches), 1)
    if scan.filters:
        return FilterExec(leg, and_(*scan.filters))
    return leg


def graft_append_scans(physical, views: dict[str, DeltaView]):
    """Union every named base scan with its table's folded parquet parts
    and retained in-memory deltas. Planning contexts stay base-only; this
    runs at dispatch time on every path, so full executions always reflect
    the current table versions."""

    def rec(node):
        if isinstance(node, ParquetScanExec):
            view = views.get(node.table_name.lower()) if node.table_name else None
            if view is None:
                return node
            legs = [node]
            if view.folded_files:
                part = {"files": [{"file": f, "row_groups": None}
                                  for f in view.folded_files]}
                legs.append(ParquetScanExec(
                    node.df_schema, [part], list(node.projection),
                    list(node.filters), node.table_name))
            if view.batches:
                legs.append(_delta_leg(node, view.batches))
            if len(legs) == 1:
                return node
            return UnionExec(legs, node.df_schema)
        kids = node.children()
        if not kids:
            return node
        return node.with_children([rec(c) for c in kids])

    return rec(physical)


def graft_delta_scan(physical, table: str, batches: list[pa.RecordBatch]):
    """Replace `table`'s scan with ONLY its new delta batches — the delta
    query of a maintained refresh. Other tables' scans are untouched (the
    caller augments them to their full current view)."""
    table = table.lower()

    def rec(node):
        if isinstance(node, ParquetScanExec) and node.table_name.lower() == table:
            return _delta_leg(node, batches)
        kids = node.children()
        if not kids:
            return node
        return node.with_children([rec(c) for c in kids])

    return rec(physical)


# ---------------------------------------------------------------------------
# state split / maintain plan / finisher render
# ---------------------------------------------------------------------------


def split_finisher(bound):
    """Split a bound aggregate plan at the final HashAggregateExec:
    returns (final_node, finisher_chain root→just-above-final). Only
    valid after `analyze_plan` said "aggregate"."""
    chain = []
    node = bound
    while not (isinstance(node, HashAggregateExec) and node.mode == "final"):
        chain.append(node)
        node = node.children()[0]
    return node, chain


def build_maintain_plan(bound, table: str, delta_batches, state_batches):
    """The maintained refresh: delta rows flow through the template's own
    partial aggregate, union with the cached accumulator state, and
    re-merge through the template's exchange + final aggregate. The
    result is an ordinary two-phase stage DAG (AQE/plan verification see
    a valid shape); the finisher renders separately over the merged
    state. The state leg bypasses the partial phase — its rows are
    already accumulators, and COUNT partials would re-count them."""
    final, _chain = split_finisher(bound)
    merged = final.input  # RepartitionExec(hash) | CoalescePartitionsExec
    partial = merged.input  # HashAggregateExec(partial)
    delta_sub = graft_delta_scan(partial, table, delta_batches)
    state_leg = MemoryScanExec(partial.df_schema, list(state_batches), 1)
    union = UnionExec([delta_sub, state_leg], partial.df_schema)
    return final.with_children([merged.with_children([union])])


def render_finisher(chain, final_node, state_batches, config) -> pa.Table:
    """Rebuild the finisher chain over an in-memory scan of the merged
    accumulator state and execute it locally — grouped state is small by
    construction, and rendering on the scheduler keeps the dispatched
    job a pure state computation."""
    node = MemoryScanExec(final_node.df_schema, list(state_batches), 1)
    for parent in reversed(chain):
        node = parent.with_children([node])
    ctx = TaskContext(config)
    batches: list[pa.RecordBatch] = []
    for p in range(node.output_partition_count()):
        batches.extend(b for b in node.execute(p, ctx) if b.num_rows)
    schema = node.schema()
    if not batches:
        return pa.table({f.name: pa.array([], f.type) for f in schema},
                        schema=schema)
    return pa.Table.from_batches(batches, schema=schema)


# ---------------------------------------------------------------------------
# continuous queries
# ---------------------------------------------------------------------------


class Subscription:
    """One continuous query: a prepared statement + bound params that
    re-executes on every bump of its tables. Results push into a bounded
    freshest-wins queue; refreshes coalesce (a bump during a refresh
    marks it dirty and re-runs once, not once per bump)."""

    def __init__(self, sub_id: str, statement_id: str, params, session_id: str,
                 maxsize: int, inline: bool):
        self.sub_id = sub_id
        self.statement_id = statement_id
        self.params = params
        self.session_id = session_id
        self.inline = inline
        self.tables: tuple[str, ...] = ()
        self.queue: "queue.Queue[dict]" = queue.Queue(max(1, int(maxsize)))
        self.pushed = 0
        self.dropped = 0
        self.errors = 0
        self.closed = False
        self._lock = threading.Lock()
        self._inflight = False
        self._dirty = False

    def offer(self, status: dict) -> None:
        with self._lock:
            self.pushed += 1
        while True:
            try:
                self.queue.put_nowait(status)
                return
            except queue.Full:
                try:
                    self.queue.get_nowait()
                    with self._lock:
                        self.dropped += 1  # freshest-wins: oldest falls out
                except queue.Empty:
                    pass

    def note_error(self, err: str) -> None:
        with self._lock:
            self.errors += 1
        self.offer({"state": "failed", "error": err,
                    "subscription_id": self.sub_id})

    def begin_refresh(self) -> bool:
        """True when the caller should run the refresh; a refresh already
        in flight absorbs the bump as a dirty mark instead."""
        with self._lock:
            if self.closed:
                return False
            if self._inflight:
                self._dirty = True
                return False
            self._inflight = True
            return True

    def end_refresh(self) -> bool:
        """True when bumps arrived mid-refresh and the caller should run
        one more round."""
        with self._lock:
            if self._dirty and not self.closed:
                self._dirty = False
                return True
            self._inflight = False
            return False


class SubscriptionRegistry:
    """Continuous-query registry: statement subscriptions indexed by the
    tables their plan scans, so a version bump fans out to exactly the
    affected subscribers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, Subscription] = {}
        self._seq = 0
        # lifetime totals survive unsubscribe (a closed sub's counters fold
        # in here so /api/state keeps the history)
        self._pushed = 0
        self._dropped = 0
        self._errors = 0

    def register(self, statement_id: str, params, session_id: str,
                 tables: tuple[str, ...], maxsize: int,
                 inline: bool) -> Subscription:
        with self._lock:
            self._seq += 1
            sub_id = f"sub-{self._seq}"
            sub = Subscription(sub_id, statement_id, params, session_id,
                               maxsize, inline)
            sub.tables = tuple(t.lower() for t in tables)
            self._subs[sub_id] = sub
            return sub

    def bind_tables(self, sub: Subscription, tables: tuple[str, ...]) -> None:
        with self._lock:
            sub.tables = tuple(t.lower() for t in tables)

    def remove(self, sub_id: str) -> None:
        with self._lock:
            sub = self._subs.pop(sub_id, None)
            if sub is not None:
                sub.closed = True
                self._pushed += sub.pushed
                self._dropped += sub.dropped
                self._errors += sub.errors

    def get(self, sub_id: str):
        with self._lock:
            return self._subs.get(sub_id)

    def for_table(self, table: str) -> list[Subscription]:
        table = table.lower()
        with self._lock:
            return [s for s in self._subs.values()
                    if not s.tables or table in s.tables]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active": len(self._subs),
                "pushed": self._pushed + sum(s.pushed for s in self._subs.values()),
                "dropped": self._dropped + sum(s.dropped for s in self._subs.values()),
                "errors": self._errors + sum(s.errors for s in self._subs.values()),
            }
