"""ServingTier: the scheduler's caches for high-QPS repeated queries.

Three layers, all bounded by the thread-safe `LruDict` (entry caps plus a
byte budget for results, env-tunable through the `ballista.serving.*`
knobs) and all evictable in one call when memory-pressure shedding wants
the headroom back:

- L1 text cache: exact SQL text + config fingerprint → (plan key, bound
  values). A hit skips parsing AND optimization.
- L2 plan cache: plan key → `PlanTemplate` (a physical tree with tagged
  literal slots). A hit skips physical planning; same shape with
  different literals maps to the same entry.
- result cache: (plan key, values, table versions) → result table.
  Table versions bump on every catalog re-registration or DDL, so a
  re-registered table orphans its cached results without scanning them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ballista_tpu_torch.config import (
    SERVING_INCREMENTAL_STATE_BYTES,
    SERVING_INCREMENTAL_STATE_ENTRIES,
    SERVING_PLAN_CACHE_ENTRIES,
    SERVING_RESULT_CACHE_BYTES,
    SERVING_RESULT_CACHE_ENTRIES,
    SERVING_RESULT_MAX_BYTES,
    BallistaConfig,
)
from ballista_tpu_torch.utils.lru import LruDict
from ballista_tpu_torch.plan.physical import ExecutionPlan


@dataclass
class PlanTemplate:
    """One cached physical-plan template: the tagged tree plus everything
    needed to bind, admit, and invalidate executions of its shape."""

    key: str
    physical: ExecutionPlan  # literals carry param slot tags; never executed as-is
    type_tags: tuple[str, ...]
    values: tuple  # the values it was planned with (exact-repeat fallback)
    tables: tuple[str, ...]
    bindable: bool  # every slot survived into the physical tree
    single_stage: bool | None = None  # learned at first stage planning
    hits: int = 0
    # merge-eligibility decision, analyzed once per template by
    # serving/incremental.py: "aggregate" | "append" | "none" (+ reason),
    # surfaced in the serving snapshot so fallbacks are diagnosable
    incremental_mode: str | None = None
    incremental_reason: str = ""
    incremental_tables: tuple[str, ...] = ()

    def accepts(self, values: tuple) -> bool:
        """A non-bindable template (the physical planner consumed a slot)
        can only serve the exact values it was planned with."""
        if len(values) != len(self.type_tags):
            return False
        return self.bindable or values == self.values


@dataclass
class PreparedStatement:
    """Server-side prepared statement: sql text kept for template
    re-creation after an eviction, plus the slot signature clients bind."""

    statement_id: str
    sql: str
    session_id: str
    key: str
    type_tags: tuple[str, ...]
    default_values: tuple  # the literals the statement was prepared with
    created_at: float = field(default_factory=time.time)


class _TableVersions:
    """Monotonic per-table counters; absent tables are version 0. Bumped
    on catalog changes so result-cache keys referencing the old data stop
    matching (invalidation by orphaning, never by scanning)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._versions: dict[str, int] = {}
        self.bumps = 0

    def bump(self, table: str) -> int:
        """Returns the new version — append ingestion retains each delta
        set under the version its bump produced."""
        with self._lock:
            v = self._versions.get(table, 0) + 1
            self._versions[table] = v
            self.bumps += 1
            return v

    def vector(self, tables: tuple[str, ...]) -> tuple:
        with self._lock:
            return tuple((t, self._versions.get(t, 0)) for t in tables)


@dataclass
class StateEntry:
    """Cached maintenance state for one (template, values) pair: the
    accumulator table of an aggregate (pre-finisher) or the full result
    of an append-mode plan, tagged with the table-version vector it
    reflects. A maintained refresh merges only the delta versions between
    `vector` and the current one."""

    vector: tuple  # ((table, version), ...) in template-table order
    table: object  # pa.Table — accumulator rows or append-mode result
    kind: str  # "aggregate" | "append"


class ServingTier:
    """Process-wide serving caches for one scheduler. Enablement is
    checked per submission from the session config; the tier itself is
    sized once from defaults + env escape hatches."""

    def __init__(self, config: BallistaConfig | None = None):
        cfg = config or BallistaConfig()
        plan_entries = int(cfg.get(SERVING_PLAN_CACHE_ENTRIES))
        self.plan_cache: LruDict = LruDict(plan_entries)
        # exact-text hits are cheap to store and skip the parser entirely;
        # give them headroom over the template cache they point into
        self.text_cache: LruDict = LruDict(plan_entries * 4)
        self.result_cache: LruDict = LruDict(
            int(cfg.get(SERVING_RESULT_CACHE_ENTRIES)),
            max_bytes=int(cfg.get(SERVING_RESULT_CACHE_BYTES)),
            sizer=lambda t: int(t.nbytes),
        )
        self.result_max_bytes = int(cfg.get(SERVING_RESULT_MAX_BYTES))
        # maintenance state: (plan key, values) → StateEntry. Unlike the
        # result cache it is NOT version-keyed — an entry at an older
        # vector is exactly what a maintained refresh merges deltas into.
        self.state_cache: LruDict = LruDict(
            int(cfg.get(SERVING_INCREMENTAL_STATE_ENTRIES)),
            max_bytes=int(cfg.get(SERVING_INCREMENTAL_STATE_BYTES)),
            sizer=lambda e: int(e.table.nbytes),
        )
        self.table_versions = _TableVersions()
        self.prepared: dict[str, PreparedStatement] = {}
        self._lock = threading.Lock()
        self.plan_hits = 0
        self.plan_misses = 0
        self.text_hits = 0
        self.result_hits = 0
        self.result_misses = 0
        self.fast_lane_executed = 0
        self.fast_lane_fallbacks = 0
        self.uncacheable = 0
        self.cleared = 0
        self.maintained = 0
        self.bootstraps = 0
        self.state_renders = 0
        self.recomputes = 0
        self.recompute_reasons: dict[str, int] = {}
        self.appends = 0
        self.appended_rows = 0

    # -- text (L1) ---------------------------------------------------------

    def lookup_text(self, sql: str, cfg_fp: str):
        """Exact-text hit: (key, values) if both the text mapping and its
        plan template are still resident, else None."""
        got = self.text_cache.get((sql, cfg_fp))
        if got is None:
            return None
        key, values = got
        template = self.plan_cache.get(key)
        if template is None or not template.accepts(values):
            return None
        with self._lock:
            # a text hit implies a plan hit: both layers were skipped
            self.text_hits += 1
            self.plan_hits += 1
        return key, values, template

    def remember_text(self, sql: str, cfg_fp: str, key: str, values: tuple) -> None:
        self.text_cache[(sql, cfg_fp)] = (key, values)

    # -- templates (L2) ----------------------------------------------------

    def lookup_template(self, key: str, values: tuple) -> PlanTemplate | None:
        template = self.plan_cache.get(key)
        if template is None or not template.accepts(values):
            with self._lock:
                self.plan_misses += 1
            return None
        with self._lock:
            self.plan_hits += 1
            template.hits += 1
        return template

    def store_template(self, template: PlanTemplate) -> None:
        self.plan_cache[template.key] = template

    def note_uncacheable(self) -> None:
        with self._lock:
            self.uncacheable += 1

    def note_fast_lane(self, outcome: str) -> None:
        with self._lock:
            if outcome == "executed":
                self.fast_lane_executed += 1
            else:
                self.fast_lane_fallbacks += 1

    # -- results -----------------------------------------------------------

    def result_key(self, key: str, values: tuple, tables: tuple[str, ...]):
        return (key, values, self.table_versions.vector(tables))

    def lookup_result(self, rkey):
        tbl = self.result_cache.get(rkey)
        with self._lock:
            if tbl is None:
                self.result_misses += 1
            else:
                self.result_hits += 1
        return tbl

    def store_result(self, rkey, table) -> None:
        if int(table.nbytes) > self.result_max_bytes:
            return
        self.result_cache[rkey] = table

    # -- incremental maintenance state ---------------------------------------

    def lookup_state(self, key: str, values: tuple) -> StateEntry | None:
        return self.state_cache.get((key, values))

    def store_state(self, key: str, values: tuple, entry: StateEntry) -> None:
        self.state_cache[(key, values)] = entry

    def note_incremental(self, outcome: str, reason: str = "") -> None:
        """Record a refresh decision: "maintained" (delta merge),
        "bootstrap" (first state computation), "state_render" (result
        rebuilt from current state, no job), "recompute" (+ reason)."""
        with self._lock:
            if outcome == "maintained":
                self.maintained += 1
            elif outcome == "bootstrap":
                self.bootstraps += 1
            elif outcome == "state_render":
                self.state_renders += 1
            else:
                self.recomputes += 1
                if reason:
                    self.recompute_reasons[reason] = (
                        self.recompute_reasons.get(reason, 0) + 1)

    def note_append(self, rows: int) -> None:
        with self._lock:
            self.appends += 1
            self.appended_rows += int(rows)

    # -- prepared statements -----------------------------------------------

    def register_prepared(self, stmt: PreparedStatement) -> None:
        with self._lock:
            self.prepared[stmt.statement_id] = stmt

    def get_prepared(self, statement_id: str) -> PreparedStatement | None:
        with self._lock:
            return self.prepared.get(statement_id)

    def close_prepared(self, statement_id: str) -> None:
        with self._lock:
            self.prepared.pop(statement_id, None)

    # -- pressure / introspection -------------------------------------------

    def clear(self) -> None:
        """Drop every cached plan and result (memory-pressure eviction
        path; prepared statements keep their sql and re-template lazily)."""
        self.plan_cache.clear()
        self.text_cache.clear()
        self.result_cache.clear()
        self.state_cache.clear()
        with self._lock:
            self.cleared += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "plan_cache": {
                    "hits": self.plan_hits,
                    "misses": self.plan_misses,
                    "text_hits": self.text_hits,
                    "entries": len(self.plan_cache),
                    "evictions": self.plan_cache.evictions,
                    "uncacheable": self.uncacheable,
                },
                "result_cache": {
                    "hits": self.result_hits,
                    "misses": self.result_misses,
                    "entries": len(self.result_cache),
                    "nbytes": self.result_cache.nbytes(),
                    "evictions": self.result_cache.evictions,
                    "invalidations": self.table_versions.bumps,
                },
                "fast_lane": {
                    "executed": self.fast_lane_executed,
                    "fallbacks": self.fast_lane_fallbacks,
                },
                "incremental": {
                    "maintained": self.maintained,
                    "bootstraps": self.bootstraps,
                    "state_renders": self.state_renders,
                    "recomputes": self.recomputes,
                    "recompute_reasons": dict(self.recompute_reasons),
                    "state_entries": len(self.state_cache),
                    "state_nbytes": self.state_cache.nbytes(),
                    "state_evictions": self.state_cache.evictions,
                    "appends": self.appends,
                    "appended_rows": self.appended_rows,
                    "modes": {
                        key: {"mode": t.incremental_mode or "unanalyzed",
                              "reason": t.incremental_reason}
                        for key, t in self.plan_cache.items()
                    },
                },
                "prepared_statements": len(self.prepared),
                "cleared": self.cleared,
            }
