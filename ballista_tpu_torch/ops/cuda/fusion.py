"""Whole-stage fusion planning for the device stage compiler.

Copied from the JAX package's ops/tpu/fusion.py. The one change: the
platform that earns the hand-written-kernel rung (`fused_pallas`, the
mode name kept as in the JAX package) is "cuda" where it was "tpu".

Three pieces, all pure host-side logic:

- `plan_spans`: walk a stage's operator chain and group it into fusible
  SPANS — predicate (scan filters + FilterExec + join match masks),
  project (ProjectionExec rebinding), probe (HashJoinExec lookup+gather),
  aggregate (the partial agg). Consecutive ops of the same span kind
  merge; the span list is what `fused_spans` counts and what the staged
  path materializes one HBM intermediate per.
- `estimate_stage`: derive a `StageEstimate` from compile-time facts only
  (DeviceTable encode metadata + prepared BuildTables + the plan), so the
  estimate is computable from a spec table during compile/fill overlap:
  rows, group-domain cardinality (product of pow2 dictionary sizes, None
  when unbounded), expansion-lane count, aggregate-through-join shape,
  operator mix, agg function set.
- `CostModel.choose`: pick `staged` / `fused_xla` / `fused_pallas` for a
  stage. The choice is a REQUEST: `_compile` clamps it to what the stage
  actually supports (the fallback ladder — fused_pallas degrades to
  fused_xla at trace time, staged-ineligible stages compile fused) and
  RUN_STATS `fusion_mode` reports what ran.

Decision rules (auto mode):
  forced mode knob          → that mode (still clamped by the compiler)
  fusion disabled           → staged (per-span sub-kernels, the
                              always-available fallback)
  legacy pallas knob        → fused_pallas when kernel-eligible
  rows < fusion.min.rows
    and staged-eligible     → staged (dispatch overhead is noise; span
                              timings feed the roofline taps)
  pallas-eligible on a real
    TPU backend             → fused_pallas
  otherwise                 → fused_xla (one jitted kernel, intermediates
                              fused by XLA)

Pallas eligibility = grouped aggregation over a bounded code domain
(1 < G ≤ pallas.max.groups), single expansion lane, no
aggregate-through-join weights, and only sum/count/count_all aggregates
(the kernel accumulates f32 sums + i32 counts). `fused_pallas` is never
auto-picked on CPU backends: the interpreter-mode kernel is for test
parity, not speed.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def _pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


PREDICATE = "predicate"
PROJECT = "project"
PROBE = "probe"
AGGREGATE = "aggregate"
SORT = "sort"
WINDOW = "window"
TOPK = "topk"


@dataclass
class Span:
    """One fusible span of the operator chain."""

    kind: str  # predicate | project | probe | aggregate
    ops: int = 1  # plan nodes merged into this span


@dataclass
class StageEstimate:
    """Compile-time stage facts feeding the cost model (derivable from a
    spec DeviceTable, so the decision can run during compile/fill
    overlap)."""

    rows: int  # total input rows across partitions
    partitions: int
    group_domain: int | None  # product of pow2 dict sizes; None = unbounded
    n_group_keys: int
    lanes: int  # expansion-join lane product (1 = no dup unroll)
    has_mult: bool  # aggregate-through-join weight path active
    n_filters: int
    n_projections: int
    n_joins: int
    max_probe_table: int  # largest direct build table (entries), 0 if none
    agg_funcs: tuple = ()
    spans: list = field(default_factory=list)
    # HBM working-set bytes (admission inputs for the out-of-core planner).
    # table_bytes reproduces DeviceTable.nbytes exactly — data stacks +
    # validity planes + row mask, all [P, N] — so it is computable from a
    # spec table before the uploads drain. dict_bytes prices the string
    # LUTs the stage uploads per dictionary column (the undercount this
    # field fixes: codes were budgeted, their dictionaries were not).
    table_bytes: int = 0
    dict_bytes: int = 0
    build_bytes: int = 0  # all join build sides, device layout
    max_build_bytes: int = 0  # largest single build (the grace-split target)
    max_build_jidx: int = -1  # its join index, -1 when no builds
    # ORDER BY / window family (estimate_sort_stage): key count, padded
    # lane width (pow2 for the bitonic network), LIMIT fetch, window
    # function count. Zero everywhere for aggregate stages.
    sort_keys: int = 0
    sort_lanes: int = 0
    topk_k: int = 0
    window_funcs: int = 0


@dataclass
class FusionDecision:
    mode: str  # staged | fused_xla | fused_pallas
    reason: str


def plan_spans(n_scan_filters: int, ops, agg, *, sort_keys: int = 0,
               fetch=None, window_funcs: int = 0) -> list[Span]:
    """Group the stage's op chain into fusible spans, dataflow order.

    The ORDER BY family rides the keyword tail: `sort_keys` > 0 appends a
    SORT span (or a TOPK span when `fetch` bounds the output — the fused
    top-k never materializes the full sort), and `window_funcs` > 0
    appends a WINDOW span (segmented scans over the sorted layout)."""
    from ballista_tpu_torch.plan.physical import (
        CoalesceBatchesExec,
        FilterExec,
        HashJoinExec,
        ProjectionExec,
    )

    spans: list[Span] = []

    def add(kind: str) -> None:
        if spans and spans[-1].kind == kind:
            spans[-1].ops += 1
        else:
            spans.append(Span(kind))

    for _ in range(max(0, int(n_scan_filters))):
        add(PREDICATE)
    for op in ops:
        if isinstance(op, CoalesceBatchesExec):
            continue
        if isinstance(op, FilterExec):
            add(PREDICATE)
        elif isinstance(op, HashJoinExec):
            add(PROBE)
        elif isinstance(op, ProjectionExec):
            add(PROJECT)
        else:
            add(PROJECT)  # unknown residuals lower like projections or raise later
    if agg is not None:
        add(AGGREGATE)
    if sort_keys > 0:
        spans.append(Span(TOPK if fetch is not None else SORT,
                          max(1, int(sort_keys))))
    if window_funcs > 0:
        spans.append(Span(WINDOW, max(1, int(window_funcs))))
    return spans


def estimate_stage(scan, ops, agg, dt, builds) -> StageEstimate:
    """Build a StageEstimate from encode metadata + prepared builds.

    The group-domain walk mirrors _compile's unrolled-eligibility scan: a
    provenance environment maps each current-schema slot to its (kind,
    dictionary) origin; projections rebind Columns, joins prepend build
    slots. Any group key that is not a dictionary-coded Column makes the
    domain unbounded (None)."""
    from ballista_tpu_torch.plan.expressions import Alias, Column
    from ballista_tpu_torch.plan.physical import (
        CoalesceBatchesExec,
        FilterExec,
        HashJoinExec,
        ProjectionExec,
    )

    scan_filters = len(getattr(scan, "filters", []) or [])
    spans = plan_spans(scan_filters, ops, agg)

    # provenance env: per current-schema slot, (kind, dictionary) or None
    env: list = [(k, d) for k, d in zip(dt.kinds, dt.dicts)]
    cur_schema = scan.df_schema
    n_filters = scan_filters
    n_projections = 0
    n_joins = 0
    lanes = 1
    has_mult = False
    max_probe_table = 0

    join_ops = [o for o in ops if isinstance(o, HashJoinExec)]
    if builds and join_ops:
        try:
            from ballista_tpu_torch.ops.cuda.stage_compiler import _mult_shape_check

            cba = _mult_shape_check(agg, ops, join_ops[-1])
            has_mult = cba is not None and builds[-1].dup > 1
        except Exception:  # noqa: BLE001 — estimate only, never fail a stage
            has_mult = False

    jidx = 0
    for op in ops:
        if isinstance(op, CoalesceBatchesExec):
            continue
        if isinstance(op, FilterExec):
            n_filters += 1
        elif isinstance(op, HashJoinExec):
            n_joins += 1
            bt = builds[jidx] if jidx < len(builds) else None
            membership = op.join_type in ("right_semi", "right_anti")
            is_mult = has_mult and jidx == len(builds) - 1
            if bt is not None:
                if bt.mode == "direct":
                    try:
                        max_probe_table = max(max_probe_table, int(bt.keys.shape[0]))
                    except Exception:  # noqa: BLE001
                        pass
                if not membership and not is_mult:
                    lanes *= max(1, int(bt.dup))
            if not membership and not is_mult and bt is not None:
                # build fields prepend, like _compile's env rebinding
                env = [
                    (k, d) for k, d in zip(bt.kinds, bt.dicts)
                ] + env
                cur_schema = op.df_schema
            elif is_mult:
                env = [None] * len(op.left.df_schema) + env
                cur_schema = op.df_schema
            jidx += 1
        elif isinstance(op, ProjectionExec):
            n_projections += 1
            new_env: list = []
            for e in op.exprs:
                inner = e.expr if isinstance(e, Alias) else e
                slot = None
                if isinstance(inner, Column):
                    i = cur_schema.maybe_index_of(inner.name, inner.qualifier)
                    if i is not None and i < len(env):
                        slot = env[i]
                new_env.append(slot)
            env = new_env
            cur_schema = op.df_schema

    group_domain: int | None = 1
    n_group_keys = len(agg.group_exprs) if agg is not None else 0
    if agg is not None:
        for g in agg.group_exprs:
            gc = g.expr if isinstance(g, Alias) else g
            slot = None
            if isinstance(gc, Column):
                i = cur_schema.maybe_index_of(gc.name, gc.qualifier)
                if i is not None and i < len(env):
                    slot = env[i]
            if slot is None or slot[0] != "code" or slot[1] is None:
                group_domain = None
                break
            group_domain *= _pow2(len(slot[1]))

    P, N = dt.shape
    # mirror _load's nbytes accumulation term for term: data stacks,
    # validity planes of nullable columns, then the [P, N] row mask
    table_bytes = sum(P * N * c.dtype.itemsize for c in dt.cols)
    table_bytes += sum(P * N for v in dt.valids if v is not None)
    table_bytes += P * N
    # each dictionary column uploads a pow2-padded LUT; 8 B/slot covers the
    # widest remap target (int64 combined keys / i64 decode tables)
    dict_bytes = sum(_pow2(len(d)) * 8 for d in dt.dicts if d)
    build_bytes = 0
    max_build_bytes = 0
    max_build_jidx = -1
    for j, bt in enumerate(builds or []):
        b = sum(int(getattr(a, "nbytes", 0)) for a in bt.flat_arrays())
        dict_bytes += sum(_pow2(len(d)) * 8 for d in bt.dicts if d)
        build_bytes += b
        if b > max_build_bytes:
            max_build_bytes, max_build_jidx = b, j

    agg_funcs = tuple(d.func for d in agg.aggs) if agg is not None else ()
    return StageEstimate(
        rows=sum(dt.part_rows),
        partitions=len(dt.part_rows),
        group_domain=group_domain,
        n_group_keys=n_group_keys,
        lanes=lanes,
        has_mult=has_mult,
        n_filters=n_filters,
        n_projections=n_projections,
        n_joins=n_joins,
        max_probe_table=max_probe_table,
        agg_funcs=agg_funcs,
        spans=spans,
        table_bytes=table_bytes,
        dict_bytes=dict_bytes,
        build_bytes=build_bytes,
        max_build_bytes=max_build_bytes,
        max_build_jidx=max_build_jidx,
    )


def estimate_sort_stage(n_rows: int, key_meta, fetch=None,
                        window_funcs: int = 0) -> StageEstimate:
    """StageEstimate for an ORDER BY / window stage (the device-permutation
    layout: only key lanes upload; payload columns stay host-side and are
    gathered by the returned permutation).

    `key_meta` is a sequence of (kind, nullable) per sort key — kind from
    the lane encoding (i64/date/money/f64/code/bool). Priced per padded
    lane (pow2 for the bitonic network):

      per key: 8 B transformed i64 + 8 B null-rank tiebreak operand
               (+ 1 B NaN-disambiguation plane for f64 keys)
      fixed:   4 B position + 4 B permutation output
      scans:   per window function, 8 B value lanes + 8 B scan state
               + 4 B partition-boundary flags + 4 B peer-boundary flags
               (boundary planes ship as int32 lanes)

    The total lands in table_bytes so `hbm.plan_stage` admits the stage
    through the same ladder as aggregate stages (no grace rung: sorts
    have no splittable build side, so over-budget demotes to the CPU
    engine with the reason recorded)."""
    key_meta = list(key_meta)
    lanes = _pow2(max(int(n_rows), 1))
    per_key = 0
    for kind, nullable in key_meta:
        per_key += 8 + 8  # transformed key + tiebreak operand
        if kind == "f64":
            per_key += 1
        if nullable:
            per_key += 1
    scratch = lanes * (per_key + 4 + 4)
    scratch += int(window_funcs) * lanes * (8 + 8 + 4 + 4)
    return StageEstimate(
        rows=int(n_rows),
        partitions=1,
        group_domain=None,
        n_group_keys=0,
        lanes=1,
        has_mult=False,
        n_filters=0,
        n_projections=0,
        n_joins=0,
        max_probe_table=0,
        spans=plan_spans(0, (), None, sort_keys=len(key_meta),
                         fetch=fetch, window_funcs=window_funcs),
        table_bytes=scratch,
        sort_keys=len(key_meta),
        sort_lanes=lanes,
        topk_k=int(fetch) if fetch is not None else 0,
        window_funcs=int(window_funcs),
    )


@dataclass
class CostModel:
    """Fuse-vs-stage chooser. All inputs are compile-time facts; the
    platform string keeps auto mode honest (interpreter-mode Pallas on
    CPU is a correctness rig, not a fast path)."""

    enabled: bool = True
    mode: str = "auto"
    min_fused_rows: int = 4096
    pallas_max_groups: int = 4096
    pallas_max_probe: int = 1 << 18
    force_pallas: bool = False  # legacy ballista.tpu.pallas.enabled
    platform: str = "cpu"
    sort_max_rows: int = 1 << 17  # pallas bitonic lane ceiling (padded)
    topk_max_k: int = 1024  # above this, ORDER BY...LIMIT full-sorts

    @classmethod
    def from_config(cls, config) -> "CostModel":
        from ballista_tpu_torch.config import (
            TPU_FUSION_ENABLED,
            TPU_FUSION_MIN_ROWS,
            TPU_FUSION_MODE,
            TPU_FUSION_PALLAS_MAX_GROUPS,
            TPU_FUSION_PALLAS_MAX_PROBE,
            TPU_PALLAS,
            TPU_SORT_PALLAS_MAX_ROWS,
            TPU_TOPK_MAX_K,
        )

        return cls(
            enabled=bool(config.get(TPU_FUSION_ENABLED)),
            mode=str(config.get(TPU_FUSION_MODE)),
            min_fused_rows=int(config.get(TPU_FUSION_MIN_ROWS)),
            pallas_max_groups=int(config.get(TPU_FUSION_PALLAS_MAX_GROUPS)),
            pallas_max_probe=int(config.get(TPU_FUSION_PALLAS_MAX_PROBE)),
            force_pallas=bool(config.get(TPU_PALLAS)),
            sort_max_rows=int(config.get(TPU_SORT_PALLAS_MAX_ROWS)),
            topk_max_k=int(config.get(TPU_TOPK_MAX_K)),
        )

    def _pallas_eligible(self, est: StageEstimate) -> bool:
        from ballista_tpu_torch.ops.cuda.cuda_kernels import MAX_GROUPS

        cap = min(self.pallas_max_groups, MAX_GROUPS)
        return (
            est.n_group_keys > 0
            and est.group_domain is not None
            and 1 < est.group_domain <= cap
            and est.lanes == 1
            and not est.has_mult
            and bool(est.agg_funcs)
            and all(f in ("sum", "count", "count_all") for f in est.agg_funcs)
        )

    def _staged_eligible(self, est: StageEstimate) -> bool:
        # mirrors _compile's staged gate: single lane, no mult weights,
        # bounded group domain small enough for the unrolled form
        return (
            est.lanes == 1
            and not est.has_mult
            and est.group_domain is not None
            and est.group_domain <= 64
        )

    def choose(self, est: StageEstimate) -> FusionDecision:
        if self.mode in ("staged", "fused_xla", "fused_pallas"):
            return FusionDecision(
                self.mode, f"forced by ballista.tpu.fusion.mode={self.mode}"
            )
        if not self.enabled:
            return FusionDecision(
                "staged", "fusion disabled; staged per-span fallback"
            )
        if self.force_pallas and self._pallas_eligible(est):
            return FusionDecision(
                "fused_pallas", "legacy ballista.tpu.pallas.enabled"
            )
        if est.rows < self.min_fused_rows and self._staged_eligible(est):
            return FusionDecision(
                "staged",
                f"{est.rows} rows < fusion.min.rows={self.min_fused_rows}",
            )
        if self.platform == "cuda" and self._pallas_eligible(est):
            return FusionDecision(
                "fused_pallas",
                f"grouped agg, G={est.group_domain} fits the kernel family",
            )
        why = []
        if est.group_domain is None:
            why.append("unbounded group domain")
        elif est.group_domain > self.pallas_max_groups:
            why.append(f"G={est.group_domain} > pallas ceiling")
        if est.lanes > 1:
            why.append(f"{est.lanes} expansion lanes")
        if est.has_mult:
            why.append("aggregate-through-join weights")
        if self.platform != "cuda":
            why.append(f"platform={self.platform}")
        return FusionDecision(
            "fused_xla", "whole-chain XLA fusion (" + "; ".join(why) + ")"
        )

    def _sort_pallas_eligible(self, est: StageEstimate) -> tuple[bool, str]:
        from ballista_tpu_torch.ops.cuda.cuda_kernels import MAX_SORT_LANES

        cap = min(self.sort_max_rows, MAX_SORT_LANES)
        if est.sort_lanes > cap:
            return False, f"{est.sort_lanes} padded lanes > sort ceiling {cap}"
        if est.topk_k and est.topk_k > self.topk_max_k:
            return False, (f"fetch {est.topk_k} > topk.max.k {self.topk_max_k}"
                           " — full sort + slice")
        if est.topk_k and est.sort_keys > 1:
            return False, (f"{est.sort_keys} sort keys — the top-k kernel "
                           "takes one composite key; full sort + slice")
        return True, ""

    def choose_sort(self, est: StageEstimate) -> FusionDecision:
        """Mode choice for the ORDER BY / window stage family. Same ladder
        shape as `choose`: forced knob > disabled→staged > pallas on a
        CUDA card > fused_xla, every demotion with its reason."""
        kinds = {s.kind for s in est.spans}
        what = "window" if WINDOW in kinds else ("topk" if TOPK in kinds else "sort")
        ok, why = self._sort_pallas_eligible(est)
        if self.mode in ("staged", "fused_xla", "fused_pallas"):
            if self.mode == "fused_pallas" and not ok:
                return FusionDecision(
                    "fused_xla", f"forced fused_pallas but {why}")
            return FusionDecision(
                self.mode, f"forced by ballista.tpu.fusion.mode={self.mode}")
        if not self.enabled:
            return FusionDecision(
                "staged", "fusion disabled; per-pass lax.sort fallback")
        if (self.platform == "cuda" or self.force_pallas) and ok:
            return FusionDecision(
                "fused_pallas",
                f"{what} stage, {est.sort_lanes} lanes fit the kernel family")
        parts = [why] if why else []
        if self.platform != "cuda" and not self.force_pallas:
            parts.append(f"platform={self.platform}")
        return FusionDecision(
            "fused_xla", f"{what} via whole-chain XLA sort ("
                         + "; ".join(parts) + ")")
