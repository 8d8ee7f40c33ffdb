"""Adaptive query execution: replan stages with runtime statistics.

Rebuild of the reference's AQE subsystem (scheduler/src/state/aqe/), scoped
to its three headline optimizations, applied when a stage RESOLVES (all
inputs finished, actual per-partition stats in hand):

- PropagateEmptyExecRule: an inner join whose build or probe input produced
  ZERO rows collapses to an EmptyExec subtree (semi joins likewise; anti
  joins with an empty right side collapse to their left input).
- CoalescePartitionsRule: post-shuffle reduce partitions are bin-packed to
  `ballista.planner.adaptive.coalesce.target.bytes` — ONE group assignment
  per stage (computed over the summed sizes of every hash input) so
  co-partitioned join sides stay aligned (coalesce/algorithm.rs).
- SelectJoinRule (dynamic join selection): a partitioned inner join whose
  build side turned out tiny is rewritten to CollectLeft with a broadcast
  reader, skipping the per-partition build (join swap by ACTUAL sizes, not
  estimates). Build-side-emitting join types keep partitioned mode — the
  correctness constraint from the physical planner applies at runtime too.
- SkewSplitRule (docs/aqe.md): a reduce partition whose observed bytes
  exceed `median × ballista.aqe.skew.factor` (median via a T-Digest over
  the per-bucket histogram) and the `ballista.aqe.skew.min.bytes` floor is
  split into K partition-SLICE tasks. Each slice's reader consumes a
  distinct contiguous sub-range of the hot partition's map outputs
  (shuffle.reader.split_location_ranges), so concatenating the slices in
  partition order is byte-identical to the unsplit read; a join's build
  side is DUPLICATED into every slice instead. plan_check's skew rule
  verifies cover / no-overlap / order from the SkewSplitReport before the
  replanned DAG runs.
- Mesh composition: mesh-fused stages no longer disable AQE wholesale
  (the PR 7 blanket skip). A hot key demotes the fused edge to the host
  split with `mesh_mode_reason="demoted:aqe:skew"`; otherwise, when the
  observed input volume warrants far fewer device buckets, the exchange
  is rebuilt at the smaller count and the stage's task span shrinks with
  it.

The reference plans stages incrementally (AdaptivePlanner::replan_stages);
this build plans statically and rewrites at resolution — same signals,
same rewrites, one fewer moving part. Incremental planning is the round-2
item that also unlocks probe-side-shuffle elision.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ballista_tpu_torch.config import (
    AQE_COALESCE_MERGED_FACTOR,
    AQE_DYNAMIC_JOIN_SELECTION,
    AQE_EMPTY_PROPAGATION,
    AQE_MIN_PARTITION_BYTES,
    AQE_SKEW_ENABLED,
    AQE_SKEW_FACTOR,
    AQE_SKEW_MAX_SLICES,
    AQE_SKEW_MIN_BYTES,
    AQE_TARGET_PARTITION_BYTES,
    BROADCAST_JOIN_ROWS_THRESHOLD,
    BROADCAST_JOIN_THRESHOLD,
    PLANNER_ADAPTIVE_ENABLED,
    BallistaConfig,
)
from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec
from ballista_tpu_torch.plan.physical import (
    CoalesceBatchesExec,
    EmptyExec,
    ExecutionPlan,
    FilterExec,
    HashJoinExec,
    ProjectionExec,
)
from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec, split_location_ranges
from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec
from ballista_tpu_torch.utils.tdigest import TDigest

log = logging.getLogger(__name__)


def coalesce_groups(sizes: list[int], target: int, min_bytes: int, merged_factor: float) -> list[list[int]]:
    """Bin-pack contiguous reduce partitions by byte size.

    Greedy sequential packing to `target` bytes with a slack factor; a
    trailing small group merges backwards (the reference's merged-factor +
    small-tail refinements, aqe/coalesce/algorithm.rs)."""
    if not sizes:
        return []
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, s in enumerate(sizes):
        if cur and cur_bytes + s > target * merged_factor:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += s
    if cur:
        tail_bytes = sum(sizes[i] for i in cur)
        if groups and tail_bytes < min_bytes:
            groups[-1].extend(cur)
        else:
            groups.append(cur)
    return groups


@dataclass
class InputStageStats:
    stage_id: int
    total_rows: int
    total_bytes: int
    bucket_bytes: list[int]  # per output partition
    broadcast: bool
    # T-Digest over this input's per-bucket byte histogram; the skew rule's
    # robust-median threshold merges these across hash inputs
    bytes_digest: "TDigest | None" = None


@dataclass
class SkewSplit:
    """One hot reduce partition split into slice tasks."""

    bucket: int            # original output-partition index that ran hot
    partitions: list[int]  # stage partition indices now holding the slices
    bytes: int             # observed combined bytes of the hot bucket


@dataclass
class SkewSplitReport:
    """Resolution-time record of skew splits on a stage, consumed by
    plan_check's skew rule (cover / no-overlap / order over the slice
    readers' location lists) and by the aqe-grew partition accounting."""

    splits: list[SkewSplit] = field(default_factory=list)
    extra_partitions: int = 0


# join types whose output is a pure function of (full build side, probe
# rows): slicing the probe and concatenating slice outputs in probe order
# reproduces the unsplit join. Build-emitting types (left/full/anti-left)
# would emit their unmatched-build rows once PER slice — never split those.
_SPLIT_SAFE_JOINS = ("inner", "right", "right_semi", "right_anti")


def apply_aqe(plan: ExecutionPlan, input_stats: dict[int, InputStageStats],
              config: BallistaConfig,
              stage_partitions: int | None = None,
              stage_unconsumed: bool = False,
              ) -> tuple[ExecutionPlan, int | None, SkewSplitReport | None]:
    """Rewrite a freshly-resolved stage plan using actual input statistics.

    `plan` has concrete ShuffleReaderExec leaves tagged with their source
    stage id (set by the graph at resolution). `stage_unconsumed` marks a
    stage with no downstream consumers (results are collected, not read by
    another stage) — a passthrough-rooted stage may only change its task
    count then, because passthrough outputs are indexed by map partition.
    Returns (new_plan, new_partition_count or None, SkewSplitReport or
    None); a non-None count replaces the stage's pending/effective
    partitions — it may exceed the planned count when a skew split grew
    the stage.
    """
    if not bool(config.get(PLANNER_ADAPTIVE_ENABLED)):
        return plan, None, None

    if bool(config.get(AQE_EMPTY_PROPAGATION)):
        plan = _propagate_empty(plan, input_stats)

    if bool(config.get(AQE_DYNAMIC_JOIN_SELECTION)):
        plan = _select_joins(plan, input_stats, config)

    # a stage whose root writer hash-routes (output_partitions > 0) can take
    # any task count — every task feeds the same K output buckets. A
    # passthrough root writes one output PER map partition, so its task
    # count is only negotiable when nothing downstream indexes those outputs
    repartitionable = isinstance(plan, ShuffleWriterExec) and (
        plan.output_partitions > 0 or stage_unconsumed
    )

    mesh_nodes = _mesh_nodes(plan)
    if mesh_nodes:
        return _mesh_aqe(plan, mesh_nodes, input_stats, config, repartitionable)

    target = int(config.get(AQE_TARGET_PARTITION_BYTES))
    min_b = int(config.get(AQE_MIN_PARTITION_BYTES))
    factor = float(config.get(AQE_COALESCE_MERGED_FACTOR))
    hash_inputs = [
        s for s in input_stats.values() if not s.broadcast and len(s.bucket_bytes) > 1
    ]
    readers = _hash_readers(plan)
    k_in = len(hash_inputs[0].bucket_bytes) if hash_inputs else 0
    # regrouping replaces reader partition lists IN PLACE of the stage's
    # partition indexing — only sound when the stage's partitions ARE the
    # readers' (a Union stage concatenates branch partition ranges, so its
    # indexing is not reader-aligned; never regroup it)
    aligned = stage_partitions is None or stage_partitions == k_in
    if not (hash_inputs and readers and aligned and all(
        len(r.partition_locations) == k_in for r in readers
    )):
        return plan, None, None

    k = k_in
    combined = _combined_bucket_bytes(input_stats)

    # -- skew detection: which buckets split, into how many slices ---------
    splits: dict[int, int] = {}
    dup_ids: set[int] = set()
    if repartitionable and bool(config.get(AQE_SKEW_ENABLED)):
        safe, sliced_ids, dup_ids = _classify_split_readers(plan)
        if safe:
            sliced = [r for r in readers if id(r) in sliced_ids]

            def min_locs(b: int) -> int:
                return min((len(r.partition_locations[b]) for r in sliced), default=0)

            splits = _plan_splits(combined, config, min_locs)

    # -- unit construction: slices for hot buckets, coalesce groups for the
    #    cold segments between them ----------------------------------------
    report = None
    if not splits:
        groups = coalesce_groups(combined, target, min_b, factor)
        if not (0 < len(groups) < k):
            return plan, None, None
        units: list[tuple] = [("group", g) for g in groups]
        log.info("AQE coalesced %d reduce partitions into %d groups", k, len(groups))
    else:
        units = []
        rsplits: list[SkewSplit] = []
        seg: list[int] = []

        def flush_segment() -> None:
            if not seg:
                return
            for g in coalesce_groups([combined[i] for i in seg], target, min_b, factor):
                units.append(("group", [seg[x] for x in g]))
            seg.clear()

        for b in range(k):
            if b in splits:
                flush_segment()
                n = splits[b]
                rsplits.append(SkewSplit(
                    bucket=b,
                    partitions=list(range(len(units), len(units) + n)),
                    bytes=combined[b],
                ))
                for j in range(n):
                    units.append(("slice", b, j, n))
            else:
                seg.append(b)
        flush_segment()
        report = SkewSplitReport(
            splits=rsplits,
            extra_partitions=sum(len(s.partitions) - 1 for s in rsplits),
        )
        log.info(
            "AQE skew split: buckets %s → %d slices each (%d stage partitions total)",
            sorted(splits), max(splits.values()), len(units),
        )

    # -- rebuild readers over the unit layout. FRESH readers rather than
    #    mutating shared ones in place: a reader aliased by a replayed or
    #    retried resolution must never see half-regrouped location lists
    #    (the stale-alias class of bug this codebase hit once already) ------
    replacements: dict[int, ShuffleReaderExec] = {}
    for r in readers:
        dup = id(r) in dup_ids
        ranges: dict[int, list[list]] = {}
        lists: list[list] = []
        for u in units:
            if u[0] == "group":
                lists.append([loc for i in u[1] for loc in r.partition_locations[i]])
            else:
                _, b, j, n = u
                if dup:
                    # a join's build side sees the WHOLE hot bucket in every
                    # slice — each slice re-builds the full hash table and
                    # probes its own sub-range
                    lists.append(list(r.partition_locations[b]))
                else:
                    if b not in ranges:
                        ranges[b] = split_location_ranges(r.partition_locations[b], n)
                    lists.append(ranges[b][j])
        nr = ShuffleReaderExec(r.df_schema, lists, r.broadcast)
        nr.source_stage_id = getattr(r, "source_stage_id", None)
        replacements[id(r)] = nr
    plan = _replace_readers(plan, replacements)
    new_parts = len(units)
    from ballista_tpu_torch.ops.cpu.range_repartition import retarget_routers

    plan = retarget_routers(plan, new_parts)

    from ballista_tpu_torch.ops.cuda import aqe_stats

    if splits:
        aqe_stats.note_skew_splits(len(splits))
    coalesced_away = (k - len(splits)) - sum(1 for u in units if u[0] == "group")
    aqe_stats.note_coalesced_partitions(coalesced_away)
    return plan, new_parts, report


def _combined_bucket_bytes(input_stats: dict[int, InputStageStats]) -> list[int]:
    """Per-reduce-partition bytes summed over every hash input (the joint
    histogram the coalesce and skew thresholds both read)."""
    hash_inputs = [
        s for s in input_stats.values() if not s.broadcast and len(s.bucket_bytes) > 1
    ]
    if not hash_inputs:
        return []
    k = len(hash_inputs[0].bucket_bytes)
    combined = [0] * k
    for s in hash_inputs:
        if len(s.bucket_bytes) == k:
            for i, b in enumerate(s.bucket_bytes):
                combined[i] += b
    return combined


def _hot_buckets(combined: list[int], config: BallistaConfig) -> list[int]:
    """Buckets exceeding `median × skew.factor` AND the skew bytes floor.
    The median comes from a T-Digest over the bucket histogram — the same
    sketch the runtime range repartitioner uses, robust to the hot bucket
    dragging a plain mean."""
    factor = float(config.get(AQE_SKEW_FACTOR))
    floor = int(config.get(AQE_SKEW_MIN_BYTES))
    if factor <= 0 or len(combined) < 2:
        return []
    digest = TDigest()
    digest.add_array(np.asarray(combined, dtype=np.float64))
    med = digest.quantile(0.5)
    if med != med:  # empty digest
        return []
    threshold = max(med * factor, float(floor))
    return [i for i, v in enumerate(combined) if v > threshold]


def _plan_splits(combined: list[int], config: BallistaConfig,
                 min_locs) -> dict[int, int]:
    """bucket → slice count for every splittable hot bucket. The count
    aims each slice at the coalesce target, capped by skew.max.slices and
    by the bucket's map-output count (`min_locs`) — a single map output is
    never subdivided, so fewer than 2 available locations means no split."""
    hot = _hot_buckets(combined, config)
    if not hot:
        return {}
    target = max(1, int(config.get(AQE_TARGET_PARTITION_BYTES)))
    max_slices = int(config.get(AQE_SKEW_MAX_SLICES))
    out: dict[int, int] = {}
    for b in hot:
        n = max(2, min(max_slices, -(-combined[b] // target)))
        n = min(n, min_locs(b))
        if n >= 2:
            out[b] = n
    return out


def _classify_split_readers(plan: ExecutionPlan) -> tuple[bool, set[int], set[int]]:
    """Can this stage tolerate splitting one reduce partition into slices,
    and how does each hash reader participate?

    Walks from the root writer through partition-wise operators. Filter /
    projection / batch-coalescing are transparent (row-wise, order
    preserving). A join whose type is in _SPLIT_SAFE_JOINS contributes its
    LEFT (build) subtree's readers as duplicates — the full build executes
    per slice — and recurses down the probe side; any other operator
    (sorts, aggregates, unions, build-emitting joins) makes the plan
    unsplittable. Returns (safe, sliced_reader_ids, dup_reader_ids)."""
    sliced: set[int] = set()
    dup: set[int] = set()
    ok = True

    def collect(n: ExecutionPlan) -> None:
        if isinstance(n, ShuffleReaderExec):
            if not n.broadcast:
                dup.add(id(n))
            return
        for c in n.children():
            collect(c)

    def walk(n: ExecutionPlan) -> None:
        nonlocal ok
        if not ok:
            return
        if isinstance(n, ShuffleReaderExec):
            if not n.broadcast:
                sliced.add(id(n))
            return
        if isinstance(n, (HashJoinExec, DynamicJoinSelectionExec)):
            if n.join_type not in _SPLIT_SAFE_JOINS:
                ok = False
                return
            collect(n.left)
            walk(n.right)
            return
        if isinstance(n, (FilterExec, ProjectionExec, CoalesceBatchesExec)):
            walk(n.children()[0])
            return
        ok = False

    if isinstance(plan, ShuffleWriterExec):
        walk(plan.input)
    else:
        ok = False
    return ok and bool(sliced), sliced, dup


def _mesh_aqe(plan: ExecutionPlan, mesh_nodes: list,
              input_stats: dict[int, InputStageStats], config: BallistaConfig,
              repartitionable: bool,
              ) -> tuple[ExecutionPlan, int | None, SkewSplitReport | None]:
    """AQE over a mesh-fused stage — composition, not mutual exclusion.

    Partition-slicing and reader regrouping cannot apply (the exchange
    stands where the readers stood), but the runtime stats still drive two
    decisions:

    1. **skew demotion**: a hot bucket in the input histogram means the
       fixed-capacity collective would see one device's receive lane blow
       past its peers — demote the fused edge to the host split up front,
       with `mesh_mode_reason="demoted:aqe:skew"` on record.
    2. **bucket replan**: when the observed input volume wants far fewer
       buckets than planned (the coalescing signal), REBUILD the exchange
       at the smaller count — hash routing is bucket-count-parametric
       (`h % K` on both the device and host paths), so any K is valid —
       and shrink the stage's task span to match.
    """
    from ballista_tpu_torch.ops.cuda import aqe_stats

    _demote_oversized_mesh(mesh_nodes, input_stats, config)

    combined = _combined_bucket_bytes(input_stats)
    if bool(config.get(AQE_SKEW_ENABLED)) and combined and _hot_buckets(combined, config):
        demoted = False
        for n in mesh_nodes:
            if not n.demote_reason:
                n.demote_reason = "aqe:skew"
                demoted = True
        if demoted:
            aqe_stats.note_mesh_replan()
            log.info("AQE demoted mesh exchange: hot reduce bucket detected "
                     "(mesh_mode_reason=demoted:aqe:skew)")
        return plan, None, None

    if not repartitionable or len(mesh_nodes) != 1:
        return plan, None, None
    ex = mesh_nodes[0]
    if ex.demote_reason:
        return plan, None, None
    target = int(config.get(AQE_TARGET_PARTITION_BYTES))
    total = sum(s.total_bytes for s in input_stats.values() if not s.broadcast)
    if target <= 0 or total <= 0:
        return plan, None, None
    k = ex.file_partitions
    new_k = max(1, -(-total // target))
    # same hysteresis as the fan-out rule: only replan on a big win, the
    # device dispatch amortizes small imbalances anyway
    if new_k > k // 2 or new_k >= k:
        return plan, None, None
    plan = _replace_readers(plan, {id(ex): ex.with_file_partitions(new_k)})
    from ballista_tpu_torch.ops.cpu.range_repartition import retarget_routers

    plan = retarget_routers(plan, new_k)
    aqe_stats.note_mesh_replan()
    log.info("AQE replanned mesh exchange: %d → %d device buckets "
             "(%d observed input bytes)", k, new_k, total)
    return plan, new_k, None


def _mesh_nodes(plan: ExecutionPlan) -> list:
    from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec

    out = []

    def walk(n):
        if isinstance(n, MeshExchangeExec):
            out.append(n)
        for c in n.children():
            walk(c)

    walk(plan)
    return out


def _demote_oversized_mesh(nodes: list, input_stats: dict[int, InputStageStats],
                           config: BallistaConfig) -> None:
    from ballista_tpu_torch.config import TPU_MESH_MAX_INPUT_BYTES

    limit = int(config.get(TPU_MESH_MAX_INPUT_BYTES))
    if limit <= 0:
        return
    total = sum(s.total_bytes for s in input_stats.values() if not s.broadcast)
    if total <= limit:
        return
    reason = f"aqe:input-bytes({total}>{limit})"
    for n in nodes:
        n.demote_reason = reason
    log.info("AQE demoted mesh exchange to the per-partition path: %s", reason)


def _replace_readers(plan: ExecutionPlan, replacements: dict[int, ShuffleReaderExec]) -> ExecutionPlan:
    hit = replacements.get(id(plan))
    if hit is not None:
        return hit
    kids = plan.children()
    if not kids:
        return plan
    new_kids = [_replace_readers(c, replacements) for c in kids]
    if all(a is b for a, b in zip(new_kids, kids)):
        return plan
    return plan.with_children(new_kids)


def _hash_readers(plan: ExecutionPlan) -> list[ShuffleReaderExec]:
    out = []

    def walk(n, under_collect_build=False):
        if isinstance(n, ShuffleReaderExec) and not n.broadcast and not under_collect_build:
            out.append(n)
        if isinstance(n, HashJoinExec) and n.mode == "collect_left":
            walk(n.left, True)
            walk(n.right, under_collect_build)
            return
        for c in n.children():
            walk(c, under_collect_build)

    walk(plan)
    return out


def _stats_of(reader: ShuffleReaderExec, input_stats: dict[int, InputStageStats]):
    sid = getattr(reader, "source_stage_id", None)
    return input_stats.get(sid) if sid is not None else None


def _propagate_empty(plan: ExecutionPlan, input_stats) -> ExecutionPlan:
    def is_empty(n: ExecutionPlan) -> bool:
        if isinstance(n, ShuffleReaderExec):
            s = _stats_of(n, input_stats)
            return s is not None and s.total_rows == 0
        if isinstance(n, EmptyExec):
            return not n.produce_one_row
        return False

    def walk(n: ExecutionPlan) -> ExecutionPlan:
        kids = n.children()
        if kids:
            n = n.with_children([walk(c) for c in kids])
        # the deferred-decision node collapses under the same rules as a
        # concrete hash join: emptiness does not depend on build strategy
        if isinstance(n, (HashJoinExec, DynamicJoinSelectionExec)):
            l_empty, r_empty = is_empty(n.left), is_empty(n.right)
            jt = n.join_type
            if jt == "inner" and (l_empty or r_empty):
                return EmptyExec(n.df_schema, False)
            if jt in ("left_semi", "right_semi") and (l_empty or r_empty):
                return EmptyExec(n.df_schema, False)
            if jt == "left_anti" and r_empty:
                return n.left  # nothing to subtract: pass the build side through
            if jt == "right_anti" and l_empty:
                return n.right
        return n

    return walk(plan)


def _broadcast_build_reader(resolved: ExecutionPlan) -> ExecutionPlan:
    """A collect_left build over a plain partitioned reader collects its
    partitions one sequential execute(p) at a time; the broadcast reader
    flattens every location into ONE concurrently governed fetch. Rebuild
    the build-side reader accordingly (the resolved node may sit under the
    swap-restoring projection)."""
    join = resolved
    if not isinstance(join, HashJoinExec):
        kids = join.children()
        if len(kids) != 1 or not isinstance(kids[0], HashJoinExec):
            return resolved
        join = kids[0]
    if join.mode != "collect_left" or not isinstance(join.left, ShuffleReaderExec) \
            or join.left.broadcast:
        return resolved
    bcast = ShuffleReaderExec(join.left.df_schema, join.left.partition_locations,
                              broadcast=True)
    bcast.source_stage_id = getattr(join.left, "source_stage_id", None)
    new_join = join.with_children([bcast, join.right])
    if join is resolved:
        return new_join
    return resolved.with_children([new_join])


def _select_joins(plan: ExecutionPlan, input_stats, config: BallistaConfig) -> ExecutionPlan:
    rows_threshold = int(config.get(BROADCAST_JOIN_ROWS_THRESHOLD))
    byte_threshold = int(config.get(BROADCAST_JOIN_THRESHOLD))

    def walk(n: ExecutionPlan) -> ExecutionPlan:
        kids = n.children()
        if kids:
            n = n.with_children([walk(c) for c in kids])
        if isinstance(n, DynamicJoinSelectionExec):
            # the planner's deferred decision, resolved here when BOTH input
            # stages finished with known sizes (the reference's optimizer-
            # rule replacement of dynamic_join.rs); otherwise the node stays
            # and decides mid-stage at first-batch time
            ls = _stats_of(n.left, input_stats) if isinstance(n.left, ShuffleReaderExec) else None
            rs = _stats_of(n.right, input_stats) if isinstance(n.right, ShuffleReaderExec) else None
            if ls is not None and rs is not None:
                resolved = n.resolve_with_stats(
                    ls.total_bytes, ls.total_rows, rs.total_bytes, rs.total_rows,
                    byte_threshold, rows_threshold,
                )
                resolved = _broadcast_build_reader(resolved)
                log.info(
                    "AQE dynamic join resolved at stage resolution: %s "
                    "(left %d B/%d rows, right %d B/%d rows)", n.decision,
                    ls.total_bytes, ls.total_rows, rs.total_bytes, rs.total_rows,
                )
                return resolved
            return n
        if (
            isinstance(n, HashJoinExec)
            and n.mode == "partitioned"
            and n.join_type in ("inner", "right", "right_semi", "right_anti")
            and isinstance(n.left, ShuffleReaderExec)
        ):
            s = _stats_of(n.left, input_stats)
            # promotion is byte-aware as well as row-aware: a build whose
            # rows squeak under the budget but whose BYTES are broadcast-
            # hostile (wide payloads) stays partitioned
            if (s is not None and s.total_rows <= rows_threshold // 8
                    and 0 < s.total_bytes <= byte_threshold // 8):
                bcast = ShuffleReaderExec(n.left.df_schema, n.left.partition_locations, broadcast=True)
                bcast.source_stage_id = getattr(n.left, "source_stage_id", None)
                log.info(
                    "AQE join selection: build side has %d rows / %d bytes → "
                    "CollectLeft broadcast", s.total_rows, s.total_bytes,
                )
                from ballista_tpu_torch.ops.cuda import aqe_stats

                aqe_stats.note_broadcast_promotion()
                return HashJoinExec(
                    bcast, n.right, n.on, n.join_type, n.filter, "collect_left", n.df_schema
                )
        return n

    return walk(plan)


# -- incremental replanning over UNRESOLVED stage specs ----------------------


def propagate_empty_unresolved(plan: ExecutionPlan, empty_ids: set[int]) -> ExecutionPlan:
    """The incremental form of PropagateEmptyExecRule: operates on a NOT yet
    resolved stage spec whose leaves are UnresolvedShuffleExec placeholders.
    A placeholder whose source stage finished with ZERO rows is a proven-
    empty leaf — join shapes collapse immediately, before the stage ever
    resolves or schedules (reference: aqe/optimizer_rule/propagate_empty
    over the remaining plan, state/aqe/planner.rs:304)."""
    from ballista_tpu_torch.shuffle.reader import UnresolvedShuffleExec

    def is_empty(n: ExecutionPlan) -> bool:
        if isinstance(n, UnresolvedShuffleExec):
            return n.stage_id in empty_ids
        if isinstance(n, EmptyExec):
            return not n.produce_one_row
        return False

    def walk(n: ExecutionPlan) -> ExecutionPlan:
        kids = n.children()
        if kids:
            new_kids = [walk(c) for c in kids]
            if any(a is not b for a, b in zip(new_kids, kids)):
                n = n.with_children(new_kids)
        if isinstance(n, (HashJoinExec, DynamicJoinSelectionExec)):
            l_empty, r_empty = is_empty(n.left), is_empty(n.right)
            jt = n.join_type
            if jt == "inner" and (l_empty or r_empty):
                return EmptyExec(n.df_schema, False)
            if jt in ("left_semi", "right_semi") and (l_empty or r_empty):
                return EmptyExec(n.df_schema, False)
            if jt == "left_anti" and r_empty:
                return n.left
            if jt == "right_anti" and l_empty:
                return n.right
            if jt in ("left", "right", "full"):
                # outer joins: an empty probe/emitting side empties the join
                if (jt == "right" and r_empty) or (jt == "left" and l_empty):
                    return EmptyExec(n.df_schema, False)
        return n

    return walk(plan)


def provably_empty(plan: ExecutionPlan) -> bool:
    """True iff the plan yields ZERO rows given its EmptyExec leaves — the
    gate for SKIPPING a stage outright. Conservative: only operators that
    provably preserve emptiness qualify (a group-less aggregate emits one
    row from empty input, so it never qualifies)."""
    from ballista_tpu_torch.plan.physical import (
        CoalesceBatchesExec,
        CoalescePartitionsExec,
        FilterExec,
        GlobalLimitExec,
        HashAggregateExec,
        LocalLimitExec,
        ProjectionExec,
        SortExec,
        SortPreservingMergeExec,
        UnionExec,
        WindowExec,
    )

    if isinstance(plan, EmptyExec):
        return not plan.produce_one_row
    if isinstance(plan, (FilterExec, ProjectionExec, CoalesceBatchesExec,
                         LocalLimitExec, GlobalLimitExec, SortExec,
                         SortPreservingMergeExec, CoalescePartitionsExec,
                         WindowExec)):
        return provably_empty(plan.children()[0])
    if isinstance(plan, HashAggregateExec):
        return bool(plan.group_exprs) and provably_empty(plan.children()[0])
    if isinstance(plan, UnionExec):
        return all(provably_empty(c) for c in plan.children())
    if isinstance(plan, (HashJoinExec, DynamicJoinSelectionExec)):
        jt = plan.join_type
        if jt in ("inner", "left_semi", "right_semi"):
            return provably_empty(plan.left) or provably_empty(plan.right)
        if jt == "full":
            return provably_empty(plan.left) and provably_empty(plan.right)
        emit = plan.left if jt in ("left", "left_anti") else plan.right
        return provably_empty(emit)
    return False
