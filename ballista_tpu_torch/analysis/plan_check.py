"""Static verifier over staged physical plans and ExecutionGraphs.

The distributed planner, the mesh merge pass, AQE replans, and graph
recovery all REWRITE stage DAGs; each rewrite preserves a set of
invariants nothing re-checks afterward. This module checks them:

stage-list invariants (`verify_stages`):
- stage ids unique; every root is a ShuffleWriterExec tagged with its own
  stage id; `input_stage_ids` equals the UnresolvedShuffleExec leaves
  actually present in the plan; references resolve; the DAG is acyclic
- every shuffle edge agrees with its producer: the leaf's
  `output_partitions` matches the producer stage's, the `broadcast` flag
  matches, and the leaf's schema (field names + dtypes) matches what the
  producer's writer actually emits
- mesh gating (`merge_mesh_stages` postconditions): `stage.mesh` iff the
  plan contains a MeshExchangeExec; a mesh stage is never a broadcast
  producer; the exchange's device bucket count equals the stage's task
  span

graph invariants (`verify_graph`): all of the above on the stage specs,
plus `effective_partitions <= spec.partitions + skew growth` (AQE may
shrink by coalescing, and may grow ONLY by the slice count its
SkewSplitReport accounts for), task ids below the fast-lane band
(`FAST_TASK_ID_BASE` — graph tasks and fast jobs share the executor's
task-id namespace), and resolved readers tagged with a live
`source_stage_id`.

skew-split postconditions (`verify_graph`, when a stage carries a
SkewSplitReport): for every split hot bucket and every non-broadcast
resolved reader, the slice tasks' location lists must either each equal
the producer's full bucket list (a duplicated join build side) or
concatenate to EXACTLY that list in (map_partition, path) order —
cover, no overlap, and order, the same three legs the grace verifier
checks. A violated split would silently drop, duplicate, or permute
probe rows.

lease-band invariants (`verify_lease_bands`): direct-dispatch leases
reserve task-id bands at/above `DIRECT_TASK_ID_BASE`, pairwise disjoint,
with allocation cursors inside their band — and `verify_graph` flags any
scheduler-run task whose id strays into that band. Together these prove
a direct-dispatched task id can never collide with a scheduler-assigned
one in the executor's shared namespace.

Wiring: `ballista.debug.plan.verify` runs `check_stages` at submit time
(after `merge_mesh_stages`) and `check_graph` after AQE replans, failing
the job instead of executing a corrupt DAG. The TPC-H plan-stability
tests call `check_stages` unconditionally on every golden plan.
"""

from __future__ import annotations

from dataclasses import dataclass

from ballista_tpu_torch.errors import GeneralError
from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec, contains_mesh_exchange
from ballista_tpu_torch.shuffle.reader import ShuffleReaderExec, UnresolvedShuffleExec
from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec


@dataclass(frozen=True)
class PlanViolation:
    code: str  # stable machine tag, e.g. "edge-schema"
    stage_id: int
    message: str

    def render(self) -> str:
        return f"stage {self.stage_id}: [{self.code}] {self.message}"


class PlanVerificationError(GeneralError):
    """Raised by check_stages/check_graph; carries the full violation list."""

    def __init__(self, violations: list[PlanViolation]):
        self.violations = violations
        super().__init__(
            "plan verification failed:\n  " +
            "\n  ".join(v.render() for v in violations)
        )


def _schema_fields(schema) -> list[tuple[str, str]]:
    # compare names + dtypes; qualifiers legitimately differ across a
    # shuffle edge (the reader drops table qualifiers the writer kept)
    return [(f.name, str(f.dtype)) for f in schema]


def _shuffle_leaves(plan) -> list:
    out = []

    def walk(n):
        if isinstance(n, (UnresolvedShuffleExec, ShuffleReaderExec)):
            out.append(n)
        for c in n.children():
            walk(c)

    walk(plan)
    return out


def _mesh_exchanges(plan) -> list[MeshExchangeExec]:
    out = []

    def walk(n):
        if isinstance(n, MeshExchangeExec):
            out.append(n)
        for c in n.children():
            walk(c)

    walk(plan)
    return out


def verify_stages(stages) -> list[PlanViolation]:
    """Invariants over a list of QueryStage (pre-graph, post-merge)."""
    v: list[PlanViolation] = []
    by_id = {}
    for s in stages:
        if s.stage_id in by_id:
            v.append(PlanViolation("dup-stage-id", s.stage_id,
                                   "duplicate stage id in stage list"))
        by_id[s.stage_id] = s

    for s in stages:
        plan = s.plan
        if not isinstance(plan, ShuffleWriterExec):
            v.append(PlanViolation("root-not-writer", s.stage_id,
                                   f"stage root is {type(plan).__name__}, "
                                   f"expected ShuffleWriterExec"))
            continue
        if plan.stage_id != s.stage_id:
            v.append(PlanViolation("writer-stage-id", s.stage_id,
                                   f"writer is tagged stage {plan.stage_id}"))
        if plan.output_partitions > 0 and plan.output_partitions != s.output_partitions:
            v.append(PlanViolation(
                "writer-partitions", s.stage_id,
                f"writer produces {plan.output_partitions} output partitions "
                f"but the stage advertises {s.output_partitions}"))

        leaves = [l for l in _shuffle_leaves(plan) if isinstance(l, UnresolvedShuffleExec)]
        leaf_ids = sorted({l.stage_id for l in leaves})
        if leaf_ids != sorted(set(s.input_stage_ids)):
            v.append(PlanViolation(
                "input-ids", s.stage_id,
                f"input_stage_ids={sorted(set(s.input_stage_ids))} but the plan "
                f"references stages {leaf_ids}"))

        for leaf in leaves:
            prod = by_id.get(leaf.stage_id)
            if prod is None:
                v.append(PlanViolation(
                    "dangling-input", s.stage_id,
                    f"reads stage {leaf.stage_id} which is not in the stage list"))
                continue
            if leaf.output_partitions != prod.output_partitions:
                v.append(PlanViolation(
                    "edge-partitions", s.stage_id,
                    f"reads stage {prod.stage_id} expecting "
                    f"{leaf.output_partitions} partitions; the producer makes "
                    f"{prod.output_partitions}"))
            if bool(leaf.broadcast) != bool(prod.broadcast):
                v.append(PlanViolation(
                    "edge-broadcast", s.stage_id,
                    f"reads stage {prod.stage_id} with broadcast={leaf.broadcast} "
                    f"but the producer stage has broadcast={prod.broadcast}"))
            if isinstance(prod.plan, ShuffleWriterExec):
                produced = _schema_fields(prod.plan.input.df_schema)
                expected = _schema_fields(leaf.df_schema)
                if produced != expected:
                    v.append(PlanViolation(
                        "edge-schema", s.stage_id,
                        f"reads stage {prod.stage_id} expecting fields "
                        f"{expected} but the producer emits {produced}"))

        # mesh gating postconditions
        exchanges = _mesh_exchanges(plan)
        if bool(s.mesh) != bool(exchanges):
            v.append(PlanViolation(
                "mesh-flag", s.stage_id,
                f"mesh={s.mesh} but the plan contains {len(exchanges)} "
                f"MeshExchangeExec node(s); the flag and the plan must agree "
                f"(pop_next_task ships mesh stages as ONE unsliced task)"))
        if s.mesh and s.broadcast:
            v.append(PlanViolation(
                "mesh-broadcast", s.stage_id,
                "a mesh stage cannot be a broadcast producer (the merge gate "
                "rejects broadcast edges)"))
        for ex in exchanges:
            if ex.file_partitions != s.partitions:
                v.append(PlanViolation(
                    "mesh-buckets", s.stage_id,
                    f"mesh exchange routes {ex.file_partitions} device buckets "
                    f"but the stage spans {s.partitions} task partitions; the "
                    f"single mesh task must cover exactly the reduce buckets"))

    # acyclicity over the input-stage edges
    state: dict[int, int] = {}  # 0=visiting, 1=done

    def dfs(sid: int) -> bool:
        if state.get(sid) == 1:
            return True
        if state.get(sid) == 0:
            return False
        state[sid] = 0
        s = by_id.get(sid)
        ok = all(dfs(i) for i in (s.input_stage_ids if s else []) if i in by_id)
        state[sid] = 1
        return ok

    for sid in by_id:
        if not dfs(sid):
            v.append(PlanViolation("cycle", sid, "stage dependency cycle"))
            break
    return v


def verify_graph(graph) -> list[PlanViolation]:
    """verify_stages over the specs, plus runtime-state invariants."""
    from ballista_tpu_torch.serving.fast_lane import FAST_TASK_ID_BASE

    stages = [st.spec for st in graph.stages.values()]
    v = verify_stages(stages)
    if graph.next_task_id >= FAST_TASK_ID_BASE:
        v.append(PlanViolation(
            "task-id-band", 0,
            f"next_task_id={graph.next_task_id} has crossed the fast-lane "
            f"band (FAST_TASK_ID_BASE={FAST_TASK_ID_BASE}); graph and fast "
            f"tasks would collide in the executor task-id namespace"))
    from ballista_tpu_torch.serving.lease import DIRECT_TASK_ID_BASE

    for st in graph.stages.values():
        report = getattr(st, "skew_report", None)
        allowed_growth = getattr(report, "extra_partitions", 0) if report else 0
        if st.effective_partitions > st.spec.partitions + allowed_growth:
            v.append(PlanViolation(
                "aqe-grew", st.stage_id,
                f"effective_partitions={st.effective_partitions} exceeds the "
                f"planned {st.spec.partitions} plus the {allowed_growth} "
                f"slice partitions the skew report accounts for; AQE growth "
                f"must be backed by a SkewSplitReport"))
        v.extend(_verify_skew_splits(graph, st))
        for task_id in st.running:
            if task_id >= DIRECT_TASK_ID_BASE:
                v.append(PlanViolation(
                    "lease-band", st.stage_id,
                    f"running task {task_id} is inside the direct-dispatch "
                    f"lease band (>= {DIRECT_TASK_ID_BASE}); only a client "
                    f"holding an executor lease may mint ids there, never "
                    f"the scheduler's graph loop"))
            elif task_id >= FAST_TASK_ID_BASE:
                v.append(PlanViolation(
                    "task-id-band", st.stage_id,
                    f"running task {task_id} is inside the fast-lane id band"))
        if st.resolved_plan is not None and st.resolved_plan is not st.spec.plan:
            for leaf in _shuffle_leaves(st.resolved_plan):
                if isinstance(leaf, UnresolvedShuffleExec):
                    continue  # partially resolved plans are legal mid-flight
                src = getattr(leaf, "source_stage_id", None)
                if src is not None and src not in graph.stages:
                    v.append(PlanViolation(
                        "reader-source", st.stage_id,
                        f"resolved reader tagged source_stage_id={src}, which "
                        f"is not a stage of this graph"))
    return v


def _verify_skew_splits(graph, st) -> list[PlanViolation]:
    """Postconditions of an AQE skew split, checked against the stage's
    SkewSplitReport before any slice task runs. For each hot bucket, each
    non-broadcast reader's lists at the slice partitions must either each
    equal the producer's full bucket location list (duplicated build side)
    or concatenate exactly to it — cover / no-overlap / order over
    (map_partition, path) identity."""
    v: list[PlanViolation] = []
    report = getattr(st, "skew_report", None)
    if report is None or st.resolved_plan is None:
        return v
    readers = [l for l in _shuffle_leaves(st.resolved_plan)
               if isinstance(l, ShuffleReaderExec) and not l.broadcast]
    for split in report.splits:
        for r in readers:
            src = getattr(r, "source_stage_id", None)
            prod = graph.stages.get(src) if src is not None else None
            if prod is None:
                continue
            want = sorted(
                (l.map_partition, l.path) for l in prod.output_locations()
                if l.output_partition == split.bucket
            )
            slices: list[list[tuple]] = []
            truncated = False
            for p in split.partitions:
                if p >= len(r.partition_locations):
                    v.append(PlanViolation(
                        "skew-cover", st.stage_id,
                        f"split of bucket {split.bucket} names slice "
                        f"partition {p} but a reader of stage {src} only has "
                        f"{len(r.partition_locations)} partition lists"))
                    truncated = True
                    break
                slices.append([(l.map_partition, l.path)
                               for l in r.partition_locations[p]])
            if truncated:
                continue
            if want and all(s == want for s in slices):
                continue  # duplicated join build side: every slice sees it all
            got = [t for s in slices for t in s]
            if got == want:
                continue  # clean slicing: cover, no overlap, in order
            if sorted(got) == want:
                v.append(PlanViolation(
                    "skew-order", st.stage_id,
                    f"split of bucket {split.bucket} (stage {src} input) "
                    f"covers the bucket but permutes its map outputs; only "
                    f"in-order concatenation is byte-identical"))
            else:
                missing = len(set(want) - set(got))
                v.append(PlanViolation(
                    "skew-cover", st.stage_id,
                    f"split of bucket {split.bucket} (stage {src} input) "
                    f"does not partition the bucket's map outputs: "
                    f"{len(got)} slice locations vs {len(want)} produced "
                    f"({missing} missing); every map output must be read "
                    f"exactly once across the slices"))
    return v


def verify_grace(report) -> list[PlanViolation]:
    """Postconditions of a grace-partitioned join execution (an
    `hbm.GraceReport`). The stage checks these after every grace run; a
    violation demotes the stage to the CPU engine instead of serving a
    result the verifier cannot vouch for:

    - **cover**: the run + empty sub-bucket sets partition exactly
      [0, n_buckets): every build row's bucket was visited once, so no
      probe match was dropped or counted twice;
    - **order**: the sub-runs reunified in producer row order (probe rows
      are never permuted);
    - **depth**: recursion depth <= the configured cap, and the bucket
      count is exactly fanout**depth (past the cap the ladder must land
      on cpu_demote, not a wider split).
    """
    v: list[PlanViolation] = []

    def bad(code: str, message: str) -> None:
        v.append(PlanViolation(code, 0, f"[{report.stage_tag}] {message}"))

    run = set(report.buckets_run)
    empty = set(report.buckets_empty)
    if run & empty:
        bad("grace-cover", f"buckets {sorted(run & empty)} were reported "
            f"both run and empty")
    if run | empty != set(range(report.n_buckets)):
        bad("grace-cover",
            f"sub-buckets {sorted(run | empty)} do not cover "
            f"[0, {report.n_buckets}); the split must visit every bucket "
            f"exactly once")
    if report.merge != "producer-order":
        bad("grace-order", f"sub-runs merged as {report.merge!r}; only "
            f"producer-order reunification keeps the partials' order")
    if report.depth > report.max_depth:
        bad("grace-depth", f"recursion depth {report.depth} exceeds the "
            f"cap {report.max_depth}")
    if report.depth < 1:
        bad("grace-depth", f"grace ran with depth {report.depth}; a split "
            f"plan implies depth >= 1")
    if report.fanout < 2:
        bad("grace-depth", f"fanout {report.fanout} cannot split anything")
    elif report.n_buckets != report.fanout ** max(report.depth, 0):
        bad("grace-depth",
            f"{report.n_buckets} sub-buckets != fanout {report.fanout} ** "
            f"depth {report.depth}")
    return v


def check_grace(report) -> list[PlanViolation]:
    """verify_grace, returned (not raised): the stage turns violations
    into a CPU demotion."""
    return verify_grace(report)


def verify_lease_bands(leases) -> list[PlanViolation]:
    """Direct-dispatch band invariants over a set of `ExecutorLease`s
    (live or historical). A lease hands a client a private task-id range;
    byte-identity of direct results depends on those ids never colliding
    with scheduler-assigned ids (graph tasks < FAST_TASK_ID_BASE, fast
    jobs < DIRECT_TASK_ID_BASE) or with each other:

    - **floor**: every band starts at or above `DIRECT_TASK_ID_BASE`;
    - **disjoint**: no two bands overlap (the registry allocates them
      monotonically — an overlap means two clients can mint the same id
      at one executor);
    - **cursor**: a lease's allocation cursor stays within its band
      (`0 <= next_offset <= band_size`).
    """
    from ballista_tpu_torch.serving.lease import DIRECT_TASK_ID_BASE

    v: list[PlanViolation] = []

    def bad(code: str, lease, message: str) -> None:
        v.append(PlanViolation(code, 0, f"[lease {lease.lease_id}] {message}"))

    ranges = []
    for lease in leases:
        start, size = lease.band_start, lease.band_size
        if size <= 0:
            bad("lease-band", lease, f"band_size={size}; an empty band can "
                f"never admit a task")
            continue
        if start < DIRECT_TASK_ID_BASE:
            bad("lease-band", lease,
                f"band [{start}, {start + size}) starts below "
                f"DIRECT_TASK_ID_BASE={DIRECT_TASK_ID_BASE}; direct ids "
                f"would collide with scheduler-assigned task ids")
        cursor = getattr(lease, "next_offset", 0)
        if not 0 <= cursor <= size:
            bad("lease-band", lease,
                f"allocation cursor next_offset={cursor} is outside "
                f"[0, band_size={size}]; ids minted past the band spill "
                f"into a neighbouring lease's range")
        ranges.append((start, start + size, lease))
    ranges.sort(key=lambda r: r[0])
    for (a_lo, a_hi, a), (b_lo, b_hi, b) in zip(ranges, ranges[1:]):
        if b_lo < a_hi:
            bad("lease-band", b,
                f"band [{b_lo}, {b_hi}) overlaps lease {a.lease_id}'s "
                f"band [{a_lo}, {a_hi}); two clients could mint the same "
                f"task id at one executor")
    return v


def check_lease_bands(leases) -> None:
    violations = verify_lease_bands(leases)
    if violations:
        raise PlanVerificationError(violations)


def check_stages(stages) -> None:
    violations = verify_stages(stages)
    if violations:
        raise PlanVerificationError(violations)


def check_graph(graph) -> None:
    violations = verify_graph(graph)
    if violations:
        raise PlanVerificationError(violations)
