"""Postconditions of a grace-partitioned join execution.

Counterpart of the JAX package's analysis/plan_check.py, cut to
`PlanViolation` and the grace verifier (`verify_grace` / `check_grace`),
which the stage compiler runs after every grace split before it serves a
result.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PlanViolation:
    code: str  # stable machine tag, e.g. "grace-cover"
    stage_id: int
    message: str

    def render(self) -> str:
        return f"stage {self.stage_id}: [{self.code}] {self.message}"


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
