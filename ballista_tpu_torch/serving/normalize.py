"""Plan normalization: literal lifting, shape fingerprints, param binding.

The parameterized plan cache keys on the *optimized* logical plan with
every literal replaced by a typed parameter slot. Normalizing after the
optimizer (not the parser) is deliberate: constant folding collapses
expressions like `date '1998-12-01' - interval '90' day` into a single
literal, so two texts that fold to the same shape share one entry, and a
folded constant becomes an ordinary parameter of the folded plan rather
than a hole the optimizer can no longer reach.

Binding happens at the PHYSICAL level. Physical nodes embed the same
logical `Expr` objects they were planned from, so a cached template is a
physical tree whose literals carry `param` slot tags; executing it for
new values is a structural rebuild (fresh node copies, fresh metrics)
that substitutes `Literal(values[i])` for every tagged literal — no
re-planning, no shared mutable state with the cached copy.
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field

from ballista_tpu_torch.plan.expressions import Expr, Literal, SortKey, literal_type, transform_expr
from ballista_tpu_torch.plan.logical import LogicalPlan, Values
from ballista_tpu_torch.plan.physical import ExecutionPlan, Metrics


class _Slot:
    """Placeholder literal value used only while rendering the cache key;
    its str() masks the concrete value with the slot index + arrow type."""

    __slots__ = ("token",)

    def __init__(self, token: str):
        self.token = token

    def __str__(self) -> str:
        return self.token

    __repr__ = __str__


@dataclass
class LiftResult:
    """Outcome of lifting literals out of one optimized logical plan."""

    tagged: LogicalPlan | None  # literals carry param slot tags
    values: tuple  # slot index -> literal value
    type_tags: tuple[str, ...]  # slot index -> str(arrow type)
    tables: tuple[str, ...]  # referenced table names (version vector)
    cacheable: bool = True
    reason: str = ""  # why not, when cacheable is False
    key: str = field(default="", repr=False)  # shape fingerprint (no config)


def _map_value(v, expr_fn, seen_plans):
    """Map `expr_fn` over every Expr reachable from a node attribute,
    rebuilding containers (lists/tuples/dicts/SortKeys) and nested plan
    nodes along the way. Returns the original object when untouched."""
    if isinstance(v, Expr):
        return transform_expr(v, expr_fn)
    if isinstance(v, SortKey):
        e = transform_expr(v.expr, expr_fn)
        return v if e is v.expr else SortKey(e, v.ascending, v.nulls_first)
    if isinstance(v, LogicalPlan):
        return _rebuild_logical(v, expr_fn, seen_plans)
    if isinstance(v, ExecutionPlan):
        return _rebuild_physical(v, expr_fn)
    if isinstance(v, list):
        out = [_map_value(x, expr_fn, seen_plans) for x in v]
        return v if all(a is b for a, b in zip(out, v)) else out
    if isinstance(v, tuple):
        out = tuple(_map_value(x, expr_fn, seen_plans) for x in v)
        return v if all(a is b for a, b in zip(out, v)) else out
    if isinstance(v, dict):
        out = {k: _map_value(x, expr_fn, seen_plans) for k, x in v.items()}
        return v if all(out[k] is v[k] for k in v) else out
    return v


def _rebuild_logical(p: LogicalPlan, expr_fn, seen_plans=None) -> LogicalPlan:
    """Shallow-copy rebuild of a logical node with `expr_fn` applied to
    every embedded expression. Generic over node shape (attribute scan) so
    new node types cannot silently dodge the walk; the schema attribute is
    carried over untouched (exprs never change result types here)."""
    if seen_plans is None:
        seen_plans = {}
    got = seen_plans.get(id(p))
    if got is not None:
        return got
    new = copy.copy(p)
    for name, val in list(vars(new).items()):
        if name == "schema":
            continue
        mapped = _map_value(val, expr_fn, seen_plans)
        if mapped is not val:
            object.__setattr__(new, name, mapped)
    seen_plans[id(p)] = new
    return new


def _rebuild_physical(node: ExecutionPlan, expr_fn) -> ExecutionPlan:
    """Shallow-copy rebuild of a physical tree with `expr_fn` applied to
    every embedded logical expression. Every node gets fresh Metrics so a
    bound copy never shares counters with the cached template (or with
    another in-flight job bound from the same template)."""
    new = copy.copy(node)
    new.metrics = Metrics()
    for name, val in list(vars(new).items()):
        if name == "metrics":
            continue
        mapped = _map_value(val, expr_fn, {})
        if mapped is not val:
            setattr(new, name, mapped)
    return new


def _walk_exprs(node, visit, seen):
    """Visit every Expr reachable from a plan tree (logical or physical)."""
    if id(node) in seen:
        return
    seen.add(id(node))

    def scan(v):
        if isinstance(v, Expr):
            visit(v)
            for c in v.children():
                scan(c)
        elif isinstance(v, SortKey):
            scan(v.expr)
        elif isinstance(v, (LogicalPlan, ExecutionPlan)):
            _walk_exprs(v, visit, seen)
        elif isinstance(v, (list, tuple)):
            for x in v:
                scan(x)
        elif isinstance(v, dict):
            for x in v.values():
                scan(x)

    for name, val in vars(node).items():
        if name in ("schema", "metrics"):
            continue
        scan(val)


def lift_parameters(optimized: LogicalPlan) -> LiftResult:
    """Lift every literal of an optimized plan into a parameter slot.

    Returns a tagged copy of the plan (each Literal annotated with its
    slot index), the slot values/types in deterministic walk order, the
    referenced table names, and the shape fingerprint. Plans the cache
    cannot represent soundly (subqueries the decorrelator left behind,
    VALUES rows, literal types the engine cannot re-type) come back
    `cacheable=False` and are planned the ordinary way."""
    from ballista_tpu_torch.plan.logical import TableScan

    values: list = []
    tags: list[str] = []
    tables: list[str] = []
    bad: list[str] = []

    def tag(e: Expr) -> Expr:
        if getattr(e, "plan", None) is not None and not isinstance(e, Literal):
            # un-decorrelated subquery: its inner plan has its own literals
            # that this walk does not reach — refuse rather than alias them
            bad.append(f"subquery expr {type(e).__name__}")
            return e
        if isinstance(e, Literal) and e.param is None:
            try:
                t = str(literal_type(e.value))
            except Exception:  # noqa: BLE001 — exotic literal type
                bad.append(f"unsupported literal {type(e.value).__name__}")
                return e
            idx = len(values)
            values.append(e.value)
            tags.append(t)
            return Literal(e.value, param=idx)
        return e

    tagged = _rebuild_logical(optimized, tag)

    def check(p: LogicalPlan):
        if isinstance(p, Values):
            bad.append("VALUES rows")
        if isinstance(p, TableScan):
            tables.append(p.table_name.lower())
        for c in p.children():
            check(c)

    check(tagged)
    if bad:
        return LiftResult(None, (), (), tuple(sorted(set(tables))),
                          cacheable=False, reason="; ".join(sorted(set(bad))))

    # render the shape key from a masked copy: every tagged literal prints
    # as ?slot:type, so the key is independent of the bound values but not
    # of their types (decimal literal types carry value-derived scale)
    def mask(e: Expr) -> Expr:
        if isinstance(e, Literal) and e.param is not None:
            return Literal(_Slot(f"?{e.param}:{tags[e.param]}"))
        return e

    masked = _rebuild_logical(tagged, mask)
    key = hashlib.sha256(masked.display().encode()).hexdigest()
    return LiftResult(tagged, tuple(values), tuple(tags),
                      tuple(sorted(set(tables))), key=key)


def config_fingerprint(cfg) -> str:
    """Session-config fingerprint folded into every cache key: catalog
    registrations ride in the config (`ballista.catalog.table.*`), so a
    table pointed at a new path naturally changes every dependent key."""
    pairs = sorted(cfg.to_key_value_pairs())
    return hashlib.sha256(repr(pairs).encode()).hexdigest()[:16]


def collect_physical_params(plan: ExecutionPlan) -> set[int]:
    """Slot indices that survived physical planning. A slot the planner
    consumed (constant-folded into a scan range, say) cannot be re-bound;
    the template then only serves exact-value repeats."""
    out: set[int] = set()

    def visit(e: Expr):
        if isinstance(e, Literal) and e.param is not None:
            out.add(e.param)

    _walk_exprs(plan, visit, set())
    return out


def collect_scan_tables(plan: ExecutionPlan) -> set[str]:
    """Named tables a physical plan scans (lower-cased). Used to decide
    whether a cached plan is exposed to append ingestion: direct dispatch
    demotes to the scheduler when any of these tables has retained deltas,
    and the serving tier subscribes continuous queries to exactly this
    set. Memory scans have no name and so never appear."""
    out: set[str] = set()
    stack = [plan]
    while stack:
        node = stack.pop()
        name = getattr(node, "table_name", "")
        if name:
            out.add(str(name).lower())
        stack.extend(node.children())
    return out


def bind_physical(template: ExecutionPlan, values: tuple) -> ExecutionPlan:
    """Fresh executable copy of a cached template with `values` bound into
    its parameter slots. Always rebuilds — even for the template's own
    values — so no two jobs (nor the cache itself) share node state."""

    def bind(e: Expr) -> Expr:
        if isinstance(e, Literal) and e.param is not None:
            return Literal(values[e.param])
        return e

    return _rebuild_physical(template, bind)


def bind_logical(tagged: LogicalPlan, values: tuple) -> LogicalPlan:
    """Bind values into a tagged LOGICAL plan. Fallback for templates the
    physical planner made non-bindable (it consumed a slot): substitute at
    the logical level, then run physical planning normally."""

    def bind(e: Expr) -> Expr:
        if isinstance(e, Literal) and e.param is not None:
            return Literal(values[e.param])
        return e

    return _rebuild_logical(tagged, bind)


def encode_params(values) -> str:
    """JSON-encode prepared-statement parameters for the wire. Dates and
    decimals don't survive plain JSON, so each value rides with a tag."""
    import json
    from datetime import date, datetime
    from decimal import Decimal

    out = []
    for v in values:
        if isinstance(v, datetime):
            out.append({"t": "datetime", "v": v.isoformat()})
        elif isinstance(v, date):
            out.append({"t": "date", "v": v.isoformat()})
        elif isinstance(v, Decimal):
            out.append({"t": "decimal", "v": str(v)})
        else:
            out.append({"t": "raw", "v": v})
    return json.dumps(out)


def decode_params(payload: str) -> tuple:
    import json
    from datetime import date, datetime
    from decimal import Decimal

    out = []
    for item in json.loads(payload):
        t, v = item["t"], item["v"]
        if t == "date":
            out.append(date.fromisoformat(v))
        elif t == "datetime":
            out.append(datetime.fromisoformat(v))
        elif t == "decimal":
            out.append(Decimal(v))
        else:
            out.append(v)
    return tuple(out)
