"""Logical plan nodes.

The relational algebra the SQL frontend lowers into and the optimizer
rewrites. Scoped to the reference's exercised surface (TPC-H/TPC-DS class):
scan/filter/project/aggregate/join/sort/limit/distinct/union/values plus
subquery alias. Each node knows its output schema; display() produces the
indented tree used by golden-plan tests (reference: tpch_plan_stability).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import pyarrow as pa

from ballista_tpu_torch.errors import PlanningError, SchemaError
from ballista_tpu_torch.plan.expressions import (
    AggregateFunction,
    Expr,
    SortKey,
    to_field,
)
from ballista_tpu_torch.plan.schema import DFField, DFSchema


class LogicalPlan:
    schema: DFSchema

    def children(self) -> list["LogicalPlan"]:
        return []

    def with_children(self, children: list["LogicalPlan"]) -> "LogicalPlan":
        assert not children
        return self

    def node_str(self) -> str:
        return type(self).__name__

    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [pad + self.node_str()]
        for c in self.children():
            lines.append(c.display(indent + 1))
        return "\n".join(lines)


@dataclass
class TableScan(LogicalPlan):
    table_name: str
    provider: Any  # TableProvider
    projection: Optional[list[int]] = None  # pushed-down column indices
    filters: list[Expr] = field(default_factory=list)  # pushed-down predicates
    alias: Optional[str] = None

    def __post_init__(self):
        qualifier = self.alias or self.table_name
        full = self.provider.df_schema().with_qualifier(qualifier)
        if self.projection is None:
            self.schema = full
        else:
            self.schema = DFSchema([full.field(i) for i in self.projection])

    def node_str(self) -> str:
        proj = ""
        if self.projection is not None:
            proj = f" projection=[{', '.join(f.name for f in self.schema)}]"
        filt = f" filters=[{', '.join(map(str, self.filters))}]" if self.filters else ""
        al = f" AS {self.alias}" if self.alias and self.alias != self.table_name else ""
        return f"TableScan: {self.table_name}{al}{proj}{filt}"


@dataclass
class Projection(LogicalPlan):
    input: LogicalPlan
    exprs: list[Expr]

    def __post_init__(self):
        self.schema = DFSchema([to_field(e, self.input.schema) for e in self.exprs])

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Projection(c[0], self.exprs)

    def node_str(self) -> str:
        return f"Projection: {', '.join(map(str, self.exprs))}"


@dataclass
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr

    def __post_init__(self):
        self.schema = self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Filter(c[0], self.predicate)

    def node_str(self) -> str:
        return f"Filter: {self.predicate}"


@dataclass
class Aggregate(LogicalPlan):
    input: LogicalPlan
    group_exprs: list[Expr]
    agg_exprs: list[Expr]  # AggregateFunction possibly wrapped in Alias

    def __post_init__(self):
        fields = [to_field(e, self.input.schema) for e in self.group_exprs]
        fields += [to_field(e, self.input.schema) for e in self.agg_exprs]
        self.schema = DFSchema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Aggregate(c[0], self.group_exprs, self.agg_exprs)

    def node_str(self) -> str:
        g = ", ".join(map(str, self.group_exprs))
        a = ", ".join(map(str, self.agg_exprs))
        return f"Aggregate: groupBy=[{g}], aggr=[{a}]"


JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti", "right_semi", "right_anti")


@dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    on: list[tuple[Expr, Expr]]  # equi-join key pairs (left expr, right expr)
    join_type: str = "inner"
    filter: Optional[Expr] = None  # non-equi residual predicate

    def __post_init__(self):
        if self.join_type not in JOIN_TYPES:
            raise PlanningError(f"bad join type {self.join_type}")
        if self.join_type in ("left_semi", "left_anti"):
            self.schema = self.left.schema
        elif self.join_type in ("right_semi", "right_anti"):
            self.schema = self.right.schema
        else:
            self.schema = self.left.schema.merge(self.right.schema)

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Join(c[0], c[1], self.on, self.join_type, self.filter)

    def node_str(self) -> str:
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        f = f", filter={self.filter}" if self.filter is not None else ""
        return f"Join: type={self.join_type}, on=[{on}]{f}"


@dataclass
class CrossJoin(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan

    def __post_init__(self):
        self.schema = self.left.schema.merge(self.right.schema)

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return CrossJoin(c[0], c[1])

    def node_str(self) -> str:
        return "CrossJoin"


@dataclass
class Window(LogicalPlan):
    """Appends one column per window expression (named __win{i}) to the
    input; the projection above references them by name."""

    input: LogicalPlan
    window_exprs: list[Expr]  # WindowFunction nodes

    def __post_init__(self):
        from ballista_tpu_torch.plan.schema import DFField

        fields = list(self.input.schema.fields)
        for i, e in enumerate(self.window_exprs):
            fields.append(DFField(f"__win{i}", e.data_type(self.input.schema)))
        self.schema = DFSchema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Window(c[0], self.window_exprs)

    def node_str(self) -> str:
        return f"Window: {', '.join(map(str, self.window_exprs))}"


@dataclass
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: list[SortKey]
    fetch: Optional[int] = None  # top-k pushdown

    def __post_init__(self):
        self.schema = self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Sort(c[0], self.keys, self.fetch)

    def node_str(self) -> str:
        k = ", ".join(map(str, self.keys))
        f = f", fetch={self.fetch}" if self.fetch is not None else ""
        return f"Sort: {k}{f}"


@dataclass
class Limit(LogicalPlan):
    input: LogicalPlan
    fetch: Optional[int]
    skip: int = 0

    def __post_init__(self):
        self.schema = self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Limit(c[0], self.fetch, self.skip)

    def node_str(self) -> str:
        return f"Limit: fetch={self.fetch}, skip={self.skip}"


@dataclass
class Distinct(LogicalPlan):
    input: LogicalPlan

    def __post_init__(self):
        self.schema = self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Distinct(c[0])

    def node_str(self) -> str:
        return "Distinct"


@dataclass
class SubqueryAlias(LogicalPlan):
    input: LogicalPlan
    alias: str

    def __post_init__(self):
        self.schema = self.input.schema.strip_qualifiers().with_qualifier(self.alias)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return SubqueryAlias(c[0], self.alias)

    def node_str(self) -> str:
        return f"SubqueryAlias: {self.alias}"


@dataclass
class Union(LogicalPlan):
    inputs: list[LogicalPlan]
    all: bool = True

    def __post_init__(self):
        self.schema = self.inputs[0].schema.strip_qualifiers()

    def children(self) -> list[LogicalPlan]:
        return list(self.inputs)

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Union(c, self.all)

    def node_str(self) -> str:
        return "Union" + ("" if self.all else " Distinct")


@dataclass
class Values(LogicalPlan):
    rows: list[list[Any]]
    schema: DFSchema = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.schema is None:
            from ballista_tpu_torch.plan.expressions import literal_type

            fields = []
            for i, v in enumerate(self.rows[0]):
                fields.append(DFField(f"column{i + 1}", literal_type(v), True, None))
            self.schema = DFSchema(fields)

    def node_str(self) -> str:
        return f"Values: {len(self.rows)} rows"


@dataclass
class EmptyRelation(LogicalPlan):
    produce_one_row: bool = False
    schema: DFSchema = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.schema is None:
            self.schema = DFSchema([])

    def node_str(self) -> str:
        return f"EmptyRelation: produce_one_row={self.produce_one_row}"


@dataclass
class Explain(LogicalPlan):
    input: LogicalPlan
    analyze: bool = False
    verbose: bool = False

    def __post_init__(self):
        self.schema = DFSchema(
            [DFField("plan_type", pa.string(), False), DFField("plan", pa.string(), False)]
        )

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, c: list[LogicalPlan]) -> "LogicalPlan":
        return Explain(c[0], self.analyze, self.verbose)

    def node_str(self) -> str:
        return "Explain" + (" Analyze" if self.analyze else "")


def transform_plan_up(plan: LogicalPlan, fn) -> LogicalPlan:
    kids = plan.children()
    if kids:
        new = [transform_plan_up(k, fn) for k in kids]
        plan = plan.with_children(new)
    return fn(plan)
