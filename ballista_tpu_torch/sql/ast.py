"""Statement-level AST.

Expressions inside these nodes are already `ballista_tpu_torch.plan.expressions`
objects (the parser emits the expression IR directly); subquery expressions
carry a raw `SelectStmt` that the planner replaces with a planned
LogicalPlan during binding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ballista_tpu_torch.plan.expressions import Expr, SortKey


@dataclass
class TableName:
    name: str
    alias: Optional[str] = None


@dataclass
class DerivedTable:
    select: "SelectStmt"
    alias: str


@dataclass
class JoinClause:
    left: Any  # TableName | DerivedTable | JoinClause
    right: Any
    join_type: str  # inner/left/right/full/cross
    on: Optional[Expr] = None


@dataclass
class SelectStmt:
    projections: list[Expr] = field(default_factory=list)
    distinct: bool = False
    from_tables: list[Any] = field(default_factory=list)  # comma-separated refs
    where: Optional[Expr] = None
    group_by: list[Any] = field(default_factory=list)  # Expr | int ordinal
    # ROLLUP/CUBE/GROUPING SETS: list of grouping sets (each a list of
    # indices into group_by); None = plain GROUP BY
    grouping_sets: Optional[list[list[int]]] = None
    having: Optional[Expr] = None
    order_by: list[SortKey] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    ctes: list[tuple[str, "SelectStmt"]] = field(default_factory=list)
    set_op: Optional[tuple[str, "SelectStmt"]] = None  # ("union"|"union_all", rhs)


@dataclass
class ExplainStmt:
    inner: Any
    analyze: bool = False
    verbose: bool = False


@dataclass
class CreateExternalTable:
    name: str
    location: str
    file_format: str = "parquet"


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class ValuesClause:
    rows: list  # list of literal rows
    alias: str = "__values__"
    column_names: list = None  # optional t(c1, c2, ...) renames


@dataclass
class ShowColumns:
    table: str


@dataclass
class ShowTables:
    pass


@dataclass
class SetVariable:
    key: str
    value: str
