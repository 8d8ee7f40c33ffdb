"""Schema model for logical/physical plans.

A thin qualified-name layer over `pyarrow.Schema`: each field may carry a
relation qualifier (`lineitem.l_orderkey`). The reference gets this from
DataFusion's DFSchema; we rebuild just the parts planning needs — qualified
lookup, ambiguity detection, merge for joins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import pyarrow as pa

from ballista_tpu_torch.errors import SchemaError


@dataclass(frozen=True)
class DFField:
    name: str
    dtype: pa.DataType
    nullable: bool = True
    qualifier: str | None = None

    @property
    def qualified_name(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name

    def to_arrow(self) -> pa.Field:
        return pa.field(self.name, self.dtype, self.nullable)

    def __repr__(self) -> str:
        return f"{self.qualified_name}:{self.dtype}"


class DFSchema:
    def __init__(self, fields: list[DFField]):
        self.fields = list(fields)
        self._by_name: dict[str, list[int]] = {}
        for i, f in enumerate(self.fields):
            self._by_name.setdefault(f.name, []).append(i)

    @classmethod
    def from_arrow(cls, schema: pa.Schema, qualifier: str | None = None) -> "DFSchema":
        return cls([DFField(f.name, f.type, f.nullable, qualifier) for f in schema])

    def to_arrow(self) -> pa.Schema:
        return pa.schema([f.to_arrow() for f in self.fields])

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self) -> Iterator[DFField]:
        return iter(self.fields)

    def field(self, i: int) -> DFField:
        return self.fields[i]

    def index_of(self, name: str, qualifier: str | None = None) -> int:
        """Resolve a possibly-qualified column reference to a field index."""
        if qualifier is not None:
            matches = [
                i
                for i in self._by_name.get(name, [])
                if self.fields[i].qualifier == qualifier
            ]
            if not matches:
                raise SchemaError(f"no column {qualifier}.{name} in schema {self}")
            if len(matches) > 1:
                raise SchemaError(f"ambiguous column {qualifier}.{name}")
            return matches[0]
        matches = self._by_name.get(name, [])
        if not matches:
            raise SchemaError(f"no column {name} in schema {self}")
        if len(matches) > 1:
            quals = {self.fields[i].qualifier for i in matches}
            if len(quals) > 1:
                raise SchemaError(
                    f"ambiguous column {name}: qualify with one of {sorted(q or '?' for q in quals)}"
                )
        return matches[0]

    def maybe_index_of(self, name: str, qualifier: str | None = None) -> int | None:
        try:
            return self.index_of(name, qualifier)
        except SchemaError:
            return None

    def merge(self, other: "DFSchema") -> "DFSchema":
        return DFSchema(self.fields + other.fields)

    def strip_qualifiers(self) -> "DFSchema":
        return DFSchema([DFField(f.name, f.dtype, f.nullable, None) for f in self.fields])

    def with_qualifier(self, qualifier: str) -> "DFSchema":
        return DFSchema([DFField(f.name, f.dtype, f.nullable, qualifier) for f in self.fields])

    def __repr__(self) -> str:
        return "[" + ", ".join(repr(f) for f in self.fields) + "]"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DFSchema) and [
            (f.name, f.dtype, f.qualifier) for f in self.fields
        ] == [(f.name, f.dtype, f.qualifier) for f in other.fields]


EMPTY_SCHEMA = DFSchema([])
