"""Table providers: how scans get their data.

The reference delegates to DataFusion's TableProvider/ObjectStore stack
(listing tables over parquet on local disk or S3). We provide:

- ParquetTable: a directory (or list) of parquet files; file-level
  partitioning, column projection + predicate pushdown into the reader,
  row-group pruning via parquet statistics.
- MemoryTable: in-memory record batches (used by tests / VALUES / caches).

Statistics (row counts, byte sizes, per-column min/max) feed the physical
optimizer's broadcast-join decisions, matching the reference's
JoinSelection-by-stats (scheduler/src/physical_optimizer/join_selection.rs).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Any, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ballista_tpu_torch.plan.schema import DFSchema


@dataclass
class ColumnStats:
    min_value: Any = None
    max_value: Any = None
    null_count: int | None = None
    distinct_count: int | None = None


@dataclass
class TableStats:
    num_rows: int | None = None
    total_bytes: int | None = None
    columns: dict[str, ColumnStats] | None = None

    @property
    def exact(self) -> bool:
        return self.num_rows is not None


class TableProvider:
    def arrow_schema(self) -> pa.Schema:
        raise NotImplementedError

    def df_schema(self) -> DFSchema:
        return DFSchema.from_arrow(self.arrow_schema())

    def statistics(self) -> TableStats:
        return TableStats()

    def scan_partitions(self, target_partitions: int) -> list[dict]:
        """Split the table into partition descriptors (serializable dicts).

        Each descriptor is what one scan task reads; the scheduler's per-task
        plan restriction slices this list (reference: task_builder.rs).
        """
        raise NotImplementedError


class ParquetTable(TableProvider):
    def __init__(self, path: str, collect_statistics: bool = True):
        self.path = path
        if path.startswith("s3://"):
            from ballista_tpu_torch.plan.object_store import resolve_filesystem
            import pyarrow.fs as pafs

            fs, inner = resolve_filesystem(path)
            infos = fs.get_file_info(pafs.FileSelector(inner.rstrip("/"), recursive=True))
            self.files = sorted(
                "s3://" + i.path for i in infos if i.path.endswith(".parquet")
            ) or [path]
        elif os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "**", "*.parquet"), recursive=True))
        elif "*" in path:
            self.files = sorted(glob.glob(path))
        else:
            self.files = [path]
        if not self.files:
            raise FileNotFoundError(f"no parquet files under {path}")
        self._schema = _normalize_schema(_read_schema(self.files[0]))
        self._stats: TableStats | None = None
        if collect_statistics:
            self._collect_stats()

    def arrow_schema(self) -> pa.Schema:
        return self._schema

    def _collect_stats(self) -> None:
        rows = 0
        tbytes = 0
        for f in self.files:
            md = _read_metadata(f)
            rows += md.num_rows
            tbytes += sum(
                md.row_group(i).total_byte_size for i in range(md.num_row_groups)
            )
        self._stats = TableStats(num_rows=rows, total_bytes=tbytes)

    def statistics(self) -> TableStats:
        return self._stats or TableStats()

    def scan_partitions(self, target_partitions: int) -> list[dict]:
        """One partition per (file, row-group range), rebalanced to roughly
        `target_partitions` groups by byte size."""
        units: list[tuple[str, int, int]] = []  # (file, rg_index, bytes)
        for f in self.files:
            md = _read_metadata(f)
            for rg in range(md.num_row_groups):
                units.append((f, rg, md.row_group(rg).total_byte_size))
        if not units:
            return [{"file": f, "row_groups": None} for f in self.files]
        target = max(1, min(target_partitions, len(units)))
        # greedy LPT bin packing by bytes
        bins: list[list[tuple[str, int]]] = [[] for _ in range(target)]
        sizes = [0] * target
        for f, rg, sz in sorted(units, key=lambda u: -u[2]):
            i = sizes.index(min(sizes))
            bins[i].append((f, rg))
            sizes[i] += sz
        parts = []
        for b in bins:
            if not b:
                continue
            by_file: dict[str, list[int]] = {}
            for f, rg in b:
                by_file.setdefault(f, []).append(rg)
            parts.append(
                {"files": [{"file": f, "row_groups": sorted(rgs)} for f, rgs in sorted(by_file.items())]}
            )
        return parts


def _normalize_schema(schema: pa.Schema) -> pa.Schema:
    """Exact decimal policy: decimal128 columns keep their type end-to-end —
    parser literals carry minimal precision, arithmetic follows Arrow's
    decimal rules with decimal256 widening (plan/expressions.py::
    decimal_arith_type), and sums aggregate at max precision. This replaces
    the round-4 float64 coercion policy (the reference gets the same
    exactness from DataFusion decimal128; SURVEY §7 hard-part #2). Only
    decimals beyond 256-bit range — which parquet cannot produce — would
    need normalization, so this is now the identity."""
    return schema


def _read_schema(path: str) -> pa.Schema:
    if path.startswith("s3://"):
        from ballista_tpu_torch.plan.object_store import resolve_filesystem

        fs, inner = resolve_filesystem(path)
        return pq.read_schema(inner, filesystem=fs)
    return pq.read_schema(path)


def _read_metadata(path: str):
    if path.startswith("s3://"):
        from ballista_tpu_torch.plan.object_store import resolve_filesystem

        fs, inner = resolve_filesystem(path)
        return pq.read_metadata(inner, filesystem=fs)
    return pq.read_metadata(path)


class MemoryTable(TableProvider):
    def __init__(self, batches: list[pa.RecordBatch], schema: pa.Schema | None = None, partitions: int = 1):
        raw = schema or (batches[0].schema if batches else pa.schema([]))
        self._schema = _normalize_schema(raw)
        if self._schema is not raw and batches:
            tbl = pa.Table.from_batches(batches, raw).cast(self._schema)
            batches = tbl.to_batches()
        self.batches = batches
        self.partitions = max(1, partitions)

    @classmethod
    def from_table(cls, table: pa.Table, partitions: int = 1) -> "MemoryTable":
        return cls(table.to_batches(), table.schema, partitions)

    def arrow_schema(self) -> pa.Schema:
        return self._schema

    def statistics(self) -> TableStats:
        rows = sum(b.num_rows for b in self.batches)
        nbytes = sum(b.nbytes for b in self.batches)
        return TableStats(num_rows=rows, total_bytes=nbytes)

    def scan_partitions(self, target_partitions: int) -> list[dict]:
        n = min(self.partitions, max(1, len(self.batches))) if self.batches else 1
        return [{"memory_partition": i, "of": n} for i in range(n)]


class AppendedTable(TableProvider):
    """A base provider overlaid with appended in-memory batches — local
    mode's mirror of the scheduler's ingest DeltaRegistry. `ctx.append`
    wraps the registered provider once and extends the overlay on each
    call; the planner unions the base scan with a memory scan of the
    overlay (engine/physical_planner.py::_plan_scan), so reads always see
    base + appends without rewriting files."""

    def __init__(self, base: TableProvider):
        self.base = base
        self.batches: list[pa.RecordBatch] = []
        self.version = 0

    def append(self, batches: list[pa.RecordBatch]) -> int:
        self.batches.extend(batches)
        self.version += 1
        return self.version

    def arrow_schema(self) -> pa.Schema:
        return self.base.arrow_schema()

    def statistics(self) -> TableStats:
        base = self.base.statistics()
        if base.num_rows is None:
            return TableStats()
        rows = sum(b.num_rows for b in self.batches)
        nbytes = sum(b.nbytes for b in self.batches)
        return TableStats(base.num_rows + rows, (base.total_bytes or 0) + nbytes,
                          base.columns)

    def scan_partitions(self, target_partitions: int) -> list[dict]:
        return self.base.scan_partitions(target_partitions)


class Catalog:
    """Session table registry (names → providers)."""

    def __init__(self):
        self.tables: dict[str, TableProvider] = {}

    def register(self, name: str, provider: TableProvider) -> None:
        self.tables[name.lower()] = provider

    def get(self, name: str) -> TableProvider | None:
        return self.tables.get(name.lower())

    def deregister(self, name: str) -> None:
        self.tables.pop(name.lower(), None)

    def names(self) -> list[str]:
        return sorted(self.tables)
