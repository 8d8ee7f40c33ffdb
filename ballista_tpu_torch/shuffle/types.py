"""Shuffle partition identity and location types.

Mirrors the reference's PartitionId / PartitionLocation / PartitionStats
(ballista/core/src/serde/scheduler/mod.rs): a completed map task publishes
one location per output partition; downstream ShuffleReaderExec leaves
consume lists of these.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PartitionId:
    job_id: str
    stage_id: int
    partition_id: int


@dataclass
class PartitionStats:
    num_rows: int = 0
    num_batches: int = 0
    num_bytes: int = 0


@dataclass
class PartitionLocation:
    """Where one (stage, output_partition) shuffle result lives."""

    map_partition: int
    job_id: str
    stage_id: int
    output_partition: int
    executor_id: str = ""
    host: str = ""
    flight_port: int = 0
    path: str = ""  # data file path on the executor
    layout: str = "hash"  # hash | sort
    stats: PartitionStats = field(default_factory=PartitionStats)

    @property
    def addr(self) -> str:
        """Data-plane dial address of the owning executor — the coalescing
        key: locations sharing an addr can ship in one fetch RPC."""
        return f"{self.host}:{self.flight_port}"
