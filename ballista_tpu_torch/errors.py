"""Error model.

Mirrors the reference's `BallistaError` taxonomy
(ballista/core/src/error.rs:37): distinct variants for planning vs execution
vs transport vs cancellation matter because the scheduler's retry policy
branches on them (fetch failures → recompute upstream stage; task failures →
bounded per-stage retries; cancellation → no retry).
"""

from __future__ import annotations


class BallistaError(Exception):
    """Base class for all engine errors."""

    retryable: bool = False


class NotImplementedError_(BallistaError):
    pass


class GeneralError(BallistaError):
    pass


class PlanningError(BallistaError):
    """SQL analysis / planning failed. Never retryable."""


class SqlParseError(PlanningError):
    pass


class SchemaError(PlanningError):
    pass


class ExecutionError(BallistaError):
    """An operator failed at runtime on the executor."""

    def __init__(self, msg: str, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


class FetchFailed(BallistaError):
    """A shuffle partition could not be fetched.

    Carries enough identity for the scheduler to mark the *upstream* stage's
    output lost and recompute it (reference: ResultLost failure reason,
    ballista.proto:595, handled by rerun_successful_stage,
    scheduler/src/state/execution_graph.rs:216).
    """

    retryable = True

    def __init__(self, executor_id: str, job_id: str, stage_id: int, map_partition: int,
                 msg: str = "", cause: str = ""):
        tag = f" [{cause}]" if cause else ""
        super().__init__(
            f"fetch failed from executor={executor_id} {job_id}/{stage_id}/{map_partition}{tag}: {msg}"
        )
        self.executor_id = executor_id
        self.job_id = job_id
        self.stage_id = stage_id
        self.map_partition = map_partition
        # "corruption" when checksum verification failed twice for the same
        # map output: the scheduler additionally strikes the SERVING
        # executor's health score (its disk, not the network, is suspect)
        self.cause = cause


class IoError(BallistaError):
    retryable = True


class DataCorrupted(IoError):
    """Shuffle bytes failed checksum verification (client-side before
    decode, or a local read against the stored value). Retryable exactly
    ONCE in place — a transient in-transit flip heals on refetch — then
    escalated as FetchFailed(cause="corruption") so the upstream stage
    recomputes and the serving executor takes a corruption strike."""

    def __init__(self, where: str, expected: str, actual: str, detail: str = ""):
        extra = f" ({detail})" if detail else ""
        super().__init__(
            f"shuffle data corrupted at {where}: checksum {actual} != expected {expected}{extra}"
        )
        self.where = where
        self.expected = expected
        self.actual = actual


class DiskExhausted(IoError):
    """A shuffle write or spill demotion hit ENOSPC (or the executor's
    high disk watermark). Retryable and blame-aware like `DataCorrupted`:
    the failure names the WRITING executor's disk, so the scheduler
    re-pends the partition and the per-executor disk gauges steer the
    retry toward a node with headroom instead of hammering the full one."""

    def __init__(self, where: str, detail: str = ""):
        extra = f": {detail}" if detail else ""
        super().__init__(f"disk exhausted at {where}{extra}")
        self.where = where


class ShortRead(IoError):
    """A requested shuffle byte range extends past the file's actual size
    (torn write, truncated disk, stale index). Typed and retryable so the
    Flight server can refuse to stream a short range instead of silently
    ending the stream early."""

    def __init__(self, path: str, offset: int, length: int, size: int):
        super().__init__(
            f"shuffle file truncated: {path} has {size} bytes, range needs "
            f"[{offset}, {offset + length})"
        )
        self.path = path
        self.offset = offset
        self.length = length
        self.size = size


class GrpcError(BallistaError):
    retryable = True


class ClusterOverloaded(BallistaError):
    """The scheduler shed this submission (admission quota exceeded or the
    cluster is in a shedding/draining overload state). Always retryable;
    `retry_after_ms` is the server's backoff hint, computed from the
    admission queue's observed drain rate. Surfaced over gRPC as
    RESOURCE_EXHAUSTED with a `retry-after-ms` trailing-metadata entry."""

    retryable = True

    def __init__(self, msg: str, retry_after_ms: int = 1000, reason: str = "quota"):
        super().__init__(msg)
        self.retry_after_ms = max(0, int(retry_after_ms))
        self.reason = reason  # quota | depth | shedding | draining


class CircuitOpen(IoError):
    """Client-side circuit breaker for a Flight address is open: recent
    consecutive failures tripped it and the cooldown has not elapsed.
    Fails fast (no dial) so a dead/overloaded data-plane peer cannot tie
    up every reduce task in connect timeouts."""

    def __init__(self, addr: str, retry_after_s: float):
        super().__init__(f"circuit open for {addr} (retry in {retry_after_s:.1f}s)")
        self.addr = addr
        self.retry_after_s = retry_after_s


class Cancelled(BallistaError):
    """Task/job cancelled; terminal, not a failure for retry accounting."""


class TokioError(BallistaError):
    """Internal concurrency failure (named for parity with the reference)."""


class ConfigurationError(BallistaError):
    pass


def error_to_proto_kind(err: BaseException) -> str:
    """Stable string tag used in TaskStatus/FailedTask wire messages."""
    if isinstance(err, FetchFailed):
        # the cause rides the kind tag ("FetchPartitionError:corruption")
        # so blame-aware recovery crosses the wire without a proto change
        return f"FetchPartitionError:{err.cause}" if err.cause else "FetchPartitionError"
    if isinstance(err, ClusterOverloaded):
        return "ResourceExhausted"
    if isinstance(err, Cancelled):
        return "TaskKilled"
    if isinstance(err, DataCorrupted):
        return "DataCorrupted"
    if isinstance(err, DiskExhausted):
        return "DiskExhausted"
    if isinstance(err, (IoError, GrpcError)):
        return "IoError"
    if isinstance(err, ExecutionError):
        return "ExecutionError"
    if isinstance(err, PlanningError):
        return "PlanningError"
    return "GeneralError"
