"""Control-plane message serde: dataclasses ↔ protobuf.

Covers TaskDefinition/TaskStatus/ExecutorMetadata/JobStatus — the messages
the SchedulerGrpc and ExecutorGrpc services exchange (reference:
serde/scheduler/{to,from}_proto.rs).
"""

from __future__ import annotations

import logging

from ballista_tpu_torch.executor.executor import ExecutorMetadata, TaskResult
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.state.execution_graph import TaskDescription
from ballista_tpu_torch.serde import (
    decode_location,
    decode_plan,
    decode_schema,
    encode_location,
    encode_plan,
    encode_schema,
)


def encode_executor_metadata(m: ExecutorMetadata) -> pb.ExecutorMetadataProto:
    out = pb.ExecutorMetadataProto(
        id=m.id, host=m.host, grpc_port=m.grpc_port, flight_port=m.flight_port,
        vcores=m.vcores, wire_version=m.wire_version,
    )
    if m.device_ordinal >= 0:  # explicit presence: ordinal 0 is a valid chip
        out.device_ordinal = m.device_ordinal
    return out


def decode_executor_metadata(p: pb.ExecutorMetadataProto) -> ExecutorMetadata:
    return ExecutorMetadata(
        id=p.id, host=p.host, grpc_port=p.grpc_port, flight_port=p.flight_port,
        vcores=p.vcores, wire_version=p.wire_version,
        device_ordinal=p.device_ordinal if p.HasField("device_ordinal") else -1,
    )


def _encoded_plan_bytes(t: TaskDescription, config=None) -> bytes:
    """Per-task plan restriction + stage-plan encode cache.

    The plan shipped to a task is RESTRICTED to the task's partition slice
    (scan file-groups and reader location lists outside the slice become
    empty; see scheduler/task_builder.py — the reference's
    state/task_builder.rs:18-64). Encodings are memoized ON the shared
    stage-plan object, keyed by the partition slice, so retries and
    multi-partition slices reuse bytes; the cache's lifetime is the plan's
    (replanned/retried stages build new plan objects and re-encode; no
    id() aliasing). Plans are never mutated after task hand-out begins
    (AQE rewrites happen at resolution, before the first task is popped)."""
    from ballista_tpu_torch.scheduler.task_builder import restrict_plan_to_partitions

    restricted = restrict_plan_to_partitions(t.plan, t.partitions, config)
    if restricted is t.plan:
        hit = getattr(t.plan, "_encoded_task_plan", None)
        if hit is None:
            hit = encode_plan(t.plan).SerializeToString()
            t.plan._encoded_task_plan = hit
        return hit
    cache = getattr(t.plan, "_encoded_task_plan_slices", None)
    if cache is None:
        cache = {}
        t.plan._encoded_task_plan_slices = cache
    key = tuple(sorted(set(t.partitions)))
    hit = cache.get(key)
    if hit is None:
        hit = encode_plan(restricted).SerializeToString()
        cache[key] = hit
    return hit


def encode_task_definition(t: TaskDescription, config=None) -> pb.TaskDefinitionProto:
    out = pb.TaskDefinitionProto(
        task_id=t.task_id, job_id=t.job_id, stage_id=t.stage_id,
        stage_attempt=t.stage_attempt, session_id=t.session_id,
        deadline_seconds=t.deadline_seconds, task_attempt=t.task_attempt,
    )
    out.partitions.extend(t.partitions)
    out.plan.ParseFromString(_encoded_plan_bytes(t, config))
    return out


def decode_task_definition(p: pb.TaskDefinitionProto) -> TaskDescription:
    # the fast-lane flag has no proto field (no protoc here); the reserved
    # task-id band IS the wire encoding — graph tasks never reach it
    from ballista_tpu_torch.serving.fast_lane import FAST_TASK_ID_BASE

    return TaskDescription(
        job_id=p.job_id, stage_id=p.stage_id, stage_attempt=p.stage_attempt,
        task_id=p.task_id, partitions=list(p.partitions),
        plan=decode_plan(p.plan), session_id=p.session_id,
        deadline_seconds=p.deadline_seconds, task_attempt=p.task_attempt,
        fast_lane=p.task_id >= FAST_TASK_ID_BASE,
    )


def encode_task_status(r: TaskResult, executor_id: str) -> pb.TaskStatusProto:
    out = pb.TaskStatusProto(
        task_id=r.task_id, job_id=r.job_id, stage_id=r.stage_id,
        stage_attempt=r.stage_attempt, executor_id=executor_id,
        state=r.state, error=r.error, error_kind=r.error_kind, retryable=r.retryable,
        fetch_failed_executor_id=r.fetch_failed_executor_id,
        fetch_failed_stage_id=r.fetch_failed_stage_id,
        timed_out=r.timed_out,
    )
    out.partitions.extend(r.partitions)
    for l in r.locations:
        out.shuffle_partitions.append(
            pb.ShuffleWritePartitionProto(
                output_partition=l.output_partition, path=l.path,
                num_rows=l.stats.num_rows, num_bytes=l.stats.num_bytes, layout=l.layout,
                map_partition=l.map_partition,
            )
        )
    for m in r.metrics or []:
        mp = pb.OperatorMetricProto(
            name=str(m.get("name", "")), output_rows=int(m.get("output_rows", 0)),
            elapsed_ns=int(m.get("elapsed_ns", 0)), depth=int(m.get("depth", 0)),
        )
        for k, v in m.items():
            if k in ("name", "output_rows", "elapsed_ns", "depth"):
                continue
            if isinstance(v, (int, bool)):
                mp.extra[str(k)] = int(v)
            else:
                # extras are integer counters by contract (Metrics.extra:
                # dict[str, int]); anything else would vanish remotely, so
                # say so instead of a silent local-vs-distributed skew
                logging.getLogger(__name__).warning(
                    "dropping non-integer operator metric extra %s=%r (%s)",
                    k, v, m.get("name", ""))
        out.metrics.append(mp)
    if r.locations:
        out.map_partition = r.locations[0].map_partition
    return out


def decode_task_status(p: pb.TaskStatusProto, executor_meta: ExecutorMetadata | None) -> TaskResult:
    from ballista_tpu_torch.shuffle.types import PartitionLocation, PartitionStats

    locations = []
    if p.state == "success" and executor_meta is not None:
        for sp in p.shuffle_partitions:
            locations.append(
                PartitionLocation(
                    map_partition=sp.map_partition,
                    job_id=p.job_id, stage_id=p.stage_id,
                    output_partition=sp.output_partition,
                    executor_id=executor_meta.id, host=executor_meta.host,
                    flight_port=executor_meta.flight_port, path=sp.path,
                    layout=sp.layout or "hash",
                    stats=PartitionStats(num_rows=sp.num_rows, num_bytes=sp.num_bytes),
                )
            )
    return TaskResult(
        task_id=p.task_id, job_id=p.job_id, stage_id=p.stage_id,
        stage_attempt=p.stage_attempt, partitions=list(p.partitions),
        state=p.state, locations=locations, error=p.error,
        error_kind=p.error_kind, retryable=p.retryable,
        metrics=[
            {"name": m.name, "output_rows": m.output_rows, "elapsed_ns": m.elapsed_ns,
             "depth": m.depth, **dict(m.extra)}
            for m in p.metrics
        ],
        fetch_failed_executor_id=p.fetch_failed_executor_id,
        fetch_failed_stage_id=p.fetch_failed_stage_id,
        # the cause rides the kind tag ("FetchPartitionError:corruption") —
        # blame-aware recovery without a proto change
        fetch_failed_cause=(
            p.error_kind.split(":", 1)[1]
            if p.error_kind.startswith("FetchPartitionError:") else ""),
        timed_out=p.timed_out,
    )


def encode_job_status(status: dict) -> pb.JobStatusProto:
    out = pb.JobStatusProto(
        job_id=status["job_id"], job_name=status.get("job_name", ""),
        state=status["state"], error=status.get("error", ""),
        completed_stages=status.get("completed_stages", 0),
        total_stages=status.get("total_stages", 0),
    )
    if status.get("schema") is not None:
        out.schema.CopyFrom(encode_schema(status["schema"]))
    for l in status.get("partitions", []) or []:
        out.partitions.append(encode_location(l))
    return out


def decode_job_status(p: pb.JobStatusProto) -> dict:
    out = {
        "job_id": p.job_id, "job_name": p.job_name, "state": p.state,
        "error": p.error, "completed_stages": p.completed_stages,
        "total_stages": p.total_stages,
        "partitions": [decode_location(l) for l in p.partitions],
    }
    if p.HasField("schema"):
        out["schema"] = decode_schema(p.schema)
    return out
