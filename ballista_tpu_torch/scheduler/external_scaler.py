"""KEDA external scaler: autoscale executors on scheduler job pressure.

Rebuild of the reference's `ExternalScaler` gRPC service
(scheduler/src/scheduler_server/external_scaler.rs, proto/keda.proto:24) —
served on the scheduler's own gRPC port so a k8s ScaledObject pointing at
`<scheduler>:<port>` scales executor replicas from pending/running job
counts. Same contract: IsActive always true (the scheduler itself stays
up), GetMetricSpec advertises `pending_jobs` with target 0, GetMetrics
reports pending_jobs and running_jobs.

Scheduler scale-out extends the signal set with the REAL load-shedding
inputs: per-lane admission counters (interactive/batch inflight, lifetime
sheds), the deepest shard event queue, and the count of outstanding
direct-dispatch leases — so a ScaledObject can scale on control-plane
saturation, not just job counts.
"""

from __future__ import annotations

import grpc

from ballista_tpu_torch.proto import keda_pb2 as kpb
from ballista_tpu_torch.scheduler.server import JobState, SchedulerServer

PENDING_JOBS = "pending_jobs"
RUNNING_JOBS = "running_jobs"
INTERACTIVE_INFLIGHT = "interactive_inflight"
BATCH_INFLIGHT = "batch_inflight"
LANE_SHED_TOTAL = "lane_shed_total"
SHARD_QUEUE_DEPTH = "shard_queue_depth"
ACTIVE_LEASES = "active_leases"
SERVICE_NAME = "externalscaler.ExternalScaler"


class ExternalScalerService:
    def __init__(self, scheduler: SchedulerServer):
        self.scheduler = scheduler

    def _counts(self) -> tuple[int, int]:
        pending = running = 0
        with self.scheduler._jobs_lock:
            for g in self.scheduler.jobs.values():
                if g.status is JobState.QUEUED:
                    pending += 1
                elif g.status is JobState.RUNNING:
                    running += 1
        return pending, running

    def IsActive(self, request: kpb.ScaledObjectRef, context) -> kpb.IsActiveResponse:
        return kpb.IsActiveResponse(result=True)

    def GetMetricSpec(self, request: kpb.ScaledObjectRef, context) -> kpb.GetMetricSpecResponse:
        # target 1 = one executor replica per pending job (HPA computes
        # desired = ceil(metric / target)); the reference advertises 0
        # here, which KEDA's HPA rejects as a non-positive target — a
        # deliberate deviation, overridable per ScaledObject metadata
        target = 1
        meta = request.scalerMetadata.get("targetSize") if request.scalerMetadata else None
        if meta:
            try:
                target = max(1, int(meta))
            except ValueError:
                pass
        out = kpb.GetMetricSpecResponse()
        out.metricSpecs.append(kpb.MetricSpec(metricName=PENDING_JOBS, targetSize=target))
        # shard queue depth scales SCHEDULER replicas, not executors: a
        # ScaledObject selecting it targets the scheduler deployment
        out.metricSpecs.append(kpb.MetricSpec(metricName=SHARD_QUEUE_DEPTH, targetSize=target))
        return out

    def GetMetrics(self, request: kpb.GetMetricsRequest, context) -> kpb.GetMetricsResponse:
        pending, running = self._counts()
        out = kpb.GetMetricsResponse()
        out.metricValues.append(kpb.MetricValue(metricName=PENDING_JOBS, metricValue=pending))
        out.metricValues.append(kpb.MetricValue(metricName=RUNNING_JOBS, metricValue=running))
        # per-lane admission pressure straight off the controller snapshot
        lanes = self.scheduler.admission.snapshot().get("lanes", {})
        out.metricValues.append(kpb.MetricValue(
            metricName=INTERACTIVE_INFLIGHT,
            metricValue=int(lanes.get("interactive", {}).get("inflight", 0))))
        out.metricValues.append(kpb.MetricValue(
            metricName=BATCH_INFLIGHT,
            metricValue=int(lanes.get("batch", {}).get("inflight", 0))))
        out.metricValues.append(kpb.MetricValue(
            metricName=LANE_SHED_TOTAL,
            metricValue=sum(int(l.get("shed_total", 0)) for l in lanes.values())))
        # deepest shard event queue: the control-plane saturation signal
        shards = self.scheduler.shards_snapshot()
        out.metricValues.append(kpb.MetricValue(
            metricName=SHARD_QUEUE_DEPTH,
            metricValue=max((s["queue_depth"] for s in shards), default=0)))
        out.metricValues.append(kpb.MetricValue(
            metricName=ACTIVE_LEASES,
            metricValue=self.scheduler.leases.active_count()))
        return out


_RPCS = {
    "IsActive": kpb.ScaledObjectRef,
    "GetMetricSpec": kpb.ScaledObjectRef,
    "GetMetrics": kpb.GetMetricsRequest,
}


def add_external_scaler_service(server: grpc.Server, service: ExternalScalerService) -> None:
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(service, name),
            request_deserializer=req_t.FromString,
            response_serializer=lambda resp: resp.SerializeToString(),
        )
        for name, req_t in _RPCS.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))


def external_scaler_stub(channel: grpc.Channel):
    """Typed callables for the scaler rpcs (test/tooling client)."""

    class Stub:
        pass

    stub = Stub()
    for name, req_t in _RPCS.items():
        resp_t = {
            "IsActive": kpb.IsActiveResponse,
            "GetMetricSpec": kpb.GetMetricSpecResponse,
            "GetMetrics": kpb.GetMetricsResponse,
        }[name]
        setattr(stub, name, channel.unary_unary(
            f"/{SERVICE_NAME}/{name}",
            request_serializer=req_t.SerializeToString,
            response_deserializer=resp_t.FromString,
        ))
    return stub
