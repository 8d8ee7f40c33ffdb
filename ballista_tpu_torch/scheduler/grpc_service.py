"""SchedulerGrpc service (reference: ballista.proto:952, grpc.rs).

Hand-registered method handlers (no grpc_tools codegen in this
environment): each rpc deserializes with the generated protobuf messages.
Includes the wire-protocol version gate on registration/poll
(grpc.rs:92,200) and PollWork's heartbeat+status+handout composite.
"""

from __future__ import annotations

import logging
import threading

import grpc

from ballista_tpu_torch.errors import BallistaError, ClusterOverloaded
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.server import SchedulerServer
from ballista_tpu_torch.serde_control import (
    decode_executor_metadata,
    decode_task_status,
    encode_job_status,
    encode_task_definition,
)

log = logging.getLogger(__name__)

SERVICE_NAME = "ballista_tpu.SchedulerGrpc"


class _PollCoalescer:
    """Single-flight for identical in-flight job-status polls: when a herd
    of clients waits on one job, the FIRST poll in computes the status and
    every poll that arrives while it is in flight piggybacks on that
    result instead of taking the jobs lock again. Correctness is safe
    because a follower's answer is at most one leader-computation stale —
    strictly fresher than the poll interval that triggered it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict[str, tuple[threading.Event, list]] = {}
        self.computed = 0
        self.coalesced = 0

    def get(self, key: str, compute):
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                entry = self._inflight[key] = (threading.Event(), [])
                leader = True
                self.computed += 1
            else:
                leader = False
                self.coalesced += 1
        ev, slot = entry
        if leader:
            try:
                slot.append(compute())
            except BaseException as e:  # noqa: BLE001 — followers re-raise it
                slot.append(e)
                raise
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
            return slot[0]
        # follower: a missing/late leader result degrades to computing our
        # own answer — coalescing is an optimization, never a correctness gate
        if not ev.wait(timeout=5.0) or not slot:
            return compute()
        result = slot[0]
        if isinstance(result, BaseException):
            raise result
        return result


class SchedulerGrpcService:
    def __init__(self, scheduler: SchedulerServer):
        self.scheduler = scheduler
        self._poll_coalescer = _PollCoalescer()

    # -- client-facing -------------------------------------------------------

    def ExecuteQuery(self, request: pb.ExecuteQueryParams, context) -> pb.ExecuteQueryResult:
        session_id = request.session_id or self.scheduler.sessions.create_or_update(
            [(kv.key, kv.value) for kv in request.settings]
        )
        if request.settings and request.session_id:
            self.scheduler.sessions.create_or_update(
                [(kv.key, kv.value) for kv in request.settings], session_id
            )
        which = request.WhichOneof("query")
        try:
            if which == "sql":
                job_id = self.scheduler.submit_sql(request.sql, session_id, request.job_name)
            else:
                from ballista_tpu_torch.serde import decode_plan

                plan = decode_plan(request.physical_plan)
                job_id = self.scheduler.submit_physical_plan(plan, session_id, request.job_name)
        except ClusterOverloaded as e:
            self._abort_overloaded(context, e)
        return pb.ExecuteQueryResult(job_id=job_id, session_id=session_id)

    @staticmethod
    def _abort_overloaded(context, e: ClusterOverloaded) -> None:
        """Shed submissions map to RESOURCE_EXHAUSTED with the backoff
        hint in trailing metadata (clients parse `retry-after-ms`; the
        message text carries it too for non-ballista clients)."""
        context.set_trailing_metadata((
            ("retry-after-ms", str(e.retry_after_ms)),
            ("overload-reason", e.reason),
        ))
        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                      f"{e} [retry_after_ms={e.retry_after_ms}]")

    def PrepareStatement(self, request: pb.ExecuteQueryParams, context) -> pb.ExecuteQueryResult:
        """Server-side prepare: parse/optimize/plan once, return the
        statement handle. Reuses the ExecuteQuery message pair (no protoc
        in this environment): sql carries the statement text, and the
        response's job_id field carries a JSON handle
        {statement_id, num_params, type_tags}."""
        import json

        session_id = request.session_id or self.scheduler.sessions.create_or_update(
            [(kv.key, kv.value) for kv in request.settings]
        )
        if request.settings and request.session_id:
            self.scheduler.sessions.create_or_update(
                [(kv.key, kv.value) for kv in request.settings], session_id
            )
        try:
            handle = self.scheduler.prepare_statement(request.sql, session_id)
        except BallistaError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.ExecuteQueryResult(job_id=json.dumps(handle), session_id=session_id)

    def ExecutePrepared(self, request: pb.ExecuteQueryParams, context) -> pb.ExecuteQueryResult:
        """Execute a prepared statement with bound parameters. The sql
        field carries JSON {statement_id, params} with params encoded by
        serving.encode_params (dates/decimals ride with type tags)."""
        import json

        from ballista_tpu_torch.serving.normalize import decode_params

        body = json.loads(request.sql)
        params = decode_params(body["params"]) if body.get("params") else None
        try:
            job_id = self.scheduler.execute_prepared(
                body["statement_id"], params, request.session_id, request.job_name)
        except ClusterOverloaded as e:
            self._abort_overloaded(context, e)
        except BallistaError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.ExecuteQueryResult(job_id=job_id, session_id=request.session_id)

    def GetJobStatus(self, request: pb.GetJobStatusParams, context) -> pb.GetJobStatusResult:
        status = self._poll_coalescer.get(
            request.job_id, lambda: self.scheduler.job_status(request.job_id))
        out = pb.GetJobStatusResult()
        if status is not None:
            out.status.CopyFrom(encode_job_status(status))
        return out

    def ExecuteQueryPush(self, request: pb.ExecuteQueryParams, context):
        """Server-streaming variant (grpc.rs:419): submit, then push a
        status event on every state change until the job is terminal — no
        client polling."""
        import time as _time

        first = self.ExecuteQuery(request, context)
        yield pb.ExecuteQueryPushResult(job_id=first.job_id, session_id=first.session_id)
        last_state = None
        while context.is_active():
            status = self.scheduler.job_status(first.job_id)
            if status is None:
                return
            if status["state"] != last_state:
                last_state = status["state"]
                out = pb.ExecuteQueryPushResult(job_id=first.job_id, session_id=first.session_id)
                out.status.CopyFrom(encode_job_status(status))
                yield out
                if last_state in ("successful", "failed", "cancelled"):
                    return
            _time.sleep(0.05)

    def AppendData(self, request: pb.ExecuteQueryParams, context) -> pb.ExecuteQueryResult:
        """Append-oriented ingestion. Reuses the ExecuteQuery message pair
        (no protoc here): job_name carries the table name, physical_plan
        carries a MemoryScanExec whose IPC payload is the appended rows.
        The response's job_id field carries JSON {table, version, rows}."""
        import json

        from ballista_tpu_torch.serde import decode_plan

        session_id = request.session_id or self.scheduler.sessions.create_or_update(
            [(kv.key, kv.value) for kv in request.settings]
        )
        if not request.job_name:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "AppendData requires the table name in job_name")
        plan = decode_plan(request.physical_plan)
        batches = [b for b in getattr(plan, "batches", []) if b.num_rows]
        out = self.scheduler.append_data(request.job_name, batches, session_id)
        return pb.ExecuteQueryResult(job_id=json.dumps(out), session_id=session_id)

    def SubscribeQuery(self, request: pb.ExecuteQueryParams, context):
        """Continuous-query push stream: subscribe a prepared statement to
        its tables' versions; every append/DDL bump re-executes it
        (incrementally when eligible) and pushes the fresh terminal status.
        sql carries JSON {statement_id, params} like ExecutePrepared; the
        first frame's job_id is the subscription handle. Remote clients
        fetch each refresh's partitions like any other job."""
        import json
        import queue as _queue

        from ballista_tpu_torch.serving.normalize import decode_params

        body = json.loads(request.sql)
        params = decode_params(body["params"]) if body.get("params") else None
        try:
            sub = self.scheduler.subscribe_statement(
                body["statement_id"], params, request.session_id,
                inline_results=False)
        except BallistaError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        yield pb.ExecuteQueryPushResult(job_id=sub.sub_id,
                                        session_id=request.session_id)
        try:
            while context.is_active():
                try:
                    st = sub.queue.get(timeout=0.25)
                except _queue.Empty:
                    continue
                out = pb.ExecuteQueryPushResult(
                    job_id=str(st.get("job_id", "")),
                    session_id=request.session_id)
                out.status.CopyFrom(encode_job_status(st))
                yield out
        finally:
            self.scheduler.unsubscribe(sub.sub_id)

    def CreateUpdateSession(self, request: pb.CreateSessionParams, context) -> pb.CreateSessionResult:
        sid = self.scheduler.sessions.create_or_update(
            [(kv.key, kv.value) for kv in request.settings], request.session_id
        )
        return pb.CreateSessionResult(session_id=sid)

    def RemoveSession(self, request: pb.RemoveSessionParams, context) -> pb.RemoveSessionResult:
        self.scheduler.sessions.remove(request.session_id)
        return pb.RemoveSessionResult()

    def CancelJob(self, request: pb.CancelJobParams, context) -> pb.CancelJobResult:
        self.scheduler.cancel_job(request.job_id)
        return pb.CancelJobResult(cancelled=True)

    def CleanJobData(self, request: pb.CleanJobDataParams, context) -> pb.CleanJobDataResult:
        self.scheduler.clean_job_data(request.job_id)
        return pb.CleanJobDataResult()

    def GetJobMetrics(self, request: pb.GetJobMetricsParams, context) -> pb.GetJobMetricsResult:
        out = pb.GetJobMetricsResult()
        with self.scheduler._jobs_lock:
            g = self.scheduler.jobs.get(request.job_id)
        if g is not None:
            for sid, metrics in sorted(g.stage_metrics.items()):
                sp = out.stages.add()
                sp.stage_id = sid
                for m in metrics:
                    sp.metrics.add(
                        name=str(m.get("name", "")), output_rows=int(m.get("output_rows", 0)),
                        elapsed_ns=int(m.get("elapsed_ns", 0)), depth=int(m.get("depth", 0)),
                    )
        return out

    # -- executor-facing -----------------------------------------------------

    def RegisterExecutor(self, request: pb.RegisterExecutorParams, context) -> pb.RegisterExecutorResult:
        try:
            self.scheduler.register_executor(decode_executor_metadata(request.metadata))
            return pb.RegisterExecutorResult(success=True)
        except BallistaError as e:
            self.scheduler.metrics.record_protocol_mismatch()
            return pb.RegisterExecutorResult(success=False, error=str(e))

    def HeartBeatFromExecutor(self, request: pb.HeartBeatParams, context) -> pb.HeartBeatResult:
        # overload signals ride the existing repeated ExecutorMetricProto
        # field — no wire change needed
        metrics = {m.name: m.value for m in request.metrics} or None
        known = self.scheduler.executor_heartbeat(request.executor_id, metrics)
        return pb.HeartBeatResult(reregister=not known)

    def UpdateTaskStatus(self, request: pb.UpdateTaskStatusParams, context) -> pb.UpdateTaskStatusResult:
        meta = self.scheduler.executors.get(request.executor_id)
        results = [
            decode_task_status(p, meta.metadata if meta else None) for p in request.task_status
        ]
        self.scheduler.update_task_status(request.executor_id, results)
        return pb.UpdateTaskStatusResult(success=True)

    def PollWork(self, request: pb.PollWorkParams, context) -> pb.PollWorkResult:
        meta = decode_executor_metadata(request.metadata)
        results = [decode_task_status(p, meta) for p in request.task_status]
        tasks = self.scheduler.poll_work(meta, request.can_accept_task, request.free_slots, results)
        out = pb.PollWorkResult()
        for t in tasks:
            # the session's settings travel with the task, as the push
            # launcher sends them (GrpcTaskLauncher.launch): without them a
            # pull executor ran the task under the default config
            # (engine=cpu, no fusion mode, no force_remote_read)
            cfg = self.scheduler.sessions.get(t.session_id)
            tp = encode_task_definition(t, cfg)
            if cfg is not None:
                for k, v in cfg.to_key_value_pairs():
                    tp.props.add(key=k, value=v)
            out.tasks.append(tp)
        return out

    def ExecutorStopped(self, request: pb.ExecutorStoppedParams, context) -> pb.ExecutorStoppedResult:
        from ballista_tpu_torch.scheduler.server import Event

        self.scheduler.post(Event("executor_lost", request.executor_id))
        return pb.ExecutorStoppedResult()


_RPCS = {
    "ExecuteQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    # prepared statements reuse the ExecuteQuery message pair (no protoc
    # here): handles/params travel as JSON in the sql/job_id string fields
    "PrepareStatement": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "ExecutePrepared": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    # append ingestion rides the same pair: table in job_name, rows as a
    # MemoryScanExec in physical_plan, {table, version, rows} JSON back
    "AppendData": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "GetJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
    "CreateUpdateSession": (pb.CreateSessionParams, pb.CreateSessionResult),
    "RemoveSession": (pb.RemoveSessionParams, pb.RemoveSessionResult),
    "CancelJob": (pb.CancelJobParams, pb.CancelJobResult),
    "CleanJobData": (pb.CleanJobDataParams, pb.CleanJobDataResult),
    "GetJobMetrics": (pb.GetJobMetricsParams, pb.GetJobMetricsResult),
    "RegisterExecutor": (pb.RegisterExecutorParams, pb.RegisterExecutorResult),
    "HeartBeatFromExecutor": (pb.HeartBeatParams, pb.HeartBeatResult),
    "UpdateTaskStatus": (pb.UpdateTaskStatusParams, pb.UpdateTaskStatusResult),
    "PollWork": (pb.PollWorkParams, pb.PollWorkResult),
    "ExecutorStopped": (pb.ExecutorStoppedParams, pb.ExecutorStoppedResult),
}

# server-streaming rpcs (reference: execute_query_push, grpc.rs:419)
_STREAM_RPCS = {
    "ExecuteQueryPush": (pb.ExecuteQueryParams, pb.ExecuteQueryPushResult),
    "SubscribeQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryPushResult),
}


def add_scheduler_service(server: grpc.Server, service: SchedulerGrpcService) -> None:
    handlers = {}
    for name, (req_t, _resp_t) in _RPCS.items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(service, name),
            request_deserializer=req_t.FromString,
            response_serializer=lambda resp: resp.SerializeToString(),
        )
    for name, (req_t, _resp_t) in _STREAM_RPCS.items():
        handlers[name] = grpc.unary_stream_rpc_method_handler(
            getattr(service, name),
            request_deserializer=req_t.FromString,
            response_serializer=lambda resp: resp.SerializeToString(),
        )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))


def scheduler_stub(channel: grpc.Channel):
    """Typed callables for every scheduler rpc."""

    class Stub:
        pass

    stub = Stub()
    for name, (req_t, resp_t) in _RPCS.items():
        setattr(
            stub, name,
            channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            ),
        )
    for name, (req_t, resp_t) in _STREAM_RPCS.items():
        setattr(
            stub, name,
            channel.unary_stream(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            ),
        )
    return stub
