"""Remote scheduler client: the client side of the distributed query flow.

Rebuild of DistributedQueryExec (core/src/execution_plans/
distributed_query.rs:64,211): CreateUpdateSession with the full session
config (catalog registrations ride along as KV pairs), ExecuteQuery (SQL
or physical-plan protobuf), GetJobStatus polling, then fetch result
partitions from executors over Flight (local fast path applies when
colocated).

Overload cooperation: submissions shed by the scheduler's admission gate
come back as RESOURCE_EXHAUSTED with a `retry-after-ms` hint in trailing
metadata; this client honors the hint with jittered exponential backoff
instead of hammering an already-overloaded control plane. Idempotent
RPCs (GetJobStatus, CreateUpdateSession) retry on transient UNAVAILABLE/
DEADLINE_EXCEEDED, and wait_for_job's poll interval grows exponentially
so long jobs don't keep a tight 10 Hz poll loop open per client.
"""

from __future__ import annotations

import logging
import random
import time

import grpc
import pyarrow as pa

from ballista_tpu_torch.config import (
    CLIENT_BACKOFF_BASE_MS,
    CLIENT_BACKOFF_MAX_MS,
    CLIENT_JOB_TIMEOUT_S,
    CLIENT_SUBMIT_RETRIES,
    BallistaConfig,
)
from ballista_tpu_torch.errors import ClusterOverloaded, ExecutionError, GrpcError
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.grpc_service import scheduler_stub
from ballista_tpu_torch.serde import encode_plan
from ballista_tpu_torch.serde_control import decode_job_status

log = logging.getLogger(__name__)

# the floor sets the best-case tail latency a polling client can observe:
# at the old 100ms floor a 5ms fast-lane query always took >=100ms
# end-to-end, wiping out the serving tier's win. 10ms keeps short-query
# p99 honest; the exponential growth still backs long jobs off to the cap.
POLL_INTERVAL_S = 0.01
POLL_INTERVAL_MAX_S = 2.0

# transient codes worth retrying on idempotent rpcs
_TRANSIENT = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED)


def _retry_after_ms(e: grpc.RpcError) -> int | None:
    """Extract the scheduler's backoff hint from a RESOURCE_EXHAUSTED
    rejection: trailing metadata first, message text as fallback."""
    try:
        for k, v in (e.trailing_metadata() or ()):
            if k == "retry-after-ms":
                return int(v)
    except Exception:  # noqa: BLE001 — metadata shape varies by transport
        pass
    import re

    m = re.search(r"retry_after_ms=(\d+)", str(e.details() if hasattr(e, "details") else e))
    return int(m.group(1)) if m else None


class RemoteSchedulerClient:
    def __init__(self, scheduler_url: str, config: BallistaConfig):
        addr = scheduler_url.replace("df://", "").replace("grpc://", "")
        from ballista_tpu_torch.utils.grpc_util import create_channel

        self.channel = create_channel(addr, config)
        self.stub = scheduler_stub(self.channel)
        self.config = config
        self.session_id: str = ""
        self.submit_retries = 0  # observability: backoffs taken on submit

    def _settings(self) -> list[pb.KeyValuePair]:
        return [pb.KeyValuePair(key=k, value=v) for k, v in self.config.to_key_value_pairs()]

    def _backoff_s(self, attempt: int, hint_ms: int | None = None) -> float:
        """Jittered exponential backoff, floored at the server's
        retry_after_ms hint when one was given: the server knows its own
        drain rate better than our exponent does."""
        base = int(self.config.get(CLIENT_BACKOFF_BASE_MS))
        cap = int(self.config.get(CLIENT_BACKOFF_MAX_MS))
        ms = min(cap, base * (2 ** attempt))
        if hint_ms is not None:
            ms = min(cap, max(ms, hint_ms))
        # full jitter (0.5x..1.0x) decorrelates a herd of rejected clients
        return ms * (0.5 + random.random() * 0.5) / 1000.0

    def _call_idempotent(self, fn, req, what: str, timeout: float = 10.0):
        """Retry an idempotent rpc on transient UNAVAILABLE /
        DEADLINE_EXCEEDED with jittered backoff (satellite: wait_for_job
        must not raise through the caller mid-poll on a scheduler blip)."""
        retries = int(self.config.get(CLIENT_SUBMIT_RETRIES))
        for attempt in range(retries + 1):
            try:
                return fn(req, timeout=timeout)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code not in _TRANSIENT or attempt >= retries:
                    raise
                wait = self._backoff_s(attempt)
                log.warning("%s transient failure (%s); retry %d/%d in %.2fs",
                            what, code, attempt + 1, retries, wait)
                time.sleep(wait)

    def ensure_session(self) -> str:
        req = pb.CreateSessionParams(session_id=self.session_id)
        req.settings.extend(self._settings())
        resp = self._call_idempotent(self.stub.CreateUpdateSession, req, "CreateUpdateSession")
        self.session_id = resp.session_id
        return self.session_id

    def _submit(self, req) -> str:
        """ExecuteQuery with overload cooperation: RESOURCE_EXHAUSTED
        rejections back off honoring the scheduler's retry_after_ms hint,
        then resubmit; a still-overloaded cluster after all retries
        surfaces a typed ClusterOverloaded to the caller."""
        retries = int(self.config.get(CLIENT_SUBMIT_RETRIES))
        for attempt in range(retries + 1):
            try:
                return self.stub.ExecuteQuery(req, timeout=30).job_id
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    hint = _retry_after_ms(e)
                    if attempt >= retries:
                        raise ClusterOverloaded(
                            f"submission rejected after {retries} retries: "
                            f"{e.details() if hasattr(e, 'details') else e}",
                            retry_after_ms=hint or 1000,
                        ) from None
                    wait = self._backoff_s(attempt, hint)
                    self.submit_retries += 1
                    log.info("cluster overloaded; resubmitting in %.2fs (hint=%sms, retry %d/%d)",
                             wait, hint, attempt + 1, retries)
                    time.sleep(wait)
                    continue
                if code in _TRANSIENT and attempt < retries:
                    time.sleep(self._backoff_s(attempt))
                    continue
                raise GrpcError(f"ExecuteQuery failed: {e}") from None

    def execute_sql(self, sql: str, job_name: str = "") -> str:
        sid = self.ensure_session()
        req = pb.ExecuteQueryParams(sql=sql, session_id=sid, job_name=job_name)
        req.settings.extend(self._settings())
        return self._submit(req)

    def execute_physical(self, physical, job_name: str = "") -> str:
        sid = self.ensure_session()
        req = pb.ExecuteQueryParams(session_id=sid, job_name=job_name)
        req.physical_plan.CopyFrom(encode_plan(physical))
        req.settings.extend(self._settings())
        return self._submit(req)

    def execute_sql_push(self, sql: str, job_name: str = "", timeout: float = 600.0) -> dict:
        """Submit + watch in ONE server-streaming rpc (execute_query_push):
        the scheduler pushes each state change; returns the terminal status.
        An admission rejection terminates the stream with
        RESOURCE_EXHAUSTED, surfaced as a typed ClusterOverloaded."""
        sid = self.ensure_session()
        req = pb.ExecuteQueryParams(sql=sql, session_id=sid, job_name=job_name)
        req.settings.extend(self._settings())
        last: dict | None = None
        try:
            for event in self.stub.ExecuteQueryPush(req, timeout=timeout):
                if event.HasField("status"):
                    last = decode_job_status(event.status)
                    if last["state"] in ("successful", "failed", "cancelled"):
                        return last
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                raise ClusterOverloaded(
                    f"push submission shed: {e.details() if hasattr(e, 'details') else e}",
                    retry_after_ms=_retry_after_ms(e) or 1000,
                ) from None
            raise GrpcError(f"ExecuteQueryPush failed: {e}") from None
        if last is None:
            raise ExecutionError("push stream ended without a terminal status")
        return last

    def wait_for_job(self, job_id: str, timeout: float = 600.0) -> dict:
        deadline = time.time() + timeout
        # jittered floor: a herd of clients submitting together must not
        # poll in lockstep — each client's cadence starts (and grows) at a
        # random phase, so the scheduler sees a smear instead of spikes
        poll = POLL_INTERVAL_S * (1.0 + random.random())
        while time.time() < deadline:
            resp = self._call_idempotent(
                self.stub.GetJobStatus, pb.GetJobStatusParams(job_id=job_id), "GetJobStatus")
            status = decode_job_status(resp.status)
            if status["state"] in ("successful", "failed", "cancelled"):
                return status
            time.sleep(poll)
            # exponential poll growth: fast feedback on short jobs, gentle
            # on the scheduler for long ones; jittering the factor keeps
            # initially-synchronized clients from re-converging
            poll = min(POLL_INTERVAL_MAX_S, poll * (1.25 + 0.5 * random.random()))
        raise ExecutionError(f"job {job_id} timed out")

    # -- prepared statements -------------------------------------------------

    def prepare_statement(self, sql: str) -> dict:
        """PrepareStatement rpc: plan once server-side, get back a handle
        {statement_id, num_params, type_tags} (JSON in the job_id field —
        the rpc reuses the ExecuteQuery message pair)."""
        import json

        sid = self.ensure_session()
        req = pb.ExecuteQueryParams(sql=sql, session_id=sid)
        req.settings.extend(self._settings())
        try:
            resp = self.stub.PrepareStatement(req, timeout=30)
        except grpc.RpcError as e:
            raise GrpcError(f"PrepareStatement failed: {e}") from None
        return json.loads(resp.job_id)

    def execute_prepared(self, statement_id: str, params=None, job_name: str = "") -> str:
        """ExecutePrepared rpc with overload cooperation (same backoff
        contract as _submit); params travel JSON-encoded with type tags."""
        import json

        from ballista_tpu_torch.serving.normalize import encode_params

        sid = self.ensure_session()
        body = {"statement_id": statement_id}
        if params is not None:
            body["params"] = encode_params(params)
        req = pb.ExecuteQueryParams(sql=json.dumps(body), session_id=sid, job_name=job_name)
        retries = int(self.config.get(CLIENT_SUBMIT_RETRIES))
        for attempt in range(retries + 1):
            try:
                return self.stub.ExecutePrepared(req, timeout=30).job_id
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    hint = _retry_after_ms(e)
                    if attempt >= retries:
                        raise ClusterOverloaded(
                            f"prepared execution rejected after {retries} retries: "
                            f"{e.details() if hasattr(e, 'details') else e}",
                            retry_after_ms=hint or 1000,
                        ) from None
                    self.submit_retries += 1
                    time.sleep(self._backoff_s(attempt, hint))
                    continue
                if code in _TRANSIENT and attempt < retries:
                    time.sleep(self._backoff_s(attempt))
                    continue
                raise GrpcError(f"ExecutePrepared failed: {e}") from None

    # -- append ingestion / continuous queries -------------------------------

    def append_data(self, table: str, batches: list[pa.RecordBatch]) -> dict:
        """AppendData rpc: ship appended rows to the scheduler's ingest
        registry. The rpc reuses the ExecuteQuery message pair — the table
        name rides in job_name, the batches ride as a MemoryScanNode plan
        (the same IPC carrier memory-table submissions use), and the
        response's job_id field carries {table, version, rows} as JSON."""
        import json

        from ballista_tpu_torch.plan.physical import MemoryScanExec
        from ballista_tpu_torch.plan.schema import DFSchema

        sid = self.ensure_session()
        schema = batches[0].schema if batches else pa.schema([])
        scan = MemoryScanExec(DFSchema.from_arrow(schema), batches, 1)
        req = pb.ExecuteQueryParams(session_id=sid, job_name=table)
        req.physical_plan.CopyFrom(encode_plan(scan))
        req.settings.extend(self._settings())
        try:
            resp = self.stub.AppendData(req, timeout=30)
        except grpc.RpcError as e:
            raise GrpcError(f"AppendData failed: {e}") from None
        return json.loads(resp.job_id)

    def subscribe_query(self, statement_id: str, params=None) -> "SubscriptionStream":
        """SubscribeQuery rpc: open a server-streaming continuous query on
        a prepared statement. The first frame is a handshake carrying the
        subscription id; each subsequent frame is a refreshed job status
        whose partitions the caller fetches."""
        import json

        from ballista_tpu_torch.serving.normalize import encode_params

        sid = self.ensure_session()
        body = {"statement_id": statement_id}
        if params is not None:
            body["params"] = encode_params(params)
        req = pb.ExecuteQueryParams(sql=json.dumps(body), session_id=sid)
        req.settings.extend(self._settings())
        call = self.stub.SubscribeQuery(req)
        return SubscriptionStream(call)

    def cancel_job(self, job_id: str) -> None:
        self.stub.CancelJob(pb.CancelJobParams(job_id=job_id), timeout=10)

    def job_metrics(self, job_id: str):
        return self.stub.GetJobMetrics(pb.GetJobMetricsParams(job_id=job_id), timeout=10)

    def collect(self, df) -> pa.Table:
        from ballista_tpu_torch.client.context import fetch_job_results
        from ballista_tpu_torch.config import PUSH_STATUS

        timeout = float(self.config.get(CLIENT_JOB_TIMEOUT_S))
        sql_ok = df.sql_text is not None and not df.ctx._has_memory_tables()
        if sql_ok and bool(self.config.get(PUSH_STATUS)):
            status = self.execute_sql_push(df.sql_text, timeout=timeout)
        elif sql_ok:
            job_id = self.execute_sql(df.sql_text)
            status = self.wait_for_job(job_id, timeout=timeout)
        else:
            # memory tables can't be re-resolved from SQL on the scheduler:
            # plan client-side, ship the physical plan (MemoryScanNode
            # carries the batches as IPC bytes)
            physical = df.ctx.create_physical_plan(df.plan)
            job_id = self.execute_physical(physical)
            status = self.wait_for_job(job_id, timeout=timeout)
        if status["state"] != "successful":
            raise ExecutionError(
                f"job {status.get('job_id', '?')} {status['state']}: {status.get('error', '')}"
            )
        return fetch_job_results(status, self.config)


class SubscriptionStream:
    """Client side of a SubscribeQuery stream: a drain thread decouples the
    gRPC iterator from the caller so `next(timeout)` can time out without
    tearing down the stream. The handshake frame (job_id only, no status)
    carries the subscription id; every later frame is a refresh status."""

    def __init__(self, call):
        import queue
        import threading

        self.call = call
        self.sub_id = ""
        self.queue: "queue.Queue[dict]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._drain, name="subscription-drain", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        try:
            for event in self.call:
                if event.HasField("status"):
                    self.queue.put(decode_job_status(event.status))
                elif not self.sub_id and event.job_id:
                    self.sub_id = event.job_id
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code != grpc.StatusCode.CANCELLED:  # close() cancels; not an error
                self.queue.put({"state": "failed", "error": f"subscription stream: {e}"})

    def next(self, timeout: float = 30.0) -> dict:
        import queue

        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            raise ExecutionError(
                f"no refresh within {timeout}s on subscription {self.sub_id or '?'}"
            ) from None

    def close(self) -> None:
        self.call.cancel()
