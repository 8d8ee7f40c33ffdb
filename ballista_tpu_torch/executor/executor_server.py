"""ExecutorGrpc service + push-mode task runner pool.

Rebuild of executor/src/executor_server.rs: LaunchMultiTask enqueues task
definitions; a worker pool sized to vcores runs them (TaskRunnerPool
:691); completed statuses are batched back to the owning scheduler via
UpdateTaskStatus; StopExecutor / CancelTasks / RemoveJobData complete the
rpc surface (ballista.proto:984).
"""

from __future__ import annotations

import logging
import queue
import threading

import grpc

from ballista_tpu_torch.executor.executor import Executor
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.serde_control import decode_task_definition, encode_task_status

log = logging.getLogger(__name__)

SERVICE_NAME = "ballista_tpu.ExecutorGrpc"


class ExecutorGrpcService:
    def __init__(self, executor: Executor, status_sender, shutdown_cb=None):
        """status_sender(results: list[TaskResult]) → ships to scheduler."""
        self.executor = executor
        self.status_sender = status_sender
        self.shutdown_cb = shutdown_cb
        self._queue: "queue.Queue" = queue.Queue()
        self._config_cache: dict = {}
        self._workers: list[threading.Thread] = []
        self._running = True
        for i in range(max(1, executor.metadata.vcores)):
            t = threading.Thread(target=self._worker, daemon=True, name=f"task-runner-{i}")
            t.start()
            self._workers.append(t)

    def _worker(self) -> None:
        while self._running:
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            task, config = item
            try:
                result = self.executor.run_task(task, config)
                try:
                    self.status_sender([result])
                except Exception:  # noqa: BLE001
                    log.exception("failed to report task status")
            finally:
                # unfinished_tasks hits 0 only when queued AND running work
                # is done — the drain path polls it to know the executor is
                # idle (docs/lifecycle.md#drain-protocol)
                self._queue.task_done()

    def stop(self) -> None:
        self._running = False

    # -- rpcs ----------------------------------------------------------------

    def LaunchMultiTask(self, request: pb.LaunchMultiTaskParams, context) -> pb.LaunchMultiTaskResult:
        for tp in request.tasks:
            task = decode_task_definition(tp)
            cfg = self._session_config([(kv.key, kv.value) for kv in tp.props])
            self._queue.put((task, cfg))
        return pb.LaunchMultiTaskResult(success=True)

    def _session_config(self, pairs: list[tuple[str, str]]):
        """Session-scoped config cache (reference: SessionRuntimeCache,
        executor/src/runtime_cache.rs): concurrent tasks of one session
        share one parsed BallistaConfig instead of re-parsing the KV set
        per task. Bounded; keyed on the exact KV tuple."""
        from ballista_tpu_torch.config import BallistaConfig

        key = tuple(pairs)
        cfg = self._config_cache.get(key)
        if cfg is None:
            cfg = BallistaConfig.from_key_value_pairs(list(pairs), scrub_restricted=True)
            if len(self._config_cache) >= 32:
                self._config_cache.pop(next(iter(self._config_cache)))
            self._config_cache[key] = cfg
        # hand out a copy: tasks apply per-task defaults (executor memory
        # budget) and must never mutate the shared cached entry
        return cfg.copy()

    def StopExecutor(self, request: pb.StopExecutorParams, context) -> pb.StopExecutorResult:
        log.info("stop requested (force=%s): %s", request.force, request.reason)
        self.stop()
        if self.shutdown_cb is not None:
            threading.Thread(target=self.shutdown_cb, daemon=True).start()
        return pb.StopExecutorResult()

    def CancelTasks(self, request: pb.CancelTasksParams, context) -> pb.CancelTasksResult:
        for t in request.tasks:
            self.executor.cancel_task(t.job_id, t.stage_id, t.task_id)
        return pb.CancelTasksResult(cancelled=True)

    def RemoveJobData(self, request: pb.RemoveJobDataParams, context) -> pb.RemoveJobDataResult:
        import shutil
        import os

        from ballista_tpu_torch.shuffle.paths import contained_path, job_dir, validate_job_id

        try:
            job_id = validate_job_id(request.job_id)
            d = contained_path(self.executor.work_dir, job_dir(self.executor.work_dir, job_id))
        except (ValueError, PermissionError) as e:
            import grpc

            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)
        self.executor.clear_cancellations(request.job_id)
        return pb.RemoveJobDataResult()


_RPCS = {
    "LaunchMultiTask": (pb.LaunchMultiTaskParams, pb.LaunchMultiTaskResult),
    "StopExecutor": (pb.StopExecutorParams, pb.StopExecutorResult),
    "CancelTasks": (pb.CancelTasksParams, pb.CancelTasksResult),
    "RemoveJobData": (pb.RemoveJobDataParams, pb.RemoveJobDataResult),
}


def add_executor_service(server: grpc.Server, service: ExecutorGrpcService) -> None:
    handlers = {}
    for name, (req_t, _r) in _RPCS.items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(service, name),
            request_deserializer=req_t.FromString,
            response_serializer=lambda resp: resp.SerializeToString(),
        )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))


def executor_stub(channel: grpc.Channel):
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
    return stub
