"""Process-isolated task execution (DedicatedExecutor parity).

The reference runs task compute on a dedicated runtime so a misbehaving
task cannot starve the executor's IO/RPC plane
(ballista/executor/src/executor_process.rs — dedicated tokio runtime;
SURVEY §2.3 DedicatedExecutor). A Python thread pool cannot give that
guarantee: task compute shares the GIL with the daemon's gRPC/Flight
threads, and a native crash takes the whole daemon down.

`ballista.executor.task.isolation = process` (daemon flag
`--task-isolation process`) runs EACH task in a fresh spawned worker
process instead:

- true parallelism: vcore workers aggregate CPU across processes instead
  of interleaving on one GIL;
- crash isolation: a segfault/abort in a native kernel fails ONE task
  (reported `retryable`, like the reference's catch_unwind→panic path)
  — the daemon, its Flight server, and its heartbeats keep running;
- real cancellation: CancelTasks terminates the worker process mid-rows,
  not at the next cooperative checkpoint.

The task round-trips the SAME wire contract as the scheduler→executor
hop (TaskDefinitionProto in, TaskStatusProto out), so process isolation
exercises serde end-to-end by construction. Workers use the `spawn`
start method: a clean interpreter cannot inherit wedged locks from the
daemon's gRPC/Arrow threads (fork-safety), at the cost of ~1-2 s
interpreter startup per task — the mode targets long CPU-heavy tasks.
Shuffle outputs land in the shared work dir exactly as in-thread tasks'
do; the daemon's Flight server serves them identically.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import time as _time

log = logging.getLogger(__name__)

CANCEL_POLL_S = 0.2
# slack past the task deadline before the parent SIGTERMs the worker: the
# child checks its own deadline cooperatively and reports a cleaner status;
# the parent kill is the backstop for workers wedged in native code
DEADLINE_GRACE_S = 1.0


def _kill_child(child) -> None:
    child.terminate()
    child.join(timeout=5)
    if child.is_alive():
        child.kill()
        child.join(timeout=5)


def _child_main(conn, task_bytes: bytes, config_pairs: list, meta_fields: tuple,
                work_dir: str, memory_limit_per_task: int) -> None:
    """Worker entry (spawned): decode the task off the wire, run it with a
    fresh single-task Executor, ship the encoded status back."""
    try:
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.executor.executor import Executor, ExecutorMetadata
        from ballista_tpu_torch.proto import pb
        from ballista_tpu_torch.serde_control import decode_task_definition, encode_task_status

        ex_id, host, flight_port, device_ordinal = meta_fields
        meta = ExecutorMetadata(id=ex_id, host=host, flight_port=flight_port,
                                vcores=1, device_ordinal=device_ordinal)
        cfg = BallistaConfig.from_key_value_pairs(list(config_pairs),
                                                  scrub_restricted=False)
        task = decode_task_definition(
            pb.TaskDefinitionProto.FromString(task_bytes))
        ex = Executor(work_dir, meta, config=cfg)
        ex.memory_limit_per_task = memory_limit_per_task
        result = ex.execute_task(task, cfg)
        conn.send_bytes(encode_task_status(result, ex_id).SerializeToString())
    except BaseException as e:  # noqa: BLE001 — last-resort wire report
        try:
            import traceback

            from ballista_tpu_torch.proto import pb

            conn.send_bytes(pb.TaskStatusProto(
                state="failed", executor_id=meta_fields[0],
                error=f"worker: {type(e).__name__}: {e}\n"
                      f"{traceback.format_exc(limit=8)}",
                retryable=True,
            ).SerializeToString())
        except Exception:  # noqa: BLE001
            pass
    finally:
        conn.close()


def run_task_in_subprocess(executor, task, cfg):
    """Run one task in a spawned worker; returns a TaskResult. Blocks the
    calling vcore thread (slot accounting is unchanged), but the compute
    happens in the child. The parent polls the executor's cancellation
    set and SIGTERMs the child on cancel — preemptive, unlike the
    in-thread cooperative checkpoints."""
    from ballista_tpu_torch.executor.executor import TaskResult
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde_control import decode_task_status, encode_task_definition

    base = TaskResult(
        task_id=task.task_id, job_id=task.job_id, stage_id=task.stage_id,
        stage_attempt=task.stage_attempt, partitions=list(task.partitions),
        state="failed",
    )
    try:
        task_bytes = encode_task_definition(task, cfg).SerializeToString()
    except Exception as e:  # noqa: BLE001 — plan not wire-encodable
        log.warning("task %s/%s not encodable for process isolation (%s); "
                    "running in-thread", task.job_id, task.task_id, e)
        return executor.execute_task(task, cfg)

    ctx = mp.get_context("spawn")
    rx, tx = ctx.Pipe(duplex=False)
    meta = executor.metadata
    with executor._lock:
        executor.active_process_tasks += 1
        active = executor.active_process_tasks
    # the session spill pool is EXECUTOR-wide; N concurrent isolated workers
    # must split it, not each claim the full in-thread budget (which would
    # let them reserve N× the executor's memory between them)
    if executor.session_pools is not None:
        child_budget = max(1, executor.session_pools.capacity // max(1, active))
        if executor.memory_limit_per_task:
            child_budget = min(child_budget, executor.memory_limit_per_task)
    else:
        child_budget = executor.memory_limit_per_task
    deadline = float(getattr(task, "deadline_seconds", 0.0) or 0.0)
    started = _time.time()
    try:
        child = ctx.Process(
            target=_child_main,
            args=(tx, task_bytes, cfg.to_key_value_pairs(),
                  (meta.id, meta.host, meta.flight_port, meta.device_ordinal),
                  executor.work_dir, child_budget),
            daemon=True, name=f"task-{task.job_id}-{task.task_id}",
        )
        child.start()
        tx.close()
        payload = None
        while True:
            if rx.poll(CANCEL_POLL_S):
                try:
                    payload = rx.recv_bytes()
                except EOFError:
                    pass  # child died before reporting
                break
            if executor._is_cancelled(task.job_id, task.stage_id, task.task_id):
                _kill_child(child)
                base.state = "cancelled"
                base.error = f"task {task.task_id} cancelled (worker terminated)"
                return base
            if deadline > 0 and _time.time() - started > deadline + DEADLINE_GRACE_S:
                # preemptive deadline enforcement: the child may be wedged in
                # native code where cooperative checkpoints never run
                _kill_child(child)
                executor.tasks_failed += 1
                base.error = (f"task {task.task_id} exceeded its {deadline:.1f}s "
                              f"deadline (worker terminated after "
                              f"{_time.time() - started:.1f}s)")
                base.error_kind = "ExecutionError"
                base.retryable = True
                base.timed_out = True
                log.warning("task %s/%s timed out: %s", task.job_id, task.task_id, base.error)
                return base
            if not child.is_alive():
                # drain any result raced in between poll and death
                if rx.poll(0):
                    try:
                        payload = rx.recv_bytes()
                    except EOFError:
                        pass
                break
        child.join(timeout=10)
        rx.close()
    finally:
        with executor._lock:
            executor.active_process_tasks -= 1
    if payload is None:
        executor.tasks_failed += 1
        base.error = (f"task worker died without a status "
                      f"(exitcode={child.exitcode})")
        base.error_kind = "ExecutionError"
        base.retryable = True  # crash ≠ deterministic failure: retry elsewhere
        log.warning("task %s/%s: %s", task.job_id, task.task_id, base.error)
        return base
    result = decode_task_status(pb.TaskStatusProto.FromString(payload), meta)
    if result.state == "success":
        executor.tasks_run += 1
        return result
    # non-success: keep the parent's task identity (the child's last-resort
    # report may carry none) and graft the child's error detail onto it
    executor.tasks_failed += 1
    base.state = result.state
    base.error = result.error
    base.error_kind = result.error_kind
    base.retryable = result.retryable
    base.timed_out = result.timed_out
    base.fetch_failed_executor_id = result.fetch_failed_executor_id
    base.fetch_failed_stage_id = result.fetch_failed_stage_id
    base.metrics = result.metrics
    return base
