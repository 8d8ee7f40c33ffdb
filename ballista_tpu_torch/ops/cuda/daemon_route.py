"""Shared daemon-routing ladder for device stages.

Counterpart of the JAX package's ops/tpu/daemon_route.py. Every stage
family that ships work to the warm device-runtime daemon (TpuStageExec
partials and TpuFinalStageExec merges; the mesh exchange's route waits
for the mesh, and sort and window stages are not routed, as in the
reference) goes through `run_via_daemon`, which owns the whole failure
domain (docs/device_daemon.md#failure-domain):

1. quarantine check — a stage fingerprint that already killed two daemon
   incarnations is demoted straight to the in-process ladder;
2. serialize the RAW subtree (device wrappers unwrapped via
   `unwrap_device_stages`; the daemon recompiles through the same
   maybe_compile_tpu entry, so results are byte-identical and the
   fingerprints — hence the daemon's table, build and LUT cache keys —
   are stable);
3. execute with a deadline derived from the stage's byte estimate
   (protocol.derive_execute_timeout_s) that the daemon-side watchdog
   enforces too;
4. on a typed DaemonCrashed: count it, classify a watchdog kill from the
   <socket>.crash.json post-mortem, respawn-and-retry ONCE, and poison
   the fingerprint on the second crash so nothing crash-loops.

Outcomes land in RunStats as daemon_failover / daemon_failover_reason,
and the process-lifetime failure counters (daemon_restarts,
daemon_crashes_detected, watchdog_kills, poisoned_stages) are mirrored
into the merged stats so they ride the executor heartbeat.

Like the client module, this file makes no torch.cuda call.
"""

from __future__ import annotations

import logging
import zlib

from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
from ballista_tpu_torch.plan.physical import ExecutionPlan

log = logging.getLogger(__name__)


def stage_tag(prefix: str, fingerprint: str) -> str:
    """The daemon-visible identity of a stage: stable across processes
    (quarantine entries must outlive the client that wrote them) and
    short enough for a JSON header."""
    return f"{prefix}_{zlib.crc32(fingerprint.encode()):08x}"


def unwrap_device_stages(plan: ExecutionPlan) -> ExecutionPlan:
    """Replace every compiled device wrapper in `plan` with the raw
    subtree it stands for, so serde can encode the tree. The daemon's
    maybe_compile_tpu re-derives the SAME wrappers from the raw shape —
    unwrap + recompile is identity up to process boundary."""
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.sort_window import (
        TpuSortStageExec,
        TpuWindowStageExec,
    )
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.plan.physical import (
        CoalescePartitionsExec,
        SortExec,
        WindowExec,
    )

    if isinstance(plan, TpuStageExec):
        raw = plan.partial_agg.with_children([plan._raw_chain()])
        return unwrap_device_stages(raw) if raw is not plan else raw
    if isinstance(plan, TpuFinalStageExec):
        node = unwrap_device_stages(plan.child)
        if plan.coalesce:
            # match_final_stage consumed a CoalescePartitionsExec to set
            # coalesce=True; re-add it so the daemon re-derives the shape
            node = CoalescePartitionsExec(node)
        node = plan.agg.with_children([node])
        for op in reversed(plan.post_ops):
            node = op.with_children([node])
        if plan.sort is not None:
            node = plan.sort.with_children([node])
        return node
    if isinstance(plan, TpuSortStageExec):
        return plan._keep_stamp(
            SortExec(unwrap_device_stages(plan.input), plan.keys, plan.fetch))
    if isinstance(plan, TpuWindowStageExec):
        return WindowExec(unwrap_device_stages(plan.input), plan.window_exprs,
                          plan.df_schema)
    kids = plan.children()
    if not kids:
        return plan
    new_kids = [unwrap_device_stages(c) for c in kids]
    if all(a is b for a, b in zip(new_kids, kids)):
        return plan
    return plan.with_children(new_kids)


def _mirror_counters() -> None:
    """Publish the process-lifetime failure counters into the merged
    RunStats view, so they ride the executor heartbeat."""
    from ballista_tpu_torch.device_daemon import client as dclient

    c = dclient.failure_counters()
    RUN_STATS.set("daemon_restarts", float(c.get("daemon_restarts", 0)))
    RUN_STATS.set("daemon_crashes_detected",
                  float(c.get("daemon_crashes_detected", 0)))
    RUN_STATS.set("watchdog_kills", float(c.get("watchdog_kills", 0)))
    RUN_STATS.set("poisoned_stages", float(c.get("poisoned_stages", 0)))


def _note_local(mode_reason: str, failover: str = "",
                failover_reason: str = "") -> None:
    RUN_STATS.set("daemon_mode", "in_process")
    RUN_STATS.set("daemon_mode_reason", mode_reason[:300])
    RUN_STATS.set("daemon_attached", 0.0)
    if failover:
        RUN_STATS.set("daemon_failover", failover)
        RUN_STATS.set("daemon_failover_reason", failover_reason[:300])
    _mirror_counters()


def run_via_daemon(config, *, plan_builder, partitions, tag: str,
                   fingerprint: str, emit_pid=None, est_bytes: int = 0):
    """Ship one stage through the daemon's failure-domain ladder.

    Returns {partition: [batches]} on success, None to mean 'run it
    locally' — with the reason in RunStats daemon_mode_reason and, for
    crash-driven demotions, daemon_failover / daemon_failover_reason.
    `plan_builder` is called lazily (only when the daemon is enabled and
    the stage is not quarantined) and must return the raw subtree; device
    wrappers in it are unwrapped here. Never raises.
    """
    from ballista_tpu_torch.config import TPU_DAEMON_ENABLED, TPU_DAEMON_POISON_TTL_S

    if not bool(config.get(TPU_DAEMON_ENABLED)):
        return None
    from ballista_tpu_torch.device_daemon import client as dclient

    path = dclient.resolve_socket(config)
    ttl = float(config.get(TPU_DAEMON_POISON_TTL_S))
    if dclient.is_poisoned(path, tag, ttl):
        _note_local(f"poisoned: {tag} quarantined after repeated daemon "
                    "crashes", failover="poisoned",
                    failover_reason=f"{tag} in quarantine (ttl {ttl:.0f}s)")
        log.warning("stage %s is quarantined; running in-process", tag)
        return None
    try:
        from ballista_tpu_torch import serde

        raw = unwrap_device_stages(plan_builder())
        plan_bytes = serde.plan_to_bytes(raw)
    except Exception as e:  # noqa: BLE001 — a shape serde can't carry yet
        _note_local(f"serde_failed: {e}")
        log.info("stage %s not daemon-serializable (%s); running in-process",
                 tag, e)
        return None
    deadline_s = protocol_deadline(config, est_bytes)

    for attempt in (0, 1):
        client, mode, reason = dclient.attach(config)
        if client is None:
            _note_local(reason)
            log.info("daemon unavailable (%s); running stage in-process",
                     reason)
            return None
        if attempt > 0:
            # the ladder brought a daemon back after a crash (respawned,
            # or a supervisor's replacement answered) — a recovery event
            dclient.bump_counter("daemon_restarts")
        crashed_gen = client.generation
        try:
            results, resp = client.execute(
                plan_bytes, config.to_key_value_pairs(), partitions,
                emit_pid=emit_pid, tag=tag, deadline_s=deadline_s)
        except dclient.DaemonCrashed as e:
            dclient.bump_counter("daemon_crashes_detected")
            dclient.drop_attached(path)
            # classify: a diagnosed watchdog kill leaves a post-mortem for
            # THIS incarnation next to the socket (fresh binds remove
            # stale ones, so generation can only match the latest corpse)
            report = dclient.read_crash_report(path)
            if (report is not None and report.get("kind") == "watchdog"
                    and (not crashed_gen
                         or report.get("generation") == crashed_gen)):
                dclient.bump_counter("watchdog_kills")
            count = dclient.record_stage_crash(path, tag, fingerprint, ttl)
            log.warning("daemon crashed running %s (%s; crash %d/%d)",
                        tag, e.reason, count, dclient.POISON_CRASH_THRESHOLD)
            if count >= dclient.POISON_CRASH_THRESHOLD:
                dclient.bump_counter("poisoned_stages")
                _note_local(
                    f"poisoned: {tag} crashed {count} daemons",
                    failover="poisoned",
                    failover_reason=f"crash ({e.reason}) x{count}; quarantined")
                return None
            if attempt == 0:
                # respawn-and-retry ONCE: attach() reruns its ladder (the
                # spawn knob governs whether a dead daemon is restarted)
                continue
            _note_local(f"daemon_crashed: {e}", failover="crashed",
                        failover_reason=f"crash ({e.reason}) after retry")
            return None
        except RuntimeError as e:
            if getattr(e, "poisoned", False):
                # a respawned daemon refusing a quarantined stage: clean
                # demotion, not a new crash against the fingerprint
                _note_local(f"poisoned: {e}", failover="poisoned",
                            failover_reason="daemon refused quarantined stage")
                return None
            _note_local(f"execute_failed: {e}")
            log.warning("daemon execute failed; running stage in-process: %s",
                        e)
            return None
        except Exception as e:  # noqa: BLE001 — the daemon must never fail
            # a query the in-process engine can run
            _note_local(f"execute_failed: {e}")
            log.warning("daemon execute failed; running stage in-process",
                        exc_info=True)
            return None
        _mirror_success(tag, resp, reason, retried=attempt > 0)
        return results
    return None  # unreachable; the loop always returns


def protocol_deadline(config, est_bytes: int) -> float:
    from ballista_tpu_torch.config import TPU_DAEMON_EXECUTE_TIMEOUT_S
    from ballista_tpu_torch.device_daemon import protocol

    return protocol.derive_execute_timeout_s(
        float(config.get(TPU_DAEMON_EXECUTE_TIMEOUT_S)), est_bytes)


def _mirror_success(tag: str, resp: dict, reason: str, retried: bool) -> None:
    """Publish the daemon's mirrored engine stats under this stage's tag:
    the client's RUN_STATS (heartbeat, bench events) reports the device
    work even though it happened in the daemon process."""
    with RUN_STATS.run(tag) as rec:
        for k, v in resp.get("stats", {}).items():
            if isinstance(v, (int, float, str, bool)):
                rec[k] = v
        rec["daemon_mode"] = "attached"
        rec["daemon_mode_reason"] = reason
        rec["daemon_attached"] = 1.0
        rec["daemon_sessions"] = float(resp.get("sessions", 0))
        rec["daemon_queue_depth"] = float(resp.get("queue_depth", 0))
        if retried:
            rec["daemon_failover"] = "daemon_restarted"
            rec["daemon_failover_reason"] = "crash recovered by respawn+retry"
        init_s = resp.get("init_phase_s", {})
        if "platform_probe" in init_s:
            rec["init_platform_probe_s"] = float(init_s["platform_probe"])
        if "cuda_devices" in init_s:
            rec["init_cuda_devices_s"] = float(init_s["cuda_devices"])
        if "first_launch" in init_s:
            rec["init_first_launch_s"] = float(init_s["first_launch"])
    _mirror_counters()
