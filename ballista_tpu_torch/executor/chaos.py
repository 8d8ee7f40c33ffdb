"""Chaos fault injection.

Rebuild of ChaosExec + ChaosCreatingRule (core/src/execution_plans/
chaos_exec.rs:49, scheduler/src/state/aqe/optimizer_rule/chaos_exec.rs:58):
when `ballista.chaos.enabled` is on, the executor's engine seam wraps every
leaf operator in a ChaosExec that — with seeded probability — injects a
transient error (retryable), a fatal error, a panic (non-BallistaError
exception), or a delay. Robustness tests run real queries under injected
failures and assert the retry machinery converges.

Determinism: the RNG seed mixes (config seed, job, stage, partition,
attempt) so a retried task sees DIFFERENT luck — exactly what makes
transient-fault tests terminate.

Mode 'corrupt' is the exception: it is a SERVE-time fault (the Flight
server flips a bit in the bytes it streams, keyed by `corrupt_roll`/
`flip_bit` below), so ChaosExec itself treats it as a no-op at execute
time. The data plane has no session config, hence the env knobs
BALLISTA_CHAOS_CORRUPT_P / BALLISTA_CHAOS_CORRUPT_ONCE / BALLISTA_CHAOS_SEED
documented on `ballista.chaos.mode`.

Mode 'skew' faults the shuffle-writer PARTITIONER rather than leaf
execution (wrapping leaves would hide device-compiled stages from the
chain matcher, same trap 'hbm_oom' avoids): when armed, every bucketed
ShuffleWriterExec reroutes a seeded fraction of rows into one hot reduce
partition via `skew_remap_pids` below. The reroute is a pure function of
the row's KEY HASH — never of row position — so equal keys still
co-locate, both sides of a co-partitioned join skew identically, and
query results stay byte-identical while one partition absorbs the load.
Deterministic fuel for the AQE skew-split defense (docs/aqe.md).

Modes 'daemon_crash' and 'daemon_hang' fault the DEVICE-DAEMON process
(docs/device_daemon.md#failure-domain) and never wrap the plan either —
wrapping leaves would hide device stages from the chain matcher, and the
fault must fire in the DAEMON's process, not the executor's. The session
config carries the arming (`ballista.chaos.daemon.arm` picks the point:
pre_execute / mid_execute / post_execute; `ballista.chaos.daemon.once`
bounds it to the first armed request per socket) to the daemon, whose
execute handler kills itself uncleanly (daemon_crash → os._exit(137)) or
wedges until the execute watchdog fires (daemon_hang → diagnosed exit 4
with a <socket>.crash.json post-mortem). Deterministic fuel for the
crash-recovery / quarantine ladder in ops/tpu/daemon_route.py.

Mode 'disk_full' faults the STORAGE path and never wraps the plan: the
shuffle writer's commit points and the spill pool's disk demotions poll
`maybe_disk_full` below, which raises a typed DiskExhausted on a seeded
roll keyed by (seed, job, stage, partition[, attempt]). With
`ballista.chaos.disk.once` (the default) a hit is recorded so the
RETRY of the same slice heals — the injected ENOSPC is transient
storage pressure, and robustness tests assert no job ever fails to it.

Mode 'drain_kill' faults the DRAIN state machine (docs/lifecycle.md):
BALLISTA_CHAOS_DRAIN_KILL_AFTER=N makes a graceful drain's shuffle
migration die after N committed locations (`drain_kill_after` below),
exercising the hard-kill-mid-drain fallback to the recompute path.

Mode 'hbm_oom' is the other plan-wrapping exception: it faults the DEVICE memory path,
which chaos cannot reach by wrapping plan leaves — the TPU engine seam
runs after chaos injection, and a ChaosExec-wrapped scan would hide the
stage from the device compiler's chain matcher entirely (silently testing
the CPU path instead). It arms module state in `ops.tpu.hbm` instead:
the admission budget shrinks to BALLISTA_CHAOS_HBM_BUDGET bytes (default
1 MiB) and, with BALLISTA_CHAOS_HBM_OOM_N > 0, the Nth device upload
raises a synthetic RESOURCE_EXHAUSTED once. CPU-exercisable: the whole
out-of-core ladder (spill, grace, OOM-retry) runs under interpret-mode
jax in tier-1.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Iterator

import numpy as np

from ballista_tpu_torch.config import (
    CHAOS_ENABLED,
    CHAOS_MODE,
    CHAOS_PROBABILITY,
    CHAOS_SEED,
    CHAOS_SKEW_FRACTION,
    CHAOS_STRAGGLER_DELAY_S,
    CHAOS_STRAGGLER_PARTITION,
    CHAOS_STRAGGLER_STAGE,
    BallistaConfig,
)
from ballista_tpu_torch.errors import Cancelled, ExecutionError
from ballista_tpu_torch.ops.hashing import splitmix64
from ballista_tpu_torch.plan.physical import ExecutionPlan, TaskContext


def corrupt_roll(seed: int, key: str, p: float) -> bool:
    """Seeded decision for chaos mode=corrupt: should THIS serve of the
    range identified by `key` flip a bit? Pure function of (seed, key) so
    a test replaying the same serves sees the same corruption."""
    if p <= 0.0:
        return False
    h = hashlib.sha256(f"{seed}|corrupt|{key}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64 < p


def flip_bit(data: bytes, seed: int, key: str) -> bytes:
    """Deterministically flip one bit of `data` (position and bit index
    both derived from the seed+key hash). Returns a new bytes object —
    the stored file is never touched, only the served copy."""
    if not data:
        return data
    h = hashlib.sha256(f"{seed}|corrupt|{key}".encode()).digest()
    pos = int.from_bytes(h[8:16], "big") % len(data)
    bit = h[0] % 8
    out = bytearray(data)
    out[pos] ^= 1 << bit
    return bytes(out)


# disk_full once-mode ledger: keys that already fired, so the RETRY of an
# injected ENOSPC heals (the module's determinism principle, applied to a
# fault whose whole point is "transient storage pressure"). Keyed without
# the attempt so the marker survives into the retry.
from ballista_tpu_torch.utils.lru import LruDict

_DISK_FULL_FIRED = LruDict(max_entries=4096)


def disk_full_params(config: BallistaConfig) -> tuple[int, float, bool] | None:
    """(seed, probability, once) when chaos mode=disk_full is armed, else
    None. The shuffle writer and the spill pool poll this at their write
    points — disk_full never wraps the plan (the fault lives in the
    storage path, not leaf execution)."""
    try:
        if not bool(config.get(CHAOS_ENABLED)):
            return None
        if str(config.get(CHAOS_MODE)) != "disk_full":
            return None
        from ballista_tpu_torch.config import CHAOS_DISK_ONCE

        return (int(config.get(CHAOS_SEED)), float(config.get(CHAOS_PROBABILITY)),
                bool(config.get(CHAOS_DISK_ONCE)))
    except Exception:
        return None


def maybe_disk_full(config: BallistaConfig | None, job_id: str, stage_id: int,
                    partition: int, attempt: int, where: str) -> None:
    """Raise a synthetic DiskExhausted at a shuffle-write / spill-demote
    point when chaos mode=disk_full rolls a hit. In once mode the roll is
    keyed WITHOUT the attempt and a hit is recorded, so the retried task
    finds the marker and heals; otherwise the attempt joins the key and a
    retry simply sees different luck."""
    if config is None:
        return
    params = disk_full_params(config)
    if params is None:
        return
    seed, p, once = params
    key = f"{job_id}|{stage_id}|{partition}"
    if once:
        if _DISK_FULL_FIRED.get(key) is not None:
            return  # already failed this slice once: the retry heals
        h = hashlib.sha256(f"{seed}|disk_full|{key}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2**64 >= p:
            return
        _DISK_FULL_FIRED.setdefault(key, True)
    else:
        h = hashlib.sha256(f"{seed}|disk_full|{key}|{attempt}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2**64 >= p:
            return
    from ballista_tpu_torch.errors import DiskExhausted

    raise DiskExhausted(where, "chaos: injected ENOSPC (os error 28)")


def drain_kill_after() -> int:
    """Chaos mode=drain_kill arming: BALLISTA_CHAOS_DRAIN_KILL_AFTER=N
    hard-kills a drain's migration after N committed locations (0 =
    disarmed). Env-armed like the serve-time corrupt knobs: the migration
    runs in the scheduler/launcher context, which has no session config."""
    try:
        return int(os.environ.get("BALLISTA_CHAOS_DRAIN_KILL_AFTER", "0"))
    except ValueError:
        return 0


def skew_params(config: BallistaConfig) -> tuple[int, float] | None:
    """(seed, fraction) when chaos mode=skew is armed, else None. The
    shuffle writer polls this per task — skew never wraps the plan."""
    try:
        if not bool(config.get(CHAOS_ENABLED)):
            return None
        if str(config.get(CHAOS_MODE)) != "skew":
            return None
        return int(config.get(CHAOS_SEED)), float(config.get(CHAOS_SKEW_FRACTION))
    except Exception:
        return None


def skew_remap_pids(h: np.ndarray, k: int, seed: int, fraction: float) -> np.ndarray:
    """Chaos mode=skew partitioner remap: route ~`fraction` of rows to the
    hot partition `seed % k`, the rest to their honest `h % k` home.

    The reroute decision re-mixes the row's key hash with a seeded salt,
    so it is a pure function of the KEY — equal keys always land together
    (results stay byte-identical) and every writer of a co-partitioned
    exchange, host- or device-hashed, skews the same rows."""
    h = h.astype(np.uint64, copy=False)
    pids = (h % np.uint64(k)).astype(np.uint64)
    if k <= 1 or fraction <= 0.0:
        return pids
    hot = np.uint64(seed % k)
    if fraction >= 1.0:
        return np.full_like(pids, hot)
    salt = splitmix64(np.array([seed & 0xFFFFFFFFFFFFFFFF], dtype=np.uint64))[0]
    mixed = splitmix64(h ^ salt)
    threshold = np.uint64(int(fraction * float(2**64)))
    return np.where(mixed < threshold, hot, pids)


class ChaosExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, seed: int, probability: float, mode: str,
                 stage_attempt: int = 0, straggler_delay_s: float = 5.0,
                 straggler_partition: int = -1):
        super().__init__(input.df_schema)
        self.input = input
        self.seed = seed
        self.probability = probability
        self.mode = mode
        self.stage_attempt = stage_attempt
        self.straggler_delay_s = straggler_delay_s
        self.straggler_partition = straggler_partition

    def children(self):
        return [self.input]

    def with_children(self, c):
        return ChaosExec(c[0], self.seed, self.probability, self.mode, self.stage_attempt,
                         self.straggler_delay_s, self.straggler_partition)

    def node_str(self) -> str:
        return f"ChaosExec: mode={self.mode} p={self.probability}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator:
        if self.mode == "straggler":
            self._maybe_straggle(partition, ctx)
            return self.input.execute(partition, ctx)
        h = hashlib.sha256(
            f"{self.seed}|{ctx.task_id}|{partition}|{self.stage_attempt}".encode()
        ).digest()
        roll = int.from_bytes(h[:8], "big") / 2**64
        if roll < self.probability:
            if self.mode == "transient":
                raise ExecutionError(f"chaos: injected transient failure (roll={roll:.4f})", retryable=True)
            if self.mode == "fatal":
                raise ExecutionError(f"chaos: injected fatal failure (roll={roll:.4f})", retryable=False)
            if self.mode == "panic":
                raise RuntimeError("chaos: injected panic")
            if self.mode == "delay":
                time.sleep(0.2)
            if self.mode == "overload":
                return self._overloaded_execute(partition, ctx)
        return self.input.execute(partition, ctx)

    def _overloaded_execute(self, partition: int, ctx: TaskContext) -> Iterator:
        """Synthetic memory pressure: reserve the session pool's whole
        capacity for this partition's duration (grow_wait with a zero
        deadline forces the reservation through, counting it in
        `overcommitted`) plus a queue delay. Deterministic fuel for
        overload tests: while the hit partition runs, the pool reads
        saturated, so the executor's admission gate rejects new tasks and
        the heartbeat pressure score goes to >= 1."""
        pool = getattr(ctx, "memory_pool", None)
        held = 0
        if pool is not None:
            # one byte PAST capacity: even an idle pool ends up overcommitted
            held = max(2, pool.capacity + 1)
            pool.grow_wait(held, timeout_s=0.0)
        try:
            time.sleep(min(self.straggler_delay_s, 0.5))
            yield from self.input.execute(partition, ctx)
        finally:
            if pool is not None:
                pool.shrink(held)

    def _maybe_straggle(self, partition: int, ctx: TaskContext) -> None:
        """Deterministic slow-partition injection: the roll is keyed on the
        PARTITION alone (task ids differ across attempts/schedulers, so
        mixing them in would make 'which partition straggles' a lottery),
        and only attempt 0 straggles — a speculative duplicate of the same
        partition must be able to win."""
        if getattr(ctx, "task_attempt", 0) != 0:
            return
        if self.straggler_partition >= 0:
            hit = partition == self.straggler_partition
        else:
            h = hashlib.sha256(f"{self.seed}|straggler|{partition}".encode()).digest()
            hit = int.from_bytes(h[:8], "big") / 2**64 < self.probability
        if not hit:
            return
        # sleep in small increments so a CancelTasks push (speculation's
        # loser-kill) or the task deadline preempts the straggler mid-nap
        deadline_at = float(getattr(ctx, "deadline_at", 0.0) or 0.0)
        cancel_check = getattr(ctx, "cancel_check", None)
        end = time.time() + self.straggler_delay_s
        while time.time() < end:
            if cancel_check is not None and cancel_check():
                raise Cancelled("chaos: straggler cancelled mid-delay")
            if deadline_at and time.time() > deadline_at:
                err = ExecutionError("chaos: straggler exceeded task deadline", retryable=True)
                err.timed_out = True
                raise err
            time.sleep(min(0.05, max(0.0, end - time.time())))


def _sync_hbm_chaos(enabled: bool, mode: str) -> None:
    """Arm or disarm the hbm_oom override in ops.tpu.hbm. Always syncs —
    a previous session's armed state must not leak into a chaos-off run.
    `ops.tpu.hbm` is import-light (no jax at module scope), so this does
    not drag a backend into CPU-only executors."""
    from ballista_tpu_torch.ops.cuda import hbm

    if enabled and mode == "hbm_oom":
        hbm.arm_chaos(
            int(os.environ.get("BALLISTA_CHAOS_HBM_BUDGET", str(1 << 20))),
            int(os.environ.get("BALLISTA_CHAOS_HBM_OOM_N", "0")))
    else:
        hbm.disarm_chaos()


def maybe_inject_chaos(plan: ExecutionPlan, config: BallistaConfig, stage_attempt: int = 0) -> ExecutionPlan:
    enabled = bool(config.get(CHAOS_ENABLED))
    mode = str(config.get(CHAOS_MODE)) if enabled else ""
    _sync_hbm_chaos(enabled, mode)
    if not enabled or mode in ("hbm_oom", "skew", "daemon_crash", "daemon_hang",
                               "disk_full", "drain_kill"):
        # these modes never wrap the plan (see module docstring): the
        # faults live in the device upload path / the shuffle partitioner /
        # the device-daemon process / the storage and drain paths, not in
        # leaf execution
        return plan
    seed = int(config.get(CHAOS_SEED))
    prob = float(config.get(CHAOS_PROBABILITY))
    delay_s = float(config.get(CHAOS_STRAGGLER_DELAY_S))
    straggler_part = int(config.get(CHAOS_STRAGGLER_PARTITION))
    straggler_stage = int(config.get(CHAOS_STRAGGLER_STAGE))
    if mode == "straggler" and straggler_stage >= 0:
        # stage roots are ShuffleWriterExecs carrying their stage id; leave
        # other stages' plans untouched so the straggle fires exactly once
        if getattr(plan, "stage_id", -1) != straggler_stage:
            return plan

    def walk(n: ExecutionPlan) -> ExecutionPlan:
        kids = n.children()
        if not kids:
            return ChaosExec(n, seed, prob, mode, stage_attempt, delay_s, straggler_part)
        return n.with_children([walk(c) for c in kids])

    return walk(plan)
