"""Executor registry: registration, heartbeats, slots, expiry.

Rebuild of ExecutorManager (scheduler/src/state/executor_manager.rs:62) +
the in-memory ClusterState slot accounting (cluster/memory.rs:54):
executors register with vcore counts (gated on wire-protocol version),
heartbeat on a cadence, get expired after `executor_timeout_seconds`
without one, and tasks bind against free slots under a distribution
policy (bias = fill one executor first; round-robin = spread).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ballista_tpu_torch.errors import GeneralError
from ballista_tpu_torch.executor.executor import ExecutorMetadata
from ballista_tpu_torch.version import WIRE_PROTOCOL_VERSION

DEFAULT_EXECUTOR_TIMEOUT_S = 180


@dataclass
class ExecutorSlot:
    metadata: ExecutorMetadata
    total_slots: int
    free_slots: int
    last_seen: float = field(default_factory=time.time)
    terminating: bool = False
    # -- health scoring / quarantine (decayed fail/success counters) -------
    health_state: str = "healthy"  # healthy | quarantined | probation
    health_fail: float = 0.0
    health_succ: float = 0.0
    health_updated: float = field(default_factory=time.time)
    quarantined_at: float = 0.0
    probe_inflight: bool = False
    # -- overload signals piggybacked on heartbeats -------------------------
    memory_pressure: float = 0.0  # 0..1+ fraction of pool capacity reserved
    pool_overcommitted_bytes: float = 0.0
    pressure_rejections: float = 0.0
    # -- shuffle integrity ---------------------------------------------------
    # strikes: times a READER escalated persistent corruption of bytes THIS
    # executor served (its disk is the suspect). Gauges below are the
    # executor's own heartbeat-reported reader-side counters.
    corruption_strikes: int = 0
    checksum_failures: float = 0.0
    corruption_retries: float = 0.0
    # -- direct-dispatch leases (heartbeat-reported gauges) ------------------
    active_leases: float = 0.0
    direct_dispatch_tasks: float = 0.0
    # -- out-of-core TPU execution (hbm.py demotion-ladder gauges) -----------
    tpu_hbm_budget_bytes: float = 0.0
    tpu_hbm_spill_bytes: float = 0.0
    tpu_hbm_spill_events: float = 0.0
    tpu_grace_splits: float = 0.0
    # -- lifecycle & storage (docs/lifecycle.md) -----------------------------
    lifecycle_state: str = "active"  # active | draining (drained = ledger)
    disk_used_bytes: float = 0.0
    disk_free_bytes: float = 0.0
    # executor self-reports it is past its high watermark: placement skips
    # it until the next heartbeat says otherwise
    disk_rejecting: float = 0.0
    disk_rejections: float = 0.0
    migrated_partitions: float = 0.0
    migrated_bytes: float = 0.0
    gc_reclaimed_bytes: float = 0.0
    orphans_reclaimed: float = 0.0

    @property
    def failure_rate(self) -> float:
        total = self.health_fail + self.health_succ
        return self.health_fail / total if total > 0 else 0.0

    @property
    def schedulable(self) -> bool:
        """Eligible for regular offers: quarantined/probation executors only
        receive work through the probe gate; a disk past its high watermark
        would reject the task at admission anyway, so placement skips it."""
        return (not self.terminating and self.health_state == "healthy"
                and self.disk_rejecting < 1.0)


class ExecutorManager:
    def __init__(self, task_distribution: str = "bias", timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S,
                 quarantine_threshold: float = 0.5, quarantine_min_events: float = 4.0,
                 health_half_life_s: float = 60.0, probe_backoff_s: float = 10.0):
        self.executors: dict[str, ExecutorSlot] = {}
        self.task_distribution = task_distribution
        self.timeout_s = timeout_s
        # flaky-executor quarantine knobs (cluster-scoped, not per-session):
        # an executor whose decayed failure rate crosses the threshold (with
        # at least min_events of decayed evidence) stops receiving offers
        # until a probe task succeeds. threshold <= 0 disables quarantine.
        self.quarantine_threshold = quarantine_threshold
        self.quarantine_min_events = quarantine_min_events
        self.health_half_life_s = max(1e-3, health_half_life_s)
        self.probe_backoff_s = probe_backoff_s
        self._lock = threading.RLock()
        self._rr = 0
        # terminal lifecycle ledger (docs/lifecycle.md): executors that
        # left THROUGH the drain state machine, with their handoff
        # counters — the quarantine/health ledger's "drained" terminal
        # reason. Bounded: a long-lived scheduler sees endless rolling
        # restarts.
        from ballista_tpu_torch.utils.lru import LruDict

        self.drained = LruDict(max_entries=256)

    def register(self, metadata: ExecutorMetadata) -> None:
        if metadata.wire_version != WIRE_PROTOCOL_VERSION:
            raise GeneralError(
                f"wire protocol mismatch: executor {metadata.wire_version!r} != "
                f"scheduler {WIRE_PROTOCOL_VERSION!r}"
            )
        with self._lock:
            self.executors[metadata.id] = ExecutorSlot(metadata, metadata.vcores, metadata.vcores)

    def heartbeat(self, executor_id: str, metrics: dict[str, float] | None = None) -> bool:
        """Returns False if the executor is unknown (must re-register).
        `metrics` carries the overload signals piggybacked on
        HeartBeatParams.metrics (memory_pressure, pool_overcommitted_bytes,
        pressure_rejections — see proto/ballista.proto)."""
        with self._lock:
            ex = self.executors.get(executor_id)
            if ex is None:
                return False
            ex.last_seen = time.time()
            if metrics:
                ex.memory_pressure = float(metrics.get("memory_pressure", ex.memory_pressure))
                ex.pool_overcommitted_bytes = float(
                    metrics.get("pool_overcommitted_bytes", ex.pool_overcommitted_bytes))
                ex.pressure_rejections = float(
                    metrics.get("pressure_rejections", ex.pressure_rejections))
                ex.checksum_failures = float(
                    metrics.get("checksum_failures", ex.checksum_failures))
                ex.corruption_retries = float(
                    metrics.get("corruption_retries", ex.corruption_retries))
                ex.active_leases = float(
                    metrics.get("active_leases", ex.active_leases))
                ex.direct_dispatch_tasks = float(
                    metrics.get("direct_dispatch_tasks", ex.direct_dispatch_tasks))
                ex.tpu_hbm_budget_bytes = float(
                    metrics.get("tpu_hbm_budget_bytes", ex.tpu_hbm_budget_bytes))
                ex.tpu_hbm_spill_bytes = float(
                    metrics.get("tpu_hbm_spill_bytes", ex.tpu_hbm_spill_bytes))
                ex.tpu_hbm_spill_events = float(
                    metrics.get("tpu_hbm_spill_events", ex.tpu_hbm_spill_events))
                ex.tpu_grace_splits = float(
                    metrics.get("tpu_grace_splits", ex.tpu_grace_splits))
                ex.disk_used_bytes = float(
                    metrics.get("disk_used_bytes", ex.disk_used_bytes))
                ex.disk_free_bytes = float(
                    metrics.get("disk_free_bytes", ex.disk_free_bytes))
                ex.disk_rejecting = float(
                    metrics.get("disk_rejecting", ex.disk_rejecting))
                ex.disk_rejections = float(
                    metrics.get("disk_rejections", ex.disk_rejections))
                ex.migrated_partitions = float(
                    metrics.get("migrated_partitions", ex.migrated_partitions))
                ex.migrated_bytes = float(
                    metrics.get("migrated_bytes", ex.migrated_bytes))
                ex.gc_reclaimed_bytes = float(
                    metrics.get("gc_reclaimed_bytes", ex.gc_reclaimed_bytes))
                ex.orphans_reclaimed = float(
                    metrics.get("orphans_reclaimed", ex.orphans_reclaimed))
                if float(metrics.get("lifecycle_draining", 0.0)) >= 1.0:
                    # executor-initiated (SIGTERM) drain announcement; the
                    # scheduler's drain path notices and runs the handoff
                    if ex.lifecycle_state == "active":
                        ex.lifecycle_state = "draining"
            return True

    def aggregate_pressure(self) -> float:
        """Cluster-wide memory-pressure signal for the overload state
        machine: the mean of live executors' pool saturation (mean, not
        max — one hot executor is the quarantine/retry machinery's
        problem; admission control reacts to fleet-wide saturation)."""
        with self._lock:
            live = [e for e in self.executors.values() if not e.terminating]
            if not live:
                return 0.0
            return sum(e.memory_pressure for e in live) / len(live)

    def deregister(self, executor_id: str) -> None:
        with self._lock:
            self.executors.pop(executor_id, None)

    # -- lifecycle: drain state machine (docs/lifecycle.md) -------------------

    def begin_drain(self, executor_id: str) -> bool:
        """Move an executor into the draining state: no new offers bind to
        it (terminating), but it stays registered so in-flight tasks report
        and its map outputs stay addressable for the handoff. Returns False
        for an unknown executor, and idempotently True for one already
        draining."""
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return False
            e.terminating = True
            e.lifecycle_state = "draining"
            return True

    def mark_drained(self, executor_id: str, migrated_partitions: int = 0,
                     migrated_bytes: int = 0, reason: str = "drained") -> None:
        """Terminal drain transition: deregister the executor and record it
        in the bounded drained ledger with its handoff counters."""
        with self._lock:
            self.executors.pop(executor_id, None)
            self.drained[executor_id] = {
                "state": "drained",
                "reason": reason,
                "at": time.time(),
                "migrated_partitions": int(migrated_partitions),
                "migrated_bytes": int(migrated_bytes),
            }

    def drained_snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {eid: dict(info) for eid, info in self.drained.items()}

    def get(self, executor_id: str) -> ExecutorSlot | None:
        with self._lock:
            return self.executors.get(executor_id)

    def alive_executors(self) -> list[ExecutorSlot]:
        with self._lock:
            return [e for e in self.executors.values() if not e.terminating]

    def expire_dead(self) -> list[str]:
        """Executors without a heartbeat for timeout_s (config.rs:310)."""
        now = time.time()
        with self._lock:
            dead = [eid for eid, e in self.executors.items() if now - e.last_seen > self.timeout_s]
            for eid in dead:
                del self.executors[eid]
            return dead

    # -- slot binding --------------------------------------------------------

    def reserve_slots(self, n: int) -> list[tuple[str, int]]:
        """Reserve up to n slots; returns [(executor_id, count)]."""
        with self._lock:
            avail = [e for e in self.executors.values() if e.free_slots > 0 and e.schedulable]
            if not avail:
                return []
            out: list[tuple[str, int]] = []
            if self.task_distribution == "bias":
                avail.sort(key=lambda e: -e.free_slots)
                for e in avail:
                    take = min(e.free_slots, n)
                    if take:
                        e.free_slots -= take
                        out.append((e.metadata.id, take))
                        n -= take
                    if n <= 0:
                        break
            else:  # round-robin
                i = self._rr
                while n > 0 and any(e.free_slots > 0 for e in avail):
                    e = avail[i % len(avail)]
                    if e.free_slots > 0:
                        e.free_slots -= 1
                        if out and out[-1][0] == e.metadata.id:
                            out[-1] = (e.metadata.id, out[-1][1] + 1)
                        else:
                            out.append((e.metadata.id, 1))
                        n -= 1
                    i += 1
                self._rr = i
            return out

    def free_slot(self, executor_id: str, n: int = 1) -> None:
        with self._lock:
            e = self.executors.get(executor_id)
            if e is not None:
                e.free_slots = min(e.total_slots, e.free_slots + n)

    def free_slot_count(self) -> int:
        """Fleet-wide schedulable free slots (cross-shard revive gate)."""
        with self._lock:
            return sum(e.free_slots for e in self.executors.values()
                       if e.schedulable and not e.terminating)

    def take_slots(self, executor_id: str, n: int) -> int:
        """Reserve up to n slots on ONE executor (pull-mode handout: the
        poller's self-reported free capacity must still debit the shared
        ledger, or a mixed push+pull cluster double-books)."""
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None or e.terminating:
                return 0
            if e.health_state != "healthy":
                # pull-mode probe gate: a quarantined poller past its backoff
                # gets EXACTLY ONE task to prove itself with
                if (e.health_state == "quarantined" and not e.probe_inflight
                        and e.free_slots > 0
                        and time.time() - e.quarantined_at >= self.probe_backoff_s):
                    e.health_state = "probation"
                    e.probe_inflight = True
                    e.free_slots -= 1
                    return 1
                return 0
            take = max(0, min(e.free_slots, n))
            e.free_slots -= take
            return take

    @staticmethod
    def _ring_point(s: str) -> int:
        import hashlib

        return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")

    def _ring(self) -> tuple[list[int], list[str]]:
        """Sorted virtual-node ring, cached until executor membership
        changes (rebuilding + rehashing per pick would be O(tasks ×
        executors log executors) per offer)."""
        ids = tuple(sorted(
            e.metadata.id for e in self.executors.values() if not e.terminating
        ))
        cached = getattr(self, "_ring_cache", None)
        if cached is not None and cached[0] == ids:
            return cached[1], cached[2]
        ring: list[tuple[int, str]] = []
        for eid in ids:
            for v in range(8):  # virtual nodes smooth the distribution
                ring.append((self._ring_point(f"{eid}#{v}"), eid))
        ring.sort()
        points = [p for p, _ in ring]
        owners = [e for _, e in ring]
        self._ring_cache = (ids, points, owners)
        return points, owners

    def pick_consistent(self, key: str) -> str | None:
        """Consistent-hash task placement (reference: TaskDistributionPolicy
        consistent-hash, scheduler/src/config.rs:92 / cluster/mod.rs:626):
        the key (job/stage/partition identity) maps onto a ring of virtual
        executor nodes; the first ring node at-or-after the key's point
        with a free slot wins, so placement is sticky across offers (cache
        affinity) yet spills to neighbors under load."""
        import bisect

        with self._lock:
            points, owners = self._ring()
            if not points:
                return None
            i = bisect.bisect_left(points, self._ring_point(key)) % len(points)
            for off in range(len(points)):
                eid = owners[(i + off) % len(points)]
                e = self.executors.get(eid)
                if e is not None and e.schedulable and e.free_slots > 0:
                    e.free_slots -= 1
                    return eid
            return None

    def reserve_one_avoiding(self, avoid: set[str]) -> str | None:
        """Reserve a single slot on any healthy executor NOT in `avoid` —
        speculative duplicates must land away from the straggling one."""
        with self._lock:
            cands = [e for e in self.executors.values()
                     if e.free_slots > 0 and e.schedulable and e.metadata.id not in avoid]
            if not cands:
                return None
            cands.sort(key=lambda e: -e.free_slots)
            cands[0].free_slots -= 1
            return cands[0].metadata.id

    # -- health scoring / quarantine ----------------------------------------

    def _decay_locked(self, e: ExecutorSlot, now: float) -> None:
        dt = now - e.health_updated
        if dt > 0:
            f = 0.5 ** (dt / self.health_half_life_s)
            e.health_fail *= f
            e.health_succ *= f
            e.health_updated = now

    def record_task_result(self, executor_id: str, ok: bool,
                           timed_out: bool = False) -> str | None:
        """Fold one task outcome into the executor's decayed health score.
        Returns a state transition ('quarantined' | 'readmitted' |
        'requarantined') when one happened, else None. Cancelled tasks
        should NOT be reported here (they say nothing about health)."""
        now = time.time()
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return None
            self._decay_locked(e, now)
            if ok:
                e.health_succ += 1.0
            else:
                # timeouts weigh like failures: a straggling executor that
                # never fails outright is exactly what quarantine is for
                e.health_fail += 1.0
            if e.health_state == "probation":
                e.probe_inflight = False
                if ok:
                    e.health_state = "healthy"
                    # the probe clears the slate: old decayed failures must
                    # not instantly re-trip the threshold on the next miss
                    e.health_fail = 0.0
                    e.health_succ = 1.0
                    return "readmitted"
                e.health_state = "quarantined"
                e.quarantined_at = now
                return "requarantined"
            if e.health_state == "healthy" and not ok and self.quarantine_threshold > 0:
                total = e.health_fail + e.health_succ
                # epsilon: decay over the microseconds between back-to-back
                # events leaves N outcomes summing to N - ~1e-7, which must
                # still count as N against the min-events floor
                if total + 1e-6 >= self.quarantine_min_events and e.failure_rate >= self.quarantine_threshold:
                    e.health_state = "quarantined"
                    e.quarantined_at = now
                    return "quarantined"
            return None

    def record_corruption_strike(self, executor_id: str) -> str | None:
        """A reader escalated persistent corruption of bytes this executor
        SERVED: count the strike and fold it into the decayed health score
        as a failure — enough strikes quarantine the executor exactly like
        repeated task failures (its disk is suspect, not its compute, but
        either way its outputs can't be trusted). Returns the health-state
        transition when one happened."""
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return None
            e.corruption_strikes += 1
            # RLock: safe to delegate the scoring under the held lock
            return self.record_task_result(executor_id, ok=False)

    def probe_reservations(self, now: float | None = None) -> list[tuple[str, int]]:
        """Quarantined executors past their backoff get one probation slot
        each; the caller must bind a real task to it (or cancel_probe)."""
        now = time.time() if now is None else now
        out: list[tuple[str, int]] = []
        with self._lock:
            for e in self.executors.values():
                if (e.health_state == "quarantined" and not e.terminating
                        and not e.probe_inflight and e.free_slots > 0
                        and now - e.quarantined_at >= self.probe_backoff_s):
                    e.health_state = "probation"
                    e.probe_inflight = True
                    e.free_slots -= 1
                    out.append((e.metadata.id, 1))
        return out

    def cancel_probe(self, executor_id: str) -> None:
        """No task could be bound to the probe slot: put the executor back
        in quarantine (same quarantined_at, so the next offer retries)."""
        with self._lock:
            e = self.executors.get(executor_id)
            if e is not None and e.health_state == "probation" and e.probe_inflight:
                e.health_state = "quarantined"
                e.probe_inflight = False
                e.free_slots = min(e.total_slots, e.free_slots + 1)

    def probes_due(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        with self._lock:
            return any(
                e.health_state == "quarantined" and not e.probe_inflight
                and now - e.quarantined_at >= self.probe_backoff_s
                for e in self.executors.values()
            )

    def quarantined_count(self) -> int:
        with self._lock:
            return sum(1 for e in self.executors.values()
                       if e.health_state in ("quarantined", "probation"))

    def health_snapshot(self) -> dict[str, dict]:
        now = time.time()
        with self._lock:
            out = {}
            for eid, e in self.executors.items():
                self._decay_locked(e, now)
                out[eid] = {
                    "state": e.health_state,
                    "failure_rate": round(e.failure_rate, 4),
                    "decayed_failures": round(e.health_fail, 3),
                    "decayed_successes": round(e.health_succ, 3),
                    "memory_pressure": round(e.memory_pressure, 4),
                    "pool_overcommitted_bytes": int(e.pool_overcommitted_bytes),
                    "pressure_rejections": int(e.pressure_rejections),
                    "corruption_strikes": e.corruption_strikes,
                    "active_leases": int(e.active_leases),
                    "direct_dispatch_tasks": int(e.direct_dispatch_tasks),
                    "checksum_failures": int(e.checksum_failures),
                    "corruption_retries": int(e.corruption_retries),
                    "hbm_budget_bytes": int(e.tpu_hbm_budget_bytes),
                    "hbm_spill_bytes": int(e.tpu_hbm_spill_bytes),
                    "hbm_spill_events": int(e.tpu_hbm_spill_events),
                    "grace_splits": int(e.tpu_grace_splits),
                    "lifecycle_state": e.lifecycle_state,
                    "disk_used_bytes": int(e.disk_used_bytes),
                    "disk_free_bytes": int(e.disk_free_bytes),
                    "disk_rejecting": bool(e.disk_rejecting >= 1.0),
                    "disk_rejections": int(e.disk_rejections),
                    "migrated_partitions": int(e.migrated_partitions),
                    "migrated_bytes": int(e.migrated_bytes),
                    "gc_reclaimed_bytes": int(e.gc_reclaimed_bytes),
                    "orphans_reclaimed": int(e.orphans_reclaimed),
                }
            return out
