"""Revocable executor lease tokens: scheduler-less direct dispatch.

The serving tier's fast lane (single-stage dispatch from the submit
thread) still pays one scheduler round trip per query. A lease takes the
scheduler out of the hot path entirely: it mints a token carrying a
capacity slice on one warm executor (slots), an expiry, and a reserved
task-id band, and hands it to a client holding a prepared statement. The
client binds parameters and dispatches single-stage jobs straight to the
executor — the scheduler only hears about completed work through
asynchronous reconciliation (`SchedulerServer.reconcile_direct_dispatch`).

Three parties, three structures:

- `ExecutorLease` — the token itself. The client's copy allocates task
  ids from the band; the executor's copy enforces it.
- `LeaseRegistry` — scheduler side: band allocation (disjoint by
  construction, verified by `analysis.plan_check.verify_lease_bands`),
  expiry sweeping, revocation, and dispatch accounting for KEDA.
- `LeaseTable` — executor side: admits a direct task only when the lease
  is known, unexpired, unrevoked, inside its band, under its concurrency
  slice, and — when the executor runs attached to a device daemon —
  only while the daemon's boot generation still matches the one the
  grant was stamped with ("stale-daemon-generation" fences dispatch
  against a silently restarted daemon; see
  docs/device_daemon.md#failure-domain). A rejection reason string is
  the demotion signal — the client falls back to the scheduled graph
  path, which produces byte-identical results.

Task ids: graph tasks stay below `FAST_TASK_ID_BASE` (1_000_000),
fast-lane tasks live in [FAST_TASK_ID_BASE, DIRECT_TASK_ID_BASE), and
direct-dispatch bands start at `DIRECT_TASK_ID_BASE` — a stale direct
result can never collide with a scheduler-assigned task id.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

from ballista_tpu_torch.serving.fast_lane import FAST_TASK_ID_BASE  # noqa: F401 — band layout

# direct-dispatch task ids start one band family above the fast lane
DIRECT_TASK_ID_BASE = 2_000_000
DEFAULT_BAND_SIZE = 10_000
DEFAULT_LEASE_TTL_S = 30.0
DEFAULT_LEASE_SLOTS = 2


@dataclass
class ExecutorLease:
    """A revocable capacity slice on one executor.

    `band_start`/`band_size` reserve a private task-id range; the client
    allocates ids from it monotonically (`take_task_id`) and the executor
    rejects anything outside it. Wire-friendly: `to_wire`/`from_wire`
    round-trip through a plain dict (the Flight action body)."""

    lease_id: str
    executor_id: str
    host: str
    flight_port: int
    session_id: str
    slots: int
    expires_at: float
    band_start: int
    band_size: int
    revoked: bool = False
    # device-daemon boot generation the warm capacity was promised
    # against ("" = unfenced). A daemon that silently restarted between
    # grant and dispatch has cold caches and a different failure history;
    # the executor's LeaseTable compares this token against its live
    # attachment and demotes mismatched dispatches to the scheduled path
    # (docs/device_daemon.md#failure-domain).
    daemon_generation: str = ""
    # client-side band cursor / executor-side accounting
    next_offset: int = 0
    inflight: int = 0
    tasks_total: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def rejection(self, now: float | None = None) -> str | None:
        """Why this token must not admit another task, or None."""
        if self.revoked:
            return "revoked"
        if (now if now is not None else time.time()) >= self.expires_at:
            return "expired"
        if self.next_offset >= self.band_size:
            return "band-exhausted"
        return None

    def take_task_id(self) -> int | None:
        """Allocate the next task id from the reserved band (client side);
        None once the band is exhausted — time for a fresh lease."""
        with self._lock:
            if self.next_offset >= self.band_size:
                return None
            tid = self.band_start + self.next_offset
            self.next_offset += 1
            return tid

    def owns_task_id(self, task_id: int) -> bool:
        return self.band_start <= task_id < self.band_start + self.band_size

    def to_wire(self) -> dict:
        return {
            "lease_id": self.lease_id, "executor_id": self.executor_id,
            "host": self.host, "flight_port": self.flight_port,
            "session_id": self.session_id, "slots": self.slots,
            "expires_at": self.expires_at,
            "band_start": self.band_start, "band_size": self.band_size,
            "daemon_generation": self.daemon_generation,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "ExecutorLease":
        return cls(
            lease_id=str(d["lease_id"]), executor_id=str(d["executor_id"]),
            host=str(d.get("host", "")), flight_port=int(d.get("flight_port", 0)),
            session_id=str(d.get("session_id", "")), slots=int(d["slots"]),
            expires_at=float(d["expires_at"]),
            band_start=int(d["band_start"]), band_size=int(d["band_size"]),
            daemon_generation=str(d.get("daemon_generation", "")),
        )

    def clone(self) -> "ExecutorLease":
        """Independent copy with fresh accounting (the executor's table and
        the client each hold their own view of the same token)."""
        return replace(self, next_offset=0, inflight=0, tasks_total=0,
                       _lock=threading.Lock())


class LeaseRegistry:
    """Scheduler-side lease ledger: mint, revoke, expire, reconcile."""

    def __init__(self, base: int = DIRECT_TASK_ID_BASE,
                 band_size: int = DEFAULT_BAND_SIZE):
        self.base = base
        self.default_band_size = band_size
        self._lock = threading.Lock()
        self._leases: dict[str, ExecutorLease] = {}
        self._next_band = 0
        self._seq = 0
        # counters (KEDA / REST / metrics): lifetime, never reset
        self.minted = 0
        self.denied = 0
        self.revoked_total = 0
        self.expired_total = 0
        self.reconciled_jobs = 0
        self.reconciled_tasks = 0
        self.demoted_jobs = 0

    def mint(self, executor_id: str, host: str, flight_port: int,
             session_id: str, slots: int, ttl_s: float,
             band_size: int | None = None,
             daemon_generation: str = "") -> ExecutorLease:
        size = self.default_band_size if band_size is None else int(band_size)
        with self._lock:
            self._seq += 1
            band_start = self.base + self._next_band
            self._next_band += size
            lease = ExecutorLease(
                lease_id=f"lease-{self._seq}-{executor_id[:8]}",
                executor_id=executor_id, host=host, flight_port=flight_port,
                session_id=session_id, slots=max(1, int(slots)),
                expires_at=time.time() + ttl_s,
                band_start=band_start, band_size=size,
                daemon_generation=daemon_generation,
            )
            self._leases[lease.lease_id] = lease
            self.minted += 1
            return lease

    def get(self, lease_id: str) -> ExecutorLease | None:
        with self._lock:
            return self._leases.get(lease_id)

    def revoke(self, lease_id: str) -> ExecutorLease | None:
        """Mark revoked and unlink; returns the lease so the caller can
        return its slots and push the revocation to the executor."""
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return None
            lease.revoked = True
            self.revoked_total += 1
            return lease

    def expire(self, now: float | None = None) -> list[ExecutorLease]:
        """Drop leases past expiry; returns them for slot return + push."""
        now = time.time() if now is None else now
        out = []
        with self._lock:
            for lid, lease in list(self._leases.items()):
                if now >= lease.expires_at:
                    lease.revoked = True
                    out.append(self._leases.pop(lid))
            self.expired_total += len(out)
        return out

    def note_reconciled(self, lease_id: str | None, tasks: int) -> None:
        with self._lock:
            self.reconciled_jobs += 1
            self.reconciled_tasks += max(0, int(tasks))
            lease = self._leases.get(lease_id or "")
            if lease is not None:
                lease.tasks_total += max(0, int(tasks))

    def note_demoted(self) -> None:
        with self._lock:
            self.demoted_jobs += 1

    def active(self) -> list[ExecutorLease]:
        with self._lock:
            return list(self._leases.values())

    def active_count(self) -> int:
        with self._lock:
            return len(self._leases)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active": len(self._leases),
                "minted": self.minted,
                "denied": self.denied,
                "revoked": self.revoked_total,
                "expired": self.expired_total,
                "direct_jobs_reconciled": self.reconciled_jobs,
                "direct_tasks_reconciled": self.reconciled_tasks,
                "direct_jobs_demoted": self.demoted_jobs,
            }


class LeaseTable:
    """Executor-side lease enforcement. The scheduler pushes grants and
    revocations through the launcher/Flight seam; `admit` gates every
    direct-dispatch task on validity, band membership, and the lease's
    concurrency slice. Counters ride the executor heartbeat."""

    def __init__(self, generation_probe=None):
        self._lock = threading.Lock()
        self._leases: dict[str, ExecutorLease] = {}
        self.tasks_total = 0  # direct_dispatch_tasks heartbeat gauge
        self.rejections = 0
        # () -> str: the live device-daemon generation this executor is
        # attached to ("" when unattached). Grants are stamped with it and
        # admit re-probes — a silently restarted daemon fails the fence.
        self._generation_probe = generation_probe

    def _probe_generation(self) -> str:
        if self._generation_probe is None:
            return ""
        try:
            return str(self._generation_probe() or "")
        except Exception:  # noqa: BLE001 — fencing must not break admits
            return ""

    def grant(self, lease: ExecutorLease) -> None:
        granted = lease.clone()
        if not granted.daemon_generation:
            # scheduler minted without a generation (it cannot see this
            # executor's daemon): stamp the live one at grant time, so
            # the fence measures drift from THIS moment
            granted.daemon_generation = self._probe_generation()
        with self._lock:
            self._leases[lease.lease_id] = granted

    def revoke(self, lease_id: str) -> None:
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is not None:
                lease.revoked = True

    def admit(self, lease_id: str, task_id: int) -> str | None:
        """Admission check for one direct task: None = admitted (call
        `release` when the task finishes), else the rejection reason."""
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None:
                self.rejections += 1
                return "unknown-lease"
            reason = lease.rejection()
            if reason is None and not lease.owns_task_id(task_id):
                reason = "band-violation"
            if reason is None and lease.daemon_generation:
                live = self._probe_generation()
                if live != lease.daemon_generation:
                    # the daemon restarted (or detached) since the grant:
                    # the warm capacity this lease promised is gone, and a
                    # replayed poison stage would meet an unfenced daemon.
                    # Demote to the scheduled path — byte-identical there.
                    reason = "stale-daemon-generation"
            if reason is None and lease.inflight >= lease.slots:
                reason = "capacity"
            if reason is not None:
                self.rejections += 1
                return reason
            lease.inflight += 1
            lease.tasks_total += 1
            self.tasks_total += 1
            return None

    def release(self, lease_id: str) -> None:
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is not None and lease.inflight > 0:
                lease.inflight -= 1

    def expire(self, now: float | None = None) -> int:
        now = time.time() if now is None else now
        with self._lock:
            dead = [lid for lid, le in self._leases.items() if now >= le.expires_at]
            for lid in dead:
                del self._leases[lid]
            return len(dead)

    def active_count(self) -> int:
        with self._lock:
            return len(self._leases)
