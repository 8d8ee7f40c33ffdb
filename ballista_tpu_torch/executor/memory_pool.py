"""Session-shared memory pool with try_grow semantics.

Rebuild of the reference's per-session RuntimeEnv memory pool
(executor/src/runtime_cache.rs:59): ONE pool per session id, shared by
every concurrent task of that session on this executor — so N small tasks
lend unused budget to one big sort instead of each task being statically
boxed to capacity/vcores. Consumers call try_grow before buffering and
shrink when they spill or finish; a refusal means "spill first".
"""

from __future__ import annotations

import threading
import time  # noqa: F401 — monotonic used by grow_wait and the registry TTL


class MemoryPool:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.reserved = 0
        self._lock = threading.Lock()
        self._freed = threading.Condition(self._lock)
        # forced reservations past capacity (observability: a non-zero value
        # means the deadline backstop fired under real memory pressure)
        self.overcommitted = 0
        # device headroom is split-accounted from host headroom: HBM spill
        # demotes DEVICE bytes to HOST buffers, so one ledger would let a
        # spill storm eat the budget CPU sorts spill against (and vice
        # versa). 0 = no device attached to this session's tasks.
        self.device_capacity = 0
        self.device_reserved = 0

    def set_device_capacity(self, nbytes: int) -> None:
        """Attach (or retune) the device-side ledger; monotonic max so
        concurrent tasks of one session can't shrink each other's view."""
        with self._lock:
            self.device_capacity = max(self.device_capacity, int(nbytes))

    def try_grow_device(self, nbytes: int) -> bool:
        with self._lock:
            if self.device_capacity <= 0:
                return False
            if self.device_reserved + nbytes > self.device_capacity:
                return False
            self.device_reserved += nbytes
            return True

    def shrink_device(self, nbytes: int) -> None:
        with self._lock:
            self.device_reserved = max(0, self.device_reserved - nbytes)

    def sync_device_reserved(self, nbytes: int) -> None:
        """Absolute resync from the device-cache residency snapshot: the
        stage compiler owns the cache (global, LRU, spill-demoting), so the
        ledger mirrors it instead of tracking paired grow/shrink calls that
        cache evictions on OTHER sessions' stages would unbalance."""
        with self._lock:
            self.device_reserved = max(0, int(nbytes))

    def device_pressure(self) -> float:
        """Device-ledger saturation; independent of host `pressure()` by
        construction (the split-accounting contract)."""
        with self._lock:
            if self.device_capacity <= 0:
                return 0.0
            return self.device_reserved / self.device_capacity

    def try_grow(self, nbytes: int) -> bool:
        with self._lock:
            if self.reserved + nbytes > self.capacity:
                return False
            self.reserved += nbytes
            return True

    def grow_wait(self, nbytes: int, timeout_s: float) -> bool:
        """Block until the reservation fits (another task shrinking notifies)
        or the deadline passes; a deadline pass reserves anyway — liveness
        over strictness — and is counted in `overcommitted`. Returns True
        when the reservation stayed within capacity. A single reservation
        larger than the whole pool can never be satisfied by peers
        shrinking, so it overcommits immediately instead of sleeping out
        the deadline (the write-side twin of the reader window's
        oversized-singleton admission)."""
        deadline = time.monotonic() + timeout_s
        with self._freed:
            while self.reserved + nbytes > self.capacity:
                if nbytes > self.capacity or deadline - time.monotonic() <= 0:
                    self.reserved += nbytes
                    self.overcommitted += nbytes
                    return False
                self._freed.wait(timeout=deadline - time.monotonic())
            self.reserved += nbytes
            return True

    def shrink(self, nbytes: int) -> None:
        with self._freed:
            self.reserved = max(0, self.reserved - nbytes)
            self._freed.notify_all()

    def pressure(self) -> float:
        """Saturation as a fraction of capacity; > 1.0 means overcommitted
        reservations are live right now."""
        with self._lock:
            if self.capacity <= 0:
                return 0.0
            return self.reserved / self.capacity

    @property
    def saturated(self) -> bool:
        """A new task landing here would start life overcommitted — the
        executor's admission gate rejects (retryably) instead."""
        with self._lock:
            return self.reserved >= self.capacity


class SessionPoolRegistry:
    """session id → shared MemoryPool (created on first use).

    TTL-evicting, like the reference's SessionRuntimeCache
    (executor/src/runtime_cache.rs:86): executors never hear about session
    removal from the scheduler, so pools idle past the TTL are dropped on
    the next lookup. Eviction also heals leaked reservations from tasks
    that died mid-reserve — the session's next task gets a fresh pool.
    Tasks holding a reference to an evicted pool keep using it safely; only
    new lookups see the fresh one.
    """

    def __init__(self, capacity_per_session: int, ttl_s: float = 3600.0):
        self.capacity = capacity_per_session
        self.ttl_s = ttl_s
        self._pools: dict[str, tuple[MemoryPool, float]] = {}
        self._lock = threading.Lock()

    def get(self, session_id: str) -> MemoryPool:
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            entry = self._pools.get(session_id)
            if entry is None:
                pool = MemoryPool(self.capacity)
            else:
                pool = entry[0]
            self._pools[session_id] = (pool, now)
            return pool

    def remove(self, session_id: str) -> None:
        with self._lock:
            self._pools.pop(session_id, None)

    def _sweep_locked(self, now: float) -> None:
        dead = [sid for sid, (_, used) in self._pools.items() if now - used > self.ttl_s]
        for sid in dead:
            del self._pools[sid]

    def __len__(self) -> int:
        with self._lock:
            return len(self._pools)

    def aggregate_pressure(self) -> float:
        """Max saturation across live session pools — the executor's
        heartbeat pressure score. Max, not mean: admission gating cares
        whether the pool a NEW task would join is already past budget,
        and a fresh session always starts at zero."""
        with self._lock:
            pools = [p for p, _ in self._pools.values()]
        return max((p.pressure() for p in pools), default=0.0)

    def aggregate_device_pressure(self) -> float:
        """Max device-ledger saturation across live session pools — the
        device-side twin of `aggregate_pressure`, kept separate so host
        admission gating never confuses HBM pressure with sort pressure."""
        with self._lock:
            pools = [p for p, _ in self._pools.values()]
        return max((p.device_pressure() for p in pools), default=0.0)

    def total_overcommitted(self) -> int:
        """Lifetime forced-overcommit bytes across live pools (satellite
        observability for MemoryPool.overcommitted)."""
        with self._lock:
            pools = [p for p, _ in self._pools.values()]
        return sum(p.overcommitted for p in pools)
