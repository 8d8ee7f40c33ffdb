"""Per-shard scheduler event loops (horizontal scheduler capacity).

One `SchedulerServer._event_loop` thread owning every job is the
control-plane ceiling: added executors raise compute throughput while
submit/heartbeat/state-transition work still serializes through a single
queue. Sharding partitions job ownership by `shard_of(job_id) % N`: each
shard runs its own bounded event loop and admission-lag EWMA, so one hot
job's checkpoint and offer traffic no longer queues behind every other
job's. Fleet-scoped events (revive, sweep, executor_lost) are fanned in
once at `SchedulerServer.post` and multicast to the shards that own work.

`shard_of` uses CRC32, not the builtin `hash` — the builtin is salted
per process, and job→shard agreement must survive restarts and hold
across the scheduler instances of a multi-scheduler deployment.

Event-loop hygiene: `SchedulerShard._handle` forwards into
`SchedulerServer._handle` with the shard as scope; the `analysis`
`event-loop` pass roots its blocking-call search at BOTH `_handle`s and
follows `self.server.*` edges, so no shard loop may reach a blocking
call either.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import zlib

log = logging.getLogger(__name__)

EVENT_QUEUE_MAXSIZE = 10_000


def shard_of(job_id: str, num_shards: int) -> int:
    """Deterministic job→shard owner; stable across processes/restarts."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(job_id.encode("utf-8", "surrogatepass")) % num_shards


class SchedulerShard:
    """One event loop + lag EWMA over the slice of jobs it owns."""

    def __init__(self, server, shard_id: int, maxsize: int = EVENT_QUEUE_MAXSIZE):
        self.server = server
        self.shard_id = shard_id
        self.events: "queue.Queue" = queue.Queue(maxsize=maxsize)
        # EWMA of post→dequeue delay; feeds the admission state machine
        # through the server's fleet-wide max
        self.loop_lag_s = 0.0
        self.handled = 0  # lifetime event count (snapshot/diagnostics)
        self._thread: threading.Thread | None = None

    def owns(self, job_id: str) -> bool:
        return shard_of(job_id, self.server.num_shards) == self.shard_id

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._event_loop, daemon=True,
            name=f"scheduler-events-{self.shard_id}")
        self._thread.start()

    def join(self, timeout: float) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def post(self, ev) -> None:
        self.events.put(ev)

    def queue_depth(self) -> int:
        return self.events.qsize()

    def _event_loop(self) -> None:
        while self.server._running:
            try:
                ev = self.events.get(timeout=0.2)
            except queue.Empty:
                # an idle loop has zero lag by definition; decay toward it
                self.loop_lag_s *= 0.5
                continue
            lag = max(0.0, time.monotonic() - ev.posted_at)
            self.loop_lag_s = 0.8 * self.loop_lag_s + 0.2 * lag
            self.handled += 1
            try:
                self._handle(ev)
            except Exception:  # noqa: BLE001
                log.exception("shard %d event loop error on %s", self.shard_id, ev.kind)

    def _handle(self, ev) -> None:
        # scoped dispatch: the server filters job enumeration to this
        # shard's slice (event-loop hygiene pass roots here too)
        self.server._handle(ev, self)
