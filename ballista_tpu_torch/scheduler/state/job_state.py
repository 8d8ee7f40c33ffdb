"""Pluggable job-state persistence + ownership (scheduler fail-over).

Rebuild of the `JobState` trait (reference: scheduler/src/cluster/mod.rs:283)
with the ownership events stubbed there made real: graphs are externalized
through `ExecutionGraph.to_proto` at every stage completion and terminal
transition, and a restarting (or standby) scheduler `recover()`s them —
successful stages keep their materialized shuffle outputs (the durable
unit, SURVEY.md §5), anything mid-flight recomputes.

`FileJobState` is the reference's memory-only backend taken one step
further: a directory of `{job_id}.graph` protos plus `{job_id}.owner`
ownership markers (JobAcquired/JobReleased, cluster/mod.rs:221). Every
ownership read-check-write runs under a per-job flock, so acquire, lease
takeover, and release are mutually atomic; a scheduler taking over a live
owner's jobs passes `force=True` (operator decision), expired leases are
adopted without it.
"""

from __future__ import annotations

import logging
import os
import threading

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.scheduler.state.execution_graph import ExecutionGraph

log = logging.getLogger(__name__)

# checkpoint framing: MAGIC + 4-byte little-endian CRC32 of the payload +
# the serialized graph proto. Files without the magic are legacy raw protos
# (still loadable); files WITH it get verified on recover, so a torn write
# or flipped bit is skipped with a WARN instead of adopted as truth.
GRAPH_MAGIC = b"BGR1"


def _frame_graph(payload: bytes) -> bytes:
    import struct
    import zlib

    return GRAPH_MAGIC + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _unframe_graph(raw: bytes) -> bytes:
    """Payload of a framed checkpoint (verifying its CRC), or the input
    unchanged when it predates framing. Raises ValueError on a checksum
    mismatch or truncated header."""
    import struct
    import zlib

    if not raw.startswith(GRAPH_MAGIC):
        return raw
    if len(raw) < len(GRAPH_MAGIC) + 4:
        raise ValueError("truncated graph checkpoint header")
    (expected,) = struct.unpack_from("<I", raw, len(GRAPH_MAGIC))
    payload = raw[len(GRAPH_MAGIC) + 4:]
    actual = zlib.crc32(payload) & 0xFFFFFFFF
    if actual != expected:
        raise ValueError(
            f"graph checkpoint CRC mismatch: {actual:08x} != {expected:08x}")
    return payload


class JobStateStore:
    """Trait: persist/recover job graphs and arbitrate ownership."""

    def save_graph(self, graph: ExecutionGraph) -> None:  # noqa: ARG002
        return

    def remove_job(self, job_id: str) -> None:  # noqa: ARG002
        return

    def list_jobs(self) -> list[str]:
        return []

    def load_graph(self, job_id: str, config: BallistaConfig | None = None):
        return None

    def acquire(self, job_id: str, scheduler_id: str, force: bool = False) -> bool:  # noqa: ARG002
        return True

    def release(self, job_id: str, scheduler_id: str) -> None:  # noqa: ARG002
        return


class InMemoryJobState(JobStateStore):
    """The reference's default: nothing survives the process."""


class FileJobState(JobStateStore):
    # a live owner refreshes its markers on every checkpoint; an owner file
    # untouched for longer than this is considered dead and may be adopted
    # without --force (the lease expiry the reference stubs)
    LEASE_S = 600.0

    def __init__(self, state_dir: str, lease_s: float | None = None,
                 fsync: bool = False):
        self.dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        # per-job locks, not one global one: checkpoints of DIFFERENT jobs
        # are independent files (mkstemp + os.replace is already safe across
        # jobs), and sharded scheduler event loops checkpoint concurrently —
        # a global lock would serialize every shard's file I/O again
        self._locks_guard = threading.Lock()
        self._job_locks: dict[str, threading.Lock] = {}
        self.lease_s = self.LEASE_S if lease_s is None else lease_s
        self.fsync = fsync

    def _job_lock(self, job_id: str) -> threading.Lock:
        with self._locks_guard:
            lock = self._job_locks.get(job_id)
            if lock is None:
                lock = self._job_locks[job_id] = threading.Lock()
            return lock

    def _graph_path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.graph")

    def _owner_path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.owner")

    def save_graph(self, graph: ExecutionGraph) -> None:
        import tempfile

        data = _frame_graph(graph.to_proto().SerializeToString())
        path = self._graph_path(graph.job_id)
        # refresh the ownership lease alongside the checkpoint
        try:
            os.utime(self._owner_path(graph.job_id))
        except OSError:
            pass
        with self._job_lock(graph.job_id):
            # unique tmp name: two scheduler PROCESSES (forced takeover with
            # a partitioned old owner) must never interleave into one file
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic: readers never see a torn graph

    def remove_job(self, job_id: str) -> None:
        with self._job_lock(job_id):
            for p in (self._graph_path(job_id), self._owner_path(job_id)):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
        with self._locks_guard:
            self._job_locks.pop(job_id, None)

    def list_jobs(self) -> list[str]:
        try:
            return sorted(
                f[: -len(".graph")] for f in os.listdir(self.dir) if f.endswith(".graph")
            )
        except FileNotFoundError:
            return []

    def load_graph(self, job_id: str, config: BallistaConfig | None = None):
        from ballista_tpu_torch.proto import pb

        path = self._graph_path(job_id)
        try:
            with open(path, "rb") as f:
                raw = f.read()
            # CRC check first: a torn/corrupt checkpoint that still parses
            # as SOME proto is the dangerous case — garbage adopted as truth
            proto = pb.ExecutionGraphProto.FromString(_unframe_graph(raw))
            return ExecutionGraph.from_proto(proto, config)
        except FileNotFoundError:
            return None
        except ValueError as e:
            log.warning("skipping torn/corrupt job checkpoint %s: %s", path, e)
            try:
                os.replace(path, path + ".bad")
            except OSError:
                pass
            return None
        except Exception as e:  # noqa: BLE001 — corrupt/skewed graph must
            # never make the scheduler unbootable: quarantine and continue
            log.warning("quarantining unreadable job graph %s: %s", path, e)
            try:
                os.replace(path, path + ".bad")
            except OSError:
                pass
            return None

    def _owner_lock(self, job_id: str):
        """Exclusive flock on a per-job sidecar file. EVERY ownership
        read-check-write (fresh acquire, takeover, release) runs under it —
        a takeover's os.replace must not clobber a concurrent fresh acquire,
        and two standbys adopting one expired lease must see each other."""
        import contextlib
        import fcntl

        lock_path = self._owner_path(job_id) + ".lock"

        @contextlib.contextmanager
        def held():
            with open(lock_path, "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lockf, fcntl.LOCK_UN)

        return held()

    def acquire(self, job_id: str, scheduler_id: str, force: bool = False) -> bool:
        import tempfile
        import time as _time

        path = self._owner_path(job_id)
        with self._owner_lock(job_id):
            try:
                with open(path) as f:
                    owner = f.read().strip()
                stale = (_time.time() - os.path.getmtime(path)) > self.lease_s
            except OSError:
                owner, stale = "", True
            if owner == scheduler_id:
                return True
            if owner and not stale and not force:
                return False
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".owner.tmp")
            with os.fdopen(fd, "w") as f:
                f.write(scheduler_id)
            os.replace(tmp, path)  # JobAcquired
            if owner:
                log.info(
                    "job %s ownership %s from %s to %s", job_id,
                    "forced" if force else "adopted (lease expired)", owner, scheduler_id,
                )
            return True

    def release(self, job_id: str, scheduler_id: str) -> None:
        path = self._owner_path(job_id)
        with self._owner_lock(job_id):
            try:
                with open(path) as f:
                    if f.read().strip() != scheduler_id:
                        return
                os.remove(path)  # JobReleased
            except FileNotFoundError:
                pass
