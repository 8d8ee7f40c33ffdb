"""Arrow Flight shuffle server (executor data plane).

Rebuild of ballista/executor/src/flight_service.rs:

- do_get(FetchPartition ticket): streams one shuffle output partition as
  decoded record batches (hash layout: whole file; sort layout: byte range
  through the index). The stream is generator-based — batches leave as they
  decode off the memory map, the partition is never materialized with
  read_all(). A coalesced ticket ({"locations": [...]}) streams several map
  outputs of the same stage back-to-back in one call.
- do_action("io_block_transport"): raw 8 MiB block streaming of the stored
  IPC bytes with NO decode/re-encode — the preferred fast path
  (flight_service.rs:243; 8 MiB buffer :77). Blocks are zero-copy slices
  of a memory map of the shuffle file. The client reassembles and decodes
  the stream once.
- do_action("io_coalesced_transport"): the coalesced raw path — body
  carries {"locations": [ticket, ...]} for one (executor, reduce
  partition) pair and the server streams every location back-to-back in
  ONE RPC. Each location is framed by a small JSON header Result
  ({"i": index, "nbytes": n}) followed by its data blocks, so the client
  keeps per-location accounting: a mid-stream failure is attributed to the
  exact map output being served, and FetchFailed carries the right map
  identity for stage recomputation.

Tickets are JSON: {path, layout, output_partition} — the location fields a
PartitionLocation already carries. The server does NOT trust the ticket
path: it is resolved and required to live under this executor's work dir
(the reference rebuilds paths server-side from structured fields for the
same reason), and job ids in GC actions are validated against traversal.

mmap serving defaults on; BALLISTA_SHUFFLE_MMAP=0 in the executor's
environment falls back to plain reads (the data plane has no session
config, so the escape hatch is environmental).

TLS: when the executor's control plane is configured with mTLS, the same
certificates secure the Flight listener (tls_certificates + client CA with
required verification) — the data plane is not left plaintext on 0.0.0.0.
"""

from __future__ import annotations

import json
import os
import threading

import pyarrow as pa
import pyarrow.flight as flight
import pyarrow.ipc as ipc

from ballista_tpu_torch.config import _env_bool, _env_float, _env_int
from ballista_tpu_torch.errors import ShortRead
from ballista_tpu_torch.shuffle import paths
from ballista_tpu_torch.shuffle.integrity import INTEGRITY, verify_blocks

BLOCK_SIZE = 8 * 1024 * 1024

COALESCED_ACTION = "io_coalesced_transport"

_EMPTY = pa.py_buffer(b"")


class _StreamGate:
    """Concurrent-stream cap with a bounded accept queue.

    Up to `max_streams` responses stream at once; up to `accept_queue`
    more callers may WAIT for a slot (bounded, so a flood of fetches
    holds a bounded amount of server state); anything past that is
    rejected immediately with FlightUnavailableError — the client's
    retry ladder treats it like any transient IO failure and backs off.
    max_streams <= 0 disables the gate."""

    def __init__(self, max_streams: int, accept_queue: int, acquire_timeout_s: float = 10.0):
        self.max_streams = max_streams
        self.accept_queue = accept_queue
        self.acquire_timeout_s = acquire_timeout_s
        self._sem = threading.Semaphore(max_streams) if max_streams > 0 else None
        self._waiters = 0
        self._lock = threading.Lock()

    def acquire(self) -> None:
        if self._sem is None:
            return
        if self._sem.acquire(blocking=False):
            return
        with self._lock:
            if self._waiters >= self.accept_queue:
                raise flight.FlightUnavailableError(
                    f"stream cap reached ({self.max_streams} active, "
                    f"{self._waiters} queued); retry")
            self._waiters += 1
        try:
            if not self._sem.acquire(timeout=self.acquire_timeout_s):
                raise flight.FlightUnavailableError(
                    f"no stream slot freed within {self.acquire_timeout_s:.0f}s; retry")
        finally:
            with self._lock:
                self._waiters -= 1

    def release(self) -> None:
        if self._sem is not None:
            self._sem.release()

    @property
    def waiters(self) -> int:
        with self._lock:
            return self._waiters


def _open_buffer(ticket: dict, work_dir: str) -> pa.Buffer:
    """One location's stored IPC bytes as a (zero-copy, mmap-backed)
    buffer; empty buffer for a partition absent from a sort index."""
    path = paths.contained_path(work_dir, ticket["path"])
    buf = paths.open_range_buffer(
        path, ticket.get("layout", "hash"), ticket.get("output_partition", 0),
        use_mmap=_env_bool("BALLISTA_SHUFFLE_MMAP", True),
    )
    return _EMPTY if buf is None else buf


def _ticket_list(t: dict) -> list[dict]:
    return t["locations"] if "locations" in t else [t]


def _chaos_roll(seed: int, key: str, p: float) -> bool:
    # lazy import: the chaos module pulls in the plan layer, which the
    # data plane otherwise never needs
    from ballista_tpu_torch.executor.chaos import corrupt_roll

    return corrupt_roll(seed, key, p)


class BallistaFlightServer(flight.FlightServerBase):
    def __init__(self, host: str = "0.0.0.0", port: int = 0, work_dir: str = "",
                 tls_cert: str | None = None, tls_key: str | None = None,
                 tls_client_ca: str | None = None):
        kwargs = {}
        scheme = "grpc"
        if tls_cert and tls_key:
            scheme = "grpc+tls"
            with open(tls_cert, "rb") as f:
                cert = f.read()
            with open(tls_key, "rb") as f:
                key = f.read()
            kwargs["tls_certificates"] = [(cert, key)]
            if tls_client_ca:
                with open(tls_client_ca, "rb") as f:
                    kwargs["root_certificates"] = f.read()
                kwargs["verify_client"] = True
        super().__init__(f"{scheme}://{host}:{port}", **kwargs)
        self.work_dir = work_dir
        self.host = host
        # data-plane counters (benchmarks / smoke tests read these):
        # RPCs by kind, locations served, payload bytes out, and overload
        # protection outcomes (rejected at the gate / stalled consumers)
        self.stats = {"do_get": 0, "block_rpc": 0, "coalesced_rpc": 0,
                      "locations_served": 0, "bytes_served": 0,
                      "streams_rejected": 0, "streams_stalled": 0,
                      "checksum_failures": 0, "short_reads": 0,
                      "chaos_corruptions": 0,
                      "lease_dispatch": 0, "lease_rejections": 0,
                      "migrations": 0, "migrated_bytes": 0}
        # executors attached for direct dispatch: lease grants/revocations
        # and scheduler-less task execution arrive as Flight actions
        self._executors: dict[str, object] = {}
        self._stats_lock = threading.Lock()
        # overload knobs are environmental: the data plane has no session
        # config (same precedent as BALLISTA_SHUFFLE_MMAP)
        self.gate = _StreamGate(
            _env_int("BALLISTA_FLIGHT_MAX_STREAMS", 64),
            _env_int("BALLISTA_FLIGHT_ACCEPT_QUEUE", 128),
        )
        self.stall_timeout_s = _env_float("BALLISTA_FLIGHT_STALL_TIMEOUT_S", 30.0)
        # integrity: ship stored checksums in serve headers (same env
        # escape hatch the session knob documents)
        self.checksum_env = _env_bool("BALLISTA_SHUFFLE_CHECKSUM", True)
        # chaos mode=corrupt — serve-time seeded bit-flips (stored files
        # stay pristine, so a refetch can heal); see config.CHAOS_MODE
        self.corrupt_p = _env_float("BALLISTA_CHAOS_CORRUPT_P", 0.0)
        self.corrupt_once = _env_bool("BALLISTA_CHAOS_CORRUPT_ONCE", True)
        self.chaos_seed = _env_int("BALLISTA_CHAOS_SEED", 0)
        self._serve_counts: dict[str, int] = {}

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _gate_acquire(self) -> None:
        try:
            self.gate.acquire()
        except flight.FlightUnavailableError:
            self._bump("streams_rejected")
            raise

    def _crc_for(self, tk: dict) -> str | None:
        """Stored checksum for one location ticket, or None when unchecked
        (knob off, pre-checksum file, unreadable sidecar/index). Never
        raises: serving must not fail because a checksum cannot be read."""
        if not self.checksum_env:
            return None
        try:
            path = paths.contained_path(self.work_dir, tk["path"])
            return paths.checksum_for(
                path, tk.get("layout", "hash"), tk.get("output_partition", 0))
        except Exception:
            return None

    def _maybe_corrupt(self, buf: pa.Buffer, tk: dict) -> pa.Buffer:
        """chaos mode=corrupt: seeded bit-flip of the SERVED copy. With
        BALLISTA_CHAOS_CORRUPT_ONCE (default) only the FIRST serve of each
        (path, partition) range is eligible — deterministic transient
        corruption that heals on the client's retry-once refetch. Without
        it, every serve rolls independently (mixing the serve count into
        the key), modelling a persistently bad disk/NIC."""
        if self.corrupt_p <= 0.0 or buf.size == 0:
            return buf
        key = f"{tk.get('path', '')}|{tk.get('output_partition', 0)}"
        with self._stats_lock:
            serve = self._serve_counts.get(key, 0)
            self._serve_counts[key] = serve + 1
        if self.corrupt_once:
            hit = serve == 0 and _chaos_roll(self.chaos_seed, key, self.corrupt_p)
        else:
            hit = _chaos_roll(self.chaos_seed, f"{key}|{serve}", self.corrupt_p)
        if not hit:
            return buf
        from ballista_tpu_torch.executor.chaos import flip_bit

        self._bump("chaos_corruptions")
        return pa.py_buffer(flip_bit(buf.to_pybytes(), self.chaos_seed, key))

    def do_get(self, context, ticket):
        t = json.loads(ticket.ticket.decode())
        tickets = _ticket_list(t)
        self._gate_acquire()
        try:
            bufs = [_open_buffer(x, self.work_dir) for x in tickets]
        except PermissionError as e:
            self.gate.release()
            raise flight.FlightUnauthorizedError(str(e))
        except ShortRead as e:
            self.gate.release()
            self._bump("short_reads")
            raise flight.FlightUnavailableError(str(e))
        # do_get DECODES server-side, so the client never sees the stored
        # bytes to verify — verify here instead, before the first batch
        # leaves. Raw block/coalesced paths leave verification client-side.
        for x, b in zip(tickets, bufs):
            if b.size == 0:
                continue
            expected = self._crc_for(x)
            if expected and not verify_blocks([b], expected):
                self.gate.release()
                self._bump("checksum_failures")
                INTEGRITY.add("checksum_failures")
                raise flight.FlightInternalError(
                    f"stored shuffle bytes corrupted: {x.get('path')} "
                    f"partition={x.get('output_partition', 0)} fails {expected}")
        self._bump("do_get")
        self._bump("locations_served", len(tickets))
        readers = [ipc.open_stream(pa.BufferReader(b)) for b in bufs if b.size]
        if not readers:
            self.gate.release()
            return flight.RecordBatchStream(pa.table({}))

        def gen():
            import time

            served = 0
            try:
                for r in readers:
                    for batch in r:
                        served += batch.nbytes
                        t0 = time.monotonic()
                        yield batch
                        # a yield that took this long was backpressured by
                        # the consumer; kill the stream and free the mmap
                        # buffers instead of wedging a slot indefinitely
                        if self.stall_timeout_s and time.monotonic() - t0 > self.stall_timeout_s:
                            self._bump("streams_stalled")
                            raise flight.FlightTimedOutError(
                                f"consumer stalled > {self.stall_timeout_s:.0f}s; "
                                "stream dropped")
                self._bump("bytes_served", served)
            finally:
                self.gate.release()

        # generator-based: first batch leaves before the last is decoded;
        # nothing is materialized server-side (no read_all)
        return flight.GeneratorStream(readers[0].schema, gen())

    def _yield_blocks(self, buf: pa.Buffer):
        for off in range(0, buf.size, BLOCK_SIZE):
            # zero-copy: each Result body is a slice of the mmap buffer
            yield flight.Result(buf.slice(off, min(BLOCK_SIZE, buf.size - off)))

    def do_action(self, context, action):
        if action.type == "io_block_transport":
            t = json.loads(action.body.to_pybytes().decode())
            self._gate_acquire()
            try:
                try:
                    buf = _open_buffer(t, self.work_dir)
                except PermissionError as e:
                    raise flight.FlightUnauthorizedError(str(e))
                except ShortRead as e:
                    self._bump("short_reads")
                    raise flight.FlightUnavailableError(str(e))
                self._bump("block_rpc")
                self._bump("locations_served")
                self._bump("bytes_served", buf.size)
                buf = self._maybe_corrupt(buf, t)
                if t.get("want_crc"):
                    # opt-in header (new clients ask; old servers that don't
                    # understand the field just ignore it and the client
                    # detects the absence): {"nbytes": n, "crc": "..."}
                    header = {"nbytes": buf.size}
                    crc = self._crc_for(t)
                    if crc:
                        header["crc"] = crc
                    yield flight.Result(pa.py_buffer(json.dumps(header).encode()))
                yield from self._yield_blocks(buf)
            finally:
                self.gate.release()
            return
        if action.type == COALESCED_ACTION:
            t = json.loads(action.body.to_pybytes().decode())
            tickets = _ticket_list(t)
            self._gate_acquire()
            try:
                self._bump("coalesced_rpc")
                for i, tk in enumerate(tickets):
                    # open INSIDE the stream: a failure on location i surfaces
                    # after location i-1 completed, so the client's per-location
                    # accounting attributes it to the right map output
                    try:
                        buf = _open_buffer(tk, self.work_dir)
                    except PermissionError as e:
                        raise flight.FlightUnauthorizedError(str(e))
                    except ShortRead as e:
                        self._bump("short_reads")
                        raise flight.FlightUnavailableError(str(e))
                    buf = self._maybe_corrupt(buf, tk)
                    h = {"i": i, "nbytes": buf.size}
                    crc = self._crc_for(tk)
                    if crc:
                        # expected checksum travels WITH the location frame;
                        # clients that predate it ignore the extra key
                        h["crc"] = crc
                    yield flight.Result(pa.py_buffer(json.dumps(h).encode()))
                    yield from self._yield_blocks(buf)
                    self._bump("locations_served")
                    self._bump("bytes_served", buf.size)
            finally:
                self.gate.release()
            return
        if action.type == "migrate_pull":
            yield from self._migrate_pull(action.body.to_pybytes())
            return
        if action.type == "remove_job_data":
            t = json.loads(action.body.to_pybytes().decode())
            import shutil

            try:
                job_id = paths.validate_job_id(t["job_id"])
                d = paths.contained_path(self.work_dir, paths.job_dir(self.work_dir, job_id))
            except (ValueError, PermissionError) as e:
                raise flight.FlightUnauthorizedError(str(e))
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
            yield flight.Result(pa.py_buffer(b"ok"))
            return
        if action.type == "lease_grant":
            t = json.loads(action.body.to_pybytes().decode())
            from ballista_tpu_torch.serving.lease import ExecutorLease

            ex = self._executors.get(t.get("executor_id", ""))
            if ex is None:
                raise flight.FlightServerError(
                    f"no executor {t.get('executor_id')!r} attached")
            ex.lease_table.grant(ExecutorLease.from_wire(t))
            yield flight.Result(pa.py_buffer(b"ok"))
            return
        if action.type == "lease_revoke":
            t = json.loads(action.body.to_pybytes().decode())
            ex = self._executors.get(t.get("executor_id", ""))
            if ex is not None:
                ex.lease_table.revoke(str(t.get("lease_id", "")))
            yield flight.Result(pa.py_buffer(b"ok"))
            return
        if action.type == "lease_dispatch":
            # frame: one JSON header line, then a TaskDefinitionProto. The
            # response is a JSON header (admitted or rejection reason)
            # followed, when admitted, by the TaskStatusProto.
            yield from self._lease_dispatch(action.body.to_pybytes())
            return
        raise flight.FlightServerError(f"unknown action {action.type}")

    def _migrate_pull(self, body: bytes):
        """Drain handoff (docs/lifecycle.md#migration-commit-rules): this
        DESTINATION pulls shuffle byte ranges from a draining source over
        the existing coalesced Flight path and commits each one under its
        own work dir — hash layout, tmp + atomic rename, `.crc` sidecar
        carried over — then reports the new path so the scheduler can
        rewrite the PartitionLocation in place. Idempotent: the committed
        name is a pure function of the location's identity, so a replayed
        migration renames over an identical file."""
        from ballista_tpu_torch.flight.client import fetch_partitions_bytes

        t = json.loads(body.decode())
        source = str(t["source"])
        locs = list(t.get("locations", []))
        for i, data, crc in fetch_partitions_bytes(source, locs):
            tk = locs[i]
            try:
                job_id = paths.validate_job_id(str(tk["job_id"]))
            except ValueError as e:
                raise flight.FlightUnauthorizedError(str(e))
            dest = paths.hash_data_path(
                self.work_dir, job_id, int(tk["stage_id"]),
                int(tk.get("output_partition", 0)),
                f"mig{int(tk.get('map_partition', 0))}")
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            tmp = dest + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                if crc:
                    with open(paths.crc_path(dest) + ".tmp", "w") as f:
                        f.write(crc)
                    os.replace(paths.crc_path(dest) + ".tmp", paths.crc_path(dest))
                os.replace(tmp, dest)
            except BaseException:
                for p in (tmp, paths.crc_path(dest) + ".tmp"):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                raise
            self._bump("migrations")
            self._bump("migrated_bytes", len(data))
            yield flight.Result(pa.py_buffer(json.dumps(
                {"i": i, "path": dest, "nbytes": len(data)}).encode()))

    def attach_executor(self, executor) -> None:
        """Register an in-process Executor as a direct-dispatch target of
        this data-plane endpoint (daemon/standalone wiring)."""
        self._executors[executor.metadata.id] = executor

    def _lease_dispatch(self, body: bytes):
        from ballista_tpu_torch.proto import pb
        from ballista_tpu_torch.serde_control import decode_task_definition, encode_task_status

        head, _, payload = body.partition(b"\n")
        t = json.loads(head.decode())
        lease_id = str(t.get("lease_id", ""))
        ex = self._executors.get(t.get("executor_id", ""))
        if ex is None:
            self._bump("lease_rejections")
            yield flight.Result(pa.py_buffer(json.dumps(
                {"rejected": "no-executor-attached"}).encode()))
            return
        proto = pb.TaskDefinitionProto.FromString(payload)
        task = decode_task_definition(proto)
        cfg = None
        if proto.props:
            from ballista_tpu_torch.config import BallistaConfig

            cfg = BallistaConfig.from_key_value_pairs(
                [(kv.key, kv.value) for kv in proto.props], scrub_restricted=True)
        reason = ex.lease_table.admit(lease_id, task.task_id)
        if reason is not None:
            self._bump("lease_rejections")
            yield flight.Result(pa.py_buffer(json.dumps({"rejected": reason}).encode()))
            return
        try:
            result = ex.run_task(task, cfg)
        finally:
            ex.lease_table.release(lease_id)
        self._bump("lease_dispatch")
        status = encode_task_status(result, ex.metadata.id).SerializeToString()
        yield flight.Result(pa.py_buffer(json.dumps({"ok": True}).encode()))
        yield flight.Result(pa.py_buffer(status))

    def list_actions(self, context):
        return [("io_block_transport", "raw IPC block stream"),
                (COALESCED_ACTION, "framed multi-location raw IPC block stream"),
                ("remove_job_data", "GC a job's shuffle files"),
                ("migrate_pull", "pull + commit shuffle ranges from a draining executor"),
                ("lease_grant", "install a direct-dispatch lease on an attached executor"),
                ("lease_revoke", "revoke a direct-dispatch lease"),
                ("lease_dispatch", "run one leased single-stage task scheduler-less")]


def start_flight_server(work_dir: str, host: str = "0.0.0.0", port: int = 0,
                        tls_cert: str | None = None, tls_key: str | None = None,
                        tls_client_ca: str | None = None) -> tuple[BallistaFlightServer, int]:
    server = BallistaFlightServer(host, port, work_dir,
                                  tls_cert=tls_cert, tls_key=tls_key,
                                  tls_client_ca=tls_client_ca)
    bound = server.port
    t = threading.Thread(target=server.serve, daemon=True, name="flight-server")
    t.start()
    return server, bound
