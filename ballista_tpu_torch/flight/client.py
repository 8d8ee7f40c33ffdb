"""Flight data-plane client with connection pooling.

Rebuild of BallistaClient + BallistaClientPool (core/src/client.rs:54,
client_pool.rs:34): fetch_partition in decoded-stream mode (do_get) or
raw-block mode (do_action("io_block_transport"), client.rs:321 — ships the
stored IPC bytes and decodes once on the reduce side). Pooled clients are
discarded on error (PooledClient discard-on-error).

Two data-movement optimizations live here:

- Block streams decode through ChainedBufferReader — a file-like view over
  the received block list — instead of re-assembling them with
  b"".join(blocks), which doubled the partition's footprint on the reduce
  side for one decode pass.
- fetch_partitions_flight ships a reduce task's WHOLE want-list for one
  executor in a single io_coalesced_transport RPC. The server frames each
  map output with a JSON header Result, so this client yields per-location
  results as they complete and, when the stream dies, reports exactly which
  location was mid-flight (FetchStreamError.loc_index) — the reader turns
  that into a FetchFailed with the right map identity. Servers that predate
  the action (the native C++ data plane) reject it; that address is cached
  in _NO_COALESCE and the caller falls back to per-location fetches.
"""

from __future__ import annotations

import json
import threading
from typing import Iterator, Sequence

import pyarrow as pa
import pyarrow.flight as flight
import pyarrow.ipc as ipc

from ballista_tpu_torch.config import SHUFFLE_BLOCK_TRANSPORT, SHUFFLE_CHECKSUM_ENABLED
from ballista_tpu_torch.errors import CircuitOpen, DataCorrupted
from ballista_tpu_torch.shuffle.integrity import verify_or_raise as _verify_or_raise
from ballista_tpu_torch.plan.physical import TaskContext
from ballista_tpu_torch.shuffle.types import PartitionLocation

COALESCED_ACTION = "io_coalesced_transport"


class ClientPool:
    def __init__(self):
        self._clients: dict[str, flight.FlightClient] = {}
        self._lock = threading.Lock()

    def get(self, addr: str, tls: tuple[str, str | None, str | None] | None = None) -> flight.FlightClient:
        """tls = (ca_path, cert_path, key_path): dial grpc+tls, presenting a
        client certificate when given (mTLS data plane). Pool entries are
        keyed on (addr, tls) so callers with different transports to one
        address never share a client."""
        key = (addr, tls)
        with self._lock:
            c = self._clients.get(key)
            if c is None:
                if tls:
                    ca, cert, key_path = tls
                    kwargs = {}
                    with open(ca, "rb") as f:
                        kwargs["tls_root_certs"] = f.read()
                    if cert and key_path:
                        with open(cert, "rb") as f:
                            kwargs["cert_chain"] = f.read()
                        with open(key_path, "rb") as f:
                            kwargs["private_key"] = f.read()
                    c = flight.FlightClient(f"grpc+tls://{addr}", **kwargs)
                else:
                    c = flight.FlightClient(f"grpc://{addr}")
                self._clients[key] = c
            return c

    def discard(self, addr: str) -> None:
        with self._lock:
            doomed = [k for k in self._clients if k[0] == addr]
            clients = [self._clients.pop(k) for k in doomed]
        for c in clients:
            try:
                c.close()
            except Exception:
                pass


POOL = ClientPool()

# addresses whose server rejected io_coalesced_transport (native data
# plane): don't re-probe them on every reduce task
# analysis: ignore[bounded-cache] one entry per executor address; bounded by fleet size
_NO_COALESCE: set[str] = set()
_NO_COALESCE_LOCK = threading.Lock()


class CircuitBreaker:
    """Per-address circuit breaker for the Flight data plane.

    Closed → `threshold` CONSECUTIVE failures → open: every fetch to that
    address fails fast with CircuitOpen (an IoError: the shuffle reader's
    retry ladder treats it like any transient fetch failure, so it
    eventually surfaces as FetchFailed and the stage recomputes
    elsewhere) instead of each reduce task independently burning a
    connect timeout against a dead or drowning peer. After `cooldown_s`
    the breaker goes half-open: exactly ONE caller probes the address;
    its outcome closes or re-opens the circuit.

    Orthogonal to _NO_COALESCE (a capability cache, not a health signal):
    CoalesceUnsupported never counts as a breaker failure."""

    def __init__(self, threshold: int | None = None, cooldown_s: float | None = None):
        if threshold is None or cooldown_s is None:
            from ballista_tpu_torch.config import (
                FLIGHT_BREAKER_COOLDOWN_S,
                FLIGHT_BREAKER_THRESHOLD,
                BallistaConfig,
            )

            defaults = BallistaConfig()
            threshold = int(defaults.get(FLIGHT_BREAKER_THRESHOLD)) if threshold is None else threshold
            cooldown_s = float(defaults.get(FLIGHT_BREAKER_COOLDOWN_S)) if cooldown_s is None else cooldown_s
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        # addr -> [consecutive_failures, opened_at_monotonic, probing]
        self._state: dict[str, list] = {}
        self.trips = 0  # observability: times any circuit opened

    def check(self, addr: str) -> None:
        """Gate a fetch: raises CircuitOpen when the circuit is open and
        cooling down; lets exactly one probe through once it elapses."""
        if self.threshold <= 0:
            return
        import time

        with self._lock:
            st = self._state.get(addr)
            if st is None or st[1] == 0.0:
                return
            elapsed = time.monotonic() - st[1]
            if elapsed >= self.cooldown_s and not st[2]:
                st[2] = True  # half-open: this caller is the probe
                return
            raise CircuitOpen(addr, max(0.0, self.cooldown_s - elapsed))

    def success(self, addr: str) -> None:
        with self._lock:
            self._state.pop(addr, None)

    def failure(self, addr: str) -> None:
        if self.threshold <= 0:
            return
        import time

        with self._lock:
            st = self._state.setdefault(addr, [0, 0.0, False])
            st[0] += 1
            if st[1] != 0.0 and st[2]:
                # failed probe: re-open for another full cooldown
                st[1] = time.monotonic()
                st[2] = False
                self.trips += 1
            elif st[1] == 0.0 and st[0] >= self.threshold:
                st[1] = time.monotonic()
                st[2] = False
                self.trips += 1

    def is_open(self, addr: str) -> bool:
        with self._lock:
            st = self._state.get(addr)
            return st is not None and st[1] != 0.0

    def reset(self) -> None:
        with self._lock:
            self._state.clear()


BREAKER = CircuitBreaker()


class CoalesceUnsupported(Exception):
    """The server at this address has no io_coalesced_transport action —
    caller should fall back to per-location fetches."""


class FetchStreamError(Exception):
    """A coalesced stream died while (or before) serving location
    `loc_index` (index into the request's location list). Locations before
    it completed and were already yielded — only the tail needs refetching,
    and the failure is attributed to exactly this map output."""

    def __init__(self, loc_index: int, cause: BaseException):
        super().__init__(f"coalesced fetch failed at location {loc_index}: {cause}")
        self.loc_index = loc_index
        self.cause = cause


class ChainedBufferReader:
    """File-like view over a list of received blocks for ipc.open_stream —
    decodes a block stream without re-assembling it into one contiguous
    bytes object. pyarrow's PythonFile wrapper requires `closed` to be an
    attribute (a method object is truthy = treated as closed) and never
    retries short reads, so read(n) must return exactly n bytes until EOF;
    a span inside one block returns a zero-copy memoryview."""

    closed = False

    def __init__(self, blocks: Sequence) -> None:
        self._blocks = [memoryview(b) for b in blocks if len(memoryview(b))]
        self._bi = 0
        self._off = 0
        self._pos = 0

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return False

    def tell(self) -> int:
        return self._pos

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def size(self) -> int:
        return sum(len(b) for b in self._blocks)

    def read(self, n: int = -1):
        blocks, bi, off = self._blocks, self._bi, self._off
        if n is None or n < 0:
            n = sum(len(b) for b in blocks[bi:]) - (off if bi < len(blocks) else 0)
        if bi < len(blocks) and len(blocks[bi]) - off >= n:
            out = blocks[bi][off:off + n]
            off += n
            if off == len(blocks[bi]):
                bi, off = bi + 1, 0
            self._bi, self._off = bi, off
            self._pos += n
            return out
        parts = []
        need = n
        while need and bi < len(blocks):
            take = min(need, len(blocks[bi]) - off)
            parts.append(blocks[bi][off:off + take])
            need -= take
            off += take
            if off == len(blocks[bi]):
                bi, off = bi + 1, 0
        self._bi, self._off = bi, off
        out = b"".join(parts)
        self._pos += len(out)
        return out


def _try_parse_header(body) -> dict | None:
    """Sniff an optional leading JSON header Result on the block path.

    New servers answering a want_crc ticket prepend {"nbytes": n, "crc":
    "..."} before the raw blocks; old servers ignore the ticket field and
    send blocks only. Arrow IPC bytes never begin with '{' (the stream
    opens with a length prefix / 0xFFFFFFFF continuation marker), so a
    small first body starting with '{' that parses as JSON with an
    "nbytes" key is unambiguously the header."""
    if body.size == 0 or body.size > 256:
        return None
    raw = body.to_pybytes()
    if raw[:1] != b"{":
        return None
    try:
        h = json.loads(raw.decode())
    except (UnicodeDecodeError, ValueError):
        return None
    return h if isinstance(h, dict) and "nbytes" in h else None


def _ticket(loc: PartitionLocation) -> dict:
    return {
        "path": loc.path,
        "layout": loc.layout,
        "output_partition": loc.output_partition,
        "job_id": loc.job_id,
        "stage_id": loc.stage_id,
    }


def _session_tls(config) -> tuple[str, str | None, str | None] | None:
    from ballista_tpu_torch.config import GRPC_TLS_CA, GRPC_TLS_CERT, GRPC_TLS_KEY

    ca = str(config.get(GRPC_TLS_CA) or "")
    if not ca:
        return None
    return (ca, str(config.get(GRPC_TLS_CERT) or "") or None,
            str(config.get(GRPC_TLS_KEY) or "") or None)


def _route(ctx: TaskContext, loc: PartitionLocation, body: dict) -> tuple[str, dict]:
    """(dial address, wire body) — external mode relays through the
    scheduler's Flight proxy with the owning executor named in the body."""
    from ballista_tpu_torch.config import FLIGHT_PROXY

    proxy = str(ctx.config.get(FLIGHT_PROXY) or "")
    if proxy:
        return proxy, {**body, "host": loc.host, "flight_port": loc.flight_port}
    return f"{loc.host}:{loc.flight_port}", body


def fetch_partition_flight(loc: PartitionLocation, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
    body = _ticket(loc)
    if bool(ctx.config.get(SHUFFLE_CHECKSUM_ENABLED)):
        # opt-in: ask the server to prepend its stored checksum header on
        # the block path (old servers ignore the field — no header comes
        # back and the bytes stay unchecked, exactly the legacy behavior)
        body["want_crc"] = True
    addr, ticket = _route(ctx, loc, body)
    BREAKER.check(addr)  # fail fast while the address's circuit is open
    client = POOL.get(addr, tls=_session_tls(ctx.config))
    try:
        if bool(ctx.config.get(SHUFFLE_BLOCK_TRANSPORT)):
            action = flight.Action("io_block_transport", json.dumps(ticket).encode())
            results = list(client.do_action(action))
            expected = declared = None
            if results:
                h = _try_parse_header(results[0].body)
                if h is not None:
                    expected = h.get("crc")
                    declared = int(h["nbytes"])
                    results = results[1:]
            blocks = [r.body for r in results]
            if not blocks and not declared:
                BREAKER.success(addr)
                return
            where = f"{loc.path}#p{loc.output_partition}"
            total = sum(b.size for b in blocks)
            if declared is not None and total != declared:
                raise DataCorrupted(where, f"{declared} bytes", f"{total} bytes",
                                    detail="stream length != declared")
            # verify the RAW received bytes before handing them to the
            # Arrow decoder: a flip surfaces as typed corruption, not an
            # opaque decode crash (or silent wrong rows)
            _verify_or_raise(blocks, expected, where)
            reader = ipc.open_stream(ChainedBufferReader(blocks))
            yield from reader
        else:
            t = flight.Ticket(json.dumps(ticket).encode())
            for chunk in client.do_get(t):
                yield chunk.data
        BREAKER.success(addr)
    except DataCorrupted:
        # corruption is a DISK/serve-path signal, not connection health:
        # it must not open the circuit (the retry-once refetch needs the
        # address reachable) and the pooled connection is fine
        raise
    except Exception:
        BREAKER.failure(addr)
        POOL.discard(addr)
        raise


def _is_unknown_action(e: BaseException) -> bool:
    return "unknown action" in str(e).lower()


def fetch_partitions_flight(locs: Sequence[PartitionLocation], ctx: TaskContext
                            ) -> Iterator[tuple[int, list[pa.RecordBatch], int]]:
    """Coalesced fetch: every location (all owned by ONE executor) streams
    back in a single RPC. Yields (index, batches, nbytes) per location, in
    request order, as each completes. Raises CoalesceUnsupported when the
    server lacks the action (native data plane) and FetchStreamError with
    the first incomplete location's index when the stream dies mid-flight.
    """
    addr, body = _route(ctx, locs[0], {"locations": [_ticket(l) for l in locs]})
    with _NO_COALESCE_LOCK:
        if addr in _NO_COALESCE:
            raise CoalesceUnsupported(addr)
    BREAKER.check(addr)  # fail fast while the address's circuit is open
    client = POOL.get(addr, tls=_session_tls(ctx.config))
    action = flight.Action(COALESCED_ACTION, json.dumps(body).encode())

    completed = 0          # locations fully received = first incomplete idx
    cur_need = 0           # bytes still owed for the current location
    cur_blocks: list = []
    cur_crc: str | None = None

    def fail(e: BaseException):
        if _is_unknown_action(e):
            # capability miss, not a health signal: never trips the breaker
            with _NO_COALESCE_LOCK:
                _NO_COALESCE.add(addr)
            return CoalesceUnsupported(addr)
        BREAKER.failure(addr)
        POOL.discard(addr)
        return FetchStreamError(completed, e)

    try:
        results = iter(client.do_action(action))
    except Exception as e:
        raise fail(e) from e
    while True:
        try:
            r = next(results)
        except StopIteration:
            break
        except Exception as e:
            raise fail(e) from e
        if cur_need == 0:
            # header Result: {"i": index, "nbytes": n, "crc": optional}
            h = json.loads(r.body.to_pybytes().decode())
            cur_need = int(h["nbytes"])
            cur_crc = h.get("crc")
            cur_blocks = []
            if cur_need == 0:
                yield completed, [], 0
                completed += 1
            continue
        cur_blocks.append(r.body)
        cur_need -= r.body.size
        if cur_need == 0:
            nbytes = sum(b.size for b in cur_blocks)
            if cur_crc:
                try:
                    _verify_or_raise(
                        cur_blocks, cur_crc,
                        f"{locs[completed].path}#p{locs[completed].output_partition}")
                except DataCorrupted as e:
                    # NOT fail(e): corruption must not trip the breaker or
                    # drop the pooled connection — the reader's retry-once
                    # refetch targets this same address
                    raise FetchStreamError(completed, e) from e
            try:
                batches = list(ipc.open_stream(ChainedBufferReader(cur_blocks)))
            except Exception as e:
                raise FetchStreamError(completed, e) from e
            cur_blocks = []
            yield completed, batches, nbytes
            completed += 1
    if cur_need:
        # server hung up inside the current location's data
        BREAKER.failure(addr)
        raise FetchStreamError(completed, EOFError(
            f"stream ended {cur_need} bytes short of location {completed}"))
    if completed < len(locs):
        BREAKER.failure(addr)
        raise FetchStreamError(completed, EOFError(
            f"stream served {completed}/{len(locs)} locations"))
    BREAKER.success(addr)


def fetch_partitions_bytes(addr: str, tickets: Sequence[dict],
                           tls: tuple[str, str | None, str | None] | None = None,
                           ) -> Iterator[tuple[int, bytes, str | None]]:
    """Raw-bytes coalesced fetch for shuffle MIGRATION (drain handoff,
    docs/lifecycle.md): streams every ticket's stored IPC byte range from
    `addr` over the existing io_coalesced_transport framing, verifies each
    range against the source's declared checksum BEFORE yielding, and
    returns the raw bytes untouched — the destination commits them as-is
    (no decode/re-encode), so the migrated file is byte-identical to the
    source range. Yields (index, bytes, crc_or_None) in request order."""
    client = POOL.get(addr, tls=tls)
    action = flight.Action(COALESCED_ACTION, json.dumps({"locations": list(tickets)}).encode())
    completed = 0
    cur_need = 0
    cur_blocks: list = []
    cur_crc: str | None = None
    for r in client.do_action(action):
        if cur_need == 0:
            h = json.loads(r.body.to_pybytes().decode())
            cur_need = int(h["nbytes"])
            cur_crc = h.get("crc")
            cur_blocks = []
            if cur_need == 0:
                yield completed, b"", None
                completed += 1
            continue
        cur_blocks.append(r.body)
        cur_need -= r.body.size
        if cur_need == 0:
            if cur_crc:
                tk = tickets[completed]
                _verify_or_raise(
                    cur_blocks, cur_crc,
                    f"migrate {tk.get('path')}#p{tk.get('output_partition', 0)}")
            yield completed, b"".join(b.to_pybytes() for b in cur_blocks), cur_crc
            completed += 1
    if cur_need or completed < len(tickets):
        raise EOFError(
            f"migration stream from {addr} served {completed}/{len(tickets)} locations")


def remove_job_data(host: str, flight_port: int, job_id: str) -> None:
    client = POOL.get(f"{host}:{flight_port}")
    action = flight.Action("remove_job_data", json.dumps({"job_id": job_id}).encode())
    list(client.do_action(action))
