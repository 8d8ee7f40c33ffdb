"""Wire protocol between the device daemon and its clients.

Framing on the unix-domain socket — every message, both directions, is

    [4-byte big-endian header length][JSON header][body bytes]

where the header declares its body's length under ``body_len`` (0 when
absent). Headers are small JSON dicts (op, session, partitions, stats);
bodies carry the bulk bytes: a serde-encoded physical plan on an
``execute`` request, concatenated Arrow IPC streams (one per partition,
offsets in the header's ``segments``) on its response. Keeping the
header out-of-band of the Arrow payload means a client can parse an
error response without touching pyarrow, and the daemon can route a
request before the plan bytes are decoded.

Requests are one message; responses are one message; connections are
per-request (unix sockets make connect ~free, and it keeps a crashed
client from wedging a daemon-side stream parser mid-frame).

Ops: ``ping`` (liveness, answered during init), ``status`` (init phase
report + session/queue/cache counters), ``execute`` (run one stage),
``clear_caches`` (evict daemon-resident device state), ``shutdown``.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import tempfile

# bump when the header schema changes incompatibly; a daemon refuses
# mismatched clients loudly instead of mis-parsing their frames
PROTOCOL_VERSION = 1

_LEN = struct.Struct(">I")
# a header is a few KB of JSON; anything bigger is a framing bug, not a
# request — refuse before allocating
MAX_HEADER_BYTES = 4 * 1024 * 1024


class ProtocolError(RuntimeError):
    """Malformed frame or peer hangup mid-message."""


def default_socket_path() -> str:
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"ballista-tpu-daemon-{uid}.sock")


def probe_report_path(socket_path: str) -> str:
    """The daemon's structured init report lives NEXT TO the socket so a
    watcher can diagnose a hung init without a live daemon to ask."""
    return socket_path + ".probe.json"


def crash_report_path(socket_path: str) -> str:
    """The execute watchdog's post-mortem artifact: written by a daemon
    whose in-flight request overran its deadline, immediately before the
    process exits. Next to the socket for the same reason as the probe
    report — the corpse must be readable without a live daemon."""
    return socket_path + ".crash.json"


def poison_path(socket_path: str) -> str:
    """The on-disk poison-stage quarantine shared by every client of this
    socket AND by respawned daemons (which refuse quarantined stages):
    {tag: {crashes, updated, fingerprint}} with TTL'd entries."""
    return socket_path + ".poison.json"


def daemon_log_path(socket_path: str) -> str:
    return socket_path + ".log"


def derive_execute_timeout_s(floor_s: float, est_bytes: int) -> float:
    """The execute deadline both sides agree on: the knob
    `ballista.tpu.daemon.execute.timeout.s` is the floor for small stages,
    the bound grows with the stage's estimated bytes at a pessimistic
    16 MiB/s (encode + upload + kernel build + exec all counted), and the
    same knob caps the growth at 8x — a wedged device call must trip the
    watchdog in bounded time no matter how big the stage claimed to be."""
    floor_s = max(1.0, float(floor_s))
    derived = floor_s + max(0, int(est_bytes)) / float(16 * 1024 * 1024)
    return min(derived, floor_s * 8.0)


def send_msg(sock: socket.socket, header: dict, body: bytes = b"") -> None:
    header = dict(header)
    header["body_len"] = len(body)
    hb = json.dumps(header).encode()
    sock.sendall(_LEN.pack(len(hb)) + hb + body)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ProtocolError(f"peer closed mid-message ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    hlen = _LEN.unpack(recv_exact(sock, _LEN.size))[0]
    if hlen > MAX_HEADER_BYTES:
        raise ProtocolError(f"header length {hlen} exceeds {MAX_HEADER_BYTES}")
    header = json.loads(recv_exact(sock, hlen).decode())
    body = recv_exact(sock, int(header.get("body_len", 0)))
    return header, body


def batches_to_ipc(batches, schema) -> bytes:
    """One partition's batches as one Arrow IPC stream (zero batches is a
    valid stream: schema only — an empty partition round-trips as empty)."""
    import io

    import pyarrow as pa

    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, schema) as w:
        for b in batches:
            w.write_batch(b)
    return sink.getvalue()


def ipc_to_batches(buf: bytes):
    import pyarrow as pa

    with pa.ipc.open_stream(pa.py_buffer(buf)) as r:
        return list(r)


def pack_results(results: dict) -> tuple[list, bytes]:
    """{partition: [batches]} → (segments, body). Segments are
    [partition, offset, length] triples into the concatenated body."""
    segments: list = []
    chunks: list[bytes] = []
    off = 0
    for part in sorted(results):
        batches = results[part]
        if batches:
            schema = batches[0].schema
        else:
            # an empty partition still needs a schema to frame a stream;
            # borrow any sibling's (all partitions share the stage schema)
            schema = next((bs[0].schema for bs in results.values() if bs), None)
            if schema is None:
                segments.append([part, off, 0])
                continue
        buf = batches_to_ipc(batches, schema)
        segments.append([part, off, len(buf)])
        chunks.append(buf)
        off += len(buf)
    return segments, b"".join(chunks)


def unpack_results(segments: list, body: bytes) -> dict:
    out: dict = {}
    for part, off, length in segments:
        out[int(part)] = ipc_to_batches(body[off:off + length]) if length else []
    return out
