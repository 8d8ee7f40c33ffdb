"""Shuffle integrity primitives: block checksums + corruption accounting.

The shuffle contract carries a per-partition checksum from the writer all
the way to the reader (SURVEY.md §5: the materialized shuffle output is
the durable unit, so IT is what must be verifiable): the writer records a
checksum over each output partition's stored byte range as it writes, the
Flight servers ship the recorded value in their per-location headers, and
clients/local readers recompute it over the received bytes BEFORE handing
them to the Arrow decoder. A flipped bit therefore surfaces as a typed
DataCorrupted instead of an opaque decoder crash — or, silently worse,
wrong query results.

Checksum values are small self-describing strings, `"<algo>:<8 hex>"`:

- ``c32`` — CRC32C (Castagnoli), used when an accelerated implementation
  is importable (the `crc32c`/`google_crc32c` wheels);
- ``z32`` — CRC-32 (ISO-HDLC) via zlib, the always-available C-speed
  fallback.

The algo travels WITH the value, so a verifier always recomputes with the
writer's algorithm — mixed fleets never turn an algo skew into a false
corruption signal. A pure-Python CRC32C exists only to verify `c32:`
values written by a host that had the accelerated wheel; writers never
pick an algorithm they'd compute slowly.
"""

from __future__ import annotations

import threading
import zlib

# -- algorithm selection -----------------------------------------------------

try:  # accelerated CRC32C if the wheel is present (never a hard dep)
    import crc32c as _crc32c_mod  # type: ignore

    def _crc32c(data, crc: int = 0) -> int:
        return _crc32c_mod.crc32c(data, crc)

    _HAVE_FAST_C32 = True
except ImportError:
    try:
        import google_crc32c as _gcrc32c_mod  # type: ignore

        def _crc32c(data, crc: int = 0) -> int:
            return _gcrc32c_mod.extend(crc, bytes(data))

        _HAVE_FAST_C32 = True
    except ImportError:
        _HAVE_FAST_C32 = False
        _C32_TABLE: list[int] | None = None

        def _c32_table() -> list[int]:
            global _C32_TABLE
            if _C32_TABLE is None:
                poly = 0x82F63B78  # Castagnoli, reflected
                tbl = []
                for i in range(256):
                    c = i
                    for _ in range(8):
                        c = (c >> 1) ^ poly if c & 1 else c >> 1
                    tbl.append(c)
                _C32_TABLE = tbl
            return _C32_TABLE

        def _crc32c(data, crc: int = 0) -> int:
            # pure-Python verification fallback only — writers on hosts
            # without the accelerated wheel emit z32 (zlib, C speed) instead
            tbl = _c32_table()
            c = crc ^ 0xFFFFFFFF
            for b in memoryview(data).cast("B"):
                c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
            return c ^ 0xFFFFFFFF


DEFAULT_ALGO = "c32" if _HAVE_FAST_C32 else "z32"

_UPDATERS = {
    "c32": _crc32c,
    "z32": lambda data, crc=0: zlib.crc32(data, crc) & 0xFFFFFFFF,
}


class Checksum:
    """Incremental checksum with a self-describing string digest."""

    def __init__(self, algo: str | None = None):
        self.algo = algo or DEFAULT_ALGO
        self._update = _UPDATERS[self.algo]
        self._crc = 0

    def update(self, data) -> None:
        if len(data):
            self._crc = self._update(data, self._crc)

    def reset(self) -> None:
        self._crc = 0

    def digest(self) -> str:
        return f"{self.algo}:{self._crc & 0xFFFFFFFF:08x}"


def checksum_bytes(data, algo: str | None = None) -> str:
    c = Checksum(algo)
    c.update(data)
    return c.digest()


def algo_of(value: str) -> str | None:
    """Algo tag of a stored checksum string; None when unparseable (a
    malformed stored value must read as 'no checksum', not crash serving)."""
    algo, _, rest = value.partition(":")
    return algo if algo in _UPDATERS and rest else None


def verify_or_raise(blocks, expected: str | None, where: str) -> None:
    """Recompute `expected`'s algorithm over the received blocks and raise
    DataCorrupted (with both digests) on mismatch. None or unknown-algo
    expected → unchecked, returns silently."""
    if not expected:
        return
    algo = algo_of(expected)
    if algo is None:
        return
    c = Checksum(algo)
    for b in blocks:
        c.update(memoryview(b))
    actual = c.digest()
    if actual != expected:
        from ballista_tpu_torch.errors import DataCorrupted

        raise DataCorrupted(where, expected, actual)


def verify_blocks(blocks, expected: str) -> bool:
    """Recompute `expected`'s algorithm over a sequence of buffer-protocol
    blocks (pyarrow Buffers, memoryviews, bytes) and compare. An expected
    value with an unknown algo verifies as True — a newer writer's format
    must degrade to 'unchecked', never to a false corruption signal."""
    algo = algo_of(expected)
    if algo is None:
        return True
    c = Checksum(algo)
    for b in blocks:
        c.update(memoryview(b))
    return c.digest() == expected


class ChecksumSink:
    """File-object wrapper that checksums bytes AS THEY ARE WRITTEN
    (per-range: `start_range()` resets the running value so one physical
    file yields one digest per output-partition byte range). Implements
    just enough of the binary-file protocol for pyarrow's IPC writer."""

    closed = False

    def __init__(self, f, enabled: bool = True):
        self._f = f
        self._cs = Checksum() if enabled else None

    def write(self, data) -> int:
        if self._cs is not None:
            self._cs.update(data)
        return self._f.write(data)

    def tell(self) -> int:
        return self._f.tell()

    def flush(self) -> None:
        self._f.flush()

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def readable(self) -> bool:
        return False

    def start_range(self) -> None:
        if self._cs is not None:
            self._cs.reset()

    def digest(self) -> str | None:
        return None if self._cs is None else self._cs.digest()


# -- executor-wide corruption accounting -------------------------------------


class IntegrityCounters:
    """Process-wide integrity counters, heartbeat-piggybacked to the
    scheduler (same no-proto-change pattern as the overload gauges) and
    exposed on the executor's /health endpoint."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data = {"checksum_failures": 0, "corruption_retries": 0}

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._data[key] += n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._data)

    def reset(self) -> None:
        with self._lock:
            for k in self._data:
                self._data[k] = 0


INTEGRITY = IntegrityCounters()
