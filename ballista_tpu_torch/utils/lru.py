"""Bounded LRU mapping for module-level caches.

Lived in ops/tpu/stage_compiler.py through PR 8, but CPU-side modules
(shuffle reader, physical planner) need the same discipline and must NOT
import the stage compiler to get it: the executor heartbeat keys its TPU
gauges on `sys.modules.get("ballista_tpu_torch.ops.cuda.stage_compiler")`, so an
import from the CPU path would make every executor look TPU-resident.
stage_compiler re-exports this class for back-compat.

The bounded-cache analysis pass requires every module-level mutable cache
to be one of these (or carry an explicit suppression with a reason).
"""

from __future__ import annotations

import threading


class LruDict:
    """Thread-safe LRU mapping with an entry cap and an optional byte budget
    (`sizer(value)` → bytes). Long-lived executor sessions touch unbounded
    stage populations; module caches must evict, not leak."""

    def __init__(self, max_entries: int, max_bytes: int = 0, sizer=None):
        import collections

        self._od: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = int(max_bytes)
        self._sizer = sizer
        self._bytes = 0
        self.evictions = 0

    def get(self, key, default=None):
        with self._lock:
            try:
                self._od.move_to_end(key)
            except KeyError:
                return default
            return self._od[key][0]

    def __getitem__(self, key):
        _MISS = object()
        got = self.get(key, _MISS)
        if got is _MISS:
            raise KeyError(key)
        return got

    def __setitem__(self, key, value) -> None:
        size = int(self._sizer(value)) if self._sizer else 0
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._od[key] = (value, size)
            self._bytes += size
            while len(self._od) > self.max_entries or (
                self.max_bytes and self._bytes > self.max_bytes and len(self._od) > 1
            ):
                _, (_, sz) = self._od.popitem(last=False)
                self._bytes -= sz
                self.evictions += 1

    def setdefault(self, key, default):
        """Atomic get-or-insert (the shuffle fetch governor keys per
        (address, limits) and must hand every caller the same instance)."""
        size = int(self._sizer(default)) if self._sizer else 0
        with self._lock:
            try:
                self._od.move_to_end(key)
                return self._od[key][0]
            except KeyError:
                pass
            self._od[key] = (default, size)
            self._bytes += size
            while len(self._od) > self.max_entries or (
                self.max_bytes and self._bytes > self.max_bytes and len(self._od) > 1
            ):
                _, (_, sz) = self._od.popitem(last=False)
                self._bytes -= sz
                self.evictions += 1
            return default

    def pop(self, key, default=None):
        """Remove and return an entry without counting it as an eviction
        (callers that fold data elsewhere first — e.g. delta compaction —
        own the removal; `evictions` stays a pure pressure signal)."""
        with self._lock:
            got = self._od.pop(key, None)
            if got is None:
                return default
            self._bytes -= got[1]
            return got[0]

    def items(self) -> list:
        """Point-in-time [(key, value)] snapshot (LRU → MRU order) without
        touching recency — observability reads must not distort eviction."""
        with self._lock:
            return [(k, v[0]) for k, v in self._od.items()]

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._od.clear()
            self._bytes = 0
