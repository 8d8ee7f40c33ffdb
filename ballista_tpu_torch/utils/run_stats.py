"""The port's stage-run diagnostics, statement spans and host-sync counter.

Lived in ops/cuda/stage_compiler.py, which imports torch; the client
opens statement scopes and must not load torch to do so, so the one
`RUN_STATS` lives here and stage_compiler re-exports it (the executor
heartbeat still keys its device gauges on stage_compiler being loaded).

Spans: a statement id is minted in `SessionContext.sql()` and a statement
scope opened around `DataFrame.collect()`; inside it `RUN_STATS.span(name)`
records `(statement, span_id, parent_id, name, thread, start_ns, end_ns)`
on the Unix clock (`time.time_ns()`, the clock torch.profiler gives its
events in), so a span can be laid over the device trace. A pool thread
joins the statement that spawned it with `within(scope())`. Records go
into a bounded ring (`SPAN_RING`); a record that pushes the oldest out
counts in `spans_dropped`. While spans are on, Python's collections are
recorded too, as `gc` spans in the thread that triggered them.

Spans are on after `trace(True)`, and while a torch profiler records this
process (checked as each statement opens), so a profiled window carries
the spans that explain it. Off, `span()` costs one flag check and returns
a shared no-op context.

Counters, always counted, at the site, on the CPU forms too:
`host_syncs`, every point where a port thread blocks on the card (a
synchronize, an event wait, a blocking fetch: `.cpu()`, `int()` of a
device scalar); `footer_reads`, every parquet footer the planner parses
(`ParquetTable`, plan/provider.py).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import sys
import threading
import time


class _NoSpan:
    """The shared context `span()` and `statement()` return while spans
    are off: it allocates nothing and records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_rs", "_name", "_scope", "_t0", "_id")

    def __init__(self, rs: "RunStats", name: str, scope: tuple[int, int]):
        self._rs = rs
        self._name = name
        self._scope = scope

    def __enter__(self):
        self._id = next(self._rs._span_ids)
        self._rs._tls.scope = (self._scope[0], self._id)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._rs._tls.scope = self._scope
        self._rs._record((self._scope[0], self._id, self._scope[1], self._name,
                          threading.get_ident(), self._t0, t1))
        return False


class _Statement:
    """A statement's root span: opens the statement on this thread (and
    restores what the thread had open before)."""

    __slots__ = ("_rs", "_sid", "_name", "_prev", "_t0", "_id")

    def __init__(self, rs: "RunStats", sid: int, name: str):
        self._rs = rs
        self._sid = sid
        self._name = name

    def __enter__(self):
        rs = self._rs
        self._prev = getattr(rs._tls, "scope", None)
        self._id = next(rs._span_ids)
        rs._tls.scope = (self._sid, self._id)
        with rs._lock:
            rs._open += 1
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rs = self._rs
        rs._tls.scope = self._prev
        with rs._lock:
            rs._open -= 1
        rs._record((self._sid, self._id, 0, self._name, threading.get_ident(), self._t0, t1))
        return False


def _profiler_on() -> bool:
    """A torch profiler records this process (torch imported, never loaded here)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None and getattr(prof, "_is_profiler_enabled", False))


class RunStats:
    """Per-stage-run diagnostics.

    Every stage dispatch opens a `run(tag)` scope that collects into a
    private per-run dict and publishes atomically on exit: `snapshot()`
    is a consistent most-recent-run-wins view, and `stages()` keeps the
    last few per-stage records.

    Keys the port fills: fill_s (whole device fill), encode_s (host encode
    wall), upload_s (host→card copies), device_bytes, build_s (join build
    sides: host collect + encode + upload, or the build-cache hits; under
    ballista.tpu.compile.overlap the builds' wall from the first submit to
    the last result, beside the fill), exec_s
    (dispatch + fetch + decode), build_modes (direct | sorted per join
    build), fused_kernel_s (device seconds of the
    stage pass), span_s (staged mode: predicate / project / aggregate
    seconds), fusion_mode (fused_xla | fused_pallas | staged — the mode
    that actually ran), fusion_reason (the cost model's stated rationale),
    fused_spans (operator spans run in the stage pass), hbm_budget_bytes,
    hbm_plan (run_whole | spill_colds | grace_split | cpu_demote),
    hbm_plan_reason, grace_splits (sub-buckets run), and the spill pool's
    cumulative hbm_spill_bytes, hbm_spill_events, hbm_reupload_events with
    hbm_oom_retries (the out-of-memory retries so far); the sorted
    aggregation adds sort_s (device seconds of its sort), live_rows (rows
    sorted), n_seg (groups) and seg_capacity (C). Warm-daemon routing
    (ops/cuda/daemon_route.py): daemon_mode ("attached" when the stage ran
    in the device daemon, "in_process" when the session opted in but it
    ran here) and daemon_mode_reason; daemon_attached, daemon_sessions,
    daemon_queue_depth and the daemon's init phase seconds
    (init_platform_probe_s, init_cuda_devices_s, init_first_launch_s);
    daemon_failover / daemon_failover_reason for a crash recovered by a
    respawn or a quarantined stage, and the process-lifetime counters
    daemon_restarts, daemon_crashes_detected, watchdog_kills and
    poisoned_stages.

    Spans and counters (the module docstring): `statement`, `span`,
    `scope` / `within`, `trace`, `spans()`, `counters()`, `count`,
    `count_sync`."""

    _MAX_STAGES = 32
    # a 51 s window of 3 streams at ~15 statements/s and ~25 spans each is
    # ~19k spans: room for four such windows
    SPAN_RING = 1 << 17
    COUNTERS = ("host_syncs", "footer_reads")

    def __init__(self):
        self._lock = threading.Lock()
        self._merged: dict = {}
        self._stages: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._tls = threading.local()
        self._statement_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._ring: collections.deque = collections.deque(maxlen=self.SPAN_RING)
        # its own lock, re-entrant: a collection can start at any call,
        # inside `_record` too, and its callback records into the ring
        self._ring_lock = threading.RLock()
        self._recorded = 0        # records since the ring was emptied
        self._on = False          # spans record (explicitly, or following a profiler)
        self._explicit = False    # trace(True) asked for them
        self._open = 0            # statement scopes open now, any thread
        self._gc_t0 = 0
        self._counts = dict.fromkeys(self.COUNTERS, 0)
        self._counts_at_on = dict(self._counts)  # when spans were turned on

    @contextlib.contextmanager
    def run(self, tag: str):
        rec: dict = {}
        prev = getattr(self._tls, "rec", None)
        self._tls.rec = rec
        try:
            yield rec
        finally:
            self._tls.rec = prev
            self._publish(tag, rec)

    def _publish(self, tag: str, rec: dict) -> None:
        if not rec:
            return
        with self._lock:
            self._merged.update(rec)
            self._stages.pop(tag, None)
            self._stages[tag] = dict(rec)
            while len(self._stages) > self._MAX_STAGES:
                self._stages.popitem(last=False)

    def set(self, key: str, value, rec: dict | None = None) -> None:
        """Record one stat. With `rec` (a run's private dict, threadable to
        helper threads) the write lands in that run; otherwise in the
        calling thread's open run scope, else directly in the merged view."""
        if rec is None:
            rec = getattr(self._tls, "rec", None)
        if rec is not None:
            rec[key] = value
        else:
            with self._lock:
                self._merged[key] = value

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._merged)

    def stages(self) -> dict:
        with self._lock:
            return {t: dict(r) for t, r in self._stages.items()}

    def clear(self) -> None:
        with self._lock:
            self._merged.clear()
            self._stages.clear()

    # -- statements and spans -------------------------------------------

    def new_statement(self) -> int:
        """A statement id no other statement of this process has."""
        return next(self._statement_ids)

    def statement(self, sid: int, name: str = "collect"):
        """Open statement `sid` on this thread, as a root span `name`."""
        if not self._explicit:
            self._follow(_profiler_on())
        if not self._on:
            return _NO_SPAN
        return _Statement(self, sid, name)

    def span(self, name: str):
        """A child of the innermost span open on this thread; records only
        while spans are on and a statement is open here."""
        if not self._on:
            return _NO_SPAN
        scope = getattr(self._tls, "scope", None)
        if scope is None:
            return _NO_SPAN
        return _Span(self, name, scope)

    def scope(self):
        """This thread's open statement and innermost span, for `within`."""
        return getattr(self._tls, "scope", None)

    @contextlib.contextmanager
    def within(self, scope):
        """Run a pool thread's work inside the statement and span `scope`
        (from `scope()` on the thread that handed the work over)."""
        prev = getattr(self._tls, "scope", None)
        self._tls.scope = scope
        try:
            yield
        finally:
            self._tls.scope = prev

    def trace(self, on: bool) -> None:
        """Turn spans on or off for the process. Turning them on empties
        the ring and `spans_dropped`."""
        self._explicit = bool(on)
        self._set_on(bool(on))

    def _follow(self, profiling: bool) -> None:
        if profiling != self._on:
            self._set_on(profiling)

    def _set_on(self, on: bool) -> None:
        with self._lock:
            if on == self._on:
                return
            if on:
                with self._ring_lock:
                    self._ring.clear()
                    self._recorded = 0
                self._counts_at_on = dict(self._counts)
                gc.callbacks.append(self._on_gc)
            else:
                with contextlib.suppress(ValueError):
                    gc.callbacks.remove(self._on_gc)
            self._on = on

    def _record(self, rec: tuple) -> None:
        with self._ring_lock:
            self._recorded += 1
            self._ring.append(rec)

    @property
    def spans_dropped(self) -> int:
        """Records the ring pushed out since it was last emptied."""
        with self._ring_lock:
            return self._recorded - len(self._ring)

    def _on_gc(self, phase: str, info: dict) -> None:
        # a collection holds the GIL throughout: one at a time
        if self._open <= 0:
            return
        if phase == "start":
            self._gc_t0 = time.time_ns()
            return
        scope = getattr(self._tls, "scope", None) or (0, 0)
        self._record((scope[0], next(self._span_ids), scope[1], "gc",
                      threading.get_ident(), self._gc_t0, time.time_ns()))

    def spans(self) -> list[tuple]:
        """The ring's records, oldest first."""
        with self._ring_lock:
            return list(self._ring)

    # -- counters ---------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` (one of `COUNTERS`)."""
        with self._lock:
            self._counts[name] += n

    def count_sync(self, n: int = 1) -> None:
        """`n` points where this thread blocks on the card."""
        self.count("host_syncs", n)

    def counters(self, since_trace: bool = False) -> dict:
        """The `COUNTERS` and spans_dropped; with `since_trace`, each
        counter counted since spans were last turned on."""
        with self._lock:
            out = {k: v - (self._counts_at_on[k] if since_trace else 0)
                   for k, v in self._counts.items()}
        out["spans_dropped"] = self.spans_dropped
        return out


RUN_STATS = RunStats()
