"""The closed loop: streams of statements through one session.

Each stream is a thread that runs its statements in its own order, one
after another with no think time, cycling until the window closes: the
next statement is submitted when the previous one's last row is
collected. Every statement records two spans on the host clock
(`time.time()`, the clock the profiler's events are given in): `sql`
around `session.sql(text)` and `collect` around `session.collect(df)`.
A stream waits only between its start and its first submission.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass


@dataclass
class Window:
    records: list
    open: float
    close: float
    drained: float
    stuck: int  # streams still in a statement `grace_s` after the close


@dataclass
class Record:
    stream: int
    key: str
    query: str
    submit: float
    planned: float
    done: float
    table: object = None
    error: str | None = None


def run_one(session, stmt: dict, stream: int) -> Record:
    t0 = time.time()
    try:
        df = session.sql(stmt["sql"])
        t1 = time.time()
        table = session.collect(df)
        return Record(stream, stmt["key"], stmt["query"], t0, t1, time.time(), table)
    except Exception:  # noqa: BLE001 — a failed statement is counted, the stream goes on
        t = time.time()
        return Record(stream, stmt["key"], stmt["query"], t0, t, t,
                      error=traceback.format_exc(limit=8))


def warm_up(session, streams: list[list[dict]]) -> list[Record]:
    """Two rounds of all streams together, each stream running its
    statements once a round: the first fills the tables and makes each
    statement's builds and LUTs, the second runs them as the window will.
    Returns the records of both."""
    return [r for _ in range(2) for r in run_streams(session, streams, seconds=None).records]


def run_streams(session, streams: list[list[dict]], seconds: float | None,
                on_open=None, grace_s: float = 60.0) -> Window:
    """All streams together. With `seconds`, each stream cycles through
    its statements until `seconds` after the common start and finishes the
    statement in flight; with None, each runs its statements once.
    `on_open()` runs just before the streams are released. Streams still
    running `grace_s` after the close are left (daemon threads); their
    statement in flight has no record."""
    records: list[list[Record]] = [[] for _ in streams]
    gate = threading.Event()
    bounds: dict = {}

    def loop(s: int) -> None:
        gate.wait()
        stmts = streams[s]
        i = 0
        while True:
            if seconds is None and i == len(stmts):
                return
            if seconds is not None and time.time() >= bounds["close"]:
                return
            records[s].append(run_one(session, stmts[i % len(stmts)], s))
            i += 1

    threads = [threading.Thread(target=loop, args=(s,), daemon=True, name=f"stream-{s}")
               for s in range(len(streams))]
    for t in threads:
        t.start()
    if on_open is not None:
        on_open()
    t0 = time.time()
    bounds["open"] = t0
    bounds["close"] = t0 + (seconds or 0.0)
    gate.set()
    deadline = bounds["close"] + grace_s if seconds is not None else None
    for t in threads:
        t.join(None if deadline is None else max(0.0, deadline - time.time()))
    drained = time.time()
    return Window([r for rs in records for r in list(rs)], t0, bounds["close"], drained,
                  sum(t.is_alive() for t in threads))
