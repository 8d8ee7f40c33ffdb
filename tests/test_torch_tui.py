"""The port's TUI cluster monitor (`ballista_tpu_torch.cli.tui`) against the
JAX package's: the render layer draws byte-identical frames from the same
REST payloads, the domain layer (history, filters, sorts) agrees, and the
curses app and its REST client run against the port's live scheduler."""

import time

import pytest

from ballista_tpu.cli import tui as ref_tui
from ballista_tpu_torch.cli import tui

NOW = 1_700_000_000.0


@pytest.fixture()
def frozen_clock(monkeypatch):
    # the render layer prints ages and durations from time.time(): both
    # packages must draw the same instant
    monkeypatch.setattr(time, "time", lambda: NOW)


def _both(fn_name, *args, **kwargs):
    got = getattr(tui, fn_name)(*args, **kwargs)
    want = getattr(ref_tui, fn_name)(*args, **kwargs)
    assert got == want, fn_name
    return got


def test_render_layers(frozen_clock):
    hdr = _both("render_header", {"version": "0.1.0", "scheduler_id": "s0",
                                  "executors": 2, "jobs": 1})
    assert "s0" in hdr[0] and "executors 2" in hdr[0]
    jobs = [{"job_id": "abc123", "job_name": "q1", "state": "running",
             "completed_stages": 1, "total_stages": 3, "queued_at": NOW - 5}]
    out = _both("render_jobs", jobs, 0)
    assert "abc123" in out[1] and out[1].startswith(">")
    execs = [{"id": "e1", "host": "h", "grpc_port": 1, "flight_port": 2,
              "free_slots": 3, "total_slots": 4, "last_seen": NOW,
              "device_ordinal": 5}]
    out = _both("render_executors", execs, 0)
    assert "3/4" in out[1] and " 5 " in out[1]
    stages = [{"stage_id": 1, "state": "successful", "completed": 4, "running": 0,
               "pending": 0, "metric_percentiles": [
                   {"name": "SortExec: x", "elapsed_ms_p50": 3.2}]}]
    out = _both("render_stages", stages)
    assert "SortExec" in out[1]
    out = _both("render_stages", stages, selected=0)
    assert out[1].startswith(">")


def test_sparkline_and_history(frozen_clock):
    assert tui.SPARK_CHARS == ref_tui.SPARK_CHARS
    assert _both("sparkline", []) == ""
    assert _both("sparkline", [0, 0, 0]) == tui.SPARK_CHARS[1] * 3
    s = _both("sparkline", [0, 5, 10], width=3)
    assert len(s) == 3 and s[2] == tui.SPARK_CHARS[-1]
    assert tui.sparkline(list(range(100)), width=10) == _both(
        "sparkline", list(range(90, 100)), width=10)

    hists = (tui.History(window=4), ref_tui.History(window=4))
    execs = [{"total_slots": 4, "free_slots": 1}]
    for n_done in (0, 0, 1, 3, 3, 3):
        jobs = ([{"state": "RUNNING"}] * 2
                + [{"state": "SUCCESSFUL"}] * n_done)
        for h in hists:
            h.sample(jobs, execs)
    h, ref = hists
    assert len(h.running_jobs) == 4  # window trims
    assert h.busy_slots[-1] == 3.0
    assert h.completed_rate[-3:] == [2.0, 0.0, 0.0]  # deltas, not totals
    assert (h.running_jobs, h.busy_slots, h.completed_rate) == \
        (ref.running_jobs, ref.busy_slots, ref.completed_rate)
    hdr = tui.render_header({"version": "v"}, h, width=80)
    assert hdr == ref_tui.render_header({"version": "v"}, ref, width=80)
    assert len(hdr) == 2 and "slots" in hdr[1]


def test_filter_and_sort_jobs(frozen_clock):
    jobs = [
        {"job_id": "a1", "job_name": "etl", "state": "RUNNING", "queued_at": 100.0,
         "ended_at": 190.0},
        {"job_id": "b2", "job_name": "adhoc", "state": "SUCCESSFUL", "queued_at": 120.0,
         "ended_at": 125.0},
    ]
    assert [j["job_id"] for j in _both("filter_jobs", jobs, "ETL")] == ["a1"]
    assert [j["job_id"] for j in _both("filter_jobs", jobs, "success")] == ["b2"]
    assert _both("filter_jobs", jobs, "") == jobs
    assert [j["job_id"] for j in _both("sort_jobs", jobs, "queued")] == ["b2", "a1"]
    assert [j["job_id"] for j in _both("sort_jobs", jobs, "elapsed")] == ["a1", "b2"]
    assert [j["job_id"] for j in _both("sort_jobs", jobs, "name")] == ["b2", "a1"]
    assert [j["job_id"] for j in _both("sort_jobs", jobs, "state")] == ["a1", "b2"]


def test_render_operators_and_config_and_help(frozen_clock):
    stage = {"stage_id": 3, "completed": 8, "metric_percentiles": [
        {"depth": 0, "name": "ShuffleWriterExec: h", "tasks": 8,
         "elapsed_ms_p50": 1.5, "elapsed_ms_p90": 2.0, "elapsed_ms_p99": 9.0,
         "output_rows_total": 1234},
        {"depth": 1, "name": "FilterExec: x > 1", "tasks": 8,
         "elapsed_ms_p50": 0.5, "elapsed_ms_p90": 0.7, "elapsed_ms_p99": 0.9,
         "output_rows_total": 99},
    ]}
    out = _both("render_operators", stage)
    assert "ShuffleWriterExec" in out[2] and "1234" in out[2]
    assert out[3].startswith("   ")  # depth indents
    assert "(no task metrics yet)" in _both(
        "render_operators", {"stage_id": 1, "metric_percentiles": []})[-1]

    cfg = {"scheduler_id": "s0", "version": "0.1.0", "task_distribution": "bias",
           "executor_timeout_s": 180.0, "job_state_backend": "InMemoryJobState",
           "session_config_entries": [
               {"name": "ballista.job.name", "type": "str", "default": "",
                "description": "Job name"},
               {"name": "ballista.shuffle.partitions", "type": "int", "default": 16,
                "description": "Default shuffle fan-out"}]}
    out = _both("render_config", cfg)
    assert "bias" in out[0]
    assert any("ballista.shuffle.partitions" in line for line in out)
    # scroll offset drops the first entry but keeps the header rows
    assert not any("ballista.job.name" in line for line in _both("render_config", cfg, offset=1))

    assert any("cancel" in line for line in _both("render_help"))
    assert _both("fmt_duration", NOW - 75, None) == _both("fmt_duration", NOW - 75, NOW)


def test_tui_under_pty_against_live_scheduler():
    """Drive the port's curses app under a pty against the port's own
    scheduler: walk every pane (Tab), open help, drill into a finished
    job's stages and operators, and quit. The assertion is a clean exit:
    curses addstr errors or key-model bugs crash the child and surface as
    a nonzero status."""
    import os
    import pty
    import select
    import subprocess
    import sys

    import pyarrow as pa

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0)
    sched.start()
    ex = ExecutorProcess(f"127.0.0.1:{sched.port}", bind_host="127.0.0.1",
                         external_host="127.0.0.1", vcores=2)
    ex.start()
    try:
        ctx = SessionContext.remote(f"127.0.0.1:{sched.port}", BallistaConfig())
        ctx.register_arrow_table("t", pa.table({"x": [1, 2, 3]}))
        ctx.sql("select sum(x) from t").collect()  # one finished job to drill

        master, slave = pty.openpty()
        env = dict(os.environ, TERM="xterm", LINES="30", COLUMNS="100")
        env.pop("PYTHONPATH", None)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.Popen(
            [sys.executable, "-m", "ballista_tpu_torch.cli.tui",
             "--rest-port", str(sched.rest_port), "--refresh", "0.2"],
            stdin=slave, stdout=slave, stderr=subprocess.PIPE, env=env, cwd=root)
        os.close(slave)
        try:
            for key in ["?", "?", "\t", "\t", "j", "j", "k", "\t",
                        "/", "su", "\r", "\x1b",  # filter to 'su'ccessful, clear
                        "s", "\r", "j", "\r", "\x1b", "\x1b",  # drill stage → ops → back
                        "q"]:
                time.sleep(0.35)
                os.write(master, key.encode())
                # drain the screen so the child never blocks on a full pty
                while select.select([master], [], [], 0)[0]:
                    if not os.read(master, 65536):
                        break
            rc = proc.wait(timeout=15)
        finally:
            if proc.poll() is None:
                proc.kill()
            os.close(master)
        assert rc == 0, proc.stderr.read().decode()[-2000:]
    finally:
        ex.shutdown()
        sched.shutdown()


def test_rest_client_against_live_scheduler():
    """The port's RestClient reads the port's REST API; the frames it draws
    from those payloads are the JAX package's frames of the same payloads."""
    import pyarrow as pa

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import RESTRICTED_KEYS, BallistaConfig
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0)
    sched.start()
    ex = ExecutorProcess(f"127.0.0.1:{sched.port}", bind_host="127.0.0.1",
                         external_host="127.0.0.1", vcores=2)
    ex.start()
    try:
        ctx = SessionContext.remote(f"127.0.0.1:{sched.port}", BallistaConfig())
        ctx.register_arrow_table("t", pa.table({"x": [1, 2, 3]}))
        ctx.sql("select sum(x) from t").collect()

        c = tui.RestClient(f"http://127.0.0.1:{sched.rest_port}")
        cfg = c.config()
        assert cfg["task_distribution"] in ("bias", "round-robin", "consistent-hash")
        names = [e["name"] for e in cfg["session_config_entries"]]
        assert "ballista.job.name" in names
        # restricted keys are scrubbed exactly like the session KV transport
        assert not set(names) & set(RESTRICTED_KEYS)
        assert len(_both("render_config", cfg)) >= len(names)

        state, jobs, execs = c.state(), c.jobs(), c.executors()
        assert len(execs) == 1 and len(jobs) == 1
        assert jobs[0]["state"].lower().startswith("succ")
        stages = c.stages(jobs[0]["job_id"])
        assert stages and all(s["state"].lower().startswith("succ") for s in stages)
        _both("render_header", state)
        frame = _both("render_jobs", jobs, 0)
        assert jobs[0]["job_id"] in frame[1]
        _both("render_executors", execs, 0)
        _both("render_stages", stages, 0)
        for s in stages:
            _both("render_operators", s)
    finally:
        ex.shutdown()
        sched.shutdown()
