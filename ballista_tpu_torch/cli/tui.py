"""Terminal cluster monitor (TUI).

Rebuild of ballista-cli's ratatui monitor (ballista-cli/src/tui/, ~10 kLoC
hexagonal Rust) as a curses app over the scheduler REST API: live jobs /
executors / scheduler-config panes with cluster-history sparklines, job
filtering and sorting, job→stage→operator drill-down with metric
percentiles, job cancellation, and a help overlay. The domain/render split
keeps everything below `run_tui` testable without a terminal.

  python -m ballista_tpu_torch.cli.tui --host 127.0.0.1 --rest-port 50080
  keys: Tab panes · j/k move · Enter drill · / filter · s sort
        c cancel · ? help · Esc back · q quit
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.request


class RestClient:
    def __init__(self, base: str):
        self.base = base.rstrip("/")

    def _get(self, path: str):
        with urllib.request.urlopen(f"{self.base}{path}", timeout=5) as r:
            return json.load(r)

    def state(self) -> dict:
        return self._get("/api/state")

    def jobs(self) -> list[dict]:
        return self._get("/api/jobs")

    def executors(self) -> list[dict]:
        return self._get("/api/executors")

    def stages(self, job_id: str) -> list[dict]:
        return self._get(f"/api/job/{job_id}/stages")

    def config(self) -> dict:
        return self._get("/api/config")

    def cancel(self, job_id: str) -> None:
        req = urllib.request.Request(f"{self.base}/api/job/{job_id}/cancel", method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            r.read()


# ------------------------------------------------------- history + sparkline

SPARK_CHARS = " ▁▂▃▄▅▆▇█"


def sparkline(vals: list[float], width: int = 30) -> str:
    """Render the last `width` samples as a unicode sparkline (the ratatui
    Sparkline widget analog). Empty/flat series render as a low bar."""
    vals = [max(0.0, float(v)) for v in vals][-width:]
    if not vals:
        return ""
    hi = max(vals)
    if hi <= 0:
        return SPARK_CHARS[1] * len(vals)
    out = []
    for v in vals:
        i = 1 + int(round(v / hi * (len(SPARK_CHARS) - 2)))
        out.append(SPARK_CHARS[min(i, len(SPARK_CHARS) - 1)])
    return "".join(out)


class History:
    """Fixed-window ring of cluster samples feeding the header sparklines:
    running jobs, busy slots, and completions/second (per-tick deltas are
    divided by `tick_s`, the sampling interval)."""

    def __init__(self, window: int = 120, tick_s: float = 1.0):
        self.window = window
        self.tick_s = max(tick_s, 1e-9)
        self.running_jobs: list[float] = []
        self.busy_slots: list[float] = []
        self.completed_rate: list[float] = []
        self._last_completed: int | None = None

    def sample(self, jobs: list[dict], execs: list[dict]) -> None:
        running = sum(1 for j in jobs if j.get("state") in ("RUNNING", "QUEUED"))
        busy = sum(e.get("total_slots", 0) - e.get("free_slots", 0) for e in execs)
        done = sum(1 for j in jobs if j.get("state") in ("SUCCESSFUL", "FAILED", "CANCELLED"))
        rate = (0.0 if self._last_completed is None
                else max(0, done - self._last_completed) / self.tick_s)
        self._last_completed = done
        for series, v in ((self.running_jobs, running), (self.busy_slots, busy),
                          (self.completed_rate, rate)):
            series.append(float(v))
            del series[: max(0, len(series) - self.window)]


# --------------------------------------------------------- filtering/sorting

JOB_SORT_KEYS = ("queued", "elapsed", "state", "name")


def filter_jobs(jobs: list[dict], query: str) -> list[dict]:
    """Case-insensitive substring match over id, name, and state."""
    if not query:
        return jobs
    q = query.lower()
    return [j for j in jobs
            if q in str(j.get("job_id", "")).lower()
            or q in str(j.get("job_name", "")).lower()
            or q in str(j.get("state", "")).lower()]


def sort_jobs(jobs: list[dict], key: str) -> list[dict]:
    now = time.time()
    if key == "elapsed":
        return sorted(jobs, key=lambda j: -(
            (j.get("ended_at") or now) - (j.get("queued_at") or now)))
    if key == "state":
        return sorted(jobs, key=lambda j: str(j.get("state", "")))
    if key == "name":
        return sorted(jobs, key=lambda j: str(j.get("job_name", "")))
    return sorted(jobs, key=lambda j: -(j.get("queued_at") or 0))  # newest first


# ---------------------------------------------------------------- rendering


def fmt_duration(start_s, end_s) -> str:
    if not start_s:
        return "-"
    end = end_s or time.time()
    s = max(0.0, end - start_s)
    return f"{s:.1f}s" if s < 120 else f"{s / 60:.1f}m"


def render_header(state: dict, hist: History | None = None, width: int = 120) -> list[str]:
    lines = [
        f" ballista_tpu {state.get('version', '?')} · scheduler {state.get('scheduler_id', '?')}"
        f" · executors {state.get('executors', 0)} · jobs {state.get('jobs', 0)}"
    ]
    if hist is not None and hist.running_jobs:
        w = max(8, (width - 30) // 3)
        lines.append(
            f" act {sparkline(hist.running_jobs, w)} "
            f"slots {sparkline(hist.busy_slots, w)} "
            f"done/s {sparkline(hist.completed_rate, w)}"[:width])
    return lines


def render_jobs(jobs: list[dict], selected: int, width: int = 120,
                query: str = "", sort_key: str = "queued") -> list[str]:
    tag = f" [filter:{query}]" if query else ""
    lines = [f" {'JOB':<12} {'NAME':<16} {'STATE':<11} {'STAGES':<8} "
             f"{'ELAPSED':<8} sort:{sort_key}{tag}"]
    for i, j in enumerate(jobs):
        stages = f"{j.get('completed_stages', 0)}/{j.get('total_stages', 0)}"
        row = (
            f" {j.get('job_id', '')[:12]:<12} {j.get('job_name', '')[:16]:<16} "
            f"{j.get('state', ''):<11} {stages:<8} "
            f"{fmt_duration(j.get('queued_at'), j.get('ended_at')):<8}"
        )
        lines.append((">" if i == selected else " ") + row[1:width])
    return lines


def render_executors(execs: list[dict], selected: int, width: int = 120) -> list[str]:
    lines = [f" {'EXECUTOR':<16} {'HOST':<18} {'GRPC':<6} {'FLIGHT':<7} "
             f"{'SLOTS':<9} {'DEV':<4} {'SEEN':<6}"]
    now = time.time()
    for i, e in enumerate(execs):
        slots = f"{e.get('free_slots', 0)}/{e.get('total_slots', 0)}"
        seen = f"{now - e.get('last_seen', now):.0f}s"
        dev = e.get("device_ordinal")
        row = (
            f" {e.get('id', '')[:16]:<16} {e.get('host', '')[:18]:<18} "
            f"{e.get('grpc_port', 0):<6} {e.get('flight_port', 0):<7} {slots:<9} "
            f"{('-' if dev is None else dev):<4} {seen:<6}"
        )
        lines.append((">" if i == selected else " ") + row[1:width])
    return lines


def render_stages(stages: list[dict], selected: int = -1, width: int = 120) -> list[str]:
    lines = [f" {'STAGE':<6} {'STATE':<11} {'TASKS':<16} {'TOP OPERATORS (p50 ms)':<60}"]
    for i, s in enumerate(stages):
        tasks = f"{s.get('completed', 0)}✓ {s.get('running', 0)}▶ {s.get('pending', 0)}·"
        pcts = s.get("metric_percentiles", [])
        tops = sorted(pcts, key=lambda p: -p.get("elapsed_ms_p50", 0))[:2]
        ops = "; ".join(
            f"{p['name'].split(':')[0]} {p.get('elapsed_ms_p50', 0):.1f}" for p in tops
        )
        row = f" {s.get('stage_id', 0):<6} {s.get('state', ''):<11} {tasks:<16} {ops[:60]:<60}"
        lines.append(((">" if i == selected else " ") + row[1:])[:width])
    return lines


def render_operators(stage: dict, width: int = 120) -> list[str]:
    """Full per-operator metric table for one stage: every operator from the
    percentile summary, indented by plan depth, with elapsed p50/p90/p99 and
    output rows (the ratatui query-detail metric table analog)."""
    lines = [f" stage {stage.get('stage_id', '?')} operators "
             f"({stage.get('completed', 0)} tasks done)",
             f" {'OPERATOR':<38} {'TASKS':<6} {'P50ms':<9} {'P90ms':<9} "
             f"{'P99ms':<9} {'ROWS':<12}"]
    for p in stage.get("metric_percentiles", []):
        name = ("  " * int(p.get("depth", 0)) + p.get("name", "").split(":")[0])[:38]
        lines.append(
            f" {name:<38} {p.get('tasks', 0):<6} {p.get('elapsed_ms_p50', 0):<9.1f} "
            f"{p.get('elapsed_ms_p90', 0):<9.1f} {p.get('elapsed_ms_p99', 0):<9.1f} "
            f"{p.get('output_rows_total', 0):<12}"[:width])
    if len(lines) == 2:
        lines.append(" (no task metrics yet)")
    return lines


def render_config(cfg: dict, width: int = 120, offset: int = 0) -> list[str]:
    lines = [
        f" scheduler {cfg.get('scheduler_id', '?')} · v{cfg.get('version', '?')} · "
        f"task-distribution={cfg.get('task_distribution', '?')} · "
        f"executor-timeout={cfg.get('executor_timeout_s', '?')}s · "
        f"job-state={cfg.get('job_state_backend', '?')}"[:width],
        f" {'SESSION CONFIG KEY':<44} {'TYPE':<6} {'DEFAULT':<14} DESCRIPTION",
    ]
    entries = cfg.get("session_config_entries", [])
    offset = max(0, min(offset, len(entries) - 1))  # clamp: never scroll blank
    for e in entries[offset:]:
        d = str(e.get("default"))
        lines.append(
            f" {e.get('name', '')[:44]:<44} {e.get('type', ''):<6} {d[:14]:<14} "
            f"{e.get('description', '')}"[:width])
    return lines


def render_help(width: int = 120) -> list[str]:
    return [line[:width] for line in (
        " ballista_tpu monitor — keys",
        "",
        "   Tab        cycle panes (Jobs / Executors / Config)",
        "   j / k, ↓/↑ move selection (scrolls Config)",
        "   Enter      Jobs: drill into stages; stages: operator metrics",
        "   Esc        back out one level",
        "   /          filter jobs (type, Enter applies, Esc clears)",
        "   s          cycle job sort: queued → elapsed → state → name",
        "   c          cancel selected (or drilled) job",
        "   ?          toggle this help",
        "   q          quit",
    )]


# ------------------------------------------------------------------ the app


def run_tui(base_url: str, refresh_s: float = 1.0) -> None:  # pragma: no cover
    import curses

    client = RestClient(base_url)
    hist = History(tick_s=refresh_s)

    def app(scr):
        curses.curs_set(0)
        scr.timeout(int(refresh_s * 1000))
        pane = 0  # 0 jobs, 1 executors, 2 config
        sel = 0
        drill: str | None = None       # job id whose stages are shown
        stages_shown: list[dict] = []  # last rendered stage list
        op_stage: int | None = None    # stage id whose operators are shown
        stage_sel = 0
        cfg_off = 0
        cfg_cache: dict | None = None
        query, typing = "", False
        sort_i = 0
        show_help = False
        msg = ""
        while True:
            try:
                state = client.state()
                jobs_raw = client.jobs()
                execs = client.executors()
            except Exception as e:  # noqa: BLE001
                scr.erase()
                _, ew = scr.getmaxyx()
                try:
                    scr.addstr(0, 0, f" cannot reach scheduler: {e} (q quits)"[: ew - 1])
                except curses.error:
                    pass
                scr.refresh()
                if scr.getch() in (ord("q"), 27):
                    return
                continue
            hist.sample(jobs_raw, execs)
            jobs = sort_jobs(filter_jobs(jobs_raw, query), JOB_SORT_KEYS[sort_i])
            h, w = scr.getmaxyx()
            scr.erase()
            if h < 5 or w < 20:
                try:
                    scr.addstr(0, 0, "window too small"[: max(0, w - 1)])
                except curses.error:
                    pass
                scr.refresh()
                if scr.getch() == ord("q"):
                    return
                continue
            head = render_header(state, hist, w - 1)
            for i, line in enumerate(head):
                scr.addstr(i, 0, line[: w - 1], curses.A_BOLD if i == 0 else 0)
            top = len(head)
            if show_help:
                body = render_help(w - 1)
                scr.addstr(top, 0, " help (? closes)"[: w - 1], curses.A_UNDERLINE)
                for i, line in enumerate(body[: h - top - 2]):
                    scr.addstr(top + 1 + i, 0, line[: w - 1])
            elif drill is not None:
                try:
                    stages = client.stages(drill)
                except Exception:  # noqa: BLE001
                    stages, msg = [], " job gone"
                stages_shown = stages  # Enter drills what was RENDERED
                if op_stage is not None:
                    st = next((s for s in stages if s.get("stage_id") == op_stage), None)
                    body = render_operators(st, w - 1) if st else [" stage gone"]
                    scr.addstr(top, 0, f" {drill} / stage {op_stage} (Esc back)"[: w - 1],
                               curses.A_UNDERLINE)
                else:
                    stage_sel = max(0, min(stage_sel, len(stages) - 1))
                    body = render_stages(stages, stage_sel, w - 1)
                    scr.addstr(top, 0,
                               f" stages of {drill} (Enter operators · Esc back)"[: w - 1],
                               curses.A_UNDERLINE)
                for i, line in enumerate(body[: h - top - 2]):
                    scr.addstr(top + 1 + i, 0, line[: w - 1])
            elif pane == 2:
                try:
                    if cfg_cache is None:  # static payload: fetch once per entry
                        cfg_cache = client.config()
                    body = render_config(cfg_cache, w - 1, cfg_off)
                except Exception as e:  # noqa: BLE001
                    body = [f" config unavailable: {e}"]
                scr.addstr(top, 0, " Jobs  Executors [Config] "[: w - 1], curses.A_UNDERLINE)
                for i, line in enumerate(body[: h - top - 2]):
                    scr.addstr(top + 1 + i, 0, line[: w - 1])
            else:
                rows = jobs if pane == 0 else execs
                sel = max(0, min(sel, len(rows) - 1))
                body = (render_jobs(jobs, sel, w - 1, query, JOB_SORT_KEYS[sort_i])
                        if pane == 0 else render_executors(execs, sel, w - 1))
                title = " [Jobs] Executors  Config " if pane == 0 else " Jobs [Executors] Config "
                scr.addstr(top, 0, title[: w - 1], curses.A_UNDERLINE)
                for i, line in enumerate(body[: h - top - 2]):
                    scr.addstr(top + 1 + i, 0, line[: w - 1])
            status = f" /{query}" if typing else msg
            if status:
                scr.addstr(h - 1, 0, status[: w - 1], curses.A_REVERSE)
                msg = ""
            scr.refresh()
            ch = scr.getch()
            if typing:
                if ch in (curses.KEY_ENTER, 10, 13):
                    typing = False
                elif ch == 27:
                    typing, query = False, ""
                elif ch in (curses.KEY_BACKSPACE, 127, 8):
                    query = query[:-1]
                elif 32 <= ch < 127:
                    query += chr(ch)
                continue
            if ch == ord("q"):
                return
            if ch == ord("?"):
                show_help = not show_help
            elif show_help:
                show_help = ch != 27  # Esc closes; other keys are inert
            elif ch == 27:  # Esc backs out one level
                if op_stage is not None:
                    op_stage = None
                elif drill is not None:
                    drill = None
                else:
                    query = ""
            elif drill is not None:
                if ch == ord("c"):
                    try:
                        client.cancel(drill)
                        msg = f" cancel requested for {drill}"
                    except Exception as e:  # noqa: BLE001
                        msg = f" cancel failed: {e}"
                elif op_stage is None:
                    if ch in (ord("j"), curses.KEY_DOWN):
                        stage_sel += 1
                    elif ch in (ord("k"), curses.KEY_UP):
                        stage_sel = max(0, stage_sel - 1)
                    elif ch in (curses.KEY_ENTER, 10, 13) and stages_shown:
                        op_stage = stages_shown[
                            min(stage_sel, len(stages_shown) - 1)]["stage_id"]
            elif ch == ord("\t"):
                pane, sel, cfg_off, cfg_cache = (pane + 1) % 3, 0, 0, None
            elif ch == ord("/") and pane == 0:
                typing = True
            elif ch == ord("s") and pane == 0:
                sort_i = (sort_i + 1) % len(JOB_SORT_KEYS)
            elif ch in (ord("j"), curses.KEY_DOWN):
                if pane == 2:
                    cfg_off += 1
                else:
                    sel += 1
            elif ch in (ord("k"), curses.KEY_UP):
                if pane == 2:
                    cfg_off = max(0, cfg_off - 1)
                else:
                    sel = max(0, sel - 1)
            elif ch in (curses.KEY_ENTER, 10, 13) and pane == 0 and jobs:
                drill, stage_sel = jobs[min(sel, len(jobs) - 1)]["job_id"], 0
            elif ch == ord("c") and pane == 0 and jobs:
                jid = jobs[min(sel, len(jobs) - 1)]["job_id"]
                try:
                    client.cancel(jid)
                    msg = f" cancel requested for {jid}"
                except Exception as e:  # noqa: BLE001
                    msg = f" cancel failed: {e}"

    curses.wrapper(app)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ballista_tpu_torch cluster monitor (TUI)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--rest-port", type=int, default=50080)
    ap.add_argument("--refresh", type=float, default=1.0)
    args = ap.parse_args(argv)
    run_tui(f"http://{args.host}:{args.rest_port}", args.refresh)


if __name__ == "__main__":
    main()
