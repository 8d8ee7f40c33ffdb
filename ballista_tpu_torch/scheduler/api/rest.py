"""Scheduler REST API.

Rebuild of the axum REST surface (scheduler/src/api/routes.rs:24,
handlers.rs): scheduler state/version, executors, jobs (+cancel), per-job
stages with operator metrics, dot-format stage graphs, Prometheus metrics
passthrough, and a health endpoint. stdlib http.server — zero deps, same
routes.

GET  /api/state                 GET  /api/executors
GET  /api/jobs                  GET  /api/job/{id}
GET  /api/job/{id}/stages       GET  /api/job/{id}/dot
GET  /api/job/{id}/graph        POST /api/job/{id}/cancel
GET  /api/metrics               GET  /health
GET  / (and /ui)                — web cluster monitor (webui.py)
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ballista_tpu_torch.scheduler.metrics import InMemoryMetricsCollector
from ballista_tpu_torch.scheduler.server import SchedulerServer
from ballista_tpu_torch.version import BALLISTA_VERSION


def _metric_percentiles(raw: list[dict]) -> list[dict]:
    """Per-operator percentile summary across a stage's task metrics
    (reference: api/handlers.rs:191,200 metric percentiles)."""
    by_op: dict[tuple, list[dict]] = {}
    for m in raw:
        by_op.setdefault((int(m.get("depth", 0)), str(m.get("name", ""))), []).append(m)

    def pct(sorted_vals, p):
        if not sorted_vals:
            return 0
        i = min(len(sorted_vals) - 1, int(round(p / 100.0 * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    out = []
    for (depth, name), ms in sorted(by_op.items()):
        elapsed = sorted(int(m.get("elapsed_ns", 0)) for m in ms)
        rows = sorted(int(m.get("output_rows", 0)) for m in ms)
        out.append({
            "depth": depth, "name": name, "tasks": len(ms),
            "output_rows_total": sum(rows),
            "elapsed_ms_p50": pct(elapsed, 50) / 1e6,
            "elapsed_ms_p90": pct(elapsed, 90) / 1e6,
            "elapsed_ms_p99": pct(elapsed, 99) / 1e6,
            "output_rows_p50": pct(rows, 50),
            "output_rows_p99": pct(rows, 99),
        })
    return out


def start_rest_api(scheduler: SchedulerServer, metrics: InMemoryMetricsCollector,
                   host: str = "0.0.0.0", port: int = 0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: str, ctype: str = "application/json"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj, default=str, indent=1))

        def do_GET(self):  # noqa: N802
            p = self.path.rstrip("/")
            if p in ("", "/ui"):
                from ballista_tpu_torch.scheduler.api.webui import WEBUI_HTML

                return self._send(200, WEBUI_HTML, "text/html; charset=utf-8")
            if p == "/health":
                return self._json({"status": "healthy"})
            if p == "/api/state":
                with scheduler._jobs_lock:
                    jobs = len(scheduler.jobs)
                return self._json({
                    "version": BALLISTA_VERSION,
                    "scheduler_id": scheduler.scheduler_id,
                    "executors": len(scheduler.executors.alive_executors()),
                    "quarantined_executors": scheduler.executors.quarantined_count(),
                    "jobs": jobs,
                    "flight_proxy_port": getattr(scheduler, "flight_proxy_port", 0),
                    # overload posture: state machine + admission gauges
                    # (per-lane inflight/shed counts live under "lanes")
                    "overload": scheduler.admission.snapshot(),
                    "aggregate_memory_pressure": round(
                        scheduler.executors.aggregate_pressure(), 4),
                    # serving tier: plan/result cache hit rates + fast lane
                    "serving": scheduler.serving.snapshot(),
                    # append ingestion: retained delta versions/bytes,
                    # compaction counters; continuous-query subscriptions
                    "ingest": scheduler.ingest.snapshot(),
                    "subscriptions": scheduler.subscriptions.snapshot(),
                    # scheduler scale-out: per-shard queue depth/lag/job
                    # counts, direct-dispatch lease ledger, heartbeat fan-in
                    "shards": scheduler.shards_snapshot(),
                    "leases": scheduler.leases.snapshot(),
                    "fanin": dict(scheduler._fanin),
                    # executor lifecycle (docs/lifecycle.md): drain/migration
                    # counters + the terminal drained-executor ledger
                    "lifecycle": {
                        **scheduler.lifecycle_stats,
                        "drained_executors": scheduler.executors.drained_snapshot(),
                    },
                })
            if p == "/api/executors":
                out = []
                health = scheduler.executors.health_snapshot()
                for e in scheduler.executors.alive_executors():
                    out.append({
                        "id": e.metadata.id, "host": e.metadata.host,
                        "grpc_port": e.metadata.grpc_port, "flight_port": e.metadata.flight_port,
                        "total_slots": e.total_slots, "free_slots": e.free_slots,
                        "last_seen": e.last_seen,
                        "device_ordinal": e.metadata.device_ordinal,
                        **health.get(e.metadata.id, {}),
                    })
                return self._json(out)
            if p == "/api/jobs":
                with scheduler._jobs_lock:
                    out = [g.job_status() for g in scheduler.jobs.values()]
                for o in out:
                    o.pop("partitions", None)
                    o.pop("schema", None)
                    o.pop("inline_result", None)  # pa.Table; not JSON
                return self._json(out)
            m = re.match(r"^/api/job/([^/]+)$", p)
            if m:
                st = scheduler.job_status(m.group(1))
                if st is None:
                    return self._json({"error": "not found"}, 404)
                st.pop("partitions", None)
                st.pop("schema", None)
                st.pop("inline_result", None)
                return self._json(st)
            m = re.match(r"^/api/job/([^/]+)/stages$", p)
            if m:
                with scheduler._jobs_lock:
                    g = scheduler.jobs.get(m.group(1))
                if g is None:
                    return self._json({"error": "not found"}, 404)
                stages = []
                for sid in sorted(g.stages):
                    s = g.stages[sid]
                    raw = g.stage_metrics.get(sid, [])
                    stages.append({
                        "stage_id": sid, "state": s.state.value, "attempt": s.attempt,
                        "partitions": s.spec.partitions,
                        "output_partitions": s.spec.output_partitions,
                        "pending": len(s.pending), "running": len(s.running),
                        "completed": len(s.completed),
                        "plan": s.spec.plan.display(),
                        "metrics": raw[:200],
                        "metric_percentiles": _metric_percentiles(raw),
                    })
                return self._json(stages)
            m = re.match(r"^/api/job/([^/]+)/graph$", p)
            if m:
                # stage DAG as JSON (the web monitor's client-side renderer;
                # the dot endpoint below stays for graphviz tooling)
                with scheduler._jobs_lock:
                    g = scheduler.jobs.get(m.group(1))
                if g is None:
                    return self._json({"error": "not found"}, 404)
                stages = []
                for sid in sorted(g.stages):
                    s = g.stages[sid]
                    stages.append({
                        "stage_id": sid, "state": s.state.value,
                        "attempt": s.attempt,
                        "partitions": s.spec.partitions,
                        "completed": len(s.completed),
                        "summary": s.spec.plan.node_str(),
                        "metric_percentiles": _metric_percentiles(
                            g.stage_metrics.get(sid, [])),
                    })
                edges = [[sid, o] for sid, outs in g.output_links.items()
                         for o in outs]
                return self._json({
                    "job_id": g.job_id, "status": g.status.value,
                    "stages": stages, "edges": edges,
                })
            m = re.match(r"^/api/job/([^/]+)/dot$", p)
            if m:
                with scheduler._jobs_lock:
                    g = scheduler.jobs.get(m.group(1))
                if g is None:
                    return self._json({"error": "not found"}, 404)
                from ballista_tpu_torch.utils.dot import graph_to_dot

                return self._send(200, graph_to_dot(g), "text/vnd.graphviz")
            if p == "/api/metrics":
                return self._send(200, metrics.render_prometheus(), "text/plain; version=0.0.4")
            if p == "/api/config":
                # scheduler runtime settings + the typed session-config
                # registry (reference: the TUI's scheduler-config screen);
                # restricted keys are scrubbed like the session KV transport
                from ballista_tpu_torch.config import RESTRICTED_KEYS, VALID_ENTRIES

                entries = [{
                    "name": e.name, "type": e.ty.__name__,
                    "default": e.default, "description": e.description,
                    **({"choices": list(e.choices)} if e.choices else {}),
                } for e in VALID_ENTRIES.values() if e.name not in RESTRICTED_KEYS]
                return self._json({
                    "scheduler_id": scheduler.scheduler_id,
                    "version": BALLISTA_VERSION,
                    "task_distribution": scheduler.executors.task_distribution,
                    "executor_timeout_s": scheduler.executors.timeout_s,
                    "job_state_backend": type(scheduler.job_state).__name__,
                    "flight_proxy_port": getattr(scheduler, "flight_proxy_port", 0),
                    "session_config_entries": sorted(entries, key=lambda e: e["name"]),
                })
            return self._json({"error": "not found"}, 404)

        def do_POST(self):  # noqa: N802
            m = re.match(r"^/api/job/([^/]+)/cancel$", self.path.rstrip("/"))
            if m:
                scheduler.cancel_job(m.group(1))
                return self._json({"cancelled": m.group(1)})
            m = re.match(r"^/api/table/([^/]+)/append$", self.path.rstrip("/"))
            if m:
                # body: one Arrow IPC stream of appended rows
                import pyarrow as pa

                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    return self._json({"error": "empty body"}, 400)
                try:
                    reader = pa.ipc.open_stream(self.rfile.read(length))
                    batches = [b for b in reader if b.num_rows]
                    out = scheduler.append_data(m.group(1), batches)
                except Exception as e:  # noqa: BLE001 — malformed IPC → client error
                    return self._json({"error": str(e)}, 400)
                return self._json(out)
            return self._json({"error": "not found"}, 404)

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True, name="rest-api")
    t.start()
    return server, server.server_port
