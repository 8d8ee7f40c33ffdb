"""Executor HTTP health endpoint (reference: executor/src/health.rs:94).

GET /health → {"status": "healthy", ...liveness facts} — the probe target
for k8s-style deployments; reports degraded once shutdown begins.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def start_health_server(executor, stopping_event, host: str = "0.0.0.0", port: int = 0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") not in ("", "/health"):
                self.send_response(404)
                self.end_headers()
                return
            from ballista_tpu_torch.shuffle.integrity import INTEGRITY

            pools = executor.session_pools
            stopping = stopping_event.is_set()
            body = json.dumps({
                "status": "draining" if (stopping or executor.draining) else "healthy",
                # lifecycle facts (docs/lifecycle.md): draining = handoff in
                # progress, stopping = shutdown begun
                "lifecycle_state": ("stopping" if stopping
                                    else "draining" if executor.draining else "active"),
                "executor_id": executor.metadata.id,
                "tasks_run": executor.tasks_run,
                "tasks_failed": executor.tasks_failed,
                "device_ordinal": executor.metadata.device_ordinal,
                "pressure_rejections": executor.pressure_rejections,
                "disk_rejections": executor.disk_rejections,
                "migrated_partitions": executor.migrated_partitions,
                "migrated_bytes": executor.migrated_bytes,
                "gc_reclaimed_bytes": executor.gc_reclaimed_bytes,
                "orphans_reclaimed": executor.orphans_reclaimed,
                "memory_pressure": round(pools.aggregate_pressure(), 4) if pools else 0.0,
                "pool_overcommitted_bytes": pools.total_overcommitted() if pools else 0,
                # shuffle-integrity counters (reader-side verification)
                **INTEGRITY.snapshot(),
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True, name="executor-health")
    t.start()
    return server, server.server_port
