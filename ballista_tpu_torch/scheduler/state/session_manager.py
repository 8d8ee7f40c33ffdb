"""Session registry: session id → config → planning context.

Rebuild of SessionManager (scheduler/src/state/session_manager.rs:29).
Table registrations travel inside the session config as
`ballista.catalog.table.<name> = <parquet path>` key/value pairs (the
reference ships ListingTable definitions inside the logical-plan proto;
same information, different envelope).
"""

from __future__ import annotations

import threading

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.ids import SessionId, new_session_id

CATALOG_PREFIX = "ballista.catalog.table."


class SessionManager:
    def __init__(self):
        self.sessions: dict[str, BallistaConfig] = {}
        self._lock = threading.Lock()
        # serving tier hook: called with the table name whenever a session
        # update registers a table or points an existing one at a new path
        # (bumps the table-version vector → cached results stop matching)
        self.on_catalog_change = None

    def create_or_update(self, settings: list[tuple[str, str]], session_id: str = "") -> str:
        cfg = BallistaConfig.from_key_value_pairs(settings, scrub_restricted=True)
        sid = session_id or str(new_session_id())
        with self._lock:
            old = self.sessions.get(sid)
            self.sessions[sid] = cfg
        if self.on_catalog_change is not None:
            for k, v in cfg.to_key_value_pairs():
                if k.startswith(CATALOG_PREFIX) and (old is None or old.get(k) != v):
                    self.on_catalog_change(k[len(CATALOG_PREFIX):])
        return sid

    def get(self, session_id: str) -> BallistaConfig | None:
        with self._lock:
            return self.sessions.get(session_id)

    def remove(self, session_id: str) -> None:
        with self._lock:
            self.sessions.pop(session_id, None)

    def create_planning_context(self, session_id: str):
        """SessionContext (local mode) wired with the session's config and
        catalog registrations (create_datafusion_context analog)."""
        from ballista_tpu_torch.client.context import SessionContext

        cfg = self.get(session_id) or BallistaConfig()
        ctx = SessionContext(cfg.copy(), mode="local")
        for k, v in cfg.to_key_value_pairs():
            if k.startswith(CATALOG_PREFIX):
                ctx.register_parquet(k[len(CATALOG_PREFIX):], v)
        return ctx
