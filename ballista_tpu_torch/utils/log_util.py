"""Daemon logging init with rotation.

Rebuild of the reference's tracing-appender setup (LogRotationPolicy
minutely/hourly/daily/never, core/src/config.rs:898): both daemons log to
stderr by default; with --log-file they also write a rotating file so a
long-lived scheduler/executor can't fill its disk with one unbounded log.
"""

from __future__ import annotations

import logging
import logging.handlers

ROTATION_POLICIES = ("never", "minutely", "hourly", "daily")

_WHEN = {"minutely": "M", "hourly": "H", "daily": "midnight"}
_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def init_logging(level: str = "INFO", log_file: str | None = None,
                 rotation: str = "daily", backups: int = 7) -> None:
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_file:
        if rotation == "never":
            fh: logging.Handler = logging.FileHandler(log_file)
        else:
            if rotation not in _WHEN:
                raise ValueError(f"log rotation must be one of {ROTATION_POLICIES}")
            fh = logging.handlers.TimedRotatingFileHandler(
                log_file, when=_WHEN[rotation], backupCount=backups
            )
        handlers.append(fh)
    logging.basicConfig(level=level, format=_FORMAT, handlers=handlers, force=True)
