"""Disk-pressure watermarks: the executor's storage admission ladder.

Two thresholds over the used fraction of the work-dir filesystem
(`shutil.disk_usage`), checked at distinct admission points so pressure
sheds the OPTIONAL writes first and the MANDATORY ones last
(docs/lifecycle.md#watermark-ladder):

- low watermark (`ballista.executor.disk.low.watermark`) — spill
  admission sheds: the sort-shuffle writer stops demoting buffers to
  disk (`spill_allowed`) and the HBM spill pool keeps cold entries in
  the host tier. Queries keep running on the in-memory overcommit
  ladder; only disk-optional writes stop.
- high watermark (`ballista.executor.disk.high.watermark`) — task
  admission rejects: `Executor.run_task` turns new tasks away with a
  retryable DiskExhausted (`admission_blocked`), the scheduler re-pends
  the slice, and the per-executor disk gauges on the heartbeat steer
  placement toward nodes with headroom.

An actual ENOSPC from the filesystem (errno 28) is the ladder's
backstop: the write points wrap it as the same typed `DiskExhausted`
(see `shuffle/writer.py`, `ops/tpu/hbm.py`), so a disk that fills
faster than the watermarks can react still fails blame-aware and
retryable instead of crashing the task untyped.

`disk_status` caches the statvfs result briefly — admission runs per
task and per spill, and the fraction moves on a much coarser clock
than either.
"""

from __future__ import annotations

import errno
import shutil
import time

from ballista_tpu_torch.utils.lru import LruDict

# path → (sampled_at, used_frac, used_bytes, free_bytes); tiny TTL cache
# so per-spill checks don't syscall-storm statvfs
_STATUS_CACHE = LruDict(max_entries=16)
_CACHE_TTL_S = 1.0

# test seam: force the observed used fraction (None = measure). Module
# state, set/cleared by tests and exercises — watermark behavior must be
# provable without actually filling a disk.
_FORCED_FRACTION: float | None = None


def force_used_fraction(frac: float | None) -> None:
    """Test seam: pin the used fraction `disk_status` reports (None =
    measure the real filesystem again). Clears the status cache."""
    global _FORCED_FRACTION
    _FORCED_FRACTION = frac
    _STATUS_CACHE.clear()


def disk_status(path: str) -> tuple[float, int, int]:
    """(used_fraction, used_bytes, free_bytes) for the filesystem holding
    `path`. Never raises: an unstatable path reports zero pressure (the
    write itself will surface the real error, typed)."""
    now = time.time()
    cached = _STATUS_CACHE.get(path)
    if cached is not None and now - cached[0] < _CACHE_TTL_S:
        return cached[1], cached[2], cached[3]
    if _FORCED_FRACTION is not None:
        frac = float(_FORCED_FRACTION)
        total = 1 << 30
        used = int(frac * total)
        out = (frac, used, total - used)
    else:
        try:
            du = shutil.disk_usage(path)
            frac = du.used / du.total if du.total > 0 else 0.0
            out = (frac, int(du.used), int(du.free))
        except OSError:
            out = (0.0, 0, 0)
    _STATUS_CACHE[path] = (now, out[0], out[1], out[2])
    return out


def _watermark(config, key) -> float:
    try:
        return float(config.get(key))
    except Exception:  # noqa: BLE001 — a broken config must not block writes
        return 1.0


def spill_allowed(config, path: str) -> bool:
    """Low-watermark gate for OPTIONAL disk writes (sort-shuffle spills,
    HBM pool disk demotions). False = shed: stay in memory."""
    if config is None:
        return True
    from ballista_tpu_torch.config import EXECUTOR_DISK_LOW_WATERMARK

    return disk_status(path)[0] < _watermark(config, EXECUTOR_DISK_LOW_WATERMARK)


def admission_blocked(config, path: str) -> bool:
    """High-watermark gate for NEW TASK admission. True = the executor
    should reject with a retryable DiskExhausted."""
    if config is None:
        return False
    from ballista_tpu_torch.config import EXECUTOR_DISK_HIGH_WATERMARK

    return disk_status(path)[0] >= _watermark(config, EXECUTOR_DISK_HIGH_WATERMARK)


def wrap_enospc(e: OSError, where: str):
    """Return a typed DiskExhausted for an ENOSPC OSError, else None —
    the write points re-raise anything that isn't actually a full disk."""
    if getattr(e, "errno", None) != errno.ENOSPC:
        return None
    from ballista_tpu_torch.errors import DiskExhausted

    return DiskExhausted(where, f"os error {errno.ENOSPC}: {e}")
