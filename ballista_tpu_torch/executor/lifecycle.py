"""Executor lifecycle: drain-time shuffle migration + startup orphan sweep.

Drain protocol (docs/lifecycle.md): when the scheduler drains an
executor, the map outputs it holds are HANDED OFF to a survivor instead
of being declared lost. The migration rides the existing coalesced
Flight path — the destination pulls each location's stored byte range
(CRC-verified against the source's declared checksum), commits it under
its own work dir with the writer's tmp+rename discipline, and this
module rewrites the PartitionLocation IN PLACE. Locations are shared by
reference between `stage.completed` and every reader built from them, so
the rewrite retargets downstream fetches without any stage rerun — the
post-drain `executor_lost` sweep finds nothing left that names the
drained executor.

Hard-kill mid-migration (chaos mode=drain_kill) aborts the loop after N
applied locations; the unrewritten remainder still names the drained
executor, so the same `executor_lost` sweep recomputes exactly those
stages — today's recovery path, byte-identical results.

The startup sweep is the crash-recovery half of orphaned-data GC: an
executor that died uncleanly leaves shuffle/spill job dirs its next
incarnation would never reclaim. The sweep is scoped to the executor's
OWN work dir (per-process identity — no reaching into peers' dirs) and
age-gated so a restart never races a live scheduler's `remove_job_data`.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

logger = logging.getLogger(__name__)


class DrainKilled(RuntimeError):
    """Chaos mode=drain_kill fired: the drain's migration died after N
    committed locations (simulating a hard-kill mid-handoff)."""


def migration_ticket(loc) -> dict:
    """Flight ticket for one location's byte range, plus the map identity
    the destination bakes into its committed file name."""
    return {
        "path": loc.path,
        "layout": loc.layout,
        "output_partition": loc.output_partition,
        "job_id": loc.job_id,
        "stage_id": loc.stage_id,
        "map_partition": loc.map_partition,
    }


def apply_migration(loc, dest_meta, new_path: str) -> None:
    """Rewrite one PartitionLocation in place to its migrated home. The
    object is shared by reference with every reader already built from it,
    so this single mutation retargets all downstream fetches. Migrated
    ranges always commit as hash layout (each range is a complete IPC
    stream, so the whole-file read is exactly the old range read)."""
    loc.executor_id = dest_meta.id
    loc.host = dest_meta.host
    loc.flight_port = dest_meta.flight_port
    loc.path = new_path
    loc.layout = "hash"


def migrate_via_flight(source_addr: str, dest_addr: str, locations,
                       dest_meta) -> tuple[int, int]:
    """Hand `locations` (all held by the executor at `source_addr`) off to
    the destination executor: one `migrate_pull` action on the DEST data
    plane pulls + commits every range, and each returned commit rewrites
    its location in place. Returns (migrated_count, migrated_bytes).

    Chaos mode=drain_kill aborts after N applied locations with
    DrainKilled — the caller treats the drain as a hard-kill and falls
    back to the recompute path for the unrewritten remainder."""
    import pyarrow.flight as flight

    from ballista_tpu_torch.executor.chaos import drain_kill_after
    from ballista_tpu_torch.flight.client import POOL

    if not locations:
        return 0, 0
    kill_after = drain_kill_after()
    tickets = [migration_ticket(l) for l in locations]
    client = POOL.get(dest_addr)
    action = flight.Action(
        "migrate_pull",
        json.dumps({"source": source_addr, "locations": tickets}).encode())
    count = 0
    nbytes = 0
    for r in client.do_action(action):
        h = json.loads(r.body.to_pybytes().decode())
        apply_migration(locations[int(h["i"])], dest_meta, h["path"])
        count += 1
        nbytes += int(h.get("nbytes", 0))
        if kill_after and count >= kill_after:
            raise DrainKilled(
                f"chaos: drain killed after {count}/{len(locations)} migrated locations")
    return count, nbytes


def migrate_local(locations, dest_meta) -> tuple[int, int]:
    """Shared-work-dir migration (single-process standalone): the files
    are already readable by the surviving data plane, so the handoff is
    pure relabeling — rewrite the owning executor identity, keep the path
    and layout. Honors drain_kill the same way the Flight path does."""
    from ballista_tpu_torch.executor.chaos import drain_kill_after

    kill_after = drain_kill_after()
    count = 0
    nbytes = 0
    for loc in locations:
        loc.executor_id = dest_meta.id
        loc.host = dest_meta.host
        loc.flight_port = dest_meta.flight_port
        count += 1
        nbytes += int(getattr(loc.stats, "num_bytes", 0))
        if kill_after and count >= kill_after:
            raise DrainKilled(
                f"chaos: drain killed after {count}/{len(locations)} migrated locations")
    return count, nbytes


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def sweep_stale_dirs(work_dir: str, max_age_s: float,
                     now: float | None = None) -> tuple[int, int]:
    """Startup orphan sweep: remove job dirs under this executor's OWN
    work dir whose last modification predates `max_age_s` — artifacts of a
    crashed prior run that no scheduler will ever `remove_job_data` for.
    Age-gated so a fresh restart cannot race a live job's files, and
    bounded to the work dir's immediate children (the job-dir layout,
    shuffle/paths.py). Returns (orphans_reclaimed, bytes_reclaimed)."""
    if max_age_s <= 0 or not work_dir or not os.path.isdir(work_dir):
        return 0, 0
    now = time.time() if now is None else now
    cutoff = now - max_age_s
    orphans = 0
    reclaimed = 0
    try:
        entries = os.listdir(work_dir)
    except OSError:
        return 0, 0
    for name in entries:
        d = os.path.join(work_dir, name)
        try:
            if not os.path.isdir(d) or os.path.getmtime(d) > cutoff:
                continue
        except OSError:
            continue
        nbytes = _dir_bytes(d)
        shutil.rmtree(d, ignore_errors=True)
        orphans += 1
        reclaimed += nbytes
        logger.info("startup sweep reclaimed stale dir %s (%d bytes)", d, nbytes)
    return orphans, reclaimed
