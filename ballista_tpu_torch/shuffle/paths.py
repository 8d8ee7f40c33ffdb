"""Shuffle file layout.

hash layout (reference: execution_plans/mod.rs:78):
    {work_dir}/{job_id}/{stage_id}/{output_partition}/data-{task_id}.arrow
    one complete Arrow IPC stream per (map task, output partition)

sort layout (reference: sort_shuffle/index.rs — 2×M files instead of N×M):
    {work_dir}/{job_id}/{stage_id}/data-{map_partition}-{task_id}.arrow
        (K buckets, each byte range a complete IPC stream, sorted by
        partition id; task_id makes the name attempt-unique so speculative
        duplicates never clobber each other)
    {work_dir}/{job_id}/{stage_id}/data-{map_partition}-{task_id}.idx
        (json index: output_partition → [offset, length, rows, bytes]
         + an optional 5th element: the range's checksum string — readers
         that predate it only index [0] and [1], so old and new binaries
         interoperate in both directions)

integrity sidecars: a hash-layout data file's whole-file checksum lives in
`{data}.arrow.crc` (the sort layout stores per-range checksums inside the
index instead). Both are optional — their absence means "unchecked", never
an error, so files written with `ballista.shuffle.checksum.enabled=false`
round-trip unchanged.
"""

from __future__ import annotations

import os


def hash_partition_dir(work_dir: str, job_id: str, stage_id: int, output_partition: int) -> str:
    return os.path.join(work_dir, job_id, str(stage_id), str(output_partition))


def hash_data_path(work_dir: str, job_id: str, stage_id: int, output_partition: int, task_id) -> str:
    return os.path.join(hash_partition_dir(work_dir, job_id, stage_id, output_partition), f"data-{task_id}.arrow")


def sort_data_path(work_dir: str, job_id: str, stage_id: int, map_partition: int,
                   task_id=None) -> str:
    """With task_id, the name is ATTEMPT-unique: concurrent attempts of the
    same map partition (speculation, deadline retries) write disjoint files
    and the winner's paths are the only ones the scheduler commits. The
    reader derives the index name from whatever path it is handed."""
    name = f"data-{map_partition}.arrow" if task_id is None else f"data-{map_partition}-{task_id}.arrow"
    return os.path.join(work_dir, job_id, str(stage_id), name)


def index_path(data_path: str) -> str:
    return data_path[: -len(".arrow")] + ".idx" if data_path.endswith(".arrow") else data_path + ".idx"


def crc_path(data_path: str) -> str:
    """Sidecar holding a hash-layout file's whole-file checksum string."""
    return data_path + ".crc"


def checksum_for(path: str, layout: str, output_partition: int) -> str | None:
    """The stored checksum of one output partition's byte range, or None
    when it was never recorded (pre-checksum writer, knob disabled, or the
    partition is absent). Sort layout: 5th element of the index entry;
    hash layout: the `.crc` sidecar. Never raises — a serving path must
    treat an unreadable checksum as 'unchecked', not as an error."""
    try:
        if is_sort_layout(layout):
            import json

            with open(index_path(path)) as f:
                index = json.load(f)
            entry = index.get(str(output_partition))
            if entry is None or len(entry) < 5 or not isinstance(entry[4], str):
                return None
            return entry[4] or None
        with open(crc_path(path)) as f:
            return f.read().strip() or None
    except (OSError, ValueError):
        return None


def is_sort_layout(layout: str) -> bool:
    return layout == "sort"


def range_for(path: str, layout: str, output_partition: int) -> tuple[int, int] | None:
    """(offset, length) of one output partition's bytes inside `path`, or
    None when the partition is absent from a sort index (empty = contract).
    Hash layout is always the whole file."""
    if not is_sort_layout(layout):
        return 0, os.path.getsize(path)
    import json

    with open(index_path(path)) as f:
        index = json.load(f)
    entry = index.get(str(output_partition))
    if entry is None:
        return None
    return entry[0], entry[1]


def open_range_buffer(path: str, layout: str, output_partition: int,
                      use_mmap: bool = True):
    """One partition's stored IPC bytes as a pyarrow Buffer.

    With mmap (the default) the buffer is a zero-copy slice of a memory
    map — the page cache backs it and the kernel faults pages in as the
    consumer streams, so neither the Flight server nor a local reader ever
    materializes the partition in anonymous memory. The buffer holds a
    reference to the mapping, which stays alive until the last slice drops.
    Returns None for a partition absent from a sort index."""
    import pyarrow as pa

    r = range_for(path, layout, output_partition)
    if r is None:
        return None
    offset, length = r
    size = os.path.getsize(path)
    if offset + length > size:
        # torn write / truncated disk / stale index: a short mmap slice
        # would silently end the IPC stream early — refuse with a typed,
        # retryable error instead (the Flight server surfaces it as
        # unavailable; a local reader's retry ladder escalates it)
        from ballista_tpu_torch.errors import ShortRead

        raise ShortRead(path, offset, length, size)
    if use_mmap:
        mm = pa.memory_map(path)
        mm.seek(offset)
        return mm.read_buffer(length)
    with open(path, "rb") as f:
        f.seek(offset)
        return pa.py_buffer(f.read(length))


def job_dir(work_dir: str, job_id: str) -> str:
    return os.path.join(work_dir, job_id)


def validate_job_id(job_id: str) -> str:
    """Reject job ids that could escape the work dir when joined into a
    filesystem path (data-plane actions take the id from the wire)."""
    if not job_id or job_id in (".", "..") or "/" in job_id or "\\" in job_id or "\x00" in job_id:
        raise ValueError(f"invalid job id {job_id!r}")
    return job_id


def contained_path(work_dir: str, path: str) -> str:
    """Resolve `path` and require it to live under `work_dir`.

    The Flight data plane receives file paths inside tickets (they are the
    location fields a PartitionLocation carries); the server must not trust
    them to stay inside its own shuffle directory — the reference builds
    paths server-side from structured fields for the same reason
    (executor/src/flight_service.rs). Raises PermissionError on escape.
    """
    root = os.path.realpath(work_dir)
    resolved = os.path.realpath(path)
    if resolved != root and not resolved.startswith(root + os.sep):
        raise PermissionError(f"path {path!r} escapes work dir {work_dir!r}")
    return resolved
