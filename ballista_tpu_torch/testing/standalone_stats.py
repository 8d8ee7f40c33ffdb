"""What a standalone or remote job did, read from its ExecutionGraph.

The scheduler keeps the operator metrics of every task that won its
partition (`ExecutionGraph.stage_metrics`, the rows a distributed EXPLAIN
ANALYZE prints) and the shuffle locations each stage published. From them,
per stage: the tasks that ran, the device passes and CPU fallbacks of its
device nodes summed over those tasks (the `device_runs=` / `cpu_fallbacks=`
counters of their `node_str`), the bytes its tasks wrote to shuffle files,
and the bytes and fetch RPCs its shuffle readers took from local files or
over Flight. The JAX package's graphs have the same shape and counters, so
its tests read those with this too.
"""

from __future__ import annotations

import re

_DEVICE_NODE = re.compile(r"^(Tpu\w+Exec): ")
_COUNTERS = re.compile(r" device_runs=(\d+) cpu_fallbacks=(\d+)$")
_READ_KEYS = ("bytes_read_local", "bytes_fetched_remote", "fetch_rpcs")


def stage_stats(graph) -> dict[int, dict]:
    """{stage_id: {"tasks", "device": {node kind: [nodes, device passes,
    fallbacks]}, "device_passes", "fallbacks", "shuffle_bytes_written",
    "bytes_read_local", "bytes_fetched_remote", "fetch_rpcs"}}."""
    out: dict[int, dict] = {}
    for sid in sorted(graph.stages):
        out[sid] = _stage_counts(graph.stage_metrics.get(sid, []))
        out[sid]["shuffle_bytes_written"] = sum(
            loc.stats.num_bytes for locs in graph.stages[sid].completed.values()
            for loc in locs)
    return out


def job_metrics_stats(result) -> dict[int, dict]:
    """Tasks, device nodes, passes and fallbacks per stage from a scheduler
    in another process: its GetJobMetrics reply (the rows a remote EXPLAIN
    ANALYZE prints; `RemoteSchedulerClient.job_metrics(job_id)`). The reply
    carries names and depths only, so the shuffle bytes and reads read 0."""
    return {sp.stage_id: _stage_counts([{"name": m.name, "depth": m.depth}
                                        for m in sp.metrics])
            for sp in result.stages}


def _stage_counts(metrics: list[dict]) -> dict:
    device: dict[str, list[int]] = {}
    read = dict.fromkeys(_READ_KEYS, 0)
    for m in metrics:
        name = str(m.get("name", ""))
        kind = _DEVICE_NODE.match(name)
        if kind is not None:
            runs = _COUNTERS.search(name)
            d = device.setdefault(kind.group(1), [0, 0, 0])
            d[0] += 1
            if runs is not None:
                d[1] += int(runs.group(1))
                d[2] += int(runs.group(2))
        if name.startswith("ShuffleReaderExec"):
            for k in _READ_KEYS:
                read[k] += int(m.get(k, 0))
    return {
        # every task reports its stage root (the shuffle writer) at depth 0
        "tasks": sum(1 for m in metrics if int(m.get("depth", 0)) == 0),
        "device": device,
        "device_passes": sum(d[1] for d in device.values()),
        "fallbacks": sum(d[2] for d in device.values()),
        **read,
    }


def last_job(scheduler):
    """The graph of the scheduler's most recently submitted job."""
    with scheduler._jobs_lock:
        return list(scheduler.jobs.values())[-1]
