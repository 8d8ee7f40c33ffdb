"""Typed session configuration.

Rebuild of the reference's `BallistaConfig` (ballista/core/src/config.rs):
a registry of `ConfigEntry`s — name, description, type, default — with
validation at parse time, round-tripped over the wire as key/value pairs so
every job carries its full session config to the scheduler and executors
(reference: SessionConfigHelperExt::to_key_value_pairs,
ballista/core/src/extension.rs:293).

TPU-native additions live under `ballista.tpu.*` (engine selection, shape
bucketing, device-memory budget) — these are the knobs the reference never
needed because CPU engines don't recompile per shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ballista_tpu_torch.errors import ConfigurationError

# -- keys (reference: core/src/config.rs:32-160) ----------------------------

JOB_NAME = "ballista.job.name"
DEFAULT_SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
SHUFFLE_COMPRESSION_CODEC = "ballista.shuffle.compression.codec"
SHUFFLE_READER_MAX_REQUESTS = "ballista.shuffle.reader.max.requests"
SHUFFLE_READER_MAX_PER_ADDR = "ballista.shuffle.reader.max.requests.per.address"
SHUFFLE_READER_MAX_BYTES = "ballista.shuffle.reader.max.inflight.bytes"
SHUFFLE_READER_FORCE_REMOTE = "ballista.shuffle.reader.force_remote_read"
SHUFFLE_BLOCK_TRANSPORT = "ballista.shuffle.block.transport"
SHUFFLE_FETCH_COALESCE = "ballista.shuffle.fetch.coalesce"
SHUFFLE_MMAP = "ballista.shuffle.mmap.enabled"
SHUFFLE_CHECKSUM_ENABLED = "ballista.shuffle.checksum.enabled"
SORT_SHUFFLE_ENABLED = "ballista.shuffle.sort.enabled"
SORT_SHUFFLE_MEMORY_LIMIT = "ballista.shuffle.sort.memory.limit"
SORT_SHUFFLE_POOL_WAIT_S = "ballista.shuffle.sort.memory.wait.seconds"
BROADCAST_JOIN_THRESHOLD = "ballista.optimizer.broadcast.join.threshold.bytes"
BROADCAST_JOIN_ROWS_THRESHOLD = "ballista.optimizer.broadcast.join.threshold.rows"
BROADCAST_SEMI_KEYS_THRESHOLD = "ballista.optimizer.broadcast.semi.keys.threshold.rows"
MAX_PARTITIONS_PER_TASK = "ballista.scheduler.max_partitions_per_task"
JOB_RESUBMIT_INTERVAL_MS = "ballista.scheduler.job.resubmit.interval.ms"
# scheduler scale-out: sharded event loops + direct-dispatch leases
SCHEDULER_SHARDS = "ballista.scheduler.shards"
SCHEDULER_LEASE_ENABLED = "ballista.scheduler.lease.enabled"
SCHEDULER_LEASE_TTL_S = "ballista.scheduler.lease.ttl.seconds"
SCHEDULER_LEASE_SLOTS = "ballista.scheduler.lease.slots"
SCHEDULER_LEASE_BAND_SIZE = "ballista.scheduler.lease.band.size"
PLANNER_ADAPTIVE_ENABLED = "ballista.planner.adaptive.enabled"
AQE_TARGET_PARTITION_BYTES = "ballista.planner.adaptive.coalesce.target.bytes"
AQE_MIN_PARTITION_BYTES = "ballista.planner.adaptive.coalesce.min.bytes"
AQE_COALESCE_MERGED_FACTOR = "ballista.planner.adaptive.coalesce.merged.factor"
AQE_EMPTY_PROPAGATION = "ballista.planner.adaptive.empty.propagation"
AQE_DYNAMIC_JOIN_SELECTION = "ballista.planner.adaptive.join.selection"
AQE_ALTER_FANOUT = "ballista.planner.adaptive.alter.fanout"
AQE_JOIN_HEDGE_FACTOR = "ballista.planner.adaptive.join.hedge.factor"
# AQE skew defense: hot reduce partitions split into slice tasks
AQE_SKEW_ENABLED = "ballista.aqe.skew.enabled"
AQE_SKEW_FACTOR = "ballista.aqe.skew.factor"
AQE_SKEW_MIN_BYTES = "ballista.aqe.skew.min.bytes"
AQE_SKEW_MAX_SLICES = "ballista.aqe.skew.max.slices"
GRPC_CLIENT_MAX_MESSAGE_SIZE = "ballista.grpc.client.max.message.size.bytes"
GRPC_SERVER_MAX_MESSAGE_SIZE = "ballista.grpc.server.max.message.size.bytes"
FLIGHT_PROXY = "ballista.client.flight.proxy"
CLIENT_JOB_TIMEOUT_S = "ballista.client.job.timeout.seconds"
PUSH_STATUS = "ballista.client.push.status"
GRPC_TLS_CA = "ballista.grpc.tls.ca.path"
GRPC_TLS_CERT = "ballista.grpc.tls.cert.path"
GRPC_TLS_KEY = "ballista.grpc.tls.key.path"
IO_RETRIES = "ballista.io.retries.times"
IO_RETRY_WAIT_MS = "ballista.io.retry.wait.time.ms"
# overload protection: scheduler admission control + load shedding
ADMISSION_ENABLED = "ballista.admission.enabled"
ADMISSION_MAX_PENDING_JOBS = "ballista.admission.max.pending.jobs"
ADMISSION_MAX_INFLIGHT_PER_SESSION = "ballista.admission.max.inflight.per.session"
ADMISSION_SHED_DEPTH = "ballista.admission.shed.queue.depth"
ADMISSION_DRAIN_DEPTH = "ballista.admission.drain.queue.depth"
ADMISSION_SHED_LOOP_LAG_S = "ballista.admission.shed.loop.lag.seconds"
ADMISSION_SHED_MEMORY_PRESSURE = "ballista.admission.shed.memory.pressure"
ADMISSION_MIN_RETRY_AFTER_MS = "ballista.admission.min.retry.after.ms"
ADMISSION_INTERACTIVE_MAX_PENDING = "ballista.admission.interactive.max.pending.jobs"
# high-QPS serving tier: plan cache / prepared statements / result cache /
# short-query fast lane
SERVING_PLAN_CACHE = "ballista.serving.plan.cache.enabled"
SERVING_PLAN_CACHE_ENTRIES = "ballista.serving.plan.cache.max.entries"
SERVING_RESULT_CACHE = "ballista.serving.result.cache.enabled"
SERVING_RESULT_CACHE_ENTRIES = "ballista.serving.result.cache.max.entries"
SERVING_RESULT_CACHE_BYTES = "ballista.serving.result.cache.max.bytes"
SERVING_RESULT_MAX_BYTES = "ballista.serving.result.cache.max.result.bytes"
SERVING_FAST_LANE = "ballista.serving.fast.lane.enabled"
SERVING_FAST_LANE_TIMEOUT_S = "ballista.serving.fast.lane.timeout.seconds"
# streaming ingestion + incremental maintenance (docs/streaming.md)
SERVING_INCREMENTAL = "ballista.serving.incremental.enabled"
SERVING_INCREMENTAL_STATE_ENTRIES = "ballista.serving.incremental.state.max.entries"
SERVING_INCREMENTAL_STATE_BYTES = "ballista.serving.incremental.state.max.bytes"
SERVING_SUBSCRIPTION_QUEUE = "ballista.serving.incremental.subscription.queue.depth"
INGEST_DELTA_RETAIN_BYTES = "ballista.ingest.delta.retained.max.bytes"
INGEST_DELTA_RETAIN_VERSIONS = "ballista.ingest.delta.retained.max.versions"
INGEST_COMPACTION_DIR = "ballista.ingest.compaction.dir"
# overload protection: Flight data plane
FLIGHT_MAX_STREAMS = "ballista.flight.max.streams"
FLIGHT_ACCEPT_QUEUE = "ballista.flight.accept.queue.depth"
FLIGHT_STALL_TIMEOUT_S = "ballista.flight.stream.stall.timeout.seconds"
FLIGHT_BREAKER_THRESHOLD = "ballista.flight.breaker.failure.threshold"
FLIGHT_BREAKER_COOLDOWN_S = "ballista.flight.breaker.cooldown.seconds"
# overload protection: client backoff
CLIENT_SUBMIT_RETRIES = "ballista.client.submit.max.retries"
CLIENT_BACKOFF_BASE_MS = "ballista.client.backoff.base.ms"
CLIENT_BACKOFF_MAX_MS = "ballista.client.backoff.max.ms"
CHAOS_ENABLED = "ballista.chaos.enabled"
CHAOS_SEED = "ballista.chaos.seed"
CHAOS_PROBABILITY = "ballista.chaos.probability"
CHAOS_MODE = "ballista.chaos.mode"
CHAOS_STRAGGLER_DELAY_S = "ballista.chaos.straggler.delay.seconds"
CHAOS_STRAGGLER_PARTITION = "ballista.chaos.straggler.partition"
CHAOS_STRAGGLER_STAGE = "ballista.chaos.straggler.stage"
CHAOS_SKEW_FRACTION = "ballista.chaos.skew.fraction"
CHAOS_DAEMON_ARM = "ballista.chaos.daemon.arm"
CHAOS_DAEMON_ONCE = "ballista.chaos.daemon.once"
CHAOS_DISK_ONCE = "ballista.chaos.disk.once"
# straggler defense (speculation / deadlines)
SPECULATION_ENABLED = "ballista.scheduler.speculation.enabled"
SPECULATION_QUANTILE = "ballista.scheduler.speculation.quantile"
SPECULATION_MULTIPLIER = "ballista.scheduler.speculation.multiplier"
SPECULATION_MIN_RUNTIME_S = "ballista.scheduler.speculation.min.runtime.seconds"
TASK_DEADLINE_S = "ballista.scheduler.task.deadline.seconds"
TASK_DEADLINE_MULTIPLIER = "ballista.scheduler.task.deadline.multiplier"
COLLECT_STATISTICS = "ballista.collect_statistics"
TARGET_PARTITIONS = "ballista.target.partitions"
BATCH_SIZE = "ballista.batch.size"
REPARTITION_JOINS = "ballista.repartition.joins"
REPARTITION_AGGREGATIONS = "ballista.repartition.aggregations"
PARQUET_PRUNING = "ballista.parquet.pruning"
EXECUTOR_ENGINE = "ballista.executor.engine"
EXECUTOR_TASK_ISOLATION = "ballista.executor.task.isolation"
# executor lifecycle & storage failure domain (docs/lifecycle.md)
EXECUTOR_DISK_LOW_WATERMARK = "ballista.executor.disk.low.watermark"
EXECUTOR_DISK_HIGH_WATERMARK = "ballista.executor.disk.high.watermark"
EXECUTOR_DATA_TTL_S = "ballista.executor.data.ttl.seconds"
EXECUTOR_DRAIN_TIMEOUT_S = "ballista.executor.drain.timeout.seconds"
# TPU-native knobs
TPU_SHAPE_BUCKETS = "ballista.tpu.shape.buckets"
TPU_MAX_DEVICE_BYTES = "ballista.tpu.max.device.bytes"
TPU_HASH_TABLE_LOAD = "ballista.tpu.hash.table.load.factor"
TPU_ALLOW_F32_MONEY = "ballista.tpu.allow.f32.money"
TPU_MIN_ROWS = "ballista.tpu.min.rows"
TPU_BROADCAST_JOIN_ROWS = "ballista.tpu.broadcast.join.threshold.rows"
TPU_COLLECTIVE_EXCHANGE = "ballista.tpu.collective.exchange"
TPU_PALLAS = "ballista.tpu.pallas.enabled"
# whole-stage fusion (stage_compiler fusion planner + cost model)
TPU_FUSION_ENABLED = "ballista.tpu.fusion.enabled"
TPU_FUSION_MODE = "ballista.tpu.fusion.mode"
TPU_FUSION_MIN_ROWS = "ballista.tpu.fusion.min.rows"
TPU_FUSION_PALLAS_MAX_GROUPS = "ballista.tpu.fusion.pallas.max.groups"
TPU_FUSION_PALLAS_MAX_PROBE = "ballista.tpu.fusion.pallas.max.probe.rows"
# on-device sort / window / top-k stage family
TPU_SORT_ENABLED = "ballista.tpu.sort.enabled"
TPU_SORT_PALLAS_MAX_ROWS = "ballista.tpu.sort.pallas.max.rows"
TPU_TOPK_ENABLED = "ballista.tpu.topk.enabled"
TPU_TOPK_MAX_K = "ballista.tpu.topk.max.k"
# cold-path pipeline (fill/compile overlap + persistent XLA compile cache)
TPU_FILL_THREADS = "ballista.tpu.fill.threads"
TPU_FILL_CHUNK_ROWS = "ballista.tpu.fill.chunk_rows"
TPU_COMPILE_OVERLAP = "ballista.tpu.compile.overlap"
TPU_COMPILE_CACHE_DIR = "ballista.tpu.compile.cache_dir"
# out-of-core execution (HBM-budgeted admission, host spill, grace fallback)
TPU_HBM_BUDGET_BYTES = "ballista.tpu.hbm.budget.bytes"
TPU_HBM_BUDGET_FRACTION = "ballista.tpu.hbm.budget.fraction"
TPU_HBM_SPILL_ENABLED = "ballista.tpu.hbm.spill.enabled"
TPU_HBM_SPILL_HOST_BYTES = "ballista.tpu.hbm.spill.host.bytes"
TPU_HBM_SPILL_DIR = "ballista.tpu.hbm.spill.dir"
TPU_HBM_GRACE_BUCKETS = "ballista.tpu.hbm.grace.buckets"
TPU_HBM_GRACE_DEPTH = "ballista.tpu.hbm.grace.max.depth"
# mesh-wide stage execution (planner mesh merge + on-device all_to_all exchange)
TPU_MESH_ENABLED = "ballista.tpu.mesh.enabled"
TPU_MESH_DEVICES = "ballista.tpu.mesh.devices"
TPU_MESH_EXCHANGE_CAPACITY = "ballista.tpu.mesh.exchange.capacity.rows"
TPU_MESH_MIN_ROWS = "ballista.tpu.mesh.min.rows"
TPU_MESH_MAX_INPUT_BYTES = "ballista.tpu.mesh.max.input.bytes"
# warm device-runtime daemon (ballista_tpu_torch/device_daemon/)
TPU_DAEMON_ENABLED = "ballista.tpu.daemon.enabled"
TPU_DAEMON_SOCKET = "ballista.tpu.daemon.socket"
TPU_DAEMON_SPAWN = "ballista.tpu.daemon.spawn"
TPU_DAEMON_ATTACH_TIMEOUT_MS = "ballista.tpu.daemon.attach.timeout.ms"
TPU_DAEMON_SESSION_QUOTA_BYTES = "ballista.tpu.daemon.session.hbm.quota.bytes"
TPU_DAEMON_EXECUTE_TIMEOUT_S = "ballista.tpu.daemon.execute.timeout.s"
TPU_DAEMON_POISON_TTL_S = "ballista.tpu.daemon.poison.ttl.s"
# debug verifiers
DEBUG_PLAN_VERIFY = "ballista.debug.plan.verify"


@dataclass(frozen=True)
class ConfigEntry:
    """One typed config key (reference: ConfigEntry, config.rs:403)."""

    name: str
    description: str
    ty: type  # bool | int | float | str
    default: Any
    validator: Callable[[Any], bool] | None = None
    choices: tuple[str, ...] | None = None

    def parse(self, raw: Any) -> Any:
        try:
            if self.ty is bool:
                if isinstance(raw, bool):
                    v: Any = raw
                else:
                    s = str(raw).strip().lower()
                    if s not in ("true", "false", "1", "0"):
                        raise ValueError(s)
                    v = s in ("true", "1")
            else:
                v = self.ty(raw)
        except (ValueError, TypeError):
            raise ConfigurationError(
                f"invalid value {raw!r} for {self.name} (expected {self.ty.__name__})"
            ) from None
        if self.choices is not None and v not in self.choices:
            raise ConfigurationError(
                f"invalid value {v!r} for {self.name}; expected one of {self.choices}"
            )
        if self.validator is not None and not self.validator(v):
            raise ConfigurationError(f"value {v!r} out of range for {self.name}")
        return v


def _env_bool(name: str, default: bool) -> bool:
    """Escape-hatch defaults: data-plane optimizations (mmap serving, fetch
    coalescing) default ON but can be killed fleet-wide with an env var on
    the affected host — no session-config change required. The Flight
    server, which never sees a session config, consults the same vars."""
    import os

    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


def _env_int(name: str, default: int) -> int:
    """Integer escape hatch for daemons with no session config (Flight
    server, admission control on a shared scheduler)."""
    import os

    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    import os

    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_str(name: str, default: str) -> str:
    import os

    return os.environ.get(name, default)


def _pos(v: Any) -> bool:
    return v > 0


def _nonneg(v: Any) -> bool:
    return v >= 0


_ENTRIES: list[ConfigEntry] = [
    ConfigEntry(JOB_NAME, "Human-readable job name shown in the UI/REST API.", str, ""),
    ConfigEntry(DEFAULT_SHUFFLE_PARTITIONS, "Output partition count for hash repartitions.", int, 16, _pos),
    ConfigEntry(
        SHUFFLE_COMPRESSION_CODEC,
        "IPC compression for shuffle files and Flight streams.",
        str, "lz4", choices=("none", "lz4", "zstd"),
    ),
    ConfigEntry(SHUFFLE_READER_MAX_REQUESTS, "Reduce-side fetch governor: max concurrent fetch requests.", int, 64, _pos),
    ConfigEntry(SHUFFLE_READER_MAX_PER_ADDR, "Reduce-side fetch governor: max concurrent fetches per executor address.", int, 8, _pos),
    ConfigEntry(SHUFFLE_READER_MAX_BYTES, "Reduce-side fetch governor: in-flight byte budget.", int, 256 * 1024 * 1024, _pos),
    ConfigEntry(SHUFFLE_READER_FORCE_REMOTE, "Testing: fetch shuffle partitions over Flight even when local.", bool, False),
    ConfigEntry(SHUFFLE_BLOCK_TRANSPORT, "Fetch remote shuffle partitions as raw 8 MiB IPC blocks (no decode/re-encode).", bool, True),
    ConfigEntry(SHUFFLE_FETCH_COALESCE, "Coalesce a reduce task's fetches: all map outputs owned by one executor stream back in a single RPC (M small RPCs become one per executor). Env escape hatch: BALLISTA_SHUFFLE_COALESCE=0.", bool, _env_bool("BALLISTA_SHUFFLE_COALESCE", True)),
    ConfigEntry(SHUFFLE_MMAP, "Serve and read shuffle files through memory maps (zero-copy buffer slices instead of seek+read copies). Env escape hatch: BALLISTA_SHUFFLE_MMAP=0 (also honored by the Flight server, which has no session config).", bool, _env_bool("BALLISTA_SHUFFLE_MMAP", True)),
    ConfigEntry(SHUFFLE_CHECKSUM_ENABLED, "End-to-end shuffle integrity: writers record a checksum per output-partition byte range (hash layout: .crc sidecar; sort layout: 5th index-entry field), Flight servers ship it in per-location headers, and readers verify the received bytes BEFORE decoding. A mismatch retries the fetch once in place, then escalates as FetchFailed(cause=corruption) so the upstream stage recomputes and the serving executor takes a corruption strike. Disabling only stops WRITING checksums — readers always verify when a stored value is present. Env escape hatch: BALLISTA_SHUFFLE_CHECKSUM=0 (also honored by the Flight server, which has no session config).", bool, _env_bool("BALLISTA_SHUFFLE_CHECKSUM", True)),
    ConfigEntry(SORT_SHUFFLE_ENABLED, "Use sort-based shuffle (M consolidated bucket files + index) for hash repartitions.", bool, True),
    ConfigEntry(SORT_SHUFFLE_MEMORY_LIMIT, "Bytes of buffered batches before sort-shuffle spills (0 = unlimited).", int, 256 * 1024 * 1024, _nonneg),
    ConfigEntry(SORT_SHUFFLE_POOL_WAIT_S, "How long a writer with nothing left to spill blocks for session-pool headroom before overcommitting (liveness backstop).", float, 10.0, _nonneg),
    ConfigEntry(BROADCAST_JOIN_THRESHOLD, "Max build-side bytes to lower a join to a broadcast exchange.", int, 10 * 1024 * 1024, _nonneg),
    ConfigEntry(BROADCAST_JOIN_ROWS_THRESHOLD, "Max build-side rows to lower a join to a broadcast exchange.", int, 1_000_000, _nonneg),
    ConfigEntry(BROADCAST_SEMI_KEYS_THRESHOLD, "Max build-side rows to collect a filterless semi/anti join's membership keys instead of co-partitioning (the build ships join keys only, so the collect threshold relaxes past the row-broadcast one).", int, 8_000_000, _nonneg),
    ConfigEntry(MAX_PARTITIONS_PER_TASK, "Group up to N partitions into one task (partition slices).", int, 1, _pos),
    ConfigEntry(JOB_RESUBMIT_INTERVAL_MS, "Periodically re-offer jobs holding runnable-but-unscheduled tasks (0 = off; offers otherwise fire on task/executor events only).", int, 0, _nonneg),
    ConfigEntry(SCHEDULER_SHARDS, "Scheduler event-loop shards: jobs partition by crc32(job_id) mod N, each shard running its own event loop and admission-lag EWMA.", int, 1, _pos),
    ConfigEntry(SCHEDULER_LEASE_ENABLED, "Direct-dispatch leases: mint revocable executor capacity slices so prepared-statement clients can skip the scheduler on the hot path.", bool, False),
    ConfigEntry(SCHEDULER_LEASE_TTL_S, "Direct-dispatch lease lifetime; expired tokens are rejected at the executor and swept by the scheduler.", float, 30.0, _pos),
    ConfigEntry(SCHEDULER_LEASE_SLOTS, "Executor task slots reserved per direct-dispatch lease (taken out of the shared slot ledger).", int, 2, _pos),
    ConfigEntry(SCHEDULER_LEASE_BAND_SIZE, "Task ids reserved per lease; direct-dispatch ids live in a private band above all scheduler-assigned ids.", int, 10_000, _pos),
    ConfigEntry(PLANNER_ADAPTIVE_ENABLED, "Adaptive query execution: replan remaining stages with runtime stats.", bool, True),
    ConfigEntry(AQE_TARGET_PARTITION_BYTES, "AQE coalescing: target bytes per post-shuffle partition.", int, 64 * 1024 * 1024, _pos),
    ConfigEntry(AQE_MIN_PARTITION_BYTES, "AQE coalescing: never coalesce below this size.", int, 1024 * 1024, _pos),
    ConfigEntry(AQE_COALESCE_MERGED_FACTOR, "AQE coalescing: merged-partition slack factor.", float, 1.2, _pos),
    ConfigEntry(AQE_EMPTY_PROPAGATION, "AQE: prune stages proven empty by runtime stats.", bool, True),
    ConfigEntry(AQE_DYNAMIC_JOIN_SELECTION, "AQE: choose join strategy at runtime from actual input sizes.", bool, True),
    ConfigEntry(AQE_ALTER_FANOUT, "AQE: shrink a resolving stage's hash fan-out when observed input volume proves the planned bucket count too high.", bool, True),
    ConfigEntry(
        AQE_JOIN_HEDGE_FACTOR,
        "AQE join hedging: a join whose build-side row ESTIMATE lands within "
        "this factor of the broadcast row threshold (estimate * factor > "
        "threshold) is too close to call at plan time, so the planner keeps "
        "the partitioned layout with a deferred DynamicJoinSelectionExec "
        "carrying the broadcast preference. Runtime bytes then decide both "
        "ways: a build that finishes tiny is promoted to CollectLeft (with "
        "probe-shuffle elision when it finishes first), one that comes in "
        "oversized is DEMOTED to the partitioned join the hedge preserved. "
        "0 disables hedging (estimates commit broadcast statically, the "
        "pre-hedge behavior).",
        float, 4.0, _nonneg,
    ),
    ConfigEntry(
        AQE_SKEW_ENABLED,
        "AQE skew defense: split a hot reduce partition into K slice tasks "
        "at stage resolution when its observed bytes exceed both the "
        "median-multiple factor and the bytes floor.",
        bool, True,
    ),
    ConfigEntry(
        AQE_SKEW_FACTOR,
        "AQE skew defense: a reduce partition is hot when its combined input "
        "bytes exceed factor * median(partition bytes).",
        float, 4.0, lambda v: v >= 1.0,
    ),
    ConfigEntry(
        AQE_SKEW_MIN_BYTES,
        "AQE skew defense: never split a partition below this byte size "
        "(splitting tiny skew trades task overhead for nothing).",
        int, 16 * 1024 * 1024, _pos,
    ),
    ConfigEntry(
        AQE_SKEW_MAX_SLICES,
        "AQE skew defense: hard cap on the slice tasks one hot partition "
        "splits into (the actual count is ceil(bytes/coalesce-target) "
        "clamped here and to the partition's map-output count).",
        int, 8, lambda v: v >= 2,
    ),
    ConfigEntry(GRPC_CLIENT_MAX_MESSAGE_SIZE, "Client-side gRPC message ceiling.", int, 256 * 1024 * 1024, _pos),
    ConfigEntry(CLIENT_JOB_TIMEOUT_S, "How long a client waits for a submitted job before giving up.", int, 600, _pos),
    ConfigEntry(GRPC_SERVER_MAX_MESSAGE_SIZE, "Server-side gRPC message ceiling.", int, 256 * 1024 * 1024, _pos),
    ConfigEntry(
        FLIGHT_PROXY,
        "Scheduler Flight proxy address (host:port). When set, result "
        "partitions are fetched through the scheduler instead of directly "
        "from executors (for clients that cannot reach executors).",
        str, "",
    ),
    ConfigEntry(
        PUSH_STATUS,
        "Use the server-streaming execute_query_push rpc (scheduler pushes "
        "state changes) instead of polling get_job_status.",
        bool, False,
    ),
    ConfigEntry(
        GRPC_TLS_CA,
        "CA certificate (PEM) used to verify gRPC peers; presence turns on "
        "TLS for outbound control-plane channels.",
        str, "",
    ),
    ConfigEntry(
        GRPC_TLS_CERT,
        "This party's certificate chain (PEM) presented on gRPC connections "
        "(mTLS client auth when dialing, server identity when listening).",
        str, "",
    ),
    ConfigEntry(
        GRPC_TLS_KEY,
        "Private key (PEM) matching ballista.grpc.tls.cert.path.",
        str, "",
    ),
    ConfigEntry(IO_RETRIES, "Shuffle fetch retry attempts.", int, 3, _nonneg),
    ConfigEntry(IO_RETRY_WAIT_MS, "Base backoff between shuffle fetch retries.", int, 100, _nonneg),
    ConfigEntry(
        ADMISSION_ENABLED,
        "Scheduler admission control: bound pending jobs and per-session in-flight "
        "quotas, shedding excess submissions with a typed ClusterOverloaded "
        "rejection + retry_after_ms hint instead of queueing without bound. "
        "Env escape hatch: BALLISTA_ADMISSION=0.",
        bool, _env_bool("BALLISTA_ADMISSION", True),
    ),
    ConfigEntry(
        ADMISSION_MAX_PENDING_JOBS,
        "Max jobs queued/planning cluster-wide before new submissions are shed. "
        "Env: BALLISTA_ADMISSION_MAX_PENDING.",
        int, _env_int("BALLISTA_ADMISSION_MAX_PENDING", 256), _pos,
    ),
    ConfigEntry(
        ADMISSION_MAX_INFLIGHT_PER_SESSION,
        "Max non-terminal jobs one session may hold; the quota halves while the "
        "cluster is shedding. Env: BALLISTA_ADMISSION_SESSION_QUOTA.",
        int, _env_int("BALLISTA_ADMISSION_SESSION_QUOTA", 64), _pos,
    ),
    ConfigEntry(
        ADMISSION_SHED_DEPTH,
        "Pending-job depth at which the overload state machine leaves normal for "
        "shedding (quotas halve; hysteresis exits at half this depth). Env: "
        "BALLISTA_ADMISSION_SHED_DEPTH.",
        int, _env_int("BALLISTA_ADMISSION_SHED_DEPTH", 128), _pos,
    ),
    ConfigEntry(
        ADMISSION_DRAIN_DEPTH,
        "Pending-job depth at which shedding escalates to draining: ALL new "
        "submissions are rejected until the backlog drains below the shed depth. "
        "Env: BALLISTA_ADMISSION_DRAIN_DEPTH.",
        int, _env_int("BALLISTA_ADMISSION_DRAIN_DEPTH", 224), _pos,
    ),
    ConfigEntry(
        ADMISSION_SHED_LOOP_LAG_S,
        "Scheduler event-loop lag (post→handle latency) that forces shedding even "
        "with a shallow queue — a wedged loop means depth is lying.",
        float, 2.0, _pos,
    ),
    ConfigEntry(
        ADMISSION_SHED_MEMORY_PRESSURE,
        "Aggregate executor memory-pressure score (0-1, from heartbeats) above "
        "which the scheduler sheds: executors near pool saturation reject tasks "
        "anyway, so admitting more jobs only grows the retry storm.",
        float, 0.9, lambda v: 0.0 < v <= 1.0,
    ),
    ConfigEntry(
        ADMISSION_MIN_RETRY_AFTER_MS,
        "Floor for the retry_after_ms hint carried by ClusterOverloaded "
        "rejections (the drain-rate estimate can be optimistic right after a "
        "burst).",
        int, 100, _nonneg,
    ),
    ConfigEntry(
        ADMISSION_INTERACTIVE_MAX_PENDING,
        "Per-lane admission: max in-flight jobs in the interactive lane (plan-"
        "cache hits known to be single-stage, prepared executions). The batch "
        "lane keeps the global max-pending cap; shedding/draining degrade the "
        "batch lane first so short repeat queries survive a batch overload. "
        "Env: BALLISTA_ADMISSION_INTERACTIVE_MAX_PENDING.",
        int, _env_int("BALLISTA_ADMISSION_INTERACTIVE_MAX_PENDING", 512), _pos,
    ),
    ConfigEntry(
        SERVING_PLAN_CACHE,
        "Serving tier: cache physical-plan templates keyed on the normalized "
        "optimized logical plan (literals lifted to parameters) plus the session "
        "config fingerprint. Repeats of a query shape skip physical planning; "
        "exact-text repeats also skip parsing and optimization. "
        "Env escape hatch: BALLISTA_SERVING_PLAN_CACHE=0.",
        bool, _env_bool("BALLISTA_SERVING_PLAN_CACHE", True),
    ),
    ConfigEntry(
        SERVING_PLAN_CACHE_ENTRIES,
        "Plan-template cache entry cap (LRU). The exact-text L1 cache holds 4x "
        "this many entries. Env: BALLISTA_SERVING_PLAN_ENTRIES.",
        int, _env_int("BALLISTA_SERVING_PLAN_ENTRIES", 256), _pos,
    ),
    ConfigEntry(
        SERVING_RESULT_CACHE,
        "Serving tier: cache final result tables keyed on (normalized plan, "
        "bound parameters, table versions); any re-registration of a referenced "
        "table invalidates by version bump. Results are served inline to "
        "in-process clients only. Off by default: it changes freshness "
        "semantics. Env escape hatch: BALLISTA_SERVING_RESULT_CACHE=1.",
        bool, _env_bool("BALLISTA_SERVING_RESULT_CACHE", False),
    ),
    ConfigEntry(
        SERVING_RESULT_CACHE_ENTRIES,
        "Result cache entry cap (LRU). Env: BALLISTA_SERVING_RESULT_ENTRIES.",
        int, _env_int("BALLISTA_SERVING_RESULT_ENTRIES", 512), _pos,
    ),
    ConfigEntry(
        SERVING_RESULT_CACHE_BYTES,
        "Result cache byte budget across all cached tables (LRU evicts past "
        "it). Env: BALLISTA_SERVING_RESULT_BYTES.",
        int, _env_int("BALLISTA_SERVING_RESULT_BYTES", 64 * 1024 * 1024), _pos,
    ),
    ConfigEntry(
        SERVING_RESULT_MAX_BYTES,
        "Largest single result the cache will hold; bigger results are never "
        "cached (they would evict many small interactive results). Env: "
        "BALLISTA_SERVING_RESULT_MAX_RESULT_BYTES.",
        int, _env_int("BALLISTA_SERVING_RESULT_MAX_RESULT_BYTES", 4 * 1024 * 1024), _pos,
    ),
    ConfigEntry(
        SERVING_FAST_LANE,
        "Serving tier: dispatch single-stage plans straight to warm executors "
        "from the submit path, bypassing the execution-graph/event-loop "
        "machinery; failures and timeouts fall back to the full DAG path. "
        "Env escape hatch: BALLISTA_SERVING_FAST_LANE=0.",
        bool, _env_bool("BALLISTA_SERVING_FAST_LANE", True),
    ),
    ConfigEntry(
        SERVING_FAST_LANE_TIMEOUT_S,
        "Seconds a fast-lane job may run before the straggler sweep demotes it "
        "to the full DAG path (covers executors lost mid-flight, which fast "
        "jobs otherwise would not notice).",
        float, 30.0, _pos,
    ),
    ConfigEntry(
        SERVING_INCREMENTAL,
        "Serving tier: maintain eligible cached results incrementally on "
        "append (delta query over retained appends merged into cached "
        "aggregation state) instead of recomputing from scratch. Ineligible "
        "shapes fall back to full recompute with a recorded reason. "
        "Env escape hatch: BALLISTA_SERVING_INCREMENTAL=0.",
        bool, _env_bool("BALLISTA_SERVING_INCREMENTAL", True),
    ),
    ConfigEntry(
        SERVING_INCREMENTAL_STATE_ENTRIES,
        "Aggregation-state cache entry cap (LRU): one entry per (plan "
        "template, bound values) holds the pre-finisher accumulator rows a "
        "maintained refresh merges deltas into. "
        "Env: BALLISTA_SERVING_INCREMENTAL_STATE_ENTRIES.",
        int, _env_int("BALLISTA_SERVING_INCREMENTAL_STATE_ENTRIES", 256), _pos,
    ),
    ConfigEntry(
        SERVING_INCREMENTAL_STATE_BYTES,
        "Aggregation-state cache byte budget (LRU evicts past it; an evicted "
        "state falls back to bootstrap recompute on the next refresh). "
        "Env: BALLISTA_SERVING_INCREMENTAL_STATE_BYTES.",
        int, _env_int("BALLISTA_SERVING_INCREMENTAL_STATE_BYTES", 64 * 1024 * 1024), _pos,
    ),
    ConfigEntry(
        SERVING_SUBSCRIPTION_QUEUE,
        "Continuous queries: bounded per-subscription push queue depth; when "
        "a slow consumer falls behind, the oldest undelivered refresh is "
        "dropped (freshest-wins) and counted. "
        "Env: BALLISTA_SERVING_SUBSCRIPTION_QUEUE.",
        int, _env_int("BALLISTA_SERVING_SUBSCRIPTION_QUEUE", 32), _pos,
    ),
    ConfigEntry(
        INGEST_DELTA_RETAIN_BYTES,
        "Append ingestion: byte budget for retained per-version delta sets "
        "across all tables. Crossing it folds the oldest deltas into the "
        "table's base version (parquet spool) instead of dropping rows, so "
        "memory cannot grow with append rate. "
        "Env: BALLISTA_INGEST_DELTA_RETAIN_BYTES.",
        int, _env_int("BALLISTA_INGEST_DELTA_RETAIN_BYTES", 64 * 1024 * 1024), _pos,
    ),
    ConfigEntry(
        INGEST_DELTA_RETAIN_VERSIONS,
        "Append ingestion: max retained delta versions per table; older "
        "versions are folded (compacted) into the base. A maintained refresh "
        "older than the fold horizon falls back to full recompute with "
        "reason delta-compacted. Env: BALLISTA_INGEST_DELTA_RETAIN_VERSIONS.",
        int, _env_int("BALLISTA_INGEST_DELTA_RETAIN_VERSIONS", 64), _pos,
    ),
    ConfigEntry(
        INGEST_COMPACTION_DIR,
        "Append ingestion: directory delta compaction spools folded parquet "
        "parts into (empty = a per-scheduler temp dir). "
        "Env: BALLISTA_INGEST_COMPACTION_DIR.",
        str, _env_str("BALLISTA_INGEST_COMPACTION_DIR", ""),
    ),
    ConfigEntry(
        FLIGHT_MAX_STREAMS,
        "Flight data plane: max concurrent do_get/do_action streams per server; "
        "excess callers wait in a bounded accept queue and are then rejected "
        "UNAVAILABLE. Env escape hatch (servers have no session config): "
        "BALLISTA_FLIGHT_MAX_STREAMS.",
        int, _env_int("BALLISTA_FLIGHT_MAX_STREAMS", 64), _pos,
    ),
    ConfigEntry(
        FLIGHT_ACCEPT_QUEUE,
        "Flight data plane: how many callers may wait for a stream slot before "
        "new ones are rejected immediately. Env: BALLISTA_FLIGHT_ACCEPT_QUEUE.",
        int, _env_int("BALLISTA_FLIGHT_ACCEPT_QUEUE", 128), _nonneg,
    ),
    ConfigEntry(
        FLIGHT_STALL_TIMEOUT_S,
        "Flight data plane: a do_get consumer that pulls no batch for this long "
        "is cut off (frees the server-side buffers and the stream slot instead "
        "of wedging on a dead peer). 0 disables. Env: BALLISTA_FLIGHT_STALL_TIMEOUT_S.",
        float, _env_float("BALLISTA_FLIGHT_STALL_TIMEOUT_S", 30.0), _nonneg,
    ),
    ConfigEntry(
        FLIGHT_BREAKER_THRESHOLD,
        "Flight client circuit breaker: consecutive failures to one address that "
        "trip it open (fail-fast, no dial, until a half-open probe succeeds). "
        "0 disables.",
        int, 5, _nonneg,
    ),
    ConfigEntry(
        FLIGHT_BREAKER_COOLDOWN_S,
        "Flight client circuit breaker: seconds an open breaker waits before "
        "allowing one half-open probe.",
        float, 5.0, _pos,
    ),
    ConfigEntry(
        CLIENT_SUBMIT_RETRIES,
        "Max client retries of a shed submission (ClusterOverloaded / "
        "RESOURCE_EXHAUSTED), honoring the server's retry_after_ms hint with "
        "jitter; also bounds retries of idempotent RPCs on UNAVAILABLE.",
        int, 5, _nonneg,
    ),
    ConfigEntry(
        CLIENT_BACKOFF_BASE_MS,
        "Client retry backoff base (exponential, full jitter).",
        int, 100, _pos,
    ),
    ConfigEntry(
        CLIENT_BACKOFF_MAX_MS,
        "Client retry backoff ceiling.",
        int, 10_000, _pos,
    ),
    ConfigEntry(CHAOS_ENABLED, "Fault injection: wrap leaf operators in chaos nodes.", bool, False),
    ConfigEntry(CHAOS_SEED, "Fault injection RNG seed.", int, 0, _nonneg),
    ConfigEntry(CHAOS_PROBABILITY, "Per-task fault probability.", float, 0.05, lambda v: 0.0 <= v <= 1.0),
    ConfigEntry(
        CHAOS_MODE, "Fault kind to inject. 'overload' synthesizes memory "
        "pressure (the hit task overcommits its session pool for the "
        "partition's duration) plus a queue delay — deterministic fuel for "
        "overload-protection tests. 'corrupt' is a SERVE-time fault (seeded "
        "bit-flip as the Flight server streams shuffle bytes, so stored files "
        "stay pristine and a refetch can heal): because the data plane has no "
        "session config, it is armed via env on the executor — "
        "BALLISTA_CHAOS_CORRUPT_P (probability per served range), "
        "BALLISTA_CHAOS_CORRUPT_ONCE=1 (corrupt only the first serve of each "
        "range: deterministic transient corruption), BALLISTA_CHAOS_SEED. "
        "'hbm_oom' exercises the out-of-core TPU path: it deterministically "
        "shrinks the device memory budget the stage compiler admits against "
        "(no plan wrapping — a wrapped scan leaf would hide the stage from "
        "the device compiler), armed via env on the executor — "
        "BALLISTA_CHAOS_HBM_BUDGET (forced budget bytes, default 1 MiB) and "
        "BALLISTA_CHAOS_HBM_OOM_N (additionally raise a synthetic "
        "RESOURCE_EXHAUSTED on the Nth device upload, 0 = never; fires once, "
        "so the evict-spill-retry rung can be observed converging). 'skew' "
        "faults the shuffle-writer PARTITIONER (no plan wrapping): a seeded "
        "fraction of rows — chosen as a pure function of the row's key hash, "
        "so equal keys always co-locate and results stay byte-identical — is "
        "rerouted to one hot reduce partition (ballista.chaos.skew.fraction), "
        "deterministic fuel for the AQE skew-split defense. 'daemon_crash' / "
        "'daemon_hang' fault the device-runtime DAEMON (no plan wrapping — "
        "the fault fires inside the daemon's execute handler, at the arming "
        "point ballista.chaos.daemon.arm): daemon_crash hard-exits the daemon "
        "process (SIGKILL-style, exit 137) so the client's typed "
        "DaemonCrashed → respawn-and-retry → poison-quarantine ladder is "
        "exercised end to end; daemon_hang wedges the execute thread so the "
        "per-request watchdog trips, writes the <socket>.crash.json "
        "post-mortem, and exits 4 (docs/device_daemon.md#failure-domain). "
        "'disk_full' faults the STORAGE path (no plan wrapping): the shuffle "
        "writer's commit points and the spill pool's disk demotions raise a "
        "typed DiskExhausted on a seeded roll keyed by (seed, job, stage, "
        "partition) — with ballista.chaos.disk.once (the default) a hit is "
        "recorded so the retried slice heals, proving an injected ENOSPC "
        "fails no job. 'drain_kill' faults the graceful-drain state machine "
        "(no plan wrapping): armed via env on the scheduler side — "
        "BALLISTA_CHAOS_DRAIN_KILL_AFTER=N aborts a drain's shuffle-output "
        "migration after N committed locations, exercising the hard-kill "
        "fallback to the executor-lost recompute path (docs/lifecycle.md).",
        str, "transient",
        choices=("transient", "fatal", "panic", "delay", "straggler", "overload",
                 "corrupt", "hbm_oom", "skew", "daemon_crash", "daemon_hang",
                 "disk_full", "drain_kill"),
    ),
    ConfigEntry(
        CHAOS_STRAGGLER_DELAY_S,
        "chaos mode=straggler: seconds the straggling partition sleeps before "
        "producing its batches (first task attempt only, so a speculative or "
        "retried attempt escapes the injected delay).",
        float, 5.0, _nonneg,
    ),
    ConfigEntry(
        CHAOS_STRAGGLER_PARTITION,
        "chaos mode=straggler: partition index to delay deterministically "
        "(-1 = pick by seeded per-partition roll against the chaos probability).",
        int, -1, lambda v: v >= -1,
    ),
    ConfigEntry(
        CHAOS_STRAGGLER_STAGE,
        "chaos mode=straggler: restrict injection to this stage id (-1 = every "
        "stage). Partition indices repeat across stages — a shuffle reader in a "
        "single-task final stage drives the same indices the scan did — so "
        "tests that need exactly one straggling task pin the stage too.",
        int, -1, lambda v: v >= -1,
    ),
    ConfigEntry(
        CHAOS_SKEW_FRACTION,
        "chaos mode=skew: approximate fraction of shuffled rows rerouted to "
        "the hot reduce partition (seeded; the hot partition index is "
        "seed % K). Rerouting is keyed on the row's key hash, never on row "
        "position, so both sides of a co-partitioned join skew identically "
        "and query results are unchanged.",
        float, 0.5, lambda v: 0.0 <= v <= 1.0,
    ),
    ConfigEntry(
        CHAOS_DAEMON_ARM,
        "chaos mode=daemon_crash/daemon_hang: the arming point inside the "
        "device daemon's execute handler where the fault fires — "
        "pre_execute (before the plan decodes), mid_execute (holding the "
        "device, before the stage runs), or post_execute (results computed, "
        "reply not yet sent). The session config carries the arming to the "
        "daemon; the executor-side plan is never wrapped "
        "(docs/device_daemon.md#failure-domain).",
        str, "mid_execute",
        lambda v: v in ("pre_execute", "mid_execute", "post_execute"),
    ),
    ConfigEntry(
        CHAOS_DAEMON_ONCE,
        "chaos mode=daemon_crash/daemon_hang: limit the fault to the FIRST "
        "armed request per daemon socket, via a marker file next to the "
        "socket that deliberately survives daemon respawns — so the "
        "respawn-and-retry recovery path succeeds deterministically. False "
        "= every incarnation dies, which exercises the poison-stage "
        "quarantine instead.",
        bool, True,
    ),
    ConfigEntry(
        CHAOS_DISK_ONCE,
        "chaos mode=disk_full: inject the ENOSPC only on the FIRST hit per "
        "(job, stage, partition) slice — the retry of the failed task finds "
        "the recorded marker and heals, modelling transient disk pressure. "
        "False = every attempt re-rolls (the attempt joins the seed key, so "
        "a retry sees different luck).",
        bool, True,
    ),
    ConfigEntry(
        SPECULATION_ENABLED,
        "Launch duplicate attempts of a stage's slowest running tasks once the "
        "stage is mostly complete; the first attempt to finish wins and the "
        "loser is cancelled.",
        bool, True,
    ),
    ConfigEntry(
        SPECULATION_QUANTILE,
        "Fraction of a stage's tasks that must have finished before its "
        "remaining running tasks become speculation candidates.",
        float, 0.75, lambda v: 0.0 < v <= 1.0,
    ),
    ConfigEntry(
        SPECULATION_MULTIPLIER,
        "A running task is speculated when its elapsed runtime exceeds this "
        "multiple of the stage's median completed-task duration.",
        float, 1.5, _pos,
    ),
    ConfigEntry(
        SPECULATION_MIN_RUNTIME_S,
        "Never speculate a task running for less than this many seconds "
        "(guards against duplicating short tasks on noisy timings).",
        float, 1.0, _nonneg,
    ),
    ConfigEntry(
        TASK_DEADLINE_S,
        "Hard per-task deadline floor in seconds (0 = no deadline). The "
        "effective deadline is max(this, multiplier x observed median stage "
        "task duration); the executor aborts the attempt at the deadline and "
        "reports a retryable timeout.",
        float, 0.0, _nonneg,
    ),
    ConfigEntry(
        TASK_DEADLINE_MULTIPLIER,
        "Adaptive deadline: multiple of the stage's median completed-task "
        "duration allowed before a running task is timed out (only once "
        "enough samples exist; 0 disables the adaptive part).",
        float, 0.0, _nonneg,
    ),
    ConfigEntry(COLLECT_STATISTICS, "Collect table statistics at registration.", bool, True),
    ConfigEntry(TARGET_PARTITIONS, "Planner parallelism target (scan partitioning).", int, 8, _pos),
    ConfigEntry(BATCH_SIZE, "Rows per record batch in operator pipelines.", int, 64 * 1024, _pos),
    ConfigEntry(REPARTITION_JOINS, "Insert hash repartitions to parallelize joins.", bool, True),
    ConfigEntry(REPARTITION_AGGREGATIONS, "Insert hash repartitions to parallelize aggregations.", bool, True),
    ConfigEntry(PARQUET_PRUNING, "Prune parquet row groups with min/max statistics.", bool, True),
    ConfigEntry(
        EXECUTOR_ENGINE,
        "Operator engine for query stages: 'tpu' compiles supported subtrees to "
        "XLA with cpu fallback; 'cpu' is Arrow-native.",
        str, "cpu", choices=("cpu", "tpu"),
    ),
    ConfigEntry(
        EXECUTOR_TASK_ISOLATION,
        "Task execution mode: 'process' runs each task in a spawned worker "
        "(true multi-core parallelism, native-crash isolation, preemptive "
        "cancel — DedicatedExecutor parity); 'thread' runs in-process. A "
        "session setting 'process' opts its tasks in on any executor; a "
        "daemon started with --task-isolation process applies it to all "
        "tasks and cannot be opted out per-session. Exception: with "
        "engine=tpu tasks always run in-thread (the spawned worker cannot "
        "share the parent's TPU runtime), and the executor logs a warning "
        "when that downgrades a forced 'process' setting.",
        str, "thread", choices=("thread", "process"),
    ),
    ConfigEntry(
        TPU_SHAPE_BUCKETS,
        "Comma-separated row-count buckets batches are padded to before jit "
        "(bounds XLA recompilation).",
        str, "4096,16384,65536,262144,1048576",
    ),
    ConfigEntry(TPU_MAX_DEVICE_BYTES, "Per-stage HBM budget before falling back to cpu/spill.", int, 12 * 1024**3, _pos),
    ConfigEntry(TPU_HASH_TABLE_LOAD, "Open-addressing hash table load factor for device joins/aggs.", float, 0.5, lambda v: 0.0 < v <= 0.9),
    ConfigEntry(TPU_ALLOW_F32_MONEY, "Allow lossy float32 for decimal columns (faster, inexact).", bool, False),
    ConfigEntry(TPU_MIN_ROWS, "Below this many input rows a stage stays on cpu (compile cost dominates).", int, 8192, _nonneg),
    ConfigEntry(TPU_BROADCAST_JOIN_ROWS, "With engine=tpu: max build-side rows to collect a join build instead of co-partitioning. Device joins probe an HBM-resident sorted build table, so the collect budget is orders of magnitude past the CPU broadcast threshold; a partitioned join hides the chain from the stage compiler entirely.", int, 16_000_000, _nonneg),
    ConfigEntry(
        TPU_PALLAS,
        "Legacy switch predating ballista.tpu.fusion.mode: when true the "
        "fusion cost model requests fused_pallas for every eligible stage "
        "(f32 sums / i32 counts; exact int64 money stays on XLA). Prefer "
        "ballista.tpu.fusion.mode=fused_pallas.",
        bool, False,
    ),
    ConfigEntry(
        TPU_FUSION_ENABLED,
        "Whole-stage fusion in the TPU stage compiler. On, the fusion "
        "planner groups a stage's operator chain into fusible spans "
        "(predicates, projections, join probe+gather, aggregation) and the "
        "cost model picks fused-Pallas / fused-XLA / staged per stage "
        "(RUN_STATS fusion_mode records the choice). Off, every stage "
        "compiles in staged mode when eligible (per-span sub-kernels with "
        "HBM intermediates), else fused-XLA.",
        bool, True,
    ),
    ConfigEntry(
        TPU_FUSION_MODE,
        "Fusion mode override: auto (cost model decides), staged, "
        "fused_xla, or fused_pallas. Forced modes are still clamped to "
        "what the stage supports (the fallback ladder is fused_pallas → "
        "fused_xla → staged-ineligible → fused_xla; RUN_STATS fusion_mode "
        "reports the mode that actually ran).",
        str, "auto", lambda v: v in ("auto", "staged", "fused_xla", "fused_pallas"),
    ),
    ConfigEntry(
        TPU_FUSION_MIN_ROWS,
        "Cost model: below this many total stage input rows the planner "
        "prefers the staged path when the stage is staged-eligible "
        "(per-span dispatch overhead is noise at small sizes and the "
        "span timings feed the roofline taps).",
        int, 4096, _nonneg,
    ),
    ConfigEntry(
        TPU_FUSION_PALLAS_MAX_GROUPS,
        "Cost model / compiler: max group-domain cardinality routed to the "
        "Pallas hash-aggregate kernel (multi-tile one-hot accumulation). "
        "Hard kernel ceiling is 4096 lanes; larger domains use the "
        "fused-XLA sorted segmented reduction.",
        int, 4096, _pos,
    ),
    ConfigEntry(
        TPU_FUSION_PALLAS_MAX_PROBE,
        "Cost model / compiler: max direct-mode build table entries routed "
        "to the Pallas hash-probe kernel (the key→row table must fit "
        "VMEM-resident per block). Larger tables probe via the XLA gather.",
        int, 1 << 18, _pos,
    ),
    ConfigEntry(
        TPU_SORT_ENABLED,
        "On-device sort / window / top-k stage family: when true the TPU "
        "engine wraps eligible SortExec and WindowExec subtrees so ORDER "
        "BY, window-aggregate, and ORDER BY ... LIMIT stages compute their "
        "ordering permutation on device over the int64 lane encoding "
        "(results stay byte-identical to the CPU engine; ineligible shapes "
        "decline with a recorded reason and run on the host).",
        bool, True,
    ),
    ConfigEntry(
        TPU_SORT_PALLAS_MAX_ROWS,
        "Cost model: max padded sort lanes (rows rounded up to a power of "
        "two) routed to the Pallas bitonic segmented-sort kernel family. "
        "Larger stages demote to the fused-XLA stable sort with the reason "
        "recorded in fusion_reason.",
        int, 1 << 17, _pos,
    ),
    ConfigEntry(
        TPU_TOPK_ENABLED,
        "Fused top-k for ORDER BY ... LIMIT final stages: select the k "
        "smallest/largest lanes by chunked bitonic folding without ever "
        "materializing the full sorted order. Off (or when the shape is "
        "ineligible), LIMIT stages fall back to full sort + slice and "
        "RUN_STATS sort_full_materializations counts it.",
        bool, True,
    ),
    ConfigEntry(
        TPU_TOPK_MAX_K,
        "Cost model: max LIMIT fetch routed to the fused top-k kernel (the "
        "kept set must stay a small power-of-two chunk per fold round). "
        "Larger fetches use full sort + slice.",
        int, 1024, _pos,
    ),
    ConfigEntry(
        TPU_COLLECTIVE_EXCHANGE,
        "Use ICI collectives (shard_map all_to_all) instead of file shuffle for "
        "co-scheduled intra-slice stages.",
        bool, False,
    ),
    ConfigEntry(
        TPU_HBM_BUDGET_BYTES,
        "Out-of-core admission: per-stage device-memory budget in bytes the "
        "HBM planner admits stage working sets against (probe table + "
        "dictionary LUTs + join build tables). 0 = auto: "
        "ballista.tpu.hbm.budget.fraction of the detected device memory "
        "(jax memory_stats bytes_limit), falling back to "
        "ballista.tpu.max.device.bytes when detection is unavailable "
        "(CPU-jax). Every admission decision lands in RUN_STATS as "
        "hbm_plan / hbm_plan_reason.",
        int, 0, _nonneg,
    ),
    ConfigEntry(
        TPU_HBM_BUDGET_FRACTION,
        "Out-of-core admission: fraction of detected device memory used as "
        "the HBM budget when ballista.tpu.hbm.budget.bytes is 0 (headroom "
        "for XLA scratch and fusion intermediates).",
        float, 0.85, lambda v: 0.0 < v <= 1.0,
    ),
    ConfigEntry(
        TPU_HBM_SPILL_ENABLED,
        "Out-of-core spill: cold DeviceTableCache entries demote to host "
        "buffers (and past the host budget, to attempt-unique tmp+rename "
        "spill files) instead of being dropped, and re-upload transparently "
        "on the next touch. Off, eviction drops the entry and a re-touch "
        "pays the full re-encode + re-upload.",
        bool, True,
    ),
    ConfigEntry(
        TPU_HBM_SPILL_HOST_BYTES,
        "Out-of-core spill: host-buffer budget of the spill pool. Entries "
        "past it demote to the disk tier (npz files written with the CPU "
        "spill pool's tmp+rename discipline). Host-buffer bytes are "
        "split-accounted against the session memory pool's device headroom, "
        "never against the CPU sort-spill budget.",
        int, 2 * 1024**3, _pos,
    ),
    ConfigEntry(
        TPU_HBM_SPILL_DIR,
        "Out-of-core spill: directory for disk-tier spill files. Empty = "
        "the system temp directory. Files are attempt-unique and removed "
        "when their entry is dropped or re-uploaded.",
        str, "",
    ),
    ConfigEntry(
        TPU_HBM_GRACE_BUCKETS,
        "Grace fallback: sub-bucket fan-out per recursion level. When a "
        "hash-join stage's working set exceeds the HBM budget, the build "
        "side is re-split by a secondary hash into this many sub-buckets "
        "per level (buckets^depth total) and the stage kernel runs once per "
        "sub-bucket, sequentially, with probe rows kept in producer order.",
        int, 4, lambda v: v >= 2,
    ),
    ConfigEntry(
        TPU_HBM_GRACE_DEPTH,
        "Grace fallback: max recursion depth of the secondary-hash split "
        "(buckets^depth sub-buckets at the deepest rung). A working set "
        "that still exceeds the budget at this depth demotes the stage to "
        "the CPU engine — the always-correct final rung. 0 disables grace "
        "entirely (over-budget join stages demote straight to CPU).",
        int, 2, _nonneg,
    ),
    ConfigEntry(
        TPU_MESH_ENABLED,
        "Mesh-wide stage execution: the distributed planner merges an "
        "intra-host hash-shuffle producer stage into its single consumer "
        "and ships the merged stage as ONE task spanning the device mesh; "
        "the repartition runs as an on-device all_to_all (MeshExchangeExec) "
        "instead of shuffle files + Flight fetches. Requires "
        "ballista.executor.engine = tpu; stages that don't fit (multiple "
        "consumers, broadcast edges, unsupported dtypes, capacity overflow) "
        "keep or demote to the per-partition path.",
        bool, False,
    ),
    ConfigEntry(
        TPU_MESH_DEVICES,
        "Device-mesh width for mesh-wide stages. 0 = every visible device "
        "(make_mesh raises when fewer cards are visible than asked, and the "
        "exchange demotes to the host split; it never falls back to the "
        "CPU). A mesh below 2 devices demotes the exchange to the host "
        "split.",
        int, 0, _nonneg,
    ),
    ConfigEntry(
        TPU_MESH_EXCHANGE_CAPACITY,
        "Fixed per-(sender, destination) slot capacity of the on-device "
        "all_to_all exchange, in rows. The host-side gate "
        "(require_exchange_capacity) raises ExchangeCapacityExceeded and "
        "demotes the stage when routed rows exceed it — no row is ever "
        "silently truncated.",
        int, 1 << 20, _pos,
    ),
    ConfigEntry(
        TPU_MESH_MIN_ROWS,
        "Below this many producer rows a mesh exchange is not worth the "
        "collective dispatch; the stage demotes to the host split "
        "(mesh_mode_reason = demoted:small-input).",
        int, 0, _nonneg,
    ),
    ConfigEntry(
        TPU_MESH_MAX_INPUT_BYTES,
        "AQE guard: at stage resolution, a mesh exchange whose observed "
        "input stages exceed this many bytes is demoted to the "
        "per-partition path before execution (the fixed-capacity collective "
        "would overflow anyway; skip the wasted dispatch). 0 = no limit.",
        int, 0, _nonneg,
    ),
    ConfigEntry(
        TPU_FILL_THREADS,
        "Host threads encoding scan columns during the device fill. 0 = auto "
        "(pipelined: column k+1 encodes while column k uploads, bounded "
        "in-flight host stacks); 1 = strict serial encode→upload, one column "
        "at a time (the pre-pipeline behavior). Env escape hatch: "
        "BALLISTA_TPU_FILL_THREADS.",
        int, _env_int("BALLISTA_TPU_FILL_THREADS", 0), _nonneg,
    ),
    ConfigEntry(
        TPU_FILL_CHUNK_ROWS,
        "Split each column's [P, N] device upload into row chunks of this "
        "many rows along N: the stack is allocated once on the card and "
        "each [P, chunk] slice is staged through two pinned host buffers "
        "and copied asynchronously, so the host cuts slice k+1 while slice "
        "k streams. 0 = one transfer per column. Ignored under a "
        "collective-exchange mesh (sharded puts stay whole). Env escape "
        "hatch: BALLISTA_TPU_FILL_CHUNK_ROWS.",
        int, _env_int("BALLISTA_TPU_FILL_CHUNK_ROWS", 0), _nonneg,
    ),
    ConfigEntry(
        TPU_COMPILE_OVERLAP,
        "Overlap join build-side preparation with the device table fill: "
        "each join's build side collects, encodes and uploads on a thread "
        "of its own, bound to the executor's card, while the probe table "
        "fills; off, the builds follow the fill one by one. The port "
        "compiles no stage program, so nothing is compiled ahead and "
        "compile_overlap_s stays unset. Env escape hatch: "
        "BALLISTA_TPU_COMPILE_OVERLAP=0.",
        bool, _env_bool("BALLISTA_TPU_COMPILE_OVERLAP", True),
    ),
    ConfigEntry(
        TPU_COMPILE_CACHE_DIR,
        "Directory for JAX's persistent (on-disk) XLA compilation cache. "
        "When set, compiled stage programs survive process restarts: a "
        "re-admitted or redeployed executor fetches its XLA binaries from "
        "disk instead of recompiling (RUN_STATS xla_compile_s ~ 0 on warm "
        "starts). Empty = disabled. Env default: BALLISTA_TPU_COMPILE_CACHE "
        "(also honored by bare runtime users with no session config).",
        str, _env_str("BALLISTA_TPU_COMPILE_CACHE", ""),
    ),
    ConfigEntry(
        TPU_DAEMON_ENABLED,
        "Warm device-runtime daemon: when true, TPU stage execution first "
        "tries to attach to the persistent device daemon "
        "(ballista_tpu_torch/device_daemon/) over its unix socket and ship the "
        "stage there — one long-lived process owns the platform init, the "
        "device table cache, the HBM budget, and the persistent XLA compile "
        "cache, so every attached caller skips the cold init. Attach "
        "failure falls back to the in-process engine with the reason in "
        "RUN_STATS daemon_mode/daemon_mode_reason. Off by default: the "
        "in-process engine is unchanged unless a session opts in.",
        bool, False,
    ),
    ConfigEntry(
        TPU_DAEMON_SOCKET,
        "Unix-domain socket path of the device daemon. Empty = the "
        "per-user default under the system temp dir "
        "(ballista-tpu-daemon-<uid>.sock). The daemon's structured init "
        "probe report lives next to the socket at <socket>.probe.json.",
        str, "",
    ),
    ConfigEntry(
        TPU_DAEMON_SPAWN,
        "Spawn-and-adopt: when attach finds no live daemon, start one "
        "(detached, `python -m ballista_tpu_torch.device_daemon`) and attach to "
        "it instead of falling back in-process. The spawned daemon "
        "outlives the client so later processes warm-attach.",
        bool, False,
    ),
    ConfigEntry(
        TPU_DAEMON_ATTACH_TIMEOUT_MS,
        "Milliseconds the daemon client waits for the socket to accept "
        "and answer a ping before falling back to the in-process engine "
        "(also bounds the spawn-and-adopt wait for the socket to appear).",
        int, 2000, _pos,
    ),
    ConfigEntry(
        TPU_DAEMON_SESSION_QUOTA_BYTES,
        "Per-session HBM quota enforced by the daemon's admission layer: "
        "stages shipped by this session are admitted against "
        "min(ballista.tpu.hbm.budget.*, this quota), so one attached "
        "tenant's working set cannot evict every other session's resident "
        "tables — spill/grace decisions become quota-aware. 0 = no "
        "per-session ceiling.",
        int, 0, _nonneg,
    ),
    ConfigEntry(
        TPU_DAEMON_EXECUTE_TIMEOUT_S,
        "Floor (seconds) of the per-request execute deadline both sides of "
        "the daemon protocol enforce: the client derives the actual bound "
        "from the stage's byte estimate (floor + bytes at a pessimistic "
        "16 MiB/s, capped at 8x the floor — "
        "protocol.derive_execute_timeout_s) and ships it in the request "
        "header; the daemon's watchdog kills the process on overrun with a "
        "post-mortem at <socket>.crash.json (all thread stacks, the "
        "offending request header, rusage) so a wedged XLA call cannot "
        "hold the chip hostage. The client waits slightly longer than the "
        "deadline, so the watchdog's diagnosed kill wins the race.",
        int, 120, _pos,
    ),
    ConfigEntry(
        TPU_DAEMON_POISON_TTL_S,
        "Seconds a stage fingerprint stays in the on-disk poison quarantine "
        "(<socket>.poison.json) after crashing "
        "two daemon incarnations. While quarantined, respawned daemons "
        "refuse the stage and clients demote it straight to the "
        "in-process/CPU ladder (RUN_STATS daemon_failover=poisoned) — no "
        "crash loops. After the TTL the stage may try the daemon again.",
        int, 600, _pos,
    ),
    ConfigEntry(
        EXECUTOR_DISK_LOW_WATERMARK,
        "Low disk-pressure watermark: when the used fraction of the "
        "executor work-dir filesystem (shutil.disk_usage) reaches this "
        "level, the executor SHEDS SPILL ADMISSION — the sort-shuffle "
        "writer stops demoting buffers to disk (falling back to the "
        "in-memory overcommit ladder) and the HBM spill pool keeps cold "
        "entries in the host tier instead of taking the disk tier. "
        "Queries keep running; only optional disk writes stop "
        "(docs/lifecycle.md#watermark-ladder).",
        float, 0.90, lambda v: 0.0 < v <= 1.0,
    ),
    ConfigEntry(
        EXECUTOR_DISK_HIGH_WATERMARK,
        "High disk-pressure watermark: at/above this used fraction the "
        "executor REJECTS NEW TASK ADMISSION with a retryable "
        "DiskExhausted (RESOURCE_EXHAUSTED semantics, riding the overload "
        "machinery) — the scheduler re-pends the slice and the "
        "per-executor disk gauges on the heartbeat steer placement toward "
        "nodes with headroom. Must be >= the low watermark.",
        float, 0.95, lambda v: 0.0 < v <= 1.0,
    ),
    ConfigEntry(
        EXECUTOR_DATA_TTL_S,
        "Orphaned-data GC TTL in seconds: the scheduler's fleet sweep "
        "removes scheduler state AND fans RemoveJobData to every live "
        "executor for jobs that have been terminal (successful / failed / "
        "cancelled) longer than this; the executor-local work-dir sweep "
        "uses the same horizon for job directories no live scheduler "
        "claims. 0 disables the scheduler-driven sweep (the executor "
        "work-dir TTL remains the backstop).",
        int, 6 * 3600, _nonneg,
    ),
    ConfigEntry(
        EXECUTOR_DRAIN_TIMEOUT_S,
        "Graceful-drain budget in seconds: how long a drain waits for the "
        "executor's running tasks to finish before giving up and falling "
        "back to the executor-lost recompute path. The shuffle-output "
        "migration that follows the wait is not itself bounded by this "
        "(a partially migrated drain still saves the migrated stages).",
        float, 30.0, _pos,
    ),
    ConfigEntry(
        DEBUG_PLAN_VERIFY,
        "Run the static plan verifier (analysis/plan_check.py) over every "
        "staged plan at submit time and after each AQE replan, failing the "
        "job with PlanVerificationError on an invariant violation (stage-"
        "boundary schema mismatch, partition-count drift on a shuffle edge, "
        "mesh gating, task-id band collisions) instead of executing a "
        "corrupt DAG. Cheap (pure graph walk, no IO) but off by default; "
        "plan-stability tests run it unconditionally. Env escape hatch: "
        "BALLISTA_PLAN_VERIFY=1.",
        bool, _env_bool("BALLISTA_PLAN_VERIFY", False),
    ),
]

VALID_ENTRIES: dict[str, ConfigEntry] = {e.name: e for e in _ENTRIES}


@dataclass(frozen=True)
class EnvKnob:
    """An environment-only knob: read by a daemon at import/startup time,
    with no session-config equivalent (session config arrives after the
    value is needed — e.g. module-cache sizing, native-lib discovery).
    Registered here so the knob-sync analysis pass can verify every
    BALLISTA_* env read maps to something documented; entries render into
    docs/configs.md alongside the session keys."""

    name: str
    description: str
    ty: type
    default: Any


_ENV_KNOBS: list[EnvKnob] = [
    EnvKnob(
        "BALLISTA_NATIVE_LIB",
        "Explicit path to the native kernels .so (ops/native.py); unset = "
        "discover next to the package, missing = numpy fallback.",
        str, "",
    ),
    EnvKnob(
        "BALLISTA_DEVICE_ORDINAL",
        "Pin this executor's TPU device ordinal (-1 = auto). Read once at "
        "executor startup, before any session config exists.",
        int, -1,
    ),
    EnvKnob(
        "BALLISTA_TPU_COMPILE_CACHE_ENTRIES",
        "Entry cap of the in-process compiled-stage LruDict in the TPU "
        "stage compiler (import-time sizing).",
        int, 64,
    ),
    EnvKnob(
        "BALLISTA_TPU_LUT_CACHE_ENTRIES",
        "Entry cap of the device lookup-table LruDict (dictionary-encoded "
        "string columns) in the TPU stage compiler.",
        int, 256,
    ),
    EnvKnob(
        "BALLISTA_TPU_BUILD_CACHE_ENTRIES",
        "Entry cap of the join build-table LruDict in the TPU stage compiler.",
        int, 32,
    ),
    EnvKnob(
        "BALLISTA_TPU_BUILD_CACHE_BYTES",
        "Byte budget of the join build-table LruDict (HBM-resident arrays).",
        int, 2 * 1024**3,
    ),
    EnvKnob(
        "BALLISTA_TPU_FINAL_CACHE_ENTRIES",
        "Entry cap of the final-stage program LruDict (ops/tpu/final_stage.py).",
        int, 64,
    ),
    EnvKnob(
        "BALLISTA_TPU_DAEMON_INIT_TIMEOUT_S",
        "Per-phase ceiling (seconds) of the device daemon's supervised init "
        "state machine (platform probe → jax.devices() → first compile). A "
        "phase that overruns gets a faulthandler stack snapshot written "
        "into the probe report at <socket>.probe.json, then the daemon "
        "exits — a hung platform claim is diagnosed, never waited out.",
        int, 240,
    ),
    EnvKnob(
        "BALLISTA_CHAOS_DRAIN_KILL_AFTER",
        "chaos mode=drain_kill arming: abort a graceful drain's shuffle-"
        "output migration after this many committed locations (simulating "
        "a hard kill mid-drain; the scheduler falls back to the executor-"
        "lost recompute path). 0 = disarmed. Env-only: the migration runs "
        "in scheduler/launcher context, which has no session config.",
        int, 0,
    ),
    EnvKnob(
        # analysis: ignore[knob-sync] read by bench.py, the JAX package's harness; the port has none yet
        "BALLISTA_BENCH_DAEMON_CHAOS",
        "bench.py opt-in: run dev/daemon_chaos_exercise.py --quick in the "
        "device leg as a sanity probe before the timed iterations (the "
        "daemon failure domain must hold on this machine; divergence fails "
        "the leg). Env-only: bench plumbing, not engine config.",
        bool, False,
    ),
    EnvKnob(
        # analysis: ignore[knob-sync] read by bench.py, the JAX package's harness; the port has none yet
        "BALLISTA_BENCH_LIFECYCLE",
        "bench.py opt-in: run dev/lifecycle_exercise.py --quick (graceful "
        "drain / disk_full / rolling-restart smoke, docs/lifecycle.md) and "
        "record the verdict under lifecycle_smoke in the bench artifact. "
        "Env-only: bench plumbing, not engine config.",
        bool, False,
    ),
    EnvKnob(
        "BALLISTA_TPU_DAEMON_IDLE_TIMEOUT_S",
        "Device daemon self-termination after this many seconds with no "
        "request and no live parent (--parent-pid). 0 = persist forever "
        "(the default: a warm daemon is the point).",
        int, 0,
    ),
]

ENV_KNOBS: dict[str, EnvKnob] = {k.name: k for k in _ENV_KNOBS}

# Keys a remote client may NOT override on the shared daemons
# (reference: restricted-config scrubbing, extension.rs:302).
RESTRICTED_KEYS = frozenset({GRPC_SERVER_MAX_MESSAGE_SIZE})


class BallistaConfig:
    """Validated session config; unknown `ballista.*` keys are rejected,
    other namespaces (e.g. datafusion-style passthrough) are carried opaque.
    """

    def __init__(self, settings: dict[str, Any] | None = None):
        self._settings: dict[str, Any] = {}
        self._extra: dict[str, str] = {}
        for k, v in (settings or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "BallistaConfig":
        entry = VALID_ENTRIES.get(key)
        if entry is not None:
            self._settings[key] = entry.parse(value)
        elif key.startswith("ballista.catalog.") or key.startswith("ballista.udf."):
            # open namespaces: table registrations / UDF module references
            # shipped with the session
            self._extra[key] = str(value)
        elif key.startswith("ballista."):
            raise ConfigurationError(f"unknown config key: {key}")
        else:
            self._extra[key] = str(value)
        return self

    def set_default_if_unset(self, key: str, value: Any) -> None:
        """Apply a host-derived default without overriding an explicit
        session setting (executor-side memory sizing)."""
        if key not in self._settings:
            self.set(key, value)

    def get(self, key: str) -> Any:
        if key in self._settings:
            return self._settings[key]
        entry = VALID_ENTRIES.get(key)
        if entry is not None:
            return entry.default
        return self._extra.get(key)

    def __getitem__(self, key: str) -> Any:
        return self.get(key)

    # -- wire round-trip (reference: extension.rs:293-302) ------------------

    def to_key_value_pairs(self) -> list[tuple[str, str]]:
        out = [(k, _fmt(v)) for k, v in sorted(self._settings.items())]
        out.extend(sorted(self._extra.items()))
        return out

    @classmethod
    def from_key_value_pairs(
        cls, pairs: list[tuple[str, str]], scrub_restricted: bool = False
    ) -> "BallistaConfig":
        cfg = cls()
        for k, v in pairs:
            if scrub_restricted and k in RESTRICTED_KEYS:
                continue
            cfg.set(k, v)
        return cfg

    def copy(self) -> "BallistaConfig":
        c = BallistaConfig()
        c._settings = dict(self._settings)
        c._extra = dict(self._extra)
        return c

    def shape_buckets(self) -> list[int]:
        return sorted(int(x) for x in str(self.get(TPU_SHAPE_BUCKETS)).split(",") if x.strip())

    def __repr__(self) -> str:
        return f"BallistaConfig({self._settings!r})"


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def generate_config_docs() -> str:
    """Docs-as-code: render the registry as markdown
    (reference: core/src/bin/update_config_docs.rs → docs/.../configs.md).
    """
    lines = [
        "# Configuration keys",
        "",
        "<!-- GENERATED FILE — do not edit by hand. -->",
        "<!-- Rendered from the config.py registry by dev/gen_configs.py; -->",
        "<!-- the knob-sync analysis pass fails CI when this file is stale. -->",
        "",
        "All keys are set per-session and shipped with every job as key/value",
        "pairs; executors apply them when building the task's runtime.",
        "",
        "| key | type | default | description |",
        "|-----|------|---------|-------------|",
    ]
    for e in _ENTRIES:
        lines.append(f"| `{e.name}` | {e.ty.__name__} | `{_fmt(e.default)}` | {e.description} |")
    lines.extend([
        "",
        "## Environment-only knobs",
        "",
        "Read by daemons at import/startup time, before any session config",
        "exists; no `ballista.*` equivalent. (Env *escape hatches* for session",
        "keys are documented inline in the table above.)",
        "",
        "| variable | type | default | description |",
        "|----------|------|---------|-------------|",
    ])
    for k in _ENV_KNOBS:
        lines.append(f"| `{k.name}` | {k.ty.__name__} | `{_fmt(k.default)}` | {k.description} |")
    lines.append("")
    return "\n".join(lines)
