"""Out-of-core device execution: the per-stage device memory plan.

Counterpart of the JAX package's ops/tpu/hbm.py. Device memory is a
planned resource, not a crash surface. Three rungs, every decision
recorded in RUN_STATS as `hbm_plan` / `hbm_plan_reason`:

- **admission** (`plan_stage`): before the stage pass, the stage's
  working-set bytes (probe table + dictionary LUTs + join build tables,
  from `fusion.estimate_stage`) are checked against a budget
  (`ballista.tpu.hbm.budget.bytes`, default a fraction of the card's
  memory). Outcomes: `run_whole`, `spill_colds` (the stage fits but cold
  cache residents must demote first), `grace_split`, or `cpu_demote`.
- **spill** (`HostSpillPool`): cold `DeviceTableCache` entries demote to
  host buffers instead of being dropped and re-upload on the next touch;
  past the host budget they demote again to disk files written with the
  shuffle writer's tmp+rename discipline. A device out-of-memory error at
  run time (`is_resource_exhausted`) spills every resident table and
  retries the stage ONCE before demoting it to the CPU engine.
- **grace fallback**: a hash-join working set over budget re-splits the
  build side by a secondary hash of the combined join key (a salted
  splitmix64, independent of the exchange's routing hash) into
  `buckets^depth` sub-buckets run one after another on the card. Probe
  rows are never permuted: each sub-run sees the full [P, N] stacks and a
  probe row matches only in the sub-bucket its key hashes to, so the
  concatenated partial-aggregate outputs are the whole run's partials
  split by bucket, which the final aggregate merges. (Its float sums
  associate per sub-bucket partial, so they may differ from the whole
  run's in the last bits.) Depth is bounded; past the cap the stage
  demotes to the CPU engine.

Everything here is host logic; torch is needed only to read the card's
memory and to classify its out-of-memory error.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import tempfile
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

log = logging.getLogger(__name__)

# secondary-hash salt for grace sub-bucketing. The exchange routes on
# `hash_arrays(keys) % n_devices`; grace buckets on a re-mixed image of the
# combined int64 join key so the two splits stay independent (a partition
# that landed on this card by key hash still spreads across sub-buckets).
GRACE_SALT = 0xA5A5_5A5A_C3C3_3C3C

RUN_WHOLE = "run_whole"
SPILL_COLDS = "spill_colds"
GRACE_SPLIT = "grace_split"
CPU_DEMOTE = "cpu_demote"

# cudaErrorMemoryAllocation: a kernel library call that reports it raises
# DeviceAllocationError
CUDA_ERROR_MEMORY_ALLOCATION = 2


class InjectedResourceExhausted(RuntimeError):
    """Chaos mode hbm_oom's synthetic device OOM. The message carries the
    literal RESOURCE_EXHAUSTED tag so `is_resource_exhausted` classifies it
    exactly like a real one."""


class DeviceAllocationError(RuntimeError):
    """A kernel wrapper's launch reported cudaErrorMemoryAllocation."""


def is_resource_exhausted(exc: BaseException) -> bool:
    """Classify a device-path exception as an out-of-memory condition: the
    RESOURCE_EXHAUSTED tag (chaos, and the reference's XLA status), the
    caching allocator's torch.cuda.OutOfMemoryError, or a kernel wrapper's
    DeviceAllocationError. Nothing else."""
    if isinstance(exc, (InjectedResourceExhausted, DeviceAllocationError,
                        torch.cuda.OutOfMemoryError)):
        return True
    return "RESOURCE_EXHAUSTED" in f"{type(exc).__name__}: {exc}"


# ---------------------------------------------------------------------------
# chaos arming (executor-local; see ballista.chaos.mode = hbm_oom)

_CHAOS_LOCK = threading.Lock()
_CHAOS = {"armed": False, "budget": 0, "oom_n": 0, "puts": 0}


def arm_chaos(budget_bytes: int, oom_n: int = 0) -> None:
    """Arm the hbm_oom chaos override: the resolved budget shrinks to
    `budget_bytes`, and (oom_n > 0) the oom_n-th device upload raises a
    synthetic RESOURCE_EXHAUSTED — once, so the spill+retry rung can be
    observed converging."""
    with _CHAOS_LOCK:
        _CHAOS["armed"] = True
        _CHAOS["budget"] = int(budget_bytes)
        _CHAOS["oom_n"] = int(oom_n)
        _CHAOS["puts"] = 0


def disarm_chaos() -> None:
    with _CHAOS_LOCK:
        _CHAOS["armed"] = False
        _CHAOS["budget"] = 0
        _CHAOS["oom_n"] = 0
        _CHAOS["puts"] = 0


def chaos_budget() -> int:
    """The armed chaos budget, or 0 when chaos is not steering the plan."""
    with _CHAOS_LOCK:
        return _CHAOS["budget"] if _CHAOS["armed"] else 0


def maybe_chaos_oom() -> None:
    """Call on every device upload. When armed with oom_n > 0, the N-th
    upload raises a synthetic RESOURCE_EXHAUSTED exactly once."""
    with _CHAOS_LOCK:
        if not _CHAOS["armed"] or _CHAOS["oom_n"] <= 0:
            return
        _CHAOS["puts"] += 1
        if _CHAOS["puts"] < _CHAOS["oom_n"]:
            return
        _CHAOS["oom_n"] = 0  # fire once: the retry after spill must succeed
    raise InjectedResourceExhausted(
        "RESOURCE_EXHAUSTED: chaos hbm_oom injected device OOM on upload")


# ---------------------------------------------------------------------------
# budget resolution

def detect_device_memory_bytes() -> int:
    """Bytes of memory on the executing card via torch.cuda.mem_get_info
    (0 when the engine runs on the CPU)."""
    from ballista_tpu_torch.ops.cuda import runtime

    dev = runtime.device()
    if dev.type != "cuda":
        return 0
    _free, total = torch.cuda.mem_get_info(dev)
    return int(total)


# per-session device quota (device daemon multi-tenancy): the daemon wraps
# each attached session's stage execution in session_quota(q), and the
# budget resolver clamps to it, so every admission decision below becomes
# quota-aware without the ladder knowing sessions exist.
_QUOTA_TLS = threading.local()


@contextlib.contextmanager
def session_quota(quota_bytes: int):
    """Scope a per-session ceiling over resolve_hbm_budget(). 0 = no
    ceiling. Nests (inner scope wins); thread-local, matching one handler
    thread per request."""
    prev = getattr(_QUOTA_TLS, "quota", 0)
    _QUOTA_TLS.quota = int(quota_bytes)
    try:
        yield
    finally:
        _QUOTA_TLS.quota = prev


def active_session_quota() -> int:
    return int(getattr(_QUOTA_TLS, "quota", 0) or 0)


def resolve_hbm_budget(config) -> int:
    """The per-stage device budget in bytes. Precedence: armed chaos
    override, then the explicit knob, then fraction x detected card memory,
    then fraction x ballista.tpu.max.device.bytes (CPU). An active
    session_quota() clamps whatever the ladder produced, chaos included."""
    from ballista_tpu_torch.config import (
        TPU_HBM_BUDGET_BYTES,
        TPU_HBM_BUDGET_FRACTION,
        TPU_MAX_DEVICE_BYTES,
    )

    def _clamp(budget: int) -> int:
        quota = active_session_quota()
        return max(1, min(budget, quota)) if quota > 0 else budget

    forced = chaos_budget()
    if forced > 0:
        return _clamp(forced)
    explicit = int(config.get(TPU_HBM_BUDGET_BYTES))
    if explicit > 0:
        return _clamp(explicit)
    frac = float(config.get(TPU_HBM_BUDGET_FRACTION))
    base = detect_device_memory_bytes() or int(config.get(TPU_MAX_DEVICE_BYTES))
    return _clamp(max(1, int(base * frac)))


# ---------------------------------------------------------------------------
# OOM hints: a stage that ran out of device memory pre-plans grace on retry

_HINT_LOCK = threading.Lock()
# analysis: ignore[bounded-cache] one hint per retry in flight, drained by consume_oom_hint
_OOM_HINTS: set[str] = set()
# cumulative, process-wide (mirrored into RUN_STATS like the spill
# counters: a later clean re-run of the same stage must not erase the
# evidence that a retry ran)
_OOM_RETRIES = [0]


def note_oom(fingerprint: str) -> None:
    with _HINT_LOCK:
        _OOM_HINTS.add(fingerprint)
        _OOM_RETRIES[0] += 1


def oom_retry_count() -> int:
    with _HINT_LOCK:
        return _OOM_RETRIES[0]


def consume_oom_hint(fingerprint: str) -> bool:
    with _HINT_LOCK:
        if fingerprint not in _OOM_HINTS:
            return False
        _OOM_HINTS.discard(fingerprint)
        return True


# ---------------------------------------------------------------------------
# admission

@dataclass(frozen=True)
class HbmPlan:
    """One stage's admission decision (RUN_STATS hbm_plan/_reason)."""

    decision: str  # run_whole | spill_colds | grace_split | cpu_demote
    reason: str
    budget: int
    working_set: int
    grace_buckets: int = 0  # total sub-buckets (fanout ** depth)
    grace_depth: int = 0
    split_jidx: int = -1  # which join's build side the grace split targets


def plan_stage(est, budget: int, *, grace_eligible: bool, grace_fanout: int,
               grace_max_depth: int, resident_other: int = 0,
               observed_bytes: int = 0, force_grace: bool = False) -> HbmPlan:
    """Admission: check the stage's working-set estimate against the budget.

    `est` is a fusion.StageEstimate carrying table_bytes / dict_bytes /
    build_bytes. `resident_other` is the device-cache residency not owned
    by this stage (cold entries spillable to make room). `observed_bytes`
    is the AQE seam's observed input volume for a resolved or retried
    stage, a floor under the build estimate. `force_grace` is the post-OOM
    hint: the estimate said "fits" once already and the card disagreed."""
    working = int(est.table_bytes) + int(est.dict_bytes) + int(est.build_bytes)
    observed_extra = 0
    if observed_bytes > 0:
        floored = int(est.table_bytes) + int(est.dict_bytes) + int(observed_bytes)
        if floored > working:
            # the AQE seam observed more input than the estimate priced: the
            # excess is build-side data the grace split can partition, so it
            # rides the splittable term, not the fixed one
            observed_extra = floored - working
            working = floored
    if budget <= 0:
        return HbmPlan(RUN_WHOLE, "unbudgeted (hbm budget <= 0)", budget, working)
    over = working > budget or force_grace
    if not over:
        if resident_other > 0 and resident_other + working > budget:
            return HbmPlan(
                SPILL_COLDS,
                f"stage fits ({working} <= {budget} B) but {resident_other} B "
                f"of cold residents must spill to host first",
                budget, working)
        return HbmPlan(RUN_WHOLE, f"working set {working} B <= budget {budget} B",
                       budget, working)
    # over budget: try the grace rung, then the CPU rung. A stage that is
    # only "over" because of the post-OOM hint (its estimate fits; the card
    # disagreed once) prefers grace but re-runs whole when no grace rung
    # exists: the spill freed the card, and that retry is the contract; a
    # second OOM demotes for real.
    nominally_fits = working <= budget
    why = (f"post-OOM pre-plan (estimate {working} B, budget {budget} B)"
           if force_grace and nominally_fits
           else f"working set {working} B > budget {budget} B")
    split = int(est.max_build_bytes)
    if split > 0 and est.max_build_jidx >= 0:
        split += observed_extra
    if not grace_eligible or est.max_build_jidx < 0 or split <= 0:
        if nominally_fits:
            return HbmPlan(RUN_WHOLE, why + "; no grace-splittable inner-join "
                           "build — re-running whole after spill", budget, working)
        return HbmPlan(CPU_DEMOTE, why + "; no grace-splittable inner-join build",
                       budget, working)
    if grace_max_depth <= 0:
        if nominally_fits:
            return HbmPlan(RUN_WHOLE, why + "; grace disabled (max depth 0) — "
                           "re-running whole after spill", budget, working)
        return HbmPlan(CPU_DEMOTE, why + "; grace disabled (max depth 0)",
                       budget, working)
    fixed = working - split
    if fixed > budget:
        return HbmPlan(
            CPU_DEMOTE,
            why + f"; non-splittable bytes ({fixed} B) alone exceed the budget",
            budget, working)
    fanout = max(2, int(grace_fanout))
    for depth in range(1, int(grace_max_depth) + 1):
        buckets = fanout ** depth
        if fixed + -(-split // buckets) <= budget:
            return HbmPlan(
                GRACE_SPLIT,
                why + f"; grace-splitting build {est.max_build_jidx} "
                f"({split} B) into {buckets} sub-buckets (depth {depth})",
                budget, working, grace_buckets=buckets, grace_depth=depth,
                split_jidx=int(est.max_build_jidx))
    return HbmPlan(
        CPU_DEMOTE,
        why + f"; grace depth cap {grace_max_depth} (fanout {fanout}) still "
        f"over budget — demoting to the CPU engine",
        budget, working)


def grace_bucket_of(key_np: np.ndarray, n_buckets: int) -> np.ndarray:
    """Secondary-hash sub-bucket of each combined int64 join key: the
    splitmix64 finalizer (ops/hashing.py, the bit-exact twin of the device
    hash64) over the salted key. Deterministic, engine-independent, and
    independent of the exchange's routing hash."""
    from ballista_tpu_torch.ops.hashing import splitmix64

    salted = key_np.astype(np.int64).view(np.uint64) ^ np.uint64(GRACE_SALT)
    return (splitmix64(salted) % np.uint64(n_buckets)).astype(np.int64)


# ---------------------------------------------------------------------------
# grace verification record (checked by analysis/plan_check.py)

@dataclass
class GraceReport:
    """What a grace-split execution did, checked by plan_check.verify_grace
    after every grace run: the sub-buckets cover the partition, the merge
    kept producer row order, the depth stayed under the cap."""

    stage_tag: str
    n_buckets: int
    fanout: int
    depth: int
    max_depth: int
    buckets_run: list = field(default_factory=list)
    buckets_empty: list = field(default_factory=list)  # empty sub-build: no-op
    # how sub-runs merged: "producer-order" = probe rows were never permuted
    # (each sub-run masks non-bucket matches in place) and per-partition
    # outputs concatenate in bucket order
    merge: str = "producer-order"


# ---------------------------------------------------------------------------
# host spill pool

_SEQ_LOCK = threading.Lock()
_SEQ = [0]


def _next_seq() -> int:
    with _SEQ_LOCK:
        _SEQ[0] += 1
        return _SEQ[0]


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class SpilledEntry:
    """One demoted cache entry: metadata + either host numpy arrays or a
    disk-tier npz path (never both)."""

    def __init__(self, meta, arrays, nbytes: int, path: str | None = None):
        self.meta = meta  # opaque to the pool; the cache reconstructs from it
        self.arrays = arrays  # list[np.ndarray | None] | None when on disk
        self.nbytes = int(nbytes)
        self.path = path

    @property
    def on_disk(self) -> bool:
        return self.path is not None


class HostSpillPool:
    """Demotion target for cold device-cache entries.

    Two tiers: host buffers up to `max_host_bytes` (LRU), then disk files
    under `spill_dir` written with the shuffle writer's tmp+rename
    discipline (write `<name>.tmp`, then `os.replace`; a crashed writer
    leaves only a .tmp that never shadows a committed file). Counters are
    cumulative gauges mirrored into RUN_STATS by the stage compiler:
    spill_bytes / spill_events / reupload_events."""

    def __init__(self, max_host_bytes: int = 2 * 1024**3, spill_dir: str = ""):
        self.max_host_bytes = int(max_host_bytes)
        self.spill_dir = spill_dir
        self._entries: "collections.OrderedDict[tuple, SpilledEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.host_bytes = 0
        self.spill_bytes = 0  # cumulative bytes demoted (host + disk tiers)
        self.spill_events = 0
        self.reupload_events = 0
        # disk-pressure gate: a callable returning False sheds DISK
        # demotions, so cold entries stay in the host tier (overcommitting
        # it) instead of filling the last of the disk. None = disk allowed.
        self.spill_gate = None

    def configure(self, max_host_bytes: int, spill_dir: str, spill_gate=None) -> None:
        with self._lock:
            self.max_host_bytes = int(max_host_bytes)
            self.spill_dir = spill_dir
            self.spill_gate = spill_gate

    def _disk_tier_allowed(self) -> bool:
        gate = self.spill_gate
        if gate is None:
            return True
        try:
            return bool(gate())
        except Exception:  # noqa: BLE001 — a broken gate must not block demotion
            log.warning("spill gate raised; allowing the disk tier", exc_info=True)
            return True

    def _dir(self) -> str:
        d = self.spill_dir or os.path.join(tempfile.gettempdir(), "ballista-hbm-spill")
        os.makedirs(d, exist_ok=True)
        return d

    def put(self, key: tuple, meta, arrays, nbytes: int) -> None:
        """Demote one entry (host numpy arrays). An entry past the host
        budget goes straight to the disk tier; host-tier overflow demotes
        the coldest host entries to disk too."""
        entry = SpilledEntry(meta, arrays, nbytes)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop_locked(old)
            if nbytes > self.max_host_bytes and self._disk_tier_allowed():
                self._to_disk_locked(key, entry)
            else:
                self.host_bytes += entry.nbytes
                while (self.host_bytes > self.max_host_bytes and
                       self._disk_tier_allowed() and
                       any(not e.on_disk and e is not entry
                           for e in self._entries.values())):
                    ck, cold = next((k, e) for k, e in self._entries.items()
                                    if not e.on_disk)
                    self._entries.pop(ck)
                    self.host_bytes -= cold.nbytes
                    self._to_disk_locked(ck, cold)
            self._entries[key] = entry
            self.spill_bytes += entry.nbytes
            self.spill_events += 1

    def _to_disk_locked(self, key: tuple, entry: SpilledEntry) -> None:
        from ballista_tpu_torch.executor.disk import wrap_enospc

        name = f"hbm-{os.getpid()}-{_next_seq()}-{abs(hash(key)) & 0xFFFFFFFF:08x}.npz"
        path = os.path.join(self._dir(), name)
        live = {f"a{i}": a for i, a in enumerate(entry.arrays) if a is not None}
        mask = [a is not None for a in entry.arrays]
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, __mask__=np.asarray(mask, dtype=bool), **live)
            os.replace(tmp, path)
        except OSError as e:
            _unlink_quiet(tmp)
            typed = wrap_enospc(e, "hbm spill demotion")
            if typed is not None:
                raise typed from e
            raise
        except BaseException:
            _unlink_quiet(tmp)
            raise
        entry.path = path
        entry.arrays = None
        self._entries[key] = entry

    def pop(self, key: tuple):
        """Take a demoted entry for re-upload: returns (meta, arrays) or
        None. The entry (and any disk file) is consumed."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            if not entry.on_disk:
                self.host_bytes -= entry.nbytes
            self.reupload_events += 1
        if not entry.on_disk:
            return entry.meta, entry.arrays
        try:
            with np.load(entry.path) as z:
                mask = z["__mask__"]
                arrays = [z[f"a{i}"] if present else None
                          for i, present in enumerate(mask)]
        finally:
            _unlink_quiet(entry.path)
        return entry.meta, arrays

    def _drop_locked(self, entry: SpilledEntry) -> None:
        if entry.on_disk:
            _unlink_quiet(entry.path)
        else:
            self.host_bytes -= entry.nbytes

    def drop(self, key: tuple) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._drop_locked(entry)

    def clear(self) -> None:
        with self._lock:
            for entry in self._entries.values():
                self._drop_locked(entry)
            self._entries.clear()
            self.host_bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "host_bytes": self.host_bytes,
                "spill_bytes": self.spill_bytes,
                "spill_events": self.spill_events,
                "reupload_events": self.reupload_events,
            }


SPILL_POOL = HostSpillPool()
