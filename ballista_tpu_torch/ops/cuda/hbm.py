"""The per-stage device memory plan (the run-whole rung).

Counterpart of the JAX package's ops/tpu/hbm.py, cut to what the
run-whole rung needs: the budget (`resolve_hbm_budget`, from the
detected card memory) and admission (`plan_stage`). A stage whose
working set fits runs whole; one that does not demotes to the CPU
engine. The spill and grace rungs are not ported yet: where the
reference would spill cold residents or grace-split a join build,
`plan_stage` raises `Unsupported` and the stage runs on the CPU engine.
The chaos hooks stay, so `ballista.chaos.mode=hbm_oom` still shrinks the
budget.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from ballista_tpu_torch.ops.cuda.kernels import Unsupported

RUN_WHOLE = "run_whole"
CPU_DEMOTE = "cpu_demote"


class InjectedResourceExhausted(RuntimeError):
    """Chaos mode hbm_oom's synthetic device OOM. The message carries the
    literal RESOURCE_EXHAUSTED tag so `is_resource_exhausted` classifies it
    exactly like the real XlaRuntimeError."""


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


def resolve_hbm_budget(config) -> int:
    """The per-stage device budget in bytes. Precedence: armed chaos
    override, then the explicit knob, then fraction x detected card memory,
    then fraction x ballista.tpu.max.device.bytes (CPU fallback)."""
    from ballista_tpu_torch.config import (
        TPU_HBM_BUDGET_BYTES,
        TPU_HBM_BUDGET_FRACTION,
        TPU_MAX_DEVICE_BYTES,
    )

    forced = chaos_budget()
    if forced > 0:
        return forced
    explicit = int(config.get(TPU_HBM_BUDGET_BYTES))
    if explicit > 0:
        return explicit
    frac = float(config.get(TPU_HBM_BUDGET_FRACTION))
    base = detect_device_memory_bytes() or int(config.get(TPU_MAX_DEVICE_BYTES))
    return max(1, int(base * frac))


# ---------------------------------------------------------------------------
# admission

@dataclass(frozen=True)
class HbmPlan:
    """One stage's admission decision (RUN_STATS hbm_plan/_reason)."""

    decision: str  # run_whole | cpu_demote
    reason: str
    budget: int
    working_set: int


def plan_stage(est, budget: int, *, grace_eligible: bool,
               resident_other: int = 0) -> HbmPlan:
    """Admission: check the stage's working-set estimate against the budget.

    `est` is a fusion.StageEstimate carrying table_bytes / dict_bytes /
    build_bytes. `resident_other` is the device-cache residency not owned
    by this stage. Where the reference would spill those cold residents
    first (spill_colds), this raises Unsupported; over budget the stage
    demotes to the CPU engine, where the reference would first try to
    grace-split a grace-eligible inner-join build."""
    working = int(est.table_bytes) + int(est.dict_bytes) + int(est.build_bytes)
    if budget <= 0:
        return HbmPlan(RUN_WHOLE, "unbudgeted (hbm budget <= 0)", budget, working)
    if working <= budget:
        if resident_other > 0 and resident_other + working > budget:
            raise Unsupported(
                f"spill_colds: stage fits ({working} <= {budget} B) but "
                f"{resident_other} B of cold residents must spill to host "
                f"first, and the spill rung is not ported")
        return HbmPlan(RUN_WHOLE, f"working set {working} B <= budget {budget} B",
                       budget, working)
    why = f"working set {working} B > budget {budget} B"
    if grace_eligible and est.max_build_jidx >= 0 and est.max_build_bytes > 0:
        why += "; the grace_split rung is not ported"
    else:
        why += "; no grace-splittable inner-join build"
    return HbmPlan(CPU_DEMOTE, why, budget, working)
