"""PyTorch runtime bootstrap for the device engine.

Counterpart of the JAX package's ops/tpu/runtime.py. There, `ensure_jax`
pins the platform and turns on x64. Here the device is chosen
explicitly, and every tensor the engine makes names it:

- the default is the CUDA card (`cuda:0`, or the task's pinned ordinal);
- the CPU is used only after `use_cpu()` asks for it, the way the JAX
  tests pin `JAX_PLATFORMS=cpu`, or, in a process that did not call
  `use_cpu()` (an executor daemon started as a subprocess), when the
  environment sets BALLISTA_TORCH_PLATFORM=cpu, the way the reference's
  daemons inherit `JAX_PLATFORMS=cpu`. Any other value, or none, means the
  card. Without CUDA and without either request, `device()` raises: there
  is no quiet CPU fallback.

Binding a process to one card (one executor daemon per card): the daemon
calls `bind_process_ordinal(k)` before anything creates a CUDA context;
it sets CUDA_VISIBLE_DEVICES, so the process sees its card as `cuda:0`,
and `device(k)` resolves to it. The reference also has a dispatch-level
`device_scope`; the port needs none, because every stage already names
its device from the task's ordinal, `runtime.device(ctx.device_ordinal)`
(stage_compiler.py, final_stage.py, sort_window.py), and every tensor it
makes is placed there.

x64 needs no switch: the engine names int64 and float64 wherever the JAX
code relied on x64.

The persistent XLA compile cache becomes the kernel build directory: the
hand-written CUDA kernels (ops/cuda/csrc) are compiled there at first use,
keyed by a hash of their sources.
"""

from __future__ import annotations

import os
import threading

import torch

PLATFORM_ENV = "BALLISTA_TORCH_PLATFORM"

_lock = threading.Lock()
_cpu_requested: bool | None = None  # None: not asked in-process, read PLATFORM_ENV
_bound_ordinal = -1
_build_dir: str | None = None
_cc_counts = {"requests": 0, "hits": 0}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")


def use_cpu(enabled: bool = True) -> None:
    """Explicitly run the device engine on the CPU (tests, small checks).
    The kernels' plain PyTorch versions then run in their place."""
    global _cpu_requested
    with _lock:
        _cpu_requested = bool(enabled)


def cpu_requested() -> bool:
    """True after use_cpu(), or, when use_cpu() was never called, when
    BALLISTA_TORCH_PLATFORM=cpu is set."""
    with _lock:
        if _cpu_requested is not None:
            return _cpu_requested
    return os.environ.get(PLATFORM_ENV, "").strip().lower() == "cpu"


def bind_process_ordinal(ordinal: int) -> bool:
    """Restrict this PROCESS to one card by setting CUDA_VISIBLE_DEVICES.
    Must run before this process creates a CUDA context; returns False (and
    binds nothing) for an ordinal < 0 or when the context already exists.
    The explicit ordinal wins over an inherited value: several daemons on
    one host must never see each other's cards."""
    global _bound_ordinal
    if ordinal is None or ordinal < 0:
        return False
    if torch.cuda.is_initialized():
        return False
    os.environ["CUDA_VISIBLE_DEVICES"] = str(ordinal)
    with _lock:
        _bound_ordinal = int(ordinal)
    return True


def bound_ordinal() -> int:
    """The ordinal this process was bound to, or -1."""
    with _lock:
        return _bound_ordinal


def device(ordinal: int = -1) -> torch.device:
    """The device the engine dispatches to. `ordinal` >= 0 pins a card
    (the task's device ordinal); -1 means card 0. In a process bound to one
    card (bind_process_ordinal) that sees exactly one card, every ordinal
    is that card. Raises when no card is present and the CPU was not asked
    for, and for an ordinal past the visible cards of an unbound process."""
    if cpu_requested():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; call "
            "ballista_tpu_torch.ops.cuda.runtime.use_cpu() to run the device "
            "engine on the CPU explicitly")
    n = torch.cuda.device_count()
    idx = ordinal if ordinal is not None and ordinal >= 0 else 0
    if n == 1 and bound_ordinal() >= 0:
        return torch.device("cuda", 0)
    if idx >= n:
        # never alias a misconfigured ordinal onto another card
        raise ValueError(f"device ordinal {idx} out of range: {n} cards")
    return torch.device("cuda", idx)


def device_kind() -> str:
    """Platform string for the cost model: "cuda" or "cpu"."""
    return device().type


def init_compile_cache(cache_dir: str | None) -> str:
    """Set the kernel build directory (the `ballista.tpu.compile.cache_dir`
    knob, or BALLISTA_TPU_COMPILE_CACHE). Returns the active directory."""
    global _build_dir
    with _lock:
        if cache_dir:
            _build_dir = cache_dir
    return compile_cache_dir()


def compile_cache_dir() -> str:
    """Active kernel build directory (created on first build)."""
    with _lock:
        if _build_dir:
            return _build_dir
    return os.environ.get("BALLISTA_TPU_COMPILE_CACHE") or DEFAULT_BUILD_DIR


def record_kernel_load(hit: bool) -> None:
    """Count one kernel library load (ops/cuda/build.py); `hit` when the
    library was already built in the build directory."""
    with _lock:
        _cc_counts["requests"] += 1
        _cc_counts["hits"] += int(bool(hit))


def compile_cache_stats() -> dict:
    """This process's kernel loads from the build directory: requests =
    loads, hits = loads that found the library built (no nvcc)."""
    with _lock:
        req, hits = _cc_counts["requests"], _cc_counts["hits"]
    return {"dir": compile_cache_dir(), "requests": req, "hits": hits,
            "misses": req - hits}


def process_rusage() -> dict:
    """Resource-usage snapshot of THIS process for post-mortem artifacts
    (the device daemon's crash report): peak RSS and CPU split. Makes no
    CUDA call and never raises: diagnostics must not add failure modes."""
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {
            "max_rss_kb": int(ru.ru_maxrss),
            "user_s": round(ru.ru_utime, 3),
            "system_s": round(ru.ru_stime, 3),
        }
    except Exception:  # noqa: BLE001 — platform without getrusage
        return {}
