"""PyTorch runtime bootstrap for the device engine.

Counterpart of the JAX package's ops/tpu/runtime.py. There, `ensure_jax`
pins the platform and turns on x64. Here the device is chosen
explicitly, and every tensor the engine makes names it:

- the default is the CUDA card (`cuda:0`, or the task's pinned ordinal);
- the CPU is used only after `use_cpu()` asks for it, the way the JAX
  tests pin `JAX_PLATFORMS=cpu`. Without CUDA and without that request,
  `device()` raises: there is no quiet CPU fallback.

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

_lock = threading.Lock()
_cpu_requested = False
_build_dir: str | None = None

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
    with _lock:
        return _cpu_requested


def device(ordinal: int = -1) -> torch.device:
    """The device the engine dispatches to. `ordinal` >= 0 pins a card
    (the task's device ordinal); -1 means card 0. Raises when no card is
    present and the CPU was not asked for."""
    if cpu_requested():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; call "
            "ballista_tpu_torch.ops.cuda.runtime.use_cpu() to run the device "
            "engine on the CPU explicitly")
    n = torch.cuda.device_count()
    idx = ordinal if ordinal is not None and ordinal >= 0 else 0
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
