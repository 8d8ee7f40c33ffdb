"""What the harness takes from the process around the system under test:
its caches' directories, the card, the kernel counters, and the check that
nothing of JAX or of the JAX package was loaded.

The port's top-level name begins with the JAX package's, so modules are
compared by their whole top-level name (the part before the first dot).
"""

from __future__ import annotations

import os
import sys

from portbench.harness.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "ballista_tpu")


def pin_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's nvcc build directory and, should anything use them, Triton's
    and torch's extension caches."""
    build = os.path.join(root, "build")
    os.environ["BALLISTA_TPU_COMPILE_CACHE"] = os.path.join(build, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package's."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def port_is_from_checkout() -> bool:
    """The port imported is the one in the harness's own checkout."""
    import ballista_tpu_torch

    return os.path.abspath(ballista_tpu_torch.__file__).startswith(os.path.abspath(ROOT) + os.sep)


def card_problem(chips: int) -> str | None:
    """Why this process cannot measure `chips` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} cards visible, the cell asks for {chips}"
    return None


def program_counters() -> dict:
    """The port's counters in this process: kernel launches by kernel,
    hash_probe's launches by (P, N, T, regime, cluster size), and the
    device table cache's hits and fills. Read while no query runs."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.stage_compiler import DEVICE_CACHE

    return {"launches": dict(ck.LAUNCHES), "hash_probe": dict(ck.HASH_PROBE_LAUNCHES.items()),
            "table_cache": {"hits": DEVICE_CACHE.hits, "fills": DEVICE_CACHE.fills}}


def cache_sizes() -> dict:
    """Entries and bytes the port's device table and join build caches hold."""
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    tables = list(sc.DEVICE_CACHE._cache.values())
    return {"tables": len(tables), "table_bytes": sum(t.nbytes for t in tables),
            "builds": len(sc._BUILD_CACHE), "build_bytes": sc._BUILD_CACHE.nbytes()}


def counter_delta(before: dict, after: dict) -> dict:
    out = {}
    for group in after:
        a, b = after[group], before.get(group, {})
        out[group] = {k: v - b.get(k, 0) for k, v in a.items() if v - b.get(k, 0)}
    return out
