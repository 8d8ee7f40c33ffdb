"""Build the hand-written CUDA kernels and load them with ctypes.

Each source under csrc/ is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, at first use, into the kernel
build directory (runtime.compile_cache_dir(), listed in .gitignore). The
library's file name carries a hash of its source, the shared headers
(csrc/*.cuh) and the flags, so an edited source rebuilds and an
unchanged one loads as built. `build_all`
starts one nvcc per source together. A build or load error raises:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ballista_tpu_torch.ops.cuda import runtime

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("masked_group_reduce", "hash_probe", "dict_filter", "segmented_sort",
           "topk_select", "segmented_scan")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}  # per source: nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header under csrc/ (bitonic3.cuh, mergesort3.cuh)
    for path in [src] + sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                               if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return src, os.path.join(runtime.compile_cache_dir(), f"lib{name}-{digest[:16]}.so")


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed source that is not built yet, one nvcc each,
    all started together. Returns {name: library path}."""
    out_dir = runtime.compile_cache_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths: dict[str, str] = {}
    procs = []
    for name in names:
        src, so = _target(name)
        paths[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so[:-3]}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            _libs[name] = lib
        return lib
