"""ballista_tpu_torch — the ballista_tpu SQL engine with its device stages
in PyTorch on NVIDIA Hopper (H100) and its kernels written by hand in CUDA.

A port of `ballista_tpu` (the JAX/TPU package beside it, which stays the
reference). Module for module the layout is the same, with one rename:

    ballista_tpu/ops/tpu/               -> ballista_tpu_torch/ops/cuda/
    ballista_tpu/engine/tpu_engine.py   -> ballista_tpu_torch/engine/cuda_engine.py

ops/cuda/csrc/ holds the CUDA C++ kernels (one per Pallas kernel of the
reference), ops/cuda/build.py compiles them with nvcc for sm_90a, and
ops/cuda/cuda_kernels.py wraps each with its plain PyTorch form.

Config keys and values keep their spelling: `ballista.executor.engine=tpu`
selects the device engine, `ballista.tpu.*` tunes it, and the
`fused_pallas` fusion mode selects the hand-written-kernel rung.

This package imports `torch`, never `jax`, and no module of
`ballista_tpu`: the host modules it needs (SQL frontend, plan IR, CPU
operators, encoder, cost model, scheduler, shuffle, Flight, serde) are
its own copies. It carries the local SessionContext path and the
distributed standalone mode (`SessionContext.standalone()`: in-process
scheduler, executors and Flight server) so far; ROADMAP.md lists what is
still to port.
"""

from ballista_tpu_torch.version import BALLISTA_VERSION, WIRE_PROTOCOL_VERSION

__version__ = BALLISTA_VERSION

__all__ = ["BALLISTA_VERSION", "WIRE_PROTOCOL_VERSION"]
