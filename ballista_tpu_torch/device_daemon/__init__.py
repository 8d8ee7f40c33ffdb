"""Warm device-runtime daemon: one persistent process owns the CUDA card.

Counterpart of the JAX package's device_daemon. Every process that
creates a CUDA context, loads the kernel libraries and fills the device
tables pays for it again. This package moves device ownership into ONE
long-lived daemon process (`python -m ballista_tpu_torch.device_daemon`):
it binds its card and creates its context once, behind a supervised,
phase-instrumented state machine, owns the device table cache, the join
builds, the LUTs and the device budget, and serves stage execution to any
local client over a unix-domain socket (Arrow IPC framing; a Flight
do_exchange variant exists where the Flight stack is importable).

Executors and short-lived clients attach instead of initialising:
`client.attach(config)` under the `ballista.tpu.daemon.*` keys, with
in-process execution as the always-available fallback (the reason lands
in RUN_STATS daemon_mode/daemon_mode_reason).

Import discipline: `client`, `protocol` and ops/cuda/daemon_route.py make
no torch.cuda call, so an attached client process ends with
`torch.cuda.is_initialized()` false; only `server` touches the device, and
only inside functions.
"""
