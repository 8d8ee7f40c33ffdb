"""Version and wire-protocol gate.

The reference gates executor registration on an exact wire-protocol version
match (ballista/core/src/lib.rs:30-42: BALLISTA_VERSION is baked into
PollWorkParams / RegisterExecutorParams and mismatches are rejected at
registration). We keep the same behavior but separate the human version from
the wire version so bugfix releases don't force lock-step upgrades.
"""

BALLISTA_VERSION = "0.1.0"

# Bump whenever the plan protobuf, task definition, or shuffle file layout
# changes incompatibly. Schedulers reject executors with a different value.
WIRE_PROTOCOL_VERSION = "btpu-1"
