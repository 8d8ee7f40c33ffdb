"""Intra-host collective exchange: the device data plane between cards.

Counterpart of the JAX package's parallel/exchange.py. There the stage
patterns are jittable collectives under `shard_map` over a jax Mesh; here
a `Mesh` is an ordered list of torch devices inside ONE process, and the
collectives are tensor copies between them:

- `partial_then_psum`: per-device partial aggregation, the partials added
  across devices in device order — the collective form of partial-agg →
  shuffle(1) → final-agg.
- `hash_exchange_all_to_all` / `hash_exchange_table`: rows routed by the
  engine-wide key hash (bit-identical twin of ops/hashing.py) into
  fixed-capacity per-destination send buffers, then each receiver copies
  its slice of every sender's buffer — the collective form of
  ShuffleWriter(hash K) → ShuffleReader. Fixed capacity keeps the buffers'
  shapes known before any row moves; overflow falls back to the file
  shuffle path (the capacity check happens host-side before dispatch).

The arrays a mesh holds are `MeshTensor`s: per device one shard of the
leading axis (sharded) or one full copy (replicated), the counterparts of
a jax array under `NamedSharding(mesh, P(axis))` and `P()`.

The file-based Flight shuffle remains the general path (elasticity, retry,
cross-host); gated by `ballista.tpu.collective.exchange`.
"""

from __future__ import annotations

import numpy as np


class ExchangeCapacityExceeded(Exception):
    """A fixed-capacity collective exchange cannot hold the routed rows.

    The device kernel's per-(sender, destination) buckets have `capacity`
    slots; at least one pair needs `required` of them. Raised by the
    host-side gate BEFORE any device dispatch, so no row is ever silently
    truncated — the caller demotes the stage to the per-partition
    file-shuffle path and logs the reason."""

    def __init__(self, required: int, capacity: int, n_devices: int):
        self.required = required
        self.capacity = capacity
        self.n_devices = n_devices
        super().__init__(
            f"collective exchange needs {required} slots per (sender, dest) "
            f"pair but capacity is {capacity} ({n_devices} devices); "
            "demote to the file shuffle path"
        )


class _Devices(tuple):
    """The mesh's devices in order; `.size` counts them, as numpy's does
    for a jax Mesh's device array."""

    @property
    def size(self) -> int:
        return len(self)


class Mesh:
    """1-D device mesh over the partition axis: an ordered list of torch
    devices (a device may repeat: K shards of one card) and the axis name."""

    def __init__(self, devices, axis: str = "part"):
        import torch

        self.devices = _Devices(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def key(self) -> tuple:
        """What a cache keys a placement on: the devices, in order."""
        return tuple(str(d) for d in self.devices)

    def shard(self, arr) -> "MeshTensor":
        """Split `arr` (numpy or torch) into `size` equal contiguous shards
        of its leading axis, shard i on device i."""
        t = _as_tensor(arr)
        n = self.size
        if t.shape[0] % n:
            raise ValueError(f"leading axis {t.shape[0]} is not a multiple of {n} devices")
        return MeshTensor(self, [c.to(d) for c, d in zip(t.tensor_split(n), self.devices)],
                          True)

    def replicate(self, arr) -> "MeshTensor":
        """A full copy of `arr` on every device (`.to` copies nothing onto
        the device it is on: shards of one card share one copy)."""
        t = _as_tensor(arr)
        return MeshTensor(self, [t.to(d) for d in self.devices], False)

    def __repr__(self) -> str:
        return f"Mesh({list(self.key())}, axis={self.axis!r})"


class ByPartition:
    """Where a [P, ...] stack goes over `mesh`: split by its leading
    (partition) axis, the counterpart of jax's
    `NamedSharding(mesh, PartitionSpec(axis, None))`."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh


def _as_tensor(arr):
    import torch

    if isinstance(arr, torch.Tensor):
        return arr
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:
        a = a.copy()  # torch tensors may not alias read-only memory
    return torch.as_tensor(a)


class MeshTensor:
    """An array placed over a mesh: `shards[i]` lives on `mesh.devices[i]`.
    Sharded, the shards split the leading axis in device order (global
    shape: their concatenation); replicated, each is a full copy."""

    def __init__(self, mesh: Mesh, shards: list, sharded: bool):
        self.mesh = mesh
        self.shards = list(shards)
        self.sharded = bool(sharded)

    @property
    def shape(self) -> tuple:
        s = tuple(self.shards[0].shape)
        if self.sharded:
            return (sum(int(x.shape[0]) for x in self.shards),) + s[1:]
        return s

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.mesh.devices[0]

    def __len__(self) -> int:
        return self.shape[0]

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.shards[0].element_size()

    @property
    def nbytes(self) -> int:
        return self.numel() * self.element_size()

    def local(self, i: int):
        """Device i's shard (its copy, when replicated)."""
        return self.shards[i]

    def gather(self, device=None):
        """The global array on `device` (the mesh's first by default): the
        shards concatenated in device order, or the first copy."""
        import torch

        device = self.device if device is None else device
        if not self.sharded:
            return self.shards[0].to(device)
        return torch.cat([s.to(device) for s in self.shards])

    def cpu(self):
        """Every shard on the host: one blocking fetch."""
        import torch

        from ballista_tpu_torch.utils.run_stats import RUN_STATS

        RUN_STATS.count_sync()
        return self.gather(torch.device("cpu"))

    def __array__(self, dtype=None, copy=None):
        a = self.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def make_mesh(n_devices: int | None = None, axis: str = "part") -> Mesh:
    """1-D device mesh over the partition axis (data parallel over rows):
    the first `n_devices` of the visible cards (all of them by default),
    or, after `runtime.use_cpu(devices=K)`, of the K simulated CPU devices.

    Fewer devices than asked is a hard error, never a truncation, and
    never the CPU in place of missing cards (the reference falls back to
    the CPU backend's virtual devices there)."""
    from ballista_tpu_torch.ops.cuda import runtime

    devs = runtime.visible_devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)} ({devs[0].type})")
    return Mesh(devs[:n], axis)


def _sharded(arr, mesh: Mesh) -> list:
    """Per-device shards of a row-sharded input (a MeshTensor over `mesh`
    is taken as placed)."""
    if isinstance(arr, MeshTensor) and arr.sharded and arr.mesh.key() == mesh.key():
        return list(arr.shards)
    return mesh.shard(arr).shards


def _order_after(mesh: Mesh) -> None:
    """Make every device's current stream wait for every other's work so
    far: a receiver's copy must not read a send buffer its sender's stream
    is still writing. One event per sender device, waited on by each
    receiver's stream; nothing to order on the CPU."""
    import torch

    cuda = list(dict.fromkeys(d for d in mesh.devices if d.type == "cuda"))
    if len(cuda) < 2:
        return  # one stream: enqueue order is already the order
    events = []
    for d in cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append((d, ev))
    for d in cuda:
        stream = torch.cuda.current_stream(d)
        for src, ev in events:
            if src != d:
                stream.wait_event(ev)


def _all_to_all(sends: list, mesh: Mesh, cap: int) -> MeshTensor:
    """`sends[i]` is sender i's [n, cap + 1] buffer on its device: receiver j
    takes row j's first `cap` slots of every sender, in sender order, as
    `jax.lax.all_to_all(..., 0, 0, tiled=True)` does; per device [n·cap]."""
    import torch

    _order_after(mesh)
    out = []
    for j, dj in enumerate(mesh.devices):
        out.append(torch.cat([s[j, :cap].to(dj) for s in sends]))
    return MeshTensor(mesh, out, True)


def _slots(dest, live, n: int):
    """Stable slot of each row within its destination bucket: the rows
    before it with the same destination (dead rows claim none)."""
    import torch

    slot = torch.zeros_like(dest)
    for d in range(n):
        is_d = dest == d
        if live is not None:
            is_d = is_d & live
        slot = torch.where(is_d, torch.cumsum(is_d, 0) - 1, slot)
    return slot


def _scatter(arrays: list, dest, slot_w, n: int, cap: int) -> list:
    """Scatter each [rows] array into a zeroed [n, cap + 1] send buffer at
    (dest, slot_w). Only the dump column `cap` ever takes two writes, so no
    valid row shares a slot with another write."""
    import torch

    flat = dest * (cap + 1) + slot_w
    out = []
    for a in arrays:
        buf = torch.zeros(n * (cap + 1), dtype=a.dtype, device=a.device)
        buf.index_put_((flat,), a)
        out.append(buf.view(n, cap + 1))
    return out


def partial_then_psum(values, gmask_fn, num_groups: int, mesh: Mesh, axis: str = "part"):
    """Group-aggregate values sharded by rows across the mesh; returns the
    globally-merged per-group (sums, counts) replicated on every device.

    values: [rows] array sharded on `axis`; gmask_fn(local_rows) -> bool
    masks [num_groups, local_rows]. The partials are added in device order
    on the mesh's first device, so reruns are byte-identical.
    """
    import torch

    sums = cnts = None
    d0 = mesh.devices[0]
    for vals in _sharded(values, mesh):
        gm = gmask_fn(vals)
        s = torch.stack([torch.where(gm[g], vals, 0).sum() for g in range(num_groups)]).to(d0)
        c = torch.stack([gm[g].sum() for g in range(num_groups)]).to(d0)
        sums = s if sums is None else sums + s
        cnts = c if cnts is None else cnts + c
    return mesh.replicate(sums), mesh.replicate(cnts)


def required_exchange_capacity(key_arrays, n_devices: int, *, prehashed: bool = False) -> int:
    """Slots per (sending device, destination) pair the routed rows need:
    the max bucket fill over every pair. `key_arrays` is the per-device list
    of host arrays — raw int64 keys hashed with the engine-wide key hash
    (ops/hashing.py splitmix64, bit-exact twin of the device hash64), or,
    with `prehashed`, already-combined uint64 row hashes (the multi-column
    `hash_arrays` form that `hash_exchange_table` routes on)."""
    from ballista_tpu_torch.ops.hashing import splitmix64

    worst = 0
    for k in key_arrays:
        k = np.asarray(k)
        if prehashed:
            h = k.astype(np.uint64)
        else:
            h = splitmix64(k.astype(np.uint64))
        dest = h % np.uint64(n_devices)
        counts = np.bincount(dest.astype(np.int64), minlength=n_devices)
        worst = max(worst, int(counts.max(initial=0)))
    return worst


def exchange_capacity_fits(key_arrays, n_devices: int, capacity: int,
                           *, prehashed: bool = False) -> bool:
    """Host-side capacity check (the gate the docstring above promises):
    True iff, for every (sending device, destination) pair, the number of
    rows routed there fits in `capacity` slots. Rows beyond capacity would
    be dropped by the fixed-shape kernel, so a False verdict must route the
    exchange down the file-shuffle path instead."""
    return required_exchange_capacity(key_arrays, n_devices, prehashed=prehashed) <= capacity


def require_exchange_capacity(key_arrays, n_devices: int, capacity: int,
                              *, prehashed: bool = False) -> int:
    """The raising form of `exchange_capacity_fits`: returns the required
    per-pair slot count when it fits, raises the typed
    `ExchangeCapacityExceeded` when it does not (silent truncation is never
    an option — the executor catches the error and demotes the stage to the
    per-partition path)."""
    required = required_exchange_capacity(key_arrays, n_devices, prehashed=prehashed)
    if required > capacity:
        raise ExchangeCapacityExceeded(required, capacity, n_devices)
    return required


def hash_exchange_all_to_all(keys, payload, mesh: Mesh, axis: str = "part",
                             capacity: int | None = None):
    """Route (key, payload) rows to device hash(key) % n via all_to_all.

    keys/payload: [rows] int64 sharded on `axis`. Every device receives the
    rows whose key hashes to it, in fixed-capacity slots:
    returns (keys_out, payload_out, valid_out) with per-device shape
    [n_dev * capacity] where valid marks real rows.

    Overflow rows (more than `capacity` for one destination) land in a
    dump slot that is sliced away before the exchange — they can NEVER
    clobber a valid row. Callers gate dispatch with
    `exchange_capacity_fits` and fall back to the file shuffle when the
    data does not fit.
    """
    import torch

    from ballista_tpu_torch.ops.cuda.kernels import hash64, umod

    n = mesh.size
    ks, vs = _sharded(keys, mesh), _sharded(payload, mesh)
    cap = capacity or int(ks[0].shape[0])  # worst case: all rows to one bucket
    send_k, send_v, send_ok = [], [], []
    for k, v in zip(ks, vs):
        dest = umod(hash64(k.to(torch.int64)), n)
        slot = _slots(dest, None, n)
        ok = slot < cap
        # slot `cap` is a write-only dump for overflow rows
        slot_w = torch.where(ok, slot, cap)
        bk, bv, bo = _scatter([k, v, ok], dest, slot_w, n, cap)
        send_k.append(bk)
        send_v.append(bv)
        send_ok.append(bo)
    return (_all_to_all(send_k, mesh, cap), _all_to_all(send_v, mesh, cap),
            _all_to_all(send_ok, mesh, cap))


def hash_exchange_table(hashes, lanes, live, mesh: Mesh, axis: str = "part",
                        capacity: int | None = None):
    """Route a whole table's rows to device hash % n via one all_to_all
    routing decision shared by every column.

    The single-payload form above hashes raw keys on device; real stage
    output rows carry multi-column (possibly string/dictionary) keys, so
    here the caller ships the PRE-combined row hash (`ops/hashing.py
    hash_arrays`, uint64 bit-cast to int64) and the device only takes
    `% n_devices` (unsigned) — host gate and device routing are the same
    hash by construction.

    hashes: [rows] int64 (bit-cast uint64 row hash), sharded on `axis`.
    lanes:  list of [rows] int64 payload lanes (every column of the table
            encoded to one or more int64 lanes by the caller).
    live:   [rows] bool — padding rows (added to make rows divisible by the
            device count) carry False and are never routed.

    Returns (hashes_out, lanes_out, valid_out), each with per-device shape
    [n_dev * capacity] (global [n_dev² * capacity]); `valid_out` marks real
    rows. Callers MUST gate with `require_exchange_capacity(...,
    prehashed=True)` first: rows beyond `capacity` for one (sender, dest)
    pair land in a write-only dump slot and are dropped, exactly like the
    single-payload kernel."""
    import torch

    from ballista_tpu_torch.ops.cuda.kernels import umod

    n = mesh.size
    hs, lvs = _sharded(hashes, mesh), _sharded(live, mesh)
    ls = [_sharded(a, mesh) for a in lanes]
    cap = capacity or int(hs[0].shape[0])
    sends: list[list] = [[] for _ in range(len(lanes) + 2)]
    for i, (h, lv) in enumerate(zip(hs, lvs)):
        h = h.to(torch.int64)
        lv = lv.to(torch.bool)
        dest = umod(h, n)
        # stable slot assignment per destination bucket; dead (padding)
        # rows never claim a slot
        slot = _slots(dest, lv, n)
        ok = lv & (slot < cap)
        # slot `cap` is a write-only dump for overflow + padding rows
        slot_w = torch.where(ok, slot, cap)
        bufs = _scatter([h] + [l[i] for l in ls] + [ok], dest, slot_w, n, cap)
        for s, b in zip(sends, bufs):
            s.append(b)
    outs = [_all_to_all(s, mesh, cap) for s in sends]
    return outs[0], tuple(outs[1:-1]), outs[-1]
