"""The port's collective exchange (parallel/exchange.py) against the JAX
package's.

The reference's tests (tests/test_exchange.py) run on 8 virtual CPU devices;
here the same tests run on the port after `runtime.use_cpu(devices=8)`, 8
simulated CPU devices, and each device function is held against the
reference's on the same inputs: outputs, lanes and validity equal bit for
bit (the skewed and the overflow cases too); `partial_then_psum`'s sums
within rtol 1e-6 (the reference test's bound), its counts exact."""

import numpy as np
import pytest
import torch

from ballista_tpu_torch.ops.cuda import runtime
from ballista_tpu_torch.parallel.exchange import (
    ExchangeCapacityExceeded,
    Mesh,
    MeshTensor,
    exchange_capacity_fits,
    hash_exchange_all_to_all,
    hash_exchange_table,
    make_mesh,
    partial_then_psum,
    require_exchange_capacity,
    required_exchange_capacity,
)


@pytest.fixture(scope="module", autouse=True)
def _eight_devices():
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu(devices=8)
    yield
    runtime.use_cpu(*prev)


def _mesh8():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    return mesh


def _expected_routing(keys_np, n):
    from ballista_tpu_torch.ops.hashing import splitmix64

    return splitmix64(keys_np.astype(np.uint64)) % np.uint64(n)


# -- the reference's tests, on the port ------------------------------------------


def test_hash_exchange_routes_every_row_once():
    mesh = _mesh8()
    n = mesh.devices.size
    rows = 64 * n
    rng = np.random.default_rng(3)
    keys_np = rng.integers(0, 10_000, rows).astype(np.int64)
    vals_np = np.arange(rows, dtype=np.int64)

    rk, rv, ro = hash_exchange_all_to_all(keys_np, vals_np, mesh, capacity=rows)
    rk, rv, ro = np.asarray(rk), np.asarray(rv), np.asarray(ro)
    # every input row arrives exactly once, on the device its key hashes to
    got = sorted(rv[ro].tolist())
    assert got == vals_np.tolist()
    dest = _expected_routing(keys_np, n)
    per_dev = rk.reshape(n, -1)
    per_ok = ro.reshape(n, -1)
    for d in range(n):
        want = sorted(keys_np[dest == d].tolist())
        assert sorted(per_dev[d][per_ok[d]].tolist()) == want


def test_hash_exchange_overflow_never_clobbers_valid_rows():
    """Force overflow: surviving rows must be an intact SUBSET of the
    input — an overflow write must never zero a valid slot."""
    mesh = _mesh8()
    n = mesh.devices.size
    rows = 64 * n
    rng = np.random.default_rng(5)
    keys_np = rng.integers(0, 37, rows).astype(np.int64)  # few keys → skew
    vals_np = np.arange(1, rows + 1, dtype=np.int64)  # all nonzero
    cap = 4

    assert not exchange_capacity_fits(
        [keys_np[i * 64:(i + 1) * 64] for i in range(n)], n, cap)

    rk, rv, ro = hash_exchange_all_to_all(keys_np, vals_np, mesh, capacity=cap)
    rk, rv, ro = np.asarray(rk), np.asarray(rv), np.asarray(ro)
    surv_vals = rv[ro]
    # every surviving value is a real input row (no zeroed/clobbered slots)
    assert len(surv_vals) > 0
    assert set(surv_vals.tolist()) <= set(vals_np.tolist())
    # and its key traveled with it to the right destination
    dest = {v: d for v, d in zip(vals_np, _expected_routing(keys_np, n))}
    key_of = dict(zip(vals_np.tolist(), keys_np.tolist()))
    per = ro.reshape(n, -1)
    vals_per = rv.reshape(n, -1)
    keys_per = rk.reshape(n, -1)
    for d in range(n):
        for v, k in zip(vals_per[d][per[d]].tolist(), keys_per[d][per[d]].tolist()):
            assert key_of[v] == k
            assert dest[v] == d


def test_exchange_capacity_fits_gate():
    n = 8
    rng = np.random.default_rng(7)
    keys = [rng.integers(0, 1 << 40, 256).astype(np.int64) for _ in range(n)]
    # 256 rows over 8 destinations ≈ 32/dest; 96 slots is comfortably enough
    assert exchange_capacity_fits(keys, n, 96)
    assert not exchange_capacity_fits(keys, n, 8)


def test_make_mesh_clamps_device_count():
    mesh = _mesh8()
    n = mesh.devices.size
    # asking for fewer devices than exist clamps the mesh to that many
    assert make_mesh(4).devices.size == 4
    assert make_mesh(1).devices.size == 1
    # asking for more than any backend has is a hard error, not truncation
    with pytest.raises(RuntimeError, match="devices"):
        make_mesh(n * 1000)


def test_require_exchange_capacity_raises_typed():
    # every row routes to ONE destination → required == row count
    keys = [np.zeros(100, dtype=np.int64)]
    assert require_exchange_capacity(keys, 8, 100) == 100
    with pytest.raises(ExchangeCapacityExceeded) as ei:
        require_exchange_capacity(keys, 8, 10)
    assert ei.value.required == 100
    assert ei.value.capacity == 10
    assert ei.value.n_devices == 8
    assert "demote" in str(ei.value)


def test_required_capacity_prehashed_routes_on_raw_hash():
    # prehashed: the values ARE the combined row hashes — no splitmix64 pass
    h = np.full(64, 5, dtype=np.uint64)  # all route to 5 % n
    assert required_exchange_capacity([h], 8, prehashed=True) == 64
    spread = np.arange(64, dtype=np.uint64)  # 8 rows per destination
    assert required_exchange_capacity([spread], 8, prehashed=True) == 8
    assert exchange_capacity_fits([spread], 8, 8, prehashed=True)
    assert not exchange_capacity_fits([spread], 8, 7, prehashed=True)


def _skewed_table(n):
    rows = 64 * n
    rng = np.random.default_rng(9)
    hot = rng.random(rows) < 0.8  # 80% of rows on one hot key
    hashes = np.where(
        hot, np.uint64(0xDEADBEEF),
        rng.integers(1, 1 << 62, rows).astype(np.uint64),
    )
    lane_a = np.arange(rows, dtype=np.int64)  # row id
    lane_b = rng.integers(-1000, 1000, rows).astype(np.int64)
    live = np.ones(rows, dtype=bool)
    live[-7:] = False  # a padding tail that must never arrive
    return hashes, lane_a, lane_b, live


def test_hash_exchange_table_skewed_round_trip():
    """Multi-lane table exchange under heavy key skew: every live row
    arrives exactly once on the device its PRE-combined hash routes to,
    all lanes travel together, and dead (padding) rows never arrive."""
    mesh = _mesh8()
    n = mesh.devices.size
    hashes, lane_a, lane_b, live = _skewed_table(n)

    shards = [
        hashes[d * 64:(d + 1) * 64][live[d * 64:(d + 1) * 64]] for d in range(n)
    ]
    cap = required_exchange_capacity(shards, n, prehashed=True)
    h_out, (a_out, b_out), ok = hash_exchange_table(
        hashes.view(np.int64), [lane_a, lane_b], live, mesh, capacity=cap)
    h_out = np.asarray(h_out)
    a_out, b_out = np.asarray(a_out), np.asarray(b_out)
    ok = np.asarray(ok)

    # exactly the live rows arrive, each once
    assert sorted(a_out[ok].tolist()) == lane_a[live].tolist()
    # lanes travel together with their hash
    b_of = dict(zip(lane_a.tolist(), lane_b.tolist()))
    h_of = dict(zip(lane_a.tolist(), hashes.tolist()))
    for rid, b, h in zip(a_out[ok].tolist(), b_out[ok].tolist(),
                         h_out[ok].view(np.uint64).tolist()):
        assert b_of[rid] == b
        assert h_of[rid] == h
    # and each lands on the device its hash routes to
    per_rid = a_out.reshape(n, -1)
    per_ok = ok.reshape(n, -1)
    dest = (hashes % np.uint64(n)).astype(np.int64)
    for d in range(n):
        got = sorted(per_rid[d][per_ok[d]].tolist())
        want = sorted(lane_a[live & (dest == d)].tolist())
        assert got == want


def _group_masks(vals):
    # the group rides in the value's integer part: v = group * 1000 + x
    return torch.stack([(vals // 1000) == grp for grp in range(4)])


def test_partial_then_psum_merges_globally():
    mesh = _mesh8()
    rows = 128 * mesh.devices.size
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, rows)
    v = rng.integers(0, 100, rows).astype(np.float32)
    G = 4

    enc = (g * 1000 + (v % 1000).astype(np.int64)).astype(np.float32)
    sums, cnts = partial_then_psum(enc, _group_masks, G, mesh)
    sums, cnts = np.asarray(sums), np.asarray(cnts)
    for grp in range(G):
        sel = g == grp
        assert cnts[grp] == sel.sum()
        assert np.isclose(sums[grp], enc[sel].sum(), rtol=1e-6)


# -- against the reference ---------------------------------------------------------


def _jax_mesh8():
    from ballista_tpu.ops.tpu.runtime import ensure_jax
    from ballista_tpu.parallel.exchange import make_mesh as jmake_mesh

    jax = ensure_jax()  # x64 on before any array is made, as the engine runs it

    assert len(jax.devices()) >= 8, "the reference's 8 virtual devices (tests/conftest.py)"
    return jmake_mesh(8)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("case", ["spread", "overflow"])
def test_all_to_all_equals_reference_bit_for_bit(case):
    import jax.numpy as jnp

    from ballista_tpu.parallel.exchange import hash_exchange_all_to_all as jx

    n = 8
    rows = 64 * n
    rng = np.random.default_rng(3 if case == "spread" else 5)
    if case == "spread":
        keys_np = rng.integers(0, 10_000, rows).astype(np.int64)
        cap = rows
    else:
        keys_np = rng.integers(0, 37, rows).astype(np.int64)
        cap = 4
    vals_np = np.arange(1, rows + 1, dtype=np.int64)
    jmesh = _jax_mesh8()
    want = jx(jnp.asarray(keys_np), jnp.asarray(vals_np), jmesh, capacity=cap)
    got = hash_exchange_all_to_all(keys_np, vals_np, _mesh8(), capacity=cap)
    for w, g in zip(want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape == (n * n * cap,)
        assert g.dtype == w.dtype
        assert (_bits(g) == _bits(w)).all()


@pytest.mark.parametrize("case", ["skewed", "overflow"])
def test_table_exchange_equals_reference_bit_for_bit(case):
    from ballista_tpu.parallel.exchange import hash_exchange_table as jx

    n = 8
    hashes, lane_a, lane_b, live = _skewed_table(n)
    if case == "skewed":
        shards = [hashes[d * 64:(d + 1) * 64][live[d * 64:(d + 1) * 64]] for d in range(n)]
        cap = required_exchange_capacity(shards, n, prehashed=True)
    else:
        cap = 3  # the hot key's rows overflow every sender's bucket
    h = hashes.view(np.int64)
    jh, jlanes, jok = jx(h, [lane_a, lane_b], live, _jax_mesh8(), capacity=cap)
    th, tlanes, tok = hash_exchange_table(h, [lane_a, lane_b], live, _mesh8(), capacity=cap)
    assert len(tlanes) == len(jlanes) == 2
    for w, g in zip([jh, *jlanes, jok], [th, *tlanes, tok]):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape == (n * n * cap,)
        assert g.dtype == w.dtype
        assert (_bits(g) == _bits(w)).all()


def test_partial_then_psum_equals_reference():
    import jax.numpy as jnp

    from ballista_tpu.parallel.exchange import partial_then_psum as jx

    rows = 128 * 8
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, rows)
    v = rng.uniform(0, 100, rows).astype(np.float32)
    enc = (g * 1000 + v).astype(np.float32)
    jmesh = _jax_mesh8()
    js, jc = jx(jnp.asarray(enc),
                lambda vals: jnp.stack([(vals // 1000) == grp for grp in range(4)]),
                4, jmesh)
    ts, tc = partial_then_psum(enc, _group_masks, 4, _mesh8())
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js), rtol=1e-6)
    assert (np.asarray(tc) == np.asarray(jc)).all()
    # replicated on every device, and reruns are byte-identical
    assert isinstance(ts, MeshTensor) and not ts.sharded and len(ts.shards) == 8
    ts2, _ = partial_then_psum(enc, _group_masks, 4, _mesh8())
    assert (_bits(ts2) == _bits(ts)).all()


# -- no fallback that hides the card -----------------------------------------------


def test_make_mesh_without_a_card_raises_and_never_returns_the_cpu():
    # the CPU not asked for and no card: make_mesh raises as runtime.device
    # does; it never carries on over CPU devices in the cards' place
    prev = runtime.cpu_requested(), runtime.cpu_device_count()
    runtime.use_cpu(False)
    try:
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            with pytest.raises(RuntimeError, match=f"need {n + 1} devices, have {n}"):
                make_mesh(n + 1)
            assert all(d.type == "cuda" for d in make_mesh().devices)
        else:
            for want in (None, 1, 8):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    make_mesh(want)
    finally:
        runtime.use_cpu(*prev)
    # with the CPU asked for, a mesh spans only the devices asked for
    with pytest.raises(RuntimeError, match="need 9 devices, have 8"):
        make_mesh(9)
    assert [str(d) for d in make_mesh().devices] == [f"cpu:{i}" for i in range(8)]


def test_mesh_places_shards_and_replicas():
    mesh = Mesh([torch.device("cpu", i) for i in range(4)])
    a = np.arange(24, dtype=np.int64).reshape(8, 3)
    sh = mesh.shard(a)
    assert sh.shape == (8, 3) and len(sh.shards) == 4
    assert [tuple(s.shape) for s in sh.shards] == [(2, 3)] * 4
    assert (np.asarray(sh) == a).all()
    rep = mesh.replicate(a)
    assert rep.shape == (8, 3) and all((s.numpy() == a).all() for s in rep.shards)
    with pytest.raises(ValueError, match="multiple"):
        mesh.shard(np.arange(6))
