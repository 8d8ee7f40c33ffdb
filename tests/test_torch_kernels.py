"""The PyTorch port's kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both. The JAX kernel
runs in interpret mode on the CPU (as tests/test_fusion.py runs it); the
port's wrapper, given CPU tensors, runs its plain PyTorch form.
masked_group_reduce: counts must match exactly, f32 sums within rtol 1e-4 /
atol 1e-4, the JAX package's own bound for this kernel
(tests/test_fusion.py). hash_probe and dict_filter are gathers: exact.
Tests of the hand-written CUDA kernels themselves need the card: they
carry the `gpu` marker and skip elsewhere.
"""

import numpy as np
import pytest
import torch

from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
from ballista_tpu_torch.ops.cuda import runtime
from ballista_tpu_torch.ops.cuda.kernels import _align, take


@pytest.fixture(autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _inputs(seed, P, N, G, lo=-5.0, hi=5.0, p_mask=0.7):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(lo, hi, (P, N)).astype(np.float32)
    gid = rng.integers(0, G, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < p_mask
    return vals, gid, mask


def _both(vals, gid, mask, G):
    from ballista_tpu.ops.tpu.pallas_kernels import masked_group_reduce as jax_mgr

    js, jc = jax_mgr(vals, gid, mask, G, block_n=128)
    ts, tc = ck.masked_group_reduce(
        torch.from_numpy(vals), torch.from_numpy(gid), torch.from_numpy(mask), G)
    return np.asarray(js), np.asarray(jc), ts.numpy(), tc.numpy()


@pytest.mark.parametrize("P,N,G,seed", [(3, 512, 11, 7), (2, 256, 300, 11)])
def test_masked_group_reduce_matches_pallas(P, N, G, seed):
    # G=300 spans three 128-lane tiles of the Pallas kernel
    vals, gid, mask = _inputs(seed, P, N, G)
    js, jc, ts, tc = _both(vals, gid, mask, G)
    assert ts.shape == js.shape == (P, G) and tc.shape == jc.shape == (P, G)
    assert ts.dtype == np.float32 and tc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)


def test_masked_group_reduce_ignores_out_of_range_groups():
    # ids outside [0, G) belong to no group, in both kernels
    vals, gid, mask = _inputs(5, 2, 256, 16)
    gid[:, ::7] = 16  # one past the last group
    js, jc, ts, tc = _both(vals, gid, mask, 16)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)


def test_masked_group_reduce_ceiling():
    from ballista_tpu.ops.tpu.pallas_kernels import MAX_GROUPS as JAX_MAX
    from ballista_tpu.ops.tpu.pallas_kernels import masked_group_reduce as jax_mgr

    assert ck.MAX_GROUPS == JAX_MAX
    z = np.zeros((1, 8), np.float32)
    with pytest.raises(ValueError):
        jax_mgr(z, np.zeros((1, 8), np.int32), np.ones((1, 8), bool), JAX_MAX + 1)
    with pytest.raises(ValueError):
        ck.masked_group_reduce(torch.zeros(1, 8), torch.zeros(1, 8, dtype=torch.int32),
                               torch.ones(1, 8, dtype=torch.bool), ck.MAX_GROUPS + 1)


def test_wrapper_counts_only_kernel_launches():
    # on CPU tensors the wrapper runs the plain form: no launch is counted
    ck.reset_launches()
    vals, gid, mask = _inputs(1, 2, 64, 4)
    ck.masked_group_reduce(torch.from_numpy(vals), torch.from_numpy(gid),
                           torch.from_numpy(mask), 4)
    assert ck.LAUNCHES["masked_group_reduce"] == 0


@pytest.mark.parametrize("idx", [[0, 3, 5, -1, -7, 100]])
def test_take_clamps_like_xla(idx):
    import jax.numpy as jnp

    table = np.arange(4, dtype=np.int32) * 10
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = take(torch.from_numpy(table), torch.tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_align_promotes_like_jax():
    from ballista_tpu.ops.tpu.runtime import ensure_jax

    jnp = ensure_jax().numpy  # the JAX package's runtime: x64 on
    col = np.array([1, 2, 3], np.int32)
    want = (jnp.asarray(col) + jnp.asarray(2**40, dtype=jnp.int64)).dtype
    a, b = _align(torch.from_numpy(col), torch.tensor(2**40, dtype=torch.int64))
    assert str(a.dtype).split(".")[-1] == str(want) == "int64"
    assert (a + b).tolist() == [2**40 + 1, 2**40 + 2, 2**40 + 3]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_form():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    for G in (8, 300):
        vals, gid, mask = (torch.from_numpy(a).to(dev) for a in _inputs(3, 8, 262144, G))
        s1, c1 = ck.masked_group_reduce(vals, gid, mask, G)
        s2, c2 = ck.masked_group_reduce(vals, gid, mask, G)
        sp, cp = ck.masked_group_reduce_plain(vals, gid, mask, G)
        torch.cuda.synchronize()
        assert torch.equal(s1, s2) and torch.equal(c1, c2)  # fixed-order sums
        assert torch.equal(c1, cp)
        torch.testing.assert_close(s1, sp, rtol=1e-4, atol=1e-4)


# -- hash_probe ---------------------------------------------------------------


def _probe_inputs(seed, P, N, T, present=0.6, p_mask=0.8):
    """A direct key→row table with `present` of its slots filled, keys in
    [0, T) and a probe mask."""
    rng = np.random.default_rng(seed)
    table = np.full(T, -1, np.int32)
    n_present = int(round(T * present))
    slots = rng.choice(T, size=n_present, replace=False)
    table[slots] = rng.permutation(n_present).astype(np.int32)
    keys = rng.integers(0, T, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < p_mask
    return keys, table, mask


def _probe_both(keys, table, mask):
    from ballista_tpu.ops.tpu.pallas_kernels import hash_probe as jax_hp

    jr, jm = jax_hp(keys, table, mask, block_n=128)
    tr, tm = ck.hash_probe(torch.from_numpy(keys), torch.from_numpy(table),
                           torch.from_numpy(mask))
    return np.asarray(jr), np.asarray(jm), tr.numpy(), tm.numpy()


@pytest.mark.parametrize("T", [1, 4, 4096, 1 << 18])
@pytest.mark.parametrize("case", ["mixed", "all_miss", "all_hit"])
def test_hash_probe_matches_pallas(T, case):
    present = {"mixed": 0.6, "all_miss": 0.0, "all_hit": 1.0}[case]
    keys, table, mask = _probe_inputs(T + len(case), 2, 384, T, present=present,
                                      p_mask=1.0 if case == "all_hit" else 0.8)
    jr, jm, tr, tm = _probe_both(keys, table, mask)
    assert tr.dtype == np.int32 and tm.dtype == np.bool_
    np.testing.assert_array_equal(tm, jm.astype(bool))
    np.testing.assert_array_equal(tr, jr)
    if case == "all_miss":
        assert not tm.any() and not tr.any()
    if case == "all_hit":
        assert tm.all()


def test_hash_probe_ragged_block():
    # N = 300 is not a multiple of the Pallas block (128): the JAX wrapper
    # shrinks its block to 4; the port has no block constraint
    keys, table, mask = _probe_inputs(17, 3, 300, 64)
    jr, jm, tr, tm = _probe_both(keys, table, mask)
    np.testing.assert_array_equal(tm, jm.astype(bool))
    np.testing.assert_array_equal(tr, jr)


def test_hash_probe_guards_unclamped_keys():
    # keys outside [0, T) follow the engine's gather rule (wrap once, then
    # clamp) in the plain form, as in the CUDA kernel
    table = np.array([5, -1, 7, 9], np.int32)
    keys = np.array([[-1, -4, -9, 4, 100, 2]], np.int32)
    mask = np.ones_like(keys, bool)
    rows, matched = ck.hash_probe(torch.from_numpy(keys), torch.from_numpy(table),
                                  torch.from_numpy(mask))
    assert rows.tolist() == [[9, 5, 5, 9, 9, 7]]
    assert matched.all()


# -- dict_filter --------------------------------------------------------------


def _filter_inputs(seed, P, N, T, p_lut=0.4, p_mask=0.8):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, T, (P, N)).astype(np.int32)
    lut = rng.random(T) < p_lut
    mask = rng.random((P, N)) < p_mask
    return codes, lut, mask


def _filter_both(codes, lut, mask):
    from ballista_tpu.ops.tpu.pallas_kernels import dict_filter as jax_df

    jk = jax_df(codes, lut, mask, block_n=128)
    tk = ck.dict_filter(torch.from_numpy(codes), torch.from_numpy(lut),
                        torch.from_numpy(mask))
    return np.asarray(jk), tk.numpy()


@pytest.mark.parametrize("T", [8, 4096])
@pytest.mark.parametrize("case", ["mixed", "mask_all_false", "ragged"])
def test_dict_filter_matches_pallas(T, case):
    N = 300 if case == "ragged" else 512
    codes, lut, mask = _filter_inputs(T + len(case), 2, N, T,
                                      p_mask=0.0 if case == "mask_all_false" else 0.8)
    jk, tk = _filter_both(codes, lut, mask)
    assert tk.dtype == np.bool_
    np.testing.assert_array_equal(tk, jk)
    if case == "mask_all_false":
        assert not tk.any()


def _lowered_pred(pkg, pred_expr, codes, valid, dictionary):
    """Lower `pred_expr` over one nullable dictionary column `c` with the
    dict_filter route on, in the JAX package or the port, and run it over
    [P, N] codes. Returns (value, validity) as numpy."""
    import pyarrow as pa

    kmod = __import__(f"{pkg}.ops.{'tpu' if pkg == 'ballista_tpu' else 'cuda'}.kernels",
                      fromlist=["Lowering"])
    smod = __import__(f"{pkg}.plan.schema", fromlist=["DFSchema"])
    schema = smod.DFSchema([smod.DFField("c", pa.string(), True)])
    ctx = kmod.Lowering(schema, [("code", 0)], [dictionary])
    ctx.pallas_dict_filter = True
    ctx.env_fns = [lambda cols, luts: kmod.DevVal("code", cols[0], 0, dictionary,
                                                  valid=cols[1])]
    ctx.env_meta = [("code", 0, dictionary, 0)]
    fn = kmod.lower_expr(pred_expr(pkg), ctx)
    luts = ctx.build_luts([dictionary])
    if pkg == "ballista_tpu":
        import jax.numpy as jnp

        out = fn([jnp.asarray(codes), jnp.asarray(valid)], [jnp.asarray(l) for l in luts])
        return np.asarray(out.arr), np.asarray(out.valid)
    out = fn([torch.from_numpy(codes), torch.from_numpy(valid)],
             [torch.from_numpy(l) for l in luts])
    return out.arr.numpy(), out.valid.numpy()


def _ne(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["BinaryExpr"])
    return e.BinaryExpr(e.Column("c"), "<>", e.Literal("2-HIGH"))


def _eq(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["BinaryExpr"])
    return e.BinaryExpr(e.Column("c"), "=", e.Literal("2-HIGH"))


def _not_like(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["Like"])
    return e.Like(e.Column("c"), "%URGENT", negated=True)


@pytest.mark.parametrize("pred", [_ne, _eq, _not_like], ids=["ne", "eq", "not_like"])
def test_dict_filter_route_with_nulls_matches_jax(pred):
    # q12's o_orderpriority predicates over a nullable code column: the
    # kernel's mask is the valid plane under = and all-true under <> and
    # NOT LIKE, and the valid plane rides along unchanged
    rng = np.random.default_rng(12)
    dictionary = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
    codes = rng.integers(0, len(dictionary), (2, 256)).astype(np.int32)
    valid = rng.random((2, 256)) < 0.7
    jv, jvalid = _lowered_pred("ballista_tpu", pred, codes, valid, dictionary)
    tv, tvalid = _lowered_pred("ballista_tpu_torch", pred, codes, valid, dictionary)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tv, jv)


def test_dict_filter_route_counts_calls(monkeypatch):
    # = and LIKE reach the kernel wrapper under the flag; IN stays a gather
    calls = []
    real = ck.dict_filter
    monkeypatch.setattr(ck, "dict_filter", lambda *a: calls.append(1) or real(*a))
    dictionary = ["a", "b", "c"]
    codes = np.zeros((1, 8), np.int32)
    valid = np.ones((1, 8), bool)
    _lowered_pred("ballista_tpu_torch", _eq, codes, valid, dictionary)
    _lowered_pred("ballista_tpu_torch", _not_like, codes, valid, dictionary)
    assert len(calls) == 2

    def _in(pkg):
        e = __import__(f"{pkg}.plan.expressions", fromlist=["InList"])
        return e.InList(e.Column("c"), ["a", "b"])

    _lowered_pred("ballista_tpu_torch", _in, codes, valid, dictionary)
    assert len(calls) == 2


def test_gather_wrappers_count_only_kernel_launches():
    ck.reset_launches()
    keys, table, mask = _probe_inputs(2, 2, 64, 16)
    ck.hash_probe(torch.from_numpy(keys), torch.from_numpy(table), torch.from_numpy(mask))
    codes, lut, mask = _filter_inputs(2, 2, 64, 8)
    ck.dict_filter(torch.from_numpy(codes), torch.from_numpy(lut), torch.from_numpy(mask))
    assert ck.LAUNCHES["hash_probe"] == 0 and ck.LAUNCHES["dict_filter"] == 0


@pytest.mark.parametrize("n,seed", [(1, 1), (2, 2), (7, 3), (64, 4), (1000, 5)])
def test_final_stage_segscan_matches_jax_associative_scan(n, seed):
    # the final stage's float segmented sum associates as the reference's
    # jax.lax.associative_scan does, so partial sums merge bit for bit
    from ballista_tpu.ops.tpu.runtime import ensure_jax
    from ballista_tpu.ops.tpu.stage_compiler import _segscan as jax_segscan
    from ballista_tpu_torch.ops.cuda.final_stage import _segscan

    jnp = ensure_jax().numpy
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1e6, 1e6, n) / 7.0
    boundary = rng.random(n) < 0.2
    boundary[0] = True
    for func in ("sum", "min", "max"):
        want = np.asarray(jax_segscan(jnp, jnp.asarray(vals), jnp.asarray(boundary), func))
        got = _segscan(torch.from_numpy(vals), torch.from_numpy(boundary), func).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [32, 4, 1 << 18])
def test_cuda_hash_probe_matches_plain_form(T):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    keys, table, mask = (torch.from_numpy(a).to(dev)
                         for a in _probe_inputs(5, 8, 262147, T, present=0.7))
    r1, m1 = ck.hash_probe(keys, table, mask)
    r2, m2 = ck.hash_probe(keys, table, mask)
    rp, mp = ck.hash_probe_plain(keys, table, mask)
    torch.cuda.synchronize()
    assert torch.equal(r1, r2) and torch.equal(m1, m2)
    assert torch.equal(r1, rp) and torch.equal(m1, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 4096, 1 << 17])
def test_cuda_dict_filter_matches_plain_form(T):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    codes, lut, mask = (torch.from_numpy(a).to(dev) for a in _filter_inputs(6, 8, 262147, T))
    k1 = ck.dict_filter(codes, lut, mask)
    k2 = ck.dict_filter(codes, lut, mask)
    kp = ck.dict_filter_plain(codes, lut, mask)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(k1, kp)
