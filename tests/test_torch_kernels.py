"""The PyTorch port's kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both. The JAX kernel
runs in interpret mode on the CPU (as tests/test_fusion.py runs it); the
port's wrapper, given CPU tensors, runs its plain PyTorch form.
masked_group_reduce: counts must match exactly, f32 sums within rtol 1e-4 /
atol 1e-4, the JAX package's own bound for this kernel
(tests/test_fusion.py). hash_probe and dict_filter are gathers: exact.
segmented_sort and topk_select: exact (the pos operand makes the sorted
order unique). segmented_scan: bitwise for ints, min and max, and for
float sums too, because the plain form repeats the Pallas kernel's
Hillis-Steele steps; on the card the kernel's float sums associate
differently and agree within rtol times the segment's sum of |v| (the
classical bound of a summation's rounding), rtol 1e-5 (f32) / 1e-12
(f64).
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


@pytest.mark.parametrize("P,N,G,seed", [(3, 512, 11, 7), (2, 256, 300, 11), (2, 384, 1, 13),
                                         (3, 256, 33, 17), (1, 256, 4096, 19)])
def test_masked_group_reduce_matches_pallas(P, N, G, seed):
    # G=300 spans three 128-lane tiles of the Pallas kernel; G=1, 33 and
    # 4096 sit at the Hopper kernel's edges (registers up to 32 groups,
    # shared-memory bins above, up to MAX_GROUPS)
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


def test_masked_group_reduce_nan_stays_in_its_group():
    # ROADMAP C4: the reference multiplies every row by a one-hot tile, so a
    # NaN row that the mask removes, and an inf row, leak NaN (x 0) into
    # every group; the port adds a row only into its own group, as both
    # packages' CPU engines do
    vals = np.ones((1, 256), np.float32)
    gid = np.repeat(np.arange(2, dtype=np.int32), 128)[None, :]
    mask = np.ones((1, 256), bool)
    vals[0, 5] = np.nan
    mask[0, 5] = False
    vals[0, 200] = np.inf
    js, jc, ts, tc = _both(vals, gid, mask, 3)
    assert np.isnan(js).all()
    np.testing.assert_array_equal(ts, [[127.0, np.inf, 0.0]])
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, [[127, 128, 0]])


@pytest.mark.parametrize("P,N,G", [(8, 262144, 8), (8, 262144, 4096), (1, 5, 3),
                                   (3, 1 << 20, 33), (1000, 64, 2)])
def test_mgr_plan(P, N, G):
    # spans are multiples of the kernel's 16-lane chunk and cover each row;
    # about two blocks an SM in all for G <= 32, one above
    blocks, span = ck.mgr_plan(P, N, G, 132)
    assert span % ck.MGR_CHUNK == 0 and blocks * span >= N > (blocks - 1) * span
    assert blocks == 1 or P * blocks <= (2 if G <= 32 else 1) * 132


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


def _mgr_edge_inputs(kind, P, N, G, seed=3):
    """masked_group_reduce inputs of one kind: "random"; "none" (every row
    masked out); "special" (NaN and inf rows, some of them masked out);
    "outside" (ids below 0 and at or past G)."""
    vals, gid, mask = _inputs(seed, P, N, G)
    rng = np.random.default_rng(seed + 1)
    if kind == "none":
        mask[:] = False
    elif kind == "special":
        for v, share in ((np.nan, 0.001), (np.inf, 0.001), (-np.inf, 0.001)):
            vals[rng.random((P, N)) < share] = v
    elif kind == "outside":
        gid[rng.random((P, N)) < 0.2] = G
        gid[rng.random((P, N)) < 0.1] = -1
        gid[rng.random((P, N)) < 0.05] = 1 << 30
    return vals, gid, mask


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 8, 32, 33, 300, 4096])
def test_cuda_kernel_matches_plain_form(G):
    # (P, N, kind): q4's shape; one row; N no multiple of a block's span or
    # of the 16-lane chunk; N below one chunk; every row masked out; NaN and
    # inf rows; ids outside [0, G)
    dev = _on_card()
    for P, N, kind in ((8, 262144, "random"), (1, 262144, "random"), (8, 100003, "random"),
                       (3, 7, "random"), (8, 65536, "none"), (8, 65536, "special"),
                       (2, 65537, "outside")):
        vals, gid, mask = (torch.from_numpy(a).to(dev) for a in _mgr_edge_inputs(kind, P, N, G))
        s1, c1 = ck.masked_group_reduce(vals, gid, mask, G)
        s2, c2 = ck.masked_group_reduce(vals, gid, mask, G)
        sp, cp = ck.masked_group_reduce_plain(vals, gid, mask, G)
        torch.cuda.synchronize()
        assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))  # fixed-order sums
        assert torch.equal(c1, c2) and torch.equal(c1, cp)
        torch.testing.assert_close(s1, sp, rtol=1e-4, atol=1e-4, equal_nan=True)
        assert torch.equal(torch.isnan(s1), torch.isnan(sp))


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


@pytest.mark.parametrize("T", [1, 4, 4096, 12289, 1 << 14, 1 << 17, 1 << 18])
@pytest.mark.parametrize("case", ["mixed", "all_miss", "all_hit"])
def test_hash_probe_matches_pallas(T, case):
    # 12289 and 2^14 (q21's supplier table at SF1) fall in the Hopper
    # kernel's block regime, 2^17 (SF10) and 2^18 (the engine's cap) in
    # its cluster regime
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


# the regime boundaries as functions of S, one block's table entries
_REGIME_EDGES = [("1", "shared", 1), ("12288", "shared", 1), ("12289", "block", 1),
                 ("S", "block", 1), ("S+1", "split", 1), ("9S/4", "split", 1),
                 ("9S/4+1", "cluster", 2), ("4S", "cluster", 2), ("4S+1", "cluster", 2),
                 ("8S", "cluster", 2), ("8S+1", "global", 1)]


def _table_len(expr: str, s: int) -> int:
    """"12288" -> 12288, "S" -> s, "4S+1" -> 4 s + 1, "9S/4+1" -> 9 s // 4 + 1."""
    if "S" not in expr:
        return int(expr)
    k, _, rest = expr.partition("S")
    div, _, plus = rest.partition("+")
    return int(k or 1) * s // int(div[1:] or 1) + int(plus or 0)


@pytest.mark.parametrize("optin,S", [(232448, 58112), (232447, 58104), (101376, 25344),
                                     (49152, 12288)])
def test_hash_probe_block_max(optin, S):
    # S counts whole 32-byte granules of the opt-in shared memory (an H100
    # block opts in to 232,448 B; an A100's 101,376 B; the 48 KB default)
    assert ck.hash_probe_block_max(optin) == S


@pytest.mark.parametrize("optin", [232448, 101376])
@pytest.mark.parametrize("expr,regime,cluster", _REGIME_EDGES, ids=[e[0] for e in _REGIME_EDGES])
def test_hash_probe_regime_boundaries(expr, regime, cluster, optin):
    T = _table_len(expr, ck.hash_probe_block_max(optin))
    assert ck.hash_probe_regime(T, optin) == (regime, cluster)


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


_DF_OPTINS = [232448, 101376]  # an H100's and an A100's opt-in shared memory a block


@pytest.mark.parametrize("optin", _DF_OPTINS)
def test_dict_filter_bitmap_max(optin):
    # the opt-in shared memory in whole 32-bit words
    B = ck.dict_filter_bitmap_max(optin)
    assert B % 32 == 0 and B // 8 <= optin < (B + 32) // 8
    assert ck.dict_filter_bitmap_max(232448) == 1859584


@pytest.mark.parametrize("optin", _DF_OPTINS)
@pytest.mark.parametrize("T,regime", [(1, "register"), (8, "register"), (32, "register"),
                                      (33, "shared"), (256, "shared"), ("B", "shared"),
                                      ("B+1", "global"), (1 << 24, "global")])
def test_dict_filter_regime_boundaries(T, regime, optin):
    B = ck.dict_filter_bitmap_max(optin)
    T = {"B": B, "B+1": B + 1}.get(T, T)
    assert ck.dict_filter_regime(T, optin) == regime


def _wrapped_codes(codes, T, rng):
    """Codes outside [0, T) too: negatives the engine's gather wraps once
    (and some it then clamps to 0) and codes past T it clamps to T - 1."""
    codes = codes.copy()
    P, N = codes.shape
    for lo, hi, share in ((-T, 0, 0.05), (-3 * T, -T, 0.02), (T, 3 * T + 5, 0.02)):
        sel = rng.random((P, N)) < share
        codes[sel] = rng.integers(lo, hi, int(sel.sum()))
    return codes


def _pack_lut_bits(lut):
    """The bitmap the kernel looks codes up in: int32 [ceil(T / 32)], LUT
    entry e at bit e & 31 of word e >> 5, 0 past T."""
    T = lut.shape[0]
    b = torch.zeros(-(-T // 32) * 32, dtype=torch.int64)
    b[:T] = lut.to(torch.bool).to(torch.int64)
    words = (b.view(-1, 32) << torch.arange(32)).sum(dim=1)
    return (words - (words >= 1 << 31).to(torch.int64) * (1 << 32)).to(torch.int32)


def _dict_filter_bits(codes, lut, mask=None):
    """dict_filter as the kernel computes it, in plain torch: the engine's
    clamping gather of the code, then bit c & 31 of word c >> 5, and the
    mask."""
    T = lut.shape[0]
    c = codes.long()
    c = torch.where(c < 0, c + T, c).clamp_(0, T - 1)
    words = _pack_lut_bits(lut).to(torch.int64) & 0xFFFFFFFF
    keep = ((words[c >> 5] >> (c & 31)) & 1).to(torch.bool)
    return keep if mask is None else mask.to(torch.bool) & keep


@pytest.mark.parametrize("T", [1, 8, 32, 33, 256, 4096])
@pytest.mark.parametrize("N", [512, 301])
def test_dict_filter_bitmap_form_matches_pallas(T, N):
    # the kernel's arithmetic (pack into words, entry e at bit e & 31 of word
    # e >> 5, then gather by c >> 5 and c & 31) against the plain form and
    # the Pallas function, with wrapped negative and clamped codes and a
    # ragged N, with and without a mask
    from ballista_tpu.ops.tpu.pallas_kernels import dict_filter as jax_df

    rng = np.random.default_rng(T * 7 + N)
    codes, lut, mask = _filter_inputs(T + N, 3, N, T)
    codes = _wrapped_codes(codes, T, rng)
    words = _pack_lut_bits(torch.from_numpy(lut))
    assert words.dtype == torch.int32 and words.shape == (-(-T // 32),)
    for e in rng.integers(0, T, 16):
        assert bool((int(words[e >> 5]) >> (e & 31)) & 1) == bool(lut[e])
    for m in (mask, np.ones_like(mask)):
        want = np.asarray(jax_df(codes, lut, m, block_n=128))
        got = _dict_filter_bits(torch.from_numpy(codes), torch.from_numpy(lut),
                                torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)
        plain = ck.dict_filter_plain(torch.from_numpy(codes), torch.from_numpy(lut),
                                     torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(plain, want)
    no_mask = _dict_filter_bits(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(no_mask, want)  # `want` had a mask of ones


@pytest.mark.parametrize("T", [8, 4096])
@pytest.mark.parametrize("N", [512, 300])
def test_dict_filter_without_mask_matches_pallas_with_ones(T, N):
    # mask=None keeps every row: the Pallas function's answer under a mask of ones
    from ballista_tpu.ops.tpu.pallas_kernels import dict_filter as jax_df

    codes, lut, mask = _filter_inputs(T + N + 1, 2, N, T)
    want = np.asarray(jax_df(codes, lut, np.ones_like(mask), block_n=128))
    got = ck.dict_filter(torch.from_numpy(codes), torch.from_numpy(lut), None)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ck.dict_filter_plain(torch.from_numpy(codes), torch.from_numpy(lut)).numpy(), want)


def _lowered_pred(pkg, pred_expr, codes, valid, dictionary):
    """Lower `pred_expr` over one dictionary column `c` (nullable unless
    `valid` is None: no validity plane) with the dict_filter route on, in
    the JAX package or the port, and run it over [P, N] codes. Returns
    (value, validity) as numpy, validity None without a plane."""
    import pyarrow as pa

    kmod = __import__(f"{pkg}.ops.{'tpu' if pkg == 'ballista_tpu' else 'cuda'}.kernels",
                      fromlist=["Lowering"])
    smod = __import__(f"{pkg}.plan.schema", fromlist=["DFSchema"])
    schema = smod.DFSchema([smod.DFField("c", pa.string(), True)])
    ctx = kmod.Lowering(schema, [("code", 0)], [dictionary])
    ctx.pallas_dict_filter = True
    ctx.env_fns = [lambda cols, luts: kmod.DevVal("code", cols[0], 0, dictionary,
                                                  valid=cols[1] if len(cols) > 1 else None)]
    ctx.env_meta = [("code", 0, dictionary, 0)]
    fn = kmod.lower_expr(pred_expr(pkg), ctx)
    luts = ctx.build_luts([dictionary])
    planes = [codes] if valid is None else [codes, valid]
    if pkg == "ballista_tpu":
        import jax.numpy as jnp

        out = fn([jnp.asarray(a) for a in planes], [jnp.asarray(l) for l in luts])
        return np.asarray(out.arr), None if out.valid is None else np.asarray(out.valid)
    out = fn([torch.from_numpy(a) for a in planes], [torch.from_numpy(l) for l in luts])
    return out.arr.numpy(), None if out.valid is None else out.valid.numpy()


def _ne(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["BinaryExpr"])
    return e.BinaryExpr(e.Column("c"), "<>", e.Literal("2-HIGH"))


def _eq(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["BinaryExpr"])
    return e.BinaryExpr(e.Column("c"), "=", e.Literal("2-HIGH"))


def _not_like(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["Like"])
    return e.Like(e.Column("c"), "%URGENT", negated=True)


def _like(pkg):
    e = __import__(f"{pkg}.plan.expressions", fromlist=["Like"])
    return e.Like(e.Column("c"), "%URGENT", negated=False)


_PREDS = [_ne, _eq, _not_like, _like]
_PRED_IDS = ["ne", "eq", "not_like", "like"]


@pytest.mark.parametrize("pred", _PREDS, ids=_PRED_IDS)
def test_dict_filter_route_with_nulls_matches_jax(pred):
    # q12's o_orderpriority predicates over a nullable code column: the
    # kernel's mask is the valid plane under = and LIKE and none (the
    # reference: all-true) under <> and NOT LIKE, and the valid plane rides
    # along unchanged
    rng = np.random.default_rng(12)
    dictionary = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
    codes = rng.integers(0, len(dictionary), (2, 256)).astype(np.int32)
    valid = rng.random((2, 256)) < 0.7
    jv, jvalid = _lowered_pred("ballista_tpu", pred, codes, valid, dictionary)
    tv, tvalid = _lowered_pred("ballista_tpu_torch", pred, codes, valid, dictionary)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("pred", _PREDS, ids=_PRED_IDS)
def test_dict_filter_route_without_valid_plane_matches_jax(pred):
    # a non-null column (every TPC-H one): the reference hands its kernel
    # an all-true mask, the port none; the same answer, no validity plane
    rng = np.random.default_rng(13)
    dictionary = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
    codes = rng.integers(0, len(dictionary), (3, 300)).astype(np.int32)
    jv, jvalid = _lowered_pred("ballista_tpu", pred, codes, None, dictionary)
    tv, tvalid = _lowered_pred("ballista_tpu_torch", pred, codes, None, dictionary)
    assert jvalid is None and tvalid is None
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("valid", [True, False], ids=["nulls", "no_plane"])
def test_dict_filter_route_passes_a_mask_only_where_it_filters(valid, monkeypatch):
    # the valid plane under = and LIKE; no mask under <> and NOT LIKE or
    # without a plane, where the reference builds an all-true one
    masks = []
    real = ck.dict_filter
    monkeypatch.setattr(ck, "dict_filter",
                        lambda codes, lut, mask: masks.append(mask) or real(codes, lut, mask))
    dictionary = ["a", "b", "c"]
    codes = np.zeros((1, 8), np.int32)
    plane = np.ones((1, 8), bool) if valid else None
    for pred in _PREDS:
        _lowered_pred("ballista_tpu_torch", pred, codes, plane, dictionary)
    assert [m is not None for m in masks] == [False, valid, False, valid]


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


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("seed", range(6))
def test_final_stage_segscan_bits_match_reference(seed, dtype):
    # bit patterns, not values: the sign of a zero (the reference returns
    # no -0.0 once two rows combine) and of a NaN left by inf - inf or two
    # NaNs must agree
    from ballista_tpu.ops.tpu.runtime import ensure_jax
    from ballista_tpu.ops.tpu.stage_compiler import _segscan as jax_segscan
    from ballista_tpu_torch.ops.cuda.final_stage import _segscan

    jnp = ensure_jax().numpy
    pool = np.array([0.0, -0.0, 1.0, -1.0, 2.5, np.nan, np.inf, -np.inf], dtype)
    bits = np.int64 if dtype == np.float64 else np.int32
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 41))
        vals = pool[rng.integers(0, len(pool), n)]
        boundary = rng.random(n) < 0.3
        boundary[0] = True
        for func in ("sum", "min", "max"):
            want = np.asarray(jax_segscan(jnp, jnp.asarray(vals), jnp.asarray(boundary), func))
            got = _segscan(torch.from_numpy(vals), torch.from_numpy(boundary), func).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.view(bits), want.view(bits), err_msg=func)


def _cuda_probe_case(T, seed=5):
    """Probe inputs on the card (8 x 262147 rows, no multiple of 4), with
    every 97th key outside [0, T) to exercise the gather rule."""
    keys, table, mask = _probe_inputs(seed, 8, 262147, T, present=0.7)
    keys[:, ::97] = np.where(np.arange(keys[:, ::97].size).reshape(8, -1) % 2 == 0,
                             -keys[:, ::97] - 1, keys[:, ::97] + T)
    dev = torch.device("cuda", 0)
    return tuple(torch.from_numpy(a).to(dev) for a in (keys, table, mask))


def _cuda_probe_exact(keys, table, mask):
    r1, m1 = ck.hash_probe(keys, table, mask)
    r2, m2 = ck.hash_probe(keys, table, mask)
    rp, mp = ck.hash_probe_plain(keys, table, mask)
    torch.cuda.synchronize()
    assert torch.equal(r1, r2) and torch.equal(m1, m2)
    assert torch.equal(r1, rp) and torch.equal(m1, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [32, 4, 1 << 18, 12288, 12289, 1 << 14, 1 << 17, "S", "S+1",
                               "9S/4", "9S/4+1", "4S", "4S+1", "8S", "8S+1"])
def test_cuda_hash_probe_matches_plain_form(T):
    # every regime at every boundary, in the regime T chooses: exact, two
    # runs bitwise identical, the launch recorded under that regime
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    optin = ck.hash_probe_smem_optin(dev)
    assert ck.smem_max_entries("hash_probe") == ck.HP_SHARED_MAX
    T = _table_len(str(T), ck.hash_probe_block_max(optin))
    keys, table, mask = _cuda_probe_case(T)
    ck.reset_launches()
    _cuda_probe_exact(keys, table, mask)
    regime, cluster = ck.hash_probe_regime(T, optin)
    assert dict(ck.HASH_PROBE_LAUNCHES.items()) == {(8, 262147, T, regime, cluster): 2}


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("T", [8, 4096, 1 << 17, 1, 32, 33, 16384, 16385, "B", "B+1", 1 << 22])
def test_cuda_dict_filter_matches_plain_form(T, masked):
    # every regime on both sides of each boundary (register 32 | 33 shared;
    # the opt-in bitmap's last entry B | B+1 global) and the global regime at
    # 2^22, the shared bitmap packed by every CTA | by one launch first
    # (DF_CTA_PACK_MAX | + 1), with and without a mask, over wrapped and
    # clamped codes and a ragged N: exact, two runs bitwise identical, the
    # launch recorded under the regime T chooses
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    optin = ck.dict_filter_smem_optin(dev)
    B = ck.dict_filter_bitmap_max(optin)
    T = {"B": B, "B+1": B + 1}.get(T, T)
    codes, lut, mask = _filter_inputs(6, 8, 262147, T)
    codes = _wrapped_codes(codes, T, np.random.default_rng(6))
    codes, lut, mask = (torch.from_numpy(a).to(dev) for a in (codes, lut, mask))
    m = mask if masked else None
    ck.reset_launches()
    k1 = ck.dict_filter(codes, lut, m)
    k2 = ck.dict_filter(codes, lut, m)
    kp = ck.dict_filter_plain(codes, lut, m)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(k1, kp)
    regime = ck.dict_filter_regime(T, optin)
    assert ck.DICT_FILTER_LAUNCHES == {(8, 262147, T, regime, masked): 2}


# ---------------------------------------------------------------------------
# the ORDER BY family: segmented_sort, topk_select, segmented_scan

_I64_MAX = np.iinfo(np.int64).max
_I32_MAX = np.iinfo(np.int32).max


def _sort_inputs(seed, P, N, a_hi=6, b_hi=3, pad=0.125):
    """Triples with ties on a and on (a, b), unique positions, and a tail of
    (i64 max, i64 max, i32 max) padding sentinels."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-a_hi, a_hi, (P, N)).astype(np.int64)
    b = rng.integers(0, b_hi, (P, N)).astype(np.int64)
    pos = np.stack([rng.permutation(N) for _ in range(P)]).astype(np.int32)
    n_pad = int(N * pad)
    if n_pad:
        a[:, -n_pad:] = _I64_MAX
        b[:, -n_pad:] = _I64_MAX
        pos[:, -n_pad:] = _I32_MAX
    return a, b, pos


def _assert_triples_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("N", [1, 64, 1024])
def test_segmented_sort_matches_pallas(P, N):
    from ballista_tpu.ops.tpu.pallas_kernels import segmented_sort as jax_sort

    a, b, pos = _sort_inputs(P * 100 + N, P, N)
    want = jax_sort(a, b, pos)
    got = ck.segmented_sort(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pos))
    _assert_triples_equal(got, want)


@pytest.mark.parametrize("k", [1, 5, 128, 200])
def test_topk_select_matches_pallas(k):
    # 1024 lanes in 8 runs of equal (a, b): every cut falls inside a tie,
    # which only the position operand breaks
    from ballista_tpu.ops.tpu.pallas_kernels import topk_select as jax_topk

    rng = np.random.default_rng(k)
    P, N = 2, 1024
    a = rng.integers(0, 8, (P, N)).astype(np.int64)
    b = np.zeros((P, N), np.int64)
    pos = np.tile(np.arange(N, dtype=np.int32), (P, 1))
    a[:, -64:] = _I64_MAX  # padding
    b[:, -64:] = _I64_MAX
    want = jax_topk(a, b, pos, k)
    got = ck.topk_select(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pos), k)
    assert got[0].shape == (P, k)
    _assert_triples_equal(got, want)


def _scan_inputs(seed, dtype, func, P=2, N=256, p_boundary=0.15):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        v = (rng.uniform(-50, 50, (P, N)) / 3.0).astype(dtype)
        if func != "sum":
            v[rng.random((P, N)) < 0.05] = np.nan
            v[rng.random((P, N)) < 0.08] = 0.0
            v[rng.random((P, N)) < 0.08] = -0.0
            v[rng.random((P, N)) < 0.03] = np.inf
            v[rng.random((P, N)) < 0.03] = -np.inf
    else:
        v = rng.integers(-1000, 1000, (P, N)).astype(dtype)
    f = rng.random((P, N)) < p_boundary
    return v, f


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64],
                         ids=["i32", "i64", "f32", "f64"])
@pytest.mark.parametrize("func", ["sum", "min", "max"])
def test_segmented_scan_matches_pallas(func, dtype):
    # bit for bit in every case, NaN payloads and zero signs included
    from ballista_tpu.ops.tpu.pallas_kernels import segmented_scan as jax_scan

    v, f = _scan_inputs(len(func) * 10 + np.dtype(dtype).itemsize, dtype, func)
    want = np.asarray(jax_scan(v, f, func))
    got = ck.segmented_scan(torch.from_numpy(v), torch.from_numpy(f), func).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = np.int32 if want.itemsize == 4 else np.int64
    np.testing.assert_array_equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("fn", ["maximum", "minimum"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_xla_min_max_follow_jnp(fn, dtype):
    # the scan's float min/max: NaN wins, -0.0 < +0.0 in either order
    import jax.numpy as jnp

    vals = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan], dtype)
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    want = np.asarray(getattr(jnp, fn)(a, b))
    got = getattr(ck, f"xla_{fn}")(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    bits = np.int32 if want.itemsize == 4 else np.int64
    np.testing.assert_array_equal(got.view(bits), want.view(bits))


def test_sort_family_needs_pow2_lanes():
    from ballista_tpu.ops.tpu import pallas_kernels as jpk

    a = np.zeros((1, 6), np.int64)
    p = np.arange(6, dtype=np.int32)[None]
    ta, tp = torch.from_numpy(a), torch.from_numpy(p)
    for jfn, tfn in ((lambda: jpk.segmented_sort(a, a, p), lambda: ck.segmented_sort(ta, ta, tp)),
                     (lambda: jpk.topk_select(a, a, p, 2), lambda: ck.topk_select(ta, ta, tp, 2)),
                     (lambda: jpk.segmented_scan(a, a != 0, "sum"),
                      lambda: ck.segmented_scan(ta, ta != 0, "sum"))):
        with pytest.raises(ValueError, match="pow2"):
            jfn()
        with pytest.raises(ValueError, match="pow2"):
            tfn()
    assert ck.MAX_SORT_LANES == jpk.MAX_SORT_LANES


def test_sort_family_wrappers_count_only_kernel_launches():
    ck.reset_launches()
    a, b, pos = (torch.from_numpy(x) for x in _sort_inputs(3, 2, 64))
    ck.segmented_sort(a, b, pos)
    ck.topk_select(a, b, pos, 3)
    ck.segmented_scan(a, b > 0, "max")
    assert all(ck.LAUNCHES[k] == 0
               for k in ("segmented_sort", "topk_select", "segmented_scan"))


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("N,tile,passes", [(1, 1, 0), (2, 2, 0), (512, 512, 0),
                                           (2048, 2048, 0), (4096, 2048, 1),
                                           (1 << 18, 2048, 7), (1 << 20, 2048, 9)])
def test_sort_plan(P, N, tile, passes):
    # the tile pass writes the output itself when the merge passes are even
    # in number, so the last pass lands there; P does not change the plan
    assert ck.sort_plan(N) == (tile, passes, passes % 2 == 0)
    assert ck.SORT_TILE == 2048


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("N", [1, 4096, 8192, 1 << 20])
def test_scan_plan(P, N):
    tiles, n_bytes = ck.scan_plan(P, N)
    assert tiles == P * max(1, N // 4096)
    # an 8-byte aggregate and a u32 status a tile, and the u32 ticket
    assert n_bytes == tiles * 12 + 4
    assert ck.SCAN_TILE == 4096


def _sort_edge_inputs(kind, P, N, seed=9):
    """Sort inputs of one kind: "random" (ties on a and b), "descending"
    (a zero, as the null-rank plane of a non-null key, and b falling:
    every lane a new minimum), "ties" (every lane equal but for pos) and
    "sentinels" (every lane a padding sentinel, pos included)."""
    a, b, pos = _sort_inputs(seed, P, N, a_hi=1000)
    if kind == "descending":
        a[:] = 0
        b[:] = np.arange(N, 0, -1)
        pos[:] = np.arange(N, dtype=np.int32)
    elif kind == "ties":
        a[:] = 7
        b[:] = 3
    elif kind == "sentinels":
        a[:] = _I64_MAX
        b[:] = _I64_MAX
        pos[:] = _I32_MAX
    return a, b, pos


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,kind", [
    (1, 1 << 20, "random"), (1, 1 << 18, "random"), (4, 4096, "random"), (3, 1, "random"),
    (2, 2, "random"), (3, 512, "random"),  # N below the tile: the tile pass alone
    (1, 16384, "random"), (3, 1 << 15, "random"),  # 3 and 4 merge passes, P > 1
    (2, 1 << 16, "ties"), (2, 1 << 16, "sentinels"), (1, 1 << 20, "ties")])
def test_cuda_segmented_sort_matches_plain_form(P, N, kind):
    dev = _on_card()
    a, b, pos = (torch.from_numpy(x).to(dev) for x in _sort_edge_inputs(kind, P, N))
    r1 = ck.segmented_sort(a, b, pos)
    r2 = ck.segmented_sort(a, b, pos)
    rp = ck.segmented_sort_plain(a, b, pos)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(r1, r2, rp))


@pytest.mark.gpu
def test_cuda_sort_family_from_concurrent_threads():
    # the window stage calls the kernels from one thread per partition:
    # every call's scratch must stay its own until its kernels have run
    from concurrent.futures import ThreadPoolExecutor

    dev = _on_card()

    def one(seed):
        a, b, pos = (torch.from_numpy(x).to(dev) for x in _sort_inputs(seed, 1, 1 << 16, a_hi=1000))
        v, f = (torch.from_numpy(x).to(dev)
                for x in _scan_inputs(seed, np.int64, "sum", P=1, N=1 << 16))
        got = ck.segmented_sort(a, b, pos), ck.segmented_scan(v, f, "sum")
        want = ck.segmented_sort_plain(a, b, pos), ck.segmented_scan_plain(v, f, "sum")
        torch.cuda.synchronize()
        return (all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
                and torch.equal(got[1], want[1]))

    for _ in range(3):
        with ThreadPoolExecutor(16) as pool:
            assert all(pool.map(one, range(32)))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "descending", "ties", "sentinels"])
@pytest.mark.parametrize("N", [1, 2, 512, 2048, 4096, 1 << 20])
def test_cuda_topk_select_matches_plain_form(N, kind):
    # k up to 2048 through the filter (C = 1024 and 2048 at k = 1000 and
    # 1024... 2048), above it through the full sort; P = 3
    dev = _on_card()
    a, b, pos = (torch.from_numpy(x).to(dev) for x in _sort_edge_inputs(kind, 3, N, seed=N))
    for k in (1, 100, 1000, 1024, 3000, 4096):
        r1 = ck.topk_select(a, b, pos, k)
        r2 = ck.topk_select(a, b, pos, k)
        rp = ck.topk_select_plain(a, b, pos, k)
        torch.cuda.synchronize()
        assert all(x.shape == (3, min(k, N)) for x in r1)
        assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(r1, r2, rp))


@pytest.mark.parametrize("P,N,C", [(1, 1 << 20, 128), (3, 1 << 20, 1024), (1, 1, 1),
                                   (2, 2048, 2048), (8, 4096, 128), (200, 1 << 14, 128),
                                   (1, 1 << 20, 4096)])
def test_topk_plan(P, N, C):
    # filter spans are multiples of a block's step and cover each row, about
    # one block an SM in all; scratch holds the blocks' lists (20 B a lane,
    # each i64 array rounded up to 16 B) and 16 levels of tickets a block, or
    # for C above the filter's capacity the full sort's two triples
    blocks, span, n_bytes = ck.topk_plan(P, N, C, 132)
    if C > ck.TOPK_CAP:
        assert (blocks, span) == (0, 0) and n_bytes == 40 * (P * N + (P * N) % 2)
        return
    assert span % ck.TOPK_STEP == 0 and blocks * span >= N > (blocks - 1) * span
    assert blocks == 1 or P * blocks <= 132
    lanes = P * blocks * C
    assert n_bytes == (0 if blocks == 1 else 20 * (lanes + lanes % 2) + 64 * P * blocks)


@pytest.mark.gpu
def test_cuda_select_and_reduce_from_concurrent_threads():
    # topk_select's candidates and tickets and masked_group_reduce's
    # partials are scratch of each call: 16 threads on one stream must each
    # get their own answers
    from concurrent.futures import ThreadPoolExecutor

    dev = _on_card()

    def one(seed):
        a, b, pos = (torch.from_numpy(x).to(dev)
                     for x in _sort_edge_inputs("random", 1, 1 << 18, seed=seed))
        G = (8, 4096)[seed % 2]
        vals, gid, mask = (torch.from_numpy(x).to(dev) for x in _inputs(seed, 8, 1 << 15, G))
        got = ck.topk_select(a, b, pos, 100), ck.masked_group_reduce(vals, gid, mask, G)
        want = (ck.topk_select_plain(a, b, pos, 100),
                ck.masked_group_reduce_plain(vals, gid, mask, G))
        torch.cuda.synchronize()
        return (all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
                and torch.equal(got[1][1], want[1][1])
                and torch.allclose(got[1][0], want[1][0], rtol=1e-4, atol=1e-4))

    for _ in range(3):
        with ThreadPoolExecutor(16) as pool:
            assert all(pool.map(one, range(32)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.float64, np.int32],
                         ids=["i64", "f32", "f64", "i32"])
@pytest.mark.parametrize("func", ["sum", "min", "max"])
def test_cuda_segmented_scan_matches_plain_form(func, dtype):
    # (P, N, boundary share): the path's shape, no boundary across 256
    # tiles, a boundary on every lane, P > 1 over several tiles, rows
    # shorter than a tile, and one lane
    dev = _on_card()
    for P, N, p_boundary in ((1, 1 << 20, 1 / 15), (1, 1 << 20, 0.0), (1, 1 << 20, 1.0),
                             (3, 1 << 14, 0.001), (3, 1024, 0.15), (2, 1, 0.0)):
        v, f = (torch.from_numpy(x).to(dev)
                for x in _scan_inputs(5, dtype, func, P=P, N=N, p_boundary=p_boundary))
        got = ck.segmented_scan(v, f, func)
        again = ck.segmented_scan(v, f, func)
        want = ck.segmented_scan_plain(v, f, func)
        torch.cuda.synchronize()
        bits = torch.int32 if v.element_size() == 4 else torch.int64
        assert torch.equal(got.view(bits), again.view(bits))  # reruns bitwise identical
        if func == "sum" and v.dtype.is_floating_point:
            rtol = 1e-5 if v.dtype == torch.float32 else 1e-12
            scale = ck.segmented_scan_plain(v.abs(), f, "sum")
            assert bool(((got - want).abs() <= rtol * scale).all())
        else:
            assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("name", ["segmented_sort", "topk_select", "segmented_scan"])
def test_sort_family_wrapper_never_falls_back_to_the_plain_form(name):
    # a tensor on a device with no kernel raises instead of quietly taking
    # the plain path (only CPU tensors take it)
    meta = torch.zeros((1, 8), dtype=torch.int64, device="meta")
    pos = meta.to(torch.int32)
    call = {"segmented_sort": lambda: ck.segmented_sort(meta, meta, pos),
            "topk_select": lambda: ck.topk_select(meta, meta, pos, 2),
            "segmented_scan": lambda: ck.segmented_scan(meta, meta.to(torch.bool), "max")}[name]
    with pytest.raises(RuntimeError, match="no kernel"):
        call()
