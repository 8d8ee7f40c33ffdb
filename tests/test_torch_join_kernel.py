"""The CPU engine's join matching (`ops/cpu/join_kernel.PreparedBuild`):
string and binary keys are matched with Arrow's hash kernels in the port,
and every (build, probe) pair must come out as the JAX package's numpy
form gives it, in the same order.
"""

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.ops.cpu import join_kernel as ref_jk
from ballista_tpu_torch.ops.cpu import join_kernel as jk

WORDS = ["", "a", "A", "ab", "b", "zz", "ä", "é", "日本", "😀", "a\x00b", "Brand#13", "Brand#3"]


def _strings(rng, n, null_share, typ):
    vals = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    nulls = rng.random(n) < null_share
    out = pa.array([None if z else v for v, z in zip(vals, nulls)], pa.string())
    if pa.types.is_binary(typ) or pa.types.is_large_binary(typ):
        out = pa.array([None if v is None else v.encode() for v in out.to_pylist()], typ)
    return out.cast(typ)


def _pairs(mod, build, probe, chunked):
    if chunked:
        probe = [pa.chunked_array([c[: len(c) // 2], c[len(c) // 2:]]) for c in probe]
    return mod.PreparedBuild(build).match(probe)


@pytest.mark.parametrize("typ", [pa.string(), pa.large_string(), pa.binary(), pa.large_binary()],
                         ids=str)
@pytest.mark.parametrize("null_share", [0.0, 0.2])
@pytest.mark.parametrize("chunked", [False, True], ids=["array", "chunked"])
def test_string_keys_match_as_the_reference(typ, null_share, chunked):
    rng = np.random.default_rng(7)
    build = [_strings(rng, 400, null_share, typ)]
    probe = [_strings(rng, 900, null_share, typ)]
    got = _pairs(jk, build, probe, chunked)
    want = _pairs(ref_jk, build, probe, chunked)
    assert len(got[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("null_share", [0.0, 0.1])
def test_mixed_string_and_int_keys_match_as_the_reference(null_share):
    rng = np.random.default_rng(11)
    ints = lambda n: pa.array(rng.integers(0, 5, n), pa.int64())  # noqa: E731
    build = [_strings(rng, 600, null_share, pa.string()), ints(600),
             _strings(rng, 600, null_share, pa.string())]
    probe = [_strings(rng, 800, null_share, pa.string()), ints(800),
             _strings(rng, 800, null_share, pa.string())]
    got = _pairs(jk, build, probe, False)
    want = _pairs(ref_jk, build, probe, False)
    assert len(got[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_probe_values_absent_from_the_build_never_match():
    build = [pa.array(["x", "y", None], pa.string())]
    probe = [pa.array(["y", "q", None, "", "x", "y"], pa.string())]
    b, p = jk.PreparedBuild(build).match(probe)
    assert list(zip(b.tolist(), p.tolist())) == [(1, 0), (0, 4), (1, 5)]
    assert jk.PreparedBuild([pa.array([], pa.string())]).match(probe)[0].size == 0


def _ints(rng, n, lo, hi, null_share):
    vals = rng.integers(lo, hi, n)
    nulls = rng.random(n) < null_share
    return pa.array([None if z else int(v) for v, z in zip(vals, nulls)], pa.int64())


@pytest.mark.parametrize("lo,hi", [(0, 50), (-20, 20), (10**6, 10**6 + 3000),
                                   (0, 10**12), (-(2**62), 2**62)],
                         ids=["small", "negative", "offset", "sparse", "wide"])
@pytest.mark.parametrize("null_share", [0.0, 0.1])
def test_int_keys_match_as_the_reference(lo, hi, null_share):
    """Dense ranges take the code tables, sparse ones the binary search;
    the probe side reaches past the build's range on both ends."""
    rng = np.random.default_rng(3)
    build = [_ints(rng, 700, lo, hi, null_share)]
    span = hi - lo
    probe = [_ints(rng, 1500, lo - span // 4, hi + span // 4, null_share)]
    for two_keys in (False, True):
        b = build + ([_ints(rng, 700, 0, 3, null_share)] if two_keys else [])
        p = probe + ([_ints(rng, 1500, 0, 4, null_share)] if two_keys else [])
        got = _pairs(jk, b, p, False)
        want = _pairs(ref_jk, b, p, False)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_extreme_probe_values_do_not_wrap_into_a_dense_build():
    top = np.iinfo(np.int64).max
    build = [pa.array([top - 10, top - 3, top], pa.int64())]
    probe = [pa.array([np.iinfo(np.int64).min + 3, top - 3, 0, top], pa.int64())]
    b, p = jk.PreparedBuild(build).match(probe)
    assert list(zip(b.tolist(), p.tolist())) == [(1, 1), (2, 3)]


def test_float_keys_with_nan_match_as_the_reference():
    rng = np.random.default_rng(5)
    vals = lambda n: pa.array(  # noqa: E731
        [None if v < 0.1 else (float("nan") if v < 0.2 else float(int(v * 20)))
         for v in rng.random(n)], pa.float64())
    build, probe = [vals(300)], [vals(600)]
    got = _pairs(jk, build, probe, False)
    want = _pairs(ref_jk, build, probe, False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
