"""The PyTorch port's kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both. The JAX kernel
runs in interpret mode on the CPU (as tests/test_fusion.py runs it); the
port's wrapper, given CPU tensors, runs its plain PyTorch form. Counts
must match exactly; f32 sums within rtol 1e-4 / atol 1e-4, the JAX
package's own bound for this kernel (tests/test_fusion.py). Tests of the
hand-written CUDA kernel itself need the card: they carry the `gpu`
marker and skip elsewhere.
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
