"""The port's compression primitives against `repro.optim.compression`.

The same numpy inputs go through both packages. The int8 codes, scales,
dequantized values, k and the top-k selection must be bit-exact: the
arithmetic is the same IEEE f32 division, rounding and product in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.optim import compression


def _blocks(nblocks, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=nblocks * compression.BLOCK) * scale).astype(
        np.float32)


@pytest.mark.parametrize("nblocks,seed,scale", [(1, 0, 1.0), (3, 1, 1e-3),
                                                (4, 2, 50.0)])
def test_quantize_dequantize_bit_exact(nblocks, seed, scale):
    x = _blocks(nblocks, seed, scale)
    x[5] = 0.0                                   # a zero in a live block
    if nblocks > 1:
        x[compression.BLOCK:2 * compression.BLOCK] = 0.0   # scale floor
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    n = x.size - 7
    d = compression.dequantize(q, s, n)
    jd = jcomp.dequantize(jq, js, n)
    assert d.shape == (n,)
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))


def test_round_half_to_even_like_jnp():
    """Codes at exact halves round to the even neighbour in both packages:
    scale 1.0 (max |x| = 127) makes x / scale the value itself."""
    x = np.zeros(compression.BLOCK, np.float32)
    halves = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5],
                        np.float32)
    x[:halves.size] = halves
    x[-1] = 127.0
    q, s = compression.quantize(torch.from_numpy(x))
    jq, _ = jcomp.quantize(jnp.asarray(x))
    assert float(s) == 1.0
    assert q[0, :halves.size].tolist() == [0, 2, 2, 0, -2, -2, 126, -4]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("n", [1, 7, 1024, 262144])
@pytest.mark.parametrize("frac", [0.0, 1e-7, 0.05, 0.1, 0.25, 0.5, 1.0, 1.5])
def test_topk_count_matches(n, frac):
    assert compression.topk_count(n, frac) == jcomp.topk_count(n, frac)


@pytest.mark.parametrize("shape,k", [((1, 12), 4), ((3, 40), 7),
                                     ((2, 5, 16), 16), ((4, 64), 1)])
def test_topk_select_matches_lax_top_k(shape, k):
    """Indices in lax.top_k's order, ties by position: half the keys are
    drawn from 4 values, so ties are everywhere."""
    rng = np.random.default_rng(k + len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x = np.where(rng.random(shape) < 0.5,
                 rng.integers(0, 4, size=shape).astype(np.float32), x)
    idx, mask = compression.topk_select(torch.from_numpy(x), k)
    jidx, jmask = jcomp.topk_select(jnp.asarray(x), k)
    assert idx.shape == shape[:-1] + (k,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert (mask.sum(-1) == k).all()
