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


def _inexact_blocks(nblocks, seed):
    """Blocks each of whose max|x| / 127 is not the product max|x| *
    (1 / 127) in f32: where a division by a scalar run as a product with
    its reciprocal (CUDA's) gives other scales, and so other codes."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < nblocks:
        b = rng.normal(size=compression.BLOCK).astype(np.float32)
        amax = np.max(np.abs(b))
        if amax / np.float32(127.0) != amax * (np.float32(1.0)
                                               / np.float32(127.0)):
            out.append(b)
    return np.concatenate(out)


def test_quantize_scales_are_a_division():
    """The scale is max|x| / 127 as an IEEE f32 division, bit for bit as
    the reference's, on blocks where the product with the reciprocal
    rounds otherwise (ROADMAP C33)."""
    x = _inexact_blocks(4, 11)
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    amax = np.max(np.abs(x.reshape(-1, compression.BLOCK)), axis=1)
    np.testing.assert_array_equal(s.numpy()[:, 0], amax / np.float32(127.0))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


PSUM_SHAPES = {"blocks": (3, 2048), "ragged": (50, 100)}   # 5,000 values


@pytest.mark.parametrize("name", sorted(PSUM_SHAPES))
def test_compress_codes_bit_exact(name):
    """The wire format of g + err, a leaf of whole blocks and one that is
    not (5,000 values: a padded last block), as the reference's
    compress_psum quantizes it: codes, scales and the new error."""
    rng = np.random.default_rng(7)
    g = rng.normal(size=PSUM_SHAPES[name]).astype(np.float32)
    e = (1e-2 * rng.normal(size=g.shape)).astype(np.float32)
    q, s, err = compression.compress_codes(torch.from_numpy(g),
                                           torch.from_numpy(e))
    flat = jnp.pad(jnp.asarray(g).reshape(-1) + jnp.asarray(e).reshape(-1),
                   (0, (-g.size) % jcomp.BLOCK))
    jq, js = jcomp.quantize(flat)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    jerr = flat[:g.size] - jcomp.dequantize(jq, js, g.size)
    np.testing.assert_array_equal(
        err.numpy().view(np.int32),
        np.asarray(jerr).reshape(g.shape).view(np.int32))


def test_wire_bytes_and_error_state_match():
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 48), "b": (7,), "c": (3, 2048)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    assert compression.wire_bytes(tparams) == jcomp.wire_bytes(
        {k: jnp.asarray(v) for k, v in params.items()})
    err = compression.init_error_state(tparams)
    assert all(err[k].dtype == torch.float32 and tuple(err[k].shape) == s
               and not err[k].any() for k, s in shapes.items())
