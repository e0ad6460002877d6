"""The port's sliding-window attention against the JAX package's, on the
CPU.

- `layers.blocked_causal_attention(window=W)`, values and gradients
  (`jax.grad` against torch autograd) within 1e-5 in f32, on the
  reference's `_swa_attention` schedule: S a multiple of `q_block` and
  not (then one q block), S <= W and S > W, kv blocks with and without a
  remainder block, W not a multiple of the kv block;
- `layers.causal_self_attention(window=W)`, prefill's attention, takes
  that schedule and launches no kernel;
- `layers.decode_attention(window=W)` over a ring cache, with cache
  lengths below, at and beyond the ring's size, against the reference's
  within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.models import layers

TOL = 1e-5

SWA_CASES = {
    # name: (S, window, q_block, kv_block)
    "S > W, whole blocks": (64, 16, 16, 16),
    "S > W, remainder kv block": (64, 20, 16, 10),
    "S > W, S not a multiple of q_block": (60, 16, 16, 16),
    "S == W": (32, 32, 16, 16),
    "S < W, whole blocks": (24, 32, 8, 16),
    "S < W, S not a multiple of q_block": (20, 32, 16, 12),
}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", sorted(SWA_CASES))
def test_swa_attention_values_and_grads(case):
    s, window, q_block, kv_block = SWA_CASES[case]
    kw = dict(window=window, q_block=q_block, kv_block=kv_block)
    rng = np.random.default_rng(s + window)
    b, h, kh, d = 2, 4, 2, 16
    q, k, v, w = (rng.normal(size=shape).astype(np.float32) for shape in
                  ((b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))

    def jloss(q, k, v):
        out = jlayers.blocked_causal_attention(q, k, v, **kw)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.blocked_causal_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(torch.sum(out * _t(w)), (tq, tk, tv))
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    _close(out.detach(), jout)
    for got, want in zip(grads, jgrads, strict=True):
        _close(got, want)
    # S > W: the window matters (full causal attention differs); S <= W:
    # every query sees all its keys, as under full causal attention
    full = jlayers.blocked_causal_attention(q, k, v, q_block=q_block,
                                            kv_block=kv_block)
    gap = np.abs(np.asarray(full) - np.asarray(jout)).max()
    assert gap > 1e-3 if s > window else gap < TOL


def test_prefill_swa_takes_the_blocked_schedule():
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    want = jlayers.blocked_causal_attention(q, k, v, window=8)
    before = ops.launch_counts()["flash_attention"]
    got = layers.causal_self_attention(_t(q), _t(k), _t(v), window=8)
    assert ops.launch_counts()["flash_attention"] == before
    _close(got, want)


@pytest.mark.parametrize("lengths", [(3, 8), (8, 9), (13, 21)])
def test_decode_attention_window_matches_reference(lengths):
    """A ring of 8 slots; a cache length past 8 means every slot holds a
    position of the window, so every slot is valid."""
    rng = np.random.default_rng(sum(lengths))
    b, slots, h, kh, d = 2, 8, 4, 2, 16
    q, kc, vc = (rng.normal(size=shape).astype(np.float32) for shape in
                 ((b, 1, h, d), (b, slots, kh, d), (b, slots, kh, d)))
    cache_len = np.asarray(lengths, np.int32)
    want = jlayers.decode_attention(q, kc, vc, jnp.asarray(cache_len),
                                    window=8)
    got = layers.decode_attention(_t(q), _t(kc), _t(vc), _t(cache_len),
                                  window=8)
    assert got.shape == (b, 1, h, d)
    _close(got, want)
    # without the window: the slots below cache_len
    plain = layers.decode_attention(_t(q), _t(kc), _t(vc), _t(cache_len))
    _close(plain, jlayers.decode_attention(q, kc, vc,
                                           jnp.asarray(cache_len)))
