"""The port's routing and hot-set math against the JAX package.

The same numpy inputs go through `repro.core.sparse` /
`repro.core.hot_sharding` and their `repro_torch` counterparts. Integer
outputs (every `Routing` field, hot sets, counts) must be bit-exact; f32
outputs agree to atol=1e-6 (sums of the same addends in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hot_sharding as jhot
from repro.core import sparse as jsparse
from repro_torch.core import hot_sharding, sparse

# (n, P, block, cap): cap below the unique count per owner forces overflow
ROUTING_CASES = [
    (64, 1, 256, 64),
    (200, 1, 512, 16),
    (96, 4, 16, 12),
    (96, 4, 16, 4),
    (128, 3, 40, 16),
    (1, 2, 8, 16),
]


def _ids(n, p, block, seed, pad_frac=0.2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, p * block, size=n).astype(np.int32)
    # Zipf-like repeats: a third of the slots reuse a few ids
    reuse = rng.random(n) < 0.33
    ids = np.where(reuse, ids[: max(1, n // 16)][rng.integers(
        0, max(1, n // 16), size=n)], ids)
    return np.where(rng.random(n) < pad_frac, -1, ids).astype(np.int32), rng


_jax_route_build = jax.jit(jsparse.route_build, static_argnums=(1, 2, 3))


def _both(ids, p, block, cap):
    j = _jax_route_build(jnp.asarray(ids), p, block, cap)
    t = sparse.route_build(torch.from_numpy(ids), p, block, cap)
    return j, t


@pytest.mark.parametrize("n,p,block,cap", ROUTING_CASES)
def test_route_build_bit_exact(n, p, block, cap):
    ids, _ = _ids(n, p, block, seed=n + p + cap)
    j, t = _both(ids, p, block, cap)
    for field in jsparse.Routing._fields:
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)),
            err_msg=field)


def test_route_build_overflow_counts_dropped_features():
    ids = np.arange(40, dtype=np.int32)          # 40 unique ids, 1 owner
    j, t = _both(ids, 1, 64, 16)
    assert int(t.overflow) == int(j.overflow) == 24
    assert int(t.keep_s.sum()) == 16


@pytest.mark.parametrize("n,p,block,cap", ROUTING_CASES)
def test_route_return_owner_apply_combine(n, p, block, cap):
    ids, rng = _ids(n, p, block, seed=n * 7 + cap)
    j, t = _both(ids, p, block, cap)
    table = rng.normal(size=(block,)).astype(np.float32)
    base = (p - 1) * block
    got = sparse.owner_apply(t.req_ids, torch.from_numpy(table), base)
    want = jsparse.owner_apply(j.req_ids, jnp.asarray(table), base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    resp = rng.normal(size=(p, cap)).astype(np.float32)
    got = sparse.route_return(t, torch.from_numpy(resp))
    want = jsparse.route_return(j, jnp.asarray(resp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    g = rng.normal(size=(n,)).astype(np.float32)
    got = sparse.combine_grads(t, torch.from_numpy(g))
    want = jsparse.combine_grads(j, jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_plain_owner_accumulate_matches_reference():
    rng = np.random.default_rng(5)
    req = rng.integers(-1, 32, size=(2, 24)).astype(np.int32)
    req = np.where(req < 16, -1, req)              # owner block [16, 32)
    g = rng.normal(size=(2, 24)).astype(np.float32)
    acc = rng.normal(size=(16,)).astype(np.float32)
    acc_t = torch.from_numpy(acc.copy())
    got = sparse.owner_accumulate(torch.from_numpy(req), torch.from_numpy(g),
                                  acc_t, 16)
    want = jsparse.owner_accumulate(jnp.asarray(req), jnp.asarray(g),
                                    jnp.asarray(acc), 16)
    assert got is acc_t                            # added in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_hot_bit_exact(seed):
    rng = np.random.default_rng(seed)
    hot = np.sort(rng.choice(200, size=12, replace=False)).astype(np.int32)
    hot = np.concatenate([hot, np.full(4, hot_sharding.INT_MAX, np.int32)])
    ids = rng.integers(-1, 200, size=300).astype(np.int32)
    ids[:12] = hot[:12]
    got = hot_sharding.split_hot(torch.from_numpy(ids), torch.from_numpy(hot))
    want = jhot.split_hot(jnp.asarray(ids), jnp.asarray(hot))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("threshold,max_hot", [(0.0, 8), (0.01, 16),
                                               (0.5, 4), (0.02, 64)])
def test_select_hot_with_ties_bit_exact(threshold, max_hot):
    """Many equal counts: the tie order (lower id first) decides which
    features make the cap, exactly as lax.top_k's order does."""
    rng = np.random.default_rng(max_hot)
    counts = rng.integers(0, 4, size=(100,)).astype(np.int32)
    counts[[3, 17, 50, 99]] = 9                  # tied head
    got = hot_sharding.select_hot(torch.from_numpy(counts), threshold,
                                  max_hot)
    want = jhot.select_hot(jnp.asarray(counts), threshold, max_hot)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_feature_counts_bit_exact():
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 70, size=(16, 8)).astype(np.int32)
    got = hot_sharding.feature_counts(torch.from_numpy(ids), 64)
    want = jhot.feature_counts(jnp.asarray(ids), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
