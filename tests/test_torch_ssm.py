"""The port's chunked linear attention and the zamba2 hybrid (Mamba2 blocks
and a shared attention block) against the JAX package's, on the CPU.

The same numpy inputs go through both packages:
- `ssm_common.chunked_linear_attention` with and without the normaliser
  (with it, on q, k >= 0: see `_lin_inputs`) and the final state, at
  S = 48 (one chunk) and S = 256 (two chunks of 128), and its gradients
  (finite where the reference's are NaN, ROADMAP C24);
  `linear_attention_step`; within 1e-5 of the largest |value| (f32
  sums of up to a chunk's products in other orders);
- `mamba.mamba_block` (with the conv tail and SSD state it hands decode,
  at S = 2, below the conv's K - 1 = 3, and S = 20) and
  `mamba_decode_step`, within 1e-5;
- zamba2 at `smoke_config` (4 layers, the shared block every 2, SSM
  state 16): `forward`, `prefill` and 3 `decode_step`s (logits and every
  cache leaf), within 1e-4, weights carried by `convert` with the norm
  scales redrawn as 1 + N(0, 0.1^2) (ROADMAP C7) and `A_log`, `dt_bias`,
  `D_skip` redrawn away from the port's init (A_log ~ N(0, 0.5^2), dt_bias
  ~ N(0, 0.5^2), D_skip ~ 1 + N(0, 0.1^2)); greedy tokens equal; in bf16
  prefill and decode within the reference's bf16 tolerance of 2e-2;
- decode after prefill(S) against prefill(S + t)'s last logits in the
  port (the SSM state handoff), within 1e-4, as in the reference;
- a zamba2 tree through `convert` both ways (the stacked mamba layers
  and the unstacked shared block). The dense checkpoints across packages
  and the CLIs of the three families are tests/test_torch_train_launch.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig
from repro.models import mamba as jmamba
from repro.models import registry as jregistry
from repro.models import ssm_common as jssm
from repro.models.common import embed_init_scale
from repro.sharding import init_from_defs
from repro.train import serve as jserve
from repro_torch import convert
from repro_torch.models import mamba, registry, ssm_common
from repro_torch.train import serve

ARCH = "zamba2-2.7b"
TOL = 1e-4
BLOCK_TOL = 1e-5
BF16_TOL = 2e-2
PARALLEL = ParallelConfig(seq_shard=False, remat="none")
B, S = 2, 16
NORMS = ("ln1", "ln2", "ln_f", "norm", "out_norm")


def _close(got, want, tol=TOL):
    got = got.detach().to(torch.float32).numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol=BLOCK_TOL):
    """Within `tol` of the largest |value|: the products sum up to L * Dk
    terms (and the state a chunk's worth of them) in another order in
    each package, an error that grows with the values' scale."""
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _redraw(key, x, rng):
    """Norm scales 1 + N(0, 0.1^2); the SSM's scalars away from the
    port's init."""
    if key in NORMS or key == "D_skip":
        return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
    if key in ("A_log", "dt_bias"):
        return (0.5 * rng.normal(size=x.shape)).astype(x.dtype)
    return x


def _tree(cfg, seed=0):
    params = init_from_defs(jregistry.get_spec(ARCH).defs(cfg),
                            jax.random.PRNGKey(seed),
                            scale_fn=embed_init_scale)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: _redraw(path[-1].key, np.asarray(x), rng), params)


def _setup(dtype="float32", seed=0):
    jcfg = dataclasses.replace(jregistry.smoke_config(ARCH), dtype=dtype)
    cfg = dataclasses.replace(registry.smoke_config(ARCH), dtype=dtype)
    tree = _tree(jcfg, seed)
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, size=(B, S + 8)).astype(np.int32)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from_numpy(tree, cfg, "cpu"), tokens


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the chunked linear attention
# ---------------------------------------------------------------------------


def _lin_inputs(s, seed=0, positive=False, decay=1.0):
    """q, k, v and log_a = -decay * softplus(N(0, 1)) <= 0. With
    `positive`, q and k >= 0: the normaliser divides by |q . n|, which
    random signs bring arbitrarily near 0, where either package's f32
    rounding is amplified without bound; with q, k >= 0 the divisor
    stays away from 0."""
    rng = np.random.default_rng(seed)
    q, k = _rand(rng, 2, s, 3, 8), _rand(rng, 2, s, 3, 8)
    if positive:
        q, k = np.abs(q), np.abs(k)
    v = _rand(rng, 2, s, 3, 6)
    log_a = (-decay * np.log1p(np.exp(_rand(rng, 2, s, 3)))).astype(
        np.float32)
    return q, k, v, log_a


@pytest.mark.parametrize("s,normalize,state", [
    (48, False, False), (48, True, True), (256, False, True),
    (256, True, False)])
def test_chunked_linear_attention_matches_reference(s, normalize, state):
    args = _lin_inputs(s, positive=normalize)
    want = jssm.chunked_linear_attention(
        *map(jnp.asarray, args), normalize=normalize, return_state=state)
    got = ssm_common.chunked_linear_attention(
        *map(torch.from_numpy, args), normalize=normalize,
        return_state=state)
    if state:
        (got, (gs, gn)), (want, (ws, wn)) = got, want
        _close_scaled(gs, ws)
        _close_scaled(gn, wn)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_scaled(got, want)


def _grads(args, normalize=True):
    """The gradients of sum(y * r) with respect to q, k, v and log_a in
    both packages: (port's, reference's)."""
    r = np.random.default_rng(4).normal(
        size=args[2].shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jssm.chunked_linear_attention(*a, normalize=normalize)
                       * r)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = ssm_common.chunked_linear_attention(*ts, normalize=normalize)
    return torch.autograd.grad((y * torch.from_numpy(r)).sum(), ts), want


def test_chunked_linear_attention_grads_match_reference():
    """Two chunks with the normaliser, decays whose products over a chunk
    stay inside f32 (log_a ~ -0.16 a step): the gradients against
    `jax.grad`'s, all finite."""
    got, want = _grads(_lin_inputs(256, seed=3, positive=True, decay=0.2))
    for g, w in zip(got, want, strict=True):
        assert np.isfinite(np.asarray(w)).all()
        _close_scaled(g, w)


def test_chunked_linear_attention_grads_finite_where_reference_nan():
    """ROADMAP C24: at decays of ~e^-0.8 a step, exp(cum_i - cum_j) above
    the chunk's diagonal overflows to inf and the reference's where() gives
    the gradient 0 * inf = NaN; the port masks in log space, so its
    values are the reference's and its gradients finite."""
    args = _lin_inputs(256, seed=3, positive=True)
    got, want = _grads(args, normalize=False)
    assert not all(np.isfinite(np.asarray(w)).all() for w in want)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_scaled(ssm_common.chunked_linear_attention(
        *map(torch.from_numpy, args)), jssm.chunked_linear_attention(
            *map(jnp.asarray, args)))


def test_chunk_must_divide_the_sequence():
    args = [torch.from_numpy(a) for a in _lin_inputs(200)]
    with pytest.raises(ValueError, match="S = 200"):
        ssm_common.chunked_linear_attention(*args)


@pytest.mark.parametrize("normalize", [False, True])
def test_linear_attention_step_matches_reference(normalize):
    rng = np.random.default_rng(5)
    state = _rand(rng, 2, 3, 8, 6)
    q, k, v = _rand(rng, 2, 3, 8), _rand(rng, 2, 3, 8), _rand(rng, 2, 3, 6)
    log_a = -np.abs(_rand(rng, 2, 3))
    norm = _rand(rng, 2, 3, 8)
    want = jssm.linear_attention_step(
        *map(jnp.asarray, (state, q, k, v, log_a)),
        norm_state=jnp.asarray(norm), normalize=normalize)
    got = ssm_common.linear_attention_step(
        *map(torch.from_numpy, (state, q, k, v, log_a)),
        norm_state=torch.from_numpy(norm), normalize=normalize)
    for g, w in zip(got, want, strict=True):
        _close(g, w, BLOCK_TOL)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _layer(model, tree, i=0):
    """Layer i of the port's model and of the reference's stacked tree."""
    return model.layers[i], jax.tree.map(lambda a: a[i], tree["layers"])


@pytest.mark.parametrize("s", [2, 20])
def test_mamba_block_and_decode_step_match_reference(s):
    jcfg, cfg, jparams, model, _ = _setup()
    lp, jlp = _layer(model, jparams, 1)
    rng = np.random.default_rng(s)
    x = _rand(rng, B, s, cfg.d_model)
    want, (wtail, wstate) = jmamba.mamba_block(jlp, jnp.asarray(x), jcfg,
                                               return_state=True)
    with torch.no_grad():
        got, (tail, state) = mamba.mamba_block(lp, torch.from_numpy(x), cfg,
                                               return_state=True)
    _close(got, want, BLOCK_TOL)
    _close(tail, wtail, BLOCK_TOL)
    _close(state, wstate, BLOCK_TOL)
    x1 = _rand(rng, B, 1, cfg.d_model)
    want = jmamba.mamba_decode_step(jlp, jnp.asarray(x1), jcfg, wtail,
                                    wstate)
    with torch.no_grad():
        got = mamba.mamba_decode_step(lp, torch.from_numpy(x1), cfg, tail,
                                      state)
    for g, w in zip(got, want, strict=True):
        _close(g, w, BLOCK_TOL)


def test_softplus_is_logaddexp():
    x = np.array([-100.0, -20.5, -1.0, 0.0, 1.0, 20.5, 40.0, 100.0],
                 np.float32)
    _close(mamba.softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)), 1e-7)


# ---------------------------------------------------------------------------
# zamba2
# ---------------------------------------------------------------------------


def _close_cache(cache, jcache, tol=TOL):
    for name in ("conv", "ssd", "k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape, name
        _close(cache[name], jcache[name], tol)
    assert np.array_equal(cache["length"].numpy(),
                          np.asarray(jcache["length"]))


def test_zamba_forward_matches_reference():
    jcfg, cfg, jparams, model, tokens = _setup()
    batch = tokens[:, :S]
    want, _ = jregistry.get_spec(ARCH).forward(
        jparams, {"tokens": jnp.asarray(batch)}, jcfg, PARALLEL)
    got, aux = registry.get_spec(ARCH).forward(
        model, {"tokens": torch.from_numpy(batch)}, cfg, None)
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba_prefill_and_decode_match_reference(dtype):
    tol = TOL if dtype == "float32" else BF16_TOL
    jcfg, cfg, jparams, model, tokens = _setup(dtype)
    jspec, spec = jregistry.get_spec(ARCH), registry.get_spec(ARCH)
    jlogits, jcache = jspec.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])}, jcfg, PARALLEL)
    logits, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :S])}, cfg)
    _close(logits, jlogits, tol)
    _close_cache(cache, jcache, tol)
    assert cache["ssd"].dtype == torch.float32
    assert cache["k"].shape[2] == S + 32 and not cache["k"][:, :, S:].any()
    for t in range(S, S + 3):
        step = tokens[:, t:t + 1]
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        _close(logits, jlogits, tol)
        _close_cache(cache, jcache, tol)


def test_zamba_decode_after_prefill_matches_longer_prefill():
    """The SSM state handoff: decode after prefill(S), teacher-forced,
    gives prefill(S + t)'s last logits."""
    _, cfg, _, model, tokens = _setup(seed=2)
    spec = registry.get_spec(ARCH)
    _, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :S])}, cfg)
    for t in range(S, S + 4):
        logits, cache = spec.decode_step(
            model, cache, torch.from_numpy(tokens[:, t:t + 1]), cfg)
        oracle, _ = spec.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :t + 1])}, cfg)
        _close(logits, oracle)


def test_zamba_greedy_decode_matches_reference():
    jcfg, cfg, jparams, model, tokens = _setup(seed=3)
    want = jserve.greedy_decode(jregistry.get_spec(ARCH), jcfg, jparams,
                                {"tokens": jnp.asarray(tokens[:, :S])}, 8,
                                PARALLEL)
    got = serve.greedy_decode(registry.get_spec(ARCH), cfg, model,
                              {"tokens": tokens[:, :S]}, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zamba_params_round_trip():
    """The stacked mamba layers and the one shared block, both ways, for
    serving and for training; a wrong shape is refused."""
    jcfg, cfg, _, _, _ = _setup()
    tree = jax.tree.map(np.asarray, _tree(jcfg))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for train_ in (False, True):
        model = convert.params_from_numpy(tree, cfg, "cpu", train=train_)
        assert isinstance(model, mamba.Zamba)
        assert model.layers[0].conv.dtype == torch.float32
        back = list(convert.tree_leaves(convert.params_to_numpy(model)))
        assert [p for p, _ in back] == [tuple(k.key for k in p)
                                        for p, _ in flat]
        for (_, got), (_, want) in zip(back, flat, strict=True):
            np.testing.assert_array_equal(got, want)
    tree["shared"]["attn"]["wq"] = tree["shared"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="shared/attn/wq"):
        convert.params_from_numpy(tree, cfg, "cpu")

