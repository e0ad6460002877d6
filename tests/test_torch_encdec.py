"""The port's encoder-decoder (whisper-small's family) against the JAX
package's, on the CPU.

The same numpy inputs go through both packages:
- `layers.layer_norm` (no bias) within 1e-6, and `sinusoidal_positions`
  bit for bit in f32 and bf16 (float64 in numpy, then rounded);
- `layers._bidirectional_blocked` (training's non-causal attention),
  values and gradients within 1e-5, with blocks that divide (several q
  and kv blocks) and that do not (one block), Sq != Skv and GQA;
- whisper at `smoke_config` (2 encoder and 2 decoder layers, gelu MLP,
  no RoPE), 24 encoder frames against a 12-token prompt: `forward`,
  `prefill` and 3 `decode_step`s (logits, self- and cross-K/V) within
  1e-4, weights carried by `convert` with the norm scales redrawn as
  1 + N(0, 0.1^2) (ROADMAP C7); greedy tokens equal; in bf16 within the
  reference's bf16 tolerance of 2e-2. The vocab pads to a multiple of
  256, so `lm_head`'s in-place mask of the padded logits runs under
  autograd: its gradient into the masked columns is 0;
- decode after prefill(S) against prefill(S + t)'s last logits in the
  port, within 1e-4;
- the tree (encoder, ln_enc, decoder layers) through `convert` both
  ways (checkpoints across packages and the CLIs, frames from the
  loader and drawn as the reference draws them:
  tests/test_torch_train_launch.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models.common import embed_init_scale
from repro.sharding import init_from_defs
from repro.train import serve as jserve
from repro_torch import convert
from repro_torch.models import common, encdec, layers, registry
from repro_torch.train import serve

ARCH = "whisper-small"
TOL = 1e-4
BLOCK_TOL = 1e-5
BF16_TOL = 2e-2
PARALLEL = ParallelConfig(seq_shard=False, remat="none")
B, S, S_ENC = 2, 12, 24
NORMS = ("ln1", "ln2", "lnx", "ln_enc", "ln_f")


def _close(got, want, tol=TOL):
    got = got.detach().to(torch.float32).numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tree(cfg, seed=0):
    params = init_from_defs(jregistry.get_spec(ARCH).defs(cfg),
                            jax.random.PRNGKey(seed),
                            scale_fn=embed_init_scale)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key in NORMS:
            x = (1.0 + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _setup(dtype="float32", seed=0):
    jcfg = dataclasses.replace(jregistry.smoke_config(ARCH), dtype=dtype)
    cfg = dataclasses.replace(registry.smoke_config(ARCH), dtype=dtype)
    tree = _tree(jcfg, seed)
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S + 8)).astype(
        np.int32)
    frames = rng.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from_numpy(tree, cfg, "cpu"), tokens, frames


def _batches(tokens, frames, s=S):
    b = {"tokens": tokens[:, :s], "frames": frames}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layer_norm_and_positions_match_reference():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.normal(size=(2, 5, 64))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    _close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             1e-5),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
           1e-6)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = layers.sinusoidal_positions(1500, 768, dt)
        want = jlayers.sinusoidal_positions(1500, 768, jdt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("sq,skv,h,kh,qb,kb", [
    (64, 48, 4, 2, 16, 16),      # 4 q blocks, 3 kv blocks
    (20, 36, 4, 4, 16, 16),      # neither divides: one block each
])
def test_bidirectional_blocked_values_and_grads(sq, skv, h, kh, qb, kb):
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, h, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, kh, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, kh, 16)).astype(np.float32)
    r = rng.normal(size=(2, sq, h, 16)).astype(np.float32)

    def jloss(q, k, v):
        out = jlayers._bidirectional_blocked(q, k, v, qb, kb)
        return jnp.sum(out * r), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = layers._bidirectional_blocked(*ts, qb, kb)
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(), ts)
    _close(out, want, BLOCK_TOL)
    for g, w in zip(got, grads, strict=True):
        _close(g, w, BLOCK_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_encdec_forward_matches_reference():
    jcfg, cfg, jparams, model, tokens, frames = _setup()
    jb, tb = _batches(tokens, frames)
    want, _ = jregistry.get_spec(ARCH).forward(jparams, jb, jcfg, PARALLEL)
    got, aux = registry.get_spec(ARCH).forward(model, tb, cfg, None)
    assert float(aux) == 0.0 and got.shape == want.shape
    _close(got, want)


def test_lm_head_mask_under_autograd():
    """whisper's vocab (51,865) pads to 51,968: the padded logits are
    masked in place under autograd, and no gradient reaches them."""
    full = registry.get_spec(ARCH).cfg
    assert common.padded_vocab(full) == 51968
    cfg = dataclasses.replace(registry.smoke_config(ARCH), vocab_size=250)
    table = torch.randn(64, common.padded_vocab(cfg), requires_grad=True)
    x = torch.randn(2, 3, 64)
    logits = common.lm_head(table, x, cfg)
    assert bool((logits[..., 250:] == -1e30).all())
    (g,) = torch.autograd.grad(torch.logsumexp(logits, -1).sum(), table)
    assert not g[:, 250:].any() and g[:, :250].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_prefill_and_decode_match_reference(dtype):
    tol = TOL if dtype == "float32" else BF16_TOL
    jcfg, cfg, jparams, model, tokens, frames = _setup(dtype)
    jspec, spec = jregistry.get_spec(ARCH), registry.get_spec(ARCH)
    jb, tb = _batches(tokens, frames)
    jlogits, jcache = jspec.prefill(jparams, jb, jcfg, PARALLEL)
    logits, cache = spec.prefill(model, tb, cfg)
    _close(logits, jlogits, tol)

    def close_cache():
        for name in ("k", "v", "xk", "xv"):
            assert tuple(cache[name].shape) == jcache[name].shape, name
            _close(cache[name], jcache[name], tol)
        assert np.array_equal(cache["length"].numpy(),
                              np.asarray(jcache["length"]))

    close_cache()
    assert cache["xk"].shape[2] == S_ENC and cache["k"].shape[2] == S + 32
    for t in range(S, S + 3):
        step = tokens[:, t:t + 1]
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        _close(logits, jlogits, tol)
        close_cache()


def test_encdec_decode_after_prefill_matches_longer_prefill():
    _, cfg, _, model, tokens, frames = _setup(seed=2)
    spec = registry.get_spec(ARCH)
    _, cache = spec.prefill(model, _batches(tokens, frames)[1], cfg)
    for t in range(S, S + 4):
        logits, cache = spec.decode_step(
            model, cache, torch.from_numpy(tokens[:, t:t + 1]), cfg)
        oracle, _ = spec.prefill(model, _batches(tokens, frames, t + 1)[1],
                                 cfg)
        _close(logits, oracle)


def test_encdec_greedy_decode_matches_reference():
    jcfg, cfg, jparams, model, tokens, frames = _setup(seed=3)
    jb, _ = _batches(tokens, frames)
    want = jserve.greedy_decode(jregistry.get_spec(ARCH), jcfg, jparams, jb,
                                8, PARALLEL)
    got = serve.greedy_decode(registry.get_spec(ARCH), cfg, model,
                              {"tokens": tokens[:, :S], "frames": frames}, 8,
                              device="cpu")
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encdec_params_round_trip():
    """The encoder's and the decoder's stacked layers and ln_enc, both
    ways, for serving and for training; a wrong shape is refused."""
    jcfg, cfg, _, _, _, _ = _setup()
    tree = jax.tree.map(np.asarray, _tree(jcfg))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for train_ in (False, True):
        model = convert.params_from_numpy(tree, cfg, "cpu", train=train_)
        assert isinstance(model, encdec.EncDec)
        back = list(convert.tree_leaves(convert.params_to_numpy(model)))
        assert [p for p, _ in back] == [tuple(k.key for k in p)
                                        for p, _ in flat]
        for (_, got), (_, want) in zip(back, flat, strict=True):
            np.testing.assert_array_equal(got, want)
    tree["encoder"]["mlp"]["wi"] = tree["encoder"]["mlp"]["wi"][:1]
    with pytest.raises(ValueError, match="encoder/mlp/wi"):
        convert.params_from_numpy(tree, cfg, "cpu")

