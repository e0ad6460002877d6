"""The port's dense serve path against the JAX package's, on the CPU.

The same weights (the reference's `init_from_defs` at a seed, carried
across by `convert.params_from_numpy`) and the same numpy tokens go
through `spec.prefill`, `spec.decode_step` and `greedy_decode` of both
packages, at smoke size for yi-6b (GQA, swiglu), granite-34b (gelu MLP,
one KV head), chameleon-34b (qk-norm), phi3.5-moe (top-2 of 4 experts)
and mixtral (experts and a window of 8, so that the smoke prompt of 12
wraps the ring). In f32 the two differ only in
the order of f32 sums: logits and caches agree to 1e-4. One bf16 case
holds to the reference's own bf16 tolerance of 2e-2
(tests/test_models.py), since each package rounds its bf16 intermediates
in its own order. The reference draws its stacked norm scales from
N(0, 0.02^2) (ROADMAP C7); the tests replace them by 1 + N(0, 0.1^2) from
numpy, so that the norms shape the result and attention is not near
uniform.

Mixtral's window is also served at prompt lengths S of 8, 16, 12 and 5
against the reference: prefill, 3 decode steps and greedy tokens. The
reference's ring is aligned with positions only when S is a multiple of
the window (ROADMAP C21); the port reproduces it either way. A
teacher-forced oracle at capacity factor 2 (no MoE token dropped, so a
token's output does not depend on its group) shows decode after
prefill(S) equal to prefill(S + t) within 1e-4 at S = 8 and 16, and the
reference's divergence, by more than 0.1, at S = 12 and 5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ParallelConfig
from repro.models import registry as jregistry
from repro.models.common import embed_init_scale
from repro.sharding import init_from_defs
from repro.train import serve as jserve
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common, registry, transformer
from repro_torch.train import serve

ARCHS = ["yi-6b", "granite-34b", "chameleon-34b", "phi3.5-moe-42b-a6.6b",
         "mixtral-8x22b"]
TOL = 1e-4
PARALLEL = ParallelConfig(seq_shard=False, remat="none")
B, S = 2, 12


def _is_norm(path):
    return path[-1] in ("ln1", "ln2", "q_norm", "k_norm")


def _tree(arch, cfg, seed=0):
    """The reference's params at `seed` as numpy, norm scales redrawn."""
    params = init_from_defs(jregistry.get_spec(arch).defs(cfg),
                            jax.random.PRNGKey(seed),
                            scale_fn=embed_init_scale)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if _is_norm(tuple(k.key for k in path)):
            x = (1.0 + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _setup(arch, dtype="float32", seed=0):
    jcfg = dataclasses.replace(jregistry.smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(registry.smoke_config(arch), dtype=dtype)
    tree = _tree(arch, jcfg, seed)
    model = convert.params_from_numpy(tree, cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, size=(B, S + 8)).astype(np.int32)
    return jcfg, cfg, jparams, model, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_cache(cache, jcache, tol=TOL):
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name], jcache[name], tol)
    assert np.array_equal(cache["length"].numpy(),
                          np.asarray(jcache["length"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert dataclasses.asdict(registry.smoke_config(arch)) == \
        dataclasses.asdict(jregistry.smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jcfg, cfg, jparams, model, tokens = _setup(arch)
    batch = tokens[:, :S]
    jlogits, jcache = jregistry.get_spec(arch).prefill(
        jparams, {"tokens": jnp.asarray(batch)}, jcfg, PARALLEL)
    logits, cache = registry.get_spec(arch).prefill(
        model, {"tokens": torch.from_numpy(batch)}, cfg)
    assert logits.dtype == torch.float32
    _close(logits, jlogits)
    _close_cache(cache, jcache)
    if cfg.sliding_window:
        # the ring of the window's last positions, no headroom
        assert cache["k"].shape[2] == min(S, cfg.sliding_window)
        return
    # the decode headroom is zero
    assert cache["k"].shape[2] == S + transformer.PREFILL_EXTRA
    assert not cache["k"][:, :, S:].any() and not cache["v"][:, :, S:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    jcfg, cfg, jparams, model, tokens = _setup(arch)
    jspec, spec = jregistry.get_spec(arch), registry.get_spec(arch)
    _, jcache = jspec.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])},
                              jcfg, PARALLEL)
    _, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :S])}, cfg)
    for t in range(S, S + 3):
        step = tokens[:, t:t + 1]
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        _close(logits, jlogits)
        _close_cache(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference(arch):
    jcfg, cfg, jparams, model, tokens = _setup(arch, seed=3)
    batch = tokens[:, :S]
    want = jserve.greedy_decode(jregistry.get_spec(arch), jcfg, jparams,
                                {"tokens": jnp.asarray(batch)}, 8, PARALLEL)
    got = serve.greedy_decode(registry.get_spec(arch), cfg, model,
                              {"tokens": batch}, 8, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_prefill_and_decode_match_reference():
    jcfg, cfg, jparams, model, tokens = _setup("yi-6b", dtype="bfloat16")
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.dtype == torch.float32
    jspec, spec = jregistry.get_spec("yi-6b"), registry.get_spec("yi-6b")
    jlogits, jcache = jspec.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])}, jcfg, PARALLEL)
    logits, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :S])}, cfg)
    _close(logits, jlogits, 2e-2)
    _close_cache(cache, jcache, 2e-2)
    for t in range(S, S + 2):
        step = tokens[:, t:t + 1]
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        _close(logits, jlogits, 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    """f32: exact. bf16: the matrices come back rounded to bf16 (as the
    reference rounds them at every use), the norm scales exact."""
    jcfg, cfg, _, model, _ = _setup("chameleon-34b", dtype=dtype)
    tree = _tree("chameleon-34b", jcfg)
    back = convert.params_to_numpy(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for path, want in flat:
        keys = tuple(k.key for k in path)
        got = back
        for k in keys:
            got = got[k]
        if dtype == "bfloat16" and want.ndim > 1 and not _is_norm(keys):
            want = torch.tensor(want).bfloat16().float().numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_params_from_numpy_checks_shapes():
    jcfg, cfg, _, _, _ = _setup("yi-6b")
    tree = _tree("yi-6b", jcfg)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="layers/attn/wq"):
        convert.params_from_numpy(tree, cfg, "cpu")


def test_init_params():
    """Ones for the norm scales, N(0, 0.02^2) for the matrices, drawn
    from the generator leaf by leaf: the same seed gives the same model."""
    cfg = dataclasses.replace(registry.smoke_config("chameleon-34b"),
                              dtype="bfloat16")

    def make(seed):
        model = transformer.Transformer(cfg, device="cpu")
        return common.init_params(model, torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters(), strict=True):
        assert torch.equal(pa, pb), name
        if pa.dim() == 1:
            assert pa.dtype == torch.float32 and bool((pa == 1).all()), name
        else:
            assert pa.dtype == torch.bfloat16, name
            assert not torch.equal(pa, pc), name
            assert abs(float(pa.float().std()) - 0.02) < 0.004, name
    names = [n for n, _ in a.named_parameters()]
    assert "layers.1.attn.q_norm" in names and "unembed" in names


def test_launch_serve_on_the_cpu(capsys):
    toks = launch_serve.main(["--arch", "granite-34b", "--device", "cpu",
                              "--batch", "3", "--prompt-len", "9",
                              "--decode-steps", "5"])
    assert toks.shape == (3, 5) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert "decoded (3, 5) on cpu" in capsys.readouterr().out
    again = launch_serve.main(["--arch", "granite-34b", "--device", "cpu",
                               "--batch", "3", "--prompt-len", "9",
                               "--decode-steps", "5"])
    assert torch.equal(toks, again)


SWA_ARCH = "mixtral-8x22b"


def _swa_setup(s, capacity_factor=None):
    jcfg, cfg, jparams, model, _ = _setup(SWA_ARCH)
    if capacity_factor:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    tokens = np.random.default_rng(s).integers(
        0, cfg.vocab_size, size=(B, s + 8)).astype(np.int32)
    return jcfg, cfg, jparams, model, tokens


@pytest.mark.parametrize("s", [8, 16, 12, 5])
def test_swa_serving_matches_reference(s):
    jcfg, cfg, jparams, model, tokens = _swa_setup(s)
    assert cfg.sliding_window == 8
    jspec, spec = jregistry.get_spec(SWA_ARCH), registry.get_spec(SWA_ARCH)
    jlogits, jcache = jspec.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :s])}, jcfg, PARALLEL)
    logits, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :s])}, cfg)
    _close(logits, jlogits)
    _close_cache(cache, jcache)
    for t in range(s, s + 3):
        step = tokens[:, t:t + 1]
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        _close(logits, jlogits)
        _close_cache(cache, jcache)
    want = jserve.greedy_decode(jspec, jcfg, jparams,
                                {"tokens": jnp.asarray(tokens[:, :s])}, 6,
                                PARALLEL)
    got = serve.greedy_decode(spec, cfg, model, {"tokens": tokens[:, :s]},
                              6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [8, 16, 12, 5])
def test_swa_decode_against_the_prefill_oracle(s):
    """Decode after prefill(S), teacher-forced, against prefill(S + t)'s
    last logits, in both packages: equal where the ring is aligned
    (S % W == 0), the reference's divergence reproduced where not."""
    jcfg, cfg, jparams, model, tokens = _swa_setup(s, capacity_factor=2.0)
    jspec, spec = jregistry.get_spec(SWA_ARCH), registry.get_spec(SWA_ARCH)
    _, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :s])}, cfg)
    _, jcache = jspec.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :s])}, jcfg, PARALLEL)
    gaps, jgaps = [], []
    for t in range(s, s + 3):
        step = tokens[:, t:t + 1]
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        oracle, _ = spec.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :t + 1])}, cfg)
        gaps.append(float((logits - oracle).abs().max()))
        jgaps.append(float(np.abs(np.asarray(jlogits)
                                  - oracle.numpy()).max()))
    if s % cfg.sliding_window == 0:
        assert max(gaps) < TOL and max(jgaps) < TOL
    else:
        assert min(gaps) > 0.1
        np.testing.assert_allclose(gaps, jgaps, rtol=TOL, atol=TOL)
