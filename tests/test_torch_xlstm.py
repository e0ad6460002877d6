"""The port's xLSTM (mLSTM and sLSTM blocks, xlstm-125m's family) against
the JAX package's, on the CPU.

The same numpy inputs go through both packages, at `smoke_config` (2
blocks: an mLSTM, then an sLSTM), weights carried by `convert` with the
norm scales redrawn as 1 + N(0, 0.1^2) (ROADMAP C7) and the forget
gate's bias `f_bias` as 2 + N(0, 0.5^2), away from the port's init:
- `mlstm_block` (with the conv tail, S and n it hands decode) and
  `mlstm_decode_step`, `slstm_block` (with its final state) and
  `slstm_decode_step`, within 1e-5 of the largest |value| (f32 sums in
  other orders; the normaliser divides by |q . n|);
- `forward`, `prefill` and 3 `decode_step`s (logits and every cache
  leaf, the sLSTM's stabiliser finite), within 1e-4; greedy tokens
  equal; in bf16 within the reference's bf16 tolerance of 2e-2, decode's
  gate projections rounded to bf16 as the reference rounds them;
- decode after prefill(S) against prefill(S + t)'s last logits in the
  port (the recurrent state handoff), within 1e-4;
- the tuple of blocks through `convert` in the reference's leaf order,
  both ways (checkpoints across packages and the CLIs:
  tests/test_torch_train_launch.py);
- xlstm-125m at full width (d_model 768, vocab 50,304, the reference's
  own init, f32) at 2 blocks on one 1 x 256 batch: the gradient at
  init within 5e-4 of each leaf's largest |g|; 3 adamw steps at the
  card's schedule (lr 3e-4, warmup 2), the loss and lr within 1e-5, the
  grad norm within 2^-5 of its change, the batch's loss lowered, each
  param leaf within 2^-5 of its largest update (ROADMAP C20) but for
  1e-4 of its elements, those adamw steps from gradients at f32 noise; at 12 blocks the loss within 1e-5, the gradient
  not comparable (the reference's own moves by over 10% under one f32
  ulp of the embedding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig
from repro.configs.base import TrainConfig as JTrain
from repro.launch.mesh import make_host_mesh
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.models.common import embed_init_scale
from repro.sharding import init_from_defs
from repro.train import serve as jserve
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import registry, xlstm
from repro_torch.optim import optimizers
from repro_torch.train import serve, trainer

ARCH = "xlstm-125m"
TOL = 1e-4
BLOCK_TOL = 1e-5
BF16_TOL = 2e-2
PARALLEL = ParallelConfig(seq_shard=False, remat="none")
B, S = 2, 16
NORMS = ("ln_f", "norm", "out_norm")


def _close(got, want, tol=TOL):
    got = got.detach().to(torch.float32).numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol=BLOCK_TOL):
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _redraw(key, x, rng):
    if key in NORMS:
        return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
    if key == "f_bias":
        return (2.0 + 0.5 * rng.normal(size=x.shape)).astype(x.dtype)
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


def _x(seed, s, d):
    return np.random.default_rng(seed).normal(size=(B, s, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def test_mlstm_block_and_decode_step_match_reference():
    jcfg, cfg, jparams, model, _ = _setup()
    assert model.blocks[0].kind == "kind_mlstm"
    jp = jparams["blocks"][0]["kind_mlstm"]
    x = _x(1, S, cfg.d_model)
    want, (wconv, ws, wn) = jxlstm.mlstm_block(jp, jnp.asarray(x), jcfg,
                                               return_state=True)
    with torch.no_grad():
        got, (conv, st, n) = xlstm.mlstm_block(
            model.blocks[0], torch.from_numpy(x), cfg, return_state=True)
    for g, w in ((got, want), (conv, wconv), (st, ws), (n, wn)):
        _close_scaled(g, w)
    x1 = _x(2, 1, cfg.d_model)
    want = jxlstm.mlstm_decode_step(jp, jnp.asarray(x1), jcfg, wconv, ws,
                                    wn)
    with torch.no_grad():
        got = xlstm.mlstm_decode_step(model.blocks[0], torch.from_numpy(x1),
                                      cfg, conv, st, n)
    for g, w in zip(got, want, strict=True):
        _close_scaled(g, w)


def test_slstm_block_and_decode_step_match_reference():
    jcfg, cfg, jparams, model, _ = _setup()
    assert model.blocks[1].kind == "kind_slstm"
    jp = jparams["blocks"][1]["kind_slstm"]
    x = _x(3, S, cfg.d_model)
    want, wstate = jxlstm.slstm_block(jp, jnp.asarray(x), jcfg,
                                      return_state=True)
    with torch.no_grad():
        got, state = xlstm.slstm_block(model.blocks[1], torch.from_numpy(x),
                                       cfg, return_state=True)
    _close_scaled(got, want)
    for g, w in zip(state, wstate, strict=True):
        _close_scaled(g, w)
    x1 = _x(4, 1, cfg.d_model)
    want, wstate = jxlstm.slstm_decode_step(jp, jnp.asarray(x1), jcfg,
                                            wstate)
    with torch.no_grad():
        got, state = xlstm.slstm_decode_step(
            model.blocks[1], torch.from_numpy(x1), cfg, state)
    _close_scaled(got, want)
    for g, w in zip(state, wstate, strict=True):
        _close_scaled(g, w)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _close_cache(cache, jcache, tol=TOL):
    assert len(cache["blocks"]) == len(jcache["blocks"])
    for got, want in zip(cache["blocks"], jcache["blocks"], strict=True):
        assert got.keys() == want.keys()
        for kind in got:
            assert got[kind].keys() == want[kind].keys()
            for name, t in got[kind].items():
                assert tuple(t.shape) == want[kind][name].shape
                assert bool(torch.isfinite(t).all()), (kind, name)
                _close(t, want[kind][name], tol)
    assert np.array_equal(cache["length"].numpy(),
                          np.asarray(jcache["length"]))


def test_xlstm_forward_matches_reference():
    jcfg, cfg, jparams, model, tokens = _setup()
    batch = tokens[:, :S]
    want, _ = jregistry.get_spec(ARCH).forward(
        jparams, {"tokens": jnp.asarray(batch)}, jcfg, PARALLEL)
    got, aux = registry.get_spec(ARCH).forward(
        model, {"tokens": torch.from_numpy(batch)}, cfg, None)
    assert float(aux) == 0.0 and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_prefill_and_decode_match_reference(dtype):
    tol = TOL if dtype == "float32" else BF16_TOL
    jcfg, cfg, jparams, model, tokens = _setup(dtype)
    jspec, spec = jregistry.get_spec(ARCH), registry.get_spec(ARCH)
    jlogits, jcache = jspec.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])}, jcfg, PARALLEL)
    logits, cache = spec.prefill(model, {"tokens": torch.from_numpy(
        tokens[:, :S])}, cfg)
    _close(logits, jlogits, tol)
    _close_cache(cache, jcache, tol)
    for t in range(S, S + 3):
        step = tokens[:, t:t + 1]
        jlogits, jcache = jspec.decode_step(jparams, jcache,
                                            jnp.asarray(step), jcfg)
        logits, cache = spec.decode_step(model, cache,
                                         torch.from_numpy(step), cfg)
        _close(logits, jlogits, tol)
        _close_cache(cache, jcache, tol)


def test_xlstm_decode_after_prefill_matches_longer_prefill():
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


def test_xlstm_greedy_decode_matches_reference():
    jcfg, cfg, jparams, model, tokens = _setup(seed=3)
    want = jserve.greedy_decode(jregistry.get_spec(ARCH), jcfg, jparams,
                                {"tokens": jnp.asarray(tokens[:, :S])}, 8,
                                PARALLEL)
    got = serve.greedy_decode(registry.get_spec(ARCH), cfg, model,
                              {"tokens": tokens[:, :S]}, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_xlstm_params_round_trip():
    """The tuple of blocks in the reference's leaf order, both ways, for
    serving (gate weights and conv taps kept f32) and training; the
    vocab of a tied embedding padded; a wrong shape refused."""
    jcfg, cfg, _, _, _ = _setup()
    tree = jax.tree.map(np.asarray, _tree(jcfg))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    full = registry.get_spec(ARCH).cfg
    assert full.tie_embeddings and -(-full.vocab_size // 256) * 256 == 50432
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    for train_, c in ((False, bf16), (True, cfg)):
        model = convert.params_from_numpy(tree, c, "cpu", train=train_)
        assert isinstance(model, xlstm.XLSTM) and not hasattr(model,
                                                              "unembed")
        assert model.blocks[1].r_gates.dtype == torch.float32
        assert model.blocks[0].wq.dtype == (torch.float32 if train_
                                            else torch.bfloat16)
        back = list(convert.tree_leaves(convert.params_to_numpy(model)))
        assert [p for p, _ in back] == [
            tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in flat]
        if train_:
            for (_, got), (_, want) in zip(back, flat, strict=True):
                np.testing.assert_array_equal(got, want)
    tree["blocks"][1]["kind_slstm"]["r_gates"] = \
        tree["blocks"][1]["kind_slstm"]["r_gates"][:1]
    with pytest.raises(ValueError, match="blocks/1/kind_slstm/r_gates"):
        convert.params_from_numpy(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# training at full width
# ---------------------------------------------------------------------------

STEP_TOL = 2.0 ** -5     # adamw's params against their update (C20)
GRAD_TOL = 5e-4          # a leaf's gradient against its largest |g|
PARAM_FRAC = 1e-4        # elements whose |g| is at its f32 noise
TRAIN = dict(optimizer="adamw", learning_rate=3e-4, warmup_steps=2,
             total_steps=10)


def _full_width(num_layers):
    """xlstm-125m's config at `num_layers` in f32 in both packages, the
    reference's own init as numpy (no redraws)."""
    jcfg = dataclasses.replace(jregistry.get_spec(ARCH).cfg,
                               num_layers=num_layers, dtype="float32")
    cfg = dataclasses.replace(registry.get_spec(ARCH).cfg,
                              num_layers=num_layers, dtype="float32")
    tree = jax.tree.map(np.asarray, init_from_defs(
        jregistry.get_spec(ARCH).defs(jcfg), jax.random.PRNGKey(3),
        scale_fn=embed_init_scale))
    return jcfg, cfg, tree


def _lm_batch(cfg, s):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, cfg.vocab_size, size=(1, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_xlstm_full_width_train_step_matches_reference():
    """xlstm-125m at full width (d_model 768, 4 heads, vocab 50,304) and
    2 blocks (an mLSTM, then an sLSTM), f32, from the reference's own
    init, on one 1 x 256 batch:
    - the gradient at init, each leaf within GRAD_TOL = 5e-4 of its
      largest |g| (7.1e-5 measured, f_bias);
    - 3 adamw steps at the card's schedule (lr 3e-4, warmup 2) through
      both trainers: the loss and lr within 1e-5, the grad norm within
      1e-5 or, if larger, 2^-5 of its change since step 1, and the
      batch's loss lowered in both;
    - each param leaf within 2^-5 of the reference's largest update of
      it (ROADMAP C20), but for at most PARAM_FRAC = 1e-4 of its
      elements (2.2e-5 measured), which stay within that update (0.25
      of it measured): adamw moves an
      element by lr g / (|g| + eps), so where |g| is at its leaf's f32
      noise (measured: 1.0e-9 in the reference, 3.5e-8 in the port, at
      1e-6 of the leaf's largest) the two packages step by different
      fractions of lr.
    (At 12 blocks the f32 gradient is rounding noise:
    `test_xlstm_full_depth_gradient_is_rounding_bound`.)"""
    jcfg, cfg, tree = _full_width(2)
    batch = _lm_batch(cfg, 256)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    jspec = jregistry.get_spec(ARCH)
    tc, pc = JTrain(**TRAIN), ParallelConfig(remat="none")
    _, jgrad = jax.jit(jax.value_and_grad(
        jtrainer.make_loss_fn(jspec, jcfg, pc), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jbatch)
    jgrad = jax.tree.map(np.asarray, jgrad)
    state = jtrainer.init_state(jspec, jcfg, tc, pc, jax.random.PRNGKey(0))
    state = dict(state, params=jax.tree.map(jnp.asarray, tree))
    step = jax.jit(jtrainer.make_train_step(jspec, jcfg, tc, pc,
                                            make_host_mesh(1, 1)))
    want = []
    for _ in range(3):
        state, m = step(state, jbatch)
        want.append({k: float(v) for k, v in m.items()})
    want_params = jax.tree.map(np.asarray, state["params"])
    del state, step

    spec = registry.get_spec(ARCH)
    tc, pc = tbase.TrainConfig(**TRAIN), tbase.ParallelConfig(remat="none")
    model = convert.params_from_numpy(tree, cfg, "cpu", train=True)
    loss, _ = trainer.make_loss_fn(spec, cfg, pc)(model, tbatch)
    loss.backward()
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(prm.grad)
    tgrad = convert.params_to_numpy(model)
    for path, leaf in convert.tree_leaves(jgrad):
        node = tgrad
        for key in path:
            node = node[key]
        assert float(np.abs(node - leaf).max()) <= GRAD_TOL * float(
            np.abs(leaf).max()), path
    del model, tgrad

    tstate = trainer.init_state(spec, cfg, tc, pc,
                                torch.Generator().manual_seed(0), "cpu")
    tstate["params"] = convert.params_from_numpy(tree, cfg, "cpu",
                                                 train=True)
    tstate["opt"] = optimizers.get_optimizer("adamw").init(
        dict(tstate["params"].named_parameters()), cfg.opt_dtype)
    tstep = trainer.make_train_step(spec, cfg, tc, pc)
    got = []
    for _ in range(3):
        tstate, m = tstep(tstate, tbatch)
        got.append({k: float(v) for k, v in m.items()})
    got_params = convert.params_to_numpy(tstate["params"])

    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    for a, b in zip(got, want, strict=True):
        for key in a:
            if key != "grad_norm":
                _close(a[key], b[key], 1e-5)
        # the params differ by up to 2^-5 of an update (C20), and so may
        # the grad norm, of its change since the start
        change = abs(b["grad_norm"] - want[0]["grad_norm"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= max(
            1e-5 * b["grad_norm"], STEP_TOL * change), (a, b)
    assert got[-1]["nll"] < got[0]["nll"] and want[-1]["nll"] < want[0]["nll"]
    for path, leaf in convert.tree_leaves(want_params):
        node, start = got_params, tree
        for key in path:
            node, start = node[key], start[key]
        update = float(np.abs(leaf - start).max())
        gap = np.abs(node - leaf)
        assert float(gap.max()) <= update, path
        assert float(np.mean(gap > STEP_TOL * update)) <= PARAM_FRAC, path


def test_xlstm_full_depth_gradient_is_rounding_bound():
    """xlstm-125m at full width and depth (12 blocks), f32, the
    reference's own init, one 1 x 128 batch: the port's loss equals the
    reference's within 1e-5, but the gradient cannot be compared: the
    reference's own global gradient norm moves by more than 10% when the
    embedding moves by one f32 ulp (x (1 + 2^-23)), so any other order of
    f32 sums gives another gradient (the mLSTM's normaliser divides by
    |q . n|, near 0 at some positions of a random init). Full-width
    training is compared step for step at 2 blocks instead."""
    jcfg, cfg, tree = _full_width(12)
    batch = _lm_batch(cfg, 128)
    jspec = jregistry.get_spec(ARCH)
    grad = jax.jit(jax.value_and_grad(
        jtrainer.make_loss_fn(jspec, jcfg, ParallelConfig(remat="none")),
        has_aux=True))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    norms, losses = [], []
    for scale in (1.0, 1 + 2.0 ** -23):
        moved = dict(tree, embed=(tree["embed"] * np.float32(scale)).astype(
            np.float32))
        (loss, _), g = grad(jax.tree.map(jnp.asarray, moved), jbatch)
        losses.append(float(loss))
        norms.append(float(np.sqrt(sum(
            float(np.sum(np.asarray(x, np.float64) ** 2))
            for x in jax.tree.leaves(g)))))
    assert abs(norms[1] - norms[0]) > 0.1 * norms[0], norms

    spec = registry.get_spec(ARCH)
    model = convert.params_from_numpy(tree, cfg, "cpu", train=True)
    with torch.no_grad():
        loss, _ = trainer.make_loss_fn(spec, cfg, tbase.ParallelConfig(
            remat="none"))(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    _close(loss, losses[0], 1e-5)
