"""The port's dense trainer against the JAX package's, on the CPU.

The same numpy inputs go through both packages at the smoke size of
`registry.smoke_config`:
- `layers.blocked_causal_attention`, values and gradients (`jax.grad`
  against torch autograd), on both of the reference's schedules: the
  unrolled triangular one (several q blocks, with and without a remainder
  kv block) and the masked scan (`unroll_limit` forced below the q-block
  count); within 1e-5 in f32;
- `common.cross_entropy`, with and without a mask, within 1e-6;
- `transformer.forward` (logits and aux) with params carried by
  `convert` and the norm scales redrawn as 1 + N(0, 0.1^2) (ROADMAP C7),
  within 1e-5;
- the four dense optimizers over 3 steps, `clip_by_global_norm` and
  `get_schedule`, within 1e-6;
- `trainer.make_train_step`: 3 steps of adamw, sgd and momentum at
  `dtype="float32"`, within 1e-5 in loss, grad norm, lr and params;
  microbatches 2 and the three remat modes against the same reference;
  one bf16 sgd step (lr 0.1, so the params move by 0.1 g), within 2^-8,
  bf16's unit roundoff, relative and absolute: each package rounds its
  bf16 activations at the same places but sums in its own order, which
  moves the loss by a few bf16 units of the logits' scale, not of the
  loss's (3e-4 of 5.56 measured);
- 3 adamw steps of every other ported arch (granite-8b, granite-34b,
  chameleon-34b, llama3-405b, phi3.5-moe, mixtral, zamba2 (remat full
  over a group of layers and the shared block), xlstm, whisper (frames
  and tokens); the MoE archs also at microbatches 2, their aux loss
  summed over layers and averaged over microbatches; the SSM scalars
  A_log, dt_bias, D_skip and f_bias redrawn as the norm scales are):
  metrics within 1e-5, each param leaf
  within 2^-5 of its largest update (ROADMAP C20); mixtral's bf16
  masters and moments, one step within 2^-8 of the reference's.
The sliding window's blocked attention is tests/test_torch_swa.py's.
Each reference step is jitted once per module (fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.launch.mesh import make_host_mesh
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models.common import embed_init_scale
from repro.optim import optimizers as joptim
from repro.optim import schedules as jsched
from repro.sharding import init_from_defs
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models import common, layers, registry
from repro_torch.optim import optimizers, schedules
from repro_torch.train import trainer

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
STEP_TOL = 2.0 ** -5     # adamw's params against their update (C20)
ARCH = "yi-6b"
B, S = 4, 32
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
BF16_TRAIN = dict(optimizer="sgd", learning_rate=0.1, warmup_steps=0)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _is_norm(path):
    return path[-1] in ("ln1", "ln2", "q_norm", "k_norm", "lnx", "ln_enc",
                        "norm", "out_norm")


def _keys(path):
    """A jax key path as its dict keys and tuple indices."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _tree(arch, cfg, seed=0):
    """The reference's params at `seed` as numpy, norm scales redrawn."""
    params = init_from_defs(jregistry.get_spec(arch).defs(cfg),
                            jax.random.PRNGKey(seed),
                            scale_fn=embed_init_scale)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        keys = _keys(path)
        if _is_norm(keys) or keys[-1] == "D_skip":
            x = (1.0 + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
        elif keys[-1] in ("A_log", "dt_bias"):
            x = (0.5 * rng.normal(size=x.shape)).astype(x.dtype)
        elif keys[-1] == "f_bias":
            x = (2.0 + 0.5 * rng.normal(size=x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _tokens(cfg, seed, b=B, s=S):
    """tokens and labels, and an encoder-decoder's frames (B, S, D)."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
        np.int32) for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return batch


# ---------------------------------------------------------------------------
# layers and loss
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (q_block, kv_block, unroll_limit); S = 64, so 4 q blocks
    "triangular": (16, 16, 64),
    "triangular_remainder": (16, 12, 64),   # kv blocks of 12 and a rest
    "masked_scan": (16, 16, 2),             # 4 q blocks > unroll_limit
    "one_block": (48, 16, 64),              # 48 does not divide 64
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blocked_attention_values_and_grads(case):
    q_block, kv_block, unroll = ATTN_CASES[case]
    kw = dict(q_block=q_block, kv_block=kv_block, unroll_limit=unroll)
    rng = np.random.default_rng(len(case))
    b, s, h, kh, d = 2, 64, 4, 2, 16
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d))]
    q, k, v, w = arrs

    def jloss(q, k, v):
        out = jlayers.blocked_causal_attention(q, k, v, **kw)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.blocked_causal_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(torch.sum(out * _t(w)), (tq, tk, tv))
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    _close(out.detach(), jout, F32_TOL)
    for got, want in zip(grads, jgrads, strict=True):
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32) if masked else None
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = common.cross_entropy(_t(logits), _t(labels),
                               None if mask is None else _t(mask))
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want, 1e-6)


@pytest.mark.parametrize("arch", ["yi-6b", "granite-34b", "chameleon-34b"])
def test_forward_matches_reference(arch):
    cfg = registry.smoke_config(arch)
    jcfg = jregistry.smoke_config(arch)
    tree = _tree(arch, jcfg, seed=1)
    batch = _tokens(cfg, seed=2)
    want, jaux = jregistry.get_spec(arch).forward(
        jax.tree.map(jnp.asarray, tree),
        {"tokens": jnp.asarray(batch["tokens"])}, jcfg,
        JParallel(seq_shard=False, remat="none"))
    model = convert.params_from_numpy(tree, cfg, "cpu", train=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    logits, aux = registry.get_spec(arch).forward(
        model, {"tokens": _t(batch["tokens"])}, cfg, ParallelConfig())
    assert logits.shape == want.shape and logits.dtype == torch.float32
    _close(logits.detach(), want, F32_TOL)
    assert float(aux) == float(jaux) == 0.0


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

OPT_SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 3, 2)}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizer_matches_reference(name):
    tc = TrainConfig()
    rng = np.random.default_rng(3)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in OPT_SHAPES.items()}
    jopt = joptim.get_optimizer(name)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp, "float32")
    params = {k: _t(v.copy()) for k, v in p0.items()}
    opt = optimizers.get_optimizer(name)
    state = opt.init(params, "float32")
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in OPT_SHAPES.items()}
        lr = np.float32(1e-2 * (step + 1))
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, jstate, jp,
                                 jnp.float32(lr), JTrain())
        params, state = opt.update({k: _t(v) for k, v in grads.items()},
                                   state, params, torch.tensor(lr), tc)
    for k in OPT_SHAPES:
        _close(params[k], jp[k], 1e-6)
        for moment in ("m", "v", "mu"):
            if moment in state:
                _close(state[moment][k], jstate[moment][k], 1e-6)
    if "count" in state:
        assert int(state["count"]) == int(jstate["count"]) == 3


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(4)
    g = {k: rng.normal(size=s).astype(np.float32)
         for k, s in OPT_SHAPES.items()}
    jclipped, jnorm = joptim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    clipped, norm = optimizers.clip_by_global_norm(
        {k: _t(v.copy()) for k, v in g.items()}, max_norm)
    _close(norm, jnorm, 1e-6)
    _close(optimizers.global_norm({k: _t(v) for k, v in g.items()}),
           joptim.global_norm(g), 1e-6)
    for k in g:
        _close(clipped[k], jclipped[k], 1e-6)


@pytest.mark.parametrize("warmup", [0, 3])
def test_get_schedule_matches_reference(warmup):
    tc = dict(learning_rate=0.1, warmup_steps=warmup, total_steps=12)
    jfn = jsched.get_schedule(JTrain(**tc))
    fn = schedules.get_schedule(TrainConfig(**tc))
    for step in range(15):
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, jfn(jnp.int32(step)), 1e-7)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _reference_run(cfg, tc, pc, tree, batches, arch=ARCH):
    """The reference's jitted step over `batches` from `tree`: (metrics a
    step, final params as numpy)."""
    spec = jregistry.get_spec(arch)
    state = jtrainer.init_state(spec, cfg, tc, pc, jax.random.PRNGKey(0))
    state = dict(state, params=jax.tree.map(jnp.asarray, tree))
    step = jax.jit(jtrainer.make_train_step(spec, cfg, tc, pc,
                                            make_host_mesh(1, 1)))
    metrics = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state["params"])


def _port_run(cfg, tc, pc, tree, batches, arch=ARCH):
    spec = registry.get_spec(arch)
    state = trainer.init_state(spec, cfg, tc, pc,
                               torch.Generator().manual_seed(0), "cpu")
    state["params"] = convert.params_from_numpy(tree, cfg, "cpu",
                                                train=True)
    opt = optimizers.get_optimizer(tc.optimizer)
    state["opt"] = opt.init(dict(state["params"].named_parameters()),
                            cfg.opt_dtype)
    step = trainer.make_train_step(spec, cfg, tc, pc)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        assert all(v.shape == () and v.dtype == torch.float32
                   for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    assert int(state["step"]) == len(batches)
    return metrics, convert.params_to_numpy(state["params"])


def _compare(got, want, tol):
    (gm, gp), (wm, wp) = got, want
    assert len(gm) == len(wm)
    for a, b in zip(gm, wm, strict=True):
        assert sorted(a) == sorted(b)
        for key in a:
            _close(a[key], b[key], tol)
    for path, leaf in convert.tree_leaves(wp):
        node = gp
        for key in path:
            node = node[key]
        _close(node, leaf, tol)


def _setup(dtype="float32", steps=3, arch=ARCH):
    cfg = dataclasses.replace(registry.smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jregistry.smoke_config(arch), dtype=dtype)
    tree = _tree(arch, jcfg, seed=5)
    batches = [_tokens(cfg, seed=10 + i) for i in range(steps)]
    return cfg, jcfg, tree, batches


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's runs, one jitted step each: by optimizer (3 steps,
    remat full), microbatches 2 (adamw), and one bf16 sgd step."""
    cfg, jcfg, tree, batches = _setup()
    runs = {}
    for name in ("adamw", "sgd", "momentum"):
        runs[name] = _reference_run(jcfg, JTrain(optimizer=name, **TRAIN),
                                    JParallel(), tree, batches)
    runs["micro2"] = _reference_run(jcfg, JTrain(**TRAIN),
                                    JParallel(microbatches=2), tree, batches)
    bcfg, bjcfg, btree, bbatches = _setup("bfloat16", steps=1)
    runs["bf16"] = _reference_run(bjcfg, JTrain(**BF16_TRAIN), JParallel(),
                                  btree, bbatches)
    return runs


@pytest.mark.parametrize("name", ["adamw", "sgd", "momentum"])
def test_train_step_matches_reference(name, reference_runs):
    cfg, _, tree, batches = _setup()
    got = _port_run(cfg, TrainConfig(optimizer=name, **TRAIN),
                    ParallelConfig(), tree, batches)
    _compare(got, reference_runs[name], F32_TOL)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_train_step_remat_modes_match_reference(remat, reference_runs):
    cfg, _, tree, batches = _setup()
    got = _port_run(cfg, TrainConfig(**TRAIN), ParallelConfig(remat=remat),
                    tree, batches)
    _compare(got, reference_runs["adamw"], F32_TOL)


def test_train_step_microbatches_match_reference(reference_runs):
    cfg, _, tree, batches = _setup()
    got = _port_run(cfg, TrainConfig(**TRAIN),
                    ParallelConfig(microbatches=2), tree, batches)
    _compare(got, reference_runs["micro2"], F32_TOL)


def test_bf16_train_step_matches_reference(reference_runs):
    cfg, _, tree, batches = _setup("bfloat16", steps=1)
    got = _port_run(cfg, TrainConfig(**BF16_TRAIN), ParallelConfig(), tree,
                    batches)
    _compare(got, reference_runs["bf16"], BF16_TOL)


FAMILY = ["granite-8b", "granite-34b", "chameleon-34b", "llama3-405b",
          "phi3.5-moe-42b-a6.6b", "mixtral-8x22b", "zamba2-2.7b",
          "xlstm-125m", "whisper-small"]
MOE = ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b")


def _compare_to_update(got, want, before, tol):
    """Metrics within F32_TOL; each param leaf within `tol` of the
    reference's largest update of that leaf, max|p_ref - p_before|."""
    (gm, gp), (wm, wp) = got, want
    assert len(gm) == len(wm)
    for a, b in zip(gm, wm, strict=True):
        assert sorted(a) == sorted(b)
        for key in a:
            _close(a[key], b[key], F32_TOL)
    for path, leaf in convert.tree_leaves(wp):
        node, start = gp, before
        for key in path:
            node, start = node[key], start[key]
        update = float(np.abs(leaf - start).max())
        assert float(np.abs(node - leaf).max()) <= tol * update, path


@pytest.mark.parametrize("arch,micro", [(a, 1) for a in FAMILY]
                         + [(a, 2) for a in MOE])
def test_train_step_family_matches_reference(arch, micro):
    """3 adamw steps of each ported family member but yi-6b (the tests
    above), MoE archs with their aux loss, at microbatches 1 and 2 (2 for
    the MoE archs only, whose aux is averaged over microbatches): the
    metrics within 1e-5 and each param leaf within 2^-5 of its largest
    update (ROADMAP C20: adamw turns f32-noise gradients of ~1e-7 into
    updates of ~lr, so an absolute bound on the params measures noise)."""
    cfg, jcfg, tree, batches = _setup(arch=arch)
    want = _reference_run(jcfg, JTrain(**TRAIN), JParallel(microbatches=micro),
                          tree, batches, arch)
    got = _port_run(cfg, TrainConfig(**TRAIN),
                    ParallelConfig(microbatches=micro), tree, batches, arch)
    auxes = [m["aux"] for m in got[0]]
    assert all(a > 0 for a in auxes) if arch in MOE else \
        all(a == 0 for a in auxes)
    _compare_to_update(got, want, tree, STEP_TOL)


def test_bf16_masters_and_moments_match_reference():
    """mixtral keeps bf16 masters and AdamW moments (`param_dtype`,
    `opt_dtype`); one adamw step at f32 activations against the
    reference's: the metrics within 1e-5 and each param within one bf16
    unit (2^-8 relative) of the reference's."""
    arch = "mixtral-8x22b"
    full = registry.get_spec(arch).cfg
    assert (full.param_dtype, full.opt_dtype) == ("bfloat16", "bfloat16")
    cfg, jcfg, tree, batches = _setup(arch=arch, steps=1)
    cfg, jcfg = (dataclasses.replace(c, param_dtype="bfloat16",
                                     opt_dtype="bfloat16")
                 for c in (cfg, jcfg))
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)
    spec = registry.get_spec(arch)
    state = trainer.init_state(spec, cfg, TrainConfig(), ParallelConfig(),
                               torch.Generator().manual_seed(0), "cpu")
    assert all(p.dtype == torch.bfloat16
               for p in state["params"].parameters())
    assert all(m.dtype == torch.bfloat16 for key in ("m", "v")
               for m in state["opt"][key].values())
    (gm, gp), (wm, wp) = (
        run(cfg_, TrainConfig(**TRAIN), pc, tree, batches, arch)
        for run, cfg_, pc in ((_port_run, cfg, ParallelConfig()),
                              (_reference_run, jcfg, JParallel())))
    for a, b in zip(gm, wm, strict=True):
        for key in a:
            _close(a[key], b[key], F32_TOL)
    for path, leaf in convert.tree_leaves(wp):
        node = gp
        for key in path:
            node = node[key]
        np.testing.assert_allclose(node, np.asarray(leaf, np.float32),
                                   rtol=BF16_TOL, atol=1e-6)


def test_bf16_remat_dots_equals_full():
    """Selective checkpointing replays the f32-result products of the
    bf16 path (`common._MmF32`) and gives plain remat's step bit for
    bit."""
    cfg, _, tree, batches = _setup("bfloat16", steps=1)
    runs = [_port_run(cfg, TrainConfig(**BF16_TRAIN),
                      ParallelConfig(remat=r), tree, batches)
            for r in ("full", "dots", "none")]
    for metrics, params in runs[1:]:
        assert metrics == runs[0][0]
        for (_, a), (_, b) in zip(convert.tree_leaves(params),
                                  convert.tree_leaves(runs[0][1]),
                                  strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", ["attn_mode", "compress_pod_grads",
                                   "sparse_embed"])
def test_trainer_refuses_what_needs_a_mesh(field):
    """Nothing here needs a mesh any more. Without one, `attn_mode="cp"`
    (no `model` dim: the blocked attention) and `compress_pod_grads` (no
    `pod` dim: off) are the reference's no-ops, and `sparse_embed` is read
    by neither package's trainer, so 3 steps train bit for bit as the
    defaults do."""
    value = "cp" if field == "attn_mode" else True
    pc = ParallelConfig(**{field: value})
    cfg, _, tree, batches = _setup()
    got = _port_run(cfg, TrainConfig(**TRAIN), pc, tree, batches)
    want = _port_run(cfg, TrainConfig(**TRAIN), ParallelConfig(), tree,
                     batches)
    assert got[0] == want[0]
    for (_, a), (_, b) in zip(convert.tree_leaves(got[1]),
                              convert.tree_leaves(want[1]), strict=True):
        np.testing.assert_array_equal(a, b)


def test_train_state_round_trips_through_numpy():
    cfg, jcfg, tree, _ = _setup()
    spec = jregistry.get_spec(ARCH)
    jstate = jtrainer.init_state(spec, jcfg, JTrain(), JParallel(),
                                 jax.random.PRNGKey(3))
    want = jax.tree.map(np.asarray, jstate)
    want["opt"]["count"] = np.int32(4)
    want["step"] = np.int32(7)
    state = convert.train_state_from_numpy(want, cfg, "cpu")
    assert int(state["step"]) == 7 and int(state["opt"]["count"]) == 4
    got = convert.train_state_to_numpy(state)
    wl, gl = list(convert.tree_leaves(want)), list(convert.tree_leaves(got))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    assert [tuple(p) for p, _ in gl] == [
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    for (_, a), (_, b) in zip(gl, wl, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
