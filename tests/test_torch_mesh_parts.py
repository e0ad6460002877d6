"""The parts of the Distribution slice over 4 gloo ranks against the
reference, on the CPU: one `mp.spawn` of 4 ranks and one JAX subprocess
on an emulated 4-device host mesh (`tests/torch_mesh_harness.py`).

- `core.fsdp.dpmr_dense_linear` (W's rows gathered for the product, the
  gradient reduce-scattered to their owners, W gathered again in the
  backward) at (data 4): each rank holds 8 of W's 32 rows and 4 of the
  batch's 16 rows. Forward and the gradient of sum(sin(x @ W)) with
  respect to W and x against the plain product under autograd, max|d| <
  1e-4 (the reference's bound, tests/test_multidevice.py), and against
  the reference's `dpmr_dense_linear` under shard_map within 1e-5 of
  each tensor's largest |value| (the partial sums of the 4 ranks are
  added in another order); its stage functions give the autograd
  function's forward bit for bit and its gradient within that bound.
- `layers.context_parallel_attention` at (data 1, model 4): b, s, h, kh,
  d = 2, 64, 4, 2, 16 (f32), kv blocks of 16, causal, causal with a
  window of 16, and full: rank j holds sequence chunk j of q, k and v;
  only K and V are gathered. The assembled output and the gradients of
  sum(sin(out)) with respect to q, k and v against the reference's
  `context_parallel_attention` on the same mesh under jax.grad, within
  1e-5.
- `train.pipeline.pipeline_apply` over a `pipe` dim of 4 (S = 4 stages
  of tanh(h @ w_s), M = 8 microbatches of (2, 16)): the outputs on every
  rank and each stage's gradient of sum(sin(y)) against the sequential
  oracle and the reference's `pipeline_apply`, within 1e-5.
- `runtime.elastic.reshard_tree` of a whole adamw state of granite-8b's
  smoke config into a state laid out at (data 2): every rank's blocks
  equal the shards that the reference's `reshard_tree` places under its
  `shardings_for_state` on the same mesh, bit for bit.
- A dense checkpoint of granite-8b's smoke state sharded over (data 4)
  after 2 steps holds the whole leaves: restored at (data 2) (ranks
  {0, 1} and {2, 3}), at no mesh and by the reference's `Checkpointer`,
  the same arrays bit for bit.
- FSDP for the other families: one adamw step of phi3.5-moe (groups of
  16 tokens, which lie within a rank's rows), zamba2, xlstm and whisper
  at smoke size at (data 2) against the port's own one-rank step from
  the same draws (itself held to the reference by
  tests/test_torch_trainer.py): the loss within 1e-5 and each param leaf
  within 2^-5 of its largest update (ROADMAP C20).
"""
import numpy as np
import pytest
import torch

import torch_mesh_harness as h

F32_TOL = 1e-5
LINEAR_TOL = 1e-4
STEP_TOL = 2.0 ** -5
D, F, B = 32, 24, 16                              # the FSDP linear
CB, CS, CH, CKH, CD, CHUNKS = 2, 64, 4, 2, 16, 4  # context parallelism
CASES = [(True, 0), (True, 16), (False, 0)]
S, M, MB, PD = 4, 8, 2, 16                        # the pipeline
CKPT_ARCH = "granite-8b"
FAMILIES = {"phi3.5-moe-42b-a6.6b": 0, "zamba2-2.7b": 0, "xlstm-125m": 1,
            "whisper-small": 1}                   # arch: its pair (0 or 1)

REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.fsdp import dpmr_dense_linear
from repro.launch.mesh import make_host_mesh
from repro.models import layers
from repro.train.pipeline import make_pp_mesh, pipeline_apply

data = np.load(sys.argv[1])
out = {}
w, x = jnp.asarray(data["w"]), jnp.asarray(data["x"])
mesh = make_host_mesh(4, 1)

def staged(w, x):
    return compat.shard_map(lambda ws, xs: dpmr_dense_linear(ws, xs, "data"),
                            mesh=mesh, in_specs=(P("data", None),
                                                 P("data", None)),
                            out_specs=P("data", None), check_vma=False)(w, x)

with compat.set_mesh(mesh):
    out["linear/y"] = np.asarray(staged(w, x))
    gw, gx = jax.grad(lambda w, x: jnp.sum(jnp.sin(staged(w, x))),
                      argnums=(0, 1))(w, x)
out["linear/gw"], out["linear/gx"] = np.asarray(gw), np.asarray(gx)

q, k, v = (jnp.asarray(data[n]) for n in ("q", "k", "v"))
mesh = make_host_mesh(1, 4)
with compat.set_mesh(mesh):
    for causal, window in [(True, 0), (True, 16), (False, 0)]:
        def loss(q, k, v):
            o = layers.context_parallel_attention(
                q, k, v, causal=causal, window=window, kv_block=16)
            return jnp.sum(jnp.sin(o)), o
        (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
        key = f"cp/{causal}_{window}"
        out[key] = np.asarray(o)
        for name, gg in zip("qkv", g):
            out[f"{key}/d{name}"] = np.asarray(gg)

pw, px = jnp.asarray(data["pw"]), jnp.asarray(data["px"])
mesh = make_pp_mesh(4)

def ploss(w):
    y = pipeline_apply({"w": w}, px, lambda p, h: jnp.tanh(h @ p["w"]), mesh)
    return jnp.sum(jnp.sin(y)), y

with compat.set_mesh(mesh):
    (_, y), g = jax.value_and_grad(ploss, has_aux=True)(pw)
out["pipe/y"], out["pipe/g"] = np.asarray(y), np.asarray(g)

from repro.configs.base import ParallelConfig, TrainConfig
from repro.models import registry
from repro.runtime.elastic import reshard_tree
from repro.train import trainer

def unflat(prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree

arch = sys.argv[3]
spec, cfg = registry.get_spec(arch), registry.smoke_config(arch)
tree = unflat("tree/")
tree["step"] = np.asarray(tree["step"], np.int32)
tree["opt"]["count"] = np.asarray(tree["opt"]["count"], np.int32)
mesh = make_host_mesh(2, 1)
sh = trainer.shardings_for_state(trainer.state_defs(
    spec, cfg, TrainConfig(optimizer="adamw"), ParallelConfig()), mesh)
placed = reshard_tree(tree, sh)
for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                   for k in path)
    for s in leaf.addressable_shards:
        i = mesh.devices.reshape(-1).tolist().index(s.device)
        out[f"reshard/{key}/{i}"] = np.asarray(s.data)
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(D, F)).astype(np.float32),
            "x": rng.normal(size=(B, D)).astype(np.float32),
            "q": rng.normal(size=(CB, CS, CH, CD)).astype(np.float32),
            "k": rng.normal(size=(CB, CS, CKH, CD)).astype(np.float32),
            "v": rng.normal(size=(CB, CS, CKH, CD)).astype(np.float32),
            "pw": rng.normal(0, 0.3, size=(S, PD, PD)).astype(np.float32),
            "px": rng.normal(size=(M, MB, PD)).astype(np.float32)}


def _state_tree():
    """A whole adamw train state of granite-8b's smoke config as the
    reference's tree of numpy arrays: its initial params, moments drawn
    from a seed."""
    params = h.init_tree(CKPT_ARCH)
    rng = np.random.default_rng(5)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.normal(size=np.shape(v)).astype(np.float32)
                for k, v in tree.items()}

    return {"params": params, "step": np.int32(7),
            "opt": {"m": draw(params), "v": draw(params),
                    "count": np.int32(7)}}


def _tokens(cfg, seed, b=8, s=16):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32))
        for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, s, cfg.d_model)).astype(np.float32))
    return batch


def _linear(rank, data, got):
    import torch.distributed as dist

    from repro_torch.core import fsdp

    rows, brows = D // h.RANKS, B // h.RANKS
    ws = torch.tensor(data["w"][rank * rows:(rank + 1) * rows],
                      requires_grad=True)
    xs = torch.tensor(data["x"][rank * brows:(rank + 1) * brows],
                      requires_grad=True)
    group = dist.group.WORLD
    y = fsdp.dpmr_dense_linear(ws, xs, group)
    gw, gx = torch.autograd.grad(torch.sum(torch.sin(y)), (ws, xs))
    with torch.no_grad():
        y_ref = fsdp.dpmr_dense_linear_ref(ws, xs, group)
        gw_ref = fsdp.dpmr_dense_grad_ref(ws, xs, torch.cos(y_ref), group)
    got.update({"linear/y": y.detach(), "linear/gw": gw, "linear/gx": gx,
                "linear/y_ref": y_ref, "linear/gw_ref": gw_ref})


def _cp(data, got):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers

    mesh = make_host_mesh(1, CHUNKS)
    j, n = mesh.get_local_rank("model"), CS // CHUNKS
    for causal, window in CASES:
        loc = {name: torch.tensor(data[name][:, j * n:(j + 1) * n],
                                  requires_grad=True) for name in "qkv"}
        out = layers.context_parallel_attention(
            loc["q"], loc["k"], loc["v"], group=mesh.get_group("model"),
            causal=causal, window=window, kv_block=16)
        grads = torch.autograd.grad(torch.sum(torch.sin(out)),
                                    (loc["q"], loc["k"], loc["v"]))
        key = f"cp/{causal}_{window}"
        got[key] = out.detach()
        for name, g in zip("qkv", grads, strict=True):
            got[f"{key}/d{name}"] = g


def _pipe(rank, data, got):
    from repro_torch.train import pipeline

    mesh = pipeline.make_pp_mesh(S)
    ws = torch.tensor(data["pw"][rank], requires_grad=True)
    y = pipeline.pipeline_apply({"w": ws}, torch.from_numpy(data["px"]),
                                lambda p, a: torch.tanh(a @ p["w"]), mesh)
    (g,) = torch.autograd.grad(torch.sum(torch.sin(y)), (ws,))
    got["pipe/y"], got["pipe/g"] = y.detach(), g


def _ckpt(rank, ckpt, pair, got):
    """Save at (data 4) after 2 steps; restore at this rank's (data 2)."""
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.ckpt.checkpointer import Checkpointer
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import trainer

    spec, cfg = registry.get_spec(CKPT_ARCH), registry.smoke_config(CKPT_ARCH)
    tc, pc = TrainConfig(learning_rate=1e-2), ParallelConfig()

    def whole(state):
        model = state["params"]
        return {"/".join(map(str, p)): t for p, t in convert.tree_leaves(
            convert.params_to_numpy(model, trainer.full_params(model)))}

    mesh = make_host_mesh(h.RANKS, 1)
    state = trainer.init_state(spec, cfg, tc, pc,
                               torch.Generator().manual_seed(4), "cpu",
                               mesh=mesh)
    step = trainer.make_train_step(spec, cfg, tc, pc, mesh)
    for i in range(2):
        state, _ = step(state, _tokens(cfg, 10 + i))
    Checkpointer(ckpt).save(2, state)
    saved = whole(state)
    dist.barrier()
    state = trainer.init_state(spec, cfg, tc, pc,
                               torch.Generator().manual_seed(2), "cpu",
                               mesh=pair)
    state, _ = Checkpointer(ckpt).restore(state)
    restored = whole(state)
    if rank % 2 == 0:
        got.update({f"ckpt/saved/{k}": v for k, v in saved.items()})
        got.update({f"ckpt/data2/{k}": v for k, v in restored.items()})


def _reshard(rank, pair, data, got):
    """`elastic.reshard_tree` of the whole state tree `tree/...` into a
    granite-8b state at (data 2): this rank's blocks."""
    from repro_torch import convert
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.runtime.elastic import reshard_tree
    from repro_torch.train import trainer

    spec, cfg = registry.get_spec(CKPT_ARCH), registry.smoke_config(CKPT_ARCH)
    like = trainer.init_state(spec, cfg, TrainConfig(optimizer="adamw"),
                              ParallelConfig(), torch.Generator().manual_seed(3),
                              "cpu", mesh=pair)
    state = reshard_tree(h.unflat(data, "tree/"), like)
    model = state["params"]
    for section, values in (("params", dict(model.named_parameters())),
                            ("opt/m", state["opt"]["m"]),
                            ("opt/v", state["opt"]["v"])):
        for path, leaf in convert.tree_leaves(
                convert.params_to_numpy(model, values)):
            got[f"reshard/{section}/" + "/".join(map(str, path))] = leaf
    got["reshard/step"] = state["step"].numpy()
    got["reshard/opt/count"] = state["opt"]["count"].numpy()


def _families(rank, pair, got):
    """One step of each family of this rank's pair at (data 2), then each
    rank of the pair the one-rank step of one of them."""
    from repro_torch import convert
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.train import trainer

    tc, pc = TrainConfig(learning_rate=1e-2, warmup_steps=0), \
        ParallelConfig(moe_group=16)
    mine = [a for a, p in FAMILIES.items() if p == rank // 2]
    for tag, mesh, archs in (("mesh", pair, mine),
                             ("one", None, [mine[rank % 2]])):
        for arch in archs:
            spec, cfg = registry.get_spec(arch), registry.smoke_config(arch)
            state = trainer.init_state(spec, cfg, tc, pc,
                                       torch.Generator().manual_seed(1),
                                       "cpu", mesh=mesh)
            model = state["params"]

            def whole():
                return {"/".join(map(str, p)): t
                        for p, t in convert.tree_leaves(
                            convert.params_to_numpy(
                                model, trainer.full_params(model)))}

            before = whole()
            step = trainer.make_train_step(spec, cfg, tc, pc, mesh)
            state, m = step(state, _tokens(cfg, 20))
            after = whole()
            if mesh is None or rank % 2 == 0:
                got[f"fam/{arch}/{tag}/loss"] = m["loss"]
                for key, t in after.items():
                    got[f"fam/{arch}/{tag}/after/{key}"] = t
                    got[f"fam/{arch}/{tag}/before/{key}"] = before[key]


def _ranks(rank, store, inputs, out_dir):
    import torch.distributed as dist

    h.join_ranks(rank, h.RANKS, store)
    data = dict(np.load(inputs))
    got = {}
    _linear(rank, data, got)
    _cp(data, got)
    _pipe(rank, data, got)
    pair = h.pair_mesh()
    _ckpt(rank, f"{out_dir}/ckpt", pair, got)
    _reshard(rank, pair, data, got)
    _families(rank, pair, got)
    np.savez(f"{out_dir}/rank{rank}.npz",
             **{k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in got.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_parts")
    np.savez(tmp / "in.npz", **_inputs(), **h.flat(_state_tree(), "tree/"))
    h.run_both(REFERENCE, [tmp / "in.npz", tmp / "ref.npz", CKPT_ARCH],
               h.RANKS,
               _ranks, (str(tmp / "store"), str(tmp / "in.npz"), str(tmp)))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(h.RANKS)]
    return dict(np.load(tmp / "ref.npz")), ranks, tmp


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _plain_linear():
    data = _inputs()
    w, x = (torch.tensor(data[n], requires_grad=True) for n in ("w", "x"))
    y = x @ w
    gw, gx = torch.autograd.grad(torch.sum(torch.sin(y)), (w, x))
    return {"y": y.detach().numpy(), "gw": gw.numpy(), "gx": gx.numpy()}


def test_fsdp_linear_equals_plain_matmul(results):
    _, ranks, _ = results
    for key, want in _plain_linear().items():
        assert np.max(np.abs(_rows(ranks, f"linear/{key}") - want)) \
            < LINEAR_TOL, key


def test_fsdp_linear_equals_reference(results):
    ref, ranks, _ = results
    for key in ("y", "gw", "gx"):
        want = ref[f"linear/{key}"]
        np.testing.assert_allclose(_rows(ranks, f"linear/{key}"), want,
                                   rtol=0,
                                   atol=F32_TOL * np.max(np.abs(want)),
                                   err_msg=key)


def test_fsdp_stage_functions_equal_the_autograd_function(results):
    _, ranks, _ = results
    np.testing.assert_array_equal(_rows(ranks, "linear/y_ref"),
                                  _rows(ranks, "linear/y"))
    want = _rows(ranks, "linear/gw")
    np.testing.assert_allclose(_rows(ranks, "linear/gw_ref"), want, rtol=0,
                               atol=F32_TOL * np.max(np.abs(want)))


def test_fsdp_specs_are_the_rules():
    from repro_torch import sharding as shd
    from repro_torch.core.api import dpmr_dense_linear, fsdp_specs
    from repro_torch.core.fsdp import dpmr_dense_linear as direct

    assert dpmr_dense_linear is direct
    defs = {"w": shd.LeafDef((D, F), "float32", ("embed", "ff")),
            "n": shd.LeafDef((F,), "float32", (None,))}
    specs, shapes = fsdp_specs(defs, {"data": 4, "model": 2})
    assert specs == {"w": ("data", "model"), "n": (None,)}
    assert shapes == {"w": (8, 12), "n": (F,)}


@pytest.mark.parametrize("causal,window", CASES)
def test_cp_matches_reference(results, causal, window):
    """The output and dq, dk, dv, each rank's chunk assembled."""
    ref, ranks, _ = results
    key = f"cp/{causal}_{window}"
    for field in ("", "/dq", "/dk", "/dv"):
        got = np.concatenate([r[key + field] for r in ranks], axis=1)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, ref[key + field], rtol=0,
                                   atol=F32_TOL, err_msg=field)


def test_cp_without_a_group_is_blocked():
    from repro_torch.models import layers

    t = {n: torch.from_numpy(_inputs()[n]) for n in "qkv"}
    for causal in (True, False):
        got = layers.context_parallel_attention(t["q"], t["k"], t["v"],
                                                causal=causal)
        want = layers.blocked_causal_attention(t["q"], t["k"], t["v"]) \
            if causal else layers._bidirectional_blocked(t["q"], t["k"],
                                                         t["v"])
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def _pipe_oracle():
    data = _inputs()
    wt = torch.tensor(data["pw"], requires_grad=True)
    y = torch.from_numpy(data["px"])
    for s in range(S):
        y = torch.tanh(y @ wt[s])
    (g,) = torch.autograd.grad(torch.sum(torch.sin(y)), (wt,))
    return y.detach().numpy(), g.numpy()


def test_pipeline_forward_on_every_rank(results):
    ref, ranks, _ = results
    want, _ = _pipe_oracle()
    for r in ranks:
        assert np.max(np.abs(r["pipe/y"] - want)) < F32_TOL
        assert np.max(np.abs(r["pipe/y"] - ref["pipe/y"])) < F32_TOL


def test_pipeline_gradient_per_stage(results):
    ref, ranks, _ = results
    _, want = _pipe_oracle()
    got = np.stack([r["pipe/g"] for r in ranks])
    assert np.max(np.abs(got - want)) < F32_TOL
    assert np.max(np.abs(got - ref["pipe/g"])) < F32_TOL


def test_bubble_fraction():
    from repro.train.pipeline import bubble_fraction as jax_bubble
    from repro_torch.train.pipeline import bubble_fraction

    for stages, micro in ((4, 8), (1, 8), (8, 32)):
        assert bubble_fraction(stages, micro) == jax_bubble(stages, micro)
    assert bubble_fraction(4, 8) == 3 / 11
    assert bubble_fraction(8, 32) < 0.2


def test_checkpoint_restores_at_any_mesh(results):
    """Saved at (data 4), restored at (data 2) by both pairs of ranks, at
    no mesh and by the reference: the same arrays."""
    import jax
    import jax.numpy as jnp

    from repro.ckpt import checkpointer as jckpt
    from repro_torch import convert
    from repro_torch.ckpt.checkpointer import Checkpointer
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.train import trainer

    _, ranks, tmp = results
    pre = "ckpt/saved/"
    saved = {k[len(pre):]: v for k, v in ranks[0].items()
             if k.startswith(pre)}
    assert saved
    for r in (ranks[0], ranks[2]):
        for key, want in saved.items():
            np.testing.assert_array_equal(r[f"ckpt/data2/{key}"], want,
                                          err_msg=key)
    spec, cfg = registry.get_spec(CKPT_ARCH), registry.smoke_config(CKPT_ARCH)
    like = trainer.init_state(spec, cfg, TrainConfig(), ParallelConfig(),
                              torch.Generator().manual_seed(0), "cpu")
    one, _ = Checkpointer(str(tmp / "ckpt")).restore(like)
    tree = convert.train_state_to_numpy(one)
    for path, leaf in convert.tree_leaves(tree["params"]):
        np.testing.assert_array_equal(leaf, saved["/".join(map(str, path))])
    assert int(one["step"]) == 2 and int(one["opt"]["count"]) == 2
    template = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), tree)
    restored, _ = jckpt.Checkpointer(str(tmp / "ckpt")).restore(template, 2)
    for (path, leaf), (_, want) in zip(
            convert.tree_leaves(jax.tree.map(np.asarray, restored)),
            convert.tree_leaves(tree), strict=True):
        np.testing.assert_array_equal(leaf, want, err_msg=str(path))


def test_reshard_tree_matches_reference(results):
    """A whole state's arrays cut into (data 2) blocks: each rank of both
    pairs holds the block that the reference's `reshard_tree` puts on
    the device of its data index, bit for bit (a stacked leaf's layer
    block is the layer of the reference's shard)."""
    ref, ranks, _ = results
    for rank, r in enumerate(ranks):
        i = rank % 2
        keys = [k for k in r if k.startswith("reshard/")]
        assert len(keys) > 3
        for key in keys:
            want = ref[f"{key}/{i}"]
            got = r[key]
            assert got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_fsdp_step_matches_one_rank(results, arch):
    _, ranks, _ = results
    pair = 2 * FAMILIES[arch]
    mesh = ranks[pair]
    one = next(r for r in ranks[pair:pair + 2]
               if f"fam/{arch}/one/loss" in r)
    assert abs(float(mesh[f"fam/{arch}/mesh/loss"])
               - float(one[f"fam/{arch}/one/loss"])) < F32_TOL
    pre = f"fam/{arch}/one/after/"
    keys = [k[len(pre):] for k in one if k.startswith(pre)]
    assert keys
    for key in keys:
        want = one[pre + key]
        before = one[f"fam/{arch}/one/before/{key}"]
        np.testing.assert_array_equal(mesh[f"fam/{arch}/mesh/before/{key}"],
                                      before, err_msg=key)
        update = float(np.max(np.abs(want - before)))
        np.testing.assert_allclose(mesh[f"fam/{arch}/mesh/after/{key}"],
                                   want, rtol=0, atol=STEP_TOL * update,
                                   err_msg=key)
