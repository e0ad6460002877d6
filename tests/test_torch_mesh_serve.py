"""Every family served over a mesh of gloo ranks against the reference's
prefill and greedy decode on the same emulated mesh, on the CPU.

One JAX subprocess on an emulated 4-device host mesh and one `mp.spawn`
of 4 gloo ranks (`tests/torch_mesh_harness.py`) serve the smoke configs
(f32; params drawn with numpy on the reference's shapes,
`torch_mesh_harness.numpy_tree`) from the same numpy prompts. The
reference runs `make_prefill_step` (`ParallelConfig(seq_shard=False)`,
as its `serve_dense`) and `make_decode_step` in `greedy_decode`'s loop
under `compat.set_mesh`, jitted with its params placed by
`tree_shardings(spec.defs(cfg))` and its cache by
`tree_shardings(spec.cache_defs(...))`, the cache kept in that layout
across the steps (`out_shardings=(None, cache_sh)`), as its dry run's
prefill and decode cells place them. The port runs
`spec.mesh_prefill`/`spec.mesh_decode_step` on each rank's blocks
(`trainer.sharded_model(..., train=False)`, `parallel.ServeMesh`).

The runs (batch 4):
- yi-6b at (data 2, model 2) and (model 4), prompt 32: 64 slots, split
  over `model` (`kv_seq`: 2 KV heads do not reach 16); at (model 4) with
  prompt 30: 62 slots, which 4 does not divide, so the cache is whole;
- phi3.5-moe (capacity factor 0.5, so that pairs drop) at (data 2,
  model 2): the 4 experts split over `model`, every decode step's group
  spanning the DP ranks; and at (data 4);
- mixtral at (model 4), prompt 16 = 2W: the window's ring of 8 slots
  split over `model`;
- zamba2 at (data 2, model 2) (its 2 SSD heads split) and at (model 4)
  (the heads whole, the conv cache split); and with 16 heads and 16 KV
  heads at (model 4), so that the shared attention's cache takes the
  `kv_heads` layout;
- xlstm-125m and whisper-small (frames 32, prompt 16) at (data 2,
  model 2).
Each case: the greedy tokens bit for bit; the prefill and each decode
step's logits within 1e-4 of the row's largest |logit|; every cache
leaf, gathered after prefill and after the last step, within 1e-4 of the
leaf's largest |value|, `length` equal; each rank's cache blocks shaped
as `tree_shard_shapes` of the port's cache defs, whose logical axes are
the reference's; MoE dropped pairs (the sum over the layers of a call)
equal at prefill and at every step. A step whose top-2 logit margin is
under the tolerance is reported (a near tie), not reseeded.

In the same spawn: `next_token` over (model 4) on logits with ties
planted across and within ranks equals `torch.argmax` of the whole
rows; `greedy_decode(..., mesh)` gives the manual loop's tokens on every
rank; and rank 0 serves yi-6b and phi3.5-moe through a gloo mesh
(data 1, model 1) of one rank, bit for bit as with no mesh (tokens,
logits, every cache leaf).
"""
import json

import numpy as np
import pytest

import torch_mesh_harness as h

TOL = 1e-4
B = 4
STEPS = 4                   # greedy tokens: the prefill's and 3 decode steps'
PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x22b"
SPAN = {"capacity_factor": 0.5}
HEADS16 = {"num_heads": 16, "num_kv_heads": 16}
MODELS = {"yi": ("yi-6b", {}), "phi": (PHI, SPAN),
          "mixtral": (MIXTRAL, {}), "zamba2": ("zamba2-2.7b", {}),
          "zamba16": ("zamba2-2.7b", HEADS16),
          "xlstm": ("xlstm-125m", {}), "whisper": ("whisper-small", {})}
RUNS = [
    {"name": "yi-2x2", "model": "yi", "mesh": [2, 2], "prompt": 32},
    {"name": "yi-model4", "model": "yi", "mesh": [1, 4], "prompt": 32},
    {"name": "yi-model4-slots-whole", "model": "yi", "mesh": [1, 4],
     "prompt": 30},
    {"name": "phi-2x2", "model": "phi", "mesh": [2, 2], "prompt": 32},
    {"name": "phi-data4", "model": "phi", "mesh": [4, 1], "prompt": 32},
    {"name": "mixtral-model4-ring", "model": "mixtral", "mesh": [1, 4],
     "prompt": 16},
    {"name": "zamba2-2x2", "model": "zamba2", "mesh": [2, 2], "prompt": 32},
    {"name": "zamba2-model4", "model": "zamba2", "mesh": [1, 4],
     "prompt": 32},
    {"name": "zamba2-heads16-model4", "model": "zamba16", "mesh": [1, 4],
     "prompt": 32},
    {"name": "xlstm-2x2", "model": "xlstm", "mesh": [2, 2], "prompt": 32},
    {"name": "whisper-2x2", "model": "whisper", "mesh": [2, 2],
     "prompt": 16, "frames": 32},
]
for _r in RUNS:
    _r["arch"], _r["cfg"] = MODELS[_r["model"]]
    _r.update(batch=B, steps=STEPS)
GREEDY_RUNS = ("yi-2x2", "phi-2x2")     # greedy_decode(mesh) == the loop
ONE_RANK = ("yi", "phi")                # a one-rank mesh == no mesh

REFERENCE_SERVE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro import compat
from repro.configs.base import ParallelConfig
from repro.models import moe as jmoe, registry
from repro.sharding import logical_to_spec, tree_shardings, Annotated
from repro.train import serve

runs = json.load(open(sys.argv[1]))
data = np.load(sys.argv[2])
out = {}

def tuples(node):
    if not isinstance(node, dict):
        return node
    node = {k: tuples(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return tuple(node[str(i)] for i in range(len(node)))
    return node

def unflat(prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(data[key])
    return tuples(tree)

def keys(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                    for k in path)

# the (token, slot) pairs each moe_block call drops, its own routing lines
drops = []
real_moe = jmoe.moe_block

def counted(p, x, cfg, group_size=jmoe.GROUP_SIZE):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    g = min(group_size, b * s)
    ng = b * s // g
    cap = jmoe.expert_capacity(cfg, g)
    logits = jnp.einsum("ngd,de->nge", x.reshape(ng, g, d),
                        p["router"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(ng, -1, e)
    pos = jnp.cumsum(flat, axis=1) - 1
    jax.debug.callback(lambda c: drops.append(int(c)),
                       jnp.sum((pos >= cap) & (flat > 0)))
    return real_moe(p, x, cfg, group_size)

jmoe.moe_block = counted

for r in runs:
    name = r["name"]
    cfg = dataclasses.replace(registry.smoke_config(r["arch"]), **r["cfg"])
    spec = registry.get_spec(r["arch"])
    d, m = r["mesh"]
    mesh = compat.make_mesh((d, m), ("data", "model"))
    tokens = data[name + "/tokens"]
    b, s = tokens.shape
    steps = r["steps"]
    max_len = s if cfg.sliding_window else s + 32
    cdefs = spec.cache_defs(cfg, b, max_len)
    for path, a in jax.tree_util.tree_flatten_with_path(
            cdefs, is_leaf=lambda x: isinstance(x, Annotated))[0]:
        out[name + "/logical/" + keys(path)] = np.asarray(json.dumps(
            list(a.logical)))
    with compat.set_mesh(mesh):
        def place(x, logical):
            return jax.device_put(x, NamedSharding(
                mesh, logical_to_spec(logical, x.shape, mesh)))
        psh = tree_shardings(spec.defs(cfg), mesh)
        params = jax.device_put(unflat(r["model"] + "/params/"), psh)
        batch = {"tokens": place(jnp.asarray(tokens, jnp.int32),
                                 ("batch", None))}
        if cfg.family == "encdec":
            batch["frames"] = place(jnp.asarray(data[name + "/frames"]),
                                    ("batch", None, None))
        bsh = jax.tree.map(lambda x: x.sharding, batch)
        prefill = jax.jit(serve.make_prefill_step(
            spec, cfg, ParallelConfig(seq_shard=False)),
            in_shardings=(psh, bsh))
        csh = tree_shardings(cdefs, mesh)
        tsh = NamedSharding(mesh, logical_to_spec(("batch", None), (b, 1),
                                                  mesh))
        decode = jax.jit(serve.make_decode_step(spec, cfg),
                         in_shardings=(psh, csh, tsh),
                         out_shardings=(None, csh))
        drops.clear()
        logits, cache = prefill(params, batch)
        cache = jax.device_put(cache, csh)
        jax.block_until_ready(cache)
        calls = [sum(drops)]
        for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[name + "/pre/" + keys(path)] = np.asarray(leaf)
        toks = []
        for i in range(steps):
            out[name + "/logits/" + str(i)] = np.asarray(logits)
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            toks.append(np.asarray(tok))
            if i == steps - 1:
                break
            drops.clear()
            logits, cache = decode(params, cache, place(tok, ("batch", None)))
            jax.block_until_ready(cache)
            calls.append(sum(drops))
        for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[name + "/post/" + keys(path)] = np.asarray(leaf)
        out[name + "/tokens_out"] = np.concatenate(toks, axis=1)
        out[name + "/drops"] = np.asarray(calls)
np.savez(sys.argv[3], **out)
"""


def _inputs(path) -> None:
    """The params of each model and each run's prompts (and frames)."""
    import dataclasses

    from repro_torch.models import registry

    arrays = {}
    for key, (arch, over) in MODELS.items():
        arrays.update(h.flat(h.numpy_tree(arch, overrides=over),
                             f"{key}/params/"))
    rng = np.random.default_rng(7)
    for r in RUNS:
        cfg = dataclasses.replace(registry.smoke_config(r["arch"]),
                                  **r["cfg"])
        arrays[r["name"] + "/tokens"] = rng.integers(
            0, cfg.vocab_size, size=(B, r["prompt"])).astype(np.int32)
        if cfg.family == "encdec":
            arrays[r["name"] + "/frames"] = rng.normal(
                size=(B, r["frames"], cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


def _leaves(defs, blocks, prefix=""):
    """(key, LeafDef, block) of a cache's defs and blocks, in order."""
    from repro_torch import sharding as shd

    if isinstance(defs, shd.LeafDef):
        yield prefix[:-1], defs, blocks
        return
    items = enumerate(defs) if isinstance(defs, (list, tuple)) else \
        defs.items()
    for k, d in items:
        yield from _leaves(d, blocks[k], f"{prefix}{k}/")


def _setup(r, data, mesh):
    """This rank's blocks of run `r`'s model over `mesh`, its ServeMesh
    and view, and its rows of the prompt batch."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.models import parallel, registry
    from repro_torch.train import trainer

    cfg = dataclasses.replace(registry.smoke_config(r["arch"]), **r["cfg"])
    spec = registry.get_spec(r["arch"])
    whole = dict(convert.params_from_numpy(
        h.unflat(data, f"{r['model']}/params/"), cfg,
        "cpu").named_parameters())
    model = trainer.sharded_model(spec, cfg, mesh, "cpu",
                                  lambda name, shape: whole[name],
                                  train=False)
    sm = parallel.ServeMesh(model.layout, B)
    batch = {"tokens": torch.from_numpy(data[r["name"] + "/tokens"])}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(data[r["name"] + "/frames"])
    return spec, cfg, model, sm, batch


def _serve_run(r, data, mesh) -> tuple[dict, dict]:
    """Run `r` on this rank: (what rank 0 keeps: whole logits, tokens,
    caches; this rank's own: block shapes, dropped pairs, where it lies)."""
    import torch

    from repro_torch import sharding as shd
    from repro_torch.models import common, moe, parallel
    from repro_torch.train import serve

    spec, cfg, model, sm, batch = _setup(r, data, mesh)
    view = parallel.ShardedView(model, model.layout)
    vocab = shd.LeafDef((B, 1, common.padded_vocab(cfg)), "float32",
                        ("batch", None, "vocab"))
    name = r["name"]
    kept, own = {}, {}
    seen = []
    real = moe.route_exchanged

    def counting(*args, **kwargs):
        routed = real(*args, **kwargs)
        seen.append(int((~routed.keep).sum()))
        return routed

    def caches(tag, cache):
        for key, d, blk in _leaves(sm.defs, cache):
            kept[f"{name}/{tag}/{key}"] = sm.full(blk, d).numpy()
            own[f"{name}/{tag}/shape/{key}"] = np.asarray(blk.shape)
            own[f"{name}/{tag}/want/{key}"] = np.asarray(shd.shard_shape(
                d.shape, d.spec(mesh), mesh))
            own[f"{name}/logical/{key}"] = np.asarray(json.dumps(
                list(d.logical)))

    moe.route_exchanged = counting
    try:
        mine = {k: sm.my_rows(v) for k, v in batch.items()}
        logits, cache = spec.mesh_prefill(view, mine, cfg, sm)
        caches("pre", cache)
        drops = [sum(seen)]
        toks = []
        for i in range(STEPS):
            kept[f"{name}/logits/{i}"] = sm.full(logits, vocab).numpy()
            tok = parallel.next_token(logits, cfg, sm.tp)
            toks.append(sm.full(tok, shd.LeafDef((B, 1), "int32",
                                                 ("batch", None))))
            if i == STEPS - 1:
                break
            seen.clear()
            logits, cache = spec.mesh_decode_step(view, cache, tok, cfg, sm)
            drops.append(sum(seen))
        caches("post", cache)
    finally:
        moe.route_exchanged = real
    kept[f"{name}/tokens_out"] = torch.cat(toks, dim=1).numpy()
    own[f"{name}/drops"] = np.asarray(drops) \
        if model.layout.coord["model"] == 0 else np.zeros(len(drops), int)
    if name in GREEDY_RUNS:
        own[f"{name}/greedy"] = serve.greedy_decode(
            spec, cfg, model, batch, STEPS, "cpu", mesh).numpy()
    return kept, own


PLANTED = np.full((6, 256), -1.0, np.float32)
PLANTED[0, [5, 200]] = 3.0       # across ranks: 5 (rank 0), 200 (rank 3)
PLANTED[1, [140, 130]] = 2.0     # within rank 2
PLANTED[2, [70, 64, 130]] = 1.0  # within rank 1 and across to rank 2
PLANTED[3, 77] = 9.0             # one maximum
PLANTED[4] = 0.5                 # every column equal
PLANTED[5, [255, 128, 191]] = 4.0


def _argmax_planted(mesh) -> np.ndarray:
    import torch

    from repro_torch.core.fsdp import ParamLayout
    from repro_torch.models import parallel, registry

    cfg = registry.smoke_config("yi-6b")
    tp = parallel.TP(ParamLayout(registry.get_spec("yi-6b"), cfg, mesh))
    n = PLANTED.shape[1] // tp.size
    mine = torch.from_numpy(PLANTED[:, None, tp.rank * n:(tp.rank + 1) * n])
    return parallel.next_token(mine, cfg, tp).numpy()


def _one_rank(data, mesh) -> dict:
    """yi-6b and phi3.5-moe through `mesh` (data 1, model 1: a gloo group
    of one rank) and with no mesh, from the same whole params: whether
    tokens, logits and every cache leaf are bit-identical."""
    import torch

    from repro_torch.models import parallel

    out = {}
    for key in ONE_RANK:
        r = next(x for x in RUNS if x["model"] == key)
        spec, cfg, model, sm, batch = _setup(r, data, mesh)
        whole = {n: model.layout.full(n, p)
                 for n, p in model.named_parameters()}
        plain = spec.model(cfg, device="cpu")
        plain.load_state_dict(whole)
        view = parallel.ShardedView(model, model.layout)
        lm, cm = spec.mesh_prefill(view, batch, cfg, sm)
        lp, cp = spec.prefill(plain, batch, cfg)
        same = [torch.equal(lm, lp)]
        for _ in range(STEPS - 1):
            tm = parallel.next_token(lm, cfg, sm.tp)
            tp_ = torch.argmax(lp[:, -1], dim=-1)[:, None].to(torch.int32)
            same.append(torch.equal(tm, tp_))
            lm, cm = spec.mesh_decode_step(view, cm, tm, cfg, sm)
            lp, cp = spec.decode_step(plain, cp, tp_, cfg)
            same.append(torch.equal(lm, lp))
        same += [torch.equal(cm[k], cp[k]) for k in cp]
        out[f"one_rank/{key}"] = np.asarray(same)
    return out


def _ranks(rank, store, inputs, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh

    h.join_ranks(rank, h.RANKS, store)
    data = np.load(inputs)
    meshes = {tuple(s): make_host_mesh(*s) for s in
              {tuple(r["mesh"]) for r in RUNS}}
    kept, own = {}, {}
    for r in RUNS:
        k, o = _serve_run(r, data, meshes[tuple(r["mesh"])])
        kept.update(k)
        own.update(o)
    own["argmax"] = _argmax_planted(meshes[(1, 4)])
    one, _ = dist.new_subgroups(1)
    if rank == 0:
        mesh = DeviceMesh.from_group([one, one], "cpu",
                                     mesh=torch.tensor([[0]]),
                                     mesh_dim_names=("data", "model"))
        kept.update(_one_rank(data, mesh))
        np.savez(out, **kept)
    np.savez(f"{out}.rank{rank}.npz", **own)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)
    h.write_runs(tmp / "runs.json", RUNS)
    h.run_both(REFERENCE_SERVE, [tmp / "runs.json", inputs, tmp / "ref.npz"],
               h.RANKS, _ranks, (str(tmp / "store"), str(inputs),
                                 str(tmp / "port.npz")))
    ranks = [dict(np.load(tmp / f"port.npz.rank{r}.npz"))
             for r in range(h.RANKS)]
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz")), \
        ranks


def _near_ties(logits, tol):
    """(step, row, margin) where the top-2 margin is under tol x the row's
    scale."""
    out = []
    for i, lg in enumerate(logits):
        top = np.sort(lg[:, -1], axis=-1)[:, -2:]
        scale = np.max(np.abs(lg[:, -1]), axis=-1)
        for row in np.nonzero(top[:, 1] - top[:, 0] < tol * scale)[0]:
            out.append((i, int(row), float(top[row, 1] - top[row, 0])))
    return out


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_mesh_serve_matches_reference(results, run):
    """Tokens bit for bit, logits and every gathered cache leaf within
    1e-4 of their scale, `length` equal, the blocks shaped by the rules
    (logical axes the reference's), the dropped pairs equal."""
    import dataclasses

    from repro_torch.models import registry

    ref, port, ranks = results
    name = run["name"]
    cfg = dataclasses.replace(registry.smoke_config(run["arch"]),
                              **run["cfg"])
    v = cfg.vocab_size
    want_logits = [ref[f"{name}/logits/{i}"][..., :v] for i in range(STEPS)]
    ties = _near_ties(want_logits, TOL)
    if ties:
        print(f"{name}: near ties (step, row, margin) {ties}")
    np.testing.assert_array_equal(port[f"{name}/tokens_out"],
                                  ref[f"{name}/tokens_out"],
                                  err_msg=f"near ties: {ties}")
    for i, want in enumerate(want_logits):
        got = port[f"{name}/logits/{i}"][..., :v]
        scale = np.max(np.abs(want), axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= TOL * scale), (name, i)
    for tag in ("pre", "post"):
        pre = f"{name}/{tag}/"
        keys = sorted(k[len(pre):] for k in ref if k.startswith(pre))
        assert keys == sorted(k[len(pre):] for k in port
                              if k.startswith(pre)), name
        for key in keys:
            want, got = ref[pre + key], port[pre + key]
            assert got.shape == want.shape, (name, tag, key)
            if key == "length":
                np.testing.assert_array_equal(got, want)
                continue
            scale = float(np.max(np.abs(want))) or 1.0
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                                       err_msg=f"{name} {tag} {key}")
            for rk in ranks:
                np.testing.assert_array_equal(
                    rk[f"{name}/{tag}/shape/{key}"],
                    rk[f"{name}/{tag}/want/{key}"])
            assert json.loads(str(ranks[0][f"{name}/logical/{key}"])) == \
                json.loads(str(ref[f"{name}/logical/{key}"])), key
    if cfg.num_experts:
        got = sum(rk[f"{name}/drops"] for rk in ranks)
        np.testing.assert_array_equal(got, ref[f"{name}/drops"])


def test_mesh_serve_moe_drops_pairs(results):
    """The MoE runs drop pairs at capacity factor 0.5, so the equal counts
    above are not all zero."""
    ref, _, _ = results
    assert sum(int(ref[f"{r['name']}/drops"].sum()) for r in RUNS
               if r["model"] == "phi") > 0


def test_mesh_caches_are_split(results):
    """The blocks are split as the reference's rule says: yi-6b's slots
    over `model` (kv_seq) at prompt 32, whole at 30 (62 slots); the
    16-KV-head zamba2's shared K/V by heads; zamba2's conv split while
    its 2 SSD heads stay whole at (model 4)."""
    _, _, ranks = results
    shape = ranks[0]
    assert tuple(shape["yi-model4/pre/shape/k"]) == (2, 4, 16, 2, 16)
    assert tuple(shape["yi-2x2/pre/shape/k"]) == (2, 2, 32, 2, 16)
    assert tuple(shape["yi-model4-slots-whole/pre/shape/k"]) == \
        (2, 4, 62, 2, 16)
    assert tuple(shape["mixtral-model4-ring/pre/shape/k"]) == \
        (2, 4, 2, 2, 16)
    assert tuple(shape["zamba2-heads16-model4/pre/shape/k"]) == \
        (2, 4, 64, 4, 16)
    assert tuple(shape["zamba2-model4/pre/shape/conv"]) == (4, 4, 3, 32)
    assert tuple(shape["zamba2-model4/pre/shape/ssd"]) == (4, 4, 2, 16, 64)


def test_greedy_decode_over_mesh_gives_every_rank_the_tokens(results):
    """`greedy_decode(..., mesh)` returns the whole batch's tokens on
    every rank, the manual loop's."""
    _, port, ranks = results
    for name in GREEDY_RUNS:
        for rk in ranks:
            np.testing.assert_array_equal(rk[f"{name}/greedy"],
                                          port[f"{name}/tokens_out"])


def test_vocab_parallel_argmax_planted_ties(results):
    """The first maximum of the whole padded row, over 4 ranks' columns:
    ties across ranks and within one go to the lowest column."""
    import torch

    _, _, ranks = results
    want = torch.argmax(torch.from_numpy(PLANTED), dim=-1).numpy()
    assert want.tolist() == [5, 130, 64, 77, 0, 128]
    for rk in ranks:
        np.testing.assert_array_equal(rk["argmax"][:, 0], want)


@pytest.mark.parametrize("key", ONE_RANK)
def test_one_rank_mesh_is_no_mesh_bit_for_bit(results, key):
    """A gloo mesh of one rank (data 1, model 1; every collective still
    called) gives the one-card prefill and decode: logits, tokens and
    every cache leaf bit-identical."""
    _, port, _ = results
    same = port[f"one_rank/{key}"]
    assert same.size > 2 * STEPS and bool(same.all()), same


LAUNCH = ["--arch", PHI, "--smoke", "--device", "cpu", "--batch", "4",
          "--prompt-len", "32", "--decode-steps", "8"]


def _torchrun(cwd) -> dict:
    import os
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore",
               PYTHONPATH=os.pathsep.join([str(h.ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(h.RANKS), "-m", "repro_torch.launch.serve",
         *LAUNCH, "--mesh-data", "2", "--mesh-model", "2"],
        env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out, err = proc.communicate(timeout=h.TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"torchrun still ran after {h.TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def test_launch_serve_over_mesh_under_torchrun(results, tmp_path, capsys):
    """`launch.serve --arch phi3.5-moe --smoke --mesh-data 2 --mesh-model
    2 --device cpu` under torchrun (4 gloo ranks, after the spawn has
    ended) prints the tokens md5 of one process without a mesh; the mesh
    flags without torchrun are refused."""
    from repro_torch.launch import serve as launch_serve

    meshed = _torchrun(tmp_path)
    assert meshed["mesh"] == {"data": 2, "model": 2}
    capsys.readouterr()
    toks = launch_serve.main(LAUNCH)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    one = json.loads(line[-1])
    assert tuple(toks.shape) == (4, 8) and one["mesh"] is None
    assert meshed["tokens_md5"] == one["tokens_md5"]
    with pytest.raises(SystemExit):
        launch_serve.main([*LAUNCH, "--mesh-model", "2"])
