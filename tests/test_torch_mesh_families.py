"""The MoE, hybrid, SSM and encoder-decoder families trained over a mesh
of gloo ranks with `model` > 1 against the reference's jitted step at the
same mesh, on the CPU.

One JAX subprocess on an emulated 4-device host mesh and one `mp.spawn`
of 4 gloo ranks (`tests/torch_mesh_harness.py`) train each family's
smoke config (batch 8 x 16 of the reference's `LMDataset`, whisper's
frames too; adamw lr 1e-2, warmup 2; from params drawn with numpy on the
reference's shapes, `torch_mesh_harness.numpy_tree`) for 2 steps:
- phi3.5-moe (E = 4) at (data 2, model 2): the experts split over
  `model` (each rank routes its S-shard, all-to-alls to the owners); the
  default groups of 512 tokens hold the whole microbatch, so every group
  spans the 4 ranks;
- phi3.5-moe at (data 4) with microbatches 2, groups of 64 tokens (a
  rank holds 16 of a microbatch's) and capacity factor 0.5, so each
  group spans the 4 DP ranks and binds capacity (C30);
- mixtral (SWA W = 8) with 6 experts at (model 4): 6 does not divide 4,
  so `ff` splits (each rank its ff columns, partial outputs summed);
- zamba2 at (data 2, model 2) (2 SSM heads split) and at (model 4)
  (d_inner 128 splits, the 2 heads do not: the block runs whole on its
  gathered leaves);
- xlstm-125m at (data 2, model 2) (mLSTM and sLSTM head-parallel, the
  sLSTM's ff of 85 whole);
- whisper-small at (data 2, model 2), head-parallel and with
  `attn_mode="cp"`.
Each step's loss, aux, grad norm and lr within 1e-5 of the reference's,
and each final param leaf within 2^-5 of its largest update (ROADMAP
C20).

In the same spawn, the MoE layer alone on one global input (8, 16, 64),
groups of 64 tokens and capacity factor 0.5 (capacity 16, pairs
dropped), against the reference's `moe_block` and its routing lines:
at (data 4) (rows), at (data 2, model 2) (the experts split, S-shards)
and, for 6 experts, at (model 4) (ff split): every rank's experts,
capacity positions and kept mask bit for bit, its rows of the output
and the aux within 1e-5. And rank 0 trains phi3.5-moe through a gloo
mesh of one rank bit for bit as the one-card trainer (the routing over
ranks engaged).
"""
import numpy as np
import pytest

import torch_mesh_harness as h

F32_TOL = 1e-5
STEP_TOL = 2.0 ** -5       # of a leaf's largest update (C20)
STEPS = 2
TC = {"learning_rate": 1e-2, "warmup_steps": 2, "total_steps": 10}
PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x22b"
SPAN = {"capacity_factor": 0.5}
SIX = {"num_experts": 6}
MODELS = {"phi": (PHI, STEPS, {}), "mixtral6": (MIXTRAL, STEPS, SIX),
          "zamba2": ("zamba2-2.7b", STEPS, {}),
          "xlstm": ("xlstm-125m", STEPS, {}),
          "whisper": ("whisper-small", STEPS, {})}
RUNS = [
    {"name": "phi-experts-split", "model": "phi", "mesh": [0, 2, 2],
     "pc": {}},
    {"name": "phi-groups-span-dp-mb2", "model": "phi", "cfg": SPAN,
     "mesh": [0, 4, 1], "pc": {"moe_group": 64, "microbatches": 2}},
    {"name": "mixtral6-ff-split", "model": "mixtral6", "mesh": [0, 1, 4],
     "pc": {}},
    {"name": "zamba2-heads-split", "model": "zamba2", "mesh": [0, 2, 2],
     "pc": {}},
    {"name": "zamba2-heads-whole", "model": "zamba2", "mesh": [0, 1, 4],
     "pc": {}},
    {"name": "xlstm-heads-split", "model": "xlstm", "mesh": [0, 2, 2],
     "pc": {}},
    {"name": "whisper-heads-split", "model": "whisper", "mesh": [0, 2, 2],
     "pc": {}},
    {"name": "whisper-cp", "model": "whisper", "mesh": [0, 2, 2],
     "pc": {"attn_mode": "cp"}},
]
for _r in RUNS:
    _arch, _, _cfg = MODELS[_r["model"]]
    _r.update(arch=_arch, tc=TC, steps=STEPS, params=True)
    _r["cfg"] = {**_cfg, **_r.get("cfg", {})}

# the MoE layer alone: (case, arch, config overrides, port meshes)
GROUP = 64
ROUTE_B, ROUTE_S = 8, 16
ROUTE_CASES = {"phi": (PHI, SPAN, ([0, 4, 1], [0, 2, 2])),
               "mixtral6": (MIXTRAL, {**SPAN, **SIX}, ([0, 1, 4],))}

REFERENCE_ROUTE = r"""
import dataclasses
from repro.models import moe as jmoe
for case, (arch, over) in json.load(open(sys.argv[1] + ".route")).items():
    cfg = dataclasses.replace(registry.smoke_config(arch), **over)
    x = jnp.asarray(data["route/" + case + "/x"])
    p = {k: jnp.asarray(data["route/" + case + "/" + k])
         for k in ("router", "wi_gate", "wi_up", "wo")}
    o, a = jmoe.moe_block(p, x, cfg, group_size=GROUP)
    # the reference's routing, its own lines of `moe_block` (moe.py:78-98)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    ng = b * s // GROUP
    cap = jmoe.expert_capacity(cfg, GROUP)
    logits = jnp.einsum("ngd,de->nge", x.reshape(ng, GROUP, d),
                        p["router"], preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(ng, -1, e)
    pos = jnp.cumsum(flat, axis=1) - 1
    keep = (pos < cap) & (flat > 0)
    chosen = idx.reshape(ng, -1, 1)
    pre = "route/" + case + "/"
    out[pre + "out"] = np.asarray(o)
    out[pre + "aux"] = np.asarray(a)
    out[pre + "idx"] = np.asarray(idx).reshape(b, s, k)
    out[pre + "pos"] = np.asarray(
        jnp.take_along_axis(pos, chosen, -1)).reshape(b, s, k)
    out[pre + "keep"] = np.asarray(
        jnp.take_along_axis(keep, chosen, -1)).reshape(b, s, k)
""".replace("GROUP", str(GROUP))


def _route_inputs(arrays):
    """A global input and the four leaves of each case (numpy f32)."""
    import dataclasses

    from repro_torch.models import registry

    rng = np.random.default_rng(11)
    for case, (arch, over, _) in ROUTE_CASES.items():
        cfg = dataclasses.replace(registry.smoke_config(arch), **over)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        pre = f"route/{case}/"
        arrays[pre + "x"] = rng.normal(size=(ROUTE_B, ROUTE_S, d)).astype(
            np.float32)
        for name, shape, scale in (("router", (d, e), 0.3),
                                   ("wi_gate", (e, d, f), 0.1),
                                   ("wi_up", (e, d, f), 0.1),
                                   ("wo", (e, f, d), 0.1)):
            arrays[pre + name] = (scale * rng.normal(size=shape)).astype(
                np.float32)


def _port_route(inputs, meshes) -> dict:
    """This rank's MoE layer of each case at each of its meshes: its
    tokens' routing, output rows and aux, with where its tokens lie."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from repro_torch.core.fsdp import ParamLayout
    from repro_torch.models import moe, parallel as par, registry

    data = np.load(inputs)
    got = {}
    for case, (arch, over, case_meshes) in ROUTE_CASES.items():
        cfg = dataclasses.replace(registry.smoke_config(arch), **over)
        spec = registry.get_spec(arch)
        x = torch.from_numpy(data[f"route/{case}/x"])
        for shape in case_meshes:
            mesh = meshes[tuple(shape)]
            layout = ParamLayout(spec, cfg, mesh)
            tp = par.TP(layout)
            leaves = {}
            for leaf in ("router", "wi_gate", "wi_up", "wo"):
                full = torch.from_numpy(data[f"route/{case}/{leaf}"])
                for dim, s in enumerate(layout.specs[f"layers.0.mlp.{leaf}"]):
                    if s == "model":            # the `model` block only
                        n = full.shape[dim] // tp.size
                        full = full.narrow(dim, tp.rank * n, n)
                leaves[leaf] = full
            p = SimpleNamespace(**leaves)
            dp = layout.size("data")
            rows = ROUTE_B // dp
            row0 = layout.coord["data"] * rows
            cols = ROUTE_S // tp.size
            col0 = tp.rank * cols
            mine = x[row0:row0 + rows, col0:col0 + cols]
            if tp.size > 1:
                out, aux = par.tp_moe_ffn(p, mine, cfg, tp, GROUP)
            else:
                out, aux = moe.moe_block(
                    p, mine, cfg, GROUP, par.moe_exchange(layout, False,
                                                          cols))
            split = cfg.num_experts % tp.size == 0
            ex = par.moe_exchange(layout, split, cols)
            routed = mine if split else x[row0:row0 + rows]
            r = moe.route_exchanged(p, routed, cfg, GROUP, ex)
            sl = slice(None) if split else slice(col0, col0 + cols)
            pre = f"route/{case}/{'x'.join(map(str, shape))}/"
            got.update({pre + "out": out.detach().numpy(),
                        pre + "aux": aux.detach().numpy(),
                        pre + "idx": r.idx[:, sl].numpy(),
                        pre + "pos": r.pos[:, sl].numpy(),
                        pre + "keep": r.keep[:, sl].numpy(),
                        pre + "where": np.asarray([row0, rows, col0, cols])})
    return got


def _ranks(rank, store, inputs, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh

    h.join_ranks(rank, h.RANKS, store)
    shapes = {tuple(r["mesh"]) for r in RUNS}
    meshes = {s: make_host_mesh(s[1], s[2], max(s[0], 1)) for s in shapes}
    got = h.port_train(RUNS, inputs, meshes)
    route = _port_route(inputs, meshes)
    np.savez(f"{out}.rank{rank}.npz", **route)
    one, _ = dist.new_subgroups(1)
    if rank == 0:
        run = {**RUNS[0], "name": "one-rank", "mesh": [0, 1, 1]}
        one_mesh = DeviceMesh.from_group(one, "cpu",
                                         mesh_dim_names=("data",))
        got.update(h.port_train([run], inputs, {(0, 1, 1): one_mesh}))
        got.update(h.port_train([{**run, "name": "no-mesh"}], inputs,
                                {(0, 1, 1): None}))
        np.savez(out, **got)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("mesh_families")
    inputs = tmp / "inputs.npz"
    h.write_inputs(inputs, MODELS, h.numpy_tree)
    with np.load(inputs) as z:
        arrays = dict(z)
    _route_inputs(arrays)
    np.savez(inputs, **arrays)
    h.write_runs(tmp / "runs.json", RUNS)
    (tmp / "runs.json.route").write_text(json.dumps(
        {case: (arch, over) for case, (arch, over, _) in
         ROUTE_CASES.items()}))
    h.run_both(h.REFERENCE_TRAIN + REFERENCE_ROUTE + h.REFERENCE_SAVE,
               [tmp / "runs.json", inputs, tmp / "ref.npz"], h.RANKS,
               _ranks, (str(tmp / "store"), str(inputs),
                        str(tmp / "port.npz")))
    before = {m: h.flat(h.unflat(np.load(inputs), f"{m}/params/"))
              for m in MODELS}
    ranks = [dict(np.load(tmp / f"port.npz.rank{r}.npz"))
             for r in range(h.RANKS)]
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz")), \
        ranks, before


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_family_mesh_step_matches_reference(results, run):
    ref, port, _, before = results
    name = run["name"]
    for field in ("losses", "aux", "grad_norms", "lrs"):
        np.testing.assert_allclose(port[f"{name}/{field}"],
                                   ref[f"{name}/{field}"], rtol=0,
                                   atol=F32_TOL, err_msg=field)
    assert np.all(np.diff(ref[f"{name}/lrs"]) != 0)     # the warmup moved it
    if MODELS[run["model"]][0] in (PHI, MIXTRAL):
        assert np.all(ref[f"{name}/aux"] > 0)
    h.near_update(h.run_params(port, name), h.run_params(ref, name),
                  before[run["model"]], STEP_TOL)


ROUTE_IDS = [(case, "x".join(map(str, shape)))
             for case, (_, _, shapes) in ROUTE_CASES.items()
             for shape in shapes]


@pytest.mark.parametrize("case,mesh", ROUTE_IDS,
                         ids=[f"{c}-{m}" for c, m in ROUTE_IDS])
def test_moe_routing_over_ranks_matches_reference(results, case, mesh):
    """Every rank's experts, capacity positions and kept mask equal the
    reference's at its tokens bit for bit (pairs are dropped: capacity
    16 of a group's 128 pairs over 4 or 6 experts); its output rows and
    the aux within 1e-5."""
    ref, _, ranks, _ = results
    pre = f"route/{case}/"
    assert not ref[pre + "keep"].all()
    for r in ranks:
        mine = f"{pre}{mesh}/"
        row0, rows, col0, cols = r[mine + "where"]
        at = (slice(row0, row0 + rows), slice(col0, col0 + cols))
        for field in ("idx", "pos", "keep"):
            np.testing.assert_array_equal(r[mine + field],
                                          ref[pre + field][at],
                                          err_msg=field)
        np.testing.assert_allclose(r[mine + "out"], ref[pre + "out"][at],
                                   rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(r[mine + "aux"], ref[pre + "aux"],
                                   rtol=0, atol=F32_TOL)


def test_one_rank_mesh_is_the_one_card_trainer(results):
    """phi3.5-moe through a gloo mesh of one rank (the routing gathered
    and counted over the mesh, the aux from the gathered shares) trains
    bit for bit as the one-card trainer."""
    _, port, _, _ = results
    for field in ("losses", "aux", "grad_norms", "lrs"):
        np.testing.assert_array_equal(port[f"one-rank/{field}"],
                                      port[f"no-mesh/{field}"])
    mesh, plain = h.run_params(port, "one-rank"), h.run_params(port,
                                                               "no-mesh")
    assert sorted(mesh) == sorted(plain)
    for key in plain:
        np.testing.assert_array_equal(mesh[key], plain[key], err_msg=key)
