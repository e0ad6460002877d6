"""The port's dense trainer over a mesh of gloo ranks against the
reference's jitted step at the same mesh, on the CPU.

One JAX subprocess on an emulated 4-device host mesh and one `mp.spawn`
of 4 gloo ranks (`tests/torch_mesh_harness.py`) train yi-6b's smoke
config (batch 8 x 16 of the reference's `LMDataset`, adamw lr 1e-2,
warmup 2, from the reference's initial params) for 3 steps at the
meshes that cover every axis at 4 ranks: (data 4), (data 2, model 2)
and (pod 2, data 2), each with microbatches 1 and 2, and at (pod 2,
data 2) with `compress_pod_grads`:
- each step's loss, grad norm and lr within 1e-5 of the reference's;
- each final param leaf within 2^-5 of its largest update (ROADMAP
  C20: adamw's step is lr * m / sqrt(v), so where a gradient is near
  zero the sums' order moves its element's update by up to lr).
The same holds at (data 2, model 2) for a config whose heads (3, over
one KV head) and ff (99) do not divide `model`: the reference's rules
replicate those leaves, and the port runs those blocks whole.
In the same spawn, `compress_psum` alone (through `compress_tree_psum`)
over the 2 pod ranks of (pod 2, data 2) equals the reference's under
shard_map bit for bit (g_hat and each pod's new error), and rank 0 trains the (1, 1) run through a gloo
mesh of one rank bit for bit as the one-card trainer.
"""
import numpy as np
import pytest

import torch_mesh_harness as h

F32_TOL = 1e-5
STEP_TOL = 2.0 ** -5       # of a leaf's largest update (C20)
ARCH = "yi-6b"
STEPS = 3
TC = {"learning_rate": 1e-2, "warmup_steps": 2, "total_steps": 10}
MESHES = {"data4": [0, 4, 1], "data2-model2": [0, 2, 2],
          "pod2-data2": [2, 2, 1]}
# 3 heads over 1 KV head of 16 and ff 99: none divides `model` = 2, so
# the rules replicate those leaves and each rank runs the blocks whole
UNDIVIDED = {"num_heads": 3, "num_kv_heads": 1, "head_dim": 16,
             "d_ff": 99}
MODELS = {ARCH: (ARCH, STEPS, {}), "undivided": (ARCH, STEPS, UNDIVIDED)}
RUN = {"arch": ARCH, "model": ARCH, "cfg": {}, "tc": TC, "steps": STEPS,
       "params": True}
RUNS = ([{**RUN, "name": f"{mesh}-mb{k}", "mesh": shape,
          "pc": {"microbatches": k}}
         for mesh, shape in MESHES.items() for k in (1, 2)]
        + [{**RUN, "name": "pod2-data2-compressed",
            "mesh": MESHES["pod2-data2"], "pc": {"compress_pod_grads": True}},
           {**RUN, "name": "data2-model2-undivided", "model": "undivided",
            "cfg": UNDIVIDED, "mesh": MESHES["data2-model2"], "pc": {}}])
PSUM_SHAPES = {"blocks": (3, 2048), "ragged": (50, 100)}   # 5,000 values

# compress_psum over the pod axis of a (pod 2, data 2) mesh, after the runs
REFERENCE_PSUM = r"""
from jax.sharding import PartitionSpec as P
from repro.optim import compression
mesh = compat.make_mesh((2, 2), ("pod", "data"))
for name in ("blocks", "ragged"):
    g, e = jnp.asarray(data["psum/" + name + "/g"]), \
        jnp.asarray(data["psum/" + name + "/e"])
    f = compat.shard_map(
        lambda g, e: [x[None] for x in compression.compress_psum(
            g[0], e[0], "pod")],
        mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=[P("pod"), P("pod")], check_vma=False)
    with compat.set_mesh(mesh):
        g_hat, err = f(g, e)
    out["psum/" + name + "/g_hat"] = np.asarray(g_hat)
    out["psum/" + name + "/err"] = np.asarray(err)
"""


def _psum_inputs():
    rng = np.random.default_rng(7)
    return {name: (rng.normal(size=(2, *shape)).astype(np.float32),
                   (1e-2 * rng.normal(size=(2, *shape))).astype(np.float32))
            for name, shape in PSUM_SHAPES.items()}


def _ranks(rank, store, inputs, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import compression

    h.join_ranks(rank, h.RANKS, store)
    meshes = {tuple(s): make_host_mesh(s[1], s[2], max(s[0], 1))
              for s in MESHES.values()}
    got = h.port_train(RUNS, inputs, meshes)
    mesh = meshes[tuple(MESHES["pod2-data2"])]
    pod, data = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    arrays = np.load(inputs)
    g_hat, err = compression.compress_tree_psum(
        {n: torch.from_numpy(arrays[f"psum/{n}/g"][pod]) for n in PSUM_SHAPES},
        {n: torch.from_numpy(arrays[f"psum/{n}/e"][pod]) for n in PSUM_SHAPES},
        mesh.get_group("pod"))
    psum = {f"psum/{n}/{field}": t[n].numpy() for n in PSUM_SHAPES
            for field, t in (("g_hat", g_hat), ("err", err))}
    if data == 0:
        np.savez(f"{out}.pod{pod}.npz", **psum)
    one, _ = dist.new_subgroups(1)
    if rank == 0:
        run = {**RUNS[0], "name": "one-rank", "mesh": [0, 1, 1]}
        got.update(h.port_train([run], inputs, {(0, 1, 1): DeviceMesh.from_group(
            one, "cpu", mesh_dim_names=("data",))}))
        got.update(h.port_train([{**run, "name": "no-mesh"}], inputs,
                                {(0, 1, 1): None}))
        np.savez(out, **got)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    inputs = tmp / "inputs.npz"
    h.write_inputs(inputs, MODELS)
    with np.load(inputs) as z:
        arrays = dict(z)
    for name, (g, e) in _psum_inputs().items():
        arrays[f"psum/{name}/g"], arrays[f"psum/{name}/e"] = g, e
    np.savez(inputs, **arrays)
    h.write_runs(tmp / "runs.json", RUNS)
    h.run_both(h.REFERENCE_TRAIN + REFERENCE_PSUM + h.REFERENCE_SAVE,
               [tmp / "runs.json", inputs, tmp / "ref.npz"], h.RANKS,
               _ranks, (str(tmp / "store"), str(inputs),
                        str(tmp / "port.npz")))
    before = {m: h.flat(h.unflat(np.load(inputs), f"{m}/params/"))
              for m in MODELS}
    port = dict(np.load(tmp / "port.npz"))
    for pod in range(2):
        port.update({f"{k}/{pod}": v for k, v in
                     np.load(tmp / f"port.npz.pod{pod}.npz").items()})
    return dict(np.load(tmp / "ref.npz")), port, before


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_mesh_step_matches_reference(results, run):
    ref, port, before = results
    name = run["name"]
    for field in ("losses", "grad_norms", "lrs"):
        np.testing.assert_allclose(port[f"{name}/{field}"],
                                   ref[f"{name}/{field}"], rtol=0,
                                   atol=F32_TOL, err_msg=field)
    assert np.all(np.diff(ref[f"{name}/lrs"]) != 0)     # the warmup moved it
    h.near_update(h.run_params(port, name), h.run_params(ref, name),
                  before[run["model"]], STEP_TOL)


def test_compressed_run_differs_from_plain(results):
    """The int8 reduction changed the numbers: compression ran."""
    ref, port, _ = results
    for res in (ref, port):
        assert not np.array_equal(res["pod2-data2-compressed/losses"][1:],
                                  res["pod2-data2-mb1/losses"][1:])


@pytest.mark.parametrize("name", sorted(PSUM_SHAPES))
def test_compress_psum_bit_exact_over_pods(results, name):
    """g_hat (the mean over the 2 pods of the dequantized codes) and each
    pod's new error, a leaf of whole blocks and a ragged one."""
    ref, port, _ = results
    for pod in range(2):
        for field in ("g_hat", "err"):
            np.testing.assert_array_equal(
                port[f"psum/{name}/{field}/{pod}"].view(np.int32),
                ref[f"psum/{name}/{field}"][pod].view(np.int32))


def test_one_rank_mesh_is_the_one_card_trainer(results):
    _, port, _ = results
    for field in ("losses", "grad_norms", "lrs"):
        np.testing.assert_array_equal(port[f"one-rank/{field}"],
                                      port[f"no-mesh/{field}"])
    mesh, plain = h.run_params(port, "one-rank"), h.run_params(port,
                                                               "no-mesh")
    assert sorted(mesh) == sorted(plain)
    for key in plain:
        np.testing.assert_array_equal(mesh[key], plain[key], err_msg=key)
