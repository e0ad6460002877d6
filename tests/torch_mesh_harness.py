"""Shared harness of the port's mesh tests (`test_torch_mesh_*.py`): the
reference runs in ONE JAX subprocess on an emulated host mesh of at most
4 devices (XLA_FLAGS, as tests/test_multidevice.py does), the port as at
most 4 gloo ranks of ONE `mp.spawn` (one intra-op thread each) on a
`file://` store under the test's tmp directory. Both start together,
write their numbers to `.npz` files, and are waited for at most
`TIMEOUT` seconds: a rank or the subprocess still alive then is killed
and fails the test. Inputs are numpy from a seed (the reference's own
`LMDataset` batches and initial params, norm scales redrawn as
1 + N(0, 0.1^2): ROADMAP C7), carried to the port with `convert`."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300
RANKS = 4
NORMS = ("ln1", "ln2", "q_norm", "k_norm", "lnx", "ln_enc", "norm",
         "out_norm")


def env(devices: int) -> dict:
    e = dict(os.environ)
    # one compute thread and cheap codegen: the programs are tiny, and
    # their compile is most of the subprocess's CPU time
    e["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices} "
                      "--xla_cpu_multi_thread_eigen=false "
                      "--xla_backend_optimization_level=0 "
                      "--xla_llvm_disable_expensive_passes=true")
    e["JAX_PLATFORMS"] = "cpu"
    e["OMP_NUM_THREADS"] = "1"
    e["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                       e.get("PYTHONPATH", "")])
    e["PYTHONWARNINGS"] = "ignore"
    return e


def start_reference(script: str, args, devices: int = RANKS):
    """The reference's side: `python -c script *args` with `devices`
    emulated host devices, started (not waited for)."""
    assert devices <= RANKS
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=env(devices), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def wait_reference(proc, deadline: float) -> None:
    try:
        _, err = proc.communicate(timeout=max(1.0, deadline
                                              - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the reference still ran after {TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]


def start_ranks(fn, args, nprocs: int = RANKS):
    import torch.multiprocessing as mp

    assert nprocs <= RANKS
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def wait_ranks(ctx, deadline: float) -> None:
    """Join every rank; a rank that raises fails the test (the others are
    terminated), and ranks still running at `deadline` are killed and
    fail it."""
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"ranks still running after {TIMEOUT} s")


def run_both(script, script_args, devices, rank_fn, rank_args,
             nprocs: int = RANKS) -> None:
    """Start the reference's subprocess and the ranks together; wait for
    both within `TIMEOUT` seconds, killing whatever is left."""
    deadline = time.monotonic() + TIMEOUT
    ref = start_reference(script, script_args, devices)
    try:
        wait_ranks(start_ranks(rank_fn, rank_args, nprocs), deadline)
    finally:
        if ref.poll() is None and time.monotonic() > deadline:
            ref.kill()
    wait_reference(ref, deadline)


def join_ranks(rank: int, world: int, store) -> None:
    """Inside a spawned rank: one thread, the gloo group, no warnings."""
    import warnings

    import torch
    import torch.distributed as dist

    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def pair_mesh():
    """Inside a 4-rank group: this rank's (data 2) mesh of ranks {0, 1}
    or {2, 3}."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sub, _ = dist.new_subgroups(2)
    return DeviceMesh.from_group(sub, "cpu", mesh_dim_names=("data",))


def _keys(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def init_tree(arch: str, seed: int = 0, overrides=None) -> dict:
    """The reference's initial params of `arch`'s smoke config (with the
    fields `overrides`) as numpy, norm scales redrawn (ROADMAP C7)."""
    import dataclasses

    import jax

    from repro.models import registry
    from repro.models.common import embed_init_scale
    from repro.sharding import init_from_defs

    cfg = dataclasses.replace(registry.smoke_config(arch),
                              **(overrides or {}))
    params = init_from_defs(registry.get_spec(arch).defs(cfg),
                            jax.random.PRNGKey(seed),
                            scale_fn=embed_init_scale)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if _keys(path)[-1] in NORMS or _keys(path)[-1] == "D_skip":
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
        if _keys(path)[-1] in ("A_log", "dt_bias"):
            return (0.5 * rng.normal(size=x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def numpy_tree(arch: str, seed: int = 0, overrides=None) -> dict:
    """`init_tree`'s distribution drawn with numpy on the reference's
    shapes (no JAX computation): matrices N(0, 0.02^2), 1-D leaves ones,
    the norm scales, D_skip, A_log and dt_bias as `init_tree` redraws
    them."""
    import dataclasses

    import jax

    from repro.models import registry
    from repro.sharding import Annotated

    cfg = dataclasses.replace(registry.smoke_config(arch),
                              **(overrides or {}))
    defs = registry.get_spec(arch).defs(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, ann):
        name = _keys(path)[-1]
        if name in NORMS or name == "D_skip":
            x = 1.0 + 0.1 * rng.normal(size=ann.shape)
        elif name in ("A_log", "dt_bias"):
            x = 0.5 * rng.normal(size=ann.shape)
        elif len(ann.shape) == 1:
            x = np.ones(ann.shape)
        else:
            x = 0.02 * rng.normal(size=ann.shape)
        return x.astype(ann.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, defs, is_leaf=lambda x: isinstance(x, Annotated))


def flat(tree, prefix: str = "") -> dict:
    """A tree of dicts (and tuples) as {"a/b/c": array}."""
    out = {}
    items = enumerate(tree) if isinstance(tree, (tuple, list)) else \
        tree.items()
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _tuples(node):
    """A tree of dicts whose nodes keyed 0 .. n - 1 become tuples (an
    xlstm's `blocks`), as `flat` found them."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return tuple(node[str(i)] for i in range(len(node)))
    return node


def unflat(arrays, prefix: str) -> dict:
    """{"prefix/a/b": array} back into a tree of dicts (and tuples)."""
    tree: dict = {}
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arrays[key])
    return _tuples(tree)


def lm_batches(arch: str, n: int, seq: int = 16, batch: int = 8) -> list:
    """The reference tests' `LMDataset` batches (frames for whisper)."""
    from repro.data.pipeline import LMDataConfig, LMDataset, encdec_batch
    from repro.models import registry

    cfg = registry.smoke_config(arch)
    ds = LMDataset(LMDataConfig(cfg.vocab_size, seq, batch))
    if cfg.family == "encdec":
        return [encdec_batch(ds, i, cfg.d_model) for i in range(n)]
    return [ds.batch(i) for i in range(n)]


def write_inputs(path, models: dict, init=init_tree) -> None:
    """{model name: (arch, n batches, config overrides)} -> one npz of each
    model's initial params (`init`: `init_tree`, or `numpy_tree`) and
    batches, under its name."""
    arrays = {}
    for name, (arch, n, overrides) in models.items():
        arrays.update(flat(init(arch, overrides=overrides),
                           f"{name}/params/"))
        for i, b in enumerate(lm_batches(arch, n)):
            arrays.update(flat(b, f"{name}/batch{i}/"))
    np.savez(path, **arrays)


def write_runs(path, runs) -> None:
    pathlib.Path(path).write_text(json.dumps(runs))


# The reference's side of a list of training runs (JSON: name, model (the
# inputs' name of its params and batches), arch, cfg (overrides of the
# smoke config's fields), mesh [pods, data, model] with pods 0 for no pod
# dim, tc, pc, steps, params) into `out`: losses, grad norms, lrs and,
# where asked, the final params.
REFERENCE_TRAIN = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro import sharding as shd
from repro.models import registry
from repro.train import trainer
from repro.configs.base import TrainConfig, ParallelConfig
from repro.optim import compression, optimizers

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

for r in runs:
    arch, key = r["arch"], r["model"]
    cfg = dataclasses.replace(registry.smoke_config(arch), **r["cfg"])
    spec = registry.get_spec(arch)
    tc = TrainConfig(**r["tc"])
    pc = ParallelConfig(**r["pc"])
    pods, d, m = r["mesh"]
    mesh = compat.make_mesh((pods, d, m), ("pod", "data", "model")) \
        if pods else compat.make_mesh((d, m), ("data", "model"))
    losses, norms, lrs, auxes = [], [], [], []
    with compat.set_mesh(mesh):
        # `trainer.init_state` of the given params (its draw skipped)
        params = unflat(key + "/params/")
        state = {"params": params,
                 "opt": optimizers.get_optimizer(tc.optimizer).init(
                     params, cfg.opt_dtype),
                 "step": jnp.zeros((), jnp.int32)}
        if pc.compress_pod_grads:
            state["err"] = compression.init_error_state(params)
        # the state in the reference's layout, kept there across steps
        state_sh = trainer.shardings_for_state(
            trainer.state_defs(spec, cfg, tc, pc), mesh)
        batch_sh = jax.tree.map(
            lambda _: jax.sharding.NamedSharding(
                mesh, shd.batch_spec(mesh)), unflat(f"{key}/batch0/"))
        state = jax.device_put(state, state_sh)
        step = jax.jit(trainer.make_train_step(spec, cfg, tc, pc, mesh),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None))
        for i in range(r["steps"]):
            state, met = step(state, unflat(f"{key}/batch{i}/"))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            lrs.append(float(met["lr"]))
            auxes.append(float(met["aux"]))
    out[r["name"] + "/losses"] = np.asarray(losses)
    out[r["name"] + "/grad_norms"] = np.asarray(norms)
    out[r["name"] + "/lrs"] = np.asarray(lrs)
    out[r["name"] + "/aux"] = np.asarray(auxes)
    if r.get("params"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            out[r["name"] + "/params/" + keys(path)] = np.asarray(leaf)
"""
# ...and its last line: the script may compute more into `out` between
REFERENCE_SAVE = """
np.savez(sys.argv[3], **out)
"""


def port_train(runs: list, inputs, meshes: dict, device: str = "cpu"
               ) -> dict:
    """The port's side of the same runs in this rank (every rank calls
    it; `meshes` maps a run's mesh, as a tuple, to this rank's
    `DeviceMesh`, None for no mesh): {name/losses, ...} as rank 0 sees
    them."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.train import trainer

    data = np.load(inputs)
    out = {}
    for r in runs:
        arch, key = r["arch"], r["model"]
        cfg = dataclasses.replace(registry.smoke_config(arch), **r["cfg"])
        spec = registry.get_spec(arch)
        tc = TrainConfig(**r["tc"])
        pc = ParallelConfig(**r["pc"])
        mesh = meshes[tuple(r["mesh"])]
        full = dict(convert.params_from_numpy(
            unflat(data, f"{key}/params/"), cfg, device,
            train=True).named_parameters())
        state = trainer.init_from_params(spec, cfg, tc, pc, full, device,
                                         mesh)
        step = trainer.make_train_step(spec, cfg, tc, pc, mesh)
        losses, norms, lrs, auxes = [], [], [], []
        for i in range(r["steps"]):
            batch = {k: torch.from_numpy(v) for k, v in
                     unflat(data, f"{key}/batch{i}/").items()}
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            lrs.append(float(met["lr"]))
            auxes.append(float(met["aux"]))
        out[r["name"] + "/losses"] = np.asarray(losses)
        out[r["name"] + "/grad_norms"] = np.asarray(norms)
        out[r["name"] + "/lrs"] = np.asarray(lrs)
        out[r["name"] + "/aux"] = np.asarray(auxes)
        if r.get("params"):
            model = state["params"]
            for path, leaf in convert.tree_leaves(convert.params_to_numpy(
                    model, trainer.full_params(model))):
                out[r["name"] + "/params/" + "/".join(map(str, path))] = leaf
    return out


def run_params(res: dict, name: str) -> dict:
    pre = f"{name}/params/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def near_update(got: dict, want: dict, before: dict, tol: float) -> None:
    """Every leaf of `got` within `tol` of the largest update of the same
    leaf of `want` from `before` (ROADMAP C20's bound)."""
    assert sorted(got) == sorted(want)
    for key in want:
        update = float(np.max(np.abs(want[key] - before[key])))
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=tol * update, err_msg=key)


def wire_rank(rank: int, store: str, out: str, mesh: dict, rows: int,
              names) -> None:
    """Inside a spawned rank of a (pod, data) mesh of 4: each strategy's
    real `train_step` recorded by `repro_torch.analysis.trace.Recorder`;
    rank 0 writes {name: its strategy-scoped collectives, its context's
    counts, its declared bytes} as JSON to `out`."""
    import json

    import torch.distributed as dist

    join_ranks(rank, 4, store)
    from repro_torch.analysis import trace
    from repro_torch.analysis.audit import engine_batch
    from repro_torch.api.engine import put_batch
    from repro_torch.api.strategies import get_strategy
    from repro_torch.configs.base import DPMRConfig
    from repro_torch.core import dpmr
    from repro_torch.launch.mesh import make_host_mesh

    dmesh = make_host_mesh(data=mesh["data"], pods=mesh["pod"])
    rb = put_batch(engine_batch(rows, 1 << 10, 8), "cpu", dmesh)
    got = {}
    for name in names:
        cfg = DPMRConfig(num_features=1 << 10, max_features_per_sample=8,
                         distribution=name)
        # capacity at the mean: hier_a2a's inner capacity stays unclamped
        fns = dpmr.make_step_fns(cfg, rows, mesh=dmesh, cap_factor=1.0)
        state = dpmr.init_state(cfg, "cpu", mesh=dmesh)
        rec = trace.Recorder(dmesh, tuple(mesh))
        strat = get_strategy(name)
        with trace.strategy_scope(rec, strat), rec:
            fns.train_step(state, rb)
        ctx = fns.ctx
        got[name] = {"ops": [list(c) for c in rec.scoped("strategy")],
                     "ctx": [ctx.num_shards, ctx.block_size, ctx.capacity,
                             ctx.outer_shards, ctx.topk_frac],
                     "declared": list(strat.bytes_per_device(ctx))}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)
    dist.destroy_process_group()
