"""The port at P > 1 against the JAX package, on the CPU.

The JAX engine runs in one subprocess on an emulated 8-device host mesh
(XLA_FLAGS, as tests/test_multidevice.py does): the (8,) mesh for the
flat strategies and a (pod 2, data 4) mesh for hier_a2a and its two
compositions. Each run: 2^12 features, K 16, global batch 256 (32 rows a
rank), 3 `fit_sgd` steps, one `fit` iteration over 2 batches, `predict`
of a held-out batch. The port runs the same runs as 8 gloo ranks of one
`mp.spawn`, each from the reference's initial state cut into its blocks
(`convert.state_from_numpy`), on a `file://` store under the test's tmp
directory (parallel test workers never share a port).

Tolerances are those of the P = 1 tests in tests/test_torch_strategies.py
(atol 1e-5: the same f32 arithmetic in another order of summation);
routing integers are bit-exact, and the strategies that the reference
calls bit-identical to `a2a` are bit-identical here.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
F, K, B, P = 1 << 12, 16, 256, 8
CORPUS = dict(num_features=F, features_per_sample=K, signal_features=256)
FIELDS = ("cold", "hot", "hot_ids", "cold_acc", "hot_acc", "step", "strat")
FLOAT_FIELDS = ("cold", "hot", "cold_acc", "hot_acc", "strat")
# run -> (strategy, topk_frac, mesh): the runs both packages make
REFERENCE_RUNS = {
    "a2a": ("a2a", 0.25, "flat"),
    "allgather": ("allgather", 0.25, "flat"),
    "psum_scatter": ("psum_scatter", 0.25, "flat"),
    "compressed_reduce": ("compressed_reduce", 0.25, "flat"),
    "topk_reduce-0.25": ("topk_reduce", 0.25, "flat"),
    "topk_reduce-0.05": ("topk_reduce", 0.05, "flat"),
    "overlap_a2a": ("overlap_a2a", 0.25, "flat"),
    "hier_a2a": ("hier_a2a", 0.25, "pods"),
    "hier_a2a+topk": ("hier_a2a+topk", 0.05, "pods"),
    "hier_a2a+int8": ("hier_a2a+int8", 0.25, "pods"),
}
# port-only runs: (strategy, topk_frac, mesh, the reference run whose
# initial state it starts from)
REPEAT_RUNS = {
    "a2a-again": ("a2a", 0.25, "flat", "a2a"),
    "topk_reduce-0.05-again": ("topk_reduce", 0.05, "flat",
                               "topk_reduce-0.05"),
    "hier_a2a-one-pod": ("hier_a2a", 0.25, "flat", "a2a"),
    # (pod 2, data 2, model 2): the same pods as (pod 2, data 4), the
    # inner group over two dims
    "hier_a2a-3d": ("hier_a2a", 0.25, "pods3d", "hier_a2a"),
}
LAUNCH_ARGS = ["--sparse", "--device", "cpu", "--strategy", "a2a",
               "--features", "4096", "--batch", "256", "--steps", "3",
               "--data-seed", "3"]


def _kw(dist, frac):
    return dict(num_features=F, max_features_per_sample=K, max_hot=16,
                learning_rate=2.0, optimizer="adagrad", distribution=dist,
                topk_frac=frac)


def _batches():
    from repro_torch import get_source

    src = get_source("zipf_sparse", batch_size=B, **CORPUS)
    return [src.batch(i) for i in range(6)]


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 8 emulated devices
# ---------------------------------------------------------------------------


def _jax_reference(path):
    """Every reference run, into one npz: the initial state, the state
    after 3 fit_sgd steps and after one fit iteration, the metrics, the
    probabilities, and each rank's routing of batch 0."""
    import jax

    from repro import compat
    from repro.api import DPMREngine, hot_ids_from_corpus
    from repro.api.strategies import _hier_remap
    from repro.configs.base import DPMRConfig
    from repro.core import dpmr, hot_sharding, sparse
    from repro.launch.mesh import make_host_mesh

    assert len(jax.devices()) == P, jax.devices()
    meshes = {"flat": make_host_mesh(P, 1),
              "pods": compat.make_mesh((2, 4), ("pod", "data"))}
    batches = _batches()
    out = {}

    def leaves(state):
        return [np.asarray(x) for x in jax.tree.leaves(state)]

    for run, (dist, frac, mesh_name) in REFERENCE_RUNS.items():
        mesh = meshes[mesh_name]
        cfg = DPMRConfig(**_kw(dist, frac))
        with compat.set_mesh(mesh):
            hot = hot_ids_from_corpus(cfg, batches[:4], mesh)
        hot_np = np.asarray(hot)        # the engine donates its state
        eng = DPMREngine(cfg, mesh, hot_ids=hot)
        for i, leaf in enumerate(leaves(eng.state)):
            out[f"{run}/init/{FIELDS[i]}"] = leaf
        hist = eng.fit_sgd(batches[:3], steps=3)
        for key in ("loss", "accuracy", "overflow"):
            out[f"{run}/sgd/{key}"] = np.asarray([h[key] for h in hist])
        for i, leaf in enumerate(leaves(eng.state)):
            out[f"{run}/sgd/{FIELDS[i]}"] = leaf
        fit = eng.fit(lambda: iter(batches[3:5]), iterations=1)
        out[f"{run}/fit/loss"] = np.asarray([fit[0]["loss"]])
        for i, leaf in enumerate(leaves(eng.state)):
            out[f"{run}/fit/{FIELDS[i]}"] = leaf
        out[f"{run}/probs"] = np.asarray(eng.predict(batches[5]))
        # each rank's routing of batch 0, as its shard of the step builds
        # it: the flat exchange, or hier_a2a's inner one over the mirror
        ctx = eng.fns.ctx
        cap = dpmr.capacity_for_shards(cfg, B // P, P)
        ids = np.asarray(batches[0]["ids"])
        for r in range(P):
            flat = jax.numpy.asarray(ids[r * (B // P):(r + 1) * (B // P)]
                                     .reshape(-1))
            _, _, cold = hot_sharding.split_hot(flat,
                                                jax.numpy.asarray(hot_np))
            if ctx.outer_shards > 1:
                po, pi = ctx.outer_shards, ctx.inner_shards
                routing = sparse.route_build(
                    _hier_remap(cold, po, pi, ctx.block_size), pi,
                    po * ctx.block_size, min(flat.shape[0], cap * po))
            else:
                routing = sparse.route_build(cold, P, ctx.block_size, cap)
            out[f"{run}/req_ids/{r}"] = np.asarray(routing.req_ids)
            out[f"{run}/overflow/{r}"] = np.asarray(routing.overflow)
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# the port, 8 gloo ranks
# ---------------------------------------------------------------------------


def _port_run(run, dist_name, frac, mesh, init, batches):
    """One run on this rank; returns its records (global state leaves,
    metrics, probabilities, this rank's routing of batch 0)."""
    from repro_torch import DPMRConfig, DPMREngine
    from repro_torch.api.strategies import get_strategy
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import dpmr

    cfg = DPMRConfig(**_kw(dist_name, frac))
    state = state_from_numpy([init[f] for f in FIELDS], "cpu", mesh)
    eng = DPMREngine(cfg, device="cpu", mesh=mesh, state=state)
    out = {}
    hist = eng.fit_sgd(batches[:3], steps=3)
    for key in ("loss", "accuracy", "overflow"):
        out[f"{run}/sgd/{key}"] = np.asarray([h[key] for h in hist])
    for name, leaf in zip(FIELDS, state_to_numpy(eng.state, mesh),
                          strict=True):
        out[f"{run}/sgd/{name}"] = leaf
    fit = eng.fit(lambda: iter(batches[3:5]), iterations=1)
    out[f"{run}/fit/loss"] = np.asarray([fit[0]["loss"]])
    for name, leaf in zip(FIELDS, state_to_numpy(eng.state, mesh),
                          strict=True):
        out[f"{run}/fit/{name}"] = leaf
    out[f"{run}/probs"] = eng.predict(batches[5])
    # this rank's routing of batch 0, and the requests it received
    fns = eng.step_fns(B)
    b = eng.put_batch(batches[0])
    _, fwd, _ = dpmr._device_fwd(cfg, get_strategy(dist_name), fns.ctx,
                                 eng.state.cold, eng.state.hot,
                                 eng.state.hot_ids, b["ids"], b["vals"])
    if "routing" in fwd:
        out[f"{run}/req_ids"] = fwd["routing"].req_ids.numpy()
        out[f"{run}/req_recv"] = fwd["req_recv"].numpy()
    out[f"{run}/overflow"] = fwd["overflow"].numpy()
    out[f"{run}/wire"] = _wire_of_one_step(get_strategy(dist_name), fns.ctx,
                                           eng.state, b)
    out[f"{run}/wire_model"] = np.asarray(
        get_strategy(dist_name).bytes_per_device(fns.ctx))
    return out


def _wire_of_one_step(strategy, ctx, state, batch):
    """(inner, outer) bytes this rank receives from other ranks in one
    `distribute` and `reduce` (the sparsified path of a lossy strategy),
    recorded at torch.distributed's collectives."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import hot_sharding

    got = np.zeros(2, np.int64)
    real_a2a, real_ag = dist.all_to_all_single, dist.all_gather_into_tensor

    def tier(group):
        return int(ctx.groups.outer is not None and group is ctx.groups.outer)

    def a2a(out, x, group=None, async_op=False):
        g = dist.get_world_size(group)
        got[tier(group)] += out.numel() * out.element_size() * (g - 1) // g
        return real_a2a(out, x, group=group, async_op=async_op)

    def ag(out, x, group=None, async_op=False):
        got[tier(group)] += (out.numel() - x.numel()) * x.element_size()
        return real_ag(out, x, group=group, async_op=async_op)

    _, _, cold_ids = hot_sharding.split_hot(batch["ids"].reshape(-1),
                                            state.hot_ids)
    grads = torch.full(cold_ids.shape, 1e-3)
    dist.all_to_all_single, dist.all_gather_into_tensor = a2a, ag
    try:
        _, fwd = strategy.distribute(ctx, state.cold, cold_ids)
        carry = strategy.init_carry(ctx, "cpu")
        if carry is not None:
            fwd = {**fwd, "carry": carry, "accumulate": False}
        strategy.reduce(ctx, state.cold, grads, fwd)
    finally:
        dist.all_to_all_single, dist.all_gather_into_tensor = real_a2a, \
            real_ag
    return got


def _one_thread():
    """One intra-op thread a rank: 8 ranks of 8 threads each on a loaded
    host spin against each other and run hundreds of times slower."""
    import torch

    torch.set_num_threads(1)


def _rank_main(rank, store, ref_path, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    _one_thread()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=P)
    try:
        ref = np.load(ref_path)
        meshes = {"flat": make_host_mesh(P),
                  "pods": make_host_mesh(4, pods=2),
                  "pods3d": make_host_mesh(2, 2, pods=2)}
        batches = _batches()
        out = {}
        runs = {run: (*spec, run) for run, spec in REFERENCE_RUNS.items()}
        runs.update(REPEAT_RUNS)
        for run, (dist_name, frac, mesh_name, init_run) in runs.items():
            init = {f: ref[f"{init_run}/init/{f}"] for f in FIELDS}
            out.update(_port_run(run, dist_name, frac, meshes[mesh_name],
                                 init, batches))
        out.update(_put_batch_records(meshes["flat"], batches[0]))
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _put_batch_records(mesh, batch):
    """This rank's rows of a global batch, and the error of a batch one
    row short of a multiple of P."""
    from repro_torch.api import put_batch

    out = {"put_batch/ids": put_batch(batch, "cpu", mesh)["ids"].numpy()}
    try:
        put_batch({k: v[:B - 1] for k, v in batch.items()}, "cpu", mesh)
    except ValueError as e:
        out["put_batch/ragged"] = np.asarray(str(e))
    return out


def _launch_rank(rank, store, out_dir):
    """`launch.train`'s run in a rank of a 4-rank mp.spawn."""
    import torch.distributed as dist

    from repro_torch.launch import train

    _one_thread()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        args = train.build_parser().parse_args(LAUNCH_ARGS)
        out = train.train_sparse(args, "cpu")
        (pathlib.Path(out_dir) / f"launch{rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, nprocs, timeout=300):
    """`fn(rank, *args)` in `nprocs` spawned processes; a rank that raises
    fails the test, and ranks still running after `timeout` seconds are
    killed and fail it."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    # join returns as soon as any rank exits (raising if one failed), so
    # wait again until all have
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{fn.__name__} ranks still running after "
                        f"{timeout} s")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference npz, [8 ranks' npz]), both runs made once."""
    tmp = tmp_path_factory.mktemp("multirank")
    ref_path = tmp / "reference.npz"
    env = _env()
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, __file__, "jax", str(ref_path)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _spawn(_rank_main, (str(tmp / "store"), str(ref_path), str(tmp)), P)
    ref = np.load(ref_path)
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(P)]
    return ref, ranks


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("run", list(REFERENCE_RUNS))
def test_matches_jax(run, results):
    """Losses, accuracy, tables, carries and probabilities of every
    strategy at P = 8 (or on the (2, 4) mesh) against the reference's;
    overflow counts and the replicated hot ids exactly."""
    ref, ranks = results
    port = ranks[0]
    for phase in ("sgd", "fit"):
        _close(port[f"{run}/{phase}/loss"], ref[f"{run}/{phase}/loss"],
               f"{run} {phase} loss")
        for name in FLOAT_FIELDS:
            got, want = port[f"{run}/{phase}/{name}"], \
                ref[f"{run}/{phase}/{name}"]
            assert got.shape == want.shape, (run, phase, name)
            _close(got, want, f"{run} {phase} {name}")
        for name in ("hot_ids", "step"):
            np.testing.assert_array_equal(port[f"{run}/{phase}/{name}"],
                                          ref[f"{run}/{phase}/{name}"])
    np.testing.assert_array_equal(port[f"{run}/sgd/accuracy"],
                                  ref[f"{run}/sgd/accuracy"])
    np.testing.assert_array_equal(port[f"{run}/sgd/overflow"],
                                  ref[f"{run}/sgd/overflow"])
    _close(port[f"{run}/probs"], ref[f"{run}/probs"], f"{run} probs")
    # every rank ends with the same whole-batch probabilities and losses
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"{run}/probs"],
                                      port[f"{run}/probs"])
        np.testing.assert_array_equal(other[f"{run}/sgd/loss"],
                                      port[f"{run}/sgd/loss"])


@pytest.mark.parametrize("run", [r for r in REFERENCE_RUNS
                                 if r != "allgather"])
def test_routing_bit_exact_per_rank(run, results):
    """Each rank's request matrix and overflow of batch 0 equal the
    reference's shard's; the requests a rank received are the column of
    every source's matrix addressed to it (the all_to_all)."""
    ref, ranks = results
    for r, port in enumerate(ranks):
        want = ref[f"{run}/req_ids/{r}"]
        np.testing.assert_array_equal(port[f"{run}/req_ids"], want)
        assert int(port[f"{run}/overflow"]) == int(ref[f"{run}/overflow/{r}"])
    pods = REFERENCE_RUNS[run][2] == "pods"
    for r, port in enumerate(ranks):
        # hier_a2a exchanges inside a pod of 4: sources are the pod's ranks
        srcs = [(r // 4) * 4 + i for i in range(4)] if pods else range(P)
        col = r % 4 if pods else r
        want = np.stack([ref[f"{run}/req_ids/{s}"][col] for s in srcs])
        np.testing.assert_array_equal(port[f"{run}/req_recv"], want)


@pytest.mark.parametrize("run,same_as", [
    ("overlap_a2a", "a2a"), ("hier_a2a-one-pod", "a2a"),
    ("a2a-again", "a2a"), ("topk_reduce-0.05-again", "topk_reduce-0.05"),
    ("hier_a2a-3d", "hier_a2a")])
def test_bit_identical(run, same_as, results):
    """overlap_a2a and hier_a2a with one pod are bit-identical to a2a, a
    second P = 8 run is bit-identical to the first (C5), and hier_a2a on a
    (pod, data, model) mesh to the same pods as (pod, data): every table,
    carry, metric and probability."""
    _, ranks = results
    for port in ranks:
        for key in port.files:
            if key.startswith(f"{same_as}/") and "/init/" not in key:
                tail = key[len(same_as):]
                other = port[f"{run}{tail}"]
                assert other.dtype == port[key].dtype, key
                assert other.shape == port[key].shape, key
                assert other.tobytes() == port[key].tobytes(), \
                    f"{run}{tail} differs from {key}"


def test_lossy_runs_bank_a_residual(results):
    """The lossy strategies train with a live carry at P = 8 (and so are
    tested on it): topk_reduce at 0.05 drops slots, compressed_reduce
    quantizes, hier_a2a's legs work across the 2 pods."""
    _, ranks = results
    for run in ("topk_reduce-0.05", "compressed_reduce", "hier_a2a+topk",
                "hier_a2a+int8"):
        assert np.abs(ranks[0][f"{run}/sgd/strat"]).sum() > 0, run


def test_put_batch_takes_this_ranks_rows(results):
    _, ranks = results
    ids = np.asarray(_batches()[0]["ids"])
    n = B // P
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["put_batch/ids"],
                                      ids[r * n:(r + 1) * n])


def test_put_batch_refuses_rows_not_split_by_p(results):
    _, ranks = results
    for got in ranks:
        assert "put_batch/ragged" in got.files, "a ragged batch was cut"
        assert f"{B - 1} rows is not a multiple of P={P}" in str(
            got["put_batch/ragged"])


@pytest.mark.parametrize("run", list(REFERENCE_RUNS))
def test_wire_bytes_match_jax(run):
    """Both tiers of `bytes_per_device` equal the reference's on the (8,)
    and (2, 4) geometries (analytic: no process group)."""
    from repro.api.strategies import StrategyContext as JaxContext
    from repro.api.strategies import get_strategy as jax_get_strategy
    from repro.configs.base import DPMRConfig as JaxConfig
    from repro.core import dpmr as jdpmr
    from repro_torch import DPMRConfig
    from repro_torch.api.strategies import StrategyContext, get_strategy
    from repro_torch.core import dpmr

    dist_name, frac, mesh = REFERENCE_RUNS[run]
    po = 2 if mesh == "pods" else 1
    cap = dpmr.capacity(DPMRConfig(**_kw(dist_name, frac)), B // P, P)
    assert cap == jdpmr.capacity_for_shards(JaxConfig(**_kw(dist_name, frac)),
                                            B // P, P)
    geo = dict(num_shards=P, block_size=F // P, capacity=cap,
               outer_shards=po, topk_frac=frac)
    got = get_strategy(dist_name).bytes_per_device(StrategyContext(**geo))
    want = jax_get_strategy(dist_name).bytes_per_device(JaxContext(
        axes=(), **geo))
    assert tuple(got) == tuple(want) and got.total == want.total
    assert (got.outer > 0) == (po > 1)


@pytest.mark.parametrize("run", list(REFERENCE_RUNS))
def test_wire_bytes_on_the_wire_match_the_model(run, results):
    """The bytes a rank received in one step's distribute and reduce,
    recorded at the collectives (an all_to_all brings (G - 1) of its G
    rows from other ranks, an all_gather all but the rank's own part),
    equal `bytes_per_device` on both tiers. `psum_scatter`'s reduce is an
    all_to_all of (P, block) segments, so it receives the (P - 1) blocks
    of the reference's model."""
    _, ranks = results
    for port in ranks:
        np.testing.assert_array_equal(port[f"{run}/wire"],
                                      port[f"{run}/wire_model"])
    assert ranks[0][f"{run}/wire"].sum() > 0


def test_launch_train_under_torchrun(tmp_path):
    """`launch.train --sparse` under torchrun (4 gloo ranks) prints the
    losses and table of the same run made through mp.spawn."""
    _spawn(_launch_rank, (str(tmp_path / "store"), str(tmp_path)), 4)
    spawned = json.loads((tmp_path / "launch0.json").read_text())
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *LAUNCH_ARGS], env=_env(), cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout       # rank 0 alone prints
    out = json.loads(lines[0])
    assert out["losses"] == spawned["losses"] and len(out["losses"]) == 3
    assert out["cold_md5"] == spawned["cold_md5"]
    assert out["mesh"] == {"data": 4, "model": 1}
    assert out["wire_bytes"] == spawned["wire_bytes"]



@pytest.mark.parametrize("argv,names", [
    (["--sparse", "--ckpt", "/tmp/ck"], "ROADMAP A7"),
    (["--sparse", "--data-dir", "/tmp/d"], "ROADMAP A7"),
    (["--sparse", "--hosts", "2"], "ROADMAP A7"),
    (["--strategy", "a2a"], "ROADMAP A12")])
def test_launch_train_refuses_what_is_not_ported(argv, names, capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(argv)
    assert names in capsys.readouterr().err


def test_init_from_env_needs_torchrun(monkeypatch):
    """Without torchrun's variables there is no group to join: it raises
    rather than run one rank alone."""
    from repro_torch.launch import mesh

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.init_from_env("cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh(2)

if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, str(ROOT / "src"))
    _jax_reference(sys.argv[2])
