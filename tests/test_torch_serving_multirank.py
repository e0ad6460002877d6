"""The port's sparse serving at P ranks against the JAX package's, on the
CPU.

- P = 8: the JAX server runs in one subprocess on an emulated 8-device
  (4, 2) host mesh, the body of tests/test_serving.py's
  `test_serving_8dev_parity` (server A), and a second server whose hot
  cache refreshes every 2 lookups from a window of 4 requests (server B).
  The port serves the same requests from the reference's trained state
  (`convert.state_from_numpy`, cut into each rank's blocks) in one
  `mp.spawn` of 8 gloo ranks on a (4, 2) mesh: rank 0 is the front, the
  other ranks run `serve_follower()`. Every answer is bit-identical to
  the port's `predict_padded` of that request (a collective, made by
  every rank after `stop()`) and within 1e-5 of the reference's; the
  request count and the cache's hits, misses and refreshes equal the
  reference's (one client, so the sequence is deterministic); the
  followers return on `stop()`; `submit` off rank 0 raises.
- `launch.serve --sparse` from one checkpoint the JAX engine wrote: the
  port at 2 gloo ranks (`mp.spawn`) and at one gives the counters of the
  reference's `serve_sparse`, and the answers of the 2 ranks have the
  md5 of the single rank's.
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
P = 8
F, K = 1 << 12, 8
FIELDS = ("cold", "hot", "hot_ids", "cold_acc", "hot_acc", "step", "strat")
SIZES = [16, 3, 8, 11, 1, 16]        # server A's: the reference's
SIZES_B = [1, 2, 16, 4, 1, 1, 3, 8, 1, 2, 5, 1]
SERVERS = {
    "A": (dict(max_batch=32, max_wait_ms=5.0),
          dict(max_hot=64, threshold=0.0, window=64, refresh_every=1000)),
    "B": (dict(max_batch=16, max_wait_ms=2.0),
          dict(max_hot=16, threshold=0.0, window=4, refresh_every=2)),
}
COUNTERS = ("requests", "samples", "cache_hits", "cache_misses",
            "cache_refreshes", "cache_stale_refreshes",
            "cache_step_refreshes")
# launch.serve: one client, so the cache sees the requests in order
LAUNCH = ["--sparse", "--features", "4096", "--requests", "64",
          "--request-size", "1", "--clients", "1", "--hot-max", "64",
          "--hot-threshold", "0.0", "--hot-window", "8",
          "--hot-refresh-every", "4", "--max-wait-ms", "1.0"]


def _requests(get_source):
    src = get_source("zipf_sparse", batch_size=16, num_batches=8,
                     num_features=F, features_per_sample=K, seed=0)
    reqs = {"A": [(src.batch(i)["ids"][:n], src.batch(i)["vals"][:n])
                  for i, n in enumerate(SIZES)],
            "B": [(src.batch(i % 8)["ids"][:n], src.batch(i % 8)["vals"][:n])
                  for i, n in enumerate(SIZES_B)]}
    return src, reqs


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 8 emulated devices
# ---------------------------------------------------------------------------


def _jax_reference(path):
    import jax

    from repro.api import DPMREngine
    from repro.configs.base import DPMRConfig
    from repro.data import get_source
    from repro.launch.mesh import make_host_mesh
    from repro.serve import BatchingConfig, DPMRServeEngine, HotCacheConfig

    assert len(jax.devices()) == P, jax.devices()
    mesh = make_host_mesh(4, 2)
    cfg = DPMRConfig(num_features=F, max_features_per_sample=K, max_hot=16)
    src, reqs = _requests(get_source)
    eng = DPMREngine(cfg, mesh)
    eng.fit_sgd(src.iter_batches(), steps=8)
    out = {f"state/{name}": np.asarray(leaf) for name, leaf in
           zip(FIELDS, jax.tree.leaves(eng.state), strict=True)}
    for name, (batching, hot) in SERVERS.items():
        srv = DPMRServeEngine(eng, batching=BatchingConfig(**batching),
                              hot_cache=HotCacheConfig(**hot))
        futs = [srv.submit(ids, vals) for ids, vals in reqs[name]]
        got = [np.asarray(f.result(timeout=300)) for f in futs]
        srv.stop()
        for i, ((ids, vals), g) in enumerate(zip(reqs[name], got,
                                                 strict=True)):
            out[f"{name}/answer{i}"] = g
            # the reference's own claim: bit-identical to predict_padded
            assert np.array_equal(
                g, eng.predict_padded({"ids": ids, "vals": vals})), i
        m = srv.metrics_snapshot()
        for key in COUNTERS:
            out[f"{name}/{key}"] = np.asarray(m.get(key, 0))
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# the port, 8 gloo ranks
# ---------------------------------------------------------------------------


def _one_thread():
    import torch

    torch.set_num_threads(1)


def _rank_main(rank, store, ref_path, out_dir):
    import torch.distributed as dist

    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch.convert import state_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import (BatchingConfig, DPMRServeEngine,
                                   HotCacheConfig)

    _one_thread()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=P)
    try:
        mesh = make_host_mesh(4, 2)
        ref = np.load(ref_path)
        cfg = DPMRConfig(num_features=F, max_features_per_sample=K,
                         max_hot=16)
        state = state_from_numpy([ref[f"state/{f}"] for f in FIELDS], "cpu",
                                 mesh)
        eng = DPMREngine(cfg, device="cpu", mesh=mesh, state=state)
        _, reqs = _requests(get_source)
        out = {}
        for name, (batching, hot) in SERVERS.items():
            srv = DPMRServeEngine(eng, batching=BatchingConfig(**batching),
                                  hot_cache=HotCacheConfig(**hot))
            if rank == 0:
                futs = [srv.submit(ids, vals) for ids, vals in reqs[name]]
                got = [np.asarray(f.result(timeout=300)) for f in futs]
                srv.stop()
                for i, g in enumerate(got):
                    out[f"{name}/answer{i}"] = g
                m = srv.metrics_snapshot()
                for key in COUNTERS:
                    out[f"{name}/{key}"] = np.asarray(m.get(key, 0))
            else:
                try:
                    srv.submit(*reqs[name][0])
                except RuntimeError as e:
                    out[f"{name}/submit_error"] = np.asarray(str(e))
                srv.serve_follower()         # returns on rank 0's stop()
                out[f"{name}/follower_returned"] = np.asarray(True)
            # predict_padded is a collective: every rank, every request
            for i, (ids, vals) in enumerate(reqs[name]):
                out[f"{name}/padded{i}"] = eng.predict_padded(
                    {"ids": ids, "vals": vals})
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
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
    tmp = tmp_path_factory.mktemp("serving_multirank")
    ref_path = tmp / "reference.npz"
    env = _env()
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, __file__, "jax", str(ref_path)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _spawn(_rank_main, (str(tmp / "store"), str(ref_path), str(tmp)), P)
    return np.load(ref_path), [np.load(tmp / f"rank{r}.npz")
                               for r in range(P)]


@pytest.mark.parametrize("server", list(SERVERS))
def test_p8_server_answers_as_the_reference(server, results):
    """Rank 0's answers: bit-identical to predict_padded at P = 8 (which
    every rank computes alike), within 1e-5 of the reference's; the
    counters equal the reference's."""
    ref, ranks = results
    n = len(SIZES if server == "A" else SIZES_B)
    for i in range(n):
        got = ranks[0][f"{server}/answer{i}"]
        np.testing.assert_array_equal(got, ranks[0][f"{server}/padded{i}"])
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[f"{server}/padded{i}"], got)
        np.testing.assert_allclose(got, ref[f"{server}/answer{i}"],
                                   atol=ATOL, rtol=0, err_msg=str(i))
    got = {k: int(ranks[0][f"{server}/{k}"]) for k in COUNTERS}
    want = {k: int(ref[f"{server}/{k}"]) for k in COUNTERS}
    assert got == want
    assert got["requests"] == n
    if server == "B":       # the mirror was gathered again and again
        assert got["cache_refreshes"] > 2 and got["cache_hits"] > 0


def test_p8_followers_return_and_refuse_requests(results):
    _, ranks = results
    for rank in ranks[1:]:
        for server in SERVERS:
            assert bool(rank[f"{server}/follower_returned"])
            assert "follower" in str(rank[f"{server}/submit_error"])


# ---------------------------------------------------------------------------
# launch.serve --sparse from a checkpoint the JAX engine wrote
# ---------------------------------------------------------------------------


def _launch_rank(rank, store, ckpt, out_dir):
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh

    _one_thread()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        args = serve.build_parser().parse_args(
            LAUNCH + ["--device", "cpu", "--ckpt", ckpt])
        out = serve.run_sparse(args, "cpu", make_host_mesh(2))
        if rank == 0:
            (pathlib.Path(out_dir) / "launch0.json").write_text(
                json.dumps(out))
        else:
            assert out is None
    finally:
        dist.destroy_process_group()


def test_launch_serve_sparse_matches_the_reference(tmp_path, capsys):
    from repro.api import DPMREngine as JaxEngine
    from repro.configs.base import DPMRConfig as JaxConfig
    from repro.data import get_source as jax_get_source
    from repro.launch import serve as jax_serve
    from repro.launch.mesh import make_host_mesh
    from repro_torch.launch import serve

    ckpt = str(tmp_path / "ckpt")
    jeng = JaxEngine(JaxConfig(num_features=F, max_features_per_sample=16),
                     make_host_mesh(1, 1))
    jeng.fit_sgd(jax_get_source("zipf_sparse", batch_size=32, num_batches=6,
                                num_features=F, features_per_sample=16,
                                seed=1).iter_batches(), steps=6)
    jeng.save(ckpt)
    want = jax_serve.serve_sparse(jax_serve.build_parser().parse_args(
        LAUNCH + ["--ckpt", ckpt]))
    one = serve.main(LAUNCH + ["--device", "cpu", "--ckpt", ckpt])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["answers_md5"] == one["answers_md5"]
    _spawn(_launch_rank, (str(tmp_path / "store"), ckpt, str(tmp_path)), 2)
    two = json.loads((tmp_path / "launch0.json").read_text())
    assert two["ranks"] == 2 and one["ranks"] == 1
    for key in COUNTERS:
        assert one.get(key, 0) == two.get(key, 0) == want.get(key, 0), key
    assert want["requests"] == 64 and want.get("cache_hits", 0) > 0
    assert two["answers_md5"] == one["answers_md5"]


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, str(ROOT / "src"))
    _jax_reference(sys.argv[2])
