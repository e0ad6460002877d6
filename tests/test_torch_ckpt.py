"""The port's checkpoints against the JAX package's, on the CPU.

- Across packages (P = 1): the JAX engine saves at step 3 (its loader's
  cursor in the extras), the port restores and trains to step 6, and
  matches the JAX engine's uninterrupted 6 steps within atol 1e-5; and
  the reverse. For `a2a` and `topk_reduce` (whose carry rides along).
- Kill and resume: `launch.train --sparse --ckpt D --steps 3`, then
  `--steps 6`, gives the bits of one uninterrupted `--steps 6`, with
  blocking and with asynchronous saves, at 2 gloo ranks.
- Elastic: a `topk_reduce` state saved at P = 2 restores at P = 1 (here)
  and at P = 4 (gloo): the re-padded leaves equal the reference's
  `reshard_dpmr_state` of the same arrays bit for bit (one JAX
  subprocess on 4 emulated devices), and the carry resets.
- Edge cases: a truncated manifest is skipped, keep-N removes old steps,
  an unregistered saved strategy raises, a `topk_frac` mismatch warns,
  an asynchronous save holds the pre-step bits though the state is
  updated in place straight after it.

The ranks run in one `mp.spawn` of 4 processes: ranks 0 and 1 first form
a group of 2 (the P = 2 runs), then all 4 a group of 4 (`file://` stores
under the test's tmp directory).
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
F, K, B = 1 << 12, 16, 64
CORPUS = dict(num_features=F, features_per_sample=K, signal_features=256)
FIELDS = ("cold", "hot", "hot_ids", "cold_acc", "hot_acc", "step", "strat")
FLOAT_FIELDS = ("cold", "hot", "cold_acc", "hot_acc", "strat")
# the elastic run: a feature count no rank count divides, so every P pads
F_ODD = 4097
LAUNCH = ["--sparse", "--device", "cpu", "--features", "4096", "--batch",
          "64", "--sparse-batches", "8", "--data-seed", "5", "--prefetch",
          "1", "--save-every", "2"]


def _kw(strategy, features=F):
    return dict(num_features=features, max_features_per_sample=K, max_hot=16,
                learning_rate=2.0, optimizer="adagrad", distribution=strategy,
                topk_frac=0.05)


def _spec():
    return dict(batch_size=B, num_batches=4, **CORPUS)


# ---------------------------------------------------------------------------
# across packages, P = 1
# ---------------------------------------------------------------------------


def _jax_engine(strategy):
    from repro.api import DPMREngine, ShardedLoader, get_source
    from repro.api import hot_ids_from_corpus
    from repro.configs.base import DPMRConfig
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1)
    cfg = DPMRConfig(**_kw(strategy))
    src = get_source("zipf_sparse", **_spec())
    hot = hot_ids_from_corpus(cfg, [src.batch(i) for i in range(4)], mesh)
    return (DPMREngine(cfg, mesh, hot_ids=hot),
            ShardedLoader(src, mesh, host_index=0, num_hosts=1))


def _port_engine(strategy):
    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch.api import ShardedLoader, hot_ids_from_corpus

    cfg = DPMRConfig(**_kw(strategy))
    src = get_source("zipf_sparse", **_spec())
    hot = hot_ids_from_corpus(cfg, [src.batch(i) for i in range(4)],
                              device="cpu")
    return (DPMREngine(cfg, device="cpu", hot_ids=hot),
            ShardedLoader(src, device="cpu", host_index=0, num_hosts=1))


def _jax_leaves(eng):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(eng.state)]


def _port_leaves(eng):
    from repro_torch.convert import state_to_numpy

    return list(state_to_numpy(eng.state, eng.mesh))


def _close(got, want, what=""):
    for name, g, w in zip(FIELDS, got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("strategy", ["a2a", "topk_reduce"])
def test_checkpoint_read_across_packages(strategy, direction, tmp_path):
    """One package saves at step 3, the other restores (the state and
    the loader's cursor) and trains to step 6: the result matches the
    JAX engine's uninterrupted 6 steps within atol 1e-5."""
    d = str(tmp_path / "ck")
    ref, ref_loader = _jax_engine(strategy)
    ref_hist = ref.fit_sgd(ref_loader, steps=6)
    if direction == "jax_to_port":
        first, first_loader = _jax_engine(strategy)
        second, second_loader = _port_engine(strategy)
    else:
        first, first_loader = _port_engine(strategy)
        second, second_loader = _jax_engine(strategy)
    first.fit_sgd(first_loader, steps=3)
    assert first.save(d) == 3
    manifest = second.restore(d, loader=second_loader)
    assert manifest["extra"]["data"]["cursor"] == {"epoch": 0, "step": 3}
    assert manifest["extra"]["distribution"] == strategy
    assert second_loader.cursor.to_dict() == {"epoch": 0, "step": 3}
    hist = second.fit_sgd(second_loader, steps=3)
    assert [h["step"] for h in hist] == [4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in ref_hist[3:]], atol=ATOL)
    got = _port_leaves(second) if direction == "jax_to_port" \
        else _jax_leaves(second)
    _close(got, _jax_leaves(ref), f"{strategy} {direction}")
    if strategy == "topk_reduce":
        assert np.abs(got[6]).sum() > 0     # a live carry crossed over


def test_manifest_matches_the_references(tmp_path):
    """The same state saved by both packages: the same files, the same
    manifest (but for the time), the same array bytes."""
    from repro.ckpt.checkpointer import Checkpointer as JaxCheckpointer
    from repro_torch.ckpt.checkpointer import Checkpointer

    je, jl = _jax_engine("topk_reduce")
    je.fit_sgd(jl, steps=2)
    je.save(str(tmp_path / "jax"))
    te, tl = _port_engine("topk_reduce")
    te.restore(str(tmp_path / "jax"), loader=tl)
    te.save(str(tmp_path / "port"))
    ja, jm = JaxCheckpointer(str(tmp_path / "jax")).restore_host()
    ta, tm = Checkpointer(str(tmp_path / "port")).restore_host()
    jm.pop("time")
    tm.pop("time")
    assert tm == jm
    for a, b in zip(ta, ja, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert sorted(os.listdir(tmp_path / "port" / "step_0000000002")) == \
        sorted(os.listdir(tmp_path / "jax" / "step_0000000002"))
    state, manifest = Checkpointer(str(tmp_path / "jax")).restore(te.state)
    assert manifest["step"] == 2
    for t, a in zip(state, ja, strict=True):
        assert t.numpy().tobytes() == a.tobytes()


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------


def test_truncated_manifest_is_skipped_and_keep_n(tmp_path):
    from repro_torch.ckpt.checkpointer import Checkpointer, manifest_extra

    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, [np.full((3,), step, np.float32)], extra={"s": step})
    assert ck.all_steps() == [2, 3]
    (tmp_path / "step_0000000003" / "manifest.json").write_text('{"st')
    assert ck.all_steps() == [2] and ck.latest_step() == 2
    arrs, manifest = ck.restore_host()
    assert manifest["step"] == 2 and arrs[0].tolist() == [2, 2, 2]
    assert manifest_extra(str(tmp_path)) == {"s": 2}
    ck.save(4, [np.zeros((1,), np.float32)], block=False)
    ck.wait()
    assert ck.all_steps() == [2, 4]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore_host()


def test_writer_error_is_raised_by_wait(tmp_path):
    from repro_torch.ckpt.checkpointer import Checkpointer

    d = tmp_path / "ck"
    ck = Checkpointer(str(d))
    d.rmdir()
    d.write_text("a file where the directory was")
    ck.save(1, [np.zeros((1,), np.float32)], block=False)
    with pytest.raises(NotADirectoryError):
        ck.wait()
    ck.wait()                   # raised once, then cleared


def test_async_save_holds_the_pre_step_bits(tmp_path):
    """`save(block=False)` returns, the next step updates the table in
    place at once, and the file still holds the bits of the save."""
    te, tl = _port_engine("topk_reduce")
    te.fit_sgd(tl, steps=2)
    before = [x.copy() for x in _port_leaves(te)]
    te.save(str(tmp_path), block=False)
    te.fit_sgd(tl, steps=1)
    te.wait_saves()
    from repro_torch.ckpt.checkpointer import Checkpointer

    arrs, manifest = Checkpointer(str(tmp_path)).restore_host()
    assert manifest["step"] == 2
    for a, b in zip(arrs, before, strict=True):
        assert a.tobytes() == b.tobytes()
    assert not np.array_equal(_port_leaves(te)[0], before[0])


def test_restore_refuses_an_unregistered_strategy_and_warns(tmp_path):
    from repro_torch import DPMRConfig, DPMREngine
    from repro_torch.api.strategies import (
        _REGISTRY,
        TopKOuterLeg,
        register_composition,
    )

    te, tl = _port_engine("topk_reduce")
    te.fit_sgd(tl, steps=1)
    te.save(str(tmp_path / "topk"))
    other = DPMREngine(DPMRConfig(**{**_kw("topk_reduce"),
                                     "topk_frac": 0.25}), device="cpu")
    with pytest.warns(RuntimeWarning, match="topk_frac=0.05"):
        other.restore(str(tmp_path / "topk"))
    a2a = DPMREngine(DPMRConfig(**_kw("a2a")), device="cpu")
    with pytest.warns(RuntimeWarning, match="distribution='topk_reduce'"):
        a2a.restore(str(tmp_path / "topk"))
    assert a2a.state.strat.shape == (1,)       # the carry reset
    with pytest.warns(RuntimeWarning, match="no loader is attached"):
        DPMREngine(DPMRConfig(**_kw("topk_reduce")),
                   device="cpu").restore(str(tmp_path / "topk"))
    register_composition("hier_a2a", TopKOuterLeg(), name="session_only")
    try:
        eng = DPMREngine(DPMRConfig(**_kw("session_only")), device="cpu")
        eng.save(str(tmp_path / "session"))
    finally:
        del _REGISTRY["session_only"]
    with pytest.raises(ValueError, match="'session_only', which is not "
                                         "registered"):
        DPMREngine(DPMRConfig(**_kw("a2a")), device="cpu").restore(
            str(tmp_path / "session"))


# ---------------------------------------------------------------------------
# multi-rank: kill and resume at P = 2, elastic P = 2 -> 1 and 4
# ---------------------------------------------------------------------------


def _one_thread():
    torch.set_num_threads(1)


def _launch(argv):
    from repro_torch.launch import train

    return train.train_sparse(train.build_parser().parse_args(argv), "cpu")


def _elastic_engine(mesh):
    from repro_torch import DPMRConfig, DPMREngine

    return DPMREngine(DPMRConfig(**_kw("topk_reduce", F_ODD)), device="cpu",
                      mesh=mesh)


def _pair_runs(tmp):
    """P = 2: the launch runs (killed after 3 steps and resumed, or not),
    and a topk_reduce state at F_ODD saved for the elastic restores."""
    from repro_torch import get_source
    from repro_torch.convert import state_to_numpy
    from repro_torch.launch.mesh import make_host_mesh

    out = {"whole": _launch(LAUNCH + ["--steps", "6"])}
    for mode, extra in (("blocking", []), ("async", ["--async-ckpt"])):
        d = str(tmp / f"launch-{mode}")
        out[f"{mode}-3"] = _launch(LAUNCH + extra + ["--ckpt", d,
                                                     "--steps", "3"])
        out[f"{mode}-6"] = _launch(LAUNCH + extra + ["--ckpt", d,
                                                     "--steps", "6"])
    mesh = make_host_mesh(2)
    eng = _elastic_engine(mesh)
    src = get_source("zipf_sparse", batch_size=B, num_batches=4,
                     num_features=F_ODD, features_per_sample=K)
    eng.fit_sgd(src, steps=3)
    eng.save(str(tmp / "elastic"), block=False)
    eng.wait_saves()
    leaves = state_to_numpy(eng.state, mesh)
    return out, leaves


def _rank_main(rank, tmp):
    import torch.distributed as dist

    from repro_torch.convert import state_to_numpy
    from repro_torch.launch.mesh import make_host_mesh

    _one_thread()
    tmp = pathlib.Path(tmp)
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store2",
                                rank=rank, world_size=2)
        try:
            out, leaves = _pair_runs(tmp)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            (tmp / "pair.json").write_text(json.dumps(out))
            np.savez(tmp / "saved_p2.npz",
                     **dict(zip(FIELDS, leaves, strict=True)))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store4",
                            rank=rank, world_size=4)
    try:
        mesh = make_host_mesh(4)
        eng = _elastic_engine(mesh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # no loader: cursor not used
            eng.restore(str(tmp / "elastic"))
        leaves = state_to_numpy(eng.state, mesh)
        if rank == 0:
            np.savez(tmp / "restored_p4.npz",
                     **dict(zip(FIELDS, leaves, strict=True)))
    finally:
        dist.destroy_process_group()


def _jax_reshard(ckpt, out):
    """The reference's re-pad of the P = 2 checkpoint for P = 1 and P = 4
    (4 emulated devices)."""
    import jax

    from repro.ckpt.checkpointer import Checkpointer
    from repro.configs.base import DPMRConfig
    from repro.core.dpmr import DPMRState
    from repro.launch.mesh import make_host_mesh
    from repro.runtime.elastic import reshard_dpmr_state

    arrs, _ = Checkpointer(ckpt).restore_host()
    cfg = DPMRConfig(**_kw("topk_reduce", F_ODD))
    res = {}
    for p in (1, 4):
        state = reshard_dpmr_state(DPMRState(*arrs), cfg,
                                   make_host_mesh(p, 1))
        for name, leaf in zip(FIELDS, jax.tree.leaves(state), strict=True):
            res[f"p{p}/{name}"] = np.asarray(leaf)
    np.savez(out, **res)


def _spawn(fn, args, nprocs, timeout=300):
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawned runs, then the reference's re-pad of their P = 2
    checkpoint: (tmp dir, launch summaries, reference npz)."""
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    _spawn(_rank_main, (str(tmp),), 4)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, __file__, "jax", str(tmp / "elastic"),
         str(tmp / "reference.npz")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return tmp, json.loads((tmp / "pair.json").read_text()), \
        np.load(tmp / "reference.npz")


@pytest.mark.parametrize("mode", ["blocking", "async"])
def test_kill_and_resume_is_bit_identical(mode, ranks):
    """--steps 3 then --steps 6 from the checkpoint == --steps 6, at two
    ranks: the table's md5, the float64 probe loss, the losses."""
    _, out, _ = ranks
    whole, first, second = out["whole"], out[f"{mode}-3"], out[f"{mode}-6"]
    assert first["last_step"] == 3 and second["last_step"] == 6
    assert first["losses"] + second["losses"] == whole["losses"]
    assert second["cold_md5"] == whole["cold_md5"]
    assert second["final_eval_loss"] == whole["final_eval_loss"]
    assert whole["hosts"] == 2 and len(whole["losses"]) == 6


@pytest.mark.parametrize("p", [1, 4])
def test_elastic_restore_matches_the_reference_repad(p, ranks):
    """A P = 2 state (F = 4097: 4098 rows) restored at P = 1 (4097) and
    P = 4 (4100): every leaf the reference's re-pad, bit for bit; the
    carry zeros of the new geometry; the table's real rows kept."""
    from repro_torch.convert import state_to_numpy

    tmp, _, ref = ranks
    saved = np.load(tmp / "saved_p2.npz")
    assert saved["cold"].shape == (4098,) and np.abs(saved["strat"]).sum()
    if p == 1:
        eng = _elastic_engine(None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng.restore(str(tmp / "elastic"))
        got = dict(zip(FIELDS, state_to_numpy(eng.state), strict=True))
    else:
        got = np.load(tmp / "restored_p4.npz")
    for name in FIELDS:
        want = ref[f"p{p}/{name}"]
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert got[name].tobytes() == want.tobytes(), name
    assert got["cold"].shape == (F_ODD if p == 1 else 4100,)
    assert not np.abs(got["strat"]).any()
    np.testing.assert_array_equal(got["cold"][:F_ODD],
                                  saved["cold"][:F_ODD])


def test_elastic_refuses_another_hot_set_geometry(ranks):
    from repro_torch import DPMRConfig, DPMREngine

    tmp, _, _ = ranks
    eng = DPMREngine(DPMRConfig(**{**_kw("topk_reduce", F_ODD),
                                   "max_hot": 8}), device="cpu")
    with pytest.raises(ValueError, match="max_hot is 8"):
        eng.restore(str(tmp / "elastic"))


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, str(ROOT / "src"))
    _jax_reshard(sys.argv[2], sys.argv[3])
