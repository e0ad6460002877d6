"""The port's dense training CLI (`launch.train --arch`), its checkpoints
and its fault tolerance, on the CPU, against the JAX package's.

- `train_loop` for granite-8b at smoke size, killed before step 3 by a
  `FailureInjector` and finished by `run_with_restarts`, with blocking
  and with async saves, ends with the params of an uninterrupted run bit
  for bit (md5), as does a run stopped by a triggered `PreemptionGuard`
  (which saves) and run again.
- A dense checkpoint written by the reference's `train_loop` after 3
  steps is restored by the port's, which trains to step 6: its params are
  within 1e-5 of the reference's uninterrupted 6 steps. The other way
  round, the reference resumes the port's checkpoint, within 1e-5 of the
  port's 6 steps. Both packages write the same manifest paths, shapes and
  dtypes for one state.
- The copied fault-tolerance classes behave as the reference's on the
  same script (a fake clock for the watchdog).
- The CLI trains and prints its summary; under torchrun with 4 gloo
  ranks at (data 2, model 2) it trains the same 6 steps as one process
  (losses within 1e-5, its checkpoint's params within 2^-5 of each
  leaf's largest update); and without a card the trainer and the CLI
  raise unless told the CPU.
- For zamba2, xlstm and whisper at smoke size (the reference's trees
  with a shared block, a tuple of blocks, an encoder; whisper's frames
  from the loader): the reference CLI's checkpoint after 2 steps,
  resumed by the port to step 3, within 1e-5 of the reference's 3
  uninterrupted steps, and the port's checkpoint of that state read back
  by the reference leaf for leaf; `launch.serve` (whisper's frames drawn
  as the reference draws them) and `launch.train --device cpu`.
"""
import json
import os
import pathlib

import jax
import numpy as np
import pytest

from repro.ckpt import checkpointer as jckpt
from repro.launch import train as jtrain
from repro.runtime import fault_tolerance as jft
from repro_torch import convert
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train
from repro_torch.runtime import fault_tolerance as ft

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
ARGS = ["--arch", "granite-8b", "--smoke", "--batch", "4", "--seq", "16",
        "--log-every", "0", "--no-preemption-guard", "--prefetch", "1"]


def _args(parser, steps, ckpt="", extra=()):
    argv = [*ARGS, "--steps", str(steps), *extra]
    if ckpt:
        argv += ["--ckpt", str(ckpt), "--save-every", "2"]
    return parser().parse_args(argv)


def _port(steps, ckpt="", extra=(), **kw):
    return train.train_loop(
        _args(train.build_parser, steps, ckpt, [*extra, "--device", "cpu"]),
        **kw)


def _jax(steps, ckpt=""):
    return jtrain.train_loop(_args(jtrain.build_parser, steps, ckpt))


def _md5(out):
    return train.params_md5(out["state"]["params"])


def _close_params(got: dict, want: dict):
    for (gp, g), (wp, w) in zip(convert.tree_leaves(got),
                                convert.tree_leaves(want), strict=True):
        assert gp == wp
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def uninterrupted():
    out = _port(6)
    assert out["last_step"] == 6 and len(out["losses"]) == 6
    assert all(np.isfinite(out["losses"]))
    return out


@pytest.mark.parametrize("mode", ["blocking", "async"])
def test_injected_failure_resumes_bit_for_bit(mode, uninterrupted, tmp_path):
    extra = ["--async-ckpt"] if mode == "async" else []
    inj = ft.FailureInjector(fail_at_steps=[3])
    runs = []

    def loop(_):
        out = _port(6, tmp_path, extra, fail_injector=inj)
        runs.append(out)
        return out["last_step"]

    assert ft.run_with_restarts(loop, max_restarts=2) == 6
    assert inj.failed == [3]
    # the restart resumed from the step-2 checkpoint
    assert len(runs) == 1 and runs[0]["losses"] == \
        uninterrupted["losses"][2:]
    assert _md5(runs[0]) == _md5(uninterrupted)


class _PreemptAt:
    """Triggers `guard` before step `at`, as SIGTERM's handler would."""

    def __init__(self, guard, at):
        self.guard, self.at = guard, at

    def maybe_fail(self, step):
        if step == self.at:
            self.guard.trigger()


def test_preemption_saves_and_stops(uninterrupted, tmp_path):
    guard = ft.PreemptionGuard(signals=())
    out = _port(6, tmp_path, fail_injector=_PreemptAt(guard, 2),
                guard=guard)
    assert out["last_step"] == 3 and len(out["losses"]) == 3
    from repro_torch.ckpt.checkpointer import Checkpointer

    assert Checkpointer(str(tmp_path)).latest_step() == 3
    rest = _port(6, tmp_path)
    assert rest["losses"] == uninterrupted["losses"][3:]
    assert _md5(rest) == _md5(uninterrupted)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        m = json.load(f)
    return m["paths"], m["shapes"], m["dtypes"], m["extra"]


@pytest.fixture(scope="module")
def cross(tmp_path_factory, uninterrupted):
    """Each package resumes the other's step-3 checkpoint to step 6."""
    d = tmp_path_factory.mktemp("cross")
    jax_ck, port_ck = d / "jax", d / "port"
    jax_whole = _jax(6)
    _jax(3, jax_ck)
    port_from_jax = _port(6, jax_ck)
    _port(3, port_ck)
    jax_from_port = _jax(6, port_ck)
    return {"jax_whole": jax_whole, "port_from_jax": port_from_jax,
            "jax_from_port": jax_from_port, "jax_ck": str(jax_ck),
            "port_ck": str(port_ck)}


def test_port_resumes_a_jax_checkpoint(cross):
    got = cross["port_from_jax"]
    assert got["last_step"] == 6 and len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"],
                               cross["jax_whole"]["losses"][3:], rtol=TOL,
                               atol=TOL)
    _close_params(convert.params_to_numpy(got["state"]["params"]),
                  jax.tree.map(np.asarray,
                               cross["jax_whole"]["state"]["params"]))


def test_jax_resumes_a_port_checkpoint(cross, uninterrupted):
    got = cross["jax_from_port"]
    assert got["last_step"] == 6 and len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], uninterrupted["losses"][3:],
                               rtol=TOL, atol=TOL)
    _close_params(jax.tree.map(np.asarray, got["state"]["params"]),
                  convert.params_to_numpy(uninterrupted["state"]["params"]))


def test_both_packages_write_the_same_manifest(cross):
    jp, js, jd, jextra = _manifest(cross["jax_ck"], 3)
    pp, ps, pd, pextra = _manifest(cross["port_ck"], 3)
    assert (pp, ps, pd) == (jp, js, jd)
    assert pextra == jextra and pextra["data_step"] == 3
    assert pp[0] == "(DictKey(key='opt'), DictKey(key='count'))"
    assert pp[-1] == "(DictKey(key='step'),)"


class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("module", [jft, ft], ids=["reference", "port"])
def test_fault_tolerance_classes(module, monkeypatch):
    """One script through the reference's classes and the port's copies;
    both must give what the reference's own tests expect."""
    guard = module.PreemptionGuard(signals=())
    assert not guard.preempted()
    guard.trigger()
    assert guard.preempted()

    # steps of 1 s, then one of 5 s: flagged against factor 3
    ticks = []
    for i in range(6):
        ticks += [10.0 * i, 10.0 * i + 1.0]
    ticks += [100.0, 105.0]
    monkeypatch.setattr(module.time, "monotonic", _Clock(ticks))
    wd = module.StragglerWatchdog(window=10, factor=3.0)
    for i in range(7):
        wd.step_start()
        wd.step_end(i)
    assert wd.events == [{"step": 6, "seconds": 5.0, "median": 1.0}]

    inj = module.FailureInjector(fail_at_steps=[2, 4])
    inj.maybe_fail(1)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)               # each step fails once
    assert inj.failed == [2]

    calls = []

    def flaky(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise RuntimeError("boom")
        return 7

    assert module.run_with_restarts(flaky, max_restarts=2) == 7
    assert calls == [None, None, None]

    def always(_):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        module.run_with_restarts(always, max_restarts=1)


def test_cli_trains_and_prints_its_summary(uninterrupted, capsys):
    out = train.main([*ARGS, "--steps", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"final loss {uninterrupted['losses'][-1]:.4f} " \
        "after 6 steps"
    assert json.loads(lines[-1]) == out
    assert out["losses"] == uninterrupted["losses"]
    assert out["params_md5"] == _md5(uninterrupted)


def test_cli_refuses_more_than_one_rank(uninterrupted, tmp_path):
    """More than one rank is no longer refused: `launch.train --arch`
    under `torchrun --standalone --nproc-per-node 4` (gloo ranks of one
    thread, (data 2, model 2)) trains the same 6 steps as one process:
    rank 0 alone prints the final line and the JSON line, the losses
    within 1e-5 of the one process's, and every param leaf of its last
    checkpoint (the whole leaves) within 2^-5 of that leaf's largest
    update in the one process's run (ROADMAP C20)."""
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ckpt = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *ARGS,
         "--steps", "6", "--device", "cpu", "--mesh-data", "2",
         "--mesh-model", "2", "--ckpt", str(ckpt), "--save-every", "6"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail("torchrun still ran after 300 s")
    assert proc.returncode == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith(("{", "final"))]
    assert len(lines) == 2, out
    got = json.loads(lines[1])
    assert lines[0] == f"final loss {got['losses'][-1]:.4f} after 6 steps"
    assert got["last_step"] == 6
    np.testing.assert_allclose(got["losses"], uninterrupted["losses"],
                               rtol=0, atol=TOL)
    before = convert.params_to_numpy(_port(0)["state"]["params"])
    want = convert.params_to_numpy(uninterrupted["state"]["params"])
    like = _port(0)["state"]
    state, _ = Checkpointer(str(ckpt)).restore(like)
    assert int(state["step"]) == 6
    mesh = convert.params_to_numpy(state["params"])
    for (path, m), (_, w), (_, b) in zip(
            convert.tree_leaves(mesh), convert.tree_leaves(want),
            convert.tree_leaves(before), strict=True):
        update = float(np.max(np.abs(w - b)))
        np.testing.assert_allclose(m, w, rtol=0, atol=2.0 ** -5 * update,
                                   err_msg=str(path))


def test_dense_trainer_needs_a_card_unless_told_cpu():
    """Without a card the trainer and the CLI raise unless the caller
    passes the CPU; nothing goes on on the CPU by itself."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.train import trainer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer runs on it")
    spec = registry.get_spec("granite-8b")
    cfg = registry.smoke_config("granite-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.init_state(spec, cfg, TrainConfig(), ParallelConfig(),
                           torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(_args(train.build_parser, 2))


FAMILIES = ["zamba2-2.7b", "xlstm-125m", "whisper-small"]


def _family_argv(arch, steps, ckpt=""):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16",
            "--log-every", "0", "--no-preemption-guard", "--prefetch", "1",
            "--steps", str(steps)]
    if ckpt:
        argv += ["--ckpt", str(ckpt), "--save-every", "2"]
    return argv


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_checkpoints_cross_packages(arch, tmp_path):
    whole = jtrain.train_loop(jtrain.build_parser().parse_args(
        _family_argv(arch, 3)))
    jtrain.train_loop(jtrain.build_parser().parse_args(
        _family_argv(arch, 2, tmp_path / "jax")))
    got = train.train_loop(train.build_parser().parse_args(
        [*_family_argv(arch, 3, tmp_path / "jax"), "--device", "cpu"]))
    assert got["last_step"] == 3 and len(got["losses"]) == 1
    np.testing.assert_allclose(got["losses"], whole["losses"][2:],
                               rtol=TOL, atol=TOL)
    _close_params(convert.params_to_numpy(got["state"]["params"]),
                  jax.tree.map(np.asarray, whole["state"]["params"]))
    Checkpointer(str(tmp_path / "port")).save(3, got["state"])
    template = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)),
                            whole["state"])
    restored, _ = jckpt.Checkpointer(str(tmp_path / "port")).restore(
        template, 3)
    for (gp, g), (wp, w) in zip(
            convert.tree_leaves(convert.train_state_to_numpy(got["state"])),
            convert.tree_leaves(jax.tree.map(np.asarray, restored)),
            strict=True):
        assert gp == wp
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_family_on_the_cpu(arch, capsys):
    import torch

    toks = launch_serve.main(["--arch", arch, "--device", "cpu", "--batch",
                              "2", "--prompt-len", "12", "--decode-steps",
                              "4"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert "decoded (2, 4) on cpu" in capsys.readouterr().out
    out = train.main([*_family_argv(arch, 2), "--device", "cpu"])
    assert out["last_step"] == 2 and all(np.isfinite(out["losses"]))
