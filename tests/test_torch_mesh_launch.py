"""`launch.train --arch phi3.5-moe-42b-a6.6b --smoke --mesh-data 2
--mesh-model 2 --device cpu` under torchrun (4 gloo ranks of one thread)
against the same run through one `mp.spawn` of 4 ranks that call
`train_loop` over `make_host_mesh(2, 2)`, on the CPU; the two run one
after the other, so no more than 4 ranks live at once.

- The MoE family over `model` is no longer refused: torchrun trains 3
  steps with the experts split over `model` and the MoE groups (of the
  whole microbatch) spanning the 4 ranks, and gives the losses and the
  params md5 (over the whole leaves) of the spawned run, bit for bit.
- Its checkpoint holds the whole leaves: restored at (model 4) (the
  experts 1 a rank) in the spawn and at no mesh here, the params md5 is
  the run's.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

import torch_mesh_harness as h

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi3.5-moe-42b-a6.6b"
STEPS = 3
ARGV = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "16",
        "--steps", str(STEPS), "--log-every", "0", "--no-preemption-guard",
        "--prefetch", "1", "--mesh-data", "2", "--mesh-model", "2",
        "--device", "cpu"]


def _torchrun(ckpt, cwd) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(h.RANKS), "-m", "repro_torch.launch.train",
         *ARGV, "--ckpt", str(ckpt), "--save-every", str(STEPS)],
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


def _ranks(rank, store, ckpt, out):
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.checkpointer import Checkpointer
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import trainer

    h.join_ranks(rank, h.RANKS, store)
    args = train.build_parser().parse_args(ARGV)
    run = train.train_loop(args, mesh=make_host_mesh(2, 2), device="cpu")
    summary = train.dense_summary(args, run)
    spec = registry.get_spec(ARCH)
    cfg = registry.smoke_config(ARCH)
    like = trainer.init_state(spec, cfg, TrainConfig(), ParallelConfig(),
                              torch.Generator().manual_seed(1), "cpu",
                              mesh=make_host_mesh(1, 4))
    state, _ = Checkpointer(ckpt).restore(like)
    summary["restored_model4_md5"] = train.params_md5(state["params"])
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(summary))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_launch")
    own = _torchrun(tmp / "ck", tmp)
    deadline = time.monotonic() + h.TIMEOUT
    h.wait_ranks(h.start_ranks(_ranks, (str(tmp / "store"),
                                        str(tmp / "ck"),
                                        str(tmp / "spawned.json"))),
                 deadline)
    return tmp, own, json.loads((tmp / "spawned.json").read_text())


def test_launch_moe_over_model_under_torchrun(launched):
    """torchrun's losses and params md5 are the spawned run's bit for
    bit; the losses are finite and move."""
    _, own, spawned = launched
    assert own["arch"] == ARCH and own["last_step"] == STEPS
    assert len(own["losses"]) == STEPS
    assert own["losses"] == spawned["losses"]
    assert own["params_md5"] == spawned["params_md5"]
    assert len(set(own["losses"])) == STEPS


def test_moe_checkpoint_restores_at_any_mesh(launched):
    """The (data 2, model 2) checkpoint restored at (model 4) and at no
    mesh: the whole params' md5 is the run's."""
    import torch

    from repro_torch.ckpt.checkpointer import Checkpointer
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.train import trainer

    tmp, own, spawned = launched
    assert spawned["restored_model4_md5"] == own["params_md5"]
    like = trainer.init_state(registry.get_spec(ARCH),
                              registry.smoke_config(ARCH), TrainConfig(),
                              ParallelConfig(),
                              torch.Generator().manual_seed(1), "cpu")
    state, _ = Checkpointer(str(tmp / "ck")).restore(like)
    assert int(state["step"]) == STEPS
    assert train.params_md5(state["params"]) == own["params_md5"]
