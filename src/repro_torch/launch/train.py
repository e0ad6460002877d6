"""Training entry point of the port: the counterpart of
`repro.launch.train`, for the dense face (`--arch`, one process on one
card) and the sparse face (`--sparse`, one process a rank).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        --smoke --steps 6 --device cpu --ckpt /tmp/dck     # dense, the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --smoke --steps 50 --ckpt /tmp/dck                 # dense, the card
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
        -m repro_torch.launch.train --sparse --device cpu     # 8 gloo ranks
    PYTHONPATH=src torchrun --standalone --nproc-per-node 1 \
        -m repro_torch.launch.train --sparse --ckpt /tmp/sck  # the card
    # kill either mid-run and rerun the same command: it resumes from --ckpt

Dense mode (`train_loop`) wires the model zoo (`--arch`, any family;
`--smoke` for the reduced same-family config), the one-card trainer
(`train.trainer.make_train_step`: `--optimizer`, `--lr`, `--warmup`,
`--microbatches`), an `lm_markov` stream (`--batch` x `--seq` tokens,
`--data-seed`; an encoder-decoder also gets `--seq` stub frames a row)
behind a prefetching `ShardedLoader` pinned to host 0 of
1, checkpoints (`--ckpt`, `--save-every`, `--keep`, `--async-ckpt`) that
carry the model, the optimizer and the loader's cursor, a
`PreemptionGuard` (SIGTERM: save and stop; `--no-preemption-guard`) and
a `StragglerWatchdog`. A rerun resumes from the newest checkpoint at the
exact data position; under `runtime.fault_tolerance.run_with_restarts`
a failed run restarts from it. It prints the reference's final line and
one JSON line (losses, last step, straggler events, the md5 of the final
params). Under torchrun (`--mesh-data`, `--mesh-model`, `--pods`; NCCL
on the cards, gloo with `--device cpu`) it trains over a mesh of the
ranks (`train.trainer.make_train_step(..., mesh)`: FSDP over `data`,
every family's tensor, expert or SSM-head parallelism over `model`):
every rank reads the same global batch,
as the reference's loader gives every process, and trains its rows;
checkpoints hold the whole leaves (any mesh restores them), and rank 0
prints the same lines, the md5 over the gathered params:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --smoke \
        --mesh-data 2 --mesh-model 2 --device cpu

Sparse mode's data plane is the reference's (`--data-dir`, `--hosts`,
`--host-id`, `--shuffle`, `--prefetch`, `--sparse-batches`): a
`zipf_sparse` stream (`--data-seed`), or with `--data-dir` a
`file_sparse` corpus under chunk-aligned ownership, behind a
`ShardedLoader`.
  * Under torchrun with W ranks, rank r IS data-plane host r of W, as
    process h is host h in the reference's real multi-process run: its
    loader reads only host r's batches of `--batch` rows, and the engine
    takes them as rank r's rows of a global batch of W x `--batch` rows,
    in host order (`runtime.multiprocess.global_batch_placement`).
  * `--hosts H --host-id -1` is the all-hosts emulation: every rank reads
    the concatenated H x `--batch`-row global batch
    (`emulate_all_hosts`) and cuts its own rows; at H = W it trains on
    the same rows under the same mesh as the run above, bit for bit.
  * In one process, `--hosts H --host-id h` emulates host h alone.
Training runs `DPMREngine.fit_sgd` on a `pods x data x model` mesh and,
with `--ckpt`, saves every `--save-every` steps (`--async-ckpt` keeps only
the snapshot on the step path) and resumes from the newest checkpoint,
reassigning shard ownership if the host count changed. Rank 0 prints one
JSON line: the strategy, the losses, the two-tier wire bytes a rank
receives a step, a float64 loss over a fixed raw batch, and the md5 of
the final global table. It runs on the card (NCCL) unless `--device cpu`
(gloo).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import (
    DPMREngine,
    ShardedLoader,
    get_source,
    get_strategy,
)
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs.base import DPMRConfig, ParallelConfig, TrainConfig
from repro_torch.convert import params_to_numpy, state_to_numpy, tree_leaves
from repro_torch.data import Cursor
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.models import registry
from repro_torch.runtime import multiprocess as mp
from repro_torch.runtime.fault_tolerance import (
    PreemptionGuard,
    StragglerWatchdog,
)
from repro_torch.train import trainer

log = logging.getLogger("repro_torch.train")

DENSE_BATCH, SPARSE_BATCH = 8, 256    # --batch's default in each mode


def make_loader(args, cfg, device) -> ShardedLoader:
    """The dense trainer's data plane: an `lm_markov` source (with stub
    encoder frames for an encoder-decoder) behind a prefetching loader
    that puts whole batches on `device`, pinned to one stream (host 0 of
    1), as the reference's."""
    source = get_source("lm_markov", vocab_size=cfg.vocab_size,
                        seq_len=args.seq,
                        batch_size=args.batch or DENSE_BATCH,
                        seed=args.data_seed,
                        encdec_d_model=cfg.d_model
                        if cfg.family == "encdec" else 0)
    return ShardedLoader(source, device=device, placement="device",
                         host_index=0, num_hosts=1, prefetch=args.prefetch)


def params_md5(model) -> str:
    """md5 of the params as the reference's tree of f32 arrays, leaves in
    its order (over a mesh, of the whole leaves: every rank calls it)."""
    h = hashlib.md5()
    for _, leaf in tree_leaves(params_to_numpy(model,
                                               trainer.full_params(model))):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _mesh_dims(args, world: int) -> tuple[int, int, int]:
    """(pods, data, model) of `world` ranks: `--mesh-data` 0 takes the
    ranks that `--mesh-model` and `--pods` leave."""
    data = args.mesh_data or world // (args.mesh_model * args.pods)
    return args.pods, data, args.mesh_model


def dense_mesh(args):
    """The (pods, data, model) mesh of torchrun's ranks."""
    pods, data, model = _mesh_dims(args, dist.get_world_size())
    return make_host_mesh(data, model, pods)


def dense_mesh_refusal(args, world: int) -> str | None:
    """Why `world` ranks cannot train `args.arch` over the mesh the flags
    ask for (refused before any group starts), or None."""
    pods, data, model = _mesh_dims(args, world)
    if pods * data * model != world:
        return (f"a (pods {pods}, data {data}, model {model}) mesh needs "
                f"{pods * data * model} ranks; torchrun started {world}")
    return None


def train_loop(args, fail_injector=None, guard=None, mesh=None,
               device=None) -> dict:
    """The dense training loop: train `args.arch` up to `args.steps` steps,
    resuming from `args.ckpt`'s newest checkpoint, on one device or over
    `mesh` (this rank's blocks on `device`). `fail_injector` (a
    `FailureInjector`) may raise before a step; `guard` replaces the
    `PreemptionGuard` the loop would install (tests trigger it)."""
    device = resolve_device(args.device if device is None else device)
    spec = registry.get_spec(args.arch)
    cfg = registry.smoke_config(args.arch) if args.smoke else spec.cfg
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                     total_steps=args.steps, optimizer=args.optimizer)
    pc = ParallelConfig(microbatches=args.microbatches)
    loader = make_loader(args, cfg, device)
    ck = Checkpointer(args.ckpt, keep=args.keep) if args.ckpt else None
    if guard is None and args.preemption_guard:
        guard = PreemptionGuard()
    watchdog = StragglerWatchdog()

    state = trainer.init_state(
        spec, cfg, tc, pc, torch.Generator(device=device).manual_seed(tc.seed),
        device, mesh=mesh)
    start_step = 0
    if ck is not None and ck.latest_step() is not None:
        state, manifest = ck.restore(state)
        extra = manifest["extra"]
        if "data" in extra:                      # cursor-carrying ckpt
            loader.load_state_dict(extra["data"])
            start_step = loader.cursor.step
        else:                                    # pre-data-plane ckpt
            start_step = extra["data_step"]
            loader.seek(Cursor(0, start_step))
        log.info("resumed from step %d", start_step)
    step_fn = trainer.make_train_step(spec, cfg, tc, pc, mesh)

    def save(step, block):
        ck.save(step, state,
                extra={"data_step": step, "data": loader.state_dict()},
                block=block)

    losses = []
    i = start_step
    try:
        for batch in loader.batches(args.steps - start_step):
            watchdog.step_start()
            if fail_injector is not None:
                fail_injector.maybe_fail(i)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            watchdog.step_end(i)
            i += 1
            if args.log_every and i % args.log_every == 0:
                log.info("step %d loss %.4f lr %.2e", i, loss,
                         float(metrics["lr"]))
            if ck is not None and (i % args.save_every == 0
                                   or i == args.steps):
                save(i, block=not args.async_ckpt)
            if guard is not None and guard.preempted():
                if ck is not None:
                    save(i, block=True)
                log.warning("preempted; saved at step %d", i)
                break
    finally:
        # a failed step still lets the save in flight land, so a restart
        # finds it
        if ck is not None:
            ck.wait()
    return {"state": state, "losses": losses, "last_step": i,
            "straggler_events": watchdog.events}


def dense_ranks(args) -> dict:
    """Join torchrun's process group, train over the ranks' mesh, and
    leave the group; the summary is rank 0's (every rank computes it)."""
    device = init_from_env(args.device)
    try:
        out = train_loop(args, mesh=dense_mesh(args), device=device)
        return dense_summary(args, out)
    finally:
        dist.destroy_process_group()


def dense_summary(args, out) -> dict:
    return {"arch": args.arch, "losses": out["losses"],
            "last_step": out["last_step"],
            "straggler_events": out["straggler_events"],
            "params_md5": params_md5(out["state"]["params"])}


def sparse_loop(args) -> dict:
    """Join torchrun's process group, train, and leave the group."""
    get_strategy(args.strategy)          # fail fast on unknown names
    device = init_from_env(args.device)
    try:
        return train_sparse(args, device)
    finally:
        dist.destroy_process_group()


def make_sparse_loader(args, mesh,
                       device) -> tuple[ShardedLoader, object, int]:
    """This rank's loader, the raw source the final eval reads, and the
    global batch size a step trains on."""
    world, rank = dist.get_world_size(), dist.get_rank()
    hosts, host_id = args.hosts, args.host_id
    if args.data_dir:
        source = get_source("file_sparse", directory=args.data_dir)
    else:
        source = get_source("zipf_sparse",
                            batch_size=args.batch or SPARSE_BATCH,
                            num_batches=args.sparse_batches,
                            num_features=args.features,
                            features_per_sample=32, seed=args.data_seed)
    eval_source = source
    placement = "sharded"
    if host_id == -1:
        # the parity baseline: every host's stream, concatenated
        source = mp.emulate_all_hosts(source, hosts)
        hosts, host_id = 1, 0
    elif world > 1:
        if hosts not in (1, world):
            raise SystemExit(
                f"under torchrun rank r is host r of the {world} ranks: "
                f"drop --hosts {hosts}/--host-id (or pass --host-id -1 "
                "for the all-hosts emulation)")
        hosts, host_id = world, rank
        placement = mp.global_batch_placement(device, world)
    loader = ShardedLoader(source, mesh, device=device, placement=placement,
                           host_index=host_id, num_hosts=hosts,
                           prefetch=args.prefetch, shuffle=args.shuffle)
    rows = int(source.batch_size)
    if placement == "sharded":      # a global batch, conformed to the mesh
        return loader, eval_source, rows - rows % loader.batch_divisor
    return loader, eval_source, rows * world    # this rank's rows of it


def train_sparse(args, device) -> dict:
    """Train up to `args.steps` steps on this rank of the default process
    group; returns the run's summary (the same on every rank but for
    `rank`)."""
    world = dist.get_world_size()
    data = args.mesh_data or world // (args.mesh_model * args.pods)
    mesh = make_host_mesh(data, args.mesh_model, args.pods)
    cfg = DPMRConfig(num_features=args.features,
                     max_features_per_sample=32,
                     distribution=args.strategy, optimizer="adagrad",
                     learning_rate=args.lr)
    loader, eval_source, global_rows = make_sparse_loader(args, mesh, device)
    engine = DPMREngine(cfg, device=device, mesh=mesh)
    if args.ckpt and Checkpointer(args.ckpt).latest_step() is not None:
        # reassign rather than refuse when the host count changed between
        # runs: the loop resumes at the epoch boundary under the new
        # ownership
        engine.restore(args.ckpt, loader=loader, on_host_change="reassign")
    # checkpoint every --save-every steps, so a killed run resumes
    # mid-stream; the final save is always blocking (it flushes any
    # write in flight)
    history = []
    while engine.host_step() < args.steps:
        chunk = min(args.save_every, args.steps - engine.host_step())
        history += engine.fit_sgd(loader, steps=chunk)
        if args.ckpt:
            engine.save(args.ckpt, keep=args.keep,
                        block=not args.async_ckpt)
    if args.ckpt and args.async_ckpt:
        engine.save(args.ckpt, keep=args.keep)
    wire = get_strategy(args.strategy).bytes_per_device(
        engine.step_fns(global_rows).ctx)
    # a deterministic parity probe: the loss recomputed on the host in
    # float64 over a fixed raw batch, equal exactly when the tables are
    batch = eval_source.batch(0)
    probs = engine.predict({"ids": batch["ids"], "vals": batch["vals"]}
                           ).astype(np.float64)
    y = np.asarray(batch["labels"], np.float64)
    eps = 1e-9
    final_eval = float(-np.mean(y * np.log(probs + eps)
                                + (1 - y) * np.log(1 - probs + eps)))
    cold = state_to_numpy(engine.state, mesh)[0]
    return {"strategy": args.strategy,
            "losses": [h["loss"] for h in history],
            "last_step": engine.host_step(),
            "final_eval_loss": final_eval,
            "wire_bytes": {"inner": wire.inner, "outer": wire.outer},
            "cold_md5": hashlib.md5(cold.tobytes()).hexdigest(),
            "num_processes": world, "rank": dist.get_rank(),
            "hosts": loader.num_hosts,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="model zoo id of any family (dense, "
                                   "vlm, moe, hybrid, ssm, encdec; the "
                                   "dense face; required unless "
                                   "--sparse)")
    ap.add_argument("--sparse", action="store_true",
                    help="train the DPMR sparse face (DPMREngine over a "
                         "zipf_sparse loader) instead of a zoo model")
    ap.add_argument("--strategy", default="a2a",
                    help="sparse-face distribution strategy (any name in "
                         "repro_torch.api.list_strategies())")
    ap.add_argument("--features", type=int, default=1 << 14,
                    help="sparse-face hashed feature-space size")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"rows a step: dense, the batch (default "
                         f"{DENSE_BATCH}); sparse, the rows a data-plane "
                         f"host reads (default {SPARSE_BATCH}; under "
                         "torchrun the global batch is ranks x --batch)")
    ap.add_argument("--steps", type=int, default=20,
                    help="train until the state's step reaches this")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--smoke", action="store_true",
                    help="dense: the reduced same-family config")
    ap.add_argument("--seq", type=int, default=64,
                    help="dense: tokens a sequence")
    ap.add_argument("--warmup", type=int, default=10,
                    help="dense: warmup steps of the cosine schedule "
                         "(0 = a constant learning rate)")
    ap.add_argument("--optimizer", default="adamw",
                    help="dense: sgd | momentum | adam | adamw")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="dense: gradient-accumulation chunks a step")
    ap.add_argument("--log-every", type=int, default=10,
                    help="dense: log the loss every N steps (0 = never)")
    ap.add_argument("--preemption-guard",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="dense: on SIGTERM, save and stop")
    ap.add_argument("--sparse-batches", type=int, default=64,
                    help="zipf_sparse corpus size in batches (one epoch)")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--data-dir", default="",
                    help="read a file_sparse corpus (written by "
                         "write_file_corpus) from this directory under "
                         "chunk-aligned shard ownership")
    ap.add_argument("--hosts", type=int, default=1,
                    help="data-plane hosts (under torchrun: the ranks)")
    ap.add_argument("--host-id", type=int, default=0,
                    help="which host of --hosts this one-process run "
                         "emulates; -1 emulates ALL hosts (the "
                         "concatenated global batch: the parity baseline)")
    ap.add_argument("--shuffle", action="store_true",
                    help="per-epoch loader shuffling (seeded, resume-exact)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="loader prefetch depth (0 = synchronous input)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (shared by the ranks); "
                         "resumes from its newest step")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data dim of the mesh (0 = the ranks that "
                         "--mesh-model and --pods leave)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1,
                    help="pods (the mesh's leading, slow tier)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the card, NCCL; "
                         "'cpu' for the host, gloo)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.save_every < 1:
        ap.error("--save-every must be >= 1")
    if not args.sparse:
        if not args.arch:
            ap.error("--arch is required (or pass --sparse): a model zoo "
                     "id of the dense, vlm, moe, hybrid, ssm or encdec "
                     "family")
        if "RANK" in os.environ:              # under torchrun: a mesh
            refusal = dense_mesh_refusal(args,
                                         int(os.environ["WORLD_SIZE"]))
            if refusal:
                ap.error(refusal)
        elif args.mesh_data > 1 or args.mesh_model > 1 or args.pods > 1:
            ap.error("--mesh-data, --mesh-model and --pods lay out the "
                     "ranks of a torchrun: start the program with "
                     "torchrun")
        logging.basicConfig(level=logging.INFO)
        if "RANK" in os.environ:
            summary = dense_ranks(args)
            rank = int(os.environ["RANK"])
        else:
            summary, rank = dense_summary(args, train_loop(args)), 0
        if rank == 0:
            if summary["losses"]:
                print(f"final loss {summary['losses'][-1]:.4f} after "
                      f"{summary['last_step']} steps")
            print(json.dumps(summary), flush=True)
        return summary
    if args.hosts < 1 or not -1 <= args.host_id < args.hosts:
        ap.error(f"--host-id {args.host_id} is not a host of --hosts "
                 f"{args.hosts} (or -1 for all of them)")
    out = sparse_loop(args)
    if out["rank"] == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
