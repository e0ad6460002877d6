"""Training entry point of the port's sparse face: the counterpart of
`repro.launch.train --sparse` (`sparse_loop`), one process a rank.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.train --sparse --device cpu     # 8 gloo ranks
    PYTHONPATH=src torchrun --standalone --nproc-per-node 1 \\
        -m repro_torch.launch.train --sparse                  # the card

Every rank reads the same `zipf_sparse` stream (`--data-seed`) of GLOBAL
batches of `--batch` samples and trains its rows with `DPMREngine.fit_sgd`
on a `pods x data x model` mesh; rank 0 prints one JSON line: the
strategy, the losses, the two-tier wire bytes a rank receives per step,
and the md5 of the final global table. It runs on the card (NCCL) unless
`--device cpu` (gloo). The reference's checkpointing (`--ckpt`), file
corpora (`--data-dir`) and emulated hosts (`--hosts`) are ROADMAP A7; its
dense mode is ROADMAP A12.
"""
from __future__ import annotations

import argparse
import hashlib
import json

import torch.distributed as dist

from repro_torch.api import DPMREngine, get_source, get_strategy
from repro_torch.configs.base import DPMRConfig
from repro_torch.convert import state_to_numpy
from repro_torch.launch.mesh import init_from_env, make_host_mesh


def sparse_loop(args) -> dict:
    """Join torchrun's process group, train, and leave the group."""
    get_strategy(args.strategy)          # fail fast on unknown names
    device = init_from_env(args.device)
    try:
        return train_sparse(args, device)
    finally:
        dist.destroy_process_group()


def train_sparse(args, device) -> dict:
    """Train `args.steps` global batches on this rank of the default
    process group; returns the run's summary (the same on every rank but
    for `rank`)."""
    world = dist.get_world_size()
    data = args.mesh_data or world // (args.mesh_model * args.pods)
    mesh = make_host_mesh(data, args.mesh_model, args.pods)
    # the reference launcher's defaults: --lr 1e-2, --sparse-batches 64
    cfg = DPMRConfig(num_features=args.features,
                     max_features_per_sample=32,
                     distribution=args.strategy, optimizer="adagrad",
                     learning_rate=1e-2)
    source = get_source("zipf_sparse", batch_size=args.batch,
                        num_batches=64, num_features=args.features,
                        features_per_sample=32, seed=args.data_seed)
    engine = DPMREngine(cfg, device=device, mesh=mesh)
    history = engine.fit_sgd(source, steps=args.steps)
    wire = get_strategy(args.strategy).bytes_per_device(engine.fns.ctx)
    cold = state_to_numpy(engine.state, mesh)[0]
    return {"strategy": args.strategy,
            "losses": [h["loss"] for h in history],
            "last_step": int(engine.state.step),
            "wire_bytes": {"inner": wire.inner, "outer": wire.outer},
            "cold_md5": hashlib.md5(cold.tobytes()).hexdigest(),
            "num_processes": world, "rank": dist.get_rank(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sparse", action="store_true",
                    help="train the DPMR sparse face (the only mode ported)")
    ap.add_argument("--strategy", default="a2a",
                    help="distribution strategy (any name in "
                         "repro_torch.api.list_strategies())")
    ap.add_argument("--features", type=int, default=1 << 14,
                    help="hashed feature-space size")
    ap.add_argument("--batch", type=int, default=256,
                    help="GLOBAL batch (a multiple of the rank count)")
    ap.add_argument("--steps", type=int, default=20,
                    help="fit_sgd steps (at most the corpus's 64 batches)")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data dim of the mesh (0 = the ranks that "
                         "--mesh-model and --pods leave)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1,
                    help="pods (the mesh's leading, slow tier)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the card, NCCL; "
                         "'cpu' for gloo)")
    ap.add_argument("--ckpt", default="", help="not ported: ROADMAP A7")
    ap.add_argument("--data-dir", default="", help="not ported: ROADMAP A7")
    ap.add_argument("--hosts", type=int, default=1,
                    help="not ported: ROADMAP A7")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.sparse:
        ap.error("the dense trainer is not ported yet: ROADMAP A12 (pass "
                 "--sparse)")
    for flag, given in (("--ckpt", args.ckpt), ("--data-dir", args.data_dir),
                        ("--hosts", args.hosts != 1)):
        if given:
            ap.error(f"{flag} (checkpointing and the sharded data plane) is "
                     "not ported yet: ROADMAP A7")
    out = sparse_loop(args)
    if out["rank"] == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
