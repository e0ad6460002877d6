"""Serving drivers of the port: dense LM decode, and the DPMR sparse
serving engine (the two modes of `repro.launch.serve`).

  dense (default)   prefill + greedy decode of a dense model (`--arch`),
                    with weights made from a seed.
  --sparse          a `repro_torch.serve.DPMRServeEngine` keeps the
                    parameter state resident (restored from a sparse
                    checkpoint of either package with `--ckpt`, or
                    warm-trained in place with `--warm-steps`), and
                    `--clients` threads stream `file_sparse` /
                    `zipf_sparse`-shaped requests through the deadline-
                    coalesced micro-batcher + hot-feature cache. Prints
                    p50/p99 latency, sustained QPS, the cache/batching
                    counters, and one JSON line: the metrics snapshot and
                    the md5 of the answers in request order.

The modes fail loudly when mixed: `--arch` is rejected under `--sparse`,
and `--sparse` refuses a checkpoint whose manifest is not
`kind=dpmr_sparse`.

Dense mode under torchrun serves over a mesh of its ranks, the
reference's `--mesh-data` x `--mesh-model` (`train.serve.greedy_decode(
..., mesh)`: parameters and caches laid out by the reference's rules, the
batch rows over `data`); a mesh that is not torchrun's ranks is refused.
Rank 0 prints the same lines as one process and one JSON line: the
tokens' md5, prefill ms and decode ms a step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --device cpu                       # smoke size, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --no-smoke --batch 8 --prompt-len 4096 --decode-steps 32  # the card
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b \\
        --mesh-data 2 --mesh-model 2 --device cpu    # 4 gloo ranks
    PYTHONPATH=src python -m repro_torch.launch.serve --sparse \\
        --ckpt /tmp/sck                    # the card, one process
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve --sparse --ckpt /tmp/sck  # 4 cards

Under torchrun, rank 0 is the front (the batcher, the cache, the client
threads) and every other rank a follower of its broadcasts
(`DPMRServeEngine.serve_follower`). Everything runs on the card unless
`--device cpu` is given (gloo under torchrun), and raises without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models import common, registry
from repro_torch.train import serve


def serve_dense(args) -> torch.Tensor | None:
    """Join torchrun's process group when there is one and serve over the
    (data, model) mesh of its ranks, or serve in one process; rank 0
    prints the summary. Returns rank 0's (B, steps) tokens (None
    elsewhere)."""
    from repro_torch.launch.mesh import init_from_env, make_host_mesh

    if "WORLD_SIZE" not in os.environ:
        return run_dense(args, resolve_device(args.device))
    device = init_from_env(args.device)
    try:
        return run_dense(args, device, make_host_mesh(args.mesh_data,
                                                      args.mesh_model))
    finally:
        dist.destroy_process_group()


def run_dense(args, dev, mesh=None) -> torch.Tensor | None:
    """Build the model from seed 0 on `dev`, as the reference does (over
    a `mesh`, each rank its blocks of the same weights, one whole leaf at
    a time), decode prompts from numpy seed 0, and on rank 0 print the
    tokens/s, the first rows and one JSON line: the md5 of the (B, steps)
    tokens, prefill ms and decode ms a step. Returns the tokens (None off
    rank 0)."""
    from repro_torch.train import trainer

    spec = registry.get_spec(args.arch)
    cfg = registry.smoke_config(args.arch) if args.smoke else spec.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    if mesh is None:
        model = common.init_params(spec.model(cfg, device=dev), gen)
    else:
        model = trainer.sharded_model(
            spec, cfg, mesh, dev,
            lambda name, shape: trainer.draw_leaf(shape, gen), train=False)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(args.batch, args.prompt_len))}
    if cfg.family == "encdec":
        # stub frame embeddings, one a prompt position, as the reference
        # draws them
        batch["frames"] = rng.normal(size=(
            args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    times: dict = {}
    t0 = time.perf_counter()
    toks = serve.greedy_decode(spec, cfg, model, batch, args.decode_steps,
                               device=dev, mesh=mesh, timings=times)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    if mesh is not None and dist.get_rank() != 0:
        return None
    print(f"decoded {tuple(toks.shape)} on {dev} in {dt:.2f}s "
          f"({args.batch * args.decode_steps / dt:.1f} tok/s)")
    print(toks[:2].numpy())
    summary = {
        "arch": args.arch,
        "mesh": {"data": args.mesh_data, "model": args.mesh_model}
        if mesh is not None else None,
        "tokens_md5": hashlib.md5(
            toks.numpy().astype(np.int32).tobytes()).hexdigest(),
        "prefill_ms": times["prefill_s"] * 1e3,
        "decode_ms_per_step": times["decode_s"] * 1e3
        / max(args.decode_steps - 1, 1)}
    print(json.dumps(summary), flush=True)
    return toks


log = logging.getLogger("repro_torch.serve")


def serve_sparse(args) -> dict | None:
    """Join torchrun's process group when there is one (rank 0 the front,
    the others followers), serve, and leave it. Returns rank 0's summary
    (None on a follower)."""
    from repro_torch.launch.mesh import init_from_env, make_host_mesh

    if "WORLD_SIZE" not in os.environ:
        return run_sparse(args, resolve_device(args.device))
    device = init_from_env(args.device)
    try:
        return run_sparse(args, device, make_host_mesh(
            dist.get_world_size()))
    finally:
        dist.destroy_process_group()


def run_sparse(args, device, mesh=None) -> dict | None:
    """Drive the sparse serving engine on `device` (every rank of `mesh`
    calls this); rank 0 returns the metrics snapshot with the md5 of the
    answers in request order, and prints the summary."""
    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch.serve import (BatchingConfig, DPMRServeEngine,
                                   HotCacheConfig)

    if args.data_dir:
        source = get_source("file_sparse", directory=args.data_dir)
    else:
        source = get_source("zipf_sparse", batch_size=args.request_size,
                            num_batches=max(args.requests, 1),
                            num_features=args.features,
                            features_per_sample=16, seed=args.data_seed)
    k = int(source.batch(0)["ids"].shape[1])
    cfg = DPMRConfig(num_features=args.features, max_features_per_sample=k,
                     distribution=args.strategy)
    batching = BatchingConfig(max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms)
    hot = HotCacheConfig(max_hot=args.hot_max, threshold=args.hot_threshold,
                         window=args.hot_window,
                         refresh_every=args.hot_refresh_every) \
        if args.hot_cache else None

    if args.ckpt:
        srv = DPMRServeEngine.from_checkpoint(cfg, args.ckpt, device=device,
                                              mesh=mesh, batching=batching,
                                              hot_cache=hot)
        log.info("restored sparse state at step %d from %s",
                 srv.engine.host_step(), args.ckpt)
    else:
        engine = DPMREngine(cfg, device=device, mesh=mesh)
        if args.warm_steps:
            engine.fit_sgd(source.iter_batches(), steps=args.warm_steps)
            log.info("warm-trained %d steps (no --ckpt given)",
                     args.warm_steps)
        else:
            log.warning("serving ZERO parameters (no --ckpt, no "
                        "--warm-steps): every probability is 0.5")
        srv = DPMRServeEngine(engine, batching=batching, hot_cache=hot)
    if srv.rank != 0:
        srv.serve_follower()
        return None

    n = args.requests
    if source.num_batches is not None:
        n = min(n, source.num_batches)
    requests = [source.batch(i) for i in range(n)]
    results: list = [None] * n
    srv.metrics.reset_clock()
    t0 = time.time()

    def client(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            results[i] = srv.submit(requests[i]["ids"],
                                    requests[i]["vals"])

    clients = max(1, args.clients)
    per = -(-n // clients)
    threads = [threading.Thread(target=client,
                                args=(c * per, min(n, (c + 1) * per)))
               for c in range(clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        probs = [np.asarray(f.result(timeout=120)) for f in results]
        wall = time.time() - t0
    finally:
        srv.stop()          # releases the followers whatever happened

    m = srv.metrics_snapshot()
    print(f"[sparse] {n} requests x {requests[0]['ids'].shape[0]} samples "
          f"from {clients} clients in {wall:.2f}s "
          f"({n / max(wall, 1e-9):.1f} req/s)")
    print(f"  latency p50 {m.get('latency_p50_ms', float('nan')):.2f}ms "
          f"p99 {m.get('latency_p99_ms', float('nan')):.2f}ms; "
          f"flushes {m.get('flushes', 0)} "
          f"(full {m.get('flush_full', 0)} / deadline "
          f"{m.get('flush_deadline', 0)}); "
          f"compiled step fns {m['compiled_step_fns']}")
    if args.hot_cache:
        print(f"  hot cache: hit rate {m.get('hot_hit_rate', 0.0):.3f} "
              f"({m.get('cache_hits', 0)} hits / "
              f"{m.get('cache_misses', 0)} misses), "
              f"refreshes {m.get('cache_refreshes', 0)} "
              f"(stale {m.get('cache_stale_refreshes', 0)})")
    print(f"  first request -> {probs[0][:4]}")
    answers = np.concatenate(probs).astype(np.float32)
    m["answers_md5"] = hashlib.md5(answers.tobytes()).hexdigest()
    m["ranks"] = srv.engine.num_shards
    print(json.dumps(m), flush=True)
    return m


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="model zoo id (repro_torch.configs; "
                                   "rejected under --sparse)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced same-family config (--no-smoke = full)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="dense: data dim of the mesh of torchrun's ranks "
                         "(the batch rows)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="dense: model dim of the mesh (heads, ff, "
                         "experts, vocab, cache slots)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, NCCL under "
                         "torchrun; 'cpu' to run on the CPU, gloo)")
    # sparse serving mode
    ap.add_argument("--sparse", action="store_true",
                    help="serve the DPMR sparse face through "
                         "repro_torch.serve.DPMRServeEngine")
    ap.add_argument("--ckpt", default="",
                    help="sparse: restore this sparse checkpoint "
                         "(manifest kind must be dpmr_sparse)")
    ap.add_argument("--features", type=int, default=1 << 14,
                    help="sparse: hashed feature-space size")
    ap.add_argument("--strategy", default="a2a",
                    help="sparse: distribution strategy name")
    ap.add_argument("--data-dir", default="",
                    help="sparse: serve requests shaped from a file_sparse "
                         "corpus instead of the synthetic zipf stream")
    ap.add_argument("--requests", type=int, default=128,
                    help="sparse: number of requests to drive")
    ap.add_argument("--request-size", type=int, default=4,
                    help="sparse: samples per request (zipf source)")
    ap.add_argument("--clients", type=int, default=8,
                    help="sparse: concurrent client threads")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="sparse: coalescer flush size (rows)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="sparse: coalescer deadline window")
    ap.add_argument("--hot-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="sparse: host-side Zipf-head parameter cache")
    ap.add_argument("--hot-max", type=int, default=256,
                    help="sparse: hot-cache slots")
    ap.add_argument("--hot-threshold", type=float, default=0.001,
                    help="sparse: min in-window frequency to cache")
    ap.add_argument("--hot-window", type=int, default=512,
                    help="sparse: sliding request window size")
    ap.add_argument("--hot-refresh-every", type=int, default=256,
                    help="sparse: staleness bound (lookups per mirror)")
    ap.add_argument("--warm-steps", type=int, default=0,
                    help="sparse: train this many steps in place when no "
                         "--ckpt is given (demo-quality parameters)")
    ap.add_argument("--data-seed", type=int, default=0)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sparse:
        if args.arch:
            # fail loudly instead of silently ignoring a dense config: the
            # two modes serve different state and share no flags
            ap.error(f"--arch {args.arch!r} is a dense LM config; the "
                     "sparse mode serves a DPMR checkpoint (--ckpt) — "
                     "pass exactly one of --arch / --sparse")
        logging.basicConfig(level=logging.INFO)
        return serve_sparse(args)
    if not args.arch:
        ap.error("--arch is required (or pass --sparse)")
    ranks = args.mesh_data * args.mesh_model
    if "RANK" in os.environ:                 # under torchrun: a mesh
        if ranks != int(os.environ["WORLD_SIZE"]):
            ap.error(f"a (data {args.mesh_data}, model {args.mesh_model}) "
                     f"mesh needs {ranks} ranks; torchrun started "
                     f"{os.environ['WORLD_SIZE']}")
    elif ranks > 1:
        ap.error("--mesh-data and --mesh-model lay out the ranks of a "
                 "torchrun: start the program with torchrun")
    return serve_dense(args)


if __name__ == "__main__":
    main()
