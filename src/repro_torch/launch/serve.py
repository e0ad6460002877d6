"""Serving driver of the port: prefill + greedy decode of a dense model
(the dense mode of `repro.launch.serve`), with weights made from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --device cpu                       # smoke size, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --no-smoke --batch 8 --prompt-len 4096 --decode-steps 32  # the card

It runs on the card unless `--device cpu` is given, and raises without
one. The reference's `--sparse` mode (the DPMR serving engine) is not
ported: ROADMAP A8.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common, registry
from repro_torch.train import serve


def serve_dense(args) -> torch.Tensor:
    """Build the model from seed 0 on the device, as the reference does,
    decode prompts from numpy seed 0, print the tokens/s, and return the
    (B, steps) tokens."""
    dev = resolve_device(args.device)
    spec = registry.get_spec(args.arch)
    cfg = registry.smoke_config(args.arch) if args.smoke else spec.cfg
    model = spec.model(cfg, device=dev)
    common.init_params(model, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(args.batch, args.prompt_len))}
    t0 = time.perf_counter()
    toks = serve.greedy_decode(spec, cfg, model, batch, args.decode_steps,
                               device=dev)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    print(f"decoded {tuple(toks.shape)} on {dev} in {dt:.2f}s "
          f"({args.batch * args.decode_steps / dt:.1f} tok/s)")
    print(toks[:2].numpy())
    return toks


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="dense model id (repro_torch.configs)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced same-family config (--no-smoke = full)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    ap.add_argument("--sparse", action="store_true",
                    help="the DPMR sparse serving engine: not ported "
                         "(ROADMAP A8)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sparse:
        ap.error("--sparse (the DPMR sparse serving engine) is not ported "
                 "yet: ROADMAP A8")
    if not args.arch:
        ap.error("--arch is required")
    return serve_dense(args)


if __name__ == "__main__":
    main()
