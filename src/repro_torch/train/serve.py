"""Serve-step builders of the port: prefill and greedy decode
(counterpart of `repro.train.serve`).

PyTorch runs eagerly, so where the reference jits the two steps the port
calls them under `torch.inference_mode()`. `greedy_decode` runs on the
card unless the caller passes `device="cpu"`, and raises without a card.
With a `mesh` (`launch.mesh.make_host_mesh`: `data`, `model`) every rank
serves its blocks of the model (`train.trainer.sharded_model(...,
train=False)`) through the family's `mesh_prefill` and
`mesh_decode_step` (`models.parallel.ServeMesh` lays out the batch rows
and the caches) and returns the whole batch's tokens.
"""
from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fsdp
from repro_torch.device import resolve_device
from repro_torch.models import parallel


def make_prefill_step(spec, cfg: ModelConfig) -> Callable:
    def prefill_step(model, batch):
        return spec.prefill(model, batch, cfg)

    return prefill_step


def make_decode_step(spec, cfg: ModelConfig) -> Callable:
    def decode_step(model, cache, tokens):
        return spec.decode_step(model, cache, tokens, cfg)

    return decode_step


def _place(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor on `device` (in `dtype` if given)."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _next_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


@torch.inference_mode()
def greedy_decode(spec, cfg: ModelConfig, model, batch: dict, steps: int,
                  device=None, mesh=None, timings: dict | None = None
                  ) -> torch.Tensor:
    """Prefill + greedy decode loop: (B, steps) int32 tokens on `device`.

    `batch["tokens"]` (B, S), numpy or tensor, is placed on `device`, and
    so is an encoder-decoder's `batch["frames"]` (B, S_enc, D); `model`
    must already live there. A KV cache has `transformer.PREFILL_EXTRA`
    slots of headroom, so at most PREFILL_EXTRA + 1 steps fill no slot
    twice. With a `mesh`, `model` holds this rank's blocks over it
    (`model.layout`); each rank serves its rows of the batch and every
    rank returns the whole (B, steps) tokens (one all-gather over `data`
    at the end). A `timings` dict receives the prefill's seconds and
    the decode steps' (`prefill_s`, `decode_s`), the device synchronized
    at each end."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, the decode on "
                         f"{dev}")
    placed = {"tokens": _place(batch["tokens"], dev, torch.int32)}
    if cfg.family == "encdec":
        placed["frames"] = _place(batch["frames"], dev)
    clock = _Clock(dev, timings)
    if mesh is not None:
        return _mesh_greedy(spec, cfg, model, placed, steps, mesh, clock)
    decode = make_decode_step(spec, cfg)
    logits, cache = make_prefill_step(spec, cfg)(model, placed)
    tok = _next_token(logits)
    clock.lap("prefill_s")
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(model, cache, tok)
        tok = _next_token(logits)
        out.append(tok)
    clock.lap("decode_s")
    return torch.cat(out, dim=1)


class _Clock:
    """Seconds between laps into `timings` (nothing without it), the
    device synchronized at each lap."""

    def __init__(self, dev, timings: dict | None):
        self.dev, self.timings = dev, timings
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.timings is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.timings[key] = now - self.t
        self.t = now


def _mesh_greedy(spec, cfg: ModelConfig, model, placed: dict, steps: int,
                 mesh, clock: _Clock) -> torch.Tensor:
    layout = getattr(model, "layout", None)
    if layout is None or layout.mesh is not mesh:
        raise ValueError("a mesh decode takes the model's blocks over that "
                         "mesh (trainer.sharded_model(..., train=False))")
    sm = parallel.ServeMesh(layout, placed["tokens"].shape[0])
    view = parallel.ShardedView(model, layout)
    mine = {k: sm.my_rows(v) for k, v in placed.items()}
    logits, cache = spec.mesh_prefill(view, mine, cfg, sm)
    tok = parallel.next_token(logits, cfg, sm.tp)
    clock.lap("prefill_s")
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = spec.mesh_decode_step(view, cache, tok, cfg, sm)
        tok = parallel.next_token(logits, cfg, sm.tp)
        out.append(tok)
    clock.lap("decode_s")
    toks = torch.cat(out, dim=1)
    if sm.rows_split:
        toks = fsdp.all_gather_dim(toks, layout.group("data"), 0)
    return toks
