"""Serve-step builders of the port: prefill and greedy decode
(counterpart of `repro.train.serve`).

PyTorch runs eagerly, so where the reference jits the two steps the port
calls them under `torch.inference_mode()`. `greedy_decode` runs on the
card unless the caller passes `device="cpu"`, and raises without a card.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


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
                  device=None) -> torch.Tensor:
    """Prefill + greedy decode loop: (B, steps) int32 tokens on `device`.

    `batch["tokens"]` (B, S), numpy or tensor, is placed on `device`, and
    so is an encoder-decoder's `batch["frames"]` (B, S_enc, D); `model`
    must already live there. A KV cache has `transformer.PREFILL_EXTRA`
    slots of headroom, so at most PREFILL_EXTRA + 1 steps fill no slot
    twice."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, the decode on "
                         f"{dev}")
    placed = {"tokens": _place(batch["tokens"], dev, torch.int32)}
    if cfg.family == "encdec":
        placed["frames"] = _place(batch["frames"], dev)
    decode = make_decode_step(spec, cfg)
    logits, cache = make_prefill_step(spec, cfg)(model, placed)
    tok = _next_token(logits)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(model, cache, tok)
        tok = _next_token(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
