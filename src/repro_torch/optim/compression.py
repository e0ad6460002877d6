"""Gradient compression primitives of the sparse face: the counterpart of
`repro.optim.compression`, cut to what the port's strategies use.

  - `quantize` / `dequantize`: per-block symmetric int8 (one f32 scale per
    `BLOCK` values), the wire format of the `compressed_reduce` strategy,
    whose error feedback rides in `DPMRState.strat`.
  - `topk_count` / `topk_select`: the top-k selection of the `topk_reduce`
    strategy and of its wire model, so the two cannot disagree about k.

The dense trainer's `compress_psum`, `compress_tree_psum`,
`init_error_state` and `wire_bytes` come with the dense face (ROADMAP
queue A). `torch.round` rounds half to even, as `jnp.round` does, so the
int8 codes equal the reference's bit for bit.
"""
from __future__ import annotations

import math

import torch

BLOCK = 2048


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. x: (N,) f32 with N % BLOCK == 0.
    Returns (q (N/BLOCK, BLOCK) int8, scale (N/BLOCK, 1) f32)."""
    xb = x.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The first `n` values of the blocks `q * scale`, as (n,) f32."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def topk_count(n: int, frac: float) -> int:
    """k for a top-`frac` selection out of `n` slots: ceil(frac * n),
    clamped to [1, n]. The topk_reduce strategy's reduce path and its
    `bytes_per_device` wire model both take k from here."""
    return int(min(n, max(1, math.ceil(frac * n))))


def topk_select(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis: `(indices (..., k) int64, mask)` of the k
    largest entries per row, ties broken by position: `jax.lax.top_k`'s
    order, which a stable descending sort gives and `torch.topk` does not
    promise. `x` is the selection key: pass magnitudes, with invalid slots
    already pushed below every valid one."""
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    idx = torch.sort(flat, dim=1, descending=True, stable=True).indices[:, :k]
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=x.device)
    mask.scatter_(1, idx, True)
    return idx.reshape(x.shape[:-1] + (k,)), mask.reshape(x.shape)
