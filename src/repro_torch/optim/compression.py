"""Gradient compression: the counterpart of `repro.optim.compression`.

  - `quantize` / `dequantize`: per-block symmetric int8 (one f32 scale per
    `BLOCK` values), the wire format of the `compressed_reduce` strategy,
    whose error feedback rides in `DPMRState.strat`.
  - `topk_count` / `topk_select`: the top-k selection of the `topk_reduce`
    strategy and of its wire model, so the two cannot disagree about k.
  - `compress_psum` / `compress_tree_psum`: the dense trainer's cross-pod
    reduction (`ParallelConfig.compress_pod_grads`) with error feedback:

        q = round((g + e) / scale),  scale = max|g + e| / 127 per block
        g_hat = (sum over pods of q * scale) / n_pods
        e'    = (g + e) - dequant(q)          (carried)

    The int8 codes and f32 scales are all-gathered over the pod group and
    summed locally: ~4x fewer bytes cross the slow tier than an f32 ring
    all-reduce. `init_error_state` and `wire_bytes` as the reference's.

`torch.round` rounds half to even, as `jnp.round` does, so the int8
codes equal the reference's bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 2048


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. x: (N,) f32 with N % BLOCK == 0.
    Returns (q (N/BLOCK, BLOCK) int8, scale (N/BLOCK, 1) f32)."""
    xb = x.reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from the reference's (and
    # the CPU's) IEEE division
    amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
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


def compress_codes(g: torch.Tensor, err: torch.Tensor):
    """The wire format of `g` with its error feedback `err` (same shape):
    (q (blocks, BLOCK) int8, scale (blocks, 1) f32, the new error (g's
    shape, f32)); `g + err` is flattened in f32 and zero-padded to whole
    blocks."""
    n = g.numel()
    flat = F.pad(g.reshape(-1).to(torch.float32)
                 + err.reshape(-1).to(torch.float32), (0, (-n) % BLOCK))
    q, scale = quantize(flat)
    new_err = (flat[:n] - dequantize(q, scale, n)).reshape(g.shape)
    return q, scale, new_err


def compress_psum(g: torch.Tensor, err: torch.Tensor, group
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over the ranks of `group` (the pods).
    Returns (the mean-reduced g_hat, f32, g's shape; the new error)."""
    q, scale, new_err = compress_codes(g, err)
    pods = dist.get_world_size(group)
    q_all = q.new_empty((pods * q.shape[0], BLOCK))
    s_all = scale.new_empty((pods * scale.shape[0], 1))
    dist.all_gather_into_tensor(q_all, q, group=group)
    dist.all_gather_into_tensor(s_all, scale, group=group)
    deq = (q_all.to(torch.float32) * s_all).reshape(pods, -1).sum(0)[
        :g.numel()]
    return deq.reshape(g.shape) / deq.new_full((), float(pods)), new_err


def compress_tree_psum(grads: dict, err_tree: dict, group):
    """`compress_psum` leaf by leaf over dicts of the same keys."""
    outs = {k: compress_psum(g, err_tree[k], group)
            for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})


def init_error_state(params: dict) -> dict:
    """Zero error-feedback buffers (f32), shaped like `params`."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def wire_bytes(params) -> tuple[int, int]:
    """(uncompressed, compressed) bytes per cross-pod reduction of the
    leaves `params` (a dict of tensors or of anything with a `shape`)."""
    n = sum(math.prod(p.shape) for p in params.values())
    return n * 4, n * 1 + (n // BLOCK + 1) * 4
