"""Shared model plumbing of the port: parameters, embedding, LM head, the
loss, and the f32-result product (counterpart of `repro.models.common`).

Parameters keep the reference's layouts and names. The reference keeps
`param_dtype` masters and casts each matrix to `cfg.dtype` at every use.
A model built for training does the same: every leaf in
`cfg.param_dtype`, `requires_grad=True`, and each use casts (the
embedding, the LM head, the projections, the MLP). A model built for
serving stores its matrices in the activation dtype (`cfg.dtype`), which
gives the same values as one cast at load, so the casts at use are the
identity and copy nothing; its norm scales (every 1-D leaf) stay f32, as
the reference's norms read them, and so do the few matrices the
reference reads in f32 (the SSM blocks' convolution taps, the sLSTM's
gate weights).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

INIT_STD = 0.02    # `repro.models.common.embed_init_scale`


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256, as the reference pads it; the
    padded logits are masked in `lm_head`."""
    return -(-cfg.vocab_size // 256) * 256


def embed_defs(cfg: ModelConfig) -> dict:
    v = padded_vocab(cfg)
    d = {"embed": (v, cfg.d_model), "ln_f": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        d["unembed"] = (cfg.d_model, v)
    return d


def add_params(module: nn.Module, defs: dict, cfg: ModelConfig,
               device, train: bool = False, keep_f32=()) -> None:
    """Register one uninitialised parameter per `defs` entry (name ->
    shape). For training: every leaf in `cfg.param_dtype` with
    `requires_grad=True`; for serving: 1-D leaves (norm scales) and the
    leaves named in `keep_f32` (those the reference reads in f32, such as
    a convolution's taps) in f32, the rest in `cfg.dtype`, no grad."""
    for name, shape in defs.items():
        if train:
            dtype = getattr(torch, cfg.param_dtype)
        elif len(shape) == 1 or name in keep_f32:
            dtype = torch.float32
        else:
            dtype = act_dtype(cfg)
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=train))


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter in place, in `named_parameters` order: ones for
    1-D (norm) leaves, N(0, INIT_STD^2) for the rest, as
    `repro.sharding.init_from_defs` with `embed_init_scale`. Each leaf is
    drawn in f32 from `generator`, on the generator's device, then cast:
    one leaf's f32 copy exists at a time, never the model's.

    The port's leaves are per layer, so every norm scale is 1-D and gets
    ones; the reference's stacked (L, d) norm scales fall under its
    normal rule instead (ROADMAP C7). The draws differ from `jax.random`'s
    whatever the seed: tests carry weights across with `convert`."""
    for p in model.parameters():
        if p.dim() == 1:
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                dtype=torch.float32,
                                device=generator.device).mul_(INIT_STD))
    return model


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) or batched (n, i, k) @ (n, k, j) of two low-precision
    operands with an f32 result, never rounded to their dtype.

    On the card, `torch.mm`/`torch.bmm(..., out_dtype=float32)`: bf16
    products, f32 accumulation and an f32 result. The CPU build of
    PyTorch has no such product, so there the operands are upcast to f32:
    a product of two bf16 values is exact in f32, so only the order of
    the f32 sums differs."""
    if a.device.type == "cuda":
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class _MmF32(torch.autograd.Function):
    """`_mm_f32` with a backward: PyTorch defines none for the `out_dtype`
    products. The f32 cotangent is rounded to the operands' dtype and
    both gradients are products in that dtype (f32 accumulation, one
    rounding), as mixed-precision training takes them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return da, db


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MmF32.apply(a, b)
    return _mm_f32(a, b)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with an f32 result: the reference's einsum with
    `preferred_element_type=float32` and no cast after it (`_mm_f32`),
    differentiable."""
    out = _product_f32(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (n, i, k) @ (n, k, j) with an f32 result, as `dot_f32`."""
    return _product_f32(a, b)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embedding lookup, (B, S) int -> (B, S, d) in `cfg.dtype`: the
    rows are gathered, then cast, as the reference takes them. Its
    backward sums each token's rows (`F.embedding`)."""
    return F.embedding(tokens.long(), embed).to(act_dtype(cfg))


def lm_head(table: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) @ table (d, V_pad) -> f32 logits, the table cast to x's
    dtype at use and the padded vocab tail masked to -1e30."""
    logits = dot_f32(x, table.to(x.dtype))
    v = logits.shape[-1]
    if v != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (B, S, V) f32, labels (B, S) int -> the mean nll (0-d f32),
    over the tokens where `mask` is nonzero when one is given."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
