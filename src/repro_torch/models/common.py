"""Shared model plumbing of the port: parameters, embedding, LM head, and
the f32-result product (counterpart of `repro.models.common`).

Parameters keep the reference's layouts and names. Matrices are stored in
the activation dtype (`cfg.dtype`): the reference keeps `param_dtype`
masters and casts each matrix to `cfg.dtype` at every use, which gives
the same values as one cast at load. Norm scales (every 1-D leaf) stay
f32, as the reference's norms read them.
"""
from __future__ import annotations

import torch
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
               device) -> None:
    """Register one uninitialised parameter per `defs` entry (name ->
    shape): 1-D leaves (norm scales) in f32, the rest in `cfg.dtype`."""
    for name, shape in defs.items():
        dtype = torch.float32 if len(shape) == 1 else act_dtype(cfg)
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))


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


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with an f32 result: the reference's einsum with
    `preferred_element_type=float32` and no cast after it.

    On the card, for bf16 operands, `torch.mm(..., out_dtype=float32)`:
    bf16 products, f32 accumulation and an f32 result, never rounded to
    bf16. The CPU build of PyTorch has no such product, so there the
    operands are upcast to f32: a product of two bf16 values is exact in
    f32, so only the order of the f32 sums differs."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda":
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (n, i, k) @ (n, k, j) with an f32 result, as `dot_f32`."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embedding lookup, (B, S) int -> (B, S, d) in `cfg.dtype`."""
    return embed[tokens.long()].to(act_dtype(cfg))


def lm_head(table: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) @ table (d, V_pad) -> f32 logits, the padded vocab tail
    masked to -1e30."""
    logits = dot_f32(x, table)
    v = logits.shape[-1]
    if v != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
