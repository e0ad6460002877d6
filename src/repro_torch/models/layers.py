"""Model layers of the port's serve path (`repro.models.layers`' subset).

Norms, RoPE, the attention projections, the MLPs, prefill's causal
self-attention and decode's attention over the cache, as plain functions
over tensors; `p` is the `nn.Module` that holds a block's parameters
under the reference's names and layouts (`wq` (d, H, hd), `wo` (H, hd, d),
`wi_gate`/`wi_up`/`wo` or `wi`/`wo`).

Numerics follow the reference's casts. Where it keeps an f32 product
(`preferred_element_type=float32` with no cast after it: swiglu's gate
and up products, decode's scores and its probabilities times V), the port
takes `common.dot_f32`/`bmm_f32`; where it casts the f32 product back to
the activation dtype (the projections, the MLP's output), a plain product
in that dtype, which accumulates in f32 and rounds once. Prefill's
attention is `kernels.ops.flash_attention`: the hand-written kernel on
the card, its plain version on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

# ---------------------------------------------------------------------------
# norms and positions
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def head_norm(x, scale, eps: float):
    """qk-norm: RMS-normalize the head_dim axis (chameleon)."""
    return rms_norm(x, scale, eps)


def rope_tables(positions, head_dim: int, theta: float):
    """positions: (...,) int -> (sin, cos) of shape (..., head_dim // 2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (B, S, H, D); sin/cos: (B, S, D//2) or (S, D//2). The rotation
    is computed in f32 (the tables' dtype) and cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    defs = {"wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
            "wo": (h, hd, d)}
    if cfg.qk_norm:
        defs["q_norm"] = (hd,)
        defs["k_norm"] = (hd,)
    return defs


def mlp_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wi_gate": (d, f), "wi_up": (d, f), "wo": (f, d)}
    return {"wi": (d, f), "wo": (f, d)}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _project(x, w):
    """x (B, S, d) @ w (d, n, hd) -> (B, S, n, hd) in x's dtype."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                    *w.shape[1:])


def project_q(p, x, cfg: ModelConfig):
    q = _project(x, p.wq)
    if cfg.qk_norm:
        q = head_norm(q, p.q_norm, cfg.norm_eps)
    return q


def project_kv(p, x, cfg: ModelConfig):
    k, v = _project(x, p.wk), _project(x, p.wv)
    if cfg.qk_norm:
        k = head_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


def project_out(p, attn_out):
    """attn_out (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    b, s = attn_out.shape[:2]
    return attn_out.reshape(b, s, -1) @ p.wo.reshape(-1, p.wo.shape[-1])


def _no_window(window: int) -> None:
    if window:
        raise NotImplementedError(
            f"sliding-window attention (window={window}) is not ported: "
            "SWA is mixtral's, an MoE model, ROADMAP A12")


def causal_self_attention(q, k, v, *, window: int = 0):
    """Prefill's self-attention: q (B, S, H, hd), k and v (B, S, KH, hd) ->
    (B, S, H, hd), causal, scaled by 1/sqrt(hd). The reference computes it
    with `layers.blocked_causal_attention`; the port with the
    `flash_attention` kernel (one launch per layer on the card)."""
    _no_window(window)
    return ops.flash_attention(q, k, v, causal=True)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-step decode: q (B, 1, H, hd) against the cache (B, S, KH, hd),
    masked to cache_len ((B,) int). The q heads are grouped as
    (B, KH, group, hd) against their KV head, which gives the numbers of
    the reference's `_repeat_kv` without repeating the cache group-fold;
    the reshape of the permuted cache into the batched products' layout
    still copies K and V once per call. Scores and the probabilities'
    product with V are f32 products; the probabilities enter that product
    in the cache's dtype, as in the reference."""
    _no_window(window)
    b, s, kh, hd = k_cache.shape
    h = q.shape[2]
    g = h // kh
    qg = q.reshape(b * kh, g, hd)
    kt = k_cache.permute(0, 2, 3, 1).reshape(b * kh, hd, s)
    scores = common.bmm_f32(qg, kt).reshape(b, kh, g, s) / math.sqrt(hd)
    valid = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    vg = v_cache.permute(0, 2, 1, 3).reshape(b * kh, s, hd)
    out = common.bmm_f32(p.reshape(b * kh, g, s), vg)
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(p, x, cfg: ModelConfig):
    """swiglu: silu(x wi_gate) * (x wi_up), both products f32, or gelu (the
    reference's tanh approximation) of the f32 product x wi; the hidden
    state is cast to x's dtype before `wo`. The f32 intermediates are
    updated in place, which keeps one (B, S, d_ff) f32 buffer fewer live."""
    if cfg.mlp_type == "swiglu":
        g = common.dot_f32(x, p.wi_gate)
        u = common.dot_f32(x, p.wi_up)
        h = F.silu(g, inplace=True).mul_(u).to(x.dtype)
    else:
        h = F.gelu(common.dot_f32(x, p.wi), approximate="tanh").to(x.dtype)
    return h @ p.wo
