"""Model layers of the port (counterpart of `repro.models.layers`).

Norms (RMS and whisper's LayerNorm without a bias), RoPE and sinusoidal
positions, the attention projections, the MLPs, the blocked attention of
training (causal, full or sliding-window, and non-causal), prefill's
causal and non-causal attention and decode's attention over the cache,
as plain functions
over tensors; `p` is the `nn.Module` that holds a block's parameters
under the reference's names and layouts (`wq` (d, H, hd), `wo`
(H, hd, d), `wi_gate`/`wi_up`/`wo` or `wi`/`wo`).

Numerics follow the reference's casts. Each use casts a matrix to the
activation dtype (the identity for a serving model, whose matrices are
stored in it; a copy of a training model's f32 master). Where the
reference keeps an f32 product (`preferred_element_type=float32` with no
cast after it: swiglu's gate and up products, attention's scores and its
probabilities times V), the port takes `common.dot_f32`/`bmm_f32`; where
it casts the f32 product back to the activation dtype (the projections,
the MLP's output), a plain product in that dtype, which accumulates in
f32 and rounds once. Training's attention is `attention_block` over
`blocked_causal_attention`, differentiated by autograd as the reference
differentiates its jnp blocks (the Pallas kernel has no backward).
Prefill's attention is `kernels.ops.flash_attention` (the hand-written
kernel on the card, its plain version on the CPU) without a window,
causal or not; with a sliding window it is the reference's own blocked
schedule, since the Pallas kernel has no window either. The attention
core of `attention_block` runs inside the `obs` span `model.attention`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# norms and positions
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x, scale, eps: float):
    """LayerNorm without a bias (whisper): mean and population variance
    in f32, scaled, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
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


@functools.lru_cache(maxsize=16)
def sinusoidal_positions(length: int, d_model: int, dtype=torch.float32,
                         device=None):
    """(length, d_model) absolute positions, sin then cos, computed in
    float64 with numpy as the reference computes them, then rounded to
    f32 and to `dtype` (the reference's `jnp.asarray(out, dtype)` with
    64-bit floats off takes the same two steps). Kept for the next call
    with the same arguments (decode asks every step): do not write to
    it."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d_model)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device=device,
                                                       dtype=dtype)


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
    w = w.to(x.dtype)
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
    wo = p.wo.to(attn_out.dtype)
    return attn_out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def _repeat_kv(k, n_rep: int):
    """(B, S, KH, hd) -> (B, S, KH * n_rep, hd), each KV head repeated for
    the n_rep query heads of its group."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(
        b, s, kh * n_rep, hd)


def _attn_block(q, k, v, m, l, acc, mask, scale):
    """One online-softmax step of the reference's `_attn_block`, heads
    first: q (B, H, qb, hd), k and v (B, H, kb, hd), m and l (B, H, qb)
    f32, acc (B, H, qb, hd) f32 (the reference's (B, qb, H, hd), the same
    numbers), mask (qb, kb) bool or None. Scores and the probabilities'
    product with V are f32 products; the probabilities enter the second
    product in v's dtype."""
    b, h, qb, hd = q.shape
    kb = k.shape[2]
    s = common.bmm_f32(q.reshape(b * h, qb, hd),
                       k.reshape(b * h, kb, hd).transpose(1, 2))
    s = s.reshape(b, h, qb, kb) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = common.bmm_f32(p.to(v.dtype).reshape(b * h, qb, kb),
                        v.reshape(b * h, kb, hd)).reshape(b, h, qb, hd)
    return m_new, l_new, acc * corr[..., None] + pv


def _finalize(acc, l):
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _causal_mask(q0, qn, k0, kn, device):
    """The (qn, kn) mask of query positions q0.. against key positions
    k0.., or None where every key is visible to every query (there the
    reference's mask is all true and changes nothing)."""
    if k0 + kn - 1 <= q0:
        return None
    qpos = torch.arange(q0, q0 + qn, device=device)
    kpos = torch.arange(k0, k0 + kn, device=device)
    return qpos[:, None] >= kpos[None, :]


def _init_carry(q, q_block):
    b, h, _, hd = q.shape
    m = torch.full((b, h, q_block), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, q_block, hd), dtype=torch.float32,
                      device=q.device)
    return m, l, acc


def _triangular_attention(q, k, v, q_block, kv_block, scale):
    """Unrolled q blocks; q block i sees kv[0 : (i+1) * q_block], in
    kv blocks of `kv_block` and a remainder block."""
    sq = q.shape[2]
    outs = []
    for i in range(sq // q_block):
        qs = i * q_block
        qi = q[:, :, qs:qs + q_block]
        extent = qs + q_block
        kb = min(kv_block, extent)
        n_kv = extent // kb
        starts = [(j * kb, kb) for j in range(n_kv)]
        if extent - n_kv * kb:
            starts.append((n_kv * kb, extent - n_kv * kb))
        m, l, acc = _init_carry(q, q_block)
        for k0, kn in starts:
            mask = _causal_mask(qs, q_block, k0, kn, q.device)
            m, l, acc = _attn_block(qi, k[:, :, k0:k0 + kn],
                                    v[:, :, k0:k0 + kn], m, l, acc, mask,
                                    scale)
        outs.append(_finalize(acc, l))
    return torch.cat(outs, dim=2)


def _masked_scan_attention(q, k, v, q_block, kv_block, scale):
    """Every q block against every kv block, with the causal mask (the
    reference's scan, which tolerates the masked blocks' waste; like it,
    keys past the last whole kv block are not seen)."""
    sq = q.shape[2]
    kv_block = min(kv_block, sq)
    outs = []
    for iq in range(sq // q_block):
        qs = iq * q_block
        qi = q[:, :, qs:qs + q_block]
        m, l, acc = _init_carry(q, q_block)
        for ik in range(sq // kv_block):
            k0 = ik * kv_block
            mask = _causal_mask(qs, q_block, k0, kv_block, q.device)
            m, l, acc = _attn_block(qi, k[:, :, k0:k0 + kv_block],
                                    v[:, :, k0:k0 + kv_block], m, l, acc,
                                    mask, scale)
        outs.append(_finalize(acc, l))
    return torch.cat(outs, dim=2)


def _swa_attention(q, k, v, window, q_block, kv_block, scale):
    """Sliding-window causal attention, the reference's `_swa_attention`:
    k and v left-padded by `window`, so that q block i sees the static
    span padded[qs : qs + window + q_block], in kv blocks of
    min(kv_block, span) and a remainder block. Query position qs + i sees
    the keys in (qs + i - window, qs + i]; the padding is masked."""
    sq = q.shape[2]
    kp = F.pad(k, (0, 0, window, 0))
    vp = F.pad(v, (0, 0, window, 0))
    span = window + q_block
    kb = min(kv_block, span)
    n_kv = span // kb
    starts = [(j * kb, kb) for j in range(n_kv)]
    if span - n_kv * kb:
        starts.append((n_kv * kb, span - n_kv * kb))
    rel_q = torch.arange(q_block, device=q.device)[:, None] + window
    outs = []
    for iq in range(sq // q_block):
        qs = iq * q_block
        qi = q[:, :, qs:qs + q_block]
        m, l, acc = _init_carry(q, q_block)
        for k0, kn in starts:
            kpos = torch.arange(k0, k0 + kn, device=q.device)[None, :]
            valid = (kpos <= rel_q) & (kpos > rel_q - window) \
                & (qs - window + kpos >= 0)
            m, l, acc = _attn_block(qi, kp[:, :, qs + k0:qs + k0 + kn],
                                    vp[:, :, qs + k0:qs + k0 + kn], m, l,
                                    acc, valid, scale)
        outs.append(_finalize(acc, l))
    return torch.cat(outs, dim=2)


def blocked_causal_attention(q, k, v, *, window: int = 0,
                             q_block: int = 1024, kv_block: int = 1024,
                             unroll_limit: int = 64):
    """Causal, optionally sliding-window, attention, O(S * block) memory
    per step, differentiable: q (B, S, H, hd), k and v (B, S, KH, hd)
    with H % KH == 0 -> (B, S, H, hd) in q's dtype, scaled by
    1/sqrt(hd).

    The reference's schedules and block sizes: with a window,
    `_swa_attention`; else the unrolled triangular schedule when there
    are at most `unroll_limit` q blocks, and every q block against every
    kv block under the mask beyond. An S that `q_block` does not divide
    is one q block. The port computes heads first (one transposed copy
    of q, k and v) so that each block's products are batched over
    (B, H)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, sq)
    if sq % q_block:
        q_block = sq
    n_q = sq // q_block
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window:
        out = _swa_attention(qt, kt, vt, window, q_block, kv_block, scale)
    elif n_q <= unroll_limit:
        out = _triangular_attention(qt, kt, vt, q_block, kv_block, scale)
    else:
        out = _masked_scan_attention(qt, kt, vt, q_block, kv_block, scale)
    return out.transpose(1, 2).to(q.dtype)


def _bidirectional_blocked(q, k, v, q_block: int = 1024,
                           kv_block: int = 1024):
    """Non-causal blocked attention (the encoder, cross-attention) of
    training, differentiable: q (B, Sq, H, hd), k and v (B, Skv, KH, hd)
    -> (B, Sq, H, hd) in q's dtype. The reference's blocks: q blocks of
    `q_block` (one block when it does not divide Sq), kv blocks of
    min(kv_block, Skv) (one block when that does not divide Skv)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    scale = 1.0 / math.sqrt(hd)
    if sq % q_block:
        q_block = sq
    skv = k.shape[1]
    kb = min(kv_block, skv)
    if skv % kb:
        kb = skv
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ks, vs = kt.split(kb, dim=2), vt.split(kb, dim=2)
    outs = []
    for qi in qt.split(q_block, dim=2):
        m, l, acc = _init_carry(qt, q_block)
        for kj, vj in zip(ks, vs, strict=True):
            m, l, acc = _attn_block(qi, kj, vj, m, l, acc, None, scale)
        outs.append(_finalize(acc, l))
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def attention_block(p, x, cfg: ModelConfig, tables, *, causal: bool = True,
                    kv_x=None, attn_mode: str = "auto"):
    """Attention block of training: projections, RoPE, the blocked
    attention and the output projection. `tables` are RoPE's (sin, cos)
    for the sequence's positions (`rope_tables`; None without RoPE).
    Causal self-attention takes `blocked_causal_attention`; with
    `causal=False`, or cross-attention over `kv_x` (keys and values
    projected from it, without RoPE), `_bidirectional_blocked`.
    `attn_mode="cp"` (context parallel) is the same here: this block
    sees the whole sequence, and without a `model` dim of more than one
    rank the reference's `context_parallel_attention` falls back to the
    blocked attention (over a mesh, `models.parallel.cp_attention`)."""
    q = project_q(p, x, cfg)
    k, v = project_kv(p, x if kv_x is None else kv_x, cfg)
    if tables is not None:
        sin, cos = tables
        q = apply_rope(q, sin, cos)
        if kv_x is None:
            k = apply_rope(k, sin, cos)
    with obs.span("model.attention"):
        if kv_x is not None or not causal:
            out = _bidirectional_blocked(q, k, v)
        else:
            out = blocked_causal_attention(q, k, v,
                                           window=cfg.sliding_window)
    return project_out(p, out)


def cp_attention_chunk(q, k, v, chunk: int, chunks: int, *,
                       causal: bool = True, window: int = 0,
                       kv_block: int = 1024):
    """Chunk `chunk` of `chunks` of context-parallel attention: q (B, S/C,
    H, hd) holds the query rows of global positions chunk * S/C .. ; k and
    v (B, S, KH, hd) the whole sequence. An online softmax over kv blocks
    of `kv_block` (one block when it does not divide S), masked by global
    positions (causal, causal within a window of `window` keys, or
    full), scores and the probabilities' product with V in f32 as the
    reference's `context_parallel_attention` computes each chunk. A kv
    block that every query row of the chunk masks whole is skipped: the
    reference's step over it changes no bit of the result (before the
    first visible block its sums are wiped by a zero correction, after
    it every probability is exp(-1e30 - m) = 0). -> (B, S/C, H, hd) in
    q's dtype."""
    b, s_loc, h, hd = q.shape
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    skv = k.shape[1]
    kb = skv if skv % kv_block else kv_block
    scale = 1.0 / math.sqrt(hd)
    q0 = chunk * s_loc
    qt = q.transpose(1, 2).to(torch.float32).reshape(b * h, s_loc, hd)
    kt = k.transpose(1, 2).reshape(b * h, skv, hd)
    vt = v.transpose(1, 2).reshape(b * h, skv, hd)
    qpos = torch.arange(q0, q0 + s_loc, device=q.device)[:, None]
    m = torch.full((b * h, s_loc), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b * h, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b * h, s_loc, hd), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, skv, kb):
        if causal and (k0 > q0 + s_loc - 1 or (
                window and k0 + kb - 1 <= q0 - window)):
            continue
        s = torch.bmm(qt, kt[:, k0:k0 + kb].to(torch.float32).transpose(
            1, 2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kb, device=q.device)[None, :]
            mask = qpos >= kpos
            if window:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + common.bmm_f32(
            p.to(v.dtype), vt[:, k0:k0 + kb])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s_loc, hd).transpose(1, 2).to(q.dtype)


def context_parallel_attention(q, k, v, *, group=None, causal: bool = True,
                               window: int = 0, kv_block: int = 1024):
    """Context-parallel attention over the C ranks of `group` (the mesh's
    `model` dim): q, k, v (B, S/C, ., hd) are this rank's S-shards; q and
    the output stay sharded and only K and V are all-gathered over S
    (differentiable: the backward reduce-scatters their gradients), then
    `cp_attention_chunk` with this rank's chunk index. Without a group of
    more than one rank (q, k, v the whole sequence) it is the blocked
    attention, causal or not, as the reference falls back."""
    import torch.distributed as dist

    from repro_torch.core import fsdp

    if group is None or dist.get_world_size(group) == 1:
        if not causal:
            return _bidirectional_blocked(q, k, v)
        return blocked_causal_attention(q, k, v, window=window)
    k = fsdp.gather(k, group, 1)
    v = fsdp.gather(v, group, 1)
    return cp_attention_chunk(q, k, v, dist.get_rank(group),
                              dist.get_world_size(group), causal=causal,
                              window=window, kv_block=kv_block)


def causal_self_attention(q, k, v, *, window: int = 0):
    """Prefill's self-attention: q (B, S, H, hd), k and v (B, S, KH, hd) ->
    (B, S, H, hd), causal, scaled by 1/sqrt(hd). The reference computes it
    with `layers.blocked_causal_attention`; the port with the
    `flash_attention` kernel (one launch per layer on the card), or, with
    a sliding window, which the kernel does not take, with the
    reference's blocked schedule (no kernel)."""
    if window:
        return blocked_causal_attention(q, k, v, window=window)
    return ops.flash_attention(q, k, v, causal=True)


def bidirectional_attention(q, k, v):
    """Prefill's non-causal attention (whisper's encoder and its
    cross-attention over the encoded frames): q (B, Sq, H, hd), k and v
    (B, Skv, KH, hd), Sq and Skv free -> (B, Sq, H, hd). The reference
    computes it with `layers._bidirectional_blocked`; the port with one
    launch of the `flash_attention` kernel, causal=False (its plain
    version on the CPU)."""
    return ops.flash_attention(q, k, v, causal=False)


def decode_attention_part(q, k_cache, v_cache, cache_len, *,
                          slot0: int = 0, slots: int | None = None,
                          window: int = 0):
    """Single-step decode over a part of the cache: q (B, 1, H, hd)
    against the slots slot0 .. slot0 + n - 1 of a cache of `slots` (all
    of them by default), k_cache and v_cache (B, n, KH, hd). A slot is
    valid below cache_len ((B,) int), or with a window below min(
    cache_len, slots) (the ring of the last `slots` positions, as in the
    reference); the mask reads the global slot index. The q heads are
    grouped as (B, KH, group, hd) against their KV head, which gives the
    numbers of the reference's `_repeat_kv` without repeating the cache.
    Returns the part's unnormalised output o (B, KH, group, hd), its row
    max m and its sum of exponentials l (B, KH, group), all f32: scores
    are an f32 product, exp(score - m) enters the product with V in the
    cache's dtype. `decode_combine` and `decode_finish` make the
    attention of the parts."""
    b, n, kh, hd = k_cache.shape
    h = q.shape[2]
    g = h // kh
    slots = n if slots is None else slots
    qg = q.reshape(b * kh, g, hd)
    kt = k_cache.permute(0, 2, 3, 1).reshape(b * kh, hd, n)
    scores = common.bmm_f32(qg, kt).reshape(b, kh, g, n) / math.sqrt(hd)
    limit = torch.clamp(cache_len, max=slots) if window else cache_len
    idx = torch.arange(slot0, slot0 + n, device=q.device)
    valid = idx[None, :] < limit[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = torch.amax(scores, dim=-1)
    e = torch.exp(scores - m[..., None])
    vg = v_cache.permute(0, 2, 1, 3).reshape(b * kh, n, hd)
    o = common.bmm_f32(e.to(v_cache.dtype).reshape(b * kh, g, n), vg)
    return o.reshape(b, kh, g, hd), m, torch.sum(e, dim=-1)


def decode_combine(o, m, l, group):
    """The parts of `decode_attention_part` over the ranks of `group` (the
    ranks' slots) combined by log-sum-exp: the max all-reduced, then the
    rescaled outputs and sums in one all-reduce. Returns the whole (o, l);
    a rank whose slots are all masked adds exp(-1e30 - max) = 0."""
    import torch.distributed as dist

    from repro_torch.core import fsdp

    c = torch.exp(m - fsdp.all_reduce_max(m, group))
    both = torch.cat([o * c[..., None], (l * c)[..., None]], dim=-1)
    dist.all_reduce(both, group=group)
    return both[..., :-1], both[..., -1]


def decode_finish(o, l, dtype):
    """(o, l) of the whole cache -> the attention (B, 1, H, hd) in
    `dtype`."""
    b, kh, g, hd = o.shape
    return (o / l[..., None]).reshape(b, 1, kh * g, hd).to(dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-step decode: q (B, 1, H, hd) against the whole cache (B, S,
    KH, hd), masked to cache_len ((B,) int) as `decode_attention_part`
    masks it: that part over every slot, normalised by its own sum.
    The permuted cache's reshape into the batched products' layout still
    copies K and V once per call."""
    o, _, l = decode_attention_part(q, k_cache, v_cache, cache_len,
                                    window=window)
    return decode_finish(o, l, q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(p, x, cfg: ModelConfig):
    """swiglu: silu(x wi_gate) * (x wi_up), both products f32, or gelu (the
    reference's tanh approximation) of the f32 product x wi; the hidden
    state is cast to x's dtype before `wo`. With grad off (serving) the
    f32 intermediates are updated in place, which keeps one (B, S, d_ff)
    f32 buffer fewer live; under autograd the same arithmetic runs out of
    place, since silu's backward reads its input."""
    dt = x.dtype
    if cfg.mlp_type == "swiglu":
        g = common.dot_f32(x, p.wi_gate.to(dt))
        u = common.dot_f32(x, p.wi_up.to(dt))
        if torch.is_grad_enabled() and g.requires_grad:
            h = (F.silu(g) * u).to(dt)
        else:
            h = F.silu(g, inplace=True).mul_(u).to(dt)
    else:
        h = F.gelu(common.dot_f32(x, p.wi.to(dt)),
                   approximate="tanh").to(dt)
    return h @ p.wo.to(dt)
