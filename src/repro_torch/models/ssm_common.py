"""Chunked gated linear attention, the shared core of Mamba2 (SSD) and
mLSTM (counterpart of `repro.models.ssm_common`).

Both compute, per head,
    y_t = q_t^T . ( sum_{s<=t}  (prod_{r=s+1..t} a_r)  k_s v_s^T )
a linear-attention state S in R^{Dk x Dv} with a scalar decay a_r a head
and step. Mamba2: q = C, k = B, v = the x heads scaled by dt,
a = exp(dt A). mLSTM: a = sigmoid(f), k scaled by the input gate.

`chunked_linear_attention` is the reference's chunked algorithm (chunk
L): within a chunk the quadratic form ((q k^T) * decay mask) v, between
chunks the carried state. The reference scans the chunks with
`lax.scan`; the port loops over them in Python, one chunk's products
batched over (B, H), in the reference's order: the decay mask, the
intra-chunk and the inter-chunk terms (and the normaliser), then the
state update. Everything is f32. The decay mask takes exp(-inf) = 0
above the diagonal, where the reference takes where(causal, exp(cum_i -
cum_j), 0): the same values, but there cum_i - cum_j > 0 can overflow to
inf (a chunk of 128 steps of a decay below e^-0.7 a step), and the
where's gradient, 0 * inf, is NaN (ROADMAP C24). There is no Pallas
kernel here, so
there is no CUDA kernel either: on the card each chunk is a handful of
cuBLAS products and elementwise passes.

`linear_attention_step` is the O(1) decode form, the state carried in
the serve cache.
"""
from __future__ import annotations

import math

import torch


def chunked_linear_attention(q, k, v, log_a, *, chunk: int = 128,
                             normalize: bool = False, eps: float = 1e-6,
                             return_state: bool = False):
    """q, k: (B, S, H, Dk); v: (B, S, H, Dv); log_a: (B, S, H), the log
    decay (<= 0). S must be a multiple of min(chunk, S).

    Returns y (B, S, H, Dv) f32. With `normalize`, y is divided by the
    linear-attention normaliser |q_t . n_t| (clamped below by `eps`),
    n_t the decayed sum of the keys (mLSTM). With `return_state`,
    returns (y, (S_final (B, H, Dk, Dv), n_final (B, H, Dk))) for the
    prefill -> decode handoff (n_final zeros without `normalize`).
    Differentiable."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"chunked_linear_attention: S = {s} is not a "
                         f"multiple of the chunk {L}")
    f32 = torch.float32
    dev = q.device
    state = torch.zeros((b, h, dk, dv), dtype=f32, device=dev)
    norm = torch.zeros((b, h, dk), dtype=f32, device=dev)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    ys = []
    # the chunks as one split each (its backward concatenates the chunks'
    # gradients once; a slice a chunk would add a zero-filled gradient of
    # the whole sequence a chunk)
    for qi, ki, vi, lai in zip(*(t.split(L, dim=1) for t in (q, k, v,
                                                              log_a))):
        qi, ki, vi = (t.to(f32) for t in (qi, ki, vi))
        cum = torch.cumsum(lai.to(f32), dim=1)                  # (B, L, H)
        total = cum[:, -1:, :]                                   # (B, 1, H)

        # intra-chunk: decay(i, j) = exp(cum_i - cum_j) for j <= i
        scores = torch.einsum("blhd,bmhd->bhlm", qi, ki)
        ci = cum.permute(0, 2, 1)                                # (B, H, L)
        dec = torch.exp((ci[..., :, None] - ci[..., None, :])
                        .masked_fill(~causal, -math.inf))
        y = torch.einsum("bhlm,bmhd->blhd", scores * dec, vi)

        # inter-chunk: y += exp(cum_t) q_t . S_prev
        w = torch.exp(cum)                                       # (B, L, H)
        y = y + torch.einsum("blhd,bhde->blhe", qi * w[..., None], state)

        if normalize:
            # n_t = sum_{s<=t} decay * k_s, y /= |q . n|
            n_vec = torch.einsum("bhlm,bmhd->blhd", dec, ki) \
                + w[..., None] * norm[:, None]
            denom = torch.abs(torch.einsum("blhd,blhd->blh", qi, n_vec))
            y = y / torch.clamp(denom, min=eps)[..., None]

        # S_new = exp(total) S + sum_s exp(total - cum_s) k_s v_s^T
        k_w = ki * torch.exp(total - cum)[..., None]             # (B, L, H, Dk)
        decay = torch.exp(total)[:, 0]                           # (B, H)
        state = decay[..., None, None] * state \
            + torch.einsum("blhd,blhe->bhde", k_w, vi)
        if normalize:
            norm = decay[..., None] * norm + k_w.sum(dim=1)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if return_state:
        return y, (state, norm)
    return y


def linear_attention_step(state, q, k, v, log_a, *, norm_state=None,
                          normalize: bool = False, eps: float = 1e-6):
    """The O(1) decode step. state: (B, H, Dk, Dv) f32; q, k: (B, H, Dk);
    v: (B, H, Dv); log_a: (B, H). Returns (y (B, H, Dv) f32, the new
    state, the new normaliser state (`norm_state` unchanged without
    `normalize`))."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    k32 = k.to(f32)
    state = a * state + k32[..., :, None] * v.to(f32)[..., None, :]
    q32 = q.to(f32)
    y = torch.einsum("bhd,bhde->bhe", q32, state)
    if normalize:
        ns = a[..., 0] * norm_state + k32
        denom = torch.abs(torch.einsum("bhd,bhd->bh", q32, ns))
        y = y / torch.clamp(denom, min=eps)[..., None]
        return y, state, ns
    return y, state, norm_state
