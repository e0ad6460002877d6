"""Plain PyTorch versions of the port's kernels.

Counterparts of `repro.kernels.ref.sigmoid_grad_ref`,
`segment_sum_sorted_ref` and `select_pack_ref`. Each is the function its CUDA kernel computes,
written as ordinary tensor code: the wrappers in this package run it when
they are handed CPU tensors, the CPU tests hold it against the JAX
package, and `chip_smoke.py` holds each kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.optim import compression


def log_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """Stable log(sigmoid(z)) = min(z, 0) - log1p(exp(-|z|))."""
    return torch.clamp(z, max=0.0) - torch.log1p(torch.exp(-torch.abs(z)))


def sigmoid_grad_ref(vals, theta, labels):
    """DPMR computeGradients map body (the paper's Algorithm 6).

    vals, theta: (B, K), 0 at padded slots; labels: (B,) in {0, 1}.
    Returns (per-slot grads (B, K), probs (B,), nll (B,)), all f32:

        logit_b   = sum_k vals[b,k] * theta[b,k]
        grad[b,k] = vals[b,k] * (sigmoid(logit_b) - y_b)
        nll_b     = -y_b log sigmoid(logit_b) - (1-y_b) log sigmoid(-logit_b)
    """
    vals = vals.to(torch.float32)
    theta = theta.to(torch.float32)
    logits = torch.sum(vals * theta, dim=-1)
    probs = torch.sigmoid(logits)
    y = labels.to(torch.float32)
    grads = vals * (probs - y)[:, None]
    nll = -(y * log_sigmoid(logits) + (1 - y) * log_sigmoid(-logits))
    return grads, probs, nll


def segment_sum_sorted_ref(ids, grads):
    """Per-feature sums over SORTED ids (the DPMR reduce combiner).

    ids: (N,) int32 sorted ascending, any negative id is padding (sorted
    last upstream); grads: (N,) f32. Returns (N,) f32 holding each run's
    total at the run's LAST slot and 0 everywhere else. The run totals are
    an `index_add_` over run indices, as the JAX oracle's `segment_sum`.
    """
    n = ids.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.float32, device=ids.device)
    valid = ids >= 0
    one = torch.ones((1,), dtype=torch.bool, device=ids.device)
    is_start = torch.cat([one, ids[1:] != ids[:-1]]) & valid
    is_end = torch.cat([ids[:-1] != ids[1:], one]) & valid
    seg = torch.clamp(torch.cumsum(is_start, 0) - 1, min=0)
    g = torch.where(valid, grads.to(torch.float32), 0.0)
    sums = torch.zeros((n,), dtype=torch.float32, device=ids.device)
    sums.index_add_(0, seg, g)
    return torch.where(is_end, sums[seg], 0.0)


def select_pack_ref(send, ids, carry_slots, k: int):
    """The `topk_reduce` compensate + select + pack chain.

    send, carry_slots: (P, cap) f32; ids: (P, cap) int32, negative = an
    empty slot; k from `optim.compression.topk_count`. Per row:

        comp  = send + carry on live slots, 0 on dead ones
        rank  = |comp| descending, ties by position, dead slots last
        ids_k, vals_k = the first k (id, comp) pairs in rank order
                        (vals_k = 0 where ids_k is dead)
        resid = 0 for live winners, comp for every other slot

    Returns (vals_k (P, k) f32, ids_k (P, k) int32, resid (P, cap) f32).
    The ranking is a stable descending sort of the key
    (`compression.topk_select`), which is `lax.top_k`'s order.
    """
    valid = ids >= 0
    comp = torch.where(valid, send + carry_slots, 0.0)
    key = torch.where(valid, torch.abs(comp), -1.0)
    top_idx, top_mask = compression.topk_select(key, k)
    ids_k = torch.gather(ids, 1, top_idx)
    vals_k = torch.where(ids_k >= 0, torch.gather(comp, 1, top_idx), 0.0)
    resid = torch.where(top_mask & valid, 0.0, comp)
    return vals_k, ids_k, resid
