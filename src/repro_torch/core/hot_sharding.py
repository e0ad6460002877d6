"""Zipf hot-feature handling (paper §4, adapted): the counterpart of
`repro.core.hot_sharding`.

Features above a frequency threshold are replicated on every device and
their gradients reduce over all of them; only the Zipf tail goes through
the a2a routing. `select_hot` is the initParameters-time frequency
statistic.
"""
from __future__ import annotations

import torch

INT_MAX = 2 ** 31 - 1


def feature_counts(ids: torch.Tensor, num_features: int) -> torch.Tensor:
    """(num_features,) int32 histogram of feature occurrences. ids: any
    shape, -1 = padding; ids outside [0, num_features) are dropped."""
    flat = ids.reshape(-1)
    keep = (flat >= 0) & (flat < num_features)
    counts = torch.zeros((num_features,), dtype=torch.int32,
                         device=ids.device)
    return counts.index_add_(0, torch.where(keep, flat, 0),
                             keep.to(torch.int32))


def select_hot(counts: torch.Tensor, threshold: float, max_hot: int
               ) -> torch.Tensor:
    """Pick features with frequency above `threshold`, capped at max_hot.

    Returns (max_hot,) int32 sorted ascending, padded with INT_MAX so
    searchsorted stays valid. The ranking is `lax.top_k`'s order
    (descending count, ties to the lower id), which a stable descending
    sort gives and `torch.topk` does not promise.
    """
    total = torch.clamp(torch.sum(counts), min=1)
    freq = counts.to(torch.float32) / total.to(torch.float32)
    score = torch.where(freq >= threshold, counts, -1)
    top_counts, top_ids = torch.sort(score, descending=True, stable=True)
    top_counts, top_ids = top_counts[:max_hot], top_ids[:max_hot]
    ids = torch.where(top_counts > 0, top_ids, INT_MAX)
    return torch.sort(ids).values.to(torch.int32)


def split_hot(ids_flat: torch.Tensor, hot_ids: torch.Tensor):
    """Partition flat ids into hot/cold.

    Returns (hot_slot (n,) int32 index into hot_ids or -1,
             is_hot (n,) bool,
             cold_ids (n,) int32 with hot & padding replaced by -1).
    """
    pos = torch.searchsorted(hot_ids, ids_flat, out_int32=True)
    pos_c = torch.clamp(pos, 0, hot_ids.shape[0] - 1)
    is_hot = (hot_ids[pos_c] == ids_flat) & (ids_flat >= 0)
    hot_slot = torch.where(is_hot, pos_c, -1)
    cold_ids = torch.where(is_hot | (ids_flat < 0), -1, ids_flat)
    return hot_slot, is_hot, cold_ids


def load_imbalance(ids_flat: torch.Tensor, num_shards: int,
                   block_size: int) -> torch.Tensor:
    """max/mean owner load for this rank's cold ids (skew diagnostic);
    padding ids (< 0) count for no owner."""
    owner = torch.where(ids_flat >= 0, ids_flat // block_size, num_shards)
    counts = torch.bincount(owner.to(torch.int64).reshape(-1),
                            minlength=num_shards + 1)[:num_shards]
    mean = torch.clamp(torch.mean(counts.to(torch.float32)), min=1e-6)
    return torch.max(counts).to(torch.float32) / mean
