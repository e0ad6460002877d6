"""Synthetic Zipf sparse-LR corpus — the paper's data regime, scaled down.

The paper trains on ~20B ad-log samples over ~50B features with a Zipf
frequency profile and a ~3:1 class imbalance (Fig. 1). We generate the same
statistical shape: feature ids ~ Zipf(alpha) over a hashed space, a sparse
ground-truth weight vector, labels ~ Bernoulli(sigmoid(theta* . x + b)) with
b tuned to the target positive rate.

A verbatim copy of `repro.data.sparse_corpus` (numpy only): the port
imports nothing of the JAX package, and its batches must stay
bit-identical to the reference's (tests/test_torch_engine.py checks).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    num_features: int = 1 << 20
    features_per_sample: int = 64    # K (padded CSR width)
    min_features: int = 8
    zipf_alpha: float = 1.2
    signal_features: int = 4096      # features with non-zero true weight
    positive_ratio: float = 0.75     # paper: +1 : -1 roughly 3 : 1
    seed: int = 0


def _zipf_ids(rng: np.random.Generator, spec: CorpusSpec, n: int
              ) -> np.ndarray:
    """Zipf-distributed feature ids in [0, F)."""
    raw = rng.zipf(spec.zipf_alpha, size=n).astype(np.int64)
    # map the unbounded Zipf variate into [0, F) preserving rank order, then
    # hash to decorrelate id and frequency rank (ids are arbitrary strings in
    # the paper; ownership must not align with frequency)
    ranked = (raw - 1) % spec.num_features
    h = (ranked * np.int64(2654435761)) % np.int64(spec.num_features)
    return h.astype(np.int32)


def true_weights(spec: CorpusSpec) -> tuple[np.ndarray, np.ndarray]:
    """(ids, weights) of the sparse ground truth.

    Signal lives on the most FREQUENT features (the Zipf head) — as in real
    CTR logs, where informative features are the common ones; this also makes
    the paper's hot-feature sharding matter for model quality, not just load.
    """
    rng = np.random.default_rng(spec.seed + 7)
    ranks = np.arange(spec.signal_features, dtype=np.int64)
    ids = ((ranks % spec.num_features) * np.int64(2654435761)
           % np.int64(spec.num_features)).astype(np.int32)
    ids = np.unique(ids)
    w = rng.normal(0.0, 2.0, size=ids.shape[0]).astype(np.float32)
    return ids, w


def batch_seed(spec: CorpusSpec, index: int) -> int:
    """THE per-index seeding rule of the Zipf corpus. Single definition —
    `ZipfSparseSource.batch(i)` and the legacy `batches` generator both use
    it, and checkpoint resume-exactness depends on it never diverging."""
    return spec.seed * 100003 + index


def make_batch(spec: CorpusSpec, batch_size: int, seed: int):
    """One padded-CSR batch: dict(ids (B,K), vals (B,K), labels (B,))."""
    rng = np.random.default_rng(seed)
    k = spec.features_per_sample
    ids = _zipf_ids(rng, spec, batch_size * k).reshape(batch_size, k)
    # deduplicate within a row (count repeats as value weight)
    vals = np.ones((batch_size, k), np.float32)
    row_sorted = np.sort(ids, axis=1)
    # variable sample length: mask a suffix
    lens = rng.integers(spec.min_features, k + 1, size=batch_size)
    mask = np.arange(k)[None, :] < lens[:, None]
    ids = np.where(mask, ids, -1).astype(np.int32)
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    # counts normalized like tf-idf-ish scaling to keep logits bounded
    vals = vals / np.sqrt(np.maximum(lens, 1))[:, None].astype(np.float32)

    tid, tw = true_weights(spec)
    wmap = np.zeros(spec.num_features, np.float32)
    wmap[tid] = tw
    logits = (wmap[np.clip(ids, 0, None)] * vals * (ids >= 0)).sum(axis=1)
    # bias for the target class imbalance
    bias = np.log(spec.positive_ratio / (1 - spec.positive_ratio))
    p = 1.0 / (1.0 + np.exp(-(logits + bias)))
    labels = (rng.random(batch_size) < p).astype(np.int32)
    return {"ids": ids, "vals": vals, "labels": labels}
