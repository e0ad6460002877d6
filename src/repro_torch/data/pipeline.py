"""Deterministic, resumable synthetic LM data pipeline: a copy of
`repro.data.pipeline` (numpy only), whose batches are bit-identical to the
reference's for the same config and step.

Every batch is a pure function of (seed, step): resuming a failed run at
step k reproduces exactly the batches a healthy run would have seen (the
iterator state is just the integer step stored in the checkpoint). Documents
are Markov-chain token streams packed to seq_len with next-token labels —
enough structure for loss to move in the integration tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class LMDataset:
    """Seekable synthetic dataset: `batch(step)` is pure."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse-ish Markov transition structure (each token -> 8 likely next)
        self._next = rng.integers(0, v, size=(v, 8)).astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choice = rng.integers(0, 8, size=(b, s))
        noise = rng.random((b, s)) < 0.1
        rand_tok = rng.integers(0, cfg.vocab_size, size=(b, s))
        for t in range(s):
            nxt = self._next[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    # a resumable stream of these: get_source("lm_markov", vocab_size=V,
    # seq_len=S, batch_size=B) behind a repro_torch.data.ShardedLoader


def encdec_batch(ds: LMDataset, step: int, d_model: int) -> dict:
    """Whisper-style batch: stub frame embeddings + target tokens."""
    base = ds.batch(step)
    b, s = base["tokens"].shape
    rng = np.random.default_rng(np.random.SeedSequence([ds.cfg.seed, step, 7]))
    frames = rng.normal(0, 1, size=(b, s, d_model)).astype(np.float32)
    return {"frames": frames, **base}
