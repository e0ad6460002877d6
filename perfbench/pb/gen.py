"""The benchmark's traffic generators, made on the device from the seed.

`lm_markov` is rewritten from `repro_torch/data/sources.py` in torch,
and `fields_zipf` draws click-log records field by field with the
Zipf sampler of the program's `zipf_sparse`, so that a pool of batches
is made in a few large calls on the card and the yardstick does not move
when the program's data plane does. The same seed gives the same
batches.

A traffic mix is a data file (`perfbench/traffic/<name>.json`) whose
`generator` names one of `GENERATORS`; the generator reads the rest of
its parameters from that file and from the configuration.
"""
from __future__ import annotations

import math

from pb import common

ZIPF_MAX = 2.0 ** 62     # larger Zipf draws are redrawn (numpy's cap: 2^63)
HASH_MUL = 2654435761    # the id hash: prime, so a bijection mod any F below


def zipf(torch, a: float, n: int, gen, device):
    """`n` Zipf(a) draws (int64, >= 1): numpy's rejection method
    (`random_zipf`), run on every pending draw at once until none is
    left."""
    am1 = a - 1.0
    b = 2.0 ** am1
    umin = ZIPF_MAX ** -am1
    out = torch.empty((n,), dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u01 = torch.rand((m,), dtype=torch.float64, generator=gen,
                         device=device)
        u = u01 * umin + (1.0 - u01)
        v = torch.rand((m,), dtype=torch.float64, generator=gen,
                       device=device)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1.0) & (x < ZIPF_MAX) & (v * x * (t - 1.0) / (b - 1.0)
                                            <= t / b)
        out[todo[ok]] = x[ok].to(torch.int64)
        todo = todo[~ok]
    return out


def fields_zipf(torch, corpus: dict, rows: int, n: int, seed: int, device):
    """`n` padded-CSR click-log batches of `rows` samples each, stacked:
    ids (n, rows, K) int32, vals (n, rows, K) f32, labels (n, rows) int32,
    with K the number of fields (`corpus["fields"]`, each its count of
    distinct values).

    Every sample has one value in each field, as a click log's record
    does (a missing value is a value of its own). A field's value is the
    rank r = (x - 1) mod C of a Zipf(a) draw x, C the field's count; the
    field's ranks follow the fields before it (r + the counts before),
    and that global rank g is hashed to the id g * 2654435761 mod F (a
    bijection: the multiplier is prime and larger than F). Each value is
    1/sqrt(K). The label is Bernoulli(sigmoid(w . x + b)): true weights
    w ~ N(0, signal_weight_std^2) on each field's `signal_per_field`
    most frequent values, and the bias b set so that the pool's mean
    probability is the positive ratio."""
    f = int(corpus["num_features"])
    counts = torch.tensor([int(c) for c in corpus["fields"]],
                          dtype=torch.int64, device=device)
    k = counts.numel()
    if int(counts.sum()) > f:
        raise ValueError("the fields hold more values than the table rows")
    offsets = torch.cumsum(counts, 0) - counts
    gen = common.generator(torch, seed, "traffic.fields_zipf", device)
    total = n * rows
    raw = zipf(torch, float(corpus["zipf_alpha"]), total * k, gen, device)
    ranked = torch.remainder(raw.view(total, k) - 1, counts)
    ids = torch.remainder((ranked + offsets) * HASH_MUL, f).to(torch.int32)
    vals = torch.full((total, k), 1.0 / math.sqrt(k), dtype=torch.float32,
                      device=device)
    signal = int(corpus["signal_per_field"])
    w = torch.randn((k, signal), generator=gen, device=device,
                    dtype=torch.float32) * float(corpus["signal_weight_std"])
    field = torch.arange(k, device=device)
    w_slot = torch.where(ranked < signal,
                         w[field, torch.clamp(ranked, max=signal - 1)], 0.0)
    score = torch.sum(w_slot * vals, dim=1).to(torch.float64)
    bias = _bias_for_ratio(torch, score, float(corpus["positive_ratio"]))
    labels = (torch.rand((total,), generator=gen, device=device,
                         dtype=torch.float64)
              < torch.sigmoid(score + bias)).to(torch.int32)
    return {"ids": ids.view(n, rows, k), "vals": vals.view(n, rows, k),
            "labels": labels.view(n, rows)}


def _bias_for_ratio(torch, score, q: float, iters: int = 60) -> float:
    """The b at which mean(sigmoid(score + b)) is q, by bisection."""
    lo, hi = -40.0, 40.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if float(torch.sigmoid(score + mid).mean()) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def lm_markov(torch, vocab: int, seq: int, rows: int, n: int, seed: int,
              device, branch: int = 8, noise: float = 0.1):
    """`n` language-model batches of `rows` sequences of `seq` tokens,
    stacked: tokens and labels (n, rows, seq) int32, labels the next
    tokens. As `pipeline.LMDataset`: a Markov chain in which each token
    has `branch` likely successors, and with probability `noise` a
    uniform token instead."""
    gen = common.generator(torch, seed, "traffic.lm_markov", device)
    nxt = torch.randint(0, vocab, (vocab * branch,), generator=gen,
                        device=device)
    total = n * rows
    toks = torch.empty((total, seq + 1), dtype=torch.int64, device=device)
    toks[:, 0] = torch.randint(0, vocab, (total,), generator=gen,
                               device=device)
    choice = torch.randint(0, branch, (total, seq), generator=gen,
                           device=device)
    flip = torch.rand((total, seq), generator=gen, device=device) < noise
    rand_tok = torch.randint(0, vocab, (total, seq), generator=gen,
                             device=device)
    for t in range(seq):
        toks[:, t + 1] = torch.where(
            flip[:, t], rand_tok[:, t], nxt[toks[:, t] * branch
                                            + choice[:, t]])
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :-1].reshape(n, rows, seq).contiguous(),
            "labels": toks[:, 1:].reshape(n, rows, seq).contiguous()}


def normal_table(torch, n: int, std: float, seed: int, purpose: str,
                 device, dtype=None):
    """(n,) N(0, std^2) values in one call, from the seed."""
    gen = common.generator(torch, seed, purpose, device)
    out = torch.randn((n,), generator=gen, device=device,
                      dtype=dtype or torch.float32)
    return out.mul_(std)


GENERATORS = {"fields_zipf": fields_zipf, "lm_markov": lm_markov}
