"""`DPMREngine` — the façade over the DPMR sparse core, on one card: the
counterpart of `repro.api.engine`.

    from repro_torch import DPMREngine

    eng = DPMREngine(cfg, hot_ids=hot)     # on the card
    eng.fit_sgd(batches, steps=100)        # minibatch SGD
    eng.fit(batch_iter_fn)                 # paper-regime full-batch GD
    probs = eng.predict(batch)
    metrics = eng.evaluate(test_batches)

The engine runs on the card unless the caller asks for the CPU with
`device="cpu"`; with no card and no such request it raises rather than
carry on on the CPU. Data arguments are iterables of numpy (or tensor)
batch dicts, or a `DataSource` (anything with `batch`, `batch_size` and
`num_batches`), which is read for one epoch. Step functions are built per
global batch size and kept in a small LRU cache. `save`/`restore` and the
`ShardedLoader` come with later slices (ROADMAP queue A).
"""
from __future__ import annotations

from collections.abc import Callable, Iterable
import itertools

import numpy as np
import torch

from repro_torch.api.strategies import get_strategy
from repro_torch.configs.base import DPMRConfig
from repro_torch.core import dpmr, hot_sharding
from repro_torch.core.dpmr import StepFns
from repro_torch.data.sources import DataSource
from repro_torch.device import resolve_device

BATCH_DTYPES = {"ids": torch.int32, "vals": torch.float32,
                "labels": torch.int32}


def put_batch(batch: dict, device) -> dict:
    """Host→device placement of a batch dict, in the kernels' dtypes;
    tensors already on the device in those dtypes pass through."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device,
                                          dtype=BATCH_DTYPES.get(k))
            for k, v in batch.items() if k in BATCH_DTYPES}


def binary_prf_metrics(predict_fn: Callable[[dict], np.ndarray],
                       test_batches: Iterable[dict]) -> dict:
    """Fig. 1 metrics: per-class precision/recall/F + macro average.

    `predict_fn(batch) -> probs`; batches must carry "labels".
    """
    tp = fp = fn_ = tn = 0
    for batch in test_batches:
        pred = (np.asarray(predict_fn(batch)) >= 0.5).astype(np.int32)
        y = np.asarray(batch["labels"].cpu() if torch.is_tensor(
            batch["labels"]) else batch["labels"])
        tp += int(np.sum((pred == 1) & (y == 1)))
        fp += int(np.sum((pred == 1) & (y == 0)))
        fn_ += int(np.sum((pred == 0) & (y == 1)))
        tn += int(np.sum((pred == 0) & (y == 0)))

    def prf(tp, fp, fn):
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        f = 2 * p * r / max(p + r, 1e-9)
        return p, r, f

    p1, r1, f1 = prf(tp, fp, fn_)
    p0, r0, f0 = prf(tn, fn_, fp)
    return {
        "precision_pos": p1, "recall_pos": r1, "f_pos": f1,
        "precision_neg": p0, "recall_neg": r0, "f_neg": f0,
        "precision_avg": (p1 + p0) / 2, "recall_avg": (r1 + r0) / 2,
        "f_avg": (f1 + f0) / 2,
    }


def hot_ids_from_corpus(cfg: DPMRConfig, sample_batches: Iterable[dict], *,
                        device=None) -> torch.Tensor:
    """initParameters-time frequency statistics -> the hot set, counted on
    `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    f = dpmr.padded_features(cfg)
    counts = torch.zeros((f,), dtype=torch.int32, device=dev)
    for b in sample_batches:
        counts += hot_sharding.feature_counts(
            put_batch({"ids": b["ids"]}, dev)["ids"], f)
    return hot_sharding.select_hot(counts, cfg.hot_threshold, cfg.max_hot)


def _is_source(data) -> bool:
    # duck-typed sources count too, as in the reference engine
    return isinstance(data, DataSource) or (
        hasattr(data, "batch") and hasattr(data, "batch_size")
        and hasattr(data, "num_batches"))


def _source_epoch(src):
    if src.num_batches is None:
        raise ValueError(
            "an unbounded DataSource has no epoch: pass steps= (fit_sgd) "
            "or give the source num_batches")
    return (src.batch(i) for i in range(src.num_batches))


class DPMREngine:
    """State + step functions for sparse DPMR on one card.

    Parameters
    ----------
    cfg:         DPMRConfig (features, strategy, optimizer, schedule, ...)
    device:      where state and steps live; None = the card (raises when
                 there is none), "cpu" for the plain versions on the host
    cap_factor:  a2a capacity factor (slots per (src,dst) pair = cap_factor
                 x the uniform mean)
    hot_ids:     Zipf-head ids (see `hot_ids_from_corpus`); None disables
                 hot replication
    state:       resume from an existing DPMRState instead of zeros
    max_cached_fns: LRU bound on the per-batch-size StepFns cache
    """

    def __init__(self, cfg: DPMRConfig, *, device=None,
                 cap_factor: float = 4.0, hot_ids=None,
                 state: dpmr.DPMRState | None = None,
                 max_cached_fns: int = 8):
        self.cfg = cfg
        get_strategy(cfg.distribution)      # raises on one not ported
        self.device = resolve_device(device)
        self.cap_factor = cap_factor
        if max_cached_fns < 1:
            raise ValueError(f"max_cached_fns must be >= 1: {max_cached_fns}")
        self.max_cached_fns = max_cached_fns
        self._fns: dict[int, StepFns] = {}
        self._schedule = dpmr.make_schedule(cfg)
        self.state = state if state is not None else dpmr.init_state(
            cfg, self.device, hot_ids)

    # -- step-function cache -------------------------------------------------

    def step_fns(self, batch_size: int) -> StepFns:
        """StepFns for a given GLOBAL batch size (LRU-cached)."""
        fns = self._fns.pop(batch_size, None)
        if fns is None:
            fns = dpmr.make_step_fns(self.cfg, batch_size,
                                     cap_factor=self.cap_factor)
        self._fns[batch_size] = fns     # move to the end: most recently used
        while len(self._fns) > self.max_cached_fns:
            self._fns.pop(next(iter(self._fns)))     # evict least recent
        return fns

    @property
    def fns(self) -> StepFns:
        """StepFns of the most recently used batch size."""
        if not self._fns:
            raise RuntimeError("no step fns built yet; run a step or "
                               "call engine.step_fns(batch_size)")
        return next(reversed(self._fns.values()))

    def put_batch(self, batch: dict) -> dict:
        return put_batch(batch, self.device)

    def learning_rate(self) -> float:
        """Schedule value at the current step."""
        return float(self._schedule(self.state.step))

    # -- training -----------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One minibatch update; returns host-side metrics."""
        fns = self.step_fns(len(batch["labels"]))
        self.state, m = fns.train_step(self.state, self.put_batch(batch))
        return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
                "overflow": int(m["overflow"])}

    def fit_sgd(self, data, steps: int | None = None) -> list[dict]:
        """Minibatch SGD (one update per batch); returns the history.

        `data`: an iterable of batches or a `DataSource`; `steps` bounds
        the number of updates. `steps=None` trains one epoch of a bounded
        source, or the whole iterable."""
        if _is_source(data):
            batches = (data.batch(i) for i in itertools.count()) \
                if steps is not None and data.num_batches is None \
                else _source_epoch(data)
        else:
            batches = iter(data)
        if steps is not None:
            batches = itertools.islice(batches, steps)
        history: list[dict] = []
        base = int(self.state.step)   # continue numbering across calls
        for i, batch in enumerate(batches):
            m = self.train_step(batch)
            history.append({"step": base + i + 1, **m})
        return history

    def fit(self, data, iterations: int | None = None,
            eval_fn: Callable[[DPMREngine], dict] | None = None
            ) -> list[dict]:
        """Full-batch gradient descent: one update per ITERATION over the
        whole corpus (the paper's regime).

        `data`: a callable yielding the corpus in fixed-size batches each
        time it is called, or a bounded `DataSource` (one epoch per
        iteration)."""
        if _is_source(data):
            batch_iter_fn = lambda: _source_epoch(data)  # noqa: E731
        elif callable(data):
            batch_iter_fn = data
        else:
            raise TypeError("fit() needs a batch_iter_fn callable or a "
                            f"DataSource; got {type(data).__name__}")
        iterations = self.cfg.iterations if iterations is None else iterations
        history: list[dict] = []
        for it in range(iterations):
            acc_cold = torch.zeros_like(self.state.cold)
            acc_hot = torch.zeros_like(self.state.hot)
            tot_loss = tot_acc = 0.0
            nb = 0
            for batch in batch_iter_fn():
                fns = self.step_fns(len(batch["labels"]))
                gc, gh, m = fns.grad_step(self.state, self.put_batch(batch))
                acc_cold += gc
                acc_hot += gh
                tot_loss += float(m["loss"])
                tot_acc += float(m["accuracy"])
                nb += 1
            if nb == 0:
                raise ValueError(
                    "fit(): the corpus yielded no batches in iteration "
                    f"{it + 1}; an empty epoch cannot produce an update")
            self.state = fns.apply_update(
                self.state, acc_cold / nb, acc_hot / nb,
                self.learning_rate())
            rec = {"iteration": it + 1, "loss": tot_loss / nb,
                   "accuracy": tot_acc / nb}
            if eval_fn is not None:
                rec.update(eval_fn(self))
            history.append(rec)
        return history

    # -- inference ----------------------------------------------------------

    def predict(self, batch: dict) -> np.ndarray:
        """Algorithm 9: probabilities for a test batch ({ids, vals})."""
        fns = self.step_fns(len(batch["ids"]))
        probs = fns.predict(self.state, self.put_batch(
            {k: batch[k] for k in ("ids", "vals")}))
        return probs.cpu().numpy()

    def bucket_for(self, n: int, buckets: Iterable[int] | None = None) -> int:
        """The padded batch size `predict_padded` would run `n` rows at.

        Default ladder: the smallest power of two that holds `n` (times
        the shard count, 1 on one card). An explicit `buckets` ladder must
        hold `n`; a larger `n` is an error."""
        p = 1
        if n <= 0:
            raise ValueError(f"batch size must be positive: {n}")
        if buckets is None:
            return p * (1 << (-(-n // p) - 1).bit_length())
        for b in sorted(set(buckets)):
            if b % p:
                raise ValueError(
                    f"bucket {b} is not a multiple of the shard count {p}")
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket in "
            f"{sorted(set(buckets))}")

    def predict_padded(self, batch: dict,
                       buckets: Iterable[int] | None = None) -> np.ndarray:
        """`predict` with the batch padded to a bucketed size with empty
        samples (ids=-1, vals=0), results sliced back to the caller's
        rows; the first `n` probabilities equal `predict(batch)`'s."""
        ids = np.asarray(batch["ids"])
        vals = np.asarray(batch["vals"])
        n = len(ids)
        b = self.bucket_for(n, buckets)
        if b != n:
            pad = b - n
            ids = np.concatenate(
                [ids, np.full((pad, ids.shape[1]), -1, ids.dtype)])
            vals = np.concatenate(
                [vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
        return self.predict({"ids": ids, "vals": vals})[:n]

    def evaluate(self, test_batches) -> dict:
        """Fig. 1 metrics: per-class precision/recall/F + macro average,
        over an iterable of batches or one epoch of a `DataSource`."""
        if _is_source(test_batches):
            test_batches = _source_epoch(test_batches)
        return binary_prf_metrics(self.predict, test_batches)
