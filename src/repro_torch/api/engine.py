"""`DPMREngine` — the façade over the DPMR sparse core: the counterpart
of `repro.api.engine`.

    from repro_torch import DPMREngine

    eng = DPMREngine(cfg, hot_ids=hot)     # on the card
    eng.fit_sgd(batches, steps=100)        # minibatch SGD
    eng.fit(batch_iter_fn)                 # paper-regime full-batch GD
    probs = eng.predict(batch)
    metrics = eng.evaluate(test_batches)
    eng.save("/ckpt/dir"); eng.restore("/ckpt/dir")

The data arguments of `fit`, `fit_sgd` and `evaluate` take, besides plain
iterables, anything of the data plane (`repro_torch.data`): a
`ShardedLoader`, a `DataSource`, or a registered source name with `spec=`
kwargs, which the engine reads through a loader of its own:

    eng.fit_sgd("zipf_sparse", steps=40,
                spec=dict(batch_size=512, num_features=1 << 14))

A loader's resumable cursor rides along in `save()`/`restore()` extras,
so a restored engine and loader continue the exact batch stream an
uninterrupted run would have seen.

Given a `DeviceMesh` (`launch.mesh.make_host_mesh`), every rank of it
runs the same calls: each rank keeps its own block of the feature table,
takes its own rows of every GLOBAL batch (`put_batch`) or is handed them
already cut (a `data.loader.RankBatch`: the loader's placement, or a rank
that reads only its own host's rows), the strategies' collectives join
the ranks, and `predict`, `predict_padded` and `evaluate` give every rank
the whole batch's results. `save` is a collective too; rank 0 writes.

The engine runs on the card unless the caller asks for the CPU with
`device="cpu"`; with no card and no such request it raises rather than
carry on on the CPU. Step functions are built per global batch size and
kept in a small LRU cache. The steps update the state's tensors in place
(`core.dpmr`), so `save(block=False)` snapshots them on the stream before
the next step can write them (`ckpt.checkpointer`). Each device value
that `train_step`, `fit`, `learning_rate` and `host_step` read back to
the host counts once in the `obs` counter `host_reads`.
"""
from __future__ import annotations

from collections.abc import Callable, Iterable
import itertools
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.strategies import (
    _all_gather,
    get_strategy,
    list_strategies,
)
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs.base import DPMRConfig
from repro_torch.convert import SHARDED, state_from_numpy
from repro_torch.core import dpmr, hot_sharding
from repro_torch.core.dpmr import StepFns
from repro_torch.data import DataSource, ShardedLoader, get_source
from repro_torch.data.loader import RankBatch, put_sharded
from repro_torch.device import resolve_device
from repro_torch.runtime import multiprocess
from repro_torch.runtime.elastic import reshard_dpmr_state


def put_batch(batch: dict, device, mesh=None) -> RankBatch:
    """Host→device placement of this rank's rows of a global batch dict,
    in the kernels' dtypes: rows [r·B/P, (r+1)·B/P) on rank r of `mesh`
    (all of them without one). A `RankBatch` (a loader placed it, or a
    rank read only its own rows) passes through. Raises when the rows do
    not split evenly over the P ranks.

    Delegates to `data.loader.put_sharded`, the one definition the
    loader's "sharded" placement also uses."""
    return put_sharded(batch, device, mesh)


def pad_rows(ids: np.ndarray, vals: np.ndarray, rows: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """(n, K) host ids and vals padded to `rows` rows with empty samples
    (ids -1, vals 0), which every step reads as no feature."""
    pad = rows - len(ids)
    if pad:
        ids = np.concatenate(
            [ids, np.full((pad, ids.shape[1]), -1, ids.dtype)])
        vals = np.concatenate(
            [vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
    return ids, vals


def _global_rows(batch: dict, key: str) -> int:
    """The GLOBAL batch size a batch dict stands for."""
    if isinstance(batch, RankBatch):
        return batch.global_size
    return len(batch[key])


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
                        device=None, num_shards: int = 1) -> torch.Tensor:
    """initParameters-time frequency statistics -> the hot set, counted on
    `device` (the card unless the caller asks for the CPU) over the
    feature space padded for `num_shards` ranks. Every rank counts the
    same global batches, so every rank gets the same replicated set."""
    dev = resolve_device(device)
    f = dpmr.padded_features(cfg, num_shards)
    counts = torch.zeros((f,), dtype=torch.int32, device=dev)
    for b in sample_batches:
        counts += hot_sharding.feature_counts(
            put_batch({"ids": b["ids"]}, dev)["ids"], f)
    return hot_sharding.select_hot(counts, cfg.hot_threshold, cfg.max_hot)


class DPMREngine:
    """State + step functions + checkpointing for sparse DPMR on one rank.

    Parameters
    ----------
    cfg:         DPMRConfig (features, strategy, optimizer, schedule, ...);
                 `distribution="auto"` resolves through the autotuner
                 (`core.dpmr.resolve_distribution`)
    device:      where state and steps live; None = the card (raises when
                 there is none), "cpu" for the plain versions on the host
    mesh:        torch DeviceMesh (`launch.mesh.make_host_mesh`) whose
                 ranks are the DPMR nodes, each holding samples and
                 parameters; None = one rank and no process group. A mesh
                 over NCCL needs a CUDA device, one over gloo the CPU
    cap_factor:  a2a capacity factor (slots per (src,dst) pair = cap_factor
                 x the uniform mean)
    hot_ids:     Zipf-head ids (see `hot_ids_from_corpus`); None disables
                 hot replication
    state:       resume from an existing DPMRState instead of zeros
    max_cached_fns: LRU bound on the per-batch-size StepFns cache
    """

    def __init__(self, cfg: DPMRConfig, *, device=None, mesh=None,
                 cap_factor: float = 4.0, hot_ids=None,
                 state: dpmr.DPMRState | None = None,
                 max_cached_fns: int = 8):
        self.cfg = cfg
        # raises on an unknown name; "auto" resolves to a registered one
        get_strategy(dpmr.resolve_distribution(cfg, mesh))
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run an "
                             f"engine on {self.device}")
        self.mesh = mesh
        self.num_shards = dpmr.num_shards(mesh)
        self.cap_factor = cap_factor
        if max_cached_fns < 1:
            raise ValueError(f"max_cached_fns must be >= 1: {max_cached_fns}")
        self.max_cached_fns = max_cached_fns
        self._fns: dict[int, StepFns] = {}
        self._checkpointers: dict[str, Checkpointer] = {}
        self._loader: ShardedLoader | None = None
        self._schedule = dpmr.make_schedule(cfg)
        self.state = state if state is not None else dpmr.init_state(
            cfg, self.device, hot_ids, mesh)

    # -- state --------------------------------------------------------------

    @property
    def state(self) -> dpmr.DPMRState:
        return self._state

    @state.setter
    def state(self, value: dpmr.DPMRState) -> None:
        self._state = value
        self._step = None       # read from the device when next asked for

    def host_step(self) -> int:
        """`state.step` as a host int. The engine counts its own updates,
        so asking after a step does not wait for the device (`save` must
        not); it reads the device only after `state` was replaced."""
        if self._step is None:
            self._step = int(self._state.step)
            obs.count("host_reads")
        return self._step

    def _stepped(self) -> None:
        if self._step is not None:
            self._step += 1

    # -- step-function cache -------------------------------------------------

    def step_fns(self, batch_size: int) -> StepFns:
        """StepFns for a given GLOBAL batch size (LRU-cached)."""
        fns = self._fns.pop(batch_size, None)
        if fns is None:
            fns = dpmr.make_step_fns(self.cfg, batch_size, mesh=self.mesh,
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

    def put_batch(self, batch: dict) -> RankBatch:
        return put_batch(batch, self.device, self.mesh)

    def learning_rate(self) -> float:
        """Schedule value at the current step."""
        obs.count("host_reads")
        return float(self._schedule(self.state.step))

    # -- data-plane resolution ----------------------------------------------

    def _as_loader(self, data, spec: dict | None) -> ShardedLoader | None:
        """Normalize a data argument to a ShardedLoader when it comes from
        the data plane (loader | DataSource | registered source name);
        None for plain iterables and callables."""
        # engine-built loaders are pinned to one stream (host 0 of 1):
        # every rank reads the same global batches and cuts its rows; a
        # rank that reads only its own host's rows needs a ShardedLoader
        # of its own (cf. launch/train.py)
        if isinstance(data, str):
            return ShardedLoader(get_source(data, **(spec or {})), self.mesh,
                                 device=self.device, host_index=0,
                                 num_hosts=1)
        if spec is not None:
            # anything non-str never reads spec; dropping it silently would
            # train on a differently configured source than the caller asked
            raise TypeError("spec= is only meaningful with a source NAME; "
                            f"got {type(data).__name__}: configure the "
                            "source/loader directly instead")
        if isinstance(data, ShardedLoader):
            return data
        # duck-typed sources count too: register_source only requires
        # batch(index) / batch_size / num_batches, not the base class
        if isinstance(data, DataSource) or (
                hasattr(data, "batch") and hasattr(data, "batch_size")
                and hasattr(data, "num_batches")):
            return ShardedLoader(data, self.mesh, device=self.device,
                                 host_index=0, num_hosts=1)
        return None

    # -- training -----------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One minibatch update; returns host-side metrics."""
        fns = self.step_fns(_global_rows(batch, "labels"))
        self._state, m = fns.train_step(self._state, self.put_batch(batch))
        self._stepped()
        obs.count("host_reads", 3)
        return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
                "overflow": int(m["overflow"])}

    def fit_sgd(self, data, steps: int | None = None, *,
                spec: dict | None = None) -> list[dict]:
        """Minibatch SGD (one update per batch); returns the history.

        `data`: an iterable of batches, a `ShardedLoader`, a `DataSource`,
        or a registered source name (+ `spec` kwargs). With a loader,
        batches arrive prefetched and placed, and its cursor tracks
        progress for exact resume; `steps` bounds the number of updates,
        rolling over into later epochs. `steps=None` on a bounded loader
        trains the remainder of the current epoch; on an unbounded one it
        is an error rather than an infinite loop."""
        loader = self._as_loader(data, spec)
        if loader is not None:
            self._loader = loader
            if steps is None and loader.steps_per_epoch is None:
                raise ValueError(
                    "fit_sgd over an unbounded loader needs steps= (or give "
                    "the loader an epoch_size)")
            batches = loader.batches(steps) if steps is not None \
                else loader.epoch()
        else:
            batches = iter(data) if steps is None else \
                itertools.islice(iter(data), steps)
        history: list[dict] = []
        base = self.host_step()   # continue numbering across resumes
        for i, batch in enumerate(batches):
            m = self.train_step(batch)
            history.append({"step": base + i + 1, **m})
        return history

    def fit(self, data, iterations: int | None = None,
            eval_fn: Callable[[DPMREngine], dict] | None = None, *,
            spec: dict | None = None) -> list[dict]:
        """Full-batch gradient descent: one update per ITERATION over the
        whole corpus (the paper's regime).

        `data`: a callable yielding the corpus in fixed-size batches each
        time it is called, or a `ShardedLoader` / `DataSource` / source
        name (+ `spec`); then each iteration consumes one FULL loader
        epoch (a mid-epoch cursor is rewound to its epoch start, so every
        update averages the whole corpus; the cursor's epoch counts
        iterations)."""
        loader = self._as_loader(data, spec)
        if loader is not None:
            self._loader = loader
            batch_iter_fn = lambda: loader.epoch(from_start=True)  # noqa: E731
        elif callable(data):
            batch_iter_fn = data
        else:
            raise TypeError(
                "fit() needs a batch_iter_fn callable, a ShardedLoader, a "
                f"DataSource, or a source name; got {type(data).__name__}")
        iterations = self.cfg.iterations if iterations is None else iterations
        history: list[dict] = []
        for it in range(iterations):
            acc_cold = torch.zeros_like(self.state.cold)
            acc_hot = torch.zeros_like(self.state.hot)
            tot_loss = tot_acc = 0.0
            nb = 0
            for batch in batch_iter_fn():
                fns = self.step_fns(_global_rows(batch, "labels"))
                gc, gh, m = fns.grad_step(self.state, self.put_batch(batch))
                acc_cold += gc
                acc_hot += gh
                tot_loss += float(m["loss"])
                tot_acc += float(m["accuracy"])
                obs.count("host_reads", 2)
                nb += 1
            if nb == 0:
                raise ValueError(
                    "fit(): the corpus yielded no batches in iteration "
                    f"{it + 1}; an empty epoch cannot produce an update")
            self._state = fns.apply_update(
                self._state, acc_cold / nb, acc_hot / nb,
                self.learning_rate())
            self._stepped()
            rec = {"iteration": it + 1, "loss": tot_loss / nb,
                   "accuracy": tot_acc / nb}
            if eval_fn is not None:
                rec.update(eval_fn(self))
            history.append(rec)
        return history

    # -- inference ----------------------------------------------------------

    def predict(self, batch: dict) -> np.ndarray:
        """Algorithm 9: probabilities for a test batch ({ids, vals}); every
        rank gets the whole batch's (an all_gather of the ranks' rows)."""
        fns = self.step_fns(_global_rows(batch, "ids"))
        probs = fns.predict(self.state, self.put_batch(batch))
        return _all_gather(probs, fns.ctx).cpu().numpy()

    def bucket_for(self, n: int, buckets: Iterable[int] | None = None) -> int:
        """The padded batch size `predict_padded` would run `n` rows at.

        Default ladder: the smallest power-of-two multiple of the shard
        count P that holds `n` (P, 2P, 4P, ...). An explicit `buckets`
        ladder must be multiples of P and hold `n`; a larger `n` is an
        error."""
        p = self.num_shards
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
        ids, vals = np.asarray(batch["ids"]), np.asarray(batch["vals"])
        n = len(ids)
        ids, vals = pad_rows(ids, vals, self.bucket_for(n, buckets))
        return self.predict({"ids": ids, "vals": vals})[:n]

    def evaluate(self, test_batches, *, spec: dict | None = None) -> dict:
        """Fig. 1 metrics: per-class precision/recall/F + macro average.

        `test_batches`: an iterable of batches, or a `ShardedLoader` /
        `DataSource` / source name (+ `spec`); then one full epoch of the
        test source is scored, and the loader's cursor is left where it
        was (repeatable, and safe on a training loader whose resume
        position save() will persist)."""
        loader = self._as_loader(test_batches, spec)
        if loader is None:
            return binary_prf_metrics(self.predict, test_batches)
        mark = loader.cursor

        def scored():
            # a placed batch holds this rank's rows; predict gives every
            # rank the whole batch's probabilities, so gather the labels
            for b in loader.epoch(from_start=True):
                labels = b["labels"]
                if isinstance(b, RankBatch):
                    labels = multiprocess.host_value(labels, self.mesh)
                yield {"probs": self.predict(b), "labels": labels}

        try:
            return binary_prf_metrics(lambda d: d["probs"], scored())
        finally:
            loader.seek(mark)

    # -- checkpointing -------------------------------------------------------

    def _checkpointer(self, directory: str, keep: int = 3) -> Checkpointer:
        """One long-lived Checkpointer per directory: `save(block=False)`
        hands its write thread (and its pinned buffers) to an object that
        survives until the next save, which joins it; a throwaway instance
        per call would orphan the thread and allow two writers."""
        ck = self._checkpointers.get(directory)
        if ck is None:
            ck = self._checkpointers[directory] = Checkpointer(
                directory, keep=keep)
        ck.keep = keep
        return ck

    def wait_saves(self) -> None:
        """Join any in-flight async checkpoint writes (call before process
        exit; `save(block=True)` and every later save also join)."""
        for ck in self._checkpointers.values():
            ck.wait()

    def save(self, directory: str, *, keep: int = 3, block: bool = True,
             loader: ShardedLoader | None = None) -> int:
        """Atomic checkpoint of the sparse state; returns the step saved.

        `block=False` enqueues the device->host snapshot on the stream and
        returns without waiting for the device; the write runs on a
        thread. The training loop may update the state in place at once:
        stream order runs the snapshot first. On a mesh every rank must
        call this (the gather is a collective); rank 0 writes.

        The data cursor of `loader` (default: the last loader handed to
        fit/fit_sgd) is kept in the manifest's extras, so restore resumes
        the exact batch stream."""
        loader = loader if loader is not None else self._loader
        step = self.host_step()
        # record the RESOLVED strategy name: under distribution="auto" the
        # carry in DPMRState.strat belongs to whatever the autotuner picked
        extra = {"kind": "dpmr_sparse",
                 "distribution": dpmr.resolve_distribution(self.cfg,
                                                           self.mesh),
                 "topk_frac": self.cfg.topk_frac,
                 "optimizer": self.cfg.optimizer,
                 "num_features": self.cfg.num_features}
        if loader is not None:
            extra["data"] = loader.state_dict()
        self._checkpointer(directory, keep).save(
            step, self.state, block=block, extra=extra, mesh=self.mesh)
        return step

    def _global_shapes(self) -> list[tuple]:
        """The live state's leaves' GLOBAL shapes (as saved)."""
        p = self.num_shards
        return [(t.shape[0] * p,) if name in SHARDED else tuple(t.shape)
                for name, t in zip(dpmr.DPMRState._fields, self.state,
                                   strict=True)]

    def restore(self, directory: str, step: int | None = None, *,
                loader: ShardedLoader | None = None,
                on_host_change: str = "error") -> dict:
        """Restore the state (latest step by default); returns the
        checkpoint manifest. Every rank reads the full arrays and takes
        its blocks.

        If the checkpoint carries a data cursor and a loader is at hand
        (`loader=` or the engine's attached one), the loader is sought to
        it, so training continues on the exact next batch.
        `on_host_change="reassign"` accepts a cursor recorded under a
        different data-plane host count: ownership is recomputed for the
        new geometry and the stream resumes at the epoch boundary.

        If the checkpoint was written at a DIFFERENT rank count (the
        table's padded length no longer matches this engine's mesh), the
        state is re-padded through `runtime/elastic.py::reshard_dpmr_state`
        instead of cut blind: the strategy carry resets, and the hot-set
        geometry (cfg.max_hot) must match."""
        ck = self._checkpointer(directory, keep=3)
        # no rank may read before rank 0 has finished writing
        self.wait_saves()
        multiprocess.barrier()
        arrs, manifest = ck.restore_host(step)
        if len(arrs) != len(self.state):
            raise ValueError(
                f"checkpoint has {len(arrs)} leaves, the engine state "
                f"{len(self.state)}: not a {manifest['extra'].get('kind')} "
                "checkpoint for this state structure")
        if [tuple(s) for s in manifest["shapes"]] == self._global_shapes():
            self.state = state_from_numpy(arrs, self.device, self.mesh)
        else:
            self.state = reshard_dpmr_state(arrs, self.cfg, self.mesh,
                                            self.device)
        saved_dist = manifest.get("extra", {}).get("distribution")
        if saved_dist is not None and saved_dist not in list_strategies():
            # a registry KeyError here would name nothing useful; the
            # common culprit is a composition (or other user-registered
            # strategy) of the saving session that this process never
            # registered
            raise ValueError(
                f"checkpoint was trained with distribution strategy "
                f"{saved_dist!r}, which is not registered in this "
                "process: register it first (register_strategy / "
                "register_composition; a session-local composition "
                "does not register on import). Registered: "
                f"{list_strategies()}")
        mine = dpmr.resolve_distribution(self.cfg, self.mesh)
        if saved_dist is not None and saved_dist != mine:
            warnings.warn(
                f"checkpoint was trained with distribution={saved_dist!r} "
                f"but this engine uses {mine!r}; the "
                "persistent strategy carry (DPMRState.strat) may be "
                "meaningless or mis-shaped for the new strategy",
                RuntimeWarning, stacklevel=2)
        saved_frac = manifest.get("extra", {}).get("topk_frac")
        if (mine == "topk_reduce"
                and saved_dist == "topk_reduce"
                and saved_frac is not None
                and saved_frac != self.cfg.topk_frac):
            warnings.warn(
                f"checkpoint carries a topk_reduce residual accumulated at "
                f"topk_frac={saved_frac} but this engine sparsifies at "
                f"{self.cfg.topk_frac}; training stays correct (error "
                "feedback re-injects it) but the first steps flush a "
                "residual sized for the old k",
                RuntimeWarning, stacklevel=2)
        if loader is not None:
            self._loader = loader      # attach even for cursor-less ckpts,
        else:                          # so the NEXT save records a cursor
            loader = self._loader
        data_state = manifest.get("extra", {}).get("data")
        if data_state is not None:
            if loader is not None:
                loader.load_state_dict(data_state,
                                       on_host_change=on_host_change)
            else:
                warnings.warn(
                    "checkpoint carries a data cursor "
                    f"{data_state.get('cursor')} but no loader is attached; "
                    "pass loader= (or seek your loader to this cursor) or "
                    "training will replay already-consumed batches",
                    RuntimeWarning, stacklevel=2)
        return manifest
