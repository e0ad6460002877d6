"""`DPMRServeEngine` — resident-parameter, micro-batched sparse serving:
the counterpart of `repro.serve.engine`.

The paper's premise is that the parameter table is too large for one node
and must stay DISTRIBUTED; serving therefore keeps the `DPMRState`
resident on the card (or on its P ranks' cards) and streams requests
through the predict step, instead of re-materializing parameters per
call:

    from repro_torch.serve import DPMRServeEngine

    srv = DPMRServeEngine.from_checkpoint(cfg, "/ckpt/dir")   # the card
    fut = srv.submit(ids, vals)          # (r, K) padded-CSR rows
    probs = fut.result()                 # (r,) probabilities
    srv.stop()                           # drains the queue

Three layers under one object:

  MicroBatcher       (serve/batching.py) a thread-safe queue + deadline-
                     aware flusher: requests coalesce until `max_batch`
                     rows or `max_wait_ms`, whichever first.
  predict_padded     the flushed batch pads to a small ladder of bucketed
                     sizes, so the per-batch-size `StepFns` LRU cache gets
                     hits instead of new entries under mixed request sizes.
  HotFeatureCache    (serve/hot_cache.py) requests made entirely of
                     Zipf-head features are answered from a host-mirrored
                     dense slice and never enter the queue at all.

Results come back as per-request futures, bit-identical to what
`engine.predict_padded` returns for the same rows (hot-cache hits
included, while the mirror is fresh — see the staleness contract in
serve/hot_cache.py). All counters live on one `ServeMetrics`
(`srv.metrics_snapshot()`).

During serving, the flusher thread is the only caller into the wrapped
engine's steps; don't train the same engine concurrently from another
thread (train between `stop()`/`start()` instead — the hot cache notices
the step change and refreshes itself).

P ranks. The reference serves a mesh from one controller; here each rank
is a process, and `predict_padded` and the mirror's gather of the
owner-sharded `cold` table are collectives. Rank 0 is the FRONT: it runs
the batcher and the cache, and `submit` on any other rank raises. Every
other rank is a FOLLOWER and runs `serve_follower()`, a loop over the
commands rank 0 broadcasts over the world group (predict a padded batch,
gather the mirror's values, stop), which returns when rank 0 calls
`stop()`. On rank 0 the flusher thread issues every collective, the
mirror gather that a stale lookup needs included (the lookup hands it to
the flusher and waits): collectives of two threads on one group could
reach the ranks in different orders and hang them. An engine with no
process group takes none of this: no broadcast, no extra host work a
flush.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.engine import DPMREngine, pad_rows
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs.base import DPMRConfig
from repro_torch.core import hot_sharding
from repro_torch.launch.mesh import mesh_rank
from repro_torch.serve.batching import BatchingConfig, MicroBatcher
from repro_torch.serve.hot_cache import (
    HotCacheConfig,
    HotFeatureCache,
    owned_values,
)
from repro_torch.serve.metrics import ServeMetrics

# the front's commands to its followers: (command, rows, K) then payload
_PREDICT, _MIRROR, _STOP = 1, 2, 3


class DPMRServeEngine:
    """Resident-parameter serving over a live (or restored) `DPMREngine`.

    Parameters
    ----------
    engine:     the wrapped `DPMREngine`; its state stays resident for the
                lifetime of the server
    batching:   `BatchingConfig` (max_batch / max_wait_ms / pad buckets)
    hot_cache:  `HotCacheConfig`, or None to disable the Zipf-head fast
                path entirely
    start:      start the flusher immediately (default); with False, call
                `start()` before submitting. A follower rank has no
                flusher: it calls `serve_follower()`
    """

    def __init__(self, engine: DPMREngine, *,
                 batching: BatchingConfig | None = None,
                 hot_cache: HotCacheConfig | None = HotCacheConfig(),
                 start: bool = True):
        self.engine = engine
        self.batching = batching or BatchingConfig()
        self.metrics = ServeMetrics()
        self._k = int(engine.cfg.max_features_per_sample)
        self._grouped = engine.mesh is not None
        self.rank = mesh_rank(engine.mesh)
        self._followers_serving = False
        self._batcher = MicroBatcher(self._predict_flush, self.batching,
                                     self.metrics)
        self.cache = None if hot_cache is None else HotFeatureCache(
            engine, hot_cache, self.metrics,
            gather=self._gather_on_flusher if self._grouped else None)
        if start:
            self.start()

    @classmethod
    def from_checkpoint(cls, cfg: DPMRConfig, directory: str, *,
                        device=None, mesh=None, step: int | None = None,
                        **kw) -> DPMRServeEngine:
        """Restore-into-serving: build an engine on `device` (the card
        unless "cpu"), on `mesh` at P ranks (every rank calls this),
        restore the sparse checkpoint at `directory` into it (written by
        either package), and serve it.

        Fails loudly when pointed at a non-sparse checkpoint (e.g. a dense
        LM checkpoint) — the manifest must carry `kind == "dpmr_sparse"`,
        which `DPMREngine.save` writes."""
        ck = Checkpointer(directory)
        at = ck.latest_step() if step is None else step
        if at is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        with open(os.path.join(directory, f"step_{at:010d}",
                               "manifest.json")) as f:
            kind = json.load(f).get("extra", {}).get("kind")
        if kind != "dpmr_sparse":
            raise ValueError(
                f"{directory} step {at} is not a sparse DPMR checkpoint "
                f"(manifest kind={kind!r}); the sparse serving engine "
                "cannot serve a dense LM state — use the dense serve path "
                "for that")
        engine = DPMREngine(cfg, device=device, mesh=mesh)
        with warnings.catch_warnings():
            # serving never resumes the training data stream; the engine's
            # "checkpoint carries a data cursor but no loader" warning is
            # noise here (strategy/topk mismatch warnings still surface)
            warnings.filterwarnings("ignore", message=".*data cursor.*",
                                    category=RuntimeWarning)
            engine.restore(directory, step=step)
        return cls(engine, **kw)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> DPMRServeEngine:
        """Start the flusher (rank 0 only: a follower serves through
        `serve_follower`, and this is a no-op there). At P ranks the
        followers must be in `serve_follower()` to answer."""
        if self.rank == 0:
            self._batcher.start()
            self._followers_serving = self._grouped
        return self

    def stop(self) -> None:
        """Drain the queue (every accepted request is answered) and stop
        the flusher; at P ranks then release the followers. Idempotent;
        the engine state stays resident, so `start()` serves again (with
        the followers back in `serve_follower()`)."""
        self._batcher.stop()
        if self._followers_serving:
            # the flusher has been joined: this thread is now the only one
            # issuing collectives on rank 0
            self._command(_STOP, 0, 0)
            self._followers_serving = False

    def __enter__(self) -> DPMRServeEngine:
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path -------------------------------------------------------

    def submit(self, ids, vals) -> concurrent.futures.Future:
        """Queue one request of (r, K') sparse rows; K' <= the engine's
        max_features_per_sample (short rows are padded). Returns a Future
        of the (r,) probabilities. Thread-safe; rank 0 only."""
        if self.rank != 0:
            raise RuntimeError(
                f"rank {self.rank} is a follower: requests go to rank 0, "
                "and this rank runs serve_follower()")
        t0 = time.monotonic()
        ids, vals = self._conform(ids, vals)
        self.metrics.count("requests")
        self.metrics.count("samples", len(ids))
        if self.cache is not None:
            self.cache.observe(ids)
            probs = self.cache.lookup(ids, vals)
            if probs is not None:
                fut: concurrent.futures.Future = concurrent.futures.Future()
                fut.set_result(probs)
                self.metrics.record_latency(time.monotonic() - t0)
                return fut
        return self._batcher.submit(ids, vals)

    def predict(self, batch: dict) -> np.ndarray:
        """Synchronous convenience: submit the batch as ONE request (it
        still coalesces with concurrent traffic) and wait for its result."""
        return np.asarray(self.submit(batch["ids"], batch["vals"]).result())

    def _conform(self, ids, vals) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        if ids.ndim == 1:
            ids, vals = ids[None, :], vals[None, :]
        if ids.ndim != 2 or ids.shape != vals.shape:
            raise ValueError(
                f"request must be (rows, K) id/val pairs of one shape; got "
                f"ids {ids.shape} vals {vals.shape}")
        k = ids.shape[1]
        if k > self._k:
            raise ValueError(
                f"request has {k} features per sample but the engine "
                f"was built for max_features_per_sample={self._k}")
        if k < self._k:
            pad = self._k - k
            ids = np.concatenate(
                [ids, np.full((len(ids), pad), -1, np.int32)], axis=1)
            vals = np.concatenate(
                [vals, np.zeros((len(vals), pad), np.float32)], axis=1)
        return ids, vals

    # -- flusher side -------------------------------------------------------

    def _predict_flush(self, ids: np.ndarray,
                       vals: np.ndarray) -> np.ndarray:
        """The MicroBatcher's predict_fn: one coalesced micro-batch through
        the bucket-padded predict step (flusher thread only)."""
        n = len(ids)
        b = self.engine.bucket_for(n, self.batching.buckets)
        self.metrics.record_flush(n, b)
        if not self._grouped:
            return self.engine.predict_padded({"ids": ids, "vals": vals},
                                              self.batching.buckets)
        ids, vals = pad_rows(ids, vals, b)
        batch = self._command(_PREDICT, *ids.shape, ids=ids, vals=vals)
        return self.engine.predict(batch)[:n]

    def _gather_on_flusher(self, sel: torch.Tensor) -> torch.Tensor:
        """The cache's gather at P ranks: the collective, on the flusher."""
        def gather():
            self._command(_MIRROR, sel.numel(), 0, sel=sel)
            return self._gather_owned(sel)

        return self._batcher.run_on_flusher(gather)

    # -- the ranks' protocol ------------------------------------------------

    def _command(self, cmd: int, rows: int, k: int, **payload) -> dict:
        """Rank 0: broadcast (cmd, rows, k) and then the payload's arrays,
        in keyword order, over the world group; returns the payload as
        tensors on the group's device."""
        dev = self.engine.device
        dist.broadcast(torch.tensor([cmd, rows, k], dtype=torch.int64,
                                    device=dev), src=0)
        out = {}
        for name, a in payload.items():
            t = torch.as_tensor(a).to(dev)
            dist.broadcast(t, src=0)
            out[name] = t
        return out

    def _receive(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=self.engine.device)
        dist.broadcast(t, src=0)
        return t

    def _gather_owned(self, sel: torch.Tensor) -> torch.Tensor:
        """Every rank: the mirror's values of `sel` from their owners, an
        all_gather of each rank's owned values, each id's taken from its
        owner's row (not summed, so a -0.0 stays -0.0)."""
        state = self.engine.state
        mine = owned_values(state, sel, self.rank)
        parts = mine.new_empty((self.engine.num_shards * mine.numel(),))
        dist.all_gather_into_tensor(parts, mine.contiguous())
        parts = parts.view(self.engine.num_shards, mine.numel())
        safe = torch.where(sel != hot_sharding.INT_MAX, sel, 0)
        owner = (safe // state.cold.shape[0]).to(torch.int64)
        return parts[owner, torch.arange(sel.numel(), device=sel.device)]

    def serve_follower(self) -> None:
        """The loop of every rank but 0 at P ranks: answer rank 0's
        commands until it calls `stop()`."""
        if self.rank == 0:
            raise RuntimeError("rank 0 is the front: it serves through "
                               "submit(), not serve_follower()")
        while True:
            cmd, rows, k = self._receive((3,), torch.int64).tolist()
            if cmd == _STOP:
                return
            if cmd == _PREDICT:
                self.engine.predict({
                    "ids": self._receive((rows, k), torch.int32),
                    "vals": self._receive((rows, k), torch.float32)})
            elif cmd == _MIRROR:
                self._gather_owned(self._receive((rows,), torch.int32))
            else:
                raise RuntimeError(f"unknown serving command {cmd}")

    # -- introspection ------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._batcher.queue_depth

    def metrics_snapshot(self) -> dict:
        """Counters + latency percentiles + cache/batching stats, plus the
        engine's count of cached step functions (one per padded batch
        size: the gauge of the bucket ladder)."""
        out = self.metrics.snapshot()
        out["compiled_step_fns"] = len(self.engine._fns)
        return out
