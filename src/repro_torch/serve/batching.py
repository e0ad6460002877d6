"""Deadline-aware micro-batch coalescing for the sparse serving engine:
the counterpart of `repro.serve.batching`.

Requests (small `{ids, vals}` row groups) enter a thread-safe queue; a
single flusher thread coalesces them into micro-batches and hands each
batch to a `predict_fn`. A batch flushes when either

  - the pending rows reach `max_batch` (a full batch), or
  - `max_wait_ms` has elapsed since the OLDEST pending request arrived
    (the deadline — a lone request never waits longer than the window), or
  - the batcher is stopping (drain: everything queued is still served).

Requests are atomic — a request's rows are never split across flushes, so
one oversized request can push a flush past `max_batch`; the bucket ladder
in `DPMREngine.predict_padded` absorbs that. Results are scattered back to
per-request `concurrent.futures.Future`s, and a `predict_fn` exception
fails every future in the batch rather than wedging the queue.

The flusher thread is the ONLY caller of `predict_fn`, so the engine
underneath never sees concurrent steps however many client threads submit.
`run_on_flusher` hands it other work as well (it runs between flushes):
at P ranks every collective of the front rank must come from this one
thread, the mirror gather of the hot cache included, or the ranks would
see the collectives of two threads in different orders.
"""
from __future__ import annotations

from collections.abc import Callable
import concurrent.futures
import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np

from repro_torch.serve.metrics import ServeMetrics


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Coalescing knobs.

    max_batch:    flush as soon as this many rows are pending (the
                  throughput lever)
    max_wait_ms:  flush a partial batch this many ms after its oldest
                  request arrived (the latency lever; 0 = flush immediately,
                  i.e. no coalescing beyond what queues up during a step)
    buckets:      explicit pad ladder forwarded to `predict_padded`
                  (None = the engine's power-of-two-multiple-of-P ladder)
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    buckets: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0: {self.max_wait_ms}")


class _Pending(NamedTuple):
    ids: np.ndarray                      # (r, K) int32
    vals: np.ndarray                     # (r, K) f32
    future: concurrent.futures.Future    # resolves to (r,) probabilities
    t_enqueue: float                     # time.monotonic() at submit


class MicroBatcher:
    """Thread-safe request queue + deadline-aware flusher thread.

    `predict_fn(ids (n,K), vals (n,K)) -> (n,) np.ndarray` runs on the
    flusher thread only. `start()` before submitting; `stop()` drains the
    queue (every accepted request still gets its result) and joins the
    thread. Usable as a context manager.
    """

    def __init__(self, predict_fn: Callable[[np.ndarray, np.ndarray],
                                            np.ndarray],
                 config: BatchingConfig | None = None,
                 metrics: ServeMetrics | None = None):
        self._predict_fn = predict_fn
        self.config = config or BatchingConfig()
        self.metrics = metrics or ServeMetrics()
        self._cond = threading.Condition()
        self._pending: list[_Pending] = []
        self._pending_rows = 0
        self._tasks: list[tuple[Callable, concurrent.futures.Future]] = []
        self._stopping = False
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> MicroBatcher:
        with self._cond:
            if self._thread is not None:
                raise RuntimeError("MicroBatcher already started")
            self._stopping = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dpmr-serve-flusher")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue (pending requests are flushed and answered),
        then stop the flusher. Idempotent; `submit` afterwards raises."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
        with self._cond:
            self._thread = None

    def __enter__(self) -> MicroBatcher:
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client side --------------------------------------------------------

    def submit(self, ids: np.ndarray,
               vals: np.ndarray) -> concurrent.futures.Future:
        """Queue one request; returns a Future of its (r,) probabilities."""
        ids = np.asarray(ids)
        vals = np.asarray(vals)
        if ids.ndim != 2 or ids.shape != vals.shape:
            raise ValueError(
                f"request must be (rows, K) id/val pairs of one shape; got "
                f"ids {ids.shape} vals {vals.shape}")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            self._check_running()
            if self._pending and self._pending[0].ids.shape[1] != \
                    ids.shape[1]:
                raise ValueError(
                    f"request K={ids.shape[1]} differs from the pending "
                    f"batch's K={self._pending[0].ids.shape[1]}; conform "
                    "requests to one max_features_per_sample first (the "
                    "serve engine pads them)")
            self._pending.append(_Pending(ids, vals, fut, time.monotonic()))
            self._pending_rows += len(ids)
            self._cond.notify_all()
        return fut

    def run_on_flusher(self, fn: Callable[[], object]) -> object:
        """Run `fn()` on the flusher thread, between two flushes, and
        return its result (or raise what it raised). Raises when the
        batcher is stopped."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            self._check_running()
            self._tasks.append((fn, fut))
            self._cond.notify_all()
        return fut.result()

    def _check_running(self) -> None:
        if self._stopping or self._thread is None:
            raise RuntimeError(
                "MicroBatcher is stopped; start() it before submitting")

    @property
    def queue_depth(self) -> int:
        """Requests currently waiting to be flushed."""
        with self._cond:
            return len(self._pending)

    # -- flusher side -------------------------------------------------------

    def _next(self):
        """Under the lock: wait for a task or a batch that is due. Returns
        ("task", (fn, future)), ("batch", (requests, rows, reason)), or
        None when stopping with nothing left."""
        max_wait = self.config.max_wait_ms / 1e3
        while True:
            if self._tasks:
                return "task", self._tasks.pop(0)
            if not self._pending:
                if self._stopping:
                    return None
                self._cond.wait()
                continue
            # wait out the coalescing window (or a full batch, or stop)
            remaining = self._pending[0].t_enqueue + max_wait \
                - time.monotonic()
            if (self._pending_rows < self.config.max_batch
                    and not self._stopping and remaining > 0):
                self._cond.wait(timeout=remaining)
                continue
            # take whole requests until max_batch rows are on board
            # (at least one, even if it alone exceeds max_batch)
            take, rows = 0, 0
            while take < len(self._pending) and \
                    (take == 0 or rows + len(self._pending[take].ids)
                     <= self.config.max_batch):
                rows += len(self._pending[take].ids)
                take += 1
            batch, self._pending = (self._pending[:take],
                                    self._pending[take:])
            self._pending_rows -= rows
            if rows >= self.config.max_batch:
                reason = "full"
            elif self._stopping:
                reason = "drain"
            else:
                reason = "deadline"
            return "batch", (batch, rows, reason)

    def _run(self) -> None:
        while True:
            with self._cond:
                item = self._next()
            if item is None:
                return
            kind, work = item
            if kind == "task":
                fn, fut = work
                try:
                    fut.set_result(fn())
                except Exception as e:  # handed back to the caller
                    fut.set_exception(e)
            else:
                self._flush(*work)

    def _flush(self, batch: list[_Pending], rows: int, reason: str) -> None:
        done = time.monotonic  # latency stamp after scatter, per request
        self.metrics.count(f"flush_{reason}")
        try:
            ids = np.concatenate([p.ids for p in batch])
            vals = np.concatenate([p.vals for p in batch])
            probs = np.asarray(self._predict_fn(ids, vals))
            if probs.shape != (rows,):
                raise ValueError(
                    f"predict_fn returned {probs.shape}, expected ({rows},)")
        except BaseException as e:  # noqa: B036 — futures must not wedge
            for p in batch:
                if not p.future.cancelled():
                    p.future.set_exception(e)
            return
        off = 0
        for p in batch:
            r = len(p.ids)
            if not p.future.cancelled():
                p.future.set_result(probs[off:off + r])
            self.metrics.record_latency(done() - p.t_enqueue)
            off += r
