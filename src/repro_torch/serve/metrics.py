"""Thread-safe serving metrics: counters + latency/batch-size recorders;
the counterpart of `repro.serve.metrics`, a copy of it.

One `ServeMetrics` instance is shared by the serve engine, its
`MicroBatcher`, and its `HotFeatureCache`; every component only ever calls
`count` / `record_latency` / `record_flush` under the metrics lock, so the
numbers stay consistent however many client threads are submitting.

`snapshot()` derives the headline serving numbers:

  latency_p50_ms / latency_p99_ms   request latency percentiles
                                    (submit -> result, hot-cache hits
                                    included at their near-zero cost)
  qps                               completed requests / wall seconds
                                    since construction (or `reset_clock`)
  batch_mean / padded_mean          flushed micro-batch row counts, raw vs
                                    after bucket padding
  padding_frac                      wasted rows the bucket ladder added
  hot_hit_rate                      cache_hits / (cache_hits + cache_misses)

Counter names written by the subsystem (all start at 0 and appear in the
snapshot once touched): requests, samples, flushes, flush_full,
flush_deadline, flush_drain, cache_hits, cache_misses, cache_refreshes,
cache_stale_refreshes, cache_step_refreshes.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np


class ServeMetrics:
    """Counters + bounded reservoirs of latencies and flush sizes."""

    def __init__(self, max_samples: int = 100_000):
        self._lock = threading.Lock()
        self._counters: collections.Counter = collections.Counter()
        self._latencies: list[float] = []       # seconds, one per request
        self._flush_rows: list[int] = []        # raw rows per flushed batch
        self._flush_padded: list[int] = []      # rows after bucket padding
        self._max_samples = int(max_samples)
        self._t0 = time.monotonic()

    def reset_clock(self) -> None:
        """Restart the QPS wall clock (e.g. after warmup)."""
        with self._lock:
            self._t0 = time.monotonic()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            if len(self._latencies) < self._max_samples:
                self._latencies.append(float(seconds))

    def record_flush(self, rows: int, padded_rows: int) -> None:
        """One coalesced micro-batch left the queue for the device (the
        per-reason `flush_full`/`flush_deadline`/`flush_drain` counters are
        incremented by the MicroBatcher, which knows why it flushed)."""
        with self._lock:
            self._counters["flushes"] += 1
            if len(self._flush_rows) < self._max_samples:
                self._flush_rows.append(int(rows))
                self._flush_padded.append(int(padded_rows))

    def snapshot(self) -> dict:
        """Point-in-time copy: raw counters + derived percentiles/rates."""
        with self._lock:
            counters = dict(self._counters)
            lat = np.asarray(self._latencies, np.float64)
            rows = np.asarray(self._flush_rows, np.float64)
            padded = np.asarray(self._flush_padded, np.float64)
            elapsed = time.monotonic() - self._t0
        out = dict(counters)
        if lat.size:
            out["latency_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["latency_p99_ms"] = float(np.percentile(lat, 99) * 1e3)
            out["qps"] = float(lat.size / max(elapsed, 1e-9))
        if rows.size:
            out["batch_mean"] = float(rows.mean())
            out["padded_mean"] = float(padded.mean())
            tot = float(padded.sum())
            out["padding_frac"] = float((padded - rows).sum() / max(tot, 1.0))
        hits = counters.get("cache_hits", 0)
        misses = counters.get("cache_misses", 0)
        if hits + misses:
            out["hot_hit_rate"] = hits / (hits + misses)
        return out
