"""Host-side hot-feature parameter cache — the Zipf-head fast path: the
counterpart of `repro.serve.hot_cache`.

Under Zipf traffic a handful of head features appears in almost every
request. Their parameters fit trivially on the serving host, so a request
built ENTIRELY of cached head features is answered from a locally
mirrored dense slice — no micro-batch, no device call, no sparse
exchange. Only requests touching the Zipf tail go through the coalesced
`predict_padded` path.

The head set is the reference's statistic (`hot_sharding.select_hot` over
`feature_counts` of a sliding window of recent request ids), computed
from the window's DISTINCT ids (`select_hot_ids`): the same ids bit for
bit, at a cost that follows the window, not the feature space (at 2^27
features the dense histogram alone is a 512 MiB tensor). `split_hot`
classifies the selected ids against the MODEL's replicated hot set, so
the mirror takes each value from the right table (`state.hot` for
model-hot features, `state.cold` for owner-sharded ones).

Staleness contract (as the reference's, docs/SERVING.md):

  - a hit is answered from the mirror only while the mirror is FRESH:
    at most `refresh_every` lookups old AND gathered at the engine's
    current step;
  - crossing either bound does not serve stale values — the next lookup
    refreshes the mirror first (counted in `cache_stale_refreshes` /
    `cache_step_refreshes`), then answers;
  - within freshness, a cached hit is bit-identical to the sparse path:
    the mirror holds exact f32 parameter values and the hit runs
    `core.dpmr.row_probs`, the predict step's own arithmetic, whose bits
    depend on neither the device nor the batch size. So a hit is
    computed on the host with no device call.

Freshness reads the step the engine counts on the host
(`DPMREngine.host_step`), never the device: on the card a read of
`state.step` would wait behind every predict the flusher has queued.

At P ranks the values of `cold` live with their owners; the serve engine
hands the cache a `gather` that runs the collective on its flusher thread
(`serve.engine`).
"""
from __future__ import annotations

from collections.abc import Callable
import collections
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core import dpmr, hot_sharding
from repro_torch.serve.metrics import ServeMetrics


@dataclasses.dataclass(frozen=True)
class HotCacheConfig:
    """Hot-cache knobs.

    max_hot:        mirror slots (select_hot cap) — the head-set size
    threshold:      minimum in-window frequency for a feature to be cached
    window:         sliding request window feeding the frequency count
    refresh_every:  staleness bound, in lookups: a mirror older than this
                    many served requests is refreshed before the next hit
    """

    max_hot: int = 256
    threshold: float = 0.001
    window: int = 512
    refresh_every: int = 256

    def __post_init__(self):
        if self.max_hot < 1:
            raise ValueError(f"max_hot must be >= 1: {self.max_hot}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1: {self.window}")
        if self.refresh_every < 1:
            raise ValueError(
                f"refresh_every must be >= 1: {self.refresh_every}")


def select_hot_ids(ids: torch.Tensor, num_features: int, threshold: float,
                   max_hot: int) -> torch.Tensor:
    """`hot_sharding.select_hot(hot_sharding.feature_counts(ids,
    num_features), threshold, max_hot)`, from the distinct ids alone.

    The same ranking over the ids that occur: frequency = count / total
    (f32) at least `threshold`, count descending, ties to the lower id, at
    most `max_hot`; padded with INT_MAX and sorted ascending. An id that
    does not occur has count 0 and is never selected by `select_hot`, so
    leaving it out changes nothing. Runs where `ids` lies."""
    flat = ids.reshape(-1)
    flat = flat[(flat >= 0) & (flat < num_features)]
    uniq, counts = torch.unique(flat, sorted=True, return_counts=True)
    total = torch.clamp(torch.sum(counts), min=1)
    freq = counts.to(torch.float32) / total.to(torch.float32)
    score = torch.where(freq >= threshold, counts, -1)
    top, order = torch.sort(score, descending=True, stable=True)
    top, order = top[:max_hot], order[:max_hot]
    out = torch.full((max_hot,), hot_sharding.INT_MAX, dtype=torch.int32,
                     device=ids.device)
    out[:top.numel()] = torch.where(top > 0, uniq[order].to(torch.int32),
                                    hot_sharding.INT_MAX)
    return torch.sort(out).values


def owned_values(state: dpmr.DPMRState, sel: torch.Tensor,
                 rank: int = 0) -> torch.Tensor:
    """The parameter of each selected id (INT_MAX = an empty slot, 0.0)
    that this rank holds: model-hot ids from the replicated `hot` table,
    the others from this rank's block of `cold` (rank r holds ids
    [r·block, (r+1)·block)); 0.0 where this rank does not own the id.
    With one rank, every value."""
    block = state.cold.shape[0]
    valid = sel != hot_sharding.INT_MAX
    safe = torch.where(valid, sel, 0)
    # model-hot features live in the replicated `hot` table, everything
    # else in the owner-sharded `cold` table — exactly the split the
    # device forward makes, so mirrored values are the exact f32
    # parameters a sparse predict would fetch
    hot_slot, is_hot, _ = hot_sharding.split_hot(safe, state.hot_ids)
    local = safe - rank * block
    mine = (local >= 0) & (local < block)
    cold = state.cold[torch.where(mine, local, 0)]
    vals = torch.where(is_hot, state.hot[torch.clamp(hot_slot, min=0)],
                       cold)
    return torch.where(valid & (is_hot | mine), vals, 0.0)


class HotFeatureCache:
    """Sliding-window hot-set mirror over a live `DPMREngine` state.

    Thread-safe: `observe`/`lookup` take an internal lock, so client
    threads and the flusher can share one cache. The mirror gathers values
    lazily (first lookup) and again whenever stale (see the module
    docstring's staleness contract).

    `gather(sel) -> values` fetches the parameters of the selected ids;
    the default reads the engine's own state, which holds every value
    only without a process group. At P ranks the serve engine passes its
    collective gather.
    """

    def __init__(self, engine, config: HotCacheConfig | None = None,
                 metrics: ServeMetrics | None = None, *,
                 gather: Callable[[torch.Tensor], torch.Tensor]
                 | None = None):
        if gather is None and engine.mesh is not None:
            raise ValueError(
                "the engine has a process group, so its cold values live "
                "with their owners: serve it through DPMRServeEngine, "
                "whose gather collects them")
        self.engine = engine
        self.config = config or HotCacheConfig()
        self.metrics = metrics or ServeMetrics()
        self._gather = gather or (
            lambda sel: owned_values(engine.state, sel))
        self._lock = threading.Lock()
        self._window: collections.deque = collections.deque(
            maxlen=self.config.window)          # flat id arrays, one/request
        self._ids: np.ndarray | None = None     # sorted, INT_MAX padded
        self._vals: np.ndarray | None = None    # f32, aligned with _ids
        self._mirror_step = -1                  # engine step at last gather
        self._lookups_since_refresh = 0

    # -- observation & freshness --------------------------------------------

    def observe(self, ids: np.ndarray) -> None:
        """Feed one request's ids into the sliding frequency window."""
        with self._lock:
            self._window.append(np.asarray(ids, np.int32).reshape(-1))

    @property
    def staleness(self) -> int:
        """Lookups served since the mirror was last gathered."""
        with self._lock:
            return self._lookups_since_refresh

    @property
    def hot_ids(self) -> np.ndarray:
        """The currently mirrored feature ids (unpadded, sorted)."""
        with self._lock:
            if self._ids is None:
                return np.empty((0,), np.int32)
            return self._ids[self._ids != hot_sharding.INT_MAX].copy()

    def _fresh(self) -> bool:
        return (self._ids is not None
                and self._lookups_since_refresh < self.config.refresh_every
                and self._mirror_step == self.engine.host_step())

    # -- mirror refresh -----------------------------------------------------

    def refresh(self) -> None:
        """Re-derive the hot set from the window and re-gather its values."""
        with self._lock:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        eng = self.engine
        f = dpmr.padded_features(eng.cfg, eng.num_shards)
        if self._window:
            flat = np.concatenate(list(self._window))
        else:
            flat = np.empty((0,), np.int32)
        sel = select_hot_ids(torch.from_numpy(flat).to(eng.device), f,
                             self.config.threshold, self.config.max_hot)
        vals = self._gather(sel)
        self._ids = sel.cpu().numpy()
        self._vals = vals.to(torch.float32).cpu().numpy()
        self._mirror_step = eng.host_step()
        self._lookups_since_refresh = 0
        self.metrics.count("cache_refreshes")

    # -- the fast path ------------------------------------------------------

    def lookup(self, ids: np.ndarray,
               vals: np.ndarray) -> np.ndarray | None:
        """Answer a request from the mirror, or None (miss -> sparse path).

        A request hits iff every non-padding feature id is in the mirrored
        hot set. A stale mirror is refreshed FIRST (never answering from
        stale values), then consulted."""
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        with self._lock:
            if not self._fresh():
                if self._ids is not None:
                    if self._mirror_step != self.engine.host_step():
                        self.metrics.count("cache_step_refreshes")
                    else:
                        self.metrics.count("cache_stale_refreshes")
                self._refresh_locked()
            self._lookups_since_refresh += 1
            table_ids, table_vals = self._ids, self._vals
        flat = ids.reshape(-1)
        pos = np.searchsorted(table_ids, flat)
        pos = np.clip(pos, 0, len(table_ids) - 1)
        found = (table_ids[pos] == flat) & (flat >= 0)
        if not np.all(found | (flat < 0)):
            self.metrics.count("cache_misses")
            return None
        theta = np.where(found, table_vals[pos], np.float32(0.0)) \
            .astype(np.float32).reshape(ids.shape)
        probs = dpmr.row_probs(torch.from_numpy(vals),
                               torch.from_numpy(theta)).numpy()
        self.metrics.count("cache_hits")
        return probs
