"""Sparse serving: resident parameters, micro-batched requests; the
counterpart of `repro.serve`.

    from repro_torch.serve import (BatchingConfig, DPMRServeEngine,
                                   HotCacheConfig)

`DPMRServeEngine` keeps a `DPMREngine`'s state resident on the card (or on
its P ranks) and streams concurrent requests through deadline-coalesced,
bucket-padded micro-batches (`serve/batching.py` +
`DPMREngine.predict_padded`), with a host-side Zipf-head parameter cache
(`serve/hot_cache.py`) answering head-only requests without a device
call. At P ranks rank 0 is the front and the others run
`DPMRServeEngine.serve_follower()` (`serve/engine.py`).
"""
from repro_torch.serve.batching import BatchingConfig, MicroBatcher
from repro_torch.serve.engine import DPMRServeEngine
from repro_torch.serve.hot_cache import HotCacheConfig, HotFeatureCache
from repro_torch.serve.metrics import ServeMetrics

__all__ = [
    "BatchingConfig",
    "DPMRServeEngine",
    "HotCacheConfig",
    "HotFeatureCache",
    "MicroBatcher",
    "ServeMetrics",
]
