"""Flat re-exports of the DPMR core primitives: the counterpart of
`repro.core.api`. Prefer `repro_torch.api` (the `DPMREngine` façade and
the strategy registry) and `repro_torch.data` (sources and the
`ShardedLoader`); `dpmr_dense_linear` and `fsdp_specs` are the dense
face's (`core/fsdp.py`).
"""
from repro_torch.api.engine import hot_ids_from_corpus
from repro_torch.core.dpmr import (
    DPMRState,
    StepFns,
    capacity,
    init_state,
    make_schedule,
    make_step_fns,
    num_shards,
    optimize,
    padded_features,
)
from repro_torch.core.fsdp import dpmr_dense_linear, fsdp_specs
from repro_torch.core.hot_sharding import (
    feature_counts,
    load_imbalance,
    select_hot,
    split_hot,
)
from repro_torch.core.sparse import (
    Routing,
    combine_grads,
    owner_accumulate,
    owner_apply,
    route_build,
    route_return,
)

__all__ = [
    "DPMRState", "Routing", "StepFns", "capacity", "combine_grads",
    "dpmr_dense_linear", "feature_counts", "fsdp_specs",
    "hot_ids_from_corpus", "init_state", "load_imbalance",
    "make_schedule", "make_step_fns", "num_shards", "optimize",
    "owner_accumulate", "owner_apply", "padded_features", "route_build",
    "route_return", "select_hot", "split_hot",
]
