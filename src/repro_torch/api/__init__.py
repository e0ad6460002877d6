"""Typed public API of the port's DPMR sparse core.

    from repro_torch.api import DPMREngine, get_strategy, list_strategies

`DPMREngine` is the façade (state, step functions, batch placement,
checkpointing); the strategy registry makes the parameter-distribution
shuffle pluggable, including per-tier compositions and the analytic
autotuner (`api.autotune`, reached through `DPMRConfig.distribution =
"auto"`); the data plane (`repro_torch.data`, re-exported here) does the
same for the input face: `fit`, `fit_sgd` and `evaluate` take a
`ShardedLoader` or a registered source name with a spec.
"""
from repro_torch.api.autotune import (
    ScoredStrategy,
    WireBandwidth,
    choose_strategy,
    score_strategies,
)
from repro_torch.api.engine import (
    DPMREngine,
    binary_prf_metrics,
    hot_ids_from_corpus,
    put_batch,
)
from repro_torch.api.strategies import (
    AllGatherStrategy,
    AllToAllStrategy,
    ComposedStrategy,
    CompressedReduceStrategy,
    DistributionStrategy,
    HierarchicalA2AStrategy,
    Int8OuterLeg,
    OuterLeg,
    OverlapA2AStrategy,
    PsumScatterStrategy,
    StrategyContext,
    TopKOuterLeg,
    TopKReduceStrategy,
    WireBytes,
    get_strategy,
    list_strategies,
    register_composition,
    register_strategy,
)
from repro_torch.core.dpmr import DPMRState, StepFns, init_state, make_step_fns
from repro_torch.data import (
    Cursor,
    DataSource,
    ShardedLoader,
    get_source,
    list_sources,
    register_source,
    write_file_corpus,
)

__all__ = [
    "AllGatherStrategy", "AllToAllStrategy", "ComposedStrategy",
    "CompressedReduceStrategy", "Cursor", "DPMREngine", "DPMRState",
    "DataSource", "DistributionStrategy", "HierarchicalA2AStrategy",
    "Int8OuterLeg", "OuterLeg", "OverlapA2AStrategy", "PsumScatterStrategy",
    "ScoredStrategy", "ShardedLoader", "StepFns", "StrategyContext",
    "TopKOuterLeg", "TopKReduceStrategy", "WireBandwidth", "WireBytes",
    "binary_prf_metrics", "choose_strategy", "get_source", "get_strategy",
    "hot_ids_from_corpus", "init_state", "list_sources", "list_strategies",
    "make_step_fns", "put_batch", "register_composition", "register_source",
    "register_strategy", "score_strategies", "write_file_corpus",
]
