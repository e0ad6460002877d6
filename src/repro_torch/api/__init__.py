"""Typed public API of the port's DPMR sparse core.

    from repro_torch.api import DPMREngine, get_strategy
"""
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
from repro_torch.data import DataSource, get_source

__all__ = [
    "AllGatherStrategy", "AllToAllStrategy", "ComposedStrategy",
    "CompressedReduceStrategy", "DPMREngine", "DPMRState", "DataSource",
    "DistributionStrategy", "HierarchicalA2AStrategy", "Int8OuterLeg",
    "OuterLeg", "OverlapA2AStrategy", "PsumScatterStrategy", "StepFns",
    "StrategyContext", "TopKOuterLeg", "TopKReduceStrategy", "WireBytes",
    "binary_prf_metrics", "get_source", "get_strategy", "hot_ids_from_corpus",
    "init_state", "list_strategies", "make_step_fns", "put_batch",
    "register_composition", "register_strategy",
]
