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
    AllToAllStrategy,
    DistributionStrategy,
    StrategyContext,
    get_strategy,
    register_strategy,
)
from repro_torch.core.dpmr import DPMRState, StepFns, init_state, make_step_fns
from repro_torch.data import DataSource, get_source

__all__ = [
    "AllToAllStrategy", "DPMREngine", "DPMRState", "DataSource",
    "DistributionStrategy", "StepFns", "StrategyContext",
    "binary_prf_metrics", "get_source", "get_strategy", "hot_ids_from_corpus",
    "init_state", "make_step_fns", "put_batch", "register_strategy",
]
