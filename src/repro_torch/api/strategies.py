"""Parameter-distribution strategies: the counterpart of
`repro.api.strategies`, cut to the paper's `a2a` shuffle on one card.

A `DistributionStrategy` implements the two collective-bearing stages of
the per-device pipeline; `core.dpmr` asks the registry for the one
`DPMRConfig.distribution` names. On one card (P = 1) the all_to_all is
the identity. `_all_to_all` is the seam the multi-rank slice fills with
`torch.distributed` (ROADMAP queue A, item 5); until then it raises for
P > 1. The other strategies of the reference, the compositions and
`auto` are not ported yet (ROADMAP queue A, item 6): naming one raises
instead of running `a2a`. The reference's per-rank and per-tier context
fields, its two-tier `WireBytes` and its strategy carry come back with
the multi-rank and stateful strategies that first use them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import sparse
from repro_torch.kernels import ops


class StrategyContext(NamedTuple):
    """Static per-step geometry handed to every strategy method."""

    num_shards: int          # P = ranks taking part
    block_size: int          # rows of the feature table per rank
    capacity: int            # per-(src,dst) a2a slots for cold features


class DistributionStrategy:
    """Interface for the distributeParameters / reduce pair of stages.

    `distribute` returns the per-slot cold parameters plus a forward-state
    dict that the engine threads into `reduce`; `overflow` must be a 0-d
    int32 tensor in that dict.
    """

    name: str = "base"

    def distribute(self, ctx: StrategyContext, cold_loc: torch.Tensor,
                   cold_ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def reduce(self, ctx: StrategyContext, cold_loc: torch.Tensor,
               grads_flat: torch.Tensor, fwd: dict) -> torch.Tensor:
        raise NotImplementedError

    def bytes_per_device(self, ctx: StrategyContext) -> int:
        """Bytes one rank receives over the wire per step."""
        raise NotImplementedError


def _all_to_all(x: torch.Tensor, ctx: StrategyContext) -> torch.Tensor:
    """Tiled all_to_all over the (P, cap) leading axis: row o goes to rank
    o. The identity on one rank."""
    if ctx.num_shards == 1:
        return x
    raise NotImplementedError(
        "all_to_all across ranks is not ported yet: multi-rank a2a over "
        "torch.distributed is ROADMAP queue A, item 5")


class AllToAllStrategy(DistributionStrategy):
    """Paper-faithful DPMR shuffle in both directions."""

    name = "a2a"

    def distribute(self, ctx, cold_loc, cold_ids):
        routing = sparse.route_build(cold_ids, ctx.num_shards,
                                     ctx.block_size, ctx.capacity)
        req_recv = _all_to_all(routing.req_ids, ctx)
        # one rank: it owns rows [0, block_size), so its base is 0
        resp = sparse.owner_apply(req_recv, cold_loc, 0)
        theta_cold = sparse.route_return(routing, _all_to_all(resp, ctx))
        return theta_cold, {"routing": routing, "req_recv": req_recv,
                            "cold_ids": cold_ids,
                            "overflow": routing.overflow}

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        send = sparse.combine_grads(fwd["routing"], grads_flat)
        recv = _all_to_all(send, ctx)
        return ops.owner_accumulate(fwd["req_recv"], recv,
                                    torch.zeros_like(cold_loc), 0)

    def bytes_per_device(self, ctx):
        # 3 (P, cap) f32 buffers (requests, responses, grad sums); a rank
        # receives P - 1 buckets of each, its own never leaves the card
        return 3 * (ctx.num_shards - 1) * ctx.capacity * 4


_REGISTRY: dict[str, DistributionStrategy] = {}


def register_strategy(name: str, strategy: DistributionStrategy) -> None:
    """Register a strategy instance under `name`."""
    strategy.name = name
    _REGISTRY[name] = strategy


def get_strategy(name: str) -> DistributionStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"distribution strategy {name!r} is not in repro_torch: only "
            f"{sorted(_REGISTRY)} are ported, the others are ROADMAP "
            "queue A, item 6") from None


register_strategy("a2a", AllToAllStrategy())
