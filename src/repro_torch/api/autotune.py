"""Analytic geometry autotuner over the distribution-strategy registry:
the counterpart of `repro.api.autotune`.

Every registered strategy (compositions included) prices itself with a
two-tier `WireBytes(inner, outer)` model: the bytes a rank RECEIVES a
step inside its pod (inner) and from other pods (outer). Given a
`StrategyContext` and per-tier bandwidths, `score_strategies` charges
each tier's bytes at that tier's one-direction rate and ranks every
candidate by the seconds its exchange would occupy the wire;
`choose_strategy` picks the cheapest admissible one.
`DPMRConfig.distribution = "auto"` routes through it
(`core.dpmr.resolve_distribution`).

The objective is wire-cost seconds, not total bytes: a hierarchical
strategy spends more inner bytes to spend fewer outer ones, which reads
as a win only once each tier is charged at its own speed. Equal costs
break by name, so the choice is stable across runs: checkpoints record
the resolved name.

The default `WireBandwidth` is this hardware's, from NVIDIA's data
sheets, not a measurement: inside a host, H100 SXM NVLink 4 carries
900 GB/s a card in both directions, so 450 GB/s one way; between hosts,
one ConnectX-7 NDR port of 400 Gb/s a card, 50 GB/s. Pass measured
values to tune for a real fabric.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.api.strategies import (
    StrategyContext,
    WireBytes,
    get_strategy,
    list_strategies,
)
from repro_torch.configs.base import H100_NDR_GBPS, H100_NVLINK_GBPS


class WireBandwidth(NamedTuple):
    """Per-tier one-direction wire speeds in GB/s (data-sheet defaults,
    see the module note; pass measured values for a real fabric)."""

    inner_gbps: float = H100_NVLINK_GBPS   # NVLink 4 inside a host
    outer_gbps: float = H100_NDR_GBPS      # an NDR port, between hosts


class ScoredStrategy(NamedTuple):
    """One ranked candidate: its audited wire model priced on a fabric."""

    name: str
    wire: WireBytes
    cost_s: float     # seconds the exchange occupies the wire
    lossy: bool       # carries error-feedback state on this geometry


def wire_cost(wire: WireBytes, bandwidth: WireBandwidth) -> float:
    """Seconds of wire occupancy: each tier's bytes at that tier's speed."""
    return (wire.inner / (bandwidth.inner_gbps * 1e9)
            + wire.outer / (bandwidth.outer_gbps * 1e9))


def score_strategies(ctx: StrategyContext,
                     bandwidth: WireBandwidth | None = None, *,
                     require_exact: bool = False,
                     strategies: list[str] | None = None
                     ) -> list[ScoredStrategy]:
    """Rank candidates by analytic wire cost on `ctx`, cheapest first.

    `strategies` defaults to the whole registry. `require_exact` drops
    candidates that are lossy ON THIS GEOMETRY (i.e. `init_carry(ctx)` is
    not None: a composition is exact on a single-pod mesh, where it
    degenerates to its member). Equal costs break deterministically by
    name.
    """
    bw = bandwidth or WireBandwidth()
    scored = []
    for name in (strategies if strategies is not None else list_strategies()):
        s = get_strategy(name)
        lossy = s.init_carry(ctx, device="meta") is not None
        if require_exact and lossy:
            continue
        wire = s.bytes_per_device(ctx)
        scored.append(ScoredStrategy(name=name, wire=wire,
                                     cost_s=wire_cost(wire, bw),
                                     lossy=lossy))
    return sorted(scored, key=lambda s: (s.cost_s, s.name))


def choose_strategy(ctx: StrategyContext,
                    bandwidth: WireBandwidth | None = None, *,
                    require_exact: bool = False,
                    strategies: list[str] | None = None) -> str:
    """The cheapest admissible strategy name for `ctx` (see
    `score_strategies` for the ranking contract)."""
    ranked = score_strategies(ctx, bandwidth, require_exact=require_exact,
                              strategies=strategies)
    if not ranked:
        raise ValueError(
            "no admissible strategy to choose from "
            f"(require_exact={require_exact}, candidates="
            f"{strategies if strategies is not None else list_strategies()})")
    return ranked[0].name
