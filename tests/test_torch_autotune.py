"""The port's wire-cost autotuner (`api/autotune.py`, `auto`) against the
JAX package's, on the CPU.

Under the same explicit `WireBandwidth` both packages rank every
registered strategy alike over the P = 1, (8,) and (pod 2, data 4)
geometries (the costs in float64 from the same integer byte counts, so
exactly); the hypothesis properties of tests/test_properties.py
(optimality, outer-tier monotonicity, determinism, `require_exact`) are
restated for the port; `resolve_distribution` equals the reference's at
P = 1 (tests/test_torch_multirank.py holds it at P = 8 and (2, 4)).
"""
import pytest
from hypothesis import given, settings, strategies as st

from repro.api import autotune as jax_autotune
from repro.api.strategies import StrategyContext as JaxContext
from repro.api.strategies import list_strategies as jax_list
from repro.configs.base import DPMRConfig as JaxConfig
from repro.core import dpmr as jax_dpmr
from repro.launch.mesh import make_host_mesh
from repro_torch.api import autotune
from repro_torch.api.strategies import (
    StrategyContext,
    get_strategy,
    list_strategies,
)
from repro_torch.configs.base import DPMRConfig
from repro_torch.core import dpmr

SET = dict(max_examples=25, deadline=None)
BUILTINS = tuple(list_strategies())
# the reference's shipped registry, read at collection: tests/test_dpmr.py
# registers strategies of its own into it when it runs, and a test
# worker may run that file first
JAX_BUILTINS = tuple(jax_list())
F, K = 1 << 12, 16
# (P, pods, global batch): one card, the flat (8,) mesh, (pod 2, data 4)
GEOMETRIES = {"1": (1, 1, 256), "8": (8, 1, 256), "2x4": (8, 2, 256)}
BANDWIDTHS = [autotune.WireBandwidth(), autotune.WireBandwidth(900.0, 90.0),
              autotune.WireBandwidth(100.0, 100.0),
              autotune.WireBandwidth(450.0, 5.0)]


def _contexts(geo, frac=0.05):
    p, po, b = GEOMETRIES[geo]
    cfg = DPMRConfig(num_features=F, max_features_per_sample=K,
                     topk_frac=frac)
    cap = dpmr.capacity(cfg, b // p, p)
    geom = dict(num_shards=p, block_size=dpmr.padded_features(cfg, p) // p,
                capacity=cap, outer_shards=po, topk_frac=frac)
    return StrategyContext(**geom), JaxContext(axes=(), **geom)


def test_registries_match():
    assert BUILTINS == JAX_BUILTINS


@pytest.mark.parametrize("bw", BANDWIDTHS, ids=lambda b: f"{b[0]:g}-{b[1]:g}")
@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("require_exact", [False, True])
def test_ranking_matches_reference(geo, bw, require_exact):
    ctx, jctx = _contexts(geo)
    got = autotune.score_strategies(ctx, bw, require_exact=require_exact)
    want = jax_autotune.score_strategies(
        jctx, jax_autotune.WireBandwidth(*bw), require_exact=require_exact,
        strategies=list(JAX_BUILTINS))
    assert [(s.name, tuple(s.wire), s.cost_s, s.lossy) for s in got] == \
        [(s.name, tuple(s.wire), s.cost_s, s.lossy) for s in want]
    assert autotune.choose_strategy(ctx, bw, require_exact=require_exact) \
        == jax_autotune.choose_strategy(
            jctx, jax_autotune.WireBandwidth(*bw),
            require_exact=require_exact, strategies=list(JAX_BUILTINS))


def test_defaults_are_this_hardwares():
    """NVLink 4 one way a card, one NDR port a card: not the TPU's."""
    assert tuple(autotune.WireBandwidth()) == (450.0, 50.0)
    assert tuple(jax_autotune.WireBandwidth()) != (450.0, 50.0)


def test_resolve_distribution_matches_reference_at_one_rank():
    kw = dict(num_features=F, max_features_per_sample=K, topk_frac=0.05)
    want = jax_dpmr.resolve_distribution(
        JaxConfig(distribution="auto", **kw), make_host_mesh(1, 1))
    assert dpmr.resolve_distribution(DPMRConfig(distribution="auto",
                                                **kw)) == want
    assert dpmr.resolve_distribution(DPMRConfig(distribution="hier_a2a",
                                                **kw)) == "hier_a2a"
    assert dpmr.strategy_carry_len(DPMRConfig(distribution="auto",
                                              **kw)) == 1
    with pytest.raises(ValueError, match="no admissible strategy"):
        autotune.choose_strategy(_contexts("1")[0], strategies=[])


# ---------------------------------------------------------------------------
# the reference's hypothesis properties, restated for the port
# ---------------------------------------------------------------------------


@st.composite
def geometries(draw):
    po = draw(st.sampled_from([1, 2, 4]))
    pi = 2 ** draw(st.integers(1, 6))
    block = 2 ** draw(st.integers(7, 14))
    cap = 2 ** draw(st.integers(4, 12))
    frac = draw(st.sampled_from([0.05, 0.25, 1.0]))
    return StrategyContext(num_shards=po * pi, block_size=block,
                           capacity=cap, outer_shards=po, topk_frac=frac)


bandwidths = st.floats(1.0, 2000.0)


@given(geometries(), bandwidths, bandwidths)
@settings(**SET)
def test_autotuner_choice_is_optimal(ctx, inner_gbps, outer_gbps):
    bw = autotune.WireBandwidth(inner_gbps, outer_gbps)
    ranked = autotune.score_strategies(ctx, bw, strategies=BUILTINS)
    assert autotune.choose_strategy(ctx, bw, strategies=BUILTINS) == \
        ranked[0].name
    for name in BUILTINS:
        cost = autotune.wire_cost(
            get_strategy(name).bytes_per_device(ctx), bw)
        assert ranked[0].cost_s <= cost


@given(geometries(), bandwidths, bandwidths, bandwidths)
@settings(**SET)
def test_autotuner_outer_tier_monotonicity(ctx, inner_gbps, bw_a, bw_b):
    """A slower outer tier never flips the tuner toward a strategy with
    MORE outer bytes."""
    fast, slow = max(bw_a, bw_b), min(bw_a, bw_b)

    def pick(outer_gbps):
        return autotune.score_strategies(
            ctx, autotune.WireBandwidth(inner_gbps, outer_gbps),
            strategies=BUILTINS)[0]

    assert pick(slow).wire.outer <= pick(fast).wire.outer


@given(geometries(), bandwidths, bandwidths)
@settings(**SET)
def test_autotuner_ranking_deterministic(ctx, inner_gbps, outer_gbps):
    bw = autotune.WireBandwidth(inner_gbps, outer_gbps)
    r1 = autotune.score_strategies(ctx, bw, strategies=BUILTINS)
    r2 = autotune.score_strategies(ctx, bw, strategies=BUILTINS)
    assert [s.name for s in r1] == [s.name for s in r2]
    keys = [(s.cost_s, s.name) for s in r1]
    assert keys == sorted(keys)


@given(geometries(), bandwidths, bandwidths)
@settings(**SET)
def test_autotuner_require_exact_filters_lossy(ctx, inner_gbps, outer_gbps):
    bw = autotune.WireBandwidth(inner_gbps, outer_gbps)
    exact = autotune.score_strategies(ctx, bw, require_exact=True,
                                      strategies=BUILTINS)
    assert exact and all(not s.lossy for s in exact)
    for s in exact:
        assert get_strategy(s.name).init_carry(ctx, device="meta") is None
