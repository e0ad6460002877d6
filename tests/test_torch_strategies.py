"""The port's distribution strategies against the JAX engine.

Both engines train on the same numpy batches: the JAX `DPMREngine` on a
1x1 host mesh with `kernel_impl="pallas_interpret"` (at B = 64, K = 16
the capacity is 1,024, under the Pallas `select_pack`'s MAX_CAPACITY, so
its kernel really runs), the port's `DPMREngine(device="cpu")` on its
plain versions. Losses, tables and the strategy carry agree to
atol=1e-5: the same f32 arithmetic in another order of summation.
"""
import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro.api import DPMREngine as JaxEngine
from repro.api import hot_ids_from_corpus as jax_hot_ids
from repro.api.strategies import StrategyContext as JaxContext
from repro.api.strategies import get_strategy as jax_get_strategy
from repro.configs.base import DPMRConfig as JaxConfig
from repro.core import dpmr as jdpmr
from repro.launch.mesh import make_host_mesh
from repro_torch import DPMRConfig, DPMREngine, get_source
from repro_torch.api import (
    AllToAllStrategy,
    StrategyContext,
    get_strategy,
    hot_ids_from_corpus,
    list_strategies,
    register_strategy,
)
from repro_torch.api import strategies
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import dpmr

ATOL = 1e-5
F, K, B = 1 << 12, 16, 64
CORPUS = dict(num_features=F, features_per_sample=K, signal_features=256)
STATE = ("cold", "hot", "cold_acc", "hot_acc", "strat")
PORTED = ["a2a", "allgather", "compressed_reduce", "hier_a2a",
          "hier_a2a+int8", "hier_a2a+topk", "overlap_a2a", "psum_scatter",
          "topk_reduce"]


def _kw(dist, frac=0.25):
    return dict(num_features=F, max_features_per_sample=K, max_hot=16,
                learning_rate=2.0, optimizer="adagrad", distribution=dist,
                topk_frac=frac)


@pytest.fixture(scope="module")
def batches():
    src = get_source("zipf_sparse", batch_size=B, **CORPUS)
    return [src.batch(i) for i in range(6)]


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _engines(kw, batches, mesh):
    jcfg, cfg = JaxConfig(**kw), DPMRConfig(**kw)
    jh = jax_hot_ids(jcfg, batches[:4], mesh)
    th = hot_ids_from_corpus(cfg, batches[:4], device="cpu")
    return (JaxEngine(jcfg, mesh, kernel_impl="pallas_interpret", hot_ids=jh),
            DPMREngine(cfg, device="cpu", hot_ids=th))


def _assert_state(je, te):
    for name in STATE:
        got, want = getattr(te.state, name), np.asarray(getattr(je.state,
                                                                name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dist,frac", [
    ("topk_reduce", 0.05), ("topk_reduce", 1.0), ("compressed_reduce", 0.25),
    ("psum_scatter", 0.25), ("allgather", 0.25)])
def test_fit_sgd_matches_jax(dist, frac, batches, mesh):
    je, te = _engines(_kw(dist, frac), batches, mesh)
    hj = je.fit_sgd(batches, steps=4)
    ht = te.fit_sgd(batches, steps=4)
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], atol=ATOL)
    assert [h["overflow"] for h in ht] == [h["overflow"] for h in hj]
    _assert_state(je, te)
    carried = bool(te.state.strat.any())
    # 0.05 of 1,024 slots is k = 52, below the live count: losers bank a
    # residual; compressed_reduce always leaves quantization error
    assert carried == (dist == "compressed_reduce"
                       or (dist == "topk_reduce" and frac < 1.0))


def test_fit_leaves_the_topk_carry_unchanged(batches, mesh):
    """Full-batch fit takes the exact reduce and passes the carry through,
    in both packages."""
    je, te = _engines(_kw("topk_reduce", 0.05), batches, mesh)
    je.fit_sgd(batches, steps=2)
    te.fit_sgd(batches, steps=2)
    carry = te.state.strat.clone()
    assert carry.any()
    hj = je.fit(lambda: iter(batches[:4]), iterations=1)
    ht = te.fit(lambda: iter(batches[:4]), iterations=1)
    assert ht[0]["loss"] == pytest.approx(hj[0]["loss"], abs=ATOL)
    assert torch.equal(te.state.strat, carry)
    _assert_state(je, te)


def test_topk_full_fraction_equals_a2a(batches):
    """topk_frac=1.0 sends every slot: the same tables as a2a, bit for bit,
    and a residual that stays zero."""
    hot = hot_ids_from_corpus(DPMRConfig(**_kw("a2a")), batches[:4],
                              device="cpu")
    a2a = DPMREngine(DPMRConfig(**_kw("a2a")), device="cpu", hot_ids=hot)
    topk = DPMREngine(DPMRConfig(**_kw("topk_reduce", 1.0)), device="cpu",
                      hot_ids=hot)
    ha, ht = a2a.fit_sgd(batches, steps=4), topk.fit_sgd(batches, steps=4)
    assert [h["loss"] for h in ha] == [h["loss"] for h in ht]
    for name in ("cold", "hot", "cold_acc", "hot_acc"):
        assert torch.equal(getattr(a2a.state, name),
                           getattr(topk.state, name)), name
    assert topk.state.strat.shape == (F,) and not topk.state.strat.any()


def test_state_round_trip_with_carry_then_one_step(batches, mesh):
    """A JAX topk_reduce state with its (F,) carry, carried into the port:
    one more step in each package gives the same state."""
    kw = _kw("topk_reduce", 0.05)
    je, _ = _engines(kw, batches, mesh)
    je.fit_sgd(batches, steps=2)
    leaves = [np.asarray(x) for x in jax.tree.leaves(je.state)]
    state = state_from_numpy(leaves, "cpu")
    assert state.strat.shape == (F,) and state.strat.any()
    for a, b in zip(state_to_numpy(state), leaves, strict=True):
        np.testing.assert_array_equal(a, b)
    te = DPMREngine(DPMRConfig(**kw), device="cpu", state=state)
    with compat.set_mesh(je.mesh):
        mj = je.train_step(batches[2])
    mt = te.train_step(batches[2])
    assert mt["loss"] == pytest.approx(mj["loss"], abs=ATOL)
    _assert_state(je, te)


@pytest.mark.parametrize("name", PORTED)
def test_carry_lengths_and_wire_models_match_jax(name, mesh):
    """init_carry, the state's carry length and the two-tier wire model
    at P = 8 equal the reference's."""
    kw = _kw(name, 0.1)
    cap = dpmr.capacity(DPMRConfig(**kw), B)
    with compat.set_mesh(mesh):
        jctx = jdpmr.make_strategy_context(JaxConfig(**kw), mesh, cap)
        jlen = jdpmr.strategy_carry_len(JaxConfig(**kw), mesh)
    tctx = dpmr.make_strategy_context(DPMRConfig(**kw), None, cap)
    assert tctx.topk_frac == jctx.topk_frac == 0.1
    jc = jax_get_strategy(name).init_carry(jctx)
    tc = get_strategy(name).init_carry(tctx)
    assert (tc is None) == (jc is None)
    if tc is not None:
        assert tc.shape == jc.shape and tc.dtype == torch.float32
        assert not tc.any()
    assert dpmr.strategy_carry_len(DPMRConfig(**kw)) == jlen
    assert dpmr.init_state(DPMRConfig(**kw), "cpu").strat.shape == (jlen,)
    wide = dict(num_shards=8, block_size=F // 8, capacity=cap, topk_frac=0.1)
    assert get_strategy(name).bytes_per_device(StrategyContext(**wide)) == \
        jax_get_strategy(name).bytes_per_device(JaxContext(axes=(), **wide))


def test_registry_lists_ported_and_takes_a_decorated_class(batches):
    assert list_strategies() == PORTED

    @register_strategy("mirror_a2a")
    class Mirror(AllToAllStrategy):
        pass

    try:
        assert get_strategy("mirror_a2a").name == "mirror_a2a"
        assert get_strategy("a2a").name == "a2a"
        eng = DPMREngine(DPMRConfig(**_kw("mirror_a2a")), device="cpu")
        assert len(eng.fit_sgd(batches, steps=1)) == 1
    finally:
        strategies._REGISTRY.pop("mirror_a2a")
    assert list_strategies() == PORTED
