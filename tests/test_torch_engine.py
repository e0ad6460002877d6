"""The port's single-card trainer against the JAX engine.

Both engines train on the same numpy batches from the same seed: the JAX
`DPMREngine` on a 1x1 host mesh with `kernel_impl="pallas_interpret"`,
the port's `DPMREngine(device="cpu")` on its plain versions. Losses,
tables and probabilities agree to atol=1e-5: the same f32 arithmetic in
another order of summation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.api import DPMREngine as JaxEngine
from repro.api import get_source as jax_get_source
from repro.api import hot_ids_from_corpus as jax_hot_ids
from repro.configs.base import DPMRConfig as JaxConfig
from repro.launch.mesh import make_host_mesh
from repro_torch import DPMRConfig, DPMREngine, get_source
from repro_torch.api import hot_ids_from_corpus
from repro_torch.convert import state_from_numpy, state_to_numpy

ATOL = 1e-5
F, K, B = 1 << 12, 16, 64
CORPUS = dict(num_features=F, features_per_sample=K, signal_features=256)
TABLES = ("cold", "hot", "cold_acc", "hot_acc")


def _cfg_kw(optimizer):
    return dict(num_features=F, max_features_per_sample=K, max_hot=16,
                learning_rate=2.0 if optimizer == "adagrad" else 0.5,
                optimizer=optimizer)


@pytest.fixture(scope="module")
def batches():
    src = get_source("zipf_sparse", batch_size=B, **CORPUS)
    return [src.batch(i) for i in range(6)]


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _engines(optimizer, batches, mesh):
    kw = _cfg_kw(optimizer)
    jcfg, cfg = JaxConfig(**kw), DPMRConfig(**kw)
    jh = jax_hot_ids(jcfg, batches[:4], mesh)
    th = hot_ids_from_corpus(cfg, batches[:4], device="cpu")
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    return (JaxEngine(jcfg, mesh, kernel_impl="pallas_interpret", hot_ids=jh),
            DPMREngine(cfg, device="cpu", hot_ids=th))


def _assert_tables(je, te):
    for name in TABLES:
        np.testing.assert_allclose(getattr(te.state, name).numpy(),
                                   np.asarray(getattr(je.state, name)),
                                   atol=ATOL, err_msg=name)


def test_zipf_source_bit_identical():
    jsrc = jax_get_source("zipf_sparse", batch_size=B, num_batches=3,
                          start=1000, **CORPUS)
    tsrc = get_source("zipf_sparse", batch_size=B, num_batches=3,
                      start=1000, **CORPUS)
    for i in range(3):
        jb, tb = jsrc.batch(i), tsrc.batch(i)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    with pytest.raises(IndexError):
        tsrc.batch(3)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_fit_sgd_losses_and_tables(optimizer, batches, mesh):
    je, te = _engines(optimizer, batches, mesh)
    hj = je.fit_sgd(batches, steps=4)
    ht = te.fit_sgd(batches, steps=4)
    assert [h["step"] for h in ht] == [h["step"] for h in hj] == [1, 2, 3, 4]
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], atol=ATOL)
    assert [h["accuracy"] for h in ht] == [h["accuracy"] for h in hj]
    assert [h["overflow"] for h in ht] == [h["overflow"] for h in hj]
    _assert_tables(je, te)
    assert int(te.state.step) == int(je.state.step) == 4
    assert te.learning_rate() == pytest.approx(je.learning_rate())


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_fit_full_batch_and_predict(optimizer, batches, mesh):
    je, te = _engines(optimizer, batches, mesh)
    hj = je.fit(lambda: iter(batches[:4]), iterations=2)
    ht = te.fit(lambda: iter(batches[:4]), iterations=2)
    for a, b in zip(ht, hj, strict=True):
        assert a["iteration"] == b["iteration"]
        assert a["loss"] == pytest.approx(b["loss"], abs=ATOL)
        assert a["accuracy"] == b["accuracy"]
    _assert_tables(je, te)
    for batch in batches[4:]:
        np.testing.assert_allclose(te.predict(batch), je.predict(batch),
                                   atol=ATOL)
    mj, mt = je.evaluate(batches[4:]), te.evaluate(batches[4:])
    assert mt == pytest.approx(mj, abs=1e-12)


def test_predict_padded_and_sources(batches, mesh):
    """predict_padded pads to the bucket ladder and returns the caller's
    rows unchanged; a DataSource is read for one epoch."""
    _, te = _engines("adagrad", batches, mesh)
    src = get_source("zipf_sparse", batch_size=B, num_batches=2, **CORPUS)
    hist = te.fit_sgd(src)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    part = {k: v[:37] for k, v in batches[5].items()}
    assert te.bucket_for(37) == 64
    np.testing.assert_array_equal(te.predict_padded(part),
                                  te.predict(batches[5])[:37])
    assert set(te.evaluate(src)) >= {"f_avg", "precision_avg"}
    with pytest.raises(ValueError, match="unbounded"):
        te.fit_sgd(get_source("zipf_sparse", batch_size=B, **CORPUS))


def test_state_round_trip_then_one_step(batches, mesh):
    """A JAX state after 2 steps, carried into the port: one more step in
    each package gives the same state."""
    je, _ = _engines("adagrad", batches, mesh)
    je.fit_sgd(batches, steps=2)
    leaves = [np.asarray(x) for x in jax.tree.leaves(je.state)]
    state = state_from_numpy(leaves, "cpu")
    for a, b in zip(state_to_numpy(state), leaves, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    te = DPMREngine(DPMRConfig(**_cfg_kw("adagrad")), device="cpu",
                    state=state)
    with compat.set_mesh(mesh):
        mj = je.train_step(batches[2])
    mt = te.train_step(batches[2])
    assert mt["loss"] == pytest.approx(mj["loss"], abs=ATOL)
    _assert_tables(je, te)
    assert int(te.state.step) == 3


def test_step_fns_geometry_matches_reference(mesh):
    """capacity, block size and the a2a wire model of the one-card
    geometry equal the reference's."""
    from repro.api.strategies import get_strategy as jax_get_strategy
    from repro.core import dpmr as jdpmr
    from repro_torch.api.strategies import get_strategy
    from repro_torch.core import dpmr

    kw = _cfg_kw("sgd")
    with compat.set_mesh(mesh):
        jf = jdpmr.make_step_fns(JaxConfig(**kw), mesh, B)
    tf = dpmr.make_step_fns(DPMRConfig(**kw), B)
    assert (tf.capacity, tf.block_size, tf.num_shards, tf.strategy) == \
        (jf.capacity, jf.block_size, jf.num_shards, jf.strategy)
    assert get_strategy("a2a").bytes_per_device(tf.ctx) == \
        jax_get_strategy("a2a").bytes_per_device(jf.ctx) == (0, 0)
    assert jnp.asarray(0).dtype == jnp.int32    # jax x64 stays off
