"""The port's sparse serving (`repro_torch.serve`) against the JAX
package's (`repro.serve`), at one rank on the CPU.

Each engine of the port starts from the reference's trained state,
carried across with `convert.state_from_numpy`, so both serve the same
parameters. Every served answer must be bit-identical to the port's own
`predict_padded` of that request (hot-cache hits included) and within
1e-5 of the reference's (the same f32 arithmetic in another order of
summation). The cases of tests/test_serving.py and the hot-cache cases
of tests/test_hot_sharding.py are covered one for one; on the
sequential hot trace of benchmarks/serving.py the cache's hits, misses
and refreshes equal the reference's exactly; the cache's selection from
distinct ids equals `select_hot(feature_counts(...))` bit for bit; a
checkpoint the JAX engine wrote is served by the port.
"""
import sys
import threading
import time

from hypothesis import given, settings
from hypothesis import strategies as st
import jax
import numpy as np
import pytest
import torch

from repro.api import DPMREngine as JaxEngine
from repro.api import hot_ids_from_corpus as jax_hot_ids
from repro.configs.base import DPMRConfig as JaxConfig
from repro.launch.mesh import make_host_mesh
from repro.serve import HotCacheConfig as JaxHotCacheConfig
from repro.serve import HotFeatureCache as JaxHotFeatureCache
from repro.serve import ServeMetrics as JaxServeMetrics
from repro_torch import DPMRConfig, DPMREngine, get_source
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.convert import state_from_numpy
from repro_torch.core import dpmr, hot_sharding
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    BatchingConfig,
    DPMRServeEngine,
    HotCacheConfig,
    HotFeatureCache,
    MicroBatcher,
    ServeMetrics,
)
from repro_torch.serve.hot_cache import select_hot_ids

ATOL = 1e-5
F = 1 << 10
K = 8


def _leaves(jeng):
    return [np.asarray(x) for x in jax.tree.leaves(jeng.state)]


def _pair(kw, batches, steps, hot=False):
    """(JAX engine trained `steps` steps, the port's engine on its state)."""
    mesh = make_host_mesh(1, 1)
    hot_ids = jax_hot_ids(JaxConfig(**kw), batches[:4], mesh) if hot \
        else None
    jeng = JaxEngine(JaxConfig(**kw), mesh, hot_ids=hot_ids)
    jeng.fit_sgd(batches, steps=steps)
    teng = DPMREngine(DPMRConfig(**kw), device="cpu",
                      state=state_from_numpy(_leaves(jeng), "cpu"))
    return jeng, teng


def _source(batch_size=4, num_batches=16, seed=0, features=F, k=K):
    return get_source("zipf_sparse", batch_size=batch_size,
                      num_batches=num_batches, num_features=features,
                      features_per_sample=k, seed=seed)


def _req(src, i, n=None):
    b = src.batch(i)
    return b["ids"][:n], b["vals"][:n]


@pytest.fixture(scope="module")
def engines():
    """One trained pair shared by the read-only serving tests (tests that
    train further build their own), as tests/test_serving.py's fixture."""
    kw = dict(num_features=F, max_features_per_sample=K, max_hot=16)
    src = _source()
    return _pair(kw, [src.batch(i) for i in range(16)], steps=8)


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def _check(engines, reqs, got):
    """Each answer bit-identical to the port's predict_padded of that
    request alone, and within 1e-5 of the reference's."""
    jeng, teng = engines
    for (ids, vals), g in zip(reqs, got, strict=True):
        g = np.asarray(g)
        np.testing.assert_array_equal(
            g, teng.predict_padded({"ids": ids, "vals": vals}))
        np.testing.assert_allclose(
            g, np.asarray(jeng.predict({"ids": ids, "vals": vals})),
            atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# predict_padded and the bucket ladder
# ---------------------------------------------------------------------------


def test_predict_padded_bit_identical(engines):
    jeng, teng = engines
    src = _source(batch_size=5)
    b = src.batch(0)
    for n in (1, 2, 3, 5):
        batch = {"ids": b["ids"][:n], "vals": b["vals"][:n]}
        padded = teng.predict_padded(batch)
        np.testing.assert_array_equal(padded, teng.predict(batch))
        np.testing.assert_allclose(padded, np.asarray(jeng.predict(batch)),
                                   atol=ATOL, rtol=0)


def test_predict_padded_reuses_bucketed_step_fns(engine):
    before = set(engine._fns)
    b = _source(batch_size=8).batch(0)
    for n in (5, 6, 7, 8):                  # all bucket to 8
        engine.predict_padded({"ids": b["ids"][:n], "vals": b["vals"][:n]})
    new = set(engine._fns) - before
    assert new <= {8}, f"sizes 5..8 must share the 8-row entry, got {new}"


@pytest.mark.parametrize("n, buckets, want", [
    (1, None, 1), (2, None, 2), (3, None, 4), (4, None, 4), (5, None, 8),
    (9, None, 16), (3, (4, 16), 4), (5, (4, 16), 16),
    (17, (4, 16), "largest bucket"), (0, None, "positive")])
def test_bucket_for(engines, n, buckets, want):
    """The ladder and its errors, as the reference's."""
    jeng, teng = engines
    if isinstance(want, str):
        for eng in (jeng, teng):
            with pytest.raises(ValueError, match=want):
                eng.bucket_for(n, buckets)
        return
    assert teng.bucket_for(n, buckets) == jeng.bucket_for(n, buckets) == want


def test_row_probs_do_not_depend_on_the_batch():
    """The predict step's row arithmetic gives each row the same bits at
    every batch size (a fixed halving tree; the sigmoid in f64), K a
    power of two or not."""
    gen = torch.Generator().manual_seed(0)
    for k in (1, 5, 8, 64):
        vals = torch.randn((300, k), generator=gen)
        theta = torch.randn((300, k), generator=gen)
        whole = dpmr.row_probs(vals, theta)
        for lo, hi in ((0, 1), (1, 4), (7, 40), (100, 300)):
            assert torch.equal(dpmr.row_probs(vals[lo:hi], theta[lo:hi]),
                               whole[lo:hi])
        want = 1 / (1 + np.exp(-(vals.double() * theta.double()).sum(-1)
                               .numpy()))
        np.testing.assert_allclose(whole.numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# coalescing correctness
# ---------------------------------------------------------------------------


def test_concurrent_requests_match_sequential_predict(engines):
    """3 client threads through the coalescer == per-request predict."""
    src = _source(num_batches=12, seed=1)
    reqs = [_req(src, i) for i in range(12)]
    results: list = [None] * len(reqs)
    srv = DPMRServeEngine(engines[1],
                          batching=BatchingConfig(max_batch=16,
                                                  max_wait_ms=5.0),
                          hot_cache=None)     # pure batcher path

    def client(lo, hi):
        for i in range(lo, hi):
            results[i] = srv.submit(*reqs[i])

    threads = [threading.Thread(target=client, args=(c * 4, c * 4 + 4))
               for c in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    got = [np.asarray(f.result(timeout=120)) for f in results]
    srv.stop()
    _check(engines, reqs, got)
    m = srv.metrics_snapshot()
    assert m["requests"] == 12 and m["flushes"] >= 1


def test_mixed_request_sizes_share_buckets(engines):
    """Mixed sizes stay bit-correct AND don't build one entry per size."""
    srv = DPMRServeEngine(engines[1],
                          batching=BatchingConfig(max_batch=8,
                                                  max_wait_ms=1.0),
                          hot_cache=None)
    src = _source(batch_size=5, seed=2)
    sizes = [1, 2, 3, 4, 5, 1, 3, 5]
    reqs = [_req(src, i, n) for i, n in enumerate(sizes)]
    futs = [srv.submit(*r) for r in reqs]
    got = [np.asarray(f.result(timeout=120)) for f in futs]
    srv.stop()
    _check(engines, reqs, got)
    # every flush padded to the power-of-two ladder {1,2,4,8}
    assert all(s in (1, 2, 4, 8) for s in srv.metrics._flush_padded)


def test_hot_cache_hits_inside_serve_engine(engines):
    """End-to-end: a Zipf-head request short-circuits the queue and still
    answers bit-identically."""
    srv = DPMRServeEngine(
        engines[1], batching=BatchingConfig(max_batch=8, max_wait_ms=1.0),
        hot_cache=HotCacheConfig(max_hot=64, threshold=0.0, window=64,
                                 refresh_every=1000))
    req = _req(_source(seed=3), 0)
    first = np.asarray(srv.submit(*req).result(timeout=120))
    again = np.asarray(srv.submit(*req).result(timeout=120))
    srv.stop()
    m = srv.metrics_snapshot()
    assert m["cache_hits"] == 2 and m.get("cache_misses", 0) == 0, m
    assert m.get("flushes", 0) == 0, m
    np.testing.assert_array_equal(first, again)
    _check(engines, [req], [first])


def test_many_clients_under_a_short_switch_interval(engines):
    """Stress: 16 client threads, more than the cores, with the interpreter
    switching threads every microsecond: every request is answered with
    its own rows' bits, and the counters add up (requests, samples, hits
    and misses, the flushes by reason, and the rows flushed plus the rows
    the cache answered)."""
    src = _source(batch_size=3, num_batches=64, seed=12)
    reqs = [_req(src, i, 1 + i % 3) for i in range(64)]
    srv = DPMRServeEngine(
        engines[1], batching=BatchingConfig(max_batch=8, max_wait_ms=0.5),
        hot_cache=HotCacheConfig(max_hot=32, threshold=0.0, window=8,
                                 refresh_every=3))
    hit_rows, lock = [], threading.Lock()
    lookup = srv.cache.lookup

    def counted(ids, vals):
        probs = lookup(ids, vals)
        if probs is not None:
            with lock:
                hit_rows.append(len(ids))
        return probs

    srv.cache.lookup = counted
    results: list = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), 16):
            results[i] = srv.submit(*reqs[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        got = [np.asarray(f.result(timeout=120)) for f in results]
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    _check(engines, reqs, got)
    m = srv.metrics_snapshot()
    samples = sum(len(r[0]) for r in reqs)
    assert m["requests"] == 64 and m["samples"] == samples
    assert m.get("cache_hits", 0) == len(hit_rows)
    assert m.get("cache_hits", 0) + m.get("cache_misses", 0) == 64
    assert sum(m.get(f"flush_{r}", 0) for r in ("full", "deadline", "drain")
               ) == m.get("flushes", 0) == len(srv.metrics._flush_rows)
    assert sum(srv.metrics._flush_rows) + sum(hit_rows) == samples


# ---------------------------------------------------------------------------
# lifecycle: deadline, full, drain, stop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reason", ["deadline", "full", "drain"])
def test_flush_reasons(engines, reason):
    """A lone partial request flushes at its deadline; two requests of 4
    rows fill max_batch 8 long before an hour-long window; stop() drains
    what an hour-long window still holds, answering every request."""
    src = _source(seed={"deadline": 4, "full": 5, "drain": 6}[reason])
    batching = {"deadline": BatchingConfig(max_batch=512, max_wait_ms=30.0),
                "full": BatchingConfig(max_batch=8, max_wait_ms=3.6e6),
                "drain": BatchingConfig(max_batch=1024,
                                        max_wait_ms=3.6e6)}[reason]
    srv = DPMRServeEngine(engines[1], batching=batching, hot_cache=None)
    reqs = [_req(src, i) for i in range({"deadline": 1, "full": 2,
                                         "drain": 3}[reason])]
    futs = [srv.submit(*r) for r in reqs]
    if reason == "drain":
        srv.stop()                      # nobody waits out the hour
        assert all(f.done() for f in futs)
    got = [np.asarray(f.result(timeout=120)) for f in futs]
    m = srv.metrics_snapshot()
    srv.stop()
    _check(engines, reqs, got)
    assert m[f"flush_{reason}"] >= 1
    if reason == "deadline":
        assert m["flush_deadline"] == 1 and m.get("flush_full", 0) == 0
        assert m["batch_mean"] == 4.0       # partial: far below max_batch


def test_submit_after_stop_raises(engine):
    srv = DPMRServeEngine(engine, hot_cache=None)
    srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(*_req(_source(seed=7), 0))


def test_stop_is_idempotent_and_restartable(engines):
    srv = DPMRServeEngine(engines[1], hot_cache=None)
    srv.stop()
    srv.stop()
    srv.start()                          # state stayed resident
    req = _req(_source(seed=8), 0)
    got = np.asarray(srv.submit(*req).result(timeout=120))
    srv.stop()
    _check(engines, [req], [got])


def test_predict_fn_exception_fails_futures_not_queue():
    calls = []

    def boom(ids, vals):
        calls.append(len(ids))
        raise RuntimeError("kaboom")

    with MicroBatcher(boom, BatchingConfig(max_batch=4, max_wait_ms=1.0),
                      ServeMetrics()) as mb:
        f1 = mb.submit(np.zeros((1, 4), np.int32), np.zeros((1, 4)))
        with pytest.raises(RuntimeError, match="kaboom"):
            f1.result(timeout=60)
        # the queue survives a failing batch: the next request still flushes
        f2 = mb.submit(np.zeros((2, 4), np.int32), np.zeros((2, 4)))
        with pytest.raises(RuntimeError, match="kaboom"):
            f2.result(timeout=60)
    assert calls == [1, 2]


def test_run_on_flusher_runs_between_flushes():
    """Work handed to the flusher runs on its thread, returns its result
    or raises its error there, and is refused once the batcher stops."""
    threads = []
    mb = MicroBatcher(lambda ids, vals: np.zeros(len(ids)),
                      BatchingConfig(max_batch=4, max_wait_ms=1.0))
    mb.start()
    fut = mb.submit(np.zeros((1, 4), np.int32), np.zeros((1, 4)))
    assert mb.run_on_flusher(
        lambda: threads.append(threading.current_thread().name) or 7) == 7
    with pytest.raises(ZeroDivisionError):
        mb.run_on_flusher(lambda: 1 / 0)
    fut.result(timeout=60)
    mb.stop()
    assert threads == ["dpmr-serve-flusher"]
    with pytest.raises(RuntimeError, match="stopped"):
        mb.run_on_flusher(lambda: None)


def test_request_validation(engines):
    srv = DPMRServeEngine(engines[1], hot_cache=None)
    ids, vals = _req(_source(seed=9), 0)
    # 1-D single-sample requests are promoted to (1, K)
    one = np.asarray(srv.submit(ids[0], vals[0]).result(timeout=120))
    assert one.shape == (1,)
    # short rows pad to the engine's K
    short = np.asarray(
        srv.submit(ids[:1, :3], vals[:1, :3]).result(timeout=120))
    wide_ids = np.concatenate([ids[:1, :3],
                               np.full((1, K - 3), -1, np.int32)], axis=1)
    wide_vals = np.concatenate([vals[:1, :3], np.zeros((1, K - 3))], axis=1)
    _check(engines, [(wide_ids, wide_vals.astype(np.float32))], [short])
    with pytest.raises(ValueError, match="max_features_per_sample"):
        srv.submit(np.zeros((1, K + 1), np.int32), np.zeros((1, K + 1)))
    with pytest.raises(ValueError, match="one shape"):
        srv.submit(ids[:2], vals[:1])
    srv.stop()


# ---------------------------------------------------------------------------
# restore-into-serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_restore_into_serving_roundtrip(writer, tmp_path):
    """A checkpoint of 6 steps, written by the port's engine or by the JAX
    engine, restored into serving: its answers are the live engine's."""
    kw = dict(num_features=F, max_features_per_sample=K, max_hot=16)
    src = _source(seed=10)
    jeng, live = _pair(kw, [src.batch(i) for i in range(6)], steps=6)
    (live if writer == "port" else jeng).save(str(tmp_path))
    srv = DPMRServeEngine.from_checkpoint(
        DPMRConfig(**kw), str(tmp_path), device="cpu",
        batching=BatchingConfig(max_batch=8, max_wait_ms=1.0))
    assert srv.engine.host_step() == 6
    reqs = [_req(_source(seed=11), i) for i in range(3)]
    got = [np.asarray(srv.submit(*r).result(timeout=120)) for r in reqs]
    srv.stop()
    for (ids, vals), g in zip(reqs, got, strict=True):
        np.testing.assert_array_equal(
            g, live.predict({"ids": ids, "vals": vals}))
    _check((jeng, srv.engine), reqs, got)


@pytest.mark.parametrize("case", ["dense", "empty"])
def test_from_checkpoint_refuses(case, tmp_path):
    """A dense checkpoint is refused by name, an empty directory with
    FileNotFoundError; both packages alike."""
    cfg = DPMRConfig(num_features=F, max_features_per_sample=K)
    if case == "dense":
        Checkpointer(str(tmp_path)).save(
            0, [torch.zeros(3)], extra={"kind": "lm_dense"})
        with pytest.raises(ValueError, match="not a sparse DPMR checkpoint"):
            DPMRServeEngine.from_checkpoint(cfg, str(tmp_path),
                                            device="cpu")
        return
    with pytest.raises(FileNotFoundError):
        DPMRServeEngine.from_checkpoint(cfg, str(tmp_path), device="cpu")


def test_from_checkpoint_needs_a_card_unless_told(tmp_path):
    """Restore-into-serving and `launch.serve --sparse` run on the card by
    default, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: serving runs on it")
    kw = dict(num_features=F, max_features_per_sample=K, max_hot=16)
    DPMREngine(DPMRConfig(**kw), device="cpu").save(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPMRServeEngine.from_checkpoint(DPMRConfig(**kw), str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--sparse", "--ckpt", str(tmp_path)])


def test_from_checkpoint_silences_only_the_cursor_warning(tmp_path):
    """A checkpoint with a data cursor restores into serving without the
    "no loader" warning; a strategy mismatch still warns."""
    import warnings

    kw = dict(num_features=F, max_features_per_sample=K, max_hot=16)
    eng = DPMREngine(DPMRConfig(**kw), device="cpu")
    eng.fit_sgd("zipf_sparse", steps=2,
                spec=dict(batch_size=8, num_features=F,
                          features_per_sample=K))
    eng.save(str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DPMRServeEngine.from_checkpoint(DPMRConfig(**kw), str(tmp_path),
                                        device="cpu").stop()
    with pytest.warns(RuntimeWarning, match="this engine uses 'allgather'"):
        DPMRServeEngine.from_checkpoint(
            DPMRConfig(distribution="allgather", **kw), str(tmp_path),
            device="cpu").stop()


# ---------------------------------------------------------------------------
# the hot cache (tests/test_hot_sharding.py's serving cases)
# ---------------------------------------------------------------------------

HOT_KW = dict(num_features=F, max_features_per_sample=8, max_hot=16,
              hot_threshold=0.001)


def _trained(steps=8):
    """A pair with a real model-hot set, so the mirror gathers from BOTH
    the replicated hot table and the cold table."""
    src = _source(batch_size=8, num_batches=8, seed=3)
    batches = [src.batch(i) for i in range(8)]
    jeng, teng = _pair(HOT_KW, batches, steps, hot=True)
    assert int((teng.state.hot_ids != hot_sharding.INT_MAX).sum()) > 0
    return jeng, teng, src


def _caches(jeng, teng, **kw):
    cfg = dict(max_hot=64, threshold=0.0, window=64, refresh_every=1000)
    cfg.update(kw)
    return (JaxHotFeatureCache(jeng, JaxHotCacheConfig(**cfg),
                               JaxServeMetrics()),
            HotFeatureCache(teng, HotCacheConfig(**cfg), ServeMetrics()))


def _counters(cache):
    m = cache.metrics.snapshot()
    return {k: m.get(k, 0) for k in (
        "cache_hits", "cache_misses", "cache_refreshes",
        "cache_stale_refreshes", "cache_step_refreshes")}


def test_cached_hit_bit_identical_to_sparse_path():
    jeng, teng, src = _trained()
    jc, tc = _caches(jeng, teng)
    ids, vals = _req(src, 0)
    for c in (jc, tc):
        c.observe(ids)
    got = tc.lookup(ids, vals)
    assert got is not None, "fully-observed request must hit"
    np.testing.assert_array_equal(
        got, teng.predict({"ids": ids, "vals": vals}))   # bit-exact
    np.testing.assert_allclose(got, np.asarray(jc.lookup(ids, vals)),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.hot_ids, jc.hot_ids)
    assert _counters(tc) == _counters(jc)
    assert _counters(tc)["cache_hits"] == 1


def test_unseen_feature_misses():
    jeng, teng, src = _trained()
    ids, vals = _req(src, 0)
    other = np.full_like(ids, -1)
    other[0, 0] = (int(ids.max()) + 1) % F    # a feature never observed
    for c in _caches(jeng, teng):
        c.observe(ids)
        assert c.lookup(ids, vals) is not None   # builds the mirror
        assert c.lookup(other, vals) is None
        assert c.metrics.snapshot()["cache_misses"] == 1


def test_staleness_bound_forces_refresh():
    jeng, teng, src = _trained()
    ids, vals = _req(src, 0)
    counters = []
    for c in _caches(jeng, teng, refresh_every=3):
        c.observe(ids)
        for _ in range(7):
            assert c.lookup(ids, vals) is not None
        counters.append(_counters(c))
        # 7 lookups at refresh_every=3: initial gather + 2 staleness ones
        assert c.staleness == 1               # one lookup since the last
    assert counters[0] == counters[1]
    assert counters[1]["cache_refreshes"] == 3
    assert counters[1]["cache_stale_refreshes"] == 2


def test_step_change_refreshes_and_tracks_new_params():
    """Training moves the resident parameters between lookups: the mirror
    notices the step change (counted on the host) and re-gathers BEFORE
    answering, and the port keeps the reference's answers."""
    jeng, teng, src = _trained()
    jc, tc = _caches(jeng, teng)
    ids, vals = _req(src, 0)
    for c in (jc, tc):
        c.observe(ids)
    before = tc.lookup(ids, vals)
    jc.lookup(ids, vals)
    assert before is not None
    batches = [src.batch(i) for i in range(8)]
    jeng.fit_sgd(batches, steps=4)
    teng.fit_sgd(batches, steps=4)
    assert teng.host_step() == 12
    after = tc.lookup(ids, vals)
    ref = np.asarray(jc.lookup(ids, vals))
    assert after is not None
    assert _counters(tc) == _counters(jc)
    assert _counters(tc)["cache_step_refreshes"] == 1
    assert not np.array_equal(before, after), "params moved; so must probs"
    np.testing.assert_array_equal(after,
                                  teng.predict({"ids": ids, "vals": vals}))
    np.testing.assert_allclose(after, ref, atol=1e-4, rtol=0)


def test_freshness_reads_the_host_step():
    """After the first read, freshness never asks the state for its step:
    a lookup on a state whose step cannot be read still hits."""
    jeng, teng, src = _trained()
    tc = _caches(jeng, teng)[1]
    ids, vals = _req(src, 0)
    tc.observe(ids)
    assert tc.lookup(ids, vals) is not None
    teng._state = teng.state._replace(step=None)   # int(None) would raise
    assert tc.lookup(ids, vals) is not None


def test_window_eviction_drops_old_features():
    jeng, teng, src = _trained()
    ids0, vals0 = _req(src, 0)
    ids1, _ = _req(src, 1)
    only0 = set(np.unique(ids0[ids0 >= 0])) - set(np.unique(ids1[ids1 >= 0]))
    assert only0, "the zipf draw has ids in request 0 alone"
    for c in _caches(jeng, teng, window=2, refresh_every=1):
        c.observe(ids0)
        assert c.lookup(ids0, vals0) is not None
        # push two newer requests through a window of 2: ids0 falls out
        c.observe(ids1)
        c.observe(ids1)
        assert c.lookup(ids0, vals0) is None


def test_empty_window_never_hits():
    jeng, teng, src = _trained()
    ids, vals = _req(src, 0)
    for c in _caches(jeng, teng, max_hot=8, window=4, refresh_every=10):
        assert c.lookup(ids, vals) is None    # nothing observed yet
        assert c.hot_ids.size == 0


def test_hot_trace_counters_equal_the_reference():
    """benchmarks/serving.py's deterministic hot trace at its size (4096
    features, K 8, 96 single-sample requests, max_hot 512, window 256,
    refresh_every 4, threshold 0), processed sequentially by both caches
    over the same state: hits, misses and refreshes equal, every hit
    bit-identical to the port's predict and within 1e-5 of the
    reference's."""
    kw = dict(num_features=1 << 12, max_features_per_sample=8, max_hot=16)
    src = _source(batch_size=16, num_batches=8, seed=7, features=1 << 12)
    jeng, teng = _pair(kw, [src.batch(i) for i in range(8)], steps=8)
    jc, tc = _caches(jeng, teng, max_hot=512, window=256, refresh_every=4)
    trace = _source(batch_size=1, num_batches=96, seed=0, features=1 << 12)
    hits = 0
    for i in range(96):
        ids, vals = _req(trace, i)
        jc.observe(ids)
        tc.observe(ids)
        ref, got = jc.lookup(ids, vals), tc.lookup(ids, vals)
        assert (ref is None) == (got is None), i
        if got is not None:
            hits += 1
            np.testing.assert_array_equal(
                got, teng.predict({"ids": ids, "vals": vals}))
            np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL,
                                       rtol=0)
        np.testing.assert_array_equal(tc.hot_ids, jc.hot_ids)
    assert _counters(tc) == _counters(jc)
    assert hits > 0 and _counters(tc)["cache_misses"] > 0
    assert _counters(tc)["cache_refreshes"] == 24


@settings(max_examples=60, deadline=None)
@given(ids=st.lists(st.integers(-3, 70), max_size=200),
       threshold=st.sampled_from([-1.0, 0.0, 1e-3, 0.01, 0.05, 0.2, 1.0]),
       max_hot=st.integers(1, 40))
def test_selection_from_distinct_ids_equals_select_hot(ids, threshold,
                                                       max_hot):
    """The cache's selection equals select_hot(feature_counts(...)) bit for
    bit: ids out of [0, F) dropped, ties to the lower id, INT_MAX padding."""
    f = 64
    t = torch.tensor(ids, dtype=torch.int32)
    want = hot_sharding.select_hot(hot_sharding.feature_counts(t, f),
                                   threshold, max_hot)
    got = select_hot_ids(t, f, threshold, max_hot)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


def test_cache_at_p_ranks_needs_the_serve_engine(engine):
    """Without a process group the cache gathers from the state; an engine
    with one holds only its owned block, so a cache built without the
    serve engine's gather is refused."""
    class Grouped:
        mesh = object()

    with pytest.raises(ValueError, match="DPMRServeEngine"):
        HotFeatureCache(Grouped(), HotCacheConfig())
    assert HotFeatureCache(engine, HotCacheConfig()).engine is engine


def test_hit_path_makes_no_device_call(engines, monkeypatch):
    """A fresh hit is computed on the host: no predict step runs."""
    srv = DPMRServeEngine(
        engines[1], batching=BatchingConfig(max_batch=8, max_wait_ms=1.0),
        hot_cache=HotCacheConfig(max_hot=64, threshold=0.0, window=64,
                                 refresh_every=1000))
    req = _req(_source(seed=3), 1)
    srv.submit(*req).result(timeout=120)        # builds the mirror
    monkeypatch.setattr(srv.engine, "predict", None)
    monkeypatch.setattr(srv.engine, "step_fns", None)
    t0 = time.monotonic()
    got = srv.submit(*req).result(timeout=120)
    assert time.monotonic() - t0 < 60
    srv.stop()
    monkeypatch.undo()
    assert srv.metrics_snapshot()["cache_hits"] == 2
    _check(engines, [req], [got])
