"""The port's data plane against the JAX package's, on the CPU.

`ShardAssignment`, the sources (`zipf_sparse`, `lm_markov`,
`file_sparse`) and the `ShardedLoader` with `placement="host"` give the
same numpy batches, cursors, assignments and permutations as the
reference's, bit for bit, over 3 epochs: stride and chunk ownership,
shuffle on and off, `remainder` drop and pad, `seek`, `state_dict` and
`load_state_dict` (also across a host-count change). A corpus written by
either package is read by the other. Prefetch hands over the same
batches, moves the cursor only on hand-over and raises a producer's
error in the consumer. `fit_sgd`, `fit` and `evaluate` take the data
plane as the reference's do (F1: `steps` past one epoch rolls over, as
the reference's loader does), within atol 1e-5 of the JAX engine.
"""
import json
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

from repro.configs.base import DPMRConfig as JaxConfig
from repro.data import ShardAssignment as JaxAssignment
from repro.data import ShardedLoader as JaxLoader
from repro.data import get_source as jax_get_source
from repro.data import reassign_state as jax_reassign
from repro.data import write_file_corpus as jax_write_corpus
from repro_torch import obs
from repro_torch.configs.base import DPMRConfig
from repro_torch.data import (
    Cursor,
    ShardAssignment,
    ShardedLoader,
    get_source,
    list_sources,
    reassign_state,
    write_file_corpus,
)

ATOL = 1e-5
F, K = 1 << 12, 16
CORPUS = dict(num_features=F, features_per_sample=K, signal_features=256)


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


# ---------------------------------------------------------------------------
# ownership
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks,hosts", [(8, 2), (6, 4), (7, 3), (3, 5),
                                          (1, 1), (16, 8)])
def test_shard_assignment_matches_reference(chunks, hosts):
    n = chunks * 4 - 1          # a short last chunk
    got = ShardAssignment.chunk_aligned(chunks, hosts, batches_per_chunk=4,
                                        num_batches=n)
    want = JaxAssignment.chunk_aligned(chunks, hosts, batches_per_chunk=4,
                                       num_batches=n)
    assert got.to_dict() == want.to_dict()
    assert ShardAssignment.from_dict(got.to_dict()) == got
    for h in range(hosts):
        assert got.owned_batches(h) == want.owned_batches(h)
        assert got.steps_per_epoch(h) == want.steps_per_epoch(h)
        assert got.global_rows(h, 32) == want.global_rows(h, 32)
    for c in range(chunks):
        assert got.chunk_owner(c) == want.chunk_owner(c)
        assert got.chunk_batches(c) == want.chunk_batches(c)
    s, w = ShardAssignment.strided(n, hosts), JaxAssignment.strided(n, hosts)
    assert s.to_dict() == w.to_dict()
    for h in range(hosts):
        assert s.owned_batches(h) == w.owned_batches(h)
        assert s.steps_per_epoch(h) == w.steps_per_epoch(h)
    state = {"cursor": {"epoch": 2, "step": 3}, "num_hosts": 7,
             "host_index": 1, "assignment": got.to_dict(), "source": "x"}
    assert reassign_state(state, hosts, 0) == jax_reassign(state, hosts, 0)
    assert reassign_state(state, hosts) == jax_reassign(state, hosts)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def test_source_registries_match():
    """The port registers the reference's sources. The reference's own
    registry is read in a fresh interpreter: other test files of a worker
    register sources of their own into it (tests/test_data.py)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(pathlib.Path(__file__).resolve().parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", "import json; from repro.data import "
         "list_sources; print(json.dumps(list_sources()))"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert list_sources() == json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("encdec", [0, 8])
def test_lm_markov_bit_identical(encdec):
    kw = dict(vocab_size=97, seq_len=12, batch_size=4, seed=5,
              num_batches=3, encdec_d_model=encdec)
    got, want = get_source("lm_markov", **kw), jax_get_source("lm_markov",
                                                              **kw)
    for i in range(3):
        _same_batch(got.batch(i), want.batch(i))
    with pytest.raises(IndexError):
        got.batch(3)


def _zipf(mod, n=10, batch_size=20):
    return mod("zipf_sparse", batch_size=batch_size, num_batches=n, seed=2,
               **CORPUS)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_corpus_read_across_packages(writer, tmp_path):
    """A corpus written by either package is read by the other: the same
    manifest, the same batches, the same read counts."""
    write = write_file_corpus if writer == "port" else jax_write_corpus
    manifest = write(str(tmp_path), _zipf(get_source), batches_per_chunk=3)
    assert manifest == (jax_write_corpus if writer == "port"
                        else write_file_corpus)(str(tmp_path / "again"),
                                               _zipf(jax_get_source),
                                               batches_per_chunk=3)
    got = get_source("file_sparse", directory=str(tmp_path))
    want = jax_get_source("file_sparse", directory=str(tmp_path))
    zipf = _zipf(get_source)
    for i in (0, 1, 5, 9, 2):
        _same_batch(got.batch(i), want.batch(i))
        _same_batch(got.batch(i), zipf.batch(i))
    assert got.read_stats == want.read_stats
    for h in range(3):
        assert got.owned_shards(h, 3).to_dict() == \
            want.owned_shards(h, 3).to_dict()
    assert get_source("zipf_sparse", batch_size=4, num_batches=5,
                      **CORPUS).owned_shards(1, 2).to_dict() == \
        jax_get_source("zipf_sparse", batch_size=4, num_batches=5,
                       **CORPUS).owned_shards(1, 2).to_dict()


# ---------------------------------------------------------------------------
# the loader, placement="host"
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_file_corpus(str(d), _zipf(get_source, n=11), batches_per_chunk=2)
    return str(d)


def _loaders(ownership, corpus, **kw):
    if ownership == "chunk":
        src = get_source("file_sparse", directory=corpus)
        jsrc = jax_get_source("file_sparse", directory=corpus)
    else:
        src, jsrc = _zipf(get_source, n=11), _zipf(jax_get_source, n=11)
    kw = dict(placement="host", prefetch=0, **kw)
    return ShardedLoader(src, **kw), JaxLoader(jsrc, **kw)


def _stream_matches(got, want, steps):
    for g, w in zip(got.batches(steps), want.batches(steps), strict=True):
        _same_batch(g, w)
        assert got.cursor == Cursor(**want.cursor.to_dict())
    assert got.state_dict() == want.state_dict()


@pytest.mark.parametrize("remainder", ["drop", "pad"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("ownership", ["stride", "chunk"])
def test_loader_matches_reference_over_three_epochs(ownership, shuffle,
                                                    remainder, corpus):
    """Host 1 of 3, a divisor of 8 against batches of 20 rows: the same
    batches, cursors and state dicts for 3 epochs."""
    kw = dict(host_index=1, num_hosts=3, batch_divisor=8,
              remainder=remainder, shuffle=shuffle, shuffle_seed=7)
    got, want = _loaders(ownership, corpus, **kw)
    assert got.assignment_kind == want.assignment_kind == ownership
    assert got.steps_per_epoch == want.steps_per_epoch
    _stream_matches(got, want, 3 * got.steps_per_epoch)
    assert got.cursor.epoch == 3
    if ownership == "chunk":
        assert got.assignment.to_dict() == want.assignment.to_dict()
        assert got.source.read_stats == want.source.read_stats
    for e in range(3):
        if ownership == "chunk":
            np.testing.assert_array_equal(got._owned_order(e),
                                          want._owned_order(e))
        elif shuffle:
            np.testing.assert_array_equal(got._permutation(e),
                                          want._permutation(e))


@pytest.mark.parametrize("ownership", ["stride", "chunk"])
def test_loader_seek_and_state_dict(ownership, corpus):
    """seek, epoch(), take() and a state dict carried from one loader to a
    new one (also across a host-count change, "reassign") continue the
    reference's streams."""
    kw = dict(host_index=0, num_hosts=2, shuffle=True, shuffle_seed=3)
    got, want = _loaders(ownership, corpus, **kw)
    got.seek({"epoch": 1, "step": 2})
    want.seek({"epoch": 1, "step": 2})
    _stream_matches(got, want, 3)
    for g, w in zip(got.epoch(), want.epoch(), strict=True):
        _same_batch(g, w)
    assert got.cursor == Cursor(**want.cursor.to_dict())
    _same_batch(got.take(1)[0], want.take(1)[0])
    saved = got.state_dict()
    assert saved == want.state_dict()
    got2, want2 = _loaders(ownership, corpus, **kw)
    got2.load_state_dict(saved)
    want2.load_state_dict(saved)
    _stream_matches(got2, want2, 4)
    # three hosts now: the epoch survives, the step restarts
    got3, want3 = _loaders(ownership, corpus, host_index=2, num_hosts=3,
                           shuffle=True, shuffle_seed=3)
    with pytest.warns(RuntimeWarning, match="reassigning"):
        got3.load_state_dict(saved, on_host_change="reassign")
    with pytest.warns(RuntimeWarning, match="reassigning"):
        want3.load_state_dict(saved, on_host_change="reassign")
    assert got3.cursor == Cursor(saved["cursor"]["epoch"], 0)
    _stream_matches(got3, want3, 4)
    with pytest.raises(ValueError, match="num_hosts=2"):
        _loaders(ownership, corpus, host_index=0,
                 num_hosts=3)[0].load_state_dict(saved)


def test_loader_refuses_what_the_reference_refuses(corpus):
    src = _zipf(get_source, n=11)
    with pytest.raises(ValueError, match="remainder"):
        ShardedLoader(src, placement="host", remainder="keep")
    with pytest.raises(ValueError, match="fewer than one batch"):
        ShardedLoader(src, placement="host", host_index=0, num_hosts=12)
    with pytest.raises(ValueError, match="owns no chunks"):
        ShardedLoader(get_source("file_sparse", directory=corpus),
                      placement="host", host_index=7, num_hosts=8)
    with pytest.raises(ValueError, match="bounded epoch"):
        ShardedLoader(get_source("zipf_sparse", batch_size=4, **CORPUS),
                      placement="host", shuffle=True)
    with pytest.raises(ValueError, match="smaller than the mesh"):
        ShardedLoader(get_source("zipf_sparse", batch_size=4,
                                 num_batches=2, **CORPUS),
                      placement="host", batch_divisor=8).take(1)
    loader = ShardedLoader(src, placement="host", prefetch=0)
    it = loader.batches(3)
    next(it)
    loader.seek(Cursor(0, 0))
    with pytest.raises(RuntimeError, match="repositioned"):
        next(it)


# ---------------------------------------------------------------------------
# prefetch and placement
# ---------------------------------------------------------------------------


def test_prefetch_hands_over_the_same_batches_and_moves_the_cursor():
    src = _zipf(get_source, n=6)
    plain = ShardedLoader(src, placement="host", prefetch=0).take(8)
    loader = ShardedLoader(src, placement="host", prefetch=3)
    obs.reset_counts("loader.")
    it = loader.batches(8)
    first = next(it)
    # the producer runs ahead; the cursor counts what was handed over
    assert loader.cursor == Cursor(0, 1)
    rest = list(it)
    for g, w in zip([first, *rest], plain, strict=True):
        _same_batch(g, w)
    assert loader.cursor == Cursor(1, 2)
    waited = obs.counts("loader.")
    assert waited["loader.batches"] == 8 and waited["loader.wait_s"] >= 0


def test_prefetch_raises_the_producers_error():
    class Broken:
        name, batch_size, num_batches = "broken", 4, 5

        def batch(self, index):
            if index == 2:
                raise OSError("chunk 2 is unreadable")
            return {"ids": np.zeros((4, 2), np.int32)}

    loader = ShardedLoader(Broken(), placement="host", prefetch=2)
    got = []
    with pytest.raises(OSError, match="chunk 2"):
        for b in loader.batches(5):
            got.append(b)
    assert len(got) == 2 and loader.cursor == Cursor(0, 2)


def test_sharded_placement_cuts_this_ranks_rows_on_the_device():
    """One rank: every row, in the kernels' dtypes, as a RankBatch; the
    card is the default device."""
    import torch

    from repro_torch.data.loader import RankBatch

    src = _zipf(get_source, n=2)
    b = ShardedLoader(src, device="cpu").take(1)[0]
    assert isinstance(b, RankBatch) and b.global_size == 20
    assert b["ids"].dtype == torch.int32 and b["vals"].dtype == torch.float32
    np.testing.assert_array_equal(b["ids"].numpy(), src.batch(0)["ids"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedLoader(src)


# ---------------------------------------------------------------------------
# the engine's data plane (F1)
# ---------------------------------------------------------------------------


def _engines(strategy="a2a"):
    from repro.api import DPMREngine as JaxEngine
    from repro.launch.mesh import make_host_mesh
    from repro_torch import DPMREngine

    kw = dict(num_features=F, max_features_per_sample=K, max_hot=16,
              learning_rate=2.0, optimizer="adagrad", distribution=strategy,
              topk_frac=0.05)
    return (JaxEngine(JaxConfig(**kw), make_host_mesh(1, 1)),
            DPMREngine(DPMRConfig(**kw), device="cpu"))


def _close_tables(je, te):
    for name in ("cold", "hot", "cold_acc", "hot_acc", "strat"):
        np.testing.assert_allclose(getattr(te.state, name).numpy(),
                                   np.asarray(getattr(je.state, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_fit_sgd_rolls_over_epochs_like_the_reference():
    """F1: `fit_sgd(source, steps=10)` over a 4-batch source trains 10
    steps, rolling into later epochs, as the reference's loader does."""
    je, te = _engines()
    spec = dict(batch_size=64, num_batches=4, **CORPUS)
    hj = je.fit_sgd(jax_get_source("zipf_sparse", **spec), steps=10)
    ht = te.fit_sgd(get_source("zipf_sparse", **spec), steps=10)
    assert len(ht) == len(hj) == 10
    assert [h["step"] for h in ht] == list(range(1, 11))
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], atol=ATOL)
    _close_tables(je, te)
    assert te.host_step() == int(te.state.step) == 10
    # a source name and spec=: one epoch without steps, rolling with them
    assert len(te.fit_sgd("zipf_sparse", spec=spec)) == 4
    assert len(te.fit_sgd("zipf_sparse", steps=6, spec=spec)) == 6
    with pytest.raises(TypeError, match="spec="):
        te.fit_sgd(get_source("zipf_sparse", **spec), spec=spec)


def test_fit_and_evaluate_through_a_loader():
    """`fit` over a loader takes one full epoch an iteration (a mid-epoch
    cursor rewinds); `evaluate` scores one epoch and leaves the cursor."""
    je, te = _engines("topk_reduce")
    spec = dict(batch_size=64, num_batches=3, **CORPUS)
    jl = JaxLoader(jax_get_source("zipf_sparse", **spec), None,
                   placement="host", host_index=0, num_hosts=1)
    tl = ShardedLoader(get_source("zipf_sparse", **spec), device="cpu",
                       host_index=0, num_hosts=1)
    je.fit_sgd(jl, steps=2)
    te.fit_sgd(tl, steps=2)
    assert tl.cursor == Cursor(0, 2)
    fj, ft = je.fit(jl, iterations=2), te.fit(tl, iterations=2)
    for a, b in zip(ft, fj, strict=True):
        assert a["loss"] == pytest.approx(b["loss"], abs=ATOL)
    _close_tables(je, te)
    assert tl.cursor == Cursor(**jl.cursor.to_dict())
    test = dict(batch_size=64, num_batches=2, start=100, **CORPUS)
    mark = tl.cursor
    mt = te.evaluate("zipf_sparse", spec=test)
    mj = je.evaluate("zipf_sparse", spec=test)
    assert mt == pytest.approx(mj, abs=1e-12)
    assert te.evaluate(tl) == pytest.approx(je.evaluate(jl), abs=1e-12)
    assert tl.cursor == mark


def test_core_api_exports_the_reference_less_the_dense_helpers():
    import repro.core.api as jax_api
    import repro_torch.core.api as api

    left_out = set()           # the dense helpers came with the mesh
    assert set(api.__all__) == set(jax_api.__all__) - left_out
    for name in api.__all__:
        assert getattr(api, name) is not None


def test_load_imbalance_matches_reference():
    import jax.numpy as jnp
    import torch

    from repro.core.hot_sharding import load_imbalance as jax_imbalance
    from repro_torch.core.hot_sharding import load_imbalance

    ids = get_source("zipf_sparse", batch_size=64, num_batches=1,
                     **CORPUS).batch(0)["ids"].reshape(-1)
    for p in (1, 4, 8):
        got = load_imbalance(torch.as_tensor(ids), p, F // p)
        want = jax_imbalance(jnp.asarray(ids), p, F // p)
        assert float(got) == float(want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert float(load_imbalance(torch.full((4,), -1), 2, 8)) == 0.0
