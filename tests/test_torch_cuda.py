"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where there is no CUDA device;
the file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The kernels build with nvcc at first use (src/repro_torch/kernels/build.py).
`select_pack` only moves values and adds once, so it is held to its plain
version bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _sorted_ids(n, nruns, seed):
    """Sorted ids with n // 8 padding slots (-1) LAST."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, nruns, size=n - n // 8)).astype(np.int32)
    return np.concatenate([ids, np.full(n // 8, -1, np.int32)]), rng


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(4096, 64), (33, 7), (5, 200)])
def test_sigmoid_grad_kernel_matches_plain(cuda, b, k):
    rng = np.random.default_rng(b + k)
    vals = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    theta = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, size=(b,)).astype(np.int32))
    want = ref.sigmoid_grad_ref(vals.to(cuda), theta.to(cuda), y.to(cuda))
    before = ops.launch_counts()["sigmoid_grad"]
    got = ops.sigmoid_grad(vals.to(cuda), theta.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["sigmoid_grad"] == before + 1
    for g_, w in zip(got, want, strict=True):
        torch.testing.assert_close(g_, w, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,nruns", [(262144, 40000), (262144, 3),
                                     (5000, 1), (4097, 50)])
def test_segment_sum_kernel_matches_plain(cuda, n, nruns):
    """Integer-valued grads: totals are exact, so kernel and plain version
    agree bit for bit whatever their order of additions."""
    ids, rng = _sorted_ids(n, nruns, seed=n + nruns)
    g = rng.integers(-8, 9, size=(n,)).astype(np.float32)
    ids_t, g_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(g).to(cuda)
    got = ops.segment_sum_sorted(ids_t, g_t)
    want = ref.segment_sum_sorted_ref(ids_t, g_t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_segment_sum_kernel_edge_inputs(cuda):
    ones = torch.ones(262144, device=cuda)
    one_run = ops.segment_sum_sorted(
        torch.zeros(262144, dtype=torch.int32, device=cuda), ones)
    assert float(one_run[-1]) == 262144.0 and float(one_run.sum()) == 262144.0
    pad = ops.segment_sum_sorted(
        torch.full((3000,), -1, dtype=torch.int32, device=cuda),
        torch.ones(3000, device=cuda))
    assert not pad.any()


def _select_case(p, cap, live, seed, prefix=True):
    """(send, ids, carry) numpy inputs of select_pack: `live` live slots
    per row, as a prefix (route_build's layout) or scattered."""
    rng = np.random.default_rng(seed)
    ids = np.full((p, cap), -1, np.int32)
    for r in range(p):
        at = np.arange(live) if prefix else np.sort(
            rng.choice(cap, size=live, replace=False))
        ids[r, at] = rng.choice(1 << 27, size=live, replace=False)
    send = np.where(ids >= 0, rng.normal(size=(p, cap)), 0.0)
    carry = np.where((ids >= 0) & (rng.random((p, cap)) < 0.5),
                     rng.normal(scale=0.5, size=(p, cap)), 0.0)
    return send.astype(np.float32), ids, carry.astype(np.float32)


def _select_cases():
    path = _select_case(1, 262144, 27376, seed=1)
    equal = _select_case(2, 3000, 2500, seed=2, prefix=False)
    equal = (np.where(equal[1] >= 0, 0.5, 0.0).astype(np.float32), equal[1],
             np.zeros_like(equal[2]))
    zeros = _select_case(1, 2048, 2048, seed=3)
    rng = np.random.default_rng(3)
    sign = rng.choice([-0.0, 0.0, 1.0, -1.0], size=zeros[0].shape,
                      p=[0.3, 0.3, 0.2, 0.2]).astype(np.float32)
    zeros = (sign, zeros[1],
             rng.choice([-0.0, 0.0], size=sign.shape).astype(np.float32))
    dead = _select_case(3, 1100, 900, seed=4, prefix=False)
    dead[1][1] = -1
    few = _select_case(2, 1024, 3, seed=5)
    return {
        "path-k13108": (*path, 13108),
        "path-k65536": (*path, 65536),
        "all-keys-equal": (*equal, 1000),
        "signed-zeros": (*zeros, 1500),
        "all-dead-row": (*dead, 100),
        "3-live-below-k": (*few, 10),
        "k-1": (*dead, 1),
        "k-cap": (*dead, 1100),
        "8-rows-cap-4104": (*_select_case(8, 4104, 3000, seed=6), 411),
        "ragged-cap": (*_select_case(2, 5001, 4000, seed=7, prefix=False),
                       2501),
    }


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_select_cases()))
def test_select_pack_kernel_bit_exact(cuda, case):
    """All three outputs equal the plain version bit for bit, -0.0 and the
    order of the packed pairs included."""
    send, ids, carry, k = _select_cases()[case]
    args = [torch.from_numpy(x).to(cuda) for x in (send, ids, carry)]
    before = ops.launch_counts()["select_pack"]
    got = ops.select_pack(*args, k)
    want = ref.select_pack_ref(*args, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["select_pack"] == before + 1
    for g_, w in zip(got, want, strict=True):
        assert g_.shape == w.shape and g_.dtype == w.dtype
        assert _same_bits(g_, w)


@pytest.mark.gpu
def test_combine_and_hot_grads_bit_reproducible(cuda):
    """The combiner and the hot-set gradient reduce through sorted runs, so
    five calls on a Zipf batch give the same bits."""
    from repro_torch.configs import DPMRConfig
    from repro_torch.core import dpmr, hot_sharding, sparse
    from repro_torch.data import get_source

    cfg = DPMRConfig(num_features=1 << 20, max_features_per_sample=64)
    batch = get_source("zipf_sparse", batch_size=4096, num_features=1 << 20,
                       features_per_sample=64).batch(0)
    ids = torch.from_numpy(batch["ids"]).to(cuda).reshape(-1)
    counts = hot_sharding.feature_counts(ids, 1 << 20)
    hot = hot_sharding.select_hot(counts, cfg.hot_threshold, cfg.max_hot)
    hot_slot, is_hot, cold_ids = hot_sharding.split_hot(ids, hot)
    routing = sparse.route_build(cold_ids, 1, 1 << 20,
                                 dpmr.capacity(cfg, 4096))
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=ids.numel()).astype(np.float32)).to(cuda)
    for fn in (lambda: sparse.combine_grads(routing, g),
               lambda: dpmr.hot_grads(cfg, g, hot_slot, is_hot)):
        outs = [fn() for _ in range(5)]
        torch.cuda.synchronize()
        assert all(_same_bits(o, outs[0]) for o in outs)
        assert outs[0].any()
