"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where there is no CUDA device;
the file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The kernels build with nvcc at first use (src/repro_torch/kernels/build.py).
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
