"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where there is no CUDA device;
the file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The kernels build with nvcc at first use (src/repro_torch/kernels/build.py).
`select_pack` only moves values and adds once, so it is held to its plain
version bit for bit. `flash_attention` takes bf16 and rounds the
probabilities to bf16 before their product with V, where its plain
version stays in f32: both outputs are bf16, held to the reference's bf16
tolerance of 2e-2 (tests/test_kernels.py).
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


def _sg_inputs(cuda, b, k, seed=None):
    rng = np.random.default_rng(b + k if seed is None else seed)
    vals = rng.normal(size=(b, k)).astype(np.float32)
    theta = rng.normal(size=(b, k)).astype(np.float32)
    y = rng.integers(0, 2, size=(b,)).astype(np.int32)
    return [torch.from_numpy(x).to(cuda) for x in (vals, theta, y)]


# (B, K) where the kernel's paths split: the main path's (4096, 64), one
# wave; (262144, 64) and the ragged (270001, 8), past one wave (the groups
# stride over the rows); K % 4 != 0 (scalar chunks), also past one wave
# (10001, 65); K > 128 (a warp a row, over its chunks); B = 0 and 1; a
# ragged B
@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(4096, 64), (33, 7), (5, 200), (262144, 64),
                                 (1000, 65), (77, 3), (300, 256), (0, 64),
                                 (1, 64), (1, 7), (4097, 64), (129, 128),
                                 (10001, 65), (270001, 8)])
def test_sigmoid_grad_kernel_matches_plain(cuda, b, k):
    vals, theta, y = _sg_inputs(cuda, b, k)
    want = ref.sigmoid_grad_ref(vals, theta, y)
    before = ops.launch_counts()["sigmoid_grad"]
    got = ops.sigmoid_grad(vals, theta, y)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sigmoid_grad"] == before + (b > 0)
    for g_, w in zip(got, want, strict=True):
        assert g_.shape == w.shape and g_.dtype == torch.float32
        torch.testing.assert_close(g_, w, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(4096, 64), (262144, 64), (1000, 65),
                                 (10001, 65), (300, 256)])
def test_sigmoid_grad_kernel_bit_repeatable(cuda, b, k):
    """5 calls give the same bits; so do rows read a float at a time
    (vals, theta one element off 16 bytes) and the first 4096 rows taken
    alone (another grid): every variant sums the same chunks in the same
    order."""
    vals, theta, y = _sg_inputs(cuda, b, k)
    outs = [ops.sigmoid_grad(vals, theta, y) for _ in range(5)]
    shifted = [torch.empty(b * k + 1, device=cuda)[1:].view(b, k)
               for _ in range(2)]
    shifted[0].copy_(vals)
    shifted[1].copy_(theta)
    assert shifted[0].data_ptr() % 16 != 0
    outs.append(ops.sigmoid_grad(*shifted, y))
    head = ops.sigmoid_grad(vals[:4096], theta[:4096], y[:4096])
    torch.cuda.synchronize()
    for o in outs[1:]:
        for a, b_ in zip(o, outs[0], strict=True):
            assert _same_bits(a, b_)
    for a, b_ in zip(head, outs[0], strict=True):
        assert _same_bits(a, b_[:4096])


@pytest.mark.gpu
def test_sigmoid_grad_wrapper_one_buffer(cuda):
    """grads, probs and nll are views into one allocation, each on a
    16-byte boundary, none overlapping another: writing one leaves the
    others as they were."""
    from repro_torch.kernels import sigmoid_grad as sg

    for b, k in [(4096, 64), (33, 7), (5, 3)]:
        grads, probs, nll = ops.sigmoid_grad(*_sg_inputs(cuda, b, k))
        assert grads.shape == (b, k) and grads.is_contiguous()
        assert probs.shape == (b,) and nll.shape == (b,)
        assert all(t.data_ptr() % 16 == 0 for t in (grads, probs, nll))
        base = grads.data_ptr()
        p, n, total = sg.layout(b, k)
        assert probs.data_ptr() == base + 4 * p >= base + 4 * b * k
        assert nll.data_ptr() == base + 4 * n >= probs.data_ptr() + 4 * b
        assert grads.untyped_storage().nbytes() == 4 * total
        keep = [t.clone() for t in (grads, probs, nll)]
        probs.fill_(7.0)
        assert torch.equal(grads, keep[0]) and torch.equal(nll, keep[2])
        nll.fill_(-7.0)
        grads.fill_(3.0)
        assert bool((probs == 7.0).all()) and bool((nll == -7.0).all())


@pytest.mark.gpu
def test_sigmoid_grad_wrapper_refuses(cuda):
    vals, theta, y = _sg_inputs(cuda, 8, 16)
    with pytest.raises(ValueError, match="labels on cpu"):
        ops.sigmoid_grad(vals, theta, y.cpu())
    with pytest.raises(TypeError, match="torch.float64"):
        ops.sigmoid_grad(vals, theta.double(), y)
    with pytest.raises(TypeError, match="torch.int64"):
        ops.sigmoid_grad(vals, theta, y.long())
    with pytest.raises(ValueError, match="shapes"):
        ops.sigmoid_grad(vals, theta[:, :8], y)
    with pytest.raises(ValueError, match="shapes"):
        ops.sigmoid_grad(vals, theta, y[:4])
    with pytest.raises(ValueError, match="contiguous"):
        ops.sigmoid_grad(vals.t().contiguous().t(), theta, y)


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



def _tile_edges(n, run):
    return (np.arange(n) // run).astype(np.int32)


def _alternating(n):
    """Runs of length 1 and 2 in turn: ids 0, 1, 1, 2, 3, 3, ..."""
    return (2 * np.arange(n) // 3).astype(np.int32)


# name -> sorted ids (padding last) of the look-back's edge cases; the
# kernel's tiles are 2,048 slots
_SEG_CASES = {
    "run-ends-at-tile-edges": lambda: _tile_edges(2048 * 64, 2048),
    "runs-of-half-a-tile": lambda: _tile_edges(2048 * 64, 1024),
    "runs-of-two-tiles": lambda: _tile_edges(2048 * 64, 4096),
    "n-tile-times-37-plus-1": lambda: _sorted_ids(2048 * 37 + 1, 30, 1)[0],
    "n-tile-times-37-minus-1": lambda: _sorted_ids(2048 * 37 - 1, 30, 2)[0],
    "n-tile-plus-1-one-run": lambda: np.zeros(2049, np.int32),
    "all-padding-many-tiles": lambda: np.full(2048 * 5 + 7, -1, np.int32),
    "length-1-runs": lambda: np.arange(262144, dtype=np.int32),
    "alternating-length-1-and-2": lambda: _alternating(262144),
    "one-run-then-padding": lambda: np.concatenate([
        np.zeros(2048 * 40 + 5, np.int32), np.full(3000, -1, np.int32)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_SEG_CASES))
def test_segment_sum_kernel_edge_cases(cuda, case):
    """Integer-valued grads, so bit for bit; once on 16-byte aligned
    tensors and once on views one element in (no vector loads)."""
    ids = _SEG_CASES[case]()
    g = np.random.default_rng(len(ids)).integers(
        -8, 9, size=ids.shape).astype(np.float32)
    for off in (0, 1):
        ids_t = torch.from_numpy(np.concatenate([[0] * off, ids]).astype(
            np.int32)).to(cuda)[off:]
        g_t = torch.from_numpy(np.concatenate([[0] * off, g]).astype(
            np.float32)).to(cuda)[off:]
        assert ids_t.shape == (len(ids),)
        assert (ids_t.data_ptr() % 16 == 0) == (off == 0)
        got = ops.segment_sum_sorted(ids_t, g_t)
        want = ref.segment_sum_sorted_ref(ids_t, g_t)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (case, off)


@pytest.mark.gpu
def test_segment_sum_kernel_look_back_is_deterministic(cuda):
    """f32 grads over N = 2^22 (2,048 tiles) in 7 runs that each cross
    hundreds of tiles, so the look-back folds long chains of aggregates:
    within the run-sum tolerance of the plain version, and 5 calls give
    the same bits whatever order the tiles published in."""
    n = 1 << 22
    ids, rng = _sorted_ids(n, 7, seed=3)
    g = rng.normal(size=n).astype(np.float32)
    ids_t, g_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(g).to(cuda)
    outs = [ops.segment_sum_sorted(ids_t, g_t) for _ in range(5)]
    want = ref.segment_sum_sorted_ref(ids_t, g_t)
    mass = ref.segment_sum_sorted_ref(ids_t, g_t.abs())
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert bool(((outs[0] - want).abs() <= 1e-5 + 1e-6 * mass).all())


def _stream_buffer(cuda):
    from repro_torch.kernels import segment_sum as ss

    key = (cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    return ss._lookback[key]


def _control(words):
    """The control word {ticket, epoch - 1} as ints."""
    return words[-1:].view(torch.int32).tolist()


@pytest.mark.gpu
def test_segment_sum_kernel_refused_launch_resets_look_back(cuda,
                                                            monkeypatch):
    """A launch that the C entry refuses raises and changes nothing: the
    look-back state lives on the device and only the kernel advances it,
    so the next call gives the same bits as before, from the same
    buffer."""
    from repro_torch.kernels import build

    n = 20000
    ids, rng = _sorted_ids(n, 50, seed=4)
    ids_t = torch.from_numpy(ids).to(cuda)
    g_t = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    first = ops.segment_sum_sorted(ids_t, g_t)
    words = _stream_buffer(cuda)
    torch.cuda.synchronize()
    control = _control(words)
    assert control[0] == 0

    class Refusing:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        def repro_segment_sum_sorted_f32(self, *args):
            return 1   # cudaErrorInvalidValue, before any launch

    lib = build.library()
    monkeypatch.setattr(build, "library", lambda: Refusing(lib))
    with pytest.raises(RuntimeError, match="segment_sum_sorted"):
        ops.segment_sum_sorted(ids_t, g_t)
    monkeypatch.undo()
    assert _stream_buffer(cuda) is words and _control(words) == control
    again = ops.segment_sum_sorted(ids_t, g_t)
    torch.cuda.synchronize()
    assert torch.equal(again, first)
    assert _control(words) == [0, control[1] + 1]


@pytest.mark.gpu
def test_segment_sum_kernel_epoch_wraps(cuda):
    """Calls across the epoch's wrap (2^29 - 1, then 1) give the plain
    version's bits, and the control word counts on: ticket 0, epoch."""
    n = 2048 * 64
    ids, rng = _sorted_ids(n, 5, seed=6)
    ids_t = torch.from_numpy(ids).to(cuda)
    g_t = torch.from_numpy(rng.integers(-8, 9, size=n).astype(
        np.float32)).to(cuda)
    want = ref.segment_sum_sorted_ref(ids_t, g_t)
    assert torch.equal(ops.segment_sum_sorted(ids_t, g_t), want)
    words = _stream_buffer(cuda)
    words[-1:].view(torch.int32)[1] = 2 ** 29 - 3   # next epoch 2^29 - 2
    for stored in (2 ** 29 - 2, 0, 1, 2):
        assert torch.equal(ops.segment_sum_sorted(ids_t, g_t), want)
        assert _control(words) == [0, stored]


@pytest.mark.gpu
def test_segment_sum_kernel_scrubs_unused_status_words(cuda):
    """Calls over fewer tiles than the buffer holds zero the words past
    their tiles, one a call, so within 2 m calls (m the power of two above
    the capacity) every word is zero or freshly published: none keeps an
    epoch for the 2^29 - 1 calls it takes the epoch to come round."""
    from repro_torch.kernels import segment_sum as ss

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        big = torch.zeros(2048 * 100, dtype=torch.int32, device=cuda)
        ops.segment_sum_sorted(big, torch.ones(big.shape, device=cuda))
        words = ss._lookback[(cuda.index or 0, side.cuda_stream)]
        capacity = words.numel() - ss.CONTROL_WORDS
        assert capacity == 100
        stale = ((7 << 3 | 1 << 2 | 2) << 32) | int(
            np.float32(999.0).view(np.uint32))
        words[2:capacity] = stale
        ids, rng = _sorted_ids(4096, 7, seed=9)
        ids_t = torch.from_numpy(ids).to(cuda)
        g_t = torch.from_numpy(rng.integers(-8, 9, size=4096).astype(
            np.float32)).to(cuda)
        want = ref.segment_sum_sorted_ref(ids_t, g_t)
        outs = [ops.segment_sum_sorted(ids_t, g_t) for _ in range(2 * 128)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert not words[2:capacity].any()


def _seg_graph_inputs(cuda, seed):
    """f32 grads over sorted ids whose runs cross many tiles, at the main
    path's N: the look-back folds chains of aggregates."""
    n = 262144
    ids, rng = _sorted_ids(n, 300, seed=seed)
    g = rng.normal(size=n).astype(np.float32)
    return torch.from_numpy(ids).to(cuda), torch.from_numpy(g).to(cuda)


def _capture(fn):
    """fn() captured in a CUDA graph after a warm-up on a side stream, as
    torch.cuda.graphs asks; returns (graph, its output, the look-back
    buffers its calls took)."""
    from repro_torch.kernels import segment_sum as ss

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    ss.take_captured()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out, ss.take_captured()


@pytest.mark.gpu
def test_segment_sum_kernel_graph_replays_bit_identical(cuda):
    """A call captured in a CUDA graph and replayed 5 times gives the eager
    call's bits, on the captured inputs and on inputs changed in place
    between replays; replays on a side stream while eager calls run on
    the default stream give them too. One kernel a replay, no memset."""
    ids_t, g_t = _seg_graph_inputs(cuda, seed=7)
    want = ops.segment_sum_sorted(ids_t, g_t)
    graph, out, bufs = _capture(lambda: ops.segment_sum_sorted(ids_t, g_t))
    assert len(bufs) == 1 and bufs[0] is not _stream_buffer(cuda)
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, want)
    for seed in range(8, 13):
        new_ids, new_g = _seg_graph_inputs(cuda, seed)
        ids_t.copy_(new_ids)
        g_t.copy_(new_g)
        eager = ops.segment_sum_sorted(new_ids, new_g)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, eager)
        assert _same_bits(eager, ops.segment_sum_sorted(new_ids, new_g))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    others = [_seg_graph_inputs(cuda, seed) for seed in (20, 21)]
    with torch.cuda.stream(side):
        for _ in range(5):
            graph.replay()
    eager = [ops.segment_sum_sorted(*x) for x in others for _ in range(5)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert _same_bits(out, ops.segment_sum_sorted(ids_t, g_t))
    for i, x in enumerate(others):
        want_x = ref.segment_sum_sorted_ref(*x)
        mass = ref.segment_sum_sorted_ref(x[0], x[1].abs())
        for e in eager[5 * i:5 * i + 5]:
            assert _same_bits(e, eager[5 * i])
        assert bool(((eager[5 * i] - want_x).abs()
                     <= 1e-5 + 1e-6 * mass).all())
    assert _control(bufs[0])[0] == 0


@pytest.mark.gpu
def test_segment_sum_kernel_eager_after_capture(cuda):
    """An eager call after a captured one on the same stream keeps the
    stream's own buffer and gives the eager bits."""
    ids_t, g_t = _seg_graph_inputs(cuda, seed=30)
    first = ops.segment_sum_sorted(ids_t, g_t)
    words = _stream_buffer(cuda)
    other_ids, other_g = _seg_graph_inputs(cuda, seed=31)
    graph, out, _ = _capture(lambda: ops.segment_sum_sorted(other_ids,
                                                            other_g))
    graph.replay()
    again = ops.segment_sum_sorted(ids_t, g_t)
    graph.replay()
    torch.cuda.synchronize()
    assert _stream_buffer(cuda) is words
    assert _same_bits(again, first)
    assert _same_bits(out, ops.segment_sum_sorted(other_ids, other_g))


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


def _select_ties_straddling_a_slice():
    """All live, cap 40,000: 300 large values, then |comp| = 1.0 at
    positions 2,000..3,500, which straddle the edge between the cluster's
    first two 2,048-slot chunks (CTAs 0 and 1); k = 1,000 takes 700 of
    those 1,501 ties."""
    send, ids, carry = _select_case(1, 40000, 40000, seed=8)
    send[0] = np.clip(send[0], -0.5, 0.5)
    send[0, 2000:3501] = np.where(np.arange(1501) % 2, 1.0, -1.0)
    carry[0, 2000:3501] = 0.0
    send[0, 10000:10300] = 3.0 + np.arange(300)
    return send, ids, carry


def _select_all_equal(p, cap, live):
    send, ids, carry = _select_case(p, cap, live, seed=2, prefix=False)
    return (np.where(ids >= 0, 0.5, 0.0).astype(np.float32), ids,
            np.zeros_like(carry))


def _select_signed_zeros():
    zeros = _select_case(1, 2048, 2048, seed=3)
    rng = np.random.default_rng(3)
    sign = rng.choice([-0.0, 0.0, 1.0, -1.0], size=zeros[0].shape,
                      p=[0.3, 0.3, 0.2, 0.2]).astype(np.float32)
    return (sign, zeros[1],
            rng.choice([-0.0, 0.0], size=sign.shape).astype(np.float32))


def _select_dead_row():
    dead = _select_case(3, 1100, 900, seed=4, prefix=False)
    dead[1][1] = -1
    return dead


def _select_nan():
    send, ids, carry = _select_case(2, 3000, 2800, seed=9, prefix=False)
    send[0, [5, 700, 2999]] = np.nan
    carry[1, [0, 1]] = np.nan
    return send, ids, carry


def _boundary_k(rule, cap):
    """The largest k <= cap that `rule(cap, k)` puts on the cluster path,
    or 0 if none (the rule switches once in k)."""
    lo, hi = 0, cap + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rule(cap, mid) else (lo, mid)
    return lo


def _kernel_rule(cap, k):
    from repro_torch.kernels import build

    return bool(build.library().repro_select_pack_uses_cluster(cap, k))


def _select_boundary_k():
    """The largest k of the cluster path at the main path's cap, by the
    kernel's own rule."""
    return _boundary_k(_kernel_rule, 262144)


def _path_row():
    return _select_case(1, 262144, 27376, seed=1)


# name -> (inputs, k), built when a test asks for them
_SELECT_CASES = {
    "path-k13108": lambda: (*_path_row(), 13108),
    "path-k65536": lambda: (*_path_row(), 65536),
    # k on each side of the path rule's boundary (both k > live: a dead
    # tail of ~118,000 slots)
    "path-k-cluster-boundary": lambda: (*_path_row(), _select_boundary_k()),
    "path-k-large-past-boundary": lambda: (*_path_row(),
                                           _select_boundary_k() + 1),
    "all-keys-equal": lambda: (*_select_all_equal(2, 3000, 2500), 1000),
    "all-keys-equal-262144": lambda: (
        *_select_all_equal(1, 262144, 262144), 100000),
    "ties-straddle-a-chunk-edge": lambda: (*_select_ties_straddling_a_slice(),
                                      1000),
    "signed-zeros": lambda: (*_select_signed_zeros(), 1500),
    "nan": lambda: (*_select_nan(), 400),
    "all-dead-row": lambda: (*_select_dead_row(), 100),
    "3-live-below-k": lambda: (*_select_case(2, 1024, 3, seed=5), 10),
    "k-1": lambda: (*_select_dead_row(), 1),
    "k-cap": lambda: (*_select_dead_row(), 1100),
    "k-above-live-scattered-dead": lambda: (
        *_select_case(1, 50000, 20000, seed=10, prefix=False), 30000),
    "8-rows-cap-4104": lambda: (*_select_case(8, 4104, 3000, seed=6), 411),
    "8-rows-cap-32768": lambda: (*_select_case(8, 32768, 6000, seed=11),
                                 3000),
    "ragged-cap": lambda: (*_select_case(2, 5001, 4000, seed=7,
                                         prefix=False), 2501),
    "cap-100003": lambda: (*_select_case(1, 100003, 60000, seed=12,
                                         prefix=False), 5000),
}


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_SELECT_CASES))
def test_select_pack_kernel_bit_exact(cuda, case):
    """All three outputs equal the plain version bit for bit, -0.0 and the
    order of the packed pairs included, on both paths."""
    send, ids, carry, k = _SELECT_CASES[case]()
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
def test_select_pack_path_rule_matches_kernel(cuda):
    """The Python copy of the (cap, k) path rule is the kernel's, on each
    side of its boundary, and the card places the main path's cluster."""
    from repro_torch.kernels import build, select_pack

    lib = build.library()
    for cap in (1, 1000, 4104, 40000, 262144, 262145, 300001, 1 << 20,
                3 << 20):
        # both rules switch at the same k, compared on each side of it
        kb = _boundary_k(select_pack.uses_cluster, cap)
        assert _boundary_k(_kernel_rule, cap) == kb
        for k in sorted({1, 13108, 65536, kb, kb + 1, cap}):
            if not 1 <= k <= cap:
                continue
            assert _kernel_rule(cap, k) == select_pack.uses_cluster(cap, k)
            assert lib.repro_select_pack_cluster_smem(cap, k) == \
                select_pack.cluster_smem_bytes(cap, k)
    assert _select_boundary_k() == 128928
    assert lib.repro_select_pack_cluster_size() == select_pack.CLUSTER_CTAS
    assert lib.repro_select_pack_tile_size() == select_pack.LARGE_TILE
    assert lib.repro_select_pack_radix() == select_pack.RADIX
    assert lib.repro_select_pack_max_clusters(262144, 13108) >= 1
    assert lib.repro_select_pack_max_clusters(262144, 65536) >= 1


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


# (rows, base, slots, distinct ids, id range past the block, seed): the
# received (P, cap) buffer's run totals that the row update reads; ids
# drawn from `distinct` values in [base - past, base + rows + past), a
# Zipf-like count of slots each, -1 padding after them
_ROW_CASES = {
    "spread": (1 << 16, 0, 20000, 3000, 0, 1),
    "edges": (4096, 0, 600, 0, 0, 2),          # rows 0 and rows - 1 named
    "outside-block": (4096, 10000, 8000, 900, 2000, 3),
    "all-padding": (4096, 0, 512, None, 0, 4),
    "duplicates": (4096, 7, 160000, 40, 0, 5),
    "b4096-shape": (1 << 24, 1 << 20, 159744, 21145, 0, 6),
}


def _row_inputs(cuda, rows, base, slots, distinct, past, seed):
    """(req_ids (1, slots) int32, grads (1, slots) f32): run totals of
    every kind the reduce makes, an id whose slots all carry -0.0 (its
    total is -0.0) among them."""
    rng = np.random.default_rng(seed)
    if distinct is None:
        ids = np.full(slots, -1, np.int64)
    else:
        if distinct == 0:      # row 0 and the last row, heavily repeated
            pool = np.array([base, base + rows - 1, base + rows // 2])
        else:
            pool = rng.choice(np.arange(base - past, base + rows + past),
                              size=distinct, replace=False)
            pool = pool[pool >= 0]
        w = 1.0 / np.arange(1, pool.size + 1) ** 1.1
        live = slots - slots // 8
        ids = np.concatenate([rng.choice(pool, size=live, p=w / w.sum()),
                              np.full(slots - live, -1)])
    grads = rng.normal(size=slots).astype(np.float32)
    if distinct is not None:
        grads[ids == ids[0]] = -0.0
    return (torch.from_numpy(ids.astype(np.int32)).to(cuda)[None],
            torch.from_numpy(grads).to(cuda)[None])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgd", "adagrad"])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("case", sorted(_ROW_CASES))
def test_row_update_kernel_matches_the_dense_chain(cuda, case, lr_kind,
                                                   kind):
    """The row update on a reduce's run totals leaves theta and acc as the
    eager dense chain does (a (rows,) gradient from `owner_accumulate`,
    then the registry's dense update), every row bit for bit: untouched
    rows, rows 0 and rows - 1, ids outside the block, all padding, heavy
    duplicates, -0.0 totals and -0.0 rows; lr a float and a 0-d tensor
    read on the card. One launch a call."""
    import types

    from repro_torch.optim import optimizers

    rows, base, slots, distinct, past, seed = _ROW_CASES[case]
    req_ids, grads = _row_inputs(cuda, rows, base, slots, distinct, past,
                                 seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    theta = torch.randn(rows, device=cuda, generator=g)
    theta[::7] = -0.0
    acc = torch.rand(rows, device=cuda, generator=g)
    acc[::5] = 0.0
    lr = 0.37 if lr_kind == "float" else torch.full((), 0.37, device=cuda)
    cfg = types.SimpleNamespace(adagrad_eps=1e-6)
    t_row, a_row, t_dense, a_dense = (theta.clone(), acc.clone(),
                                      theta.clone(), acc.clone())

    ids_s, totals, end = ops.sorted_run_totals(req_ids, grads)
    before = ops.launch_counts()["row_update"]
    ops.row_update(kind, t_row, a_row, ids_s, totals, base, lr, 1e-6)
    assert ops.launch_counts()["row_update"] == before + 1
    dense = ops.owner_accumulate(req_ids, grads,
                                 torch.zeros(rows, device=cuda), base)
    optimizers.SPARSE_OPTIMIZERS[kind].update(t_dense, a_dense, dense, lr,
                                              cfg)
    torch.cuda.synchronize()
    assert _same_bits(t_row, t_dense)
    assert _same_bits(a_row, a_dense)
    local = ids_s.long() - base
    named = end & (local >= 0) & (local < rows)
    if distinct is None:
        assert not named.any() and _same_bits(t_row, theta)
    else:
        assert named.any()
        assert int(named.sum()) < rows      # some rows left untouched
    if case == "edges":
        hit = local[named].tolist()
        assert 0 in hit and rows - 1 in hit


@pytest.mark.gpu
def test_row_update_device_time_falls_under_its_callers_span(cuda):
    """The profiler links the row update's kernel to the op
    `repro_torch::row_update`, so a span around the call (the benchmark's
    `optimizer.update`) holds its device time; a bare ctypes launch is
    linked to no host event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    rows = 1 << 20
    req_ids, grads = _row_inputs(cuda, rows, 0, 65536, 20000, 0, 7)
    ids_s, totals, _ = ops.sorted_run_totals(req_ids, grads)
    theta = torch.randn(rows, device=cuda)
    acc = torch.rand(rows, device=cuda)
    lr = torch.full((), 0.5, device=cuda)
    ops.row_update("adagrad", theta, acc, ids_s, totals, 0, lr, 1e-6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("caller"):
            for _ in range(5):
                ops.row_update("adagrad", theta, acc, ids_s, totals, 0, lr,
                               1e-6)
        torch.cuda.synchronize()
    span = kernel = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name == "caller":
            span += e.device_time_total
        elif e.device_type == DeviceType.CUDA and "row_update" in e.name:
            kernel += e.time_range.end - e.time_range.start
    assert kernel > 0
    assert span >= 0.9 * kernel


# (B, Sq, Skv, H, KH, D, causal): the serve path's head layout at a short
# S, then D = 64, MHA, MQA with group 48, ragged S, Sq < Skv, full
# attention and one query row; then the kernel's tile edges (128 query
# rows a block, 64 a consumer warpgroup, 128 keys a K/V tile)
_ATTN_CASES = {
    "yi-6b-heads": (2, 512, 512, 32, 4, 128, True),
    "d64": (1, 256, 256, 8, 8, 64, True),
    "mha": (2, 192, 192, 4, 4, 128, True),
    "mqa-48": (1, 320, 320, 48, 1, 128, True),
    "ragged-1000": (1, 1000, 1000, 8, 2, 128, True),
    "sq-below-skv": (2, 100, 333, 8, 2, 128, True),
    "full": (1, 200, 200, 8, 2, 128, False),
    "full-sq-below-skv": (1, 70, 129, 4, 2, 64, False),
    "sq-1": (2, 1, 777, 8, 2, 128, True),
    "s-4097": (1, 4097, 4097, 8, 1, 128, True),
    "s-65": (2, 65, 65, 8, 2, 128, True),
    "s-129": (2, 129, 129, 8, 2, 128, True),
    "sq-77-skv-1000": (2, 77, 1000, 8, 2, 128, True),
    "full-sq-77-skv-1000": (2, 77, 1000, 8, 2, 128, False),
    "d64-4096": (1, 4096, 4096, 8, 2, 64, True),
    # zamba2's head dim of 80 (MHA, 32 heads), computed in the tiles of
    # D = 128: causal, ragged, Sq < Skv, full and one query row
    "d80-zamba2-heads": (2, 512, 512, 32, 32, 80, True),
    "d80-ragged-1000": (1, 1000, 1000, 8, 8, 80, True),
    "d80-sq-below-skv": (2, 100, 333, 8, 2, 80, True),
    "d80-full": (1, 200, 200, 8, 8, 80, False),
    "d80-sq-1": (2, 1, 777, 8, 8, 80, True),
    # whisper's cross-attention: 416 prompt queries over 1500 frames
    "d64-whisper-cross": (1, 416, 1500, 12, 12, 64, False),
}


def _attn_inputs(cuda, b, sq, skv, h, kh, d, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, torch.bfloat16)

    return t(b, sq, h, d), t(b, skv, kh, d), t(b, skv, kh, d)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case):
    b, sq, skv, h, kh, d, causal = _ATTN_CASES[case]
    q, k, v = _attn_inputs(cuda, b, sq, skv, h, kh, d, seed=sq + skv + h)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kh,d", [(4, 128), (32, 80)])
def test_flash_attention_kernel_bit_reproducible(cuda, kh, d):
    """No atomics, and an item's arithmetic does not depend on which
    block takes it: two calls on the same inputs give the same bits."""
    q, k, v = _attn_inputs(cuda, 2, 1000, 1000, 32, kh, d, seed=7)
    outs = [ops.flash_attention(q, k, v) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_views(cuda):
    """q, k and v as views into one fused (B, S, H + 2 KH, D) projection:
    the kernel reads them in place by strides."""
    b, s, h, kh, d = 2, 300, 8, 2, 128
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(b, s, h + 2 * kh, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_flash_attention_kernel_refuses(cuda):
    q, k, v = _attn_inputs(cuda, 1, 64, 32, 4, 2, 128, seed=1)
    with pytest.raises(ValueError, match="Sq = 64 > Skv = 32"):
        ops.flash_attention(q, k, v, causal=True)
    q, k, v = _attn_inputs(cuda, 1, 32, 32, 4, 2, 128, seed=2)
    with pytest.raises(TypeError, match="torch.bfloat16"):
        ops.flash_attention(q.float(), k.float(), v.float())
    q, k, v = _attn_inputs(cuda, 1, 32, 32, 4, 2, 32, seed=3)
    with pytest.raises(ValueError, match="head dim 32"):
        ops.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# the data plane and checkpoints on the card
# ---------------------------------------------------------------------------


def _small_engine(cuda, strategy):
    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch.data import ShardedLoader

    cfg = DPMRConfig(num_features=1 << 16, max_features_per_sample=16,
                     max_hot=16, learning_rate=2.0, optimizer="adagrad",
                     distribution=strategy, topk_frac=0.05)
    src = get_source("zipf_sparse", batch_size=512, num_batches=6,
                     num_features=1 << 16, features_per_sample=16)
    return DPMREngine(cfg, device=cuda), src, ShardedLoader


@pytest.mark.gpu
def test_prefetch_onto_the_card_hands_over_the_same_batches(cuda):
    """Batches copied on the loader's side stream equal those placed on
    the consumer's stream, and train to the same bits."""
    eng, src, loader_cls = _small_engine(cuda, "a2a")
    other, _, _ = _small_engine(cuda, "a2a")
    fed = loader_cls(src, device=cuda, host_index=0, num_hosts=1,
                     prefetch=2)
    plain = loader_cls(src, device=cuda, host_index=0, num_hosts=1,
                       prefetch=0)
    for a, b in zip(fed.take(8), plain.take(8), strict=True):
        assert a["ids"].is_cuda and a.global_size == 512
        for k in ("ids", "vals", "labels"):
            assert torch.equal(a[k], b[k])
    fed.seek({"epoch": 0, "step": 0})
    plain.seek({"epoch": 0, "step": 0})
    eng.fit_sgd(fed, steps=8)
    other.fit_sgd(plain, steps=8)
    for a, b in zip(eng.state, other.state, strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["a2a", "topk_reduce"])
def test_async_save_holds_the_pre_step_bits_on_the_card(cuda, strategy,
                                                        tmp_path):
    """save(block=False) enqueues its copies on the stream and returns;
    train_step straight after it updates the table in place, and the
    file holds the bits of the save."""
    from repro_torch.ckpt.checkpointer import Checkpointer

    eng, src, _ = _small_engine(cuda, strategy)
    eng.fit_sgd(src, steps=3)
    before = [t.clone() for t in eng.state]
    eng.save(str(tmp_path), block=False)
    eng.train_step(src.batch(3))
    eng.wait_saves()
    arrs, manifest = Checkpointer(str(tmp_path)).restore_host()
    assert manifest["step"] == 3
    for a, b in zip(arrs, before, strict=True):
        assert a.tobytes() == b.cpu().numpy().tobytes()
    assert not torch.equal(eng.state.cold, before[0])


def _serving_engine(cuda):
    """An a2a engine on the card with a model-hot set, trained 8 steps at
    2^16 features, K 64; and its source."""
    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch.api import hot_ids_from_corpus

    cfg = DPMRConfig(num_features=1 << 16, max_features_per_sample=64,
                     max_hot=64, learning_rate=2.0, optimizer="adagrad")
    src = get_source("zipf_sparse", batch_size=256, num_batches=8,
                     num_features=1 << 16, features_per_sample=64, seed=0)
    batches = [src.batch(i) for i in range(8)]
    hot = hot_ids_from_corpus(cfg, batches[:4], device=cuda)
    eng = DPMREngine(cfg, device=cuda, hot_ids=hot)
    eng.fit_sgd(batches)
    return eng, batches


@pytest.mark.gpu
def test_serve_hit_bit_identical_to_flush_at_every_request_size(cuda):
    """A hit, computed on the host from the mirror, has the bits of the
    card's predict_padded and of the same request flushed through the
    batcher, at every request size from 1 to 64 (window 1 and a refresh a
    lookup: the mirror holds each request's own ids, so each hits)."""
    from repro_torch.serve import (BatchingConfig, DPMRServeEngine,
                                   HotCacheConfig, HotFeatureCache)

    eng, batches = _serving_engine(cuda)
    cache = HotFeatureCache(eng, HotCacheConfig(
        max_hot=4096, threshold=0.0, window=1, refresh_every=1))
    srv = DPMRServeEngine(eng, batching=BatchingConfig(max_batch=1,
                                                       max_wait_ms=0.0),
                          hot_cache=None)
    try:
        for n in range(1, 65):
            b = batches[n % 8]
            ids, vals = b["ids"][n:2 * n], b["vals"][n:2 * n]
            cache.observe(ids)
            hit = cache.lookup(ids, vals)
            assert hit is not None, n
            flushed = srv.submit(ids, vals).result(timeout=120)
            card = eng.predict_padded({"ids": ids, "vals": vals})
            assert np.array_equal(hit, card), n
            assert np.array_equal(hit, flushed), n
    finally:
        srv.stop()
    assert cache.metrics.snapshot()["cache_hits"] == 64


@pytest.mark.gpu
def test_serve_fresh_lookup_reads_no_device_value(cuda):
    """Freshness reads the step the engine counts on the host: lookups on
    a fresh mirror, hits and misses, make no synchronizing device call
    (a read of state.step would wait behind every queued predict)."""
    from repro_torch.serve import HotCacheConfig, HotFeatureCache

    eng, batches = _serving_engine(cuda)
    cache = HotFeatureCache(eng, HotCacheConfig(
        max_hot=4096, threshold=0.0, window=8, refresh_every=1000))
    ids, vals = batches[0]["ids"][:4], batches[0]["vals"][:4]
    tail = np.full_like(ids, -1)
    tail[0, 0] = int(ids.max()) + 1            # a feature never observed
    cache.observe(ids)
    assert cache.lookup(ids, vals) is not None     # gathers the mirror
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            assert cache.lookup(ids, vals) is not None
        assert cache.lookup(tail, vals) is None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    m = cache.metrics.snapshot()
    assert m["cache_refreshes"] == 1 and m["cache_hits"] == 6


# ---------------------------------------------------------------------------
# the dense trainer on the card
# ---------------------------------------------------------------------------


def _smoke_train(arch, dtype):
    import dataclasses

    from repro_torch.models import registry

    spec = registry.get_spec(arch)
    return spec, dataclasses.replace(registry.smoke_config(arch),
                                     dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [((64, 48), (48, 80)),
                                   ((3, 16, 32), (3, 32, 8))])
def test_f32_result_product_backward_on_the_card(cuda, shape):
    """`common.dot_f32`/`bmm_f32` of bf16 operands keep an f32 result on
    the card (`torch.mm(..., out_dtype=float32)`, which has no backward of
    its own) and differentiate through `common._MmF32`: the forward equals
    the f32 product of the same bf16 values within f32 rounding, the
    gradients the bf16 products of the bf16-rounded cotangent."""
    from repro_torch.models import common

    rng = np.random.default_rng(len(shape[0]))
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(torch.bfloat16) for s in shape)
    g = torch.from_numpy(rng.normal(size=(*shape[0][:-1],
                                          shape[1][-1])).astype(np.float32))
    fn = common.dot_f32 if len(shape[0]) == 2 else common.bmm_f32
    ga, gb = a.to(cuda).requires_grad_(), b.to(cuda).requires_grad_()
    out = fn(ga, gb)
    da, db = torch.autograd.grad(out, (ga, gb), g.to(cuda))
    assert out.dtype == torch.float32 and da.dtype == torch.bfloat16
    want = torch.matmul(a.float(), b.float())
    torch.testing.assert_close(out.cpu(), want, atol=1e-5, rtol=1e-5)
    gb16 = g.to(torch.bfloat16)
    torch.testing.assert_close(da.cpu(), (gb16 @ b.transpose(-1, -2)),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(db.cpu(), (a.transpose(-1, -2) @ gb16),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_on_the_card_match_the_cpu(cuda, dtype):
    """3 adamw steps of yi-6b at smoke size from the same state on the
    card and on the CPU: losses within 1e-4 (f32) or 2^-8 relative
    (bf16), and the card's remat modes bit-identical to each other."""
    from repro_torch import convert
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data import get_source
    from repro_torch.train import trainer

    spec, cfg = _smoke_train("yi-6b", dtype)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0)
    src = get_source("lm_markov", vocab_size=cfg.vocab_size, seq_len=64,
                     batch_size=4, seed=1)
    batches = [src.batch(i) for i in range(3)]
    cpu = trainer.init_state(spec, cfg, tc, ParallelConfig(),
                             torch.Generator().manual_seed(0), "cpu")
    tree = convert.train_state_to_numpy(cpu)
    runs = {}
    for tag, device, remat in (("cpu", "cpu", "full"),
                               ("full", cuda, "full"),
                               ("dots", cuda, "dots"),
                               ("none", cuda, "none")):
        pc = ParallelConfig(remat=remat)
        state = convert.train_state_from_numpy(tree, cfg, device)
        step = trainer.make_train_step(spec, cfg, tc, pc)
        losses = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(device)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs[tag] = (losses, convert.params_to_numpy(state["params"]))
    tol = 1e-4 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(runs["full"][0], runs["cpu"][0], rtol=tol,
                               atol=tol)
    for remat in ("dots", "none"):
        losses, params = runs[remat]
        assert losses == runs["full"][0]
        for (_, x), (_, y) in zip(convert.tree_leaves(params),
                                  convert.tree_leaves(runs["full"][1]),
                                  strict=True):
            np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
def test_dense_async_save_holds_the_pre_step_bits_on_the_card(cuda,
                                                              tmp_path):
    """A dense train state saved with block=False, then stepped at once:
    the checkpoint holds the pre-step params and moments (the copies run
    on the step's stream before its in-place updates)."""
    from repro_torch import convert
    from repro_torch.ckpt.checkpointer import Checkpointer
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data import get_source
    from repro_torch.train import trainer

    spec, cfg = _smoke_train("granite-8b", "float32")
    tc, pc = TrainConfig(learning_rate=1e-2, warmup_steps=0), \
        ParallelConfig()
    src = get_source("lm_markov", vocab_size=cfg.vocab_size, seq_len=32,
                     batch_size=4, seed=2)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in src.batch(0).items()}
    state = trainer.init_state(spec, cfg, tc, pc,
                               torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    step = trainer.make_train_step(spec, cfg, tc, pc)
    state, _ = step(state, batch)
    want = convert.train_state_to_numpy(state)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, block=False)
    state, _ = step(state, batch)
    ck.wait()
    like = trainer.init_state(spec, cfg, tc, pc,
                              torch.Generator(device=cuda).manual_seed(1),
                              cuda)
    got, manifest = ck.restore(like)
    assert manifest["step"] == 1
    for (pa, x), (pb, y) in zip(
            convert.tree_leaves(convert.train_state_to_numpy(got)),
            convert.tree_leaves(want), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the hybrid, SSM and encoder-decoder families on the card
# ---------------------------------------------------------------------------

# per arch: the smoke config's changes (a head dim the kernel takes where
# prefill reaches it) and the activation dtype: bf16 where the kernel is
# on the path (it takes bf16 only), f32 where it is not
_FAMILY_CASES = {
    "zamba2-2.7b": (dict(d_model=320, num_heads=4, num_kv_heads=4,
                         head_dim=0), "bfloat16"),
    "xlstm-125m": ({}, "float32"),
    "whisper-small": (dict(d_model=128, num_heads=2, num_kv_heads=2,
                           head_dim=0), "bfloat16"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(_FAMILY_CASES))
def test_family_serving_on_the_card_matches_the_cpu(cuda, arch):
    """Prefill and 3 decode steps of each family at a small width, the
    same weights and tokens on the card and the CPU: the last logits
    within 2e-2 of the row's largest |logit| in bf16 (each side rounds at
    the same places, sums in its own order, and the kernel's
    probabilities are bf16) and 1e-4 in f32 (TF32 off); flash_attention
    launched once per attention of the prefill on the card (zamba2: each
    invocation of the shared block; whisper: 3 a layer)."""
    import dataclasses

    from repro_torch.models import common, registry

    changes, dtype = _FAMILY_CASES[arch]
    spec = registry.get_spec(arch)
    cfg = dataclasses.replace(registry.smoke_config(arch), dtype=dtype,
                              **changes)
    cpu = common.init_params(spec.model(cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
    card = spec.model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    host = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 48)).astype(
        np.int32)}
    if cfg.family == "encdec":
        host["frames"] = rng.normal(size=(2, 80, cfg.d_model)).astype(
            np.float32)
    want_fa = {"hybrid": cfg.num_layers // max(cfg.attn_every, 1),
               "encdec": 3 * cfg.num_layers}.get(cfg.family, 0)
    tol = 1e-4 if dtype == "float32" else 2e-2
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = ops.launch_counts()["flash_attention"]
        lc, cc = spec.prefill(card, {k: torch.from_numpy(v).to(cuda)
                                     for k, v in host.items()}, cfg)
        assert ops.launch_counts()["flash_attention"] == before + want_fa
        lh, ch = spec.prefill(cpu, {k: torch.from_numpy(v)
                                    for k, v in host.items()}, cfg)
        for step in range(4):
            got = lc.float().cpu()[:, -1, :cfg.vocab_size]
            want = lh.float()[:, -1, :cfg.vocab_size]
            scale = want.abs().amax(dim=-1, keepdim=True)
            assert bool(((got - want).abs() <= tol * scale).all()), step
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
            if step < 3:
                lc, cc = spec.decode_step(card, cc, tok.to(cuda), cfg)
                lh, ch = spec.decode_step(cpu, ch, tok, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# the Distribution slice on one card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_cp_chunks_on_the_card_equal_blocked(cuda, causal, window):
    """Context-parallel attention's per-chunk function, all 4 chunks on
    the card with the whole K and V, against the blocked attention in
    f32 (TF32 off), within 1e-5."""
    from repro_torch.models import layers

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        q = torch.randn((2, 64, 4, 16), generator=gen, device=cuda)
        k, v = (torch.randn((2, 64, 2, 16), generator=gen, device=cuda)
                for _ in range(2))
        got = torch.cat([layers.cp_attention_chunk(
            q[:, c * 16:(c + 1) * 16], k, v, c, 4, causal=causal,
            window=window, kv_block=16) for c in range(4)], dim=1)
        want = layers.blocked_causal_attention(
            q, k, v, window=window, q_block=16, kv_block=16) if causal \
            else layers._bidirectional_blocked(q, k, v, q_block=16,
                                               kv_block=16)
        assert float((got - want).abs().max()) < ATOL
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_one_rank_nccl_mesh_step_equals_no_mesh(cuda, tmp_path):
    """Two steps of granite-8b's smoke config through an NCCL mesh of one
    rank (data 1, model 1) and through the one-card trainer, from the
    same draws: losses and params bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import trainer

    spec, cfg = registry.get_spec("granite-8b"), \
        registry.smoke_config("granite-8b")
    tc, pc = TrainConfig(learning_rate=1e-2, warmup_steps=0), \
        ParallelConfig()
    gen = torch.Generator(device=cuda).manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (2, 4, 33), generator=gen,
                        device=cuda)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", rank=0,
        world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        runs = {}
        for tag, mesh in (("plain", None), ("mesh", make_host_mesh(1, 1))):
            state = trainer.init_state(
                spec, cfg, tc, pc, torch.Generator(device=cuda).manual_seed(0),
                cuda, mesh=mesh)
            step = trainer.make_train_step(spec, cfg, tc, pc, mesh)
            losses = []
            for t in tok:
                state, m = step(state, {"tokens": t[:, :-1],
                                        "labels": t[:, 1:]})
                losses.append(float(m["loss"]))
            runs[tag] = (losses, {n: p.detach().cpu() for n, p in
                                  state["params"].named_parameters()})
    finally:
        dist.destroy_process_group()
    assert runs["mesh"][0] == runs["plain"][0]
    for name, p in runs["plain"][1].items():
        assert torch.equal(runs["mesh"][1][name], p), name


# small widths that the kernel takes (head dim 64 or 80, bf16), the
# serving families of each layout over `model`
_MESH_SERVE_CASES = {
    "yi-6b": dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64),
    "phi3.5-moe-42b-a6.6b": dict(d_model=256, num_heads=4, num_kv_heads=2,
                                 head_dim=64),
    "zamba2-2.7b": _FAMILY_CASES["zamba2-2.7b"][0],
    "whisper-small": _FAMILY_CASES["whisper-small"][0],
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(_MESH_SERVE_CASES))
def test_one_rank_nccl_mesh_serving_equals_no_mesh(cuda, arch, tmp_path):
    """Prefill and 4 greedy steps in bf16 through an NCCL mesh of one rank
    (data 1, model 1: the weights' gathers, the K/V all-to-all, the
    decode combine and the vocab-parallel argmax over the one-rank
    groups) and through the one-card path on the same weights: the
    tokens bit for bit, flash_attention launched as often (chip_smoke's
    phase 18 compares the logits at full width)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, registry
    from repro_torch.train import serve, trainer

    spec = registry.get_spec(arch)
    cfg = dataclasses.replace(registry.smoke_config(arch), dtype="bfloat16",
                              **_MESH_SERVE_CASES[arch])
    model = common.init_params(spec.model(cfg, device=cuda),
                               torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(2)
    host = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 48)).astype(
        np.int32)}
    if cfg.family == "encdec":
        host["frames"] = rng.normal(size=(2, 80, cfg.d_model)).astype(
            np.float32)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", rank=0,
        world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_host_mesh(1, 1)
        whole = dict(model.named_parameters())
        blocks = trainer.sharded_model(spec, cfg, mesh, cuda,
                                       lambda name, shape: whole[name],
                                       train=False)
        runs = {}
        for tag, m, kw in (("plain", model, {}),
                           ("mesh", blocks, {"mesh": mesh})):
            before = ops.launch_counts()["flash_attention"]
            toks = serve.greedy_decode(spec, cfg, m, host, 5, device=cuda,
                                       **kw)
            runs[tag] = (toks.cpu(),
                         ops.launch_counts()["flash_attention"] - before)
    finally:
        dist.destroy_process_group()
    assert torch.equal(runs["mesh"][0], runs["plain"][0])
    assert runs["mesh"][1] == runs["plain"][1]


@pytest.mark.gpu
def test_quantize_codes_and_scales_card_equals_cpu(cuda):
    """`compression.quantize` on the card gives the CPU's codes and scales
    bit for bit, on blocks each of whose max|x| / 127 differs from the
    product max|x| * (1 / 127) in f32 (ROADMAP C33: a division by the
    Python scalar 127.0 ran on CUDA as that product)."""
    from repro_torch.optim import compression

    gen = torch.Generator().manual_seed(0)
    blocks = []
    while len(blocks) < 64:
        b = torch.randn(compression.BLOCK, generator=gen)
        amax = b.abs().max()
        if amax / torch.tensor(127.0) != amax * (1 / torch.tensor(127.0)):
            blocks.append(b)
    x = torch.cat(blocks)
    q, s = compression.quantize(x.to(cuda))
    cq, cs = compression.quantize(x)
    assert torch.equal(q.cpu(), cq)
    assert torch.equal(s.cpu().view(torch.int32), cs.view(torch.int32))
