"""The port's kernel seam against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(`repro_torch.kernels.ref`); these are held against the JAX kernels run
in interpret mode, on the same numpy inputs. f32 sums are taken in
another order in the two packages, so values agree to atol=1e-5 and
integer-valued sums bit for bit. `select_pack` moves values and adds once, so its
plain version equals the Pallas kernel bit for bit. The CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

ATOL = 1e-5


def _sorted_ids(n, nruns, seed):
    """Sorted ids with n // 8 padding slots (-1) LAST, as the engine
    sorts them (padding keyed INT32_MAX)."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, nruns, size=n - n // 8)).astype(np.int32)
    return np.concatenate([ids, np.full(n // 8, -1, np.int32)]), rng


# ---------------------------------------------------------------------------
# sigmoid_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,k", [(8, 16), (64, 32), (128, 64), (33, 7)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_sigmoid_grad_matches_pallas(b, k, dtype):
    """f16 inputs are cast to f32 by both packages before any arithmetic,
    so both dtypes hold to the f32 tolerance."""
    rng = np.random.default_rng(b * 100 + k)
    vals = rng.normal(size=(b, k)).astype(dtype)
    theta = rng.normal(size=(b, k)).astype(dtype)
    y = rng.integers(0, 2, size=(b,)).astype(np.int32)
    want = jops.sigmoid_grad(jnp.asarray(vals), jnp.asarray(theta),
                             jnp.asarray(y), impl="pallas_interpret",
                             block_b=16)
    got = ops.sigmoid_grad(torch.from_numpy(vals), torch.from_numpy(theta),
                           torch.from_numpy(y))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_sigmoid_grad_stable_at_large_logits():
    """The stable log-sigmoid keeps nll finite where log(sigmoid(z))
    would underflow to -inf."""
    vals = torch.full((2, 4), 40.0)
    theta = torch.tensor([[1.0] * 4, [-1.0] * 4])
    y = torch.tensor([0, 1], dtype=torch.int32)
    _, probs, nll = ops.sigmoid_grad(vals, theta, y)
    assert torch.isfinite(nll).all()
    np.testing.assert_allclose(nll.numpy(), [160.0, 160.0], rtol=1e-6)
    np.testing.assert_allclose(probs.numpy(), [1.0, 0.0], atol=1e-30)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, size=(16,)).astype(np.int32))
    got = ops.sigmoid_grad(vals, vals, y)
    for g, w in zip(got, ref.sigmoid_grad_ref(vals, vals, y), strict=True):
        assert torch.equal(g, w)
    ids = torch.tensor([0, 0, 3, -1], dtype=torch.int32)
    assert torch.equal(ops.segment_sum_sorted(ids, torch.ones(4)),
                       torch.tensor([0.0, 2.0, 1.0, 0.0]))
    send = torch.tensor([[1.0, -3.0, 2.0]])
    got = ops.select_pack(send, torch.tensor([[4, 5, -1]], dtype=torch.int32),
                          torch.zeros((1, 3)), 1)
    assert got[1].tolist() == [[5]] and got[0].tolist() == [[-3.0]]
    assert ops.launch_counts() == {"sigmoid_grad": 0,
                                   "segment_sum_sorted": 0,
                                   "select_pack": 0}


# ---------------------------------------------------------------------------
# segment_sum_sorted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(64, 16), (256, 32), (256, 256),
                                     (1024, 128), (100, 100)])
@pytest.mark.parametrize("nruns", [3, 40])
def test_segment_sum_matches_pallas(n, block, nruns):
    ids, rng = _sorted_ids(n, nruns, seed=n + nruns)
    g = rng.normal(size=(n,)).astype(np.float32)
    want = jops.segment_sum_sorted(jnp.asarray(ids), jnp.asarray(g),
                                   impl="pallas_interpret", block=block)
    got = ops.segment_sum_sorted(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(got.sum()), float(g[ids >= 0].sum()),
                               atol=1e-4)


def test_segment_sum_run_spanning_blocks():
    """One run over 4 Pallas blocks: exactly one total, at the last slot."""
    ids = np.zeros((64,), np.int32)
    g = np.ones((64,), np.float32)
    want = jops.segment_sum_sorted(jnp.asarray(ids), jnp.asarray(g),
                                   impl="pallas_interpret", block=16)
    got = ops.segment_sum_sorted(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[-1]) == 64.0 and float(got.sum()) == 64.0


def test_segment_sum_all_padding():
    ids = np.full((48,), -1, np.int32)
    g = np.random.default_rng(1).normal(size=(48,)).astype(np.float32)
    want = jops.segment_sum_sorted(jnp.asarray(ids), jnp.asarray(g),
                                   impl="pallas_interpret", block=16)
    got = ops.segment_sum_sorted(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


# ---------------------------------------------------------------------------
# owner_accumulate
# ---------------------------------------------------------------------------


def _routing_case(p, cap, f, seed, integer_grads=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, f, size=(p, cap)).astype(np.int32)
    if integer_grads:
        g = rng.integers(-8, 9, size=(p, cap)).astype(np.float32)
    else:
        g = rng.normal(size=(p, cap)).astype(np.float32)
    return ids, np.where(ids >= 0, g, 0.0).astype(np.float32)


@pytest.mark.parametrize("p,cap,f,base", [
    (4, 16, 64, 0), (8, 32, 64, 16), (1, 64, 256, 0), (3, 10, 32, 8),
])
def test_owner_accumulate_integer_bit_exact(p, cap, f, base):
    """Integer-valued grads make every total exact: the port's sort +
    run totals + scatter equals both JAX paths bit for bit.

    Ids below `base` are made padding: an owner never receives them
    (route_build sends id to owner id // block), and on them the two
    packages differ by design: JAX's scatter wraps a negative local index
    to the end of the block, the port drops it."""
    ids, g = _routing_case(p, cap, f, seed=p + cap, integer_grads=True)
    ids = np.where(ids < base, -1, ids)
    acc = np.zeros((f,), np.float32)
    got = ops.owner_accumulate(torch.from_numpy(ids), torch.from_numpy(g),
                               torch.from_numpy(acc.copy()), base)
    for impl in ("xla", "pallas_interpret"):
        want = jops.owner_accumulate(jnp.asarray(ids), jnp.asarray(g),
                                     jnp.asarray(acc), base, impl=impl,
                                     block=16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_owner_accumulate_float_tolerance():
    ids, g = _routing_case(8, 64, 128, seed=7)
    acc = np.zeros((128,), np.float32)
    got = ops.owner_accumulate(torch.from_numpy(ids), torch.from_numpy(g),
                               torch.from_numpy(acc.copy()), 0)
    for impl in ("xla", "pallas_interpret"):
        want = jops.owner_accumulate(jnp.asarray(ids), jnp.asarray(g),
                                     jnp.asarray(acc), 0, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_owner_accumulate_in_place_and_edge_shapes():
    """The port adds into the accumulator in place. All-padding input is a
    no-op; one feature everywhere concentrates every add into one slot."""
    acc0 = torch.arange(32, dtype=torch.float32)
    acc = acc0.clone()
    out = ops.owner_accumulate(torch.full((4, 16), -1, dtype=torch.int32),
                               torch.ones((4, 16)), acc, 0)
    assert out is acc and torch.equal(out, acc0)
    out = ops.owner_accumulate(torch.full((4, 16), 5, dtype=torch.int32),
                               torch.ones((4, 16)), torch.zeros(32), 0)
    want = torch.zeros(32)
    want[5] = 64.0
    assert torch.equal(out, want)


def test_owner_accumulate_base_offset_drop():
    """Ids beyond the owner window [base, base + rows) and padding drop."""
    ids = np.asarray([[17, 18, 31, -1, 40]], np.int32)
    g = np.asarray([[2.0, 3.0, 4.0, 9.0, 5.0]], np.float32)
    want = jops.owner_accumulate(jnp.asarray(ids), jnp.asarray(g),
                                 jnp.zeros((16,)), 16, impl="xla")
    got = ops.owner_accumulate(torch.from_numpy(ids), torch.from_numpy(g),
                               torch.zeros(16), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == 2.0 and got[2] == 3.0 and got[15] == 4.0


def test_owner_accumulate_matches_plain_scatter():
    """The kernel-backed seam against the port's own plain scatter-add
    (`core.sparse.owner_accumulate`), the reference's XLA path."""
    from repro_torch.core import sparse

    ids, g = _routing_case(4, 32, 64, seed=3, integer_grads=True)
    ids_t, g_t = torch.from_numpy(ids), torch.from_numpy(g)
    want = sparse.owner_accumulate(ids_t, g_t, torch.zeros(48), 8)
    got = ops.owner_accumulate(ids_t, g_t, torch.zeros(48), 8)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# select_pack
# ---------------------------------------------------------------------------


def _select_pack_case(p, cap, seed, live_frac=0.8):
    """The JAX package's select_pack inputs (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4 * cap, size=(p, cap)).astype(np.int32)
    dead = rng.random(size=(p, cap)) > live_frac
    ids = np.where(dead, -1, ids)
    send = np.where(ids >= 0, rng.normal(size=(p, cap)), 0.0).astype(
        np.float32)
    carry = np.where(ids >= 0, rng.normal(size=(p, cap)), 0.0).astype(
        np.float32)
    return send, ids, carry


def _edge_rows():
    send, ids, carry = _select_pack_case(4, 16, seed=0)
    ids[1] = -1                                   # row 1 fully dead
    ids[2, 3:] = -1                               # row 2: 3 live < k
    return (np.where(ids >= 0, send, 0.0).astype(np.float32), ids,
            np.where(ids >= 0, carry, 0.0).astype(np.float32))


def _tie_break():
    ids = np.arange(12, dtype=np.int32).reshape(1, 12)
    send = np.full((1, 12), 0.5, np.float32)
    send[0, 7] = -0.5                             # same |.|, negative
    return send, ids, np.zeros((1, 12), np.float32)


def _signed_zeros():
    """+0.0 and -0.0 compensated values tie with each other and with dead
    slots' 0 only by position; a live -0.0 keeps its sign."""
    ids = np.asarray([[3, -1, 9, 4, 7, -1, 2, 8]], np.int32)
    send = np.asarray([[0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 0.0, -2.0]],
                      np.float32)
    carry = np.asarray([[-0.0, 0.0, -0.0, 0.0, 0.0, 0.0, -0.0, 0.0]],
                       np.float32)
    return send, ids, carry


SELECT_PACK_CASES = {
    # every case of tests/test_kernels.py, against the Pallas kernel
    **{f"sweep-{p}x{cap}-k{k}": (lambda p=p, cap=cap, k=k: (
        *_select_pack_case(p, cap, seed=p * 1000 + cap + k), k))
       for p, cap, k in [(1, 8, 2), (4, 64, 16), (3, 33, 7), (8, 128, 128),
                         (2, 16, 1), (5, 40, 39)]},
    "edge-rows": lambda: (*_edge_rows(), 8),
    "tie-break": lambda: (*_tie_break(), 4),
    "signed-zeros": lambda: (*_signed_zeros(), 5),
}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("case", sorted(SELECT_PACK_CASES))
def test_select_pack_matches_pallas_bit_exact(case):
    """All three outputs, the order of the packed pairs included, equal the
    Pallas kernel's (interpret mode) and the JAX chain's bit for bit."""
    send, ids, carry, k = SELECT_PACK_CASES[case]()
    got = ops.select_pack(torch.from_numpy(send), torch.from_numpy(ids),
                          torch.from_numpy(carry), k)
    want = jops.select_pack(jnp.asarray(send), jnp.asarray(ids),
                            jnp.asarray(carry), k=k, impl="pallas_interpret")
    chain = jref.select_pack_ref(jnp.asarray(send), jnp.asarray(ids),
                                 jnp.asarray(carry), k=k)
    for g, w, c in zip(got, want, chain, strict=True):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(c))


def test_select_pack_above_pallas_capacity():
    """cap 4,104 is above the Pallas kernel's MAX_CAPACITY, where the JAX
    seam runs its XLA chain; the port has no capacity bound."""
    from repro.kernels import select_pack as jsp

    p, cap, k = 8, jsp.MAX_CAPACITY + 8, 205
    send, ids, carry = _select_pack_case(p, cap, seed=11)
    got = ops.select_pack(torch.from_numpy(send), torch.from_numpy(ids),
                          torch.from_numpy(carry), k)
    want = jref.select_pack_ref(jnp.asarray(send), jnp.asarray(ids),
                                jnp.asarray(carry), k=k)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_select_pack_edge_rows_semantics():
    """Dead picks carry id -1 and value 0; a row with <= k live slots
    sends them all and banks nothing; k = cap ranks every slot."""
    send, ids, carry = _edge_rows()
    vals_k, ids_k, resid = ops.select_pack(
        torch.from_numpy(send), torch.from_numpy(ids),
        torch.from_numpy(carry), 8)
    assert (ids_k[1] == -1).all() and (vals_k[1] == 0).all()
    assert (resid[2] == 0).all() and (ids_k[2, 3:] == -1).all()
    vals_k, ids_k, resid = ops.select_pack(
        torch.from_numpy(send), torch.from_numpy(ids),
        torch.from_numpy(carry), 16)
    assert not resid.any()
    assert sorted(ids_k[0].tolist()) == sorted(ids[0].tolist())
