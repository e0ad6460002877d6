"""The port's plain attention against the JAX package's, on the CPU.

`repro_torch.kernels.ref.flash_attention_ref` is what the port's prefill
runs on the CPU and what `chip_smoke.py` holds the CUDA kernel against on
the card. Here it is held against the Pallas kernel run in interpret mode
at Sq == Skv, over the shapes, dtypes and tolerances of
tests/test_kernels.py (2e-5 in f32, 2e-2 in bf16), and against
`repro.kernels.ref.flash_attention_ref` at Sq < Skv, where the Pallas
kernel's mask is not aligned with its oracle's (ROADMAP C2) and the port
follows the oracle. Inputs are numpy draws, cast to bf16 the same way by
both packages. The CUDA kernel's own cases are in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, registry

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, sq, skv, h, kh, d, dtype, seed):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d))]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shapes", [
    (1, 32, 2, 2, 8), (2, 64, 4, 2, 16), (2, 128, 8, 1, 32),
    (1, 64, 6, 3, 16),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_pallas(shapes, dtype, causal):
    b, s, h, kh, d = shapes
    (jq, jk, jv), (q, k, v) = _inputs(b, s, s, h, kh, d, dtype, sum(shapes))
    want = jops.flash_attention(jq, jk, jv, causal=causal,
                                impl="pallas_interpret", block_q=16,
                                block_k=16)
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("sq,skv", [(8, 16), (1, 33), (20, 64), (63, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_oracle_below_skv(sq, skv, causal):
    """Sq < Skv: key j visible from query i when j <= i + (Skv - Sq)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, sq, skv, 4, 2, 16, "float32",
                                      sq * skv)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    _close(got, want, 2e-5)


def test_plain_attention_gqa_group_mapping():
    """GQA: each q head must attend to ITS kv head, not head 0."""
    b, s, h, kh, d = 1, 16, 4, 2, 8
    _, (q, k, v) = _inputs(b, s, s, h, kh, d, "float32", 9)
    out = ref.flash_attention_ref(q, k, v)
    # head 3 belongs to kv head 1: zeroing kv head 0 must not change it
    k0, v0 = k.clone(), v.clone()
    k0[:, :, 0] = 0.0
    v0[:, :, 0] = 0.0
    out2 = ref.flash_attention_ref(q, k0, v0)
    torch.testing.assert_close(out[:, :, 3], out2[:, :, 3], atol=1e-6,
                               rtol=0)
    assert not torch.allclose(out[:, :, 0], out2[:, :, 0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_attention_matches_reference_layer(dtype):
    """The port's prefill self-attention against the reference's prefill
    attention, `layers.blocked_causal_attention`, with blocks small enough
    to take its online-softmax path over several kv blocks."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 64, 64, 8, 2, 16, dtype, 4)
    want = jlayers.blocked_causal_attention(jq, jk, jv, q_block=16,
                                            kv_block=16)
    got = layers.causal_self_attention(q, k, v)
    _close(got, want, DTYPES[dtype][2])


def test_seam_on_cpu_runs_the_plain_version():
    _, (q, k, v) = _inputs(1, 40, 40, 4, 2, 16, "bfloat16", 5)
    before = ops.launch_counts()["flash_attention"]
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
    assert torch.equal(ops.flash_attention(q, k, v, causal=False),
                       ref.flash_attention_ref(q, k, v, causal=False))
    assert ops.launch_counts()["flash_attention"] == before


def test_seam_refuses_on_every_device():
    _, (q, k, v) = _inputs(1, 40, 20, 4, 2, 16, "float32", 6)
    with pytest.raises(ValueError, match="Sq = 40 > Skv = 20"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="H divisible by KH"):
        ops.flash_attention(q[:, :, :3], k, v, causal=False)
    # every family of the reference resolves now; an unknown id raises
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_spec("not-an-arch")
