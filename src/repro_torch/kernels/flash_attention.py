"""Wrapper of the CUDA `flash_attention` kernel (`csrc/flash_attention.cu`).

Replaces the Pallas TPU kernel `repro.kernels.flash_attention.
flash_attention`: causal (or full) GQA attention forward with an online
softmax, in the (B, S, H, D) layout. The port's prefill runs it for every
layer's self-attention (and whisper's encoder and cross-attention, not
causal), where the reference's dense prefill runs the XLA
online softmax `layers.blocked_causal_attention` that the Pallas kernel
stands in for on a TPU. The source note in the `.cu` file says what bounds
it on the card (tensor-core operations) and what the design does.

With `causal`, key j is visible from query i when j <= i + (Skv - Sq): the
plain version's bottom-right alignment (ROADMAP C2), which for Sq == Skv
is the Pallas kernel's mask. A causal call with Sq > Skv raises on every
device: such rows would see no key, and no path makes one.

On CPU tensors the wrapper computes the plain version
(`ref.flash_attention_ref`); on CUDA tensors it launches the kernel, or
raises on inputs the kernel does not take: bf16 only (f32 raises
`TypeError`), D in {64, 80, 128} (80 is zamba2's, computed in the tiles
of 128), a dense head dim, strides that are
multiples of 8 and a 16-byte aligned base (what the kernel's TMA tensor
maps take).
The `obs` counter `launch.flash_attention` counts launches.

On fake tensors (`FakeTensorMode`, the dry run of `launch.dryrun`) the
wrapper dispatches to the custom op `repro_torch::flash_attention`
(`fake_op`): its fake implementation allocates only the (B, Sq, H, D)
output, the kernel's footprint, where the plain version would build
the S x S scores, and `flops` is its FLOP formula for
`FlopCounterMode`: the pairs the mask lets through, as the kernel
computes them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import obs
from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 80, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KH, D) with H % KH == 0.
    Returns (B, Sq, H, D) in q's dtype, as `ref.flash_attention_ref`."""
    _check_shapes(q, k, v, causal)
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(q, FakeTensor):
        return fake_op()(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    _check_cuda(q, k, v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    status = build.library().repro_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        h, kh, d, strides, 1.0 / math.sqrt(d), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_attention")
    obs.count("launch.flash_attention")
    return out


@functools.cache
def fake_op():
    """The custom op `repro_torch::flash_attention` (registered on first
    use): on real tensors the wrapper; on fake tensors an empty output."""

    @torch.library.custom_op("repro_torch::flash_attention",
                             mutates_args=())
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
        return flash_attention(q, k, v, causal=causal)

    @op.register_fake
    def _(q, k, v, causal):
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    return op


def flops(q_shape, k_shape, v_shape, causal, *, out_shape=None) -> int:
    """FLOPs of one call: 4 D a head and visible (query, key) pair (q.k
    and p.v); with `causal`, query i sees keys j <= i + (Skv - Sq).
    Takes the shapes, as `FlopCounterMode`'s `custom_mapping` passes
    them."""
    b, sq, h, d = q_shape
    skv = k_shape[1]
    pairs = sq * (skv - sq + 1) + sq * (sq - 1) // 2 if causal \
        else sq * skv
    return 4 * d * pairs * b * h


def _check_shapes(q, k, v, causal) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}; expected (B, Sq, H, D) "
            "and two (B, Skv, KH, D)")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 \
            or h % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "need the same B and D, and H divisible by KH")
    if k.shape[1] == 0 and sq:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if causal and sq > k.shape[1]:
        raise ValueError(
            f"flash_attention: causal with Sq = {sq} > Skv = {k.shape[1]}: "
            "the first Sq - Skv rows would see no key")


def _check_cuda(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}; the kernel takes "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, the "
                            "kernel takes torch.bfloat16")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} strides {t.stride()}: the kernel "
                "reads by TMA, so it needs a dense head dim, other "
                "strides that are multiples of 8 and a 16-byte aligned base")
