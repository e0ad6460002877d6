"""Wrapper of the CUDA `sigmoid_grad` kernel (`csrc/sigmoid_grad.cu`).

Replaces the Pallas TPU kernel `repro.kernels.sigmoid_grad.sigmoid_grad`:
the DPMR computeGradients map body, one pass over a (B, K) block of
sufficient samples. The source note in the `.cu` file says what bounds it
on the card (memory; the launch and one round trip at the main path's
shape) and what the design does about it.

On CPU tensors the wrapper computes the plain version
(`ref.sigmoid_grad_ref`); on CUDA tensors it launches the kernel, or
raises on inputs the kernel does not take. The `obs` counter
`launch.sigmoid_grad` counts launches.

A call costs the host more than the card, so the wrapper keeps its host
work small: one allocation holds grads, probs and nll (`layout`), each
part starting on a 16-byte boundary; the checks read each tensor's
attributes once; the stream is taken as its raw handle. It allocates
nothing the kernel keeps and never synchronises, so a call may be
captured in a CUDA graph.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import build, ref

_F32, _I32 = torch.float32, torch.int32


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def layout(b: int, k: int) -> tuple[int, int, int]:
    """(offset of probs, offset of nll, total floats) in the one output
    buffer, grads first at 0; as `repro_sigmoid_grad_f32` places them."""
    p = _round4(b * k)
    n = p + _round4(b)
    return p, n, n + b


def sigmoid_grad(vals: torch.Tensor, theta: torch.Tensor,
                 labels: torch.Tensor):
    """vals, theta: (B, K) f32; labels: (B,) int32 in {0, 1}.
    Returns (grads (B, K), probs (B,), nll (B,)), all f32."""
    if not vals.is_cuda and vals.device.type == "cpu":
        return ref.sigmoid_grad_ref(vals, theta, labels)
    b, k = _check(vals, theta, labels)
    p, n, total = layout(b, k)
    out = torch.empty((total,), dtype=_F32, device=vals.device)
    grads = out.as_strided((b, k), (k, 1))
    probs = out.as_strided((b,), (1,), p)
    nll = out.as_strided((b,), (1,), n)
    if b == 0:
        return grads, probs, nll
    build.check(build.library().repro_sigmoid_grad_f32(
        vals.data_ptr(), theta.data_ptr(), labels.data_ptr(), out.data_ptr(),
        b, k, torch._C._cuda_getCurrentRawStream(vals.get_device())),
        "sigmoid_grad")
    obs.count("launch.sigmoid_grad")
    return grads, probs, nll


def _check(vals, theta, labels) -> tuple[int, int]:
    """(B, K), or raise on what the kernel does not take."""
    if not vals.is_cuda:
        raise ValueError(f"sigmoid_grad: no kernel for device {vals.device}")
    shape = vals.shape
    if len(shape) != 2 or theta.shape != shape \
            or labels.shape != shape[:1]:
        raise ValueError(
            f"sigmoid_grad: shapes vals {tuple(shape)}, theta "
            f"{tuple(theta.shape)}, labels {tuple(labels.shape)}")
    if (vals.dtype, theta.dtype, labels.dtype) != (_F32, _F32, _I32):
        raise TypeError(
            f"sigmoid_grad: vals, theta, labels are {vals.dtype}, "
            f"{theta.dtype}, {labels.dtype}; the kernel takes "
            f"{_F32}, {_F32}, {_I32}")
    dev = vals.get_device()
    if theta.get_device() != dev or labels.get_device() != dev:
        raise ValueError(f"sigmoid_grad: vals on {vals.device}, theta on "
                         f"{theta.device}, labels on {labels.device}")
    if not (vals.is_contiguous() and theta.is_contiguous()
            and labels.is_contiguous()):
        raise ValueError("sigmoid_grad: vals, theta and labels must be "
                         "contiguous")
    return shape
