"""Wrapper of the CUDA `sigmoid_grad` kernel (`csrc/sigmoid_grad.cu`).

Replaces the Pallas TPU kernel `repro.kernels.sigmoid_grad.sigmoid_grad`:
the DPMR computeGradients map body, one pass over a (B, K) block of
sufficient samples. The source note in the `.cu` file says what bounds it
on the card (memory; the launch dominates at the main path's shape) and
what the design does about it.

On CPU tensors the wrapper computes the plain version
(`ref.sigmoid_grad_ref`); on CUDA tensors it launches the kernel, or
raises on inputs the kernel does not take. `launches` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0


def sigmoid_grad(vals: torch.Tensor, theta: torch.Tensor,
                 labels: torch.Tensor):
    """vals, theta: (B, K) f32; labels: (B,) int32 in {0, 1}.
    Returns (grads (B, K), probs (B,), nll (B,)), all f32."""
    if vals.device.type == "cpu":
        return ref.sigmoid_grad_ref(vals, theta, labels)
    global launches
    _check(vals, theta, labels)
    b, k = vals.shape
    grads = torch.empty_like(vals)
    probs = torch.empty((b,), dtype=torch.float32, device=vals.device)
    nll = torch.empty((b,), dtype=torch.float32, device=vals.device)
    if b == 0:
        return grads, probs, nll
    lib = build.library()
    status = lib.repro_sigmoid_grad_f32(
        vals.data_ptr(), theta.data_ptr(), labels.data_ptr(),
        grads.data_ptr(), probs.data_ptr(), nll.data_ptr(), b, k,
        torch.cuda.current_stream(vals.device).cuda_stream)
    build.check(status, "sigmoid_grad")
    launches += 1
    return grads, probs, nll


def _check(vals, theta, labels) -> None:
    if vals.device.type != "cuda":
        raise ValueError(f"sigmoid_grad: no kernel for device {vals.device}")
    if vals.dim() != 2 or theta.shape != vals.shape \
            or labels.shape != vals.shape[:1]:
        raise ValueError(
            f"sigmoid_grad: shapes vals {tuple(vals.shape)}, theta "
            f"{tuple(theta.shape)}, labels {tuple(labels.shape)}")
    for name, t, dtype in (("vals", vals, torch.float32),
                           ("theta", theta, torch.float32),
                           ("labels", labels, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"sigmoid_grad: {name} is {t.dtype}, "
                            f"the kernel takes {dtype}")
        if t.device != vals.device:
            raise ValueError(f"sigmoid_grad: {name} on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"sigmoid_grad: {name} is not contiguous")
