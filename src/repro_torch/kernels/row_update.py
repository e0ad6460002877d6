"""Wrapper of the CUDA `row_update` kernel (`csrc/row_update.cu`).

The sparse optimizer over the rows that a step's reduce gave a gradient:
`sgd` or `adagrad` applied IN PLACE to the rows that the run ends of
`kernels.ops.sorted_run_totals` name inside the owner block, with the f32
operations of the dense update (`optim.optimizers`) in its order, so the
state after it is the dense update's bit for bit. The JAX package has no
counterpart: its optimizer passes over the whole table.

On CPU tensors the wrapper computes the plain version
(`ref.row_update_ref`); on CUDA tensors it launches the kernel, or raises
on inputs the kernel does not take, through the op
`repro_torch::row_update` (`_op`), so that a profile links the kernel to
its caller. It never reads a device value: a 0-d CUDA `lr` is handed to
the kernel as a pointer. The `obs` counter `launch.row_update` counts
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import obs
from repro_torch.kernels import build, ref

KINDS = ("sgd", "adagrad")
_F32, _I32 = torch.float32, torch.int32
_LIBS: list = []


def row_update(kind: str, theta: torch.Tensor, acc: torch.Tensor,
               ids_s: torch.Tensor, totals: torch.Tensor, base: int, lr,
               eps: float = 0.0):
    """kind: "sgd" or "adagrad"; theta, acc: (rows,) f32 owner block whose
    row 0 is global id `base`, updated IN PLACE (acc unused by sgd);
    ids_s, totals: (N,) as `sorted_run_totals` returns them (int32 ids
    sorted ascending, padding -1 last; each run's total at its last
    slot); lr: a Python number or a 0-d f32 tensor; eps: adagrad's.
    Returns (theta, acc)."""
    if kind not in KINDS:
        raise ValueError(f"row_update: no kind {kind!r}; kinds: {KINDS}")
    if theta.device.type == "cpu":
        return ref.row_update_ref(kind, theta, acc, ids_s, totals, base, lr,
                                  eps)
    lr_t, lr_val = _check(kind, theta, acc, ids_s, totals, lr)
    if ids_s.shape[0]:
        _op()(theta, acc, ids_s, totals, int(base), lr_t, lr_val,
              float(eps), KINDS.index(kind))
    return theta, acc


@functools.cache
def _op():
    """The op `repro_torch::row_update` (defined on first use), whose CUDA
    implementation launches the kernel. A profiler links a ctypes launch
    to no host operation, but a launch inside an op to the op: so the
    kernel's device time counts under the span that holds the call (the
    optimizer's). A `torch.library.Library` op, not a `custom_op`: its
    dispatch costs the host about a tenth as much."""
    lib = torch.library.Library("repro_torch", "FRAGMENT")
    lib.define("row_update(Tensor(a!) theta, Tensor(b!) acc, Tensor ids_s, "
               "Tensor totals, int base, Tensor? lr_t, float lr, float eps, "
               "int kind) -> ()")
    lib.impl("row_update", _launch, "CUDA")
    _LIBS.append(lib)       # the registration lives as long as `lib`
    return torch.ops.repro_torch.row_update


def _launch(theta, acc, ids_s, totals, base, lr_t, lr, eps, kind):
    build.check(build.library().repro_row_update_f32(
        ids_s.data_ptr(), totals.data_ptr(), ids_s.shape[0], base,
        theta.shape[0], theta.data_ptr(),
        acc.data_ptr() if KINDS[kind] == "adagrad" else None,
        None if lr_t is None else lr_t.data_ptr(), ctypes.c_float(lr),
        ctypes.c_float(eps), kind, torch._C._cuda_getCurrentRawStream(
            theta.get_device())), "row_update")
    obs.count("launch.row_update")


def _check(kind, theta, acc, ids_s, totals, lr):
    """(lr as a 0-d tensor on the card or None, lr's value or 0), or raise
    on what the kernel does not take."""
    if not theta.is_cuda:
        raise ValueError(f"row_update: no kernel for device {theta.device}")
    tensors = [theta, ids_s, totals] + ([acc] if kind == "adagrad" else [])
    dev = theta.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("row_update: theta, acc, ids and totals must be on "
                         "one device")
    if theta.dim() != 1 or ids_s.dim() != 1 \
            or totals.shape != ids_s.shape \
            or (kind == "adagrad" and acc.shape != theta.shape):
        raise ValueError(
            f"row_update: shapes theta {tuple(theta.shape)}, acc "
            f"{tuple(acc.shape)}, ids {tuple(ids_s.shape)}, totals "
            f"{tuple(totals.shape)}")
    if (theta.dtype, ids_s.dtype, totals.dtype) != (_F32, _I32, _F32) or \
            (kind == "adagrad" and acc.dtype != _F32):
        raise TypeError("row_update: theta, acc, totals f32 and ids int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("row_update: theta, acc, ids and totals must be "
                         "contiguous")
    if isinstance(lr, torch.Tensor):
        if lr.dim() != 0:
            raise ValueError(f"row_update: lr of shape {tuple(lr.shape)}")
        if lr.device.type == "cpu":
            return None, float(lr)
        if lr.dtype != _F32 or lr.get_device() != dev:
            raise ValueError(f"row_update: lr is {lr.dtype} on {lr.device}; "
                             f"the kernel reads an f32 on {theta.device}")
        return lr, 0.0
    return None, float(lr)
