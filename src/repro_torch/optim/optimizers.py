"""DPMR sparse-face optimizers: the counterpart of the `SPARSE_OPTIMIZERS`
registry in `repro.optim.optimizers` (the dense optimizers come with the
dense face).

The engine carries exactly one auxiliary array per parameter table
(`DPMRState.cold_acc` / `hot_acc`). A sparse optimizer is a
`(theta, acc, grad, lr, cfg) -> (theta, acc)` update. Where the reference
returns new arrays from donated buffers, the port updates `theta` and
`acc` IN PLACE under `torch.no_grad()` and returns the same tensors: at
2^27 features each table is 512 MiB, and a copy per step would double
the state. `lr` is a Python float or a 0-d f32 tensor on the tables'
device; the arithmetic is f32, in the reference's order.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch


class SparseOptimizer(NamedTuple):
    update: Callable     # (theta, acc, grad, lr, cfg) -> (theta, acc)


@torch.no_grad()
def _sparse_sgd(theta, acc, grad, lr, cfg):
    theta.sub_(grad * lr)
    return theta, acc


@torch.no_grad()
def _sparse_adagrad(theta, acc, grad, lr, cfg):
    acc.add_(grad * grad)
    step = torch.rsqrt(acc + cfg.adagrad_eps).mul_(grad)
    theta.sub_(step.mul_(lr))
    return theta, acc


@torch.no_grad()
def _sparse_momentum(theta, acc, grad, lr, cfg):
    acc.mul_(cfg.momentum).add_(grad)
    theta.sub_(acc * lr)
    return theta, acc


SPARSE_OPTIMIZERS = {
    "sgd": SparseOptimizer(_sparse_sgd),
    "adagrad": SparseOptimizer(_sparse_adagrad),
    "momentum": SparseOptimizer(_sparse_momentum),
}


def get_sparse_optimizer(name: str) -> SparseOptimizer:
    try:
        return SPARSE_OPTIMIZERS[name]
    except KeyError:
        raise KeyError(
            f"unknown sparse optimizer {name!r}; "
            f"registered: {sorted(SPARSE_OPTIMIZERS)}") from None
