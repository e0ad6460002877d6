"""Optimizers of the port: the counterpart of `repro.optim.optimizers`,
its dense optimizers and its `SPARSE_OPTIMIZERS` registry.

Dense optimizers (`OPTIMIZERS`: sgd, momentum, adam, adamw) work on the
trainer's parameters as a dict name -> tensor (`named_parameters()`
order) and keep their moments in dicts under the same names, in
`opt_dtype`, beside adam's `count` (0-d int32 on the parameters'
device). `update(grads, state, params, lr, cfg)` runs the reference's
f32 operations in its order and writes the parameters and the state IN
PLACE under `torch.no_grad()` (the reference returns new arrays from
donated buffers); it returns `(params, state)`.

The sparse engine carries exactly one auxiliary array per parameter
table (`DPMRState.cold_acc` / `hot_acc`). A sparse optimizer is a
`(theta, acc, grad, lr, cfg) -> (theta, acc)` update. Where the reference
returns new arrays from donated buffers, the port updates `theta` and
`acc` IN PLACE under `torch.no_grad()` and returns the same tensors: at
2^27 features each table is 512 MiB, and a copy per step would double
the state. `lr` is a Python float or a 0-d f32 tensor on the tables'
device; the arithmetic is f32, in the reference's order.

A registry entry may also have a `rows` update, `(theta, acc, g, lr,
cfg)` with `g` a `kernels.ops.RowGrad`: the same update over only the
rows that a reduce's run totals name (`kernels.ops.row_update`). `sgd` and `adagrad` have one: a row
whose gradient is +0.0 keeps its bits under both (adagrad with eps > 0),
so it gives the dense update's state bit for bit without a pass over the
table. `momentum` decays every row and has none. `row_update(cfg)` says
which applies.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class Optimizer(NamedTuple):
    init: Callable           # (params, opt_dtype) -> state
    update: Callable         # (grads, state, params, lr, cfg) -> (params,
    #                          state), in place


def _zeros_like(params: dict, opt_dtype: str) -> dict:
    return {name: torch.zeros(p.shape, dtype=getattr(torch, opt_dtype),
                              device=p.device)
            for name, p in params.items()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (0-d f32)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, norm_fn=global_norm):
    """Scale the gradients IN PLACE by min(1, max_norm / norm); returns
    (grads, norm before clipping). `norm_fn(grads)` is the norm (over a
    mesh, one that sums every rank's blocks)."""
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


# --- SGD / momentum ---------------------------------------------------------


@torch.no_grad()
def _sgd_update(grads, state, params, lr, cfg):
    for name, p in params.items():
        p.copy_(p.to(torch.float32) - lr * grads[name].to(torch.float32))
    return params, state


@torch.no_grad()
def _momentum_update(grads, state, params, lr, cfg):
    for name, p in params.items():
        m = state["mu"][name]
        m.copy_(cfg.beta1 * m.to(torch.float32)
                + grads[name].to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * m.to(torch.float32))
    return params, state


# --- Adam / AdamW -----------------------------------------------------------


def _adam_init(params, opt_dtype):
    device = next(iter(params.values())).device
    return {"m": _zeros_like(params, opt_dtype),
            "v": _zeros_like(params, opt_dtype),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def _adamw_update(grads, state, params, lr, cfg,
                  weight_decay: float | None = None):
    wd = cfg.weight_decay if weight_decay is None else weight_decay
    state["count"] += 1
    b1, b2 = cfg.beta1, cfg.beta2
    count = state["count"].to(torch.float32)
    bc1 = 1.0 - b1 ** count
    bc2 = 1.0 - b2 ** count
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g32 = grads[name].to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + 1e-8)
        p32 = p.to(torch.float32)
        if wd:
            step = step + wd * p32
        p.copy_(p32 - lr * step)
        m.copy_(m32)
        v.copy_(v32)
    return params, state


def _adam_update(grads, state, params, lr, cfg):
    return _adamw_update(grads, state, params, lr, cfg, weight_decay=0.0)


OPTIMIZERS = {
    "sgd": Optimizer(lambda p, od: {}, _sgd_update),
    "momentum": Optimizer(lambda p, od: {"mu": _zeros_like(p, od)},
                          _momentum_update),
    "adam": Optimizer(_adam_init, _adam_update),
    "adamw": Optimizer(_adam_init, _adamw_update),
}


def get_optimizer(name: str) -> Optimizer:
    return OPTIMIZERS[name]


# --- DPMR sparse-face optimizers --------------------------------------------


class SparseOptimizer(NamedTuple):
    update: Callable     # (theta, acc, grad, lr, cfg) -> (theta, acc)
    rows: Callable | None = None   # (theta, acc, ops.RowGrad, lr, cfg) ->
    #                                (theta, acc); None: dense only


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


def _sgd_rows(theta, acc, g, lr, cfg):
    return ops.row_update("sgd", theta, acc, g.ids, g.totals, g.base, lr)


def _adagrad_rows(theta, acc, g, lr, cfg):
    return ops.row_update("adagrad", theta, acc, g.ids, g.totals, g.base,
                          lr, cfg.adagrad_eps)


SPARSE_OPTIMIZERS = {
    "sgd": SparseOptimizer(_sparse_sgd, _sgd_rows),
    "adagrad": SparseOptimizer(_sparse_adagrad, _adagrad_rows),
    "momentum": SparseOptimizer(_sparse_momentum),
}


def get_sparse_optimizer(name: str) -> SparseOptimizer:
    try:
        return SPARSE_OPTIMIZERS[name]
    except KeyError:
        raise KeyError(
            f"unknown sparse optimizer {name!r}; "
            f"registered: {sorted(SPARSE_OPTIMIZERS)}") from None


def row_update(cfg) -> Callable | None:
    """`cfg.optimizer`'s row update where it gives the dense update's
    bits, else None: adagrad at eps <= 0 turns an untouched row with a
    zero accumulator into NaN (rsqrt(0) * 0), so it keeps the dense
    pass there."""
    rows = get_sparse_optimizer(cfg.optimizer).rows
    if cfg.optimizer == "adagrad" and not cfg.adagrad_eps > 0:
        return None
    return rows
