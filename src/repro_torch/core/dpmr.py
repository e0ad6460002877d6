"""Distributed Parameter Map-Reduce on one card: the counterpart of
`repro.core.dpmr`.

One train step runs the paper's stages in order:

  stage                 paper          here
  -----                 -----          ----
  initParameters        Algorithm 2    init_state (zeros; hot set external)
  (hot sharding)        §4             hot_sharding.split_hot
  invertDocuments       Algorithm 3    sparse.route_build
  distributeParameters  Algorithm 4    a2a(requests) + sparse.owner_apply
                                       + a2a(responses)
  restoreDocuments      Algorithm 5    sparse.route_return
  computeGradients      Algorithm 6    kernels.ops.sigmoid_grad (map body)
                                       + sparse.combine_grads (combiner)
  (reduce shuffle)                     a2a(grad sums) +
                                       kernels.ops.owner_accumulate
  updateParameters      Algorithm 7    sparse optimizer on the owner block,
                                       and on the replicated hot set

The step functions are plain functions on tensors: no `nn.Module` and no
`autograd.Function`. The JAX package never differentiates either: the
logistic-regression gradient is analytic and comes out of the
`sigmoid_grad` kernel's forward pass, so there is nothing for autograd
to do, and everything here runs under `torch.no_grad()`.

Where the reference jits `train_step` and `apply_update` with the state
DONATED (its (F,)-sized buffers alias the outputs), the port updates the
state's tensors IN PLACE and returns the same `DPMRState`: at 2^27
features `cold` and `cold_acc` are 512 MiB each. Treat a state passed to
`train_step` or `apply_update` as updated; `grad_step` and `predict` do
not touch it.

On one card there is one shard (P = 1) and the all_to_all stages are the
identity (`api.strategies._all_to_all`).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.configs.base import DPMRConfig
from repro_torch.core import hot_sharding
from repro_torch.kernels import ops
from repro_torch.optim import optimizers, schedules


class DPMRState(NamedTuple):
    cold: torch.Tensor       # (F,) f32 feature table (owner block)
    hot: torch.Tensor        # (max_hot,) f32 replicated Zipf head
    hot_ids: torch.Tensor    # (max_hot,) int32 sorted, INT_MAX padded
    cold_acc: torch.Tensor   # (F,) optimizer accumulator, like cold
    hot_acc: torch.Tensor    # (max_hot,) optimizer accumulator
    step: torch.Tensor       # () int32
    strat: torch.Tensor      # (P,) f32 zeros: the reference's strategy
    #                          carry, which stateless `a2a` leaves at zero


def padded_features(cfg: DPMRConfig, num_shards: int = 1) -> int:
    return -(-cfg.num_features // num_shards) * num_shards


def capacity_for_shards(cfg: DPMRConfig, batch_local: int, p: int,
                        factor: float = 4.0) -> int:
    """Per-(src,dst) a2a slots for cold features: factor x the uniform
    mean, rounded up to 8, at least 16, at most every slot."""
    n = batch_local * cfg.max_features_per_sample
    mean = max(1, n // p)
    return int(min(n, max(16, -(-int(factor * mean) // 8) * 8)))


def capacity(cfg: DPMRConfig, batch_local: int, num_shards: int = 1,
             factor: float = 4.0) -> int:
    return capacity_for_shards(cfg, batch_local, num_shards, factor)


def make_strategy_context(cfg: DPMRConfig, num_shards: int = 1,
                          cap: int = 0):
    """The `StrategyContext` of this geometry (rank 0 of `num_shards`)."""
    # late import: repro_torch.api.strategies imports from repro_torch.core
    from repro_torch.api.strategies import StrategyContext

    return StrategyContext(
        num_shards=num_shards,
        block_size=padded_features(cfg, num_shards) // num_shards,
        capacity=cap)


def init_state(cfg: DPMRConfig, device, hot_ids=None,
               num_shards: int = 1) -> DPMRState:
    device = torch.device(device)
    f = padded_features(cfg, num_shards)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    if hot_ids is None:
        hot_ids = torch.full((cfg.max_hot,), hot_sharding.INT_MAX,
                             dtype=torch.int32, device=device)
    hot_ids = torch.as_tensor(hot_ids).to(device=device, dtype=torch.int32)
    return DPMRState(zeros(f), zeros(cfg.max_hot), hot_ids, zeros(f),
                     zeros(cfg.max_hot),
                     torch.zeros((), dtype=torch.int32, device=device),
                     zeros(num_shards))


def optimize(cfg: DPMRConfig, theta, acc, grad, lr):
    """Algorithm 7 step 12: newPara = optimize(para, grad), in place."""
    return optimizers.get_sparse_optimizer(cfg.optimizer).update(
        theta, acc, grad, lr, cfg)


def make_schedule(cfg: DPMRConfig) -> Callable:
    """LR schedule for the sparse face from the schedule registry."""
    return schedules.get_schedule_by_name(
        cfg.schedule, cfg.learning_rate,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps)


# ---------------------------------------------------------------------------
# per-device stage pipeline
# ---------------------------------------------------------------------------


def _device_fwd(cfg, strategy, ctx, cold_loc, hot, hot_ids, ids, vals):
    """Stages distribute+restore: returns (theta (B,K), fwd-state, aux)."""
    flat = ids.reshape(-1)
    hot_slot, is_hot, cold_ids = hot_sharding.split_hot(flat, hot_ids)
    theta_cold, fwd = strategy.distribute(ctx, cold_loc, cold_ids)
    theta_hot = torch.where(is_hot, hot[torch.clamp(hot_slot, min=0)], 0.0)
    theta = (theta_cold + theta_hot).reshape(ids.shape)
    aux = {"hot_slot": hot_slot, "is_hot": is_hot,
           "overflow": fwd["overflow"]}
    return theta, fwd, aux


def _device_grads(cfg, strategy, ctx, cold_loc, grads_slot, fwd, aux):
    """Reduce stages: per-feature sums delivered to the owner, and the
    hot-set gradient (summed over ranks: the identity at P = 1)."""
    gflat = grads_slot.reshape(-1)
    grad_cold = strategy.reduce(ctx, cold_loc, gflat, fwd)
    return grad_cold, hot_grads(cfg, gflat, aux["hot_slot"], aux["is_hot"])


def hot_grads(cfg, gflat, hot_slot, is_hot):
    """(max_hot,) hot-set gradient: a plain scatter-add of the hot slots,
    the cold ones dropped into one extra slot.

    The Zipf head collides heavily here, and `index_add_` on the card adds
    in atomic order: on an H100 five gradient steps from one state gave
    hot gradients that differ in their last bits (chip_smoke.py, parity
    phase), so the card's hot update is not bit-reproducible run to run.
    """
    ghot = torch.zeros((cfg.max_hot + 1,), dtype=torch.float32,
                       device=gflat.device)
    ghot.index_add_(0, torch.where(is_hot, hot_slot, cfg.max_hot),
                    torch.where(is_hot, gflat, 0.0))
    return ghot[:cfg.max_hot]


def _metrics(probs, labels, nll, overflow) -> dict:
    y = labels.to(torch.float32)
    pred = (probs >= 0.5).to(torch.float32)
    return {"loss": torch.mean(nll),
            "accuracy": torch.mean((pred == y).to(torch.float32)),
            "overflow": overflow}


# ---------------------------------------------------------------------------
# public step builders
# ---------------------------------------------------------------------------


class StepFns(NamedTuple):
    """The DPMR step functions of one batch size, plus their geometry.

    `train_step` and `apply_update` update the state passed to them IN
    PLACE and return it; `grad_step` and `predict` leave it untouched.
    `ctx` is the `StrategyContext` of these steps: feed it to
    `strategy.bytes_per_device` for the wire model of this geometry.
    """

    train_step: Callable     # (state, batch) -> (state, metrics)
    grad_step: Callable      # (state, batch) -> (grad_cold, grad_hot, metrics)
    apply_update: Callable   # (state, grad_cold, grad_hot, lr) -> state
    predict: Callable        # (state, batch) -> probs
    capacity: int            # per-(src,dst) a2a slots
    block_size: int          # feature-table rows per rank
    num_shards: int          # P
    strategy: str = "a2a"    # distribution-strategy name
    ctx: object = None       # StrategyContext of these steps


def make_step_fns(cfg: DPMRConfig, batch_size: int, *,
                  num_shards: int = 1, cap_factor: float = 4.0) -> StepFns:
    """Step functions for a GLOBAL batch of `batch_size` samples.

    Batches are dicts of tensors on the state's device: ids (B, K) int32,
    vals (B, K) f32, labels (B,) int32. They run where their tensors lie:
    on the card the map body and the owner reduce launch the CUDA kernels
    (`kernels.ops`), on the CPU they take the plain versions."""
    # late import: repro_torch.api.strategies imports from this package
    from repro_torch.api.strategies import get_strategy

    p = num_shards
    f = padded_features(cfg, p)
    if batch_size % p:
        raise ValueError(f"batch {batch_size} is not a multiple of P={p}")
    cap = capacity(cfg, batch_size // p, p, cap_factor)
    strategy = get_strategy(cfg.distribution)
    ctx = make_strategy_context(cfg, p, cap)
    sched = make_schedule(cfg)

    def _fwd_grads(state, batch):
        ids, vals, labels = batch["ids"], batch["vals"], batch["labels"]
        theta, fwd, aux = _device_fwd(cfg, strategy, ctx, state.cold,
                                      state.hot, state.hot_ids, ids, vals)
        grads_slot, probs, nll = ops.sigmoid_grad(vals, theta, labels)
        if cfg.grad_scale == "mean":
            grads_slot = grads_slot / float(batch_size)
        grad_cold, grad_hot = _device_grads(cfg, strategy, ctx, state.cold,
                                            grads_slot, fwd, aux)
        return grad_cold, grad_hot, _metrics(probs, labels, nll,
                                             aux["overflow"])

    @torch.no_grad()
    def train_step(state: DPMRState, batch):
        grad_cold, grad_hot, m = _fwd_grads(state, batch)
        lr = sched(state.step)
        optimize(cfg, state.cold, state.cold_acc, grad_cold, lr)
        optimize(cfg, state.hot, state.hot_acc, grad_hot, lr)
        state.step.add_(1)
        return state, m

    @torch.no_grad()
    def grad_step(state: DPMRState, batch):
        return _fwd_grads(state, batch)

    @torch.no_grad()
    def apply_update(state: DPMRState, grad_cold, grad_hot, lr: float):
        optimize(cfg, state.cold, state.cold_acc, grad_cold, lr)
        optimize(cfg, state.hot, state.hot_acc, grad_hot, lr)
        state.step.add_(1)
        return state

    @torch.no_grad()
    def predict(state: DPMRState, batch):
        theta, _, _ = _device_fwd(cfg, strategy, ctx, state.cold, state.hot,
                                  state.hot_ids, batch["ids"], batch["vals"])
        return torch.sigmoid(torch.sum(batch["vals"] * theta, dim=-1))

    return StepFns(train_step=train_step, grad_step=grad_step,
                   apply_update=apply_update, predict=predict,
                   capacity=cap, block_size=f // p, num_shards=p,
                   strategy=cfg.distribution, ctx=ctx)
