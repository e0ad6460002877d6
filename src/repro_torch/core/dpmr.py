"""Distributed Parameter Map-Reduce over `torch.distributed`: the
counterpart of `repro.core.dpmr`.

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
                                       kernels.ops.owner_accumulate, or
                                       on train_step's row path the run
                                       totals alone
  updateParameters      Algorithm 7    sparse optimizer on the owner block
                                       (its touched rows on the row path),
                                       and on the replicated hot set

`train_step` takes the row path where the strategy has a row reduce
(`reduce_rows`: a2a, overlap_a2a) and the optimizer a row update
(`optim.optimizers.row_update`: sgd, adagrad with eps > 0): the reduce
hands over its run totals as a `kernels.ops.RowGrad`, and
`optimize` updates only the rows they name with the `row_update` kernel,
with no (F/P,) gradient and no pass over the table. The state is the
dense route's bit for bit. Every other pair, `grad_step`,
`apply_update` and the hot set take the dense gradient and update.

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

Spans and counters (`repro_torch.obs`): `train_step`, `grad_step` and
`apply_update` run inside `dpmr.step`, each `optimize` call inside
`optimizer.update`; `optimizer.row_updates` and `optimizer.dense_updates`
count the `optimize` calls by the path they take;
`optimizer.rows_passed` counts the rows each call passes over (a dense
call's whole table on the host, a row call's written rows on the device
while tracing is on), `optimizer.rows_given_grad` (with
`ops.owner_accumulate`'s) the rows and hot slots that receive a
gradient.

The reference runs the step as one `shard_map` program over every mesh
axis. Here each rank of a `DeviceMesh` (`launch.mesh`) runs the step on
its own rows of the global batch and its own block of the table, and the
strategies' collectives join the ranks. Without a mesh there is one rank
(P = 1) and no process group: the collectives are the identity
(`api.strategies._all_to_all`).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.configs.base import DPMRConfig
from repro_torch.core import hot_sharding
from repro_torch.kernels import ops
from repro_torch.optim import optimizers, schedules


class DPMRState(NamedTuple):
    """One rank's state: its block of the sharded leaves, and the
    replicated ones whole (the reference's global arrays, cut as its
    shardings cut them; `convert` goes between the two)."""

    cold: torch.Tensor       # (F/P,) f32 this rank's block of the table
    hot: torch.Tensor        # (max_hot,) f32 replicated Zipf head
    hot_ids: torch.Tensor    # (max_hot,) int32 sorted, INT_MAX padded
    cold_acc: torch.Tensor   # (F/P,) optimizer accumulator, like cold
    hot_acc: torch.Tensor    # (max_hot,) optimizer accumulator
    step: torch.Tensor       # () int32
    strat: torch.Tensor      # (L,) f32 this rank's persistent strategy
    #                          carry: L is the strategy's carry length, 1
    #                          (a zero placeholder) for a stateless one


def num_shards(mesh) -> int:
    """P = ranks of `mesh` (1 without one)."""
    return 1 if mesh is None else int(mesh.size())


def padded_features(cfg: DPMRConfig, p: int = 1) -> int:
    """F rounded up to a multiple of the shard count `p`."""
    return -(-cfg.num_features // p) * p


def capacity_for_shards(cfg: DPMRConfig, batch_local: int, p: int,
                        factor: float = 4.0) -> int:
    """Per-(src,dst) a2a slots for cold features: factor x the uniform
    mean, rounded up to 8, at least 16, at most every slot."""
    n = batch_local * cfg.max_features_per_sample
    mean = max(1, n // p)
    return int(min(n, max(16, -(-int(factor * mean) // 8) * 8)))


def capacity(cfg: DPMRConfig, batch_local: int, p: int = 1,
             factor: float = 4.0) -> int:
    return capacity_for_shards(cfg, batch_local, p, factor)


def make_strategy_context(cfg: DPMRConfig, mesh=None, cap: int = 0):
    """The `StrategyContext` of this rank of `mesh`: its rank, the
    (outer, inner) tiers of `launch.mesh.tier_shards` and the mesh's
    process groups. Without a mesh: one rank and no group. `cap` is the
    per-(src,dst) a2a capacity (0 where only the geometry matters)."""
    # late import: repro_torch.api.strategies imports from repro_torch.core
    from repro_torch.api.strategies import StrategyContext
    from repro_torch.launch import mesh as mesh_lib

    p = num_shards(mesh)
    if mesh is None:
        po, rank, groups = 1, 0, None
    else:
        po, _ = mesh_lib.tier_shards(mesh)
        rank = mesh_lib.mesh_rank(mesh)
        groups = mesh_lib.process_groups(mesh)
    return StrategyContext(
        num_shards=p, block_size=padded_features(cfg, p) // p,
        capacity=cap, topk_frac=cfg.topk_frac, rank=rank, outer_shards=po,
        groups=groups)


_AUTOTUNE_BATCH_LOCAL = 128
#   nominal per-rank batch behind cfg.distribution == "auto": the
#   autotuner prices capacity at this fixed size so one (cfg, mesh) pair
#   resolves to ONE strategy; a batch-size-dependent choice could flip
#   between StepFns and invalidate the persistent carry's shape


def resolve_distribution(cfg: DPMRConfig, mesh=None) -> str:
    """The concrete strategy name for this (cfg, mesh): cfg.distribution
    itself, or, when it is the sentinel "auto", the cheapest registered
    strategy under the analytic per-tier wire-cost model
    (`api.autotune.choose_strategy`) on this mesh's geometry."""
    if cfg.distribution != "auto":
        return cfg.distribution
    # late import: repro_torch.api imports this module
    from repro_torch.api import autotune

    p = num_shards(mesh)
    ctx = make_strategy_context(
        cfg, mesh, cap=capacity(cfg, _AUTOTUNE_BATCH_LOCAL, p))
    return autotune.choose_strategy(ctx)


def strategy_carry_len(cfg: DPMRConfig, mesh=None) -> int:
    """Per-rank length L of the resolved strategy's persistent carry (1
    when the strategy is stateless: the placeholder keeps the state's
    layout the same for every strategy)."""
    from repro_torch.api.strategies import get_strategy

    carry = get_strategy(resolve_distribution(cfg, mesh)).init_carry(
        make_strategy_context(cfg, mesh), device="meta")
    return 1 if carry is None else int(carry.shape[0])


def init_state(cfg: DPMRConfig, device, hot_ids=None,
               mesh=None) -> DPMRState:
    """Zeros: this rank's (F/P,) blocks and (L,) carry, and the whole
    replicated hot set."""
    device = torch.device(device)
    p = num_shards(mesh)
    f = padded_features(cfg, p) // p

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    if hot_ids is None:
        hot_ids = torch.full((cfg.max_hot,), hot_sharding.INT_MAX,
                             dtype=torch.int32, device=device)
    hot_ids = torch.as_tensor(hot_ids).to(device=device, dtype=torch.int32)
    return DPMRState(zeros(f), zeros(cfg.max_hot), hot_ids, zeros(f),
                     zeros(cfg.max_hot),
                     torch.zeros((), dtype=torch.int32, device=device),
                     zeros(strategy_carry_len(cfg, mesh)))


@obs.spanned("optimizer.update")
def optimize(cfg: DPMRConfig, theta, acc, grad, lr):
    """Algorithm 7 step 12: newPara = optimize(para, grad), in place.

    `grad` is a dense tensor like `theta`, or a `RowGrad` (train_step's
    row path), which goes to the optimizer's row update."""
    if isinstance(grad, ops.RowGrad):
        obs.count("optimizer.row_updates")
        if obs.tracing():
            written = grad.written(theta.shape[0])
            obs.count_device("optimizer.rows_passed", written)
            obs.count_device("optimizer.rows_given_grad", written)
        return optimizers.row_update(cfg)(theta, acc, grad, lr, cfg)
    obs.count("optimizer.dense_updates")
    obs.count("optimizer.rows_passed", theta.numel())
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


def _device_grads(cfg, strategy, ctx, cold_loc, grads_slot, fwd, aux,
                  carry, stateful, accumulating=False, rows=False):
    """Reduce stages: per-feature sums delivered to the owner, the
    hot-set gradient summed over ranks (`strategies._psum`), and the
    strategy's new carry. With `rows` (a stateless strategy with
    `reduce_rows`) the owner's sums come as a `RowGrad`.

    `carry` is this rank's slice of `DPMRState.strat`; a stateful strategy
    gets it as `fwd["carry"]` and returns `(grad_cold, new_carry)`.
    `accumulating=True` marks the full-batch `grad_step` path, whose
    caller discards the new carry; it reaches the strategy as
    `fwd["accumulate"]`, so a lossy strategy takes its exact reduce there
    and leaves the carry alone."""
    from repro_torch.api.strategies import _psum

    gflat = grads_slot.reshape(-1)
    if rows:
        grad_cold = strategy.reduce_rows(ctx, cold_loc, gflat, fwd)
        carry_new = carry
    elif stateful:
        grad_cold, carry_new = strategy.reduce(
            ctx, cold_loc, gflat,
            {**fwd, "carry": carry, "accumulate": accumulating})
    else:
        grad_cold = strategy.reduce(ctx, cold_loc, gflat, fwd)
        carry_new = carry
    grad_hot = _psum(hot_grads(cfg, gflat, aux["hot_slot"], aux["is_hot"]),
                     ctx)
    return grad_cold, grad_hot, carry_new


def hot_grads(cfg, gflat, hot_slot, is_hot):
    """(max_hot,) hot-set gradient of this rank's slots: the hot slots'
    sum per hot slot.

    The Zipf head collides heavily here, so the sum is not a scatter-add
    (on the card `index_add_` adds in atomic order, and the result changes
    in its last bits from run to run) but `kernels.ops.sorted_run_totals`
    over the hot slots, the cold ones as padding, and one write of each
    run total. Every other slot writes into one extra entry that is cut
    off.
    """
    slot_s, totals, end = ops.sorted_run_totals(
        torch.where(is_hot, hot_slot, -1), gflat)
    obs.count_device("optimizer.rows_given_grad", end)
    ghot = torch.zeros((cfg.max_hot + 1,), dtype=torch.float32,
                       device=gflat.device)
    ghot[torch.where(end, slot_s, cfg.max_hot).to(torch.int64)] = totals
    return ghot[:cfg.max_hot]


def row_probs(vals: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """σ(Σ_k vals·θ) of each row of (B, K) f32 tensors: the predict step's
    arithmetic, in bits that depend neither on the device nor on B.

    The row sum is a fixed halving tree of elementwise f32 adds (K padded
    with zeros to a power of two, then `x[:, :h] + x[:, h:]` until one
    column is left), each add correctly rounded on the card and on the
    CPU alike, where a reduction kernel picks its order by device and
    shape. The sigmoid runs in f64 and is rounded to f32 once. In f32,
    `exp` differs between the card and the CPU, and on the CPU between
    its vector and scalar loops, in the last bit of many rows; in f64 the
    two differ by an ulp or two, which reaches the f32 result only when
    the exact value lies within a few f64 ulps of an f32 rounding
    boundary (a chance of about 1e-8 a row). So the serve cache computes
    a hit on the host with the card's bits (`serve.hot_cache`)."""
    x = vals * theta
    k = x.shape[-1]
    width = 1 << (k - 1).bit_length()
    if width != k:
        x = torch.nn.functional.pad(x, (0, width - k))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return torch.sigmoid(x[..., 0].to(torch.float64)).to(torch.float32)


def _metrics(ctx, probs, labels, nll, overflow) -> dict:
    """Loss and accuracy as the mean over ranks of the ranks' means (the
    reference's pmean), overflow as their sum (its psum): one sum in rank
    order of the three, in f64, which holds each count exactly. Without a
    process group they are this rank's own."""
    y = labels.to(torch.float32)
    pred = (probs >= 0.5).to(torch.float32)
    loss = torch.mean(nll)
    acc = torch.mean((pred == y).to(torch.float32))
    if ctx.groups is None:
        return {"loss": loss, "accuracy": acc, "overflow": overflow}
    from repro_torch.api.strategies import _psum

    tot = _psum(torch.stack([loss, acc, overflow.to(loss.dtype)]).to(
        torch.float64), ctx)
    n = tot.new_full((), float(ctx.num_shards))
    return {"loss": (tot[0] / n).to(torch.float32),
            "accuracy": (tot[1] / n).to(torch.float32),
            "overflow": tot[2].to(torch.int32)}


# ---------------------------------------------------------------------------
# public step builders
# ---------------------------------------------------------------------------


class StepFns(NamedTuple):
    """The DPMR step functions of one batch size, plus their geometry.

    `train_step` and `apply_update` update the state passed to them IN
    PLACE and return it (`train_step` writes a stateful strategy's new
    carry into `state.strat`); `grad_step` and `predict` leave it
    untouched.
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
    strategy: str = "a2a"    # RESOLVED distribution-strategy name (a
    #                          registry entry, never "auto")
    ctx: object = None       # StrategyContext of these steps


def make_step_fns(cfg: DPMRConfig, batch_size: int, *, mesh=None,
                  cap_factor: float = 4.0) -> StepFns:
    """Step functions of this rank of `mesh` (None: one rank, no process
    group) for a GLOBAL batch of `batch_size` samples.

    Each rank's steps take its own B/P rows of the global batch (see
    `api.engine.put_batch`): dicts of tensors on the state's device, ids
    (B/P, K) int32, vals (B/P, K) f32, labels (B/P,) int32. They run where
    their tensors lie: on the card the map body and the owner reduce
    launch the CUDA kernels (`kernels.ops`), on the CPU they take the
    plain versions. `predict` returns this rank's rows' probabilities."""
    # late import: repro_torch.api.strategies imports from this package
    from repro_torch.api.strategies import get_strategy, has_row_reduce

    p = num_shards(mesh)
    f = padded_features(cfg, p)
    if batch_size % p:
        raise ValueError(f"batch {batch_size} is not a multiple of P={p}")
    cap = capacity(cfg, batch_size // p, p, cap_factor)
    dist_name = resolve_distribution(cfg, mesh)
    strategy = get_strategy(dist_name)
    ctx = make_strategy_context(cfg, mesh, cap)
    stateful = strategy.init_carry(ctx, device="meta") is not None
    # train_step's row path: what the strategy and the optimizer can do
    rows = has_row_reduce(strategy) and not stateful \
        and optimizers.row_update(cfg) is not None
    sched = make_schedule(cfg)

    def _fwd_grads(state, batch, accumulating=False, rows=False):
        ids, vals, labels = batch["ids"], batch["vals"], batch["labels"]
        theta, fwd, aux = _device_fwd(cfg, strategy, ctx, state.cold,
                                      state.hot, state.hot_ids, ids, vals)
        grads_slot, probs, nll = ops.sigmoid_grad(vals, theta, labels)
        if cfg.grad_scale == "mean":
            # a tensor divisor: on CUDA a Python scalar divides as a
            # product with its reciprocal, not as the reference's division
            grads_slot = grads_slot / grads_slot.new_full(
                (), float(batch_size))
        grad_cold, grad_hot, carry = _device_grads(
            cfg, strategy, ctx, state.cold, grads_slot, fwd, aux,
            state.strat, stateful, accumulating, rows)
        return grad_cold, grad_hot, carry, _metrics(
            ctx, probs, labels, nll, aux["overflow"])

    @torch.no_grad()
    @obs.spanned("dpmr.step")
    def train_step(state: DPMRState, batch):
        grad_cold, grad_hot, carry, m = _fwd_grads(state, batch, rows=rows)
        if carry is not state.strat:    # a strategy may update it in place
            state.strat.copy_(carry)
        lr = sched(state.step)
        optimize(cfg, state.cold, state.cold_acc, grad_cold, lr)
        optimize(cfg, state.hot, state.hot_acc, grad_hot, lr)
        state.step.add_(1)
        return state, m

    @torch.no_grad()
    @obs.spanned("dpmr.step")
    def grad_step(state: DPMRState, batch):
        # the carry is read-only here: fit() adds many grad_steps into one
        # update, so error feedback advances through train_step only
        grad_cold, grad_hot, _, m = _fwd_grads(state, batch,
                                               accumulating=True)
        return grad_cold, grad_hot, m

    @torch.no_grad()
    @obs.spanned("dpmr.step")
    def apply_update(state: DPMRState, grad_cold, grad_hot, lr: float):
        optimize(cfg, state.cold, state.cold_acc, grad_cold, lr)
        optimize(cfg, state.hot, state.hot_acc, grad_hot, lr)
        state.step.add_(1)
        return state

    @torch.no_grad()
    def predict(state: DPMRState, batch):
        theta, _, _ = _device_fwd(cfg, strategy, ctx, state.cold, state.hot,
                                  state.hot_ids, batch["ids"], batch["vals"])
        return row_probs(batch["vals"], theta)

    return StepFns(train_step=train_step, grad_step=grad_step,
                   apply_update=apply_update, predict=predict,
                   capacity=cap, block_size=f // p, num_shards=p,
                   strategy=dist_name, ctx=ctx)
