"""The dense trainer's train step: loss, gradient accumulation over
microbatches, clipping, the optimizer, on one card or over a mesh of
ranks (counterpart of `repro.train.trainer`).

The train state is a dict `{"params": model, "opt": optimizer state,
"step": 0-d int32}`: `params` is the model (`spec.model(cfg, device,
train=True)`, f32 masters that require grad), `opt` the optimizer's
moments under the parameters' names (`optim.optimizers`). A step
updates it IN PLACE and returns it with the metrics `loss`,
`grad_norm`, `lr`, `nll` and `aux`, 0-d f32 tensors on the device: the
step never waits for the device.

Over a mesh (`launch.mesh.make_host_mesh`: `pod`, `data`, `model`) the
state is this rank's blocks: every parameter is stored as
`sharding.logical_to_spec` lays it out (`state_defs`,
`shardings_for_state`; `core.fsdp.ParamLayout`), the moments on the same
blocks, and the model carries its layout (`model.layout`). A step takes
the GLOBAL batch and trains this rank's rows of it over the DP dims
(`pod`, `data`; each microbatch's rows as the reference shards them).
The paper's stages are placed by hand: a data-sharded leaf is gathered
over `data` at its use in the layer (`models.parallel.ShardedView`,
inside the remat region, so recomputed rather than stored) and its
gradient reduce-scattered back in the backward; leaves that `data` does
not shard are all-reduced over it, and leaves that `model` does not
shard over it (with `model` > 1 each rank's copy sees its own heads or
positions, or, where the heads or ff do not divide `model`, its own
positions of a block run whole); the sum is divided by the `data` size. Across pods the
gradients are all-reduced and averaged, or with `compress_pod_grads`
reduced by `optim.compression.compress_tree_psum` with the error
feedback `err` kept on each rank's blocks. Clipping sums every block's
squares once (a replicated block counts on one rank). With `model` > 1
every family runs its forward over `model` (`spec.tp_forward`: the
dense and MoE families' `models.parallel.tp_forward`, tensor- or with
`attn_mode="cp"` context-parallel attention, the MoE FFN expert- or
ff-parallel; zamba2's, xlstm's and whisper's in their modules), the
loss vocab-parallel. The MoE routing counts its groups over the whole
microbatch wherever its tokens lie (`moe.Exchange`: a group may span DP
ranks and the S-shards of `model` ranks), and the aux is the
reference's, averaged over every group. `sparse_embed` is read by
neither package's trainer. On one card, clipping runs inside the `obs`
span `train.clip` and the optimizer inside `train.optimizer`.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import obs, sharding as shd
from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.convert import _pairs
from repro_torch.core.fsdp import ParamLayout
from repro_torch.device import resolve_device
from repro_torch.models import common, parallel as par
from repro_torch.optim import compression, optimizers, schedules

AUX_COEF = 0.01      # MoE load-balance loss weight


# ---------------------------------------------------------------------------
# the state's layout
# ---------------------------------------------------------------------------


class Sharding(NamedTuple):
    """A leaf's spec over a mesh and this rank's block shape."""

    spec: tuple
    shard_shape: tuple


def _opt_defs(name: str, pd: dict, opt_dtype: str) -> dict:
    moments = {"sgd": (), "momentum": ("mu",), "adam": ("m", "v"),
               "adamw": ("m", "v")}[name]
    out = {key: {n: shd.LeafDef(d.shape, opt_dtype, d.logical)
                 for n, d in pd.items()} for key in moments}
    if name in ("adam", "adamw"):
        out["count"] = shd.LeafDef((), "int32", ())
    return out


def state_defs(spec, cfg: ModelConfig, train_cfg: TrainConfig,
               parallel: ParallelConfig) -> dict:
    """`sharding.LeafDef`s of the whole train state (params, optimizer,
    step, and `err` with `compress_pod_grads`), the params by their
    `named_parameters` names."""
    pd = shd.param_defs(spec, cfg)
    defs = {"params": pd,
            "opt": _opt_defs(train_cfg.optimizer, pd, cfg.opt_dtype),
            "step": shd.LeafDef((), "int32", ())}
    if parallel.compress_pod_grads:
        defs["err"] = {n: shd.LeafDef(d.shape, "float32", d.logical)
                       for n, d in pd.items()}
    return defs


def shardings_for_state(defs, mesh, rules=None):
    """The tree of `Sharding`s (spec, this rank's block shape) of a tree
    of LeafDefs over `mesh`."""
    if isinstance(defs, shd.LeafDef):
        sp = defs.spec(mesh, rules)
        return Sharding(sp, shd.shard_shape(defs.shape, sp, mesh))
    return {k: shardings_for_state(v, mesh, rules) for k, v in defs.items()}


def batch_shardings(batch_defs, mesh, rules=None):
    """The same for a batch's LeafDefs (logical `batch` first)."""
    return shardings_for_state(batch_defs, mesh, rules)


# ---------------------------------------------------------------------------
# the state
# ---------------------------------------------------------------------------


def draw_leaf(p_shape, generator: torch.Generator) -> torch.Tensor:
    """`common.init_params`' draw for a leaf of `p_shape`."""
    if len(p_shape) == 1:
        return torch.ones(p_shape, dtype=torch.float32,
                          device=generator.device)
    return torch.randn(p_shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(common.INIT_STD)


@torch.no_grad()
def sharded_model(spec, cfg: ModelConfig, mesh, device, fill: Callable,
                  layout: ParamLayout | None = None,
                  train: bool = True) -> nn.Module:
    """`cfg`'s training model (with `train=False` its serving model: the
    serving dtypes, no grad) whose parameters are this rank's blocks on
    `device`, each cut from `fill(name, full_shape)` (a whole leaf, made
    one leaf at a time); the model carries its layout."""
    layout = layout or ParamLayout(spec, cfg, mesh)
    device = resolve_device(device)
    model = spec.model(cfg, device="meta", train=train)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        block = layout.shard(name, fill(name, tuple(p.shape)))
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            block.to(device=device, dtype=p.dtype, copy=True),
            requires_grad=train)
    model.layout = layout
    return model


def init_state(spec, cfg: ModelConfig, train_cfg: TrainConfig,
               parallel: ParallelConfig, generator: torch.Generator,
               device=None, mesh=None) -> dict:
    """A fresh train state on `device` (default: the card), the weights
    drawn from `generator` (`common.init_params`), the moments zero.
    With a `mesh`, this rank's blocks of the same weights: every rank
    draws each whole leaf in turn and keeps its block."""
    if mesh is None:
        model = common.init_params(spec.model(cfg, device=device,
                                              train=True), generator)
    else:
        model = sharded_model(spec, cfg, mesh, device,
                              lambda name, shape: draw_leaf(shape, generator))
    return _with_moments(model, cfg, train_cfg, parallel, mesh)


def init_from_params(spec, cfg: ModelConfig, train_cfg: TrainConfig,
                     parallel: ParallelConfig, params: dict, device=None,
                     mesh=None) -> dict:
    """A fresh train state (moments zero) of the given WHOLE parameters
    {name: tensor} (`convert.params_from_numpy(...).named_parameters()`
    carries the reference's), or with a `mesh` this rank's blocks of
    them."""
    if mesh is None:
        model = spec.model(cfg, device=device, train=True)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
    else:
        model = sharded_model(spec, cfg, mesh, device,
                              lambda name, shape: params[name])
    return _with_moments(model, cfg, train_cfg, parallel, mesh)


def _with_moments(model, cfg, train_cfg, parallel, mesh) -> dict:
    opt = optimizers.get_optimizer(train_cfg.optimizer)
    params = dict(model.named_parameters())
    state = {"params": model, "opt": opt.init(params, cfg.opt_dtype),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if mesh is not None and parallel.compress_pod_grads:
        state["err"] = compression.init_error_state(params)
    return state


def full_params(model) -> dict:
    """{name: the whole leaf} of a model (a collective over a mesh: every
    rank must call it; without a layout, the parameters themselves)."""
    layout = getattr(model, "layout", None)
    if layout is None:
        return dict(model.named_parameters())
    return {n: layout.full(n, p) for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def make_loss_fn(spec, cfg: ModelConfig, parallel: ParallelConfig):
    def loss_fn(model, batch, **kwargs):
        logits, aux = spec.forward(model, batch, cfg, parallel, **kwargs)
        nll = common.cross_entropy(logits, batch["labels"])
        loss = nll + AUX_COEF * aux
        return loss, {"nll": nll, "aux": aux}

    return loss_fn


def _split_micro(batch: dict, k: int) -> list[dict]:
    """k microbatches of equal rows, in order."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % k:
        raise ValueError(f"batch rows {sorted(rows)} do not split into "
                         f"{k} microbatches")
    n = next(iter(rows)) // k
    return [{key: v[i * n:(i + 1) * n] for key, v in batch.items()}
            for i in range(k)]


def _rank_micro(batch: dict, k: int, dp: int, dp_rank: int) -> list[dict]:
    """This DP rank's rows of each of the k microbatches of a global
    batch: microbatch i is rows [i B/k, (i+1) B/k), sharded over the `dp`
    ranks in order, as the reference lays out `_split_micro`'s
    (k, B/k, ...) under the batch's DP sharding."""
    micro = _split_micro(batch, k)
    rows = len(next(iter(micro[0].values())))
    if rows % dp:
        raise ValueError(f"a microbatch of {rows} rows does not split over "
                         f"{dp} DP ranks")
    n = rows // dp
    return [{key: v[dp_rank * n:(dp_rank + 1) * n] for key, v in mb.items()}
            for mb in micro]


def _accumulate(loss_fn, model, names, params, micro, adt):
    """(grads {name: this rank's}, loss, metrics) over the microbatches,
    the one-card trainer's arithmetic."""
    k = len(micro)
    if k == 1:
        loss, m = loss_fn(model, micro[0])
        grads = torch.autograd.grad(loss, params)
        return dict(zip(names, grads, strict=True)), loss.detach(), {
            key: x.detach() for key, x in m.items()}
    g_acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
             for p in params]
    l_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    a_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for mb in micro:
        loss, m = loss_fn(model, mb)
        for a, g in zip(g_acc, torch.autograd.grad(loss, params),
                        strict=True):
            a.add_(g.to(adt))
        l_acc += loss.detach()
        a_acc += m["aux"].detach()
    grads = {name: a.div_(k) for name, a in zip(names, g_acc, strict=True)}
    loss = l_acc / k
    return grads, loss, {"nll": loss, "aux": a_acc / k}


def make_train_step(spec, cfg: ModelConfig, train_cfg: TrainConfig,
                    parallel: ParallelConfig, mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); `batch` holds
    `tokens` and `labels` (B, S) int tensors (and an encoder-decoder's
    `frames`) on the state's device: the global batch."""
    if mesh is not None:
        return _make_mesh_step(spec, cfg, train_cfg, parallel, mesh)
    loss_fn = make_loss_fn(spec, cfg, parallel)
    opt = optimizers.get_optimizer(train_cfg.optimizer)
    sched = schedules.get_schedule(train_cfg)
    k = max(parallel.microbatches, 1)
    adt = getattr(torch, parallel.accum_dtype)

    def train_step(state, batch):
        model = state["params"]
        names, params = zip(*model.named_parameters(), strict=True)
        micro = [batch] if k == 1 else _split_micro(batch, k)
        grads, loss, m = _accumulate(loss_fn, model, names, params, micro,
                                     adt)
        with obs.span("train.clip"):
            grads, gnorm = optimizers.clip_by_global_norm(
                grads, train_cfg.grad_clip)
        lr = sched(state["step"])
        with obs.span("train.optimizer"):
            opt.update(grads, state["opt"], dict(zip(names, params,
                                                     strict=True)),
                       lr, train_cfg)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **m}

    return train_step


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _compress_leaf(layout, name, g, err):
    """`compress_psum` over the pods of this rank's block of `name`'s
    gradient with its error feedback. The reference quantizes the whole
    leaf in blocks of `compression.BLOCK` of its flattening, so a leaf
    sharded within the pod is gathered first, compressed whole (the
    reference's codes and scales) and cut back."""
    if all(s is None or layout.size(s) == 1 for s in layout.specs[name]):
        return compression.compress_psum(g, err, layout.group("pod"))
    g_hat, new_err = compression.compress_psum(
        layout.full(name, g), layout.full(name, err), layout.group("pod"))
    return (layout.shard(name, g_hat).contiguous(),
            layout.shard(name, new_err).contiguous())


def _stacked_leaves(model) -> list[list[str]]:
    """The names, in layer order, of each leaf that the reference stacks
    over layers and whose layer is not a whole number of compression
    blocks (a norm scale): there the reference's blocks run across
    layers."""
    stacks: dict = {}
    for name, path, layer in _pairs(model):
        if layer is not None:
            stacks.setdefault(path, []).append(name)
    return [names for names in stacks.values()
            if math.prod(model.layout.defs[names[0]].shape)
            % compression.BLOCK]


def _compress_grads(layout, grads: dict, err: dict, stacked) -> None:
    """Every gradient through `compress_psum` over the pods, IN PLACE of
    `grads` and `err`: the stacked leaves of `stacked` as the reference's
    one (L, ...) leaf, the rest leaf by leaf (`_compress_leaf`)."""
    joint = {n for names in stacked for n in names}
    for name in grads:
        if name not in joint:
            grads[name], err[name] = _compress_leaf(layout, name,
                                                    grads[name], err[name])
    for names in stacked:
        g = torch.stack([layout.full(n, grads[n]) for n in names])
        e = torch.stack([layout.full(n, err[n]) for n in names])
        g_hat, new_err = compression.compress_psum(g, e, layout.group("pod"))
        for i, n in enumerate(names):
            grads[n] = layout.shard(n, g_hat[i]).contiguous()
            err[n] = layout.shard(n, new_err[i]).contiguous()


def _make_mesh_step(spec, cfg, train_cfg, parallel, mesh) -> Callable:
    shape = shd.mesh_shape(mesh)
    pods, data = shape.get("pod", 1), shape.get("data", 1)
    tensor = shape.get("model", 1) > 1
    compress = parallel.compress_pod_grads and "pod" in shape
    opt = optimizers.get_optimizer(train_cfg.optimizer)
    sched = schedules.get_schedule(train_cfg)
    k = max(parallel.microbatches, 1)
    adt = getattr(torch, parallel.accum_dtype)
    family_loss = make_loss_fn(spec, cfg, parallel)

    def loss_fn(model, batch):
        view = par.ShardedView(model, model.layout)
        if not tensor:
            kw = {"exchange": par.moe_exchange(
                model.layout, False, batch["tokens"].shape[1])} \
                if cfg.num_experts else {}
            return family_loss(view, batch, **kw)
        tp = par.TP(model.layout)
        logits, aux = spec.tp_forward(view, batch, cfg, parallel, tp)
        nll = par.vocab_parallel_cross_entropy(logits, batch["labels"], tp)
        return nll + AUX_COEF * aux, {"nll": nll, "aux": aux}

    def dp_mean(x, layout):
        """The mean over the DP ranks of a metric (a new tensor)."""
        x = x.clone()
        for axis in ("data", "pod"):
            if axis in shape:
                _all_reduce(x, layout.group(axis))
        return x / (pods * data)

    def sync(grads, state, layout):
        """Sum every leaf's gradient over the ranks of its copies, the
        data mean, then the pods'."""
        for name, g in grads.items():
            if layout.sharded_over(name, "data") is None:
                _all_reduce(g, layout.group("data"))
            if tensor and layout.sharded_over(name, "model") is None:
                _all_reduce(g, layout.group("model"))
            g.div_(data)
        if "pod" not in shape:
            return grads
        if compress:
            _compress_grads(layout, grads, state["err"],
                            _stacked_leaves(state["params"]))
            return grads
        for g in grads.values():
            _all_reduce(g, layout.group("pod")).div_(pods)
        return grads

    def norm_fn(layout):
        def norm(grads):
            total = torch.zeros((), dtype=torch.float32,
                                device=next(iter(grads.values())).device)
            total = total + sum(torch.sum(torch.square(g.to(torch.float32)))
                                for name, g in grads.items()
                                if layout.owner(name))
            for axis in layout.shape:       # the sum over the mesh's ranks
                _all_reduce(total, layout.group(axis))
            return torch.sqrt(total)
        return norm

    def train_step(state, batch):
        model = state["params"]
        layout = model.layout
        names, params = zip(*model.named_parameters(), strict=True)
        dp_rank = layout.coord.get("pod", 0) * data + layout.coord["data"]
        micro = _rank_micro(batch, k, pods * data, dp_rank)
        grads, loss, m = _accumulate(loss_fn, model, names, params, micro,
                                     adt)
        grads = sync(grads, state, layout)
        loss = dp_mean(loss, layout)
        m = {key: dp_mean(x, layout) for key, x in m.items()}
        grads, gnorm = optimizers.clip_by_global_norm(
            grads, train_cfg.grad_clip, norm_fn(layout))
        lr = sched(state["step"])
        opt.update(grads, state["opt"], dict(zip(names, params,
                                                 strict=True)),
                   lr, train_cfg)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **m}

    return train_step
