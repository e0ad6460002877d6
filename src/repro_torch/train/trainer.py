"""Train-step builder of the dense trainer, one card: loss, gradient
accumulation over microbatches, clipping, the optimizer (counterpart of
`repro.train.trainer`).

The train state is a dict `{"params": model, "opt": optimizer state,
"step": 0-d int32}`: `params` is the model (`spec.model(cfg, device,
train=True)`, f32 masters that require grad), `opt` the optimizer's
moments under the parameters' names (`optim.optimizers`). A step
updates it IN PLACE and returns it with the metrics `loss`,
`grad_norm`, `lr`, `nll` and `aux`, 0-d f32 tensors on the device: the
step never waits for the device.

The reference's shardings (`state_defs`, `shardings_for_state`) and its
cross-pod compressed gradients (`compress_pod_grads`) belong to a mesh
of cards, ROADMAP A12 (Distribution); `check_parallel` refuses them.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.models import common
from repro_torch.optim import optimizers, schedules

AUX_COEF = 0.01      # MoE load-balance loss weight


def check_parallel(parallel: ParallelConfig, mesh=None) -> None:
    """Raise for what needs more than one card."""
    wants = []
    if parallel.attn_mode == "cp":
        wants.append("attn_mode='cp'")
    if parallel.compress_pod_grads:
        wants.append("compress_pod_grads=True")
    if parallel.sparse_embed:
        wants.append("sparse_embed=True")
    if mesh is not None and int(mesh.size()) > 1:
        wants.append(f"a mesh of {int(mesh.size())} ranks")
    if wants:
        raise NotImplementedError(
            f"the dense trainer runs on one card; {', '.join(wants)} "
            "needs the Distribution slice: ROADMAP A12 (Distribution)")


def init_state(spec, cfg: ModelConfig, train_cfg: TrainConfig,
               parallel: ParallelConfig, generator: torch.Generator,
               device=None) -> dict:
    """A fresh train state on `device` (default: the card), the weights
    drawn from `generator` (`common.init_params`), the moments zero."""
    check_parallel(parallel)
    model = common.init_params(spec.model(cfg, device=device, train=True),
                               generator)
    opt = optimizers.get_optimizer(train_cfg.optimizer)
    params = dict(model.named_parameters())
    return {"params": model, "opt": opt.init(params, cfg.opt_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def make_loss_fn(spec, cfg: ModelConfig, parallel: ParallelConfig):
    def loss_fn(model, batch):
        logits, aux = spec.forward(model, batch, cfg, parallel)
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


def make_train_step(spec, cfg: ModelConfig, train_cfg: TrainConfig,
                    parallel: ParallelConfig, mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); `batch` holds
    `tokens` and `labels` (B, S) int tensors on the state's device."""
    check_parallel(parallel, mesh)
    loss_fn = make_loss_fn(spec, cfg, parallel)
    opt = optimizers.get_optimizer(train_cfg.optimizer)
    sched = schedules.get_schedule(train_cfg)
    k = max(parallel.microbatches, 1)
    adt = getattr(torch, parallel.accum_dtype)

    def grads_of(model, names, params, batch):
        if k == 1:
            loss, m = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, params)
            return dict(zip(names, grads, strict=True)), loss.detach(), {
                key: x.detach() for key, x in m.items()}
        g_acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
                 for p in params]
        l_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        a_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in _split_micro(batch, k):
            loss, m = loss_fn(model, mb)
            for a, g in zip(g_acc, torch.autograd.grad(loss, params),
                            strict=True):
                a.add_(g.to(adt))
            l_acc += loss.detach()
            a_acc += m["aux"].detach()
        grads = {name: a.div_(k) for name, a in zip(names, g_acc,
                                                     strict=True)}
        loss = l_acc / k
        return grads, loss, {"nll": loss, "aux": a_acc / k}

    def train_step(state, batch):
        model = state["params"]
        names, params = zip(*model.named_parameters(), strict=True)
        grads, loss, m = grads_of(model, names, params, batch)
        grads, gnorm = optimizers.clip_by_global_norm(grads,
                                                      train_cfg.grad_clip)
        lr = sched(state["step"])
        opt.update(grads, state["opt"], dict(zip(names, params,
                                                 strict=True)),
                   lr, train_cfg)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **m}

    return train_step
