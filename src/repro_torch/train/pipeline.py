"""GPipe-style pipeline parallelism over a `pipe` dim of ranks: the
counterpart of `repro.train.pipeline`.

Layers are split into S stages; stage s's parameters live on the ranks
of pipe index s. Microbatches stream through the fill/drain schedule:
T = M + S - 1 ticks, and at tick t stage s computes microbatch t - s
(idle where that is not a microbatch). Stage boundaries are point-to-
point transfers, each an autograd function whose backward sends the
gradient back to the previous stage, so differentiating the outputs
gives GPipe's drain-then-fill backward. The last stage's outputs reach
every rank as the reference's psum of masked outputs does: a sum over
the pipe group of the outputs, zero on every stage but the last (its
backward hands each rank its own gradient: every rank holds the same
replicated result and differentiates its copy).

As in the reference, the trainer does not call it (the dense trainer is
FSDP and tensor parallel): it is the optional pipe dim for models that
are deep before they are wide. Bubble fraction = (S - 1) / (M + S - 1);
take M >= 4 S to keep it under 20%.
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import fsdp


def make_pp_mesh(pipe: int, data: int = 1) -> DeviceMesh:
    """A mesh of `pipe` stages (x `data` ranks each) over the default
    process group, which must hold exactly that many ranks."""
    if pipe * data != dist.get_world_size():
        raise ValueError(f"a ({pipe}, {data}) pipe mesh needs {pipe * data} "
                         f"ranks, the group has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if data == 1:
        return init_device_mesh(device_type, (pipe,), mesh_dim_names=("pipe",))
    return init_device_mesh(device_type, (pipe, data),
                            mesh_dim_names=("pipe", "data"))


class _Send(torch.autograd.Function):
    """Send y to `dst`; the backward receives its gradient from `dst`.
    Returns a 0-d zero that ties the send into the graph."""

    @staticmethod
    def forward(ctx, y, dst):
        ctx.dst, ctx.meta = dst, (y.shape, y.dtype, y.device)
        dist.send(y.contiguous(), dst)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.dst)
        return g, None


class _StageIn(torch.autograd.Function):
    """A stage's input x (received from `src`) and its parameters, passed
    through; the backward sends x's gradient back to `src`. Tying the
    parameters in puts the send on every path from the output to them,
    so differentiating with respect to a stage's parameters runs it."""

    @staticmethod
    def forward(ctx, x, src, *params):
        ctx.src = src
        return (x.clone(), *(p.view_as(p) for p in params))

    @staticmethod
    def backward(ctx, gx, *gparams):
        dist.send(gx.contiguous(), ctx.src)
        return (None, None, *gparams)


def pipeline_apply(stage_params, micro_in: torch.Tensor,
                   stage_fn: Callable, mesh: DeviceMesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run the microbatches through the pipeline.

    stage_params: this rank's stage's parameters (what `stage_fn` takes).
    micro_in:     (M, B_mu, ...) microbatch inputs, the same on every rank.
    stage_fn:     (params, x) -> y, y shaped as x (a stage of layers).

    Returns the (M, B_mu, ...) outputs of the last stage on every rank.
    Its backward runs the boundary transfers when every rank
    differentiates with respect to its stage's parameters (tensors of
    `stage_params` that require grad)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    stage = dist.get_rank(group)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < n - 1 else None
    m = micro_in.shape[0]
    leaves, spec = tree_flatten(stage_params)
    tied = [i for i, p in enumerate(leaves)
            if torch.is_tensor(p) and p.requires_grad]
    outs, ties = [], []
    for t in range(m + n - 1):
        mb = t - stage
        if not 0 <= mb < m:
            continue
        params = stage_params
        if prev is None:
            x = micro_in[mb]
        else:
            x = torch.empty_like(micro_in[mb])
            dist.recv(x, prev)
            x, *ps = _StageIn.apply(x, prev, *(leaves[i] for i in tied))
            args = list(leaves)
            for i, p in zip(tied, ps, strict=True):
                args[i] = p
            params = tree_unflatten(args, spec)
        y = stage_fn(params, x)
        if nxt is None:
            outs.append(y)
        else:
            ties.append(_Send.apply(y, nxt))
    out = torch.stack(outs) if nxt is None else torch.zeros_like(micro_in)
    out = fsdp.all_reduce_sum(out, group)
    if ties:
        out = out + torch.stack(ties).sum() * 0
    return out


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
