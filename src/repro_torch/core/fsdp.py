"""DPMR dense face: fully-sharded parameters as the degenerate map-reduce
(the counterpart of `repro.core.fsdp`).

When every sample touches every parameter (a dense layer), the paper's
inverted index is trivial, every feature's sample list is "all docs",
and the DPMR stages collapse to:

    distributeParameters  ->  all_gather(param shard)   [per layer, at use]
    restoreDocuments      ->  identity (already aligned)
    computeGradients      ->  local matmul fwd/bwd
    reduce shuffle        ->  reduce_scatter(grad)
    updateParameters      ->  sharded optimizer step

i.e. DPMR-on-dense IS ZeRO-3/FSDP. The reference gets it from GSPMD; the
port places the stages by hand: `gather` is an all-gather whose backward
reduce-scatters the gradient (the feature reduce), `scatter_sum` its
transpose, `all_reduce_sum` a sum whose backward passes the gradient
through (every rank holds the same replicated result and differentiates
its own copy), `sum_shared` a sum that each rank then uses on its own
part (its backward sums the gradients too), `exchange` an all-to-all of
equal blocks (the MoE dispatch; its own transpose). Each takes a process
group (a `DeviceMesh` dim's: NCCL on the cards, gloo on the CPU) and a
tensor dim; a group of one rank still calls the collective (a copy).
`dpmr_dense_linear` is the explicit FSDP linear of the reference, its
backward re-gathering W (no full W kept).

`ParamLayout` is the trainer's storage layout: every parameter of a
model stored as this rank's block per `sharding.logical_to_spec`, with
the gathers of a block back to the whole leaf (`use` at a layer's use,
`full` for checkpoints) and the slice of a whole leaf into the block.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import sharding as shd


def _world(group) -> int:
    return dist.get_world_size(group)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in group-rank order,
    contiguous (a product then sees the operand layout it sees without a
    mesh). The blocks arrive stacked along dim 0 and are laid side by
    side along `dim` by one concatenation (none along dim 0 or at one
    rank), never by a transposing copy."""
    n = _world(group)
    xc = x.contiguous()
    out = xc.new_empty((n * xc.shape[0], *xc.shape[1:]))
    dist.all_gather_into_tensor(out, xc, group=group)
    if n == 1 or dim % x.dim() == 0:
        return out
    return torch.cat(out.chunk(n), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group's ranks of `x`, this rank's block along
    `dim` (the blocks stacked along dim 0 for the collective by one
    concatenation where `dim` is another and the group has more than one
    rank)."""
    n = _world(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    if n == 1 or dim % x.dim() == 0:
        xt = x.contiguous()
    else:
        xt = torch.cat(x.chunk(n, dim), dim=0)
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def gather(x, group, dim: int):
    """distributeParameters: all-gather along `dim`; the backward
    reduce-scatters the gradient to the owners (sums over the ranks)."""
    return _Gather.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of x's dim 0 (equal blocks, one a rank) to rank i; the
    result holds the blocks received, in source-rank order (no
    gradient)."""
    xt = x.contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    return out


def exchange(x, group):
    """`all_to_all`, differentiable: with equal blocks the exchange is its
    own transpose, so the backward exchanges the gradient back."""
    return _AllToAll.apply(x, group)


def sum_shared(x, group):
    """Sum over the ranks into a replicated result that each rank then
    uses on its own part (its channels, its heads): the backward sums the
    ranks' gradients too (the transpose of a sum whose uses differ)."""
    return _SumShared.apply(x, group)


def scale_grad(x, factor: float):
    """x unchanged; its gradient times `factor`."""
    return _ScaleGrad.apply(x, factor)


def scatter_sum(x, group, dim: int):
    """Sum over the ranks, each keeping its block along `dim`; the
    backward all-gathers the gradient."""
    return _ScatterSum.apply(x, group, dim)


def all_reduce_sum(x, group):
    """Sum over the ranks into a replicated result; the backward passes
    each rank's gradient of its own copy through."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the ranks (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# ---------------------------------------------------------------------------
# the explicit FSDP linear
# ---------------------------------------------------------------------------


def dpmr_dense_linear_ref(w_shard, x, group):
    """Explicit DPMR stages for y = x @ W with W row-sharded over `group`:
    w_shard (D/P, F), x (B_loc, D) -> y (B_loc, F) f32."""
    w_full = all_gather_dim(w_shard, group, 0)          # (D, F)
    return torch.matmul(x.to(torch.float32), w_full.to(torch.float32))


def dpmr_dense_grad_ref(w_shard, x, gy, group):
    """Backward: gw = x^T gy, reduced back to the owner rows (the
    reduce-by-feature stage)."""
    gw_full = torch.matmul(x.to(torch.float32).T, gy.to(torch.float32))
    return reduce_scatter_dim(gw_full, group, 0)


class DPMRDenseLinear(torch.autograd.Function):
    """The differentiable explicit-FSDP linear: the backward gathers W
    again (remat-style), so no full W outlives the forward."""

    @staticmethod
    def forward(ctx, w_shard, x, group):
        ctx.group = group
        ctx.save_for_backward(w_shard, x)
        return dpmr_dense_linear_ref(w_shard, x, group)

    @staticmethod
    def backward(ctx, gy):
        w_shard, x = ctx.saved_tensors
        gw = dpmr_dense_grad_ref(w_shard, x, gy, ctx.group)
        w_full = all_gather_dim(w_shard, ctx.group, 0)
        gx = torch.matmul(gy.to(torch.float32), w_full.to(torch.float32).T)
        return gw.to(w_shard.dtype), gx.to(x.dtype), None


def dpmr_dense_linear(w_shard, x, group):
    """y = x @ W (f32) with W's rows sharded over `group`; every rank
    passes its rows of the batch."""
    return DPMRDenseLinear.apply(w_shard, x, group)


def fsdp_specs(defs: dict, mesh) -> tuple[dict, dict]:
    """(specs, per-rank block shapes) of a tree of `sharding.LeafDef`s:
    the dense face's storage layout, from the logical-axis rules."""
    return shd.tree_specs(defs, mesh), shd.tree_shard_shapes(defs, mesh)


# ---------------------------------------------------------------------------
# the trainer's storage layout
# ---------------------------------------------------------------------------


class ParamLayout:
    """Every parameter of a model of `cfg` laid out over `mesh` (a
    `DeviceMesh` of dims `pod`, `data`, `model`) by the logical-axis
    rules: `defs` {name: LeafDef}, `specs` {name: spec}, and this rank's
    coordinate on each mesh dim."""

    def __init__(self, spec, cfg, mesh, rules=None):
        self.cfg, self.mesh = cfg, mesh
        self.defs = shd.param_defs(spec, cfg)
        self.specs = {name: d.spec(mesh, rules)
                      for name, d in self.defs.items()}
        for name, sp in self.specs.items():
            if any(isinstance(s, tuple) for s in sp):
                raise ValueError(f"{name}: spec {sp} shards a dim over "
                                 "several mesh dims; the layout takes one")
        self.shape = shd.mesh_shape(mesh)
        self.coord = {a: int(mesh.get_local_rank(a)) for a in self.shape}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def sharded_over(self, name: str, axis: str) -> int | None:
        """The dim of `name` sharded over `axis`, or None."""
        for dim, s in enumerate(self.specs[name]):
            if s == axis:
                return dim
        return None

    def owner(self, name: str) -> bool:
        """True on the one rank of each set of ranks that hold the same
        block of `name` (coordinate 0 on every mesh dim it is not sharded
        over): that rank counts the block in a global sum."""
        used = set(self.specs[name])
        return all(c == 0 for a, c in self.coord.items() if a not in used)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf `full` (a view)."""
        out = full
        for dim, s in enumerate(self.specs[name]):
            if s is not None:
                n = full.shape[dim] // self.size(s)
                out = out.narrow(dim, self.coord[s] * n, n)
        return out

    def use(self, name: str, block: torch.Tensor,
            axes: tuple = ("data",)) -> torch.Tensor:
        """The leaf gathered over the mesh dims `axes` that shard it
        (differentiable: the backward reduce-scatters over them)."""
        out = block
        for dim, s in enumerate(self.specs[name]):
            if s is not None and s in axes:
                out = gather(out, self.group(s), dim)
        return out

    @torch.no_grad()
    def full(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block (a collective)."""
        return self.gather_spec(block, self.specs[name])

    @torch.no_grad()
    def gather_spec(self, block: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole array from every rank's block of it laid out by
        `spec` over this mesh (a collective)."""
        out = block.detach()
        for dim, s in enumerate(spec):
            if s is not None:
                out = all_gather_dim(out, self.group(s), dim)
        return out
