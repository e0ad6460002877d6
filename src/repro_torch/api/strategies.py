"""Parameter-distribution strategies: the counterpart of
`repro.api.strategies`, over `torch.distributed`.

A `DistributionStrategy` implements the two collective-bearing stages of
the per-rank pipeline; `core.dpmr` asks the registry for the one
`DPMRConfig.distribution` names. Ported, with the reference's semantics
(P = ranks, Pi = ranks of a pod, Po = pods, cap = a2a capacity):

  a2a               the paper's shuffle both ways: route_build + request
                    all_to_all, reverse all_to_all of per-feature sums.
  allgather         ship the table: all_gather it, dense accumulate +
                    psum_scatter reduce.
  psum_scatter      sparse shuffle forward, dense psum_scatter reduce.
  compressed_reduce sparse forward; the dense reduce goes on the wire as
                    int8 blocks (`optim.compression`), the quantization
                    residual carried in `DPMRState.strat`.
  topk_reduce       sparse forward; the reverse shuffle sends only the k =
                    ceil(topk_frac * cap) largest-|g| slots per destination
                    as (value, id) pairs (`kernels.ops.select_pack`), the
                    losers banked in an error-feedback residual in
                    `DPMRState.strat`.
  overlap_a2a       a2a with every exchange split into `num_chunks`
                    asynchronous all_to_alls over capacity-slot ranges,
                    waited in order; bit-identical to a2a.
  hier_a2a          two tiers: a pod all_gather mirrors the inner peers'
                    blocks, the sparse exchange runs inside the pod only,
                    and one psum_scatter over the pods carries the per-pod
                    partials. Bit-identical to a2a with one pod.
  hier_a2a+topk     hier_a2a with the cross-pod reduce sparsified to the
                    top-k rows of each partial block (`TopKOuterLeg`).
  hier_a2a+int8     hier_a2a with the cross-pod partials as int8 blocks
                    (`Int8OuterLeg`).

`auto` (the reference's wire-cost autotuner, `api/autotune.py`) is not
ported: naming it raises.

The collectives `_all_to_all`, `_all_gather` and `_psum_scatter` run over
the context's process groups (`launch.mesh.Groups`): NCCL on CUDA
tensors, gloo on the CPU. With a group they always call the collective,
at world size 1 too. A context with no group is one rank: the seams are
the identity there, and raise for P > 1. Every sum across ranks (the
psum_scatter, the hot-set gradient, the metrics) gathers the ranks'
partials and adds them in rank order, so its bits do not depend on the
backend or on timing.

`bytes_per_device` is the reference's two-tier wire model: the bytes one
rank RECEIVES per step, split by tier into `WireBytes(inner, outer)`.

Third parties extend the seam with either

    @register_strategy("my_strategy")
    class MyStrategy(DistributionStrategy): ...

or `register_strategy("name", instance)`, and compose a hierarchical
strategy with an outer leg with `register_composition`.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import sparse
from repro_torch.kernels import ops
from repro_torch.optim import compression


class WireBytes(NamedTuple):
    """Per-rank per-step wire cost, split by mesh tier: `inner` within a
    pod, `outer` across pods."""

    inner: int
    outer: int

    @property
    def total(self) -> int:
        return self.inner + self.outer


class StrategyContext(NamedTuple):
    """Static per-step geometry handed to every strategy method.

    `rank` is this rank's linear index over the mesh, `outer_index *
    inner_shards + inner_index` (the outer tier leads). Analytic callers
    leave `groups` None and set only the counts; only the collectives
    need groups."""

    num_shards: int          # P = ranks taking part
    block_size: int          # rows of the feature table per rank
    capacity: int            # per-(src,dst) a2a slots for cold features
    topk_frac: float = 0.25  # topk_reduce: kept fraction of the capacity
    #                          slots (k = ceil(topk_frac * capacity));
    #                          threaded from DPMRConfig.topk_frac by
    #                          core.dpmr.make_strategy_context
    rank: int = 0            # this rank's linear index over the mesh
    outer_shards: int = 1    # Po = pods
    groups: object = None    # launch.mesh.Groups (world, inner, outer);
    #                          None = no process group (one rank)

    @property
    def inner_shards(self) -> int:
        """Pi = ranks per pod."""
        return self.num_shards // max(self.outer_shards, 1)


class DistributionStrategy:
    """Interface for the distributeParameters / reduce pair of stages.

    `distribute` returns the per-slot cold parameters plus a forward-state
    dict that the engine threads into `reduce`; `overflow` must be a 0-d
    int32 tensor in that dict.

    A strategy may carry persistent per-rank state across steps (error
    feedback): `init_carry` then returns its zero value, a 1-D f32 tensor
    of static length. The engine keeps it in `DPMRState.strat`, passes it
    to `reduce` as `fwd["carry"]` (with `fwd["accumulate"]` True on the
    full-batch path, whose caller discards the new carry), and expects
    `(grad_cold, new_carry)` back. `reduce` may update the carry IN PLACE
    and return it: at 2^27 features it is 512 MiB.
    """

    name: str = "base"

    def distribute(self, ctx: StrategyContext, cold_loc: torch.Tensor,
                   cold_ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def reduce(self, ctx: StrategyContext, cold_loc: torch.Tensor,
               grads_flat: torch.Tensor, fwd: dict):
        raise NotImplementedError

    def init_carry(self, ctx: StrategyContext,
                   device=None) -> torch.Tensor | None:
        """Zero value of the per-rank persistent state on `device`
        (None = stateless)."""
        return None

    def bytes_per_device(self, ctx: StrategyContext) -> WireBytes:
        """Bytes one rank receives over the wire per step, by tier."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _group(ctx: StrategyContext, tier: str):
    """The process group of `tier` ("world", "inner" or "outer"), or None
    for a context with no group, which must then be one rank."""
    if ctx.groups is not None:
        return getattr(ctx.groups, tier)
    size = {"world": ctx.num_shards, "inner": ctx.inner_shards,
            "outer": ctx.outer_shards}[tier]
    if size != 1:
        raise NotImplementedError(
            f"a {tier} exchange over {size} ranks needs a process group: "
            "build the steps from a DeviceMesh (launch.mesh.make_host_mesh)")
    return None


def _all_to_all(x: torch.Tensor, ctx: StrategyContext,
                tier: str = "world") -> torch.Tensor:
    """Tiled all_to_all over the leading axis: row o goes to rank o of the
    tier's group, row s of the result came from rank s. Equal splits; f32,
    int32 and int8."""
    group = _group(ctx, tier)
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _chunked_all_to_all(x: torch.Tensor, ctx: StrategyContext,
                        num_chunks: int) -> torch.Tensor:
    """`_all_to_all` of a (P, cap) buffer as `num_chunks` asynchronous
    all_to_alls over capacity-slot ranges, waited in order. Every element
    goes where the whole exchange sends it, so the result is
    bit-identical."""
    group = _group(ctx, "world")
    if group is None:
        return x
    cap = x.shape[1]
    n = max(1, min(num_chunks, cap))
    bounds = [cap * i // n for i in range(n + 1)]
    out = torch.empty_like(x)
    sent = []      # each chunk's buffers stay alive until its wait
    for lo, hi in zip(bounds, bounds[1:], strict=False):
        if hi > lo:
            src = x[:, lo:hi].contiguous()
            dst = torch.empty_like(src)
            work = dist.all_to_all_single(dst, src, group=group,
                                          async_op=True)
            sent.append((work, lo, hi, src, dst))
    for work, lo, hi, _, dst in sent:
        work.wait()
        out[:, lo:hi] = dst
    return out


def _all_gather(x: torch.Tensor, ctx: StrategyContext,
                tier: str = "world") -> torch.Tensor:
    """Tiled all_gather over the leading axis: the ranks' `x` stacked in
    rank order along it."""
    group = _group(ctx, tier)
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _rank_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (rank) axis, added in rank order. `parts` is
    a collective's fresh output, so one rank's part is returned as it
    is (no copy)."""
    if parts.shape[0] == 1:
        return parts[0]
    acc = parts[0] + parts[1]
    for r in range(2, parts.shape[0]):
        acc += parts[r]
    return acc


def _psum_scatter(x: torch.Tensor, ctx: StrategyContext,
                  tier: str = "world") -> torch.Tensor:
    """Sum over the tier's ranks of the (G * block,) vectors, each rank
    keeping its block: an all_to_all of the (G, block) segments, then
    their sum in rank order. A rank receives (G - 1) blocks, as the
    reference's ring psum_scatter does."""
    group = _group(ctx, tier)
    if group is None:
        return x
    g = dist.get_world_size(group)
    return _rank_sum(_all_to_all(x.reshape(g, -1), ctx, tier))


def _psum(x: torch.Tensor, ctx: StrategyContext) -> torch.Tensor:
    """Sum over every rank of `x`, the same bits on each: an all_gather of
    the partials, added in rank order."""
    if _group(ctx, "world") is None:
        return x
    return _rank_sum(_all_gather(x[None], ctx))


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------


def _owner_base(ctx: StrategyContext) -> int:
    """Global id of this rank's first table row."""
    return ctx.rank * ctx.block_size


def _sparse_distribute(ctx, cold_loc, cold_ids, a2a_fn=None):
    """The paper's Algorithm 4: request shuffle + owner lookup + response.

    `a2a_fn(x)` is the exchange of the two (P, cap) buffers: the whole
    all_to_all by default, micro-chunks for overlap_a2a."""
    if a2a_fn is None:
        a2a_fn = lambda x: _all_to_all(x, ctx)  # noqa: E731
    routing = sparse.route_build(cold_ids, ctx.num_shards, ctx.block_size,
                                 ctx.capacity)
    req_recv = a2a_fn(routing.req_ids)
    resp = sparse.owner_apply(req_recv, cold_loc, _owner_base(ctx))
    theta_cold = sparse.route_return(routing, a2a_fn(resp))
    return theta_cold, {"routing": routing, "req_recv": req_recv,
                        "cold_ids": cold_ids, "overflow": routing.overflow}


def _exact_reduce(ctx, cold_loc, grads_flat, fwd, a2a_fn=None):
    """The paper's reverse shuffle: per-feature sums to their owner, one
    add per feature (`ops.owner_accumulate`)."""
    if a2a_fn is None:
        a2a_fn = lambda x: _all_to_all(x, ctx)  # noqa: E731
    send = sparse.combine_grads(fwd["routing"], grads_flat)
    return ops.owner_accumulate(fwd["req_recv"], a2a_fn(send),
                                torch.zeros_like(cold_loc), _owner_base(ctx))


def _dense_accumulate(ctx, cold_loc, grads_flat, cold_ids):
    """Local dense accumulation: the (F,) per-rank gradient vector. Its
    sum per feature is `ops.owner_accumulate` over the whole table (one
    add per feature, bit-reproducible on the card)."""
    f = cold_loc.shape[0] * ctx.num_shards
    return ops.owner_accumulate(
        cold_ids, grads_flat,
        torch.zeros((f,), dtype=torch.float32, device=cold_loc.device), 0)


def _dense_reduce(ctx, cold_loc, grads_flat, cold_ids):
    """Dense accumulate + psum_scatter: every rank folds its gradients
    into a full-length vector; one collective delivers owner blocks."""
    return _psum_scatter(
        _dense_accumulate(ctx, cold_loc, grads_flat, cold_ids), ctx)


def _zero_carry(n, device):
    return torch.zeros((n,), dtype=torch.float32, device=device)


def _padded_block(block: int) -> int:
    qb = compression.BLOCK
    return -(-block // qb) * qb


def _int8_reduce(comp, g, block, ctx, tier):
    """compressed_reduce's wire: the (g * block,) compensated vector as
    int8 blocks by destination segment over the tier's `g` ranks; returns
    (this rank's (block,) sum, the new quantization residual)."""
    qb = compression.BLOCK
    bp = _padded_block(block)
    seg = torch.nn.functional.pad(comp.reshape(g, block), (0, bp - block))
    q, scale = compression.quantize(seg.reshape(-1))       # (g*bp/qb, qb)
    new_carry = comp - compression.dequantize(
        q, scale, g * bp).reshape(g, bp)[:, :block].reshape(-1)
    q_recv = _all_to_all(q.reshape(g, bp), ctx, tier)
    s_recv = _all_to_all(scale.reshape(g, bp // qb), ctx, tier)
    deq = (q_recv.to(torch.float32).reshape(g, bp // qb, qb)
           * s_recv[..., None])
    return deq.reshape(g, bp)[:, :block].sum(dim=0), new_carry


def _int8_bytes(block: int) -> int:
    """Bytes of one peer's int8 segment and its f32 scales."""
    bp = _padded_block(block)
    return bp + (bp // compression.BLOCK) * 4


class AllToAllStrategy(DistributionStrategy):
    """Paper-faithful DPMR shuffle in both directions."""

    name = "a2a"

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids)

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return _exact_reduce(ctx, cold_loc, grads_flat, fwd)

    def bytes_per_device(self, ctx):
        # 3 (P, cap) f32 buffers (requests, responses, grad sums); a rank
        # receives the (Pi - 1) same-pod buckets inside the pod and the
        # (P - Pi) from other pods across them, its own never leaves
        pi = ctx.inner_shards
        return WireBytes(inner=3 * (pi - 1) * ctx.capacity * 4,
                         outer=3 * (ctx.num_shards - pi) * ctx.capacity * 4)


class AllGatherStrategy(DistributionStrategy):
    """Ship-the-table baseline (the paper's comparison point)."""

    name = "allgather"

    def distribute(self, ctx, cold_loc, cold_ids):
        table = _all_gather(cold_loc, ctx)
        theta_cold = torch.where(cold_ids >= 0,
                                 table[torch.clamp(cold_ids, min=0)], 0.0)
        return theta_cold, {"cold_ids": cold_ids,
                            "overflow": torch.zeros((), dtype=torch.int32,
                                                    device=cold_ids.device)}

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return _dense_reduce(ctx, cold_loc, grads_flat, fwd["cold_ids"])

    def bytes_per_device(self, ctx):
        # all_gather forward + psum_scatter reduce: P - 1 remote blocks
        # each, the (P - Pi) owned by other pods across them
        pi = ctx.inner_shards
        return WireBytes(
            inner=2 * ctx.block_size * (pi - 1) * 4,
            outer=2 * ctx.block_size * (ctx.num_shards - pi) * 4)


class PsumScatterStrategy(DistributionStrategy):
    """Hybrid: sparse shuffle forward, dense psum_scatter reduce."""

    name = "psum_scatter"

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids)

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return _dense_reduce(ctx, cold_loc, grads_flat, fwd["cold_ids"])

    def bytes_per_device(self, ctx):
        pi = ctx.inner_shards
        cross = ctx.num_shards - pi
        return WireBytes(
            inner=2 * (pi - 1) * ctx.capacity * 4
            + ctx.block_size * (pi - 1) * 4,
            outer=2 * cross * ctx.capacity * 4 + ctx.block_size * cross * 4)


class CompressedReduceStrategy(DistributionStrategy):
    """Sparse forward + int8 block-quantized dense reduce with error
    feedback.

    The (F,) per-rank gradient is compensated with the carried residual,
    block-quantized (`compression.quantize`, one f32 scale per
    `compression.BLOCK` values) and exchanged as int8 by destination
    segment; receivers dequantize and sum their own block. The residual
    `(g + err) - dequant(q)` is the new carry. On the full-batch path
    (`fwd["accumulate"]`) the carry is frozen, so the reduce is the exact
    dense one there.
    """

    name = "compressed_reduce"

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids)

    def init_carry(self, ctx, device=None):
        return _zero_carry(ctx.num_shards * ctx.block_size, device)

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        if fwd.get("accumulate", False):
            return (_dense_reduce(ctx, cold_loc, grads_flat,
                                  fwd["cold_ids"]), fwd["carry"])
        gfull = _dense_accumulate(ctx, cold_loc, grads_flat,
                                  fwd["cold_ids"])
        return _int8_reduce(gfull + fwd["carry"], ctx.num_shards,
                            ctx.block_size, ctx, "world")

    def bytes_per_device(self, ctx):
        pi = ctx.inner_shards
        cross = ctx.num_shards - pi
        per_peer = _int8_bytes(ctx.block_size)
        return WireBytes(
            inner=2 * (pi - 1) * ctx.capacity * 4 + (pi - 1) * per_peer,
            outer=2 * cross * ctx.capacity * 4 + cross * per_peer)


class TopKReduceStrategy(DistributionStrategy):
    """Sparse forward + top-k sparsified reverse shuffle with per-rank
    error feedback.

    Each rank combines its per-feature gradient sums into the (P, cap)
    send buffer, compensates every live slot with the residual its feature
    banked (`carry[feature_id]`), and sends per destination only the
    k = ceil(topk_frac * cap) largest-|value| slots as (value, id) pairs
    (`ops.select_pack`). Losers bank their compensated value in the carry,
    winners reset theirs to zero. `topk_frac=1.0` keeps every slot and the
    residual stays zero. On the full-batch path (`fwd["accumulate"]`) the
    carry is frozen, so the reduce is the exact a2a one and the carry is
    passed through: `fit` gets exact epoch gradients, `fit_sgd` the
    sparsified wire.
    """

    name = "topk_reduce"

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids)

    def init_carry(self, ctx, device=None):
        return _zero_carry(ctx.num_shards * ctx.block_size, device)

    def _k(self, ctx) -> int:
        return compression.topk_count(ctx.capacity, ctx.topk_frac)

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        carry = fwd["carry"]
        if fwd.get("accumulate", False):
            return _exact_reduce(ctx, cold_loc, grads_flat, fwd), carry
        f = ctx.num_shards * ctx.block_size
        send = sparse.combine_grads(fwd["routing"], grads_flat)  # (P, cap)
        ids = fwd["routing"].req_ids                             # (P, cap)
        carry_slots = carry[torch.clamp(ids, 0, f - 1)]
        vals_k, ids_k, resid = ops.select_pack(send, ids, carry_slots,
                                               self._k(ctx))
        _bank_residual(carry, ids, resid)
        v_recv = _all_to_all(vals_k, ctx)
        i_recv = _all_to_all(ids_k, ctx)
        grad = ops.owner_accumulate(i_recv, v_recv,
                                    torch.zeros_like(cold_loc),
                                    _owner_base(ctx))
        return grad, carry

    def bytes_per_device(self, ctx):
        # forward: a2a's 2 (P, cap) f32 buffers; reduce: k (f32 value,
        # int32 id) pairs from each peer, on both tiers
        pi = ctx.inner_shards
        cross = ctx.num_shards - pi
        k = self._k(ctx)
        return WireBytes(
            inner=2 * (pi - 1) * ctx.capacity * 4 + (pi - 1) * k * 8,
            outer=2 * cross * ctx.capacity * 4 + cross * k * 8)


def _bank_residual(carry: torch.Tensor, ids: torch.Tensor,
                   resid: torch.Tensor) -> None:
    """carry[ids] = resid on live slots, IN PLACE; dead slots change
    nothing.

    Live ids are unique per rank (route_build deduplicates each source's
    ids before it fills the (P, cap) rows), so the live writes never
    collide. A static-shape write has no way to skip the dead slots, and
    the reference's (F+1)-long target with a dropped row would cost a
    512 MiB copy per step at 2^27. So each dead slot repeats the first
    live slot's (id, value) write: an address that receives several
    writes receives the same bits from each, and the result does not
    depend on their order on the card. With no live slot at all, the dead
    slots write carry[0]'s own value back.
    """
    ids = ids.reshape(-1)
    resid = resid.reshape(-1)
    live = ids >= 0
    first = torch.argmax(live.to(torch.uint8))
    any_live = live[first]
    fill_id = torch.where(any_live, ids[first], 0).to(torch.int64)
    fill_val = torch.where(any_live, resid[first], carry[0])
    carry[torch.where(live, ids.to(torch.int64), fill_id)] = \
        torch.where(live, resid, fill_val)


class OverlapA2AStrategy(AllToAllStrategy):
    """Overlap-aware `a2a`: the same exchanges as micro-chunks.

    Every (P, cap) all_to_all of the paper's shuffle is split into
    `num_chunks` asynchronous collectives over capacity-slot ranges
    (`_chunked_all_to_all`), waited in order. Element routing is
    untouched, so parameters and gradients are BIT-IDENTICAL to `a2a` on
    any mesh; wire bytes equal `a2a`'s (inherited model).
    """

    name = "overlap_a2a"
    num_chunks = 4      # micro-chunks per exchange; capacity-bounded

    def _a2a(self, ctx, x):
        return _chunked_all_to_all(x, ctx, self.num_chunks)

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids,
                                  a2a_fn=lambda x: self._a2a(ctx, x))

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return _exact_reduce(ctx, cold_loc, grads_flat, fwd,
                             a2a_fn=lambda x: self._a2a(ctx, x))


def _hier_remap(cold_ids: torch.Tensor, po: int, pi: int,
                block: int) -> torch.Tensor:
    """Bijection global id -> (inner_owner, mirror_row) contiguous space.

    Row r is owned by rank d = r // block with pod q = d // Pi and inner
    index i = d % Pi. After the pod all_gather, rank (*, i) holds a mirror
    of all pods' i-blocks, pod-major; relabelling
    r' = i * (Po*block) + q*block + (r % block) makes mirror ownership
    contiguous-block again (block Po*block over Pi owners), so the
    unmodified routing drives the inner-only exchange.
    """
    ids = torch.clamp(cold_ids, min=0)
    q = torch.div(ids, pi * block, rounding_mode="floor")
    inner_owner = torch.div(ids, block, rounding_mode="floor") % pi
    remapped = inner_owner * (po * block) + q * block + ids % block
    return torch.where(cold_ids >= 0, remapped, -1).to(torch.int32)


class HierarchicalA2AStrategy(DistributionStrategy):
    """Two-level exchange over the (pod, inner) tiers.

    Forward: an all_gather over the pods mirrors, on every rank, the table
    blocks of its inner peers in every pod (Po blocks); the sparse
    request/response all_to_all then runs ONLY inside the pod, against
    the mirror, with ids relabelled by `_hier_remap`. Reduce: the reverse
    inner shuffle accumulates per-feature sums into the mirror layout,
    then ONE psum_scatter over the pods carries the already-reduced
    per-pod partials and lands each owner's block.

    With a single pod (Po == 1) this is bit-identical to `a2a`. The inner
    capacity is Po x the flat capacity (requests concentrate on Pi owners
    instead of P), so overflow behaviour matches `a2a` at equal headroom.
    """

    name = "hier_a2a"

    def _inner_capacity(self, ctx, n):
        return int(min(n, ctx.capacity * ctx.outer_shards))

    def _inner_base(self, ctx) -> int:
        """Global mirror row of this rank's first mirror row."""
        return (ctx.rank % ctx.inner_shards) * (ctx.outer_shards
                                                * ctx.block_size)

    def distribute(self, ctx, cold_loc, cold_ids):
        po, pi = ctx.outer_shards, ctx.inner_shards
        if po == 1:
            return _sparse_distribute(ctx, cold_loc, cold_ids)
        block = ctx.block_size
        mirror = _all_gather(cold_loc, ctx, "outer")       # (Po*block,)
        rem = _hier_remap(cold_ids, po, pi, block)
        if pi == 1:
            # one rank a pod: the mirror is the whole table, look up
            # locally; only the dense block exchanges cross pods
            theta_cold = torch.where(cold_ids >= 0,
                                     mirror[torch.clamp(rem, min=0)], 0.0)
            return theta_cold, {"cold_ids": cold_ids, "rem_ids": rem,
                                "overflow": torch.zeros(
                                    (), dtype=torch.int32,
                                    device=cold_ids.device)}
        cap_i = self._inner_capacity(ctx, cold_ids.shape[0])
        routing = sparse.route_build(rem, pi, po * block, cap_i)
        req_recv = _all_to_all(routing.req_ids, ctx, "inner")
        resp = sparse.owner_apply(req_recv, mirror, self._inner_base(ctx))
        theta_cold = sparse.route_return(
            routing, _all_to_all(resp, ctx, "inner"))
        return theta_cold, {"routing": routing, "req_recv": req_recv,
                            "cold_ids": cold_ids,
                            "overflow": routing.overflow}

    def _mirror_accumulate(self, ctx, cold_loc, grads_flat, fwd):
        """Inner-tier gradient reduce up to (not including) the cross-pod
        leg: the (Po*block,) mirror accumulator whose segment q holds this
        pod's partial sums for pod q's owner block. The composition seam:
        `ComposedStrategy` swaps the psum_scatter that follows for a lossy
        outer leg. Requires Po > 1."""
        po, pi = ctx.outer_shards, ctx.inner_shards
        f_mirror = po * ctx.block_size
        acc = torch.zeros((f_mirror,), dtype=torch.float32,
                          device=grads_flat.device)
        if pi == 1:
            return ops.owner_accumulate(fwd["rem_ids"], grads_flat, acc, 0)
        send = sparse.combine_grads(fwd["routing"], grads_flat)
        return ops.owner_accumulate(fwd["req_recv"],
                                    _all_to_all(send, ctx, "inner"), acc,
                                    self._inner_base(ctx))

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        if ctx.outer_shards == 1:
            return _exact_reduce(ctx, cold_loc, grads_flat, fwd)
        mirror_acc = self._mirror_accumulate(ctx, cold_loc, grads_flat, fwd)
        # per-pod partials cross pods once: segment q of the mirror
        # accumulator is pod q's owner block, summed across pods
        return _psum_scatter(mirror_acc, ctx, "outer")

    def bytes_per_device(self, ctx):
        po, pi = ctx.outer_shards, ctx.inner_shards
        # inner: the sparse shuffle at Po-scaled capacity from the (Pi - 1)
        # inner peers; outer: the pod all_gather of the block and the
        # psum_scatter of the per-pod partials
        return WireBytes(inner=3 * (pi - 1) * (ctx.capacity * po) * 4,
                         outer=2 * ctx.block_size * (po - 1) * 4)


class OuterLeg:
    """The cross-pod half of a per-tier composition.

    A leg replaces the single outer-tier collective of a hierarchical
    strategy's reduce: it receives the (Po*block,) mirror accumulator
    (segment q = this pod's partials for pod q's owner block) and must
    deliver this rank's (block,) owner gradient by exchanging ONLY over
    the outer group. Legs may keep an error-feedback residual: declare its
    static length via `carry_len` (0 = stateless) and advance it in
    `reduce_outer`; `ComposedStrategy` namespaces it into the composed
    carry that the engine keeps in `DPMRState.strat`.
    """

    name: str = "leg"

    def carry_len(self, ctx: StrategyContext) -> int:
        """Static residual length on this geometry (0 = no carry)."""
        return 0

    def reduce_outer(self, ctx: StrategyContext, mirror_acc: torch.Tensor,
                     carry: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def reduce_bytes(self, ctx: StrategyContext) -> int:
        """Cross-pod bytes a rank receives on the reduce leg (Po > 1)."""
        raise NotImplementedError


class TopKOuterLeg(OuterLeg):
    """Top-k sparsified cross-pod reduce: each pod sends, per destination
    pod, only the k = ceil(topk_frac * block) largest-|g| rows of its
    partial block as (value f32, row int32) pairs; losers bank an
    error-feedback residual over the (Po*block,) mirror layout.

    The owner adds the received pairs with `ops.owner_accumulate` (sorted
    run totals, one add per row), not the reference's scatter-add: two
    pods may send the same row, and a card `index_add_` would add them in
    atomic order, so the bits would change from run to run.
    """

    name = "topk"

    def _k(self, ctx) -> int:
        return compression.topk_count(ctx.block_size, ctx.topk_frac)

    def carry_len(self, ctx):
        return ctx.outer_shards * ctx.block_size

    def reduce_outer(self, ctx, mirror_acc, carry):
        po, block = ctx.outer_shards, ctx.block_size
        comp = (mirror_acc + carry).reshape(po, block)   # error feedback
        top_idx, top_mask = compression.topk_select(torch.abs(comp),
                                                    self._k(ctx))
        vals_k = torch.gather(comp, 1, top_idx)          # (Po, k)
        new_carry = torch.where(top_mask, 0.0, comp).reshape(-1)
        v_recv = _all_to_all(vals_k, ctx, "outer")
        i_recv = _all_to_all(top_idx.to(torch.int32), ctx, "outer")
        grad = ops.owner_accumulate(
            i_recv, v_recv, torch.zeros((block,), dtype=torch.float32,
                                        device=mirror_acc.device), 0)
        return grad, new_carry

    def reduce_bytes(self, ctx):
        # k (f32 value, int32 row) pairs from each of the (Po-1) other pods
        return (ctx.outer_shards - 1) * self._k(ctx) * 8


class Int8OuterLeg(OuterLeg):
    """Int8 block-quantized cross-pod reduce: the per-pod partial blocks
    cross as int8 + per-`compression.BLOCK` f32 scales (compressed_reduce's
    scheme on the outer tier only), with the quantization residual banked
    as an error-feedback carry over the (Po*block,) mirror layout.
    """

    name = "int8"

    def carry_len(self, ctx):
        return ctx.outer_shards * ctx.block_size

    def reduce_outer(self, ctx, mirror_acc, carry):
        return _int8_reduce(mirror_acc + carry, ctx.outer_shards,
                            ctx.block_size, ctx, "outer")

    def reduce_bytes(self, ctx):
        return (ctx.outer_shards - 1) * _int8_bytes(ctx.block_size)


class ComposedStrategy(DistributionStrategy):
    """Per-tier composition: a hierarchical member's exact exchange inside
    the pod, an `OuterLeg`'s lossy reduce across pods.

    The cut point is the member's `_mirror_accumulate` seam: forward and
    the inner gradient shuffle are the member's own (exact), and only the
    single cross-pod crossing of the reduce is replaced by the leg. With
    one pod (Po == 1) the composition is the member exactly: stateless and
    bit-identical. On the full-batch accumulation path the composition
    takes the member's exact reduce with the carry frozen.
    """

    def __init__(self, inner: DistributionStrategy, leg: OuterLeg):
        self.inner = inner
        self.leg = leg
        self.name = f"{inner.name}+{leg.name}"

    def carry_layout(self, ctx) -> list[tuple[str, int]]:
        """Namespaced `(member_name, length)` segments of the composed
        carry, in `DPMRState.strat` order: at most the outer leg's."""
        n = self.leg.carry_len(ctx) if ctx.outer_shards > 1 else 0
        return [(self.leg.name, n)] if n else []

    def distribute(self, ctx, cold_loc, cold_ids):
        return self.inner.distribute(ctx, cold_loc, cold_ids)

    def init_carry(self, ctx, device=None):
        total = sum(n for _, n in self.carry_layout(ctx))
        return _zero_carry(total, device) if total else None

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        if ctx.outer_shards == 1:
            return self.inner.reduce(ctx, cold_loc, grads_flat, fwd)
        if fwd.get("accumulate", False):
            return (self.inner.reduce(ctx, cold_loc, grads_flat, fwd),
                    fwd["carry"])
        mirror_acc = self.inner._mirror_accumulate(ctx, cold_loc,
                                                   grads_flat, fwd)
        return self.leg.reduce_outer(ctx, mirror_acc, fwd["carry"])

    def bytes_per_device(self, ctx):
        member = self.inner.bytes_per_device(ctx)
        po = ctx.outer_shards
        if po == 1:
            return member
        # inner tier is the member's own exchange; outer = the pod
        # all_gather of the local block + the leg's reduce
        outer = ctx.block_size * (po - 1) * 4 + self.leg.reduce_bytes(ctx)
        return WireBytes(inner=member.inner, outer=outer)


_REGISTRY: dict[str, DistributionStrategy] = {}


def register_strategy(name: str, strategy: DistributionStrategy = None):
    """Register a strategy instance, or use as a class decorator:

        @register_strategy("mine")
        class Mine(DistributionStrategy): ...
    """
    if strategy is not None:
        # shallow-copy so aliasing an existing instance doesn't rename it
        inst = copy.copy(strategy)
        inst.name = name
        _REGISTRY[name] = inst
        return inst

    def _decorate(cls):
        inst = cls() if isinstance(cls, type) else cls
        inst.name = name
        _REGISTRY[name] = inst
        return cls

    return _decorate


def get_strategy(name: str) -> DistributionStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"distribution strategy {name!r} is not registered in "
            f"repro_torch ({sorted(_REGISTRY)}); 'auto', the wire-cost "
            "autotuner (api/autotune.py), is ROADMAP queue A") from None


def list_strategies() -> list[str]:
    return sorted(_REGISTRY)


def register_composition(inner_name: str, leg: OuterLeg,
                         name: str | None = None) -> ComposedStrategy:
    """Register `ComposedStrategy(get_strategy(inner_name), leg)` under
    `"<inner>+<leg>"` (or `name`). The inner member must expose the
    `_mirror_accumulate` seam and be stateless."""
    inner = get_strategy(inner_name)
    if not hasattr(inner, "_mirror_accumulate"):
        raise TypeError(
            f"strategy {inner_name!r} has no _mirror_accumulate seam; "
            "only hierarchical strategies whose reduce isolates the "
            "cross-pod crossing can take a composed outer leg")
    composed = ComposedStrategy(inner, leg)
    register_strategy(name or composed.name, composed)
    return composed


register_strategy("a2a", AllToAllStrategy())
register_strategy("allgather", AllGatherStrategy())
register_strategy("psum_scatter", PsumScatterStrategy())
register_strategy("hier_a2a", HierarchicalA2AStrategy())
register_strategy("compressed_reduce", CompressedReduceStrategy())
register_strategy("topk_reduce", TopKReduceStrategy())
register_strategy("overlap_a2a", OverlapA2AStrategy())
register_composition("hier_a2a", TopKOuterLeg())
register_composition("hier_a2a", Int8OuterLeg())
