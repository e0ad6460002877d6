"""Parameter-distribution strategies: the counterpart of
`repro.api.strategies`, on one card.

A `DistributionStrategy` implements the two collective-bearing stages of
the per-device pipeline; `core.dpmr` asks the registry for the one
`DPMRConfig.distribution` names. Ported, with the reference's semantics:

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

On one card (P = 1) the collectives `_all_to_all`, `_all_gather` and
`_psum_scatter` are the identity. They are the seams the multi-rank slice
fills with `torch.distributed` (ROADMAP queue A); until then they raise
for P > 1. `overlap_a2a`, `hier_a2a`, the per-tier compositions and
`auto` differ from these only across ranks or tiers and come with
multi-rank: naming one raises instead of running another strategy. The
reference's per-rank and per-tier context fields and its two-tier
`WireBytes` come back with them; `bytes_per_device` here is the
single-tier total.

Third parties extend the seam with either

    @register_strategy("my_strategy")
    class MyStrategy(DistributionStrategy): ...

or `register_strategy("name", instance)`.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from repro_torch.core import sparse
from repro_torch.kernels import ops
from repro_torch.optim import compression


class StrategyContext(NamedTuple):
    """Static per-step geometry handed to every strategy method."""

    num_shards: int          # P = ranks taking part
    block_size: int          # rows of the feature table per rank
    capacity: int            # per-(src,dst) a2a slots for cold features
    topk_frac: float = 0.25  # topk_reduce: kept fraction of the capacity
    #                          slots (k = ceil(topk_frac * capacity));
    #                          threaded from DPMRConfig.topk_frac by
    #                          core.dpmr.make_strategy_context


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

    def bytes_per_device(self, ctx: StrategyContext) -> int:
        """Bytes one rank receives over the wire per step."""
        raise NotImplementedError


def _single_rank(ctx: StrategyContext, what: str) -> None:
    if ctx.num_shards != 1:
        raise NotImplementedError(
            f"{what} across ranks is not ported yet: multi-rank strategies "
            "over torch.distributed are ROADMAP queue A")


def _all_to_all(x: torch.Tensor, ctx: StrategyContext) -> torch.Tensor:
    """Tiled all_to_all over the (P, cap) leading axis: row o goes to rank
    o. The identity on one rank."""
    _single_rank(ctx, "all_to_all")
    return x


def _all_gather(x: torch.Tensor, ctx: StrategyContext) -> torch.Tensor:
    """Tiled all_gather of each rank's block into the whole table. The
    identity on one rank."""
    _single_rank(ctx, "all_gather")
    return x


def _psum_scatter(x: torch.Tensor, ctx: StrategyContext) -> torch.Tensor:
    """Sum over ranks of the (F,) vectors, each rank keeping its block.
    The identity on one rank."""
    _single_rank(ctx, "psum_scatter")
    return x


def _sparse_distribute(ctx, cold_loc, cold_ids):
    """The paper's Algorithm 4: request shuffle + owner lookup + response.
    One rank owns rows [0, block_size), so its owner base is 0."""
    routing = sparse.route_build(cold_ids, ctx.num_shards, ctx.block_size,
                                 ctx.capacity)
    req_recv = _all_to_all(routing.req_ids, ctx)
    resp = sparse.owner_apply(req_recv, cold_loc, 0)
    theta_cold = sparse.route_return(routing, _all_to_all(resp, ctx))
    return theta_cold, {"routing": routing, "req_recv": req_recv,
                        "cold_ids": cold_ids, "overflow": routing.overflow}


def _exact_reduce(ctx, cold_loc, grads_flat, fwd):
    """The paper's reverse shuffle: per-feature sums to their owner."""
    send = sparse.combine_grads(fwd["routing"], grads_flat)
    return ops.owner_accumulate(fwd["req_recv"], _all_to_all(send, ctx),
                                torch.zeros_like(cold_loc), 0)


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


def _zero_carry(ctx, device):
    return torch.zeros((ctx.num_shards * ctx.block_size,),
                       dtype=torch.float32, device=device)


class AllToAllStrategy(DistributionStrategy):
    """Paper-faithful DPMR shuffle in both directions."""

    name = "a2a"

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids)

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return _exact_reduce(ctx, cold_loc, grads_flat, fwd)

    def bytes_per_device(self, ctx):
        # 3 (P, cap) f32 buffers (requests, responses, grad sums); a rank
        # receives P - 1 buckets of each, its own never leaves the card
        return 3 * (ctx.num_shards - 1) * ctx.capacity * 4


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
        # all_gather forward + psum_scatter reduce: P - 1 remote blocks each
        return 2 * ctx.block_size * (ctx.num_shards - 1) * 4


class PsumScatterStrategy(DistributionStrategy):
    """Hybrid: sparse shuffle forward, dense psum_scatter reduce."""

    name = "psum_scatter"

    def distribute(self, ctx, cold_loc, cold_ids):
        return _sparse_distribute(ctx, cold_loc, cold_ids)

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return _dense_reduce(ctx, cold_loc, grads_flat, fwd["cold_ids"])

    def bytes_per_device(self, ctx):
        peers = ctx.num_shards - 1
        return 2 * peers * ctx.capacity * 4 + ctx.block_size * peers * 4


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
        return _zero_carry(ctx, device)

    def _padded_block(self, ctx) -> int:
        qb = compression.BLOCK
        return -(-ctx.block_size // qb) * qb

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        if fwd.get("accumulate", False):
            return (_dense_reduce(ctx, cold_loc, grads_flat,
                                  fwd["cold_ids"]), fwd["carry"])
        p = ctx.num_shards
        block = ctx.block_size
        qb = compression.BLOCK
        bp = self._padded_block(ctx)
        gfull = _dense_accumulate(ctx, cold_loc, grads_flat,
                                  fwd["cold_ids"])
        comp = gfull + fwd["carry"]                        # error feedback
        seg = torch.nn.functional.pad(comp.reshape(p, block),
                                      (0, bp - block))
        q, scale = compression.quantize(seg.reshape(-1))   # (p*bp/qb, qb)
        new_carry = comp - compression.dequantize(
            q, scale, p * bp).reshape(p, bp)[:, :block].reshape(-1)
        # int8 on the wire: exchange by destination segment, dequantize and
        # sum the received contributions to this rank's block
        q_recv = _all_to_all(q.reshape(p, bp), ctx)
        s_recv = _all_to_all(scale.reshape(p, bp // qb), ctx)
        deq = (q_recv.to(torch.float32).reshape(p, bp // qb, qb)
               * s_recv[..., None])
        grad = deq.reshape(p, bp)[:, :block].sum(dim=0)
        return grad, new_carry

    def bytes_per_device(self, ctx):
        peers = ctx.num_shards - 1
        bp = self._padded_block(ctx)
        per_peer = bp + (bp // compression.BLOCK) * 4      # int8 + scales
        return 2 * peers * ctx.capacity * 4 + peers * per_peer


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
        return _zero_carry(ctx, device)

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
                                    torch.zeros_like(cold_loc), 0)
        return grad, carry

    def bytes_per_device(self, ctx):
        # forward: a2a's 2 (P, cap) f32 buffers; reduce: k (f32 value,
        # int32 id) pairs from each peer
        peers = ctx.num_shards - 1
        return 2 * peers * ctx.capacity * 4 + peers * self._k(ctx) * 8


def _bank_residual(carry: torch.Tensor, ids: torch.Tensor,
                   resid: torch.Tensor) -> None:
    """carry[ids] = resid on live slots, IN PLACE; dead slots change
    nothing.

    Live ids are unique per rank (route_build deduplicates), so the live
    writes never collide. A static-shape write has no way to skip the dead
    slots, and the reference's (F+1)-long target with a dropped row would
    cost a 512 MiB copy per step at 2^27. So each dead slot repeats the
    first live slot's (id, value) write: an address that receives several
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
            f"distribution strategy {name!r} is not in repro_torch: only "
            f"{sorted(_REGISTRY)} are ported, the multi-rank ones are "
            "ROADMAP queue A") from None


def list_strategies() -> list[str]:
    return sorted(_REGISTRY)


register_strategy("a2a", AllToAllStrategy())
register_strategy("allgather", AllGatherStrategy())
register_strategy("psum_scatter", PsumScatterStrategy())
register_strategy("compressed_reduce", CompressedReduceStrategy())
register_strategy("topk_reduce", TopKReduceStrategy())
