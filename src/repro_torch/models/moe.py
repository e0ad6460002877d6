"""Mixture-of-Experts FFN with group-limited top-k dispatch (counterpart
of `repro.models.moe`).

Tokens are split into groups of `group_size` (`g = min(group_size,
B * S)`, which must divide B * S), consecutive in (B, S) row order.
Within a group each token picks its top-k experts from the router's
softmax, and each (token, slot) pair gets a position in its expert's
buffer of C = `expert_capacity` rows by a running count over the group's
pairs, token-major and slot-minor; a pair whose position is C or more is
dropped. A dropped pair adds nothing to its token's output.

The reference builds one-hot (groups, g, E, C) dispatch and combine
tensors and contracts them. The port gathers and scatters by index
instead, which gives the same numbers: a buffer row holds exactly one
token's row or zeros, so the dispatch is a copy; the combine weight is
the gate rounded to the activation dtype, times the expert's output row,
summed in f32 over the k slots and cast once. The experts' products are
batched over experts, (E, groups * C, d) @ (E, d, d_ff): gate and up with
f32 results (`common.bmm_f32`), silu(gate) * up cast to the activation
dtype, then `wo` in that dtype.

Ranking uses a stable descending sort of the probabilities, so that on
ties the lower expert index comes first, as `jax.lax.top_k` orders them,
on every device (`torch.topk` promises no order on ties on CUDA).

The aux loss is the Switch load-balancing loss, `mean over groups of
sum_e density_e * mean_prob_e`, times E^2 / k, where density is the
share of the group's (token, slot) pairs that chose expert e.

Over a mesh of ranks (`Exchange`) a group may span ranks: the DP ranks'
rows, or the S-shards of `model` ranks. A pair's output depends on the
other ranks only through its capacity position and, in the aux, through
its group's densities and mean probabilities. So each rank ranks its
own tokens, the experts they chose are all-gathered (k integers a
token) and every rank counts the positions of the whole microbatch as
the reference does (the kept and dropped pairs are the reference's, bit
for bit); the mean probabilities are each rank's own tokens' share,
summed over the ranks. The experts' weights then lie in one of three
layouts over `model`, as the reference's rules place them: split by
experts when E divides `model` (phi3.5-moe's 16): each rank routes its
S-shard of the stream, its buffers of (E, groups, C, d) reach the
experts' owners by an all-to-all over `model` and come back the same way
(`moe_block(..., ep=group)`); split by `ff` otherwise (mixtral's 8 on a
wider `model`): each rank routes the whole sequence and computes its ff
columns, a partial output that the caller sums over `model`; or whole,
where neither divides. Serving keeps the stream whole on every `model`
rank (`models.parallel.serve_moe_ffn`): each rank applies its own
experts, or its ff columns, to the buffers of the tokens it already
holds (`dispatch_combine(..., local=...)`), and the f32 partial outputs
are summed over `model`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fsdp
from repro_torch.models import common

GROUP_SIZE = 512


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": (d, e), "wi_gate": (e, d, f), "wi_up": (e, d, f),
            "wo": (e, f, d)}


def expert_capacity(cfg: ModelConfig, group_size: int) -> int:
    c = int(group_size * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


class Routing(NamedTuple):
    """One `route` of x (B, S, d) in `groups` groups of g tokens."""

    probs: torch.Tensor      # (groups, g, E) f32 router softmax
    idx: torch.Tensor        # (groups, g, k) int64 experts, best first
    gates: torch.Tensor      # (groups, g, k) f32, renormalised over k
    pos: torch.Tensor        # (groups, g, k) int64 row in the expert buffer
    keep: torch.Tensor       # (groups, g, k) bool: pos < capacity
    density: torch.Tensor    # (groups, E) f32 share of pairs per expert
    capacity: int


class Exchange(NamedTuple):
    """Where a rank's routed tokens (b, s) lie in the global microbatch
    (B, S) and the groups that reach the others. The rows are split over
    the DP ranks (`rows`, process groups inner first: `data`, then `pod`;
    this rank's block `row_rank` of `dp`); the columns over `seq` (the
    `model` group, this rank's block `seq_rank`) when the routed tokens
    are an S-shard, else `seq` is None. Of the routed columns the rank
    owns `own` (start, length) for the aux (None: all), and `aux` are the
    groups over which the owners' shares of the mean probabilities are
    summed (every rank's own tokens once)."""

    rows: tuple
    row_rank: int
    dp: int
    seq: object = None
    seq_rank: int = 0
    own: tuple | None = None
    aux: tuple = ()


class Routed(NamedTuple):
    """`route_exchanged` of this rank's tokens (b, s): per token (b, s,
    ...) its experts, gates, positions and kept mask, and its group's
    index among the global groups that its tokens lie in (in order);
    `groups`, the buffer's groups: that count, or with `seq` the most
    that any rank of `seq` touches (the all-to-all's blocks are equal);
    the capacity and the aux (0-d f32, the reference's, replicated)."""

    probs: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    group: torch.Tensor
    groups: int
    capacity: int
    aux: torch.Tensor


def _rank(probs: torch.Tensor, k: int):
    """Top-k experts by a stable descending sort and their gates,
    renormalised with max(sum, 1e-9)."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    gates = torch.gather(probs, -1, idx)
    return idx, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def _positions(idx: torch.Tensor, ng: int, e: int):
    """idx (ng * g, k) in row order -> (positions (ng, g, k), the one-hot
    (ng, g * k, E)): the running count of each expert's pairs within its
    group, token-major and slot-minor."""
    k = idx.shape[-1]
    flat = F.one_hot(idx.reshape(ng, -1), e)
    pos = torch.gather(torch.cumsum(flat, dim=1) - 1, -1,
                       idx.reshape(ng, -1, 1)).reshape(ng, -1, k)
    return pos, flat


def _group_count(n: int, group_size: int, shape) -> tuple[int, int]:
    g = min(group_size, n)
    if n % g:
        b, s = shape
        raise ValueError(f"{n} tokens (B={b} x S={s}) do not split into "
                         f"MoE groups of {g}")
    return g, n // g


def route(p, x: torch.Tensor, cfg: ModelConfig,
          group_size: int = GROUP_SIZE) -> Routing:
    """The router of `moe_block`: logits as an f32 product of x.dtype
    operands, softmax in f32, top-k by a stable descending sort, gates
    renormalised with max(sum, 1e-9), capacity positions and the kept
    mask. Raises ValueError when g does not divide B * S."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    g, ng = _group_count(b * s, group_size, (b, s))
    logits = common.dot_f32(x.reshape(ng, g, d), p.router.to(x.dtype))
    probs = torch.softmax(logits, dim=-1)
    idx, gates = _rank(probs, k)
    pos, flat = _positions(idx, ng, e)
    cap = expert_capacity(cfg, g)
    return Routing(probs, idx, gates, pos, pos < cap,
                   flat.to(torch.float32).mean(dim=1), cap)


def _touched_groups(row0: int, rows: int, col0: int, cols: int, seq: int,
                   g: int) -> list[int]:
    """The global groups of g tokens (in (B, S) row order, rows of `seq`)
    that the tokens of rows [row0, row0 + rows) x columns [col0, col0 +
    cols) lie in, in order (host arithmetic)."""
    out: set = set()
    for r in range(row0, row0 + rows):
        first = r * seq + col0
        out.update(range(first // g, (first + cols - 1) // g + 1))
    return sorted(out)


def route_exchanged(p, x: torch.Tensor, cfg: ModelConfig, group_size: int,
                    ex: Exchange) -> Routed:
    """The router over a mesh: x (b, s, d) are this rank's routed tokens
    (`ex` places them). Each rank ranks its own tokens; the experts they
    chose are all-gathered into the microbatch's (B, S, k) and the
    positions and densities counted over the whole of it as `route`
    counts them; the aux is the reference's from every rank's share of
    the groups' mean probabilities (differentiable: its gradient reaches
    each rank's own tokens, scaled by `ex.dp`, since the trainer divides
    the summed gradients by the DP ranks)."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(common.dot_f32(x, p.router.to(x.dtype)), dim=-1)
    idx, gates = _rank(probs, k)
    every = idx
    if ex.seq is not None:
        every = fsdp.all_gather_dim(every, ex.seq, 1)
    for group in ex.rows:
        every = fsdp.all_gather_dim(every, group, 0)
    rows, seq = every.shape[:2]
    g, ng = _group_count(rows * seq, group_size, (rows, seq))
    pos_all, flat = _positions(every, ng, e)
    row0, col0 = ex.row_rank * b, ex.seq_rank * s
    pos = pos_all.reshape(rows, seq, k)[row0:row0 + b, col0:col0 + s]
    cap = expert_capacity(cfg, g)
    # the aux: this rank's own tokens' probabilities in the microbatch's
    # layout (zeros elsewhere), their groups' means summed over the ranks
    o0, on = ex.own or (0, s)
    share = F.pad(probs[:, o0:o0 + on],
                  (0, 0, col0 + o0, seq - col0 - o0 - on,
                   row0, rows - row0 - b))
    mean_prob = share.reshape(ng, g, e).mean(dim=1)
    for group in ex.aux:
        mean_prob = fsdp.all_reduce_sum(mean_prob, group)
    density = flat.to(torch.float32).mean(dim=1)
    aux = torch.mean(torch.sum(density * mean_prob, dim=-1)) * (e * e / k)
    touched = _touched_groups(row0, b, col0, s, seq, g)
    groups = len(touched) if ex.seq is None else max(
        len(_touched_groups(row0, b, t * s, s, seq, g))
        for t in range(seq // s))
    lookup = torch.full((touched[-1] - touched[0] + 1,), -1,
                        dtype=torch.long)
    lookup[torch.tensor(touched) - touched[0]] = torch.arange(len(touched))
    tok = (torch.arange(row0, row0 + b)[:, None] * seq
           + torch.arange(col0, col0 + s)[None, :])
    group = lookup[tok // g - touched[0]].to(x.device)
    return Routed(probs, idx, gates, pos, pos < cap, group, groups, cap,
                  fsdp.scale_grad(aux, float(ex.dp)))


def _experts(p, xin: torch.Tensor) -> torch.Tensor:
    """The experts' MLPs on their buffers xin (E', rows, d) with the
    leaves of `p` (E' experts; all of d_ff or a block of it): gate and up
    f32 products, silu(gate) * up in xin's dtype, then `wo`."""
    dt = xin.dtype
    hg = common.bmm_f32(xin, p.wi_gate.to(dt))
    hu = common.bmm_f32(xin, p.wi_up.to(dt))
    if torch.is_grad_enabled() and hg.requires_grad:
        h = (F.silu(hg) * hu).to(dt)
    else:
        h = F.silu(hg, inplace=True).mul_(hu).to(dt)
    del hg, hu
    return torch.bmm(h, p.wo.to(dt))


def dispatch_combine(p, x, idx, gates, keep, pos, group, groups: int,
                      cap: int, e: int, ep=None, local=None,
                      cast: bool = True):
    """x (n, d) through the experts: each kept pair's row copied into its
    expert's buffer of the (E, groups, C) layout at (its group, its
    position), the experts applied, each token's output the sum over its
    k slots of the gate (rounded to x's dtype) times its row, in f32,
    cast once -> (n, d). With `ep` (the `model` group over which the
    experts are split, E / m a rank in order) the buffers travel to the
    experts' owners and back by all-to-alls."""
    n, d = x.shape
    k = idx.shape[-1]
    dt = x.dtype
    rows = e * groups * cap
    # buffer row of each kept pair; dropped pairs go to a spare row past
    # the end, which is discarded
    slot = torch.where(keep, (idx * groups + group[:, None]) * cap + pos,
                       rows)
    tok = torch.arange(n, device=x.device)[:, None].expand(n, k)
    src = torch.full((rows + 1,), n, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    if local is not None:
        gc = groups * cap
        a, b = local[0] * gc, (local[0] + local[1]) * gc
        yo = _experts(p, x_pad[src[a:b]].view(local[1], gc, d))
        yo_pad = yo.new_zeros((rows + 1, d))
        yo_pad[a:b] = yo.reshape(-1, d)
        return _combine(yo_pad, slot, gates, k, dt, cast)
    xin = x_pad[src[:rows]].view(e, groups * cap, d)
    if ep is None:
        yo = _experts(p, xin)
    else:
        m = dist.get_world_size(ep)
        # (m owners, E/m, rows, d) -> each owner's experts' rows from the
        # m sources, (E/m, m * rows, d)
        got = fsdp.exchange(xin.reshape(m, e // m, groups * cap, d), ep)
        yo = _experts(p, got.transpose(0, 1).reshape(e // m, -1, d))
        yo = fsdp.exchange(yo.reshape(e // m, m, groups * cap, d)
                           .transpose(0, 1), ep)
    yo_pad = torch.cat([yo.reshape(rows, d), yo.new_zeros(1, d)])
    return _combine(yo_pad, slot, gates, k, dt, cast)


def _combine(yo_pad, slot, gates, k: int, dt, cast: bool = True):
    """Each token's output: the sum over its k slots of the gate (rounded
    to `dt`) times its buffer row, in f32, cast to `dt` once (unless not
    `cast`)."""
    w = gates.to(dt).to(torch.float32)
    out = None
    for j in range(k):
        term = w[:, j:j + 1] * yo_pad[slot[:, j]].to(torch.float32)
        out = term if out is None else out + term
    return out.to(dt) if cast else out


def moe_block(p, x: torch.Tensor, cfg: ModelConfig,
              group_size: int = GROUP_SIZE, exchange: Exchange | None = None,
              ep=None):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux 0-d f32); `p` holds
    `moe_defs`' leaves. Differentiable under autograd; with grad off the
    f32 gate buffer is updated in place. Over a mesh, `exchange` places
    x's tokens in the microbatch (`route_exchanged`) and `ep` is the
    `model` group when `p`'s experts are split over it: the buffers are
    padded to the most groups that any of its ranks' tokens touch."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    if exchange is None:
        r = route(p, x, cfg, group_size)
        ng = r.idx.shape[0]
        group = torch.arange(ng, device=x.device).repeat_interleave(
            n // ng)
        out = dispatch_combine(p, x.reshape(n, d), r.idx.reshape(n, k),
                                r.gates.reshape(n, k),
                                r.keep.reshape(n, k), r.pos.reshape(n, k),
                                group, ng, r.capacity, e)
        aux = torch.mean(torch.sum(r.density * r.probs.mean(dim=1),
                                   dim=-1)) * (e * e / k)
        return out.reshape(b, s, d), aux
    r = route_exchanged(p, x, cfg, group_size, exchange)
    out = dispatch_combine(p, x.reshape(n, d), r.idx.reshape(n, k),
                            r.gates.reshape(n, k), r.keep.reshape(n, k),
                            r.pos.reshape(n, k), r.group.reshape(n),
                            r.groups, r.capacity, e, ep)
    return out.reshape(b, s, d), r.aux
