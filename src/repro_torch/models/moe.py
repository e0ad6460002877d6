"""Mixture-of-Experts FFN with group-limited top-k dispatch (counterpart
of `repro.models.moe`).

Tokens are split into groups of `group_size` (`g = min(group_size,
B * S)`, which must divide B * S). Within a group each token picks its
top-k experts from the router's softmax, and each (token, slot) pair
gets a position in its expert's buffer of C = `expert_capacity` rows by
a running count over the group's pairs, token-major and slot-minor; a
pair whose position is C or more is dropped. A dropped pair adds
nothing to its token's output.

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

The reference's expert-parallel sharding constraints are a no-op
outside a mesh; on one card there is none (ROADMAP A12, Distribution).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def route(p, x: torch.Tensor, cfg: ModelConfig,
          group_size: int = GROUP_SIZE) -> Routing:
    """The router of `moe_block`: logits as an f32 product of x.dtype
    operands, softmax in f32, top-k by a stable descending sort, gates
    renormalised with max(sum, 1e-9), capacity positions and the kept
    mask. Raises ValueError when g does not divide B * S."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    g = min(group_size, n)
    if n % g:
        raise ValueError(f"{n} tokens (B={b} x S={s}) do not split into "
                         f"MoE groups of {g}")
    ng = n // g
    logits = common.dot_f32(x.reshape(ng, g, d), p.router.to(x.dtype))
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(idx, e).reshape(ng, g * k, e)
    pos = torch.gather(torch.cumsum(flat, dim=1) - 1, -1,
                       idx.reshape(ng, g * k, 1)).reshape(ng, g, k)
    cap = expert_capacity(cfg, g)
    return Routing(probs, idx, gates, pos, pos < cap,
                   flat.to(torch.float32).mean(dim=1), cap)


def moe_block(p, x: torch.Tensor, cfg: ModelConfig,
              group_size: int = GROUP_SIZE):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux 0-d f32); `p` holds
    `moe_defs`' leaves. Differentiable under autograd; with grad off the
    f32 gate buffer is updated in place."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dt = x.dtype
    r = route(p, x, cfg, group_size)
    ng, g, _ = r.idx.shape
    cap = r.capacity
    n, rows = b * s, e * ng * cap
    # buffer row of each kept pair in the (E, groups, C) layout; dropped
    # pairs go to a spare row past the end, which is discarded
    group = torch.arange(ng, device=x.device)[:, None, None]
    slot = torch.where(r.keep, (r.idx * ng + group) * cap + r.pos, rows)
    slot = slot.reshape(n, k)
    tok = torch.arange(n, device=x.device)[:, None].expand(n, k)
    src = torch.full((rows + 1,), n, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    x_pad = torch.cat([x.reshape(n, d), x.new_zeros(1, d)])
    xin = x_pad[src[:rows]].view(e, ng * cap, d)

    hg = common.bmm_f32(xin, p.wi_gate.to(dt))
    hu = common.bmm_f32(xin, p.wi_up.to(dt))
    if torch.is_grad_enabled() and hg.requires_grad:
        h = (F.silu(hg) * hu).to(dt)
    else:
        h = F.silu(hg, inplace=True).mul_(hu).to(dt)
    del hg, hu
    yo = torch.bmm(h, p.wo.to(dt)).reshape(rows, d)
    yo_pad = torch.cat([yo, yo.new_zeros(1, d)])
    w = r.gates.reshape(n, k).to(dt).to(torch.float32)
    out = None
    for j in range(k):
        term = w[:, j:j + 1] * yo_pad[slot[:, j]].to(torch.float32)
        out = term if out is None else out + term
    aux = torch.mean(torch.sum(r.density * r.probs.mean(dim=1), dim=-1)) \
        * (e * e / k)
    return out.to(dt).reshape(b, s, d), aux
