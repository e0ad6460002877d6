"""Sparse batch format + feature routing math: the counterpart of
`repro.core.sparse`.

Pure per-device math with no collectives. Terminology maps to the paper:
  - `route_build`    = invertDocuments + the combiner's dedup + the
                       shuffle layout of distributeParameters.
  - `route_return`   = restoreDocuments.
  - `combine_grads`  = computeGradients' combiner (sum per feature before
                       the reduce-side shuffle).

`route_build`, `owner_apply`, `route_return` and `combine_grads` run
inside the `obs` spans `routing.<name>`.

Feature ownership is contiguous-block: owner(f) = f // block_size, so one
sort by feature id groups by owner and makes duplicates adjacent.

Batches are padded CSR: ids (B, K) int32 with -1 padding, vals (B, K) f32,
labels (B,) int32.

The reference's `.at[...].set/add(mode="drop")` writes become index writes
into a buffer one row longer than the target, where every dropped index
points; the extra row is cut off afterwards. That keeps the step free of
host synchronisation (no boolean-mask compaction). Gathers clamp their
indices, as JAX's do, and the clamped values are masked.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import ops

INT32_MAX = 2 ** 31 - 1


class Routing(NamedTuple):
    """Static-shape routing plan for one device's feature slots."""

    req_ids: torch.Tensor      # (P, cap) int32, -1 = empty
    order: torch.Tensor        # (n,) int64 argsort-by-id (sorted <- orig)
    owner_s: torch.Tensor      # (n,) int32 owner of each sorted slot (P = pad)
    pos_s: torch.Tensor        # (n,) int32 capacity slot of the slot's run
    keep_s: torch.Tensor       # (n,) bool: run fits in capacity and is real
    start_idx_s: torch.Tensor  # (n,) int32 sorted index of the run start
    overflow: torch.Tensor     # () int32: dropped unique features


@obs.spanned("routing.route_build")
def route_build(ids_flat: torch.Tensor, num_shards: int, block_size: int,
                cap: int) -> Routing:
    """Build the request plan. ids_flat: (n,) int32 with -1 for padding."""
    n = ids_flat.shape[0]
    dev = ids_flat.device
    valid = ids_flat >= 0
    owner = torch.where(valid, torch.div(ids_flat, block_size,
                                         rounding_mode="floor"), num_shards)
    # sort by id; padding (-1) would sort first, so key it INT32_MAX
    ids_s, order = torch.sort(torch.where(valid, ids_flat, INT32_MAX),
                              stable=True)
    owner_s = owner[order]
    valid_s = valid[order]

    one = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([one, ids_s[1:] != ids_s[:-1]]) & valid_s
    u = torch.cumsum(is_start, 0, dtype=torch.int32)   # runs up to & incl. i
    # owner o's first sorted index
    owner_first = torch.searchsorted(
        owner_s, torch.arange(num_shards, dtype=torch.int32, device=dev),
        side="left", out_int32=True)
    of_c = torch.clamp(owner_first, 0, n - 1)
    runs_before_owner = u[of_c] - is_start[of_c].to(torch.int32)
    runs_before_owner = torch.where(owner_first >= n, u[-1],
                                    runs_before_owner)
    # capacity slot of each element's run, within its owner
    pos_s = (u - 1) - runs_before_owner[torch.clamp(owner_s, 0,
                                                    num_shards - 1)]
    keep_s = valid_s & (pos_s < cap)

    # unique run-start ids into the request matrix; the rest to row P
    put = is_start & keep_s
    flat = torch.where(put, owner_s * cap + pos_s, num_shards * cap)
    req = torch.full(((num_shards + 1) * cap,), -1, dtype=torch.int32,
                     device=dev)
    req[flat.to(torch.int64)] = torch.where(put, ids_s, -1)
    req = req[:num_shards * cap].view(num_shards, cap)

    # run-start sorted index for every slot (to copy responses to duplicates)
    start_idx = torch.where(is_start,
                            torch.arange(n, dtype=torch.int32, device=dev),
                            -1)
    start_idx_s = torch.cummax(start_idx, 0).values

    overflow = u[-1] - torch.sum(put, dtype=torch.int32)
    return Routing(req, order, owner_s, pos_s, keep_s, start_idx_s,
                   overflow)


@obs.spanned("routing.route_return")
def route_return(routing: Routing, resp: torch.Tensor) -> torch.Tensor:
    """Map responses (P, cap) back to the original slot layout (n,).

    resp[o, c] is the value for the c-th unique feature requested from
    owner o. Every duplicate slot copies its run start's response;
    padding/overflow slots get 0.
    """
    n = routing.order.shape[0]
    p, cap = resp.shape
    gathered = resp[torch.clamp(routing.owner_s, 0, p - 1),
                    torch.clamp(routing.pos_s, 0, cap - 1)]
    gathered = torch.where(routing.keep_s, gathered, 0.0)
    start_vals = gathered[torch.clamp(routing.start_idx_s, 0, n - 1)]
    vals_sorted = torch.where(routing.keep_s, start_vals, 0.0)
    out = torch.empty((n,), dtype=resp.dtype, device=resp.device)
    out[routing.order] = vals_sorted          # a permutation: no collisions
    return out


@obs.spanned("routing.combine_grads")
def combine_grads(routing: Routing, grads_flat: torch.Tensor
                  ) -> torch.Tensor:
    """Combiner: sum per-slot grads by feature -> (P, cap) send buffer.

    grads_flat: (n,) in the ORIGINAL slot layout. Output aligns with the
    request matrix (owner, capacity-slot). The sums run through the
    routing's sorted order, where each feature's slots are one run:
    `kernels.ops.segment_sum_sorted` (the kernel on the card) totals each
    run at its last slot, and each kept run's total is written once into
    its own (owner, capacity-slot) entry. No entry is written twice, so
    the result is bit-reproducible on the card.

    The run id of a sorted slot is its run start's sorted index; padding
    (owner P) is -1 and already sorts last. Slots of overflowed runs keep
    their run ids (at P > 1 they lie mid-array) and add 0.
    """
    p, cap = routing.req_ids.shape
    run = torch.where(routing.owner_s == p, -1, routing.start_idx_s)
    g_sorted = torch.where(routing.keep_s, grads_flat[routing.order], 0.0)
    totals = ops.segment_sum_sorted(run.contiguous(), g_sorted.contiguous())
    last = torch.cat([run[1:] != run[:-1],
                      torch.ones((1,), dtype=torch.bool, device=run.device)])
    put = routing.keep_s & last
    flat = torch.where(put, routing.owner_s * cap + routing.pos_s, p * cap)
    send = torch.zeros(((p + 1) * cap,), dtype=grads_flat.dtype,
                       device=grads_flat.device)
    send[flat.to(torch.int64)] = totals
    return send[:p * cap].view(p, cap)


@obs.spanned("routing.owner_apply")
def owner_apply(req_ids: torch.Tensor, table_local: torch.Tensor,
                base: int) -> torch.Tensor:
    """Owner side of distributeParameters: look up requested rows.

    req_ids: (P, cap) global ids (-1 empty); table_local: (rows,);
    base: global id of local row 0. Returns (P, cap) values.
    """
    local = torch.clamp(req_ids - base, 0, table_local.shape[0] - 1)
    return torch.where(req_ids >= 0, table_local[local], 0.0)


def owner_accumulate(req_ids: torch.Tensor, grads: torch.Tensor,
                     acc_local: torch.Tensor, base: int) -> torch.Tensor:
    """Owner side of the gradient reduce as a plain scatter-add of the
    received slots (the reference's XLA path), kept as the oracle of
    `kernels.ops.owner_accumulate`. Adds into `acc_local` IN PLACE and
    returns it; ids outside the owner block and padding are dropped (sent
    to row 0 with +0.0, which leaves any value but -0.0 unchanged)."""
    rows = acc_local.shape[0]
    local = (req_ids - base).reshape(-1)
    keep = (req_ids.reshape(-1) >= 0) & (local >= 0) & (local < rows)
    return acc_local.index_add_(0, torch.where(keep, local, 0),
                                torch.where(keep, grads.reshape(-1), 0.0))
