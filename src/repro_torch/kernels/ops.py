"""The kernel seam of the port: the counterpart of `repro.kernels.ops`.

The reference picks a lowering with a `kernel_impl` knob. The port has
none: every op here dispatches by the device of the tensors it is given.
A CPU tensor takes the plain PyTorch version (`kernels/ref.py`); a CUDA
tensor launches the hand-written kernel or raises. Nothing falls back,
so the card never runs the plain version of a kernel in its place.

Call sites on the main path:
  - `sigmoid_grad`      computeGradients map body (core.dpmr step fns)
  - `owner_accumulate`  the reverse-shuffle add on the owner, as sort +
                        `segment_sum_sorted` run totals + one scatter of
                        the totals (api.strategies.AllToAllStrategy.reduce)

Each kernel wrapper keeps a plain-int launch counter; `launch_counts()`
reads them and `reset_launch_counts()` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import sigmoid_grad as _sg

INT32_MAX = 2 ** 31 - 1

sigmoid_grad = _sg.sigmoid_grad
segment_sum_sorted = _ss.segment_sum_sorted


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"sigmoid_grad": _sg.launches,
            "segment_sum_sorted": _ss.launches}


def reset_launch_counts() -> None:
    _sg.launches = 0
    _ss.launches = 0


def owner_accumulate(req_ids: torch.Tensor, grads: torch.Tensor,
                     acc_local: torch.Tensor, base: int) -> torch.Tensor:
    """The owner side of the gradient reduce, one add per unique feature.

    req_ids: (P, cap) int32 global ids received (-1 empty); grads: (P, cap)
    f32 sums aligned with them; acc_local: (rows,) f32 owner block, whose
    row 0 is global id `base`. Adds each feature's total into `acc_local`
    IN PLACE and returns it; ids outside [base, base + rows) and padding
    are dropped.

    As `repro.kernels.ops.owner_accumulate` on its Pallas path: a stable
    sort of the slots by id (padding keyed INT32_MAX, so it sorts last),
    the run totals of `segment_sum_sorted` (kernel on the card), then one
    scatter of those totals. Only run ends scatter a total, and run ends
    have distinct ids, so each owner row receives at most one nonzero
    add: the scatter is deterministic on the card although `index_add_`
    uses atomics. Slots that scatter nothing are sent to row 0 with +0.0,
    which leaves any value but -0.0 unchanged.
    """
    rows = acc_local.shape[0]
    ids = req_ids.reshape(-1)
    valid = ids >= 0
    g = torch.where(valid, grads.reshape(-1), 0.0)
    key_s, order = torch.sort(torch.where(valid, ids, INT32_MAX),
                              stable=True)
    ids_s = torch.where(key_s == INT32_MAX, -1, key_s)
    totals = segment_sum_sorted(ids_s.contiguous(), g[order].contiguous())
    nxt = torch.cat([ids_s[1:], ids_s.new_full((1,), -1)])
    local = ids_s - base
    scatter = (ids_s >= 0) & (ids_s != nxt) & (local >= 0) & (local < rows)
    return acc_local.index_add_(0, torch.where(scatter, local, 0),
                                torch.where(scatter, totals, 0.0))
