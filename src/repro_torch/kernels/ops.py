"""The kernel seam of the port: the counterpart of `repro.kernels.ops`.

The reference picks a lowering with a `kernel_impl` knob. The port has
none: every op here dispatches by the device of the tensors it is given.
A CPU tensor takes the plain PyTorch version (`kernels/ref.py`); a CUDA
tensor launches the hand-written kernel or raises. Nothing falls back,
so the card never runs the plain version of a kernel in its place.

Call sites on the main path:
  - `sigmoid_grad`      computeGradients map body (core.dpmr step fns)
  - `owner_accumulate`  the reverse-shuffle add on the owner, as
                        `sorted_run_totals` + one scatter of the totals
                        (every strategy's dense reduce, and the dense
                        accumulate of allgather/psum_scatter/
                        compressed_reduce)
  - `sorted_run_totals` also the hot-set gradient (core.dpmr.hot_grads),
                        and alone a2a's and overlap_a2a's row reduce
                        (api.strategies.AllToAllStrategy.reduce_rows)
  - `segment_sum_sorted` the sorted reduce under both, and the combiner
                        `core.sparse.combine_grads` on the routing's order;
                        one CUDA kernel a call (a single-pass scan)
  - `select_pack`       topk_reduce's compensate + rank + pack
                        (api.strategies.TopKReduceStrategy.reduce); one
                        cluster kernel a call at the main path's shapes
  - `flash_attention`   the dense face's prefill self-attention, once per
                        layer (models.layers.causal_self_attention)
  - `row_update`        the sparse optimizer (sgd, adagrad) over the rows
                        of a `RowGrad`, `sorted_run_totals`' run ends
                        (optim.optimizers' row updates, on train_step's
                        row path: a2a and overlap_a2a)

Each kernel wrapper counts its launches in the `obs` counter
`launch.<kernel>`; `launch_counts()` reads them and
`reset_launch_counts()` sets them to 0. `sigmoid_grad`,
`segment_sum_sorted`, `sorted_run_totals` and `owner_accumulate` open the
`obs` spans `seam.<name>` at the seam's top level only: a seam function
called inside another opens none.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import row_update as _ru
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import select_pack as _sp
from repro_torch.kernels import sigmoid_grad as _sg

INT32_MAX = 2 ** 31 - 1

KERNELS = ("sigmoid_grad", "segment_sum_sorted", "select_pack",
           "flash_attention", "row_update")


def _seam(name: str):
    return obs.spanned(f"seam.{name}", group="seam")


sigmoid_grad = _seam("sigmoid_grad")(_sg.sigmoid_grad)
segment_sum_sorted = _seam("segment_sum_sorted")(_ss.segment_sum_sorted)
select_pack = _sp.select_pack
flash_attention = _fa.flash_attention
row_update = _ru.row_update


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    got = obs.counts("launch.")
    return {k: int(got.get(f"launch.{k}", 0)) for k in KERNELS}


def reset_launch_counts() -> None:
    obs.reset_counts("launch.")


@_seam("sorted_run_totals")
def sorted_run_totals(ids: torch.Tensor, grads: torch.Tensor):
    """Each distinct id's sum of `grads`, by a sorted reduce.

    ids: any shape, int32, negative = padding; grads: f32, same number of
    elements. A stable sort by id (padding keyed INT32_MAX, so it sorts
    last), then the run totals of `segment_sum_sorted` (kernel on the
    card). Returns (ids_s, totals, end), each (N,): the sorted ids with
    padding as -1, each run's total at its last slot (0 elsewhere), and
    True at the last slot of each run of a real id. The run ends hold
    distinct ids, so a scatter of their totals writes each target once.
    """
    ids = ids.reshape(-1)
    key_s, order = torch.sort(torch.where(ids >= 0, ids, INT32_MAX),
                              stable=True)
    ids_s = torch.where(key_s == INT32_MAX, -1, key_s)
    totals = segment_sum_sorted(ids_s.contiguous(),
                                grads.reshape(-1)[order].contiguous())
    nxt = torch.cat([ids_s[1:], ids_s.new_full((1,), -1)])
    return ids_s, totals, (ids_s >= 0) & (ids_s != nxt)


class RowGrad(NamedTuple):
    """A reduce's gradient as the run totals of its received ids: the
    `ids_s` and `totals` of `sorted_run_totals`, and the global id of the
    owner block's row 0. The rows it names are the run ends' ids - `base`
    inside the block (`written`), each with its total; every other row's
    gradient is +0.0. `row_update` applies it."""

    ids: torch.Tensor        # (N,) int32 sorted ascending, padding -1 last
    totals: torch.Tensor     # (N,) f32 each run's total at its last slot
    base: int

    def written(self, rows: int) -> torch.Tensor:
        """(N,) bool: the slots whose row `row_update` writes in a block
        of `rows` rows."""
        return ref.row_update_slots(self.ids, self.base, rows)


@_seam("owner_accumulate")
def owner_accumulate(req_ids: torch.Tensor, grads: torch.Tensor,
                     acc_local: torch.Tensor, base: int) -> torch.Tensor:
    """The owner side of the gradient reduce, one add per unique feature.

    req_ids: (P, cap) int32 global ids received (-1 empty); grads: (P, cap)
    f32 sums aligned with them; acc_local: (rows,) f32 owner block, whose
    row 0 is global id `base`. Adds each feature's total into `acc_local`
    IN PLACE and returns it; ids outside [base, base + rows) and padding
    are dropped.

    As `repro.kernels.ops.owner_accumulate` on its Pallas path: the run
    totals of `sorted_run_totals`, then one scatter of those totals. Only
    run ends scatter a total, and run ends have distinct ids, so each
    owner row receives at most one nonzero add: the scatter is
    deterministic on the card although `index_add_` uses atomics. Slots
    that scatter nothing are sent to row 0 with +0.0, which leaves any
    value but -0.0 unchanged. The rows that receive a total are counted
    in `optimizer.rows_given_grad` while tracing is on.
    """
    rows = acc_local.shape[0]
    ids_s, totals, end = sorted_run_totals(req_ids, grads)
    local = ids_s - base
    scatter = end & (local >= 0) & (local < rows)
    obs.count_device("optimizer.rows_given_grad", scatter)
    return acc_local.index_add_(0, torch.where(scatter, local, 0),
                                torch.where(scatter, totals, 0.0))
