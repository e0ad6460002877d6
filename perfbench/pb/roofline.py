"""The yardstick's arithmetic: the card's data-sheet peaks, the least
time of a piece of work, the bytes and operations of the sparse step
and of each call of the kernel seam, and the dense step's model FLOPs.

The peaks are copies of NVIDIA's H100 SXM data sheet (the figures
`repro_torch/configs/base.py` keeps), held here so that the yardstick
does not move when the program does. They assume the full power limit
of 700 W; each run prints the card's limit beside its numbers.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # HBM3
F32_FLOPS = 67e12             # f32 outside the tensor cores
BF16_TC_FLOPS = 989e12        # bf16 tensor cores, dense
SECTOR_BYTES = 32             # the least the memory moves for a scattered 4 B


def least_time_s(nbytes: float, nflops: float,
                 peak_flops: float = F32_FLOPS) -> float:
    """The least time the work needs on the card: the larger of its
    bytes over the memory rate and its operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, nflops / peak_flops)


# --- the sparse step --------------------------------------------------------


def sparse_step_work(rows: int, k: int, nnz: int, unique: int
                     ) -> tuple[int, int]:
    """(bytes, FLOPs) that one step of sparse logistic regression with
    adagrad needs, whatever implements it: the batch's ids, values
    (rows x k, 4 B each) and labels (4 B a row) read once, and each
    parameter and adagrad row that the batch touches (`unique` of them)
    read and written once (16 B). FLOPs: a multiply-add for each of the
    `nnz` real slots in the logit and again in its gradient, and 6 for
    each touched row's adagrad update (g^2, the add, the eps add, the
    reciprocal square root, two products and the subtraction counted as
    one with the last product). Rows the batch does not touch keep their
    bits under adagrad with eps > 0, so they need no pass."""
    nbytes = 8 * rows * k + 4 * rows + 16 * unique
    nflops = 4 * nnz + 6 * unique
    return nbytes, nflops


# --- the kernel seam (`repro_torch.kernels.ops`) ---------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def seam_call_work(name: str, args: tuple, out, touched: int | None = None
                   ) -> tuple[int, int]:
    """(bytes, FLOPs) of one call of a seam function, from the shapes of
    its arguments and results: each input byte read once, each output
    byte written once. `owner_accumulate` adds into its target in place:
    its output is the `touched` rows it adds to, read and written once
    (4 B each way), not the whole target. `row_update` reads each slot's
    id, the id after it (which the slot compares) and its total (12 B),
    and reads and writes each of the `touched` rows it writes in the
    weights and, under adagrad, the accumulator: scattered rows, so a
    32 B sector each way and each array (128 B a row under adagrad).
    FLOPs: sigmoid_grad's logit and gradient (a multiply-add each a slot);
    one add for each summed element of the reduces; adagrad's 6 a written
    row (`sparse_step_work`'s count), sgd's 2."""
    if name == "sigmoid_grad":
        vals, theta, labels = args[:3]
        nbytes = _nbytes(vals) + _nbytes(theta) + _nbytes(labels) + sum(
            _nbytes(t) for t in out)
        return nbytes, 4 * vals.numel()
    if name == "segment_sum_sorted":
        ids, grads = args[:2]
        return _nbytes(ids) + _nbytes(grads) + _nbytes(out), grads.numel()
    if name == "sorted_run_totals":
        ids, grads = args[:2]
        return _nbytes(ids) + _nbytes(grads) + sum(
            _nbytes(t) for t in out), grads.numel()
    if name == "owner_accumulate":
        req_ids, grads = args[:2]
        if touched is None:
            raise ValueError("owner_accumulate needs the rows it touched")
        return _nbytes(req_ids) + _nbytes(grads) + 8 * touched, \
            grads.numel()
    if name == "row_update":
        kind, ids_s = args[0], args[3]
        if touched is None:
            raise ValueError("row_update needs the rows it wrote")
        arrays = 2 if kind == "adagrad" else 1
        return 12 * ids_s.numel() + 2 * SECTOR_BYTES * arrays * touched, \
            (6 if kind == "adagrad" else 2) * touched
    raise KeyError(f"no work count for seam function {name!r}")


# --- the dense step ----------------------------------------------------------


def dense_model_flops(n_product_params: int, layers: int, heads: int,
                      head_dim: int, batch: int, seq: int) -> int:
    """A training step's model FLOPs for a decoder-only transformer (the
    arithmetic of `chip_smoke.model_flops`, with the input embedding left
    out, since its lookup is a gather and no product): 6 N tokens for
    the N parameters that enter products, plus the forward and backward
    (3x the forward) of causal self-attention, 4 hd FLOPs a head and
    visible (query, key) pair. Recomputation is not counted."""
    tokens = batch * seq
    causal_pairs = batch * seq * (seq + 1) // 2
    return 6 * n_product_params * tokens + 3 * 4 * head_dim * heads * \
        layers * causal_pairs
