"""The comparison that decides `correct` for a training cell.

The program and the reference each give, for the first steps of a run
from the same inputs: each step's loss, the first gradient's norm by
leaf (as the optimizer got it) and each leaf's change after the last
step. Three numbers come of them:

  loss_gap         the largest |L_prog - L_ref| / |L_ref| over the steps
  grad_norm_gap    the worst leaf's |G_prog - G_ref| / max(G_ref, the
                   median leaf's G_ref)
  update_norm_gap  the same for the norms of the leaves' changes, over
                   the leaves whose reference gradient is at least a
                   thousandth of the median leaf's (a leaf with a
                   gradient nought to rounding moves under adam by
                   round-off alone)

Each is held against its limit (`perfbench/limits/<cell>.json`); a
number that is not finite fails. Cells may add exact counts (a limit of
0), such as the sparse cells' hot-set mismatch.
"""
from __future__ import annotations

import math
import statistics

TINY_GRAD = 1e-3     # of the median leaf's reference gradient norm


def norm_gap(prog: dict, ref: dict, leaves=None) -> float:
    leaves = sorted(ref) if leaves is None else sorted(leaves)
    if set(prog) != set(ref):
        return math.inf
    med = statistics.median(ref.values())
    worst = 0.0
    for k in leaves:
        base = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / base if base > 0 else (
            0.0 if prog[k] == ref[k] else math.inf)
        worst = max(worst, gap)
    return worst


def moving_leaves(ref_grad_norms: dict) -> list:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, g in ref_grad_norms.items() if g >= TINY_GRAD * med]


def training_numbers(prog: dict, ref: dict) -> dict:
    """The three gaps of a program's readings against the reference's."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_norm_gap": norm_gap(prog["grad_norms"], ref["grad_norms"]),
            "update_norm_gap": norm_gap(
                prog["change_norms"], ref["change_norms"],
                moving_leaves(ref["grad_norms"]))}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit. A number with no limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
