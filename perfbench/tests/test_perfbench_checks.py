"""The comparison that decides `correct`, driven through the harness on
the CPU at a small size (the look for a card skipped): the program comes
out correct; with the timed path broken underneath (each fault a cell
can have) and in the control's place (the reference in the precision
below the configuration's), it comes out not correct. Each cell's own
limits (`perfbench/limits/`) are the ones held."""
from __future__ import annotations

import math

import pytest

from pb import cells, compare

SPARSE = "dpmr-lr-13x2e27.sgd-b65536"
DENSE = "yi-6b-l4.train-4x4096"
FAULTS = ("fault:unchanged", "fault:half_batch", "fault:altered")


@pytest.mark.parametrize("workload", [SPARSE, DENSE])
def test_the_program_comes_out_correct(small_ctx, workload):
    out = cells.run(small_ctx(workload, trace=True))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 3 and out["failed"] == 0
    assert out["e2e"]["setup_s"] > 0
    assert out["layer"]["traced_steps"] >= 1


@pytest.mark.parametrize("workload", [SPARSE, DENSE])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_comes_out_not_correct(small_ctx, workload, fault):
    out = cells.run(small_ctx(workload, variant=fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", [SPARSE, DENSE])
def test_the_control_comes_out_not_correct(small_ctx, workload):
    ctx = small_ctx(workload)
    rows = cells.run(ctx, "calibrate", ([ctx.seed], ["control"]))
    nums = {k: v for k, v in rows[0].items()
            if k in ctx.cell.limits}
    ok, checks = compare.judge(nums, ctx.cell.limits)
    assert not ok, checks


def test_a_number_without_a_limit_or_not_finite_fails():
    ok, checks = compare.judge({"loss_gap": 0.0}, {})
    assert not ok and checks["loss_gap"]["limit"] is None
    assert not compare.judge({"loss_gap": math.nan}, {"loss_gap": 1.0})[0]
    assert compare.judge({"loss_gap": 0.5}, {"loss_gap": 1.0})[0]


def test_gaps_are_taken_by_the_worst_leaf_against_the_median():
    ref = {"a": 1.0, "b": 10.0, "c": 1e-9}
    prog = {"a": 1.5, "b": 10.0, "c": 2e-9}
    # leaf a: 0.5 / max(1, median 1) = 0.5; leaf c: 1e-9 / 1 -> tiny
    assert compare.norm_gap(prog, ref) == pytest.approx(0.5)
    assert compare.moving_leaves(ref) == ["a", "b"]
    nums = compare.training_numbers(
        {"losses": [1.0, 2.0], "grad_norms": ref, "change_norms": prog},
        {"losses": [1.0, 2.2], "grad_norms": ref, "change_norms": ref})
    assert nums["loss_gap"] == pytest.approx(0.2 / 2.2)
    assert nums["grad_norm_gap"] == 0.0
    assert nums["update_norm_gap"] == pytest.approx(0.5)
