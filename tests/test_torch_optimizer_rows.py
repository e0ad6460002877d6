"""`train_step`'s row path against the dense route, on the CPU.

On the row path a reduce hands its run totals to the optimizer's row
update (`kernels.ops.RowGrad`, `kernels.ops.row_update`) and no
(F/P,) gradient is made. For every registered strategy x {sgd, adagrad,
momentum}, the state after each of three `train_step`s must equal, bit for
bit (the int32 views, so -0.0 and +0.0 differ), a step built from the
strategy's dense `reduce` and the registry's dense update on a copy of the
same state: at P = 1, and for a2a and overlap_a2a over 4 gloo ranks of one
`mp.spawn` (tests/torch_mesh_harness.py). The path counters say which
route ran: a2a and overlap_a2a with sgd or adagrad make one row update a
step (the table) and one dense update (the hot set); every other pair
makes two dense updates. The table starts from N(0, 1) draws with some
rows at -0.0 and the accumulators at |N(0, 1)| with some rows at 0, so a
row the update should leave alone would show any change to its bits.
"""
import json
import time

import pytest
import torch

import torch_mesh_harness as mh
from repro_torch import DPMRConfig, get_source, obs
from repro_torch.api import hot_ids_from_corpus
from repro_torch.api.engine import put_batch
from repro_torch.api.strategies import (AllToAllStrategy, _exact_reduce,
                                       _psum, get_strategy, has_row_reduce,
                                       list_strategies)
from repro_torch.core import dpmr
from repro_torch.kernels import ops
from repro_torch.optim import optimizers

F, K, B, MAX_HOT, STEPS = 1 << 10, 8, 32, 8, 3
ROW_PATH = {"a2a", "overlap_a2a"}
OPTIMIZERS = ("sgd", "adagrad", "momentum")
FIELDS = ("cold", "hot", "cold_acc", "hot_acc", "step", "strat")


def _cfg(dist_name: str, opt: str, **kw) -> DPMRConfig:
    return DPMRConfig(num_features=F, max_features_per_sample=K,
                      max_hot=MAX_HOT, learning_rate=0.5,
                      hot_threshold=0.01, optimizer=opt,
                      distribution=dist_name, topk_frac=0.25, **kw)


def _batches(seed: int = 0) -> list:
    src = get_source("zipf_sparse", batch_size=B, num_batches=STEPS + 1,
                     num_features=F, features_per_sample=K, seed=seed)
    return [src.batch(i) for i in range(STEPS + 1)]


def _fill(state, seed: int) -> None:
    """Random table and accumulators, some rows at -0.0 and at 0."""
    g = torch.Generator().manual_seed(seed)
    for t, acc in ((state.cold, state.cold_acc), (state.hot, state.hot_acc)):
        t.copy_(torch.randn(t.shape, generator=g))
        t[::7] = -0.0
        acc.copy_(torch.randn(acc.shape, generator=g).abs())
        acc[::5] = 0.0


def _clone(state) -> dpmr.DPMRState:
    return dpmr.DPMRState(*(t.clone() for t in state))


def dense_step(fns, cfg, state, batch) -> None:
    """One train step by the dense route: the strategy's `reduce` into a
    (F/P,) gradient, the registry's dense update on the table and the hot
    set; the state IN PLACE."""
    strategy, ctx = get_strategy(fns.strategy), fns.ctx
    stateful = strategy.init_carry(ctx, device="meta") is not None
    theta, fwd, aux = dpmr._device_fwd(cfg, strategy, ctx, state.cold,
                                       state.hot, state.hot_ids,
                                       batch["ids"], batch["vals"])
    g, _, _ = ops.sigmoid_grad(batch["vals"], theta, batch["labels"])
    if cfg.grad_scale == "mean":
        g = g / g.new_full((), float(B))
    gflat = g.reshape(-1)
    if stateful:
        grad_cold, carry = strategy.reduce(
            ctx, state.cold, gflat,
            {**fwd, "carry": state.strat, "accumulate": False})
    else:
        grad_cold = strategy.reduce(ctx, state.cold, gflat, fwd)
        carry = state.strat
    assert isinstance(grad_cold, torch.Tensor) \
        and grad_cold.shape == state.cold.shape
    grad_hot = _psum(dpmr.hot_grads(cfg, gflat, aux["hot_slot"],
                                    aux["is_hot"]), ctx)
    if carry is not state.strat:
        state.strat.copy_(carry)
    lr = dpmr.make_schedule(cfg)(state.step)
    update = optimizers.get_sparse_optimizer(cfg.optimizer).update
    update(state.cold, state.cold_acc, grad_cold, lr, cfg)
    update(state.hot, state.hot_acc, grad_hot, lr, cfg)
    state.step.add_(1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _differing(a, b) -> list:
    """The state fields whose bits differ."""
    return [f for f in FIELDS
            if not torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f)))]


def run_pair(cfg, batches, mesh=None, seed: int = 0) -> dict:
    """STEPS train_steps and as many dense steps from one state: the fields
    that differ after each step, and the path counters of the
    train_steps."""
    fns = dpmr.make_step_fns(cfg, B, mesh=mesh)
    hot = hot_ids_from_corpus(cfg, batches[:2], device="cpu")
    state = dpmr.init_state(cfg, "cpu", hot, mesh=mesh)
    _fill(state, seed)
    ref, before = _clone(state), state.cold.clone()
    diffs = []
    obs.reset_counts("optimizer.")
    for b in batches[1:]:
        rb = put_batch(b, "cpu", mesh)
        state, _ = fns.train_step(state, rb)
        dense_step(fns, cfg, ref, rb)
        diffs.append(_differing(state, ref))
    got = obs.counts("optimizer.")
    return {"diffs": diffs,
            "row_updates": got.get("optimizer.row_updates", 0),
            "dense_updates": got.get("optimizer.dense_updates", 0),
            "table_changed": not torch.equal(_bits(state.cold),
                                             _bits(before))}


def _want_counts(dist_name: str, opt: str) -> tuple[int, int]:
    rows = dist_name in ROW_PATH and opt != "momentum"
    return (STEPS, STEPS) if rows else (0, 2 * STEPS)


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("dist_name", list_strategies())
def test_train_step_matches_the_dense_route(dist_name, opt):
    got = run_pair(_cfg(dist_name, opt), _batches())
    assert got["diffs"] == [[]] * STEPS
    assert got["table_changed"]
    assert (got["row_updates"], got["dense_updates"]) == \
        _want_counts(dist_name, opt)


def test_adagrad_without_eps_keeps_the_dense_pass():
    """At eps = 0 an untouched row with a zero accumulator turns NaN
    under the dense update (rsqrt(0) * 0), so the row path must not
    engage."""
    cfg = _cfg("a2a", "adagrad", adagrad_eps=0.0)
    assert optimizers.row_update(cfg) is None
    assert optimizers.row_update(_cfg("a2a", "adagrad")) is not None
    assert optimizers.row_update(_cfg("a2a", "momentum")) is None
    batches = _batches()
    fns = dpmr.make_step_fns(cfg, B)
    state = dpmr.init_state(cfg, "cpu", hot_ids_from_corpus(
        cfg, batches[:2], device="cpu"))
    obs.reset_counts("optimizer.")
    fns.train_step(state, put_batch(batches[1], "cpu"))
    assert obs.counts("optimizer.")["optimizer.dense_updates"] == 2
    assert "optimizer.row_updates" not in obs.counts("optimizer.")


def test_a_subclass_that_changes_reduce_has_no_row_reduce():
    """The row path engages only where the class that gives a strategy
    its `reduce` defines `reduce_rows` too: a subclass of a2a that changes
    `reduce` must not inherit a2a's row reduce, which would skip it."""

    class Scaled(AllToAllStrategy):
        name = "scaled_a2a"

        def reduce(self, ctx, cold_loc, grads_flat, fwd):
            return _exact_reduce(ctx, cold_loc, grads_flat, fwd) * 2.0

    assert {n for n in list_strategies()
            if has_row_reduce(get_strategy(n))} == ROW_PATH
    assert not has_row_reduce(Scaled())
    cfg = _cfg("a2a", "adagrad")
    batches = _batches()
    fns = dpmr.make_step_fns(cfg, B)
    state = dpmr.init_state(cfg, "cpu", hot_ids_from_corpus(
        cfg, batches[:2], device="cpu"))
    obs.reset_counts("optimizer.")
    fns.train_step(state, put_batch(batches[1], "cpu"))
    assert obs.counts("optimizer.")["optimizer.row_updates"] == 1


def test_row_grad_names_the_run_ends_inside_the_block():
    """`RowGrad.written`: the last slot of each run of a real id whose
    row lies in the block, as the row update writes them."""
    ids = torch.tensor([0, 2, 2, 3, 9, 9, 12, -1, -1], dtype=torch.int32)
    g = ops.RowGrad(ids, torch.zeros(9), 2)
    assert g.written(10).nonzero().flatten().tolist() == [2, 3, 5]
    assert g.written(2).nonzero().flatten().tolist() == [2, 3]
    assert not ops.RowGrad(ids[-2:], torch.zeros(2), 0).written(10).any()


def test_row_update_plain_version_leaves_other_rows_alone():
    """`ops.row_update` on the CPU: the rows that run ends name inside the
    block change, every other row keeps its bits; ids outside the block
    and padding are dropped; a total of -0.0 is the dense gradient's
    +0.0 and leaves a -0.0 row as it is; a float lr and a 0-d tensor
    agree."""
    ids = torch.tensor([0, 2, 2, 3, 9, 9, 12, -1, -1], dtype=torch.int32)
    totals = torch.tensor([5.0, 0, 1.5, -0.0, 0, 2.0, 4.0, 0, 0])
    theta0 = torch.arange(10, dtype=torch.float32)
    theta0[1] = -0.0
    outs = []
    for lr in (0.25, torch.tensor(0.25)):
        theta, acc = theta0.clone(), torch.ones(10)
        ops.row_update("adagrad", theta, acc, ids, totals, 2, lr, 1e-6)
        outs.append((theta, acc))
    (theta, acc), (theta2, acc2) = outs
    assert torch.equal(_bits(theta), _bits(theta2))
    assert torch.equal(_bits(acc), _bits(acc2))
    # base 2, 10 rows: id 0 lies below the block, id 12 past it; id 2 is
    # row 0 (1.5), id 3 row 1 (-0.0), id 9 row 7 (2.0)
    assert (_bits(theta) != _bits(theta0)).nonzero().flatten().tolist() \
        == [0, 7]
    assert (acc != 1.0).nonzero().flatten().tolist() == [0, 7]


# --- the row path over 4 gloo ranks ------------------------------------------


def _rank_main(rank, store, out_dir):
    mh.join_ranks(rank, mh.RANKS, store)
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(mh.RANKS)
    batches = _batches(seed=3)
    got = {}
    for dist_name in sorted(ROW_PATH):
        for opt in OPTIMIZERS:
            got[f"{dist_name}/{opt}"] = run_pair(
                _cfg(dist_name, opt), batches, mesh, seed=11 + rank)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(got))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("rows")
    deadline = time.monotonic() + mh.TIMEOUT
    mh.wait_ranks(mh.start_ranks(_rank_main, (str(d / "store"), d)),
                  deadline)
    return [json.loads((d / f"rank{r}.json").read_text())
            for r in range(mh.RANKS)]


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("dist_name", sorted(ROW_PATH))
def test_train_step_matches_the_dense_route_over_ranks(ranks, dist_name,
                                                       opt):
    for rank, got in enumerate(ranks):
        g = got[f"{dist_name}/{opt}"]
        assert g["diffs"] == [[]] * STEPS, f"rank {rank}"
        assert g["table_changed"], f"rank {rank}"
        assert (g["row_updates"], g["dense_updates"]) == \
            _want_counts(dist_name, opt), f"rank {rank}"
