"""The port's wire auditor (`repro_torch.analysis`) against the JAX
package's rules and wire model, on the CPU.

The reference's own tracer cannot run under this jax (its
`jax.core.extend_axis_env_nd` is gone: ROADMAP C3), so the port is held
to the reference's RULES and WIRE MODEL, not to its tracer: the port's
recorded collectives are converted into `repro.analysis.trace.
Collective`s / `StrategyTrace`s, and the reference's own `wire_total`
and `check_strategy(..., tr=...)` judge them.

- Every registered strategy on the 1dev, pod8, multipod and (2, 16, 16)
  production geometries: the port's audit finds nothing; its
  `bytes_per_device` equals the reference's; the reference's
  `wire_total` of the recorded collectives equals the port's, and the
  reference's `check_strategy` finds nothing.
- The reference tests' deliberately broken strategies, ported, give the
  rule IDs `tests/test_analysis.py` asserts.
- Every `collective_wire` case of `tests/test_analysis.py` gives the
  reference's result; the multipod (prim, axes) table beside the
  reference's `PINNED_MULTIPOD_OPS`, each difference named.
- `analytic_world` leaves no default group; the engine checks pass on
  the CPU; the command line.
- Four real gloo ranks at (pod 2, data 2): each strategy's recorded
  `train_step` prices to its `bytes_per_device` and to the analytic trace
  of the same geometry.
"""
import json
import time

import pytest
import torch
import torch.distributed as dist

from repro.analysis import audit as jaudit
from repro.analysis import contracts as jcontracts
from repro.analysis import trace as jtrace
from repro.analysis import wire as jwire
from repro.api import strategies as jstrategies
from repro_torch.analysis import audit, contracts, trace, wire
from repro_torch.api import strategies
from repro_torch.api.strategies import (
    AllToAllStrategy,
    TopKReduceStrategy,
    WireBytes,
    get_strategy,
)

import torch_mesh_harness as harness

ALL = ("a2a", "allgather", "compressed_reduce", "hier_a2a", "hier_a2a+int8",
       "hier_a2a+topk", "overlap_a2a", "psum_scatter", "topk_reduce")
# the reference tests' set of built-ins (tests/test_analysis.py)
STRATEGIES = ("a2a", "allgather", "psum_scatter", "hier_a2a",
              "compressed_reduce", "topk_reduce", "overlap_a2a")
CONTEXTS = {a.name: a for a in audit.build_contexts()}
J_CONTEXTS = {a.name: a for a in jaudit.build_contexts()}


@pytest.fixture(scope="module")
def traces():
    """{(context, strategy): the port's StrategyTrace}, each context's
    world brought up once."""
    out = {}
    for name, actx in CONTEXTS.items():
        with trace.analytic_world(actx.axis_sizes) as world:
            for s in ALL:
                out[name, s] = trace.trace_strategy(
                    get_strategy(s), actx.ctx, actx.axis_sizes, world=world)
    return out


def _exact_sigs(traces, ctx_name, convert=False):
    out = {}
    for s in ALL:
        tr = traces[ctx_name, s]
        if not tr.stateful:
            ops = tr.reduce if not convert else _j_ops(tr.reduce)
            out[s] = (jtrace if convert else trace).signature_multiset(ops)
    return out


def _j_ops(ops):
    return tuple(jtrace.Collective(*c) for c in ops)


def _j_trace(tr):
    """The port's StrategyTrace as the reference's."""
    return jtrace.StrategyTrace(
        distribute=_j_ops(tr.distribute), reduce=_j_ops(tr.reduce),
        accumulate=None if tr.accumulate is None else _j_ops(tr.accumulate),
        stateful=tr.stateful, carry_1d_f32=tr.carry_1d_f32,
        reduce_pair=tr.reduce_pair,
        carry_aval_preserved=tr.carry_aval_preserved,
        carry_passthrough=tr.carry_passthrough,
        wire_dtypes_accumulate=tr.wire_dtypes_accumulate,
        fwd_overflow=tr.fwd_overflow)


@pytest.mark.parametrize("ctx_name", list(CONTEXTS))
@pytest.mark.parametrize("name", ALL)
def test_port_audit_finds_nothing(name, ctx_name, traces):
    actx = CONTEXTS[ctx_name]
    tr, findings = contracts.check_strategy(
        get_strategy(name), actx.ctx, actx.axis_sizes,
        context_name=ctx_name, exact_reduce_sigs=_exact_sigs(traces,
                                                             ctx_name),
        tr=traces[ctx_name, name])
    assert findings == [], findings
    assert tr.distribute + tr.reduce or ctx_name == "1dev"


@pytest.mark.parametrize("ctx_name", list(CONTEXTS))
@pytest.mark.parametrize("name", ALL)
def test_bytes_per_device_equal_reference(name, ctx_name):
    got = get_strategy(name).bytes_per_device(CONTEXTS[ctx_name].ctx)
    want = jstrategies.get_strategy(name).bytes_per_device(
        J_CONTEXTS[ctx_name].ctx)
    assert (got.inner, got.outer) == (int(want.inner), int(want.outer))
    assert CONTEXTS[ctx_name].axis_sizes == J_CONTEXTS[ctx_name].axis_sizes


@pytest.mark.parametrize("ctx_name", list(CONTEXTS))
@pytest.mark.parametrize("name", ALL)
def test_reference_rules_pass_the_recorded_collectives(name, ctx_name,
                                                       traces):
    """The reference's own wire model and rules over the port's record."""
    jctx = J_CONTEXTS[ctx_name]
    tr = traces[ctx_name, name]
    jtr = _j_trace(tr)
    ops = tr.distribute + tr.reduce
    port = wire.wire_total(ops, jctx.axis_sizes,
                           contracts.outer_axes(jctx.axis_sizes))
    ref = jwire.wire_total(_j_ops(ops), jctx.axis_sizes,
                           jctx.ctx.outer_axes)
    assert (port.inner, port.outer) == (ref.inner, ref.outer)
    _, findings = jcontracts.check_strategy(
        jstrategies.get_strategy(name), jctx.ctx, jctx.axis_sizes,
        context_name=ctx_name,
        exact_reduce_sigs=_exact_sigs(traces, ctx_name, convert=True),
        tr=jtr)
    assert findings == [], findings


# ---------------------------------------------------------------------------
# deliberately-wrong strategies must be rejected
# ---------------------------------------------------------------------------


class _SelfCountingWire(AllToAllStrategy):
    """Legacy drift: counts its own chunk as received wire bytes."""

    def bytes_per_device(self, ctx):
        pi = ctx.inner_shards
        return WireBytes(inner=3 * pi * ctx.capacity * 4,
                         outer=3 * (ctx.num_shards - pi) * ctx.capacity * 4)


class _NoOuterTier(AllToAllStrategy):
    """Claims a multi-pod exchange never crosses pods."""

    def bytes_per_device(self, ctx):
        return WireBytes(
            inner=3 * (ctx.num_shards - 1) * ctx.capacity * 4, outer=0)


class _NoAccumulateFallback(TopKReduceStrategy):
    """Ignores fwd["accumulate"]: sparsifies and advances the carry on the
    full-batch accumulation path too."""

    def reduce(self, ctx, cold_loc, grads_flat, fwd):
        return super().reduce(ctx, cold_loc, grads_flat,
                              {**fwd, "accumulate": False})


@pytest.fixture
def scratch_registry():
    """Register test strategies, guaranteed unregistered afterwards."""
    added = []

    def add(name, strategy):
        strategies.register_strategy(name, strategy)
        added.append(name)
        return get_strategy(name)

    try:
        yield add
    finally:
        for name in added:
            strategies._REGISTRY.pop(name, None)


def _check(name, actx):
    with trace.analytic_world(actx.axis_sizes) as world:
        exact = {}
        for n in STRATEGIES:
            tr = trace.trace_strategy(get_strategy(n), actx.ctx,
                                      actx.axis_sizes, world=world)
            if not tr.stateful:
                exact[n] = trace.signature_multiset(tr.reduce)
        tr = trace.trace_strategy(get_strategy(name), actx.ctx,
                                  actx.axis_sizes, world=world)
    return contracts.check_strategy(get_strategy(name), actx.ctx,
                                    actx.axis_sizes, context_name=actx.name,
                                    exact_reduce_sigs=exact, tr=tr)


def _rules(findings):
    return {f.rule for f in findings}


def test_bad_wire_model_rejected(scratch_registry):
    strat = scratch_registry("_bad_wire", _SelfCountingWire())
    _, findings = _check("_bad_wire", CONTEXTS["pod8"])
    assert "W-MATCH" in _rules(findings), findings
    assert strat.bytes_per_device(CONTEXTS["pod8"].ctx).inner > \
        get_strategy("a2a").bytes_per_device(CONTEXTS["pod8"].ctx).inner


def test_missing_outer_tier_rejected(scratch_registry):
    scratch_registry("_no_outer", _NoOuterTier())
    _, findings = _check("_no_outer", CONTEXTS["multipod"])
    assert "W-OUTER" in _rules(findings), findings
    _, findings_1pod = _check("_no_outer", CONTEXTS["pod8"])
    assert "W-OUTER" not in _rules(findings_1pod)


def test_missing_accumulate_fallback_rejected(scratch_registry):
    scratch_registry("_no_acc", _NoAccumulateFallback())
    _, findings = _check("_no_acc", CONTEXTS["pod8"])
    # the carry is written on the frozen path AND the collective pattern
    # no longer matches any exact strategy's reduce
    assert {"A-FREEZE", "A-EXACT"} <= _rules(findings), findings


def test_audit_registry_fails_on_miswired_strategy(scratch_registry):
    scratch_registry("_bad_wire", _SelfCountingWire())
    report = audit.audit_registry(engine_checks=False,
                                  contexts=[CONTEXTS["pod8"]])
    assert not report["ok"]
    assert any(f["strategy"] == "_bad_wire" for f in report["findings"])
    assert all(f["strategy"] == "_bad_wire" for f in report["findings"])


def test_audit_registry_report_shape():
    report = audit.audit_registry(strategies=["a2a", "topk_reduce"],
                                  contexts=[CONTEXTS["multipod"]],
                                  engine_checks=False)
    assert report["ok"] and report["num_findings"] == 0
    entry = report["strategies"]["a2a"]["multipod"]
    assert entry["declared"] == entry["extracted"]
    assert entry["collectives"]["distribute"]
    assert report["strategies"]["topk_reduce"]["multipod"]["stateful"]


# ---------------------------------------------------------------------------
# wire attribution math, against the reference's on the same records
# ---------------------------------------------------------------------------


def _coll(prim, axes, shape, dtype="float32", out_shape=None):
    return trace.Collective(prim=prim, axes=axes, shapes=(shape,),
                            dtypes=(dtype,), out_shapes=(out_shape or shape,),
                            out_dtypes=(dtype,))


WIRE_CASES = [
    # (record, axis sizes, outer axes, the reference test's expectation)
    (_coll("all_to_all", ("pod", "data"), (8, 16)), {"pod": 2, "data": 4},
     ("pod",), WireBytes(inner=3 * 64, outer=4 * 64)),
    (_coll("all_gather", ("pod",), (128,)), {"pod": 2, "data": 4},
     ("pod",), WireBytes(inner=0, outer=128 * 4)),
    (_coll("reduce_scatter", ("data",), (64,), out_shape=(16,)),
     {"pod": 2, "data": 4}, ("pod",), WireBytes(inner=3 * 16 * 4, outer=0)),
    (_coll("all_to_all", ("pod",), (2, 4)), {"pod": 1}, (),
     WireBytes(0, 0)),
    (_coll("psum", ("pod", "data"), (64,)), {"pod": 2, "data": 4},
     ("pod",), WireBytes(inner=2 * 3 * 32, outer=2 * 4 * 32)),
    (_coll("ppermute", ("pod",), (16,)), {"pod": 2, "data": 4}, ("pod",),
     WireBytes(inner=0, outer=64)),
    (_coll("ppermute", ("data",), (16,)), {"pod": 2, "data": 4}, ("pod",),
     WireBytes(inner=64, outer=0)),
]


@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
def test_collective_wire_matches_reference(case):
    c, sizes, outer, want = WIRE_CASES[case]
    got = wire.collective_wire(c, sizes, outer)
    ref = jwire.collective_wire(jtrace.Collective(*c), sizes, outer)
    assert got == want
    assert (got.inner, got.outer) == (ref.inner, ref.outer)


@pytest.mark.parametrize("c,sizes", [
    (_coll("psum[grouped]", ("data",), (8,)), {"data": 4}),
    (_coll("all_gather", ("ghost",), (8,)), {"data": 4}),
    (_coll("c10d.broadcast_", ("data",), (8,)), {"data": 4}),
])
def test_unmodeled_collective_raises(c, sizes):
    with pytest.raises(wire.UnmodeledCollectiveError):
        wire.collective_wire(c, sizes, ())
    with pytest.raises(jwire.UnmodeledCollectiveError):
        jwire.collective_wire(jtrace.Collective(*c), sizes, ())


def test_wire_total_sums_both_tiers():
    sizes = {"pod": 2, "data": 4}
    ops = [_coll("all_to_all", ("pod", "data"), (8, 16)),
           _coll("all_gather", ("pod",), (128,))]
    total = wire.wire_total(ops, sizes, ("pod",))
    assert total == WireBytes(inner=3 * 64, outer=4 * 64 + 512)
    ref = jwire.wire_total([jtrace.Collective(*c) for c in ops], sizes,
                           ("pod",))
    assert (ref.inner, ref.outer) == total


# ---------------------------------------------------------------------------
# the recorded collective pattern per strategy
# ---------------------------------------------------------------------------

# the reference's PINNED_MULTIPOD_OPS (tests/test_analysis.py), copied
REFERENCE_PINNED = {
    "a2a": [("all_to_all", ("pod", "data"))] * 3,
    "allgather": [("all_gather", ("pod", "data")),
                  ("reduce_scatter", ("pod", "data"))],
    "psum_scatter": [("all_to_all", ("pod", "data"))] * 2
    + [("reduce_scatter", ("pod", "data"))],
    "hier_a2a": [("all_gather", ("pod",))]
    + [("all_to_all", ("data",))] * 3
    + [("reduce_scatter", ("pod",))],
    "compressed_reduce": [("all_to_all", ("pod", "data"))] * 4,
    "topk_reduce": [("all_to_all", ("pod", "data"))] * 4,
    "overlap_a2a": [("all_to_all", ("pod", "data"))] * 12,
}
# where the port's record differs, and why: `_psum_scatter` is an
# all_to_all of the (G, block) segments summed in rank order
# (`api.strategies`), priced as the reference's reduce_scatter
DIFFERENCES = {
    ("reduce_scatter", ("pod", "data")): ("all_to_all", ("pod", "data")),
    ("reduce_scatter", ("pod",)): ("all_to_all", ("pod",)),
}
PORT_PINNED = {
    "a2a": [("all_to_all", ("pod", "data"))] * 3,
    "allgather": [("all_gather", ("pod", "data")),
                  ("all_to_all", ("pod", "data"))],
    "psum_scatter": [("all_to_all", ("pod", "data"))] * 3,
    "hier_a2a": [("all_gather", ("pod",))]
    + [("all_to_all", ("data",))] * 3 + [("all_to_all", ("pod",))],
    "compressed_reduce": [("all_to_all", ("pod", "data"))] * 4,
    "topk_reduce": [("all_to_all", ("pod", "data"))] * 4,
    "overlap_a2a": [("all_to_all", ("pod", "data"))] * 12,
    # the compositions, which the reference's table leaves out: the pod
    # all_gather, the inner shuffle, the leg's two (value, index) or
    # (int8, scale) all_to_alls over the pods
    "hier_a2a+topk": [("all_gather", ("pod",))]
    + [("all_to_all", ("data",))] * 3 + [("all_to_all", ("pod",))] * 2,
    "hier_a2a+int8": [("all_gather", ("pod",))]
    + [("all_to_all", ("data",))] * 3 + [("all_to_all", ("pod",))] * 2,
}


@pytest.mark.parametrize("name", ALL)
def test_pinned_collective_signatures(name, traces):
    tr = traces["multipod", name]
    got = sorted((c.prim, c.axes) for c in tr.distribute + tr.reduce)
    assert got == sorted(PORT_PINNED[name]), (name, got)
    if name in REFERENCE_PINNED:
        named = [DIFFERENCES.get(op, op) for op in REFERENCE_PINNED[name]]
        assert sorted(named) == got


def test_stateful_accumulate_path_is_exact(traces):
    for name in ("compressed_reduce", "topk_reduce"):
        tr = traces["pod8", name]
        assert tr.stateful and tr.carry_passthrough, name
        assert set(tr.wire_dtypes_accumulate) <= {"float32", "int32"}


def test_contexts_cover_required_geometries():
    prod = CONTEXTS["production"]
    assert prod.ctx.num_shards == 512 and prod.ctx.outer_shards == 2
    assert prod.axis_sizes == {"pod": 2, "data": 16, "model": 16}
    assert set(CONTEXTS) == set(J_CONTEXTS)


def test_batch_elems_never_clamps_hier_capacity():
    ctx = CONTEXTS["multipod"].ctx
    n = trace.batch_elems(ctx)
    assert n == jtrace.batch_elems(J_CONTEXTS["multipod"].ctx)
    assert get_strategy("hier_a2a")._inner_capacity(ctx, n) == \
        ctx.capacity * ctx.outer_shards


def test_traces_repeat(traces):
    """Two traces of one strategy record the same collectives (the fake
    world's results are filled as identical ranks would give them)."""
    actx = CONTEXTS["multipod"]
    again = trace.trace_strategy(get_strategy("hier_a2a+topk"), actx.ctx,
                                 actx.axis_sizes)
    assert again == traces["multipod", "hier_a2a+topk"]


# ---------------------------------------------------------------------------
# the analytic world, the engine checks, the command line
# ---------------------------------------------------------------------------


def test_analytic_world_leaves_no_group():
    with trace.analytic_world({"pod": 2, "data": 4}) as world:
        assert dist.get_world_size() == 8
        assert world.groups.outer is not None
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="boom"):
        with trace.analytic_world({"data": 2, "model": 4}):
            raise RuntimeError("boom")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with trace.analytic_world({"model": 2, "data": 2}):
            pass
    assert not dist.is_initialized()


def test_analytic_world_refuses_a_live_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            with trace.analytic_world({"data": 1, "model": 1}):
                pass
    finally:
        dist.destroy_process_group()


def test_recorder_maps_groups_and_peers():
    """Dim groups, the flattened inner group, a group that is no sub-grid
    of the mesh, and point-to-point peers."""
    with trace.analytic_world({"pod": 2, "data": 2, "model": 2}) as world:
        rec = world.recorder()
        odd = dist.new_group([0, 3])
        x, y = torch.ones(4), torch.ones(4)
        with rec:
            dist.all_reduce(x, group=world.mesh.get_group("model"))
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=world.groups.inner)
            dist.all_reduce(x, group=odd)
            dist.send(y, 4)
            dist.recv(y, 2)
            dist.broadcast(y, 0)
    got = [(c.prim, c.axes) for c in rec.ops]
    assert got == [("psum", ("model",)), ("pmax", ("data", "model")),
                   ("psum[grouped]", ()), ("ppermute", ("pod",)),
                   ("ppermute", ("data",)),
                   ("broadcast", ("pod", "data", "model"))]
    # filled as identical ranks: the sum over `model` doubles x, the max
    # keeps it, the unmapped group is left alone; a receive reads zeros
    assert torch.equal(x, torch.full((4,), 2.0))
    assert torch.equal(y, torch.zeros(4))


def test_collect_collectives():
    with trace.analytic_world({"data": 2, "model": 2}) as world:
        x = torch.ones(3)
        _, ops = trace.collect_collectives(
            dist.all_reduce, world.mesh, x,
            group=world.mesh.get_group("data"), fill=True)
    assert ops == [trace.Collective("psum", ("data",), ((3,),),
                                    ("float32",), ((3,),), ("float32",))]
    assert torch.equal(x, torch.full((3,), 2.0))


def test_engine_checks_pass_on_cpu():
    findings, report = audit.audit_engine(ALL, device="cpu")
    assert findings == [], findings
    assert report["recorder_neutral"] == {name: True for name in ALL}
    checks = " ".join(report["checks"])
    assert "in place" in checks and "resets the carry" in checks
    assert "cache hits" in checks
    assert set(report["collectives"]) == set(ALL)
    assert not dist.is_initialized()


def test_cli(tmp_path, capsys):
    path = tmp_path / "audit.json"
    rc = audit.main(["--strategy", "a2a", "--strategy", "topk_reduce",
                     "--device", "cpu", "--json", str(path), "--quiet"])
    assert rc == 0
    report = json.loads(path.read_text())
    assert report["ok"] and set(report["strategies"]) == {"a2a",
                                                          "topk_reduce"}
    assert set(report["strategies"]["a2a"]) == set(CONTEXTS)
    assert "engine" in report
    assert "0 finding(s) -> PASS" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# four real gloo ranks
# ---------------------------------------------------------------------------

GLOO_MESH = {"pod": 2, "data": 2}
ROWS = 32                       # global batch: 8 rows a rank, 64 slots


def _as_collective(row):
    return trace.Collective(row[0], tuple(row[1]),
                            tuple(tuple(s) for s in row[2]), tuple(row[3]),
                            tuple(tuple(s) for s in row[4]), tuple(row[5]))


@pytest.fixture(scope="module")
def gloo_rows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_wire")
    out = tmp / "rows.json"
    deadline = time.monotonic() + harness.TIMEOUT
    harness.wait_ranks(harness.start_ranks(
        harness.wire_rank, (str(tmp / "store"), str(out), GLOO_MESH, ROWS,
                            ALL)), deadline)
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", ALL)
def test_gloo_train_step_wire(name, gloo_rows):
    row = gloo_rows[name]
    ops = [_as_collective(r) for r in row["ops"]]
    got = wire.wire_total(ops, GLOO_MESH, ("pod",))
    assert list(got) == row["declared"]
    assert got.outer > 0 and got.inner > 0
    p, block, cap, po, frac = row["ctx"]
    ctx = strategies.StrategyContext(num_shards=p, block_size=block,
                                     capacity=cap, topk_frac=frac,
                                     outer_shards=po)
    n = ROWS // p * 8
    analytic = trace.trace_strategy(get_strategy(name), ctx, GLOO_MESH, n=n)
    want = analytic.distribute + analytic.reduce
    assert wire.wire_total(want, GLOO_MESH, ("pod",)) == got
    assert trace.signature_multiset(want) == trace.signature_multiset(ops)
