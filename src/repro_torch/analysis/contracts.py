"""The lint rules: what a registered strategy must prove on an analytic
geometry (the counterpart of `repro.analysis.contracts`, the same rules
and rule IDs over the port's recorded collectives).

`check_strategy` runs every rule against one `(strategy, ctx)` pair and
returns `Finding`s. Rules (IDs appear in reports and test assertions):

  W-MODEL   every recorded collective has a wire model (wire.py) — an
            unmodeled collective would silently undercount the claim.
  W-MATCH   the declared `bytes_per_device` WireBytes equals the
            recorded bytes on BOTH tiers, for distribute + the
            carry-advancing reduce path. Exact strategies are exact by
            construction; the lossy built-ins are statically exact too
            (top-k sends exactly k pairs, int8 reduce sends exactly the
            padded block), so equality is required of everyone.
  W-OUTER   on a multi-pod context, declared AND recorded outer bytes
            must be nonzero — a two-tier model that never crosses pods
            on a 2-pod mesh is lying about one tier.
  W-SINGLE  on a single-pod context, declared and recorded outer must be
            exactly zero (nothing can cross a tier that does not exist).
  F-OVERFLOW `distribute` must return a fwd dict carrying a 0-d int32
            "overflow" (the engine sums it into step metrics).
  C-CARRY   `init_carry` must return a 1-D float32 tensor (the engine
            stores it flat in `DPMRState.strat`), and `reduce` must then
            return `(grad, new_carry)` with the carry's shape and dtype
            preserved; stateless strategies must return the bare
            gradient.
  A-FREEZE  on the accumulate path (`fwd["accumulate"]` set) a stateful
            strategy must return the carry INPUT itself, unwritten: the
            returned tensor is the input tensor and its `_version` did
            not move (the reference proves the same at the jaxpr level,
            the output variable being the input variable).
  A-EXACT   the accumulate path must be exact: its collective signature
            multiset must equal the reduce-path signature multiset of one
            of the registry's exact (stateless) strategies on the same
            geometry, and must put only f32/int32 on the wire.

The reference's docs/ANALYSIS.md gives the rationale behind each rule.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.analysis import trace as trace_mod
from repro_torch.analysis.wire import UnmodeledCollectiveError, wire_total
from repro_torch.api.strategies import WireBytes
from repro_torch.launch.mesh import OUTER_AXES

EXACT_WIRE_DTYPES = {"float32", "int32"}


class Finding(NamedTuple):
    """One rule violation (or the audit-level error that prevented a rule
    from running)."""

    rule: str        # rule ID ("W-MATCH", ...)
    strategy: str    # registered strategy name
    context: str     # analytic context name ("pod8", "multipod", ...)
    message: str     # human-readable diagnosis

    def as_dict(self) -> dict:
        return self._asdict()


def _fmt(wb: WireBytes) -> str:
    return f"inner={wb.inner} outer={wb.outer}"


def outer_axes(axis_sizes: dict) -> tuple[str, ...]:
    """The axes of `axis_sizes` on the outer (between-pod) tier."""
    return tuple(a for a in axis_sizes if a in OUTER_AXES)


def check_strategy(strategy, ctx, axis_sizes: dict, *,
                   context_name: str = "?",
                   exact_reduce_sigs: dict | None = None,
                   tr: trace_mod.StrategyTrace | None = None,
                   ) -> tuple[trace_mod.StrategyTrace | None, list[Finding]]:
    """Run every contract rule for one strategy on one analytic geometry.

    `exact_reduce_sigs` maps exact-strategy name -> reduce-path signature
    multiset on THIS geometry (from `trace.signature_multiset`); when None
    the A-EXACT rule is skipped. Pass `tr` to reuse an existing trace.
    Returns `(trace, findings)`; trace is None if tracing itself failed.
    """
    name = getattr(strategy, "name", type(strategy).__name__)
    findings: list[Finding] = []

    def bad(rule: str, message: str) -> None:
        findings.append(Finding(rule=rule, strategy=name,
                                context=context_name, message=message))

    if tr is None:
        try:
            tr = trace_mod.trace_strategy(strategy, ctx, axis_sizes)
        except Exception as e:  # noqa: BLE001 - any trace failure is a finding
            bad("TRACE", f"tracing failed: {type(e).__name__}: {e}")
            return None, findings

    try:
        declared = strategy.bytes_per_device(ctx)
        declared = WireBytes(inner=int(declared.inner),
                             outer=int(declared.outer))
    except Exception as e:  # noqa: BLE001
        bad("W-MATCH", f"bytes_per_device failed: {type(e).__name__}: {e}")
        declared = None

    step_ops = tr.distribute + tr.reduce
    try:
        extracted = wire_total(step_ops, axis_sizes, outer_axes(axis_sizes))
    except UnmodeledCollectiveError as e:
        bad("W-MODEL", str(e))
        extracted = None

    if declared is not None and extracted is not None:
        if (declared.inner, declared.outer) != (extracted.inner,
                                                extracted.outer):
            ops = "; ".join(c.describe() for c in step_ops) or "none"
            bad("W-MATCH",
                f"declared {_fmt(declared)} but the recorded collectives "
                f"carry {_fmt(extracted)} (ops: {ops})")
        if ctx.outer_shards > 1:
            if declared.outer <= 0:
                bad("W-OUTER", "multi-pod context "
                    f"(outer_shards={ctx.outer_shards}) but the declared "
                    "wire model claims zero outer-tier bytes")
            if extracted.outer <= 0:
                bad("W-OUTER", "multi-pod context "
                    f"(outer_shards={ctx.outer_shards}) but no recorded "
                    "collective crosses the outer tier")
        elif declared.outer != 0 or extracted.outer != 0:
            bad("W-SINGLE", "single-pod context but nonzero outer "
                f"bytes (declared {declared.outer}, recorded "
                f"{extracted.outer})")

    if not tr.fwd_overflow:
        bad("F-OVERFLOW", "distribute's fwd dict must carry a 0-d "
            'int32 "overflow" (0 when the strategy cannot drop)')

    if tr.stateful:
        if not tr.carry_1d_f32:
            bad("C-CARRY", "init_carry must return a 1-D float32 tensor "
                "(stored flat in DPMRState.strat)")
        if not tr.reduce_pair:
            bad("C-CARRY", "stateful reduce must return "
                "(grad, new_carry), got a bare value")
        elif not tr.carry_aval_preserved:
            bad("C-CARRY", "reduce's returned carry changes shape/dtype; "
                "the persistent carry's must be preserved")
        if tr.reduce_pair and not tr.carry_passthrough:
            bad("A-FREEZE", 'on the accumulate path (fwd["accumulate"]) '
                "the carry must be returned untouched — the returned "
                "carry is not the input tensor, or it was written")
        if tr.accumulate is not None:
            lossy = set(tr.wire_dtypes_accumulate or ()) - EXACT_WIRE_DTYPES
            if lossy:
                bad("A-EXACT", "accumulate path puts lossy dtypes "
                    f"{sorted(lossy)} on the wire; it must fall back to "
                    "an exact reduce")
            if exact_reduce_sigs:
                acc_sig = trace_mod.signature_multiset(tr.accumulate)
                if acc_sig not in set(exact_reduce_sigs.values()):
                    ops = "; ".join(c.describe() for c in tr.accumulate) \
                        or "none"
                    bad("A-EXACT", "accumulate-path collectives match no "
                        "exact strategy's reduce path on this geometry "
                        f"(ops: {ops}; exact candidates: "
                        f"{sorted(exact_reduce_sigs)})")
    elif tr.reduce_pair:
        bad("C-CARRY", "stateless strategy (init_carry -> None) must "
            "return the bare gradient from reduce, not a tuple")

    return tr, findings
