"""Static analysis over the DPMR strategy registry and the engine's steps
(the counterpart of `repro.analysis`).

The paper's headline accounting is communication volume: every loop pays
a parameter-assignment shuffle and a gradient reduce, and each registered
`DistributionStrategy` justifies itself through a hand-written two-tier
`WireBytes` model. This subsystem makes those claims *machine-checked*:

  trace.py      records a strategy's `distribute` / `reduce` (and the
                engine's real `StepFns`) as `torch.distributed` calls in
                an analytic world of any size (the `fake` backend, no
                device), each collective with its axes, shapes, dtypes.
  wire.py       classifies each recorded collective's bytes received per
                rank onto the inner / outer tiers.
  contracts.py  the lint rules: wire-model cross-check, lossy-strategy
                carry lifecycle, exact fallback on the accumulate path,
                multi-pod outer-tier liveness.
  audit.py      `python -m repro_torch.analysis.audit` — runs the rules
                over the whole registry and the engine seam, and emits a
                machine-readable report.
"""
from repro_torch.analysis.audit import AuditContext, audit_registry, \
    build_contexts
from repro_torch.analysis.contracts import Finding, check_strategy
from repro_torch.analysis.trace import (
    Collective,
    Recorder,
    StrategyTrace,
    analytic_world,
    collect_collectives,
    trace_strategy,
)
from repro_torch.analysis.wire import collective_wire, wire_total

__all__ = [
    "AuditContext",
    "Collective",
    "Finding",
    "Recorder",
    "StrategyTrace",
    "analytic_world",
    "audit_registry",
    "build_contexts",
    "check_strategy",
    "collect_collectives",
    "collective_wire",
    "trace_strategy",
    "wire_total",
]
