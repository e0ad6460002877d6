"""`python -m repro_torch.analysis.audit` — prove the strategy registry's
claims (the counterpart of `repro.analysis.audit`).

For every registered strategy x every analytic context (one rank, an
8-rank pod, a (2, 4) two-pod mesh, the (2, 16, 16) production geometry)
the audit runs `distribute`/`reduce` in an analytic world (`trace.
analytic_world`: the `fake` backend, no device), records every collective
with its axes, shapes and dtypes, attributes each one's bytes onto the
inner/outer tiers, cross-checks the total against the declared
`bytes_per_device` WireBytes, and runs the contract rules in
`contracts.py`. It then builds real `StepFns` on a host mesh of one rank
and audits the engine seam itself, on the device the caller names (the
card unless `--device cpu`):

  E-COMPILE  `core.dpmr.make_step_fns` builds.
  E-DONATE   `train_step` and `apply_update` update the state in place:
             the storage (`data_ptr()`) of `cold`, `cold_acc`, `hot`,
             `hot_acc` and `strat` is the same after each (the
             reference's donated buffers aliased in the lowering).
  E-WIRE     the collectives that the strategy's own `distribute` and
             `reduce` issue inside a real `train_step` (recorded, and
             scoped to the strategy: the hot-set and metric sums are
             all_gathers of `strategies._psum` outside the wire model)
             re-verify the declared model end to end.
  E-RESET    `runtime.elastic.reshard_dpmr_state` returns a stateful
             carry to zeros.
  E-CACHE    `DPMREngine.step_fns` hits its cache on a repeat batch size.

Exit status is 0 iff no findings; `--json PATH` writes the
machine-readable report.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from typing import NamedTuple

import numpy as np

from repro_torch.analysis import trace as trace_mod
from repro_torch.analysis.contracts import Finding, check_strategy, \
    outer_axes
from repro_torch.analysis.wire import UnmodeledCollectiveError, wire_total
from repro_torch.api.strategies import StrategyContext, get_strategy, \
    list_strategies

DONATED = ("cold", "cold_acc", "hot", "hot_acc", "strat")


class AuditContext(NamedTuple):
    """One analytic geometry the audit runs every strategy on."""

    name: str                     # report key ("pod8", "multipod", ...)
    ctx: StrategyContext          # geometry handed to the strategy (its
    #                               counts; the analytic world gives the
    #                               rank and the groups)
    axis_sizes: dict              # mesh axis name -> size


def _make_ctx(axis_sizes: dict, *, block_size: int,
              capacity: int) -> StrategyContext:
    p = 1
    for s in axis_sizes.values():
        p *= int(s)
    po = 1
    for a in outer_axes(axis_sizes):
        po *= int(axis_sizes[a])
    return StrategyContext(num_shards=p, block_size=block_size,
                           capacity=capacity, outer_shards=po)


def build_contexts(*, block_size: int = 64, capacity: int = 16,
                   production: bool = True) -> tuple[AuditContext, ...]:
    """The default audit geometries: degenerate, single-pod, multi-pod,
    and (optionally) the reference's production shape of two pods of
    16 x 16 — all analytic, no device touched."""
    specs = [
        ("1dev", {"data": 1, "model": 1}),
        ("pod8", {"data": 2, "model": 4}),
        ("multipod", {"pod": 2, "data": 4}),
    ]
    if production:
        specs.append(("production", {"pod": 2, "data": 16, "model": 16}))
    return tuple(
        AuditContext(name=name, ctx=_make_ctx(sizes, block_size=block_size,
                                              capacity=capacity),
                     axis_sizes=sizes)
        for name, sizes in specs)


def _wb_dict(wb) -> dict:
    return {"inner": int(wb.inner), "outer": int(wb.outer),
            "total": int(wb.inner) + int(wb.outer)}


def audit_registry(strategies=None, contexts=None, *,
                   engine_checks: bool = True, device=None) -> dict:
    """Run the full audit; returns the machine-readable report.

    `strategies`: names to audit (default: the whole registry).
    `contexts`: `AuditContext`s (default: `build_contexts()`).
    `engine_checks=False` skips the engine seam checks, which run on
    `device` (None: the card).
    """
    names = list(strategies) if strategies is not None else list_strategies()
    contexts = tuple(contexts) if contexts is not None else build_contexts()
    findings: list[Finding] = []
    report: dict = {"strategies": {n: {} for n in names}}

    for actx in contexts:
        # exact (stateless) strategies' reduce signatures on THIS geometry
        # are the reference set for the A-EXACT accumulate-fallback rule
        traces: dict[str, trace_mod.StrategyTrace | None] = {}
        exact_sigs: dict[str, tuple] = {}
        with trace_mod.analytic_world(actx.axis_sizes) as world:
            for n in names:
                try:
                    tr = trace_mod.trace_strategy(
                        get_strategy(n), actx.ctx, actx.axis_sizes,
                        world=world)
                except Exception:  # noqa: BLE001 - re-raised as TRACE finding
                    tr = None
                traces[n] = tr
                if tr is not None and not tr.stateful:
                    exact_sigs[n] = trace_mod.signature_multiset(tr.reduce)

        for n in names:
            strat = get_strategy(n)
            tr, fs = check_strategy(strat, actx.ctx, actx.axis_sizes,
                                    context_name=actx.name,
                                    exact_reduce_sigs=exact_sigs,
                                    tr=traces[n])
            findings.extend(fs)
            entry: dict = {"findings": [f.as_dict() for f in fs]}
            try:
                entry["declared"] = _wb_dict(
                    strat.bytes_per_device(actx.ctx))
            except Exception as e:  # noqa: BLE001
                entry["declared"] = f"error: {e}"
            if tr is not None:
                step_ops = tr.distribute + tr.reduce
                try:
                    entry["extracted"] = _wb_dict(wire_total(
                        step_ops, actx.axis_sizes,
                        outer_axes(actx.axis_sizes)))
                except UnmodeledCollectiveError as e:
                    entry["extracted"] = f"unmodeled: {e}"
                entry["collectives"] = {
                    "distribute": [c.describe() for c in tr.distribute],
                    "reduce": [c.describe() for c in tr.reduce],
                }
                if tr.accumulate is not None:
                    entry["collectives"]["accumulate"] = [
                        c.describe() for c in tr.accumulate]
                entry["stateful"] = tr.stateful
            report["strategies"][n][actx.name] = entry

    if engine_checks:
        eng_findings, eng_report = audit_engine(names, device=device)
        findings.extend(eng_findings)
        report["engine"] = eng_report

    report["ok"] = not findings
    report["num_findings"] = len(findings)
    report["findings"] = [f.as_dict() for f in findings]
    return report


# ---------------------------------------------------------------------------
# engine seam: real StepFns, in-place updates, cache, elastic carry reset
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def one_rank_group(device):
    """The default process group of one rank for `device` (NCCL on the
    card, gloo on the CPU; a file store in a temporary directory),
    destroyed on exit; an existing group of one rank is used as it is."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("the engine checks run on one rank, the "
                               f"default group has {dist.get_world_size()}")
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        if device.type == "cuda":
            dist.init_process_group(
                "nccl", init_method=store, rank=0, world_size=1,
                device_id=torch.device("cuda", device.index
                                       if device.index is not None
                                       else torch.cuda.current_device()))
        else:
            dist.init_process_group("gloo", init_method=store, rank=0,
                                    world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def engine_batch(rows: int, num_features: int, k: int, seed: int = 0
                 ) -> dict:
    """A global host batch of `rows` samples of `k` features in [0,
    num_features), values and labels from numpy seed `seed`."""
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, num_features, (rows, k),
                                dtype=np.int64).astype(np.int32),
            "vals": rng.random((rows, k), dtype=np.float32),
            "labels": rng.integers(0, 2, (rows,)).astype(np.int32)}


def audit_engine(names, device=None, *, num_features: int = 1 << 10,
                 features_per_sample: int = 8, batch: dict | None = None
                 ) -> tuple[list[Finding], dict]:
    """The engine-seam checks on a host mesh of one rank on `device`
    (None: the card), at `num_features` x `features_per_sample` and the
    global host `batch` (default: 8 rows of `engine_batch`). The report
    also holds, per strategy, the kernel launches of the recorded
    `train_step` (`kernels.ops.launch_counts`: launches on the card,
    none on the CPU) and its collectives in and outside the strategy.
    A twin state takes the same steps without the recorder:
    `report["recorder_neutral"][name]` says whether the two are
    bit-identical after the recorded step."""
    import torch

    from repro_torch.api.engine import DPMREngine, put_batch
    from repro_torch.configs.base import DPMRConfig
    from repro_torch.core import dpmr
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import OUTER_AXES, make_host_mesh
    from repro_torch.runtime.elastic import reshard_dpmr_state

    device = resolve_device(device)
    findings: list[Finding] = []
    report: dict = {"checks": [], "device": str(device), "launches": {},
                    "collectives": {}, "recorder_neutral": {}}

    def bad(rule, strategy, message):
        findings.append(Finding(rule=rule, strategy=strategy,
                                context="engine", message=message))

    def ok(check):
        report["checks"].append(check)

    if batch is None:
        batch = engine_batch(8, num_features, features_per_sample)
    rows = len(batch["labels"])

    with one_rank_group(device), torch.no_grad():
        mesh = make_host_mesh(1, 1)
        axis_sizes = {a: 1 for a in mesh.mesh_dim_names}
        rb = put_batch(batch, device, mesh)
        for name in names:
            cfg = DPMRConfig(num_features=num_features,
                             max_features_per_sample=features_per_sample,
                             distribution=name)
            try:
                fns = dpmr.make_step_fns(cfg, rows, mesh=mesh)
            except Exception as e:  # noqa: BLE001
                bad("E-COMPILE", name,
                    f"make_step_fns failed on the host mesh: {e}")
                continue
            strategy = get_strategy(name)
            state = dpmr.init_state(cfg, device, mesh=mesh)
            plain = dpmr.init_state(cfg, device, mesh=mesh)

            # E-DONATE: both updates keep every table's storage
            ptrs = {f: getattr(state, f).data_ptr() for f in DONATED}
            state, _ = fns.train_step(state, rb)
            after_train = {f: getattr(state, f).data_ptr() for f in DONATED}
            state = fns.apply_update(state, torch.zeros_like(state.cold),
                                     torch.zeros_like(state.hot), 0.1)
            for fn_name, got in (("train_step", after_train),
                                 ("apply_update", {
                                     f: getattr(state, f).data_ptr()
                                     for f in DONATED})):
                moved = [f for f in DONATED if got[f] != ptrs[f]]
                if moved:
                    bad("E-DONATE", name,
                        f"StepFns.{fn_name} reallocated {moved}: the "
                        "state must be updated in place so the updates "
                        "reuse table memory")
                else:
                    ok(f"{name}: {fn_name} updates the state in place")
            plain, _ = fns.train_step(plain, rb)
            plain = fns.apply_update(plain, torch.zeros_like(plain.cold),
                                     torch.zeros_like(plain.hot), 0.1)

            # E-WIRE: the strategy's collectives inside a real train_step
            rec = trace_mod.Recorder(mesh)
            try:
                ops.reset_launch_counts()
                with trace_mod.strategy_scope(rec, strategy), rec:
                    state, _ = fns.train_step(state, rb)
                report["launches"][name] = ops.launch_counts()
                scoped = rec.scoped("strategy")
                report["collectives"][name] = {
                    "strategy": [c.describe() for c in scoped],
                    "other": [c.describe() for s, c in rec.records
                              if s != "strategy"]}
                extracted = wire_total(scoped, axis_sizes, OUTER_AXES)
                declared = strategy.bytes_per_device(fns.ctx)
                if (int(declared.inner), int(declared.outer)) != (
                        extracted.inner, extracted.outer):
                    bad("E-WIRE", name,
                        f"train_step carries inner={extracted.inner} "
                        f"outer={extracted.outer} but the declared model "
                        f"says inner={declared.inner} "
                        f"outer={declared.outer}")
                elif not scoped:
                    bad("E-WIRE", name, "train_step issued no collective "
                        "of the strategy on the host mesh")
                else:
                    ok(f"{name}: train_step wire total matches declared "
                       "model")
            except Exception as e:  # noqa: BLE001
                bad("E-WIRE", name, f"train_step wire check failed: {e}")
            plain, _ = fns.train_step(plain, rb)
            report["recorder_neutral"][name] = all(
                torch.equal(a, b) for a, b in zip(state, plain, strict=True))
            del plain

            # E-RESET: a per-rank residual is meaningless under another
            # shard assignment, so the elastic reshard zeroes it
            if strategy.init_carry(fns.ctx, device="meta") is not None:
                leaves = [x.cpu().numpy() for x in state]
                leaves[-1] = np.ones_like(leaves[-1])
                fresh = reshard_dpmr_state(leaves, cfg, mesh, device)
                if bool(torch.any(fresh.strat != 0)):
                    bad("E-RESET", name,
                        "runtime.elastic.reshard_dpmr_state must reset "
                        "the strategy carry to zeros")
                else:
                    ok(f"{name}: elastic reshard resets the carry")
            del state

        # E-CACHE: a miss would rebuild the steps on every call
        eng = DPMREngine(DPMRConfig(num_features=num_features,
                                    max_features_per_sample=
                                    features_per_sample),
                         device=device, mesh=mesh)
        if eng.step_fns(rows) is not eng.step_fns(rows):
            bad("E-CACHE", "engine",
                "DPMREngine.step_fns(batch_size) rebuilds on a repeat "
                "batch size instead of hitting the LRU cache")
        else:
            ok("engine: step_fns LRU cache hits on repeat batch size")
    return findings, report


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Wire-model & contract audit of the DPMR strategy "
                    "registry over recorded collectives.")
    ap.add_argument("--strategy", action="append", default=None,
                    help="audit only this strategy (repeatable; default: "
                         "the whole registry)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--no-engine", action="store_true",
                    help="skip the engine-seam checks")
    ap.add_argument("--quiet", action="store_true",
                    help="print findings only, no per-strategy summary")
    ap.add_argument("--device", default=None,
                    help="device of the engine-seam checks (default: the "
                         "card; cpu for the host)")
    args = ap.parse_args(argv)

    report = audit_registry(strategies=args.strategy,
                            engine_checks=not args.no_engine,
                            device=args.device)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)

    if not args.quiet:
        for name, per_ctx in sorted(report["strategies"].items()):
            for ctx_name, entry in per_ctx.items():
                declared = entry.get("declared")
                extracted = entry.get("extracted")
                n_find = len(entry.get("findings", []))
                status = "ok" if n_find == 0 else f"{n_find} finding(s)"
                print(f"{name:18s} {ctx_name:10s} declared={declared} "
                      f"extracted={extracted} [{status}]")
    for f in report["findings"]:
        print(f"FINDING {f['rule']} [{f['strategy']} @ {f['context']}]: "
              f"{f['message']}", file=sys.stderr)
    n = report["num_findings"]
    print(f"audit: {len(report['strategies'])} strategies, "
          f"{n} finding(s) -> {'PASS' if report['ok'] else 'FAIL'}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
