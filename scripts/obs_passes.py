#!/usr/bin/env python3
"""Read the port's own spans and counters (`repro_torch.obs`) in one of
the benchmark's cells on the card, beside what the benchmark reads.

    python3 scripts/obs_passes.py --workload <cell> --seeds 1 2 3 \
        [--seconds 10] [--out results]

The cell's set-up is the benchmark's own (`perfbench/`: its runner's
`Program`, the pool of batches, the weights from the seed, the three
checked steps). For each seed it measures the closed-loop window three
times, tracing off, on (`obs.enabled()`), off, and reports the rate of
each: the cost of tracing when it is on. For the first seed it then
runs, over the same `trace_steps` batches:

  harness   the runner's own traced pass (`Program.traced`: for the
            sparse runner its `SPANS` wrapped around the program's
            functions, profiled), for the side-by-side table
  (a)       `obs.enabled()` under the CPU+CUDA profiler: device time
            under each program span (`obs_trace.read_trace`, the
            attention's backward included by sequence number), the
            counters, and the idle gaps named by the innermost program
            span
  (b)       `obs.enabled()` without a profiler: the spans' host time from
            `obs.snapshot()` and the pass's wall a step
  sync      a few steps (sparse: the engine's `train_step`) under
            `torch.cuda.set_sync_debug_mode("warn")`: every synchronising
            call, by file and line

and the five readings that per-layer metrics over them would report:
`sparse.dispatch_ms`, `sparse.host_reads`, `sparse.optimizer_useful_share`,
`dense.attention_ms`, `dense.optimizer_ms`. Prints one JSON line a cell
and writes it to `<out>/obs_passes_<cell>.json`. Needs a CUDA card.

The benchmark's runners do not take passes a and b yet; this script
stands in for them and goes once they do.
"""
import argparse
import json
import pathlib
import statistics
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "perfbench"))
sys.path.insert(0, str(ROOT / "src"))

import obs_trace  # noqa: E402
from pb import cells, common, tracing  # noqa: E402

SPARSE_SPANS = ("routing.route_build", "routing.owner_apply",
                "routing.route_return", "routing.combine_grads",
                "optimizer.update", "seam.sigmoid_grad",
                "seam.segment_sum_sorted", "seam.sorted_run_totals",
                "seam.owner_accumulate")


def windows(torch, prog, seconds: float) -> dict:
    """The window off, on, off: samples or tokens a second, and steps."""
    from repro_torch import obs

    out = {}
    for key in ("off1", "on", "off2"):
        obs.reset()
        if key == "on":
            with obs.enabled():
                w = prog.window(seconds)
        else:
            w = prog.window(seconds)
        out[key] = {"steps": w["steps"], "elapsed_s": w["elapsed_s"],
                    "step_s": w["elapsed_s"] / w["steps"]}
    off = (out["off1"]["step_s"] + out["off2"]["step_s"]) / 2
    out["cost_pct"] = (out["on"]["step_s"] / off - 1) * 100
    return out


def unlinked(events, names, steps: int) -> dict:
    """Device ms a step, by kernel name, of the device operations that
    no host event of the trace lists as its own (so that no span can
    hold them)."""
    from torch.autograd import DeviceType

    dev, held = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in names:
                continue
            dev[e.name] = dev.get(e.name, 0.0) + \
                e.time_range.end - e.time_range.start
        else:
            for k in e.kernels:
                held[k.name] = held.get(k.name, 0.0) + k.duration
    return {k: (v - held.get(k, 0.0)) / steps * 1e-3 for k, v in dev.items()
            if v - held.get(k, 0.0) > 0.5}


def run_steps(prog, sparse: bool, batches) -> None:
    if sparse:
        prog.eng.fit_sgd(batches)
    else:
        for b in batches:
            prog.one(b)


def _sync(torch, prog) -> None:
    if prog.dev.type == "cuda":
        torch.cuda.synchronize()


def passes(torch, prog, sparse: bool, steps: int, untraced_step_s: float):
    from repro_torch import obs

    n = len(prog.batches)
    batches = [prog.batches[(3 + i) % n] for i in range(steps)]
    out = {"steps": steps}
    harness = prog.traced(steps)
    out["harness_span_ms"] = {k: v / steps * 1e3 for k, v in
                              harness.get("span_device_s", {}).items()}
    out["harness_busy_ms"] = harness["busy_s"] / steps * 1e3
    # (a) profiled, tracing on
    obs.reset()
    with obs.enabled(), tracing.profiled(torch, prog.dev.type) as prof:
        _sync(torch, prog)
        run_steps(prog, sparse, batches)
        _sync(torch, prog)
    events = prof.events()
    snap = obs.snapshot()
    read = obs_trace.read_trace(events, snap["spans"])
    red = tracing.reduce_profile(torch, prof, sorted(snap["spans"]))
    out["a"] = {"busy_ms": red["busy_s"] / steps * 1e3,
                "unlinked_ms": unlinked(events, snap["spans"], steps),
                "span_ms": {k: v / steps * 1e3
                            for k, v in read["span_s"].items()},
                "backward_ms": {k: v / steps * 1e3
                                for k, v in read["backward_s"].items()},
                "gaps_ms": {k: v / steps * 1e3
                            for k, v in read["gaps_s"].items()},
                "counts": snap["counts"], "device": snap["device"]}
    # (b) tracing on, no profiler
    obs.reset()
    with obs.enabled():
        _sync(torch, prog)
        t = time.perf_counter()
        run_steps(prog, sparse, batches)
        _sync(torch, prog)
        wall = time.perf_counter() - t
    snap = obs.snapshot()
    out["b"] = {"wall_step_ms": wall / steps * 1e3,
                "untraced_step_ms": untraced_step_s * 1e3,
                "cost_pct": (wall / steps / untraced_step_s - 1) * 100,
                "host_ms": {k: sum(v["host_ns"] for v in by.values())
                            / steps * 1e-6
                            for k, by in snap["spans"].items()},
                "spans": snap["spans"], "counts": snap["counts"],
                "device": snap["device"]}
    a, b = out["a"], out["b"]
    if sparse:
        out["side_by_side_ms"] = {
            k: [out["harness_span_ms"].get(k), a["span_ms"].get(k)]
            for k in SPARSE_SPANS}
        given = b["device"].get("optimizer.rows_given_grad", 0)
        # dense updates count on the host, row updates on the device
        passed = b["counts"].get("optimizer.rows_passed", 0) + \
            b["device"].get("optimizer.rows_passed", 0)
        out["metrics"] = {
            "sparse.dispatch_ms": b["host_ms"].get("dpmr.step"),
            "sparse.host_reads": b["counts"].get("host_reads", 0) / steps,
            "sparse.optimizer_useful_share":
                100.0 * given / passed if passed else None}
    else:
        out["metrics"] = {
            "dense.attention_ms": a["span_ms"].get("model.attention"),
            "dense.optimizer_ms": a["span_ms"].get("train.clip", 0.0)
            + a["span_ms"].get("train.optimizer", 0.0)}
    return out


def sync_check(torch, prog, sparse: bool) -> dict:
    """Every synchronising call a few steps make, by the file and line
    of the Python frame that made it: for the sparse face the engine's
    public `train_step` (its reads of the step's values show at
    api/engine.py; any other file is a sync inside the step), for the
    dense face the runner's step."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n = len(prog.batches)
            for i in range(5 if sparse else 2):
                if sparse:
                    prog.eng.train_step(prog.batches[(3 + i) % n])
                else:
                    prog.state, _ = prog.step(prog.state, prog.batches[3 + i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where: dict = {}
    for w in got:
        if "called a synchronizing" not in str(w.message):
            continue
        key = f"{pathlib.Path(w.filename).name}:{w.lineno}: " \
              f"{str(w.message).splitlines()[0][:80]}"
        where[key] = where.get(key, 0) + 1
    torch.cuda.synchronize()
    return {"steps": 5 if sparse else 2, "where": where,
            "outside_engine": sum(v for k, v in where.items()
                                  if not k.startswith("engine.py:"))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    common.set_cache_dirs(ROOT)
    import torch

    from repro_torch import obs

    cell = cells.load(ROOT, args.workload)
    runner = cells.runner(cell)
    sparse = cell.traffic["runner"] == "dpmr_sgd"
    dev = torch.device("cuda", 0)
    result = {"cell": cell.name, "card": common.power_limit(),
              "torch": torch.__version__, "seeds": {}}
    for i, seed in enumerate(args.seeds):
        ctx = cells.Ctx(cell=cell, seed=seed, seconds=args.seconds,
                        trace=False, t0=time.perf_counter())
        prog = runner.Program(torch, ctx, dev)
        prog.checked_steps()
        per = {"windows": windows(torch, prog, args.seconds)}
        if i == 0:
            off = per["windows"]["off1"]["step_s"]
            per["passes"] = passes(torch, prog, sparse,
                                   cell.traffic["trace_steps"], off)
            per["sync"] = sync_check(torch, prog, sparse)
        prog.free()
        del prog
        obs.reset()
        result["seeds"][seed] = per
        common.log(f"[obs] {cell.name} seed {seed}: {json.dumps(per)}")
    costs = [s["windows"]["cost_pct"] for s in result["seeds"].values()]
    result["tracing_cost_pct"] = {"each": costs,
                                  "median": statistics.median(costs)}
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"obs_passes_{cell.name}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
