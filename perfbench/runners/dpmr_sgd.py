"""Runner: sparse DPMR training, `DPMREngine.fit_sgd`, closed loop.

One step after another, from a pool of batches already on the card,
which owns the whole table. The run:

  set-up   the pool of batches (the traffic's generator) and the
           table's initial weights (N(0, init_table_std^2)) from the
           seed on the device; the program's hot set
           (`hot_ids_from_corpus` over the first `hot_sample_batches`);
           the engine, handed the weights as its state; three steps
           through `fit_sgd` on batches 0, 1, 2, which also build and
           warm every kernel: the program's readings (the losses, the
           first gradient's norm by leaf from adagrad's accumulators,
           each leaf's change after the third step)
  window   `fit_sgd` over the pool from batch 3 on, cycling, for
           `--seconds`; samples/s over all of it
  traced   (`--trace 1`) a profiled pass over `trace_steps` batches with
           spans around the routing, the optimizer and the kernel seam,
           the same batches again counting the seam's work, and a
           host-only profile for the host operations a step
  check    the program's state freed, the plain reference
           (`reference/sparse_lr.py`, float64) follows the same three
           steps and the numbers are held to their limits

The leaves are the hot rows and the rest ("cold"), as the reference
works the hot set out from the same batches; the program's own hot set
must equal it (`hot_set_mismatch`, limit 0).
"""
from __future__ import annotations

import gc
import math
import time

from pb import common, compare, gen, roofline, tracing

SPANS = [("repro_torch.core.sparse", "route_build", "routing.route_build",
          False),
         ("repro_torch.core.sparse", "owner_apply", "routing.owner_apply",
          False),
         ("repro_torch.core.sparse", "route_return", "routing.route_return",
          False),
         ("repro_torch.core.sparse", "combine_grads",
          "routing.combine_grads", False),
         ("repro_torch.core.dpmr", "optimize", "optimizer.update", False),
         ("repro_torch.kernels.ops", "sigmoid_grad", "seam.sigmoid_grad",
          True),
         ("repro_torch.kernels.ops", "segment_sum_sorted",
          "seam.segment_sum_sorted", True),
         ("repro_torch.kernels.ops", "sorted_run_totals",
          "seam.sorted_run_totals", True),
         ("repro_torch.kernels.ops", "owner_accumulate",
          "seam.owner_accumulate", True),
         ("repro_torch.kernels.ops", "row_update", "seam.row_update", True)]
CHECKED_STEPS = 3
BLOCK = 1 << 26         # rows a float64 sum over the table takes at a time


def dpmr_config(conf: dict):
    from repro_torch import DPMRConfig

    keys = ("num_features", "max_features_per_sample", "hot_threshold",
            "max_hot", "learning_rate", "optimizer", "adagrad_eps",
            "distribution", "grad_scale", "schedule", "topk_frac")
    return DPMRConfig(**{k: conf[k] for k in keys if k in conf})


def corpus(conf: dict) -> dict:
    return {**conf["corpus"], "num_features": conf["num_features"],
            "features_per_sample": conf["max_features_per_sample"]}


def make_pool(torch, conf, traffic, seed, device):
    return gen.GENERATORS[traffic["generator"]](
        torch, corpus(conf), traffic["batch"], traffic["pool_batches"],
        seed, device)


def make_table(torch, conf, seed, device):
    return gen.normal_table(torch, conf["num_features"],
                            conf["init_table_std"], seed, "table", device)


# --- faults planted in the program (for the checks that must fail) ---------


def plant(variant: str) -> common.Patch:
    """The program with one fault: "fault:unchanged" (the optimizer
    leaves the state as it is), "fault:half_batch" (the second half of
    the rows left out of the gradient, the mean taken over the rest),
    "fault:altered" (one slot's error term off by 1, as a flipped
    label)."""
    from repro_torch.core import dpmr
    from repro_torch.kernels import ops

    patch = common.Patch()
    if variant == "program":
        return patch
    if variant == "fault:unchanged":
        patch.set(dpmr, "optimize",
                  lambda cfg, theta, acc, grad, lr: (theta, acc))
    elif variant in ("fault:half_batch", "fault:altered"):
        real = ops.sigmoid_grad

        def broken(vals, theta, labels):
            grads, probs, nll = real(vals, theta, labels)
            if variant == "fault:half_batch":
                half = grads.shape[0] // 2
                grads = grads.clone()
                grads[half:] = 0.0
                grads[:half] *= 2.0
            else:
                grads = grads.clone()
                grads[0, 0] += 1.0
            return grads, probs, nll

        patch.set(ops, "sigmoid_grad", broken)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return patch


# --- the program -----------------------------------------------------------


def sum_sq64(torch, a, b=None) -> float:
    """The float64 sum of a*a (or of (a - b)^2) over a table, a block of
    rows at a time, so that no float64 copy of the table is made."""
    total = 0.0
    for lo in range(0, a.shape[0], BLOCK):
        d = a[lo:lo + BLOCK].to(torch.float64)
        if b is not None:
            d -= b[lo:lo + BLOCK].to(torch.float64)
        total += float(torch.sum(d * d))
    return total


class Program:
    """The engine on the card, its batches and its readings."""

    def __init__(self, torch, ctx, device):
        from repro_torch import DPMREngine
        from repro_torch.api import hot_ids_from_corpus
        from repro_torch.core import dpmr

        self.torch, self.ctx, self.dev = torch, ctx, device
        conf, traffic = ctx.cell.config, ctx.cell.traffic
        self.cfg = cfg = dpmr_config(conf)
        rows = traffic["batch"]
        pool = make_pool(torch, conf, traffic, ctx.seed, device)
        self.hot = hot_ids_from_corpus(
            cfg, [{"ids": pool["ids"][i]}
                  for i in range(traffic["hot_sample_batches"])],
            device=device)
        if device.type == "cuda":
            # the count over the table is set-up's; hand its memory back
            torch.cuda.empty_cache()
        # per batch: real slots and distinct ids (the step's least work)
        self.work = []
        for i in range(pool["ids"].shape[0]):
            ids = pool["ids"][i].reshape(-1)
            ids = ids[ids >= 0]
            self.work.append(roofline.sparse_step_work(
                rows, conf["max_features_per_sample"], ids.numel(),
                int(torch.unique(ids).numel())))
        self.batches = [{k: pool[k][i] for k in ("ids", "vals", "labels")}
                        for i in range(pool["ids"].shape[0])]
        theta0 = make_table(torch, conf, ctx.seed, device)
        state = dpmr.init_state(cfg, device, self.hot)
        state.cold.copy_(theta0)
        state.hot.copy_(self._hot_values(theta0))
        del theta0
        self.eng = DPMREngine(cfg, device=device, hot_ids=self.hot,
                              state=state)

    def _hot_values(self, theta0):
        torch = self.torch
        f = theta0.shape[0]
        ok = self.hot < f
        return torch.where(ok, theta0[torch.clamp(self.hot, max=f - 1)
                                      .long()], 0.0)

    def checked_steps(self) -> dict:
        """Steps 1-3 through `fit_sgd`, and the program's readings."""
        torch = self.torch
        st = self.eng.state
        hist = self.eng.fit_sgd(self.batches[:1])
        # adagrad's accumulators start at 0: after one step they hold g^2
        grad_norms = {"cold": math.sqrt(self._sum64(st.cold_acc)),
                      "hot": math.sqrt(self._sum64(st.hot_acc))}
        hist += self.eng.fit_sgd(self.batches[1:CHECKED_STEPS])
        st = self.eng.state
        theta0 = make_table(torch, self.ctx.cell.config, self.ctx.seed,
                            self.dev)
        change_norms = {
            "cold": math.sqrt(sum_sq64(torch, st.cold, theta0)),
            "hot": math.sqrt(sum_sq64(torch, st.hot,
                                      self._hot_values(theta0)))}
        del theta0
        hot_ids = st.hot_ids[st.hot_ids < self.cfg.num_features]
        return {"losses": [h["loss"] for h in hist],
                "overflow": sum(h["overflow"] for h in hist),
                "grad_norms": grad_norms, "change_norms": change_norms,
                "hot_ids": hot_ids.to(torch.int64).cpu()}

    def _sum64(self, x) -> float:
        torch = self.torch
        return sum(float(torch.sum(x[lo:lo + BLOCK].to(torch.float64)))
                   for lo in range(0, x.shape[0], BLOCK))

    def batch_stream(self, deadline, start: int, stamps: list):
        n = len(self.batches)
        i = 0
        while not deadline.done(i):
            stamps.append(time.perf_counter())
            yield self.batches[(start + i) % n]
            i += 1

    def window(self, seconds: float) -> dict:
        torch = self.torch
        deadline = tracing.Deadline(seconds)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        deadline.start()
        stamps = []
        hist = self.eng.fit_sgd(self.batch_stream(deadline, CHECKED_STEPS,
                                                  stamps))
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = deadline.elapsed()
        log_steps(stamps)
        n = len(self.batches)
        least = sum(roofline.least_time_s(*self.work[(CHECKED_STEPS + i) % n])
                    for i in range(len(hist)))
        failed = sum(1 for h in hist if h["overflow"] or not
                     math.isfinite(h["loss"]))
        return {"steps": len(hist), "elapsed_s": elapsed, "failed": failed,
                "least_s": least, "p50_ms": common.step_p50_ms(stamps)}

    def traced(self, steps: int) -> dict:
        """The traced pass, the counting pass and the host-only pass,
        each over the same `steps` batches of the pool."""
        torch = self.torch
        n = len(self.batches)
        batches = [self.batches[(CHECKED_STEPS + i) % n]
                   for i in range(steps)]
        names = [s[2] for s in SPANS]
        cuda = self.dev.type == "cuda"
        with tracing.Spans(torch, SPANS), \
                tracing.profiled(torch, self.dev.type) as prof:
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            self.eng.fit_sgd(batches)
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t
        red = tracing.reduce_profile(torch, prof, names)
        with tracing.Spans(torch, SPANS, mode="count") as counting:
            self.eng.fit_sgd(batches)
        seam_least = sum(roofline.least_time_s(b, f)
                         for _, b, f in counting.work)
        with tracing.profiled(torch, self.dev.type, cpu_only=True) as host:
            self.eng.fit_sgd(batches)
        ops = tracing.host_ops(host.events(), steps)
        seam_dev = sum(v for k, v in red["span_device_s"].items()
                       if k.startswith("seam."))
        return {"steps": steps, "window_s": window_s,
                "busy_s": red["busy_s"], "by_name": red["by_name"],
                "span_device_s": red["span_device_s"],
                "idle_gaps": red["idle_gaps"],
                "host_ops": sum(ops.values()),
                "seam_least_s": seam_least, "seam_device_s": seam_dev}

    def free(self):
        del self.eng, self.batches
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


def log_steps(stamps: list) -> None:
    """The window's step times (between batches handed to the program)
    on standard error: their spread within a run."""
    ms = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    if ms:
        q = [ms[int(f * (len(ms) - 1))] for f in (0.1, 0.5, 0.9, 0.99)]
        common.log(f"[window] {len(ms) + 1} steps; step ms p10 {q[0]:.3f} "
                   f"p50 {q[1]:.3f} p90 {q[2]:.3f} p99 {q[3]:.3f}")


# --- the reference ----------------------------------------------------------


def reference_readings(torch, ctx, device, dtype) -> dict:
    """The plain reference's readings for the cell's first steps, from the
    seed's inputs (made again here), in `dtype`."""
    from reference import sparse_lr

    conf, traffic = ctx.cell.config, ctx.cell.traffic
    pool = make_pool(torch, conf, traffic, ctx.seed, device)
    hot = sparse_lr.hot_set(
        torch, [pool["ids"][i] for i in range(traffic["hot_sample_batches"])],
        conf["num_features"], conf["hot_threshold"], conf["max_hot"])
    batches = [{k: pool[k][i] for k in ("ids", "vals", "labels")}
               for i in range(CHECKED_STEPS)]
    theta0 = make_table(torch, conf, ctx.seed, device)
    out = sparse_lr.train(torch, theta0, batches,
                          lr=conf["learning_rate"], eps=conf["adagrad_eps"],
                          dtype=dtype, hot_ids=hot)
    out["hot_ids"] = hot.cpu()
    return out


def numbers(torch, prog: dict, ref: dict) -> dict:
    out = compare.training_numbers(prog, ref)
    a, b = prog["hot_ids"], ref["hot_ids"]
    out["hot_set_mismatch"] = 0 if torch.equal(a, b) else int(
        max(a.numel(), b.numel()) - torch.isin(a, b).sum())
    return out


# --- the tasks --------------------------------------------------------------


def layer_readings(win: dict, tr: dict) -> dict:
    """What the per-layer readers read, from the window and the traced
    pass."""
    return {"traced_steps": tr["steps"], "busy_s": tr["busy_s"],
            "traced_window_s": tr["window_s"],
            "wall_per_step_s": win["elapsed_s"] / win["steps"],
            "window_least_s": win["least_s"],
            "window_elapsed_s": win["elapsed_s"],
            "by_name": tr["by_name"], "span_device_s": tr["span_device_s"],
            "host_ops_per_step": tr["host_ops"],
            "seam_least_s": tr["seam_least_s"],
            "seam_device_s": tr["seam_device_s"]}


def run(ctx):
    import torch

    dev = common.device(torch, ctx)
    patch = plant(ctx.variant)
    try:
        prog = Program(torch, ctx, dev)
        readings = prog.checked_steps()
        setup_s = common.end_setup(ctx.t0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        win = prog.window(ctx.seconds)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        tr = prog.traced(ctx.cell.traffic["trace_steps"]) if ctx.trace \
            else None
        prog.free()
        del prog
    finally:
        gc.unfreeze()
        patch.undo()
    ref = reference_readings(torch, ctx, dev, torch.float64)
    nums = numbers(torch, readings, ref)
    correct, checks = compare.judge(nums, ctx.cell.limits)
    rows = ctx.cell.traffic["batch"]
    out = {"correct": correct, "checks": checks,
           "attempted": CHECKED_STEPS + win["steps"],
           "failed": win["failed"] + (1 if readings["overflow"] else 0),
           "memory_peak_bytes": peak, "step_p50_ms": win["p50_ms"],
           "e2e": {"setup_s": setup_s,
                   "sparse_samples_per_s": win["steps"] * rows
                   / win["elapsed_s"],
                   "peak_mem_gib": peak / 2 ** 30}}
    if tr is not None:
        layer = layer_readings(win, tr)
        out["layer"] = layer
        out["busy_s"] = layer["busy_s"]
        out["window_s"] = layer["traced_window_s"]
        out["breakdown"] = {"device_ops": tracing.top10(layer["by_name"]),
                            "idle_gaps": tracing.top10(tr["idle_gaps"])}
    return out


def calibrate(ctx, seeds, variants):
    """For each seed: the program's readings under each variant (set-up
    and the checked steps, no window) and the control's, each held
    against the reference's. Returns rows of numbers."""
    import torch

    dev = common.device(torch, ctx)
    rows = []
    for seed in seeds:
        ctx.seed = seed
        got = {}
        for variant in variants:
            if variant == "control":
                continue
            patch = plant(variant)
            try:
                prog = Program(torch, ctx, dev)
                got[variant] = prog.checked_steps()
                prog.free()
                del prog
            finally:
                patch.undo()
        ref = reference_readings(torch, ctx, dev, torch.float64)
        if "control" in variants:
            got["control"] = reference_readings(torch, ctx, dev,
                                                torch.bfloat16)
        for variant, prog_r in got.items():
            rows.append({"seed": seed, "variant": variant,
                         **numbers(torch, prog_r, ref),
                         "losses": prog_r["losses"],
                         "ref_losses": ref["losses"]})
        common.log(f"[calibrate] seed {seed}: {rows[-len(got):]}")
    return rows
