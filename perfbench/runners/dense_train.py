"""Runner: dense training, the step that `train.trainer.make_train_step`
builds (as `launch/train.py --arch` builds it), closed loop on one card.

  set-up   the weights (every matrix from one draw on the card, the norm
           scales ones; `reference/dense_lm.py`'s names and layouts) and
           a pool of `lm_markov` batches from the seed; the program's
           train state from those weights (`trainer.init_from_params`:
           f32 masters, adamw's moments zero); three steps through the
           window's own call on batches 0, 1, 2, which warm every shape:
           the program's readings (each step's loss, the first clipped
           gradient's norm by leaf, worked out from adamw's second
           moment after step 1, each leaf's change after step 3)
  window   the step over the pool from batch 3 on, cycling, reading
           each step's loss as `launch.train.train_loop` does, for
           `--seconds`; tokens/s over all of it
  traced   (`--trace 1`) a profiled pass over `trace_steps` batches
  check    the program's state freed, the plain reference (float32, TF32
           off) follows the same three steps from the same weights and
           the numbers are held to their limits
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

from pb import common, compare, gen, roofline, tracing

CHECKED_STEPS = 3


def configs(conf: dict):
    """(spec, ModelConfig, TrainConfig, ParallelConfig) of the port for
    the configuration file `conf`."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry

    spec = registry.get_spec(conf["arch"])
    num = conf["numerics"]
    if conf["hidden_act"] != "silu" or spec.cfg.family != "dense":
        raise ValueError("the dense runner trains SwiGLU decoder-only models")
    cfg = dataclasses.replace(
        spec.cfg, num_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        head_dim=0, rope_theta=conf["rope_theta"],
        norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"], mlp_type="swiglu",
        dtype=num["activations"], param_dtype=num["params"],
        opt_dtype=num["optimizer_state"])
    t = conf["training"]
    if t["final_lr_fraction"] != 0.1:
        raise ValueError("the port's warmup_cosine decays to 0.1 of the "
                         "learning rate")
    tc = TrainConfig(learning_rate=t["learning_rate"],
                     warmup_steps=t["warmup_steps"],
                     total_steps=t["total_steps"],
                     weight_decay=t["weight_decay"], beta1=t["beta1"],
                     beta2=t["beta2"], grad_clip=t["grad_clip"],
                     optimizer=t["optimizer"])
    return spec, cfg, tc, ParallelConfig(remat=conf["remat"])


def make_weights(torch, conf: dict, seed: int, device) -> dict:
    from reference import dense_lm

    return dense_lm.make_params(
        torch, conf, lambda n: gen.normal_table(torch, n, 1.0, seed,
                                                "weights", device))


def make_pool(torch, conf, traffic, seed, device) -> list:
    pool = gen.GENERATORS[traffic["generator"]](
        torch, conf["vocab_size"], traffic["seq"], traffic["batch"],
        traffic["pool_batches"], seed, device, branch=traffic["branch"],
        noise=traffic["noise"])
    return [{"tokens": pool["tokens"][i], "labels": pool["labels"][i]}
            for i in range(traffic["pool_batches"])]


# --- faults planted in the program ------------------------------------------


ALTERED_LEAF = "layers.0.mlp.wo"


def plant(variant: str) -> common.Patch:
    """The program with one fault: "fault:unchanged" (adamw leaves
    parameters and moments as they are), "fault:half_batch" (the loss,
    and so the gradient, over the first half of the rows only),
    "fault:altered" (one value of one gradient leaf off by that leaf's
    norm, where the step produces it)."""
    from repro_torch.models import common as mcommon
    from repro_torch.optim import optimizers
    from repro_torch.train import trainer

    patch = common.Patch()
    if variant == "program":
        return patch
    if variant == "fault:unchanged":
        real = optimizers.OPTIMIZERS["adamw"]
        patch.set(optimizers.OPTIMIZERS, "adamw", optimizers.Optimizer(
            real.init, lambda grads, state, params, lr, cfg:
            (params, state)), item=True)
    elif variant == "fault:half_batch":
        real = mcommon.cross_entropy

        def half(logits, labels, mask=None):
            h = labels.shape[0] // 2
            return real(logits[:h], labels[:h])

        patch.set(mcommon, "cross_entropy", half)
    elif variant == "fault:altered":
        real = trainer._accumulate

        def altered(*args, **kwargs):
            grads, loss, m = real(*args, **kwargs)
            g = grads[ALTERED_LEAF]
            g.view(-1)[0] += g.float().norm().to(g.dtype)
            return grads, loss, m

        patch.set(trainer, "_accumulate", altered)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return patch


# --- the program ---------------------------------------------------------------


class Program:
    def __init__(self, torch, ctx, device):
        from repro_torch.train import trainer

        self.torch, self.ctx, self.dev = torch, ctx, device
        conf, traffic = ctx.cell.config, ctx.cell.traffic
        self.spec, self.cfg, self.tc, self.pc = configs(conf)
        self.batches = make_pool(torch, conf, traffic, ctx.seed, device)
        params = make_weights(torch, conf, ctx.seed, device)
        self.state = trainer.init_from_params(self.spec, self.cfg, self.tc,
                                              self.pc, params, device)
        del params
        got = {n: tuple(p.shape) for n, p in
               self.state["params"].named_parameters()}
        from reference import dense_lm
        want = {n: tuple(s) for n, s in dense_lm.param_shapes(conf)}
        if got != want:
            raise ValueError(f"the program's parameters {got} are not the "
                             f"benchmark's {want}")
        self.step = trainer.make_train_step(self.spec, self.cfg, self.tc,
                                            self.pc)

    def one(self, batch) -> float:
        self.state, m = self.step(self.state, batch)
        return float(m["loss"])

    def checked_steps(self) -> dict:
        torch = self.torch
        losses = [self.one(self.batches[0])]
        beta2 = self.tc.beta2
        grad_norms = {n: math.sqrt(float(torch.sum(v.to(torch.float64)))
                                   / (1 - beta2))
                      for n, v in self.state["opt"]["v"].items()}
        losses += [self.one(b) for b in self.batches[1:CHECKED_STEPS]]
        start = make_weights(torch, self.ctx.cell.config, self.ctx.seed,
                             self.dev)
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(
                (p.detach() - start[n]).to(torch.float64)))
                for n, p in self.state["params"].named_parameters()}
        del start
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change}

    def window(self, seconds: float) -> dict:
        torch = self.torch
        deadline = tracing.Deadline(seconds)
        n = len(self.batches)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        deadline.start()
        steps = failed = 0
        stamps = []
        while not deadline.done(steps):
            stamps.append(time.perf_counter())
            loss = self.one(self.batches[(CHECKED_STEPS + steps) % n])
            steps += 1
            failed += not math.isfinite(loss)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return {"steps": steps, "elapsed_s": deadline.elapsed(),
                "failed": failed, "p50_ms": common.step_p50_ms(stamps)}

    def traced(self, steps: int) -> dict:
        torch = self.torch
        n = len(self.batches)
        cuda = self.dev.type == "cuda"
        with tracing.profiled(torch, self.dev.type) as prof:
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(steps):
                self.one(self.batches[(CHECKED_STEPS + i) % n])
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t
        red = tracing.reduce_profile(torch, prof)
        return {"steps": steps, "window_s": window_s, **red}

    def free(self):
        del self.state, self.step, self.batches
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


def reference_readings(torch, ctx, device, precision="float32") -> dict:
    from reference import dense_lm

    conf = ctx.cell.config
    batches = make_pool(torch, conf, ctx.cell.traffic, ctx.seed,
                        device)[:CHECKED_STEPS]
    return dense_lm.train(
        torch, conf, lambda: make_weights(torch, conf, ctx.seed, device),
        batches, precision)


def run(ctx):
    import torch

    from reference import dense_lm

    dev = common.device(torch, ctx)
    patch = plant(ctx.variant)
    try:
        prog = Program(torch, ctx, dev)
        readings = prog.checked_steps()
        setup_s = common.end_setup(ctx.t0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        win = prog.window(ctx.seconds)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        tr = prog.traced(ctx.cell.traffic["trace_steps"]) if ctx.trace \
            else None
        prog.free()
        del prog
    finally:
        gc.unfreeze()
        patch.undo()
    ref = reference_readings(torch, ctx, dev)
    correct, checks = compare.judge(compare.training_numbers(readings, ref),
                                    ctx.cell.limits)
    conf, traffic = ctx.cell.config, ctx.cell.traffic
    tokens = traffic["batch"] * traffic["seq"]
    out = {"correct": correct, "checks": checks,
           "attempted": CHECKED_STEPS + win["steps"],
           "failed": win["failed"] + sum(
               not math.isfinite(x) for x in readings["losses"]),
           "memory_peak_bytes": int(peak), "step_p50_ms": win["p50_ms"],
           "e2e": {"setup_s": setup_s,
                   "dense_tokens_per_s": win["steps"] * tokens
                   / win["elapsed_s"],
                   "peak_mem_gib": peak / 2 ** 30}}
    if tr is not None:
        n = dense_lm.dims(conf)
        out["layer"] = {
            "traced_steps": tr["steps"], "busy_s": tr["busy_s"],
            "traced_window_s": tr["window_s"], "by_name": tr["by_name"],
            "wall_per_step_s": win["elapsed_s"] / win["steps"],
            "window_steps": win["steps"],
            "window_elapsed_s": win["elapsed_s"],
            "model_flops_per_step": roofline.dense_model_flops(
                dense_lm.product_params(conf), n["layers"], n["h"],
                n["hd"], traffic["batch"], traffic["seq"])}
        out["busy_s"] = tr["busy_s"]
        out["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tracing.top10(tr["by_name"]),
                            "idle_gaps": tracing.top10(tr["idle_gaps"])}
    return out


def calibrate(ctx, seeds, variants):
    """For each seed: the program's readings under each variant and the
    control's (the reference with fp8 products), each held against the
    reference's. Returns rows of numbers."""
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
        t = time.perf_counter()
        ref = reference_readings(torch, ctx, dev)
        ref_s = time.perf_counter() - t
        if "control" in variants:
            got["control"] = reference_readings(torch, ctx, dev, "fp8")
        for variant, r in got.items():
            rows.append({"seed": seed, "variant": variant,
                         **compare.training_numbers(r, ref),
                         "losses": r["losses"], "ref_losses": ref["losses"],
                         "ref_s": ref_s})
        common.log(f"[calibrate] seed {seed}: {rows[-len(got):]}")
    return rows
