"""Learning-rate schedules: the counterpart of `repro.optim.schedules`.

A schedule maps the step counter, a 0-d int32 tensor, to a 0-d f32
tensor on the same device, so the train step reads its learning rate
without a round trip to the host.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        # tensor divisors: on CUDA a Python scalar divides as a product
        # with its reciprocal, not as the reference's division
        warm = lr * torch.clamp(
            step / step.new_full((), float(max(warmup_steps, 1))), max=1.0)
        prog = torch.clamp(
            (step - warmup_steps)
            / step.new_full((), float(max(total_steps - warmup_steps, 1))),
            0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def get_schedule(cfg):
    """The dense trainer's schedule from a `TrainConfig`: warmup_cosine
    when it has warmup steps, else constant."""
    if cfg.warmup_steps:
        return warmup_cosine(cfg.learning_rate, cfg.warmup_steps,
                             cfg.total_steps)
    return constant(cfg.learning_rate)


def _warmup_cosine_checked(lr, warmup_steps=0, total_steps=0):
    if total_steps <= warmup_steps:
        raise ValueError(
            f"warmup_cosine needs total_steps > warmup_steps, got "
            f"total_steps={total_steps}, warmup_steps={warmup_steps}")
    return warmup_cosine(lr, warmup_steps, total_steps)


SCHEDULES = {
    "constant": lambda lr, warmup_steps=0, total_steps=0: constant(lr),
    "warmup_cosine": _warmup_cosine_checked,
}


def get_schedule_by_name(name: str, lr: float, *, warmup_steps: int = 0,
                         total_steps: int = 0):
    try:
        factory = SCHEDULES[name]
    except KeyError:
        raise KeyError(f"unknown schedule {name!r}; "
                       f"registered: {sorted(SCHEDULES)}") from None
    return factory(lr, warmup_steps=warmup_steps, total_steps=total_steps)
