"""The port's spans and counters: the one place where they live.

    span(name, group=None)     a context manager around one layer's work
    spanned(name, group=None)  the same around every call of a function
    count(name, n=1)           a host counter; always counts
    count_device(name, t)      adds t's sum into a device accumulator,
                               only while tracing is on
    enabled()                  turns tracing on for a `with` block
    tracing()                  whether it is on
    snapshot(), reset()        read (the one sync) and clear all of it

Tracing is off by default. Then `span` returns one shared no-op context
after a single module-level flag check: it enters no `record_function`,
reads no clock, allocates nothing, launches nothing and never
synchronises. On, a span enters `torch.profiler.record_function(name)`,
so that under an active profiler it lies in the same trace as the
card's operations on one clock, and adds its host time
(`time.perf_counter_ns`) to an aggregate keyed by (name, parent span):
calls, total host ns and self host ns, in bounded memory. It records no
device time; that comes only from a profiler. A span of a `group` opens
only at the group's top level: a nested call of the same group (one
seam function calling another) opens none.

Spans and counters of the port:

  dpmr.step                 the sparse step functions' bodies
                            (core/dpmr.py): host time a step, the
                            host's dispatch (C9)
  optimizer.update          core.dpmr.optimize, on the table and on the
                            hot set
  routing.route_build, routing.owner_apply, routing.route_return,
  routing.combine_grads     core/sparse.py
  seam.sigmoid_grad, seam.segment_sum_sorted, seam.sorted_run_totals,
  seam.owner_accumulate     kernels/ops.py, group "seam"
  train.clip, train.optimizer
                            the dense step's clipping and optimizer
                            (train/trainer.py)
  model.attention           the attention core of models.layers.
                            attention_block
  host_reads                device values read by the host in
                            api/engine.py's train_step, fit,
                            learning_rate and host_step
  optimizer.row_updates, optimizer.dense_updates
                            core.dpmr.optimize calls by the path they
                            take: a RowGrad to the row update, a dense
                            gradient to the dense update (host)
  optimizer.rows_passed     rows each core.dpmr.optimize call passes
                            over: a dense call's whole table (host), a
                            row call's written rows (device)
  optimizer.rows_given_grad rows that receive a gradient: the run ends
                            that ops.owner_accumulate scatters into its
                            block, a row call's written rows, and the
                            distinct hot slots of core.dpmr.hot_grads
                            (device)
  launch.<kernel>           each kernel wrapper's launches
                            (kernels.ops.launch_counts)
  loader.wait_s, loader.batches
                            the consumer's wait for prefetched batches
                            (data/loader.py)
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: dict[tuple[str, str | None], list[int]] = {}
_counts: dict[str, int | float] = {}
_device: dict[str, torch.Tensor] = {}


def tracing() -> bool:
    """Whether tracing is on: for work that only a device counter reads."""
    return _on


@contextlib.contextmanager
def enabled():
    """Tracing on for the block (and back to what it was after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def _thread():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
        _local.groups = {}
    return st


class _Span:
    __slots__ = ("name", "group", "rf", "t0", "child_ns")

    def __init__(self, name: str, group: str | None):
        self.name, self.group = name, group
        self.child_ns = 0

    def __enter__(self):
        st = _thread()
        if self.group is not None:
            _local.groups[self.group] = _local.groups.get(self.group, 0) + 1
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        st = _local.stack
        st.pop()
        self.rf.__exit__(*exc)
        if self.group is not None:
            _local.groups[self.group] -= 1
        key = (self.name, st[-1].name if st else None)
        with _lock:
            agg = _spans.get(key)
            if agg is None:
                agg = _spans[key] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child_ns
        if st:
            st[-1].child_ns += dt
        return False


def span(name: str, group: str | None = None):
    """A span around a `with` block: a no-op while tracing is off, and
    inside an open span of the same `group`."""
    if not _on:
        return _NULL
    _thread()
    if group is not None and _local.groups.get(group):
        return _NULL
    return _Span(name, group)


def spanned(name: str, group: str | None = None):
    """Decorator: every call of the function inside `span(name, group)`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with span(name, group):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def count(name: str, n: int | float = 1) -> None:
    """Adds `n` to the host counter `name`, whether tracing is on or not."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """While tracing is on, adds the sum of `t` (a mask, a count) into the
    device accumulator `name`, with no sync; off, does nothing."""
    if not _on:
        return
    dt = torch.float64 if t.is_floating_point() else torch.int64
    v = t.sum(dtype=dt)
    with _lock:
        acc = _device.get(name)
        if acc is None:
            _device[name] = v
        else:
            acc.add_(v)


def counts(prefix: str = "") -> dict:
    """The host counters whose names start with `prefix`."""
    with _lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Clears the host counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


def snapshot() -> dict:
    """The span aggregates, host counters and device counters; reading
    the device counters is the only sync. `spans[name][parent]` holds
    `calls`, `host_ns` and `self_ns` (parent "" at the top level)."""
    with _lock:
        spans: dict = {}
        for (name, parent), (calls, total, own) in _spans.items():
            spans.setdefault(name, {})[parent or ""] = {
                "calls": calls, "host_ns": total, "self_ns": own}
        device = {k: v.item() for k, v in _device.items()}
    return {"spans": spans, "counts": dict(_counts), "device": device}


def reset() -> None:
    """Clears the span aggregates and every counter."""
    with _lock:
        _spans.clear()
        _counts.clear()
        _device.clear()

