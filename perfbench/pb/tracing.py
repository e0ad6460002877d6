"""Spans around the program's functions, and the reduction of a profiler
trace to the numbers the per-layer metrics read.

The program has no spans of its own yet. For a traced run only, `Spans`
wraps named functions of the program's modules in
`torch.profiler.record_function`, and restores them on exit; the
untraced runs call the program untouched. In "count" mode it records,
instead of spans, the work of each top-level call of the kernel seam
(`roofline.seam_call_work`), synchronising as it needs: that pass is
never timed.
"""
from __future__ import annotations

import contextlib
import importlib
import time

from pb import roofline

GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


class Spans:
    """`patches`: (module name, attribute, span name, is_seam). A seam
    function's nested calls (one seam function calling another) get no
    span of their own and are not counted again."""

    def __init__(self, torch, patches, mode: str = "trace"):
        if mode not in ("trace", "count"):
            raise ValueError(f"unknown span mode {mode!r}")
        self.torch = torch
        self.patches = patches
        self.mode = mode
        self.depth = 0
        self.work = []          # (seam name, bytes, FLOPs) in count mode
        self._saved = []

    def _wrap(self, fn, span: str, seam: bool, short: str):
        torch = self.torch

        def wrapped(*args, **kwargs):
            if seam and self.depth:
                return fn(*args, **kwargs)
            if self.mode == "count":
                if not seam:
                    return fn(*args, **kwargs)
                self.depth += 1
                try:
                    out = fn(*args, **kwargs)
                finally:
                    self.depth -= 1
                touched = None
                if short == "owner_accumulate":
                    touched = touched_rows(torch, args[0], args[2], args[3])
                elif short == "row_update":
                    # the run ends name distinct ids: the rows written
                    touched = touched_rows(torch, args[3], args[1], args[5])
                self.work.append((short, *roofline.seam_call_work(
                    short, args, out, touched)))
                return out
            with torch.profiler.record_function(span):
                if not seam:
                    return fn(*args, **kwargs)
                self.depth += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.depth -= 1

        return wrapped

    def __enter__(self):
        for mod_name, attr, span, seam in self.patches:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, span, seam, attr))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


def touched_rows(torch, req_ids, acc_local, base: int) -> int:
    """Distinct ids of `req_ids` inside the owner block [base, base +
    rows): the rows an owner-side accumulate adds to."""
    ids = req_ids.reshape(-1).to(torch.int64)
    local = ids - int(base)
    keep = (ids >= 0) & (local >= 0) & (local < acc_local.shape[0])
    return int(torch.unique(ids[keep]).numel())


def _union(intervals):
    """Total length and merged list of (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def reduce_profile(torch, prof, span_names=()) -> dict:
    """From a CPU + CUDA profile: the device busy time (the union of every
    device operation's interval: kernels, copies, memsets), the device
    time by operation name, the device time under each span (the
    kernels that the span's host calls launched), and the idle gaps
    between device operations, each named by the top-level host
    operation of the main thread that was running at its middle. All in
    seconds."""
    from torch.autograd import DeviceType

    spans = set(span_names)
    dev, by_name, under = [], {}, {}
    top = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # record_function's ranges (the harness's spans) also appear
            # on the device timeline: they are annotations, not operations
            if getattr(e, "is_user_annotation", False) or e.name in spans \
                    or e.name.startswith("ProfilerStep"):
                continue
            s, t = e.time_range.start, e.time_range.end
            dev.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) * 1e-6
        elif e.device_type == DeviceType.CPU:
            if e.name in spans:
                under[e.name] = under.get(e.name, 0.0) + \
                    e.device_time_total * 1e-6
            if e.cpu_parent is None:
                top.append(e)
    busy_us, merged = _union(dev)
    gaps = {}
    if top:
        threads = [e.thread for e in top]
        main = max(set(threads), key=threads.count)
        host = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in top if e.thread == main)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) / 2
            name = "no host operation"
            for s, t, n in host:
                if s <= mid <= t:
                    name = n
                if s > mid:
                    break
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy_us * 1e-6, "by_name": by_name,
            "span_device_s": under, "idle_gaps": gaps}


def top10(d: dict) -> list:
    """The 10 largest entries of {name: seconds} as [name, seconds]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def gemm_seconds(by_name: dict) -> float:
    """Device seconds of the cuBLAS and CUTLASS matrix products, matched
    by kernel name."""
    return sum(v for k, v in by_name.items()
               if any(m in k.lower() for m in GEMM_MARKS))


def host_ops(events, n: int) -> dict:
    """The top-level host operations of a CPU-only trace over `n` steps
    (the torch calls the program made on its main thread, not those they
    made in turn), a step: name -> calls (a copy of `chip_smoke.host_ops`'
    count)."""
    from torch.autograd import DeviceType

    top = [e for e in events if e.device_type == DeviceType.CPU
           and e.cpu_parent is None]
    if not top:
        return {}
    threads = [e.thread for e in top]
    main = max(set(threads), key=threads.count)
    out = {}
    for evt in top:
        if evt.thread == main:
            out[evt.name] = out.get(evt.name, 0.0) + 1.0 / n
    return out


@contextlib.contextmanager
def profiled(torch, device_type: str, cpu_only: bool = False):
    """A torch.profiler over CPU and, on the card, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda" and not cpu_only:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


class Deadline:
    """The end of a measured window `seconds` after `start()`."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = None

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def done(self, i: int) -> bool:
        return self.elapsed() >= self.seconds
