"""A profiler trace of the port, cut by the program's own spans
(`repro_torch.obs`): device time under each span, the autograd engine's
work attributed to the span whose forward made it, and the device's idle
gaps named by the span open at each. `scripts/obs_passes.py` reads a
cell's traced steps with it; `tests/test_torch_obs.py` checks it on the
CPU.
"""
from __future__ import annotations

BACKWARD = "autograd::engine::evaluate_function: "


def _chain(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def read_trace(events, names, clock: str = "device") -> dict:
    """The time of a profile (`prof.events()` of `torch.profiler`, taken
    with tracing on) by the spans in `names`, in seconds.

    `span_s[name]`: the time under every outermost occurrence of `name`,
    each operation counted once a name. `backward_s[name]`: the part of
    it that the autograd engine ran for operations made under `name` in
    the forward (an `evaluate_function` event with no span of its own
    inside, linked to the forward by its `sequence_nr` and forward
    thread); a forward run again inside the backward (remat) counts under
    its own spans. `gaps_s[name]`: the device's idle gaps, each named by
    the innermost span open on the main thread at its middle ("no span"
    when none). `clock="device"` weighs each operation by the kernels it
    launched; `clock="cpu"` by its own host time (no gaps then)."""
    from torch.autograd import DeviceType

    names = set(names)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # the spans around the forward op that made each autograd node: the
    # last op to record a sequence number on its thread made the node
    fwd: dict = {}
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        if e.sequence_nr < 0:
            continue
        chain = list(_chain(e))
        if any(a.name.startswith(BACKWARD) for a in chain):
            continue
        fwd[(e.thread, e.sequence_nr)] = {a.name for a in chain
                                          if a.name in names}
    span_us: dict = {}
    back_us: dict = {}
    for e in cpu:
        if clock == "device":
            w = sum(k.duration for k in e.kernels if k.name not in names)
        else:
            w = e.self_cpu_time_total
        if w <= 0:
            continue
        found, bwd = set(), None
        for a in _chain(e):
            if a.name in names:
                found.add(a.name)
            elif bwd is None and not found and a.name.startswith(BACKWARD):
                bwd = a
        if bwd is not None:
            for n in fwd.get((bwd.fwd_thread, bwd.sequence_nr), ()):
                back_us[n] = back_us.get(n, 0.0) + w
                found.add(n)
        for n in found:
            span_us[n] = span_us.get(n, 0.0) + w
    out = {"span_s": {k: v * 1e-6 for k, v in span_us.items()},
           "backward_s": {k: v * 1e-6 for k, v in back_us.items()},
           "gaps_s": {}}
    if clock == "device":
        out["gaps_s"] = _gaps(events, cpu, names)
    return out


def _gaps(events, cpu, names) -> dict:
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in names
                 and not e.name.startswith("ProfilerStep"))
    merged: list = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    top = [e for e in cpu if e.cpu_parent is None]
    if not top:
        return {}
    threads = [e.thread for e in top]
    main = max(set(threads), key=threads.count)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.thread == main and e.name in names]
    gaps: dict = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid, best, name = (a + b) / 2, None, "no span"
        for s, t, n in spans:
            if s <= mid <= t and (best is None or s >= best):
                best, name = s, n
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return gaps
