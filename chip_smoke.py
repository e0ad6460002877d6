#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, in order; any failure exits non-zero:
  1. device   require CUDA; print the card's name and power limit
  2. build    nvcc-build the port's CUDA kernels from src/repro_torch/
              kernels/csrc (sm_90a), print the build seconds; from
              ptxas' reports, the registers, spills (must be 0 in
              flash_attention, select_pack and segment_sum) and shared
              memory (must fit a block) of each kernel, and the number
              of select_pack's 16-CTA clusters the card places at once
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes and on adversarial inputs
              (`select_pack` bit for bit on both of its paths,
              `segment_sum_sorted` and `sigmoid_grad` bit-reproducible;
              `segment_sum_sorted` also captured in a CUDA graph, its
              replays bit-identical to eager calls, one kernel and no
              memset a replay; `sigmoid_grad` also at (262144, 64), with
              an empty kernel and one round trip on its grid at both
              shapes and its wrapper's host time split into parts). Two
              times each:
              `ms`/`plain_ms` are device time from a torch.profiler
              (CUPTI) trace, the mean over 20 calls after a warm-up call
              (every device operation of the call; for sigmoid_grad and
              flash_attention, their kernels by name), with the
              operations a call runs from the same trace (one kernel and
              no memset for sigmoid_grad and segment_sum_sorted; at most
              two kernels and no memset for select_pack at the main
              path's shape);
              `call_ms`/`plain_call_ms` are the median of 50 single calls
              timed by CUDA events after 5 warm-up calls (host dispatch
              included). Beside them the bound and, where one PyTorch
              call computes the same function, its time (`library_ms`)
  4. engine   DPMREngine at full width (2^27 features, K=64, batch 4096,
              adagrad lr 2.0, max_hot 512), twice on the same
              device-resident batches: `a2a`, then `topk_reduce` at
              topk_frac 0.05. Each: hot set from 4 batches, fit_sgd for
              20 steps with the kernel launch counters set to 0 just
              before and read just after, a full-batch fit iteration, a
              profiled window of 8 steps, evaluate on 3 held-out batches
              (start=1000)
  5. multirank  the same engine through an NCCL process group of one
              rank (a file store, device_id set): a2a and topk_reduce for
              8 steps, overlap_a2a for 4, each from the same state on the
              same batches as an engine with no group; the states after
              the steps bit-identical, the kernels launched, NCCL's
              collectives and the device operations inside their
              annotated spans in a host and device trace (at one rank
              NCCL runs them as copies); step medians and samples/s with
              and without the group, walls in turns, the host operations
              the group adds a step (the c10d collectives among them)
              against the wall it adds, host µs of a collective
  6. p8       the buffers of a P = 8 routing on one card: a global batch
              of 8 x 4096 samples at 2^27, each rank's rows routed to 8
              owners of 2^24 rows, the all_to_alls as transposes of the
              stacked buffers; each owner's owner_accumulate and
              segment_sum_sorted against the plain versions, the
              run-length histogram of the received buffers (a run longer
              than 1 required), select_pack on the 8-row send buffers bit
              for bit, the 8 owners' gradient against the P = 1 gradient
              of the same samples; segment_sum_sorted, owner_accumulate
              and select_pack timed at one owner's (8, cap)
  7. parity   both strategies at 2^20 features on the card and on the CPU
              from the same batches; run-to-run bit reproducibility of
              the card's gradient step and of topk_reduce's carry
  8. attention  yi-6b at full width (32 layers, bf16) built on the card
              from a torch.Generator seeded 0; `flash_attention` against
              its plain version on layer 0's q, k, v of a (1, 4096)
              prefill, and on adversarial shapes (D = 64, MHA, MQA with
              group 48, ragged S, Sq < Skv, full attention, Sq = 1, the
              kernel's tile edges); timed at the serve path's (8, 4096)
              with its plain version and scaled_dot_product_attention as
              the yardstick; the timed call's own output held to the
              plain version, and 3 calls bit-identical
  9. serve    greedy_decode of yi-6b, batch 8 x prompt 4096 (numpy seed
              0), 32 steps, with the launch counters set to 0 just before
              and read just after (flash_attention: 32, all in prefill);
              then prefill and each decode step timed alone, a profiled
              prefill and a profiled window of decode steps
  10. dense parity  yi-6b at full width with 2 layers, weights from a CPU
              generator copied to the card: prefill (2 x 256) and 4
              decode steps on the card and on the CPU; the card's prefill
              again with the plain attention put in the kernel's place
Then one `{"kernels": [...]}` line, and last the device line
`{"ok": true, "device": {...}}`. Measurements also go to
results/chip_smoke.json.
"""
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
SMEM_PER_BLOCK = 232448        # H100 shared memory a block can use
LOG2_F, K, BATCH, STEPS = 27, 64, 4096, 20
TOPK_FRAC = 0.05
SEED = 0
ARCH = "yi-6b"
SERVE_BATCH, PROMPT, DECODE_STEPS = 8, 4096, 32
ATTN_TOL = 2e-2                # the reference's bf16 attention tolerance


def log(msg):
    print(msg, flush=True)


def bound(nbytes, nflops, peak_flops=F32_FLOPS):
    """Least time in ms for the work: the larger of its bytes over the
    memory rate and its operations over the peak rate for their type
    (f32 outside the tensor cores unless `peak_flops` says otherwise)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nflops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def time_ms(torch, fn, iters=50, warmup=5):
    """Median per-call time in ms of `fn` over `iters` calls, each timed
    by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_times(torch, fn, iters=20, counts=None):
    """Device time per call of `fn` in ms, by kernel name, from a
    torch.profiler (CUPTI) trace of `iters` calls after one warm-up call.
    Unlike CUDA events around one call, this leaves out the host's
    dispatch time while the card waits. Every device operation counts:
    kernels, memsets and copies. With `counts` (a dict), it is filled
    from the same trace with each operation's launches per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            out[evt.key] = out.get(evt.key, 0.0) + us / iters / 1e3
            if counts is not None:
                counts[evt.key] = counts.get(evt.key, 0) + evt.count / iters
    return out


def events_ms(torch, fn, iters=50):
    """Mean ms per call of `iters` back-to-back calls of `fn` between two
    CUDA events, after one warm-up call. Host gaps between the launches
    count too, so on a host-bound call this is above the device time."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def kernel_and_call_ms(torch, fn, names, iters=50, counts=None):
    """(device ms of the kernels whose names contain one of `names`, or
    of all kernels when `names` is empty; ms of one call by CUDA events).

    A profiler trace that shows none of those kernels, or that counts an
    operation a fractional number of times a call, is taken again, up to
    3 traces in all, and the last is kept (on the H100 a trace has come
    back without the kernels it timed, and one has lost one launch of 20;
    an operation that a function runs on only some calls counts a
    fraction in every trace). If no trace saw the kernels, the device ms
    is `events_ms`, and the log says so."""
    for attempt in range(3):
        got = {}
        dev = device_times(torch, fn, counts=got)
        ms = sum(v for k, v in dev.items() if not names
                 or any(n in k for n in names))
        lost = {k: c for k, c in got.items() if abs(c - round(c)) > 1e-9}
        if ms > 0 and not lost:
            break
        log(f"[timing] trace {attempt + 1} of {names or 'every kernel'}: "
            + (f"a call counts {json.dumps(lost)}" if ms > 0
               else "no device time"))
    if counts is not None:
        counts.clear()
        counts.update(got)
    if ms <= 0:
        ms = events_ms(torch, fn, iters)
        log(f"[timing] 3 profiler traces saw no device time for "
            f"{names or 'any kernel'}; device ms {ms:.5f} from CUDA events "
            f"over {iters} back-to-back calls instead")
    return ms, time_ms(torch, fn, iters=iters)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # f32 products and convolutions in full f32 (no TF32) everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return smi


def ptxas_resources(text):
    """Per kernel in a `-Xptxas -v` report: registers, stack, spill
    stores and loads (bytes), static shared memory (bytes)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "stack": 0, "spill_stores": 0,
                         "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def phase_build():
    """Build the kernels; check ptxas' resource reports: no spills in
    flash_attention, select_pack, segment_sum or sigmoid_grad,
    flash_attention's dynamic
    shared memory within the card's 227 KB, and select_pack's cluster
    (16 CTAs) placeable at the main path's (cap, k)."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(verbose=True)
    lib = build.library()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc {build.find_nvcc()} -> {build.BUILD_DIR}: "
        f"{secs:.2f} s")
    res = ptxas_resources(build.report("flash_attention").read_text())
    fa = {}
    for name, r in res.items():
        d = 128 if "ILi128E" in name else 64 if "ILi64E" in name else None
        if "flash_attention_kernel" not in name or d is None:
            continue
        r["dynamic_smem"] = lib.repro_flash_attention_smem_bytes(d)
        fa[f"D={d}"] = r
        log(f"[build] flash_attention_kernel<{d}>: {r['registers']} "
            f"registers a thread at launch (setmaxnreg then gives the "
            f"producer 24, the consumers 240), stack {r['stack']} B, spill "
            f"stores {r['spill_stores']} B, spill loads {r['spill_loads']} "
            f"B, static smem {r['smem']} B, dynamic smem "
            f"{r['dynamic_smem']} B")
    require(sorted(fa) == ["D=128", "D=64"],
            f"no flash_attention_kernel<64>/<128> in the ptxas report: {res}")
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                for r in fa.values()), f"flash_attention spills: {fa}")
    require(all(r["dynamic_smem"] + r["smem"] <= SMEM_PER_BLOCK
                for r in fa.values()),
            f"flash_attention needs more than {SMEM_PER_BLOCK} B: {fa}")
    res = {"flash_attention": fa}
    for stem in ("select_pack", "segment_sum", "sigmoid_grad"):
        res[stem] = {}
        for name, r in ptxas_resources(build.report(stem).read_text()).items():
            m = re.search(r"\d([a-z_]+_kernel)(?:ILb([01])E)?", name)
            short = name if m is None else m.group(1) + (
                "" if m.group(2) is None else
                "<true>" if m.group(2) == "1" else "<false>")
            res[stem][short] = r
            log(f"[build] {stem}.cu {short}: "
                f"{r['registers']} registers, stack {r['stack']} B, spill "
                f"stores {r['spill_stores']} B, spill loads "
                f"{r['spill_loads']} B, static smem {r['smem']} B")
        require(res[stem] and all(
            r["spill_stores"] == 0 and r["spill_loads"] == 0
            for r in res[stem].values()), f"{stem} spills: {res[stem]}")
    cl = res["select_pack"].get("select_pack_cluster_kernel")
    require(cl is not None, "no select_pack_cluster_kernel in the report")
    for k in (13108, 65536):
        cl[f"dynamic_smem_k{k}"] = lib.repro_select_pack_cluster_smem(
            1 << 18, k)
        cl[f"max_active_clusters_k{k}"] = \
            lib.repro_select_pack_max_clusters(1 << 18, k)
        log(f"[build] select_pack cluster path at (cap, k) = (262144, {k}):"
            f" {lib.repro_select_pack_cluster_size()} CTAs a row, dynamic "
            f"smem {cl[f'dynamic_smem_k{k}']} B a CTA, at most "
            f"{cl[f'max_active_clusters_k{k}']} such clusters at once "
            "(cudaOccupancyMaxActiveClusters)")
        require(cl[f"max_active_clusters_k{k}"] >= 1
                and cl[f"dynamic_smem_k{k}"] + cl["smem"] <= SMEM_PER_BLOCK,
                f"select_pack's cluster does not fit the card: {cl}")
    return secs, res


def make_batches(spec_kw, n, start=0):
    from repro_torch.data import get_source

    src = get_source("zipf_sparse", batch_size=BATCH, start=start, **spec_kw)
    return [src.batch(i) for i in range(n)]


SG_LARGE = 262144              # sigmoid_grad's bytes-bound batch (K = 64)


def path_sigmoid_inputs(torch, dev, batch):
    """sigmoid_grad's input on the main path: a real batch's (4096, 64)
    vals and labels, and theta drawn N(0, 2^2) in the batch's shape."""
    rng = np.random.default_rng(SEED)
    vals = torch.from_numpy(batch["vals"]).to(dev)
    theta = torch.from_numpy(
        rng.normal(0.0, 2.0, size=vals.shape).astype(np.float32)).to(dev)
    return vals, theta, torch.from_numpy(batch["labels"]).to(dev)


def large_sigmoid_inputs(torch, dev, b=SG_LARGE):
    """sigmoid_grad at (b, 64), drawn on the card from a seeded generator:
    vals and theta N(0, 1), labels in {0, 1}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    vals = torch.randn((b, K), generator=gen, device=dev)
    theta = torch.randn((b, K), generator=gen, device=dev)
    y = torch.randint(0, 2, (b,), generator=gen, device=dev,
                      dtype=torch.int32)
    return vals, theta, y


def _sg_bound(b, k):
    """vals and theta read, grads written (12 B an element), labels read
    and probs and nll written (12 B a row); 3 flops an element."""
    return bound(12 * b * k + 12 * b, 3 * b * k)


def _sg_check(torch, name, vals, theta, y, calls=1):
    """sigmoid_grad against its plain version, within 1e-5 + 1e-5|plain|
    (the logit is a K-term f32 sum in another order), and `calls` calls
    bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sigmoid_grad import sigmoid_grad

    outs = [sigmoid_grad(vals, theta, y) for _ in range(calls)]
    want = ref.sigmoid_grad_ref(vals, theta, y)
    torch.cuda.synchronize()
    got = outs[0]
    err = max(float((g - w).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    ok = all(bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all())
             and bool(torch.isfinite(g).all()) for g, w in zip(got, want))
    same = all(_same_bits(torch, a, b) for o in outs[1:]
               for a, b in zip(o, got))
    log(f"[kernels] sigmoid_grad {name} {tuple(vals.shape)} f32: max|d|="
        f"{err:.3e} (tol 1e-5 + 1e-5|plain|) ok={ok}; {calls} calls "
        f"bit-identical={same}")
    require(ok, f"sigmoid_grad disagrees with its plain version on {name}")
    require(same, f"sigmoid_grad is not bit-reproducible on {name}")
    return err


def host_us(torch, parts, calls=1000):
    """Host microseconds a call of each function in `parts`, the mean over
    `calls` calls each after 50 warm-up calls (time.perf_counter_ns around
    the loop, so a lambda call is included)."""
    res = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        res[name] = (time.perf_counter_ns() - t) / calls / 1e3
        torch.cuda.synchronize()
    return res


def sg_host_parts(torch, vals, theta, y):
    """The parts of the sigmoid_grad wrapper, each alone: the checks, the
    one output allocation, its three views, the raw stream lookup, the
    ctypes call with the kernel's launch, and the whole wrapper; beside
    them, as yardsticks in the same process, what the wrapper no longer
    does: three allocations and a torch.cuda.Stream lookup."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sigmoid_grad as sg

    lib = build.library()
    b, k = vals.shape
    p, n, total = sg.layout(b, k)
    idx = vals.get_device()
    out = torch.empty((total,), dtype=torch.float32, device=vals.device)
    args = (vals.data_ptr(), theta.data_ptr(), y.data_ptr(), out.data_ptr(),
            b, k, torch._C._cuda_getCurrentRawStream(idx))
    return {
        "checks": lambda: sg._check(vals, theta, y),
        "allocation": lambda: torch.empty((total,), dtype=torch.float32,
                                          device=vals.device),
        "views": lambda: (out.as_strided((b, k), (k, 1)),
                          out.as_strided((b,), (1,), p),
                          out.as_strided((b,), (1,), n)),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "ctypes_launch": lambda: lib.repro_sigmoid_grad_f32(*args),
        "wrapper": lambda: sg.sigmoid_grad(vals, theta, y),
        "yardstick_three_allocations": lambda: (
            torch.empty((b, k), dtype=torch.float32, device=vals.device),
            torch.empty((b,), dtype=torch.float32, device=vals.device),
            torch.empty((b,), dtype=torch.float32, device=vals.device)),
        "yardstick_stream_object": lambda: torch.cuda.current_stream(
            vals.device).cuda_stream,
    }


def sg_host_split(torch, vals, theta, y):
    res = host_us(torch, sg_host_parts(torch, vals, theta, y))
    log("[kernels] sigmoid_grad host us a call, over 1000 calls each: "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in res.items()))
    return res


def sg_floor_ms(torch, vals=None, shape=None):
    """Device ms, from the same profiler method as the kernel's own time,
    of what no sigmoid_grad kernel on the grid and block it takes for
    (B, K) can beat: an empty kernel (`shape` = (B, K)), or with `vals`
    one round trip on that grid (each lane loads its 16 bytes of vals and
    stores them)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sigmoid_grad as sg

    lib = build.library()
    b, k = vals.shape if vals is not None else shape
    out = None if vals is None else torch.empty(
        (sg.layout(b, k)[2],), dtype=torch.float32, device=vals.device)
    ptrs = (None, None) if vals is None else (vals.data_ptr(),
                                              out.data_ptr())

    def launch():
        build.check(lib.repro_sigmoid_grad_floor(
            *ptrs, b, k, torch.cuda.current_stream().cuda_stream), "floor")

    ms, _ = kernel_and_call_ms(torch, launch, (
        "empty_kernel" if vals is None else "round_trip_kernel",))
    return ms


def _sg_entry(torch, dev, batch, results):
    """sigmoid_grad at the path's (4096, 64) f32 and at (262144, 64)
    against its plain version, 5 calls bit-identical; timed at both with
    their bounds, and on each grid an empty kernel and one round trip; the
    wrapper's host time split into its parts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sigmoid_grad import sigmoid_grad

    vals, theta, y = path_sigmoid_inputs(torch, dev, batch)
    err = _sg_check(torch, "path", vals, theta, y, calls=5)
    for b, k in ((1, 64), (4097, 64), (1000, 65), (300, 256), (77, 7)):
        err = max(err, _sg_check(torch, "ragged", *_sg_ragged(
            torch, dev, b, k), calls=2))
    b, k = vals.shape
    bms, by = _sg_bound(b, k)
    entry = results["sigmoid_grad"] = {
        "name": "sigmoid_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sigmoid_grad.cu",
        "replaces": "src/repro/kernels/sigmoid_grad.py:38",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by, "library_ms": None}
    _timed(torch, entry, lambda: sigmoid_grad(vals, theta, y),
           ("sigmoid_grad_kernel",),
           lambda: ref.sigmoid_grad_ref(vals, theta, y))
    _one_launch(torch, "sigmoid_grad", entry, 1)
    entry["floor_ms"] = sg_floor_ms(torch, shape=(b, k))
    entry["round_trip_ms"] = sg_floor_ms(torch, vals)
    entry["host_us"] = sg_host_split(torch, vals, theta, y)

    big = large_sigmoid_inputs(torch, dev)
    entry["max_abs_err"] = max(err, _sg_check(torch, "large", *big, calls=5))
    large = entry["large"] = {"shape": [SG_LARGE, K]}
    large["bound_ms"], large["bound_by"] = _sg_bound(SG_LARGE, K)
    ops_large = {}
    large["ms"], large["call_ms"] = kernel_and_call_ms(
        torch, lambda: sigmoid_grad(*big), (), counts=ops_large)
    large["ops_per_call"] = ops_large
    large["plain_ms"], _ = kernel_and_call_ms(
        torch, lambda: ref.sigmoid_grad_ref(*big), ())
    large["floor_ms"] = sg_floor_ms(torch, shape=(SG_LARGE, K))
    large["round_trip_ms"] = sg_floor_ms(torch, big[0])
    log(f"[kernels] sigmoid_grad at ({b}, {k}): device ms {entry['ms']:.5f}"
        f", on its grid an empty kernel {entry['floor_ms']:.5f} and one "
        f"round trip {entry['round_trip_ms']:.5f}, bound {bms:.5f}; at "
        f"({SG_LARGE}, {K}): device ms {large['ms']:.5f} "
        f"({large['bound_ms'] / large['ms']:.1%} of its {large['bound_ms']:.5f}"
        f" ms bound), empty kernel {large['floor_ms']:.5f}, one round trip "
        f"{large['round_trip_ms']:.5f}, plain {large['plain_ms']:.5f}; a "
        f"call runs {json.dumps(ops_large)}")
    del big


def _sg_ragged(torch, dev, b, k):
    rng = np.random.default_rng(b * 1000 + k)
    return (torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(
        dev), torch.from_numpy(rng.normal(size=(b, k)).astype(
            np.float32)).to(dev), torch.from_numpy(
        rng.integers(0, 2, size=(b,)).astype(np.int32)).to(dev))


def _timed(torch, entry, kernel_fn, names, plain_fn):
    """Fill an entry's device times (profiler) and call times (events), and
    from the kernel's trace its device operations per call."""
    ops_per_call = {}
    entry["ms"], entry["call_ms"] = kernel_and_call_ms(
        torch, kernel_fn, names, counts=ops_per_call)
    entry["ops_per_call"] = ops_per_call
    entry["plain_ms"], entry["plain_call_ms"] = kernel_and_call_ms(
        torch, plain_fn, ())


def _run_mass(ref, ids, g):
    """Per-slot sum of |g| over the slot's run, at run ends (tolerance)."""
    return ref.segment_sum_sorted_ref(ids, g.abs())


def _seg_case(torch, name, ids, g, exact, calls=2):
    """segment_sum_sorted against its plain version, and `calls` calls
    bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    outs = [segment_sum_sorted(ids, g) for _ in range(calls)]
    got = outs[0]
    want = ref.segment_sum_sorted_ref(ids, g)
    torch.cuda.synchronize()
    d = (got - want).abs()
    err = float(d.max()) if d.numel() else 0.0
    if exact:
        ok = bool(torch.equal(got, want))
        tol = "bit-exact (integer-valued sums)"
    else:
        ok = bool((d <= 1e-5 + 1e-6 * _run_mass(ref, ids, g)).all())
        tol = "1e-5 + 1e-6 * sum|g| over the run"
    repro = all(bool(torch.equal(got, o)) for o in outs[1:])
    runs = int(((ids[1:] != ids[:-1]) & (ids[1:] >= 0)).sum()) + \
        int(ids.numel() > 0 and ids[0] >= 0)
    log(f"[kernels] segment_sum_sorted {name}: N={ids.numel()} runs={runs} "
        f"max|d|={err:.3e} (tol {tol}) ok={ok}; {calls} calls "
        f"bit-identical={repro}")
    require(ok, f"segment_sum_sorted disagrees on {name}")
    require(repro, f"segment_sum_sorted not reproducible on {name}")
    return err


def _sorted_last_pad(torch, ids_flat):
    key = torch.where(ids_flat >= 0, ids_flat, 2 ** 31 - 1)
    key_s = torch.sort(key, stable=True).values
    return torch.where(key_s == 2 ** 31 - 1, -1, key_s).contiguous()


def path_routing(torch, dev, batch, hot):
    """The main path's routing of one batch at 2^27 (P = 1): (config, the
    batch's flat ids, hot split, routing)."""
    from repro_torch.configs import DPMRConfig
    from repro_torch.core import dpmr, hot_sharding, sparse

    cfg = DPMRConfig(num_features=1 << LOG2_F, max_features_per_sample=K)
    ids = torch.from_numpy(batch["ids"]).to(dev).reshape(-1)
    hot_slot, is_hot, cold_ids = hot_sharding.split_hot(ids, hot)
    routing = sparse.route_build(cold_ids, 1, 1 << LOG2_F,
                                 dpmr.capacity(cfg, BATCH))
    return cfg, ids, (hot_slot, is_hot), routing


def path_segment_inputs(torch, dev, path_req):
    """segment_sum_sorted's input on the main path: the sorted request ids
    of a real batch (at P = 1 every run has length 1: route_build
    deduplicates per source) and N(0, 1) grads; and the generator, to draw
    more inputs from."""
    rng = np.random.default_rng(SEED + 1)
    path_ids = _sorted_last_pad(torch, path_req.reshape(-1))
    path_g = torch.from_numpy(rng.normal(size=path_req.numel()).astype(
        np.float32)).to(dev)
    return path_ids, path_g, rng


def path_select_inputs(torch, dev, routing):
    """select_pack's input on the main path: the routed send buffer of a
    real batch's gradients, a carry from earlier steps on half the live
    slots, and k at TOPK_FRAC; and the generator."""
    from repro_torch.core import sparse
    from repro_torch.optim import compression

    rng = np.random.default_rng(SEED + 3)

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    ids = routing.req_ids
    live = ids >= 0
    g = tensor(rng.normal(scale=1.0 / BATCH, size=routing.order.numel())
               .astype(np.float32))
    send = sparse.combine_grads(routing, g)
    carry = torch.where(live & tensor(rng.random(ids.shape) < 0.5),
                        tensor(rng.normal(scale=0.5 / BATCH, size=ids.shape)
                               .astype(np.float32)), 0.0)
    return send, ids, carry, compression.topk_count(ids.shape[1],
                                                    TOPK_FRAC), rng


def _one_launch(torch, name, entry, max_kernels):
    """From the timed trace: at most `max_kernels` kernels a call and no
    memset."""
    got = entry["ops_per_call"]
    memsets = {k: v for k, v in got.items() if "memset" in k.lower()}
    kernels = {k: v for k, v in got.items() if k not in memsets}
    log(f"[kernels] {name}: device operations a call, from the timed trace: "
        f"{json.dumps(got)}")
    require(got and not memsets and sum(kernels.values()) <= max_kernels,
            f"{name} runs {got} a call: at most {max_kernels} kernels and no "
            "memset allowed")


def _seg_entries(torch, dev, batch, path_req, results):
    """segment_sum_sorted at the path's N and on adversarial inputs, and
    owner_accumulate at the path's shape."""
    from repro_torch.core import sparse
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    n = path_req.numel()
    path_ids, path_g, rng = path_segment_inputs(torch, dev, path_req)

    def normal(m):
        return torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)

    def integer(m):
        return torch.from_numpy(
            rng.integers(-8, 9, size=m).astype(np.float32)).to(dev)

    err = _seg_case(torch, "path (sorted requests)", path_ids, path_g, False)
    # the raw Zipf batch sorted: head features make runs over many tiles
    zipf_ids = _sorted_last_pad(
        torch, torch.from_numpy(batch["ids"].reshape(-1)).to(dev))
    _seg_case(torch, "zipf batch, f32", zipf_ids, normal(zipf_ids.numel()),
              False)
    _seg_case(torch, "zipf batch, integer", zipf_ids,
              integer(zipf_ids.numel()), True)
    few = torch.from_numpy(np.sort(rng.integers(0, 3, size=n)).astype(
        np.int32)).to(dev)
    _seg_case(torch, "3 runs over 256 tiles", few, integer(n), True)
    _seg_case(torch, "one run covering N", torch.zeros(
        n, dtype=torch.int32, device=dev), torch.ones(n, device=dev), True)
    _seg_case(torch, "all padding", torch.full(
        (n,), -1, dtype=torch.int32, device=dev), normal(n), True)
    m = n - 333
    ragged = torch.from_numpy(np.concatenate([
        np.sort(rng.integers(0, 50, size=m - 700)),
        np.full(700, -1)]).astype(np.int32)).to(dev)
    _seg_case(torch, "ragged N, 50 runs", ragged, integer(m), True)
    # the look-back: f32 runs over thousands of tiles, 5 calls
    big = 1 << 22
    long_runs = torch.from_numpy(np.concatenate([
        np.sort(rng.integers(0, 7, size=big - 4321)),
        np.full(4321, -1)]).astype(np.int32)).to(dev)
    _seg_case(torch, "N = 2^22, 7 runs over 2048 tiles, f32", long_runs,
              normal(big), False, calls=5)
    tile = build.library().repro_segment_sum_tile_size()
    _seg_case(torch, f"runs end at the {tile}-slot tile edges", torch.arange(
        n, device=dev, dtype=torch.int32) // tile, normal(n), False, calls=5)
    for m in (n + 1, n - 1):
        ids_m = torch.from_numpy(np.concatenate([
            np.sort(rng.integers(0, 40, size=m - 500)),
            np.full(500, -1)]).astype(np.int32)).to(dev)
        _seg_case(torch, f"N = {tile} x {n // tile} {m - n:+d}", ids_m,
                  integer(m), True)
    _seg_case(torch, "alternating length-1 runs", torch.arange(
        n, device=dev, dtype=torch.int32), normal(n), False, calls=5)
    _seg_case(torch, "runs of length 1 and 2 in turn", (2 * torch.arange(
        n, device=dev, dtype=torch.int32)) // 3, integer(n), True)

    # bound: read ids and write out once a slot (8 B), read grads only at
    # live slots (padding needs none, 4 B); one f32 add a live slot
    n_live = int((path_ids >= 0).sum())
    bms, by = bound(8 * n + 4 * n_live, n_live)
    log(f"[kernels] segment_sum_sorted bound: N = {n}, {n_live} live")
    results["segment_sum_sorted"] = {
        "name": "segment_sum_sorted", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum.py:68",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by, "library_ms": None}
    _timed(torch, results["segment_sum_sorted"],
           lambda: segment_sum_sorted(path_ids, path_g), (),
           lambda: ref.segment_sum_sorted_ref(path_ids, path_g))
    _one_launch(torch, "segment_sum_sorted", results["segment_sum_sorted"],
                1)

    # owner_accumulate as the reduce calls it: (1, cap) received slots
    # into the 2^27-row owner block
    rows = 1 << LOG2_F
    g2 = normal(n).reshape(path_req.shape)
    got = ops.owner_accumulate(path_req, g2, torch.zeros(rows, device=dev), 0)
    want = sparse.owner_accumulate(path_req, g2,
                                   torch.zeros(rows, device=dev), 0)
    torch.cuda.synchronize()
    oa_err = float((got - want).abs().max())
    log(f"[kernels] owner_accumulate (1, {n}) -> {rows} rows: "
        f"max|d|={oa_err:.3e} (tol 1e-6: one addend per feature at P=1)")
    require(oa_err <= 1e-6, "owner_accumulate disagrees with the scatter-add")
    acc = torch.zeros(rows, device=dev)
    oa = results["owner_accumulate"] = {"max_abs_err": oa_err}
    _timed(torch, oa, lambda: ops.owner_accumulate(path_req, g2, acc, 0), (),
           lambda: sparse.owner_accumulate(path_req, g2, acc, 0))
    oa["library_ms"], oa["library_call_ms"] = kernel_and_call_ms(
        torch, lambda: acc.index_add_(0, path_req.reshape(-1).clamp(min=0),
                                      g2.reshape(-1)), ())
    log(f"[kernels] owner_accumulate device ms={oa['ms']:.4f} (sort + "
        f"kernel + scatter) plain scatter-add ms={oa['plain_ms']:.4f} "
        f"one index_add_ ms={oa['library_ms']:.4f}")


def _seg_graph(torch, dev, path_req):
    """segment_sum_sorted captured in a CUDA graph at the main path's N:
    5 replays bit-identical to the eager call, then 3 replays on inputs
    changed in place (runs over many tiles) against eager calls on the
    same inputs; from a profiler trace, the operations a replay runs (one
    kernel, no memset) and its device ms."""
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    ids, g, rng = path_segment_inputs(torch, dev, path_req)
    n = ids.numel()
    want = segment_sum_sorted(ids, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        segment_sum_sorted(ids, g)
    torch.cuda.current_stream().wait_stream(side)
    ss.take_captured()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segment_sum_sorted(ids, g)
    bufs = ss.take_captured()
    require(len(bufs) == 1, f"the capture took {len(bufs)} buffers, not 1")
    same = []
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        same.append(_same_bits(torch, out, want))
    for _ in range(3):
        new_ids = torch.from_numpy(np.concatenate([
            np.sort(rng.integers(0, 300, size=n - 5000)),
            np.full(5000, -1)]).astype(np.int32)).to(dev)
        new_g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(
            dev)
        ids.copy_(new_ids)
        g.copy_(new_g)
        eager = segment_sum_sorted(new_ids, new_g)
        graph.replay()
        torch.cuda.synchronize()
        same.append(_same_bits(torch, out, eager))
    ops = {}
    ms = sum(device_times(torch, graph.replay, counts=ops).values())
    log(f"[kernels] segment_sum_sorted in a CUDA graph (N = {n}): 5 replays "
        f"and 3 on inputs changed in place bit-identical to eager calls: "
        f"{same}; a replay runs {json.dumps(ops)}, device ms {ms:.5f}")
    require(all(same), "segment_sum_sorted's graph replays differ from the "
            "eager call")
    memsets = [k for k in ops if "memset" in k.lower()]
    require(not memsets and sum(ops.values()) == 1,
            f"a replay runs {ops}: one kernel and no memset allowed")
    return {"replays_bit_identical": same, "ms": ms, "ops_per_replay": ops}


def _same_bits(torch, a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _select_case(torch, name, send, ids, carry, k):
    """select_pack against its plain version: all three outputs bit for
    bit (-0.0 and the order of the packed pairs included)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.select_pack import select_pack

    got = select_pack(send, ids, carry, k)
    want = ref.select_pack_ref(send, ids, carry, k)
    torch.cuda.synchronize()
    ok = all(_same_bits(torch, g, w) for g, w in zip(got, want))
    # |d| where the bits differ (inf where one side is NaN)
    err = max(float(torch.where(
        g.view(torch.int32) == w.view(torch.int32), 0.0,
        (g.float() - w.float()).abs()).nan_to_num(float("inf")).max())
        if g.numel() else 0.0 for g, w in zip(got, want))
    live = int((ids >= 0).sum())
    log(f"[kernels] select_pack {name}: (P, cap)={tuple(ids.shape)} k={k} "
        f"live={live} max|d|={err:.3e} bit-exact={ok}")
    require(ok, f"select_pack disagrees with its plain version on {name}")
    return err


def _select_entries(torch, dev, routing, results):
    """select_pack at the path's shape, from a real batch's routed send
    buffer at 2^27, for k at topk_frac 0.05 and 0.25, and on adversarial
    rows; timed at the path's k against torch.topk of the same key."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import select_pack as sp
    from repro_torch.kernels.select_pack import select_pack
    from repro_torch.optim import compression

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    send, ids, carry, k, rng = path_select_inputs(torch, dev, routing)
    p, cap = ids.shape
    live = ids >= 0
    k25 = compression.topk_count(cap, 0.25)
    # the kernel's own path rule, which the wrapper follows
    rule = build.library().repro_select_pack_uses_cluster
    require(rule(cap, k) and rule(cap, k25),
            f"the main path's select_pack at k = {k}, {k25} is not on the "
            "cluster path")
    err = _select_case(torch, "path (routed send, frac 0.05)", send, ids,
                       carry, k)
    _select_case(torch, "path (routed send, frac 0.25)", send, ids,
                 carry, k25)
    # k on each side of the path rule's boundary at this cap
    lo_k, hi_k = k, cap
    while hi_k - lo_k > 1:
        mid = (lo_k + hi_k) // 2
        lo_k, hi_k = (mid, hi_k) if rule(cap, mid) else (lo_k, mid)
    _select_case(torch, f"path, k = {lo_k} (the cluster path's largest)",
                 send, ids, carry, lo_k)
    require(not rule(cap, hi_k), "no large path past the rule")
    require(sp.uses_cluster(cap, lo_k) and not sp.uses_cluster(cap, hi_k),
            f"the Python copy of the path rule (select_pack.uses_cluster) "
            f"does not switch at the kernel's k = {lo_k}/{hi_k}")
    _select_case(torch, f"path, k = {hi_k} (the large path)", send, ids,
                 carry, hi_k)

    def case(p_, cap_, nlive, seed, prefix=True):
        r = np.random.default_rng(seed)
        i = np.full((p_, cap_), -1, np.int32)
        for row in range(p_):
            at = np.arange(nlive) if prefix else np.sort(
                r.choice(cap_, size=nlive, replace=False))
            i[row, at] = r.choice(1 << LOG2_F, size=nlive, replace=False)
        s_ = np.where(i >= 0, r.normal(size=(p_, cap_)), 0.0)
        c_ = np.where((i >= 0) & (r.random((p_, cap_)) < 0.5),
                      r.normal(scale=0.5, size=(p_, cap_)), 0.0)
        return (tensor(s_.astype(np.float32)), tensor(i),
                tensor(c_.astype(np.float32)))

    s_, i_, c_ = case(2, 3000, 2500, 1, prefix=False)
    _select_case(torch, "all keys equal", torch.where(
        i_ >= 0, 0.5, 0.0), i_, torch.zeros_like(c_), 1000)
    s_, i_, c_ = case(1, 2048, 2048, 2)
    sign = tensor(rng.choice([-0.0, 0.0, 1.0, -1.0], size=(1, 2048),
                             p=[0.3, 0.3, 0.2, 0.2]).astype(np.float32))
    zeros = tensor(rng.choice([-0.0, 0.0], size=(1, 2048)).astype(
        np.float32))
    _select_case(torch, "+-0.0", sign, i_, zeros, 1500)
    s_, i_, c_ = case(3, 1100, 900, 3, prefix=False)
    i_[1] = -1
    _select_case(torch, "an all-dead row", s_, i_, c_, 100)
    _select_case(torch, "k = 1", s_, i_, c_, 1)
    _select_case(torch, "k = cap", s_, i_, c_, 1100)
    _select_case(torch, "3 live < k", *case(2, 1024, 3, 4), 10)
    _select_case(torch, "P = 8, cap 4104 (> Pallas MAX_CAPACITY)",
                 *case(8, 4104, 3000, 5), 411)
    _select_case(torch, "ragged cap 5001", *case(2, 5001, 4000, 6,
                                                      prefix=False), 2501)
    _select_case(torch, "cap 100003 (not a multiple of the 2048-slot chunk)",
                 *case(1, 100003, 60000, 7, prefix=False), 5000)
    _select_case(torch, "k > live, dead slots between live ones",
                 *case(1, 50000, 20000, 8, prefix=False), 30000)
    _select_case(torch, "P = 8, cap 32768", *case(8, 32768, 6000, 9), 3000)
    s_, i_, c_ = case(1, cap, cap, 10)
    _select_case(torch, f"all keys equal, cap {cap}", torch.full_like(
        s_, -0.25), i_, torch.zeros_like(c_), 100000)
    # |comp| = 1.0 at positions 2000..3500 of a cap-40,000 row straddle the
    # edge between the cluster's first two chunks (CTAs 0 and 1); 300
    # larger values win first, then 700 ties
    s_, i_, c_ = case(1, 40000, 40000, 11)
    s_ = s_.clamp(-0.5, 0.5)
    s_[0, 2000:3501] = tensor(np.where(np.arange(1501) % 2, 1.0, -1.0)
                              .astype(np.float32))
    c_[0, 2000:3501] = 0.0
    s_[0, 10000:10300] = 3.0 + torch.arange(300, device=dev)
    require(2000 < sp.CLUSTER_CHUNK < 3501, "ties miss the chunk edge")
    _select_case(torch, "ties at the threshold across a chunk edge", s_, i_,
                 c_, 1000)
    s_, i_, c_ = case(2, 3000, 2800, 12, prefix=False)
    s_[0, [5, 700, 2999]] = float("nan")
    _select_case(torch, "NaN", s_, i_, c_, 400)

    # bound: read ids and write resid once a slot (8 B), read send and
    # carry only at live slots (a dead slot's comp is 0, 8 B), write the k
    # (value, id) pairs (8 B each); one f32 add a live slot
    n_live = int(live.sum())
    bms, by = bound(8 * p * cap + 8 * n_live + 8 * p * k, n_live)
    log(f"[kernels] select_pack bound: (P, cap) = {(p, cap)}, {n_live} "
        f"live, k = {k}")
    entry = results["select_pack"] = {
        "name": "select_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/select_pack.cu",
        "replaces": "src/repro/kernels/select_pack.py:89",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by}
    _timed(torch, entry, lambda: select_pack(send, ids, carry, k), (),
           lambda: ref.select_pack_ref(send, ids, carry, k))
    _one_launch(torch, f"select_pack at (1, {cap}), k={k}", entry, 2)
    # the main path at topk_frac 0.25, and the large path at this row
    for tag, kk in (("k65536", k25), ("large_path", hi_k)):
        got = {}
        entry[f"{tag}_ms"], _ = kernel_and_call_ms(
            torch, lambda: select_pack(send, ids, carry, kk), (), counts=got)
        entry[f"{tag}_ops_per_call"] = got
        log(f"[kernels] select_pack at (1, {cap}), k={kk}: device ms="
            f"{entry[f'{tag}_ms']:.5f}; a call runs {json.dumps(got)}")
    key = torch.where(live, (send + carry).abs(), -1.0)
    entry["library_ms"], entry["library_call_ms"] = kernel_and_call_ms(
        torch, lambda: torch.topk(key, k, dim=1, sorted=True), ())
    log(f"[kernels] select_pack at (1, {cap}), k={k}: torch.topk of the key "
        f"alone device ms={entry['library_ms']:.5f}")


def phase_kernels(torch, dev, batch, hot):
    from repro_torch.core import dpmr, sparse

    results = {}
    # one trace first, so that the profiler's start-up falls on no kernel
    device_times(torch, lambda: torch.zeros(1, device=dev))
    _sg_entry(torch, dev, batch, results)
    cfg, ids, (hot_slot, is_hot), routing = path_routing(torch, dev, batch,
                                                         hot)
    _seg_entries(torch, dev, batch, routing.req_ids, results)
    results["segment_sum_sorted"]["graph"] = _seg_graph(torch, dev,
                                                        routing.req_ids)
    _select_entries(torch, dev, routing, results)

    # the step's two reduces that collide, now through sorted runs
    g = torch.from_numpy(np.random.default_rng(SEED + 2).normal(
        size=ids.numel()).astype(np.float32)).to(dev)
    results["reduces"] = {}
    for name, fn in (
            ("combine_grads", lambda: sparse.combine_grads(routing, g)),
            ("hot_grads", lambda: dpmr.hot_grads(cfg, g, hot_slot, is_hot))):
        outs = [fn() for _ in range(5)]
        same = all(_same_bits(torch, o, outs[0]) for o in outs)
        ms, call = kernel_and_call_ms(torch, fn, ())
        results["reduces"][name] = {"ms": ms, "call_ms": call,
                                    "bit_reproducible": same}
        log(f"[kernels] {name} at the path's inputs (sorted runs + "
            f"segment_sum_sorted): device ms={ms:.4f}, one call "
            f"{call:.4f} ms; 5 calls bit-identical={same}")
        require(same, f"{name} is not bit-reproducible on the card")
    for r in results.values():
        if "name" in r:
            log(f"[kernels] {r['name']}: device ms={r['ms']:.5f} "
                f"plain ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f}"
                f" ({r['bound_by']}); one call by CUDA events "
                f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms "
                "(L2-warm inputs)")
    log("kernels: " + json.dumps(
        [r["name"] for r in results.values() if "name" in r]))
    return results


def full_width_config(distribution="a2a"):
    from repro_torch import DPMRConfig

    return DPMRConfig(num_features=1 << LOG2_F, max_features_per_sample=K,
                      learning_rate=2.0, max_hot=512, optimizer="adagrad",
                      distribution=distribution, topk_frac=TOPK_FRAC)


def run_engine(torch, cfg, dev_train, test, hot):
    """fit_sgd over `dev_train` (one step per batch) with the launch
    counters set to 0 just before and read just after; then one fit
    iteration over 2 batches, a profiled window and evaluate. Returns the
    measurements and the engine."""
    from repro_torch import DPMREngine
    from repro_torch.kernels import ops

    eng = DPMREngine(cfg, hot_ids=hot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hist, step_s = [], []
    t_all = time.perf_counter()
    for b in dev_train:
        t = time.perf_counter()
        hist += eng.fit_sgd([b])
        step_s.append(time.perf_counter() - t)
    total_s = time.perf_counter() - t_all
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    tag = f"[engine {cfg.distribution}]"
    log(f"{tag} fit_sgd {STEPS} steps: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; overflow {sum(h['overflow'] for h in hist)}")
    log(f"{tag} step time on device-resident batches: median "
        f"{statistics.median(step_s) * 1e3:.3f} ms, mean "
        f"{total_s / STEPS * 1e3:.3f} ms, first {step_s[0] * 1e3:.3f} ms; "
        f"{STEPS * BATCH / total_s:.0f} samples/s; "
        f"max_memory_allocated {peak / 2 ** 30:.3f} GiB")
    log(f"{tag} launches in fit_sgd: {counts}")
    require(all(np.isfinite(losses)), "non-finite loss")
    require(np.mean(losses[-5:]) < losses[0], "loss did not fall")
    require(all(h["overflow"] == 0 for h in hist), "capacity overflow")

    carry = eng.state.strat.clone()
    ops.reset_launch_counts()
    fit_hist = eng.fit(lambda: iter(dev_train[:2]), iterations=1)
    fit_counts = ops.launch_counts()
    carry_kept = bool(torch.equal(eng.state.strat, carry))
    log(f"{tag} fit 1 iteration over 2 batches: loss "
        f"{fit_hist[0]['loss']:.4f}; launches {fit_counts}; carry "
        f"unchanged={carry_kept}")
    require(np.isfinite(fit_hist[0]["loss"]), "non-finite fit loss")
    require(carry_kept, "fit changed the strategy carry")

    prof = profile_steps(torch, eng, dev_train[2:10], cfg.distribution)

    t = time.perf_counter()
    metrics = eng.evaluate(test)
    eval_s = time.perf_counter() - t
    probs = eng.predict_padded({k: test[0][k][:1000] for k in ("ids",
                                                                "vals")})
    require(probs.shape == (1000,) and np.isfinite(probs).all(),
            "bad predict_padded output")
    log(f"{tag} evaluate 3 held-out batches: f_avg "
        f"{metrics['f_avg']:.4f} precision_avg "
        f"{metrics['precision_avg']:.4f} ({eval_s:.2f} s incl. transfer)")
    return {"losses": losses, "step_ms_median": statistics.median(step_s)
            * 1e3, "step_ms_mean": total_s / STEPS * 1e3,
            "step_ms_first": step_s[0] * 1e3,
            "samples_per_s": STEPS * BATCH / total_s,
            "max_memory_allocated": peak,
            "launches": counts, "fit_launches": fit_counts,
            "f_avg": metrics["f_avg"], "eval": metrics, "profile": prof}, eng


def phase_engine(torch, dev, results, train, test, hot):
    from repro_torch.api import put_batch

    dev_train = [put_batch(b, dev) for b in train]
    kernels = ("sigmoid_grad", "segment_sum_sorted", "select_pack")

    a2a, eng = run_engine(torch, full_width_config("a2a"), dev_train, test,
                          hot)
    del eng
    counts, fit_counts = a2a["launches"], a2a["fit_launches"]
    # one sigmoid_grad a step; segment_sum_sorted under combine_grads,
    # hot_grads and owner_accumulate
    require(counts["sigmoid_grad"] == STEPS
            and counts["segment_sum_sorted"] == 3 * STEPS
            and counts["select_pack"] == 0,
            f"a2a launches {counts} in {STEPS} steps")
    require(fit_counts["sigmoid_grad"] == 2
            and fit_counts["segment_sum_sorted"] == 6,
            f"fit did not launch the kernels: {fit_counts}")
    for name in kernels[:2]:
        results[name]["launches"] = counts[name]
    torch.cuda.empty_cache()

    topk, eng = run_engine(torch, full_width_config("topk_reduce"), dev_train,
                           test, hot)
    counts, fit_counts = topk["launches"], topk["fit_launches"]
    banked = int((eng.state.strat != 0).sum())
    log(f"[engine topk_reduce] features with a banked residual after "
        f"{STEPS} steps: {banked}")
    require(counts["select_pack"] >= STEPS and counts["sigmoid_grad"] == STEPS,
            f"topk_reduce launches {counts} in {STEPS} steps")
    require(banked > 0, "the topk_reduce carry stayed zero: no slot lost")
    require(fit_counts["select_pack"] == 0,
            f"fit launched select_pack: {fit_counts}")
    results["select_pack"]["launches"] = counts["select_pack"]
    topk["banked_features"] = banked
    del eng
    torch.cuda.empty_cache()
    return {"a2a": a2a, "topk_reduce": topk}


def profile_steps(torch, eng, batches, tag):
    """Where a train step's time goes: fit_sgd over `batches` three times,
    first untraced for the wall time per step, then under torch.profiler
    for the device busy time per step by kernel, then traced on the host
    alone for the top-level host operations a step by name (`host_ops`:
    the work a step dispatches, which two checkouts can be compared on).
    The profiler adds host cost to every launch, so the idle share is
    1 - busy / untraced wall; the traced wall is reported beside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.fit_sgd(batches)
    wall_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.fit_sgd(batches)
        traced_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    by_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            by_kernel[evt.key] = us / len(batches) / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    log(f"[profile {tag}] {len(batches)} steps: untraced wall {wall_ms:.3f} "
        f"ms/step, traced wall {traced_ms:.3f} ms/step (profiler cost "
        f"included), device busy {busy:.3f} ms/step; idle share "
        f"{1 - busy / wall_ms:.3f} of the untraced wall "
        f"({1 - busy / traced_ms:.3f} of the traced one)")
    for name, ms in top:
        log(f"[profile {tag}]   {ms:8.4f} ms  {name[:110]}")
    with profile(activities=[ProfilerActivity.CPU]) as host:
        eng.fit_sgd(batches)
    ops = host_ops(host.events(), len(batches))
    calls = {name: round(d["calls"], 4) for name, d in sorted(ops.items())}
    log(f"[profile {tag}] top-level host operations a step: "
        f"{sum(calls.values()):g}, {sum(d['ms'] for d in ops.values()):.3f} "
        f"ms traced; by name {json.dumps(calls)}")
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "idle_share_traced": 1 - busy / traced_ms, "top": top,
            "by_kernel": by_kernel, "host_ops": ops}


MR_STEPS = (("a2a", 8), ("topk_reduce", 8), ("overlap_a2a", 4))


def _timed_fit(torch, eng, batches):
    """fit_sgd one batch at a time, with the launch counters set to 0 just
    before and read just after: (step seconds, total seconds, counts)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    step_s = []
    t_all = time.perf_counter()
    for b in batches:
        t = time.perf_counter()
        eng.fit_sgd([b])            # reads the metrics back: synchronizes
        step_s.append(time.perf_counter() - t)
    return step_s, time.perf_counter() - t_all, ops.launch_counts()


def phase_multirank(torch, dev, train, hot):
    """The engine through an NCCL process group of one rank on the card:
    a2a and topk_reduce for 8 fit_sgd steps, overlap_a2a for 4, each from
    the same state on the same device-resident batches as an engine with
    no group; the states after the steps must be bit-identical, the
    kernels launched in the group's run, and NCCL's collectives with
    device operations (kernels, or at one rank copies) inside their
    annotated spans in a trace of the group's a2a steps."""
    import torch.distributed as dist

    from repro_torch import DPMREngine
    from repro_torch.api import put_batch
    from repro_torch.launch.mesh import make_host_mesh, process_groups

    store = ROOT / "results" / "nccl_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    out = {}
    try:
        mesh = make_host_mesh(1)
        groups = process_groups(mesh)
        log(f"[multirank] NCCL group of 1 rank (backend "
            f"{dist.get_backend()}, NCCL {torch.cuda.nccl.version()}): mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{mesh.device_type}; world group size "
            f"{dist.get_world_size(groups.world)}")
        batches = [put_batch(b, dev) for b in train[:8]]
        for name, steps in MR_STEPS:
            cfg = full_width_config(name)
            runs, engines = {}, {}
            for tag, m in (("plain", None), ("nccl", mesh)):
                eng = DPMREngine(cfg, hot_ids=hot, mesh=m)
                step_s, total, counts = _timed_fit(torch, eng,
                                                   batches[:steps])
                runs[tag] = {"step_ms_median": statistics.median(step_s)
                             * 1e3, "step_ms": [x * 1e3 for x in step_s],
                             "samples_per_s": steps * BATCH / total,
                             "launches": counts}
                engines[tag] = eng
            same = _same_state(torch, engines["plain"].state,
                               engines["nccl"].state)
            counts = runs["nccl"]["launches"]
            log(f"[multirank {name}] {steps} steps: step median "
                f"{runs['plain']['step_ms_median']:.3f} ms without a group "
                f"({runs['plain']['samples_per_s']:.0f} samples/s), "
                f"{runs['nccl']['step_ms_median']:.3f} ms through NCCL "
                f"({runs['nccl']['samples_per_s']:.0f} samples/s); cold, hot "
                f"and carry bit-identical={same}; launches through NCCL "
                f"{counts}")
            require(same, f"{name}: the NCCL group's states differ from the "
                    "run without a group")
            require(counts["sigmoid_grad"] == steps
                    and counts["segment_sum_sorted"] == 3 * steps
                    and counts["select_pack"] == (
                        steps if name == "topk_reduce" else 0),
                    f"{name} through NCCL launched {counts} in {steps} steps")
            if name == "a2a":
                for tag in ("plain", "nccl"):
                    runs[tag]["profile"] = profile_steps(
                        torch, engines[tag], batches, f"multirank a2a {tag}")
                runs["nccl"].update(nccl_ops(torch, engines, batches))
                out["walls_in_turns"] = walls_in_turns(torch, engines,
                                                       batches)
                out["collective_host_us"] = collective_host_us(
                    torch, dev, engines["nccl"].fns.ctx,
                    engines["nccl"].fns.capacity, cfg.max_hot)
            out[name] = runs
            del engines
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return out


def host_ops(events, n):
    """The top-level host operations of a trace over `n` steps (the torch
    and c10d calls the program made on its main thread, not those they
    made in turn), a step: name -> {"calls", "ms"} of host time."""
    from torch.autograd import DeviceType

    top = [e for e in events if e.device_type == DeviceType.CPU
           and e.cpu_parent is None and not e.name.startswith("nccl:")]
    if not top:
        return {}
    threads = [e.thread for e in top]
    main = max(set(threads), key=threads.count)
    out = {}
    for evt in top:
        if evt.thread == main:
            d = out.setdefault(evt.name, {"calls": 0.0, "ms": 0.0})
            d["calls"] += 1 / n
            d["ms"] += evt.time_range.elapsed_us() / n / 1e3
    return out


def host_ops_diff(got, base):
    """name -> {"calls", "ms"} a step that `got`'s host operations run
    beyond `base`'s, for the names whose count differs."""
    out = {}
    zero = {"calls": 0.0, "ms": 0.0}
    for name in sorted(set(got) | set(base)):
        g, b = got.get(name, zero), base.get(name, zero)
        if abs(g["calls"] - b["calls"]) > 1e-6:
            out[name] = {"calls": g["calls"] - b["calls"],
                         "ms": g["ms"] - b["ms"]}
    return out


def _host_and_device_trace(torch, eng, batches):
    """fit_sgd over `batches` traced on the host and the device, a step:
    the wall (traced); the host's ProcessGroupNCCL ranges ("nccl:*",
    calls); the top-level host operations (`host_ops`); the device spans
    NCCL annotates with the same names (calls, ms); and the device
    operations inside those spans on their stream (calls, ms), which are
    NCCL's own: a stream runs in order, and a span covers from the first
    to the last device operation its host range launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.fit_sgd(batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    n = len(batches)
    events = prof.events()
    host, spans, windows = {}, {}, []

    def add(into, evt):
        d = into.setdefault(evt.name, {"calls": 0.0, "ms": 0.0})
        d["calls"] += 1 / n
        d["ms"] += evt.time_range.elapsed_us() / n / 1e3

    for evt in events:
        if evt.device_type == DeviceType.CPU:
            if evt.name.startswith("nccl:"):
                host[evt.name] = host.get(evt.name, 0.0) + 1 / n
        elif evt.name.startswith("nccl:"):
            add(spans, evt)
            windows.append((evt.device_resource_id, evt.time_range.start,
                            evt.time_range.end))
    device = {}
    for evt in events:
        if evt.device_type == DeviceType.CPU or evt.name.startswith("nccl:"):
            continue
        r = evt.time_range
        if any(s == evt.device_resource_id and lo - 0.01 <= r.start
               and r.end <= hi + 0.01 for s, lo, hi in windows):
            add(device, evt)
    return {"wall_ms": wall_ms / n, "host": host,
            "ops": host_ops(events, n), "spans": spans, "device": device}


def nccl_ops(torch, engines, batches):
    """What NCCL did a step of fit_sgd: the collectives the host called,
    their device spans, the device operations inside those spans (at one
    rank NCCL may run a collective as a device-to-device copy instead of
    a kernel), and where the wall the group adds goes on the host: the
    top-level host operations it runs beyond the same steps without a
    group (the c10d collectives among them), and the rest (Python between
    the operations, the profiler's own cost)."""
    got = _host_and_device_trace(torch, engines["nccl"], batches)
    plain = _host_and_device_trace(torch, engines["plain"], batches)
    ms = sum(d["ms"] for d in got["device"].values())
    calls = sum(d["calls"] for d in got["device"].values())
    extra_ms = got["wall_ms"] - plain["wall_ms"]
    ops_ms = {k: sum(d["ms"] for d in r["ops"].values())
              for k, r in (("nccl", got), ("plain", plain))}
    c10d_ms = sum(d["ms"] for name, d in got["ops"].items()
                  if name.startswith("c10d::"))
    extra_ops = host_ops_diff(got["ops"], plain["ops"])
    log(f"[multirank a2a] a step: NCCL collectives the host called "
        f"{json.dumps(got['host'])}; their device spans "
        f"{json.dumps(got['spans'])}; device operations inside them "
        f"{json.dumps(got['device'])}, {calls:g} a step, {ms:.5f} ms")
    log(f"[multirank a2a] host, traced, a step: wall {got['wall_ms']:.3f} ms "
        f"with the group, {plain['wall_ms']:.3f} without (+{extra_ms:.3f}); "
        f"top-level host operations {ops_ms['nccl']:.3f} ms with, "
        f"{ops_ms['plain']:.3f} without (+{ops_ms['nccl'] - ops_ms['plain']:.3f}"
        f"), of which the c10d collectives {c10d_ms:.3f}; the rest "
        f"{extra_ms - ops_ms['nccl'] + ops_ms['plain']:.3f}. Operations the "
        f"group adds (calls, ms a step): {json.dumps(extra_ops)}")
    require(got["host"] and got["spans"],
            "no NCCL collective in the group's trace")
    require(got["device"], "no device operation inside NCCL's spans")
    require(not plain["host"] and not plain["spans"],
            "an NCCL collective in the trace of the steps without a group")
    return {"nccl_calls_per_step": got["host"], "nccl_spans": got["spans"],
            "nccl_device": got["device"], "nccl_ms_per_step": ms,
            "traced_wall_ms": got["wall_ms"],
            "traced_wall_ms_no_group": plain["wall_ms"],
            "host_ops_ms": ops_ms["nccl"],
            "host_ops_ms_no_group": ops_ms["plain"],
            "c10d_host_ms": c10d_ms, "host_ops_added": extra_ops}


def walls_in_turns(torch, engines, batches):
    """Untraced wall ms a step of fit_sgd over `batches`, the engines in
    turns: without a group, with, with, without."""
    out = {"plain": [], "nccl": []}
    for tag in ("plain", "nccl", "nccl", "plain"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engines[tag].fit_sgd(batches)
        out[tag].append((time.perf_counter() - t) * 1e3 / len(batches))
    log(f"[multirank a2a] untraced wall ms a step in turns (no group, "
        f"NCCL, NCCL, no group): {out['plain'][0]:.3f}, {out['nccl'][0]:.3f}"
        f", {out['nccl'][1]:.3f}, {out['plain'][1]:.3f}")
    return out


def collective_host_us(torch, dev, ctx, cap, max_hot, calls=500):
    """Host µs a call of the two seams a step calls through the group, on
    the step's shapes: `_all_to_all` of a (1, cap) int32 buffer and
    `_psum` of a (max_hot,) f32 vector; and of the same seams with no
    group (the identity the P = 1 path keeps); the calls back to back,
    then one synchronize."""
    from repro_torch.api import strategies

    x = torch.zeros((1, cap), dtype=torch.int32, device=dev)
    v = torch.zeros((max_hot,), device=dev)
    alone = ctx._replace(groups=None)
    out = {}
    for name, fn in (("all_to_all", lambda: strategies._all_to_all(x, ctx)),
                     ("psum", lambda: strategies._psum(v, ctx)),
                     ("all_to_all_no_group",
                      lambda: strategies._all_to_all(x, alone)),
                     ("psum_no_group", lambda: strategies._psum(v, alone))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e6 / calls
    log(f"[multirank] host µs a call through the NCCL group ({calls} calls): "
        f"_all_to_all (1, {cap}) int32 {out['all_to_all']:.2f}, _psum "
        f"({max_hot},) f32 {out['psum']:.2f}; the same with no group (the "
        f"identity) {out['all_to_all_no_group']:.3f} and "
        f"{out['psum_no_group']:.3f}")
    return out


P8 = 8


def _sum_bound(torch, m, mass):
    """|d| allowed between two f32 sums of the same m terms in other
    orders: each lies within (m - 1) 2^-24 sum|terms| of the exact sum."""
    return 2.0 * torch.clamp(m - 1.0, min=0.0) * 2.0 ** -24 * mass


def phase_p8(torch, dev, hot, results):
    """The buffers of a P = 8 routing on one card: a global batch of
    8 x 4096 samples, each rank's 4096 rows routed to 8 owners of 2^24
    rows; the all_to_alls are transposes of the stacked (src, dst, cap)
    buffers. Checks each owner's reduce against its plain version, the
    run lengths the owners receive (runs longer than 1, C1), select_pack
    on the 8-row send buffers bit for bit, and the concatenated owner
    blocks against the P = 1 gradient of the same samples; times
    segment_sum_sorted, owner_accumulate and select_pack at one owner's
    (8, cap)."""
    from repro_torch.core import dpmr, hot_sharding, sparse
    from repro_torch.data import get_source
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_sum import segment_sum_sorted
    from repro_torch.kernels.select_pack import select_pack
    from repro_torch.optim import compression

    t0 = time.perf_counter()
    batch = get_source("zipf_sparse", batch_size=P8 * BATCH,
                       num_features=1 << LOG2_F, features_per_sample=K,
                       signal_features=4096).batch(0)
    gen_s = time.perf_counter() - t0
    cfg = full_width_config()
    f = 1 << LOG2_F
    block = f // P8
    cap = dpmr.capacity(cfg, BATCH, P8)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    table = torch.randn(f, generator=gen, device=dev) * 0.05
    hot_vals = torch.randn(cfg.max_hot, generator=gen, device=dev) * 0.05
    ids = torch.from_numpy(batch["ids"]).to(dev)
    vals = torch.from_numpy(batch["vals"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    log(f"[p8] global batch {P8} x {BATCH} at 2^{LOG2_F} (host generation "
        f"{gen_s:.2f} s); {P8} owners of {block} rows, cap {cap}")

    srcs = []
    for r in range(P8):
        flat = ids[r * BATCH:(r + 1) * BATCH].reshape(-1)
        hot_slot, is_hot, cold = hot_sharding.split_hot(flat, hot)
        srcs.append((hot_slot, is_hot, cold,
                     sparse.route_build(cold, P8, block, cap)))
    overflow = [int(s[3].overflow) for s in srcs]
    require(not any(overflow), f"P = 8 routing overflowed: {overflow}")
    # the tiled all_to_all: row o of source s goes to owner o as row s
    req = torch.stack([s[3].req_ids for s in srcs])          # (src, dst, cap)
    recv = req.transpose(0, 1).contiguous()                  # (dst, src, cap)
    resp = torch.stack([sparse.owner_apply(
        recv[o], table[o * block:(o + 1) * block], o * block)
        for o in range(P8)])
    back = resp.transpose(0, 1).contiguous()                 # (src, dst, cap)
    grads, send = [], []
    for r, (hot_slot, is_hot, _, routing) in enumerate(srcs):
        theta = (sparse.route_return(routing, back[r]) + torch.where(
            is_hot, hot_vals[torch.clamp(hot_slot, min=0)], 0.0)
                 ).reshape(BATCH, K)
        rows = slice(r * BATCH, (r + 1) * BATCH)
        if r == 0:
            _sg_check(torch, "P = 8, rank 0's rows", vals[rows], theta,
                      labels[rows])
        g = ops.sigmoid_grad(vals[rows], theta, labels[rows])[0]
        g = (g / float(P8 * BATCH)).reshape(-1)             # grad_scale mean
        grads.append(g)
        send.append(sparse.combine_grads(routing, g))
    send = torch.stack(send)                                  # (src, dst, cap)
    recv_g = send.transpose(0, 1).contiguous()               # (dst, src, cap)

    blocks, hist, worst = [], {}, 0.0
    for o in range(P8):
        zeros = torch.zeros(block, device=dev)
        got = ops.owner_accumulate(recv[o], recv_g[o], zeros.clone(),
                                   o * block)
        want = sparse.owner_accumulate(recv[o], recv_g[o], zeros.clone(),
                                       o * block)
        mass = sparse.owner_accumulate(recv[o], recv_g[o].abs(),
                                       zeros.clone(), o * block)
        m = sparse.owner_accumulate(recv[o], (recv[o] >= 0).float(),
                                    zeros.clone(), o * block)
        d = (got - want).abs()
        ok = bool((d <= _sum_bound(torch, m, mass)).all())
        key = torch.where(recv[o] >= 0, recv[o], 2 ** 31 - 1).reshape(-1)
        key_s, order = torch.sort(key, stable=True)
        ids_s = torch.where(key_s == 2 ** 31 - 1, -1, key_s).contiguous()
        g_s = recv_g[o].reshape(-1)[order].contiguous()
        err = _seg_case(torch, f"P = 8, owner {o}'s received buffer",
                        ids_s, g_s, False)
        _, lengths = torch.unique_consecutive(ids_s[ids_s >= 0],
                                              return_counts=True)
        for n_, c in zip(*torch.unique(lengths, return_counts=True)):
            hist[int(n_)] = hist.get(int(n_), 0) + int(c)
        worst = max(worst, float(d.max()))
        log(f"[p8] owner {o}: owner_accumulate vs the plain scatter-add "
            f"max|d|={float(d.max()):.3e} (tol 2 (m - 1) 2^-24 sum|g|, m "
            f"the feature's received slots) ok={ok}; segment_sum max|d|="
            f"{err:.3e}; longest run {int(lengths.max())}")
        require(ok, f"owner_accumulate disagrees with the scatter-add at "
                f"P = 8, owner {o}")
        blocks.append(got)
    log(f"[p8] run lengths in the 8 owners' received buffers: "
        f"{json.dumps(dict(sorted(hist.items())))}")
    require(max(hist) > 1, "no run longer than 1 in the P = 8 buffers")
    grad8 = torch.cat(blocks)

    # the same samples' gradient at P = 1: one owner of every row
    cold1 = torch.cat([s[2] for s in srcs])
    g1 = torch.cat(grads)
    route1 = sparse.route_build(cold1, 1, f, dpmr.capacity(
        cfg, P8 * BATCH, 1))
    zeros = torch.zeros(f, device=dev)
    grad1 = ops.owner_accumulate(route1.req_ids,
                                 sparse.combine_grads(route1, g1),
                                 zeros.clone(), 0)
    mass1 = ops.owner_accumulate(route1.req_ids, sparse.combine_grads(
        route1, g1.abs()), zeros.clone(), 0)
    m1 = ops.owner_accumulate(route1.req_ids, sparse.combine_grads(
        route1, (cold1 >= 0).float()), zeros.clone(), 0)
    d = (grad8 - grad1).abs()
    ok8 = bool((d <= _sum_bound(torch, m1, mass1)).all())
    log(f"[p8] the 8 owners' gradient blocks vs the P = 1 gradient of the "
        f"same {P8 * BATCH} samples: max|d|={float(d.max()):.3e}, "
        f"{int((d > 0).sum())} of {int((m1 > 0).sum())} features differ "
        f"(tol 2 (m - 1) 2^-24 sum|g|, m the feature's slots, up to "
        f"{int(m1.max())}) ok={ok8}")
    require(ok8, "the P = 8 gradient disagrees with the P = 1 one")
    del grad1, mass1, m1, zeros, route1, table

    # select_pack on each source's 8-row send buffer
    k = compression.topk_count(cap, TOPK_FRAC)
    sel_err = 0.0
    for r in range(P8):
        ids_r = srcs[r][3].req_ids
        live = ids_r >= 0
        carry = torch.where(live & (torch.rand(ids_r.shape, generator=gen,
                                               device=dev) < 0.5),
                            torch.randn(ids_r.shape, generator=gen,
                                        device=dev) * (0.5 / BATCH), 0.0)
        sel_err = max(sel_err, _select_case(
            torch, f"P = 8, source {r}'s send", send[r], ids_r, carry, k))

    # times at one owner's (8, cap) shape, as the kernel phase takes them
    o = 0
    key = torch.where(recv[o] >= 0, recv[o], 2 ** 31 - 1).reshape(-1)
    key_s, order = torch.sort(key, stable=True)
    ids_s = torch.where(key_s == 2 ** 31 - 1, -1, key_s).contiguous()
    g_s = recv_g[o].reshape(-1)[order].contiguous()
    n, n_live = ids_s.numel(), int((ids_s >= 0).sum())
    seg = {"shape": [P8, cap], "run_lengths": hist, "max_abs_err": worst}
    seg["bound_ms"], seg["bound_by"] = bound(8 * n + 4 * n_live, n_live)
    _timed(torch, seg, lambda: segment_sum_sorted(ids_s, g_s), (),
           lambda: ref.segment_sum_sorted_ref(ids_s, g_s))
    _one_launch(torch, "segment_sum_sorted at P = 8", seg, 1)
    acc = torch.zeros(block, device=dev)
    oa = {"shape": [P8, cap]}
    _timed(torch, oa, lambda: ops.owner_accumulate(recv[o], recv_g[o], acc,
                                                   0), (),
           lambda: sparse.owner_accumulate(recv[o], recv_g[o], acc, 0))
    flat_ids = (recv[o] - o * block).reshape(-1).clamp(min=0).to(torch.int64)
    oa["library_ms"], oa["library_call_ms"] = kernel_and_call_ms(
        torch, lambda: acc.index_add_(0, flat_ids, recv_g[o].reshape(-1)), ())
    ids_r = srcs[0][3].req_ids
    carry = torch.zeros_like(send[0])
    live = int((ids_r >= 0).sum())
    sel = {"shape": [P8, cap], "k": k, "max_abs_err": sel_err}
    sel["bound_ms"], sel["bound_by"] = bound(
        8 * P8 * cap + 8 * live + 8 * P8 * k, live)
    _timed(torch, sel, lambda: select_pack(send[0], ids_r, carry, k), (),
           lambda: ref.select_pack_ref(send[0], ids_r, carry, k))
    key = torch.where(ids_r >= 0, (send[0] + carry).abs(), -1.0)
    sel["library_ms"], sel["library_call_ms"] = kernel_and_call_ms(
        torch, lambda: torch.topk(key, k, dim=1, sorted=True), ())
    for tag, e in (("segment_sum_sorted", seg), ("owner_accumulate", oa),
                   ("select_pack", sel)):
        log(f"[p8] {tag} at (8, {cap}): device ms={e['ms']:.5f} plain ms="
            f"{e['plain_ms']:.5f}"
            + (f" bound_ms={e['bound_ms']:.5f} ({e['bound_by']})"
               if "bound_ms" in e else "")
            + (f" library ms={e['library_ms']:.5f}" if "library_ms" in e
               else "")
            + f"; one call by CUDA events {e['call_ms']:.4f} ms")
    results["segment_sum_sorted"]["p8"] = seg
    results["select_pack"]["p8"] = sel
    results["owner_accumulate"]["p8"] = oa
    del recv, recv_g, send, back, resp, req
    torch.cuda.empty_cache()
    return {"gen_s": gen_s, "cap": cap, "run_lengths": hist,
            "grad_max_abs_err": float(d.max())}


def _same_state(torch, a, b, fields=("cold", "hot", "strat")):
    return all(_same_bits(torch, getattr(a, f), getattr(b, f))
               for f in fields)


def phase_parity(torch, dev):
    """Card vs CPU at 2^20 for a2a and topk_reduce, and run-to-run bit
    reproducibility of the card's gradient step (and of topk_reduce's
    train step, which writes the carry)."""
    from repro_torch import DPMRConfig, DPMREngine
    from repro_torch.api import hot_ids_from_corpus, put_batch
    from repro_torch.core import dpmr
    from repro_torch.optim import compression

    f = 1 << 20
    spec = dict(num_features=f, features_per_sample=K, signal_features=4096)
    batches = make_batches(spec, 5)
    out = {}
    for dist in ("a2a", "topk_reduce"):
        cfg = DPMRConfig(num_features=f, max_features_per_sample=K,
                         learning_rate=2.0, max_hot=512, optimizer="adagrad",
                         distribution=dist, topk_frac=TOPK_FRAC)
        hot_cpu = hot_ids_from_corpus(cfg, batches[:4], device="cpu")
        hot_gpu = hot_ids_from_corpus(cfg, batches[:4], device=dev)
        require(torch.equal(hot_cpu, hot_gpu.cpu()), "hot sets differ")
        card = DPMREngine(cfg, device=dev, hot_ids=hot_gpu)
        cpu = DPMREngine(cfg, device="cpu", hot_ids=hot_cpu)
        lc = [h["loss"] for h in card.fit_sgd(batches)]
        lh = [h["loss"] for h in cpu.fit_sgd(batches)]
        d_loss = max(abs(a - b) for a, b in zip(lc, lh))
        d_tab = {name: float((getattr(card.state, name).cpu()
                              - getattr(cpu.state, name)).abs().max())
                 for name in ("cold", "hot", "strat")}
        # a slot that won the top-k race on one side and lost on the other
        # leaves a residual on one side only
        flips = int(((card.state.strat.cpu() != 0)
                     != (cpu.state.strat != 0)).sum())
        k = compression.topk_count(dpmr.capacity(cfg, BATCH), TOPK_FRAC)
        log(f"[parity {dist}] 2^20, 5 steps card vs CPU: max|d loss|="
            f"{d_loss:.3e} (tol 1e-5); max|d table| {d_tab} (tol 1e-4; "
            f"|cold| up to {float(cpu.state.cold.abs().max()):.2f}); "
            f"features whose selection differs: {flips} (limit 0.1% of "
            f"k={k})")
        require(d_loss <= 1e-5 and max(d_tab.values()) <= 1e-4,
                f"card and CPU disagree on {dist}")
        require(flips <= 0.001 * k, f"{flips} selections differ on {dist}")

        fns = dpmr.make_step_fns(cfg, BATCH)
        b = put_batch(batches[0], dev)
        grads = [fns.grad_step(card.state, b) for _ in range(5)]
        same_grad = all(_same_bits(torch, o[0], grads[0][0])
                        and _same_bits(torch, o[1], grads[0][1])
                        for o in grads)
        states = []
        for _ in range(5):
            st = dpmr.DPMRState(*(t.clone() for t in card.state))
            states.append(fns.train_step(st, b)[0])
        same_step = all(_same_state(torch, st, states[0]) for st in states)
        log(f"[parity {dist}] grad_step x5 from one state: cold and hot "
            f"gradients bit-identical={same_grad}; train_step x5 from one "
            f"state: cold, hot and carry bit-identical={same_step}")
        require(same_grad and same_step,
                f"the card's {dist} step is not bit-reproducible")
        out[dist] = {"d_loss": d_loss, "d_table": d_tab,
                     "selection_flips": flips,
                     "grad_step_reproducible": same_grad,
                     "train_step_reproducible": same_step}
    return out


def yi_model(torch, dev, num_layers=None, generator=None):
    """yi-6b at full width (bf16 matrices, f32 norm scales), optionally cut
    to `num_layers`, with weights from `generator` (default: one on `dev`
    seeded SEED)."""
    import dataclasses

    from repro_torch.models import common, registry

    spec = registry.get_spec(ARCH)
    cfg = spec.cfg if num_layers is None else dataclasses.replace(
        spec.cfg, num_layers=num_layers)
    gen = generator or torch.Generator(device=dev).manual_seed(SEED)
    model = common.init_params(spec.model(cfg, device=gen.device), gen)
    return spec, cfg, model


def prompts(cfg, batch, length):
    return np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(batch, length)).astype(np.int32)


def layer0_qkv(torch, model, cfg, tokens):
    """Layer 0's q, k, v of a prefill of `tokens`, as prefill makes them
    (RMS norm, projections, RoPE)."""
    from repro_torch.models import common, layers

    with torch.inference_mode():
        x = common.embed_tokens(model.embed, tokens, cfg)
        lp = model.layers[0]
        h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
        q = layers.project_q(lp.attn, h, cfg)
        k, v = layers.project_kv(lp.attn, h, cfg)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        sin, cos = layers.rope_tables(pos, cfg.resolved_head_dim,
                                      cfg.rope_theta)
        return layers.apply_rope(q, sin, cos), layers.apply_rope(
            k, sin, cos), v


def attn_work(q, k, causal):
    """(bytes, flops) of one attention call: q, k, v read once and the
    output written once; 4 D flops per visible (query, key) pair per head
    (q.k and p.v), counting only the pairs the mask lets through."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if causal:
        shift = skv - sq
        pairs = sum(min(i + shift + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * skv * kh * d)
    return nbytes, 4 * d * pairs * b * h


def _attn_case(torch, name, q, k, v, causal):
    """flash_attention against its plain version: max |d| and the stated
    tolerance, |d| <= ATTN_TOL * (1 + |plain|), on bf16 outputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    got = flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    ok = bool((d <= ATTN_TOL * (1 + want.float().abs())).all()) \
        and bool(torch.isfinite(got).all())
    log(f"[kernels] flash_attention {name}: q {tuple(q.shape)} kv "
        f"{tuple(k.shape)} causal={causal} max|d|={err:.3e} (tol "
        f"{ATTN_TOL} * (1 + |plain|), bf16 probabilities against f32) "
        f"ok={ok}")
    require(ok, f"flash_attention disagrees with its plain version on {name}")
    return err


def phase_attention(torch, dev, model, cfg, results):
    """flash_attention on the card at the serve path's shape and on
    adversarial shapes; timed at (8, 4096)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    tokens = torch.from_numpy(prompts(cfg, SERVE_BATCH, PROMPT)).to(dev)
    q, k, v = layer0_qkv(torch, model, cfg, tokens[:1])
    err = _attn_case(torch, "path (yi-6b layer 0, batch 1)", q, k, v, True)
    rng = np.random.default_rng(SEED + 4)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    for name, (b, sq, skv, h, kh, d, causal) in {
            "D = 64": (2, 1024, 1024, 16, 4, 64, True),
            "MHA (KH = H)": (2, 512, 512, 8, 8, 128, True),
            "MQA group 48 (granite-34b)": (1, 1024, 1024, 48, 1, 128, True),
            "ragged S = 1000": (2, 1000, 1000, 32, 4, 128, True),
            "Sq < Skv": (2, 300, 1000, 32, 4, 128, True),
            "causal=False": (2, 1000, 1000, 32, 4, 128, False),
            "Sq = 1": (4, 1, 4097, 32, 4, 128, True),
            # the tile edges of the kernel (128 query rows a block, 64 a
            # consumer warpgroup, 128 keys a K/V tile)
            "S = 4097 (one key past a tile)": (1, 4097, 4097, 32, 4, 128,
                                                True),
            "S = 65": (2, 65, 65, 32, 4, 128, True),
            "S = 129": (2, 129, 129, 32, 4, 128, True),
            "(Sq, Skv) = (77, 1000)": (2, 77, 1000, 32, 4, 128, True),
            "(Sq, Skv) = (77, 1000), causal=False": (2, 77, 1000, 32, 4, 128,
                                                     False),
            "D = 64, S = 4096": (1, 4096, 4096, 32, 4, 64, True)}.items():
        _attn_case(torch, name, rand(b, sq, h, d), rand(b, skv, kh, d),
                   rand(b, skv, kh, d), causal)

    # the serve path's shape: q (8, 4096, 32, 128), kv (8, 4096, 4, 128)
    q, k, v = layer0_qkv(torch, model, cfg, tokens)
    nbytes, nflops = attn_work(q, k, True)
    bms, by = bound(nbytes, nflops, BF16_TC_FLOPS)
    entry = results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by, "shape": [list(q.shape), list(k.shape)],
        "flops": nflops, "bytes": nbytes}
    timed = {}

    def call():
        timed["out"] = flash_attention(q, k, v)

    with torch.inference_mode():
        _timed(torch, entry, call, ("flash_attention_kernel",),
               lambda: ref.flash_attention_ref(q, k, v))
        # the timed call's own output, one batch element at a time, and
        # two more calls on the same inputs: the same bits
        out = timed["out"]
        again = [flash_attention(q, k, v) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(out, a) for a in again)
        errs = []
        for i in range(q.shape[0]):
            want = ref.flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1])
            d = (out[i:i + 1].float() - want.float()).abs()
            errs.append(float(d.max()))
            require(bool((d <= ATTN_TOL * (1 + want.float().abs())).all())
                    and bool(torch.isfinite(out[i]).all()),
                    f"flash_attention's timed output disagrees with its "
                    f"plain version at batch element {i}")
        log(f"[kernels] flash_attention timed output {tuple(out.shape)}: "
            f"max|d| by batch element {[f'{e:.3e}' for e in errs]} (tol "
            f"{ATTN_TOL} * (1 + |plain|)) ok=True; 3 calls bit-identical="
            f"{same}")
        require(same, "flash_attention is not bit-reproducible")
        entry["max_abs_err"] = max(err, *errs)
        del out, again, timed["out"]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        entry["library_ms"], entry["library_call_ms"] = kernel_and_call_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), ())
    entry["tflops"] = nflops / entry["ms"] / 1e9
    log(f"[kernels] flash_attention at the serve path's {tuple(q.shape)} x "
        f"{tuple(k.shape)}: device ms={entry['ms']:.4f} "
        f"({entry['tflops']:.1f} TFLOP/s), plain ms={entry['plain_ms']:.4f},"
        f" scaled_dot_product_attention ms={entry['library_ms']:.4f}, bound "
        f"{bms:.4f} ms ({by}: {nflops / 1e12:.4f} TFLOP, "
        f"{nbytes / 1e9:.4f} GB)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def profile_window(torch, fn, n, tag):
    """Device busy time by kernel over `n` calls of `fn` under
    torch.profiler, beside the wall time of `n` untraced calls; the idle
    share is 1 - busy / untraced wall, as in `profile_steps`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            by_kernel[evt.key] = us / n / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile {tag}] {n} calls: untraced wall {wall_ms:.3f} ms/call, "
        f"device busy {busy:.3f} ms/call; idle share "
        f"{1 - busy / wall_ms:.3f}")
    for name, ms in top:
        log(f"[profile {tag}]   {ms:9.4f} ms  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "top": top}


def phase_serve(torch, dev, spec, cfg, model, results):
    """The dense main path: greedy_decode of yi-6b at full width and depth,
    batch 8 x 4096, 32 steps, counted; then its parts timed alone."""
    from repro_torch.kernels import ops
    from repro_torch.train import serve

    batch = {"tokens": prompts(cfg, SERVE_BATCH, PROMPT)}
    # warm-up: cuBLAS handles and workspaces, the allocator's pools
    serve.greedy_decode(spec, cfg, model, batch, 2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    toks = serve.greedy_decode(spec, cfg, model, batch, DECODE_STEPS,
                               device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {ARCH} {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.4f} B params: greedy_decode batch "
        f"{SERVE_BATCH} x prompt {PROMPT}, {DECODE_STEPS} steps in "
        f"{wall:.4f} s ({SERVE_BATCH * DECODE_STEPS / wall:.2f} generated "
        f"tok/s); max_memory_allocated {peak / 2 ** 30:.3f} GiB "
        f"({peak} B); launches {counts}")
    require(tuple(toks.shape) == (SERVE_BATCH, DECODE_STEPS)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"bad tokens {tuple(toks.shape)}")
    require(counts["flash_attention"] == cfg.num_layers
            and sum(counts.values()) == cfg.num_layers,
            f"greedy_decode launched {counts}: expected flash_attention "
            f"{cfg.num_layers} times (once per layer of the prefill)")
    results["flash_attention"]["launches"] = counts["flash_attention"]

    # the parts alone: prefill, then each decode step
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    prefill = serve.make_prefill_step(spec, cfg)
    decode = serve.make_decode_step(spec, cfg)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    pre_counts = ops.launch_counts()
    require(pre_counts["flash_attention"] == cfg.num_layers,
            f"prefill launched {pre_counts}")
    require(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
            "non-finite prefill logits")
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    require(torch.equal(tok[:, 0], toks[:, 0]),
            "prefill alone chose other first tokens than greedy_decode")
    ops.reset_launch_counts()
    step_ms = []
    for _ in range(16):
        t = time.perf_counter()
        logits, cache = decode(model, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    dec_counts = ops.launch_counts()
    require(sum(dec_counts.values()) == 0,
            f"decode steps launched {dec_counts}")
    require(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
            "non-finite decode logits")
    step_med = statistics.median(step_ms)
    log(f"[serve] prefill alone {prefill_s * 1e3:.3f} ms "
        f"({SERVE_BATCH * PROMPT / prefill_s:.1f} prompt tok/s), launches "
        f"{pre_counts}; decode step median {step_med:.4f} ms over 16 "
        f"(min {min(step_ms):.4f}, max {max(step_ms):.4f}; "
        f"{SERVE_BATCH / step_med * 1e3:.2f} tok/s), launches {dec_counts}")

    def step():
        decode(model, cache, tok)

    # 16 more steps: 8 untraced, 8 traced; the cache keeps 32 slots of
    # headroom, so no step writes past it
    dec_prof = profile_window(torch, step, 8, "decode step")
    del cache, logits
    torch.cuda.empty_cache()
    pre_prof = profile_window(
        torch, lambda: prefill(model, {"tokens": tokens}), 1, "prefill")
    torch.cuda.empty_cache()
    return {"arch": ARCH, "batch": SERVE_BATCH, "prompt": PROMPT,
            "decode_steps": DECODE_STEPS, "greedy_s": wall,
            "generated_tok_per_s": SERVE_BATCH * DECODE_STEPS / wall,
            "prefill_ms": prefill_s * 1e3,
            "prompt_tok_per_s": SERVE_BATCH * PROMPT / prefill_s,
            "decode_ms_median": step_med, "decode_ms": step_ms,
            "max_memory_allocated": peak, "launches": counts,
            "decode_profile": dec_prof, "prefill_profile": pre_prof,
            "first_tokens": toks[:2].cpu().tolist()}


def phase_dense_parity(torch, dev):
    """yi-6b at full width, 2 layers: the card against the CPU on the same
    weights and tokens, and the card's prefill with the kernel against the
    card's prefill with the plain attention in its place.

    Tolerance: both sides round their bf16 activations at the same places
    but sum in other orders (cuBLAS against oneDNN, the kernel's bf16
    probabilities against f32 ones), so they differ by a few bf16 units
    of the activations' scale; the logits must agree to the reference's
    bf16 tolerance taken relative to the row's scale,
    |d| <= ATTN_TOL * max|logits| of the row, and the greedy tokens may
    differ only where the CPU's top two logits are closer than that."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer

    spec, cfg, cpu = yi_model(torch, "cpu", num_layers=2,
                              generator=torch.Generator().manual_seed(SEED))
    card = transformer.Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens = prompts(cfg, 2, 256)
    out = {"steps": []}

    def compare(tag, got, want):
        got = got.float().cpu()[:, -1, :cfg.vocab_size]
        want = want.float().cpu()[:, -1, :cfg.vocab_size]
        scale = want.abs().amax(dim=-1, keepdim=True)
        d = (got - want).abs()
        ok = bool((d <= ATTN_TOL * scale).all())
        top2 = torch.topk(want, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        tie = gap < ATTN_TOL * scale[:, 0]
        ok = ok and bool((same | tie).all())
        rec = {"step": tag, "max_abs_err": float(d.max()),
               "mean_abs_err": float(d.mean()),
               "tol": (ATTN_TOL * scale[:, 0]).tolist(),
               "argmax_equal": same.tolist()}
        log(f"[dense parity] {tag}: max|d logits|={rec['max_abs_err']:.4e} "
            f"mean {rec['mean_abs_err']:.4e} (tol {ATTN_TOL} x max|logit| "
            f"= {[round(x, 4) for x in rec['tol']]}); argmax equal "
            f"{rec['argmax_equal']} ok={ok}")
        require(ok, f"card and reference disagree at {tag}")
        return rec

    ops.reset_launch_counts()
    logits_c, cache_c = spec.prefill(
        card, {"tokens": torch.from_numpy(tokens).to(dev)}, cfg)
    require(ops.launch_counts()["flash_attention"] == 2,
            f"2-layer prefill launched {ops.launch_counts()}")
    logits_h, cache_h = spec.prefill(
        cpu, {"tokens": torch.from_numpy(tokens)}, cfg)
    out["steps"].append(compare("prefill, card vs CPU", logits_c, logits_h))
    seen = ops.flash_attention
    try:
        ops.flash_attention = ref.flash_attention_ref
        logits_p, _ = spec.prefill(
            card, {"tokens": torch.from_numpy(tokens).to(dev)}, cfg)
    finally:
        ops.flash_attention = seen
    out["kernel_vs_plain"] = compare(
        "prefill on the card, kernel vs plain attention", logits_c, logits_p)
    tok = torch.argmax(logits_c[:, -1], dim=-1)[:, None].to(torch.int32)
    for i in range(4):
        logits_c, cache_c = spec.decode_step(card, cache_c, tok, cfg)
        logits_h, cache_h = spec.decode_step(cpu, cache_h, tok.cpu(), cfg)
        out["steps"].append(compare(f"decode step {i + 1}, card vs CPU",
                                    logits_c, logits_h))
        tok = torch.argmax(logits_c[:, -1], dim=-1)[:, None].to(torch.int32)
    dk = float((cache_c["k"].float().cpu() - cache_h["k"].float()).abs().max())
    log(f"[dense parity] K cache after 4 steps: max|d|={dk:.4e}")
    out["cache_k_max_abs_err"] = dk
    del card, cache_c
    torch.cuda.empty_cache()
    return out


def main():
    import torch

    smi = phase_device(torch)
    dev = torch.device("cuda")
    build_s, resources = phase_build()
    from repro_torch.api import hot_ids_from_corpus

    spec = dict(num_features=1 << LOG2_F, features_per_sample=K,
                signal_features=4096)
    t0 = time.perf_counter()
    train = make_batches(spec, STEPS)
    test = make_batches(spec, 3, start=1000)
    gen_s = time.perf_counter() - t0
    hot = hot_ids_from_corpus(full_width_config(), train[:4])
    log(f"[data] 2^{LOG2_F} features: host batch generation {gen_s:.2f} s "
        f"for {len(train) + len(test)} batches of {BATCH} (not in any step "
        f"time); hot set {int((hot < 2 ** 31 - 1).sum())} ids")
    results = phase_kernels(torch, dev, train[0], hot)
    engine = phase_engine(torch, dev, results, train, test, hot)
    engine["batch_gen_s"] = gen_s
    multirank = phase_multirank(torch, dev, train, hot)
    p8 = phase_p8(torch, dev, hot, results)
    parity = phase_parity(torch, dev)
    del train, test
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec, cfg, model = yi_model(torch, dev)
    torch.cuda.synchronize()
    log(f"[serve] {ARCH} weights from torch.Generator(seed {SEED}) on the "
        f"card in {time.perf_counter() - t0:.2f} s: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")
    phase_attention(torch, dev, model, cfg, results)
    served = phase_serve(torch, dev, spec, cfg, model, results)
    del model
    torch.cuda.empty_cache()
    dense_parity = phase_dense_parity(torch, dev)

    kernels = [results[name] for name in ("sigmoid_grad",
                                          "segment_sum_sorted",
                                          "select_pack", "flash_attention")]
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build_s": build_s,
         "kernel_resources": resources, "kernels": kernels,
         "owner_accumulate": results["owner_accumulate"],
         "reduces": results["reduces"],
         "engine": engine, "multirank": multirank, "p8": p8,
         "parity": parity, "serve": served,
         "dense_parity": dense_parity}, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
