#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, in order; any failure exits non-zero:
  1. device   require CUDA; print the card's name and power limit
  2. build    nvcc-build the port's CUDA kernels from src/repro_torch/
              kernels/csrc (sm_90a), print the build seconds
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes and on adversarial inputs
              (`select_pack` bit for bit). Two times each: `ms`/
              `plain_ms` are device time from a torch.profiler (CUPTI)
              trace, the mean over 20 calls after a warm-up call;
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
  5. parity   both strategies at 2^20 features on the card and on the CPU
              from the same batches; run-to-run bit reproducibility of
              the card's gradient step and of topk_reduce's carry
Then one `{"kernels": [...]}` line, and last the device line
`{"ok": true, "device": {...}}`. Measurements also go to
results/chip_smoke.json.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
LOG2_F, K, BATCH, STEPS = 27, 64, 4096, 20
TOPK_FRAC = 0.05
SEED = 0


def log(msg):
    print(msg, flush=True)


def bound(nbytes, nflops):
    """Least time in ms for the work: the larger of its bytes over the
    memory rate and its f32 operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nflops / F32_FLOPS
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


def device_times(torch, fn, iters=20):
    """Device time per call of `fn` in ms, by kernel name, from a
    torch.profiler (CUPTI) trace of `iters` calls after one warm-up call.
    Unlike CUDA events around one call, this leaves out the host's
    dispatch time while the card waits."""
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


def kernel_and_call_ms(torch, fn, names, iters=50):
    """(device ms of the kernels whose names contain one of `names`, or
    of all kernels when `names` is empty; ms of one call by CUDA events).

    A profiler trace that shows none of those kernels is taken again, up
    to 3 traces in all (on the H100 one trace in a run has come back
    without the kernels it timed); after that the device ms is
    `events_ms`, and the log says so."""
    for _ in range(3):
        dev = device_times(torch, fn)
        ms = sum(v for k, v in dev.items() if not names
                 or any(n in k for n in names))
        if ms > 0:
            break
    else:
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


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc {build.find_nvcc()} -> {build.BUILD_DIR}: "
        f"{secs:.2f} s")
    return secs


def make_batches(spec_kw, n, start=0):
    from repro_torch.data import get_source

    src = get_source("zipf_sparse", batch_size=BATCH, start=start, **spec_kw)
    return [src.batch(i) for i in range(n)]


def _sg_entry(torch, dev, batch, results):
    """sigmoid_grad at the path's (4096, 64) f32 against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sigmoid_grad import sigmoid_grad

    rng = np.random.default_rng(SEED)
    vals = torch.from_numpy(batch["vals"]).to(dev)
    theta = torch.from_numpy(
        rng.normal(0.0, 2.0, size=vals.shape).astype(np.float32)).to(dev)
    y = torch.from_numpy(batch["labels"]).to(dev)
    got = sigmoid_grad(vals, theta, y)
    want = ref.sigmoid_grad_ref(vals, theta, y)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # tolerance: the logit is a 64-term f32 sum in another order
    tol_ok = all(bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all())
                 for g, w in zip(got, want))
    log(f"[kernels] sigmoid_grad (4096, 64) f32: max|d|={err:.3e} "
        f"(tol 1e-5 + 1e-5|plain|) ok={tol_ok}")
    require(tol_ok, "sigmoid_grad disagrees with its plain version")
    b, k = vals.shape
    bms, by = bound(12 * b * k + 12 * b, 3 * b * k)
    results["sigmoid_grad"] = {
        "name": "sigmoid_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sigmoid_grad.cu",
        "replaces": "src/repro/kernels/sigmoid_grad.py:38",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by, "library_ms": None}
    _timed(torch, results["sigmoid_grad"],
           lambda: sigmoid_grad(vals, theta, y), ("sigmoid_grad_kernel",),
           lambda: ref.sigmoid_grad_ref(vals, theta, y))


def _timed(torch, entry, kernel_fn, names, plain_fn):
    """Fill an entry's device times (profiler) and call times (events)."""
    entry["ms"], entry["call_ms"] = kernel_and_call_ms(torch, kernel_fn,
                                                       names)
    entry["plain_ms"], entry["plain_call_ms"] = kernel_and_call_ms(
        torch, plain_fn, ())


def _run_mass(ref, ids, g):
    """Per-slot sum of |g| over the slot's run, at run ends (tolerance)."""
    return ref.segment_sum_sorted_ref(ids, g.abs())


def _seg_case(torch, name, ids, g, exact):
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    got = segment_sum_sorted(ids, g)
    again = segment_sum_sorted(ids, g)
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
    repro = bool(torch.equal(got, again))
    runs = int(((ids[1:] != ids[:-1]) & (ids[1:] >= 0)).sum()) + \
        int(ids.numel() > 0 and ids[0] >= 0)
    log(f"[kernels] segment_sum_sorted {name}: N={ids.numel()} runs={runs} "
        f"max|d|={err:.3e} (tol {tol}) ok={ok} bit-reproducible={repro}")
    require(ok, f"segment_sum_sorted disagrees on {name}")
    require(repro, f"segment_sum_sorted not reproducible on {name}")
    return err


def _sorted_last_pad(torch, ids_flat):
    key = torch.where(ids_flat >= 0, ids_flat, 2 ** 31 - 1)
    key_s = torch.sort(key, stable=True).values
    return torch.where(key_s == 2 ** 31 - 1, -1, key_s).contiguous()


def _seg_entries(torch, dev, batch, path_req, results):
    """segment_sum_sorted at the path's N and on adversarial inputs, and
    owner_accumulate at the path's shape."""
    from repro_torch.core import sparse
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    rng = np.random.default_rng(SEED + 1)
    n = path_req.numel()

    def normal(m):
        return torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)

    def integer(m):
        return torch.from_numpy(
            rng.integers(-8, 9, size=m).astype(np.float32)).to(dev)

    # the main path's input: the sorted request ids of a real batch (at
    # P = 1 every run has length 1: route_build deduplicates per source)
    path_ids = _sorted_last_pad(torch, path_req.reshape(-1))
    path_g = normal(n)
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

    bms, by = bound(12 * n, n)
    results["segment_sum_sorted"] = {
        "name": "segment_sum_sorted", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum.py:68",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by, "library_ms": None}
    _timed(torch, results["segment_sum_sorted"],
           lambda: segment_sum_sorted(path_ids, path_g),
           ("segment_tile_kernel", "segment_carry_kernel"),
           lambda: ref.segment_sum_sorted_ref(path_ids, path_g))

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
    err = max(float((g.float() - w.float()).abs().max()) if g.numel()
              else 0.0 for g, w in zip(got, want))
    live = int((ids >= 0).sum())
    log(f"[kernels] select_pack {name}: (P, cap)={tuple(ids.shape)} k={k} "
        f"live={live} max|d|={err:.3e} bit-exact={ok}")
    require(ok, f"select_pack disagrees with its plain version on {name}")
    return err


def _select_entries(torch, dev, routing, results):
    """select_pack at the path's shape, from a real batch's routed send
    buffer at 2^27, for k at topk_frac 0.05 and 0.25, and on adversarial
    rows; timed at the path's k against torch.topk of the same key."""
    from repro_torch.core import sparse
    from repro_torch.kernels import ref
    from repro_torch.kernels.select_pack import select_pack
    from repro_torch.optim import compression

    rng = np.random.default_rng(SEED + 3)

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    ids = routing.req_ids
    p, cap = ids.shape
    live = ids >= 0
    g = tensor(rng.normal(scale=1.0 / BATCH, size=routing.order.numel())
               .astype(np.float32))
    send = sparse.combine_grads(routing, g)
    # a carry from earlier steps: a residual on half the live slots
    carry = torch.where(live & tensor(rng.random(ids.shape) < 0.5),
                        tensor(rng.normal(scale=0.5 / BATCH, size=ids.shape)
                               .astype(np.float32)), 0.0)
    k = compression.topk_count(cap, TOPK_FRAC)
    err = _select_case(torch, "path (routed send, frac 0.05)", send, ids,
                       carry, k)
    _select_case(torch, "path (routed send, frac 0.25)", send, ids,
                 carry, compression.topk_count(cap, 0.25))

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

    # bound: read send, ids, carry and write resid (16 B a slot), write
    # the k (value, id) pairs (8 B each); one f32 add a slot
    bms, by = bound(16 * p * cap + 8 * p * k, p * cap)
    entry = results["select_pack"] = {
        "name": "select_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/select_pack.cu",
        "replaces": "src/repro/kernels/select_pack.py:89",
        "launches": None, "max_abs_err": err, "bound_ms": bms,
        "bound_by": by}
    _timed(torch, entry, lambda: select_pack(send, ids, carry, k),
           ("select_pack_",),
           lambda: ref.select_pack_ref(send, ids, carry, k))
    key = torch.where(live, (send + carry).abs(), -1.0)
    entry["library_ms"], entry["library_call_ms"] = kernel_and_call_ms(
        torch, lambda: torch.topk(key, k, dim=1, sorted=True), ())
    log(f"[kernels] select_pack at (1, {cap}), k={k}: torch.topk of the key "
        f"alone device ms={entry['library_ms']:.5f}")


def phase_kernels(torch, dev, batch, hot):
    from repro_torch.core import dpmr, hot_sharding, sparse
    from repro_torch.configs import DPMRConfig

    results = {}
    _sg_entry(torch, dev, batch, results)
    cfg = DPMRConfig(num_features=1 << LOG2_F, max_features_per_sample=K)
    cap = dpmr.capacity(cfg, BATCH)
    ids = torch.from_numpy(batch["ids"]).to(dev).reshape(-1)
    hot_slot, is_hot, cold_ids = hot_sharding.split_hot(ids, hot)
    routing = sparse.route_build(cold_ids, 1, 1 << LOG2_F, cap)
    _seg_entries(torch, dev, batch, routing.req_ids, results)
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
    """Where a train step's time goes: fit_sgd over `batches` twice, first
    untraced for the wall time per step, then under torch.profiler for
    the device busy time per step by kernel. The profiler adds host cost
    to every launch, so the idle share is 1 - busy / untraced wall; the
    traced wall is reported beside it."""
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
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "idle_share_traced": 1 - busy / traced_ms, "top": top}


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


def main():
    import torch

    smi = phase_device(torch)
    dev = torch.device("cuda")
    build_s = phase_build()
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
    parity = phase_parity(torch, dev)

    kernels = [results[name] for name in ("sigmoid_grad",
                                          "segment_sum_sorted",
                                          "select_pack")]
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build_s": build_s, "kernels": kernels,
         "owner_accumulate": results["owner_accumulate"],
         "reduces": results["reduces"],
         "engine": engine, "parity": parity}, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
