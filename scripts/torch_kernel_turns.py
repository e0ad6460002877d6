#!/usr/bin/env python3
"""Time the sparse path's `sigmoid_grad`, `select_pack` and
`segment_sum_sorted` kernels of one checkout of the PyTorch port on the
card, and optionally the sparse train step around them, so that two
checkouts can be compared in turns.

    python3 scripts/torch_kernel_turns.py [--tree DIR] [--steps]

DIR (default: this checkout) is the root of a checkout of the repo: its
`src/repro_torch` is imported and its kernels are built into DIR/build.
The inputs and the timing helpers are this checkout's `chip_smoke.py`
ones, with its seeds: the routed request buffer of one Zipf batch at 2^27
features (P = 1, cap = 262,144) for both kernels, `select_pack` at k =
13,108 (topk_frac 0.05) and 65,536 (0.25); `sigmoid_grad` on that batch's
(4096, 64) vals and labels, and at (262,144, 64) on N(0, 1) inputs drawn
on the card (chip_smoke's `path_sigmoid_inputs`, `large_sigmoid_inputs`).
Beside them, `sigmoid_grad`'s wrapper on the host at (4096, 64), split
into its parts (`chip_smoke.host_us`: the mean of 1,000 calls of each
part, `time.perf_counter_ns`); a checkout whose wrapper predates the one
output buffer (no `layout`) is split into its own parts, three
allocations and a `torch.cuda.Stream` lookup among them. Each time is the
device time
of every device operation of one call (kernels and memsets), from a
torch.profiler trace of 20 calls after a warm-up call, with the number of
each operation per call from the same trace. With `--steps`, it also
trains `a2a` and `topk_reduce` at chip_smoke's full width for 2 steps and
profiles 8 more (`chip_smoke.profile_steps`): device busy per step and
the idle share.

To compare two checkouts, run it for each on one card, in turns,
A B B A, and read the JSON line each run prints last.
"""
import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def three_buffer_parts(torch, sg, vals, theta, y):
    """The host parts of a sigmoid_grad wrapper that allocates grads, probs
    and nll apart and looks the stream up as a torch.cuda.Stream, with a
    nine-argument C entry (the port's wrapper before its one output
    buffer)."""
    from repro_torch.kernels import build

    lib = build.library()
    b, k = vals.shape
    outs = (torch.empty_like(vals), torch.empty((b,), device=vals.device),
            torch.empty((b,), device=vals.device))
    args = (vals.data_ptr(), theta.data_ptr(), y.data_ptr(),
            *(t.data_ptr() for t in outs), b, k,
            torch.cuda.current_stream(vals.device).cuda_stream)
    return {
        "checks": lambda: sg._check(vals, theta, y),
        "allocations": lambda: (
            torch.empty_like(vals),
            torch.empty((b,), dtype=torch.float32, device=vals.device),
            torch.empty((b,), dtype=torch.float32, device=vals.device)),
        "stream": lambda: torch.cuda.current_stream(vals.device).cuda_stream,
        "ctypes_launch": lambda: lib.repro_sigmoid_grad_f32(*args),
        "wrapper": lambda: sg.sigmoid_grad(vals, theta, y),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--steps", action="store_true",
                    help="also profile a2a and topk_reduce train steps")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))

    import torch

    from repro_torch.api import DPMREngine, hot_ids_from_corpus, put_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_sum import segment_sum_sorted
    from repro_torch.kernels.select_pack import select_pack
    from repro_torch.kernels import sigmoid_grad as sg
    from repro_torch.kernels.sigmoid_grad import sigmoid_grad

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_turns: no CUDA device")
    cs.require(pathlib.Path(build.__file__).resolve().is_relative_to(tree),
               f"imported {build.__file__}, not the checkout {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    build.build()
    spec = dict(num_features=1 << cs.LOG2_F, features_per_sample=cs.K,
                signal_features=4096)
    batches = cs.make_batches(spec, 10 if args.steps else 4)
    hot = hot_ids_from_corpus(cs.full_width_config(), batches[:4])
    _, _, _, routing = cs.path_routing(torch, dev, batches[0], hot)
    seg_ids, seg_g, _ = cs.path_segment_inputs(torch, dev, routing.req_ids)
    send, ids, carry, k, _ = cs.path_select_inputs(torch, dev, routing)
    sg_path = cs.path_sigmoid_inputs(torch, dev, batches[0])
    sg_large = cs.large_sigmoid_inputs(torch, dev)

    out = {"tree": str(tree), "nvidia_smi": smi, "kernels": {}}
    for name, fn in (
            ("sigmoid_grad_4096x64", lambda: sigmoid_grad(*sg_path)),
            (f"sigmoid_grad_{cs.SG_LARGE}x64", lambda: sigmoid_grad(
                *sg_large)),
            ("segment_sum_sorted", lambda: segment_sum_sorted(seg_ids,
                                                              seg_g)),
            (f"select_pack_k{k}", lambda: select_pack(send, ids, carry, k)),
            ("select_pack_k65536", lambda: select_pack(send, ids, carry,
                                                       65536))):
        counts = {}
        ms, call_ms = cs.kernel_and_call_ms(torch, fn, (), counts=counts)
        out["kernels"][name] = {"ms": ms, "call_ms": call_ms,
                                "ops_per_call": counts}
        cs.log(f"[turns {tree.name}] {name}: device ms {ms:.5f}, one call "
               f"by CUDA events {call_ms:.4f} ms; a call runs "
               f"{json.dumps(counts)}")
    parts = (cs.sg_host_parts(torch, *sg_path) if hasattr(sg, "layout")
             else three_buffer_parts(torch, sg, *sg_path))
    out["sigmoid_grad_host_us"] = cs.host_us(torch, parts)
    cs.log(f"[turns {tree.name}] sigmoid_grad host us a call: " + ", ".join(
        f"{name} {us:.3f}" for name, us in out["sigmoid_grad_host_us"].items()))
    if args.steps:
        dev_train = [put_batch(b, dev) for b in batches]
        out["steps"] = {}
        for dist in ("a2a", "topk_reduce"):
            eng = DPMREngine(cs.full_width_config(dist), hot_ids=hot)
            eng.fit_sgd(dev_train[:2])
            prof = cs.profile_steps(torch, eng, dev_train[2:10],
                                    f"{tree.name} {dist}")
            out["steps"][dist] = {key: prof[key] for key in (
                "wall_ms", "traced_wall_ms", "busy_ms", "idle_share")}
            del eng
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
