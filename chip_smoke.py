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
              shapes and its wrapper's host time split into parts;
              `row_update` over one owner's received run totals into
              the 2^27-row table, adagrad and sgd, bit for bit against
              its plain version on the card). Two
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
              before and read just after (a2a: one row_update a step,
              the table's update; topk_reduce and fit: none), a
              full-batch fit iteration, a
              profiled window of 8 steps, evaluate on 3 held-out batches
              (start=1000)
  5. dataplane  at configuration 1's width: a file corpus of the 20
              training batches (`write_file_corpus`, seconds and bytes);
              a2a for 20 steps fed 8 ways in turns (A B ... B A), each
              with the launch counters set to 0 just before and read just
              after and its state bit-identical to the first resident
              run's: batches resident on the card; ShardedLoader over
              the file corpus with prefetch 2 and with prefetch 0; a
              prefetching loader over batches in memory; and, just
              before each step, a host batch placed (put_batch), a
              resident batch cloned, a batch copied from host memory
              pinned once, a resident batch after a host copy of its
              bytes. Each step is split at the hand-over into fetching
              and training; the consumer's wait a batch; profiled
              windows of 8 steps, resident and loader-fed (idle share,
              the host operations the loader adds); placing one batch
              timed and traced; 4 steps from a loader that synthesises
              zipf_sparse batches beside the host's time a batch; a 2^27
              checkpoint's cost (save blocking and asynchronous, the
              snapshot's device time, wait, restore, bytes); a resume
              for a2a and topk_reduce (10 steps, save(block=False), 10
              more at once; a new engine and loader restore and train
              10) bit-identical to the uninterrupted engine, the file
              holding the pre-step bits; `auto` resolved on the card and
              the CPU, and its ranking at P = 1, 8 and (pod 2, data 4).
              Its files live under build/ and are deleted at the end
  6. multirank  the same engine through an NCCL process group of one
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
  7. p8       the buffers of a P = 8 routing on one card: a global batch
              of 8 x 4096 samples at 2^27, each rank's rows routed to 8
              owners of 2^24 rows, the all_to_alls as transposes of the
              stacked buffers; each owner's owner_accumulate and
              segment_sum_sorted against the plain versions, the
              run-length histogram of the received buffers (a run longer
              than 1 required), select_pack on the 8-row send buffers bit
              for bit, the 8 owners' gradient against the P = 1 gradient
              of the same samples; segment_sum_sorted, owner_accumulate
              and select_pack timed at one owner's (8, cap)
  8. parity   both strategies at 2^20 features on the card and on the CPU
              from the same batches; run-to-run bit reproducibility of
              the card's gradient step and of topk_reduce's carry
  9. sparse_serve  configuration 8: a2a trained 20 steps on the resident
              batches at 2^27, saved under build/ and restored with
              DPMRServeEngine.from_checkpoint (seconds); traffic A, the
              12,288 held-out rows cut into requests of 1-64 rows (numpy
              seed 0), submitted at once by 8 client threads, served with
              max_batch 64 and then 1024 (max_wait_ms 2, the reference's
              hot-cache defaults), the launch counters set to 0 just
              before and read just after each (the forward launches none
              of the repo's kernels); p50/p99 latency, requests/s,
              samples/s, batch_mean, padding_frac, hit rate, refreshes;
              every answer bit-identical to predict_padded of its request
              alone, the counters adding up; a refresh's ms on traffic
              A's window and the dense select_hot(feature_counts()) route
              beside it, the two selections equal; traffic B, 256
              head-only requests of 1-4 rows drawn from the mirror, every
              one a hit, the host µs a hit; stop() draining 8 queued
              requests and submit after it raising; predict_padded alone
              at buckets 64, 256, 1024, 4096 (CUDA events) with a profiled
              window at 1024, and the row arithmetic (halving tree, f64
              sigmoid) against torch.sum; then traffic A through an NCCL
              group of one rank (file store), bit-identical to no group,
              with the host µs of the front's broadcasts a flush. Its
              files under build/ are deleted at the end
  10. attention  yi-6b at full width (32 layers, bf16) built on the card
              from a torch.Generator seeded 0; `flash_attention` against
              its plain version on layer 0's q, k, v of a (1, 4096)
              prefill, and on adversarial shapes (D = 64, MHA, MQA with
              group 48, ragged S, Sq < Skv, full attention, Sq = 1, the
              kernel's tile edges); timed at the serve path's (8, 4096)
              with its plain version and scaled_dot_product_attention as
              the yardstick; the timed call's own output held to the
              plain version, and 3 calls bit-identical
  11. serve   greedy_decode of yi-6b, batch 8 x prompt 4096 (numpy seed
              0), 32 steps, with the launch counters set to 0 just before
              and read just after (flash_attention: 32, all in prefill);
              then prefill and each decode step timed alone, a profiled
              prefill and a profiled window of decode steps
  12. dense parity  yi-6b at full width with 2 layers, weights from a CPU
              generator copied to the card: prefill (2 x 256) and 4
              decode steps on the card and on the CPU; the card's prefill
              again with the plain attention put in the kernel's place
  13. train_dense  the dense trainer (train.trainer.make_train_step) on
              yi-6b at full width: (a) configuration 9, 4 layers, batch
              4 x 4096 of lm_markov (seed 0) through launch.train's loader,
              adamw lr 3e-4 warmup 2, remat full, 10 steps with the launch
              counters set to 0 just before and read just after (the
              path reaches none of the four kernels): step ms, tokens/s,
              model TFLOP/s and its share of the bf16 peak, peak memory,
              the losses (finite; the first batch's cross-entropy after
              step 10 below step 1's), a profiled
              window of 2 steps (idle share, top device operations);
              (b) one sgd step at 1 layer, 1 x 256, on the card and on
              the CPU from the same params (convert); (c) at 1 layer and
              4 x 4096, remat dots and none against full bit for bit
              (peak memory of each) and microbatches 2 against 1; (d)
              launch.train --arch granite-8b --smoke, killed at step 13
              under run_with_restarts (async saves every 5) and preempted
              at step 18, each against an uninterrupted 30-step run (and a
              second uninterrupted run against the first). Its files
              under build/ are deleted at the end
  14. moe     the MoE family and the sliding window, each model freed
              before the next is built: (a) configuration 10,
              phi3.5-moe at full width cut to 16 layers (bf16, weights
              from a torch.Generator seeded 0): flash_attention held to
              its plain version on layer 0's q, k, v at (8, 4096) (GQA
              group 4) and timed beside its plain version and SDPA; then
              greedy_decode batch 8 x prompt 4096, 32 steps, counted
              (flash_attention 16 launches, all in prefill), prefill and
              decode steps timed alone, profiled windows, and the share
              of (token, slot) pairs dropped at prefill and over 31
              decode steps; (b) one layer of phi3.5-moe at full width, 2 x
              512, card vs CPU: in f32 (TF32 off) layer 0's experts,
              capacity positions and kept pairs equal except at near ties
              (top-k margin < 1e-5), the training forward's logits within
              1e-4 of each row's scale (prefill's kernel takes bf16 only),
              the aux within 1e-5; in bf16 the share of tokens given the
              same experts (at least 0.95), and for the tokens routed
              alike the forward's and prefill's last logits, and the aux,
              within 2e-2; (c) configuration
              11, phi3.5-moe cut to 2 layers (1 if the peak passes 75
              GiB), batch 4 x 4096 of lm_markov, adamw lr 3e-4 warmup 2,
              remat full, 10 steps as in 13(a), the model FLOPs from the
              active parameters, the aux each step; one sgd step at 1
              layer, 1 x 256, in f32 activations, card vs CPU as 13(b);
              (d) configuration 12, mixtral-8x22b at full width cut to 8
              layers, batch 2 x prompt 8192 (twice the window, so the
              ring is aligned), 32 steps, as (a) with no flash_attention
              launch (the window takes the blocked attention); then the
              ring check: decode_attention over a ring of 4096 slots for
              32 steps past 8192 seeded bf16 positions at mixtral's
              attention widths, each step within 2e-2 * (1 + |ref|) of
              blocked_causal_attention(window=4096) over the whole
              sequence
  15. families  the hybrid, SSM and encoder-decoder families, each model
              freed before the next is built (weights from seed 0): (a)
              flash_attention at zamba2's head dim 80 (the D = 128
              instance with the tensor maps' D at 80) on the shared
              block's q, k, v of an (8, 4096) prefill (a 6-layer zamba2)
              and on adversarial shapes (ragged S, Sq < Skv, full, Sq =
              1, tile edges), each held to the plain version, 3 calls
              bit-identical, timed beside the bound, the plain version
              and SDPA; (b) configuration 13: zamba2-2.7b at full width
              and depth (54 layers, bf16) served as in 11 (8 x 4096, 32
              steps, flash_attention 9 launches a prefill); (g) its state
              handoff at 2 layers and one shared block (bf16; A_log and
              dt_bias at -4 so the state outlives 128 steps): prefill(3968) + 128 decode
              steps against prefill(4096), within ATTN_TOL of the row's
              scale, and a control from zeroed SSD states missing by 5x
              that; (c) configuration 14: zamba2 trained as in 13(a) at
              12 layers, else 6 (out of memory or a peak above 75 GiB
              cuts it; the cut is logged; 54 layers run out of memory on
              one card, a 4-card cell now), model FLOPs with the
              chunked scan and the attention (`model_flops`), and one
              f32 sgd step at 6 layers, 1 x 256, card vs CPU; (d)
              configurations 15-16: xlstm-125m served (8 x 4096, 32
              steps, no kernel launch), its f32 handoff (forget biases
              raised; within XLSTM_HANDOFF_TOL = 3e-4, 2x the sound
              path's reading and above the logits' response to one f32
              rounding of the input), and
              trained at 16 x 1024 cut to 4 blocks (remat none; its
              sLSTM loop is host-bound), the sLSTM loop's share
              of the step from the same step with the sLSTM blocks made
              the identity, and one f32 sgd step at 2 layers, 1 x 256,
              card vs CPU (not the loss's fall: at random init the
              mLSTM's normaliser keeps 10 steps from moving it); (e)
              configurations 17-18:
              whisper-small served (8 x 1500 frames, prompt 416, 32
              steps: the decoder's 448 positions; flash_attention 36
              launches a prefill), the kernel timed at the encoder's
              (8, 1500), the decoder's causal (8, 416) and the cross
              (416 x 1500) shapes, each timed output held to the plain
              version a batch element at a time, trained at
              16 x 1024 frames and tokens through launch.train's loader;
              (f) each family at full width and 2 layers card vs CPU,
              prefill and 4 decode steps (zamba2 and whisper in bf16
              within ATTN_TOL of the row's scale, xlstm in f32 with TF32
              off within 1e-4)
  16. distribution  the dense trainer over a mesh, on an NCCL group of one
              rank, mesh (data 1, model 1): (1) configuration 9 as in
              13(a) through make_train_step(..., mesh), losses and final
              params bit for bit against 13(a)'s one-card run (the
              gathers NCCL copies, the reduce-scatters the identity),
              both runs' step ms, tokens/s, model TFLOP/s, peak memory
              and idle share; (2) context-parallel attention at C = 4
              chunks of yi-6b's attention (4 x 4096, 32 heads over 4,
              D = 128, bf16, causal) on one card against
              blocked_causal_attention, forward and dq/dk/dv, both
              forwards timed; (3) compress_codes of configuration 9's 39
              first-step gradient leaves, card vs CPU bit for bit (and
              with C33's scalar divisor, counted), compress_psum through
              the group, wire_bytes; (4) launch.train --arch yi-6b
              --smoke for 3 steps under torchrun --nproc-per-node 1 and
              as one process, the same params_md5; (5) the per-rank
              bytes of yi-6b's whole train state at (data 4), (data 8)
              and (data 2, model 4), arithmetic
  17. model_parallel  every family's training blocks over `model`, on an
              NCCL group of one rank, mesh (data 1, model 1) (each block
              runs its collectives over the one-rank `model` group): (a)
              against the one-card block on the same bf16 inputs and
              leaves, forward and backward, max|d| of the output and of
              every gradient within 2e-2 of the one-card's largest
              |value|, bit-identity, and both blocks' device ms (a
              profiler trace of 2 calls, of 1 for the sLSTM's host-bound
              loop): phi3.5-moe's expert-split MoE
              FFN (16 experts of 4,096 x 6,400, top-2, group 512, 4 x
              4,096 tokens; the dropped (token, slot) pairs equal),
              zamba2's Mamba2 layer (80 heads) and shared block (32 heads
              of 80) at 4 x 4,096, xlstm-125m's mLSTM and sLSTM blocks
              at 16 x 1,024, whisper-small's encoder layer (8 x 1,500)
              and decoder layer (8 x 416, cross-attention over 1,500
              frames); no kernel launched; (b) configuration 20:
              configuration 11 through make_train_step(..., mesh), the
              MoE routing gathered and counted over the mesh's ranks,
              against phase 14's one-card run: losses, aux and final
              params bit for bit; both runs' step ms, tokens/s, model
              TFLOP/s, peak memory and idle share
  18. serve_mesh  dense serving over a mesh, run right after phase 11 on
              its model, on an NCCL group of one rank, mesh (data 1,
              model 1) (every collective of the path over the one-rank
              groups): (c) flash_attention at one rank's share of yi-6b's
              heads at (model 4), q (8, 4096, 8, 128) against k, v (8,
              4096, 1, 128) from layer 0 of phase 11's prefill, causal,
              held to its plain version a batch element at a time, 3
              calls bit-identical, timed beside its bound, the plain
              version and SDPA; (a) configuration 3 through
              greedy_decode(..., mesh) on phase 11's weights (copied into
              the mesh's blocks, then the one-card model freed) and
              prompts: the 32 tokens equal phase 11's, flash_attention 32
              launches, all in the prefill, the prefill's and first decode
              step's logits within ATTN_TOL of the one-card path's (and
              whether bit-identical), prefill ms, decode ms a step
              (median of 16), peak memory and a profiled decode window's
              idle share beside phase 11's; (b) phi3.5-moe (8 x 4096),
              mixtral (2 x 8192), zamba2 (8 x 4096, one shared block: the
              kv_heads cache), xlstm-125m (8 x 4096, f32, TF32 off) and
              whisper-small (8 x 1500 frames, prompt 416) at full width
              cut to 2 layers, the mesh path against the one-card path on
              the same weights, 8 greedy steps: tokens equal, each call's
              logits within ATTN_TOL (xlstm 1e-4) of the row's scale, the
              same launches and dropped pairs, both paths' prefill ms and
              decode ms a step; (d) launch.serve --arch mixtral-8x22b
              --smoke (the MoE routing and the window's ring; a smoke
              head dim of 16 is no kernel's, and the window takes none)
              under torchrun --nproc-per-node 1 and as one process, the
              same tokens md5
  19. audit   the wire auditor and the dry run (last): (a) the audit's
              engine checks (`analysis.audit.audit_engine`) for all nine
              strategies at configuration 1's widths (2^27 features,
              K = 64, one batch of 4096 of its corpus) on an NCCL group
              of one rank, mesh (data 1, model 1): no finding, the
              kernels of each recorded train_step counted by name
              (AUDIT_LAUNCHES), a twin state that took the same steps
              without the recorder bit-identical to the recorded one,
              host µs of a collective with and without the recorder;
              (b) the analytic audit (nine strategies x 1dev, pod8,
              multipod, production on the `fake` backend of this
              machine's torch): no finding, its seconds; (c)
              configuration 19's dry run (`launch.dryrun.dry_step`, fake
              tensors at (data 1, model 1)) against the same step on the
              card: argument bytes equal to the state and batch the card
              holds, the collective schedule (op, count, bytes) equal to
              what the recorder sees around the card's NCCL step, the
              dry run's peak over the card's max_memory_allocated
              printed; then a prefill cell (yi-6b at 4 layers, 2 x
              32768, its attention the flash_attention kernel's
              footprint) against `mesh_prefill` on the card: argument
              bytes and collective schedule equal, the kernel launched
              once a layer, the peak ratio within AUDIT_PEAK_BAND; (d)
              the strategies' wire table of `launch.dryrun --strategies`
Then one `{"kernels": [...]}` line, and last the device line
`{"ok": true, "device": {...}}`. Measurements also go to
results/chip_smoke.json.
"""
import itertools
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM data sheet's rates, kept in the port's configs
from repro_torch.configs.base import (  # noqa: E402
    H100_BF16_TC_FLOPS as BF16_TC_FLOPS,
    H100_F32_FLOPS as F32_FLOPS,
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
)

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
    fraction in every trace). If the kept trace saw a fractional number
    of launches of the named kernels a call, their time is scaled to the
    nearest whole number of launches (one trace late in a run on the
    H100 saw 13 of 20). If no trace saw the kernels, the device ms is
    `events_ms`, and the log says so."""
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
    named = sum(c for k, c in got.items() if names
                and any(n in k for n in names))
    if 0 < named and round(named) != named:
        # the last trace still lost launches of the named kernels: their
        # time over the launches it saw, times the launches a call makes
        whole = max(round(named), 1)
        log(f"[timing] {names}: the trace saw {named} launches a call; "
            f"device ms scaled by {whole} / {named}")
        ms *= whole / named
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
        m = re.search(r"ILi(\d+)EE", name)
        d = int(m.group(1)) if m else None
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
    require(sorted(fa) == ["D=128", "D=64", "D=80"],
            f"no flash_attention_kernel<64>/<80>/<128> in the ptxas report: "
            f"{res}")
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


def _row_update_entry(torch, dev, path_req, results):
    """row_update as the row path calls it: the run totals of one owner's
    (1, cap) received buffer at the path's shape (`sorted_run_totals`)
    into a 2^LOG2_F-row table and accumulator, adagrad (eps 1e-6) and sgd,
    lr a 0-d tensor on the card and a float. Each against its plain
    version (`ref.row_update_ref`, eager on the card, whose rsqrt is the
    kernel's) on copies of the same state, bit for bit; timed against its
    byte bound."""
    from repro_torch.kernels import ops, ref

    rows = 1 << LOG2_F
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    g = torch.randn(path_req.shape, generator=gen, device=dev) / BATCH
    ids_s, totals, end = ops.sorted_run_totals(path_req, g)
    theta0 = torch.randn(rows, generator=gen, device=dev) * 0.05
    acc0 = torch.rand(rows, generator=gen, device=dev)
    touched = int(end.sum())
    same = {}
    for kind in ("adagrad", "sgd"):
        for lr in (torch.full((), 2.0, device=dev), 2.0):
            got = (theta0.clone(), acc0.clone())
            want = (theta0.clone(), acc0.clone())
            ops.reset_launch_counts()
            ops.row_update(kind, *got, ids_s, totals, 0, lr, 1e-6)
            launched = ops.launch_counts()["row_update"]
            ref.row_update_ref(kind, *want, ids_s, totals, 0, lr, 1e-6)
            tag = f"{kind}, lr {type(lr).__name__}"
            same[tag] = all(_same_bits(torch, a, b)
                            for a, b in zip(got, want)) and launched == 1
            changed = int((got[0] != theta0).sum())
            log(f"[kernels] row_update {tag}: {ids_s.numel()} slots, "
                f"{touched} rows touched, {changed} changed; bit-identical "
                f"to the plain version={same[tag]} ({launched} launch)")
            require(same[tag], f"row_update ({tag}) disagrees with its "
                    "plain version")
            del got, want
    # bound: each slot's id (its neighbour's shares the sector) and total
    # (12 B); a touched row's theta and acc read and written, each a
    # scattered 32 B sector (128 B)
    bms, by = bound(12 * ids_s.numel() + 128 * touched, 7 * touched)
    entry = results["row_update"] = {
        "name": "row_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_update.cu",
        "replaces": "none: the reference's dense _sparse_adagrad / "
                    "_sparse_sgd (src/repro/optim/optimizers.py)",
        "launches": None, "max_abs_err": 0.0, "bit_identical": same,
        "touched_rows": touched, "bound_ms": bms, "bound_by": by,
        "library_ms": None}
    theta, acc = theta0.clone(), acc0.clone()
    lr = torch.full((), 2.0, device=dev)
    _timed(torch, entry,
           lambda: ops.row_update("adagrad", theta, acc, ids_s, totals, 0,
                                  lr, 1e-6), ("row_update",),
           lambda: ref.row_update_ref("adagrad", theta, acc, ids_s, totals,
                                      0, lr, 1e-6))
    _one_launch(torch, "row_update", entry, 1)
    del theta, acc, theta0, acc0
    torch.cuda.empty_cache()


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
    _row_update_entry(torch, dev, routing.req_ids, results)

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
    kernels = ("sigmoid_grad", "segment_sum_sorted", "row_update")

    a2a, eng = run_engine(torch, full_width_config("a2a"), dev_train, test,
                          hot)
    del eng
    counts, fit_counts = a2a["launches"], a2a["fit_launches"]
    # one sigmoid_grad a step; segment_sum_sorted under combine_grads,
    # hot_grads and the row reduce's sorted_run_totals; one row_update a
    # step (the table's update on the row path); fit keeps the dense
    # gradient and update
    require(counts["sigmoid_grad"] == STEPS
            and counts["segment_sum_sorted"] == 3 * STEPS
            and counts["row_update"] == STEPS
            and counts["select_pack"] == 0,
            f"a2a launches {counts} in {STEPS} steps")
    require(fit_counts["sigmoid_grad"] == 2
            and fit_counts["segment_sum_sorted"] == 6
            and fit_counts["row_update"] == 0,
            f"fit did not launch the kernels: {fit_counts}")
    for name in kernels:
        results[name]["launches"] = counts[name]
    torch.cuda.empty_cache()

    topk, eng = run_engine(torch, full_width_config("topk_reduce"), dev_train,
                           test, hot)
    counts, fit_counts = topk["launches"], topk["fit_launches"]
    banked = int((eng.state.strat != 0).sum())
    log(f"[engine topk_reduce] features with a banked residual after "
        f"{STEPS} steps: {banked}")
    require(counts["select_pack"] >= STEPS and counts["sigmoid_grad"] == STEPS
            and counts["row_update"] == 0,
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


DP_RESUME = 10                 # steps before and after the resume's save
DP_DISK = 4 << 30              # free bytes the phase needs (keep=2 at 2^27)


class _ListSource:
    """A `DataSource` over batches already made (what `write_file_corpus`
    is given): `batch(i)` is the i-th of them."""

    name = "zipf_sparse"

    def __init__(self, batches):
        self.batches = batches
        self.batch_size = len(batches[0]["labels"])
        self.num_batches = len(batches)

    def batch(self, index):
        return self.batches[index]


def _stamped(batches, stamps):
    """Yield `batches`, noting the time just before each hand-over and
    just after fit_sgd asks for the next (its step has ended: it read the
    metrics back), and once after the last: `_split` turns the stamps
    into each step's time fetching its batch and time training on it."""
    stamps.append(time.perf_counter())
    for b in batches:
        stamps.append(time.perf_counter())
        yield b
        stamps.append(time.perf_counter())


def _split(stamps):
    """(fetch seconds, train seconds) a step from `_stamped`'s stamps."""
    fetch = [stamps[i + 1] - stamps[i] for i in range(0, len(stamps) - 1, 2)]
    train = [stamps[i + 1] - stamps[i] for i in range(1, len(stamps) - 1, 2)]
    return fetch, train


class _Window:
    """`n` steps of one continuing loader iterator each time it is
    iterated (for `profile_steps`, which runs its window three times):
    the prefetch thread runs on across the windows."""

    def __init__(self, loader, n, windows=3):
        self.it, self.n = iter(loader.batches(n * windows)), n

    def __len__(self):
        return self.n

    def __iter__(self):
        return itertools.islice(self.it, self.n)


def _fed_steps(torch, eng, batches, n):
    """fit_sgd over `batches` with the launch counters set to 0 just
    before and read just after: (step seconds, total seconds, counts,
    fetch seconds, train seconds); a step is its fetch and its train."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stamps = []
    hist = eng.fit_sgd(_stamped(batches, stamps))
    counts = ops.launch_counts()
    require(len(hist) == n, f"{len(hist)} steps, not {n}")
    fetch, train = _split(stamps)
    steps = [f + t for f, t in zip(fetch, train)]
    return steps, stamps[-1] - stamps[0], counts, fetch, train


def _feeds_loader(dev, source, prefetch):
    loader = _loader(dev, source, prefetch)
    return loader.batches(STEPS), loader


def _loader(dev, source, prefetch=2):
    from repro_torch.data import ShardedLoader

    return ShardedLoader(source, device=dev, host_index=0, num_hosts=1,
                         prefetch=prefetch)


def _placement_cost(torch, dev, src, train, n=8):
    """Host wall ms a batch, each call followed by a synchronize: reading
    one from the file corpus, placing a host batch on the card as the
    loader does (`put_batch`: pinned staging, a non_blocking copy), and,
    for comparison, a plain pageable copy of its leaves; then the host
    operations `put_batch` runs (CUDA runtime calls included), from a
    trace, by self time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import put_batch

    def wall(fn):
        ts = []
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts) * 1e3

    out = {"read_ms": wall(lambda i: src.batch(i)),
           "put_batch_ms": wall(lambda i: put_batch(train[i], dev)),
           "pageable_ms": wall(lambda i: {k: torch.as_tensor(v).to(dev)
                                          for k, v in train[i].items()})}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            put_batch(train[i], dev)
        torch.cuda.synchronize()
    top = sorted(((e.key, e.self_cpu_time_total / n / 1e3, e.count / n)
                  for e in prof.key_averages()), key=lambda r: -r[1])[:10]
    out["put_batch_host_ops"] = top
    log(f"[dataplane placement] a batch, host wall with a synchronize: "
        f"read from the file corpus {out['read_ms']:.3f} ms, put_batch "
        f"{out['put_batch_ms']:.3f} ms, a pageable copy "
        f"{out['pageable_ms']:.3f} ms; put_batch's host operations by "
        "self time a call: " + "; ".join(
            f"{k} {ms:.3f} ms x{c:g}" for k, ms, c in top))
    return out


def _tree_bytes(path):
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def _ckpt_cost(torch, eng, directory):
    """Times of save (blocking, first with the pinned buffers' allocation
    and again), of save(block=False)'s return and of the wait, the device
    time the snapshot puts on the stream (profiler), and of restore."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for key in ("save_block_first_s", "save_block_s"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = eng.save(directory, keep=2, block=True)
        out[key] = time.perf_counter() - t
    out["bytes_written"] = _tree_bytes(pathlib.Path(directory)
                                       / f"step_{step:010d}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.save(directory, keep=2, block=False)
    out["save_async_return_s"] = time.perf_counter() - t
    out["stream_busy_at_return"] = not torch.cuda.current_stream().query()
    t = time.perf_counter()
    eng.wait_saves()
    out["wait_s"] = time.perf_counter() - t
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.save(directory, keep=2, block=False)
        torch.cuda.synchronize()
    copies = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            copies[evt.key] = copies.get(evt.key, 0.0) + us / 1e3
    eng.wait_saves()
    out["snapshot_device_ms"] = sum(copies.values())
    out["snapshot_ops"] = copies
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.restore(directory)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t
    return out


def _resume(torch, dev, dist, hot, corpus, directory):
    """Engine A: DP_RESUME loader-fed steps, save(block=False), and at
    once DP_RESUME more; engine B: a new engine and loader restore A's
    checkpoint and train DP_RESUME steps. B must end with A's bits, and
    the file with A's table before its step DP_RESUME + 1."""
    from repro_torch import DPMREngine
    from repro_torch.data import get_source
    from repro_torch.kernels import ops

    cfg = full_width_config(dist)
    src = get_source("file_sparse", directory=corpus)
    a, la = DPMREngine(cfg, hot_ids=hot), _loader(dev, src)
    ops.reset_launch_counts()
    a.fit_sgd(la, steps=DP_RESUME)
    before = a.state.cold.clone()
    t = time.perf_counter()
    step = a.save(directory, keep=2, block=False)
    return_s = time.perf_counter() - t
    a.fit_sgd(la, steps=DP_RESUME)           # updates the table in place
    counts = ops.launch_counts()
    a.wait_saves()
    saved = torch.from_numpy(np.load(pathlib.Path(directory)
                                     / f"step_{step:010d}" / "arr_0.npy"))
    file_ok = _same_bits(torch, saved, before.cpu())
    changed = not _same_bits(torch, a.state.cold, before)
    del before
    b, lb = DPMREngine(cfg, hot_ids=hot), _loader(dev, src)
    b.restore(directory, loader=lb)
    cursor = lb.cursor.to_dict()
    b.fit_sgd(lb, steps=DP_RESUME)
    same = {f: _same_bits(torch, getattr(a.state, f), getattr(b.state, f))
            for f in a.state._fields}
    log(f"[dataplane resume {dist}] A: {DP_RESUME} loader-fed steps, "
        f"save(block=False) returned in {return_s * 1e3:.3f} ms, then "
        f"{DP_RESUME} steps at once; the step-{step} file holds A's cold "
        f"before step {step + 1} bit for bit={file_ok} (A's cold changed "
        f"since={changed}); B restored (cursor {cursor}) and trained "
        f"{DP_RESUME}: bit-identical to A {same}; launches in A {counts}")
    require(file_ok and changed, f"{dist}: the async snapshot does not hold "
            "the pre-step bits")
    require(all(same.values()), f"{dist}: the resumed state differs {same}")
    require(cursor == {"epoch": 0, "step": DP_RESUME},
            f"{dist}: restored cursor {cursor}")
    require(counts["sigmoid_grad"] == 2 * DP_RESUME
            and (dist != "topk_reduce"
                 or counts["select_pack"] >= 2 * DP_RESUME),
            f"{dist}: launches {counts}")
    shutil.rmtree(directory)
    return {"bit_identical": same, "file_holds_pre_step_bits": file_ok,
            "save_async_return_ms": return_s * 1e3, "launches": counts}


def _auto_tables(cfg):
    """The autotuner's ranking under the default WireBandwidth at P = 1,
    the p8 phase's P = 8 in one pod, and (pod 2, data 4)."""
    from repro_torch.api import autotune
    from repro_torch.api.strategies import StrategyContext
    from repro_torch.core import dpmr

    out = {}
    for tag, p, pods in (("P=1", 1, 1), ("P=8", 8, 1),
                         ("pod 2 x data 4", 8, 2)):
        ctx = StrategyContext(
            num_shards=p, block_size=dpmr.padded_features(cfg, p) // p,
            capacity=dpmr.capacity(cfg, BATCH, p), outer_shards=pods,
            topk_frac=cfg.topk_frac)
        ranked = autotune.score_strategies(ctx)
        out[tag] = [{"name": r.name, "inner": r.wire.inner,
                     "outer": r.wire.outer, "cost_s": r.cost_s,
                     "lossy": r.lossy} for r in ranked]
        log(f"[dataplane auto] {tag} (cap {ctx.capacity}), "
            f"{autotune.WireBandwidth()} GB/s one way: " + "; ".join(
                f"{r.name} {r.cost_s * 1e6:.3f} us ({r.wire.inner} + "
                f"{r.wire.outer} B{', lossy' if r.lossy else ''})"
                for r in ranked))
    return out


def phase_dataplane(torch, dev, train, hot):
    """The data plane, checkpoints and `auto` at configuration 1's width
    (the module note, phase 5)."""
    import tempfile

    from repro_torch import DPMREngine, obs
    from repro_torch.api import put_batch
    from repro_torch.core import dpmr
    from repro_torch.data import get_source, write_file_corpus

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    log(f"[dataplane] {free / 2 ** 30:.1f} GiB free under {build}")
    require(free >= DP_DISK, f"the phase needs {DP_DISK >> 30} GiB free")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dataplane-", dir=build))
    out = {}
    try:
        corpus = tmp / "corpus"
        t = time.perf_counter()
        write_file_corpus(str(corpus), _ListSource(train))
        out["corpus_write_s"] = time.perf_counter() - t
        out["corpus_bytes"] = _tree_bytes(corpus)
        log(f"[dataplane] file corpus of the {len(train)} training batches "
            f"({len(train) * BATCH} samples): {out['corpus_write_s']:.3f} s, "
            f"{out['corpus_bytes']} bytes on disk")

        cfg = full_width_config("a2a")
        src = get_source("file_sparse", directory=str(corpus))
        dev_train = [put_batch(b, dev) for b in train]
        # resident batches; a file loader with and without prefetch; a
        # prefetching loader over batches in memory; and, without a
        # loader, just before each step: each host batch placed
        # (put_batch), each resident batch cloned on the card, each batch
        # copied from host memory pinned once, and each resident batch
        # after the host has copied a batch's bytes (2 MiB) in its memory
        pinned = [{k: torch.as_tensor(v).pin_memory() for k, v in b.items()}
                  for b in train]
        scratch = [{k: np.empty_like(v) for k, v in b.items()} for b in train]

        def copied_then(i, b):
            for k, v in train[i].items():
                np.copyto(scratch[i][k], v)
            return b

        feeds = {
            "resident": lambda: (dev_train, None),
            "file": lambda: _feeds_loader(dev, src, 2),
            "file_sync": lambda: _feeds_loader(dev, src, 0),
            "memory": lambda: _feeds_loader(dev, _ListSource(train), 2),
            "put_each": lambda: ((put_batch(b, dev) for b in train), None),
            "clone_each": lambda: ((type(b)({k: v.clone() for k, v in
                                             b.items()}, b.global_size)
                                    for b in dev_train), None),
            "pinned_each": lambda: ((put_batch({k: v.to(dev, non_blocking=True)
                                                for k, v in b.items()}, dev)
                                     for b in pinned), None),
            "memcpy_each": lambda: ((copied_then(i, b)
                                     for i, b in enumerate(dev_train)), None)}
        runs = {k: [] for k in feeds}
        ref = None
        # in turns, each way of feeding twice: A B C ... C B A
        for kind in [*feeds, *reversed(feeds)]:
            eng = DPMREngine(cfg, hot_ids=hot)
            batches, loader = feeds[kind]()
            obs.reset_counts("loader.")
            steps, total, counts, fetch, train_s = _fed_steps(
                torch, eng, batches, STEPS)
            waited = obs.counts("loader.")
            if ref is None:
                ref = eng
            same = {f: _same_bits(torch, getattr(ref.state, f),
                                  getattr(eng.state, f))
                    for f in ref.state._fields}
            runs[kind].append({
                "step_ms_median": statistics.median(steps) * 1e3,
                "fetch_ms_median": statistics.median(fetch) * 1e3,
                "train_ms_median": statistics.median(train_s) * 1e3,
                "samples_per_s": STEPS * BATCH / total,
                "wait_ms_mean": waited["loader.wait_s"]
                / waited["loader.batches"] * 1e3
                if waited.get("loader.batches") else None,
                "launches": counts, "bit_identical": same})
            log(f"[dataplane] a2a {STEPS} steps fed {kind}: "
                + json.dumps(runs[kind][-1]))
            require(all(same.values()),
                    f"the state fed {kind} differs from resident: {same}")
            require(counts["sigmoid_grad"] == STEPS
                    and counts["segment_sum_sorted"] == 3 * STEPS,
                    f"a2a fed {kind} launched {counts} in {STEPS} steps")
            if eng is not ref:
                del eng
        del pinned, scratch
        out["feeds"] = runs
        out["resident_profile"] = profile_steps(
            torch, ref, dev_train[:8], "dataplane resident a2a")
        del ref, dev_train
        torch.cuda.empty_cache()
        fed = DPMREngine(cfg, hot_ids=hot)
        loader = _loader(dev, src)
        fed.fit_sgd(loader, steps=STEPS)
        out["loader_profile"] = profile_steps(
            torch, fed, _Window(loader, 8), "dataplane loader a2a")
        out["read_stats"] = src.read_stats
        more = host_ops_diff(out["loader_profile"]["host_ops"],
                             out["resident_profile"]["host_ops"])
        slower = sorted(
            ((k, d["ms"] - out["resident_profile"]["host_ops"].get(
                k, {"ms": 0.0})["ms"]) for k, d in
             out["loader_profile"]["host_ops"].items()),
            key=lambda kv: -kv[1])[:8]
        log(f"[dataplane] host operations the loader-fed step runs beyond "
            f"the resident one, a step: {json.dumps(more)}; the most host "
            "time added, by name: " + "; ".join(
                f"{k} {ms:+.3f} ms" for k, ms in slower))
        for kind, rs in runs.items():
            log(f"[dataplane] fed {kind}: step medians "
                f"{[round(r['step_ms_median'], 3) for r in rs]} ms (fetch "
                f"{[round(r['fetch_ms_median'], 3) for r in rs]}, train "
                f"{[round(r['train_ms_median'], 3) for r in rs]}), "
                f"samples/s {[round(r['samples_per_s']) for r in rs]}"
                + ("" if rs[0]["wait_ms_mean"] is None else
                   f", the consumer's wait a batch mean "
                   f"{[round(r['wait_ms_mean'], 3) for r in rs]} ms"))

        out["placement"] = _placement_cost(torch, dev, src, train)

        synth = get_source("zipf_sparse", batch_size=BATCH, num_batches=64,
                           start=2000, num_features=1 << LOG2_F,
                           features_per_sample=K, signal_features=4096)
        t = time.perf_counter()
        synth.batch(0)
        synth_s = time.perf_counter() - t
        zl = _loader(dev, synth)
        obs.reset_counts("loader.")
        z_steps, z_total, _, _, _ = _fed_steps(torch, fed, zl.batches(4), 4)
        waited = obs.counts("loader.")
        out["synthesising"] = {
            "step_ms_median": statistics.median(z_steps) * 1e3,
            "samples_per_s": 4 * BATCH / z_total,
            "host_synthesis_ms_a_batch": synth_s * 1e3,
            "wait_ms_mean": waited["loader.wait_s"]
            / waited["loader.batches"] * 1e3}
        log(f"[dataplane] a2a 4 steps fed by ShardedLoader(zipf_sparse, "
            f"prefetch=2), synthesising on the fly: step median "
            f"{out['synthesising']['step_ms_median']:.3f} ms; the host "
            f"makes a batch in {synth_s * 1e3:.1f} ms")

        out["checkpoint"] = ckpt = _ckpt_cost(torch, fed, str(tmp / "ck"))
        log(f"[dataplane checkpoint] 2^{LOG2_F} a2a state, "
            f"{ckpt['bytes_written']} bytes: save(block=True) "
            f"{ckpt['save_block_first_s']:.3f} s the first time (pinned "
            f"buffers allocated), {ckpt['save_block_s']:.3f} s again; "
            f"save(block=False) returns in "
            f"{ckpt['save_async_return_s'] * 1e3:.3f} ms (stream still busy "
            f"then={ckpt['stream_busy_at_return']}), wait() "
            f"{ckpt['wait_s']:.3f} s; the snapshot's device time "
            f"{ckpt['snapshot_device_ms']:.3f} ms "
            f"({json.dumps(ckpt['snapshot_ops'])}); restore "
            f"{ckpt['restore_s']:.3f} s")
        require(ckpt["bytes_written"] > 2 * 4 * (1 << LOG2_F),
                "the checkpoint lacks the tables")
        del fed, loader, zl
        shutil.rmtree(tmp / "ck")
        torch.cuda.empty_cache()

        out["resume"] = {}
        for dist in ("a2a", "topk_reduce"):
            out["resume"][dist] = _resume(torch, dev, dist, hot,
                                          str(corpus), str(tmp / dist))
            torch.cuda.empty_cache()

        auto_cfg = full_width_config("auto")
        card = DPMREngine(auto_cfg, hot_ids=hot).step_fns(BATCH).strategy
        cpu = DPMREngine(auto_cfg, device="cpu").step_fns(BATCH).strategy
        log(f"[dataplane auto] distribution='auto' at 2^{LOG2_F}, P = 1: "
            f"{card} on the card, {cpu} on the CPU "
            f"(resolve_distribution: {dpmr.resolve_distribution(auto_cfg)})")
        require(card == cpu == dpmr.resolve_distribution(auto_cfg),
                "auto resolves differently on the card")
        out["auto"] = {"card": card, "cpu": cpu,
                       "ranked": _auto_tables(auto_cfg)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


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


SERVE_BUCKETS = (64, 256, 1024, 4096)
SERVE_CLIENTS = 8
SERVE_HEAD_REQUESTS = 256


def serve_requests(test, seed=SEED):
    """Traffic A: the held-out rows in order, cut into requests of 1 to 64
    rows (uniform, numpy `seed`): a ranking service scoring a page's
    candidates."""
    ids = np.concatenate([b["ids"] for b in test])
    vals = np.concatenate([b["vals"] for b in test])
    rng = np.random.default_rng(seed)
    reqs, lo = [], 0
    while lo < len(ids):
        n = int(rng.integers(1, 65))
        reqs.append((ids[lo:lo + n], vals[lo:lo + n]))
        lo += n
    return reqs


def head_requests(hot_ids, seed=SEED):
    """Traffic B: requests of 1 to 4 rows whose ids are drawn from the
    mirror's head set (1 to K a row, the rest -1 padding)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(SERVE_HEAD_REQUESTS):
        rows = int(rng.integers(1, 5))
        ids = np.full((rows, K), -1, np.int32)
        vals = np.zeros((rows, K), np.float32)
        for r in range(rows):
            nnz = int(rng.integers(1, K + 1))
            ids[r, :nnz] = rng.choice(hot_ids, size=nnz)
            vals[r, :nnz] = rng.normal(size=nnz)
        reqs.append((ids, vals))
    return reqs


def serve_traffic(srv, reqs):
    """Submit `reqs` from SERVE_CLIENTS threads (contiguous slices, all at
    once), wait for every answer, stop the server (a drain). Returns the
    answers in request order, the wall seconds to the last answer, and
    the rows the hot cache answered."""
    import threading

    results = [None] * len(reqs)
    hit_rows, lock = [], threading.Lock()
    if srv.cache is not None:
        lookup = srv.cache.lookup

        def counted(ids, vals):
            probs = lookup(ids, vals)
            if probs is not None:
                with lock:
                    hit_rows.append(len(ids))
            return probs

        srv.cache.lookup = counted

    def client(lo, hi):
        for i in range(lo, hi):
            results[i] = srv.submit(*reqs[i])

    per = -(-len(reqs) // SERVE_CLIENTS)
    threads = [threading.Thread(target=client,
                                args=(c * per, min(len(reqs), (c + 1) * per)))
               for c in range(SERVE_CLIENTS)]
    srv.metrics.reset_clock()
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    require(not any(th.is_alive() for th in threads), "a client hung")
    got = [np.asarray(f.result(timeout=600)) for f in results]
    wall = time.perf_counter() - t
    srv.stop()
    return got, wall, sum(hit_rows)


def _check_served(tag, eng, srv, reqs, got, hit_rows):
    """Every answer bit-identical to predict_padded of its request alone,
    and the counters adding up; returns the serving's numbers."""
    same = all(np.array_equal(g, eng.predict_padded({"ids": i, "vals": v}))
               for (i, v), g in zip(reqs, got))
    m = srv.metrics_snapshot()
    rows = sum(len(r[0]) for r in reqs)
    flushes = m.get("flushes", 0)
    by_reason = {r: m.get(f"flush_{r}", 0)
                 for r in ("full", "deadline", "drain")}
    hits, misses = m.get("cache_hits", 0), m.get("cache_misses", 0)
    log(f"[sparse_serve {tag}] {len(reqs)} requests, {rows} rows: every "
        f"answer bit-identical to predict_padded alone={same}; flushes "
        f"{flushes} {by_reason}, {sum(srv.metrics._flush_rows)} rows "
        f"flushed + {hit_rows} answered by the cache; hits {hits}, misses "
        f"{misses}, refreshes {m.get('cache_refreshes', 0)} (stale "
        f"{m.get('cache_stale_refreshes', 0)}); step fns "
        f"{m['compiled_step_fns']}")
    require(same, f"{tag}: a served answer differs from predict_padded")
    require(m["requests"] == len(reqs) and m["samples"] == rows,
            f"{tag}: requests/samples {m['requests']}/{m['samples']}")
    require(sum(by_reason.values()) == flushes
            == len(srv.metrics._flush_rows),
            f"{tag}: flushes by reason {by_reason} against {flushes}")
    require(srv.cache is None or hits + misses == len(reqs),
            f"{tag}: {hits} hits + {misses} misses")
    require(sum(srv.metrics._flush_rows) + hit_rows == rows,
            f"{tag}: rows flushed and answered do not add up to {rows}")
    return m


def _serving_numbers(tag, m, wall, rows):
    out = {k: m.get(k) for k in (
        "latency_p50_ms", "latency_p99_ms", "qps", "batch_mean",
        "padded_mean", "padding_frac", "hot_hit_rate", "flushes",
        "flush_full", "flush_deadline", "flush_drain", "cache_hits",
        "cache_misses", "cache_refreshes", "cache_stale_refreshes",
        "compiled_step_fns")}
    out["wall_s"] = wall
    out["samples_per_s"] = rows / wall
    log(f"[sparse_serve {tag}] wall {wall * 1e3:.3f} ms: latency p50 "
        f"{m.get('latency_p50_ms', float('nan')):.3f} ms, p99 "
        f"{m.get('latency_p99_ms', float('nan')):.3f} ms; "
        f"{m.get('qps', 0):.1f} requests/s, {rows / wall:.0f} samples/s; "
        f"batch_mean {m.get('batch_mean', 0):.2f}, padded_mean "
        f"{m.get('padded_mean', 0):.2f}, padding_frac "
        f"{m.get('padding_frac', 0):.4f}; hot_hit_rate "
        f"{m.get('hot_hit_rate', 0):.4f}")
    return out


def _refresh_costs(torch, dev, cache, cfg):
    """One refresh's ms at 2^27 (the sparse selection from distinct ids and
    the mirror's gather, 5 times), and the dense select_hot(
    feature_counts()) route on the same window, whose ids must equal the
    sparse selection's."""
    from repro_torch.core import dpmr, hot_sharding
    from repro_torch.serve.hot_cache import select_hot_ids

    f = dpmr.padded_features(cfg)
    thr, max_hot = cache.config.threshold, cache.config.max_hot
    refresh_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache.refresh()             # ends in the copies of ids and values
        refresh_ms.append((time.perf_counter() - t) * 1e3)
    flat = np.concatenate(list(cache._window))
    window = torch.from_numpy(flat).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dense_ms = []
    for _ in range(2):
        t = time.perf_counter()
        dense = hot_sharding.select_hot(hot_sharding.feature_counts(window, f),
                                        thr, max_hot)
        torch.cuda.synchronize()
        dense_ms.append((time.perf_counter() - t) * 1e3)
    dense_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    sparse_ms = []
    for _ in range(2):
        t = time.perf_counter()
        sparse = select_hot_ids(window, f, thr, max_hot)
        torch.cuda.synchronize()
        sparse_ms.append((time.perf_counter() - t) * 1e3)
    sparse_peak = torch.cuda.max_memory_allocated() - base
    same = bool(torch.equal(sparse, dense))
    mirrored = int((sparse != hot_sharding.INT_MAX).sum())
    log(f"[sparse_serve refresh] window of {len(cache._window)} requests, "
        f"{flat.size} id slots at 2^{LOG2_F}: refresh (selection + gather "
        f"+ copies) {[round(x, 3) for x in refresh_ms]} ms; selection "
        f"alone from distinct ids {[round(x, 3) for x in sparse_ms]} ms "
        f"(+{sparse_peak / 2 ** 20:.1f} MiB at peak) against the dense "
        f"select_hot(feature_counts()) route {[round(x, 3) for x in dense_ms]}"
        f" ms (+{dense_peak / 2 ** 20:.1f} MiB); {mirrored} ids selected; "
        f"selections equal={same}")
    require(same, "the sparse selection differs from select_hot("
            "feature_counts()) at 2^27")
    return {"refresh_ms": refresh_ms, "select_sparse_ms": sparse_ms,
            "select_dense_ms": dense_ms, "sparse_peak_bytes": sparse_peak,
            "dense_peak_bytes": dense_peak, "window_id_slots": int(flat.size),
            "selected": mirrored}


def _predict_by_bucket(torch, eng, test):
    """predict_padded alone at each bucket, by CUDA events (the call ends
    in the copy of its answers to the host); at 1024 also a profiled
    window; and the row arithmetic against a torch.sum row sum."""
    from repro_torch.core import dpmr

    out = {}
    for b in SERVE_BUCKETS:
        batch = {"ids": test[0]["ids"][:b], "vals": test[0]["vals"][:b]}
        out[f"ms_{b}"] = time_ms(torch, lambda: eng.predict_padded(batch))
        log(f"[sparse_serve predict] bucket {b}: predict_padded "
            f"{out[f'ms_{b}']:.4f} ms a call (median of 50, CUDA events)")
    batch = {"ids": test[0]["ids"][:1024], "vals": test[0]["vals"][:1024]}
    out["profile_1024"] = profile_window(
        torch, lambda: eng.predict_padded(batch), 20,
        "sparse_serve predict_padded 1024")
    gen = torch.Generator(device=eng.device).manual_seed(SEED)
    vals = torch.randn((1024, K), generator=gen, device=eng.device)
    theta = torch.randn((1024, K), generator=gen, device=eng.device)
    tree = kernel_and_call_ms(torch, lambda: dpmr.row_probs(vals, theta), [])
    plain = kernel_and_call_ms(torch, lambda: torch.sigmoid(
        torch.sum(vals * theta, dim=-1)), [])
    out["row_probs"] = {"device_ms": tree[0], "call_ms": tree[1],
                        "sum_device_ms": plain[0], "sum_call_ms": plain[1]}
    log(f"[sparse_serve predict] row arithmetic at (1024, {K}): halving "
        f"tree + f64 sigmoid {tree[0]:.5f} ms device, {tree[1]:.5f} ms a "
        f"call; torch.sum + f32 sigmoid {plain[0]:.5f} ms device, "
        f"{plain[1]:.5f} ms a call")
    return out


def _grouped_serving(torch, dev, cfg, state, reqs, want):
    """The same server through an NCCL group of one rank (a file store):
    the broadcasts of the front, the mirror's gather on the flusher, and
    its answers bit-identical to the serving with no group (`want`)."""
    import torch.distributed as dist

    from repro_torch import DPMREngine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import (BatchingConfig, DPMRServeEngine,
                                   HotCacheConfig)

    store = ROOT / "results" / "nccl_serve_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        eng = DPMREngine(cfg, device=dev, mesh=make_host_mesh(1),
                         state=state)
        srv = DPMRServeEngine(eng, batching=BatchingConfig(),
                              hot_cache=HotCacheConfig(), start=False)
        calls = []
        command = srv._command

        def timed(cmd, *args, **kw):
            t = time.perf_counter()
            out = command(cmd, *args, **kw)
            calls.append((cmd, time.perf_counter() - t))
            return out

        srv._command = timed
        srv.start()
        got, wall, hit_rows = serve_traffic(srv, reqs)
        m = _check_served("nccl", eng, srv, reqs, got, hit_rows)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    us = {name: [t * 1e6 for c, t in calls if c == code]
          for name, code in (("predict", 1), ("mirror", 2), ("stop", 3))}
    log(f"[sparse_serve nccl] group of 1 rank: answers bit-identical to no "
        f"group={same}; wall {wall * 1e3:.3f} ms; host µs of the front's "
        f"broadcasts a flush: median "
        f"{statistics.median(us['predict']):.1f}, mean "
        f"{statistics.mean(us['predict']):.1f} over {len(us['predict'])} "
        f"flushes; a mirror command {[round(x, 1) for x in us['mirror']]}; "
        f"stop {[round(x, 1) for x in us['stop']]}")
    require(same, "the NCCL group's answers differ from no group's")
    require(len(us["predict"]) == m.get("flushes", 0) and len(us["stop"]) == 1,
            "the front did not broadcast once a flush and once at stop")
    return {**_serving_numbers("nccl", m, wall, sum(len(r[0]) for r in reqs)),
            "broadcast_us": us}


def phase_sparse_serve(torch, dev, train, test, hot):
    """Sparse serving at configuration 1's width (the module note, phase 9):
    configuration 8."""
    import tempfile

    from repro_torch import DPMREngine
    from repro_torch.api import put_batch
    from repro_torch.kernels import ops
    from repro_torch.serve import (BatchingConfig, DPMRServeEngine,
                                   HotCacheConfig)

    cfg = full_width_config("a2a")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="serve-", dir=build))
    out = {}
    try:
        eng = DPMREngine(cfg, device=dev, hot_ids=hot)
        eng.fit_sgd([put_batch(b, dev) for b in train])
        t = time.perf_counter()
        eng.save(str(tmp), block=True)
        out["save_s"] = time.perf_counter() - t
        del eng
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv = DPMRServeEngine.from_checkpoint(cfg, str(tmp), device=dev,
                                              start=False)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t
        eng = srv.engine
        out["checkpoint_bytes"] = _tree_bytes(tmp)
        log(f"[sparse_serve] a2a trained {STEPS} steps at 2^{LOG2_F}, saved "
            f"in {out['save_s']:.3f} s ({out['checkpoint_bytes']} bytes), "
            f"restored into serving in {out['restore_s']:.3f} s at step "
            f"{eng.host_step()}")
        require(eng.host_step() == STEPS, "restored at the wrong step")
        for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
            eng.predict_padded({k: test[0][k][:b] for k in ("ids", "vals")})
        reqs = serve_requests(test)
        rows = sum(len(r[0]) for r in reqs)
        log(f"[sparse_serve] traffic A: {len(reqs)} requests of 1-64 rows "
            f"({rows} rows) from {SERVE_CLIENTS} client threads")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        answers = None
        for tag, max_batch in (("A64", 64), ("A1024", 1024)):
            s = DPMRServeEngine(eng, batching=BatchingConfig(
                max_batch=max_batch, max_wait_ms=2.0),
                hot_cache=HotCacheConfig())
            ops.reset_launch_counts()
            got, wall, hit_rows = serve_traffic(s, reqs)
            counts = ops.launch_counts()
            m = _check_served(tag, eng, s, reqs, got, hit_rows)
            out[tag] = {**_serving_numbers(tag, m, wall, rows),
                        "launches": counts}
            log(f"[sparse_serve {tag}] kernel launches while serving: "
                f"{counts}")
            require(not any(counts.values()), "serving launched a kernel of "
                    "the repo: its forward reaches none")
            if answers is None:
                answers = got
        out["peak_serving_bytes"] = torch.cuda.max_memory_allocated()

        head = DPMRServeEngine(eng, hot_cache=HotCacheConfig(), start=False)
        for ids, _ in reqs:             # traffic A's window (< 512 requests)
            head.cache.observe(ids)
        out["refresh"] = _refresh_costs(torch, dev, head.cache, cfg)
        head.cache.refresh()
        head_ids = head.cache.hot_ids
        require(head_ids.size > 0, "traffic A's window selects no head id")
        hreqs = head_requests(head_ids)
        head.start()
        got, wall, hit_rows = serve_traffic(head, hreqs)
        m = _check_served("B", eng, head, hreqs, got, hit_rows)
        require(m.get("cache_hits", 0) == len(hreqs)
                and m.get("flushes", 0) == 0,
                "a head-only request missed the fresh mirror")
        lat = np.asarray(head.metrics._latencies) * 1e6
        head.cache.refresh()
        alone = []
        for ids, vals in hreqs[:200]:   # fresh for 256 lookups
            t = time.perf_counter()
            hit = head.cache.lookup(ids, vals)
            alone.append((time.perf_counter() - t) * 1e6)
            require(hit is not None, "a head-only lookup missed")
        out["B"] = {**_serving_numbers("B", m, wall,
                                       sum(len(r[0]) for r in hreqs)),
                    "head_ids": int(head_ids.size),
                    "hit_us_p50": float(np.percentile(lat, 50)),
                    "hit_us_alone_p50": statistics.median(alone)}
        log(f"[sparse_serve B] {head_ids.size} head ids; host µs a hit: "
            f"p50 {out['B']['hit_us_p50']:.1f} submitted by "
            f"{SERVE_CLIENTS} threads, {statistics.median(alone):.1f} "
            f"looked up alone (median of 200)")

        drain = DPMRServeEngine(eng, batching=BatchingConfig(
            max_batch=1 << 20, max_wait_ms=3.6e6), hot_cache=None)
        futs = [drain.submit(*r) for r in reqs[:8]]
        drain.stop()
        done = all(f.done() for f in futs)
        same = done and all(np.array_equal(
            f.result(), eng.predict_padded({"ids": i, "vals": v}))
            for f, (i, v) in zip(futs, reqs))
        try:
            drain.submit(*reqs[0])
            refused = False
        except RuntimeError:
            refused = True
        log(f"[sparse_serve drain] stop() answered the 8 queued requests="
            f"{same} ({drain.metrics_snapshot().get('flush_drain', 0)} "
            f"drain flush); submit after stop raises={refused}")
        require(same and refused
                and drain.metrics_snapshot().get("flush_drain", 0) == 1,
                "stop() did not drain, or submit after it did not raise")

        out["predict"] = _predict_by_bucket(torch, eng, test)
        out["grouped"] = _grouped_serving(torch, dev, cfg, eng.state, reqs,
                                          answers)
        log(f"[sparse_serve] peak device memory while serving traffic A "
            f"{out['peak_serving_bytes'] / 2 ** 30:.3f} GiB")
        del srv, eng, head, drain
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
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


def serve_run(torch, dev, spec, cfg, model, batch, prompt, phase="serve",
              label="", want_fa=None, frames=None, profile_prefill=True):
    """greedy_decode of `model`, batch x prompt (numpy seed 0), 32 steps,
    with the launch counters set to 0 just before and read just after
    (flash_attention `want_fa` times a prefill; by default once per layer,
    or never under a sliding window); then prefill and each decode step
    timed alone, a profiled window of decode steps and (unless not
    `profile_prefill`) a profiled prefill (tagged `label`). An
    encoder-decoder's `frames` (numpy, (batch, S_enc, D)) go with every
    prefill."""
    from repro_torch.kernels import ops
    from repro_torch.train import serve

    arch = spec.arch_id
    if want_fa is None:
        want_fa = 0 if cfg.sliding_window else cfg.num_layers
    toks_np = prompts(cfg, batch, prompt)
    host = {"tokens": toks_np}
    if frames is not None:
        host["frames"] = frames
    # warm-up: cuBLAS handles and workspaces, the allocator's pools
    serve.greedy_decode(spec, cfg, model, host, 2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    toks = serve.greedy_decode(spec, cfg, model, host, DECODE_STEPS,
                               device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{phase}] {arch} {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.4f} B params: greedy_decode batch "
        f"{batch} x prompt {prompt}, {DECODE_STEPS} steps in {wall:.4f} s "
        f"({batch * DECODE_STEPS / wall:.2f} generated tok/s); "
        f"max_memory_allocated {peak / 2 ** 30:.3f} GiB ({peak} B); "
        f"launches {counts}")
    require(tuple(toks.shape) == (batch, DECODE_STEPS)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"bad tokens {tuple(toks.shape)}")
    require(counts["flash_attention"] == want_fa
            and sum(counts.values()) == want_fa,
            f"greedy_decode launched {counts}: expected flash_attention "
            f"{want_fa} times (all in the prefill)")

    # the parts alone: prefill, then each decode step
    placed = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    prefill = serve.make_prefill_step(spec, cfg)
    decode = serve.make_decode_step(spec, cfg)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(model, placed)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    pre_counts = ops.launch_counts()
    require(pre_counts["flash_attention"] == want_fa,
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
    log(f"[{phase}] {label}prefill alone {prefill_s * 1e3:.3f} ms "
        f"({batch * prompt / prefill_s:.1f} prompt tok/s), launches "
        f"{pre_counts}; decode step median {step_med:.4f} ms over 16 "
        f"(min {min(step_ms):.4f}, max {max(step_ms):.4f}; "
        f"{batch / step_med * 1e3:.2f} tok/s), launches {dec_counts}")

    def step():
        decode(model, cache, tok)

    # 16 more steps: 8 untraced, 8 traced; a cache without a window keeps
    # 32 slots of headroom, so no step writes past it
    dec_prof = profile_window(torch, step, 8, f"{label}decode step")
    del cache, logits
    torch.cuda.empty_cache()
    pre_prof = profile_window(
        torch, lambda: prefill(model, placed), 1, f"{label}prefill") \
        if profile_prefill else None
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.num_layers,
            "params": cfg.param_count(), "batch": batch, "prompt": prompt,
            "decode_steps": DECODE_STEPS, "greedy_s": wall,
            "generated_tok_per_s": batch * DECODE_STEPS / wall,
            "prefill_ms": prefill_s * 1e3,
            "prompt_tok_per_s": batch * prompt / prefill_s,
            "decode_ms_median": step_med, "decode_ms": step_ms,
            "max_memory_allocated": peak, "launches": counts,
            "decode_profile": dec_prof, "prefill_profile": pre_prof,
            "first_tokens": toks[:2].cpu().tolist(),
            "tokens": toks.cpu().tolist()}


def phase_serve(torch, dev, spec, cfg, model, results):
    """The dense main path: greedy_decode of yi-6b at full width and depth,
    batch 8 x 4096, 32 steps, counted; then its parts timed alone."""
    out = serve_run(torch, dev, spec, cfg, model, SERVE_BATCH, PROMPT)
    results["flash_attention"]["launches"] = \
        out["launches"]["flash_attention"]
    return out


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


# ---------------------------------------------------------------------------
# the dense trainer
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 4096, 10
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# card vs CPU, and microbatches 2 vs 1 (sgd, so the params move by lr g):
# the loss within 2^-8 of its size, bf16's unit roundoff; the grad norm
# within 2^-6; each param leaf within 2^-5 (8 bf16 units) of its largest
# update, plus one f32 ulp of its largest value for the rounding of the
# stored p - lr g. Each side rounds its bf16 activations at the same
# places but sums in its own order.
LOSS_TOL, GNORM_TOL, STEP_TOL = 2.0 ** -8, 2.0 ** -6, 2.0 ** -5
FT_TOL = 1e-5       # restarted vs uninterrupted f32 runs (the CPU tests')


def train_config(num_layers, arch=ARCH, **changes):
    """`arch` (yi-6b) at full width (bf16 activations, the config's
    masters and moments), cut to `num_layers`, with `changes`."""
    import dataclasses

    from repro_torch.models import registry

    spec = registry.get_spec(arch)
    return spec, dataclasses.replace(spec.cfg, num_layers=num_layers,
                                     **changes)


def _train_state(torch, spec, cfg, tc, pc, dev, mesh=None):
    from repro_torch.train import trainer

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return trainer.init_state(spec, cfg, tc, pc, gen, dev, mesh=mesh)


def _lm_batches(cfg, batch, seq, n, dev):
    """`n` lm_markov batches (seed 0) through the training CLI's loader
    (`launch.train.make_loader`: whole batches on `dev`, prefetched)."""
    import argparse

    from repro_torch.launch import train

    args = argparse.Namespace(seq=seq, batch=batch, data_seed=SEED,
                              prefetch=2)
    return train.make_loader(args, cfg, dev).batches(n)


def _step_metrics(m):
    return {k: float(v) for k, v in m.items()}


def _param_gap(torch, state, ref, before):
    """Per leaf: the gap max |p - p_ref| less one f32 ulp of the leaf's
    largest value (the rounding of the stored p - lr g, whatever the
    update), over the reference's largest update max |p_ref - p_before|
    (0 if the gap is within the ulp and the reference's update is 0).
    Returns the worst leaf's ratio and {leaf: (ratio, gap, update)}."""
    worst, rows = 0.0, {}
    ref_p = dict(ref["params"].named_parameters())
    with torch.no_grad():
        for name, p in state["params"].named_parameters():
            r = ref_p[name].detach().float().cpu()
            gap = float((p.detach().float().cpu() - r).abs().max())
            upd = float((r - before[name]).abs().max())
            ulp = float(r.abs().max()) * 2.0 ** -23
            # a leaf whose update rounds away (lr g below an ulp of each
            # of its values) must stay within an ulp
            ratio = max(gap - ulp, 0.0) / upd if upd else \
                (0.0 if gap <= ulp else float("inf"))
            rows[name] = (ratio, gap, upd)
            worst = max(worst, ratio)
    return worst, rows


def _agree(tag, got, want, gap, phase="train_dense"):
    dl = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    dg = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    ok = dl <= LOSS_TOL and dg <= GNORM_TOL and gap <= STEP_TOL
    log(f"[{phase}] {tag}: loss {got['loss']:.6f} vs {want['loss']:.6f} "
        f"(rel {dl:.3e}, tol {LOSS_TOL:.3e}); grad norm "
        f"{got['grad_norm']:.6f} vs {want['grad_norm']:.6f} (rel {dg:.3e}, "
        f"tol {GNORM_TOL:.3e}); params: worst leaf (gap - ulp) / its "
        f"update {gap:.3e} (tol {STEP_TOL:.3e}) ok={ok}")
    require(ok, f"{tag}: the two steps disagree")
    return {"loss_rel": dl, "grad_norm_rel": dg, "param_gap": gap}


def model_flops(cfg, n_flops, batch, seq):
    """A training step's model FLOPs: 6 N tokens (N the parameters, or an
    MoE model's active ones), plus the forward and backward (3x the
    forward) of the products that no parameter counts: the attention
    (4 hd FLOPs a head and visible (query, key) pair: causal self-
    attention in each decoder layer or each invocation of zamba2's shared
    block, whisper's encoder over its frames (as many as tokens) and its
    cross-attention over them) and the chunked scan of the Mamba2 and
    mLSTM blocks (chunks of L = 128: a token's scores and their product
    with V, 2 L (dk + dv), the state's read and update, 4 dk dv, and the
    mLSTM's normaliser, 2 L dk, a head). Returns (total, {term: FLOPs})."""
    tokens = batch * seq
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    causal = batch * seq * (seq + 1) // 2
    terms = {"6N": 6 * n_flops * tokens}
    if cfg.family == "hybrid":
        terms["attention"] = 3 * 4 * hd * h * (
            cfg.num_layers // cfg.attn_every) * causal
        di = cfg.ssm_expand * cfg.d_model
        dk, dv = cfg.ssm_state, 64
        terms["scan"] = 3 * cfg.num_layers * (di // 64) * tokens * (
            2 * 128 * (dk + dv) + 4 * dk * dv)
    elif cfg.family == "ssm":
        n_m = cfg.num_layers - (cfg.num_layers // cfg.slstm_every
                                if cfg.slstm_every else 0)
        dk = 2 * cfg.d_model // h
        terms["scan"] = 3 * n_m * h * tokens * (
            2 * 128 * (2 * dk) + 4 * dk * dk + 2 * 128 * dk)
    elif cfg.family == "encdec":
        terms["attention"] = 3 * 4 * hd * h * (
            cfg.num_layers * (causal + tokens * seq)
            + cfg.encoder_layers * tokens * seq)
    else:
        terms["attention"] = 3 * 4 * hd * h * cfg.num_layers * causal
    return sum(terms.values()), terms


def _train_main(torch, dev, arch=ARCH, num_layers=TRAIN_LAYERS,
                phase="train_dense", batch_rows=TRAIN_BATCH, seq=TRAIN_SEQ,
                require_learning=True, remat="full", mesh=None, pc_kw=None,
                keep=None):
    """(a) configuration 9: 10 adamw steps of yi-6b at 4 x 4096, 4 layers
    (or of `arch` at `num_layers`, batch_rows x seq). The model FLOPs are
    `model_flops`'. Unless not `require_learning`, the first batch's
    cross-entropy after the 10 steps must be below step 1's. With a
    `mesh`, the mesh trainer (`ParallelConfig` fields `pc_kw` added);
    `keep(state)` sees the state after the run, before it is freed."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.models import common
    from repro_torch.models.parallel import ShardedView
    from repro_torch.train import trainer

    spec, cfg = train_config(num_layers, arch)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, optimizer="adamw")
    pc = ParallelConfig(remat=remat, **(pc_kw or {}))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = _train_state(torch, spec, cfg, tc, pc, dev, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in state["params"].parameters())
    state_bytes = torch.cuda.memory_allocated()
    step = trainer.make_train_step(spec, cfg, tc, pc, mesh)
    tokens = batch_rows * seq
    losses, step_ms, metrics = [], [], []
    ops.reset_launch_counts()
    batch = None
    for batch in _lm_batches(cfg, batch_rows, seq, TRAIN_STEPS, dev):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        metrics.append(_step_metrics(m))
        losses.append(metrics[-1]["loss"])
        if len(losses) == 1:
            first = {k: v.clone() for k, v in batch.items()}
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(len(losses) == TRAIN_STEPS, f"{len(losses)} steps ran")
    require(all(np.isfinite(x) for x in losses), f"losses {losses}")
    # step 1 (lr 0 under warmup) measured the first batch's cross-entropy
    # at the initial params; the trained params must lower it
    model = state["params"]
    if mesh is not None:
        model = ShardedView(model, model.layout)
    with torch.no_grad():
        logits, _ = spec.forward(model, first, cfg, pc)
        after = float(common.cross_entropy(logits, first["labels"]))
    del logits
    log(f"[{phase}] the first batch's cross-entropy {metrics[0]['nll']:.6f} "
        f"at step 1, {after:.6f} after step {TRAIN_STEPS}")
    require(sum(counts.values()) == 0,
            f"training launched {counts}: its path reaches none of the "
            "four kernels")
    med = statistics.median(step_ms[2:])
    n_flops = cfg.active_param_count() if cfg.num_experts else n_params
    flops, terms = model_flops(cfg, n_flops, batch_rows, seq)
    tflops = flops / (med / 1e3) / 1e12
    log(f"[{phase}] {arch} at full width cut to {cfg.num_layers} layers: "
        f"{n_params} params, {n_flops} of them counted in the model FLOPs "
        f"({state_bytes / 2 ** 30:.3f} GiB of state after "
        f"init, {init_s:.2f} s); batch {batch_rows} x {seq}, adamw lr "
        f"{TRAIN_LR} warmup {TRAIN_WARMUP}, remat {remat}")
    log(f"[{phase}] step ms {[round(x, 3) for x in step_ms]}; median of "
        f"steps 3-{TRAIN_STEPS} {med:.3f} ms, {tokens / med * 1e3:.1f} "
        f"tokens/s; model FLOPs a step {flops:.4e} "
        f"({', '.join(f'{k} {v:.4e}' for k, v in terms.items())}) = "
        f"{tflops:.2f} TFLOP/s, {tflops / (BF16_TC_FLOPS / 1e12):.4f} of "
        f"the bf16 dense peak {BF16_TC_FLOPS / 1e12:g} TFLOP/s (NVIDIA H100 "
        f"SXM data sheet); "
        f"max_memory_allocated {peak / 2 ** 30:.3f} GiB ({peak} B)")
    log(f"[{phase}] losses {[round(x, 5) for x in losses]}; aux "
        f"{[round(m['aux'], 5) for m in metrics]}; lr "
        f"{[m['lr'] for m in metrics]}; grad norm "
        f"{[round(m['grad_norm'], 4) for m in metrics]}; launches {counts}")
    require(after < metrics[0]["nll"] or not require_learning,
            f"{TRAIN_STEPS} steps did not lower the first batch's "
            f"cross-entropy: {after} against {metrics[0]['nll']}")

    def one_step():
        step(state, batch)

    prof = profile_window(torch, one_step, 1 if med > 5e3 else 2,
                          f"{phase} train step")
    out = {"arch": arch, "layers": cfg.num_layers, "params": n_params,
           "flops_params": n_flops,
           "batch": batch_rows, "seq": seq, "remat": remat,
           "init_s": init_s,
           "state_bytes": state_bytes, "step_ms": step_ms,
           "step_ms_median": med, "tokens_per_s": tokens / med * 1e3,
           "model_flops": flops, "model_flops_terms": terms,
           "model_tflops": tflops,
           "peak_share": tflops / (BF16_TC_FLOPS / 1e12),
           "max_memory_allocated": peak,
           "losses": losses, "metrics": metrics, "launches": counts,
           "profile": prof}
    if keep is not None:
        keep(state)
    del state, batch, first, model
    torch.cuda.empty_cache()
    return out


def _one_step(torch, state, batch, spec, cfg, tc, pc):
    from repro_torch.train import trainer

    state, m = trainer.make_train_step(spec, cfg, tc, pc)(state, batch)
    return state, _step_metrics(m)


def _train_vs_cpu(torch, dev, arch=ARCH, phase="train_dense", num_layers=1,
                  **changes):
    """(b) one sgd step at full width, 1 layer (or `num_layers`), 1 x 256,
    on the card and on the CPU from the same params carried by `convert`
    (of `arch`, its config with `changes`)."""
    from repro_torch import convert
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.train import trainer

    spec, cfg = train_config(num_layers, arch, **changes)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0, optimizer="sgd")
    pc = ParallelConfig()
    cpu = trainer.init_state(spec, cfg, tc, pc,
                             torch.Generator().manual_seed(SEED), "cpu")
    card = convert.train_state_from_numpy(convert.train_state_to_numpy(cpu),
                                          cfg, dev)
    before = {n: p.detach().clone()
              for n, p in cpu["params"].named_parameters()}
    batch = list(_lm_batches(cfg, 1, 256, 1, "cpu"))[0]
    t = time.perf_counter()
    cpu, want = _one_step(torch, cpu, batch, spec, cfg, tc, pc)
    cpu_s = time.perf_counter() - t
    card, got = _one_step(torch, card, {k: v.to(dev) for k, v in
                                        batch.items()}, spec, cfg, tc, pc)
    gap, rows = _param_gap(torch, card, cpu, before)
    worst = sorted(rows.items(), key=lambda kv: -kv[1][0])[:4]
    log(f"[{phase}] card vs CPU ({arch}, {num_layers} layers, 1 x 256, "
        f"{cfg.dtype} activations; the CPU step {cpu_s:.1f} s); worst "
        f"leaves (gap less an ulp over the update, gap, update): {worst}")
    out = _agree("card vs CPU, one sgd step", got, want, gap, phase)
    del card, cpu
    torch.cuda.empty_cache()
    return out


def _train_variants(torch, dev):
    """(c) at 1 layer and configuration 9's batch: the first adamw step
    under remat full, dots and none (bit for bit), and microbatches 2
    against 1 (sgd, within the tolerances of (b))."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig

    spec, cfg = train_config(1)
    batch = list(_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev))[0]
    out = {"remat": {}}
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     optimizer="adamw")
    ref = None
    for remat in ("full", "dots", "none"):
        pc = ParallelConfig(remat=remat)
        state = _train_state(torch, spec, cfg, tc, pc, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, m = _one_step(torch, state, batch, spec, cfg, tc, pc)
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated()
        params = {n: p.detach().clone()
                  for n, p in state["params"].named_parameters()}
        same = ref is None or (m == ref[0] and all(
            torch.equal(params[n], ref[1][n]) for n in params))
        log(f"[train_dense] remat {remat}: first step loss {m['loss']:.6f} "
            f"grad norm {m['grad_norm']:.6f}, {ms:.1f} ms (one step, "
            f"including its first use of the shapes), max_memory_allocated "
            f"{peak / 2 ** 30:.3f} GiB; loss and params bit-identical to "
            f"remat full: {same}")
        require(same, f"remat {remat} differs from remat full")
        out["remat"][remat] = {"metrics": m, "ms": ms, "peak": peak}
        if ref is None:
            ref = (m, params)
        del state
        torch.cuda.empty_cache()
    del ref
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0, optimizer="sgd")
    runs = []
    for k in (1, 2):
        pc = ParallelConfig(microbatches=k)
        state = _train_state(torch, spec, cfg, tc, pc, dev)
        if k == 1:
            before = {n: p.detach().float().cpu().clone()
                      for n, p in state["params"].named_parameters()}
        state, m = _one_step(torch, state, batch, spec, cfg, tc, pc)
        runs.append((state, m))
    gap, _ = _param_gap(torch, runs[1][0], runs[0][0], before)
    out["microbatches"] = _agree("microbatches 2 vs 1, one sgd step",
                                 runs[1][1], runs[0][1], gap)
    del runs
    torch.cuda.empty_cache()
    return out


class _PreemptAt:
    """Triggers a `PreemptionGuard` before step `at`, as SIGTERM would."""

    def __init__(self, guard, at):
        self.guard, self.at = guard, at

    def maybe_fail(self, step):
        if step == self.at:
            self.guard.trigger()


def _train_restarts(torch, dev):
    """(d) `launch.train --arch granite-8b --smoke` on the card: killed at
    step 13 under `run_with_restarts` (async saves every 5), and preempted
    after step 18 (blocking saves), each against an uninterrupted 30-step
    run."""
    from repro_torch import convert
    from repro_torch.launch import train
    from repro_torch.runtime import fault_tolerance as ft

    root = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "granite-8b", "--smoke", "--steps", "30", "--batch",
            "4", "--seq", "32", "--log-every", "0", "--no-preemption-guard"]

    def run(ckpt="", extra=(), **kw):
        if ckpt:
            extra = ["--ckpt", str(ckpt), "--save-every", "5", *extra]
        return train.train_loop(train.build_parser().parse_args(
            argv + list(extra)), **kw)

    def compare(tag, got, want):
        a = convert.params_to_numpy(got["state"]["params"])
        b = convert.params_to_numpy(want["state"]["params"])
        gap = max(float(np.abs(x - y).max()) for (_, x), (_, y) in
                  zip(convert.tree_leaves(a), convert.tree_leaves(b),
                      strict=True))
        same = train.params_md5(got["state"]["params"]) == \
            train.params_md5(want["state"]["params"])
        log(f"[train_dense] {tag}: last step {got['last_step']}, final "
            f"params max|d| {gap:.3e} against the uninterrupted run "
            f"(tol {FT_TOL}); bit-identical: {same}")
        require(got["last_step"] == 30 and gap <= FT_TOL,
                f"{tag}: not the uninterrupted run's params")
        return {"max_abs_diff": gap, "bit_identical": same}

    try:
        whole = run()
        again = run()
        out = {"repeat": compare("a second uninterrupted run", again, whole)}
        inj = ft.FailureInjector(fail_at_steps=[13])
        runs = []

        def loop(_):
            runs.append(run(root / "inject", ["--async-ckpt"],
                            fail_injector=inj))
            return runs[-1]["last_step"]

        require(ft.run_with_restarts(loop, max_restarts=2) == 30
                and inj.failed == [13], f"restarts: failed {inj.failed}")
        out["failure_at_13"] = compare(
            "killed at step 13 (async saves), restarted from step 10",
            runs[-1], whole)
        guard = ft.PreemptionGuard(signals=())
        stopped = run(root / "preempt", fail_injector=_PreemptAt(guard, 17),
                      guard=guard)
        from repro_torch.ckpt.checkpointer import Checkpointer

        saved = Checkpointer(str(root / "preempt")).latest_step()
        require(stopped["last_step"] == 18 and saved == 18,
                f"preemption stopped at {stopped['last_step']}, saved "
                f"{saved}")
        out["preempted_at_18"] = compare(
            "preempted after step 18 (saved, stopped), run again",
            run(root / "preempt"), whole)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_train_dense(torch, dev, keep=None):
    """The dense trainer: (a) configuration 9 (`keep(state)` sees its
    state after the run), (b) card vs CPU, (c) remat modes and
    microbatches, (d) fault tolerance."""
    return {"main": _train_main(torch, dev, keep=keep),
            "card_vs_cpu": _train_vs_cpu(torch, dev),
            "variants": _train_variants(torch, dev),
            "restarts": _train_restarts(torch, dev)}


# ---------------------------------------------------------------------------
# the MoE family and the sliding window
# ---------------------------------------------------------------------------

PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x22b"
PHI_SERVE_LAYERS, MIXTRAL_SERVE_LAYERS, PHI_TRAIN_LAYERS = 16, 8, 2
MIXTRAL_BATCH, MIXTRAL_PROMPT = 2, 8192
TRAIN_PEAK_LIMIT = 75 * 2 ** 30   # above it, training is cut to 1 layer
# card vs CPU in f32 with TF32 off: both sides sum the same f32 products
# in other orders, which moves a value by a few f32 units of its scale
# (~1e-6 relative over d = 4096); 1e-4 of the row's largest |logit|
# leaves a hundredfold margin and fails on any bf16 rounding (2^-8). A
# token whose routes differ is compared only if its top-k margin is
# under ROUTE_MARGIN (a near tie), and then its logits are not compared.
F32_LOGIT_TOL, F32_AUX_TOL, ROUTE_MARGIN = 1e-4, 1e-5, 1e-5


def moe_model(torch, dev, arch, num_layers, generator=None, **changes):
    """`arch` at full width cut to `num_layers` (bf16 matrices, f32 norm
    scales unless `changes` say otherwise), weights from `generator`
    (default: one on `dev` seeded SEED)."""
    from repro_torch.models import common

    spec, cfg = train_config(num_layers, arch, **changes)
    gen = generator or torch.Generator(device=dev).manual_seed(SEED)
    model = common.init_params(spec.model(cfg, device=gen.device), gen)
    return spec, cfg, model


def count_drops(torch, fn):
    """Run `fn` with `moe.route` counting its (token, slot) pairs and the
    dropped ones (on the device, read once at the end). Returns fn's
    result and (dropped, pairs)."""
    from repro_torch.models import moe

    seen = []
    real = moe.route

    def counting(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append((r.keep.numel(), (~r.keep).sum()))
        return r

    moe.route = counting
    try:
        out = fn()
    finally:
        moe.route = real
    return out, (int(sum(d for _, d in seen)), sum(n for n, _ in seen))


def _moe_serve(torch, dev, arch, num_layers, batch, prompt, results):
    """`serve_run` of `arch` cut to `num_layers`, batch x prompt; then
    the (token, slot) pairs dropped by a prefill and 31 decode steps."""
    from repro_torch.train import serve

    out = {}
    if arch == PHI:
        out["flash_attention"] = _moe_attention(torch, dev, results)
    t = time.perf_counter()
    spec, cfg, model = moe_model(torch, dev, arch, num_layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    log(f"[moe] {arch} at full width cut to {num_layers} layers: "
        f"{cfg.param_count()} params, {cfg.active_param_count()} active a "
        f"token; weights from torch.Generator(seed {SEED}) on the card in "
        f"{init_s:.2f} s, {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    out.update(serve_run(torch, dev, spec, cfg, model, batch, prompt, "moe",
                         f"{arch} "), init_s=init_s)

    # dropped (token, slot) pairs: a prefill (groups of 512) and 31 decode
    # steps (each step's `batch` tokens one group), untimed
    tokens = torch.from_numpy(prompts(cfg, batch, prompt)).to(dev)
    prefill = serve.make_prefill_step(spec, cfg)
    decode = serve.make_decode_step(spec, cfg)
    (logits, cache), pre_drop = count_drops(
        torch, lambda: prefill(model, {"tokens": tokens}))

    def steps():
        nonlocal logits, cache
        for _ in range(DECODE_STEPS - 1):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            logits, cache = decode(model, cache, tok)

    _, dec_drop = count_drops(torch, steps)
    log(f"[moe] {arch}: dropped (token, slot) pairs at prefill "
        f"{pre_drop[0]} of {pre_drop[1]} ({pre_drop[0] / pre_drop[1]:.5f}), "
        f"over {DECODE_STEPS - 1} decode steps {dec_drop[0]} of "
        f"{dec_drop[1]} ({dec_drop[0] / dec_drop[1]:.5f})")
    out.update(dropped_prefill=pre_drop, dropped_decode=dec_drop)
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


def _moe_attention(torch, dev, results):
    """flash_attention at phi3.5-moe's prefill shape, q (8, 4096, 32, 128)
    against k, v (8, 4096, 8, 128) (GQA group 4) from layer 0 of a
    1-layer phi3.5-moe (the plain version's (8, 8, 4, 4096, 4096) f32
    scores do not fit beside the 16-layer model): held to its plain
    version, timed beside its plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    _, cfg, model = moe_model(torch, dev, PHI, 1)
    tokens = torch.from_numpy(prompts(cfg, SERVE_BATCH, PROMPT)).to(dev)
    q, k, v = layer0_qkv(torch, model, cfg, tokens)
    del model
    err = max(_attn_case(torch, f"phi3.5-moe layer 0, batch element {i}",
                         q[i:i + 1], k[i:i + 1], v[i:i + 1], True)
              for i in (0, SERVE_BATCH - 1))
    nbytes, nflops = attn_work(q, k, True)
    bms, by = bound(nbytes, nflops, BF16_TC_FLOPS)
    entry = {"name": "flash_attention", "shape": [list(q.shape),
                                                  list(k.shape)],
             "max_abs_err": err, "bound_ms": bms, "bound_by": by,
             "flops": nflops, "bytes": nbytes}
    with torch.inference_mode():
        _timed(torch, entry, lambda: flash_attention(q, k, v),
               ("flash_attention_kernel",),
               lambda: ref.flash_attention_ref(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        entry["library_ms"], entry["library_call_ms"] = kernel_and_call_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), ())
    entry["tflops"] = nflops / entry["ms"] / 1e9
    log(f"[moe] flash_attention at phi3.5-moe's {tuple(q.shape)} x "
        f"{tuple(k.shape)}: device ms={entry['ms']:.4f} "
        f"({entry['tflops']:.1f} TFLOP/s), plain ms={entry['plain_ms']:.4f}, "
        f"scaled_dot_product_attention ms={entry['library_ms']:.4f}, bound "
        f"{bms:.4f} ms ({by}: {nflops / 1e12:.4f} TFLOP, "
        f"{nbytes / 1e9:.4f} GB)")
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"], err)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return entry


def _route_margin(probs, k):
    """Each token's smallest gap between neighbours among its k + 1
    largest router probabilities: under it, a rounding can reorder."""
    top = probs.topk(k + 1, dim=-1).values
    return (top[..., :-1] - top[..., 1:]).amin(dim=-1)


def _layer0_routing(torch, model, cfg, tokens):
    """Layer 0's MoE routing of a training forward's tokens (its input
    as `transformer.decoder_layer` makes it)."""
    from repro_torch.models import common, layers, moe, transformer

    with torch.no_grad():
        x = common.embed_tokens(model.embed, tokens, cfg)
        tables = transformer.rope_tables(torch.arange(
            tokens.shape[1], dtype=torch.int32, device=x.device), cfg)
        lp = model.layers[0]
        h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
        x = x + layers.attention_block(lp.attn, h, cfg, tables)
        h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
        return moe.route(lp.mlp, h, cfg)


def _moe_vs_cpu(torch, dev):
    """(b) One layer of phi3.5-moe at full width, batch 2 x 512, the same
    weights and tokens on the card and the CPU: in f32 (TF32 off) the
    routing of layer 0, the training forward's logits and aux; in bf16 the
    share of identical routes, prefill's last logits and the aux."""
    import dataclasses

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import transformer

    spec, cfg32, cpu32 = moe_model(
        torch, dev, PHI, 1, generator=torch.Generator().manual_seed(SEED),
        dtype="float32")
    tokens = torch.from_numpy(prompts(cfg32, 2, 512))
    pc = ParallelConfig(remat="none")
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(cfg32, dtype=dtype)
            cpu = cpu32
            if dtype != "float32":
                cpu = transformer.Transformer(cfg, device="cpu")
                cpu.load_state_dict(cpu32.state_dict())
            card = transformer.Transformer(cfg, device=dev)
            card.load_state_dict(cpu32.state_dict())
            t = time.perf_counter()
            r_h = _layer0_routing(torch, cpu, cfg, tokens)
            with torch.no_grad():
                lg_h, aux_h = spec.forward(cpu, {"tokens": tokens}, cfg, pc)
            # prefill's kernel takes bf16 only: in f32 the training
            # forward's logits stand for it (its attention is the
            # reference prefill's own blocked attention)
            pre_h = pre_c = lg_h
            if dtype == "bfloat16":
                pre_h, _ = spec.prefill(cpu, {"tokens": tokens}, cfg)
            cpu_s = time.perf_counter() - t
            tc = tokens.to(dev)
            r_c = _layer0_routing(torch, card, cfg, tc)
            with torch.no_grad():
                lg_c, aux_c = spec.forward(card, {"tokens": tc}, cfg, pc)
            pre_c = lg_c
            if dtype == "bfloat16":
                pre_c, _ = spec.prefill(card, {"tokens": tc}, cfg)
            out[dtype] = _routes_and_logits(
                torch, dtype, cfg, r_c, r_h, (lg_c, aux_c, pre_c),
                (lg_h, aux_h, pre_h), cpu_s)
            del card, lg_c, pre_c
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _routes_and_logits(torch, dtype, cfg, r_c, r_h, card, host, cpu_s):
    """Compare layer 0's routing and the outputs of card and CPU (see
    `_moe_vs_cpu`); returns the numbers."""
    lg_c, aux_c, pre_c = (x.float().cpu() for x in card)
    lg_h, aux_h, pre_h = (x.float() for x in host)
    idx_c, pos_c, keep_c = (x.cpu() for x in (r_c.idx, r_c.pos, r_c.keep))
    same_idx = (idx_c == r_h.idx).all(-1)                 # (ng, g)
    same = same_idx & (pos_c == r_h.pos).all(-1) & (keep_c == r_h.keep).all(-1)
    margin = _route_margin(r_h.probs, cfg.experts_per_token)
    near = margin < ROUTE_MARGIN
    # a token with other experts moves the positions of the pairs after
    # it in its group; the first such token of each group ends the
    # stretch in which positions must agree
    n_ng, g = same.shape
    first = torch.where(~same_idx, torch.arange(g)[None, :].expand(n_ng, g),
                        g).amin(dim=1)
    before = torch.arange(g)[None, :] < first[:, None]
    v = cfg.vocab_size
    # tokens routed alike: the same experts, positions and kept pairs (a
    # re-routed token shifts the positions of the later pairs of its
    # group, which may then be kept on one side and dropped on the other)
    rows = same.reshape(lg_c.shape[0], -1)
    d = (lg_c - lg_h).abs()[..., :v]
    scale = lg_h[..., :v].abs().amax(dim=-1)
    rel = (d.amax(dim=-1) / scale)[rows]
    dp = (pre_c - pre_h).abs()[:, -1, :v].amax(dim=-1) / \
        pre_h[:, -1, :v].abs().amax(dim=-1)
    last_alike = rows[:, -1]
    aux_rel = float(abs(aux_c - aux_h) / abs(aux_h))
    rec = {"experts_identical": int(same_idx.sum()),
           "routes_identical": int(same.sum()), "tokens": int(same.numel()),
           "other_experts": int((~same_idx).sum()),
           "other_experts_near_ties": int((~same_idx & near).sum()),
           "near_ties": int(near.sum()), "min_margin": float(margin.min()),
           "logits_max_rel": float(rel.max()),
           "prefill_last_max_rel": [float(x) for x in dp],
           "aux": [float(aux_c), float(aux_h)], "aux_rel": aux_rel,
           "cpu_s": cpu_s}
    log(f"[moe] card vs CPU, phi3.5-moe 1 layer, 2 x 512, {dtype}: experts "
        f"identical for {rec['experts_identical']} of {rec['tokens']} "
        f"tokens, experts, positions and kept pairs for "
        f"{rec['routes_identical']}; "
        f"other experts {rec['other_experts']} "
        f"({rec['other_experts_near_ties']} of them near ties, top-k margin "
        f"< {ROUTE_MARGIN}; {rec['near_ties']} near ties in all, smallest "
        f"margin {rec['min_margin']:.3e}); "
        f"logits of the tokens routed alike max|d| / max|logit| "
        f"{rec['logits_max_rel']:.3e}, prefill's last logits "
        f"{[f'{x:.3e}' for x in rec['prefill_last_max_rel']]}; aux "
        f"{float(aux_c):.7f} vs {float(aux_h):.7f} (rel {aux_rel:.3e}); "
        f"the CPU's forward and prefill {cpu_s:.1f} s")
    if dtype == "float32":
        require(bool(((same_idx) | near).all()),
                "f32: a token away from a near tie has other experts on "
                "the card")
        require(bool((same | ~before).all()),
                "f32: capacity positions or kept pairs differ before a "
                "group's first re-routed token")
        tol = F32_LOGIT_TOL
        ok = rec["logits_max_rel"] <= tol and bool(
            (dp[last_alike] <= tol).all())
        require(ok, f"f32 logits differ by more than {tol} of the row's "
                    "scale")
        if rec["other_experts"] == 0:
            require(aux_rel <= F32_AUX_TOL, f"f32 aux differs by {aux_rel}")
    else:
        require(same_idx.float().mean() >= 0.95,
                "bf16: fewer than 95% of the tokens given the same experts")
        ok = rec["logits_max_rel"] <= ATTN_TOL and bool(
            (dp[last_alike] <= ATTN_TOL).all()) and aux_rel <= ATTN_TOL
        require(ok, f"bf16 logits or aux differ by more than {ATTN_TOL} "
                    "of their scale")
    return rec


def _moe_train(torch, dev, keep=None):
    """(c) configuration 11: phi3.5-moe trained at 2 layers (1 if the peak
    passes TRAIN_PEAK_LIMIT), then one sgd step card vs CPU at 1 layer in
    f32 activations; `keep` as `_train_main`'s, of the kept run."""
    main = None
    try:
        main = _train_main(torch, dev, PHI, PHI_TRAIN_LAYERS, "moe",
                           keep=keep)
    except torch.cuda.OutOfMemoryError as e:
        log(f"[moe] training at {PHI_TRAIN_LAYERS} layers ran out of "
            f"memory ({str(e)[:200]}); cut to 1 layer")
        torch.cuda.empty_cache()
    if main is not None and main["max_memory_allocated"] > TRAIN_PEAK_LIMIT:
        log(f"[moe] training at {PHI_TRAIN_LAYERS} layers peaked at "
            f"{main['max_memory_allocated'] / 2 ** 30:.3f} GiB, above 75; "
            "cut to 1 layer")
        main = None
    if main is None:
        main = _train_main(torch, dev, PHI, 1, "moe", keep=keep)
    require(main["metrics"][-1]["aux"] > 0, "no MoE aux loss")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vs = _train_vs_cpu(torch, dev, PHI, "moe", dtype="float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"main": main, "card_vs_cpu": vs}


def _ring_check(torch, dev, cfg, batch):
    """(d) decode_attention over a ring of W slots against the blocked
    sliding-window attention over the whole sequence, at mixtral's
    attention widths, on seeded bf16 q, k, v for 8192 + 32 positions:
    each decode step's output within ATTN_TOL * (1 + |reference|)."""
    from repro_torch.models import layers

    w, s = cfg.sliding_window, MIXTRAL_PROMPT + DECODE_STEPS
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v = rand(batch, s, h, hd), rand(batch, s, kh, hd), \
        rand(batch, s, kh, hd)
    with torch.inference_mode():
        want = layers.blocked_causal_attention(q, k, v, window=w)
        p0 = MIXTRAL_PROMPT - w
        ring_k, ring_v = k[:, p0:MIXTRAL_PROMPT].clone(), \
            v[:, p0:MIXTRAL_PROMPT].clone()
        errs = []
        for t in range(DECODE_STEPS):
            pos = MIXTRAL_PROMPT + t
            ring_k[:, pos % w] = k[:, pos]
            ring_v[:, pos % w] = v[:, pos]
            got = layers.decode_attention(
                q[:, pos:pos + 1], ring_k, ring_v,
                torch.full((batch,), pos + 1, dtype=torch.int32, device=dev),
                window=w)
            ref_row = want[:, pos:pos + 1].float()
            d = (got.float() - ref_row).abs()
            require(bool((d <= ATTN_TOL * (1 + ref_row.abs())).all()),
                    f"ring decode at position {pos} differs from the "
                    "blocked window attention")
            errs.append(float(d.max()))
    log(f"[moe] ring check, mixtral attention ({batch} x {s} positions, "
        f"{h}/{kh} heads, hd {hd}, W {w}): {DECODE_STEPS} decode steps over "
        f"the ring against blocked_causal_attention(window={w}), max|d| "
        f"{max(errs):.3e} (tol {ATTN_TOL} * (1 + |reference|)) ok=True")
    del q, k, v, want, ring_k, ring_v
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "errs": errs}


def phase_moe(torch, dev, results, keep=None):
    """The MoE family and the sliding window: (a) phi3.5-moe serving,
    (b) card vs CPU, (c) phi3.5-moe training (`keep` sees its state),
    (d) mixtral serving and the ring check."""
    torch.cuda.empty_cache()
    out = {"phi_serve": _moe_serve(torch, dev, PHI, PHI_SERVE_LAYERS,
                                   SERVE_BATCH, PROMPT, results)}
    out["card_vs_cpu"] = _moe_vs_cpu(torch, dev)
    out["phi_train"] = _moe_train(torch, dev, keep)
    out["mixtral_serve"] = _moe_serve(torch, dev, MIXTRAL,
                                      MIXTRAL_SERVE_LAYERS, MIXTRAL_BATCH,
                                      MIXTRAL_PROMPT, results)
    _, cfg = train_config(1, MIXTRAL)
    out["ring"] = _ring_check(torch, dev, cfg, MIXTRAL_BATCH)
    return out


# ---------------------------------------------------------------------------
# the hybrid, SSM and encoder-decoder families
# ---------------------------------------------------------------------------

ZAMBA, XLSTM, WHISPER = "zamba2-2.7b", "xlstm-125m", "whisper-small"
FAM_TRAIN_BATCH, FAM_TRAIN_SEQ = 16, 1024      # xlstm's and whisper's
ENC_FRAMES, WHISPER_PROMPT = 1500, 416          # 416 + 32 steps = 448
HANDOFF_PROMPT, HANDOFF_STEPS = 3968, 128       # 3968 + 128 = PROMPT
# xlstm's f32 handoff: 2x the sound path's reading (1.50e-4 of the row's
# scale on the H100), above the logits' response to one f32 rounding of
# the embedding (2.45e-4: random weights make the mLSTM's normaliser
# |q . n| small at some positions); the zeroed-state control reads 1.35
XLSTM_HANDOFF_TOL = 3e-4
# 54 layers run out of memory on one card (38.6 GB of state and a
# group's recompute, PERF.md configuration 14): full depth is a 4-card
# cell, so the path starts at 12
ZAMBA_TRAIN_DEPTHS = (12, 6)
# xlstm's training is host-bound (the sLSTM recurrence, 6-12 s a step at
# its 12 blocks): cut to 4 blocks (2 sLSTM), which keeps the path and its
# sLSTM share within the script's time
XLSTM_TRAIN_BLOCKS = 4


def family_model(torch, dev, arch, generator=None, **changes):
    """`arch` at full width (its config with `changes`: a cut depth, f32
    activations), weights from `generator` (default: one on `dev`
    seeded SEED)."""
    import dataclasses

    from repro_torch.models import common, registry

    spec = registry.get_spec(arch)
    cfg = dataclasses.replace(spec.cfg, **changes)
    gen = generator or torch.Generator(device=dev).manual_seed(SEED)
    model = common.init_params(spec.model(cfg, device=gen.device), gen)
    return spec, cfg, model


def whisper_frames(cfg, batch, frames=ENC_FRAMES):
    """Stub encoder frames (batch, frames, d_model) f32 from numpy seed
    SEED + 7."""
    return np.random.default_rng(SEED + 7).normal(
        size=(batch, frames, cfg.d_model)).astype(np.float32)


def _zamba_qkv(torch, model, cfg, tokens):
    """q, k, v of the shared block's first invocation in a prefill of
    `tokens`, as prefill makes them: the first group's mamba layers, RMS
    norm, projections, RoPE."""
    from repro_torch.models import common, layers, mamba, transformer

    with torch.inference_mode():
        x = common.embed_tokens(model.embed, tokens, cfg)
        for lp in model.layers[:cfg.attn_every]:
            x = mamba.mamba_block(lp, x, cfg)
        sp = model.shared
        h = layers.rms_norm(x, sp.ln1, cfg.norm_eps)
        q = layers.project_q(sp.attn, h, cfg)
        k, v = layers.project_kv(sp.attn, h, cfg)
        q, k = transformer.rope(q, k, transformer.rope_tables(torch.arange(
            tokens.shape[1], dtype=torch.int32, device=tokens.device), cfg))
        return q, k, v


def _whisper_qkv(torch, model, cfg, tokens, frames):
    """The encoder's layer 0 q, k, v over the frames, the decoder's layer
    0 self-attention q, k, v over the prompt, and its cross-attention q
    (the prompt) with k, v of the encoded frames, as prefill makes
    them."""
    from repro_torch.models import common, encdec, layers

    with torch.inference_mode():
        x = encdec._positions(frames.to(common.act_dtype(cfg)), cfg)
        lp = model.encoder[0]
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        enc = (layers.project_q(lp.attn, h, cfg),
               *layers.project_kv(lp.attn, h, cfg))
        enc_out = encdec.encode(model, frames, cfg, serving=True)
        x = encdec._positions(common.embed_tokens(model.embed, tokens, cfg),
                              cfg)
        lp = model.layers[0]
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        dec = (layers.project_q(lp.attn, h, cfg),
               *layers.project_kv(lp.attn, h, cfg))
        x = x + layers.project_out(lp.attn,
                                   layers.causal_self_attention(*dec))
        h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
        cross = (layers.project_q(lp.xattn, h, cfg),
                 *layers.project_kv(lp.xattn, enc_out, cfg))
        return enc, dec, cross


def _attn_timed(torch, tag, q, k, v, causal):
    """flash_attention at (q, k, v): the timed call's own output held to
    the plain version one batch element at a time within ATTN_TOL * (1 +
    |plain|), two more calls bit-identical to it; device ms and call ms
    beside its bound, its plain version's and SDPA's."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    nbytes, nflops = attn_work(q, k, causal)
    bms, by = bound(nbytes, nflops, BF16_TC_FLOPS)
    entry = {"name": "flash_attention", "shape": [list(q.shape),
                                                  list(k.shape)],
             "causal": causal, "bound_ms": bms, "bound_by": by,
             "flops": nflops, "bytes": nbytes}
    timed = {}

    def call():
        timed["out"] = flash_attention(q, k, v, causal=causal)

    with torch.inference_mode():
        _timed(torch, entry, call, ("flash_attention_kernel",),
               lambda: ref.flash_attention_ref(q, k, v, causal=causal))
        out = timed.pop("out")
        again = [flash_attention(q, k, v, causal=causal) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(out, a) for a in again)
        del again
        errs = []
        for i in range(q.shape[0]):
            want = ref.flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], causal=causal)
            d = (out[i:i + 1].float() - want.float()).abs()
            errs.append(float(d.max()))
            require(bool((d <= ATTN_TOL * (1 + want.float().abs())).all())
                    and bool(torch.isfinite(out[i]).all()),
                    f"flash_attention's timed output at {tag} disagrees "
                    f"with its plain version at batch element {i}")
        del out, want, d
        log(f"[families] flash_attention timed output at {tag}: max|d| by "
            f"batch element {[f'{e:.3e}' for e in errs]} (tol {ATTN_TOL} * "
            f"(1 + |plain|)) ok=True; 3 calls bit-identical={same}")
        require(same, f"flash_attention at {tag} is not bit-reproducible")
        entry["max_abs_err"] = max(errs)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        entry["library_ms"], entry["library_call_ms"] = kernel_and_call_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal,
                enable_gqa=q.shape[2] != k.shape[2]), ())
    entry["tflops"] = nflops / entry["ms"] / 1e9
    log(f"[families] flash_attention at {tag} {tuple(q.shape)} x "
        f"{tuple(k.shape)} causal={causal}: device ms={entry['ms']:.4f} "
        f"({entry['tflops']:.1f} TFLOP/s), plain ms={entry['plain_ms']:.4f}, "
        f"scaled_dot_product_attention ms={entry['library_ms']:.4f}, bound "
        f"{bms:.4f} ms ({by}: {nflops / 1e12:.4f} TFLOP, "
        f"{nbytes / 1e9:.4f} GB); {entry['bound_ms'] / entry['ms']:.3f} of "
        "the bound")
    return entry


def _attention_d80(torch, dev, results):
    """(a) flash_attention at zamba2's head dim of 80: on the shared
    block's first q, k, v of an (8, 4096) prefill (a 6-layer zamba2, the
    first group, freed before the timing), and on adversarial shapes;
    each held to the plain version; the timed (8, 4096) call's output
    held to it one batch element at a time and 3 calls bit-identical
    (`_attn_timed`), beside the bound, the plain version and SDPA."""
    _, cfg, model = family_model(torch, dev, ZAMBA, num_layers=6)
    require(cfg.resolved_head_dim == 80, f"head dim {cfg.resolved_head_dim}")
    tokens = torch.from_numpy(prompts(cfg, SERVE_BATCH, PROMPT)).to(dev)
    q, k, v = _zamba_qkv(torch, model, cfg, tokens)
    del model
    torch.cuda.empty_cache()
    errs = []
    rng = np.random.default_rng(SEED + 8)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    for name, (b, sq, skv, h, causal) in {
            "D = 80, ragged S = 1000": (2, 1000, 1000, 32, True),
            "D = 80, Sq < Skv": (2, 300, 1000, 32, True),
            "D = 80, causal=False": (2, 1000, 1000, 32, False),
            "D = 80, Sq = 1": (4, 1, 4097, 32, True),
            "D = 80, S = 65": (2, 65, 65, 32, True),
            "D = 80, S = 129": (2, 129, 129, 32, True),
            "D = 80, S = 4097": (1, 4097, 4097, 32, True),
            "D = 80, (Sq, Skv) = (77, 1000), causal=False": (
                2, 77, 1000, 32, False)}.items():
        errs.append(_attn_case(torch, name, rand(b, sq, h, 80),
                               rand(b, skv, h, 80), rand(b, skv, h, 80),
                               causal))
    entry = _attn_timed(torch, "zamba2's (8, 4096), 32 heads, D = 80", q, k,
                        v, True)
    entry["max_abs_err"] = max(entry["max_abs_err"], *errs)
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"], entry["max_abs_err"])
    del q, k, v
    torch.cuda.empty_cache()
    return entry


def _pad_kv(torch, cache, slots):
    """The cache's K/V padded with zero slots to `slots` (the prefill
    leaves PREFILL_EXTRA of headroom; a longer decode needs more)."""
    import torch.nn.functional as F

    for name in ("k", "v"):
        extra = slots - cache[name].shape[2]
        if extra > 0:
            cache[name] = F.pad(cache[name], (0, 0, 0, 0, 0, extra))
    return cache


def _logits_agree(torch, tag, got, want, tol, vocab):
    """The last position's logits of the card (`got`) against `want`:
    |d| <= tol * max|want| of the row, and the argmax equal unless the
    top two of `want` are closer than that."""
    got = got.float().cpu()[:, -1, :vocab]
    want = want.float().cpu()[:, -1, :vocab]
    scale = want.abs().amax(dim=-1, keepdim=True)
    d = (got - want).abs()
    top2 = torch.topk(want, 2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) < tol * scale[:, 0]
    same = got.argmax(-1) == want.argmax(-1)
    ok = bool((d <= tol * scale).all()) and bool((same | tie).all())
    rec = {"step": tag, "max_abs_err": float(d.max()),
           "max_rel_err": float((d.amax(-1) / scale[:, 0]).max()),
           "tol": tol, "argmax_equal": same.tolist()}
    log(f"[families] {tag}: max|d logits| {rec['max_abs_err']:.4e}, of the "
        f"row's max|logit| {rec['max_rel_err']:.4e} (tol {tol}); argmax "
        f"equal {rec['argmax_equal']} ok={ok}")
    require(ok, f"{tag}: the logits disagree")
    return rec


def _slow_decay(torch, model, cfg):
    """Let the recurrent state outlive the handoff's 128 steps: zamba2's
    A_log and dt_bias at -4 (a decay of ~e^-3.3e-4 a step, where the
    init's ones give ~e^-3.5 and a prefill's state is gone after a few
    steps), xlstm's mLSTM forget bias at 6 and the sLSTM's forget
    pre-activation bias at 3."""
    with torch.no_grad():
        for lp in getattr(model, "layers", []):
            lp.A_log.fill_(-4.0)
            lp.dt_bias.fill_(-4.0)
        for bp in getattr(model, "blocks", []):
            if bp.kind == "kind_mlstm":
                bp.f_bias.fill_(6.0)
            else:
                bp.b_gates[2].fill_(3.0)


def _zero_states(torch, cache):
    """The control: the cache with its recurrent states zeroed (the
    conv tails and K/V kept)."""
    with torch.inference_mode():
        if "ssd" in cache:
            cache["ssd"].zero_()
        for bc in cache.get("blocks", []):
            for kind, st in bc.items():
                for name in (("S", "n") if kind == "mlstm" else
                             ("c", "n", "h")):
                    st[name] = torch.zeros_like(st[name])
    return cache


def _handoff(torch, dev, arch, dtype, tol, batch=2, **changes):
    """(g) The state handoff on the card: `arch` at full width (`changes`
    may cut it) in `dtype`, weights from a CPU generator seeded SEED (so
    that the CPU can repeat the run), its decay slowed (`_slow_decay`):
    prefill(3968) and 128 decode steps, teacher-forced, against
    prefill(4096)'s last logits within `tol` of the row's scale (TF32
    off). The control, the same decode from zeroed recurrent states, must
    miss by five times the tolerance."""
    from repro_torch.train import serve

    spec, cfg, cpu = family_model(torch, "cpu", arch,
                                  generator=torch.Generator().manual_seed(
                                      SEED), dtype=dtype, **changes)
    _slow_decay(torch, cpu, cfg)
    model = spec.model(cfg, device=dev)
    model.load_state_dict(cpu.state_dict())
    del cpu
    tokens = torch.from_numpy(prompts(cfg, batch, PROMPT)).to(dev)
    prefill = serve.make_prefill_step(spec, cfg)
    decode = serve.make_decode_step(spec, cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, _ = prefill(model, {"tokens": tokens})
        runs = {}
        for control in (False, True):
            t = time.perf_counter()
            logits, cache = prefill(
                model, {"tokens": tokens[:, :HANDOFF_PROMPT]})
            if "k" in cache:
                cache = _pad_kv(torch, cache, PROMPT)
            if control:
                cache = _zero_states(torch, cache)
            for i in range(HANDOFF_PROMPT, PROMPT):
                logits, cache = decode(model, cache, tokens[:, i:i + 1])
            torch.cuda.synchronize()
            runs[control] = (logits, time.perf_counter() - t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tag = (f"{arch} {cfg.num_layers} layers ({dtype}) prefill("
           f"{HANDOFF_PROMPT}) + {HANDOFF_STEPS} decode steps vs prefill("
           f"{PROMPT})")
    rec = _logits_agree(torch, tag, runs[False][0], want, tol,
                        cfg.vocab_size)
    lc, lw = (x.float().cpu()[:, -1, :cfg.vocab_size]
              for x in (runs[True][0], want))
    rec["control_max_rel_err"] = float(((lc - lw).abs().amax(-1)
                                        / lw.abs().amax(-1)).max())
    rec["seconds"] = runs[False][1]
    log(f"[families] {tag}: {runs[False][1]:.2f} s; the control from zeroed "
        f"states misses by {rec['control_max_rel_err']:.4e} of the row's "
        f"scale")
    require(rec["control_max_rel_err"] > 5 * tol,
            f"{tag}: zeroed states give the same logits, so the check sees "
            "no state")
    del model, cache
    torch.cuda.empty_cache()
    return rec


def _zamba_train(torch, dev):
    """(c) configuration 14: zamba2 trained at 12 layers if the peak
    stays under TRAIN_PEAK_LIMIT, else at 6; then one f32 sgd step at 6
    layers, 1 x 256, card vs CPU."""
    main = None
    for depth in ZAMBA_TRAIN_DEPTHS:
        try:
            main = _train_main(torch, dev, ZAMBA, depth, "families")
        except torch.cuda.OutOfMemoryError as e:
            log(f"[families] zamba2 training at {depth} layers ran out of "
                f"memory ({str(e)[:160]})")
            main = None
        if main is not None and main["max_memory_allocated"] \
                > TRAIN_PEAK_LIMIT:
            log(f"[families] zamba2 training at {depth} layers peaked at "
                f"{main['max_memory_allocated'] / 2 ** 30:.3f} GiB, above "
                "75")
            main = None
        torch.cuda.empty_cache()
        if main is not None:
            break
    require(main is not None, "zamba2 training fits at no depth")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vs = _train_vs_cpu(torch, dev, ZAMBA, "families", num_layers=6,
                           dtype="float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"main": main, "card_vs_cpu": vs}


def _without_slstm_ms(torch, dev, n=3):
    """A configuration-16 train step with the sLSTM blocks made the
    identity (`xlstm.slstm_block` patched: x plus the sum of the block's
    parameters times 0, so that they keep a gradient), the median of `n`
    steps
    after a warm-up, in ms: the step less the sLSTM loop's forward and
    backward."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import xlstm
    from repro_torch.train import trainer

    spec, cfg = train_config(XLSTM_TRAIN_BLOCKS, XLSTM)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, optimizer="adamw")
    pc = ParallelConfig(remat="none")
    state = _train_state(torch, spec, cfg, tc, pc, dev)
    step = trainer.make_train_step(spec, cfg, tc, pc)
    batch = list(_lm_batches(cfg, FAM_TRAIN_BATCH, FAM_TRAIN_SEQ, 1, dev))[0]
    real = xlstm.slstm_block

    def identity(p, x, cfg, return_state=False):
        # the block's parameters stay in the graph, with zero gradients
        return x + sum((t * 0.0).sum() for t in p.parameters())

    xlstm.slstm_block = identity
    times = []
    try:
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        xlstm.slstm_block = real
    del state
    torch.cuda.empty_cache()
    return statistics.median(times[1:])


def _xlstm_train(torch, dev):
    """(d) configuration 16: xlstm-125m (cut to XLSTM_TRAIN_BLOCKS) trained
    at 16 x 1024, adamw, 10 steps, remat none (it fits, and a recompute would replay the sLSTM
    loop); the sLSTM loop's share of the step from the same step with
    the sLSTM blocks made the identity; one f32 sgd step at 2 layers,
    1 x 256, card vs CPU. At random init the mLSTM's normaliser
    |q . n| is small at some positions, the gradient norms are in the
    thousands, and 10 steps at lr 3e-4 barely move the first batch's
    cross-entropy either way: the card-vs-CPU step, not the loss's fall,
    is what is required of the training path."""
    main = _train_main(torch, dev, XLSTM, XLSTM_TRAIN_BLOCKS, "families",
                       FAM_TRAIN_BATCH, FAM_TRAIN_SEQ, require_learning=False,
                       remat="none")
    rest_ms = _without_slstm_ms(torch, dev)
    share = 1 - rest_ms / main["step_ms_median"]
    log(f"[families] xlstm-125m train step with the sLSTM blocks made the "
        f"identity: {rest_ms:.3f} ms against {main['step_ms_median']:.3f}; "
        f"the sLSTM loop's share of the step {share:.4f}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vs = _train_vs_cpu(torch, dev, XLSTM, "families", num_layers=2,
                           dtype="float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"main": main, "without_slstm_ms": rest_ms, "slstm_share": share,
            "card_vs_cpu": vs}


def _family_vs_cpu(torch, dev, arch, dtype, prompt, **changes):
    """(f) `arch` at full width and few layers, the same weights and
    tokens on the card and the CPU: prefill and 4 decode steps (the
    card's greedy tokens fed to both); bf16 within ATTN_TOL of the row's
    scale where the kernel is on the path, f32 (TF32 off) within
    F32_LOGIT_TOL where it is not."""
    from repro_torch.kernels import ops

    spec, cfg, cpu = family_model(torch, "cpu", arch,
                                  generator=torch.Generator().manual_seed(
                                      SEED), dtype=dtype, **changes)
    card = spec.model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    host = {"tokens": prompts(cfg, 2, prompt)}
    if cfg.family == "encdec":
        host["frames"] = whisper_frames(cfg, 2)
    tol = F32_LOGIT_TOL if dtype == "float32" else ATTN_TOL
    out = {"steps": []}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ops.reset_launch_counts()
        lc, cc = spec.prefill(card, {k: torch.from_numpy(v).to(dev)
                                     for k, v in host.items()}, cfg)
        out["launches"] = ops.launch_counts()
        lh, ch = spec.prefill(cpu, {k: torch.from_numpy(v)
                                    for k, v in host.items()}, cfg)
        tag = f"{arch} {cfg.num_layers} layers {dtype} card vs CPU"
        out["steps"].append(_logits_agree(torch, f"{tag}, prefill", lc, lh,
                                          tol, cfg.vocab_size))
        tok = torch.argmax(lc[:, -1], dim=-1)[:, None].to(torch.int32)
        for i in range(4):
            lc, cc = spec.decode_step(card, cc, tok, cfg)
            lh, ch = spec.decode_step(cpu, ch, tok.cpu(), cfg)
            out["steps"].append(_logits_agree(
                torch, f"{tag}, decode step {i + 1}", lc, lh, tol,
                cfg.vocab_size))
            tok = torch.argmax(lc[:, -1], dim=-1)[:, None].to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[families] {arch} card vs CPU: prefill launches "
        f"{out['launches']}")
    del card, cc
    torch.cuda.empty_cache()
    return out


def phase_families(torch, dev, results):
    """The hybrid, SSM and encoder-decoder families, each model freed
    before the next is built: (a) flash_attention at D = 80; (b), (c)
    zamba2 served (configuration 13) and trained (14); (d) xlstm-125m
    served (15) and trained (16); (e) whisper-small served (17) and
    trained (18); (f) card vs CPU for each; (g) the state handoff of
    zamba2 and xlstm (after (b) and (d))."""
    out = {"attention_d80": _attention_d80(torch, dev, results)}

    spec, cfg, model = family_model(torch, dev, ZAMBA)
    log(f"[families] zamba2-2.7b at full width and depth: "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    out["zamba_serve"] = serve_run(
        torch, dev, spec, cfg, model, SERVE_BATCH, PROMPT, "families",
        "zamba2-2.7b ", want_fa=cfg.num_layers // cfg.attn_every)
    del model
    torch.cuda.empty_cache()
    # bf16 (the kernel's dtype) at 2 mamba layers and one shared block:
    # the gap that bf16 rounding alone leaves between the chunked prefill
    # and the step recurrence grows with depth (1.55e-2-1.69e-2 of the
    # row's scale at 6 layers, against ATTN_TOL)
    out["zamba_handoff"] = _handoff(torch, dev, ZAMBA, "bfloat16", ATTN_TOL,
                                    num_layers=2, attn_every=2)
    out["zamba_train"] = _zamba_train(torch, dev)

    spec, cfg, model = family_model(torch, dev, XLSTM)
    out["xlstm_serve"] = serve_run(
        torch, dev, spec, cfg, model, SERVE_BATCH, PROMPT, "families",
        "xlstm-125m ", want_fa=0, profile_prefill=False)
    del model
    torch.cuda.empty_cache()
    out["xlstm_handoff"] = _handoff(torch, dev, XLSTM, "float32",
                                    XLSTM_HANDOFF_TOL)
    out["xlstm_train"] = _xlstm_train(torch, dev)

    spec, cfg, model = family_model(torch, dev, WHISPER)
    frames = whisper_frames(cfg, SERVE_BATCH)
    out["whisper_serve"] = serve_run(
        torch, dev, spec, cfg, model, SERVE_BATCH, WHISPER_PROMPT,
        "families", "whisper-small ",
        want_fa=3 * cfg.num_layers, frames=frames)
    tokens = torch.from_numpy(prompts(cfg, SERVE_BATCH, WHISPER_PROMPT)).to(
        dev)
    enc, dec, cross = _whisper_qkv(torch, model, cfg, tokens,
                                   torch.from_numpy(frames).to(dev))
    del model
    torch.cuda.empty_cache()
    out["attention_whisper"] = {
        "encoder": _attn_timed(torch, "whisper's encoder (8, 1500)", *enc,
                               False),
        "decoder": _attn_timed(torch, "whisper's decoder (8, 416)", *dec,
                               True),
        "cross": _attn_timed(torch, "whisper's cross (416 x 1500)", *cross,
                             False)}
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"],
        *(e["max_abs_err"] for e in out["attention_whisper"].values()))
    del enc, dec, cross
    torch.cuda.empty_cache()
    out["whisper_train"] = _train_main(torch, dev, WHISPER, 12, "families",
                                       FAM_TRAIN_BATCH, FAM_TRAIN_SEQ)

    out["card_vs_cpu"] = {
        ZAMBA: _family_vs_cpu(torch, dev, ZAMBA, "bfloat16", 256,
                              num_layers=2, attn_every=2),
        XLSTM: _family_vs_cpu(torch, dev, XLSTM, "float32", 256,
                              num_layers=2),
        WHISPER: _family_vs_cpu(torch, dev, WHISPER, "bfloat16", 64,
                                num_layers=2, encoder_layers=2)}
    return out

DIST_CHUNKS = 4                # CP chunks of yi-6b's attention on one card
DIST_LAUNCH_STEPS = 3
# per-rank bytes of yi-6b's whole train state (f32 params, adamw's
# moments) at full depth, from the reference's rules (arithmetic)
DIST_STATE_BYTES = {(4, 1): 18_185_502_728, (8, 1): 9_094_348_808,
                    (2, 4): 9_094_348_808}


def _nccl_one_rank(torch, name):
    """The default group as an NCCL group of one rank (file store)."""
    import torch.distributed as dist

    store = ROOT / "results" / name
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))


def _same_params(torch, state, want):
    """Leaves of `state`'s params whose bits differ from `want`'s (CPU)."""
    with torch.no_grad():
        return [n for n, p in state["params"].named_parameters()
                if not torch.equal(p.detach().cpu(), want[n])]


def keep_params(holder):
    """A `_train_main` keep: the state's params, on the CPU, into
    `holder["params"]`."""
    def keep(state):
        holder["params"] = {n: p.detach().cpu()
                            for n, p in state["params"].named_parameters()}
    return keep


def _dist_runs(torch, dev, mesh, plain):
    """(1): configuration 9 through the mesh trainer on `mesh` (an NCCL
    group of one rank) against the one-card trainer's run of phase 13 (a)
    in this call (`plain`: its result and final params): losses and final
    params bit for bit; each run's step ms, tokens/s, model TFLOP/s, peak
    memory and idle share."""
    diff = []
    runs = {"plain": plain["run"]}
    runs["mesh"] = _train_main(
        torch, dev, phase="distribution mesh", mesh=mesh,
        keep=lambda state: diff.extend(_same_params(torch, state,
                                                    plain["params"])))
    same_loss = runs["mesh"]["losses"] == runs["plain"]["losses"]
    log(f"[distribution] mesh (data 1, model 1) against no mesh: losses "
        f"bit-identical {same_loss}; params leaves that differ "
        f"{len(diff)} of {len(plain['params'])} {diff[:4]}")
    require(same_loss and not diff,
            "the world-1 mesh trainer is not the one-card trainer bit for "
            "bit")
    runs["mesh"]["params_bit_identical"] = not diff
    for tag, r in runs.items():
        log(f"[distribution] {tag}: step ms median {r['step_ms_median']:.3f}"
            f", {r['tokens_per_s']:.1f} tokens/s, {r['model_tflops']:.2f} "
            f"model TFLOP/s, peak {r['max_memory_allocated'] / 2 ** 30:.3f} "
            f"GiB, idle share {r['profile']['idle_share']:.3f}")
    ratio = runs["mesh"]["step_ms_median"] / runs["plain"]["step_ms_median"]
    log(f"[distribution] the mesh's median step is {ratio:.4f}x the one "
        f"card's")
    return runs


def _dist_cp(torch, dev):
    """(2): context-parallel attention at C = 4 chunks of yi-6b's
    attention shape on one card against blocked_causal_attention: the
    output, each element within ATTN_TOL of (1 + |blocked|), and dq, dk,
    dv of sum(out * g) within ATTN_TOL of their largest |blocked|; the
    forwards timed (CUDA events)."""
    from repro_torch.models import layers

    _, cfg = train_config(TRAIN_LAYERS)
    b, s, h = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, g = draw(b, s, h, hd), draw(b, s, kh, hd), draw(b, s, kh, hd), \
        draw(b, s, h, hd)
    n = s // DIST_CHUNKS

    def chunked(q, k, v):
        return torch.cat([layers.cp_attention_chunk(
            q[:, c * n:(c + 1) * n], k, v, c, DIST_CHUNKS)
            for c in range(DIST_CHUNKS)], dim=1)

    def blocked(q, k, v):
        return layers.blocked_causal_attention(q, k, v)

    res = {}
    outs, grads = {}, {}
    for tag, fn in (("cp", chunked), ("blocked", blocked)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        grads[tag] = torch.autograd.grad(out, leaves, g)
        outs[tag] = out.detach()
        del out, leaves
        with torch.no_grad():
            res[f"{tag}_forward_ms"] = events_ms(torch, lambda: fn(q, k, v),
                                                 iters=5)
    for name, got, want in [("out", outs["cp"], outs["blocked"])] + [
            (f"d{x}", a, w) for x, a, w in zip("qkv", grads["cp"],
                                               grads["blocked"],
                                               strict=True)]:
        d = (got.float() - want.float()).abs()
        # the output elementwise against 1 + |blocked|; a gradient (a sum
        # over 4,096 rows, rounded to bf16 as each path accumulates it)
        # against its tensor's scale
        scale = 1 + want.float().abs() if name == "out" else \
            want.float().abs().max()
        worst = float((d / scale).max())
        res[f"{name}_max_abs"] = float(d.max())
        res[f"{name}_worst_rel"] = worst
        require(worst <= ATTN_TOL, f"cp {name}: {worst} > {ATTN_TOL}")
    log(f"[distribution] cp at C = {DIST_CHUNKS} chunks on one card, "
        f"({b}, {s}), {h} heads over {kh}, D = {hd}, bf16, causal, against "
        f"blocked_causal_attention: max|d| out {res['out_max_abs']:.3e}, dq "
        f"{res['dq_max_abs']:.3e}, dk {res['dk_max_abs']:.3e}, dv "
        f"{res['dv_max_abs']:.3e} (out within {ATTN_TOL} of 1 + |blocked| "
        f"elementwise, a gradient of its largest |blocked|; worst "
        f"{max(res[k] for k in res if k.endswith('_worst_rel')):.3e}); "
        f"forward {res['cp_forward_ms']:.3f} ms (cp) against "
        f"{res['blocked_forward_ms']:.3f} ms (blocked)")
    del q, k, v, g, outs, grads
    torch.cuda.empty_cache()
    return res


def _quantize_scalar_divisor(torch, g):
    """`compression.quantize` of g (zero-padded to whole blocks) as it was
    before C33's repair: the scale divided by the Python scalar 127.0."""
    from repro_torch.optim import compression

    flat = torch.nn.functional.pad(g.reshape(-1).float(),
                                   (0, (-g.numel()) % compression.BLOCK))
    xb = flat.reshape(-1, compression.BLOCK)
    scale = torch.clamp(torch.amax(torch.abs(xb), dim=1, keepdim=True)
                        / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _dist_compress(torch, dev, mesh):
    """(3): compress_codes of configuration 9's first-step gradient
    leaves on the card against the same leaves on the CPU, bit for bit;
    compress_psum of one leaf through the NCCL group (one pod: the mean
    of one pod's dequantized codes) and wire_bytes."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.optim import compression
    from repro_torch.train import trainer

    spec, cfg = train_config(TRAIN_LAYERS)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, optimizer="adamw")
    pc = ParallelConfig()
    state = _train_state(torch, spec, cfg, tc, pc, dev)
    batch = next(iter(_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)))
    names, params = zip(*state["params"].named_parameters(), strict=True)
    loss, _ = trainer.make_loss_fn(spec, cfg, pc)(state["params"], batch)
    grads = torch.autograd.grad(loss, params)
    t = time.perf_counter()
    differ, before = [], []
    for name, gr in zip(names, grads, strict=True):
        q, sc, _ = compression.compress_codes(gr, torch.zeros_like(gr))
        cq, cs, _ = compression.compress_codes(gr.cpu(),
                                               torch.zeros(gr.shape))
        if not (torch.equal(q.cpu(), cq) and torch.equal(
                sc.cpu().view(torch.int32), cs.view(torch.int32))):
            differ.append(name)
        # C33's fault, kept here to count it: the scale divided by the
        # Python scalar 127.0 (on CUDA a product with its reciprocal)
        bq, bs = _quantize_scalar_divisor(torch, gr)
        cbq, cbs = _quantize_scalar_divisor(torch, gr.cpu())
        if not (torch.equal(bq.cpu(), cbq) and torch.equal(
                bs.cpu().view(torch.int32), cbs.view(torch.int32))):
            before.append(name)
    check_s = time.perf_counter() - t
    g0 = grads[names.index("layers.0.attn.wq")]
    g_hat, err = compression.compress_psum(g0, torch.zeros_like(g0),
                                           mesh.get_group("data"))
    q0, s0, _ = compression.compress_codes(g0, torch.zeros_like(g0))
    one_pod = torch.equal(g_hat, compression.dequantize(
        q0, s0, g0.numel()).reshape(g0.shape))
    raw, comp = compression.wire_bytes(dict(zip(names, params,
                                                strict=True)))
    log(f"[distribution] compress_codes of configuration 9's first-step "
        f"gradients, {len(names)} leaves "
        f"({sum(p.numel() for p in params)} values): card vs CPU codes and "
        f"scales bit-identical in {len(names) - len(differ)} of "
        f"{len(names)} {differ[:4]}; with the scale divided by the "
        f"Python scalar 127.0 (C33's fault) {len(names) - len(before)} of "
        f"{len(names)} ({check_s:.1f} s); compress_psum of "
        f"layers.0.attn.wq through the NCCL group of one rank == its "
        f"dequantized codes {one_pod}; wire_bytes a cross-pod reduction: "
        f"{raw} B f32, {comp} B int8 + scales ({raw / comp:.3f}x)")
    require(not differ and one_pod, "compression on the card differs")
    del state, grads, g0, g_hat, err, loss, batch
    torch.cuda.empty_cache()
    return {"leaves": len(names), "bit_identical": not differ,
            "leaves_differing_with_scalar_divisor": len(before),
            "one_pod_psum_exact": one_pod, "wire_bytes_f32": raw,
            "wire_bytes_int8": comp, "check_s": check_s}


def _dist_launch(torch):
    """(4): launch.train --arch yi-6b --smoke for 3 steps under torchrun
    --nproc-per-node 1 (an NCCL mesh of one rank) and as one process: the
    same losses and params_md5."""
    import os

    argv = ["-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
            "--steps", str(DIST_LAUNCH_STEPS), "--log-every", "0",
            "--no-preemption-guard"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = {}
    for tag, cmd in (("torchrun", [sys.executable, "-m",
                                   "torch.distributed.run", "--standalone",
                                   "--nproc-per-node", "1"] + argv),
                     ("one process", [sys.executable] + argv)):
        t = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=400, cwd=ROOT)
        require(proc.returncode == 0,
                f"launch.train ({tag}) failed: {proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        out[tag] = dict(json.loads(line[-1]), wall_s=time.perf_counter() - t)
        log(f"[distribution] launch.train --arch {ARCH} --smoke "
            f"({DIST_LAUNCH_STEPS} steps) {tag}: losses "
            f"{out[tag]['losses']}, params_md5 {out[tag]['params_md5']} "
            f"({out[tag]['wall_s']:.1f} s)")
    same = out["torchrun"]["params_md5"] == out["one process"]["params_md5"] \
        and out["torchrun"]["losses"] == out["one process"]["losses"]
    require(same, "launch.train under torchrun differs from one process")
    return out


def _dist_state_bytes():
    """(5): per-rank bytes of yi-6b's train state at full depth from the
    port's state_defs and rules (arithmetic, no card)."""
    from repro_torch import sharding as shd
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.train import trainer

    spec = registry.get_spec(ARCH)
    defs = trainer.state_defs(spec, spec.cfg, TrainConfig(optimizer="adamw"),
                              ParallelConfig())
    got = {f"{d}x{m}": shd.tree_nbytes(defs, {"data": d, "model": m})
           for d, m in DIST_STATE_BYTES}
    log(f"[distribution] arithmetic, not a card number: {ARCH}'s whole "
        f"train state {shd.tree_nbytes(defs)} B; a rank's blocks at "
        f"(data, model) {got}")
    require(list(got.values()) == list(DIST_STATE_BYTES.values()),
            f"state bytes {got}")
    return got


def phase_distribution(torch, dev, smi, plain):
    """16. the dense trainer over a mesh (the Distribution slice), on an
    NCCL group of one rank; every number from this card (`smi`, printed
    first)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    log(f"[distribution] {smi}")
    t0 = time.perf_counter()
    _nccl_one_rank(torch, "nccl_store_dist")
    try:
        mesh = make_host_mesh(1, 1)
        out = {"runs": _dist_runs(torch, dev, mesh, plain)}
        out["cp"] = _dist_cp(torch, dev)
        out["compress"] = _dist_compress(torch, dev, mesh)
    finally:
        dist.destroy_process_group()
    out["launch"] = _dist_launch(torch)
    out["state_bytes"] = _dist_state_bytes()
    out["seconds"] = time.perf_counter() - t0
    log(f"[distribution] phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 17. model_parallel: every family's blocks over `model`, configuration 20
# ---------------------------------------------------------------------------

MP_TOL = ATTN_TOL        # bf16 blocks: max|d| over the one-card's largest
MP_ITERS = 2             # device ms: the mean of 2 traced calls
MOE_TOKENS = (4, 4096)   # phi3.5-moe's expert-split FFN, group 512
FAM_TOKENS = {ZAMBA: (4, 4096), XLSTM: (16, 1024)}
WHISPER_ENC, WHISPER_DEC = (8, ENC_FRAMES), (8, WHISPER_PROMPT)


def _mp_layout(torch, arch, cfg, mesh):
    """The TP of `mesh`'s `model` dim (a group of one rank), from the
    layout of `cfg`'s model over it."""
    from repro_torch.core.fsdp import ParamLayout
    from repro_torch.models import parallel as par, registry

    return par.TP(ParamLayout(registry.get_spec(arch), cfg, mesh))


def _block_params(torch, dev, defs, cfg, cls=None):
    """A block's training leaves (f32 masters that require grad) of
    `defs` at full width, drawn from a generator on `dev` seeded SEED."""
    from repro_torch.models import common, transformer

    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = cls(cfg, dev, True) if cls else transformer.Params(defs, cfg, dev,
                                                            True)
    return common.init_params(p, gen)


def _fwd_bwd(torch, fn, inputs, leaves, g):
    """out = fn(*inputs) and the gradients of sum(out * g) with respect to
    the float inputs and every leaf."""
    ins = [t.detach().clone().requires_grad_(t.is_floating_point())
           for t in inputs]
    out = fn(*ins)
    wrt = [t for t in ins if t.requires_grad] + leaves
    grads = torch.autograd.grad(out.float().mul(g).sum(), wrt)
    return out.detach(), grads


def _mp_compare(torch, tag, one, tp, inputs, leaves, names,
                iters=MP_ITERS):
    """`one` (the one-card block) and `tp` (the block over `model`) on the
    same inputs, forward and backward: max|d| of the output and of each
    gradient over the one-card's largest |value| (within MP_TOL), whether
    they are bit-identical, and each one's device ms of a forward and
    backward (profiler, `iters` calls)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=inputs[0].device).manual_seed(SEED + 1)
    g = torch.randn(inputs[0].shape, generator=gen, device=inputs[0].device)
    want, wg = _fwd_bwd(torch, one, inputs, leaves, g)
    got, gg = _fwd_bwd(torch, tp, inputs, leaves, g)
    rows, worst, same = {}, 0.0, True
    for name, a, b in [("out", got, want)] + list(zip(names, gg, wg,
                                                      strict=True)):
        d = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max()) or 1.0
        rows[name] = d
        worst = max(worst, d / scale)
        same = same and torch.equal(a, b)
    ms = {}
    for which, fn in (("one_card", one), ("model", tp)):
        def call(fn=fn):
            _fwd_bwd(torch, fn, inputs, leaves, g)
        ms[which] = sum(device_times(torch, call, iters=iters).values())
    log(f"[model_parallel] {tag}: max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in rows.items())
        + f"; worst {worst:.3e} of the one-card's scale (tol {MP_TOL}); "
        f"bit-identical {same}; forward+backward device ms "
        f"{ms['one_card']:.3f} (one card) vs {ms['model']:.3f} (over "
        f"`model`); {time.perf_counter() - t0:.1f} s")
    require(worst <= MP_TOL, f"{tag}: the block over `model` disagrees "
            f"with the one-card block ({worst} > {MP_TOL})")
    del want, got, wg, gg
    torch.cuda.empty_cache()
    return {"max_abs": rows, "worst_rel": worst, "bit_identical": same,
            "device_ms": ms, "seconds": time.perf_counter() - t0}


def _leaves(p):
    names, params = zip(*p.named_parameters(), strict=True)
    return list(params), list(names)


def _mp_moe(torch, dev, mesh):
    """phi3.5-moe's expert-split FFN (16 experts of 4,096 x 6,400, top-2,
    group 512) on 4 x 4,096 bf16 tokens against `moe_block`; the kept and
    dropped pairs equal."""
    from repro_torch.models import moe, parallel as par

    _, cfg = train_config(1, PHI)
    tp = _mp_layout(torch, PHI, cfg, mesh)
    p = _block_params(torch, dev, moe.moe_defs(cfg), cfg)
    leaves, names = _leaves(p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(*MOE_TOKENS, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    require(cfg.num_experts % tp.size == 0, "the experts do not split")
    with torch.no_grad():
        r1 = moe.route(p, x, cfg, moe.GROUP_SIZE)
        rt = moe.route_exchanged(p, x, cfg, moe.GROUP_SIZE,
                                 par.moe_exchange(tp.layout, True,
                                                  x.shape[1]))
        drop1, dropt = int((~r1.keep).sum()), int((~rt.keep).sum())
        same_pairs = torch.equal(r1.keep.reshape(-1), rt.keep.reshape(-1)) \
            and torch.equal(r1.pos.reshape(-1), rt.pos.reshape(-1))
    log(f"[model_parallel] phi3.5-moe expert-split FFN, {MOE_TOKENS[0]} x "
        f"{MOE_TOKENS[1]} tokens: dropped (token, slot) pairs {dropt} (over "
        f"`model`) and {drop1} (one card) of {r1.keep.numel()}; positions "
        f"and kept pairs equal {same_pairs}")
    require(same_pairs and drop1 == dropt, "the dropped pairs differ")
    out = _mp_compare(
        torch, "phi3.5-moe expert-split MoE FFN",
        lambda x: moe.moe_block(p, x, cfg, moe.GROUP_SIZE)[0],
        lambda x: par.tp_moe_ffn(p, x, cfg, tp, moe.GROUP_SIZE)[0],
        [x], leaves, ["dx"] + names)
    out["dropped"] = {"model": dropt, "one_card": drop1,
                      "pairs": r1.keep.numel()}
    del p, leaves, x
    return out


def _mp_zamba(torch, dev, mesh):
    """One zamba2 Mamba2 layer (80 heads) and its shared block (32 heads
    of 80) at 4 x 4,096 bf16."""
    from repro_torch.models import mamba, parallel as par, transformer

    spec, cfg = train_config(6, ZAMBA)
    tp = _mp_layout(torch, ZAMBA, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn(*FAM_TOKENS[ZAMBA], cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    out = {}
    lp = _block_params(torch, dev, None, cfg, mamba.MambaLayer)
    leaves, names = _leaves(lp)
    out["mamba2"] = _mp_compare(
        torch, f"zamba2 Mamba2 layer ({mamba._dims(cfg)[1]} heads)",
        lambda x: mamba.mamba_block(lp, x, cfg),
        lambda x: mamba.tp_mamba_block(lp, x, cfg, tp),
        [x], leaves, ["dx"] + names)
    del lp, leaves
    sp = _block_params(torch, dev, mamba._shared_defs(cfg), cfg)
    leaves, names = _leaves(sp)
    tables = transformer.rope_tables(torch.arange(
        x.shape[1], dtype=torch.int32, device=dev), cfg)
    out["shared"] = _mp_compare(
        torch, f"zamba2 shared block ({cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim})",
        lambda x: mamba._shared_block(sp, x, cfg, tables),
        lambda x: par.tp_decoder_layer(sp, x, cfg, tables, tp)[0],
        [x], leaves, ["dx"] + names)
    del sp, leaves, x
    return out


def _mp_xlstm(torch, dev, mesh):
    """xlstm-125m's mLSTM and sLSTM blocks at 16 x 1,024 bf16."""
    from repro_torch.models import xlstm

    _, cfg = train_config(2, XLSTM)
    tp = _mp_layout(torch, XLSTM, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn(*FAM_TOKENS[XLSTM], cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    out = {}
    for kind, cls, one, par_fn in (
            ("mlstm", xlstm.MLSTMBlock, xlstm.mlstm_block,
             xlstm.tp_mlstm_block),
            ("slstm", xlstm.SLSTMBlock, xlstm.slstm_block,
             xlstm.tp_slstm_block)):
        bp = _block_params(torch, dev, None, cfg, cls)
        leaves, names = _leaves(bp)
        # the sLSTM's 1,024-step loop is host-bound and slow to trace:
        # one traced call each
        out[kind] = _mp_compare(
            torch, f"xlstm-125m {kind} block",
            lambda x, bp=bp, one=one: one(bp, x, cfg),
            lambda x, bp=bp, fn=par_fn: fn(bp, x, cfg, tp),
            [x], leaves, ["dx"] + names, 1 if kind == "slstm" else MP_ITERS)
        del bp, leaves
    return out


def _mp_whisper(torch, dev, mesh):
    """whisper-small's encoder layer (8 x 1,500) and decoder layer (8 x
    416, cross-attention over 1,500 encoded frames), bf16."""
    from repro_torch.models import encdec

    _, cfg = train_config(1, WHISPER)
    tp = _mp_layout(torch, WHISPER, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    xe = torch.randn(*WHISPER_ENC, cfg.d_model, generator=gen,
                     device=dev).to(torch.bfloat16)
    xd = torch.randn(*WHISPER_DEC, cfg.d_model, generator=gen,
                     device=dev).to(torch.bfloat16)
    out = {}
    lp = _block_params(torch, dev, encdec._enc_defs(cfg), cfg)
    leaves, names = _leaves(lp)
    out["encoder"] = _mp_compare(
        torch, "whisper-small encoder layer",
        lambda x: encdec._encoder_layer(lp, x, cfg),
        lambda x: encdec._tp_encoder_layer(lp, x, cfg, tp, "auto"),
        [xe], leaves, ["dx"] + names)
    del lp, leaves
    lp = _block_params(torch, dev, encdec._dec_defs(cfg), cfg)
    leaves, names = _leaves(lp)
    out["decoder"] = _mp_compare(
        torch, "whisper-small decoder layer (cross-attention)",
        lambda x, e: encdec._decoder_layer(lp, x, e, cfg),
        lambda x, e: encdec._tp_decoder_layer(lp, x, e, tp.seq_gather(e),
                                              cfg, tp, "auto"),
        [xd, xe], leaves, ["dx", "denc"] + names)
    del lp, leaves, xe, xd
    return out


def _mp_config20(torch, dev, mesh, plain):
    """(b) configuration 20: configuration 11 (phi3.5-moe at the depth
    phase 14 trained) through the mesh trainer on `mesh`, the MoE routing
    over the mesh's ranks engaged, against phase 14's one-card run in
    this call (`plain`: its result and final params): losses and final
    params bit for bit; both runs' step ms, tokens/s, model TFLOP/s, peak
    memory and idle share."""
    diff = []
    runs = {"plain": plain["run"]}
    runs["mesh"] = _train_main(
        torch, dev, PHI, plain["run"]["layers"], "model_parallel mesh",
        mesh=mesh, keep=lambda state: diff.extend(
            _same_params(torch, state, plain["params"])))
    same_loss = runs["mesh"]["losses"] == runs["plain"]["losses"]
    same_aux = [m["aux"] for m in runs["mesh"]["metrics"]] == \
        [m["aux"] for m in runs["plain"]["metrics"]]
    log(f"[model_parallel] configuration 20 (mesh (data 1, model 1)) "
        f"against configuration 11 (no mesh): losses bit-identical "
        f"{same_loss}, aux {same_aux}; params leaves that differ "
        f"{len(diff)} of {len(plain['params'])} {diff[:4]}")
    require(same_loss and same_aux and not diff,
            "configuration 20 is not configuration 11 bit for bit")
    runs["mesh"]["params_bit_identical"] = not diff
    for tag, r in runs.items():
        log(f"[model_parallel] {tag}: step ms median "
            f"{r['step_ms_median']:.3f}, {r['tokens_per_s']:.1f} tokens/s, "
            f"{r['model_tflops']:.2f} model TFLOP/s, peak "
            f"{r['max_memory_allocated'] / 2 ** 30:.3f} GiB, idle share "
            f"{r['profile']['idle_share']:.3f}")
    ratio = runs["mesh"]["step_ms_median"] / runs["plain"]["step_ms_median"]
    log(f"[model_parallel] the mesh's median step is {ratio:.4f}x the one "
        f"card's")
    return runs


def phase_model_parallel(torch, dev, smi, plain):
    """17. every family's blocks over `model` and configuration 20, on an
    NCCL group of one rank; every number from this card (`smi`)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    log(f"[model_parallel] {smi}")
    t0 = time.perf_counter()
    _nccl_one_rank(torch, "nccl_store_mp")
    try:
        mesh = make_host_mesh(1, 1)
        ops.reset_launch_counts()
        out = {"moe": _mp_moe(torch, dev, mesh),
               "zamba2": _mp_zamba(torch, dev, mesh),
               "xlstm": _mp_xlstm(torch, dev, mesh),
               "whisper": _mp_whisper(torch, dev, mesh)}
        counts = ops.launch_counts()
        require(sum(counts.values()) == 0,
                f"the blocks launched {counts}: training reaches no kernel")
        t = time.perf_counter()
        out["runs"] = _mp_config20(torch, dev, mesh, plain)
        log(f"[model_parallel] the blocks took {t - t0:.1f} s, "
            f"configuration 20 {time.perf_counter() - t:.1f} s")
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"[model_parallel] phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 18. serve_mesh: dense serving over a mesh of ranks (every family)
# ---------------------------------------------------------------------------

SM_STEPS = 8             # (b): decode steps of each family's comparison
SM_FAMILIES = (          # (b): arch, batch, prompt, config changes
    (PHI, 8, 4096, {"num_layers": 2}),
    (MIXTRAL, MIXTRAL_BATCH, MIXTRAL_PROMPT, {"num_layers": 2}),
    (ZAMBA, 8, 4096, {"num_layers": 2, "attn_every": 2}),
    (XLSTM, 8, 4096, {"num_layers": 2, "dtype": "float32"}),
    (WHISPER, 8, WHISPER_PROMPT, {"num_layers": 2, "encoder_layers": 2}),
)
SM_RANK_HEADS = 4        # (c): yi-6b's heads and KV heads over model 4


def _rel_gap(torch, got, want, vocab):
    """max|got - want| over the last position's real vocab, and that over
    the row's largest |want|; whether the two are bit-identical."""
    got = got.float().cpu()[:, -1, :vocab]
    want = want.float().cpu()[:, -1, :vocab]
    d = (got - want).abs()
    scale = want.abs().amax(dim=-1)
    return float(d.max()), float((d.amax(-1) / scale).max()), \
        bool(torch.equal(got, want))


def _sm_model(torch, spec, cfg, mesh, dev, whole):
    """The serving model's blocks over `mesh` (a group of one rank: the
    whole leaves, copied), cut from `whole` {name: tensor}."""
    from repro_torch.train import trainer

    return trainer.sharded_model(spec, cfg, mesh, dev,
                                 lambda name, shape: whole[name],
                                 train=False)


def _sm_config3(torch, dev, mesh, spec, cfg, held, served):
    """(a) configuration 3 (yi-6b at full width and depth, 8 x 4096, 32
    steps) through the mesh path on phase 11's model and prompts: the
    tokens phase 11's, the prefill's and first decode step's logits
    against the one-card path's, flash_attention 32 launches all in the
    prefill; prefill ms, decode ms a step, peak memory and a profiled
    decode window's idle share beside phase 11's."""
    from repro_torch.kernels import ops
    from repro_torch.models import parallel
    from repro_torch.train import serve

    model = held["model"]
    host = {"tokens": prompts(cfg, SERVE_BATCH, PROMPT)}
    placed = {"tokens": torch.from_numpy(host["tokens"]).to(dev)}
    with torch.inference_mode():
        lp, cache = spec.prefill(model, placed, cfg)
        tok0 = torch.argmax(lp[:, -1], dim=-1)[:, None].to(torch.int32)
        ld, _ = spec.decode_step(model, cache, tok0, cfg)
        want = (lp.cpu(), ld.cpu())
        del cache, lp, ld
    t = time.perf_counter()
    smodel = _sm_model(torch, spec, cfg, mesh, dev,
                       dict(model.named_parameters()))
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t
    held.clear()                 # the one-card model, now unused
    del model
    torch.cuda.empty_cache()
    serve.greedy_decode(spec, cfg, smodel, host, 2, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    toks = serve.greedy_decode(spec, cfg, smodel, host, DECODE_STEPS,
                               device=dev, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    same = toks.cpu().tolist() == served["tokens"]
    log(f"[serve_mesh] (a) configuration 3 through the mesh path (data 1, "
        f"model 1): greedy_decode {SERVE_BATCH} x {PROMPT}, {DECODE_STEPS} "
        f"steps in {wall:.4f} s; launches {counts}; tokens equal phase "
        f"11's {same}; max_memory_allocated {peak / 2 ** 30:.3f} GiB "
        f"(phase 11: {served['max_memory_allocated'] / 2 ** 30:.3f}); the "
        f"blocks copied in {copy_s:.2f} s")
    require(counts["flash_attention"] == cfg.num_layers
            and sum(counts.values()) == cfg.num_layers,
            f"the mesh path launched {counts}: expected flash_attention "
            f"{cfg.num_layers} times, all in the prefill")
    require(same, "the mesh path's tokens are not phase 11's")

    view = parallel.ShardedView(smodel, smodel.layout)
    sm = parallel.ServeMesh(smodel.layout, SERVE_BATCH)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = spec.mesh_prefill(view, placed, cfg, sm)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    pre_counts = ops.launch_counts()
    require(pre_counts["flash_attention"] == cfg.num_layers,
            f"the mesh prefill launched {pre_counts}")
    tok = parallel.next_token(logits, cfg, sm.tp)
    gaps = {"prefill": _rel_gap(torch, logits, want[0], cfg.vocab_size)}
    ops.reset_launch_counts()
    step_ms = []
    for i in range(16):
        t = time.perf_counter()
        logits, cache = spec.mesh_decode_step(view, cache, tok, cfg, sm)
        tok = parallel.next_token(logits, cfg, sm.tp)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            gaps["decode step 1"] = _rel_gap(torch, logits, want[1],
                                             cfg.vocab_size)
    dec_counts = ops.launch_counts()
    require(sum(dec_counts.values()) == 0,
            f"the mesh decode steps launched {dec_counts}")
    for tag, (d, rel, bits) in gaps.items():
        log(f"[serve_mesh] (a) {tag} logits, mesh vs one card: max|d| "
            f"{d:.4e}, {rel:.4e} of the row's max|logit| (tol {ATTN_TOL}); "
            f"bit-identical {bits}")
        require(rel <= ATTN_TOL, f"(a) the mesh path's {tag} logits "
                f"disagree with the one-card path's")
    step_med = statistics.median(step_ms)

    def step():
        spec.mesh_decode_step(view, cache, tok, cfg, sm)

    prof = profile_window(torch, step, 8, "serve_mesh decode step")
    out = {"tokens_equal": same, "launches": counts,
           "prefill_launches": pre_counts, "greedy_s": wall,
           "prefill_ms": prefill_ms, "decode_ms_median": step_med,
           "decode_ms": step_ms, "max_memory_allocated": peak,
           "decode_profile": prof, "copy_s": copy_s,
           "logit_gaps": {k: {"max_abs": v[0], "max_rel": v[1],
                              "bit_identical": v[2]}
                          for k, v in gaps.items()}}
    for key, one in (("prefill_ms", served["prefill_ms"]),
                     ("decode_ms_median", served["decode_ms_median"])):
        log(f"[serve_mesh] (a) {key}: mesh {out[key]:.3f}, one card "
            f"{one:.3f} ({out[key] / one:.4f}x)")
    log(f"[serve_mesh] (a) decode idle share: mesh {prof['idle_share']:.3f}"
        f", one card {served['decode_profile']['idle_share']:.3f}; decode "
        f"step median {step_med:.4f} ms over 16 (min {min(step_ms):.4f}, "
        f"max {max(step_ms):.4f})")
    del smodel, view, cache, logits
    torch.cuda.empty_cache()
    return out


def _sm_drops(torch):
    """Patch the routers of both paths (`moe.route`, one card;
    `moe.route_exchanged`, the mesh) to count the dropped (token, slot)
    pairs on the device; returns (counts list, undo)."""
    from repro_torch.models import moe

    seen = []
    real = (moe.route, moe.route_exchanged)

    def wrap(fn):
        def counting(*args, **kwargs):
            r = fn(*args, **kwargs)
            seen.append((~r.keep).sum())
            return r
        return counting

    moe.route, moe.route_exchanged = (wrap(f) for f in real)

    def undo():
        moe.route, moe.route_exchanged = real
    return seen, undo


def _sm_loop(torch, prefill, decode, next_tok, steps):
    """prefill, then `steps` - 1 decode steps, each timed (device
    synchronized): (tokens (b, steps), each call's logits on the CPU,
    prefill ms, decode ms a step)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill()
    tok = next_tok(logits)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t) * 1e3
    out, all_logits, ms = [tok], [logits.cpu()], []
    for _ in range(steps - 1):
        t = time.perf_counter()
        logits, cache = decode(cache, tok)
        tok = next_tok(logits)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        out.append(tok)
        all_logits.append(logits.cpu())
    return torch.cat(out, dim=1).cpu(), all_logits, pre_ms, \
        statistics.median(ms)


def _sm_family(torch, dev, mesh, arch, batch, prompt, changes):
    """(b) `arch` at full width cut as `changes` say, the mesh path
    against the one-card path on the same weights and prompts: tokens
    equal, each call's logits within ATTN_TOL of the row's scale (f32,
    TF32 off: 1e-4), MoE dropped pairs equal; both paths' prefill ms and
    decode ms a step."""
    from repro_torch.kernels import ops
    from repro_torch.models import parallel
    from repro_torch.train import serve

    t0 = time.perf_counter()
    spec, cfg, model = family_model(torch, dev, arch, **changes)
    smodel = _sm_model(torch, spec, cfg, mesh, dev,
                       dict(model.named_parameters()))
    host = {"tokens": prompts(cfg, batch, prompt)}
    if cfg.family == "encdec":
        host["frames"] = whisper_frames(cfg, batch)
    placed = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    view = parallel.ShardedView(smodel, smodel.layout)
    sm = parallel.ServeMesh(smodel.layout, batch)
    tol = F32_LOGIT_TOL if cfg.dtype == "float32" else ATTN_TOL
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    seen, undo = _sm_drops(torch)
    try:
        with torch.inference_mode():
            serve.greedy_decode(spec, cfg, model, host, 2, device=dev)
            serve.greedy_decode(spec, cfg, smodel, host, 2, device=dev,
                                mesh=mesh)
            seen.clear()
            ops.reset_launch_counts()
            one = _sm_loop(
                torch, lambda: spec.prefill(model, placed, cfg),
                lambda c, tok: spec.decode_step(model, c, tok, cfg),
                lambda lg: torch.argmax(lg[:, -1], dim=-1)[:, None].to(
                    torch.int32), SM_STEPS)
            one_drops = [int(x) for x in seen]
            seen.clear()
            one_counts = ops.launch_counts()
            ops.reset_launch_counts()
            got = _sm_loop(
                torch, lambda: spec.mesh_prefill(view, placed, cfg, sm),
                lambda c, tok: spec.mesh_decode_step(view, c, tok, cfg, sm),
                lambda lg: parallel.next_token(lg, cfg, sm.tp), SM_STEPS)
            mesh_drops = [int(x) for x in seen]
            mesh_counts = ops.launch_counts()
    finally:
        undo()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    same = torch.equal(one[0], got[0])
    gaps = [_rel_gap(torch, g, w, cfg.vocab_size)
            for g, w in zip(got[1], one[1], strict=True)]
    worst = max(rel for _, rel, _ in gaps)
    rec = {"arch": arch, "changes": changes, "batch": batch,
           "prompt": prompt, "tokens_equal": same, "worst_rel": worst,
           "tol": tol, "bit_identical": all(b for *_, b in gaps),
           "prefill_ms": {"one_card": one[2], "mesh": got[2]},
           "decode_ms_median": {"one_card": one[3], "mesh": got[3]},
           "launches": {"one_card": one_counts, "mesh": mesh_counts},
           "dropped": {"one_card": sum(one_drops), "mesh": sum(mesh_drops)},
           "seconds": time.perf_counter() - t0}
    log(f"[serve_mesh] (b) {arch} {changes}, {batch} x {prompt}: tokens "
        f"equal {same}; logits worst {worst:.4e} of the row's scale (tol "
        f"{tol}), bit-identical {rec['bit_identical']}; prefill ms one "
        f"card {one[2]:.3f} / mesh {got[2]:.3f}; decode ms a step "
        f"{one[3]:.3f} / {got[3]:.3f}; launches {one_counts} / "
        f"{mesh_counts}; dropped pairs {rec['dropped']}; "
        f"{rec['seconds']:.1f} s")
    require(same, f"(b) {arch}: the mesh path's tokens differ")
    require(worst <= tol, f"(b) {arch}: the mesh path's logits disagree")
    require(one_counts == mesh_counts,
            f"(b) {arch}: the paths launched {one_counts} / {mesh_counts}")
    require(one_drops == mesh_drops,
            f"(b) {arch}: dropped pairs {one_drops} / {mesh_drops}")
    del model, smodel, view
    torch.cuda.empty_cache()
    return rec


def _sm_rank_share(torch, dev, cfg, held, results):
    """(c) flash_attention at one rank's share of yi-6b's heads at (model
    4): q (8, 4096, 8, 128) against k, v (8, 4096, 1, 128), causal, from
    layer 0 of phase 11's prefill; held to its plain version, 3 calls
    bit-identical, timed beside its bound, plain version and SDPA."""
    tokens = torch.from_numpy(prompts(cfg, SERVE_BATCH, PROMPT)).to(dev)
    q, k, v = layer0_qkv(torch, held["model"], cfg, tokens)
    hq = cfg.num_heads // SM_RANK_HEADS
    hk = cfg.num_kv_heads // SM_RANK_HEADS
    q, k, v = (x[:, :, :n].contiguous() for x, n in ((q, hq), (k, hk),
                                                       (v, hk)))
    del tokens
    torch.cuda.empty_cache()
    entry = _attn_timed(torch, "a rank's share of yi-6b at (model 4)", q, k,
                        v, True)
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"], entry["max_abs_err"])
    del q, k, v
    torch.cuda.empty_cache()
    return entry


def _sm_launch(torch):
    """(d) launch.serve --arch mixtral-8x22b --smoke under torchrun
    --nproc-per-node 1 (an NCCL mesh of one rank, the mesh flags at 1)
    and as one process: the same tokens md5. (A smoke config's head dim
    of 16 is not the kernel's: mixtral's window takes the blocked
    attention.)"""
    import os

    argv = ["-m", "repro_torch.launch.serve", "--arch", MIXTRAL, "--smoke"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = {}
    for tag, cmd in (("torchrun", [sys.executable, "-m",
                                   "torch.distributed.run", "--standalone",
                                   "--nproc-per-node", "1"] + argv),
                     ("one process", [sys.executable] + argv)):
        t = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=400, cwd=ROOT)
        require(proc.returncode == 0,
                f"launch.serve ({tag}) failed: {proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        out[tag] = dict(json.loads(line[-1]), wall_s=time.perf_counter() - t)
        log(f"[serve_mesh] (d) launch.serve --arch {MIXTRAL} --smoke {tag}: "
            f"{out[tag]}")
    require(out["torchrun"]["tokens_md5"] == out["one process"]["tokens_md5"]
            and out["torchrun"]["mesh"] == {"data": 1, "model": 1},
            "launch.serve under torchrun differs from one process")
    return out


def phase_serve_mesh(torch, dev, smi, spec, cfg, held, served, results):
    """18. dense serving over a mesh, on an NCCL group of one rank, mesh
    (data 1, model 1), right after phase 11 on its model (`held`, freed
    here once the blocks are copied); every number from this card
    (`smi`, printed first)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    log(f"[serve_mesh] {smi}")
    t0 = time.perf_counter()
    out = {"rank_share": _sm_rank_share(torch, dev, cfg, held, results)}
    _nccl_one_rank(torch, "nccl_store_serve_mesh")
    try:
        mesh = make_host_mesh(1, 1)
        out["config3"] = _sm_config3(torch, dev, mesh, spec, cfg, held,
                                     served)
        out["families"] = [_sm_family(torch, dev, mesh, *f)
                           for f in SM_FAMILIES]
    finally:
        dist.destroy_process_group()
    out["launch"] = _sm_launch(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"[serve_mesh] phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 19. audit: the wire auditor's engine checks and the dry run on the card
# ---------------------------------------------------------------------------

# the kernels of one recorded train_step at one rank, by strategy: every
# step's sigmoid_grad; segment_sum_sorted under combine_grads,
# owner_accumulate and hot_grads (the dense reduces of allgather,
# psum_scatter and compressed_reduce have no combiner); select_pack in
# topk_reduce only (hier_a2a+topk is hier_a2a at one pod)
AUDIT_LAUNCHES = {name: {"sigmoid_grad": 1,
                         "segment_sum_sorted": 2 if name in (
                             "allgather", "psum_scatter",
                             "compressed_reduce") else 3,
                         "select_pack": int(name == "topk_reduce"),
                         "flash_attention": 0}
                  for name in ("a2a", "allgather", "compressed_reduce",
                               "hier_a2a", "hier_a2a+int8", "hier_a2a+topk",
                               "overlap_a2a", "psum_scatter", "topk_reduce")}
AUDIT_PREFILL_ROWS, AUDIT_PREFILL_SEQ = 2, 32768   # (c)'s prefill cell
AUDIT_PEAK_BAND = (0.9, 1.1)   # the prefill's dry-run peak over the card's


def _audit_engine(torch, dev):
    """(a) the audit's engine checks for all nine strategies at
    configuration 1's widths (2^27 features, K = 64, one batch of 4096
    from its corpus) on an NCCL group of one rank: no finding, the
    kernels of the recorded train_step counted by name, and a twin state
    that took the same steps without the recorder bit-identical to the
    recorded one; then host µs of a collective with and without the
    recorder."""
    import torch.distributed as dist

    from repro_torch.analysis import audit, trace
    from repro_torch.api.strategies import _all_to_all
    from repro_torch.configs.base import DPMRConfig
    from repro_torch.core import dpmr
    from repro_torch.launch.mesh import make_host_mesh

    names = sorted(AUDIT_LAUNCHES)
    batch = make_batches(dict(num_features=1 << LOG2_F,
                              features_per_sample=K,
                              signal_features=4096), 1)[0]
    out = {}
    t = time.perf_counter()
    findings, report = audit.audit_engine(
        names, device=dev, num_features=1 << LOG2_F,
        features_per_sample=K, batch=batch)
    torch.cuda.synchronize()
    out["engine_s"] = time.perf_counter() - t
    log(f"[audit] (a) engine checks of {len(names)} strategies at "
        f"2^{LOG2_F} x {K}, batch {BATCH}: {len(findings)} findings, "
        f"{len(report['checks'])} checks passed, {out['engine_s']:.1f} s")
    for f in findings:
        log(f"[audit] FINDING {f}")
    require(not findings, f"the engine checks found {findings}")
    for name in names:
        got = {k: report["launches"][name][k] for k in AUDIT_LAUNCHES[name]}
        log(f"[audit] (a) {name}: launches in the recorded train_step "
            f"{got}; its collectives {report['collectives'][name]}")
        require(got == AUDIT_LAUNCHES[name],
                f"{name} launched {got}, not {AUDIT_LAUNCHES[name]}")
    same = report["recorder_neutral"]
    log(f"[audit] (a) the recorded state against a twin that took the "
        f"same steps without the recorder, bit-identical: {same}")
    require(same == {name: True for name in names},
            f"the recorder changed a step: {same}")
    out["launches"] = report["launches"]
    out["collectives"] = report["collectives"]
    out["bit_identical"] = same

    _nccl_one_rank(torch, "nccl_store_audit")
    try:
        mesh = make_host_mesh(1, 1)
        ctx = dpmr.make_step_fns(
            DPMRConfig(num_features=1 << LOG2_F, max_features_per_sample=K,
                       distribution="a2a"), BATCH, mesh=mesh).ctx
        x = torch.zeros((1, ctx.capacity), dtype=torch.int32, device=dev)
        rec = trace.Recorder(mesh)
        host = {}
        for tag in ("plain", "recorded"):
            _all_to_all(x, ctx)
            torch.cuda.synchronize()
            n = 500
            t = time.perf_counter()
            if tag == "recorded":
                with rec:
                    for _ in range(n):
                        _all_to_all(x, ctx)
            else:
                for _ in range(n):
                    _all_to_all(x, ctx)
            torch.cuda.synchronize()
            host[tag] = (time.perf_counter() - t) * 1e6 / n
        require(len(rec.ops) == 500, f"the recorder kept {len(rec.ops)}")
        log(f"[audit] (a) host µs a collective (_all_to_all of (1, "
            f"{ctx.capacity}) int32 through the group, 500 calls): "
            f"{host['plain']:.2f} without the recorder, "
            f"{host['recorded']:.2f} with it")
        out["collective_host_us"] = host
    finally:
        dist.destroy_process_group()
    return out


def _audit_analytic():
    """(b) the analytic audit: nine strategies x four contexts on the
    `fake` backend of this machine's torch."""
    import torch

    from repro_torch.analysis import audit

    t = time.perf_counter()
    report = audit.audit_registry(engine_checks=False)
    secs = time.perf_counter() - t
    log(f"[audit] (b) analytic audit on torch {torch.__version__}: "
        f"{len(report['strategies'])} strategies x "
        f"{len(audit.build_contexts())} contexts, "
        f"{report['num_findings']} findings, {secs:.2f} s")
    require(report["ok"], f"the analytic audit found {report['findings']}")
    return {"seconds": secs, "num_findings": report["num_findings"],
            "torch": torch.__version__}


def _audit_dryrun(torch, dev):
    """(c) the dry run of configuration 19 (yi-6b at full width cut to 4
    layers, adamw, remat full, batch 4 x 4096, mesh (data 1, model 1))
    against the same step run on the card through an NCCL group of one
    rank: argument bytes equal to the state and batch the card holds,
    the collective schedule (op, count, bytes) equal to what the
    recorder sees around the card's step, and the dry run's peak beside
    the card's max_memory_allocated (a ratio, printed)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.analysis import trace
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, \
        TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer

    spec, cfg = train_config(TRAIN_LAYERS)
    spec = dataclasses.replace(spec, cfg=cfg)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, optimizer="adamw")
    pc = ParallelConfig(remat="full")
    shape = ShapeConfig("configuration 19", TRAIN_SEQ, TRAIN_BATCH, "train")
    geometry = {"data": 1, "model": 1}
    t = time.perf_counter()
    dry = dryrun.dry_step(spec, shape, geometry, pc, tc)
    dry_s = time.perf_counter() - t
    mem = dry["memory_analysis"]
    log(f"[audit] (c) dry run of configuration 19 at {geometry}: "
        f"{dry_s:.1f} s ({dry['ops']} operations on fake tensors), "
        f"memory {mem}, flops {dry['flops']:.4e}, bytes accessed "
        f"{dry['bytes_accessed']:.4e}, collectives "
        f"{dry['collective_summary']}")
    _nccl_one_rank(torch, "nccl_store_audit_dry")
    try:
        mesh = make_host_mesh(1, 1)
        torch.cuda.empty_cache()
        state = _train_state(torch, spec, cfg, tc, pc, dev, mesh)
        batch = next(iter(_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)))
        held = sum(t.numel() * t.element_size()
                   for t in dryrun._leaves([state, batch]))
        step = trainer.make_train_step(spec, cfg, tc, pc, mesh)
        rec = trace.Recorder(mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with rec:
            step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        card = dryrun.collective_summary(
            dryrun._collective_rows(rec.ops, geometry))
        del state, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    ratio = mem["peak_memory_in_bytes"] / peak
    log(f"[audit] (c) argument bytes: dry run "
        f"{mem['argument_size_in_bytes']}, the card's state and batch "
        f"{held}; collectives on the card {card}")
    log(f"[audit] (c) peak: dry run {mem['peak_memory_in_bytes']} B, the "
        f"card's max_memory_allocated {peak} B, ratio {ratio:.4f} (the dry "
        f"run leaves out {dryrun.NOT_COUNTED})")
    require(mem["argument_size_in_bytes"] == held,
            "the dry run's argument bytes are not the card's")
    require(card == dry["collective_summary"],
            "the dry run's collective schedule is not the card's")
    return {"dry": {k: v for k, v in dry.items() if k != "collectives"},
            "dry_s": dry_s, "held_bytes": held, "card_peak": peak,
            "peak_ratio": ratio, "card_collectives": card}


def _audit_dryrun_prefill(torch, dev):
    """(c) the dry run of a prefill cell (yi-6b at full width cut to
    TRAIN_LAYERS, AUDIT_PREFILL_ROWS x AUDIT_PREFILL_SEQ, mesh (data 1,
    model 1), its attention the flash_attention kernel's footprint)
    against the same `mesh_prefill` on the card through an NCCL group of
    one rank: argument bytes equal to the parameters and tokens the card
    holds, the collective schedule equal to the card's, and the dry
    run's peak over the card's max_memory_allocated (less what was
    allocated before the model) within AUDIT_PEAK_BAND."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.analysis import trace
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import parallel

    spec, cfg = train_config(TRAIN_LAYERS)
    spec = dataclasses.replace(spec, cfg=cfg)
    shape = ShapeConfig("prefill", AUDIT_PREFILL_SEQ, AUDIT_PREFILL_ROWS,
                        "prefill")
    geometry = {"data": 1, "model": 1}
    t = time.perf_counter()
    dry = dryrun.dry_step(spec, shape, geometry, ParallelConfig())
    dry_s = time.perf_counter() - t
    mem = dry["memory_analysis"]
    log(f"[audit] (c) dry run of a prefill of {AUDIT_PREFILL_ROWS} x "
        f"{AUDIT_PREFILL_SEQ} (yi-6b, {TRAIN_LAYERS} layers) at "
        f"{geometry}: {dry_s:.1f} s ({dry['ops']} operations on fake "
        f"tensors), memory {mem}, flops {dry['flops']:.4e}, bytes accessed "
        f"{dry['bytes_accessed']:.4e}, collectives "
        f"{dry['collective_summary']}")
    _nccl_one_rank(torch, "nccl_store_audit_prefill")
    try:
        mesh = make_host_mesh(1, 1)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        _, _, model = yi_model(torch, dev, num_layers=TRAIN_LAYERS)
        smodel = _sm_model(torch, spec, cfg, mesh, dev,
                           dict(model.named_parameters()))
        del model
        torch.cuda.empty_cache()
        batch = {"tokens": torch.from_numpy(prompts(
            cfg, AUDIT_PREFILL_ROWS, AUDIT_PREFILL_SEQ)).to(dev)}
        held = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in dryrun._leaves([smodel, batch])}.values())
        view = parallel.ShardedView(smodel, smodel.layout)
        sm = parallel.ServeMesh(smodel.layout, AUDIT_PREFILL_ROWS)
        rec = trace.Recorder(mesh)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with rec:
            logits, cache = spec.mesh_prefill(view, batch, cfg, sm)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = ops.launch_counts()
        finite = bool(torch.isfinite(logits).all())
        card = dryrun.collective_summary(
            dryrun._collective_rows(rec.ops, geometry))
        del logits, cache, smodel, view, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    ratio = mem["peak_memory_in_bytes"] / peak
    log(f"[audit] (c) prefill: argument bytes: dry run "
        f"{mem['argument_size_in_bytes']}, the card's parameters and "
        f"tokens {held}; launches {counts}; logits finite {finite}; "
        f"collectives on the card {card}")
    log(f"[audit] (c) prefill peak: dry run {mem['peak_memory_in_bytes']} "
        f"B, the card's max_memory_allocated less the {base} B allocated "
        f"before the model {peak} B, ratio {ratio:.4f} (band "
        f"{AUDIT_PEAK_BAND})")
    require(finite, "the card's prefill logits are not finite")
    require(counts["flash_attention"] == TRAIN_LAYERS,
            f"the card's prefill launched {counts}")
    require(mem["argument_size_in_bytes"] == held,
            "the prefill dry run's argument bytes are not the card's")
    require(card == dry["collective_summary"],
            "the prefill dry run's collective schedule is not the card's")
    require(AUDIT_PEAK_BAND[0] <= ratio <= AUDIT_PEAK_BAND[1],
            f"the prefill dry run's peak is {ratio:.4f} of the card's")
    return {"dry": {k: v for k, v in dry.items() if k != "collectives"},
            "dry_s": dry_s, "held_bytes": held, "card_peak": peak,
            "base_bytes": base, "peak_ratio": ratio,
            "card_collectives": card, "launches": counts}


def phase_audit(torch, dev, smi):
    """19. the wire auditor and the dry run (every number from this card,
    `smi`, printed first)."""
    import contextlib
    import io

    from repro_torch.launch import dryrun

    log(f"[audit] {smi}")
    t0 = time.perf_counter()
    out = {"engine": _audit_engine(torch, dev),
           "analytic": _audit_analytic(),
           "dryrun": _audit_dryrun(torch, dev),
           "dryrun_prefill": _audit_dryrun_prefill(torch, dev)}
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        out["strategy_wire"] = dryrun.run_strategy_wire()
    log("[audit] (d) the strategies' wire on the production geometries "
        "(python -m repro_torch.launch.dryrun --strategies):\n"
        + table.getvalue().rstrip())
    out["seconds"] = time.perf_counter() - t0
    log(f"[audit] phase took {out['seconds']:.1f} s")
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
    dataplane = phase_dataplane(torch, dev, train, hot)
    multirank = phase_multirank(torch, dev, train, hot)
    p8 = phase_p8(torch, dev, hot, results)
    parity = phase_parity(torch, dev)
    sparse_serve = phase_sparse_serve(torch, dev, train, test, hot)
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
    held = {"model": model}
    del model
    serve_mesh = phase_serve_mesh(torch, dev, smi, spec, cfg, held, served,
                                  results)
    del held
    torch.cuda.empty_cache()
    dense_parity = phase_dense_parity(torch, dev)
    cfg9 = {}
    train_dense = phase_train_dense(torch, dev, keep=keep_params(cfg9))
    cfg9["run"] = train_dense["main"]
    cfg11 = {}
    moe = phase_moe(torch, dev, results, keep=keep_params(cfg11))
    cfg11["run"] = moe["phi_train"]["main"]
    families = phase_families(torch, dev, results)
    distribution = phase_distribution(torch, dev, smi, cfg9)
    del cfg9
    model_parallel = phase_model_parallel(torch, dev, smi, cfg11)
    del cfg11
    audit = phase_audit(torch, dev, smi)

    kernels = [results[name] for name in ("sigmoid_grad",
                                          "segment_sum_sorted",
                                          "select_pack", "flash_attention",
                                          "row_update")]
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build_s": build_s,
         "kernel_resources": resources, "kernels": kernels,
         "owner_accumulate": results["owner_accumulate"],
         "reduces": results["reduces"],
         "engine": engine, "dataplane": dataplane,
         "multirank": multirank, "p8": p8,
         "parity": parity, "sparse_serve": sparse_serve, "serve": served,
         "dense_parity": dense_parity, "train_dense": train_dense,
         "moe": moe, "families": families, "distribution": distribution,
         "model_parallel": model_parallel, "serve_mesh": serve_mesh,
         "audit": audit},
        indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
