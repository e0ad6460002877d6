// Run totals over SORTED feature ids (the DPMR reduce combiner) for Hopper.
//
// Replaces the Pallas TPU kernel `segment_sum_sorted` of
// src/repro/kernels/segment_sum.py (`_kernel`, `pl.pallas_call`). Input:
// ids (N,) int32 sorted ascending with padding (any negative id) last, and
// grads (N,) f32. Output (N,) f32: each run's total at the run's LAST slot,
// 0 everywhere else. Padding contributes nothing and ends no run.
//
// What bounds it on this card: memory, in principle. ids are read and out
// written once a slot, and grads read once a live slot (padding needs none),
// one add per live slot: 8 bytes a slot plus 4 a live one, ~2.2 MB at the
// main path's N = 262,144 with ~27,400 live, a ~0.66 us floor at 3.35 TB/s.
// At that size one launch and the latency of a block's load, scan and
// look-back are most of the cost, so the design is ONE launch:
//
// The TPU kernel carries a run's partial total from one grid step to the
// next in SMEM, because its grid runs in order on one core. Blocks on
// Hopper run in parallel and in no order, so the carry is a single-pass
// segmented scan with a decoupled look-back:
//  - tiles of 2,048 slots (N = 262,144 is 128 tiles, one wave on 132 SMs),
//    handed out by an atomic ticket, not by blockIdx: a tile only waits on
//    tiles whose blocks already hold a ticket, so are resident (no deadlock);
//  - a block of 512 threads loads its tile with 16-byte loads into shared
//    memory, so the run-end test reads the next id there (only the id past
//    the tile's right edge comes from global memory), then scans it: a
//    segmented inclusive scan with run-head flags, in registers within a
//    thread (4 slots), by warp shuffles within a warp, and through shared
//    memory across warps;
//  - it publishes the tile's aggregate (does a run start in it, the sum
//    since its last run start) and later its inclusive prefix as one 64-bit
//    status word (epoch, head, flag | f32 sum). Flag and value share the
//    word, so relaxed stores and loads suffice, with no memory fence;
//  - look-back: warp 0 reads the 32 nearest predecessors' words and takes
//    the nearest STOP, a tile that published its inclusive prefix or whose
//    aggregate starts a run (head = 1 resets the carry, so nothing before
//    it matters). It folds that value and the aggregates between it and
//    the tile strictly left to right with the segmented-sum operator. That
//    is the f32 sequence of a sequential fold over all tiles, so the bits
//    do not depend on which predecessors had published when the warp
//    looked (textbook look-back reduces whatever window it finds, and its
//    bits depend on timing). Without a stop in the window it polls again:
//    the tile just before it publishes its prefix in finite time. At the
//    main path's P = 1 every run has length 1, so every aggregate starts a
//    run and the look-back is one step;
//  - while warp 0 looks back, the other threads store every run total that
//    does not need the carry; only the run entering the tile from the left
//    waits for it.
// The look-back's state lives on the device, in a buffer the wrapper keeps
// per stream (and one of its own for each call captured in a CUDA graph):
// the status words and a 64-bit control word, the ticket in its low half
// and the epoch in its high half. Nothing in it comes from the host, so a
// replayed graph starts from the state the last call left. Each block
// takes its tile and the call's epoch from one atomicAdd on the control
// word; the block that takes the last tile stores ticket 0 and the next
// epoch back (after every block's add, so every block read this call's
// epoch). The status words are never zeroed on the call path: each word
// carries its call's epoch (29 bits), and a word of another epoch reads
// as unpublished. The epoch wraps after 2^29 - 1 calls, so a word must
// not outlive that many calls: the last tile's block also zeroes one word
// past the call's tiles, word (epoch mod m) for the power of two m just
// above `capacity`, so within 2 m calls (m at most 2^21, far below 2^29)
// every word is published again or zeroed, and none keeps an epoch long
// enough to meet it again. Stream
// order keeps calls apart: the next call starts after this one has ended.
// Every addition happens in a fixed order and no float atomics are used,
// so the output is bit-identical from call to call. The order differs
// from a sequential sum, so it agrees with the plain version to within f32
// rounding of the run totals, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1u;
constexpr unsigned kInclusive = 2u;
constexpr int kEpochBits = 29;
constexpr unsigned kMaxEpoch = (1u << kEpochBits) - 1;
static_assert(kItems % 4 == 0, "whole 16-byte vectors a thread");

// A span of slots under the segmented-sum operator: `head` says a run
// starts inside the span, `sum` is the total since the span's last run
// start (or since the span's first slot, without one).
struct Seg {
  int head;
  float sum;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.head | b.head, b.head ? b.sum : a.sum + b.sum};
}

__device__ __forceinline__ Seg warp_inclusive_scan(Seg x, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int h = __shfl_up_sync(kFull, x.head, off);
    const float s = __shfl_up_sync(kFull, x.sum, off);
    if (lane >= off) x = combine(Seg{h, s}, x);
  }
  return x;
}

__device__ __forceinline__ Seg shift_exclusive(Seg inc, int lane) {
  const int h = __shfl_up_sync(kFull, inc.head, 1);
  const float s = __shfl_up_sync(kFull, inc.sum, 1);
  return lane == 0 ? Seg{0, 0.0f} : Seg{h, s};
}

// status word: high half (epoch << 3) | (head << 2) | flag, low half sum
__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned flag, Seg s) {
  const unsigned hi = (epoch << 3) | ((unsigned)s.head << 2) | flag;
  return ((unsigned long long)hi << 32) | __float_as_uint(s.sum);
}

// A status word carries its flag and its value in one 64-bit access, so
// relaxed stores and loads suffice: no fence orders anything else.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The carry entering `tile`: the fold of every earlier tile's aggregate,
// as a sequential left fold would give it. Called by warp 0 only.
__device__ Seg look_back(const unsigned long long* status, int tile,
                         unsigned epoch, int lane) {
  const int pred = tile - 1 - lane;
  for (;;) {
    unsigned long long w = 0;
    if (pred >= 0) {
      do {
        w = load_status(&status[pred]);
      } while ((unsigned)(w >> 35) != epoch);
    }
    const unsigned hi = (unsigned)(w >> 32);
    const bool stop = pred >= 0 && ((hi & 3u) == kInclusive || (hi & 4u));
    const unsigned stops = __ballot_sync(kFull, stop);
    if (stops) {
      const int at = __ffs(stops) - 1;
      const int head = (int)((hi >> 2) & 1u);
      const float sum = __uint_as_float((unsigned)w);
      Seg c{__shfl_sync(kFull, head, at), __shfl_sync(kFull, sum, at)};
      // the aggregates after the stop, oldest first
      for (int l = at - 1; l >= 0; --l)
        c = combine(c, Seg{__shfl_sync(kFull, head, l),
                           __shfl_sync(kFull, sum, l)});
      return c;
    }
    __nanosleep(64);
  }
}

// The carry that warp 0's look-back left in shared memory, once it is there.
__device__ __forceinline__ float wait_carry(const int* ready,
                                            const float* sum) {
  while (*(const volatile int*)ready == 0) {
  }
  __threadfence_block();
  return *(const volatile float*)sum;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const int* __restrict__ ids,
                       const float* __restrict__ grads,
                       float* __restrict__ out,
                       unsigned long long* __restrict__ status,
                       unsigned long long* __restrict__ control,
                       int capacity, long long n, int vec) {
  __shared__ __align__(16) int s_ids[kTile];
  __shared__ __align__(16) float s_val[kTile];
  __shared__ int s_head[kWarps];
  __shared__ float s_sum[kWarps];
  __shared__ int s_tile, s_prev, s_next, s_ready;
  __shared__ unsigned s_epoch;
  __shared__ float s_carry_sum;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  if (tid == 0) {
    // the ticket and the call's epoch (stored minus 1) from one atomic
    const unsigned long long got = atomicAdd(control, 1ull);
    const int tile = (int)(unsigned)got;
    const unsigned epoch = (unsigned)(got >> 32) + 1;
    if (tile == (int)gridDim.x - 1) {
      // every block has taken its ticket, and so read the epoch: set up
      // the stream's next call (this store follows every add of the call),
      // and zero one word that this call does not use
      store_status(control,
                   (unsigned long long)(epoch == kMaxEpoch ? 0u : epoch)
                       << 32);
      const unsigned scrub = epoch & (0xffffffffu >> __clz(capacity));
      if (scrub >= gridDim.x && scrub < (unsigned)capacity)
        store_status(&status[scrub], 0ull);
    }
    s_tile = tile;
    s_epoch = epoch;
    s_ready = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const unsigned epoch = s_epoch;
  const long long base = (long long)tile * kTile;
  const long long left = n - base;
  const bool full = vec && left >= kTile;
  if (full) {
#pragma unroll
    for (int r = 0; r < kItems / 4; ++r) {
      const int q = r * kThreads + tid;
      const int4 a = reinterpret_cast<const int4*>(ids + base)[q];
      const float4 g = reinterpret_cast<const float4*>(grads + base)[q];
      reinterpret_cast<int4*>(s_ids)[q] = a;
      reinterpret_cast<float4*>(s_val)[q] = g;
    }
  } else {
    for (int j = tid; j < kTile; j += kThreads) {
      const bool in = j < left;
      s_ids[j] = in ? ids[base + j] : -1;
      s_val[j] = in ? grads[base + j] : 0.0f;
    }
  }
  if (tid == 0) {
    s_prev = base > 0 ? ids[base - 1] : -1;
    s_next = left > kTile ? ids[base + kTile] : -1;
  }
  __syncthreads();

  // this thread's kItems consecutive slots
  const int j0 = tid * kItems;
  int id[kItems];
  float v[kItems];
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    const int4 a = reinterpret_cast<const int4*>(s_ids)[j0 / 4 + q];
    const float4 f = reinterpret_cast<const float4*>(s_val)[j0 / 4 + q];
    id[4 * q] = a.x;
    id[4 * q + 1] = a.y;
    id[4 * q + 2] = a.z;
    id[4 * q + 3] = a.w;
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
  const int next_edge = j0 + kItems < kTile ? s_ids[j0 + kItems] : s_next;
  int prev = j0 == 0 ? s_prev : s_ids[j0 - 1];
  float local[kItems];
  int seen[kItems];
  Seg agg{0, 0.0f};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = id[j] >= 0;
    const int head = (base + j0 + j == 0) || !valid || id[j] != prev;
    agg = combine(agg, Seg{head, valid ? v[j] : 0.0f});
    local[j] = agg.sum;
    seen[j] = agg.head;
    prev = id[j];
  }

  // tile-wide exclusive scan of the thread aggregates
  const Seg inc = warp_inclusive_scan(agg, lane);
  const Seg ex_in_warp = shift_exclusive(inc, lane);
  if (lane == kWarp - 1) {
    s_head[warp] = inc.head;
    s_sum[warp] = inc.sum;
  }
  __syncthreads();
  Seg tot{0, 0.0f};
  if (warp == 0) {
    const Seg w = lane < kWarps ? Seg{s_head[lane], s_sum[lane]}
                                : Seg{0, 0.0f};
    const Seg w_inc = warp_inclusive_scan(w, lane);
    const Seg w_ex = shift_exclusive(w_inc, lane);
    tot = Seg{__shfl_sync(kFull, w_inc.head, kWarps - 1),
              __shfl_sync(kFull, w_inc.sum, kWarps - 1)};
    if (lane < kWarps) {
      s_head[lane] = w_ex.head;
      s_sum[lane] = w_ex.sum;
    }
    if (lane == 0)
      store_status(&status[tile],
                    pack(epoch, tile == 0 ? kInclusive : kAggregate, tot));
  }
  __syncthreads();
  // the exclusive prefix of this thread's slots within the tile
  const Seg ex = combine(Seg{s_head[warp], s_sum[warp]}, ex_in_warp);
  if (warp == 0 && tile > 0) {
    // look back for the carry entering the tile, while the other warps
    // write every total that does not need it
    const Seg carry = look_back(status, tile, epoch, lane);
    if (lane == 0) {
      store_status(&status[tile],
                    pack(epoch, kInclusive, combine(carry, tot)));
      s_carry_sum = carry.sum;
      __threadfence_block();
      *(volatile int*)&s_ready = 1;
    }
  }

  float res[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int next = j + 1 < kItems ? id[j + 1] : next_edge;
    const bool is_end = id[j] >= 0 && next != id[j];
    float total = local[j];
    if (is_end && !seen[j]) {
      // the run started before this thread's slots: add the prefix, and
      // for the run entering the tile the carry, as combine(carry, ex)
      total = ex.head ? ex.sum + local[j]
                      : (wait_carry(&s_ready, &s_carry_sum) + ex.sum) +
                            local[j];
    }
    res[j] = is_end ? total : 0.0f;
  }
  if (full) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      reinterpret_cast<float4*>(out + base + j0)[q] =
          make_float4(res[4 * q], res[4 * q + 1], res[4 * q + 2],
                      res[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (j0 + j < left) out[base + j0 + j] = res[j];
  }
}

}  // namespace

extern "C" int repro_segment_sum_tile_size() { return kTile; }

// status: `capacity` >= ceil(n / tile) 64-bit words (capacity < 2^29 - 1),
// then the 64-bit control word {ticket, epoch - 1}: all zero when the
// buffer is made, and from then on kept by the kernel alone (no argument
// carries state, so a captured launch replays correctly). Calls that share
// a buffer must be ordered (one stream, or one graph replayed in order).
// n < 2^31.
extern "C" int repro_segment_sum_sorted_f32(const int* ids, const float* grads,
                                            float* out,
                                            unsigned long long* status,
                                            unsigned long long* control,
                                            int capacity, long long n,
                                            void* stream) {
  if (n <= 0) return 0;
  const int tiles = (int)((n + kTile - 1) / kTile);
  if (capacity < tiles || capacity >= (int)kMaxEpoch)
    return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)ids | (uintptr_t)grads | (uintptr_t)out) % 16
                  == 0;
  segment_sum_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      ids, grads, out, status, control, capacity, n, vec);
  return (int)cudaGetLastError();
}

// Zero `bytes` at `p` now, outside any stream capture under way on this
// thread: for the look-back buffer of a call being captured, which must
// start zeroed at the graph's first replay and must not be zeroed again
// at later ones. Runs on a stream of its own and waits for it.
extern "C" int repro_segment_sum_zero_state(void* p, long long bytes) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t err = cudaThreadExchangeStreamCaptureMode(&mode);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(p, 0, (size_t)bytes, s);
    const cudaError_t sync = cudaStreamSynchronize(s);
    if (err == cudaSuccess) err = sync;
    cudaStreamDestroy(s);
  }
  cudaThreadExchangeStreamCaptureMode(&mode);
  return (int)err;
}
