// Run totals over SORTED feature ids (the DPMR reduce combiner) for Hopper.
//
// Replaces the Pallas TPU kernel `segment_sum_sorted` of
// src/repro/kernels/segment_sum.py (`_kernel`, `pl.pallas_call`). Input:
// ids (N,) int32 sorted ascending with padding (any negative id) last, and
// grads (N,) f32. Output (N,) f32: each run's total at the run's LAST slot,
// 0 everywhere else. Padding contributes nothing and ends no run.
//
// What bounds it on this card: memory. ids and grads are read once and out
// written once, one add per element: 12 bytes per slot, ~3.1 MB at the main
// path's N = 262,144, a ~1 us floor at 3.35 TB/s, below the cost of the
// two launches.
//
// The TPU kernel carries a run's partial total from one grid step to the
// next in SMEM, because its grid runs in order on one core. Blocks on
// Hopper run in parallel and in no order, so the carry is rebuilt as a
// segmented scan in two passes:
//  pass 1 (one block per 1024-slot tile): a segmented inclusive scan with
//    run-head flags, in registers within a thread, with warp shuffles
//    within a warp and through shared memory across the tile's warps. It
//    writes the in-tile partial total at every run end (the next id is
//    read across the tile boundary), records the tile's aggregate (does a
//    run start in it, and the sum since its last run start) and the slot
//    of the first run end that belongs to the run entering the tile from
//    the left.
//  pass 2 (one block): resolves, in tile order, the carry entering each
//    tile from the tiles before it (an exclusive segmented scan of the
//    tile aggregates) and adds it at that one run end per tile.
// Every addition happens in a fixed order and no float atomics are used,
// so the output is bit-reproducible from run to run. The order differs
// from a sequential sum, so it agrees with the plain version to within
// f32 rounding of the run totals, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryChunk = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void segment_tile_kernel(const int* __restrict__ ids,
                                    const float* __restrict__ grads,
                                    float* __restrict__ out,
                                    int* __restrict__ tile_head,
                                    float* __restrict__ tile_sum,
                                    int* __restrict__ lead_end,
                                    long long n) {
  __shared__ int s_head[kWarps];
  __shared__ float s_sum[kWarps];
  __shared__ int s_tot_head;
  __shared__ float s_tot_sum;
  __shared__ long long s_lead;

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  if (threadIdx.x == 0) s_lead = -1;

  int id[kItems];
  float local[kItems];
  int seen[kItems];
  Seg agg{0, 0.0f};
  int prev = base > 0 && base - 1 < n ? ids[base - 1] : -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    int head = 1;
    float v = 0.0f;
    id[j] = -1;
    if (i < n) {
      id[j] = ids[i];
      const bool valid = id[j] >= 0;
      v = valid ? grads[i] : 0.0f;
      head = (i == 0) || !valid || id[j] != prev;
      prev = id[j];
    }
    agg = combine(agg, Seg{head, v});
    local[j] = agg.sum;
    seen[j] = agg.head;
  }

  // tile-wide exclusive scan of the thread aggregates
  const Seg inc = warp_inclusive_scan(agg, lane);
  const Seg ex_in_warp = shift_exclusive(inc, lane);
  if (lane == kWarp - 1) {
    s_head[warp] = inc.head;
    s_sum[warp] = inc.sum;
  }
  __syncthreads();
  if (warp == 0) {
    const Seg w = lane < kWarps ? Seg{s_head[lane], s_sum[lane]}
                                : Seg{0, 0.0f};
    const Seg w_inc = warp_inclusive_scan(w, lane);
    const Seg w_ex = shift_exclusive(w_inc, lane);
    if (lane < kWarps) {
      s_head[lane] = w_ex.head;
      s_sum[lane] = w_ex.sum;
    }
    if (lane == kWarps - 1) {
      s_tot_head = w_inc.head;
      s_tot_sum = w_inc.sum;
    }
  }
  __syncthreads();
  const Seg ex = combine(Seg{s_head[warp], s_sum[warp]}, ex_in_warp);

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    const float total = seen[j] ? local[j] : ex.sum + local[j];
    int next;
    if (j + 1 < kItems)
      next = i + 1 < n ? id[j + 1] : -1;
    else
      next = i + 1 < n ? ids[i + 1] : -1;
    const bool is_end = id[j] >= 0 && (i + 1 == n || next != id[j]);
    out[i] = is_end ? total : 0.0f;
    if (is_end && !(seen[j] || ex.head)) s_lead = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tile_head[blockIdx.x] = s_tot_head;
    tile_sum[blockIdx.x] = s_tot_sum;
    lead_end[blockIdx.x] = (int)s_lead;
  }
}

__global__ void segment_carry_kernel(const int* __restrict__ tile_head,
                                     const float* __restrict__ tile_sum,
                                     const int* __restrict__ lead_end,
                                     float* __restrict__ out,
                                     int num_tiles) {
  __shared__ int s_head[kCarryChunk];
  __shared__ float s_sum[kCarryChunk];
  __shared__ float s_carry[kCarryChunk];
  float running = 0.0f;   // carry entering the chunk; thread 0 only
  for (int c0 = 0; c0 < num_tiles; c0 += kCarryChunk) {
    const int cnt = min(kCarryChunk, num_tiles - c0);
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      s_head[t] = tile_head[c0 + t];
      s_sum[t] = tile_sum[c0 + t];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < cnt; ++t) {
        s_carry[t] = running;
        running = s_head[t] ? s_sum[t] : running + s_sum[t];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const int e = lead_end[c0 + t];
      if (e >= 0) out[e] += s_carry[t];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_segment_sum_tile_size() { return kTile; }

// scratch: tile_head (int32), tile_sum (f32), lead_end (int32), each
// ceil(n / tile) long. n < 2^31.
extern "C" int repro_segment_sum_sorted_f32(const int* ids, const float* grads,
                                            float* out, int* tile_head,
                                            float* tile_sum, int* lead_end,
                                            long long n, void* stream) {
  if (n <= 0) return 0;
  const int tiles = (int)((n + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  segment_tile_kernel<<<tiles, kThreads, 0, s>>>(ids, grads, out, tile_head,
                                                 tile_sum, lead_end, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_carry_kernel<<<1, kThreads, 0, s>>>(tile_head, tile_sum, lead_end,
                                              out, tiles);
  return (int)cudaGetLastError();
}
