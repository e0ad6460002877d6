// Top-k select + pack of the topk_reduce reverse shuffle, for Hopper.
//
// Replaces the Pallas TPU kernel `select_pack` of
// src/repro/kernels/select_pack.py (`_kernel`, `pl.pallas_call`). Inputs, per
// destination row of a (P, cap) send buffer: send and carry (f32) and ids
// (int32, negative = dead slot). Per row it computes
//   comp  = send + carry on live slots, 0 on dead ones;
//   rank  = |comp| descending, ties by position, dead slots after every live
//           one (jax.lax.top_k's order);
//   ids_k, vals_k = the first k (id, comp) pairs in rank order, vals_k = 0
//           where the id is dead;
//   resid = 0 for live winners, comp for every other slot.
// All three outputs equal the plain version (kernels/ref.py,
// select_pack_ref) bit for bit: the only arithmetic is the one f32 add of
// comp, and the rest moves values.
//
// Design. The TPU kernel ranks a row with a (cap, cap) comparison mask held
// in VMEM, which caps it at cap = 4096. The main path on one card has
// cap = 262,144 (6.9e10 comparisons and a 256 GiB mask), so the ranking is a
// stable LSD radix sort of each row instead, with no capacity cap:
//  - key pass: comp, and a uint32 key whose ascending order is the rank
//    order (0x7F800001 - bits(|comp|) for live slots, so |-0.0| = |+0.0|;
//    NaN first, as torch.sort puts it; 0xFFFFFFFF for dead slots, after a
//    live 0). The value sorted beside the key is the slot's position.
//    resid = comp everywhere. The row's digit totals of all four passes
//    (they do not depend on the order) and the first pass's tile
//    histogram.
//  - 4 passes of 8 bits, each over a (tile, row) grid of 1024-slot tiles:
//    a per-tile digit histogram (shared-memory integer atomics); a scan
//    with one warp per (digit, row) that turns the digit's tile counts
//    into global offsets, starting at the sum of the lower digits' totals;
//    and a stable scatter. Within a tile the scatter ranks slots in
//    position order: 4 rounds of 256, warp peers by __match_any_sync,
//    warps by a shared-memory prefix. Stability gives "ties by position"
//    for free.
//  - emit pass: the first k sorted positions of each row give ids_k and
//    vals_k (comp recomputed with the same add), and zero resid at live
//    winners. Each position appears once, so no write races.
// No float atomics, so the result does not depend on the order blocks run.
//
// What bounds it on this card: memory. It must read send, ids and carry
// and write resid, vals_k and ids_k (16 bytes a slot plus 8 a winner, ~4.3
// MB at cap = 262,144, k = 13,108: ~1.3 us at 3.35 TB/s). The four sort
// passes read and write the key and position buffers again each pass (8 MB
// at that shape), and 13 launches and a memset of the digit totals cost
// more than that at this size; a first kernel that is right, with its
// times in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;
constexpr int kRounds = kTile / kThreads;
constexpr int kRadix = 256;
constexpr int kPasses = 4;
constexpr int kScanWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kDeadKey = 0xffffffffu;
constexpr uint32_t kInfBits = 0x7f800000u;
static_assert(kThreads == kRadix, "one thread per digit");
static_assert(kTile % kThreads == 0, "whole rounds per tile");
static_assert(kRadix % kScanWarps == 0, "whole scan blocks");

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return (int)((key >> shift) & 0xffu);
}

__device__ __forceinline__ long long hist_at(int row, int digit, int tile,
                                             int tiles) {
  return ((long long)row * kRadix + digit) * tiles + tile;
}

__global__ void select_pack_key_kernel(const float* __restrict__ send,
                                       const int* __restrict__ ids,
                                       const float* __restrict__ carry,
                                       uint32_t* __restrict__ keys,
                                       int* __restrict__ pos,
                                       float* __restrict__ resid,
                                       int* __restrict__ hist,
                                       int* __restrict__ totals, int cap,
                                       int tiles) {
  __shared__ int h[kPasses][kRadix];
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
#pragma unroll
  for (int q = 0; q < kPasses; ++q) h[q][threadIdx.x] = 0;
  __syncthreads();
  const long long rbase = (long long)row * cap;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = tile * kTile + j;
    if (i >= cap) break;
    const long long g = rbase + i;
    const bool live = ids[g] >= 0;
    const float comp = live ? __fadd_rn(send[g], carry[g]) : 0.0f;
    const uint32_t mag = __float_as_uint(comp) & 0x7fffffffu;
    const uint32_t key =
        !live ? kDeadKey : (mag > kInfBits ? 0u : kInfBits + 1u - mag);
    keys[g] = key;
    pos[g] = i;
    resid[g] = comp;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) atomicAdd(&h[q][digit_of(key, 8 * q)], 1);
  }
  __syncthreads();
  hist[hist_at(row, threadIdx.x, tile, tiles)] = h[0][threadIdx.x];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int c = h[q][threadIdx.x];
    if (c) atomicAdd(&totals[((long long)row * kPasses + q) * kRadix +
                             threadIdx.x], c);
  }
}

__global__ void select_pack_hist_kernel(const uint32_t* __restrict__ keys,
                                        int* __restrict__ hist, int cap,
                                        int tiles, int shift) {
  __shared__ int h[kRadix];
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long rbase = (long long)row * cap;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = tile * kTile + j;
    if (i >= cap) break;
    atomicAdd(&h[digit_of(keys[rbase + i], shift)], 1);
  }
  __syncthreads();
  hist[hist_at(row, threadIdx.x, tile, tiles)] = h[threadIdx.x];
}

// One warp per (digit, row): the digit's counts over the row's tiles
// become exclusive prefix sums, offset by the row's count of every lower
// digit, i.e. where each tile's slots of that digit start in the output.
__global__ void select_pack_scan_kernel(int* __restrict__ hist,
                                        const int* __restrict__ totals,
                                        int tiles, int pass) {
  const int row = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int digit = blockIdx.x * kScanWarps + threadIdx.x / 32;
  const int* tot = totals + ((long long)row * kPasses + pass) * kRadix;
  int base = 0;
  for (int j = lane; j < digit; j += 32) base += tot[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    base += __shfl_xor_sync(kFull, base, off);
  int* h = hist + hist_at(row, digit, 0, tiles);
  int run = base;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < tiles ? h[t] : 0;
    int inc = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += v;
    }
    if (t < tiles) h[t] = run + inc - c;
    run += __shfl_sync(kFull, inc, 31);
  }
}

__global__ void select_pack_scatter_kernel(
    const uint32_t* __restrict__ keys_in, const int* __restrict__ pos_in,
    uint32_t* __restrict__ keys_out, int* __restrict__ pos_out,
    const int* __restrict__ offsets, int cap, int tiles, int shift) {
  __shared__ int s_base[kRadix];            // next output slot per digit
  __shared__ int s_warp[kWarps][kRadix];    // a round's counts per warp
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const unsigned below_mask = (1u << lane) - 1u;
  const long long rbase = (long long)row * cap;
  s_base[threadIdx.x] = offsets[hist_at(row, threadIdx.x, tile, tiles)];
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_warp[w][threadIdx.x] = 0;
    __syncthreads();
    const int i = tile * kTile + r * kThreads + threadIdx.x;
    const bool active = i < cap;
    uint32_t key = 0;
    int p = 0;
    if (active) {
      key = keys_in[rbase + i];
      p = pos_in[rbase + i];
    }
    // inactive slots (past a ragged cap) take digit kRadix: they match only
    // each other and come after every active slot of the round
    const int d = active ? digit_of(key, shift) : kRadix;
    const unsigned peers = __match_any_sync(kFull, d);
    const int below = __popc(peers & below_mask);
    if (active && below == 0) s_warp[warp][d] = __popc(peers);
    __syncthreads();
    int total = 0;      // this round's count of digit threadIdx.x
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w][threadIdx.x];
      s_warp[w][threadIdx.x] = total;
      total += c;
    }
    __syncthreads();
    if (active) {
      const long long dst = rbase + s_base[d] + s_warp[warp][d] + below;
      keys_out[dst] = key;
      pos_out[dst] = p;
    }
    __syncthreads();
    s_base[threadIdx.x] += total;
  }
}

__global__ void select_pack_emit_kernel(const float* __restrict__ send,
                                        const int* __restrict__ ids,
                                        const float* __restrict__ carry,
                                        const int* __restrict__ pos_sorted,
                                        float* __restrict__ vals_k,
                                        int* __restrict__ ids_k,
                                        float* __restrict__ resid, int cap,
                                        int k) {
  const int row = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= k) return;
  const long long rbase = (long long)row * cap;
  const long long g = rbase + pos_sorted[rbase + r];
  const long long out = (long long)row * k + r;
  const int id = ids[g];
  ids_k[out] = id;
  if (id >= 0) {
    vals_k[out] = __fadd_rn(send[g], carry[g]);
    resid[g] = 0.0f;
  } else {
    vals_k[out] = 0.0f;
  }
}

}  // namespace

extern "C" int repro_select_pack_tile_size() { return kTile; }
extern "C" int repro_select_pack_radix() { return kRadix; }

// send, carry: (rows, cap) f32; ids: (rows, cap) int32. Outputs vals_k,
// ids_k (rows, k) and resid (rows, cap). Scratch: keys_a, keys_b, pos_a,
// pos_b (rows, cap) 32-bit each; hist (rows, radix * tiles) int32 with
// tiles = ceil(cap / tile); totals (rows, 4, radix) int32, zeroed here.
// 1 <= k <= cap, rows <= 65535, rows * cap < 2^31.
extern "C" int repro_select_pack_f32(const float* send, const int* ids,
                                     const float* carry, float* vals_k,
                                     int* ids_k, float* resid,
                                     uint32_t* keys_a, uint32_t* keys_b,
                                     int* pos_a, int* pos_b, int* hist,
                                     int* totals, int rows, int cap, int k,
                                     void* stream) {
  if (rows <= 0 || cap <= 0 || k <= 0) return 0;
  const int tiles = (cap + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(tiles, rows);
  cudaError_t err = cudaMemsetAsync(
      totals, 0, sizeof(int) * (size_t)rows * kPasses * kRadix, s);
  if (err != cudaSuccess) return (int)err;
  select_pack_key_kernel<<<grid, kThreads, 0, s>>>(send, ids, carry, keys_a,
                                                   pos_a, resid, hist, totals,
                                                   cap, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  uint32_t* k_in = keys_a;
  uint32_t* k_out = keys_b;
  int* p_in = pos_a;
  int* p_out = pos_b;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    if (pass > 0) {
      select_pack_hist_kernel<<<grid, kThreads, 0, s>>>(k_in, hist, cap,
                                                        tiles, shift);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    select_pack_scan_kernel<<<dim3(kRadix / kScanWarps, rows),
                              kScanWarps * 32, 0, s>>>(hist, totals, tiles,
                                                       pass);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    select_pack_scatter_kernel<<<grid, kThreads, 0, s>>>(
        k_in, p_in, k_out, p_out, hist, cap, tiles, shift);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    uint32_t* kt = k_in;
    k_in = k_out;
    k_out = kt;
    int* pt = p_in;
    p_in = p_out;
    p_out = pt;
  }
  const dim3 emit_grid((k + kThreads - 1) / kThreads, rows);
  select_pack_emit_kernel<<<emit_grid, kThreads, 0, s>>>(
      send, ids, carry, p_in, vals_k, ids_k, resid, cap, k);
  return (int)cudaGetLastError();
}
