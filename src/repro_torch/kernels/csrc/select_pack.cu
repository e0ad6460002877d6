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
// The rank order is the ascending order of one uint32 key: 0x7F800001 -
// bits(|comp|) for a live slot (so |-0.0| = |+0.0|, and NaN, key 0, comes
// first, as torch.sort puts it) and 0xFFFFFFFF for a dead one. The TPU
// kernel ranks a row with a (cap, cap) comparison mask in VMEM, which caps
// it at cap = 4096; the main path on one card has cap = 262,144.
//
// What bounds it on this card: memory, in principle. It must read ids and
// write resid once a slot, read send and carry only at live slots (a dead
// slot's comp is 0), and write vals_k and ids_k: 8 bytes a slot, 8 a live
// slot and 8 a winner, ~2.4 MB at cap = 262,144 with ~27,400 live and
// k = 13,108, ~0.72 us at 3.35 TB/s.
// One row is a selection, though, not a stream: only t = min(k, live)
// slots need ranking (13,108 of the ~27,400 live ones on the path), and a
// chain of dependent steps (count, pick a threshold, compact, sort) that
// cross the row's CTAs bounds it by latency, not bytes.
//
// CLUSTER PATH (every row that fits on chip, the main path at k = 13,108
// and at k = 65,536): ONE launch, one thread-block cluster of 16 CTAs per
// row (a non-portable size; 8 CTAs of 227 KB cannot hold a 1 MB row and a
// sort buffer sized by k = 65,536). The row never leaves shared memory.
// Chunk q of 2,048 slots goes to CTA q % 16, so a row whose live slots are
// a prefix (route_build's layout) spreads them over every CTA. The CTAs
// talk only through distributed shared memory: `st.async` pushes into
// other CTAs' shared memory, counted in bytes on the receiver's mbarrier,
// so a receiver waits for exactly what it expects. On the H100 an
// all-to-all push and wait costs less than one memory-ordered cluster
// barrier, and 4-byte DSMEM loads in bulk cost far more.
//  1. key pass: each thread reads 4 consecutive slots of each of its
//     CTA's chunks: ids with 16-byte loads, then send and carry only where
//     one of the 4 is live (a dead slot's comp is 0). comp and a live bit a
//     slot stay in shared memory; the top 8 key bits of live slots are
//     counted in per-warp rows (match_any, no atomics).
//  2. select: 4 rounds of 8 bits. Each CTA pushes its digit counts (16-bit
//     pairs) to all 16, sums the 16 rows, scans them and finds the digit
//     where the cumulative count crosses t; later rounds count only the
//     live keys under the prefix found so far, skipping warps with no live
//     slot. The result: live keys below T win, and the first m of those
//     equal to T (ties go by position). A bucket that wins whole ends the
//     select early (every live slot wins when k >= live: one round).
//  3. position-order counts: per (chunk, warp), slots below T, tied at T
//     and dead; one all-to-all push of every chunk's counts, and a scan in
//     row order gives each chunk its place.
//  4. compact: each warp walks its chunks once: each live winner (comp,
//     position) is pushed to its place in position order, winner w to CTA
//     w / (t / 16); resid is written once a slot (0 at live winners, comp
//     elsewhere); where k > live, the first k - live dead slots go
//     straight to the outputs after the winners. Warps with no live slot
//     and no winning dead one only write resid = 0.
//  5. sort only the t live winners: a stable LSD radix sort by key, 8 bits
//     a pass, each CTA holding t / 16 of them; a pass counts its digit,
//     pushes the counts to all, and pushes each winner to its place
//     (ranks within a warp by match_any, across warps by the warp rows).
//     A pass whose digit every winner shares is skipped: known from the
//     select for the top digits, or seen in the counts. Stability gives
//     "ties by position".
//  6. emit: each CTA writes its share of vals_k and ids_k in rank order.
// No memset, no scratch in device memory, no float atomics: the result
// does not depend on the order in which blocks run.
//
// LARGE PATH (a row whose cap, or min(k, cap) winners with their second
// buffer, exceed the cluster's shared memory; `repro_select_pack_uses_
// cluster(cap, k)` states the rule): 13 launches and a memset, a stable
// LSD radix sort of the whole row through device memory:
//  - key pass: comp, the key and the slot's position, resid = comp; the
//    row's digit totals of all four passes and the first pass's tile
//    histogram.
//  - 4 passes of 8 bits over a (tile, row) grid of 1024-slot tiles: a
//    per-tile digit histogram, a scan with one warp per (digit, row) that
//    turns tile counts into global offsets, and a stable scatter (warp
//    peers by __match_any_sync, warps by a shared-memory prefix).
//  - emit pass: the first k sorted positions give ids_k and vals_k, and
//    zero resid at live winners.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kDeadKey = 0xffffffffu;
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr int kRadix = 256;
constexpr int kPasses = 4;

__device__ __forceinline__ uint32_t live_key(float comp) {
  const uint32_t mag = __float_as_uint(comp) & 0x7fffffffu;
  return mag > kInfBits ? 0u : kInfBits + 1u - mag;
}

// ------------------------------------------------------------ large path

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;
constexpr int kRounds = kTile / kThreads;
constexpr int kScanWarps = 8;
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
    const uint32_t key = live ? live_key(comp) : kDeadKey;
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

int large_path(const float* send, const int* ids, const float* carry,
               float* vals_k, int* ids_k, float* resid, uint32_t* keys_a,
               uint32_t* keys_b, int* pos_a, int* pos_b, int* hist,
               int* totals, int rows, int cap, int k, cudaStream_t s) {
  const int tiles = (cap + kTile - 1) / kTile;
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

// ---------------------------------------------------------- cluster path

constexpr int kCtas = 16;                  // CTAs of a row's cluster
constexpr int kCThreads = 512;
constexpr int kCWarps = kCThreads / 32;
constexpr int kVec = 4;                    // slots a thread takes of a chunk
constexpr int kChunk = kCThreads * kVec;   // slots of a chunk
constexpr int kMaxChunks = 64;             // chunks a CTA may hold
constexpr int kBatch = 4;                  // chunks of send/carry at once
constexpr int kIdBatch = 8;                // chunks of ids at once
constexpr int kTableInts = kCtas * 128;    // one exchange table: 16 x 512 B
constexpr long long kSmemLimit = 232448;   // shared memory of one block
constexpr long long kStaticReserve = 1024; // the kernel's static shared
static_assert(kCThreads >= kRadix, "one thread per digit");
static_assert(kChunk % 32 == 0, "whole live-bit words a chunk");

// Chunks of `kChunk` slots each CTA of a row's cluster holds: chunk q of
// the row goes to CTA q % 16, so a prefix of live slots is shared evenly.
long long cluster_chunks(int cap) {
  const long long chunks = ((long long)cap + kChunk - 1) / kChunk;
  return (chunks + kCtas - 1) / kCtas;
}

long long cluster_wcap(int cap, int k) {
  return ((long long)(k < cap ? k : cap) + kCtas - 1) / kCtas;
}

// Dynamic shared memory of a cluster-path CTA: two winner buffers of
// (comp, position) pairs, two exchange tables, comp and a live bit per
// slot, the per-warp digit rows and the CTA's digit row, and per (chunk,
// warp) counts and per-chunk bases.
long long cluster_smem(int cap, int k) {
  const long long nq = cluster_chunks(cap);
  const long long s = nq * kChunk;
  return 2 * 8 * cluster_wcap(cap, k) + 2 * 4 * kTableInts + 4 * s +
         4 * kCWarps * kRadix + 4 * kRadix + 8 * kCWarps * nq + 12 * nq +
         s / 8;
}

struct Tri {
  int a, b, c;
};

__device__ __forceinline__ Tri add(Tri x, Tri y) {
  return Tri{x.a + y.a, x.b + y.b, x.c + y.c};
}

// Exclusive scan over the block's threads in thread order; `total` is the
// block's sum. Every thread of the block calls it.
__device__ Tri block_exclusive_scan(Tri v, Tri* s_warp, Tri& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Tri inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Tri u{__shfl_up_sync(kFull, inc.a, off),
                __shfl_up_sync(kFull, inc.b, off),
                __shfl_up_sync(kFull, inc.c, off)};
    if (lane >= off) inc = add(inc, u);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  Tri before{0, 0, 0}, all{0, 0, 0};
#pragma unroll
  for (int w = 0; w < kCWarps; ++w) {
    const Tri x = s_warp[w];
    if (w < warp) before = add(before, x);
    all = add(all, x);
  }
  __syncthreads();
  total = all;
  return Tri{before.a + inc.a - v.a, before.b + inc.b - v.b,
             before.c + inc.c - v.c};
}

// row[d] += 1 for each lane with `on`, in the warp's own row of counts:
// one lane adds for each distinct d, so no atomics. Every lane of the
// warp calls it.
__device__ __forceinline__ void hist_add(int* row, int d, bool on) {
  if (!__any_sync(kFull, on)) return;
  const unsigned peers = __match_any_sync(kFull, on ? d : -1);
  if (on && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    row[d] += __popc(peers);
  __syncwarp();
}

// hist[d] = the sum of the warps' rows; `clear` zeroes the rows.
__device__ __forceinline__ void gather_rows(int* rows, int* hist,
                                            bool clear) {
  if (threadIdx.x < kRadix) {
    int v[kCWarps];
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) v[w] = rows[w * kRadix + threadIdx.x];
    int c = 0;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) {
      c += v[w];
      if (clear) rows[w * kRadix + threadIdx.x] = 0;
    }
    hist[threadIdx.x] = c;
  }
}

// --- distributed shared memory through st.async and mbarriers: a CTA
// pushes data into other CTAs' shared memory, and each store counts its
// bytes on the receiver's mbarrier, so the receiver waits for exactly
// what it expects, with no cluster-wide memory fence.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned remote(unsigned addr, int cta) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(cta));
  return out;
}

__device__ __forceinline__ void push4(unsigned addr, int4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push2(unsigned addr, uint2 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the mbarrier's phase of this parity; trap instead of hanging
// if it has not completed within ~2^31 cycles (a lost byte count).
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) __trap();
  }
}

// One all-to-all exchange: every CTA sends the same number `n4` of int4
// words (n4 <= 32) from `words` into slot [its rank] of `table` in every
// CTA, then waits until the 16 senders' words are in its own table.
__device__ __forceinline__ void exchange(const int4* words, int n4,
                                         int* table, unsigned bar,
                                         unsigned parity, int rank) {
  if (threadIdx.x == 0) expect_bytes(bar, (unsigned)(kCtas * n4 * 16));
  for (int e = threadIdx.x; e < kCtas * n4; e += kCThreads) {
    const int dst = e / n4;
    const int part = e % n4;
    push4(remote(smem_addr(table + 4 * (rank * n4 + part)), dst),
          words[part], remote(bar, dst));
  }
  wait_phase(bar, parity);
}

// Digit d's count over the cluster from an exchanged table of 16-bit
// pairs: (all CTAs, the CTAs before `rank`, 0).
__device__ __forceinline__ Tri digit_counts(const int* table, int d,
                                            int rank) {
  Tri r{0, 0, 0};
#pragma unroll
  for (int c = 0; c < kCtas; ++c) {
    const int v = (table[c * 128 + d / 2] >> (16 * (d & 1))) & 0xffff;
    r.a += v;
    if (c < rank) r.b += v;
  }
  return r;
}

__device__ __forceinline__ unsigned nibble_at(const uint32_t* s_live,
                                              int j) {
  return (s_live[j >> 5] >> (j & 31)) & 0xfu;
}

__global__ void __launch_bounds__(kCThreads, 1)
    select_pack_cluster_kernel(const float* __restrict__ send,
                               const int* __restrict__ ids,
                               const float* __restrict__ carry,
                               float* __restrict__ vals_k,
                               int* __restrict__ ids_k,
                               float* __restrict__ resid, int cap, int k,
                               int nq, int wcap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* buf0 = reinterpret_cast<uint2*>(smem);
  uint2* buf1 = buf0 + wcap;
  int* tables = reinterpret_cast<int*>(buf1 + wcap);       // [2][16 x 128]
  float* s_comp = reinterpret_cast<float*>(tables + 2 * kTableInts);
  int* s_rows = reinterpret_cast<int*>(s_comp + nq * kChunk);  // warp rows
  int* s_row = s_rows + kCWarps * kRadix;                  // [radix]
  int2* s_cw = reinterpret_cast<int2*>(s_row + kRadix);   // [chunks][warps]
  Tri* s_cbase = reinterpret_cast<Tri*>(s_cw + nq * kCWarps);  // [chunks]
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_cbase + nq);
  __shared__ __align__(8) unsigned long long s_bar[4];  // tables x2, pushes x2
  __shared__ int4 s_pack[32];
  __shared__ Tri s_scan[kCWarps];
  __shared__ int s_cross[3];

  const int rank = (int)cg::this_cluster().block_rank();
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long rbase = (long long)row * cap;
  int n_tables = 0, n_pushes = 0;
  auto table_bar = [&]() { return smem_addr(&s_bar[n_tables & 1]); };
  auto push_bar = [&]() { return smem_addr(&s_bar[2 + (n_pushes & 1)]); };

  if (tid == 0) {
    for (int b = 0; b < 4; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&s_bar[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA's barriers exist before any CTA pushes: arrive now, wait
  // after the key pass
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  int* wrow = s_rows + warp * kRadix;
  for (int i = tid; i < kCWarps * kRadix; i += kCThreads) s_rows[i] = 0;
  __syncthreads();

  // 1. key pass: chunk i of this CTA is chunk i * 16 + rank of the row;
  // thread tid takes its slots 4 tid .. 4 tid + 3
  // the ids of kIdBatch chunks first; then send and carry only where a
  // lane holds a live slot (a dead slot's comp is 0 whatever they hold)
  for (int i0 = 0; i0 < nq; i0 += kIdBatch) {
    int4 id[kIdBatch];
#pragma unroll
    for (int b = 0; b < kIdBatch; ++b) {
      const long long p =
          (long long)((i0 + b) * kCtas + rank) * kChunk + kVec * tid;
      id[b] = make_int4(-1, -1, -1, -1);
      if (i0 + b >= nq || p >= cap) continue;
      if (vec && p + kVec <= cap) {
        id[b] = *reinterpret_cast<const int4*>(ids + rbase + p);
      } else {
        int* ii = &id[b].x;
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (p + v < cap) ii[v] = ids[rbase + p + v];
      }
    }
#pragma unroll
    for (int b0 = 0; b0 < kIdBatch; b0 += kBatch) {
      float4 s[kBatch], c[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const long long p =
            (long long)((i0 + b0 + b) * kCtas + rank) * kChunk + kVec * tid;
        const int4 ii = id[b0 + b];
        s[b] = c[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if ((ii.x & ii.y & ii.z & ii.w) < 0) continue;  // no live slot
        if (vec && p + kVec <= cap) {
          s[b] = *reinterpret_cast<const float4*>(send + rbase + p);
          c[b] = *reinterpret_cast<const float4*>(carry + rbase + p);
        } else {
          float* ss = &s[b].x;
          float* cc = &c[b].x;
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            if (p + v < cap) {
              ss[v] = send[rbase + p + v];
              cc[v] = carry[rbase + p + v];
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b0 + b;
        if (i >= nq) break;  // the same for the block
        const int* ii = &id[b0 + b].x;
        const float* ss = &s[b].x;
        const float* cc = &c[b].x;
        float comp[kVec];
        unsigned nib = 0;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const bool live = ii[v] >= 0;
          comp[v] = live ? __fadd_rn(ss[v], cc[v]) : 0.0f;
          nib |= (unsigned)live << v;
        }
        const int j = i * kChunk + kVec * tid;
        *reinterpret_cast<float4*>(s_comp + j) =
            make_float4(comp[0], comp[1], comp[2], comp[3]);
        // 8 lanes' nibbles make one 32-slot word of live bits
        unsigned word = nib << (4 * (lane & 7));
        word |= __shfl_xor_sync(kFull, word, 1);
        word |= __shfl_xor_sync(kFull, word, 2);
        word |= __shfl_xor_sync(kFull, word, 4);
        if ((lane & 7) == 0) s_live[j >> 5] = word;
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          hist_add(wrow, (int)(live_key(comp[v]) >> 24), (nib >> v) & 1u);
      }
    }
  }
  __syncthreads();
  gather_rows(s_rows, s_row, true);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  // 2. select: live keys below t_lo win, and the first m (in position
  // order) of those equal to `prefix`
  int t = 0, need = 0, m = 0;
  int uniform = 0;  // leading rounds whose digit every winner shares
  uint32_t prefix = 0;
  unsigned long long t_lo = 0;
  for (int r = 0; r < 4; ++r) {
    const int shift = 24 - 8 * r;
    if (r > 0) {
      const uint32_t above = ~0u << (shift + 8);
      for (int i = 0; i < nq; ++i) {
        const int j = i * kChunk + kVec * tid;
        const unsigned nib = nibble_at(s_live, j);
        if (!__any_sync(kFull, nib != 0)) continue;
        const float4 cv = *reinterpret_cast<const float4*>(s_comp + j);
        const float comp[kVec] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const uint32_t key = live_key(comp[v]);
          hist_add(wrow, (int)((key >> shift) & 0xffu),
                   ((nib >> v) & 1u) && ((key ^ prefix) & above) == 0);
        }
      }
      __syncthreads();
      gather_rows(s_rows, s_row, true);
    }
    __syncthreads();
    if (tid < 128)
      reinterpret_cast<int*>(s_pack)[tid] =
          (s_row[2 * tid] & 0xffff) | (s_row[2 * tid + 1] << 16);
    __syncthreads();
    int* table = tables + (n_tables & 1) * kTableInts;
    exchange(s_pack, 32, table, table_bar(), (n_tables >> 1) & 1, rank);
    ++n_tables;
    const Tri v = tid < kRadix ? digit_counts(table, tid, rank)
                               : Tri{0, 0, 0};
    Tri tot;
    const Tri ex = block_exclusive_scan(Tri{v.a, 0, 0}, s_scan, tot);
    if (r == 0) {
      t = min(k, tot.a);
      need = t;
      if (t == 0) break;  // t is the same in every CTA of the cluster
    }
    if (tid < kRadix && ex.a < need && ex.a + v.a >= need) {
      s_cross[0] = tid;
      s_cross[1] = ex.a;
      s_cross[2] = v.a;
    }
    // the lowest digit counted: if it is the crossing digit, every winner
    // has that digit
    const bool low = __syncthreads_or(tid < kRadix && ex.a == 0 &&
                                      v.a >= need && need > 0);
    if (low && uniform == r) uniform = r + 1;
    need -= s_cross[1];
    prefix |= (uint32_t)s_cross[0] << shift;
    if (s_cross[2] == need) {  // every key under the prefix wins
      t_lo = ((unsigned long long)(prefix >> shift) + 1) << shift;
      break;
    }
    if (r == 3) {
      t_lo = prefix;
      m = need;
    }
  }

  // 3. position-order counts of each (chunk, warp): live slots below t_lo
  // and tied at `prefix` (x = less | tie << 16), dead slots (y)
  auto flags = [&](int i, float* comp, unsigned& less, unsigned& tie,
                   unsigned& dead) {
    const int j = i * kChunk + kVec * tid;
    const long long p = (long long)(i * kCtas + rank) * kChunk + kVec * tid;
    const unsigned nib = nibble_at(s_live, j);
    const float4 cv = *reinterpret_cast<const float4*>(s_comp + j);
    comp[0] = cv.x;
    comp[1] = cv.y;
    comp[2] = cv.z;
    comp[3] = cv.w;
    less = tie = dead = 0;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const bool live = (nib >> v) & 1u;
      const uint32_t key = live_key(comp[v]);
      less |= (unsigned)(live && key < t_lo) << v;
      tie |= (unsigned)(live && m > 0 && key == prefix) << v;
      dead |= (unsigned)(!live && p + v < cap) << v;
    }
  };
  for (int i = 0; i < nq; ++i) {
    if (!__any_sync(kFull, nibble_at(s_live, i * kChunk + kVec * tid))) {
      // no live slot in the warp's 128: only dead ones, up to the row's end
      const long long pw = (long long)(i * kCtas + rank) * kChunk + 128 * warp;
      if (lane == 0)
        s_cw[i * kCWarps + warp] =
            make_int2(0, (int)max(0ll, min(128ll, (long long)cap - pw)));
      continue;
    }
    float comp[kVec];
    unsigned less, tie, dead;
    flags(i, comp, less, tie, dead);
    const int x = __reduce_add_sync(
        kFull, (unsigned)(__popc(less) | (__popc(tie) << 16)));
    const int y = __reduce_add_sync(kFull, (unsigned)__popc(dead));
    if (lane == 0) s_cw[i * kCWarps + warp] = make_int2(x, y);
  }
  __syncthreads();
  if (tid < nq) {  // per-warp counts become prefixes within the chunk
    int2 run = make_int2(0, 0);
    for (int w = 0; w < kCWarps; ++w) {
      const int2 c = s_cw[tid * kCWarps + w];
      s_cw[tid * kCWarps + w] = run;
      run.x += c.x;
      run.y += c.y;
    }
    reinterpret_cast<int2*>(s_pack)[tid] = run;
  }
  const int n4 = (2 * nq + 3) / 4;
  if (tid >= nq && tid < 2 * n4)
    reinterpret_cast<int2*>(s_pack)[tid] = make_int2(0, 0);
  __syncthreads();
  {
    int* table = tables + (n_tables & 1) * kTableInts;
    exchange(s_pack, n4, table, table_bar(), (n_tables >> 1) & 1, rank);
    ++n_tables;
    // chunk q = 16 i + c of the row, in row order, a few to a thread
    const int chunks = kCtas * nq;
    const int per = (chunks + kCThreads - 1) / kCThreads;
    auto chunk_counts = [&](int q) {
      const int* w = table + (q % kCtas) * 4 * n4 + 2 * (q / kCtas);
      return Tri{w[0] & 0xffff, (w[0] >> 16) & 0xffff, w[1]};
    };
    Tri mine{0, 0, 0};
    for (int q = tid * per; q < min(chunks, (tid + 1) * per); ++q)
      mine = add(mine, chunk_counts(q));
    Tri all;
    Tri base = block_exclusive_scan(mine, s_scan, all);
    for (int q = tid * per; q < min(chunks, (tid + 1) * per); ++q) {
      if (q % kCtas == rank) s_cbase[q / kCtas] = base;
      base = add(base, chunk_counts(q));
    }
  }
  __syncthreads();

  // 4. compact: each live winner (comp, position) goes to its place in
  // position order, winner w to CTA w / wt; resid once a slot; the first
  // k - t dead slots after the winners
  const int dead_quota = k - t;
  const int wt = max(1, (t + kCtas - 1) / kCtas);  // winners a CTA holds
  const int cn = max(0, min(wt, t - rank * wt));
  const unsigned lt = (1u << lane) - 1u;
  if (tid == 0) expect_bytes(push_bar(), (unsigned)(cn * 8));
  for (int i = 0; i < nq; ++i) {
    const long long p = (long long)(i * kCtas + rank) * kChunk + kVec * tid;
    const int2 wb = s_cw[i * kCWarps + warp];
    const Tri cb = s_cbase[i];
    if (!__any_sync(kFull, nibble_at(s_live, i * kChunk + kVec * tid)) &&
        cb.c + wb.y >= dead_quota) {
      // no live slot and no winning dead one: resid = comp = 0
      if (vec && p + kVec <= cap) {
        *reinterpret_cast<float4*>(resid + rbase + p) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (p + v < cap) resid[rbase + p + v] = 0.0f;
      }
      continue;
    }
    float comp[kVec];
    unsigned less, tie, dead;
    flags(i, comp, less, tie, dead);
    // this lane's place among the warp's lanes
    int x = __popc(less) | (__popc(tie) << 16);
    int y = __popc(dead);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ux = __shfl_up_sync(kFull, x, off);
      const int uy = __shfl_up_sync(kFull, y, off);
      if (lane >= off) {
        x += ux;
        y += uy;
      }
    }
    x -= __popc(less) | (__popc(tie) << 16);
    y -= __popc(dead);
    int n_less = cb.a + (wb.x & 0xffff) + (x & 0xffff);
    int n_tie = cb.b + (wb.x >> 16) + (x >> 16);
    int n_dead = cb.c + wb.y + y;
    float out[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const bool is_less = (less >> v) & 1u;
      const bool is_tie = (tie >> v) & 1u;
      const bool win = is_less || (is_tie && n_tie < m);
      if (win) {
        const int w = n_less + min(m, n_tie);
        push2(remote(smem_addr(buf0 + w % wt), w / wt),
              make_uint2(__float_as_uint(comp[v]), (unsigned)(p + v)),
              remote(push_bar(), w / wt));
      }
      if (((dead >> v) & 1u) && n_dead < dead_quota) {
        const long long o = (long long)row * k + t + n_dead;
        ids_k[o] = ids[rbase + p + v];
        vals_k[o] = 0.0f;
      }
      out[v] = win ? 0.0f : comp[v];
      n_less += is_less;
      n_tie += is_tie;
      n_dead += (dead >> v) & 1u;
    }
    if (vec && p + kVec <= cap) {
      *reinterpret_cast<float4*>(resid + rbase + p) =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (p + v < cap) resid[rbase + p + v] = out[v];
    }
  }
  wait_phase(push_bar(), (n_pushes >> 1) & 1);
  ++n_pushes;

  // 5. stable LSD radix sort of the t winners, wt to a CTA: a pass counts
  // its digit, exchanges the counts, and pushes each winner to its place
  uint2* cur = buf0;
  uint2* nxt = buf1;
  if (t > 1) {
    const int seg = (cn + kCWarps - 1) / kCWarps;
    const int a0 = min(cn, warp * seg);
    const int a1 = min(cn, a0 + seg);
    for (int pass = 0; pass < kPasses - uniform; ++pass) {
      const int shift = 8 * pass;
      for (int d = lane; d < kRadix; d += 32) wrow[d] = 0;
      __syncwarp();
      for (int i0 = a0; i0 < a1; i0 += 32) {
        const int i = i0 + lane;
        const bool on = i < a1;
        hist_add(wrow,
                 on ? (int)((live_key(__uint_as_float(cur[i].x)) >> shift) &
                            0xffu)
                    : 0,
                 on);
      }
      __syncthreads();
      gather_rows(s_rows, s_row, false);
      __syncthreads();
      if (tid < 128)
        reinterpret_cast<int*>(s_pack)[tid] =
            (s_row[2 * tid] & 0xffff) | (s_row[2 * tid + 1] << 16);
      __syncthreads();
      int* table = tables + (n_tables & 1) * kTableInts;
      exchange(s_pack, 32, table, table_bar(), (n_tables >> 1) & 1, rank);
      ++n_tables;
      const Tri v = tid < kRadix ? digit_counts(table, tid, rank)
                                 : Tri{0, 0, 0};
      // every winner has the same digit: the pass would move nothing
      if (__syncthreads_or(tid < kRadix && v.a == t)) continue;
      Tri tot;
      const Tri ex = block_exclusive_scan(Tri{v.a, 0, 0}, s_scan, tot);
      if (tid < kRadix) {
        int c[kCWarps];
#pragma unroll
        for (int w = 0; w < kCWarps; ++w) c[w] = s_rows[w * kRadix + tid];
        int base = ex.a + v.b;  // the digit's start here, in the cluster
#pragma unroll
        for (int w = 0; w < kCWarps; ++w) {
          s_rows[w * kRadix + tid] = base;
          base += c[w];
        }
      }
      __syncthreads();
      const unsigned bar = push_bar();
      if (tid == 0) expect_bytes(bar, (unsigned)(cn * 8));
      for (int i0 = a0; i0 < a1; i0 += 32) {
        const int i = i0 + lane;
        const bool on = i < a1;
        const uint2 x = on ? cur[i] : make_uint2(0u, 0u);
        const int d =
            on ? (int)((live_key(__uint_as_float(x.x)) >> shift) & 0xffu)
               : -1;
        const unsigned peers = __match_any_sync(kFull, d);
        if (on) {
          const int dst = wrow[d] + __popc(peers & lt);
          push2(remote(smem_addr(nxt + dst % wt), dst / wt), x,
                remote(bar, dst / wt));
        }
        __syncwarp();
        if (on && lane == __ffs(peers) - 1) wrow[d] += __popc(peers);
        __syncwarp();
      }
      wait_phase(bar, (n_pushes >> 1) & 1);
      ++n_pushes;
      uint2* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  // 6. emit this CTA's share of the ranked winners
  for (int i = tid; i < cn; i += kCThreads) {
    const uint2 x = cur[i];
    const long long o = (long long)row * k + (long long)rank * wt + i;
    vals_k[o] = __uint_as_float(x.x);
    ids_k[o] = ids[rbase + x.y];
  }
  // no CTA leaves while a push to it may still be in flight
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

void cluster_launch_config(int rows, int cap, int k, cudaStream_t s,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCtas, rows, 1);
  cfg->blockDim = dim3(kCThreads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)cluster_smem(cap, k);
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The cluster kernel's setup, done once and kept: per device, its
// attributes (the largest dynamic shared memory the path rule admits, the
// non-portable cluster size) and its static shared memory checked; per
// (device, cap, k), the clusters the card places at once. The path rule
// and the launch depend on nothing else, so a call after the first goes
// straight to the launch.
constexpr int kMaxDevices = 64;
constexpr int kPlacedKept = 64;
struct Placed {
  int device, cap, k, clusters;
};
std::mutex g_setup_mu;
bool g_attrs_set[kMaxDevices] = {};
Placed g_placed[kPlacedKept];
int g_placed_n = 0;

// How many row clusters of (cap, k) the current device runs at once
// (cudaOccupancyMaxActiveClusters, after the kernel's attributes are set),
// or the CUDA error that stopped the check.
cudaError_t cluster_placement(int cap, int k, int* clusters) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup_mu);
  for (int i = 0; i < g_placed_n && i < kPlacedKept; ++i) {
    const Placed& e = g_placed[i];
    if (e.device == device && e.cap == cap && e.k == k) {
      *clusters = e.clusters;
      return cudaSuccess;
    }
  }
  if (!g_attrs_set[device]) {
    err = cudaFuncSetAttribute(select_pack_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kSmemLimit - kStaticReserve));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(select_pack_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, select_pack_cluster_kernel);
    if (err != cudaSuccess) return err;
    if ((long long)fa.sharedSizeBytes > kStaticReserve)
      return cudaErrorInvalidConfiguration;
    g_attrs_set[device] = true;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_launch_config(1, cap, k, 0, &cfg, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, select_pack_cluster_kernel, &cfg);
  if (err != cudaSuccess) return err;
  // the oldest entry gives way once the table is full
  g_placed[g_placed_n % kPlacedKept] = Placed{device, cap, k, n};
  ++g_placed_n;
  *clusters = n;
  return cudaSuccess;
}

}  // namespace

// The path rule, a function of (cap, k) alone: a row takes the cluster
// path when its cluster's shared memory holds it.
extern "C" long long repro_select_pack_cluster_smem(int cap, int k) {
  return cluster_smem(cap, k);
}
extern "C" int repro_select_pack_uses_cluster(int cap, int k) {
  return cluster_chunks(cap) <= kMaxChunks &&
         cluster_smem(cap, k) + kStaticReserve <= kSmemLimit;
}
extern "C" int repro_select_pack_cluster_size() { return kCtas; }
extern "C" int repro_select_pack_tile_size() { return kTile; }
extern "C" int repro_select_pack_radix() { return kRadix; }

// How many row clusters of (cap, k) the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int repro_select_pack_max_clusters(int cap, int k) {
  int n = 0;
  const cudaError_t err = cluster_placement(cap, k, &n);
  return err != cudaSuccess ? -(int)err : n;
}

// send, carry: (rows, cap) f32; ids: (rows, cap) int32. Outputs vals_k,
// ids_k (rows, k) and resid (rows, cap). 1 <= k <= cap, rows <= 65535,
// rows * cap < 2^31. The cluster path (repro_select_pack_uses_cluster)
// takes no scratch: the scratch pointers may be null. The large path takes
// keys_a, keys_b, pos_a, pos_b (rows, cap) 32-bit each; hist (rows, radix
// * tiles) int32 with tiles = ceil(cap / tile); totals (rows, 4, radix)
// int32, zeroed here.
extern "C" int repro_select_pack_f32(const float* send, const int* ids,
                                     const float* carry, float* vals_k,
                                     int* ids_k, float* resid,
                                     uint32_t* keys_a, uint32_t* keys_b,
                                     int* pos_a, int* pos_b, int* hist,
                                     int* totals, int rows, int cap, int k,
                                     void* stream) {
  if (rows <= 0 || cap <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (repro_select_pack_uses_cluster(cap, k)) {
    int clusters = 0;
    cudaError_t err = cluster_placement(cap, k, &clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cluster_launch_config(rows, cap, k, s, &cfg, attr);
    // 16-byte loads and stores when every row starts on 16 bytes
    const int vec = cap % kVec == 0 &&
                    ((uintptr_t)send | (uintptr_t)ids | (uintptr_t)carry |
                     (uintptr_t)resid) % 16 == 0;
    err = cudaLaunchKernelEx(&cfg, select_pack_cluster_kernel, send, ids,
                             carry, vals_k, ids_k, resid, cap, k,
                             (int)cluster_chunks(cap),
                             (int)cluster_wcap(cap, k), vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return large_path(send, ids, carry, vals_k, ids_k, resid, keys_a, keys_b,
                    pos_a, pos_b, hist, totals, rows, cap, k, s);
}
