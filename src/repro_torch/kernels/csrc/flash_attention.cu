// Causal (or full) attention forward with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (`_kernel`, `pl.pallas_call`). For
// q (B, Sq, H, D), k and v (B, Skv, KH, D), bf16, with H % KH == 0:
//   out[b,i,h] = sum_j softmax_j(q[b,i,h] . k[b,j,h/g] / sqrt(D)) v[b,j,h/g]
// (g = H / KH, the GQA group), where with `causal` key j is visible from
// query i when j <= i + (Skv - Sq): the bottom-right alignment of the
// plain version (`ref.flash_attention_ref`), which for Sq == Skv is the
// Pallas kernel's own mask. Masked scores are the finite -1e30 of both.
// The output is bf16; the softmax state and both products accumulate in
// f32, and the probabilities enter the second product as bf16, as in the
// reference's XLA prefill path (`p.astype(v.dtype)`).
//
// What bounds it on this card: tensor-core operations. At the serve path's
// shape, q (8, 4096, 32, 128) and k, v (8, 4096, 4, 128), a causal call is
// ~1.1 TFLOP against ~0.6 GB read and written: ~1.1 ms at 989 TFLOP/s,
// ~0.18 ms at 3.35 TB/s.
//
// Design (right and simple first): one block of 4 warps per (64 query
// rows, b, h); the grid walks query tiles last-first, so the long causal
// rows start first. The block stages its q tile in shared memory, then
// loops over K/V tiles of 64 keys from tile 0 up to its causal limit,
// skipping the tiles wholly in the future as the Pallas `pl.when` does.
// Tile 0 always holds key 0, which every row sees, so each row's running
// max is finite after its first tile. Each warp owns 16 query rows: it
// computes its 16x64 strip of scores with `nvcuda::wmma` bf16 fragments
// (16x16x16, f32 accumulate) into shared memory, runs the online softmax
// on its rows (two columns per lane, warp-shuffle max and sum), rescales
// its rows of the f32 output accumulator in shared memory, and adds
// P V with wmma, loading and storing the accumulator fragments. Only the
// K/V tile loads need the whole block in step. Loads are 16 bytes a
// thread, read in place by strides from the (B, S, H, D) layout: no
// transpose and no repeated K/V. Rows and keys past the ragged edges are
// zero-filled and masked. About 111 KB of dynamic shared memory at
// D = 128 (rows padded by 16 bytes against bank conflicts), so two blocks
// fit an SM. wgmma, TMA and register-resident accumulators are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTileQ / kWarps;   // 16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kLdH = D + 8;        // bf16 row pitch of q, k, v
  static constexpr int kLdS = kTileK + 4;   // f32 row pitch of the scores
  static constexpr int kLdP = kTileK + 8;   // bf16 row pitch of the probs
  static constexpr int kLdO = D + 4;        // f32 row pitch of the output
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(__nv_bfloat16) * kTileQ * kLdH;
  static constexpr size_t kV = kK + sizeof(__nv_bfloat16) * kTileK * kLdH;
  static constexpr size_t kS = kV + sizeof(__nv_bfloat16) * kTileK * kLdH;
  static constexpr size_t kP = kS + sizeof(float) * kTileQ * kLdS;
  static constexpr size_t kO = kP + sizeof(__nv_bfloat16) * kTileQ * kLdP;
  static constexpr size_t kM = kO + sizeof(float) * kTileQ * kLdO;
  static constexpr size_t kL = kM + sizeof(float) * kTileQ;
  static constexpr size_t kBytes = kL + sizeof(float) * kTileQ;
};

// Copy a tile of 64 rows of D bf16 (row stride `ld` elements) into a
// shared tile of pitch `pitch`, 16 bytes a thread; rows from `first` at
// or past `limit` are 0.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch,
                                          const __nv_bfloat16* src,
                                          long long ld, int first, int limit) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(first + r) * ld +
                                            c * 8);
    *reinterpret_cast<uint4*>(dst + r * pitch + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                       int H, int KH, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  float* o_s = reinterpret_cast<float*>(smem + L::kO);
  float* m_s = reinterpret_cast<float*>(smem + L::kM);
  float* l_s = reinterpret_cast<float*>(smem + L::kL);

  const int q_tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = q_tile * kTileQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int shift = Skv - Sq;

  const __nv_bfloat16* q_bh = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* k_bh = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* v_bh = v + b * v_sb + kvh * v_sh;

  load_tile<D>(q_s, L::kLdH, q_bh, q_ss, q0, Sq);
  for (int i = threadIdx.x; i < kTileQ * L::kLdO; i += kThreads) o_s[i] = 0.f;
  if (threadIdx.x < kTileQ) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  // this warp's 16 rows of q, held as fragments for every K/V tile
  const int r0 = warp * kRowsPerWarp;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      q_frag[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(q_frag[kk], q_s + r0 * L::kLdH + kk * 16, L::kLdH);

  // tiles 0 .. n_tiles-1; under `causal`, none past the last row's limit
  int n_tiles = (Skv + kTileK - 1) / kTileK;
  if (causal) {
    const int last_row = min(q0 + kTileQ, Sq) - 1;
    n_tiles = min(n_tiles, (last_row + shift) / kTileK + 1);
  }
  const float scale2 = scale * kLog2e;   // softmax in base 2

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileK;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<D>(k_s, L::kLdH, k_bh, k_ss, k0, Skv);
    load_tile<D>(v_s, L::kLdH, v_bh, v_ss, k0, Skv);
    __syncthreads();

    // S = q k^T for this warp's 16 rows: 4 fragments of 16 keys
#pragma unroll
    for (int n = 0; n < kTileK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            k_frag;
        wmma::load_matrix_sync(k_frag, k_s + n * 16 * L::kLdH + kk * 16,
                               L::kLdH);
        wmma::mma_sync(acc, q_frag[kk], k_frag, acc);
      }
      wmma::store_matrix_sync(s_s + r0 * L::kLdS + n * 16, acc, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on the warp's rows; lane holds keys lane, lane + 32
    for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
      const int qpos = q0 + r;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos + shift);
        s[j] = ok ? s_s[r * L::kLdS + lane + 32 * j] * scale2 : kNegInf;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = exp2f(s[0] - m_new), p1 = exp2f(s[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = exp2f(m_old - m_new);
      p_s[r * L::kLdP + lane] = __float2bfloat16(p0);
      p_s[r * L::kLdP + lane + 32] = __float2bfloat16(p1);
#pragma unroll
      for (int c = lane; c < D; c += 32) o_s[r * L::kLdO + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncwarp();

    // O += P V for the warp's rows: D / 16 output fragments
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        p_frag[kTileK / 16];
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wmma::load_matrix_sync(p_frag[kk], p_s + r0 * L::kLdP + kk * 16,
                             L::kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = o_s + r0 * L::kLdO + n * 16;
      wmma::load_matrix_sync(acc, o_tile, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            v_frag;
        wmma::load_matrix_sync(v_frag, v_s + kk * 16 * L::kLdH + n * 16,
                               L::kLdH);
        wmma::mma_sync(acc, p_frag[kk], v_frag, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, L::kLdO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // out = O / l for the warp's rows inside Sq; out is (B, Sq, H, D) dense
  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    const int qpos = q0 + r;
    if (qpos >= Sq) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* o_row = out + (((long long)b * Sq + qpos) * H + h) * D;
    for (int c = 2 * lane; c < D; c += 64)
      *reinterpret_cast<__nv_bfloat162*>(o_row + c) = __floats2bfloat162_rn(
          o_s[r * L::kLdO + c] * inv, o_s[r * L::kLdO + c + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KH, const long long* strides,
           float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, B * H);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, KH, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], strides[8], scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 9 element strides, (batch, seq, head) of q, then of k, then of
// v; the head dim is dense. out is a dense (B, Sq, H, D). Returns a CUDA
// error code (0 = launched), or -1 for a D the kernel has no instance of.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Sq, int Skv, int H, int KH,
                                          int D, const long long* strides,
                                          float scale, int causal,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>(q, k, v, out, B, Sq, Skv, H, KH, strides, scale, causal,
                      s);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Sq, Skv, H, KH, strides, scale,
                       causal, s);
  return -1;
}
