// DPMR computeGradients map body for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sigmoid_grad` of
// src/repro/kernels/sigmoid_grad.py (`_kernel`, `pl.pallas_call`). Per row b
// of a (B, K) block of sufficient samples:
//   logit = sum_k vals*theta,  p = sigmoid(logit),
//   grads = vals * (p - y),    nll = -y log s(z) - (1-y) log s(-z)
// with the stable log s(z) = min(z, 0) - log1p(exp(-|z|)).
//
// What bounds it on this card: memory. Each element of vals and theta is
// read once and each element of grads written once, with 3 flops per
// element: 12 bytes an element. At the main path's (4096, 64) f32 that is
// 3.2 MB, a 0.95 us floor at 3.35 TB/s, so the launch and one round trip to
// memory are most of the time; at (262144, 64) it is 204 MB, 61 us, and
// bytes set the time.
//
// Design. A row is cut into 4-float chunks; a group of G lanes (the power
// of two at or above the chunk count, at most 32) takes chunks lane,
// lane + G, ... of a row, so one warp covers 32 / G rows at once (2 at
// K = 64). Where every row is 16-byte aligned (K % 4 == 0 and aligned
// pointers) a chunk is one 128-bit load (ld.global.nc.v4) and one 128-bit
// store; otherwise the same chunks are read and written a float at a time.
// A group takes one row at a time, so the main path's (4096, 64) runs as
// 512 blocks of 128 threads, one wave with a row for every thread and the
// fewest serial steps a thread. Beyond one wave the groups stride over the
// rows; the grid is sized from the SM count and the kernel's occupancy.
// Holding 4 rows a group in flight (all their loads before any reduction)
// was timed too and was slower at both (4096, 64) and (262144, 64). Rows
// longer than 128 floats take a loop over their chunks, 4 rows a warp,
// that reads vals again for the gradient (from L1).
//
// The bits: a lane sums its chunks in order, each chunk's four products
// with fused multiply-adds in order, then the group adds the lanes' sums
// by a butterfly of xor shuffles, whose every lane ends with the same bits
// (IEEE addition commutes). The tree depends on K alone, not on B or the
// pointers' alignment, so a call's bits repeat from call to call; they
// differ from the plain version's sum by f32 rounding.
//
// A second design was built and timed beside this one on the card: a
// persistent grid walking ~16 KB tiles of rows through a 3-stage ring in
// shared memory fed by 1-D bulk copies (cp.async.bulk with complete_tx on
// an mbarrier), grads written back by bulk copies from shared memory. It
// was slower at both shapes, so it is not kept.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;       // register path: a block of 4 warps
constexpr int kWarps = kThreads / kWarp;
constexpr int kRows = 4;            // rows a warp holds in flight, K > 128
constexpr int kMaxK = 128;          // the register path's longest row

struct Args {
  const float* vals;
  const float* theta;
  const int* labels;
  float* grads;
  float* probs;
  float* nll;
  long long B;
  int K;
  int chunks;   // ceil(K / 4)
  int G;        // lanes a row: a power of two >= chunks, at most 32
  int gshift;   // log2(G)
};

__host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float dot4(float acc, float4 v, float4 t) {
  acc = fmaf(v.x, t.x, acc);
  acc = fmaf(v.y, t.y, acc);
  acc = fmaf(v.z, t.z, acc);
  return fmaf(v.w, t.w, acc);
}

// The group's total of `acc`, in every lane of the group: all 32 lanes of
// the warp must call it.
__device__ __forceinline__ float group_sum(float acc, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// Chunk `c` of the row at `p`: 4 floats, those at or past K read as 0.
template <bool kVec>
__device__ __forceinline__ float4 load_chunk(const float* p, int c, int K) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p) + c);
  const int k = 4 * c;
  return make_float4(k < K ? __ldg(p + k) : 0.0f,
                     k + 1 < K ? __ldg(p + k + 1) : 0.0f,
                     k + 2 < K ? __ldg(p + k + 2) : 0.0f,
                     k + 3 < K ? __ldg(p + k + 3) : 0.0f);
}

template <bool kVec>
__device__ __forceinline__ void store_chunk(float* p, int c, int K, float4 v,
                                            float r) {
  const float4 g = make_float4(v.x * r, v.y * r, v.z * r, v.w * r);
  if (kVec) {
    reinterpret_cast<float4*>(p)[c] = g;
    return;
  }
  const int k = 4 * c;
  if (k < K) p[k] = g.x;
  if (k + 1 < K) p[k + 1] = g.y;
  if (k + 2 < K) p[k + 2] = g.z;
  if (k + 3 < K) p[k + 3] = g.w;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float nll_of(float z, float y) {
  return -(y * log_sigmoid(z) + (1.0f - y) * log_sigmoid(-z));
}

// K <= 128: one chunk a lane, held in registers from load to store; a
// group takes one row at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    sigmoid_grad_kernel(const Args a) {
  const int lane = threadIdx.x % kWarp;
  const int sub = lane & (a.G - 1);
  const int per_warp = kWarp >> a.gshift;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  const long long stride = (long long)gridDim.x * kWarps * per_warp;
  const bool has_chunk = sub < a.chunks;
  // the loop bound is the warp's, so every lane reaches the shuffles
  for (long long r0 = warp * per_warp; r0 < a.B; r0 += stride) {
    const long long row = r0 + (lane >> a.gshift);
    const bool ok = row < a.B;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), th = v;
    if (ok && has_chunk) {
      v = load_chunk<kVec>(a.vals + row * a.K, sub, a.K);
      th = load_chunk<kVec>(a.theta + row * a.K, sub, a.K);
    }
    const float y = ok ? (float)__ldg(a.labels + row) : 0.0f;
    const float z = group_sum(dot4(0.0f, v, th), a.G);
    if (!ok) continue;
    const float p = sigmoid(z);
    if (has_chunk)
      store_chunk<kVec>(a.grads + row * a.K, sub, a.K, v, p - y);
    if (sub == 0) {
      a.probs[row] = p;
      a.nll[row] = nll_of(z, y);
    }
  }
}

// K > 128: a warp a row, each lane over chunks lane, lane + 32, ...; vals
// is read again for the gradient.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    sigmoid_grad_long_kernel(const Args a) {
  const int lane = threadIdx.x % kWarp;
  const long long tiles = (a.B + kRows - 1) / kRows;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
       t < tiles; t += stride) {
    float z[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) z[r] = 0.0f;
    for (int c = lane; c < a.chunks; c += kWarp) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long row = t * kRows + r;
        if (row < a.B)
          z[r] = dot4(z[r], load_chunk<kVec>(a.vals + row * a.K, c, a.K),
                      load_chunk<kVec>(a.theta + row * a.K, c, a.K));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) z[r] = group_sum(z[r], kWarp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = t * kRows + r;
      if (row >= a.B) continue;
      const float y = (float)__ldg(a.labels + row);
      const float p = sigmoid(z[r]);
      for (int c = lane; c < a.chunks; c += kWarp)
        store_chunk<kVec>(a.grads + row * a.K, c, a.K,
                          load_chunk<kVec>(a.vals + row * a.K, c, a.K),
                          p - y);
      if (lane == r) {
        a.probs[row] = p;
        a.nll[row] = nll_of(z[r], y);
      }
    }
  }
}

__global__ void empty_kernel() {}

// One round trip on the register path's grid: each lane loads the chunk of
// vals it would load and stores it in grads' place; nothing else.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    round_trip_kernel(const Args a) {
  const int lane = threadIdx.x % kWarp;
  const int sub = lane & (a.G - 1);
  const int per_warp = kWarp >> a.gshift;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  const long long stride = (long long)gridDim.x * kWarps * per_warp;
  for (long long r0 = warp * per_warp; r0 < a.B; r0 += stride) {
    const long long row = r0 + (lane >> a.gshift);
    if (row < a.B && sub < a.chunks)
      store_chunk<kVec>(a.grads + row * a.K, sub, a.K,
                        load_chunk<kVec>(a.vals + row * a.K, sub, a.K), 1.0f);
  }
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < 64 ? dev : 0;
}

int sm_count(int dev) {
  static int cached[64];
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

using KernelFn = void (*)(Args);

KernelFn row_kernel(bool vec) {
  return vec ? sigmoid_grad_kernel<true> : sigmoid_grad_kernel<false>;
}

KernelFn long_kernel(bool vec) {
  return vec ? sigmoid_grad_long_kernel<true> : sigmoid_grad_long_kernel<false>;
}

// Blocks of kThreads that one SM holds at once of `fn`, per device.
int resident(KernelFn fn, int dev) {
  static KernelFn fns[4];
  static int counts[64][4];
  int i = 0;
  while (i < 4 && fns[i] != nullptr && fns[i] != fn) ++i;
  if (i == 4) return 1;
  fns[i] = fn;
  int& n = counts[dev][i];
  if (n == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, (const void*)fn, kThreads, 0) != cudaSuccess ||
                 n <= 0))
    n = 1;
  return n;
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The launch of a call: its kernel and grid, sized from the SM count and
// the kernel's occupancy.
void plan(Args& a, bool vec, KernelFn* fn, int* blocks) {
  a.chunks = (a.K + 3) / 4;
  a.gshift = 0;
  while ((1 << a.gshift) < a.chunks && a.gshift < 5) ++a.gshift;
  a.G = 1 << a.gshift;
  // warps a call needs: 32 / G rows a warp, or kRows rows a warp (K > 128)
  const long long warps = a.K > kMaxK ? (a.B + kRows - 1) / kRows
                                      : (a.B + (kWarp >> a.gshift) - 1) >>
                                            (5 - a.gshift);
  *fn = a.K > kMaxK ? long_kernel(vec) : row_kernel(vec);
  const int dev = current_device();
  *blocks = (int)lmin((warps + kWarps - 1) / kWarps,
                      (long long)sm_count(dev) * resident(*fn, dev));
}

int launch(const float* vals, const float* theta, const int* labels,
           float* out, long long B, int K, void* stream) {
  if (B <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  float* probs = out + round4(B * K);
  Args a{vals, theta, labels, out, probs, probs + round4(B), B, K, 0, 0, 0};
  const bool vec = K % 4 == 0 &&
                   ((uintptr_t)vals | (uintptr_t)theta | (uintptr_t)out) %
                           16 == 0;
  KernelFn fn;
  int blocks;
  plan(a, vec, &fn, &blocks);
  fn<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// grads, probs and nll in one buffer `out` of B*K + 2B floats (each part
// starting at a multiple of 4 floats): grads (B, K) at 0, probs at
// round4(B*K), nll at round4(B*K) + round4(B).
extern "C" int repro_sigmoid_grad_f32(const float* vals, const float* theta,
                                      const int* labels, float* out,
                                      long long B, int K, void* stream) {
  return launch(vals, theta, labels, out, B, K, stream);
}

// What no kernel of the launch that `repro_sigmoid_grad_f32` takes for
// (B, K) can beat, on its grid and block: with `vals` null, an empty
// kernel; otherwise (K <= 128) one round trip, `round_trip_kernel` copying
// vals into `out`'s grads part.
extern "C" int repro_sigmoid_grad_floor(const float* vals, float* out,
                                        long long B, int K, void* stream) {
  if (B <= 0) return 0;
  if (K < 0 || (vals != nullptr && K > kMaxK))
    return (int)cudaErrorInvalidValue;
  Args a{vals, nullptr, nullptr, out, nullptr, nullptr, B, K, 0, 0, 0};
  const bool vec =
      K % 4 == 0 && ((uintptr_t)vals | (uintptr_t)out) % 16 == 0;
  KernelFn fn;
  int blocks;
  plan(a, vec, &fn, &blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vals == nullptr)
    empty_kernel<<<blocks, kThreads, 0, s>>>();
  else if (vec)
    round_trip_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    round_trip_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
