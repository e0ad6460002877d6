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
// element; at the main path's (4096, 64) f32 that is ~3.2 MB, a ~1 us
// floor at 3.35 TB/s, so the ~2-3 us launch overhead dominates.
//
// Design: one warp per row, eight rows per 256-thread block. Lanes walk the
// row 32 columns at a time, so each load of a warp touches 128 contiguous
// bytes; the logit is reduced with __shfl_xor_sync and p and nll are
// computed once per row by every lane (no shared memory, no second pass
// over device memory). The first VCACHE strides of vals stay in registers
// for the gradient write; a longer row re-reads vals from L1. A ragged
// batch and any K are masked by the loop bounds: there is no tile shape
// to divide.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kVCache = 4;   // register-held strides of vals (K <= 128)

__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
}

__global__ void sigmoid_grad_kernel(const float* __restrict__ vals,
                                    const float* __restrict__ theta,
                                    const int* __restrict__ labels,
                                    float* __restrict__ grads,
                                    float* __restrict__ probs,
                                    float* __restrict__ nll, int B, int K) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;
  const float* v_row = vals + row * (long long)K;
  const float* t_row = theta + row * (long long)K;

  float vcache[kVCache];
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kVCache; ++j) {
    const int k = lane + j * kWarp;
    const float v = k < K ? v_row[k] : 0.0f;
    vcache[j] = v;
    if (k < K) acc += v * t_row[k];
  }
  for (int k = lane + kVCache * kWarp; k < K; k += kWarp)
    acc += v_row[k] * t_row[k];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);

  const float z = acc;
  const float p = 1.0f / (1.0f + expf(-z));
  const float y = (float)labels[row];
  const float r = p - y;

  float* g_row = grads + row * (long long)K;
#pragma unroll
  for (int j = 0; j < kVCache; ++j) {
    const int k = lane + j * kWarp;
    if (k < K) g_row[k] = vcache[j] * r;
  }
  for (int k = lane + kVCache * kWarp; k < K; k += kWarp)
    g_row[k] = v_row[k] * r;

  if (lane == 0) {
    probs[row] = p;
    nll[row] = -(y * log_sigmoid(z) + (1.0f - y) * log_sigmoid(-z));
  }
}

}  // namespace

extern "C" int repro_sigmoid_grad_f32(const float* vals, const float* theta,
                                      const int* labels, float* grads,
                                      float* probs, float* nll, int B, int K,
                                      void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  sigmoid_grad_kernel<<<blocks, kRowsPerBlock * kWarp, 0,
                        (cudaStream_t)stream>>>(vals, theta, labels, grads,
                                                probs, nll, B, K);
  return (int)cudaGetLastError();
}
