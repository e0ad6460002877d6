// The sparse optimizer over the rows a step touched, for Hopper (sm_90a).
//
// The JAX package has no such kernel: its optimizer takes a dense (F,)
// gradient and passes over the whole table. Here the owner's reduce hands
// over its sorted run totals instead (`ops.sorted_run_totals` over the
// received ids and sums), and this kernel applies `sgd` or `adagrad` to the
// rows they name. A row whose gradient is +0.0 keeps its bits under both
// (with adagrad's eps > 0), so the result is the dense update's, bit for bit.
//
// Input: ids (N,) int32 sorted ascending, padding (-1) last; totals (N,) f32,
// each run's total at its last slot. One thread a slot. A slot acts only if
// it holds a real id, is the last slot of its run (ids[i] != ids[i + 1]) and
// its row id - base lies in [0, rows). Run ends hold distinct ids, so each
// row is written by one thread at most: the result does not depend on the
// order in which the threads run, and no atomics are needed.
//
// An acting slot takes g = 0 + total (the dense gradient is zeros plus a
// scatter of the totals, which turns a total of -0.0 into +0.0), then the
// eager chain's f32 operations in its order, each rounded once:
//   adagrad  a = acc + g*g;  s = rsqrt(a + eps) * g;  theta -= s * lr;  acc = a
//   sgd      theta -= g * lr
// with __fmul_rn / __fadd_rn / __fsub_rn so that nvcc contracts nothing into
// an FMA, and rsqrtf, the function ATen's rsqrt calls for f32 on the card.
//
// lr is read from the device (`lr_ptr`, a 0-d f32 tensor) when given, so a
// learning rate that the step computes on the card is never read by the host.
//
// What bounds it: memory. A slot reads its id, its neighbour's (the same
// sector) and, at a run end, its total: about 12 B a slot; an acting slot
// reads and writes one f32 of theta and of acc, four scattered 32 B sectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kAdagrad>
__global__ void __launch_bounds__(kThreads)
    row_update_kernel(const int* __restrict__ ids,
                      const float* __restrict__ totals, long long n,
                      long long base, long long rows, float* theta,
                      float* acc, const float* lr_ptr, float lr_val,
                      float eps) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int id = __ldg(ids + i);
    if (id < 0 || (i + 1 < n && __ldg(ids + i + 1) == id)) continue;
    const long long r = (long long)id - base;
    if (r < 0 || r >= rows) continue;
    const float g = __fadd_rn(0.0f, __ldg(totals + i));
    const float lr = lr_ptr != nullptr ? __ldg(lr_ptr) : lr_val;
    if (kAdagrad) {
      const float a = __fadd_rn(acc[r], __fmul_rn(g, g));
      const float s = __fmul_rn(rsqrtf(__fadd_rn(a, eps)), g);
      theta[r] = __fsub_rn(theta[r], __fmul_rn(s, lr));
      acc[r] = a;
    } else {
      theta[r] = __fsub_rn(theta[r], __fmul_rn(g, lr));
    }
  }
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

}  // namespace

// kind 0: sgd (acc untouched, may be null); kind 1: adagrad. lr_ptr: a
// device f32 holding the learning rate, or null to take `lr`.
extern "C" int repro_row_update_f32(const int* ids, const float* totals,
                                    long long n, long long base,
                                    long long rows, float* theta, float* acc,
                                    const float* lr_ptr, float lr, float eps,
                                    int kind, void* stream) {
  if (n <= 0) return 0;
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  // one slot a thread, the grid capped at 32 blocks an SM (a stride beyond)
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 32;
  const int blocks = (int)(want < cap ? want : cap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 1)
    row_update_kernel<true><<<blocks, kThreads, 0, s>>>(
        ids, totals, n, base, rows, theta, acc, lr_ptr, lr, eps);
  else
    row_update_kernel<false><<<blocks, kThreads, 0, s>>>(
        ids, totals, n, base, rows, theta, acc, lr_ptr, lr, eps);
  return (int)cudaGetLastError();
}
