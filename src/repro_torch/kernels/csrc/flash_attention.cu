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
// Pallas kernel's own mask. The output is bf16; the softmax state and both
// products accumulate in f32, and the probabilities enter the second
// product as bf16, as in the reference's XLA prefill path
// (`p.astype(v.dtype)`).
//
// What bounds it on this card: tensor-core operations. At the serve path's
// shape, q (8, 4096, 32, 128) and k, v (8, 4096, 4, 128), a causal call is
// ~1.1 TFLOP against ~0.6 GB read and written: ~1.1 ms at 989 TFLOP/s,
// ~0.18 ms at 3.35 TB/s. Only `wgmma` reaches the tensor cores' full rate,
// and the exponentials (one per visible score) come next: so the design
// keeps the tensor cores fed from shared memory and keeps everything else
// in registers.
//
// Design (FA3's shape for Hopper): a persistent kernel, one block of three
// warpgroups an SM, walking work items of (128 query rows, b, h).
// - Work items: query tiles last-first, so the long causal rows start
//   first; within a query tile (b, h) with the query heads that share a KV
//   head next to each other, so that their K/V tiles come from L2. Each
//   block takes one item a round, the blocks in a snake order (forward,
//   then backward), which evens out the blocks' totals as items shrink.
// - Warpgroup 0 is the producer: one thread issues TMA loads
//   (`cp.async.bulk.tensor`) of each item's q tile, then K and V tiles of
//   128 keys into a ring of kStages stages, in the order the consumers
//   take them (K of tile t, then V of tile t - 1), handed over by
//   mbarriers: a "full" barrier per stage for K and one for V, completed
//   by the copies' bytes, and an "empty" one each, completed by the 256
//   consumer threads. The q tile has two stages with a full/empty pair
//   each, so the next item's q and first tiles load while the consumers
//   finish the last item. The tensor maps read (B, S, H, D) in place
//   from the caller's strides ({D, H, S, B}, boxes of 64 x 1 x 128 x 1: a
//   D = 128 row is two boxes, a D = 80 row two boxes whose columns past
//   80 read as 0), swizzled by 128 bytes, and zero-fill rows past S. It keeps 24 registers (`setmaxnreg`) and gives the rest to the
//   consumers.
// - Warpgroups 1 and 2 are consumers, 240 registers each, 64 query rows
//   each (one `wgmma` M). S = q K^T is `wgmma.mma_async` m64n128k16 with
//   both operands in shared memory (D / 16 k-steps); the 64 x 128 f32
//   scores stay in registers (64 a thread). The online softmax runs in
//   that layout: a thread holds parts of two rows, keeps their running max
//   and (thread-partial) sum, and reduces the max over the 4 lanes that
//   share a row by two shuffles; base 2 with `ex2.approx`. Only tiles that
//   cross the causal diagonal or the ragged end (keys >= Skv) are masked;
//   tiles wholly in the future are skipped. The probabilities become bf16
//   pairs in registers, the A operand of O += P V (`wgmma` with A in
//   registers), with V read from shared memory MN-major (the transpose
//   bit: the tile is [keys][D]). O (64 x D f32, D / 2 a thread) is
//   rescaled in registers (skipped by a warp whose rows kept their max)
//   and leaves them only at the end of an item:
//   divided by the row sums, rounded to bf16 and stored with row-bounded
//   4-byte stores.
// - Overlap: in step t a consumer issues S_t, then O += P_{t-1} V_{t-1},
//   and runs the softmax of S_t while the second product is in flight;
//   and the two consumers take turns to issue (named barriers), so that
//   one's softmax runs while the other's products hold the tensor cores.
// Shared memory at D = 128: 2 x q 32 KB + 2 stages x (K 32 KB + V 32 KB).
// Head dim 80 (zamba2's 2560 / 32) runs in D = 128's tiles: the scores
// take its 5 k-steps of 16 columns; P V computes 128 columns (m64n128k16,
// as at D = 128; V's columns past 80 are TMA's zeros) and the epilogue
// stores 80. That is 1.3x the tensor-core work of an exact-D design
// (q K^T exact, P V at 128 / 80), for one more instance of the template.
// No atomics, and an item's arithmetic does not depend on which block takes
// it: the result does not depend on timing.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 128;       // query rows a block, 64 a consumer
constexpr int kTileK = 128;       // keys a K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kQStages = 2;       // q tiles: this item's and the next one's
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBox = 64;          // bf16 columns of a TMA box: 128 bytes
// one box in shared memory: 128 rows of 128 bytes, swizzled by 128 bytes
constexpr uint32_t kPanelBytes = 128 * 128;
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kGroupBytes = 8 * kRowBytes;   // 8 rows: one swizzle atom
// a masked score; the running max starts finite, so no exp2 sees inf - inf
constexpr float kMasked = -INFINITY;
constexpr float kMaxInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kTileQ == 128 && kTileK == 128, "boxes are 128 rows");

// Head dims: 64 and 128, and 80 (zamba2) in the tiles of 128. A tile
// holds kPanels boxes of 64 columns; at D = 80 the tensor maps' global D
// is 80, so TMA fills columns 80..127 of the second box with zeros, the
// scores take only the 5 k-steps of columns 0..79, O += P V computes 128
// columns of which the epilogue stores the first 80.
template <int D>
struct Dims {
  static constexpr int kPanels = (D + kBox - 1) / kBox;
  static constexpr int kPad = kPanels * kBox;   // O's columns in registers
  static_assert(D % 16 == 0 && kPad <= 128, "D: a multiple of 16, <= 128");
};

template <int D>
struct Smem {
  static constexpr uint32_t kTile = Dims<D>::kPanels * kPanelBytes;  // q, K, V
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQStages * kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;
  // barriers: q full and q empty a q stage, then K full, V full, K empty
  // and V empty a K/V stage
  static constexpr uint32_t kBytes = kBar + 8 * (2 * kQStages + 4 * kStages)
      + 1024;   // slack to align the base to 1024 bytes (the swizzle atom)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box {64 columns, 1 head, 128 rows, 1 batch} at coordinates
// (c0, head, row, batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
// The stride offset steps 8 rows (one swizzle atom, kGroupBytes). K-major
// operands (q, K) step along K by 32 bytes inside the atom and need no
// leading offset; the MN-major V steps its 64-column panels by the leading
// offset (kPanelBytes) and its keys by 16 rows a k-step.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, f32) (+)= A (64 x 16) B (16 x N), bf16. The register layout of
// D: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and
// 8 more, columns 8 j + 2 (t % 4) + {0, 1}, as d[4 j + {0, 1}] and
// d[4 j + {2, 3}]. `ss`: A and B from shared memory, both K-major.
// `rs`: A from registers (that layout's bf16 pairs), B MN-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}


// The consumer warpgroups take turns to issue their products (FA3's
// ping-pong): warpgroup c waits on named barrier 1 + c before it issues
// and then lets the other one go, so that one's softmax runs while the
// other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(kConsumers)
               : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q K^T for the warpgroup's 64 rows and a tile of 128 keys, issued
// (and committed) but not waited for.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_c,
                                             uint32_t k_t) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss_n128(sc, smem_desc(q_c + off, 16, kGroupBytes),
                  smem_desc(k_t + off, 16, kGroupBytes), kk > 0);
  }
  wgmma_commit();
}

// O += P V for a tile of 128 keys: keys 16 kk .. 16 kk + 15 are
// p[4 kk .. 4 kk + 3]; V is [keys][D], read MN-major. Issued, not waited.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Dims<D>::kPad / 2],
                                         const uint32_t (&p)[32],
                                         uint32_t v_t) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t dv =
        smem_desc(v_t + kk * 16 * kRowBytes, kPanelBytes, kGroupBytes);
    if constexpr (Dims<D>::kPad == 128)
      wgmma_rs_n128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                    p[4 * kk + 3], dv, 1);
    else
      wgmma_rs_n64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                   p[4 * kk + 3], dv, 1);
  }
  wgmma_commit();
}

// The thread's rows of the online softmax, for one tile of scores `sc`
// (rows row0 and row0 + 8, keys k0 + 8 j + col + {0, 1}): masks the tile
// if it crosses the causal diagonal of rows first .. first + 63 or the
// ragged end, updates the running max m and the thread-partial sum l (in
// base 2, scores scaled by scale2), leaves exp2(s - m) in `sc` and the
// factor for the earlier O in corr.
struct RowState {
  float m0 = kMaxInit, m1 = kMaxInit, l0 = 0.f, l1 = 0.f;
  float corr0 = 1.f, corr1 = 1.f;
};

__device__ __forceinline__ void softmax_tile(float (&sc)[64], RowState& st,
                                             int k0, int first, int row0,
                                             int col, int Skv, int shift,
                                             int causal, float scale2) {
  if (k0 + kTileK > Skv || (causal && k0 + kTileK - 1 > first + shift)) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + col + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        if (kpos >= Skv || (causal && kpos > qpos + shift))
          sc[4 * j + e] = kMasked;
      }
  }
  float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0 * scale2);
  const float mn1 = fmaxf(st.m1, mx1 * scale2);
  st.corr0 = fast_exp2(st.m0 - mn0);
  st.corr1 = fast_exp2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale2, -mn0));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale2, -mn0));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale2, -mn1));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale2, -mn1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * st.corr0 + sum0;
  st.l1 = st.l1 * st.corr1 + sum1;
}

// The probabilities as the bf16 A operand of O += P V.
__device__ __forceinline__ void to_operand(const float (&sc)[64],
                                           uint32_t (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// O *= corr, row by row; a warp whose rows kept their max skips it.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const RowState& st) {
  if (__all_sync(0xffffffffu, st.corr0 == 1.f && st.corr1 == 1.f)) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= st.corr0;
    o[4 * j + 1] *= st.corr0;
    o[4 * j + 2] *= st.corr1;
    o[4 * j + 3] *= st.corr1;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out, int B, int Sq,
                       int Skv, int H, int KH, float scale2, int causal) {
  using L = Smem<D>;
  constexpr int kPanels = Dims<D>::kPanels;
  constexpr int kPad = Dims<D>::kPad;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  // mbarriers, 8 bytes each (+ 8 * stage): q full, q empty; K full, V
  // full, K empty, V empty
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8 * kQStages;
  const uint32_t k_full = q_empty + 8 * kQStages;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_bh = B * H;
  const int n_items = n_bh * ((Sq + kTileQ - 1) / kTileQ);
  const int shift = Skv - Sq;
  const int n_keys = (Skv + kTileK - 1) / kTileK;
  // Work item i: query tile (last first, so the long causal rows start
  // first) and (b, h), with the heads that share a KV head next to each
  // other. K/V tiles it reads: under `causal`, none past its last row's
  // limit (tile 0 is always among them: it holds key 0, which every row
  // sees).
  // The block's items: one a round, the blocks in turn, in a snake
  // order (forward in even rounds, backward in odd ones), which evens out
  // the blocks' totals when the items shrink from round to round.
  auto item = [&](int round) {
    const int blocks = gridDim.x, j = blockIdx.x;
    return round * blocks + (round & 1 ? blocks - 1 - j : j);
  };
  auto q_start = [&](int i) {
    return ((Sq + kTileQ - 1) / kTileQ - 1 - i / n_bh) * kTileQ;
  };
  auto tiles_of = [&](int q0) {
    return causal ? min(n_keys, (min(q0 + kTileQ, Sq) - 1 + shift) / kTileK + 1)
                  : n_keys;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers);
      mbar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full, in the order the
    // consumers take the tiles: q, then K of tile t and V of tile t - 1.
    // `g` counts the block's K/V tiles over its items (ring slot and
    // phase); the next item's q and first tiles load while the consumers
    // finish the last one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int round = 0, i; (i = item(round)) < n_items; ++round) {
        const int q0 = q_start(i), n = tiles_of(q0);
        const int b = (i % n_bh) / H, h = i % H, kvh = h / (H / KH);
        const int qs = round % kQStages;
        mbar_wait(q_empty + 8 * qs, ((round / kQStages) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qs, L::kTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(q_s + qs * L::kTile + p * kPanelBytes, &tm_q,
                   q_full + 8 * qs, p * kBox, h, q0, b);
        for (int t = 0; t <= n; ++t) {
          if (t < n) {
            const int s = (g + t) % kStages;
            mbar_wait(k_empty + 8 * s, (((g + t) / kStages) & 1) ^ 1);
            mbar_expect_tx(k_full + 8 * s, L::kTile);
            for (int p = 0; p < kPanels; ++p)
              tma_load(k_s + s * L::kTile + p * kPanelBytes, &tm_k,
                       k_full + 8 * s, p * kBox, kvh, t * kTileK, b);
          }
          if (t > 0) {
            const int s = (g + t - 1) % kStages;
            mbar_wait(v_empty + 8 * s, (((g + t - 1) / kStages) & 1) ^ 1);
            mbar_expect_tx(v_full + 8 * s, L::kTile);
            for (int p = 0; p < kPanels; ++p)
              tma_load(v_s + s * L::kTile + p * kPanelBytes, &tm_v,
                       v_full + 8 * s, p * kBox, kvh, (t - 1) * kTileK, b);
          }
        }
        g += n;
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows first .. first + 63 of each item's
  // query tile. In step t it issues S_t = q K_t^T, then O += P_{t-1}
  // V_{t-1}, and runs the softmax of S_t while the second product is in
  // flight. Both consumers walk all the item's tiles, masking what their
  // rows do not see, so that they take their turns in step.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid % 32;
  const int col = 2 * (lane % 4);
  float o[kPad / 2];
  float sc[64];
  uint32_t p[32];
  if (c == 1) turn_pass(1);   // consumer 0 issues first

  int g = 0;
  for (int round = 0, i; (i = item(round)) < n_items; ++round) {
    const int q0 = q_start(i), n = tiles_of(q0);
    const int b = (i % n_bh) / H, h = i % H;
    const int first = q0 + 64 * c;
    const int row0 = first + 16 * (tid / 32) + lane / 4;   // and row0 + 8
#pragma unroll
    for (int j = 0; j < kPad / 2; ++j) o[j] = 0.f;
    RowState st;
    const int qs = round % kQStages;
    const uint32_t q_c = q_s + qs * L::kTile + 64 * c * kRowBytes;
    mbar_wait(q_full + 8 * qs, (round / kQStages) & 1);

    mbar_wait(k_full + 8 * (g % kStages), (g / kStages) & 1);
    turn_wait(c);
    issue_scores<D>(sc, q_c, k_s + (g % kStages) * L::kTile);
    turn_pass(c);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty + 8 * (g % kStages));
    if (n == 1) mbar_arrive(q_empty + 8 * qs);
    softmax_tile(sc, st, 0, first, row0, col, Skv, shift, causal, scale2);
    to_operand(sc, p);

    for (int t = 1; t < n; ++t) {
      const int s = (g + t) % kStages, sv = (g + t - 1) % kStages;
      mbar_wait(k_full + 8 * s, ((g + t) / kStages) & 1);
      turn_wait(c);
      issue_scores<D>(sc, q_c, k_s + s * L::kTile);
      rescale(o, st);
      mbar_wait(v_full + 8 * sv, ((g + t - 1) / kStages) & 1);
      issue_pv<D>(o, p, v_s + sv * L::kTile);
      turn_pass(c);
      wgmma_wait<1>();   // S_t is in; P_{t-1} V_{t-1} may still run
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      if (t == n - 1) mbar_arrive(q_empty + 8 * qs);
      softmax_tile(sc, st, t * kTileK, first, row0, col, Skv, shift, causal,
                   scale2);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty + 8 * sv);
      to_operand(sc, p);
    }
    const int sv = (g + n - 1) % kStages;
    rescale(o, st);
    mbar_wait(v_full + 8 * sv, ((g + n - 1) / kStages) & 1);
    issue_pv<D>(o, p, v_s + sv * L::kTile);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_empty + 8 * sv);
    g += n;

    // out = O / l for the thread's rows inside Sq and its columns inside
    // D (of O's kPad); out is (B, Sq, H, D) dense
    float l0 = st.l0, l1 = st.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* o0 = out + (((long long)b * Sq + row0) * H + h) * D + col;
    __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {   // columns 8 j + col + {0, 1} < D
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if (c == 0) turn_wait(0);   // take consumer 1's last pass
}

constexpr int kNoEncoder = -2;     // libcuda has no cuTensorMapEncodeTiled
constexpr int kBadTensorMap = -3;  // it refused a tensor map

// cuTensorMapEncodeTiled lives in libcuda: taken through the runtime's
// entry-point query, so the library links no libcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  }
  return fn;
}

// Tensor map of a bf16 (B, S, heads, D) tensor with element strides
// (sb, ss, sh) and a dense D, in boxes of {64, 1, 128, 1}, swizzled by
// 128 bytes; rows past S read as 0.
int encode(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B,
           long long sb, long long ss, long long sh) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return kNoEncoder;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                           (cuuint64_t)sb * 2};
  // a dimension of extent 1 is never stepped: give it a dense stride
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1)
      strides[i - 1] = i == 1 ? dims[0] * 2 : strides[i - 2] * dims[i - 1];
  cuuint32_t box[4] = {kBox, 1, 128, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KH, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode(&tm_q, q, D, H, Sq, B, st[0], st[1], st[2]);
  if (err == 0) err = encode(&tm_k, k, D, KH, Skv, B, st[3], st[4], st[5]);
  if (err == 0) err = encode(&tm_v, v, D, KH, Skv, B, st[6], st[7], st[8]);
  if (err != 0) return err;
  const size_t bytes = Smem<D>::kBytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  // persistent: one block an SM walks the work items
  int dev = 0, sms = 0;
  cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long items = (long long)B * H * ((Sq + kTileQ - 1) / kTileQ);
  const int grid = (int)(items < sms ? items : sms);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), B, Sq, Skv, H, KH,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 9 element strides, (batch, seq, head) of q, then of k, then of
// v; the head dim is dense, every stride a multiple of 8 and every base
// 16-byte aligned (what TMA takes). out is a dense (B, Sq, H, D). Returns a
// CUDA error code (0 = launched), -1 for a D the kernel has no instance
// of, -2 if libcuda has no tensor-map encoder, -3 if it refused a
// tensor map.
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
  if (D == 80)
    return launch<80>(q, k, v, out, B, Sq, Skv, H, KH, strides, scale,
                      causal, s);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Sq, Skv, H, KH, strides, scale,
                       causal, s);
  return -1;
}

// Dynamic shared memory of a block at head dim D (0 for a D the kernel has
// no instance of).
extern "C" int repro_flash_attention_smem_bytes(int D) {
  if (D == 64) return (int)Smem<64>::kBytes;
  if (D == 80) return (int)Smem<80>::kBytes;
  if (D == 128) return (int)Smem<128>::kBytes;
  return 0;
}
