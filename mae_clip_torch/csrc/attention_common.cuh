// Helpers shared by the port's kernels (attention_fwd.cu, attention_bwd.cu,
// patch_embed.cu, block_stack_fwd.cu, block_stack_bwd.cu): conversions, the
// mma.sync product, and the cp.async / ldmatrix helpers that stage tiles
// and read fragments.
//
// Each source includes this header inside the same unnamed namespace, so each
// library keeps its own copy and exports nothing but its extern "C" entries.
// ops/_build.py hashes this file with every source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

// The widest head any body takes. The scalar bodies take it as a template
// parameter (128 or 256), so heads up to 128 keep their register arrays.
constexpr int kMaxHeadDim = 256;
// Masked keys score -0.7 * FLT_MAX (finite, so a fully masked row keeps
// uniform weights over its Sk keys); keys past Sk score -inf.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
// x rounded to T and back (the identity for fp32).
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return rnd(x, T());
}

// Element strides of one operand: batch, head, row (the last dim is 1).
struct Strides {
  long long b, h, r;
};

// c += a * b on the tensor cores: one m16n8k16 product, bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values as one bf16x2 register; the first takes the low half, which
// mma.sync reads as the lower row/column index.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The tensor-core bodies: 4 warps, 64-row tiles of bf16 in shared memory
// with rows padded by 8 elements (no bank conflicts on the fragment loads).
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;

// Rows row0 .. row0+63 of a (rows, D) operand into a padded shared tile,
// 16 bytes per load; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, long long stride) {
  constexpr int kChunks = D / 8, kLd = D + 8;
  for (int i = threadIdx.x; i < kMmaRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8, row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < n) v = *reinterpret_cast<const uint4*>(src + row * stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
  }
}

// ---- Asynchronous copies and ldmatrix (the pipelined attention bodies;
// cp.async also the block stacks' GEMM epilogues) ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. Without .trans lane l receives (row l / 4,
// columns 2 (l % 4) and +1) of each; with .trans (rows 2 (l % 4) and +1,
// column l / 4).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 4 bytes global -> shared (zero-filled where valid is false).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// Rows row0 .. row0+rows-1 (rows <= 64) of a (n, D) bf16 operand into a
// padded shared tile (rows of D + 8) by cp.async, 16 bytes per copy, rows
// past n zero-filled. Each thread copies one 16-byte column of every
// (128 / (D / 8))-th row, its addresses computed once. The caller commits
// the group.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int rows, int n,
                                                long long stride) {
  constexpr int kChunks = D / 8, kLd = D + 8, kStep = kMmaThreads / kChunks;
  const int r = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * 8;
  const __nv_bfloat16* s = src + (row0 + r) * stride + c;
  __nv_bfloat16* d = dst + r * kLd + c;
  const int last = min(rows, n - row0);  // rows from here on are zero
#pragma unroll
  for (int i = 0; i < kMmaRows / kStep; ++i) {
    const int row = r + i * kStep;
    if (row < rows)
      cp_async16(d + i * kStep * kLd, row < last ? s + i * kStep * stride : src,
                 row < last);
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: results below 2^-126
// flush to zero; -inf gives 0). The softmax exponents are <= 0 here.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// mma.sync operands from padded row-major bf16 tiles (row length LD) by
// ldmatrix. The A fragment of rows r0..r0+15, columns k0..k0+15:
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int k0) {
  const int lane = threadIdx.x % 32;
  ldsm4(a, tile + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}
// The B fragments (b0, b1 of n columns n0..n0+7, then of n0+8..n0+15) over
// k0..k0+15, from a tile whose rows are n (K for Q K^T: B = tile^T) ...
template <int LD>
__device__ __forceinline__ void frag_b_rows_n(uint32_t (&b)[4],
                                              const __nv_bfloat16* tile,
                                              int n0, int k0) {
  const int lane = threadIdx.x % 32, j8 = lane / 8, r8 = lane % 8;
  ldsm4(b, tile + (n0 + (j8 / 2) * 8 + r8) * LD + k0 + (j8 % 2) * 8);
}
// ... or from a tile whose rows are k (V for P V: B = tile), by .trans.
template <int LD>
__device__ __forceinline__ void frag_b_rows_k(uint32_t (&b)[4],
                                              const __nv_bfloat16* tile,
                                              int k0, int n0) {
  const int lane = threadIdx.x % 32, j8 = lane / 8, r8 = lane % 8;
  ldsm4_t(b, tile + (k0 + (j8 % 2) * 8 + r8) * LD + n0 + (j8 / 2) * 8);
}

// The A fragment of k columns 16j..16j+15 from a 16-row tile x in the mma
// C layout (x[n][e]: row g + 8 (e / 2), column 8n + 2t + e % 2), rounded to
// bf16: S or dS repacked as the left operand of the next product.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&x)[N][4], int j) {
  a[0] = pack(x[2 * j][0], x[2 * j][1]);
  a[1] = pack(x[2 * j][2], x[2 * j][3]);
  a[2] = pack(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = pack(x[2 * j + 1][2], x[2 * j + 1][3]);
}

// Max and sum over the 4 lanes of an mma row group (one row's columns).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__host__ __device__ __forceinline__ int div_up(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace
