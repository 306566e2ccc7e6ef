// Helpers shared by the port's kernels (attention_fwd.cu, attention_bwd.cu,
// patch_embed.cu, block_stack_fwd.cu, block_stack_bwd.cu).
//
// Each source includes this header inside the same unnamed namespace, so each
// library keeps its own copy and exports nothing but its extern "C" entries.
// ops/_build.py hashes this file with every source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 128;
// Masked keys score -0.7 * FLT_MAX (finite, so a fully masked row keeps
// uniform weights over its Sk keys); keys past Sk score -inf.
constexpr float kMaskValue = -0.7f * FLT_MAX;

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

}  // namespace
