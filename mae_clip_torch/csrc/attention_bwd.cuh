// Attention backward bodies, shared by attention_bwd.cu (kernels #3, #4)
// and the block stack's backward (block_stack_bwd.cu), which include this
// header inside their unnamed namespace; ops/_build.py hashes it with every
// source that includes it.
//
// Math (the same as the plain versions in ops/attention.py and
// ops/block_kernel.py, which follow the TPU kernels): the softmax is
// recomputed, never saved by the forward.
//   s  = (q . k) * scale in fp32; masked keys -0.7 * FLT_MAX; keys past Sk
//        -inf (absent, never padding)
//   P  = exp(s - m) / max(l, 1e-30), fp32, m and l over the whole row
//   dP = dO . v^T (fp32 sums of input-type values)
//   delta = rowsum(P * dP)
//   dS = P * (dP - delta), zero at masked keys (s does not depend on q or k
//        there: a fully masked row has uniform P and no dq or dk), rounded
//        to the input type
//   dq = dS . k * scale;  dk = dS^T . q * scale;  dv = round(P)^T . dO
//   accumulated in fp32 and rounded to the input type on store (and, where
//   the caller asks, also stored unrounded in fp32).
//
// Design: two kernels, no atomics, a deterministic result; each in two
// bodies, as the forward kernels: a tensor-core body for bf16 at Dh = 64 or
// 128 with 16-byte aligned rows (the training path), and a scalar-FMA body
// for fp32 and every other case.
//   * attn_bwd_dq_kernel: one block per (batch*head, 64-query tile). Pass 1
//     walks the 64-key tiles and keeps m, l and sum(exp(s - m) * dP) online
//     (rescaled as in the forward), which gives the row statistics m, l and
//     delta; they go to an fp32 scratch (3, B*H, Sq). Pass 2 walks the key
//     tiles again for dS and accumulates dq in registers. With a single key
//     tile (Sk <= 64: both training shapes) pass 2 reuses pass 1's scores
//     and tiles instead of recomputing them.
//   * attn_bwd_dkdv_kernel: one block per (batch*head, 64-key tile). It
//     walks the 64-query tiles, recomputes P and dS from the row statistics,
//     and accumulates dk and dv in registers.
//   Tensor-core body: 4 warps of 16 rows (queries in the dq kernel, keys in
//   the dk/dv kernel), bf16 tiles in shared memory with rows padded by 8
//   elements; the five products run on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate). S and dP stay in registers in the mma C layout; P and dS
//   are repacked there as the bf16 A fragments of the next product (which
//   is where they round to bf16), so no score tile goes to shared memory.
//   68 KB of shared memory per block at Dh = 128.
//   Scalar body: tiles in shared memory as fp32 (rows padded to Dh + 1: no
//   bank conflicts on the column walks); each thread owns 4 rows x 4
//   columns of a 64 x 64 score tile and 4 rows x Dh/16 columns of each
//   accumulator. Shared memory is ~145 KB (dq) and ~162 KB (dk/dv) at
//   Dh = 128, so the launcher raises the dynamic limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {
namespace attn_bwd {

constexpr int kTile = 64;     // query rows or key rows per tile
constexpr int kThreads = 256;
constexpr int kCols = kMaxHeadDim / 16;  // accumulator columns per thread

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const float* mask;  // (B, Sk), > 0 = valid key; nullptr = all valid
  float* row_m;       // (B*H, Sq) row max of s
  float* row_l;       // (B*H, Sq) row sum of exp(s - m)
  float* row_delta;   // (B*H, Sq) rowsum(P * dP)
  // Optional fp32 copies of dq, dk, dv before their rounding, with the
  // strides of dq, dk, dv (the block stacks sum them into bias gradients).
  float* dq_f;
  float* dk_f;
  float* dv_f;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk, Dh;
  float scale;
};

// Rows row0 .. row0+63 of a (n, Dh) operand into a padded fp32 tile; rows
// past n are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int n, long long stride, int dh) {
  const int ld = dh + 1;
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh, c = i % dh, row = row0 + r;
    dst[r * ld + c] = row < n ? to_float(src[row * stride + c]) : 0.f;
  }
}

// x[i][j] = a[ty*4+i] . b[tx+16j] and y[i][j] = c[ty*4+i] . d[tx+16j] over
// Dh columns of four padded tiles.
__device__ __forceinline__ void two_dots(float (&x)[4][4], float (&y)[4][4],
                                         const float* a, const float* b,
                                         const float* c, const float* d,
                                         int ld, int dh, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
  for (int e = 0; e < dh; ++e) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty * 4 + i) * ld + e];
      cv[i] = c[(ty * 4 + i) * ld + e];
      bv[i] = b[(tx + 16 * i) * ld + e];
      dv[i] = d[(tx + 16 * i) * ld + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = fmaf(av[i], bv[j], x[i][j]);
        y[i][j] = fmaf(cv[i], dv[j], y[i][j]);
      }
  }
}

__device__ __forceinline__ bool key_valid(const float* mb, int key, int sk) {
  return key < sk && (mb == nullptr || mb[key] > 0.f);
}

// Scale and mask: s is (query rows, keys tx + 16j of the tile at k0).
__device__ __forceinline__ void mask_scores(float (&s)[4][4], const float* mb,
                                            int k0, int sk, float scale,
                                            int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tx + 16 * j;
    const bool in = key < sk, valid = key_valid(mb, key, sk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][j] = !in ? -INFINITY : (valid ? s[i][j] * scale : kMaskValue);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(BwdParams<T> p) {
  extern __shared__ float smem[];
  const int ld = p.Dh + 1, lp = kTile + 1;
  float* qs = smem;                // kTile x ld
  float* dos = qs + kTile * ld;    // kTile x ld
  float* ks = dos + kTile * ld;    // kTile x ld
  float* vs = ks + kTile * ld;     // kTile x ld
  float* ds = vs + kTile * ld;     // kTile x lp

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kTile;
  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* kb = p.k + b * p.sk.b + h * p.sk.h;
  const T* vb = p.v + b * p.sv.b + h * p.sv.h;
  const T* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  T* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
  float* dqfb = p.dq_f ? p.dq_f + b * p.sdq.b + h * p.sdq.h : nullptr;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;

  load_rows(qs, qb, q0, p.Sq, p.sq.r, p.Dh);
  load_rows(dos, dob, q0, p.Sq, p.sdo.r, p.Dh);

  float m[4], l[4], dsum[4], s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = dsum[i] = 0.f;
  }
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  // Pass 1: the row statistics, online over the key tiles. Key 0 of the
  // first tile is inside Sk, so m is finite after it and exp(-inf - m) = 0.
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_rows(ks, kb, k0, p.Sk, p.sk.r, p.Dh);
    load_rows(vs, vb, k0, p.Sk, p.sv.r, p.Dh);
    __syncthreads();
    two_dots(s, dp, qs, ks, dos, vs, ld, p.Dh, ty, tx);
    mask_scores(s, mb, k0, p.Sk, p.scale, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = half_warp_max(
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float se = 0.f, sed = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        se += e;
        sed = fmaf(e, dp[i][j], sed);
      }
      l[i] = l[i] * alpha + half_warp_sum(se);
      dsum[i] = dsum[i] * alpha + half_warp_sum(sed);
      m[i] = m_new;
    }
  }

  float lmax[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lmax[i] = fmaxf(l[i], 1e-30f);
    delta[i] = dsum[i] / lmax[i];
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < p.Sq) {
      const long long at = (long long)bh * p.Sq + row;
      p.row_m[at] = m[i];
      p.row_l[at] = l[i];
      p.row_delta[at] = delta[i];
    }
  }

  // Pass 2: dS per key tile, dq += dS . k.
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    if (n_tiles > 1) {  // else the tile and its scores are still here
      __syncthreads();
      load_rows(ks, kb, k0, p.Sk, p.sk.r, p.Dh);
      load_rows(vs, vb, k0, p.Sk, p.sv.r, p.Dh);
      __syncthreads();
      two_dots(s, dp, qs, ks, dos, vs, ld, p.Dh, ty, tx);
      mask_scores(s, mb, k0, p.Sk, p.scale, tx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = key_valid(mb, k0 + tx + 16 * j, p.Sk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = expf(s[i][j] - m[i]) / lmax[i];
        ds[(ty * 4 + i) * lp + tx + 16 * j] =
            valid ? rnd<T>(pr * (dp[i][j] - delta[i])) : 0.f;
      }
    }
    __syncthreads();
    const int kn = min(kTile, p.Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds[(ty * 4 + i) * lp + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < p.Dh ? ks[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
    __syncthreads();  // ds is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col >= p.Dh) continue;
      const float x = acc[i][c] * p.scale;
      store(&dqb[row * p.sdq.r + col], x);
      if (dqfb) dqfb[row * p.sdq.r + col] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(BwdParams<T> p) {
  extern __shared__ float smem[];
  const int ld = p.Dh + 1, lp = kTile + 1;
  float* ks = smem;                // kTile x ld
  float* vs = ks + kTile * ld;     // kTile x ld
  float* qs = vs + kTile * ld;     // kTile x ld
  float* dos = qs + kTile * ld;    // kTile x ld
  float* pt = dos + kTile * ld;    // kTile keys x lp queries: round(P)^T
  float* dst = pt + kTile * lp;    // kTile keys x lp queries: dS^T

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kTile;
  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* kb = p.k + b * p.sk.b + h * p.sk.h;
  const T* vb = p.v + b * p.sv.b + h * p.sv.h;
  const T* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  T* dkb = p.dk + b * p.sdk.b + h * p.sdk.h;
  T* dvb = p.dv + b * p.sdv.b + h * p.sdv.h;
  float* dkfb = p.dk_f ? p.dk_f + b * p.sdk.b + h * p.sdk.h : nullptr;
  float* dvfb = p.dv_f ? p.dv_f + b * p.sdv.b + h * p.sdv.h : nullptr;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  const long long rows = (long long)bh * p.Sq;

  load_rows(ks, kb, k0, p.Sk, p.sk.r, p.Dh);
  load_rows(vs, vb, k0, p.Sk, p.sv.r, p.Dh);

  // This thread's keys: k0 + ty*4 + i.
  bool in[4], valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    in[i] = key < p.Sk;
    valid[i] = key_valid(mb, key, p.Sk);
  }

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    load_rows(qs, qb, q0, p.Sq, p.sq.r, p.Dh);
    load_rows(dos, dob, q0, p.Sq, p.sdo.r, p.Dh);
    __syncthreads();
    // s^T and dP^T: keys ty*4+i, queries tx+16j. k . q sums the same
    // products in the same order as q . k, so P matches the dq kernel's.
    float s[4][4], dp[4][4];
    two_dots(s, dp, ks, qs, vs, dos, ld, p.Dh, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      const bool qin = row < p.Sq;
      const float m = qin ? p.row_m[rows + row] : 0.f;
      const float lmax = qin ? fmaxf(p.row_l[rows + row], 1e-30f) : 1.f;
      const float delta = qin ? p.row_delta[rows + row] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x =
            !in[i] ? -INFINITY : (valid[i] ? s[i][j] * p.scale : kMaskValue);
        const float pr = qin ? expf(x - m) / lmax : 0.f;
        pt[(ty * 4 + i) * lp + tx + 16 * j] = rnd<T>(pr);
        dst[(ty * 4 + i) * lp + tx + 16 * j] =
            qin && valid[i] ? rnd<T>(pr * (dp[i][j] - delta)) : 0.f;
      }
    }
    __syncthreads();
    const int qn = min(kTile, p.Sq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty * 4 + i) * lp + qq];
        sv[i] = dst[(ty * 4 + i) * lp + qq];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const bool cin = col < p.Dh;
        const float dov = cin ? dos[qq * ld + col] : 0.f;
        const float qv = cin ? qs[qq * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pv[i], dov, dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!in[i]) continue;
    const int key = k0 + ty * 4 + i;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col >= p.Dh) continue;
      const float x = dk[i][c] * p.scale;
      store(&dkb[key * p.sdk.r + col], x);
      store(&dvb[key * p.sdv.r + col], dv[i][c]);
      if (dkfb) dkfb[key * p.sdk.r + col] = x;
      if (dvfb) dvfb[key * p.sdv.r + col] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core bodies: bf16, Dh = 64 or 128, rows 16-byte aligned. The same
// two kernels and scratch as above, with the five products on mma.sync
// (bf16 in, fp32 accumulate) over bf16 tiles in shared memory, 4 warps of
// 16 rows each. x[n][e] of a 16 x 64 tile is row g + 8 * (e / 2), column
// 8n + 2t + e % 2 (the mma C layout).
// ---------------------------------------------------------------------------

// x = A[r0 .. r0+15] . B[0 .. 63]^T over D columns of two padded tiles.
template <int D>
__device__ __forceinline__ void tile_dots(float (&x)[8][4],
                                          const __nv_bfloat16* a,
                                          const __nv_bfloat16* b, int r0,
                                          int g, int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* ar = a + (r0 + g) * kLd + kc * 16 + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLd), ld32(ar + 8),
                            ld32(ar + 8 * kLd + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* br = b + (n * 8 + g) * kLd + kc * 16 + 2 * t;
      mma_bf16(x[n], af, ld32(br), ld32(br + 8));
    }
  }
}

// acc += round(x) . M, x a 16 x 64 tile in the C layout, M 64 rows x D.
template <int D>
__device__ __forceinline__ void tile_times(float (&acc)[D / 8][4],
                                           const float (&x)[8][4],
                                           const __nv_bfloat16* m, int g,
                                           int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack(x[2 * j][0], x[2 * j][1]),
                           pack(x[2 * j][2], x[2 * j][3]),
                           pack(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* mr = m + (j * 16 + 2 * t) * kLd + n * 8 + g;
      mma_bf16(acc[n], a, pack(mr[0], mr[kLd]),
               pack(mr[8 * kLd], mr[9 * kLd]));
    }
  }
}

// Scale and mask a 16 x 64 score tile whose columns are keys k0 + 8n + 2t + e.
__device__ __forceinline__ void mask_tile(float (&s)[8][4], const float* mb,
                                          int k0, int sk, float scale,
                                          int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + n * 8 + 2 * t + e;
      const bool in = key < sk, valid = key_valid(mb, key, sk);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float& x = s[n][2 * hr + e];
        x = !in ? -INFINITY : (valid ? x * scale : kMaskValue);
      }
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    attn_bwd_dq_mma_kernel(BwdParams<__nv_bfloat16> p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * kLd;
  __nv_bfloat16* ks = dos + kTile * kLd;
  __nv_bfloat16* vs = ks + kTile * kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kTile;
  const __nv_bfloat16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vb = p.v + b * p.sv.b + h * p.sv.h;
  __nv_bfloat16* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
  float* dqfb = p.dq_f ? p.dq_f + b * p.sdq.b + h * p.sdq.h : nullptr;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;

  load_tile<D>(qs, p.q + b * p.sq.b + h * p.sq.h, q0, p.Sq, p.sq.r);
  load_tile<D>(dos, p.dout + b * p.sdo.b + h * p.sdo.h, q0, p.Sq, p.sdo.r);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f}, s[8][4], dp[8][4];
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  // Pass 1: row statistics, online over the key tiles (as the scalar body).
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(ks, kb, k0, p.Sk, p.sk.r);
    load_tile<D>(vs, vb, k0, p.Sk, p.sv.r);
    __syncthreads();
    tile_dots<D>(s, qs, ks, r0, g, t);
    tile_dots<D>(dp, dos, vs, r0, g, t);
    mask_tile(s, mb, k0, p.Sk, p.scale, t);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      const float alpha = expf(m[hr] - m_new);
      float se = 0.f, sed = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = expf(s[n][2 * hr + e] - m_new);
          se += ex;
          sed = fmaf(ex, dp[n][2 * hr + e], sed);
        }
      l[hr] = l[hr] * alpha + quad_sum(se);
      dsum[hr] = dsum[hr] * alpha + quad_sum(sed);
      m[hr] = m_new;
    }
  }

  float lmax[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lmax[hr] = fmaxf(l[hr], 1e-30f);
    delta[hr] = dsum[hr] / lmax[hr];
    const int row = q0 + r0 + g + 8 * hr;
    if (t == 0 && row < p.Sq) {
      const long long at = (long long)bh * p.Sq + row;
      p.row_m[at] = m[hr];
      p.row_l[at] = l[hr];
      p.row_delta[at] = delta[hr];
    }
  }

  // Pass 2: dS (in place of s) per key tile, dq += dS . k.
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (n_tiles > 1) {  // else the tile and its scores are still here
      __syncthreads();
      load_tile<D>(ks, kb, k0, p.Sk, p.sk.r);
      load_tile<D>(vs, vb, k0, p.Sk, p.sv.r);
      __syncthreads();
      tile_dots<D>(s, qs, ks, r0, g, t);
      tile_dots<D>(dp, dos, vs, r0, g, t);
      mask_tile(s, mb, k0, p.Sk, p.scale, t);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = key_valid(mb, k0 + n * 8 + 2 * t + e, p.Sk);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& x = s[n][2 * hr + e];
          const float pr = expf(x - m[hr]) / lmax[hr];
          x = valid ? pr * (dp[n][2 * hr + e] - delta[hr]) : 0.f;
        }
      }
    tile_times<D>(acc, s, ks, g, t);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + g + 8 * hr;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long long i = row * p.sdq.r + n * 8 + 2 * t;
      const float x0 = acc[n][2 * hr] * p.scale;
      const float x1 = acc[n][2 * hr + 1] * p.scale;
      *reinterpret_cast<__nv_bfloat162*>(dqb + i) =
          __floats2bfloat162_rn(x0, x1);
      if (dqfb) *reinterpret_cast<float2*>(dqfb + i) = make_float2(x0, x1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    attn_bwd_dkdv_mma_kernel(BwdParams<__nv_bfloat16> p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * kLd;
  __nv_bfloat16* qs = vs + kTile * kLd;
  __nv_bfloat16* dos = qs + kTile * kLd;
  float* st_m = reinterpret_cast<float*>(dos + kTile * kLd);  // per query
  float* st_l = st_m + kTile;
  float* st_d = st_l + kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kTile;
  const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  __nv_bfloat16* dkb = p.dk + b * p.sdk.b + h * p.sdk.h;
  __nv_bfloat16* dvb = p.dv + b * p.sdv.b + h * p.sdv.h;
  float* dkfb = p.dk_f ? p.dk_f + b * p.sdk.b + h * p.sdk.h : nullptr;
  float* dvfb = p.dv_f ? p.dv_f + b * p.sdv.b + h * p.sdv.h : nullptr;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  const long long rows = (long long)bh * p.Sq;

  load_tile<D>(ks, p.k + b * p.sk.b + h * p.sk.h, k0, p.Sk, p.sk.r);
  load_tile<D>(vs, p.v + b * p.sv.b + h * p.sv.h, k0, p.Sk, p.sv.r);

  // This thread's keys: rows g and g + 8 of its warp's 16.
  bool in[2], valid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r0 + g + 8 * hr;
    in[hr] = key < p.Sk;
    valid[hr] = key_valid(mb, key, p.Sk);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<D>(qs, qb, q0, p.Sq, p.sq.r);
    load_tile<D>(dos, dob, q0, p.Sq, p.sdo.r);
    for (int i = threadIdx.x; i < kTile; i += kMmaThreads) {
      const int row = q0 + i;
      const bool qin = row < p.Sq;
      st_m[i] = qin ? p.row_m[rows + row] : 0.f;
      st_l[i] = qin ? fmaxf(p.row_l[rows + row], 1e-30f) : 1.f;
      st_d[i] = qin ? p.row_delta[rows + row] : 0.f;
    }
    __syncthreads();
    // s^T and dP^T: this warp's 16 keys x 64 queries.
    float s[8][4], dp[8][4];
    tile_dots<D>(dp, vs, dos, r0, g, t);
    tile_dots<D>(s, ks, qs, r0, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        const bool qin = q0 + c < p.Sq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& x = s[n][2 * hr + e];
          float& y = dp[n][2 * hr + e];
          x = !in[hr] ? -INFINITY : (valid[hr] ? x * p.scale : kMaskValue);
          const float pr = qin ? expf(x - st_m[c]) / st_l[c] : 0.f;
          x = pr;
          y = qin && valid[hr] ? pr * (y - st_d[c]) : 0.f;
        }
      }
    tile_times<D>(dv, s, dos, g, t);  // dv += round(P)^T . dO
    tile_times<D>(dk, dp, qs, g, t);  // dk += round(dS)^T . q
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!in[hr]) continue;
    const int key = k0 + r0 + g + 8 * hr;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      const long long ik = key * p.sdk.r + col, iv = key * p.sdv.r + col;
      const float k0v = dk[n][2 * hr] * p.scale;
      const float k1v = dk[n][2 * hr + 1] * p.scale;
      *reinterpret_cast<__nv_bfloat162*>(dkb + ik) =
          __floats2bfloat162_rn(k0v, k1v);
      *reinterpret_cast<__nv_bfloat162*>(dvb + iv) =
          __floats2bfloat162_rn(dv[n][2 * hr], dv[n][2 * hr + 1]);
      if (dkfb) *reinterpret_cast<float2*>(dkfb + ik) = make_float2(k0v, k1v);
      if (dvfb)
        *reinterpret_cast<float2*>(dvfb + iv) =
            make_float2(dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
  }
}

// The tensor-core bodies need 16-byte aligned rows: every pointer on a
// 16-byte boundary and every stride a multiple of 8 elements.
inline bool mma_eligible(const BwdParams<__nv_bfloat16>& p) {
  const Strides all[7] = {p.sq, p.sk, p.sv, p.sdo, p.sdq, p.sdk, p.sdv};
  for (const Strides& s : all)
    if (s.b % 8 || s.h % 8 || s.r % 8) return false;
  const void* ptrs[10] = {p.q,  p.k,    p.v,    p.dout, p.dq,
                          p.dk, p.dv, p.dq_f, p.dk_f, p.dv_f};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return p.Dh == 64 || p.Dh == 128;
}

template <int D>
int launch_mma(const BwdParams<__nv_bfloat16>& p, int batch,
               cudaStream_t stream) {
  const size_t tiles = 4 * kTile * (D + 8) * sizeof(__nv_bfloat16);
  const size_t smem_dkdv = tiles + 3 * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int bh = batch * p.H;
  attn_bwd_dq_mma_kernel<D>
      <<<dim3(bh, (p.Sq + kTile - 1) / kTile), kMmaThreads, tiles, stream>>>(
          p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_mma_kernel<D><<<dim3(bh, (p.Sk + kTile - 1) / kTile),
                                kMmaThreads, smem_dkdv, stream>>>(p);
  return (int)cudaGetLastError();
}

inline size_t dq_smem_bytes(int dh) {
  return sizeof(float) *
         (size_t)(4 * kTile * (dh + 1) + kTile * (kTile + 1));
}

inline size_t dkdv_smem_bytes(int dh) {
  return sizeof(float) *
         (size_t)(4 * kTile * (dh + 1) + 2 * kTile * (kTile + 1));
}

template <typename T>
bool valid_shape(const BwdParams<T>& p, int batch) {
  return p.Dh >= 1 && p.Dh <= kMaxHeadDim && p.Sq >= 1 && p.Sk >= 1 &&
         batch >= 1 && p.H >= 1 && (p.Sq + kTile - 1) / kTile <= 65535 &&
         (p.Sk + kTile - 1) / kTile <= 65535;
}

template <typename T>
int launch_scalar(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  const size_t smem_dq = dq_smem_bytes(p.Dh);
  const size_t smem_dkdv = dkdv_smem_bytes(p.Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int bh = batch * p.H;
  attn_bwd_dq_kernel<T>
      <<<dim3(bh, (p.Sq + kTile - 1) / kTile), kThreads, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<T>
      <<<dim3(bh, (p.Sk + kTile - 1) / kTile), kThreads, smem_dkdv, stream>>>(
          p);
  return (int)cudaGetLastError();
}

// Runs both kernels over `batch` samples of p's strided views.
inline int launch(const BwdParams<float>& p, int batch,
                  cudaStream_t stream) {
  if (!valid_shape(p, batch)) return (int)cudaErrorInvalidValue;
  return launch_scalar(p, batch, stream);
}

inline int launch(const BwdParams<__nv_bfloat16>& p, int batch,
                  cudaStream_t stream) {
  if (!valid_shape(p, batch)) return (int)cudaErrorInvalidValue;
  if (!mma_eligible(p)) return launch_scalar(p, batch, stream);
  return p.Dh == 128 ? launch_mma<128>(p, batch, stream)
                     : launch_mma<64>(p, batch, stream);
}

}  // namespace attn_bwd
}  // namespace
