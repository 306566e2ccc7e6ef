// Attention backward bodies, shared by attention_bwd.cu (kernels #3, #4)
// and the block stack's backward (block_stack_bwd.cu), which include this
// header inside their unnamed namespace; ops/_build.py hashes it with every
// source that includes it.
//
// Math (the same as the plain versions in ops/attention.py and
// ops/block_kernel.py, which follow the TPU kernels):
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
// No atomics, a deterministic result. launch() picks the bodies.
//
// bf16 with Dh 64 or 128 and 16-byte aligned rows: the LSE bodies. The
// forward saved the row log-sum-exp lse = m + log(max(l, 1e-30)) and the
// output O, and the caller passes both (#3, #4, #7); without them the call
// fails (cudaErrorInvalidValue). FlashAttention-2's formulation: P =
// exp(s - lse) directly, computed as exp2(s * scale * log2(e) - lse *
// log2(e)) (uniform 1/Sk on a row whose keys are all masked, whose lse is
// -0.7 * FLT_MAX), and delta = rowsum(dO * O) in fp32, equal to rowsum(P *
// dP) in exact arithmetic. Tensor-core bodies on mma.sync.m16n8k16 (bf16
// in, fp32 accumulate):
//   * Sq, Sk <= 64 (the encoder's S = 50): attn_bwd_one_tile_kernel, one
//     block per batch*head, 5 tile products (see the kernel).
//   * Sk <= 64 < Sq (the CrossMAE decoder's 147 queries on 50 keys):
//     attn_bwd_stream_kernel, one block of 8 warps per batch*head that
//     holds K and V and streams the queries (see the kernel); dq is
//     complete in the block and stored at once.
//   * Sk > 64: two kernels, launched in this order.
//     attn_bwd_dq_lse_kernel, one block per (batch*head, 64-query tile):
//     first delta for its rows (dO from shared memory, O straight from
//     device memory; stored for the dk/dv kernel), then ONE pass over the
//     keys: S, dP, dS and dq += dS . k. attn_bwd_dkdv_lse_kernel, one
//     block per (batch*head, 64-key tile): S^T, dP^T from the same lse and
//     delta, then dv += P^T . dO and dk += dS^T . q. That is 7 tile products
//     per (query tile, key tile) pair. Both walk the other operand in
//     32-row stages through a two-stage cp.async ring (the next stage loads
//     while this one's products run; one __syncthreads per stage). 68 KB of
//     shared memory per block at Dh = 128 and 168 registers a thread:
//     three blocks per SM. A fourth would need 128 registers; the dk/dv
//     accumulators alone take 128 (16 keys x 128 columns x 2 per warp).
//   All read every fragment with ldmatrix (.trans for the right operand of
//   dq += dS k, dv += P^T dO and dk += dS^T q), and skip 16-row chunks past
//   Sq or Sk.
//
// Every other case (fp32, Dh other than 64 or 128 up to kMaxHeadDim = 256,
// strides not a multiple of 8 elements): the recomputing scalar pair, which
// reads no lse or O.
//   * attn_bwd_dq_kernel: one block per (batch*head, query tile). Pass 1
//     walks the key tiles and keeps m, l and sum(exp(s - m) * dP) online
//     (rescaled as in the forward), which gives the row statistics m, l and
//     delta; they go to an fp32 scratch (3, B*H, Sq). Pass 2 walks the key
//     tiles again for dS and accumulates dq in registers. With a single key
//     tile pass 2 reuses pass 1's scores and tiles instead of recomputing
//     them.
//   * attn_bwd_dkdv_kernel: one block per (batch*head, key tile). It walks
//     the query tiles, recomputes P and dS from the row statistics, and
//     accumulates dk and dv in registers.
//   Tiles sit in shared memory as fp32 (rows padded to Dh + 1: no bank
//   conflicts on the column walks): 64 rows up to Dh = 128 (~145 KB for dq,
//   ~162 KB for dk/dv at 128), 32 rows above (~133 / ~137 KB at 256), so
//   the launcher raises the dynamic limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {
namespace attn_bwd {

constexpr int kTile = 64;       // query rows or key rows per tile
constexpr int kStageRows = 32;  // keys (dq) or queries (dk/dv) per stage
constexpr int kRing = 2;        // stages in the cp.async ring

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
  // The forward's output and row log-sum-exp (read by the LSE bodies).
  const T* out;
  const float* lse;   // (B*H, Sq)
  // Optional fp32 copies of dq, dk, dv before their rounding, with the
  // strides of dq, dk, dv (the block stacks sum them into bias gradients).
  float* dq_f;
  float* dk_f;
  float* dv_f;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv, so;
  int H, Sq, Sk, Dh;
  float scale;
};

// ---------------------------------------------------------------------------
// Scalar bodies (fp32, and bf16 where the tensor-core bodies do not apply).
// MAXD, the widest head an instance takes, sets the tile: heads up to 128
// take 64-row tiles and 256 threads, wider ones (up to kMaxHeadDim = 256)
// 32-row tiles and 128 threads, so that four fp32 tiles of 256 columns fit
// the 227 KB of shared memory a block may use. Each thread owns 4 rows x
// kT / 16 columns of the kT x kT score tile and 4 rows x MAXD / 16 columns
// of each accumulator.
// ---------------------------------------------------------------------------

template <int MAXD>
struct Scalar {
  static constexpr int kT = MAXD > 128 ? 32 : 64;  // rows per tile
  static constexpr int kThr = 4 * kT;              // threads per block
  static constexpr int kJ = kT / 16;               // score columns / thread
  static constexpr int kCols = MAXD / 16;          // accumulator columns
};

// Rows row0 .. row0+kT-1 of a (n, Dh) operand into a padded fp32 tile;
// rows past n are zero.
template <int kT, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int n, long long stride, int dh) {
  const int ld = dh + 1;
  for (int i = threadIdx.x; i < kT * dh; i += 4 * kT) {
    const int r = i / dh, c = i % dh, row = row0 + r;
    dst[r * ld + c] = row < n ? to_float(src[row * stride + c]) : 0.f;
  }
}

// x[i][j] = a[ty*4+i] . b[tx+16j] and y[i][j] = c[ty*4+i] . d[tx+16j] over
// Dh columns of four padded tiles.
template <int kJ>
__device__ __forceinline__ void two_dots(float (&x)[4][kJ],
                                         float (&y)[4][kJ], const float* a,
                                         const float* b, const float* c,
                                         const float* d, int ld, int dh,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) x[i][j] = y[i][j] = 0.f;
  for (int e = 0; e < dh; ++e) {
    float av[4], cv[4], bv[kJ], dv[kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty * 4 + i) * ld + e];
      cv[i] = c[(ty * 4 + i) * ld + e];
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      bv[j] = b[(tx + 16 * j) * ld + e];
      dv[j] = d[(tx + 16 * j) * ld + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        x[i][j] = fmaf(av[i], bv[j], x[i][j]);
        y[i][j] = fmaf(cv[i], dv[j], y[i][j]);
      }
  }
}

__device__ __forceinline__ bool key_valid(const float* mb, int key, int sk) {
  return key < sk && (mb == nullptr || mb[key] > 0.f);
}

// Scale and mask: s is (query rows, keys tx + 16j of the tile at k0).
template <int kJ>
__device__ __forceinline__ void mask_scores(float (&s)[4][kJ],
                                            const float* mb, int k0, int sk,
                                            float scale, int tx) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(Scalar<MAXD>::kThr)
    attn_bwd_dq_kernel(BwdParams<T> p) {
  constexpr int kT = Scalar<MAXD>::kT, kJ = Scalar<MAXD>::kJ;
  constexpr int kCols = Scalar<MAXD>::kCols;
  extern __shared__ float smem[];
  const int ld = p.Dh + 1, lp = kT + 1;
  float* qs = smem;             // kT x ld
  float* dos = qs + kT * ld;    // kT x ld
  float* ks = dos + kT * ld;    // kT x ld
  float* vs = ks + kT * ld;     // kT x ld
  float* ds = vs + kT * ld;     // kT x lp

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kT;
  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* kb = p.k + b * p.sk.b + h * p.sk.h;
  const T* vb = p.v + b * p.sv.b + h * p.sv.h;
  const T* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  T* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
  float* dqfb = p.dq_f ? p.dq_f + b * p.sdq.b + h * p.sdq.h : nullptr;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;

  load_rows<kT>(qs, qb, q0, p.Sq, p.sq.r, p.Dh);
  load_rows<kT>(dos, dob, q0, p.Sq, p.sdo.r, p.Dh);

  float m[4], l[4], dsum[4], s[4][kJ], dp[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = dsum[i] = 0.f;
  }
  const int n_tiles = (p.Sk + kT - 1) / kT;

  // Pass 1: the row statistics, online over the key tiles. Key 0 of the
  // first tile is inside Sk, so m is finite after it and exp(-inf - m) = 0.
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kT;
    __syncthreads();  // the previous tile's reads are done
    load_rows<kT>(ks, kb, k0, p.Sk, p.sk.r, p.Dh);
    load_rows<kT>(vs, vb, k0, p.Sk, p.sv.r, p.Dh);
    __syncthreads();
    two_dots(s, dp, qs, ks, dos, vs, ld, p.Dh, ty, tx);
    mask_scores(s, mb, k0, p.Sk, p.scale, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kJ; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float se = 0.f, sed = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
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
    const int k0 = t * kT;
    if (n_tiles > 1) {  // else the tile and its scores are still here
      __syncthreads();
      load_rows<kT>(ks, kb, k0, p.Sk, p.sk.r, p.Dh);
      load_rows<kT>(vs, vb, k0, p.Sk, p.sv.r, p.Dh);
      __syncthreads();
      two_dots(s, dp, qs, ks, dos, vs, ld, p.Dh, ty, tx);
      mask_scores(s, mb, k0, p.Sk, p.scale, tx);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const bool valid = key_valid(mb, k0 + tx + 16 * j, p.Sk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = expf(s[i][j] - m[i]) / lmax[i];
        ds[(ty * 4 + i) * lp + tx + 16 * j] =
            valid ? rnd<T>(pr * (dp[i][j] - delta[i])) : 0.f;
      }
    }
    __syncthreads();
    const int kn = min(kT, p.Sk - k0);
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(Scalar<MAXD>::kThr)
    attn_bwd_dkdv_kernel(BwdParams<T> p) {
  constexpr int kT = Scalar<MAXD>::kT, kJ = Scalar<MAXD>::kJ;
  constexpr int kCols = Scalar<MAXD>::kCols;
  extern __shared__ float smem[];
  const int ld = p.Dh + 1, lp = kT + 1;
  float* ks = smem;             // kT x ld
  float* vs = ks + kT * ld;     // kT x ld
  float* qs = vs + kT * ld;     // kT x ld
  float* dos = qs + kT * ld;    // kT x ld
  float* pt = dos + kT * ld;    // kT keys x lp queries: round(P)^T
  float* dst = pt + kT * lp;    // kT keys x lp queries: dS^T

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kT;
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

  load_rows<kT>(ks, kb, k0, p.Sk, p.sk.r, p.Dh);
  load_rows<kT>(vs, vb, k0, p.Sk, p.sv.r, p.Dh);

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

  for (int q0 = 0; q0 < p.Sq; q0 += kT) {
    __syncthreads();  // the previous tile's reads are done
    load_rows<kT>(qs, qb, q0, p.Sq, p.sq.r, p.Dh);
    load_rows<kT>(dos, dob, q0, p.Sq, p.sdo.r, p.Dh);
    __syncthreads();
    // s^T and dP^T: keys ty*4+i, queries tx+16j. k . q sums the same
    // products in the same order as q . k, so P matches the dq kernel's.
    float s[4][kJ], dp[4][kJ];
    two_dots(s, dp, ks, qs, vs, dos, ld, p.Dh, ty, tx);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
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
    const int qn = min(kT, p.Sq - q0);
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
// LSE bodies: the forward's lse and output given (see the top of the file).
// ---------------------------------------------------------------------------

// acc + x . y over 8 bf16 pairs.
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), v = __bfloat1622float2(b[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// The 16-row chunks, at most cap, of the rows from row0 on that lie below n.
__device__ __forceinline__ int live_chunks(int row0, int n, int cap) {
  return min(cap, div_up(n - row0, 16));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
    attn_bwd_dq_lse_kernel(BwdParams<__nv_bfloat16> p) {
  constexpr int kLd = D + 8, kStage = kStageRows * kLd;
  constexpr int kChunks = kStageRows / 16, kN = kStageRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * kLd;
  __nv_bfloat16* ring = dos + kTile * kLd;  // kRing stages of (K, V) rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const bool active = q0 + r0 < p.Sq;  // the warp holds a query row
  const __nv_bfloat16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  const long long rows = (long long)bh * p.Sq;

  auto load_stage = [&](int st) {
    const int k0 = st * kStageRows;
    const int n = 16 * live_chunks(k0, p.Sk, kChunks);
    __nv_bfloat16* ks = ring + (st % kRing) * 2 * kStage;
    load_tile_async<D>(ks, kb, k0, n, p.Sk, p.sk.r);
    load_tile_async<D>(ks + kStage, vb, k0, n, p.Sk, p.sv.r);
  };
  const int n_stages = div_up(p.Sk, kStageRows);
  const int q_rows = 16 * live_chunks(q0, p.Sq, kTile / 16);
  load_tile_async<D>(qs, p.q + b * p.sq.b + h * p.sq.h, q0, q_rows, p.Sq,
                     p.sq.r);
  load_tile_async<D>(dos, p.dout + b * p.sdo.b + h * p.sdo.h, q0, q_rows,
                     p.Sq, p.sdo.r);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }

  // This lane's rows g and g + 8 of the warp's 16: the forward's lse, and
  // delta = rowsum(dO * O), from dO in shared memory and O in device memory
  // (stored for the dk/dv kernel).
  float lse2[2], delta[2];  // lse2: lse * log2(e)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + g + 8 * hr;
    lse2[hr] = row < p.Sq ? p.lse[rows + row] * kLog2e : 0.f;
  }
  const float sc2 = p.scale * kLog2e;
  cp_async_wait<kRing - 1>();  // Q and dO have landed ...
  __syncthreads();             // ... for every thread
  if (active) {
    const __nv_bfloat16* ob = p.out + b * p.so.b + h * p.so.h;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r0 + g + 8 * hr;
      float acc = 0.f;
      if (row < p.Sq)
#pragma unroll
        for (int c = t; c < D / 8; c += 4)
          acc = dot8(
              *reinterpret_cast<const uint4*>(dos + (r0 + g + 8 * hr) * kLd +
                                              8 * c),
              *reinterpret_cast<const uint4*>(ob + row * p.so.r + 8 * c),
              acc);
      delta[hr] = quad_sum(acc);
      if (t == 0 && row < p.Sq) p.row_delta[rows + row] = delta[hr];
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kRing - 2>();  // stage st has landed ...
    __syncthreads();  // ... for every thread, and stage st - 1 is read
    if (st + kRing - 1 < n_stages) load_stage(st + kRing - 1);
    cp_async_commit();
    if (!active) continue;
    const int k0 = st * kStageRows;
    const int nc = live_chunks(k0, p.Sk, kChunks);
    const __nv_bfloat16* ks = ring + (st % kRing) * 2 * kStage;
    const __nv_bfloat16* vs = ks + kStage;

    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys, s[n][2 * hr + e] is row
    // g + 8 * hr, key k0 + 8n + 2t + e.
    float s[kN][4], dp[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {  // a step's fragments, then its
      uint32_t a[4], ad[4], bk[kChunks][4], bv[kChunks][4];  // products
      frag_a<kLd>(a, qs, r0, kc * 16);
      frag_a<kLd>(ad, dos, r0, kc * 16);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nc) continue;
        frag_b_rows_n<kLd>(bk[c], ks, c * 16, kc * 16);
        frag_b_rows_n<kLd>(bv[c], vs, c * 16, kc * 16);
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nc) continue;
        mma_bf16(s[2 * c], a, bk[c][0], bk[c][1]);
        mma_bf16(s[2 * c + 1], a, bk[c][2], bk[c][3]);
        mma_bf16(dp[2 * c], ad, bv[c][0], bv[c][1]);
        mma_bf16(dp[2 * c + 1], ad, bv[c][2], bv[c][3]);
      }
    }
    // dS = P (dP - delta) with P = exp(s * scale - lse) (in base 2), in
    // place of s; zero at masked keys and keys past Sk.
    const bool full = mb == nullptr && k0 + kStageRows <= p.Sk;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid =
            full || key_valid(mb, k0 + n * 8 + 2 * t + e, p.Sk);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& x = s[n][2 * hr + e];
          x = valid ? fast_exp2(fmaf(x, sc2, -lse2[hr])) *
                          (dp[n][2 * hr + e] - delta[hr])
                    : 0.f;
        }
      }
    // dq += round(dS) K; step np + 1's fragments load during step np.
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= nc) continue;
      uint32_t a[4], bf[2][4];
      c_to_a(a, s, c);
      frag_b_rows_k<kLd>(bf[0], ks, c * 16, 0);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (np + 1 < D / 16)
          frag_b_rows_k<kLd>(bf[(np + 1) & 1], ks, c * 16, (np + 1) * 16);
        mma_bf16(acc[2 * np], a, bf[np & 1][0], bf[np & 1][1]);
        mma_bf16(acc[2 * np + 1], a, bf[np & 1][2], bf[np & 1][3]);
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
  float* dqfb = p.dq_f ? p.dq_f + b * p.sdq.b + h * p.sdq.h : nullptr;
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
__global__ void __launch_bounds__(kMmaThreads, 3)
    attn_bwd_dkdv_lse_kernel(BwdParams<__nv_bfloat16> p) {
  constexpr int kLd = D + 8, kStage = kStageRows * kLd;
  constexpr int kChunks = kStageRows / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * kLd;
  // kRing stages of (Q rows, dO rows, lse, delta).
  constexpr int kStageSize = 2 * kStage + 4 * kStageRows;
  __nv_bfloat16* ring = vs + kTile * kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const bool active = k0 + r0 < p.Sk;  // the warp holds a key row
  const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  const long long rows = (long long)bh * p.Sq;

  auto load_stage = [&](int st) {
    const int q0 = st * kStageRows;
    const int n = 16 * live_chunks(q0, p.Sq, kChunks);
    __nv_bfloat16* qs = ring + (st % kRing) * kStageSize;
    load_tile_async<D>(qs, qb, q0, n, p.Sq, p.sq.r);
    load_tile_async<D>(qs + kStage, dob, q0, n, p.Sq, p.sdo.r);
    // lse and delta of these queries; zero past Sq, where the zero Q and
    // dO rows make dP and dO zero, so those columns add nothing.
    if (threadIdx.x < 2 * kStageRows) {
      const int i = threadIdx.x % kStageRows, q = q0 + i;
      const float* src = threadIdx.x < kStageRows ? p.lse : p.row_delta;
      cp_async4(reinterpret_cast<float*>(qs + 2 * kStage) + threadIdx.x,
                q < p.Sq ? src + rows + q : src, q < p.Sq);
    }
  };
  const int n_stages = div_up(p.Sq, kStageRows);
  const int k_rows = 16 * live_chunks(k0, p.Sk, kTile / 16);
  load_tile_async<D>(ks, p.k + b * p.sk.b + h * p.sk.h, k0, k_rows, p.Sk,
                     p.sk.r);
  load_tile_async<D>(vs, p.v + b * p.sv.b + h * p.sv.h, k0, k_rows, p.Sk,
                     p.sv.r);
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) {  // K and V join stage 0's group
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }

  // This thread's keys: rows g and g + 8 of its warp's 16.
  bool valid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    valid[hr] = key_valid(mb, k0 + r0 + g + 8 * hr, p.Sk);
  const float inv_sk = 1.f / p.Sk, sc2 = p.scale * kLog2e;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kRing - 2>();  // stage st has landed ...
    __syncthreads();  // ... for every thread, and stage st - 1 is read
    if (st + kRing - 1 < n_stages) load_stage(st + kRing - 1);
    cp_async_commit();
    if (!active) continue;
    const int q0 = st * kStageRows;
    const int nq = live_chunks(q0, p.Sq, kChunks);
    const __nv_bfloat16* qs = ring + (st % kRing) * kStageSize;
    const __nv_bfloat16* dos = qs + kStage;
    const float* st_lse = reinterpret_cast<const float*>(qs + 2 * kStage);
    const float* st_delta = st_lse + kStageRows;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= nq) continue;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 16 queries;
      // s[n][2 * hr + e] is key g + 8 * hr, query q0 + 16c + 8n + 2t + e.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {  // a step's fragments, then
        uint32_t ak[4], bq[4], av[4], bo[4];  // its products
        frag_a<kLd>(ak, ks, r0, kc * 16);
        frag_b_rows_n<kLd>(bq, qs, c * 16, kc * 16);
        frag_a<kLd>(av, vs, r0, kc * 16);
        frag_b_rows_n<kLd>(bo, dos, c * 16, kc * 16);
        mma_bf16(s[0], ak, bq[0], bq[1]);
        mma_bf16(s[1], ak, bq[2], bq[3]);
        mma_bf16(dp[0], av, bo[0], bo[1]);
        mma_bf16(dp[1], av, bo[2], bo[3]);
      }
      // P^T and dS^T in place (P in base 2). A query whose keys are all
      // masked has lse = -0.7 * FLT_MAX and uniform P = 1 / Sk.
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * c + 8 * n + 2 * t + e;
          const float lq = st_lse[col], dl = st_delta[col];
          const bool dead = mb != nullptr && lq < 0.5f * kMaskValue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = s[n][2 * hr + e];
            float& y = dp[n][2 * hr + e];
            const float pr =
                dead ? inv_sk
                     : (valid[hr] ? fast_exp2(fmaf(x, sc2, -lq * kLog2e))
                                  : 0.f);
            x = pr;
            y = valid[hr] ? pr * (y - dl) : 0.f;
          }
        }
      // dv += round(P)^T dO and dk += round(dS)^T Q over these 16
      // queries, a step's fragments loading during the step before.
      uint32_t pa[4], da[4], bo[2][4], bq[2][4];
      c_to_a(pa, s, 0);
      c_to_a(da, dp, 0);
      frag_b_rows_k<kLd>(bo[0], dos, c * 16, 0);
      frag_b_rows_k<kLd>(bq[0], qs, c * 16, 0);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (np + 1 < D / 16) {
          frag_b_rows_k<kLd>(bo[(np + 1) & 1], dos, c * 16, (np + 1) * 16);
          frag_b_rows_k<kLd>(bq[(np + 1) & 1], qs, c * 16, (np + 1) * 16);
        }
        mma_bf16(dv[2 * np], pa, bo[np & 1][0], bo[np & 1][1]);
        mma_bf16(dv[2 * np + 1], pa, bo[np & 1][2], bo[np & 1][3]);
        mma_bf16(dk[2 * np], da, bq[np & 1][0], bq[np & 1][1]);
        mma_bf16(dk[2 * np + 1], da, bq[np & 1][2], bq[np & 1][3]);
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* dkb = p.dk + b * p.sdk.b + h * p.sdk.h;
  __nv_bfloat16* dvb = p.dv + b * p.sdv.b + h * p.sdv.h;
  float* dkfb = p.dk_f ? p.dk_f + b * p.sdk.b + h * p.sdk.h : nullptr;
  float* dvfb = p.dv_f ? p.dv_f + b * p.sdv.b + h * p.sdv.h : nullptr;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r0 + g + 8 * hr;
    if (key >= p.Sk) continue;
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

// Sq, Sk <= 64 (the encoder's S = 50): one block per batch*head does the
// whole backward with 5 tile products instead of 7. Q, K, V and dO are
// loaded once; warp w takes query rows 16w.. for S, dP and dq, then key rows
// 16w.. for dk and dv, reading P and dS through shared memory as [query][key]
// bf16 tiles with 16-byte chunks XOR-swizzled by row (no bank conflicts on
// the stores or on the transposing ldmatrix). At Dh = 128 they take V's
// place once dP is done.
__device__ __forceinline__ int swz64(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
    attn_bwd_one_tile_kernel(BwdParams<__nv_bfloat16> p) {
  constexpr int kLd = D + 8, kTileSize = kTile * kLd;
  constexpr bool kInV = kTileSize >= 2 * kTile * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTileSize;
  __nv_bfloat16* vs = ks + kTileSize;
  __nv_bfloat16* dos = vs + kTileSize;
  __nv_bfloat16* ps = kInV ? vs : dos + kTileSize;  // P, then dS
  __nv_bfloat16* dss = ps + kTile * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  const long long rows = (long long)bh * p.Sq;
  const int nq = div_up(p.Sq, 16), nk = div_up(p.Sk, 16);  // live chunks

  load_tile_async<D>(qs, p.q + b * p.sq.b + h * p.sq.h, 0, 16 * nq, p.Sq,
                     p.sq.r);
  load_tile_async<D>(ks, p.k + b * p.sk.b + h * p.sk.h, 0, 16 * nk, p.Sk,
                     p.sk.r);
  load_tile_async<D>(vs, p.v + b * p.sv.b + h * p.sv.h, 0, 16 * nk, p.Sk,
                     p.sv.r);
  load_tile_async<D>(dos, p.dout + b * p.sdo.b + h * p.sdo.h, 0, 16 * nq,
                     p.Sq, p.sdo.r);
  cp_async_commit();

  // This lane's query rows g and g + 8 of the warp's 16: lse (in base 2;
  // +inf past Sq, so P = 0 there) and whether all the row's keys are masked.
  float lse2[2];
  bool dead[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    const float lse = row < p.Sq ? p.lse[rows + row] : INFINITY;
    dead[hr] = mb != nullptr && lse < 0.5f * kMaskValue;
    lse2[hr] = lse * kLog2e;
  }
  const float sc2 = p.scale * kLog2e, inv_sk = 1.f / p.Sk;
  cp_async_wait<0>();
  __syncthreads();

  // S and dP for the warp's queries; P and dS in their place.
  float s[8][4], dp[8][4];
  const bool q_warp = r0 < p.Sq;
  if (q_warp) {
    float delta[2];
    const __nv_bfloat16* ob = p.out + b * p.so.b + h * p.so.h;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + g + 8 * hr;
      float acc = 0.f;
      if (row < p.Sq)
#pragma unroll
        for (int c = t; c < D / 8; c += 4)
          acc = dot8(*reinterpret_cast<const uint4*>(dos + row * kLd + 8 * c),
                     *reinterpret_cast<const uint4*>(ob + row * p.so.r + 8 * c),
                     acc);
      delta[hr] = quad_sum(acc);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], ad[4], bk[4][4], bv[4][4];
      frag_a<kLd>(a, qs, r0, kc * 16);
      frag_a<kLd>(ad, dos, r0, kc * 16);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nk) continue;
        frag_b_rows_n<kLd>(bk[c], ks, c * 16, kc * 16);
        frag_b_rows_n<kLd>(bv[c], vs, c * 16, kc * 16);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nk) continue;
        mma_bf16(s[2 * c], a, bk[c][0], bk[c][1]);
        mma_bf16(s[2 * c + 1], a, bk[c][2], bk[c][3]);
        mma_bf16(dp[2 * c], ad, bv[c][0], bv[c][1]);
        mma_bf16(dp[2 * c + 1], ad, bv[c][2], bv[c][3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = key_valid(mb, n * 8 + 2 * t + e, p.Sk);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& x = s[n][2 * hr + e];
          float& y = dp[n][2 * hr + e];
          const float pr =
              dead[hr] ? inv_sk
                       : (valid ? fast_exp2(fmaf(x, sc2, -lse2[hr])) : 0.f);
          x = pr;
          y = valid ? pr * (y - delta[hr]) : 0.f;
        }
      }

    // dq = round(dS) K.
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nk) continue;
      uint32_t a[4], bf[2][4];
      c_to_a(a, dp, c);
      frag_b_rows_k<kLd>(bf[0], ks, c * 16, 0);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (np + 1 < D / 16)
          frag_b_rows_k<kLd>(bf[(np + 1) & 1], ks, c * 16, (np + 1) * 16);
        mma_bf16(acc[2 * np], a, bf[np & 1][0], bf[np & 1][1]);
        mma_bf16(acc[2 * np + 1], a, bf[np & 1][2], bf[np & 1][3]);
      }
    }
    __nv_bfloat16* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
    float* dqfb = p.dq_f ? p.dq_f + b * p.sdq.b + h * p.sdq.h : nullptr;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + g + 8 * hr;
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
  __syncthreads();  // every warp has read V
  if (q_warp)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = swz64(r0 + g + 8 * hr, n * 8 + 2 * t);
        *reinterpret_cast<uint32_t*>(ps + i) =
            pack(s[n][2 * hr], s[n][2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(dss + i) =
            pack(dp[n][2 * hr], dp[n][2 * hr + 1]);
      }
  __syncthreads();
  if (r0 >= p.Sk) return;

  // dv = round(P)^T dO and dk = round(dS)^T Q for the warp's keys. The
  // A fragment (keys r0.., queries 16c..) is the transpose of the stored
  // [query][key] tile: ldmatrix.trans, matrix j covering keys + 8 (j % 2),
  // queries + 8 (j / 2).
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int j8 = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nq) continue;
    const int at = swz64(c * 16 + (j8 / 2) * 8 + r8, r0 + (j8 % 2) * 8);
    uint32_t pa[4], da[4], bo[2][4], bq[2][4];
    ldsm4_t(pa, ps + at);
    ldsm4_t(da, dss + at);
    frag_b_rows_k<kLd>(bo[0], dos, c * 16, 0);
    frag_b_rows_k<kLd>(bq[0], qs, c * 16, 0);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      if (np + 1 < D / 16) {
        frag_b_rows_k<kLd>(bo[(np + 1) & 1], dos, c * 16, (np + 1) * 16);
        frag_b_rows_k<kLd>(bq[(np + 1) & 1], qs, c * 16, (np + 1) * 16);
      }
      mma_bf16(dv[2 * np], pa, bo[np & 1][0], bo[np & 1][1]);
      mma_bf16(dv[2 * np + 1], pa, bo[np & 1][2], bo[np & 1][3]);
      mma_bf16(dk[2 * np], da, bq[np & 1][0], bq[np & 1][1]);
      mma_bf16(dk[2 * np + 1], da, bq[np & 1][2], bq[np & 1][3]);
    }
  }
  __nv_bfloat16* dkb = p.dk + b * p.sdk.b + h * p.sdk.h;
  __nv_bfloat16* dvb = p.dv + b * p.sdv.b + h * p.sdv.h;
  float* dkfb = p.dk_f ? p.dk_f + b * p.sdk.b + h * p.sdk.h : nullptr;
  float* dvfb = p.dv_f ? p.dv_f + b * p.sdv.b + h * p.sdv.h : nullptr;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = r0 + g + 8 * hr;
    if (key >= p.Sk) continue;
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

// Sk <= 64 < Sq (#4 at the CrossMAE decoder: 147 queries on 50 keys, and
// #7's cross-attention there): the whole backward in one kernel, one block
// of 8 warps per batch*head. K and V are loaded once; the query rows stream
// through a two-stage cp.async ring of 32-row stages (Q, dO, O and lse), the
// next stage loading while this one's products run. Per stage, two
// __syncthreads:
//   A. warp w takes query chunk w / 4 (16 rows) against key chunk w % 4
//      (16 keys): delta = rowsum(dO * O) for its rows, S and dP, then P and
//      dS, written to shared memory as [query][key] bf16 tiles with 16-byte
//      chunks XOR-swizzled by row (as in attn_bwd_one_tile_kernel).
//   B. warps 0-3 add round(P)^T dO to dv of key chunk w, warps 4-7
//      round(dS)^T Q to dk of key chunk w - 4: each warp keeps one 16 x Dh
//      fp32 accumulator for the whole kernel (64 registers at Dh = 128).
//   C. warp w: dq of query chunk w / 4, columns (w % 4) Dh / 4 ..: complete,
//      since the block holds every key, so it is stored at once.
// Each byte of Q, dO, O, K and V is read once and each gradient written
// once. 93 KB of shared memory at Dh = 128 and at most 128 registers a
// thread: two blocks (16 warps) per SM.
constexpr int kStreamThreads = 256;
constexpr int kStreamRows = 32;  // query rows per stage

template <int D>
__global__ void __launch_bounds__(kStreamThreads, 2)
    attn_bwd_stream_kernel(BwdParams<__nv_bfloat16> p) {
  constexpr int kLd = D + 8, kRows = kStreamRows;
  // A stage: Q, dO and O rows, then the rows' lse (fp32).
  constexpr int kStage = 3 * kRows * kLd + 2 * kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * kLd;
  __nv_bfloat16* ps = vs + kTile * kLd;      // kRows x 64 P, swizzled
  __nv_bfloat16* dss = ps + kRows * kTile;   // kRows x 64 dS, swizzled
  __nv_bfloat16* ring = dss + kRows * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, j8 = lane / 8, r8 = lane % 8;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nk = div_up(p.Sk, 16), n_stages = div_up(p.Sq, kRows);
  const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  const __nv_bfloat16* ob = p.out + b * p.so.b + h * p.so.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  const long long rows = (long long)bh * p.Sq;

  // Rows row0 .. row0 + n - 1 of a (rows, D) operand, zero past `last`.
  auto copy_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       int row0, int n, int last, long long stride) {
    constexpr int kPieces = D / 8;
    for (int i = threadIdx.x; i < n * kPieces; i += kStreamThreads) {
      const int r = i / kPieces, c = (i % kPieces) * 8, row = row0 + r;
      cp_async16(dst + r * kLd + c, row < last ? src + row * stride + c : src,
                 row < last);
    }
  };
  auto load_stage = [&](int st) {
    __nv_bfloat16* qs = ring + (st & 1) * kStage;
    const int q0 = st * kRows, n = min(kRows, 16 * div_up(p.Sq - q0, 16));
    copy_rows(qs, qb, q0, n, p.Sq, p.sq.r);
    copy_rows(qs + kRows * kLd, dob, q0, n, p.Sq, p.sdo.r);
    copy_rows(qs + 2 * kRows * kLd, ob, q0, n, p.Sq, p.so.r);
    if (threadIdx.x < kRows) {  // lse, zero past Sq (P there meets zero dO)
      const int q = q0 + threadIdx.x;
      cp_async4(reinterpret_cast<float*>(qs + 3 * kRows * kLd) + threadIdx.x,
                q < p.Sq ? p.lse + rows + q : p.lse, q < p.Sq);
    }
  };
  copy_rows(ks, p.k + b * p.sk.b + h * p.sk.h, 0, 16 * nk, p.Sk, p.sk.r);
  copy_rows(vs, p.v + b * p.sv.b + h * p.sv.h, 0, 16 * nk, p.Sk, p.sv.r);
  load_stage(0);
  cp_async_commit();

  // Phase A's query chunk and the key chunk of phases A and B.
  const int qa = warp / 4, kw = warp % 4;
  bool valid[2][2];  // phase A: keys 16 kw + 8n + 2t + e
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      valid[n][e] = key_valid(mb, 16 * kw + 8 * n + 2 * t + e, p.Sk);
  const float sc2 = p.scale * kLog2e, inv_sk = 1.f / p.Sk;
  // Phase B's operands: round(P)^T and dO for dv, round(dS)^T and Q for dk.
  const bool for_dv = warp < 4;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<0>();  // stage st has landed ...
    __syncthreads();     // ... for every thread; stage st - 1 is read
    if (st + 1 < n_stages) load_stage(st + 1);
    cp_async_commit();
    const int q0 = st * kRows, nq = min(2, div_up(p.Sq - q0, 16));
    const __nv_bfloat16* qs = ring + (st & 1) * kStage;
    const __nv_bfloat16* dos = qs + kRows * kLd;
    const __nv_bfloat16* os = dos + kRows * kLd;
    const float* ls = reinterpret_cast<const float*>(os + kRows * kLd);

    // A. P and dS of 16 queries x 16 keys.
    if (qa < nq && kw < nk) {
      const int r0 = 16 * qa;
      float delta[2], lse2[2];
      bool dead[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + g + 8 * hr;
        float d = 0.f;
#pragma unroll
        for (int c = t; c < D / 8; c += 4)
          d = dot8(*reinterpret_cast<const uint4*>(dos + r * kLd + 8 * c),
                   *reinterpret_cast<const uint4*>(os + r * kLd + 8 * c), d);
        delta[hr] = quad_sum(d);
        dead[hr] = mb != nullptr && ls[r] < 0.5f * kMaskValue;
        lse2[hr] = ls[r] * kLog2e;
      }
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4], ad[4], bk[4], bv[4];
        frag_a<kLd>(a, qs, r0, kc * 16);
        frag_a<kLd>(ad, dos, r0, kc * 16);
        frag_b_rows_n<kLd>(bk, ks, 16 * kw, kc * 16);
        frag_b_rows_n<kLd>(bv, vs, 16 * kw, kc * 16);
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
        mma_bf16(dp[0], ad, bv[0], bv[1]);
        mma_bf16(dp[1], ad, bv[2], bv[3]);
      }
      // P = exp(s - lse) (in base 2; uniform 1 / Sk on a row whose keys are
      // all masked), dS = P (dP - delta); both zero at masked keys and
      // keys past Sk, except P on such a dead row (its dv only).
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = s[n][2 * hr + e];
            float& y = dp[n][2 * hr + e];
            const float pr =
                dead[hr] ? inv_sk
                         : (valid[n][e] ? fast_exp2(fmaf(x, sc2, -lse2[hr]))
                                        : 0.f);
            x = pr;
            y = valid[n][e] ? pr * (y - delta[hr]) : 0.f;
          }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = swz64(r0 + g + 8 * hr, 16 * kw + 8 * n + 2 * t);
          *reinterpret_cast<uint32_t*>(ps + i) =
              pack(s[n][2 * hr], s[n][2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(dss + i) =
              pack(dp[n][2 * hr], dp[n][2 * hr + 1]);
        }
    }
    __syncthreads();

    // B. dv += round(P)^T dO or dk += round(dS)^T Q over the stage's
    // queries. The A fragment (keys 16 kw.., queries 16c..) is the
    // transpose of the stored [query][key] tile: ldmatrix.trans.
    if (kw < nk) {
      const __nv_bfloat16* lhs = for_dv ? ps : dss;
      const __nv_bfloat16* rhs = for_dv ? dos : qs;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c >= nq) continue;
        uint32_t a[4];
        ldsm4_t(a, lhs + swz64(c * 16 + (j8 / 2) * 8 + r8,
                               16 * kw + (j8 % 2) * 8));
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bf[4];
          frag_b_rows_k<kLd>(bf, rhs, c * 16, np * 16);
          mma_bf16(acc[2 * np], a, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    // C. dq = round(dS) K for 16 queries x Dh / 4 columns, stored at once.
    if (qa < nq) {
      constexpr int kN = D / 32;  // n8 tiles of the warp's columns
      const int r0 = 16 * qa, c0 = kw * (D / 4);
      float dq[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nk) continue;
        uint32_t a[4];
        ldsm4(a, dss + swz64(r0 + (lane & 15), 16 * j + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < kN / 2; ++np) {
          uint32_t bf[4];
          frag_b_rows_k<kLd>(bf, ks, 16 * j, c0 + 16 * np);
          mma_bf16(dq[2 * np], a, bf[0], bf[1]);
          mma_bf16(dq[2 * np + 1], a, bf[2], bf[3]);
        }
      }
      __nv_bfloat16* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
      float* dqfb = p.dq_f ? p.dq_f + b * p.sdq.b + h * p.sdq.h : nullptr;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + r0 + g + 8 * hr;
        if (row >= p.Sq) continue;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const long long i = row * p.sdq.r + c0 + n * 8 + 2 * t;
          const float x0 = dq[n][2 * hr] * p.scale;
          const float x1 = dq[n][2 * hr + 1] * p.scale;
          *reinterpret_cast<__nv_bfloat162*>(dqb + i) =
              __floats2bfloat162_rn(x0, x1);
          if (dqfb) *reinterpret_cast<float2*>(dqfb + i) = make_float2(x0, x1);
        }
      }
    }
  }

  if (kw >= nk) return;
  __nv_bfloat16* gb = for_dv ? p.dv + b * p.sdv.b + h * p.sdv.h
                             : p.dk + b * p.sdk.b + h * p.sdk.h;
  float* fb = for_dv ? p.dv_f : p.dk_f;
  if (fb) fb += for_dv ? b * p.sdv.b + h * p.sdv.h : b * p.sdk.b + h * p.sdk.h;
  const long long stride = for_dv ? p.sdv.r : p.sdk.r;
  const float mul = for_dv ? 1.f : p.scale;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = 16 * kw + g + 8 * hr;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long long i = key * stride + n * 8 + 2 * t;
      const float x0 = acc[n][2 * hr] * mul, x1 = acc[n][2 * hr + 1] * mul;
      *reinterpret_cast<__nv_bfloat162*>(gb + i) =
          __floats2bfloat162_rn(x0, x1);
      if (fb) *reinterpret_cast<float2*>(fb + i) = make_float2(x0, x1);
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

template <int MAXD>
size_t dq_smem_bytes(int dh) {
  constexpr int kT = Scalar<MAXD>::kT;
  return sizeof(float) * (size_t)(4 * kT * (dh + 1) + kT * (kT + 1));
}

template <int MAXD>
size_t dkdv_smem_bytes(int dh) {
  constexpr int kT = Scalar<MAXD>::kT;
  return sizeof(float) * (size_t)(4 * kT * (dh + 1) + 2 * kT * (kT + 1));
}

template <typename T>
bool valid_shape(const BwdParams<T>& p, int batch) {
  return p.Dh >= 1 && p.Dh <= kMaxHeadDim && p.Sq >= 1 && p.Sk >= 1 &&
         batch >= 1 && p.H >= 1 && (p.Sq + 31) / 32 <= 65535 &&
         (p.Sk + 31) / 32 <= 65535;
}

template <int MAXD, typename T>
int launch_scalar_at(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  constexpr int kT = Scalar<MAXD>::kT, kThr = Scalar<MAXD>::kThr;
  const size_t smem_dq = dq_smem_bytes<MAXD>(p.Dh);
  const size_t smem_dkdv = dkdv_smem_bytes<MAXD>(p.Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, MAXD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int bh = batch * p.H;
  attn_bwd_dq_kernel<T, MAXD>
      <<<dim3(bh, div_up(p.Sq, kT)), kThr, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<T, MAXD>
      <<<dim3(bh, div_up(p.Sk, kT)), kThr, smem_dkdv, stream>>>(p);
  return (int)cudaGetLastError();
}

// The recomputing scalar pair: heads up to 128 take the instance they
// always took, wider ones (up to kMaxHeadDim = 256) 32-row tiles.
template <typename T>
int launch_scalar(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  return p.Dh <= 128 ? launch_scalar_at<128>(p, batch, stream)
                     : launch_scalar_at<kMaxHeadDim>(p, batch, stream);
}

// The LSE bodies also read O (16-byte aligned rows) and need lse and the
// delta scratch, and put batch * H in the grid's y dimension.
inline bool lse_eligible(const BwdParams<__nv_bfloat16>& p, int batch) {
  return p.lse != nullptr && p.out != nullptr && p.row_delta != nullptr &&
         reinterpret_cast<uintptr_t>(p.out) % 16 == 0 && p.so.b % 8 == 0 &&
         p.so.h % 8 == 0 && p.so.r % 8 == 0 && (long long)batch * p.H <= 65535;
}

template <int D>
int launch_lse_mma(const BwdParams<__nv_bfloat16>& p, int batch,
                   cudaStream_t stream) {
  // The 64-row tiles of one operand pair and the two-stage ring of the other.
  constexpr size_t smem =
      ((2 * kTile + 2 * kRing * kStageRows) * (D + 8) +
       4 * kRing * kStageRows) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_lse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_lse_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bh = batch * p.H;
  attn_bwd_dq_lse_kernel<D>
      <<<dim3(div_up(p.Sq, kTile), bh), kMmaThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_lse_kernel<D>
      <<<dim3(div_up(p.Sk, kTile), bh), kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_one_tile(const BwdParams<__nv_bfloat16>& p, int batch,
                    cudaStream_t stream) {
  constexpr size_t tile = kTile * (D + 8);
  constexpr size_t smem =
      (4 * tile + (tile >= 2 * kTile * kTile ? 0 : 2 * kTile * kTile)) *
      sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_one_tile_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_one_tile_kernel<D>
      <<<batch * p.H, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_stream(const BwdParams<__nv_bfloat16>& p, int batch,
                  cudaStream_t stream) {
  // K and V, the P and dS tiles, and two stages of (Q, dO, O, lse).
  constexpr size_t smem =
      ((2 * kTile + 3 * 2 * kStreamRows) * (D + 8) +
       2 * kStreamRows * kTile + 2 * 2 * kStreamRows) *
      sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_stream_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_stream_kernel<D>
      <<<batch * p.H, kStreamThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Runs the backward over `batch` samples of p's strided views. fp32 takes
// the recomputing scalar pair (the forward's lse and O are not read).
inline int launch(const BwdParams<float>& p, int batch,
                  cudaStream_t stream) {
  if (!valid_shape(p, batch)) return (int)cudaErrorInvalidValue;
  return launch_scalar(p, batch, stream);
}

// bf16: with 16-byte aligned rows and Dh 64 or 128 the LSE bodies, which
// need the forward's lse and O (p.lse, p.out, p.so; cudaErrorInvalidValue
// without them): one kernel for Sk <= 64 (attn_bwd_one_tile_kernel when
// Sq <= 64 too, else attn_bwd_stream_kernel), two above. Every other case
// (Dh 256 among them) takes the recomputing scalar pair.
inline int launch(const BwdParams<__nv_bfloat16>& p, int batch,
                  cudaStream_t stream) {
  if (!valid_shape(p, batch)) return (int)cudaErrorInvalidValue;
  if (!mma_eligible(p)) return launch_scalar(p, batch, stream);
  if (!lse_eligible(p, batch)) return (int)cudaErrorInvalidValue;
  if (p.Sk <= kTile) {
    if (p.Sq <= kTile)
      return p.Dh == 128 ? launch_one_tile<128>(p, batch, stream)
                         : launch_one_tile<64>(p, batch, stream);
    return p.Dh == 128 ? launch_stream<128>(p, batch, stream)
                       : launch_stream<64>(p, batch, stream);
  }
  return p.Dh == 128 ? launch_lse_mma<128>(p, batch, stream)
                     : launch_lse_mma<64>(p, batch, stream);
}

}  // namespace attn_bwd
}  // namespace
