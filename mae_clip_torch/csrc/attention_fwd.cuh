// Attention forward bodies, shared by attention_fwd.cu (kernels #1, #2) and
// the block stacks (block_stack_fwd.cu, block_stack_bwd.cu), which include
// this header inside their unnamed namespace; ops/_build.py hashes it with
// every source that includes it.
//
// Semantics (the plain PyTorch versions in ops/attention.py and
// ops/block_kernel.py):
//   s = (q . k) * scale, fp32; masked keys get -0.7 * FLT_MAX; keys past Sk
//   (the ragged edge of the last key tile) get -inf and weigh nothing.
//   NORM = false (#1, #2): online softmax over 64-key tiles with m/l/acc in
//     fp32, P rounded to the input type unnormalised,
//     out = acc / max(l, 1e-30). Where the caller passes p.lse (the
//     training path of #1 and #2), the row log-sum-exp lse = m + log(max(l,
//     1e-30)) is written too, fp32 (B*H, Sq), for the backward (#3, #4).
//   NORM = true (the block stacks, after the TPU stack kernel's single-shot
//     softmax): a first pass over the key tiles gives the row max m and sum
//     l; the second forms P = exp(s - m) / max(l, 1e-30) in fp32, rounds it
//     to the input type, and out = P . v. With one key tile (Sk <= 64) the
//     second pass reuses the first pass's scores. Given p.lse (the stack's
//     forward when it keeps its state for the backward), lse = m +
//     log(max(l, 1e-30)) is written as for #1.
//
// Bodies for bf16 with Dh = 64 or 128 and 16-byte aligned rows, one block of
// 4 warps per (batch*head, 64-query tile), each warp owning 16 query rows as
// in FlashAttention-2; S = Q.K^T and O += P.V on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate). The S accumulators are
// rescaled, exponentiated and repacked in registers as the A fragments of
// P.V, so scores never leave the registers; that repacking is where P rounds
// to bf16. Tiles sit in shared memory row-major with rows padded by 8
// elements (no bank conflicts on ldmatrix).
//   * attn_fwd_pipe_kernel (NORM = false). A call moves ~3x the bytes it
//     takes in FLOPs at the bf16 tensor rate, so it is bound by bytes and
//     by load latency: the tiles arrive by cp.async, the V tile while S
//     runs and the next K tile during the softmax and P.V
//     (FlashAttention-2's order, two __syncthreads per key tile). Q, K and
//     V fragments come from ldmatrix (.trans for V), the next step's while
//     this step's products run. Keys are walked in 16-key chunks and the
//     chunks past Sk are skipped (S = 197 is 13 chunks, not 16), and so is
//     a warp whose 16 query rows all lie past Sq. The softmax runs in base
//     2 with the scale folded into one FMA before ex2.approx; a full tile
//     with no mask skips the masking. Shared memory: one Q, one K and one
//     V tile, 52 KB at Dh = 128; 168 registers, three blocks per SM.
//   * attn_fwd_stream_kernel (NORM = false, Sk <= 64 < Sq: the CrossMAE
//     decoder's 147 queries on 50 keys): one block per batch*head loads K
//     and V once and its warps stream the 16-row query chunks (see the
//     kernel); four blocks an SM. The pipelined body would read K and V
//     once per 64-query tile and run a tile of 19 rows.
//   * attn_fwd_norm_kernel (NORM = true): each tile loaded into registers
//     and stored to shared memory between two __syncthreads, fragments by
//     32-bit and 16-bit shared loads; 35 KB of static shared memory.
//
// Every other case (fp32 inputs, other head dims up to kMaxHeadDim = 256,
// strides not a multiple of 8 elements): attn_fwd_kernel, one block of 256
// threads with scalar fp32 FMAs. The Q tile stays in shared memory (as
// fp32) for the whole key loop; each thread owns 4 query rows x 4 keys of
// the score tile and the same 4 rows x Dh/16 columns of the accumulator
// (sized by the widest head of the instance, 128 or 256), so the row max
// and sum reduce over a half-warp with shuffles. Its dynamic shared memory
// is ~113 KB at Dh=128 and ~209 KB at 256, above the 48 KB static limit,
// so the launcher raises the limit with cudaFuncSetAttribute first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {
namespace attn_fwd {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const float* mask;  // (B, Sk), > 0 = valid key; nullptr = all valid
  float* lse;         // (B*H, Sq) row log-sum-exp, written if not null
  Strides sq, sk, sv, so;
  int H, Sq, Sk, Dh;
  float scale;
};

// MAXD: the widest head the instance takes (128 or 256); it sizes the
// accumulator, Dh/16 columns per thread.
template <typename T, bool NORM, int MAXD>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params<T> p) {
  constexpr int kColsPerThread = MAXD / 16;
  extern __shared__ float smem[];
  const int ld = p.Dh + 1;  // padded row: no bank conflicts on column walks
  float* qs = smem;                      // kBlockQ x ld
  float* ks = qs + kBlockQ * ld;         // kBlockK x ld
  float* vs = ks + kBlockK * ld;         // kBlockK x ld
  float* ps = vs + kBlockK * ld;         // kBlockQ x (kBlockK + 1)
  const int lp = kBlockK + 1;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // keys tx + 16*j, columns tx + 16*c
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBlockQ;

  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* kb = p.k + b * p.sk.b + h * p.sk.h;
  const T* vb = p.v + b * p.sv.b + h * p.sv.h;
  T* ob = p.o + b * p.so.b + h * p.so.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;

  for (int i = tid; i < kBlockQ * p.Dh; i += kThreads) {
    const int r = i / p.Dh, c = i % p.Dh, row = q0 + r;
    qs[r * ld + c] = row < p.Sq ? to_float(qb[row * p.sq.r + c]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][kColsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.f;
  }

  // The K (and V) tile at k0 into shared memory, zero past Sk.
  auto load_kv = [&](int k0, bool with_v) {
    for (int i = tid; i < kBlockK * p.Dh; i += kThreads) {
      const int r = i / p.Dh, c = i % p.Dh, row = k0 + r;
      const bool in = row < p.Sk;
      ks[r * ld + c] = in ? to_float(kb[row * p.sk.r + c]) : 0.f;
      if (with_v) vs[r * ld + c] = in ? to_float(vb[row * p.sv.r + c]) : 0.f;
    }
  };
  // s[i][j]: row ty*4 + i, key k0 + tx + 16*j of the staged tile, scaled
  // and masked.
  float s[4][4];
  auto scores = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool in = key < p.Sk;
      const bool valid = in && (mb == nullptr || mb[key] > 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = !in ? -INFINITY : (valid ? s[i][j] * p.scale : kMaskValue);
    }
  };

  if (NORM) {  // pass 1: the row max and sum over every key
    for (int k0 = 0; k0 < p.Sk; k0 += kBlockK) {
      __syncthreads();
      load_kv(k0, false);
      __syncthreads();
      scores(k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] = l_i[i] * expf(m_i[i] - m_new) + rs;
        m_i[i] = m_new;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) l_i[i] = fmaxf(l_i[i], 1e-30f);
  }

  for (int k0 = 0; k0 < p.Sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    load_kv(k0, true);
    __syncthreads();
    scores(k0);

    if (NORM) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps[(ty * 4 + i) * lp + tx + 16 * j] =
              rnd<T>(expf(s[i][j] - m_i[i]) / l_i[i]);
    } else {
      // Online softmax. Key 0 of every tile row group lies inside Sk on the
      // first tile, so m_new is finite from then on and exp(-inf - m) = 0.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        const float alpha = expf(m_i[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(s[i][j] - m_new);
          ps[(ty * 4 + i) * lp + tx + 16 * j] = e;
          rs += e;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] = l_i[i] * alpha + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[i][c] *= alpha;
      }
    }
    __syncthreads();

    const int kn = min(kBlockK, p.Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * lp + kk];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < p.Dh ? vs[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float l = NORM ? 1.f : fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = tx + 16 * c;
      if (col < p.Dh) store(&ob[row * p.so.r + col], acc[i][c] / l);
    }
    if (p.lse != nullptr && tx == 0)
      p.lse[(long long)blockIdx.y * p.Sq + row] =
          m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    attn_fwd_norm_kernel(Params<__nv_bfloat16> p) {
  constexpr int kLd = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBlockQ;

  const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vb = p.v + b * p.sv.b + h * p.sv.h;
  __nv_bfloat16* ob = p.o + b * p.so.b + h * p.so.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;

  // The Q tile passes through ks once; each warp keeps its 16 rows as A
  // fragments (rows g and g+8, columns 2t.. of each 16-wide chunk).
  load_tile<D>(ks, qb, q0, p.Sq, p.sq.r);
  __syncthreads();
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* q = ks + r0 * kLd + kc * 16 + 2 * t;
    qf[kc][0] = ld32(q);
    qf[kc][1] = ld32(q + 8 * kLd);
    qf[kc][2] = ld32(q + 8);
    qf[kc][3] = ld32(q + 8 * kLd + 8);
  }

  // S = Q K^T of the key tile at k0 staged in ks, scaled and masked: 16 rows
  // x 64 keys per warp, s[n][2*hr + e] is row g + 8*hr, key k0 + 8n + 2t + e.
  float s[8][4];
  auto scores = [&](int k0) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * kLd + kc * 16 + 2 * t;
        mma_bf16(s[n], qf[kc], ld32(kr), ld32(kr + 8));
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + n * 8 + 2 * t + e;
        const bool in = key < p.Sk;
        const bool valid = in && (mb == nullptr || mb[key] > 0.f);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& x = s[n][2 * hr + e];
          x = !in ? -INFINITY : (valid ? x * p.scale : kMaskValue);
        }
      }
  };

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // m is the row's, reduced over the 4 lanes of its group; l is this
  // lane's share of the row sum.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_tiles = (p.Sk + kBlockK - 1) / kBlockK;

  // Pass 1: the row max and sum over every key.
  for (int k0 = 0; k0 < p.Sk; k0 += kBlockK) {
    __syncthreads();  // Q fragments / the previous tile are read
    load_tile<D>(ks, kb, k0, p.Sk, p.sk.r);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float se = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        se += expf(s[n][2 * hr] - m_new) + expf(s[n][2 * hr + 1] - m_new);
      l[hr] = l[hr] * expf(m[hr] - m_new) + se;
      m[hr] = m_new;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    l[hr] = fmaxf(l[hr], 1e-30f);
  }

  // Pass 2: P normalised, rounded, times V.
  for (int k0 = 0; k0 < p.Sk; k0 += kBlockK) {
    // With one key tile, ks and the scores are pass 1's.
    const bool reuse = n_tiles == 1;
    __syncthreads();  // Q fragments / the previous tile are read
    if (!reuse) load_tile<D>(ks, kb, k0, p.Sk, p.sk.r);
    load_tile<D>(vs, vb, k0, p.Sk, p.sv.r);
    __syncthreads();
    if (!reuse) scores(k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = expf(s[n][e] - m[e / 2]) / l[e / 2];

    // O += P V, P repacked from the S accumulators as 16-key A fragments.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t a[4] = {pack(s[2 * j][0], s[2 * j][1]),
                             pack(s[2 * j][2], s[2 * j][3]),
                             pack(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = vs + (j * 16 + 2 * t) * kLd + n * 8 + g;
        mma_bf16(o[n], a, pack(vr[0], vr[kLd]),
                 pack(vr[8 * kLd], vr[9 * kLd]));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.so.r + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * hr], o[n][2 * hr + 1]);
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)blockIdx.y * p.Sq + row] = m[hr] + logf(l[hr]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
    attn_fwd_pipe_kernel(Params<__nv_bfloat16> p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * kLd;
  __nv_bfloat16* vs = ks + kBlockK * kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const bool active = q0 + r0 < p.Sq;  // the warp holds a query row

  const __nv_bfloat16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;
  // The 16-row chunks of the 64-row tile at row0 that hold a row below n.
  auto chunks = [](int row0, int n) { return min(4, div_up(n - row0, 16)); };

  load_tile_async<D>(qs, p.q + b * p.sq.b + h * p.sq.h, q0,
                     16 * chunks(q0, p.Sq), p.Sq, p.sq.r);
  load_tile_async<D>(ks, kb, 0, 16 * chunks(0, p.Sk), p.Sk, p.sk.r);
  load_tile_async<D>(vs, vb, 0, 16 * chunks(0, p.Sk), p.Sk, p.sv.r);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // The softmax runs in base 2 on s * scale * log2(e): m is the row's max,
  // reduced over the 4 lanes of its group; l is this lane's share of the
  // row sum.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sc2 = p.scale * kLog2e;
  const int n_tiles = div_up(p.Sk, kBlockK);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK, nc = chunks(k0, p.Sk);
    cp_async_wait<0>();  // this K tile has landed ...
    __syncthreads();     // ... for every thread, and the V tile is read
    if (kt > 0) load_tile_async<D>(vs, vb, k0, 16 * nc, p.Sk, p.sv.r);
    cp_async_commit();   // the V tile loads while S is computed
    // S = Q K^T over the live chunks: s[n][2 * hr + e] is row g + 8 * hr,
    // key k0 + 8n + 2t + e. The fragments of step kc + 1 load while the
    // products of step kc run.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (active) {
      uint32_t a[2][4], bk[2][4][4];
      auto frags = [&](int kc, int buf) {
        frag_a<kLd>(a[buf], qs, r0, kc * 16);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nc) frag_b_rows_n<kLd>(bk[buf][c], ks, c * 16, kc * 16);
      };
      frags(0, 0);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        if (kc + 1 < D / 16) frags(kc + 1, (kc + 1) & 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= nc) continue;
          mma_bf16(s[2 * c], a[kc & 1], bk[kc & 1][c][0], bk[kc & 1][c][1]);
          mma_bf16(s[2 * c + 1], a[kc & 1], bk[kc & 1][c][2],
                   bk[kc & 1][c][3]);
        }
      }
    }
    cp_async_wait<0>();  // this V tile has landed ...
    __syncthreads();     // ... for every thread, and the K tile is read
    if (kt + 1 < n_tiles)  // the next K tile loads during softmax and P V
      load_tile_async<D>(ks, kb, k0 + kBlockK,
                         16 * chunks(k0 + kBlockK, p.Sk), p.Sk, p.sk.r);
    cp_async_commit();
    if (!active) continue;

    // A full tile with no mask keeps the raw scores (the scale folds into
    // the exponent); else scale and mask: masked keys score
    // -0.7 * FLT_MAX, keys past Sk (and the skipped chunks) -inf. Key 0 of
    // the first tile is finite, so m stays finite after it.
    const bool full = mb == nullptr && k0 + kBlockK <= p.Sk;
    const float mul = full ? sc2 : 1.f;
    if (!full) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + 2 * t + e;
          const bool in = key < p.Sk;
          const bool valid = in && (mb == nullptr || mb[key] > 0.f);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = s[n][2 * hr + e];
            x = !in ? -INFINITY : (valid ? x * sc2 : kMaskValue);
          }
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx) * mul);
      const float alpha = fast_exp2(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= alpha;
#pragma unroll
      for (int n = 0; n < 8; ++n)  // skipped chunks: exp2(-inf) = 0
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = fast_exp2(fmaf(x, mul, -m_new));
          l[hr] += x;
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * hr] *= alpha;
        o[n][2 * hr + 1] *= alpha;
      }
    }

    // O += P V, P repacked from the S accumulators as 16-key A fragments;
    // the V fragments of step np + 1 load while step np's products run.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nc) continue;
      uint32_t pa[4], bv[2][4];
      c_to_a(pa, s, c);
      frag_b_rows_k<kLd>(bv[0], vs, c * 16, 0);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (np + 1 < D / 16)
          frag_b_rows_k<kLd>(bv[(np + 1) & 1], vs, c * 16, (np + 1) * 16);
        mma_bf16(o[2 * np], pa, bv[np & 1][0], bv[np & 1][1]);
        mma_bf16(o[2 * np + 1], pa, bv[np & 1][2], bv[np & 1][3]);
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* ob = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float sum = fmaxf(quad_sum(l[hr]), 1e-30f), inv = 1.f / sum;
    const int row = q0 + r0 + g + 8 * hr;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.so.r + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
    // lse = m + log(l) in base e; a row whose keys are all masked has
    // m = -0.7 * FLT_MAX, which keeps that value (as in base e).
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * p.Sq + row] =
          m[hr] <= 0.5f * kMaskValue ? kMaskValue
                                     : (m[hr] + log2f(sum)) * kLn2;
  }
}

// Sk <= 64 < Sq (the CrossMAE decoder's cross-attention: 147 queries on 50
// keys): one block per batch*head loads K and V once, and its 4 warps
// stream the 16-row query chunks, warp w taking chunks w, w + 4, ... into
// its own chunk buffer (cp.async); after K and V have landed no warp waits
// for another. One key tile: the softmax is exact in one pass (no
// rescaling of O). O = P V is formed in two column halves, and goes through
// the chunk's buffer for 16-byte stores. That keeps a block at 52 KB of
// shared memory and 128 registers a thread, so four blocks fit an SM: the
// decoder's 512 blocks all run in one wave, and 16 warps an SM hide each
// other's loads (a second buffer per warp to prefetch the next chunk
// costs the fourth block, and measured slower).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 4)
    attn_fwd_stream_kernel(Params<__nv_bfloat16> p) {
  constexpr int kLd = D + 8, kPieces = D / 8, kCols = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockK * kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  __nv_bfloat16* qs = vs + kBlockK * kLd + warp * 16 * kLd;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nk = div_up(p.Sk, 16), nq = div_up(p.Sq, 16);  // 16-row chunks
  const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
  __nv_bfloat16* ob = p.o + b * p.so.b + h * p.so.h;
  const float* mb = p.mask ? p.mask + (long long)b * p.Sk : nullptr;

  load_tile_async<D>(ks, p.k + b * p.sk.b + h * p.sk.h, 0, 16 * nk, p.Sk,
                     p.sk.r);
  load_tile_async<D>(vs, p.v + b * p.sv.b + h * p.sv.h, 0, 16 * nk, p.Sk,
                     p.sv.r);
  cp_async_commit();
  // Query rows row0 .. row0 + 15 into the warp's buffer, zero past Sq; the
  // warp's lanes copy 16 bytes each per step.
  auto load_chunk = [&](__nv_bfloat16* dst, int row0) {
#pragma unroll
    for (int j = 0; j < 16 * kPieces / 32; ++j) {
      const int i = lane + 32 * j;
      const int r = i / kPieces, c = (i % kPieces) * 8, row = row0 + r;
      cp_async16(dst + r * kLd + c, row < p.Sq ? qb + row * p.sq.r + c : qb,
                 row < p.Sq);
    }
  };
  if (warp < nq) load_chunk(qs, 16 * warp);
  cp_async_commit();

  // This lane's keys 8n + 2t + e: bit 2n + e of `inside` (below Sk) and of
  // `valid` (below Sk and not masked).
  uint32_t inside = 0, valid = 0;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = n * 8 + 2 * t + e;
      if (key < p.Sk) {
        inside |= 1u << (2 * n + e);
        if (mb == nullptr || mb[key] > 0.f) valid |= 1u << (2 * n + e);
      }
    }
  const float sc2 = p.scale * kLog2e;
  cp_async_wait<0>();  // K, V and the first chunks have landed ...
  __syncthreads();     // ... for every thread

  for (int c = warp; c < nq; c += 4) {
    cp_async_wait<0>();  // this chunk has landed ...
    __syncwarp();        // ... for every lane of the warp

    // S = Q K^T over the live key chunks: s[n][2 * hr + e] is row g + 8 hr,
    // key 8n + 2t + e.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], bk[4][4];
      frag_a<kLd>(a, qs, 0, kc * 16);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (cc < nk) frag_b_rows_n<kLd>(bk[cc], ks, cc * 16, kc * 16);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (cc >= nk) continue;
        mma_bf16(s[2 * cc], a, bk[cc][0], bk[cc][1]);
        mma_bf16(s[2 * cc + 1], a, bk[cc][2], bk[cc][3]);
      }
    }
    // The softmax in base 2 on s * scale * log2(e): masked keys score
    // -0.7 * FLT_MAX (so a row whose keys are all masked has uniform
    // weights), keys past Sk -inf. m is the row's max; l its sum.
    float m[2], l[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t bit = 1u << (2 * n + e);
          float& x = s[n][2 * hr + e];
          x = !(inside & bit) ? -INFINITY
                              : ((valid & bit) ? x * sc2 : kMaskValue);
          mx = fmaxf(mx, x);
        }
      m[hr] = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = fast_exp2(x - m[hr]);
          sum += x;
        }
      l[hr] = fmaxf(quad_sum(sum), 1e-30f);
    }

    // O = P V by column halves, P repacked from the S accumulators as
    // 16-key A fragments; O / l into the chunk's buffer (its Q is read).
    __syncwarp();
#pragma unroll
    for (int ps = 0; ps < 2; ++ps) {
      float o[kCols / 8][4];
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (cc >= nk) continue;
        uint32_t pa[4];
        c_to_a(pa, s, cc);
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np) {
          uint32_t bv[4];
          frag_b_rows_k<kLd>(bv, vs, cc * 16, ps * kCols + np * 16);
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float inv = 1.f / l[hr];
#pragma unroll
        for (int n = 0; n < kCols / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(
              qs + (g + 8 * hr) * kLd + ps * kCols + n * 8 + 2 * t) =
              __floats2bfloat162_rn(o[n][2 * hr] * inv,
                                    o[n][2 * hr + 1] * inv);
      }
    }
    // The row log-sum-exp where the caller asks for it; then the stores.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = 16 * c + g + 8 * hr;
      if (p.lse != nullptr && t == 0 && row < p.Sq)
        p.lse[(long long)bh * p.Sq + row] =
            m[hr] <= 0.5f * kMaskValue ? kMaskValue
                                       : (m[hr] + log2f(l[hr])) * kLn2;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16 * kPieces / 32; ++j) {
      const int i = lane + 32 * j;
      const int r = i / kPieces, col = (i % kPieces) * 8, row = 16 * c + r;
      if (row < p.Sq)
        *reinterpret_cast<uint4*>(ob + row * p.so.r + col) =
            *reinterpret_cast<const uint4*>(qs + r * kLd + col);
    }
    __syncwarp();  // the buffer is read: it takes the warp's next chunk
    if (c + 4 < nq) load_chunk(qs, 16 * (c + 4));
    cp_async_commit();
  }
}

// The tensor-core kernel needs 16-byte aligned rows: every pointer on a
// 16-byte boundary and every stride a multiple of 8 elements.
inline bool mma_eligible(const Params<__nv_bfloat16>& p) {
  const Strides all[4] = {p.sq, p.sk, p.sv, p.so};
  for (const Strides& s : all)
    if (s.b % 8 || s.h % 8 || s.r % 8) return false;
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return p.Dh == 64 || p.Dh == 128;
}

inline size_t smem_bytes(int dh) {
  return sizeof(float) *
         (size_t)(kBlockQ * (dh + 1) + 2 * kBlockK * (dh + 1) +
                  kBlockQ * (kBlockK + 1));
}

inline bool valid_shape(int batch, int H, int Sq, int Sk, int Dh) {
  return Dh >= 1 && Dh <= kMaxHeadDim && Sq >= 1 && Sk >= 1 && batch >= 1 &&
         H >= 1 && (long long)batch * H <= 65535;
}

template <bool NORM, int MAXD, typename T>
int launch_scalar_at(const Params<T>& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, NORM, MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
  attn_fwd_kernel<T, NORM, MAXD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Heads up to 128 take the instance they always took; wider ones (up to
// kMaxHeadDim = 256: 214,016 bytes of shared memory) the wide one.
template <bool NORM, typename T>
int launch_scalar(const Params<T>& p, int batch, cudaStream_t stream) {
  return p.Dh <= 128 ? launch_scalar_at<NORM, 128>(p, batch, stream)
                     : launch_scalar_at<NORM, kMaxHeadDim>(p, batch, stream);
}

// Runs the forward over `batch` samples of p's strided views.
template <bool NORM>
int launch(const Params<float>& p, int batch, cudaStream_t stream) {
  if (!valid_shape(batch, p.H, p.Sq, p.Sk, p.Dh))
    return (int)cudaErrorInvalidValue;
  return launch_scalar<NORM>(p, batch, stream);
}

template <int D>
int launch_pipe(const Params<__nv_bfloat16>& p, int batch,
                cudaStream_t stream) {
  constexpr size_t smem = 3 * kBlockK * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_pipe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(div_up(p.Sq, kBlockQ), batch * p.H);
  attn_fwd_pipe_kernel<D><<<grid, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_stream(const Params<__nv_bfloat16>& p, int batch,
                  cudaStream_t stream) {
  // K, V, and one 16-row chunk buffer per warp.
  constexpr size_t smem =
      (2 * kBlockK + (kMmaThreads / 32) * 16) * (D + 8) *
      sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_stream_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_stream_kernel<D><<<batch * p.H, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool NORM>
int launch(const Params<__nv_bfloat16>& p, int batch, cudaStream_t stream) {
  if (!valid_shape(batch, p.H, p.Sq, p.Sk, p.Dh))
    return (int)cudaErrorInvalidValue;
  if (!mma_eligible(p)) return launch_scalar<NORM>(p, batch, stream);
  if constexpr (!NORM) {
    // One key tile and more than one query tile: K and V once per
    // batch*head. Else (and so always for the packed #1, Sq = Sk) the
    // pipelined body.
    if (p.Sk <= kBlockK && p.Sq > kBlockQ)
      return p.Dh == 128 ? launch_stream<128>(p, batch, stream)
                         : launch_stream<64>(p, batch, stream);
    return p.Dh == 128 ? launch_pipe<128>(p, batch, stream)
                       : launch_pipe<64>(p, batch, stream);
  } else {
    const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
    if (p.Dh == 128)
      attn_fwd_norm_kernel<128><<<grid, kMmaThreads, 0, stream>>>(p);
    else
      attn_fwd_norm_kernel<64><<<grid, kMmaThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
}

}  // namespace attn_fwd
}  // namespace
