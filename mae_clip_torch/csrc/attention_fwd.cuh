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
//     out = acc / max(l, 1e-30).
//   NORM = true (the block stacks, after the TPU stack kernel's single-shot
//     softmax): a first pass over the key tiles gives the row max m and sum
//     l; the second forms P = exp(s - m) / max(l, 1e-30) in fp32, rounds it
//     to the input type, and out = P . v. With one key tile (Sk <= 64) the
//     second pass reuses the first pass's scores.
//
// Design, bf16 with Dh = 64 or 128: attn_fwd_mma_kernel, one block of 4
// warps per (batch*head, 64-query tile), each warp owning 16 query rows as
// in FlashAttention-2. The warp keeps its Q rows in registers as mma.sync A
// fragments; each 64-key tile of K and V is staged in shared memory
// (row-major, rows padded by 8 elements: no bank conflicts on the fragment
// loads). S = Q.K^T and O += P.V run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the S accumulators are
// rescaled, exponentiated and repacked in registers as the A fragments of
// P.V, so scores never leave the registers; that repacking is where P
// rounds to bf16. 35 KB of static shared memory per block at Dh=128.
//
// Every other case (fp32 inputs, other head dims, strides not a multiple of
// 8 elements): attn_fwd_kernel, one block of 256 threads with scalar fp32
// FMAs. The Q tile stays in shared memory (as fp32) for the whole key loop;
// each thread owns 4 query rows x 4 keys of the score tile and the same 4
// rows x Dh/16 columns of the accumulator, so the row max and sum reduce
// over a half-warp with shuffles. Its dynamic shared memory is ~113 KB at
// Dh=128, above the 48 KB static limit, so the launcher raises the limit
// with cudaFuncSetAttribute first.

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
constexpr int kColsPerThread = kMaxHeadDim / 16;

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const float* mask;  // (B, Sk), > 0 = valid key; nullptr = all valid
  Strides sq, sk, sv, so;
  int H, Sq, Sk, Dh;
  float scale;
};

template <typename T, bool NORM>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params<T> p) {
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
  }
}

template <int D, bool NORM>
__global__ void __launch_bounds__(kMmaThreads)
    attn_fwd_mma_kernel(Params<__nv_bfloat16> p) {
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

  if (NORM) {  // pass 1: the row max and sum over every key
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
  }

  for (int k0 = 0; k0 < p.Sk; k0 += kBlockK) {
    // With NORM and one key tile, ks and the scores are pass 1's.
    const bool reuse = NORM && n_tiles == 1;
    __syncthreads();  // Q fragments / the previous tile are read
    if (!reuse) load_tile<D>(ks, kb, k0, p.Sk, p.sk.r);
    load_tile<D>(vs, vb, k0, p.Sk, p.sv.r);
    __syncthreads();
    if (!reuse) scores(k0);

    if (NORM) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = expf(s[n][e] - m[e / 2]) / l[e / 2];
    } else {
      // Online softmax; a row's 64 keys are spread over the 4 lanes of its
      // group. Key 0 of the first tile is finite, so m stays finite after
      // it.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float alpha = expf(m[hr] - m_new);
        m[hr] = m_new;
        l[hr] *= alpha;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = expf(s[n][2 * hr + e] - m_new);
            s[n][2 * hr + e] = pe;
            l[hr] += pe;
          }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * hr] *= alpha;
          o[n][2 * hr + 1] *= alpha;
        }
      }
    }

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
    float sum = 1.f;
    if (!NORM) {
      sum = l[hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum = fmaxf(sum, 1e-30f);
    }
    const int row = q0 + r0 + 8 * hr;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.so.r + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * hr] / sum, o[n][2 * hr + 1] / sum);
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

template <bool NORM, typename T>
int launch_scalar(const Params<T>& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
  attn_fwd_kernel<T, NORM><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Runs the forward over `batch` samples of p's strided views.
template <bool NORM>
int launch(const Params<float>& p, int batch, cudaStream_t stream) {
  if (!valid_shape(batch, p.H, p.Sq, p.Sk, p.Dh))
    return (int)cudaErrorInvalidValue;
  return launch_scalar<NORM>(p, batch, stream);
}

template <bool NORM>
int launch(const Params<__nv_bfloat16>& p, int batch, cudaStream_t stream) {
  if (!valid_shape(batch, p.H, p.Sq, p.Sk, p.Dh))
    return (int)cudaErrorInvalidValue;
  if (!mma_eligible(p)) return launch_scalar<NORM>(p, batch, stream);
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
  if (p.Dh == 128)
    attn_fwd_mma_kernel<128, NORM><<<grid, kMmaThreads, 0, stream>>>(p);
  else
    attn_fwd_mma_kernel<64, NORM><<<grid, kMmaThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace attn_fwd
}  // namespace
