// Device code shared by the fused block-stack kernels (block_stack_fwd.cu,
// block_stack_bwd.cu): LayerNorm, GELU, the GEMM bodies with their fused
// epilogues, and the block's attention, which runs the attention kernels'
// own bodies (attention_fwd.cuh, attention_bwd.cuh) on the stack's packed
// q and kv rows, and the layout of the training state that the forward
// keeps for the backward (State, at the end). Included inside each source's
// unnamed namespace (through attention_common.cuh's), so each library keeps
// its own copy.
// ops/_build.py hashes this file with every source that includes it.
//
// Layouts. Activations are dense (rows, width) row-major in the compute
// type T (float or bf16); the weights are torch's (out, in). A GEMM computes
// C (M x N) = sum_k A(m, k) B(k, n) with fp32 sums, where A is stored either
// (M, K) ("mk", k contiguous) or (K, M) ("km", m contiguous) and B either
// (N, K) ("nk") or (K, N) ("kn"):
//   forward   y = x W^T        A = x (mk),       B = W (nk)
//   input     dx = dy W        A = dy (mk),      B = W (kn)
//   weight    dW = dy^T x      A = dy (km),      B = x (kn), summed over the
//                              rows in fixed-order splits (no atomics)
// The epilogue applies the TPU kernel's roundings (see Epi below).
//
// Bodies. bf16 with widths that are multiples of 8 and 16-byte aligned rows
// takes gemm_mma_kernel: 128 x 128 output tiles, 8 warps of 64 x 32, K in
// steps of 32 staged by cp.async into a four-stage shared-memory ring (rows
// padded by 8 elements: no bank conflicts), fragments read with ldmatrix
// (.trans for the transposed layouts), mma.sync.m16n8k16 bf16 -> fp32.
// Everything else (fp32, odd widths) takes gemm_scalar_kernel: 64 x 64
// tiles, 256 threads of 4 x 4 outputs, fp32 FMAs over 16-deep chunks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

constexpr float kLnEps = 1e-6f;
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluA = 0.044715f;
constexpr int kGeluTanh = 0;  // else erf

__device__ __forceinline__ float gelu_fwd(float x, int kind) {
  if (kind == kGeluTanh)
    return 0.5f * x * (1.f + tanhf(kGeluC * (x + kGeluA * x * x * x)));
  return 0.5f * x * (1.f + erff(x / 1.4142135623730951f));
}

__device__ __forceinline__ float gelu_grad(float x, int kind) {
  if (kind == kGeluTanh) {
    const float t = tanhf(kGeluC * (x + kGeluA * x * x * x));
    const float dinner = kGeluC * (1.f + 3.f * kGeluA * x * x);
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * dinner;
  }
  const float cdf = 0.5f * (1.f + erff(x / 1.4142135623730951f));
  return cdf + x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// LayerNorm forward: one warp per row, fp32 statistics,
// y = ((x - mean) * rstd) * g + b rounded to T. Where mean and rstd are
// given (the training state), the row's statistics are kept there (M).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    ln_fwd_kernel(const T* x, const T* g, const T* b, T* y, float* mean,
                  float* rstd_out, int M, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (long long)row * D;
  T* yr = y + (long long)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_float(xr[c]);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_float(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / D + kLnEps);
  if (mean != nullptr && lane == 0) {
    mean[row] = mu;
    rstd_out[row] = rstd;
  }
  for (int c = lane; c < D; c += 32)
    store(&yr[c], (to_float(xr[c]) - mu) * rstd * to_float(g[c]) +
                      to_float(b[c]));
}

template <typename T>
int ln_fwd(const T* x, const T* g, const T* b, T* y, float* mean,
           float* rstd, int M, int D, cudaStream_t st) {
  ln_fwd_kernel<T><<<cdiv(M, 8), 256, 0, st>>>(x, g, b, y, mean, rstd, M, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM with fused epilogues
// ---------------------------------------------------------------------------

enum EpiMode {
  kEpiBias,       // out = round(acc + bias)
  kEpiBiasRes,    // out = round(res + round(acc + bias))
  kEpiBiasGelu,   // a1 = round(acc + bias); out = a1 (if set);
                  // out2 = round(gelu(a1))
  kEpiGeluGrad,   // v = acc * gelu'(aux); outf = v; out = round(v)
  kEpiF32,        // outf = acc
  kEpiF32Add,     // outf += acc
  kEpiRound,      // out = round(acc)
  kEpiPartial,    // outf[z] = acc, the split z's partial sum
};

template <typename T>
struct Gemm {
  const T* a;
  const T* b;
  long long lda, ldb;
  int M, N, K;
  bool a_km, b_kn;  // layouts, see the header
  int k_chunk;      // K extent of one split (blockIdx.z), a multiple of 32
  int mode, gelu;
  const T* bias;    // (N)
  const T* res;     // (M, N)
  const T* aux;     // (M, N)
  T* out;           // (M, N)
  T* out2;          // (M, N)
  float* outf;      // (M, N), or (splits, M, N) partials
};

template <typename T>
__device__ __forceinline__ void epilogue(const Gemm<T>& p, int m, int n,
                                         float acc) {
  const long long i = (long long)m * p.N + n;
  switch (p.mode) {
    case kEpiBias:
      store(p.out + i, acc + to_float(p.bias[n]));
      break;
    case kEpiBiasRes:
      store(p.out + i,
            to_float(p.res[i]) + rnd<T>(acc + to_float(p.bias[n])));
      break;
    case kEpiBiasGelu: {
      const float a1 = rnd<T>(acc + to_float(p.bias[n]));
      if (p.out) store(p.out + i, a1);
      store(p.out2 + i, gelu_fwd(a1, p.gelu));
      break;
    }
    case kEpiGeluGrad: {
      const float v = acc * gelu_grad(to_float(p.aux[i]), p.gelu);
      p.outf[i] = v;
      store(p.out + i, v);
      break;
    }
    case kEpiF32:
      p.outf[i] = acc;
      break;
    case kEpiF32Add:
      p.outf[i] += acc;
      break;
    case kEpiRound:
      store(p.out + i, acc);
      break;
    default:  // kEpiPartial
      p.outf[(long long)blockIdx.z * p.M * p.N + i] = acc;
  }
}

template <typename T>
__device__ __forceinline__ float a_at(const Gemm<T>& p, int m, int k) {
  return to_float(p.a_km ? p.a[(long long)k * p.lda + m]
                         : p.a[(long long)m * p.lda + k]);
}
template <typename T>
__device__ __forceinline__ float b_at(const Gemm<T>& p, int k, int n) {
  return to_float(p.b_kn ? p.b[(long long)k * p.ldb + n]
                         : p.b[(long long)n * p.ldb + k]);
}

constexpr int kScTile = 64, kScStep = 16;

template <typename T>
__global__ void __launch_bounds__(256) gemm_scalar_kernel(Gemm<T> p) {
  __shared__ float as[kScStep][kScTile + 1];  // [k][m]
  __shared__ float bs[kScStep][kScTile + 1];  // [k][n]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * kScTile, m0 = blockIdx.y * kScTile;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kScStep) {
    __syncthreads();  // the previous chunk is read
    for (int i = tid; i < kScStep * kScTile; i += 256) {
      // Walk the contiguous dim of each operand with neighbouring threads.
      int kk = p.a_km ? i / kScTile : i % kScStep;
      int r = p.a_km ? i % kScTile : i / kScStep;
      int m = m0 + r, k = k0 + kk;
      as[kk][r] = (m < p.M && k < kend) ? a_at(p, m, k) : 0.f;
      kk = p.b_kn ? i / kScTile : i % kScStep;
      r = p.b_kn ? i % kScTile : i / kScStep;
      const int n = n0 + r;
      k = k0 + kk;
      bs[kk][r] = (n < p.N && k < kend) ? b_at(p, k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kScStep; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.N) epilogue(p, m, n, acc[i][j]);
    }
  }
}

// ---- tensor-core body ----

// Raises a kernel's dynamic shared-memory limit when it needs over 48 KB.
template <typename K>
int set_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}


constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 4;  // cp.async ring depth: 3 K steps in flight

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue of the tensor-core body, for columns n and n + 1 of row m
// (n even, N a multiple of 8), with the mode fixed at compile time: the same
// arithmetic as epilogue(), stored two columns at a time. (With the mode
// picked per element at run time, as the scalar body does, the block
// stacks ran about twice as long on the card.)
template <int MODE>
__device__ __forceinline__ void epilogue2(const Gemm<__nv_bfloat16>& p, int m,
                                          int n, float v0, float v1) {
  const long long i = (long long)m * p.N + n;
  if (MODE == kEpiBias) {
    const float2 b = ld2(p.bias + n);
    st2(p.out + i, v0 + b.x, v1 + b.y);
  } else if (MODE == kEpiBiasRes) {
    const float2 b = ld2(p.bias + n), r = ld2(p.res + i);
    st2(p.out + i, r.x + rnd<__nv_bfloat16>(v0 + b.x),
        r.y + rnd<__nv_bfloat16>(v1 + b.y));
  } else if (MODE == kEpiBiasGelu) {
    const float2 b = ld2(p.bias + n);
    const float a0 = rnd<__nv_bfloat16>(v0 + b.x);
    const float a1 = rnd<__nv_bfloat16>(v1 + b.y);
    if (p.out) st2(p.out + i, a0, a1);
    st2(p.out2 + i, gelu_fwd(a0, p.gelu), gelu_fwd(a1, p.gelu));
  } else if (MODE == kEpiGeluGrad) {
    const float2 a = ld2(p.aux + i);
    const float g0 = v0 * gelu_grad(a.x, p.gelu);
    const float g1 = v1 * gelu_grad(a.y, p.gelu);
    *reinterpret_cast<float2*>(p.outf + i) = make_float2(g0, g1);
    st2(p.out + i, g0, g1);
  } else if (MODE == kEpiF32) {
    *reinterpret_cast<float2*>(p.outf + i) = make_float2(v0, v1);
  } else if (MODE == kEpiF32Add) {
    float2* o = reinterpret_cast<float2*>(p.outf + i);
    const float2 x = *o;
    *o = make_float2(x.x + v0, x.y + v1);
  } else if (MODE == kEpiRound) {
    st2(p.out + i, v0, v1);
  } else {  // kEpiPartial
    *reinterpret_cast<float2*>(p.outf + (long long)blockIdx.z * p.M * p.N +
                               i) = make_float2(v0, v1);
  }
}

template <bool AKM, bool BKN, int MODE>
__global__ void __launch_bounds__(256)
    gemm_mma_kernel(Gemm<__nv_bfloat16> p) {
  // Shared tiles in the operands' global layouts: A (kBM, kBK+8) for mk or
  // (kBK, kBM+8) for km; B (kBN, kBK+8) for nk or (kBK, kBN+8) for kn.
  constexpr int kLdA = AKM ? kBM + 8 : kBK + 8;
  constexpr int kLdB = BKN ? kBN + 8 : kBK + 8;
  constexpr int kASize = AKM ? kBK * kLdA : kBM * kLdA;
  constexpr int kBSize = BKN ? kBK * kLdB : kBN * kLdB;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // kStages stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // warp's 64 x 32
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const int nk = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* as = smem + stage * (kASize + kBSize);
    __nv_bfloat16* bs = as + kASize;
    // 512 chunks of 8 elements per operand tile: two per thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int ch = tid + it * 256;
      if (AKM) {  // rows k, 16 chunks of m
        const int kk = ch / (kBM / 8), mm = (ch % (kBM / 8)) * 8;
        const int k = k0 + kk, m = m0 + mm;
        const bool ok = k < kend && m < p.M;
        cp_async16(as + kk * kLdA + mm, ok ? p.a + k * p.lda + m : p.a, ok);
      } else {  // rows m, 4 chunks of k
        const int mm = ch / (kBK / 8), kk = (ch % (kBK / 8)) * 8;
        const int m = m0 + mm, k = k0 + kk;
        const bool ok = m < p.M && k < kend;
        cp_async16(as + mm * kLdA + kk, ok ? p.a + m * p.lda + k : p.a, ok);
      }
      if (BKN) {  // rows k, 16 chunks of n
        const int kk = ch / (kBN / 8), nn = (ch % (kBN / 8)) * 8;
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < kend && n < p.N;
        cp_async16(bs + kk * kLdB + nn, ok ? p.b + k * p.ldb + n : p.b, ok);
      } else {  // rows n, 4 chunks of k
        const int nn = ch / (kBK / 8), kk = (ch % (kBK / 8)) * 8;
        const int n = n0 + nn, k = k0 + kk;
        const bool ok = n < p.N && k < kend;
        cp_async16(bs + nn * kLdB + kk, ok ? p.b + n * p.ldb + k : p.b, ok);
      }
    }
  };

  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, kbeg + st * kBK);
    cp_async_commit();
  }
  const int j8 = lane / 8, r8 = lane % 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; and stage kt - 1 is read
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, kbeg + next * kBK);
    cp_async_commit();
    const __nv_bfloat16* as = smem + (kt % kStages) * (kASize + kBSize);
    const __nv_bfloat16* bs = as + kASize;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm + i * 16;
        if (AKM)  // a_j = (m + 8 (j % 2), k + 8 (j / 2)) of X[k][m]
          ldsm4_t(af[i], as + (kk + (j8 / 2) * 8 + r8) * kLdA + mb +
                             (j8 % 2) * 8);
        else
          ldsm4(af[i], as + (mb + lane % 16) * kLdA + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int nb = wn + jp * 16;
        uint32_t r[4];  // b0, b1 of n tile 2jp, then of 2jp + 1
        if (BKN)
          ldsm4_t(r, bs + (kk + (j8 % 2) * 8 + r8) * kLdB + nb +
                         (j8 / 2) * 8);
        else
          ldsm4(r, bs + (nb + (j8 / 2) * 8 + r8) * kLdB + kk + (j8 % 2) * 8);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(c[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm + i * 16 + g + hr * 8;
        const int n = n0 + wn + j * 8 + 2 * t;
        if (m < p.M && n < p.N)
          epilogue2<MODE>(p, m, n, c[i][j][2 * hr], c[i][j][2 * hr + 1]);
      }
}

// The tensor-core body needs bf16, 16-byte aligned rows, operand widths
// (the contiguous dims) and N that are multiples of 8, and one of the
// (layout, epilogue) pairs launch_mma instantiates.
inline bool gemm_mma_ok(const Gemm<float>&) { return false; }
inline bool gemm_mma_ok(const Gemm<__nv_bfloat16>& p) {
  const bool a_ok = p.a_km ? p.M % 8 == 0 : p.K % 8 == 0;
  const bool b_ok = p.b_kn ? p.N % 8 == 0 : p.K % 8 == 0;
  const int md = p.mode;
  const bool pair =
      p.a_km ? p.b_kn && md == kEpiPartial
             : (p.b_kn ? md == kEpiGeluGrad || md == kEpiF32 ||
                             md == kEpiF32Add || md == kEpiRound
                       : md == kEpiBias || md == kEpiBiasRes ||
                             md == kEpiBiasGelu);
  return pair && a_ok && b_ok && p.N % 8 == 0 && p.lda % 8 == 0 &&
         p.ldb % 8 == 0 &&
         p.k_chunk % kBK == 0 && reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
}

inline int launch_mma(const Gemm<float>&, dim3, cudaStream_t) {
  return (int)cudaErrorInvalidValue;
}
// Shared memory of gemm_mma_kernel<AKM, BKN>: kStages stages of its A and
// B tiles.
constexpr size_t mma_smem(bool akm, bool bkn) {
  return kStages * sizeof(__nv_bfloat16) *
         ((akm ? kBK * (kBM + 8) : kBM * (kBK + 8)) +
          (bkn ? kBK * (kBN + 8) : kBN * (kBK + 8)));
}

template <bool AKM, bool BKN, int MODE>
int launch_mma_as(const Gemm<__nv_bfloat16>& p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = mma_smem(AKM, BKN);
  const int err = set_smem(gemm_mma_kernel<AKM, BKN, MODE>, smem);
  if (err) return err;
  gemm_mma_kernel<AKM, BKN, MODE><<<grid, 256, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// The (layout, epilogue) pairs the stacks use: forward products (mk, nk)
// with the forward epilogues, input gradients (mk, kn) with the backward
// ones, weight gradients (km, kn) as split partials.
inline int launch_mma(const Gemm<__nv_bfloat16>& p, dim3 grid,
                      cudaStream_t st) {
  if (p.a_km && p.b_kn && p.mode == kEpiPartial)
    return launch_mma_as<true, true, kEpiPartial>(p, grid, st);
  if (!p.a_km && p.b_kn) {
    switch (p.mode) {
      case kEpiGeluGrad:
        return launch_mma_as<false, true, kEpiGeluGrad>(p, grid, st);
      case kEpiF32: return launch_mma_as<false, true, kEpiF32>(p, grid, st);
      case kEpiF32Add:
        return launch_mma_as<false, true, kEpiF32Add>(p, grid, st);
      case kEpiRound:
        return launch_mma_as<false, true, kEpiRound>(p, grid, st);
    }
  }
  if (!p.a_km && !p.b_kn) {
    switch (p.mode) {
      case kEpiBias: return launch_mma_as<false, false, kEpiBias>(p, grid, st);
      case kEpiBiasRes:
        return launch_mma_as<false, false, kEpiBiasRes>(p, grid, st);
      case kEpiBiasGelu:
        return launch_mma_as<false, false, kEpiBiasGelu>(p, grid, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Runs p over `splits` K ranges (p.k_chunk is set here).
template <typename T>
int gemm(Gemm<T> p, int splits, cudaStream_t st) {
  p.k_chunk = ((cdiv(p.K, splits) + kBK - 1) / kBK) * kBK;
  if (gemm_mma_ok(p))
    return launch_mma(p, dim3(cdiv(p.N, kBN), cdiv(p.M, kBM), splits), st);
  gemm_scalar_kernel<T><<<dim3(cdiv(p.N, kScTile), cdiv(p.M, kScTile),
                               splits),
                          256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// y (M, N) = epilogue(x (M, K) . W^T), W (N, K).
template <typename T>
Gemm<T> fwd_gemm(const T* x, const T* w, int M, int N, int K, int mode) {
  Gemm<T> p = {};
  p.a = x;
  p.b = w;
  p.lda = K;
  p.ldb = K;
  p.M = M;
  p.N = N;
  p.K = K;
  p.mode = mode;
  return p;
}

// ---------------------------------------------------------------------------
// Shapes, weights and workspace
// ---------------------------------------------------------------------------

// The 16 stacked weights, in ops/block_kernel.py's W_KEYS order.
enum WKey {
  kLn1G, kLn1B, kLnkvG, kLnkvB, kWq, kBq, kWkv, kBkv, kWproj, kBproj,
  kLn2G, kLn2B, kWfc1, kBfc1, kWfc2, kBfc2, kNumW
};

struct Shape {
  int B, Sq, Sk, D, H, F, L;
  bool cross;
  long long M() const { return (long long)B * Sq; }   // query rows
  long long Mk() const { return (long long)B * (cross ? Sk : Sq); }
  // Elements of one block's slice of weight key k.
  long long wsize(int k) const {
    switch (k) {
      case kWq: case kWproj: return (long long)D * D;
      case kWkv: return 2LL * D * D;
      case kBkv: return 2LL * D;
      case kWfc1: case kWfc2: return (long long)F * D;
      case kBfc1: return F;
      default: return D;
    }
  }
};

// The attention bodies take head dims up to kMaxHeadDim and B * H blocks
// in the grid's y dimension.
inline bool valid_shape(const Shape& s) {
  return s.B >= 1 && s.Sq >= 1 && s.Sk >= 1 && s.D >= 1 && s.H >= 1 &&
         s.F >= 1 && s.L >= 1 && s.D % s.H == 0 &&
         s.D / s.H <= kMaxHeadDim && (long long)s.B * s.H <= 65535 &&
         cdiv(s.M(), kScTile) <= 65535 && cdiv(s.Mk(), kScTile) <= 65535;
}

// The block's attention on the stack's rows: q = qp (B*Sq, D), k and v the
// two halves of kvp (B*Sk', 2D), ctx (B*Sq, D); head h at columns h*Dh.
// Sk' is Sk in cross mode, else Sq.
template <typename T>
attn_fwd::Params<T> block_attention(const Shape& s, const T* qp, const T* kvp,
                                    T* ctx) {
  const int Sk = s.cross ? s.Sk : s.Sq, Dh = s.D / s.H;
  const Strides q = {(long long)s.Sq * s.D, Dh, s.D};
  const Strides kv = {2LL * Sk * s.D, Dh, 2LL * s.D};
  attn_fwd::Params<T> p = {};
  p.q = qp;
  p.k = kvp;
  p.v = kvp + s.D;
  p.o = ctx;
  p.sq = p.so = q;
  p.sk = p.sv = kv;
  p.H = s.H;
  p.Sq = s.Sq;
  p.Sk = Sk;
  p.Dh = Dh;
  p.scale = 1.f / sqrtf((float)Dh);
  return p;
}

// Bump allocator over the caller's workspace; every buffer 256-byte aligned.
// With base == nullptr it only counts the bytes.
struct Arena {
  char* base;
  size_t used;
  template <typename U>
  U* take(long long n) {
    U* p = base ? reinterpret_cast<U*>(base + used) : nullptr;
    used += ((size_t)n * sizeof(U) + 255) / 256 * 256;
    return p;
  }
};

// ---------------------------------------------------------------------------
// The training state: what block_stack_fwd keeps of every block, when a
// gradient is wanted, for block_stack_bwd to read instead of recomputing
// ---------------------------------------------------------------------------

// One block's activations in T: h = LN1(x), kvh = LNkv(kv) (cross only),
// qp (M, D), kvp (Mk, 2D), ctx, x1, h2 (M, D), a1 (before the GELU) and a2
// (M, F); and its row statistics in fp32: the attention's log-sum-exp
// (B*H, Sq), the mean and rstd of LN1's and LN2's rows (M) and of LNkv's
// (Mk, cross only). Absent fields are null. The order is
// ops/block_kernel.py's STATE_KEYS.
template <typename T>
struct State {
  T *h, *kvh, *qp, *kvp, *ctx, *x1, *h2, *a1, *a2;
  float *lse, *mean1, *rstd1, *mean2, *rstd2, *meankv, *rstdkv;
};
constexpr int kStateFields = 16;

// The fields of one block in order. Without `full`, the activations the
// forward passes from one launch to the next and nothing more (no a1, no
// statistics): the forward's workspace when it keeps no state.
template <typename T>
State<T> take_state(Arena& ar, const Shape& s, bool full) {
  const long long M = s.M(), Mk = s.Mk(), D = s.D, F = s.F;
  State<T> b = {};
  b.h = ar.take<T>(M * D);
  b.kvh = s.cross ? ar.take<T>(Mk * D) : nullptr;
  b.qp = ar.take<T>(M * D);
  b.kvp = ar.take<T>(Mk * 2 * D);
  b.ctx = ar.take<T>(M * D);
  b.x1 = ar.take<T>(M * D);
  b.h2 = ar.take<T>(M * D);
  if (full) b.a1 = ar.take<T>(M * F);
  b.a2 = ar.take<T>(M * F);
  if (!full) return b;
  b.lse = ar.take<float>((long long)s.B * s.H * s.Sq);
  b.mean1 = ar.take<float>(M);
  b.rstd1 = ar.take<float>(M);
  b.mean2 = ar.take<float>(M);
  b.rstd2 = ar.take<float>(M);
  if (s.cross) {
    b.meankv = ar.take<float>(Mk);
    b.rstdkv = ar.take<float>(Mk);
  }
  return b;
}

// Bytes of one block's state; the buffer holds L of them, block after block.
template <typename T>
long long state_block_bytes(const Shape& s) {
  Arena ar = {nullptr, 0};
  take_state<T>(ar, s, true);
  return (long long)ar.used;
}

// Block l's state in a buffer of s.L blocks.
template <typename T>
State<T> state_at(const void* base, const Shape& s, int l) {
  Arena ar = {const_cast<char*>(static_cast<const char*>(base)) +
                  (size_t)l * state_block_bytes<T>(s),
              0};
  return take_state<T>(ar, s, true);
}

}  // namespace
