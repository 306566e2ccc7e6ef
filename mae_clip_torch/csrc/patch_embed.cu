// Masked patch embedding for Hopper (sm_90a), with a plain C interface
// (bound from Python through ctypes, see mae_clip_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel of the JAX package
//
//   * masked_patch_embed_fwd <- mae_clip_tpu/ops/patch_embed.py _kernel
//                               (pallas_call in _pallas_forward).
//
// It gathers the K visible patch rows of each image and projects them:
//
//   out[b, k, :] = patches[b, ids[b, k], :] . W^T + bias
//
// patches (B, N, Din), ids (B, K) int64, W (Dm, Din) (torch's Linear
// layout), bias (Dm), out (B, K, Dm), all contiguous. Semantics (same as
// masked_patch_embed_ref in ops/patch_embed.py, and as the TPU kernel): the
// gathered rows are exact, the products accumulate in fp32, the bias is
// added in fp32 and the sum is rounded once to the input type. An index
// outside [0, N) reads nothing and gives a row of NaN.
//
// The TPU kernel gathers with a one-hot matmul because Mosaic rejects
// dynamic row loads. Here a block reads each gathered row straight from
// device memory: the work is one GEMM over the M = B*K gathered rows,
// N = Dm, K = Din, with the row indirection folded into the A-tile loads.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the MAE-pretrain
// step's shape (B=256, N=196, Din=768, K=49, Dm=384, bf16): the rows read
// (19.3 MB), W (0.6 MB), ids (0.1 MB) and the output (9.6 MB) make 29.6 MB,
// 8.8 us; 7.4 GFLOP is 7.5 us of tensor-core time. Bound by bytes, barely.
//
// Design, bf16 with Din and Dm multiples of 8 (the pretrain step):
// embed_mma_kernel, one block of 4 warps per 64 x 64 output tile. Each
// 64-deep chunk of the 64 gathered rows and of the 64 weight rows is staged
// in shared memory with 16-byte loads (rows padded by 8 elements: no bank
// conflicts on the fragment loads); each warp owns 16 rows x 64 columns and
// runs mma.sync.m16n8k16 (bf16 in, fp32 accumulate). W's rows are already
// contiguous in Din, the "col" layout the B operand takes. Rows past M and
// columns past Dm or Din are zero-filled; the output stores are masked.
//
// Every other case (fp32, unaligned widths): embed_kernel, 256 threads with
// scalar fp32 FMAs over 16-deep chunks, each thread 4 rows x 4 columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kTile = 64;    // output rows and columns per block
constexpr int kDepth = 64;   // Din chunk of the tensor-core body
constexpr int kStep = 16;    // Din chunk of the scalar body
constexpr int kThreads = 256;

template <typename T>
struct Params {
  const T* patches;
  const long long* ids;
  const T* w;
  const T* bias;
  T* out;
  int M, N, K, Din, Dm;
};

// Element offset of gathered row m in patches; -1 past M or for an index
// outside [0, N).
template <typename T>
__device__ __forceinline__ long long row_offset(const Params<T>& p, int m) {
  if (m >= p.M) return -1;
  const long long id = p.ids[m];
  if (id < 0 || id >= p.N) return -1;
  return ((long long)(m / p.K) * p.N + id) * p.Din;
}

template <typename T>
__device__ __forceinline__ float finish(const Params<T>& p, float acc,
                                        int col, bool bad) {
  return bad ? NAN : acc + to_float(p.bias[col]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) embed_kernel(Params<T> p) {
  __shared__ float as[kTile][kStep + 1];
  __shared__ float ws[kTile][kStep + 1];
  __shared__ long long rows[kTile];
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // columns tx + 16*j
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  if (tid < kTile) rows[tid] = row_offset(p, m0 + tid);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Din; k0 += kStep) {
    __syncthreads();  // rows[] is written / the previous chunk is read
    for (int i = tid; i < kTile * kStep; i += kThreads) {
      const int r = i / kStep, kk = i % kStep, col = k0 + kk;
      const bool in = col < p.Din;
      as[r][kk] = in && rows[r] >= 0 ? to_float(p.patches[rows[r] + col])
                                     : 0.f;
      ws[r][kk] = in && n0 + r < p.Dm
                      ? to_float(p.w[(long long)(n0 + r) * p.Din + col])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, m = m0 + r;
    if (m >= p.M) continue;
    const bool bad = rows[r] < 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < p.Dm)
        store(&p.out[(long long)m * p.Dm + col],
              finish(p, acc[i][j], col, bad));
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    embed_mma_kernel(Params<__nv_bfloat16> p) {
  constexpr int kLd = kDepth + 8, kChunks = kDepth / 8;
  __shared__ __align__(16) __nv_bfloat16 as[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 ws[kTile * kLd];
  __shared__ long long rows[kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column
  const int r0 = warp * 16 + g;          // this lane's rows r0 and r0 + 8
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  if (threadIdx.x < kTile) rows[threadIdx.x] = row_offset(p, m0 + threadIdx.x);

  // c[n][2*hr + e]: row r0 + 8*hr, column n0 + 8n + 2t + e.
  float c[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;

  for (int k0 = 0; k0 < p.Din; k0 += kDepth) {
    __syncthreads();  // rows[] is written / the previous chunk is read
    for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, cc = (i % kChunks) * 8, col = k0 + cc;
      uint4 a = make_uint4(0, 0, 0, 0), w = make_uint4(0, 0, 0, 0);
      if (col < p.Din) {
        if (rows[r] >= 0)
          a = *reinterpret_cast<const uint4*>(p.patches + rows[r] + col);
        if (n0 + r < p.Dm)
          w = *reinterpret_cast<const uint4*>(
              p.w + (long long)(n0 + r) * p.Din + col);
      }
      *reinterpret_cast<uint4*>(as + r * kLd + cc) = a;
      *reinterpret_cast<uint4*>(ws + r * kLd + cc) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kDepth / 16; ++kc) {
      const __nv_bfloat16* ar = as + r0 * kLd + kc * 16 + 2 * t;
      const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLd), ld32(ar + 8),
                              ld32(ar + 8 * kLd + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* wr = ws + (n * 8 + g) * kLd + kc * 16 + 2 * t;
        mma_bf16(c[n], af, ld32(wr), ld32(wr + 8));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr, m = m0 + r;
    if (m >= p.M) continue;
    const bool bad = rows[r] < 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n0 + n * 8 + 2 * t;  // Dm % 8 == 0: col + 1 < Dm too
      if (col >= p.Dm) continue;
      *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)m * p.Dm + col) =
          __floats2bfloat162_rn(finish(p, c[n][2 * hr], col, bad),
                                finish(p, c[n][2 * hr + 1], col + 1, bad));
    }
  }
}

// The tensor-core body needs 16-byte rows: Din and Dm multiples of 8 and
// the row-loaded pointers on 16-byte boundaries.
bool mma_eligible(const Params<__nv_bfloat16>& p) {
  const void* ptrs[3] = {p.patches, p.w, p.out};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return p.Din % 8 == 0 && p.Dm % 8 == 0;
}

template <typename T>
int embed(const void* patches, const long long* ids, const void* w,
          const void* bias, void* out, int B, int N, int Din, int K, int Dm,
          cudaStream_t stream) {
  if (B < 1 || N < 1 || Din < 1 || K < 1 || Dm < 1 ||
      (long long)B * K > 0x7fffffffLL || (Dm + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.patches = static_cast<const T*>(patches);
  p.ids = ids;
  p.w = static_cast<const T*>(w);
  p.bias = static_cast<const T*>(bias);
  p.out = static_cast<T*>(out);
  p.M = B * K;
  p.N = N;
  p.K = K;
  p.Din = Din;
  p.Dm = Dm;
  const dim3 grid((p.M + kTile - 1) / kTile, (Dm + kTile - 1) / kTile);
  if constexpr (sizeof(T) == 2) {
    if (mma_eligible(p)) {
      embed_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(p);
      return (int)cudaGetLastError();
    }
  }
  embed_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (patches, w, bias and out alike); ids
// int64. Every array contiguous. Returns a cudaError_t.
int masked_patch_embed_fwd(const void* patches, const long long* ids,
                           const void* w, const void* bias, void* out, int B,
                           int N, int Din, int K, int Dm, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return embed<float>(patches, ids, w, bias, out, B, N, Din, K, Dm, s);
  if (dtype == 1)
    return embed<__nv_bfloat16>(patches, ids, w, bias, out, B, N, Din, K, Dm,
                                s);
  return (int)cudaErrorInvalidValue;
}

const char* patch_embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
