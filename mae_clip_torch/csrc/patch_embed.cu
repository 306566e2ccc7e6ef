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
// dynamic row loads. Here the row indirection is folded into the loads of
// one GEMM over the M = B*K gathered rows, N = Dm, K = Din.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the MAE-pretrain
// step's shape (B=256, N=196, Din=768, K=49, Dm=384, bf16): the rows read
// (19.3 MB), W (0.6 MB), ids (0.1 MB) and the output (9.6 MB) make 29.6 MB,
// 8.8 us; 7.4 GFLOP is 7.5 us of tensor-core time. Bound by bytes, barely:
// so the products must run on wgmma at near the card's rate while the rows
// stream in, and each gathered row should come from HBM once.
//
// Design, bf16 with Din and Dm multiples of 8 and 16-byte aligned patches,
// W and out (the pretrain step): the block stacks' tensor-core GEMM body
// (gemm_wgmma_kernel in block_common.cuh, with GATHER): a persistent grid,
// a 4-stage ring of 64-deep stages of A and B in shared memory with the
// 128-byte swizzle, two consumer warpgroups on wgmma, the bias epilogue
// through shared memory. W comes by TMA as the stacks' weights do. The
// gathered rows cannot (a TMA box is consecutive rows; one box a row was
// 5x slower), so the producer warpgroup's 128 threads copy them by
// cp.async, 16 bytes a copy, each chunk where the swizzle puts it, and the
// consumers fence the proxies before their wgmma (produce_gathered). Each
// thread reads its rows' indices once a tile. Those copies, not the
// products, bound the kernel, so its tiles are 128 x 192 (m64n192k16):
// each gathered row is copied once for 192 output columns. Tiles run n
// fastest: the two tiles of an M band (Dm = 384 = 2 x 192) run at once on
// neighbouring blocks, so each gathered row comes from HBM once and once
// more from L2. At the pretrain shape M = 12544 = 98 x 128 makes 196
// tiles on 132 SMs: 1.48 waves, 64 blocks taking a second tile (with 128 x
// 128 tiles, 294 tiles, 2.23 waves, 30 blocks taking a third).
//
// Every other case (fp32, unaligned widths or pointers): embed_kernel, 256
// threads with scalar fp32 FMAs over 16-deep chunks, each thread 4 rows x
// 4 columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_common.cuh"

namespace {

constexpr int kTile = 64;    // output rows and columns per block
constexpr int kStep = 16;    // Din chunk
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

// This library's pair of the tensor-core body: the gathered rows (mk) by W
// (nk), with the bias epilogue.
int launch_wgmma(const Gemm<__nv_bfloat16>& p, int splits, cudaStream_t st) {
  if (p.gather_ids != nullptr && !p.a_km && !p.b_kn && p.mode == kEpiBias)
    return launch_wgmma_as<false, false, kEpiBias, true>(p, splits, st);
  return (int)cudaErrorInvalidValue;
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
  if constexpr (sizeof(T) == 2) {
    // The tensor-core body takes what gemm_wgmma_ok takes (Din and Dm
    // multiples of 8, and 16-byte aligned patches, W and out).
    Gemm<T> g = fwd_gemm(p.patches, p.w, p.M, Dm, Din, kEpiBias);
    g.k_chunk = cdiv(Din, kBK) * kBK;
    g.bias = p.bias;
    g.out = p.out;
    g.gather_ids = ids;
    g.gather_k = K;
    g.gather_n = N;
    if (gemm_wgmma_ok(g))
      return launch_wgmma(g, 1, stream);
  }
  const dim3 grid((p.M + kTile - 1) / kTile, (Dm + kTile - 1) / kTile);
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
