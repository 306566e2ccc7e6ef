// Device code shared by the fused block-stack kernels (block_stack_fwd.cu,
// block_stack_bwd.cu): LayerNorm, GELU, the GEMM bodies with their fused
// epilogues, and the block's attention, which runs the attention kernels'
// own bodies (attention_fwd.cuh, attention_bwd.cuh) on the stack's packed
// q and kv rows, and the layout of the training state that the forward
// keeps for the backward (State, at the end). The masked patch embedding
// (patch_embed.cu) runs the tensor-core GEMM body with a gathered A.
// Included inside each source's unnamed namespace (through
// attention_common.cuh's), so each library keeps its own copy.
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
// Bodies. bf16 with widths that are multiples of 8 and 16-byte aligned bases
// takes gemm_wgmma_kernel (TMA loads into a swizzled shared-memory ring, a
// producer warpgroup, two consumer warpgroups on wgmma, a persistent grid;
// see its header below and gemm_wgmma_ok). Everything else (fp32, odd widths) takes
// gemm_scalar_kernel: 64 x 64 tiles, 256 threads of 4 x 4 outputs, fp32
// FMAs over 16-deep chunks.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda
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
  int k_chunk;      // K extent of one split, a multiple of kBK (64)
  int mode, gelu;
  const T* bias;    // (N)
  const T* res;     // (M, N)
  const T* aux;     // (M, N)
  T* out;           // (M, N)
  T* out2;          // (M, N)
  float* outf;      // (M, N), or (splits, M, N) partials
  // A gathered A (kernel #5, patch_embed.cu; the tensor-core body with
  // GATHER): row m of A is row (m / gather_k) * gather_n + gather_ids[m]
  // of the (rows, lda) matrix at a; an index outside [0, gather_n) gives a
  // row of NaN. Null for the block stacks.
  const long long* gather_ids;
  int gather_k, gather_n;
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

// ---- The tensor-core body: TMA loads, wgmma, a producer warpgroup ----
//
// gemm_wgmma_kernel<AKM, BKN, MODE> computes 128 x 128 output tiles with
// 384 threads: warpgroup 0 is the producer, and one of its threads keeps
// TMA loads in flight; warpgroups 1 and 2 are the consumers, each 64 rows
// of the tile. K goes in steps of 64 (one 128-byte swizzle row of bf16)
// through a ring of kStages stages of A (128 x 64) and B (128 x 64) in
// shared memory. Each stage has a full barrier (the producer's arrival and
// the TMA bytes) and an empty one (one arrival per consumer warpgroup once
// its wgmma on the stage has completed). TMA writes each tile with the
// 128-byte swizzle; wgmma.mma_async m64n128k16 (bf16 -> fp32) reads both
// operands from shared memory through descriptors: the K-major operands
// (A mk, B nk) as 8-row groups of 1024 bytes, the MN-major ones (A km,
// B kn) through the transpose bits, as 64-element atoms of 64 k rows (8 KB)
// and 8-row groups of 1024 bytes, so no layout is copied first. setmaxnreg
// moves registers from the producer to the consumers. The accumulator's
// fragment layout within each warp's 16 rows is mma.sync's C layout; the
// epilogue (epilogue_tile) goes through shared memory.
//
// The grid is persistent: one block an SM walks the tiles (n fastest, then
// m, then the split), and the producer loads the next tile's stages while
// the consumers run this one's epilogue; an epilogue's inputs (bias, res,
// aux, the fp32 sum added to) are issued by cp.async before the tile's
// products, and land while they run. Tiles of 128 x 256 were tried
// (PERF.md): no faster with the plain epilogues, slower with the
// GELU ones; so one width, and the persistent grid for the tail.
//
// Bound on an H100 SXM. A 128 x 128 x 64 stage is 2.1 MFLOP against 32 KB
// of loads (64 FLOP a byte from L2), and the tensor rate needs ~7.5
// TFLOP/s an SM. From HBM the stacks' products are near or under the ridge
// (295 FLOP a byte): at the encoder a D x D product moves ~20 MB for 3.8
// GFLOP (bytes-bound, 6 us), fc1 / fc2 ~50 MB for 15 GFLOP. So the design
// keeps loads in flight across tile boundaries (the persistent producer),
// reads each activation tile once per 128-row band of concurrently running
// blocks (n fastest), spends no registers or instructions on the copies,
// and moves each epilogue's outputs and inputs in 16-byte chunks through
// shared memory. What bounds it now is the epilogue: the consumers run it
// while no product runs, on 8 warps an SM (the GELU ones most of all). A
// second block an SM does not fit (384 threads x 2 leave 80 registers a
// thread, under what the products need); warpgroups that take turns
// (one's products during the other's epilogue) need their main loops
// ordered, since a warpgroup a whole ring ahead cannot tell the stage's
// phases apart by parity.
//
// Ragged M, N and K: TMA fills loads outside the tensor with zeros, the
// stores are masked per row and column, and a split's K range
// (p.k_chunk) is a multiple of 64, so no stage crosses into the next
// split's rows.
//
// With GATHER (kernel #5, patch_embed.cu) A's rows are picked by an index
// each, which TMA's boxes of consecutive rows cannot bring: the whole
// producer warpgroup copies them instead (produce_gathered below). Those
// copies, not the products, bound it, so its tiles are 128 x 192
// (kGatherBN, wgmma m64n192k16): each gathered row serves 192 output
// columns, not 128. The consumers, the ring and the epilogue are the same
// code at either width.

// Raises a kernel's dynamic shared-memory limit when it needs over 48 KB.
template <typename K>
int set_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr int kBM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 128;  // columns of a tile (GATHER: kGatherBN)
constexpr int kGatherBN = 192;
constexpr int kBK = 64;   // K per stage
constexpr int kGemmThreads = 384;
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;
constexpr int kStages = 4;       // 128 KB, beside the epilogue's 68 KB
constexpr int kAtom = 64 * 128;  // one MN-major TMA box: 64 k rows of 128 B
// Registers a thread: 168 at launch (384 threads, one block an SM); the
// producer warpgroup gives 128 a thread to the consumers (128 x 128 =
// 256 x 64).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Each consumer warpgroup's epilogue tiles: two of 64 rows of 128 bf16, or
// one of fp32 in the same bytes, each row padded by 8 elements, which keeps
// the fragments' writes free of bank conflicts.
constexpr int kEpiBytes = 2 * 64 * (128 + 8) * 2;
// The ring, its 2 barriers a stage (in 128 bytes), the two epilogue tiles,
// and 1 KB to align the ring to 1024.
constexpr size_t kGemmSmem =
    (size_t)kStages * kStageBytes + 128 + 2 * kEpiBytes + 1024;
// GATHER: the bias epilogue alone, so one tile of 64 x 192 bf16 a consumer
// warpgroup; the ring's stages of 40 KB keep the 1024-byte alignment.
constexpr int kGatherEpiBytes = 64 * (kGatherBN + 8) * 2;
constexpr size_t kGatherSmem = (size_t)kStages * (kBM + kGatherBN) * kBK * 2 +
                               128 + 2 * kGatherEpiBytes + 1024;

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- The epilogue, through shared memory ----
//
// The accumulators of a warpgroup lie in wgmma's fragments: a thread holds
// 2 columns of a row at a time, a warp 8 rows at once. Stored as they lie,
// a warp's store writes 8 pieces of 16 bytes (32 of fp32) 8 rows apart,
// and the epilogues were bound by the count of such stores, not by bytes
// (the same time for fp32 and bf16 outputs of one shape; twice the time
// for bias + GELU, which writes a1 and a2). So each consumer warpgroup puts
// its 64 x 128 slice of an output into a padded tile in shared memory and
// then writes the tile row by row in 16-byte chunks, 32 threads covering
// whole 128-byte lines; an input of the epilogue (res, aux, the fp32 sum
// added to) comes in the same way.

__device__ __forceinline__ void wg_sync(int c) {  // consumer warpgroup c
  asm volatile("bar.sync %0, 128;\n" ::"r"(c + 1) : "memory");
}

// Bytes a row of a tile of U, BN columns wide (128, or kGatherBN).
template <typename U, int BN = kBN>
__host__ __device__ constexpr int tile_stride() {
  return (BN + 8) * (int)sizeof(U);
}

// The (64 x BN) tile at rows m0.., columns n0.. of the (M, N) matrix g,
// from the shared tile t to global memory (LOAD: the other way, by
// cp.async, which the caller waits for), in 16-byte chunks; rows and
// columns outside the matrix are skipped (N is a multiple of 8).
template <typename U, bool LOAD, int BN = kBN>
__device__ __forceinline__ void tile_copy(U* g, uint8_t* t, int m0, int n0,
                                          int M, int N, int tid) {
  constexpr int kChunks = BN * (int)sizeof(U) / 16;  // chunks a row
  constexpr int kPer = 16 / (int)sizeof(U);          // elements a chunk
#pragma unroll
  for (int k = 0; k < 64 * kChunks / 128; ++k) {
    const int ch = tid + 128 * k, r = ch / kChunks, cc = ch % kChunks;
    const int m = m0 + r, n = n0 + cc * kPer;
    uint8_t* s = t + r * tile_stride<U, BN>() + cc * 16;
    if (LOAD) {
      cp_async16(s, m < M && n < N ? g + (long long)m * N + n : g,
                 m < M && n < N);
    } else if (m < M && n < N) {
      *reinterpret_cast<uint4*>(g + (long long)m * N + n) =
          *reinterpret_cast<const uint4*>(s);
    }
  }
}

// The fragment's pair (columns 8 j + 2 q, +1 of local row r) in a tile.
template <typename U, int BN = kBN>
__device__ __forceinline__ uint8_t* at(uint8_t* t, int r, int j, int q) {
  return t + r * tile_stride<U, BN>() + (8 * j + 2 * q) * (int)sizeof(U);
}
template <int BN = kBN>
__device__ __forceinline__ void put_bf16(uint8_t* t, int r, int j, int q,
                                         float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(at<__nv_bfloat16, BN>(t, r, j, q)) =
      __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 get_bf16(uint8_t* t, int r, int j, int q) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(at<__nv_bfloat16>(t, r, j, q)));
}
__device__ __forceinline__ void put_f32(uint8_t* t, int r, int j, int q,
                                        float v0, float v1) {
  *reinterpret_cast<float2*>(at<float>(t, r, j, q)) = make_float2(v0, v1);
}
__device__ __forceinline__ float2 get_f32(uint8_t* t, int r, int j, int q) {
  return *reinterpret_cast<const float2*>(at<float>(t, r, j, q));
}

// What the epilogue of consumer warpgroup c reads for its rows m0 ..
// m0 + 63, columns n0 .. n0 + BN - 1, issued before the tile's products so
// that it lands while they run: res or aux into the second bf16 tile, the
// fp32 sum fp32 add adds to into the tile, by cp.async; and the bias pairs
// of the thread's columns into b. The previous tile's epilogue must be
// done with the tiles (wg_sync first). Tiles other than 128 wide take the
// bias epilogue alone.
template <int MODE, int BN = kBN>
__device__ __forceinline__ void epilogue_inputs(const Gemm<__nv_bfloat16>& p,
                                                float2 (&b)[BN / 8],
                                                uint8_t* t, int m0, int n0,
                                                int tid) {
  static_assert(BN == kBN || MODE == kEpiBias, "one epilogue tile");
  typedef __nv_bfloat16 T;
  if (MODE == kEpiBiasRes || MODE == kEpiGeluGrad) {
    tile_copy<T, true>(const_cast<T*>(MODE == kEpiBiasRes ? p.res : p.aux),
                       t + 64 * tile_stride<T>(), m0, n0, p.M, p.N, tid);
  } else if (MODE == kEpiF32Add) {
    tile_copy<float, true>(p.outf, t, m0, n0, p.M, p.N, tid);
  }
  cp_async_commit();
  if (MODE == kEpiBias || MODE == kEpiBiasRes || MODE == kEpiBiasGelu) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (tid % 4);
      b[j] = n < p.N ? ld2(p.bias + n) : make_float2(0.f, 0.f);
    }
  }
}

// The epilogue of consumer warpgroup c (rows m0 .. m0 + 63, columns
// n0 .. n0 + BN - 1 of split z) with the mode fixed at compile time, from
// its accumulators acc[4 j + 2 r + e] (local row 16 warp + g + 8 r, column
// 8 j + 2 q + e) and epilogue_inputs' b and tiles: the same arithmetic as
// epilogue(). (With the mode picked per element at run time, as the scalar
// body does, the block stacks ran about twice as long on the card.) t is
// the warpgroup's epilogue tile.
template <int MODE, int BN = kBN>
__device__ __forceinline__ void epilogue_tile(const Gemm<__nv_bfloat16>& p,
                                              float (&acc)[BN / 2],
                                              const float2 (&b)[BN / 8],
                                              uint8_t* t, int m0, int n0,
                                              int z, int c, int tid) {
  static_assert(BN == kBN || MODE == kEpiBias, "one epilogue tile");
  typedef __nv_bfloat16 T;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const int M = p.M, N = p.N;
  uint8_t* const t2 = t + 64 * tile_stride<T>();  // a second bf16 tile
  cp_async_wait<0>();  // this thread's input chunks
  wg_sync(c);          // everyone's
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = 16 * warp + g + 8 * r2;
      const float v0 = acc[4 * j + 2 * r2], v1 = acc[4 * j + 2 * r2 + 1];
      if (MODE == kEpiBias) {
        put_bf16<BN>(t, r, j, q, v0 + b[j].x, v1 + b[j].y);
      } else if (MODE == kEpiBiasRes) {
        const float2 x = get_bf16(t2, r, j, q);
        put_bf16(t, r, j, q, x.x + rnd<T>(v0 + b[j].x),
                 x.y + rnd<T>(v1 + b[j].y));
      } else if (MODE == kEpiBiasGelu) {
        const float a0 = rnd<T>(v0 + b[j].x), a1 = rnd<T>(v1 + b[j].y);
        put_bf16(t, r, j, q, a0, a1);
        put_bf16(t2, r, j, q, gelu_fwd(a0, p.gelu), gelu_fwd(a1, p.gelu));
      } else if (MODE == kEpiGeluGrad) {  // written below: t overlaps t2
        const float2 x = get_bf16(t2, r, j, q);
        acc[4 * j + 2 * r2] = v0 * gelu_grad(x.x, p.gelu);
        acc[4 * j + 2 * r2 + 1] = v1 * gelu_grad(x.y, p.gelu);
      } else if (MODE == kEpiF32Add) {
        const float2 x = get_f32(t, r, j, q);
        put_f32(t, r, j, q, x.x + v0, x.y + v1);
      } else if (MODE == kEpiRound) {
        put_bf16(t, r, j, q, v0, v1);
      } else {  // kEpiF32, kEpiPartial
        put_f32(t, r, j, q, v0, v1);
      }
    }
  wg_sync(c);
  if (MODE == kEpiGeluGrad) {  // the fp32 gradient, then its rounded copy
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        put_f32(t, 16 * warp + g + 8 * r2, j, q, acc[4 * j + 2 * r2],
                acc[4 * j + 2 * r2 + 1]);
    wg_sync(c);
  }
  if (MODE == kEpiBias || MODE == kEpiBiasRes || MODE == kEpiRound) {
    tile_copy<T, false, BN>(p.out, t, m0, n0, M, N, tid);
  } else if (MODE == kEpiBiasGelu) {
    if (p.out) tile_copy<T, false>(p.out, t, m0, n0, M, N, tid);
    tile_copy<T, false>(p.out2, t2, m0, n0, M, N, tid);
  } else if (MODE == kEpiPartial) {
    tile_copy<float, false>(p.outf + (long long)z * M * N, t, m0, n0, M, N,
                            tid);
  } else {  // kEpiGeluGrad, kEpiF32, kEpiF32Add
    tile_copy<float, false>(p.outf, t, m0, n0, M, N, tid);
  }
  if (MODE == kEpiGeluGrad) {
    wg_sync(c);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        put_bf16(t, 16 * warp + g + 8 * r2, j, q, acc[4 * j + 2 * r2],
                 acc[4 * j + 2 * r2 + 1]);
    wg_sync(c);
    tile_copy<T, false>(p.out, t, m0, n0, M, N, tid);
  }
}

// ---- PTX: barriers in shared memory, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// The producer's arrival, and the bytes the stage's loads will bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// One box of a 2-D tensor map into shared memory at dst; c0 is the inner
// (contiguous) coordinate. Completion counts its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's writes to shared memory through the generic proxy
// (stores, cp.async) before later accesses through the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 16 bytes global -> shared at a shared-window address (zeros where valid
// is false).
__device__ __forceinline__ void cp_async16_at(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 16 bytes of bf16 NaN at a shared-window address.
__device__ __forceinline__ void st_nan16(uint32_t dst) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
               "r"(0x7FC07FC0u)
               : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: the start
// address, the leading and the stride byte offsets (16-byte units). K-major
// operands: stride = the next 8 rows (1024 B), leading unused (1). MN-major:
// leading = the next 64 elements of M or N (the next TMA box), stride = the
// next 8 k rows (1024 B).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lead >> 4) << 16 |
         (uint64_t)(stride >> 4) << 32 | 1ull << 62;
}

// The accumulator operands of a wgmma: its register list for 64 and 96
// fp32 per thread (N = 128 and 192), and their "+f" constraints, 8 at a
// time.
#define WGMMA_REGS64                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define WGMMA_REGS96                                                        \
  WGMMA_REGS64                                                              \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95"
#define WGMMA_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_ACC64                                                     \
  WGMMA_ACC8(0), WGMMA_ACC8(8), WGMMA_ACC8(16), WGMMA_ACC8(24),         \
      WGMMA_ACC8(32), WGMMA_ACC8(40), WGMMA_ACC8(48), WGMMA_ACC8(56)
#define WGMMA_ACC96 \
  WGMMA_ACC64, WGMMA_ACC8(64), WGMMA_ACC8(72), WGMMA_ACC8(80), WGMMA_ACC8(88)

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), both bf16 in shared
// memory; TA / TB: A / B MN-major (their transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_REGS64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WGMMA_ACC64
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 192, fp32) += A (64 x 16) B (16 x 192), both bf16 and K-major in
// shared memory (the gathered body's product).
__device__ __forceinline__ void wgmma192(float (&d)[96], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WGMMA_REGS96
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_ACC96
      : "l"(da), "l"(db), "r"(1));
}

// Tile t of the persistent walk: (n tile, m tile, split), n fastest, and the
// split's number of K steps.
struct TileAt {
  int m0, n0, z, kbeg, nk;
};
template <int BN = kBN>
__device__ __forceinline__ TileAt tile_at(const Gemm<__nv_bfloat16>& p,
                                          int t, int tiles_m, int tiles_n) {
  TileAt a;
  a.n0 = (t % tiles_n) * BN;
  t /= tiles_n;
  a.m0 = (t % tiles_m) * kBM;
  a.z = t / tiles_m;
  a.kbeg = a.z * p.k_chunk;
  const int kend = min(p.K, a.kbeg + p.k_chunk);
  a.nk = kend > a.kbeg ? (kend - a.kbeg + kBK - 1) / kBK : 0;
  return a;
}

// ---- The gathered A's producer (GATHER, kernel #5) ----
//
// All 128 threads of warpgroup 0 copy A's stage by cp.async, 16 bytes a
// copy: thread i moves chunk i % 8 of rows i / 8 + 16 j (j < 8), so 8
// threads cover a 128-byte row and a warp's copy 4 whole rows. Each chunk
// goes where TMA's 128-byte swizzle would have put it (chunk c of row r at
// 16 (c ^ r % 8) bytes into the row; every stage is 1024-aligned), so the
// consumers read it through the same descriptors. Thread 0 still brings
// B's box by TMA. Each thread reads the indices of its 8 rows once a tile
// and keeps their addresses in registers (the producer's copies bound the
// kernel: reading the offsets from shared memory at every stage cost 8 %).
// A row with an index outside [0, gather_n), or past M, is written as NaN
// by plain stores, so its output row is NaN (and never stored past M).
//
// The full barrier counts thread 0's expect_tx for B and, from every
// thread, a plain arrival (which releases its NaN stores) and a cp.async
// arrival, which stays pending until the thread's copies of the stage have
// landed. cp.async and the stores write through the generic proxy and
// wgmma reads through the async proxy, so each consumer thread, once the
// stage is full, orders those writes before its wgmma with a proxy fence.
// The pointers are 64-bit, so the gathered matrix may have any size.
template <int BN>
__device__ __forceinline__ void produce_gathered(
    const Gemm<__nv_bfloat16>& p, const CUtensorMap* tma_b, uint32_t ring,
    uint32_t bars, int tiles_m, int tiles_n, int tiles) {
  constexpr uint32_t kABytes = kBM * kBK * 2, kBBytes = BN * kBK * 2;
  constexpr uint32_t kStage = kABytes + kBBytes;
  const int tid = threadIdx.x, chunk = tid % 8;
  // This thread's chunks: rows tid / 8 + 16 j, all with the same r % 8.
  const uint32_t at0 = (tid / 8) * 128 + ((chunk ^ (tid / 8) % 8) << 4);
  const uint4* const a16 = reinterpret_cast<const uint4*>(p.a);
  int it = 0;  // K steps issued so far, over every tile
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt a = tile_at<BN>(p, t, tiles_m, tiles_n);
    const uint4* src[8];  // this thread's chunks at k = 0, or null
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = a.m0 + tid / 8 + 16 * j;
      src[j] = nullptr;
      if (m < p.M) {
        const long long id = p.gather_ids[m];
        if (id >= 0 && id < p.gather_n)
          src[j] = a16 + ((long long)(m / p.gather_k) * p.gather_n + id) *
                             (p.lda / 8) + chunk;
      }
    }
    for (int kt = 0; kt < a.nk; ++kt, ++it) {
      const int s = it % kStages;
      const uint32_t full = bars + 8 * s, sa = ring + s * kStage;
      mbar_wait(bars + 8 * (kStages + s), ((it / kStages) & 1) ^ 1);
      const int k0 = a.kbeg + kt * kBK;
      const bool in = k0 + 8 * chunk < p.K;  // else zeros
      const int k16 = in ? k0 >> 3 : 0;  // in 16-byte chunks
      if (tid == 0) {
        mbar_expect_tx(full, kBBytes);
        tma_load(sa + kABytes, tma_b, full, k0, a.n0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t dst = sa + at0 + j * 16 * 128;
        if (src[j] == nullptr)
          st_nan16(dst);
        else
          cp_async16_at(dst, src[j] + k16, in);
      }
      asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                       full)
                   : "memory");
      mbar_arrive(full);
    }
  }
}

template <bool AKM, bool BKN, int MODE, bool GATHER = false>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      Gemm<__nv_bfloat16> p, int tiles_m, int tiles_n,
                      int tiles) {
  static_assert(!GATHER || (!AKM && !BKN && MODE == kEpiBias),
                "the gathered body: rows (mk) by W (nk), with the bias");
  constexpr int BN = GATHER ? kGatherBN : kBN;  // columns of a tile
  constexpr uint32_t kABytes = kBM * kBK * 2;
  constexpr uint32_t kStage = kABytes + BN * kBK * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + kStages * kStage;
  uint8_t* const epi = smem_raw + (bars + 128 - smem_u32(smem_raw));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's expect_tx; GATHER: also each producer thread's
      // arrival (produce_gathered).
      mbar_init(full(s), GATHER ? 1 + 128 : 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if constexpr (GATHER) {
      produce_gathered<BN>(p, &tma_b, ring, bars, tiles_m, tiles_n, tiles);
      return;
    }
    if (threadIdx.x != 0) return;
    int it = 0;  // K steps issued so far, over every tile
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileAt a = tile_at(p, t, tiles_m, tiles_n);
      for (int kt = 0; kt < a.nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStage);
        const uint32_t sa = ring + s * kStage, sb = sa + kABytes;
        const int k0 = a.kbeg + kt * kBK;
        if (AKM) {  // two boxes of (64 k, 64 m)
          tma_load(sa, &tma_a, full(s), a.m0, k0);
          tma_load(sa + kAtom, &tma_a, full(s), a.m0 + 64, k0);
        } else {  // one box of (128 m, 64 k)
          tma_load(sa, &tma_a, full(s), k0, a.m0);
        }
        if (BKN) {  // two boxes of (64 k, 64 n)
          tma_load(sb, &tma_b, full(s), a.n0, k0);
          tma_load(sb + kAtom, &tma_b, full(s), a.n0 + 64, k0);
        } else {  // one box of (128 n, 64 k)
          tma_load(sb, &tma_b, full(s), k0, a.n0);
        }
      }
    }
  } else {  // the consumer warpgroups: rows 64 c .. 64 c + 63 of each tile
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    float acc[BN / 2];
    int it = 0;  // K steps consumed so far, over every tile
    uint8_t* const tile = epi + c * (GATHER ? kGatherEpiBytes : kEpiBytes);
    float2 bias[BN / 8];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileAt a = tile_at<BN>(p, t, tiles_m, tiles_n);
      wg_sync(c);  // the previous tile's epilogue is done with the tiles
      epilogue_inputs<MODE, BN>(p, bias, tile, a.m0 + 64 * c, a.n0, tid);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < a.nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(full(s), (it / kStages) & 1);
        // The gathered rows were written through the generic proxy.
        if constexpr (GATHER) fence_proxy_async();
        const uint32_t sa = ring + s * kStage, sb = sa + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da =
              AKM ? wgmma_desc(sa + c * kAtom + kk * 2048, kAtom, 1024)
                  : wgmma_desc(sa + c * kAtom + kk * 32, 16, 1024);
          const uint64_t db = BKN ? wgmma_desc(sb + kk * 2048, kAtom, 1024)
                                  : wgmma_desc(sb + kk * 32, 16, 1024);
          if constexpr (BN == kBN)
            wgmma128<AKM, BKN>(acc, da, db);
          else
            wgmma192(acc, da, db);
        }
        wgmma_commit();
        fence_acc(acc);
        // The previous step's products are done: release its stage.
        wgmma_wait<1>();
        if (kt > 0 && tid == 0) mbar_arrive(empty((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (a.nk > 0 && tid == 0) mbar_arrive(empty((it - 1) % kStages));
      epilogue_tile<MODE, BN>(p, acc, bias, tile, a.m0 + 64 * c, a.n0, a.z,
                              c, tid);
    }
  }
}

// ---- Host side: tensor maps, launch ----

// cuTensorMapEncodeTiled, taken from the CUDA driver through the runtime
// (the libraries link the runtime alone, not libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 matrix of `outer` rows of `inner` elements, rows ld elements apart,
// read in boxes of box_outer rows of box_inner elements with the 128-byte
// swizzle; loads outside the matrix are zeros. The encoder is a CUDA driver
// call and needs the thread's current context, which only a runtime call
// makes current on a thread new to this library (autograd's backward
// thread).
inline int encode_map(CUtensorMap* map, const __nv_bfloat16* base,
                      long long inner, long long outer, long long ld,
                      int box_inner, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<__nv_bfloat16*>(base), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

inline bool aligned_to(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The tensor-core body takes bf16 with operand widths (the contiguous dims)
// and N that are multiples of 8, and 16-byte aligned bases: the operands'
// (TMA), and those of the outputs and of res, aux and the fp32 sum (the
// epilogue moves them in 16-byte chunks; the bias in pairs).
inline bool gemm_wgmma_ok(const Gemm<float>&) { return false; }
inline bool gemm_wgmma_ok(const Gemm<__nv_bfloat16>& p) {
  const bool a_ok = p.a_km ? p.M % 8 == 0 : p.K % 8 == 0;
  const bool b_ok = p.b_kn ? p.N % 8 == 0 : p.K % 8 == 0;
  return a_ok && b_ok && p.N % 8 == 0 && p.lda % 8 == 0 && p.ldb % 8 == 0 &&
         p.k_chunk % kBK == 0 && aligned_to(p.a, 16) && aligned_to(p.b, 16) &&
         aligned_to(p.out, 16) && aligned_to(p.out2, 16) &&
         aligned_to(p.outf, 16) && aligned_to(p.res, 16) &&
         aligned_to(p.aux, 16) && aligned_to(p.bias, 4);
}

template <bool AKM, bool BKN, int MODE, bool GATHER = false>
int launch_wgmma_as(const Gemm<__nv_bfloat16>& p, int splits,
                    cudaStream_t st) {
  constexpr size_t smem = GATHER ? kGatherSmem : kGemmSmem;
  constexpr int BN = GATHER ? kGatherBN : kBN;
  // A runtime call first: it makes the context current for the encoder.
  int err = set_smem(gemm_wgmma_kernel<AKM, BKN, MODE, GATHER>, smem);
  if (err) return err;
  CUtensorMap ta = {}, tb;  // GATHER: A takes no tensor map
  if (!GATHER) {
    err = AKM ? encode_map(&ta, p.a, p.M, p.K, p.lda, 64, kBK)
              : encode_map(&ta, p.a, p.K, p.M, p.lda, kBK, kBM);
    if (err) return err;
  }
  err = BKN ? encode_map(&tb, p.b, p.N, p.K, p.ldb, 64, kBK)
            : encode_map(&tb, p.b, p.K, p.N, p.ldb, kBK, BN);
  if (err) return err;
  const int tiles_m = cdiv(p.M, kBM), tiles_n = cdiv(p.N, BN);
  const long long tiles = (long long)tiles_m * tiles_n * splits;
  gemm_wgmma_kernel<AKM, BKN, MODE, GATHER>
      <<<(int)(tiles < num_sms() ? tiles : num_sms()), kGemmThreads, smem,
         st>>>(ta, tb, p, tiles_m, tiles_n, (int)tiles);
  return (int)cudaGetLastError();
}

// Each library defines launch_wgmma for the (layout, epilogue) pairs it
// launches, and instantiates no other: block_stack_fwd.cu the forward
// products (mk, nk) with the bias epilogues, block_stack_bwd.cu the input
// gradients (mk, kn) and the weight gradients' partials (km, kn),
// patch_embed.cu the gathered rows (mk, GATHER) by W (nk) with the bias.
// Another pair is an error, not a slower body.
int launch_wgmma(const Gemm<__nv_bfloat16>& p, int splits, cudaStream_t st);
inline int launch_wgmma(const Gemm<float>&, int, cudaStream_t) {
  return (int)cudaErrorInvalidValue;
}

// Runs p over `splits` K ranges (p.k_chunk is set here).
template <typename T>
int gemm(Gemm<T> p, int splits, cudaStream_t st) {
  p.k_chunk = ((cdiv(p.K, splits) + kBK - 1) / kBK) * kBK;
  if (gemm_wgmma_ok(p)) return launch_wgmma(p, splits, st);
  gemm_scalar_kernel<T><<<dim3(cdiv(p.N, kScTile), cdiv(p.M, kScTile),
                               splits),
                          256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The tensor-core body alone, for the check of each template on the card
// (each library's C entry *_gemm): one product of bf16 operands stored dense
// in the given layouts (A (M, K), or (K, M) with a_km; B (N, K), or (K, N)
// with b_kn), epilogue `mode` into the given outputs, over `splits` K
// ranges. A product that the tensor-core body does not take is an error
// here, not a run of the scalar body.
inline int gemm_body_entry(const void* a, const void* b, const void* bias,
                           const void* res, const void* aux, void* out,
                           void* out2, float* outf, int M, int N, int K,
                           int a_km, int b_kn, int mode, int gelu,
                           int splits, void* stream) {
  typedef __nv_bfloat16 T;
  Gemm<T> p = {};
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.lda = a_km ? M : K;
  p.ldb = b_kn ? N : K;
  p.M = M;
  p.N = N;
  p.K = K;
  p.a_km = a_km != 0;
  p.b_kn = b_kn != 0;
  p.mode = mode;
  p.gelu = gelu;
  p.bias = static_cast<const T*>(bias);
  p.res = static_cast<const T*>(res);
  p.aux = static_cast<const T*>(aux);
  p.out = static_cast<T*>(out);
  p.out2 = static_cast<T*>(out2);
  p.outf = outf;
  if (M < 1 || N < 1 || K < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  p.k_chunk = ((cdiv(K, splits) + kBK - 1) / kBK) * kBK;
  if (!gemm_wgmma_ok(p)) return (int)cudaErrorInvalidValue;
  return gemm(p, splits, static_cast<cudaStream_t>(stream));
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
