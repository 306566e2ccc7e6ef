// Fused transformer block stack, backward, for Hopper (sm_90a), with a plain
// C interface (bound from Python through ctypes, see
// mae_clip_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel of the JAX package
//
//   * block_stack_bwd <- mae_clip_tpu/ops/block_kernel.py _stack_bwd_kernel
//                        (pallas_call in _stack_backward).
//
// For the output gradient dout of a stack run by block_stack_fwd.cu with a
// state buffer, it walks the blocks in reverse from their saved inputs
// (qstack) and the forward's state (State in block_common.cuh: each block's
// activations, the attention's row log-sum-exp, the LayerNorms' row mean and
// rstd), and backpropagates the MLP half and the attention half, with the
// math and roundings of the TPU kernel (and of the plain version,
// fused_block_stack_bwd_ref in ops/block_kernel.py):
//   da1 = (dq . Wfc2) * gelu'(a1);       dh2 = round(da1) . Wfc1
//   dx1 = dq + LNbwd(dh2);               dctx = round(round(dx1) . Wproj)
//   attention: dV = round(P)^T dctx, dP = dctx V^T, delta = rowsum(P dP)
//     (taken as rowsum(dctx ctx), equal in exact arithmetic),
//     dS = round(P (dP - delta)), dq = dS K * scale, dk = dS^T Q * scale
//   dh = round(dqp) . Wq (+ round(dkvp) . Wkv in self mode)
//   dx = dx1 + LNbwd(dh) -> the previous block's dq, rounded to dout's type
//   cross: dkv += LNkvbwd(round(dkvp) . Wkv), rounded after each block
// with fp32 sums, and the weight gradients summed in fp32 over every row of
// the batch and then rounded to the weights' type: dW = round(dY)^T X, the
// biases and LayerNorm parameters as column sums. In self mode the lnkv
// gradients are zero and dkv is not written.
//
// Design. The TPU kernel re-runs each block's forward from its input, since
// only qstack outlives the forward there (a block's activations live in
// VMEM). This card's HBM holds them (1.77 GB for the flagship encoder's 12
// blocks at B=256, 1.08 GB for the decoder's 4), so the forward keeps them
// when a gradient is wanted and this kernel launches no forward work: per
// block, in reverse, the GEMMs of the input gradients (the forward's wgmma
// body, with the weight read MN-major through wgmma's transpose bit), the
// attention backward of kernel #3 (attention_bwd.cuh's LSE bodies, from the
// saved row log-sum-exp and ctx: one kernel at Sk <= 64, else one block per
// (sample*head, 64-query tile) for dq and one per (sample*head, 64-key tile)
// for dk and dv; no atomics) on the saved qp/kvp rows, which also stores
// dqp and dkvp in fp32 for the bias gradients, a LayerNorm backward from
// the saved row mean and rstd that also writes per-64-row column partials
// of dy*xhat and dy, and the weight-gradient GEMMs dY^T X split over the
// rows into fixed chunks whose fp32 partials a second kernel sums in order:
// a deterministic result with no atomics. dq is carried in two alternating
// buffers; dkv accumulates in place. The saved values are the bits the
// recompute gave (the same kernels on the same inputs), so the gradients
// are too.
//
// Bound on an H100 SXM (989 TFLOP/s bf16): twice the forward's products
// (input and weight gradients), 2x #6: ~1.1 ms for the flagship encoder
// stack and ~0.44 ms for the decoder's, bound by operations; reading the
// state adds ~0.53 / ~0.32 ms of bytes, under that (chip_smoke.py computes
// both from its inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "attention_bwd.cuh"
#include "block_common.cuh"

namespace {

#define CHECK(expr)           \
  do {                        \
    const int e_ = (expr);    \
    if (e_ != 0) return e_;   \
  } while (0)

constexpr int kRowsPer = 64;  // rows per column-partial chunk

// The tensor-core body's (layout, epilogue) pairs this library launches:
// the input gradients, dy (mk) . W (kn), with the backward epilogues, and
// the weight gradients' split partials, dy^T (km) . x (kn).
int launch_wgmma(const Gemm<__nv_bfloat16>& p, int splits,
                 cudaStream_t st) {
  if (p.a_km && p.b_kn && p.mode == kEpiPartial)
    return launch_wgmma_as<true, true, kEpiPartial>(p, splits, st);
  if (!p.a_km && p.b_kn) {
    switch (p.mode) {
      case kEpiGeluGrad:
        return launch_wgmma_as<false, true, kEpiGeluGrad>(p, splits, st);
      case kEpiF32:
        return launch_wgmma_as<false, true, kEpiF32>(p, splits, st);
      case kEpiF32Add:
        return launch_wgmma_as<false, true, kEpiF32Add>(p, splits, st);
      case kEpiRound:
        return launch_wgmma_as<false, true, kEpiRound>(p, splits, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Reductions
// ---------------------------------------------------------------------------

// What a reduce_rows_kernel instance sums; it only names the instance, so
// that a profile tells the two apart.
enum SumOf { kSumWeights, kSumColumns };

// dst[i] = sum over r in order of part[r * stride + i], rounded to T.
template <typename T, int WHAT>
__global__ void __launch_bounds__(256)
    reduce_rows_kernel(const float* part, int R, long long N,
                       long long stride, T* dst) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= N) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[r * stride + i];
  store(dst + i, s);
}

template <int WHAT, typename T>
int reduce_rows(const float* part, int R, long long N, long long stride,
                T* dst, cudaStream_t st) {
  reduce_rows_kernel<T, WHAT><<<cdiv(N, 256), 256, 0, st>>>(part, R, N,
                                                             stride, dst);
  return (int)cudaGetLastError();
}

// part[r][n] = sum of x[m][n] over the rows m of chunk r, in order.
template <typename Tin>
__global__ void __launch_bounds__(256)
    colsum_kernel(const Tin* x, int M, int N, float* part) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * kRowsPer, m1 = min(M, m0 + kRowsPer);
  float s = 0.f;
  for (int m = m0; m < m1; ++m) s += to_float(x[(long long)m * N + n]);
  part[(long long)blockIdx.y * N + n] = s;
}

// dst (N) = the column sums of x (M, N) in fp32, rounded to T.
template <typename Tin, typename T>
int bias_grad(const Tin* x, int M, int N, float* part, T* dst,
              cudaStream_t st) {
  const int R = cdiv(M, kRowsPer);
  colsum_kernel<Tin><<<dim3(cdiv(N, 256), R), 256, 0, st>>>(x, M, N, part);
  CHECK((int)cudaGetLastError());
  return reduce_rows<kSumColumns>(part, R, N, N, dst, st);
}

// Row splits of a weight-gradient GEMM: enough (out x in) tiles of kBM x
// kBN times splits for two rounds of the persistent grid's 132 blocks, at
// least 256 rows a split. The partials' workspace (max_wpart) is sized by
// the same function.
long long dw_splits(long long out, long long in, long long rows) {
  const long long tiles = (long long)cdiv(out, kBM) * cdiv(in, kBN);
  const long long z = std::min((long long)cdiv(2 * 132, tiles),
                               std::max(1LL, rows / 256));
  return std::max(1LL, std::min(z, 64LL));
}

// dst (out, in) = round(sum over rows of dy[row][o] x[row][i]), fp32 sums.
template <typename T>
int weight_grad(const T* dy, const T* x, int out, int in, int rows,
                float* part, T* dst, cudaStream_t st) {
  Gemm<T> p = {};
  p.a = dy;
  p.lda = out;
  p.a_km = true;
  p.b = x;
  p.ldb = in;
  p.b_kn = true;
  p.M = out;
  p.N = in;
  p.K = rows;
  p.mode = kEpiPartial;
  p.outf = part;
  const int z = (int)dw_splits(out, in, rows);
  CHECK(gemm(p, z, st));
  const long long n = (long long)out * in;
  return reduce_rows<kSumWeights>(part, z, n, n, dst, st);
}

// y (M, N) = epilogue(dy (M, K) . W), W (K, N): the input gradient through
// a (out = K, in = N) weight.
template <typename T>
Gemm<T> bwd_gemm(const T* dy, const T* w, int M, int N, int K, int mode) {
  Gemm<T> p = {};
  p.a = dy;
  p.lda = K;
  p.b = w;
  p.ldb = N;
  p.b_kn = true;
  p.M = M;
  p.N = N;
  p.K = K;
  p.mode = mode;
  return p;
}

// ---------------------------------------------------------------------------
// LayerNorm backward
// ---------------------------------------------------------------------------

template <typename T>
struct LnBwd {
  const T* x;         // the LN input (M, D)
  const float* mean;  // its row mean and rstd from the forward (M)
  const float* rstd;
  const float* dy;    // (M, D)
  const T* g;         // (D)
  const float* res_f; // added to dx, or null
  const T* res_t;     // added to dx, or null
  float* out_f;       // dx, or null
  T* out_t;           // dx rounded to T (accum: out_t + dx), or null
  int accum;
  float* part;        // (cdiv(M, 64), 2D): sum dy*xhat, then sum dy
  int M, D;
};

// One warp per row; each block of 8 warps takes 64 rows and writes their
// column sums (each warp's in shared memory, summed in warp order).
template <typename T>
__global__ void __launch_bounds__(256) ln_bwd_kernel(LnBwd<T> p) {
  extern __shared__ float colacc[];  // (8, 2D)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = p.D;
  float* acc = colacc + warp * 2 * D;
  for (int c = lane; c < 2 * D; c += 32) acc[c] = 0.f;
  const int r1 = min(p.M, (int)blockIdx.x * kRowsPer + kRowsPer);
  for (int row = blockIdx.x * kRowsPer + warp; row < r1; row += 8) {
    const long long o = (long long)row * D;
    const T* xr = p.x + o;
    const float* dyr = p.dy + o;
    const float mu = p.mean[row], rstd = p.rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dyg = dyr[c] * to_float(p.g[c]);
      s1 += dyg;
      s2 += dyg * ((to_float(xr[c]) - mu) * rstd);
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32) {
      const float xhat = (to_float(xr[c]) - mu) * rstd;
      const float dyv = dyr[c];
      float dx = rstd * (dyv * to_float(p.g[c]) - m1 - xhat * m2);
      if (p.res_f) dx = p.res_f[o + c] + dx;
      if (p.res_t) dx = to_float(p.res_t[o + c]) + dx;
      if (p.out_f) p.out_f[o + c] = dx;
      if (p.out_t)
        store(p.out_t + o + c,
              p.accum ? to_float(p.out_t[o + c]) + dx : dx);
      acc[c] += dyv * xhat;
      acc[D + c] += dyv;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += 256) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += colacc[w * 2 * D + c];
    p.part[(long long)blockIdx.x * 2 * D + c] = s;
  }
}

// Runs the LN backward and rounds the gamma and beta gradients into dg, db.
template <typename T>
int ln_bwd(LnBwd<T> p, float* part, T* dg, T* db, cudaStream_t st) {
  p.part = part;
  const int R = cdiv(p.M, kRowsPer);
  const size_t smem = 8 * 2 * (size_t)p.D * sizeof(float);
  CHECK(set_smem(ln_bwd_kernel<T>, smem));
  ln_bwd_kernel<T><<<R, 256, smem, st>>>(p);
  CHECK((int)cudaGetLastError());
  CHECK(reduce_rows<kSumColumns>(part, R, p.D, 2LL * p.D, dg, st));
  return reduce_rows<kSumColumns>(part + p.D, R, p.D, 2LL * p.D, db, st);
}

// ---------------------------------------------------------------------------
// The stack
// ---------------------------------------------------------------------------

template <typename T>
struct BwdBuffers {
  float* da1_f;
  T* da1_t;
  float *dh2_f, *dx1_f;
  T *dx1_t, *dctx_t;
  float* stats;  // (3, B*H*Sq): row max, row sum, delta
  float* dqp_f;
  T* dqp_t;
  float* dkvp_f;
  T* dkvp_t;
  float *dh_f, *dkvh_f;
  T* dq[2];           // the carried dq, alternating
  float* colpart;     // column partials
  float* wpart;       // weight-gradient partials
};

// The largest weight-gradient partials: splits * out * in floats.
long long max_wpart(const Shape& s) {
  const long long M = s.M(), Mk = s.Mk(), D = s.D, F = s.F;
  long long m = dw_splits(D, F, M) * D * F;
  m = std::max(m, dw_splits(F, D, M) * F * D);
  m = std::max(m, dw_splits(D, D, M) * D * D);
  return std::max(m, dw_splits(2 * D, D, Mk) * 2 * D * D);
}

template <typename T>
BwdBuffers<T> bwd_buffers(Arena& ar, const Shape& s) {
  const long long M = s.M(), Mk = s.Mk(), D = s.D, F = s.F;
  BwdBuffers<T> b;
  b.da1_f = ar.take<float>(M * F);
  b.da1_t = ar.take<T>(M * F);
  b.dh2_f = ar.take<float>(M * D);
  b.dx1_f = ar.take<float>(M * D);
  b.dx1_t = ar.take<T>(M * D);
  b.dctx_t = ar.take<T>(M * D);
  b.stats = ar.take<float>(3LL * s.B * s.H * s.Sq);
  b.dqp_f = ar.take<float>(M * D);
  b.dqp_t = ar.take<T>(M * D);
  b.dkvp_f = ar.take<float>(Mk * 2 * D);
  b.dkvp_t = ar.take<T>(Mk * 2 * D);
  b.dh_f = ar.take<float>(M * D);
  b.dkvh_f = s.cross ? ar.take<float>(Mk * D) : nullptr;
  b.dq[0] = ar.take<T>(M * D);
  b.dq[1] = ar.take<T>(M * D);
  b.colpart = ar.take<float>((long long)cdiv(std::max(M, Mk), kRowsPer) *
                             std::max(F, 2 * D));
  b.wpart = ar.take<float>(max_wpart(s));
  return b;
}

// The attention backward of one block, from d ctx (buf.dctx_t) to dqp
// (B*Sq, D) and dkvp (B*Sk', 2D) in the layouts of qp and kvp, rounded and
// in fp32; it reads the block's saved qp, kvp, ctx and row log-sum-exp.
template <typename T>
attn_bwd::BwdParams<T> block_attention_bwd(const Shape& s, const State<T>& f,
                                           const BwdBuffers<T>& buf) {
  const attn_fwd::Params<T> at =
      block_attention(s, (const T*)f.qp, (const T*)f.kvp, f.ctx);
  const long long BHS = (long long)s.B * s.H * s.Sq;
  attn_bwd::BwdParams<T> ab = {};
  ab.q = at.q;
  ab.k = at.k;
  ab.v = at.v;
  ab.dout = buf.dctx_t;
  ab.dq = buf.dqp_t;
  ab.dk = buf.dkvp_t;
  ab.dv = buf.dkvp_t + s.D;
  ab.dq_f = buf.dqp_f;
  ab.dk_f = buf.dkvp_f;
  ab.dv_f = buf.dkvp_f + s.D;
  ab.row_m = buf.stats;
  ab.row_l = buf.stats + BHS;
  ab.row_delta = buf.stats + 2 * BHS;
  ab.out = at.o;
  ab.so = at.so;
  ab.lse = f.lse;
  ab.sq = ab.sdo = ab.sdq = at.sq;
  ab.sk = ab.sv = ab.sdk = ab.sdv = at.sk;
  ab.H = at.H;
  ab.Sq = at.Sq;
  ab.Sk = at.Sk;
  ab.Dh = at.Dh;
  ab.scale = at.scale;
  return ab;
}

template <typename T>
int stack_bwd(const T* qstack, const T* kv, const void* const* w_,
              const void* state, const T* dout, T* dq0, T* dkv,
              void* const* dw_, void* work, const Shape& s, int gelu,
              cudaStream_t st) {
  const T* const* w = reinterpret_cast<const T* const*>(w_);
  T* const* dw = reinterpret_cast<T* const*>(dw_);
  Arena ar = {static_cast<char*>(work), 0};
  const BwdBuffers<T> buf = bwd_buffers<T>(ar, s);
  const int M = (int)s.M(), Mk = (int)s.Mk(), D = s.D, F = s.F;
  const long long MD = (long long)M * D;

  if (!s.cross) {
    CHECK((int)cudaMemsetAsync(dw[kLnkvG], 0, s.L * s.wsize(kLnkvG) *
                               sizeof(T), st));
    CHECK((int)cudaMemsetAsync(dw[kLnkvB], 0, s.L * s.wsize(kLnkvB) *
                               sizeof(T), st));
  }

  for (int l = s.L - 1; l >= 0; --l) {
    auto wl = [&](int k) { return w[k] + l * s.wsize(k); };
    auto dwl = [&](int k) { return dw[k] + l * s.wsize(k); };
    const State<T> f = state_at<T>(state, s, l);
    const T* x = qstack + l * MD;
    const T* kvh = s.cross ? f.kvh : f.h;
    const T* dq_in = l == s.L - 1 ? dout : buf.dq[(l + 1) & 1];
    T* dq_out = l == 0 ? dq0 : buf.dq[l & 1];

    // ---- the MLP half ----
    Gemm<T> g = bwd_gemm(dq_in, wl(kWfc2), M, F, D, kEpiGeluGrad);
    g.aux = f.a1;
    g.gelu = gelu;
    g.outf = buf.da1_f;
    g.out = buf.da1_t;
    CHECK(gemm(g, 1, st));
    CHECK(weight_grad(dq_in, (const T*)f.a2, D, F, M, buf.wpart,
                      dwl(kWfc2), st));
    CHECK(bias_grad(dq_in, M, D, buf.colpart, dwl(kBfc2), st));
    g = bwd_gemm((const T*)buf.da1_t, wl(kWfc1), M, D, F, kEpiF32);
    g.outf = buf.dh2_f;
    CHECK(gemm(g, 1, st));
    CHECK(weight_grad((const T*)buf.da1_t, (const T*)f.h2, F, D, M,
                      buf.wpart, dwl(kWfc1), st));
    CHECK(bias_grad((const float*)buf.da1_f, M, F, buf.colpart, dwl(kBfc1),
                    st));
    LnBwd<T> lb = {};
    lb.x = f.x1;
    lb.mean = f.mean2;
    lb.rstd = f.rstd2;
    lb.dy = buf.dh2_f;
    lb.g = wl(kLn2G);
    lb.res_t = dq_in;
    lb.out_f = buf.dx1_f;
    lb.out_t = buf.dx1_t;
    lb.M = M;
    lb.D = D;
    CHECK(ln_bwd(lb, buf.colpart, dwl(kLn2G), dwl(kLn2B), st));

    // ---- the attention half ----
    g = bwd_gemm((const T*)buf.dx1_t, wl(kWproj), M, D, D, kEpiRound);
    g.out = buf.dctx_t;
    CHECK(gemm(g, 1, st));
    CHECK(weight_grad((const T*)buf.dx1_t, (const T*)f.ctx, D, D, M,
                      buf.wpart, dwl(kWproj), st));
    CHECK(bias_grad((const float*)buf.dx1_f, M, D, buf.colpart,
                    dwl(kBproj), st));
    CHECK(attn_bwd::launch(block_attention_bwd(s, f, buf), s.B, st));
    g = bwd_gemm((const T*)buf.dqp_t, wl(kWq), M, D, D, kEpiF32);
    g.outf = buf.dh_f;
    CHECK(gemm(g, 1, st));
    CHECK(weight_grad((const T*)buf.dqp_t, (const T*)f.h, D, D, M,
                      buf.wpart, dwl(kWq), st));
    CHECK(bias_grad((const float*)buf.dqp_f, M, D, buf.colpart, dwl(kBq),
                    st));
    g = bwd_gemm((const T*)buf.dkvp_t, wl(kWkv), Mk, D, 2 * D,
                 s.cross ? kEpiF32 : kEpiF32Add);
    g.outf = s.cross ? buf.dkvh_f : buf.dh_f;
    CHECK(gemm(g, 1, st));
    CHECK(weight_grad((const T*)buf.dkvp_t, kvh, 2 * D, D, Mk, buf.wpart,
                      dwl(kWkv), st));
    CHECK(bias_grad((const float*)buf.dkvp_f, Mk, 2 * D, buf.colpart,
                    dwl(kBkv), st));
    lb = LnBwd<T>{};
    lb.x = x;
    lb.mean = f.mean1;
    lb.rstd = f.rstd1;
    lb.dy = buf.dh_f;
    lb.g = wl(kLn1G);
    lb.res_f = buf.dx1_f;
    lb.out_t = dq_out;
    lb.M = M;
    lb.D = D;
    CHECK(ln_bwd(lb, buf.colpart, dwl(kLn1G), dwl(kLn1B), st));
    if (s.cross) {
      lb = LnBwd<T>{};
      lb.x = kv;
      lb.mean = f.meankv;
      lb.rstd = f.rstdkv;
      lb.dy = buf.dkvh_f;
      lb.g = wl(kLnkvG);
      lb.out_t = dkv;
      lb.accum = l != s.L - 1;
      lb.M = Mk;
      lb.D = D;
      CHECK(ln_bwd(lb, buf.colpart, dwl(kLnkvG), dwl(kLnkvB), st));
    }
  }
  return 0;
}

Shape make_shape(int B, int Sq, int Sk, int D, int H, int F, int L,
                 int cross) {
  Shape s = {B, Sq, Sk, D, H, F, L, cross != 0};
  return s;
}

}  // namespace

extern "C" {

// Bytes of workspace block_stack_bwd needs (dtype: 0 float32, 1 bfloat16).
long long block_stack_bwd_workspace(int B, int Sq, int Sk, int D, int H,
                                    int F, int cross, int dtype) {
  const Shape s = make_shape(B, Sq, Sk, D, H, F, 1, cross);
  Arena ar = {nullptr, 0};
  if (dtype == 1)
    bwd_buffers<__nv_bfloat16>(ar, s);
  else
    bwd_buffers<float>(ar, s);
  return (long long)ar.used;
}

// qstack (L, B, Sq, D) and state (block_stack_fwd_state bytes) from
// block_stack_fwd run with a state buffer; kv (B, Sk, D) or null (self);
// w: the 16 stacked weights (W_KEYS order); dout (B, Sq, D). Writes dq0
// (B, Sq, D), dkv (B, Sk, D) (cross only) and dw: 16 tensors shaped as w.
// work: block_stack_bwd_workspace bytes. All contiguous, one dtype
// (0 float32, 1 bfloat16); gelu 0 tanh, 1 erf. Returns a cudaError_t.
int block_stack_bwd(const void* qstack, const void* kv, const void* const* w,
                    const void* state, const void* dout, void* dq0, void* dkv,
                    void* const* dw, void* work, int B, int Sq, int Sk,
                    int D, int H, int F, int L, int gelu, int cross,
                    int dtype, void* stream) {
  const Shape s = make_shape(B, Sq, Sk, D, H, F, L, cross);
  if (!valid_shape(s) || state == nullptr ||
      (cross && (kv == nullptr || dkv == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stack_bwd(static_cast<const float*>(qstack),
                     static_cast<const float*>(kv), w, state,
                     static_cast<const float*>(dout),
                     static_cast<float*>(dq0), static_cast<float*>(dkv), dw,
                     work, s, gelu, st);
  if (dtype == 1)
    return stack_bwd(static_cast<const __nv_bfloat16*>(qstack),
                     static_cast<const __nv_bfloat16*>(kv), w, state,
                     static_cast<const __nv_bfloat16*>(dout),
                     static_cast<__nv_bfloat16*>(dq0),
                     static_cast<__nv_bfloat16*>(dkv), dw, work, s, gelu, st);
  return (int)cudaErrorInvalidValue;
}

// One product of the tensor-core body alone, for a backward pair (a_km = 0,
// b_kn = 1 with mode 3 GELU gradient, 4 fp32, 5 fp32 add or 6 rounded; or
// a_km = b_kn = 1 with mode 7, the split partials (splits, M, N) in outf):
// see gemm_body_entry in block_common.cuh. Returns a cudaError_t.
int block_stack_bwd_gemm(const void* a, const void* b, const void* bias,
                         const void* res, const void* aux, void* out,
                         void* out2, float* outf, int M, int N, int K,
                         int a_km, int b_kn, int mode, int gelu, int splits,
                         void* stream) {
  return gemm_body_entry(a, b, bias, res, aux, out, out2, outf, M, N, K,
                         a_km, b_kn, mode, gelu, splits, stream);
}

// The row splits of a weight-gradient product (out, in) over `rows` rows,
// as the stack takes them (dw_splits).
int block_stack_bwd_dw_splits(int out, int in, int rows) {
  return (int)dw_splits(out, in, rows);
}

const char* block_stack_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
