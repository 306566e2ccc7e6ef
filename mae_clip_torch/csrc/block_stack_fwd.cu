// Fused transformer block stack, forward, for Hopper (sm_90a), with a plain
// C interface (bound from Python through ctypes, see
// mae_clip_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel of the JAX package
//
//   * block_stack_fwd <- mae_clip_tpu/ops/block_kernel.py _stack_fwd_kernel
//                        (pallas_call in _stack_forward).
//
// It runs L pre-LN blocks, self-attention (the ViT encoder) or
// cross-attention (the CrossMAE decoder), and keeps each block's input:
//   h = LN1(x); kvh = LNkv(kv) (cross) or h; qp = h Wq^T + bq;
//   kvp = kvh Wkv^T + bkv; ctx = softmax(q k^T * scale) v per sample/head;
//   x1 = x + (ctx Wproj^T + bproj); h2 = LN2(x1); a1 = h2 Wfc1^T + bfc1;
//   a2 = gelu(a1); out = x1 + (a2 Wfc2^T + bfc2).
// The roundings are the TPU kernel's (block_common.cuh, and the plain
// version fused_block_stack_ref in ops/block_kernel.py): fp32 LN statistics,
// fp32 sums plus fp32 bias rounded once to the compute type, fp32 softmax
// normalised before P is rounded, residual adds and GELU rounded to the
// compute type.
//
// Design. On the TPU the grid (block, batch tile) runs in order on one core
// with a block's weights resident in VMEM while the batch streams past. On
// this card one call walks the L blocks in order and, per block, launches
// LayerNorm, the four GEMMs (q, kv, proj + residual, fc1 + GELU, fc2 +
// residual) as bf16 tensor-core GEMMs over all B*Sq rows at once (no
// padding: each sample's keys are exactly its Sk rows), and the attention
// forward of kernels #1/#2 (attention_fwd.cuh) with P normalised before it
// is rounded, reading q, k and v in place in qp and kvp; activations go through a workspace in device memory (in L2 for the
// most part: one encoder block's are ~40 MB at B=256). qstack[l] is block
// l's input: the residual stream lives in qstack itself, so nothing is
// copied but q0. fp32, and widths that are not multiples of 8, take the
// scalar bodies.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the flagship
// encoder (B=256, S=50, D=384, 3 heads of 128, F=1536, L=12) the stack is
// 555 GFLOP against ~60 MB of inputs, weights and outputs: 0.56 ms, bound by
// operations; the CrossMAE decoder (q (256, 147, 256), kv (256, 50, 256),
// F=1024, L=4) 0.22 ms. chip_smoke.py computes both from its inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_common.cuh"

namespace {

template <typename T>
struct FwdBuffers {
  T *h, *kvh, *qp, *kvp, *ctx, *x1, *h2, *a2;
};

template <typename T>
FwdBuffers<T> fwd_buffers(Arena& ar, const Shape& s) {
  const long long M = s.M(), Mk = s.Mk(), D = s.D;
  FwdBuffers<T> b;
  b.h = ar.take<T>(M * D);
  b.kvh = s.cross ? ar.take<T>(Mk * D) : nullptr;
  b.qp = ar.take<T>(M * D);
  b.kvp = ar.take<T>(Mk * 2 * D);
  b.ctx = ar.take<T>(M * D);
  b.x1 = ar.take<T>(M * D);
  b.h2 = ar.take<T>(M * D);
  b.a2 = ar.take<T>(M * s.F);
  return b;
}

#define CHECK(expr)           \
  do {                        \
    const int e_ = (expr);    \
    if (e_ != 0) return e_;   \
  } while (0)

template <typename T>
int stack_fwd(const T* q0, const T* kv, const void* const* w_, T* out,
              T* qstack, void* work, const Shape& s, int gelu,
              cudaStream_t st) {
  const T* const* w = reinterpret_cast<const T* const*>(w_);
  Arena ar = {static_cast<char*>(work), 0};
  const FwdBuffers<T> buf = fwd_buffers<T>(ar, s);
  const int M = (int)s.M(), Mk = (int)s.Mk(), D = s.D, F = s.F;
  const long long MD = (long long)M * D;
  CHECK((int)cudaMemcpyAsync(qstack, q0, MD * sizeof(T),
                             cudaMemcpyDeviceToDevice, st));

  const attn_fwd::Params<T> at =
      block_attention(s, (const T*)buf.qp, (const T*)buf.kvp, buf.ctx);

  for (int l = 0; l < s.L; ++l) {
    auto wl = [&](int k) { return w[k] + l * s.wsize(k); };
    const T* x = qstack + l * MD;
    T* y = l + 1 < s.L ? qstack + (l + 1) * MD : out;
    CHECK(ln_fwd(x, wl(kLn1G), wl(kLn1B), buf.h, M, D, st));
    const T* kvh = buf.h;
    if (s.cross) {
      CHECK(ln_fwd(kv, wl(kLnkvG), wl(kLnkvB), buf.kvh, Mk, D, st));
      kvh = buf.kvh;
    }
    Gemm<T> g = fwd_gemm(buf.h, wl(kWq), M, D, D, kEpiBias);
    g.bias = wl(kBq);
    g.out = buf.qp;
    CHECK(gemm(g, 1, st));
    g = fwd_gemm(kvh, wl(kWkv), Mk, 2 * D, D, kEpiBias);
    g.bias = wl(kBkv);
    g.out = buf.kvp;
    CHECK(gemm(g, 1, st));
    CHECK(attn_fwd::launch</*NORM=*/true>(at, s.B, st));
    g = fwd_gemm((const T*)buf.ctx, wl(kWproj), M, D, D, kEpiBiasRes);
    g.bias = wl(kBproj);
    g.res = x;
    g.out = buf.x1;
    CHECK(gemm(g, 1, st));
    CHECK(ln_fwd((const T*)buf.x1, wl(kLn2G), wl(kLn2B), buf.h2, M, D, st));
    g = fwd_gemm((const T*)buf.h2, wl(kWfc1), M, F, D, kEpiBiasGelu);
    g.bias = wl(kBfc1);
    g.gelu = gelu;
    g.out2 = buf.a2;
    CHECK(gemm(g, 1, st));
    g = fwd_gemm((const T*)buf.a2, wl(kWfc2), M, D, F, kEpiBiasRes);
    g.bias = wl(kBfc2);
    g.res = buf.x1;
    g.out = y;
    CHECK(gemm(g, 1, st));
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

// Bytes of workspace block_stack_fwd needs (dtype: 0 float32, 1 bfloat16).
long long block_stack_fwd_workspace(int B, int Sq, int Sk, int D, int F,
                                    int cross, int dtype) {
  const Shape s = make_shape(B, Sq, Sk, D, 1, F, 1, cross);
  Arena ar = {nullptr, 0};
  if (dtype == 1)
    fwd_buffers<__nv_bfloat16>(ar, s);
  else
    fwd_buffers<float>(ar, s);
  return (long long)ar.used;
}

// q0 (B, Sq, D); kv (B, Sk, D) or null (self); w: the 16 stacked weights in
// W_KEYS order, torch (out, in) layout; out (B, Sq, D); qstack (L, B, Sq,
// D); work: block_stack_fwd_workspace bytes. All contiguous, one dtype
// (0 float32, 1 bfloat16); gelu 0 tanh, 1 erf. Returns a cudaError_t.
int block_stack_fwd(const void* q0, const void* kv, const void* const* w,
                    void* out, void* qstack, void* work, int B, int Sq,
                    int Sk, int D, int H, int F, int L, int gelu, int cross,
                    int dtype, void* stream) {
  const Shape s = make_shape(B, Sq, Sk, D, H, F, L, cross);
  if (!valid_shape(s) || (cross && kv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stack_fwd(static_cast<const float*>(q0),
                     static_cast<const float*>(kv), w,
                     static_cast<float*>(out), static_cast<float*>(qstack),
                     work, s, gelu, st);
  if (dtype == 1)
    return stack_fwd(static_cast<const __nv_bfloat16*>(q0),
                     static_cast<const __nv_bfloat16*>(kv), w,
                     static_cast<__nv_bfloat16*>(out),
                     static_cast<__nv_bfloat16*>(qstack), work, s, gelu, st);
  return (int)cudaErrorInvalidValue;
}

const char* block_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
