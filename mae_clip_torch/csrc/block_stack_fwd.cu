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
// LayerNorm, the five GEMMs (q, kv, proj + residual, fc1 + GELU, fc2 +
// residual) on the bf16 wgmma body (block_common.cuh: TMA, wgmma, 128 x 128
// tiles on a persistent grid) over all B*Sq rows at once (no
// padding: each sample's keys are exactly its Sk rows), and the attention
// forward of kernels #1/#2 (attention_fwd.cuh) with P normalised before it
// is rounded, reading q, k and v in place in qp and kvp. qstack[l] is block
// l's input: the residual stream lives in qstack itself, so nothing is
// copied but q0. fp32, and widths that are not multiples of 8, take the
// scalar bodies.
//
// Where the activations go. Without a state buffer (serving, and the
// forward of fused_blocks='fwd'), through one block's workspace in device
// memory that every block reuses (in L2 for the most part: one encoder
// block's are ~40 MB at B=256). With one (training, fused_blocks='on'),
// each block writes them into its own slice of the state (State in
// block_common.cuh): the same activations plus a1, which the fc1 epilogue
// also stores, the attention's row log-sum-exp and the LayerNorms' row mean
// and rstd, for block_stack_bwd.cu to read instead of recomputing the
// block. The TPU kernel keeps only qstack, since a block's activations live
// in VMEM; HBM holds them here: 147 MB a block at the encoder (1.77 GB for
// 12), 270 MB at the decoder (1.08 GB for 4), at B=256 in bf16. The state
// changes no value the forward computes: out and qstack are the same bits.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the flagship
// encoder (B=256, S=50, D=384, 3 heads of 128, F=1536, L=12) the stack is
// 555 GFLOP against ~60 MB of inputs, weights and outputs: 0.56 ms, bound by
// operations; the CrossMAE decoder (q (256, 147, 256), kv (256, 50, 256),
// F=1024, L=4) 0.22 ms. Writing the state adds 0.53 / 0.32 ms of bytes,
// which stay under the products' time. chip_smoke.py computes both from its
// inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_common.cuh"

namespace {

#define CHECK(expr)           \
  do {                        \
    const int e_ = (expr);    \
    if (e_ != 0) return e_;   \
  } while (0)

// The tensor-core body's (layout, epilogue) pairs this library launches:
// the forward products, x (mk) . W^T (nk), with the bias epilogues.
int launch_wgmma(const Gemm<__nv_bfloat16>& p, int splits,
                 cudaStream_t st) {
  if (!p.a_km && !p.b_kn) {
    switch (p.mode) {
      case kEpiBias:
        return launch_wgmma_as<false, false, kEpiBias>(p, splits, st);
      case kEpiBiasRes:
        return launch_wgmma_as<false, false, kEpiBiasRes>(p, splits, st);
      case kEpiBiasGelu:
        return launch_wgmma_as<false, false, kEpiBiasGelu>(p, splits, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int stack_fwd(const T* q0, const T* kv, const void* const* w_, T* out,
              T* qstack, void* work, void* state, const Shape& s, int gelu,
              cudaStream_t st) {
  const T* const* w = reinterpret_cast<const T* const*>(w_);
  State<T> buf = {};
  if (state == nullptr) {
    Arena ar = {static_cast<char*>(work), 0};
    buf = take_state<T>(ar, s, /*full=*/false);
  }
  const int M = (int)s.M(), Mk = (int)s.Mk(), D = s.D, F = s.F;
  const long long MD = (long long)M * D;
  CHECK((int)cudaMemcpyAsync(qstack, q0, MD * sizeof(T),
                             cudaMemcpyDeviceToDevice, st));

  for (int l = 0; l < s.L; ++l) {
    auto wl = [&](int k) { return w[k] + l * s.wsize(k); };
    if (state != nullptr) buf = state_at<T>(state, s, l);
    const T* x = qstack + l * MD;
    T* y = l + 1 < s.L ? qstack + (l + 1) * MD : out;
    CHECK(ln_fwd(x, wl(kLn1G), wl(kLn1B), buf.h, buf.mean1, buf.rstd1, M, D,
                 st));
    const T* kvh = buf.h;
    if (s.cross) {
      CHECK(ln_fwd(kv, wl(kLnkvG), wl(kLnkvB), buf.kvh, buf.meankv,
                   buf.rstdkv, Mk, D, st));
      kvh = buf.kvh;
    }
    Gemm<T> g = fwd_gemm((const T*)buf.h, wl(kWq), M, D, D, kEpiBias);
    g.bias = wl(kBq);
    g.out = buf.qp;
    CHECK(gemm(g, 1, st));
    g = fwd_gemm(kvh, wl(kWkv), Mk, 2 * D, D, kEpiBias);
    g.bias = wl(kBkv);
    g.out = buf.kvp;
    CHECK(gemm(g, 1, st));
    attn_fwd::Params<T> at =
        block_attention(s, (const T*)buf.qp, (const T*)buf.kvp, buf.ctx);
    at.lse = buf.lse;  // null without a state
    CHECK(attn_fwd::launch</*NORM=*/true>(at, s.B, st));
    g = fwd_gemm((const T*)buf.ctx, wl(kWproj), M, D, D, kEpiBiasRes);
    g.bias = wl(kBproj);
    g.res = x;
    g.out = buf.x1;
    CHECK(gemm(g, 1, st));
    CHECK(ln_fwd((const T*)buf.x1, wl(kLn2G), wl(kLn2B), buf.h2, buf.mean2,
                 buf.rstd2, M, D, st));
    g = fwd_gemm((const T*)buf.h2, wl(kWfc1), M, F, D, kEpiBiasGelu);
    g.bias = wl(kBfc1);
    g.gelu = gelu;
    g.out = buf.a1;  // null without a state
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

// The byte offset of each field of State<T> within a block's slice (-1 for
// an absent one): one block laid out from a base far from 0, read back.
template <typename T>
void state_offsets(const Shape& s, long long* offsets) {
  char* const base = reinterpret_cast<char*>(uintptr_t(1) << 40);
  Arena ar = {base, 0};
  const State<T> f = take_state<T>(ar, s, true);
  const void* const p[kStateFields] = {
      f.h, f.kvh, f.qp, f.kvp, f.ctx, f.x1, f.h2, f.a1, f.a2,
      f.lse, f.mean1, f.rstd1, f.mean2, f.rstd2, f.meankv, f.rstdkv};
  for (int k = 0; k < kStateFields; ++k)
    offsets[k] = p[k] == nullptr
                     ? -1
                     : (long long)(static_cast<const char*>(p[k]) - base);
}

Shape make_shape(int B, int Sq, int Sk, int D, int H, int F, int L,
                 int cross) {
  Shape s = {B, Sq, Sk, D, H, F, L, cross != 0};
  return s;
}

}  // namespace

extern "C" {

// Bytes of workspace block_stack_fwd needs without a state buffer (dtype:
// 0 float32, 1 bfloat16); with one it needs none.
long long block_stack_fwd_workspace(int B, int Sq, int Sk, int D, int F,
                                    int cross, int dtype) {
  const Shape s = make_shape(B, Sq, Sk, D, 1, F, 1, cross);
  Arena ar = {nullptr, 0};
  if (dtype == 1)
    take_state<__nv_bfloat16>(ar, s, false);
  else
    take_state<float>(ar, s, false);
  return (long long)ar.used;
}

// Bytes of the state buffer of L blocks (State in block_common.cuh). Where
// offsets is not null, it gets the byte offset of each of the 16 fields
// within a block's slice (-1 for a field the shape lacks: kvh, meankv and
// rstdkv in self mode), then the slice's size: block l's field k lies at
// l * offsets[16] + offsets[k].
long long block_stack_fwd_state(int B, int Sq, int Sk, int D, int H, int F,
                                int L, int cross, int dtype,
                                long long* offsets) {
  const Shape s = make_shape(B, Sq, Sk, D, H, F, L, cross);
  const long long block = dtype == 1 ? state_block_bytes<__nv_bfloat16>(s)
                                     : state_block_bytes<float>(s);
  if (offsets != nullptr) {
    if (dtype == 1)
      state_offsets<__nv_bfloat16>(s, offsets);
    else
      state_offsets<float>(s, offsets);
    offsets[kStateFields] = block;
  }
  return block * L;
}

// q0 (B, Sq, D); kv (B, Sk, D) or null (self); w: the 16 stacked weights in
// W_KEYS order, torch (out, in) layout; out (B, Sq, D); qstack (L, B, Sq,
// D); work: block_stack_fwd_workspace bytes, or null with a state; state:
// block_stack_fwd_state bytes, written for the backward, or null (nothing
// kept). All contiguous, one dtype (0 float32, 1 bfloat16); gelu 0 tanh,
// 1 erf. Returns a cudaError_t.
int block_stack_fwd(const void* q0, const void* kv, const void* const* w,
                    void* out, void* qstack, void* work, void* state, int B,
                    int Sq, int Sk, int D, int H, int F, int L, int gelu,
                    int cross, int dtype, void* stream) {
  const Shape s = make_shape(B, Sq, Sk, D, H, F, L, cross);
  if (!valid_shape(s) || (cross && kv == nullptr) ||
      (work == nullptr && state == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stack_fwd(static_cast<const float*>(q0),
                     static_cast<const float*>(kv), w,
                     static_cast<float*>(out), static_cast<float*>(qstack),
                     work, state, s, gelu, st);
  if (dtype == 1)
    return stack_fwd(static_cast<const __nv_bfloat16*>(q0),
                     static_cast<const __nv_bfloat16*>(kv), w,
                     static_cast<__nv_bfloat16*>(out),
                     static_cast<__nv_bfloat16*>(qstack), work, state, s,
                     gelu, st);
  return (int)cudaErrorInvalidValue;
}

// One product of the tensor-core body alone, for a forward pair (a_km = b_kn
// = 0; mode 0 bias, 1 bias + residual, 2 bias + GELU): see gemm_body_entry
// in block_common.cuh. Returns a cudaError_t.
int block_stack_fwd_gemm(const void* a, const void* b, const void* bias,
                         const void* res, const void* aux, void* out,
                         void* out2, float* outf, int M, int N, int K,
                         int a_km, int b_kn, int mode, int gelu, int splits,
                         void* stream) {
  return gemm_body_entry(a, b, bias, res, aux, out, out2, outf, M, N, K,
                         a_km, b_kn, mode, gelu, splits, stream);
}

const char* block_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
