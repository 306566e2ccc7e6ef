// Attention backward kernels for Hopper (sm_90a), with a plain C interface
// (bound from Python through ctypes, see mae_clip_torch/ops/_build.py).
//
// Replaces two Pallas TPU kernels of the JAX package:
//
//   * qkv_packed_attention_bwd <- mae_clip_tpu/ops/attention.py
//                                 _qkv_bwd_kernel (pallas_call in
//                                 _qkv_attn_bwd_rule). Reads q/k/v as column
//                                 slices (j*H + h)*Dh of the packed
//                                 (B, S, 3*H*Dh) qkv row and dO as
//                                 (B, S, H*Dh); writes dq/dk/dv into the same
//                                 column slices of one (B, S, 3*H*Dh) tensor,
//                                 so the qkv matmul's backward takes it with
//                                 no relayout. The ViT encoder blocks.
//   * flash_attention_bwd      <- mae_clip_tpu/ops/attention.py
//                                 _flash_bwd_kernel (pallas_call in
//                                 _flash_backward). q (B, H, Sq, Dh), k/v
//                                 (B, H, Sk, Dh), any strides with a
//                                 contiguous last dim; separate dq/dk/dv.
//                                 The CrossMAE decoder's cross-attention.
//
// Both entry points run the same two kernel bodies over strided views, as
// the forward kernels do (attention_fwd.cu).
//
// Math and design: attention_bwd.cuh, which holds the two kernels' bodies
// (shared with the block stack's backward); this file binds them to the
// two entry points.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), reckoned from the
// work each call must do at the flagship training shapes:
//   * packed, (256, 50, 1152) bf16, 3 heads of 128: reads qkv 29.5 MB, dO
//     and the forward's output 9.8 MB each and lse 0.15 MB, writes d_qkv
//     29.5 MB: 78.8 MB -> 23.5 us, against 2.46 GFLOP -> 2.5 us: bound by
//     bytes. At the MAE-paper decoder's (256, 197, 768), 2 heads: 207 MB
//     -> 62 us against 35.6 GFLOP (7 products) -> 36 us. The packed entry
//     runs the LSE bodies (attention_bwd.cuh): the forward's lse and output
//     replace the recomputed row statistics, so the dq kernel walks the keys
//     once.
//   * flash, q (256, 2, 147, 128), k/v (256, 2, 50, 128) bf16: reads q, k,
//     v, dO 51.6 MB, writes dq, dk, dv 32.4 MB: 84.0 MB -> 25.1 us, against
//     4.82 GFLOP -> 4.9 us: bound by bytes. This design also reads the
//     forward's output and lse (19.6 MB -> 30.9 us in all). With one key
//     tile (Sk = 50) a single kernel holds K and V and streams the queries
//     (attn_bwd_stream_kernel), so each byte is read once.
// Both entries take the forward's output and lse (the LSE bodies);
// wgmma/TMA bodies are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_bwd.cuh"

namespace {

using attn_bwd::BwdParams;

template <typename T>
void set_scratch(BwdParams<T>& p, float* scratch, long long rows) {
  p.row_m = scratch;
  p.row_l = scratch + rows;
  p.row_delta = scratch + 2 * rows;
}

template <typename T>
int flash(const void* q, const void* k, const void* v, const float* mask,
          const void* out, const float* lse, const void* dout, void* dq,
          void* dk, void* dv, float* scratch, const long long* st, int B,
          int H, int Sq, int Sk, int Dh, float scale, cudaStream_t stream) {
  BwdParams<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.mask = mask;
  p.out = static_cast<const T*>(out);
  p.lse = lse;
  set_scratch(p, scratch, (long long)B * H * Sq);
  Strides* all[8] = {&p.sq,  &p.sk,  &p.sv,  &p.sdo,
                     &p.sdq, &p.sdk, &p.sdv, &p.so};
  for (int i = 0; i < 8; ++i)
    *all[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Dh = Dh;
  p.scale = scale;
  return attn_bwd::launch(p, B, stream);
}

template <typename T>
int packed(const void* qkv, const float* mask, const void* out,
           const float* lse, const void* dout, void* dqkv, float* scratch,
           int B, int S, int H, int Dh, float scale, cudaStream_t stream) {
  const T* in = static_cast<const T*>(qkv);
  T* grad = static_cast<T*>(dqkv);
  const long long hd = (long long)H * Dh;
  const Strides cols = {S * 3 * hd, Dh, 3 * hd};
  BwdParams<T> p = {};
  p.q = in;
  p.k = in + hd;
  p.v = in + 2 * hd;
  p.dout = static_cast<const T*>(dout);
  p.dq = grad;
  p.dk = grad + hd;
  p.dv = grad + 2 * hd;
  p.mask = mask;
  p.out = static_cast<const T*>(out);
  p.lse = lse;
  set_scratch(p, scratch, (long long)B * H * S);
  p.sq = p.sk = p.sv = p.sdq = p.sdk = p.sdv = cols;
  p.sdo = p.so = {S * hd, Dh, hd};
  p.H = H;
  p.Sq = S;
  p.Sk = S;
  p.Dh = Dh;
  p.scale = scale;
  return attn_bwd::launch(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. out: the forward's output; lse: its
// (B*H, Sq) fp32 row log-sum-exp (the bf16 tensor-core bodies need both; the
// scalar body reads neither). strides: 24 element strides, (batch, head,
// row) for q, k, v, dout, dq, dk, dv and out in that order. scratch:
// 3*B*H*Sq floats. Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const float* mask, const void* out, const float* lse,
                        const void* dout, void* dq, void* dk, void* dv,
                        float* scratch, const long long* strides, int B,
                        int H, int Sq, int Sk, int Dh, float scale, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash<float>(q, k, v, mask, out, lse, dout, dq, dk, dv, scratch,
                        strides, B, H, Sq, Sk, Dh, scale, s);
  if (dtype == 1)
    return flash<__nv_bfloat16>(q, k, v, mask, out, lse, dout, dq, dk, dv,
                                scratch, strides, B, H, Sq, Sk, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// qkv, dqkv: contiguous (B, S, 3*H*Dh), columns (3, H, Dh); out (the
// forward's output) and dout: contiguous (B, S, H*Dh); lse: the forward's
// (B*H, S) fp32 row log-sum-exp; scratch: 3*B*H*S floats. Returns a
// cudaError_t.
int qkv_packed_attention_bwd(const void* qkv, const float* mask,
                             const void* out, const float* lse,
                             const void* dout, void* dqkv, float* scratch,
                             int B, int S, int H, int Dh, float scale,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return packed<float>(qkv, mask, out, lse, dout, dqkv, scratch, B, S, H,
                         Dh, scale, s);
  if (dtype == 1)
    return packed<__nv_bfloat16>(qkv, mask, out, lse, dout, dqkv, scratch, B,
                                 S, H, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
