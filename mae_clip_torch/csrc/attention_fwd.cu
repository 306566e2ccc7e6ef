// Attention forward kernels for Hopper (sm_90a), with a plain C interface
// (bound from Python through ctypes, see mae_clip_torch/ops/_build.py).
//
// Replaces two Pallas TPU kernels of the JAX package:
//
//   * flash_attention_fwd      <- mae_clip_tpu/ops/attention.py
//                                 _flash_fwd_kernel (pallas_call in
//                                 _flash_forward). q/k/v (B, H, S, Dh) with a
//                                 (B, Sk) key mask; the DistilBERT text tower.
//   * qkv_packed_attention_fwd <- mae_clip_tpu/ops/attention.py
//                                 _qkv_fwd_kernel (pallas_call in
//                                 _qkv_attention_forward). Reads q/k/v as
//                                 column slices (j*H + h)*Dh of the packed
//                                 (B, S, 3*H*Dh) qkv row and writes the
//                                 head-concatenated (B, S, H*Dh) context in
//                                 place; the ViT encoder blocks.
//
// Both entry points run the same two kernel bodies (attention_fwd.cuh) over
// strided q/k/v/out views, so neither wrapper unpacks, transposes or pads
// anything.
//
// Semantics (same as the plain PyTorch versions in ops/attention.py):
//   s = (q . k) * scale, fp32; masked keys get -0.7 * FLT_MAX; keys past Sk
//   (the ragged edge of the last key tile) get -inf and weigh nothing;
//   online softmax over 64-key tiles with m/l/acc in fp32;
//   out = acc / max(l, 1e-30), rounded to the input type. Both entries
//   also write the row log-sum-exp lse = m + log(max(l, 1e-30)) (fp32,
//   (B*H, Sq)) when given an lse pointer: the training path, whose backward
//   (#3, #4) reads it instead of recomputing the row statistics.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), reckoned from the
// work each call must do:
//   * packed, ViT-S/16 at B=64, S=197, H=3, Dh=128, bf16: reads 29.0 MB of
//     qkv and writes 9.7 MB, ~3.8 GFLOP -> memory-bound, ~11.6 us; the
//     MAE-paper decoder at B=256, S=197, H=2 (training, with lse): reads
//     77.5 MB, writes 25.8 + 0.4 MB -> ~31 us, against 10.2 GFLOP -> 10 us.
//     The pipelined body (attention_fwd.cuh) overlaps the loads with the
//     products and skips the ragged key chunks.
//   * flash, DistilBERT at B=16, H=6, S=64, Dh=128, bf16: ~6.3 MB moved ->
//     ~1.9 us; launch overhead dominates at this size. The CrossMAE
//     decoder, q (256, 2, 147, 128), k/v (256, 2, 50, 128), with lse: reads
//     32.4 MB, writes 19.6 MB -> ~15.5 us against 4.8 GFLOP: bound by
//     bytes. One key tile: K and V are read once per batch*head
//     (attn_fwd_stream_kernel).
//
// The kernel bodies live in attention_fwd.cuh (shared with the block
// stacks, which normalise P before rounding it); this file binds them to the
// two entry points with NORM = false (the pipelined tensor-core body).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_fwd.cuh"

namespace {

using attn_fwd::Params;

template <typename T>
int flash(const void* q, const void* k, const void* v, const float* mask,
          void* o, float* lse, const long long* strides, int B, int H,
          int Sq, int Sk, int Dh, float scale, cudaStream_t stream) {
  Params<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.mask = mask;
  p.lse = lse;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Dh = Dh;
  p.scale = scale;
  return attn_fwd::launch<false>(p, B, stream);
}

template <typename T>
int packed(const void* qkv, const float* mask, void* o, float* lse, int B,
           int S, int H, int Dh, float scale, cudaStream_t stream) {
  const T* base = static_cast<const T*>(qkv);
  const long long hd = (long long)H * Dh;
  const Strides in = {S * 3 * hd, Dh, 3 * hd};
  Params<T> p = {};
  p.q = base;
  p.k = base + hd;
  p.v = base + 2 * hd;
  p.o = static_cast<T*>(o);
  p.mask = mask;
  p.lse = lse;
  p.sq = p.sk = p.sv = in;
  p.so = {S * hd, Dh, hd};
  p.H = H;
  p.Sq = S;
  p.Sk = S;
  p.Dh = Dh;
  p.scale = scale;
  return attn_fwd::launch<false>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, row) for q, k, v and out in that order. lse: (B*H, Sq) fp32, or
// null for no lse. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* mask, void* out, float* lse,
                        const long long* strides, int B, int H, int Sq,
                        int Sk, int Dh, float scale, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash<float>(q, k, v, mask, out, lse, strides, B, H, Sq, Sk, Dh,
                        scale, s);
  if (dtype == 1)
    return flash<__nv_bfloat16>(q, k, v, mask, out, lse, strides, B, H, Sq,
                                Sk, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// qkv: contiguous (B, S, 3*H*Dh), columns (3, H, Dh); out: contiguous
// (B, S, H*Dh); lse: (B*H, S) fp32, or null for no lse. Returns a
// cudaError_t.
int qkv_packed_attention_fwd(const void* qkv, const float* mask, void* out,
                             float* lse, int B, int S, int H, int Dh,
                             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return packed<float>(qkv, mask, out, lse, B, S, H, Dh, scale, s);
  if (dtype == 1)
    return packed<__nv_bfloat16>(qkv, mask, out, lse, B, S, H, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
