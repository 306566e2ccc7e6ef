"""Multi-head attention: plain PyTorch versions and the CUDA kernel wrappers.

Counterpart of ``mae_clip_tpu/ops/attention.py``. Layouts follow the JAX
package at every public function: q/k/v ``(B, H, S, Dh)`` with a ``(B, Sk)``
key mask, or the packed ``(B, S, 3*H*Dh)`` output of a fused qkv matmul
(columns ordered as ``reshape(B, S, 3, H, Dh)``).

* ``attention_ref``: HF DistilBERT masking semantics (invalid-key scores
  replaced by ``finfo(float32).min``, softmax in fp32), with optional
  inverted dropout on the softmaxed weights (JAX's ``attention_xla``).
* ``flash_attention_ref`` / ``qkv_packed_attention_ref`` and
  ``flash_attention_bwd_ref`` / ``qkv_packed_attention_bwd_ref``: the plain
  versions of the four kernels, with the kernels' own semantics (masked keys
  at ``-0.7 * f32max``, normaliser floored at ``1e-30``, fp32 softmax; the
  backward recomputes P, rounds P and dS to the input type before their
  products and zeroes dS at masked keys), as the TPU kernels compute them.
* ``flash_attention_lse_ref`` / ``flash_attention_bwd_lse_ref``: the plain
  versions of kernels #2 and #4 as the training path runs them on the card:
  the forward also gives the row log-sum-exp, and the backward takes the
  forward's output and log-sum-exp instead of recomputing the row
  statistics (FlashAttention-2's formulation; equal in exact arithmetic).
  ``qkv_packed_attention_lse_ref`` / ``qkv_packed_attention_bwd_lse_ref``
  (#1 and #3) are the same on the packed layout.
* ``flash_attention`` / ``qkv_packed_attention``: the kernel wrappers, one
  ``torch.autograd.Function`` each, as the JAX package's ``custom_vjp``s. On
  a CPU tensor both directions run their plain versions, and the forward
  saves only its inputs and the mask, as JAX's residuals are; on a CUDA
  tensor they launch the hand-written kernels of ``csrc/attention_fwd.cu``
  and ``csrc/attention_bwd.cu`` or raise. There each forward, when its
  inputs need a gradient, also writes the row log-sum-exp and saves it with
  its output for the backward kernel (#3, #4) (more than JAX's residuals:
  the output is held anyway for the projection's backward, so it costs a
  reference; the log-sum-exp is 4 bytes a row and head). Each
  wrapper counts its kernel launches in ``<wrapper>.launches`` (forward) and
  ``<wrapper>.bwd_launches``.
* ``fused_qkv_attention`` / ``multi_head_attention``: the dispatchers the
  models call. There is no ``impl`` switch: the device of the input
  decides. Attention dropout (``dropout_rate > 0``, the text tower in
  train mode) takes ``attention_ref`` on every device, as JAX sends it to
  ``attention_xla``: the kernels never hold the weights it drops.

A fully masked row gets uniform weights over its Sk keys and no gradient
into q or k, as JAX's ``attention_xla`` gives. (The JAX package's Pallas
forward pads Sk to a multiple of 128 and lets the padded keys into such a
row's softmax; that fault is recorded in ROADMAP.md and not copied.)
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 256  # heads above 128 take the kernels' scalar bodies
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()  # serving threads launch concurrently


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None,
                  dropout_rate: float = 0.0,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HF DistilBERT attention: q scaled before the product, invalid-key
    scores replaced by the fp32 minimum, softmax in fp32. With
    ``dropout_rate > 0`` the softmaxed weights get inverted dropout (HF's
    train-mode ``attention_dropout``): kept where ``keep`` (B, H, Sq, Sk)
    is true and divided by ``1 - dropout_rate``; without ``keep`` the mask
    comes from torch's RNG (``F.dropout``)."""
    scale = _scale(q.shape[-1], sm_scale)
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid.bool()[:, None, None, :],
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if keep is None:
            probs = F.dropout(probs, dropout_rate)
        else:
            probs = torch.where(keep, probs / (1.0 - dropout_rate),
                                torch.zeros_like(probs))
    return torch.matmul(probs.to(q.dtype), v)


def _scores(q: torch.Tensor, k: torch.Tensor,
            key_valid: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """fp32 (q . k) * scale with masked keys at MASK_VALUE."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :] > 0, s,
                        torch.full_like(s, MASK_VALUE))
    return s


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            key_valid: Optional[torch.Tensor] = None,
                            sm_scale: Optional[float] = None):
    """Plain version of the flash kernel on the training path: (out, lse),
    out as ``flash_attention_ref`` gives it and lse the row log-sum-exp
    m + log(max(l, 1e-30)) of the masked, scaled scores, fp32 (B, H, Sq)
    (MASK_VALUE on a row whose keys are all masked)."""
    s = _scores(q, k, key_valid, _scale(q.shape[-1], sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash kernel: q/k/v (B, H, S, Dh) -> (B, H, Sq, Dh)."""
    return flash_attention_lse_ref(q, k, v, key_valid, sm_scale)[0]


def _unpack(qkv: torch.Tensor, n_heads: int):
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    x = qkv.reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def qkv_packed_attention_ref(qkv: torch.Tensor,
                             key_valid: Optional[torch.Tensor],
                             n_heads: int,
                             sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the packed kernel: (B, S, 3*H*Dh) -> (B, S, H*Dh)."""
    b, s, three_hd = qkv.shape
    q, k, v = _unpack(qkv, n_heads)
    ctx = flash_attention_ref(q, k, v, key_valid, sm_scale)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, three_hd // 3)


def qkv_packed_attention_lse_ref(qkv: torch.Tensor,
                                 key_valid: Optional[torch.Tensor],
                                 n_heads: int,
                                 sm_scale: Optional[float] = None):
    """Plain version of the packed kernel on the training path: (out, lse),
    out as ``qkv_packed_attention_ref`` gives it and lse the row
    log-sum-exp of the masked, scaled scores, fp32 (B*H, S)."""
    b, s, three_hd = qkv.shape
    ctx, lse = flash_attention_lse_ref(*_unpack(qkv, n_heads), key_valid,
                                       sm_scale)
    out = ctx.permute(0, 2, 1, 3).reshape(b, s, three_hd // 3)
    return out, lse.reshape(b * n_heads, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            key_valid: Optional[torch.Tensor],
                            sm_scale: Optional[float],
                            d_out: torch.Tensor):
    """Plain version of the flash backward kernel: (dq, dk, dv) for q
    (B, H, Sq, Dh), k/v (B, H, Sk, Dh) and d_out (B, H, Sq, Dh). The math and
    casts of the TPU kernel: P recomputed in fp32, ``pt = P`` and dO in v's
    type for dV, ``dP`` fp32, ``delta = rowsum(P * dP)``, ``dS = P * (dP -
    delta)`` in q's type (zero at masked keys), fp32 sums."""
    scale = _scale(q.shape[-1], sm_scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = None
    if key_valid is not None:
        valid = key_valid[:, None, None, :] > 0
        s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    do = d_out.to(v.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if valid is not None:
        ds = torch.where(valid, ds, torch.zeros_like(ds))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _pack_grads(grads, b: int, s: int, three_hd: int) -> torch.Tensor:
    return torch.stack(grads).permute(1, 3, 0, 2, 4).reshape(b, s, three_hd)


def qkv_packed_attention_bwd_ref(qkv: torch.Tensor,
                                 key_valid: Optional[torch.Tensor],
                                 n_heads: int, sm_scale: Optional[float],
                                 d_out: torch.Tensor) -> torch.Tensor:
    """Plain version of the packed backward kernel: d_qkv (B, S, 3*H*Dh) in
    the packed column layout, for d_out (B, S, H*Dh)."""
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    q, k, v = _unpack(qkv, n_heads)
    do = d_out.reshape(b, s, n_heads, d).permute(0, 2, 1, 3)
    grads = flash_attention_bwd_ref(q, k, v, key_valid, sm_scale, do)
    return _pack_grads(grads, b, s, three_hd)


def flash_attention_bwd_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                key_valid: Optional[torch.Tensor],
                                sm_scale: Optional[float],
                                out: torch.Tensor, lse: torch.Tensor,
                                d_out: torch.Tensor):
    """Plain version of kernel #4 as the training path runs it: (dq, dk, dv)
    from the forward's output ``out`` (B, H, Sq, Dh) and row log-sum-exp
    ``lse`` (B*H*Sq values, fp32) instead of recomputed row statistics.
    P = exp(s - lse) in fp32 (uniform 1/Sk on a row whose keys are all
    masked, whose lse is MASK_VALUE), delta = rowsum(dO * out) in fp32
    (equal to rowsum(P * dP) in exact arithmetic); the casts and masking of
    ``flash_attention_bwd_ref``."""
    b, h, sq, _ = q.shape
    scale = _scale(q.shape[-1], sm_scale)
    lse = lse.reshape(b, h, sq, 1)
    p = torch.exp(_scores(q, k, key_valid, scale) - lse)
    p = torch.where(lse < 0.5 * MASK_VALUE,
                    torch.full_like(p, 1.0 / k.shape[2]), p)
    do = d_out.to(v.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if key_valid is not None:
        ds = torch.where(key_valid[:, None, None, :] > 0, ds,
                         torch.zeros_like(ds))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def qkv_packed_attention_bwd_lse_ref(qkv: torch.Tensor,
                                     key_valid: Optional[torch.Tensor],
                                     n_heads: int, sm_scale: Optional[float],
                                     out: torch.Tensor, lse: torch.Tensor,
                                     d_out: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel #3 as the training path runs it: d_qkv from
    the forward's output ``out`` (B, S, H*Dh) and row log-sum-exp ``lse``
    (B*H, S), by ``flash_attention_bwd_lse_ref`` on the heads."""
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)

    def heads(x):
        return x.reshape(b, s, n_heads, d).permute(0, 2, 1, 3)

    grads = flash_attention_bwd_lse_ref(*_unpack(qkv, n_heads), key_valid,
                                        sm_scale, heads(out), lse,
                                        heads(d_out))
    return _pack_grads(grads, b, s, three_hd)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            f"(float32 or bfloat16)")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {[x.dtype for x in tensors]}")


def _mask_arg(key_valid: Optional[torch.Tensor], b: int, sk: int,
              device: torch.device) -> Optional[torch.Tensor]:
    if key_valid is None:
        return None
    if tuple(key_valid.shape) != (b, sk) or key_valid.device != device:
        raise ValueError(f"key_valid must be ({b}, {sk}) on {device}, got "
                         f"{tuple(key_valid.shape)} on {key_valid.device}")
    return key_valid.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on_error(err: int, error_string, name: str) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(wrapper, field: str) -> None:
    with _COUNT_LOCK:
        setattr(wrapper, field, getattr(wrapper, field) + 1)


def _strides(*tensors: torch.Tensor):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_flash(q, k, v, mask, scale: float, with_lse: bool = False):
    """(out, lse): kernel #2, with the row log-sum-exp (B, H, Sq) in fp32
    when ``with_lse`` (the training path), else None."""
    from mae_clip_torch.ops._build import load_attention

    lib = load_attention()
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # Allocated (B, Sq, H, Dh) and returned as a (B, H, Sq, Dh) view: the
    # callers' head merge back to (B, Sq, H*Dh) is then free.
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    err = lib.flash_attention_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
        _strides(q, k, v, out), b, h, sq, sk, d, scale,
        _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on_error(err, lib.attention_error_string, "flash_attention")
    _count(flash_attention, "launches")
    return out, lse


def _launch_flash_bwd(q, k, v, mask, scale: float, out, lse, d_out):
    """Kernel #4: (dq, dk, dv) from the forward's ``out`` and ``lse``."""
    from mae_clip_torch.ops._build import load_attention_bwd

    lib = load_attention_bwd()
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (out.shape != q.shape or out.dtype != q.dtype or out.stride(-1) != 1
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention backward: out and lse must be the "
                         "forward's")
    if d_out.stride(-1) != 1:
        d_out = d_out.contiguous()
    # empty_like keeps a dense input's strides: the gradient of a head-split
    # view lands in the layout of the tensor it was split from.
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty(3 * b * h * sq, dtype=torch.float32,
                          device=q.device)
    err = lib.flash_attention_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
        _ptr(d_out), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(scratch),
        _strides(q, k, v, d_out, dq, dk, dv, out), b, h, sq, sk, d, scale,
        _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on_error(err, lib.attention_bwd_error_string,
                    "flash_attention backward")
    _count(flash_attention, "bwd_launches")
    return dq, dk, dv


def _launch_packed(qkv, mask, n_heads: int, scale: float,
                   with_lse: bool = False):
    """(out, lse): kernel #1, with the row log-sum-exp (B*H, S) in fp32
    when ``with_lse`` (the training path), else None."""
    from mae_clip_torch.ops._build import load_attention

    lib = load_attention()
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    out = torch.empty((b, s, n_heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * n_heads, s), dtype=torch.float32,
                      device=qkv.device) if with_lse else None
    err = lib.qkv_packed_attention_fwd(
        _ptr(qkv), _ptr(mask), _ptr(out), _ptr(lse), b, s, n_heads, d, scale,
        _DTYPE_CODES[qkv.dtype], _stream(qkv))
    _raise_on_error(err, lib.attention_error_string, "qkv_packed_attention")
    _count(qkv_packed_attention, "launches")
    return out, lse


def _launch_packed_bwd(qkv, mask, n_heads: int, scale: float, out, lse,
                       d_out) -> torch.Tensor:
    """Kernel #3: d_qkv from the forward's ``out`` and ``lse``."""
    from mae_clip_torch.ops._build import load_attention_bwd

    lib = load_attention_bwd()
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    if (out.shape != (b, s, three_hd // 3) or lse.shape != (b * n_heads, s)
            or out.dtype != qkv.dtype or lse.dtype != torch.float32
            or not (out.is_contiguous() and lse.is_contiguous())):
        raise ValueError("qkv_packed_attention backward: out and lse must be "
                         "the forward's, contiguous")
    d_out = d_out.contiguous()
    d_qkv = torch.empty_like(qkv)
    scratch = torch.empty(3 * b * n_heads * s, dtype=torch.float32,
                          device=qkv.device)
    err = lib.qkv_packed_attention_bwd(
        _ptr(qkv), _ptr(mask), _ptr(out), _ptr(lse), _ptr(d_out),
        _ptr(d_qkv), _ptr(scratch), b, s, n_heads, d, scale,
        _DTYPE_CODES[qkv.dtype], _stream(qkv))
    _raise_on_error(err, lib.attention_bwd_error_string,
                    "qkv_packed_attention backward")
    _count(qkv_packed_attention, "bwd_launches")
    return d_qkv


class _FlashAttention(torch.autograd.Function):
    """Kernels #2 (forward) and #4 (backward); plain versions on the CPU.
    On the card the forward writes the row log-sum-exp when q, k or v needs
    a gradient and saves it with its output for #4."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, key_valid)
            return flash_attention_ref(q, k, v, key_valid, scale)
        out, lse = _launch_flash(q, k, v, key_valid, scale,
                                 with_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, key_valid, *saved = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bwd_ref(q, k, v, key_valid, ctx.scale,
                                            d_out)
        else:
            grads = _launch_flash_bwd(q, k, v, key_valid, ctx.scale, *saved,
                                      d_out)
        return (*grads, None, None)


class _PackedAttention(torch.autograd.Function):
    """Kernels #1 (forward) and #3 (backward); plain versions on the CPU.
    On the card the forward writes the row log-sum-exp when qkv needs a
    gradient and saves it with its output for #3."""

    @staticmethod
    def forward(ctx, qkv, key_valid, n_heads, scale):
        ctx.n_heads, ctx.scale = n_heads, scale
        if qkv.device.type == "cpu":
            ctx.save_for_backward(qkv, key_valid)
            return qkv_packed_attention_ref(qkv, key_valid, n_heads, scale)
        out, lse = _launch_packed(qkv, key_valid, n_heads, scale,
                                  with_lse=ctx.needs_input_grad[0])
        ctx.save_for_backward(qkv, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        qkv, key_valid, *saved = ctx.saved_tensors
        if qkv.device.type == "cpu":
            d_qkv = qkv_packed_attention_bwd_ref(qkv, key_valid, ctx.n_heads,
                                                 ctx.scale, d_out)
        else:
            d_qkv = _launch_packed_bwd(qkv, key_valid, ctx.n_heads,
                                       ctx.scale, *saved, d_out)
        return d_qkv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention. q (B, H, Sq, Dh), k/v (B, H, Sk, Dh), key_valid
    (B, Sk) or None. CUDA inputs may be any strided views whose last dim is
    contiguous (the head split of a linear output needs no copy)."""
    scale = _scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return _FlashAttention.apply(q, k, v, key_valid, scale)
    _check_cuda("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (k.shape != (b, h, sk, d) or v.shape != k.shape or d > MAX_HEAD_DIM
            or sq == 0 or sk == 0):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"(Dh <= {MAX_HEAD_DIM}, S > 0)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim must be contiguous")
    mask = _mask_arg(key_valid, b, sk, q.device)
    return _FlashAttention.apply(q, k, v, mask, scale)


flash_attention.launches = 0
flash_attention.bwd_launches = 0


def qkv_packed_attention(qkv: torch.Tensor,
                         key_valid: Optional[torch.Tensor],
                         n_heads: int,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention straight from the packed (B, S, 3*H*Dh) qkv tensor; returns
    the head-concatenated (B, S, H*Dh) context."""
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    scale = _scale(d, sm_scale)
    if qkv.device.type == "cpu":
        return _PackedAttention.apply(qkv, key_valid, n_heads, scale)
    _check_cuda("qkv_packed_attention", qkv)
    if three_hd != 3 * n_heads * d or d > MAX_HEAD_DIM or s == 0:
        raise ValueError(f"qkv_packed_attention: bad shape {tuple(qkv.shape)} "
                         f"for {n_heads} heads (Dh <= {MAX_HEAD_DIM})")
    if not qkv.is_contiguous():
        raise ValueError("qkv_packed_attention: qkv must be contiguous")
    mask = _mask_arg(key_valid, b, s, qkv.device)
    return _PackedAttention.apply(qkv, mask, n_heads, scale)


qkv_packed_attention.launches = 0
qkv_packed_attention.bwd_launches = 0


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

def fused_qkv_attention(qkv: torch.Tensor, n_heads: int,
                        key_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a packed (B, S, 3*H*Dh) qkv tensor -> (B, S, H*Dh)."""
    return qkv_packed_attention(qkv, key_valid, n_heads, sm_scale)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_valid: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None,
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Attention over separate q/k/v (B, H, S, Dh) -> (B, H, Sq, Dh): the
    flash kernel, or ``attention_ref`` with dropout when ``dropout_rate >
    0``."""
    if dropout_rate > 0.0:
        return attention_ref(q, k, v, key_valid, sm_scale, dropout_rate)
    return flash_attention(q, k, v, key_valid, sm_scale)
