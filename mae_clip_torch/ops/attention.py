"""Multi-head attention: plain PyTorch versions and the CUDA kernel wrappers.

Counterpart of ``mae_clip_tpu/ops/attention.py``. Layouts follow the JAX
package at every public function: q/k/v ``(B, H, S, Dh)`` with a ``(B, Sk)``
key mask, or the packed ``(B, S, 3*H*Dh)`` output of a fused qkv matmul
(columns ordered as ``reshape(B, S, 3, H, Dh)``).

* ``attention_ref``: HF DistilBERT masking semantics (invalid-key scores
  replaced by ``finfo(float32).min``, softmax in fp32).
* ``flash_attention_ref`` / ``qkv_packed_attention_ref``: the plain versions
  of the two kernels, with the kernels' own semantics (masked keys at
  ``-0.7 * f32max``, normaliser floored at ``1e-30``, fp32 softmax).
* ``flash_attention`` / ``qkv_packed_attention``: the kernel wrappers. On a
  CPU tensor they run their plain version; on a CUDA tensor they launch the
  hand-written kernel of ``csrc/attention_fwd.cu`` or raise. Each keeps a
  count of its kernel launches in ``<wrapper>.launches``.
* ``fused_qkv_attention`` / ``multi_head_attention``: the dispatchers the
  models call. There is no ``impl`` switch: the device of the input decides.

The kernels are forward only. Their backward kernels (the JAX package's
``_qkv_bwd_kernel`` and ``_flash_bwd_kernel``) are not ported yet, so a
backward pass through a kernel wrapper raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()  # serving threads launch concurrently


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """HF DistilBERT attention: q scaled before the product, invalid-key
    scores replaced by the fp32 minimum, softmax in fp32."""
    scale = _scale(q.shape[-1], sm_scale)
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid.bool()[:, None, None, :],
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash kernel: q/k/v (B, H, S, Dh) -> (B, H, Sq, Dh)."""
    scale = _scale(q.shape[-1], sm_scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :] > 0, s,
                        torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


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


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _launch_flash(q, k, v, mask, scale: float) -> torch.Tensor:
    from mae_clip_torch.ops._build import load_attention

    lib = load_attention()
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # Allocated (B, Sq, H, Dh) and returned as a (B, H, Sq, Dh) view: the
    # callers' head merge back to (B, Sq, H*Dh) is then free.
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = lib.flash_attention_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), strides,
        b, h, sq, sk, d, scale, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, err, "flash_attention")
    with _COUNT_LOCK:
        flash_attention.launches += 1
    return out


def _launch_packed(qkv, mask, n_heads: int, scale: float) -> torch.Tensor:
    from mae_clip_torch.ops._build import load_attention

    lib = load_attention()
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    out = torch.empty((b, s, n_heads * d), dtype=qkv.dtype, device=qkv.device)
    err = lib.qkv_packed_attention_fwd(
        _ptr(qkv), _ptr(mask), _ptr(out), b, s, n_heads, d, scale,
        _DTYPE_CODES[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on_error(lib, err, "qkv_packed_attention")
    with _COUNT_LOCK:
        qkv_packed_attention.launches += 1
    return out


class _FlashFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        return _launch_flash(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention backward kernel is not ported yet")


class _PackedFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, n_heads, scale):
        return _launch_packed(qkv, mask, n_heads, scale)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "qkv_packed_attention backward kernel is not ported yet")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention forward. q (B, H, Sq, Dh), k/v (B, H, Sk, Dh),
    key_valid (B, Sk) or None. CUDA inputs may be any strided views whose
    last dim is contiguous (the head split of a linear output needs no copy)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, key_valid, sm_scale)
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
    return _FlashFwd.apply(q, k, v, mask, _scale(d, sm_scale))


flash_attention.launches = 0


def qkv_packed_attention(qkv: torch.Tensor,
                         key_valid: Optional[torch.Tensor],
                         n_heads: int,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention straight from the packed (B, S, 3*H*Dh) qkv tensor; returns
    the head-concatenated (B, S, H*Dh) context."""
    if qkv.device.type == "cpu":
        return qkv_packed_attention_ref(qkv, key_valid, n_heads, sm_scale)
    _check_cuda("qkv_packed_attention", qkv)
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * n_heads)
    if three_hd != 3 * n_heads * d or d > MAX_HEAD_DIM or s == 0:
        raise ValueError(f"qkv_packed_attention: bad shape {tuple(qkv.shape)} "
                         f"for {n_heads} heads (Dh <= {MAX_HEAD_DIM})")
    if not qkv.is_contiguous():
        raise ValueError("qkv_packed_attention: qkv must be contiguous")
    mask = _mask_arg(key_valid, b, s, qkv.device)
    return _PackedFwd.apply(qkv, mask, n_heads, _scale(d, sm_scale))


qkv_packed_attention.launches = 0


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
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over separate q/k/v (B, H, S, Dh) -> (B, H, Sq, Dh)."""
    return flash_attention(q, k, v, key_valid, sm_scale)
