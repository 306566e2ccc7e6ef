"""Fused transformer block stacks: plain PyTorch versions and the CUDA kernel
wrappers (``mae_clip_tpu/ops/block_kernel.py``).

A stack of L pre-LN blocks (LN -> q/kv projections -> softmax attention ->
output projection + residual -> LN -> fc1 -> GELU -> fc2 + residual), in
self-attention form (the ViT encoder: pass ``kv = q0`` with
``cross=False``) or cross-attention form (the CrossMAE decoder: queries
``q0`` attend ``kv``). The stacked weights ``w`` hold the 16 tensors of
``W_KEYS``, each with a leading block dimension L, in torch's ``(out, in)``
layout: wq (L, D, D), wkv (L, 2D, D) with the k rows first and the v rows
after (head-major within each), wproj (L, D, D), wfc1 (L, F, D), wfc2
(L, D, F), biases and LayerNorm parameters (L, X). (The JAX package keeps
its kernels ``(in, out)``; ``interop.from_jax.block_stack_weights_from_jax``
converts.) For self-attention the lnkv slots are filled with ln1 and
ignored.

* ``fused_block_stack_ref`` / ``fused_block_stack_bwd_ref``: the plain
  versions of kernels #6 and #7, written step for step after the TPU
  kernels: LayerNorm with fp32 statistics (eps 1e-6) and its output in the
  compute dtype; each projection an fp32 product plus the fp32 bias, rounded
  once; P computed in one shot in fp32 over the keys, normalised, then
  rounded before P.V; residual adds in the compute dtype; GELU in fp32
  (tanh with JAX's constants, or erf), then rounded. The backward is the
  explicit math of the TPU kernel, not autograd: dq carried between blocks
  in ``dout``'s dtype, dkv summed over the blocks and rounded to its dtype
  after each, weight gradients summed in fp32 over the whole batch and then
  cast to the weights' dtype, zero lnkv gradients and dkv in self mode.
* The training state. The TPU kernel's backward recomputes each block from
  its input, the one thing its forward keeps (``qstack``). On the card #6
  keeps, when a gradient is wanted, each block's activations and row
  statistics too (``STATE_KEYS``: h, kvh, qp, kvp, ctx, x1, h2, a1, a2 in
  the compute dtype; the attention's row log-sum-exp and the LayerNorms'
  row mean and rstd in fp32), in one uint8 buffer laid out by
  ``csrc/block_common.cuh`` (1.77 GB for the flagship encoder's 12 blocks
  and 1.08 GB for the CrossMAE decoder's 4, at B=256 in bf16), and #7 reads
  it and recomputes nothing. ``state_views`` shows that buffer as the plain
  versions' state: one dict of ``STATE_KEYS`` per block, which
  ``fused_block_stack_ref(..., keep_state=True)`` also returns and
  ``fused_block_stack_bwd_ref(..., state=...)`` reads (without one it
  recomputes, as the TPU kernel does).
* ``fused_block_stack``: a ``torch.autograd.Function`` with kernel #6
  forward and kernel #7 backward (``csrc/block_stack_fwd.cu``,
  ``csrc/block_stack_bwd.cu``); the state is kept, and saved for the
  backward, only where grad mode is on and an input needs a gradient.
  ``fused_block_stack_fwd_plain_bwd``: #6 forward with no state, then a
  per-block recompute backward through torch.autograd of ``_plain_block``
  from each block's saved input, as the JAX package's
  ``fused_block_stack_fwd_xla_bwd``. On a CPU tensor both take the plain
  versions; on a CUDA tensor they launch the kernels or raise (also for
  heads wider than ``MAX_HEAD_DIM``: the kernels run the attention bodies
  of ``ops/attention.py``'s kernels, which stop there; and for #7 without
  #6's state). Launches are counted in ``fused_block_stack.launches`` (#6,
  from either wrapper) and ``fused_block_stack.bwd_launches`` (#7), one per
  stack, and the state buffers #6's wrapper allocates in
  ``fused_block_stack.state_allocs``.
* ``gemm_body`` / ``gemm_body_ref``: one product of the GEMM body that #6
  and #7 run for every bf16 product (``csrc/block_common.cuh``: TMA loads,
  wgmma, a persistent grid), alone, for each (layout, epilogue) pair the
  stacks launch (``GEMM_PAIRS``), and its plain version; for checking each
  template on the card. The stacks call the body from C.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from mae_clip_torch.ops.attention import (_DTYPE_CODES, MAX_HEAD_DIM,
                                          _count, _ptr, _raise_on_error,
                                          _stream)

W_KEYS = ("ln1_g", "ln1_b", "lnkv_g", "lnkv_b", "wq", "bq", "wkv", "bkv",
          "wproj", "bproj", "ln2_g", "ln2_b", "wfc1", "bfc1", "wfc2",
          "bfc2")
LN_EPS = 1e-6
GELU_C = 0.7978845608028654        # sqrt(2/pi), jax.nn.gelu(approximate=True)
GELU_A = 0.044715
_GELU_CODES = {"tanh": 0, "erf": 1}
# What #6 keeps of each block for #7, in csrc/block_common.cuh's order (State):
# activations in the compute dtype, then fp32 row statistics.
STATE_KEYS = ("h", "kvh", "qp", "kvp", "ctx", "x1", "h2", "a1", "a2", "lse",
              "mean1", "rstd1", "mean2", "rstd2", "meankv", "rstdkv")

Weights = Dict[str, torch.Tensor]
State = List[Dict[str, Optional[torch.Tensor]]]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """fp32-stat LayerNorm: (y in x's dtype, mean, rstd), the statistics
    fp32 (..., 1)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    return ((xc * rstd) * g.float() + b.float()).to(x.dtype), mu, rstd


def _xhat(x: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor):
    """x normalised by its saved row statistics, as ``_ln`` normalises."""
    return (x.float() - mu) * rstd


def _ln_bwd(dy, xhat, rstd, g):
    """dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)), dyg = dy*g."""
    dyg = dy * g.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    return rstd * (dyg - m1 - xhat * m2)


def _gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "tanh":
        return 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + GELU_A * x ** 3)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _gelu_grad(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "tanh":
        t = torch.tanh(GELU_C * (x + GELU_A * x ** 3))
        dinner = GELU_C * (1.0 + 3.0 * GELU_A * x * x)
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner
    cdf = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    return cdf + x * torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2 * math.pi))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T in fp32: rows of ``a`` through a (out, in) weight."""
    return torch.matmul(a.float(), w.float().t())


def _mm_back(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy @ w in fp32: the input gradient of a (out, in) weight."""
    return torch.matmul(dy.float(), w.float())


def _proj(a, w, b, dtype):
    return (_mm(a, w) + b.float()).to(dtype)


def _dweight(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum over rows of dy^T x in fp32: the (out, in) weight gradient."""
    return torch.matmul(dy.reshape(-1, dy.shape[-1]).float().t(),
                        x.reshape(-1, x.shape[-1]).float())


def _colsum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).float().sum(0)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2).float()


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _softmax(qp, kvp, n_heads: int):
    """The single-shot softmax over the keys per sample and head, on packed
    projections qp (B, Sq, D), kvp (B, Sk, 2D) with k columns then v
    columns: the fp32 probabilities (B, H, Sq, Sk) and the row log-sum-exp
    (B, H, Sq)."""
    d = qp.shape[-1]
    scale = 1.0 / float(d // n_heads) ** 0.5
    q, k = _heads(qp, n_heads), _heads(kvp[..., :d], n_heads)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    total = e.sum(-1, keepdim=True)
    return e / total, (m + torch.log(total)).squeeze(-1)


def _attention(qp, kvp, n_heads: int):
    """Softmax attention per sample on packed projections (``_softmax``):
    ctx (B, Sq, D) in qp's dtype and the fp32 row log-sum-exp (B, H, Sq)."""
    p, lse = _softmax(qp, kvp, n_heads)
    v = _heads(kvp[..., qp.shape[-1]:], n_heads)
    ctx = torch.matmul(p.to(qp.dtype).float(), v).to(qp.dtype)
    return _merge(ctx), lse


def _attention_bwd(qp, kvp, p, dctx, n_heads: int, ctx=None):
    """dqp (B, Sq, D) and dkvp (B, Sk, 2D), fp32, for the context gradient
    ``dctx`` in the compute dtype: dV = round(P)^T dO, dP = dO V^T,
    dS = round(P * (dP - rowsum(P * dP))), dq = dS K * scale,
    dk = dS^T Q * scale. Given the forward's ``ctx``, rowsum(P * dP) is
    taken as rowsum(dO * ctx) instead, as kernel #7 takes it (equal in
    exact arithmetic; ctx is rounded to the compute dtype)."""
    d = qp.shape[-1]
    scale = 1.0 / float(d // n_heads) ** 0.5
    q = _heads(qp, n_heads)
    k, v = _heads(kvp[..., :d], n_heads), _heads(kvp[..., d:], n_heads)
    do = _heads(dctx, n_heads)
    dv = torch.matmul(p.to(qp.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if ctx is None:
        delta = (p * dp).sum(-1, keepdim=True)
    else:
        delta = (do * _heads(ctx, n_heads)).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(qp.dtype).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return _merge(dq), torch.cat([_merge(dk), _merge(dv)], dim=-1)


def _block(x, kv, wl: Weights, n_heads: int, gelu: str, cross: bool):
    """One block of the stack with the kernels' roundings: its output and
    its state, the ``STATE_KEYS`` (kvh, meankv and rstdkv None in self
    mode)."""
    dt = x.dtype
    h, mean1, rstd1 = _ln(x, wl["ln1_g"], wl["ln1_b"])
    kvh, meankv, rstdkv = (_ln(kv, wl["lnkv_g"], wl["lnkv_b"]) if cross
                           else (None, None, None))
    qp = _proj(h, wl["wq"], wl["bq"], dt)
    kvp = _proj(kvh if cross else h, wl["wkv"], wl["bkv"], dt)
    ctx, lse = _attention(qp, kvp, n_heads)
    x1 = x + _proj(ctx, wl["wproj"], wl["bproj"], dt)
    h2, mean2, rstd2 = _ln(x1, wl["ln2_g"], wl["ln2_b"])
    a1 = _proj(h2, wl["wfc1"], wl["bfc1"], dt)
    a2 = _gelu(a1.float(), gelu).to(dt)
    out = x1 + _proj(a2, wl["wfc2"], wl["bfc2"], dt)
    return out, dict(h=h, kvh=kvh, qp=qp, kvp=kvp, ctx=ctx, x1=x1, h2=h2,
                     a1=a1, a2=a2, lse=lse, mean1=mean1, rstd1=rstd1,
                     mean2=mean2, rstd2=rstd2, meankv=meankv, rstdkv=rstdkv)


def _block_weights(w: Weights, l: int) -> Weights:
    return {k: v[l] for k, v in w.items()}


def fused_block_stack_ref(q0: torch.Tensor, kv: torch.Tensor, w: Weights,
                          n_heads: int, gelu: str = "tanh",
                          cross: bool = True, keep_state: bool = False):
    """Plain version of kernel #6: (out (B, Sq, D), qstack (L, B, Sq, D)),
    qstack[l] the input of block l; with ``keep_state`` also the state of
    every block, one dict of ``STATE_KEYS`` each."""
    x, inputs, state = q0, [], []
    for l in range(w["wq"].shape[0]):
        inputs.append(x)
        x, st = _block(x, kv, _block_weights(w, l), n_heads, gelu, cross)
        if keep_state:
            state.append(st)
    if keep_state:
        return x, torch.stack(inputs), state
    return x, torch.stack(inputs)


def fused_block_stack_bwd_ref(qstack: torch.Tensor, kv: torch.Tensor,
                              w: Weights, dout: torch.Tensor, n_heads: int,
                              gelu: str = "tanh", cross: bool = True,
                              delta_from_ctx: bool = False,
                              state: Optional[State] = None):
    """Plain version of kernel #7: (dq0, dkv, dw) for the output gradient
    ``dout``, walking the blocks in reverse from their saved inputs and the
    forward's ``state`` (``fused_block_stack_ref(..., keep_state=True)``'s,
    or ``state_views`` of #6's buffer), or, with none, from each block
    recomputed from its input as the TPU kernel does: the same values. P is
    taken from the state's qp and kvp by the forward's softmax (#7 takes it
    from the saved log-sum-exp). The attention backward's row sum is the
    TPU kernel's rowsum(P * dP), or with ``delta_from_ctx`` the kernel's own
    rowsum(dO * ctx)."""
    n_blocks, dt = w["wq"].shape[0], qstack.dtype
    dq, dkv, dws = dout, None, [None] * n_blocks
    for l in reversed(range(n_blocks)):
        wl = _block_weights(w, l)
        f = (state[l] if state is not None else
             _block(qstack[l], kv, wl, n_heads, gelu, cross)[1])
        kvh = f["kvh"] if cross else f["h"]
        xhat1 = _xhat(qstack[l], f["mean1"], f["rstd1"])
        xhat2 = _xhat(f["x1"], f["mean2"], f["rstd2"])
        p, _ = _softmax(f["qp"], f["kvp"], n_heads)
        dqo = dq.float()
        da1 = _mm_back(dq.to(dt), wl["wfc2"]) * _gelu_grad(f["a1"].float(),
                                                           gelu)
        dh2 = _mm_back(da1.to(dt), wl["wfc1"])
        dx1 = dqo + _ln_bwd(dh2, xhat2, f["rstd2"], wl["ln2_g"])
        dctx = _mm_back(dx1.to(dt), wl["wproj"]).to(dt)
        dqp, dkvp = _attention_bwd(f["qp"], f["kvp"], p, dctx, n_heads,
                                   f["ctx"] if delta_from_ctx else None)
        dh = _mm_back(dqp.to(dt), wl["wq"])
        dkvh = _mm_back(dkvp.to(dt), wl["wkv"])
        if cross:
            xhatkv = _xhat(kv, f["meankv"], f["rstdkv"])
            dkv_l = _ln_bwd(dkvh, xhatkv, f["rstdkv"], wl["lnkv_g"])
            dkv = (dkv_l if dkv is None else dkv.float() + dkv_l).to(
                dout.dtype)
            lnkv = (_colsum(dkvh * xhatkv), _colsum(dkvh))
        else:
            dh = dh + dkvh
            zero = torch.zeros_like(wl["lnkv_g"], dtype=torch.float32)
            lnkv = (zero, zero)
        dx = dx1 + _ln_bwd(dh, xhat1, f["rstd1"], wl["ln1_g"])
        grads = {
            "ln1_g": _colsum(dh * xhat1), "ln1_b": _colsum(dh),
            "lnkv_g": lnkv[0], "lnkv_b": lnkv[1],
            "wq": _dweight(dqp.to(dt), f["h"]), "bq": _colsum(dqp),
            "wkv": _dweight(dkvp.to(dt), kvh), "bkv": _colsum(dkvp),
            "wproj": _dweight(dx1.to(dt), f["ctx"]), "bproj": _colsum(dx1),
            "ln2_g": _colsum(dh2 * xhat2), "ln2_b": _colsum(dh2),
            "wfc1": _dweight(da1.to(dt), f["h2"]), "bfc1": _colsum(da1),
            "wfc2": _dweight(dq.to(dt), f["a2"]), "bfc2": _colsum(dqo)}
        dws[l] = {k: v.to(w[k].dtype) for k, v in grads.items()}
        dq = dx.to(dout.dtype)
    dw = {k: torch.stack([dws[l][k] for l in range(n_blocks)])
          for k in W_KEYS}
    if not cross:
        dkv = torch.zeros_like(dout if kv is None else kv)
    return dq, dkv, dw


def _plain_block(x, kv, wl: Weights, n_heads: int, gelu: str, cross: bool):
    """One block in plain torch ops (the JAX package's ``_xla_block``): the
    recompute of ``fused_block_stack_fwd_plain_bwd``'s backward. fp32 LN
    statistics and softmax, each matmul rounded to the compute dtype before
    its bias is added, as JAX's per-op evaluation rounds."""
    def ln(y, g, b):
        return _ln(y, g, b)[0]

    d = x.shape[-1]
    dh = d // n_heads
    h = ln(x, wl["ln1_g"], wl["ln1_b"])
    kvh = ln(kv, wl["lnkv_g"], wl["lnkv_b"]) if cross else h
    qp = torch.matmul(h, wl["wq"].t()) + wl["bq"]
    kvp = torch.matmul(kvh, wl["wkv"].t()) + wl["bkv"]
    b, sq, _ = qp.shape
    sk = kvp.shape[1]
    q = qp.reshape(b, sq, n_heads, dh).transpose(1, 2)
    k = kvp[..., :d].reshape(b, sk, n_heads, dh).transpose(1, 2)
    v = kvp[..., d:].reshape(b, sk, n_heads, dh).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    p = torch.softmax(s.float(), -1).to(q.dtype)
    ctx = torch.matmul(p, v).transpose(1, 2).reshape(b, sq, d)
    x = x + torch.matmul(ctx, wl["wproj"].t()) + wl["bproj"]
    h2 = ln(x, wl["ln2_g"], wl["ln2_b"])
    a = F.gelu(torch.matmul(h2, wl["wfc1"].t()) + wl["bfc1"],
               approximate="tanh" if gelu == "tanh" else "none")
    return x + torch.matmul(a, wl["wfc2"].t()) + wl["bfc2"]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(name: str, q0, kv, w: Weights, n_heads: int, gelu: str,
                  cross: bool) -> None:
    if set(w) != set(W_KEYS):
        raise KeyError(f"{name}: weights must hold {W_KEYS}, got {sorted(w)}")
    if gelu not in _GELU_CODES:
        raise ValueError(f"{name}: unknown gelu {gelu!r}")
    b, sq, d = q0.shape
    n_blocks, f = w["wq"].shape[0], w["wfc1"].shape[1]
    if d % n_heads or sq == 0 or n_blocks == 0:
        raise ValueError(f"{name}: bad shape {tuple(q0.shape)} for "
                         f"{n_heads} heads and {n_blocks} blocks")
    if cross and (kv.dim() != 3 or kv.shape[0] != b or kv.shape[2] != d
                  or kv.shape[1] == 0):
        raise ValueError(f"{name}: kv {tuple(kv.shape)} does not match q0 "
                         f"{tuple(q0.shape)}")
    shapes = {"wq": (d, d), "bq": (d,), "wkv": (2 * d, d), "bkv": (2 * d,),
              "wproj": (d, d), "bproj": (d,), "wfc1": (f, d), "bfc1": (f,),
              "wfc2": (d, f), "bfc2": (d,)}
    for k in W_KEYS:
        want = (n_blocks,) + shapes.get(k, (d,))
        if tuple(w[k].shape) != want:
            raise ValueError(f"{name}: {k} has shape {tuple(w[k].shape)}, "
                             f"expected {want}")
    if q0.device.type == "cpu":
        return
    tensors = [q0] + ([kv] if cross else []) + [w[k] for k in W_KEYS]
    if any(t.device != q0.device for t in tensors) or \
            q0.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device")
    if q0.dtype not in _DTYPE_CODES or any(t.dtype != q0.dtype
                                           for t in tensors):
        raise TypeError(f"{name}: q0, kv and the weights must share one "
                        "dtype, float32 or bfloat16; got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if d // n_heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: heads of {d // n_heads} on the card; the "
                         f"attention bodies take Dh <= {MAX_HEAD_DIM}")


def _weight_ptrs(w: Weights):
    return (ctypes.c_void_p * len(W_KEYS))(*[_ptr(w[k]) for k in W_KEYS])


def _shape(x: torch.Tensor, kv, w: Weights, n_heads: int, cross: bool):
    """(B, Sq, Sk, D, H, F, L, cross, dtype code) as the C entries take
    them, for q0 (B, Sq, D) or qstack (L, B, Sq, D)."""
    *_, b, sq, d = x.shape
    return (b, sq, kv.shape[1] if cross else sq, d, n_heads,
            w["wfc1"].shape[1], w["wq"].shape[0], int(cross),
            _DTYPE_CODES[x.dtype])


def _state_layout(shape) -> Tuple[int, list]:
    """(bytes of #6's state buffer, [the offset of each of ``STATE_KEYS``
    within a block's slice, or -1, then the slice's size])."""
    from mae_clip_torch.ops._build import load_block_stack_fwd

    offsets = (ctypes.c_longlong * (len(STATE_KEYS) + 1))()
    size = load_block_stack_fwd().block_stack_fwd_state(*shape, offsets)
    return size, list(offsets)


def _launch_fwd(q0, kv, w: Weights, n_heads: int, gelu: str, cross: bool,
                keep_state: bool = False):
    """Kernel #6: (out, qstack), and with ``keep_state`` also the uint8
    state buffer that #7 reads."""
    from mae_clip_torch.ops._build import load_block_stack_fwd

    lib = load_block_stack_fwd()
    q0 = q0.contiguous()
    kv = kv.contiguous() if cross else None
    w = {k: v.contiguous() for k, v in w.items()}
    shape = _shape(q0, kv, w, n_heads, cross)
    b, sq, sk, d, _, f, n_blocks, _, dtype = shape
    out = torch.empty_like(q0)
    qstack = torch.empty((n_blocks, b, sq, d), dtype=q0.dtype,
                         device=q0.device)
    work = state = None
    if keep_state:
        state = torch.empty(_state_layout(shape)[0], dtype=torch.uint8,
                            device=q0.device)
        _count(fused_block_stack, "state_allocs")
    else:
        work = torch.empty(lib.block_stack_fwd_workspace(b, sq, sk, d, f,
                                                         int(cross), dtype),
                           dtype=torch.uint8, device=q0.device)
    err = lib.block_stack_fwd(
        _ptr(q0), _ptr(kv), _weight_ptrs(w), _ptr(out), _ptr(qstack),
        _ptr(work), _ptr(state), b, sq, sk, d, n_heads, f, n_blocks,
        _GELU_CODES[gelu], int(cross), dtype, _stream(q0))
    _raise_on_error(err, lib.block_stack_error_string, "fused_block_stack")
    _count(fused_block_stack, "launches")
    return (out, qstack, state) if keep_state else (out, qstack)


def state_views(state: torch.Tensor, qstack: torch.Tensor, kv, w: Weights,
                n_heads: int, cross: bool) -> State:
    """#6's state buffer as the plain versions' state: per block a dict of
    ``STATE_KEYS``, views into the buffer (h, qp, ctx, x1, h2 (B, Sq, D),
    kvh (B, Sk, D), kvp (B, Sk, 2D), a1, a2 (B, Sq, F), lse (B, H, Sq),
    the row statistics (B, Sq, 1) and (B, Sk, 1); None where absent)."""
    shape = _shape(qstack, kv, w, n_heads, cross)
    b, sq, sk, d, _, f, n_blocks, _, _ = shape
    size, offsets = _state_layout(shape)
    if state.dtype != torch.uint8 or state.numel() != size:
        raise ValueError(f"state_views: a uint8 buffer of {size} bytes "
                         f"expected, got {state.numel()} of {state.dtype}")
    rows, krows = (b, sq), (b, sk)
    shapes = dict(h=rows + (d,), kvh=krows + (d,), qp=rows + (d,),
                  kvp=krows + (2 * d,), ctx=rows + (d,), x1=rows + (d,),
                  h2=rows + (d,), a1=rows + (f,), a2=rows + (f,),
                  lse=(b, n_heads, sq), mean1=rows + (1,),
                  rstd1=rows + (1,), mean2=rows + (1,), rstd2=rows + (1,),
                  meankv=krows + (1,), rstdkv=krows + (1,))
    views = []
    for l in range(n_blocks):
        block = {}
        for i, k in enumerate(STATE_KEYS):
            if offsets[i] < 0:
                block[k] = None
                continue
            dt = (qstack.dtype if i < STATE_KEYS.index("lse")
                  else torch.float32)
            start = l * offsets[-1] + offsets[i]
            n = math.prod(shapes[k]) * dt.itemsize
            block[k] = state[start:start + n].view(dt).view(shapes[k])
        views.append(block)
    return views


def _launch_bwd(qstack, kv, w: Weights, dout, state, n_heads: int,
                gelu: str, cross: bool):
    """Kernel #7 from #6's ``qstack`` and state buffer."""
    from mae_clip_torch.ops._build import load_block_stack_bwd

    lib = load_block_stack_bwd()
    kv = kv.contiguous() if cross else None
    dout = dout.to(qstack.dtype).contiguous()
    w = {k: v.contiguous() for k, v in w.items()}
    shape = _shape(qstack, kv, w, n_heads, cross)
    b, sq, sk, d, _, f, n_blocks, _, dtype = shape
    size = _state_layout(shape)[0]
    if not (isinstance(state, torch.Tensor) and state.dtype == torch.uint8
            and state.device == qstack.device and state.numel() == size
            and state.is_contiguous()):
        got = (f"{state.numel()} bytes of {state.dtype} on {state.device}"
               if isinstance(state, torch.Tensor) else repr(type(state)))
        raise ValueError(
            "fused_block_stack backward: kernel #7 reads the state that "
            f"kernel #6 keeps for it (_launch_fwd(..., keep_state=True): "
            f"{size} bytes of uint8 on {qstack.device}); got {got}")
    dq0 = torch.empty_like(dout)
    dkv = torch.empty_like(kv) if cross else None
    dw = {k: torch.empty_like(v) for k, v in w.items()}
    work = torch.empty(lib.block_stack_bwd_workspace(b, sq, sk, d, n_heads,
                                                     f, int(cross), dtype),
                       dtype=torch.uint8, device=qstack.device)
    err = lib.block_stack_bwd(
        _ptr(qstack), _ptr(kv), _weight_ptrs(w), _ptr(state), _ptr(dout),
        _ptr(dq0), _ptr(dkv), _weight_ptrs(dw), _ptr(work), b, sq, sk, d,
        n_heads, f, n_blocks, _GELU_CODES[gelu], int(cross), dtype,
        _stream(qstack))
    _raise_on_error(err, lib.block_stack_bwd_error_string,
                    "fused_block_stack backward")
    _count(fused_block_stack, "bwd_launches")
    if not cross:
        dkv = torch.zeros_like(dout)
    return dq0, dkv, dw


def _stack_forward(q0, kv, w, n_heads, gelu, cross, keep_state=False):
    if q0.device.type == "cpu":
        return fused_block_stack_ref(q0, kv, w, n_heads, gelu, cross,
                                     keep_state)
    return _launch_fwd(q0, kv, w, n_heads, gelu, cross, keep_state)


def fused_block_stack_bwd(qstack, kv, w: Weights, dout, state, n_heads: int,
                          gelu: str = "tanh", cross: bool = True):
    """(dq0, dkv, dw) of the stack from the forward's ``qstack`` and state:
    kernel #7 on a CUDA tensor (#6's state buffer, which it needs), its
    plain version on a CPU one (the plain forward's state, or None to
    recompute)."""
    if qstack.device.type == "cpu":
        return fused_block_stack_bwd_ref(qstack, kv, w, dout, n_heads, gelu,
                                         cross, state=state)
    return _launch_bwd(qstack, kv, w, dout, state, n_heads, gelu, cross)


class _FusedBlockStack(torch.autograd.Function):
    """Kernels #6 (forward) and #7 (backward); plain versions on the CPU.
    Where a gradient is wanted (grad mode on, and an input needs one), the
    forward keeps each block's input (qstack) and its state and saves both;
    the backward reads them and recomputes nothing. Else no state is kept:
    the serving tower and evaluation allocate none."""

    @staticmethod
    def forward(ctx, q0, kv, n_heads, gelu, cross, grad_mode, *ws):
        w = dict(zip(W_KEYS, ws))
        if not (grad_mode and any(ctx.needs_input_grad)):
            return _stack_forward(q0, kv, w, n_heads, gelu, cross)[0]
        # keep_state goes positionally: tests wrap _stack_forward in *args.
        out, qstack, state = _stack_forward(q0, kv, w, n_heads, gelu, cross,
                                            True)
        leaves, ctx.state_spec = tree_flatten(state)
        ctx.save_for_backward(qstack, kv, *ws, *leaves)
        ctx.cfg = (n_heads, gelu, cross)
        return out

    @staticmethod
    def backward(ctx, dout):
        qstack, kv, *rest = ctx.saved_tensors
        ws, leaves = rest[:len(W_KEYS)], rest[len(W_KEYS):]
        n_heads, gelu, cross = ctx.cfg
        dq0, dkv, dw = fused_block_stack_bwd(
            qstack, kv, dict(zip(W_KEYS, ws)), dout,
            tree_unflatten(leaves, ctx.state_spec), n_heads, gelu, cross)
        return (dq0, dkv if cross else None, None, None, None, None,
                *[dw[k] for k in W_KEYS])


class _FusedBlockStackFwdPlainBwd(torch.autograd.Function):
    """Kernel #6 forward (no state kept); the backward recomputes each block
    in plain torch from its saved input and runs autograd through it, in
    reverse."""

    @staticmethod
    def forward(ctx, q0, kv, n_heads, gelu, cross, *ws):
        w = dict(zip(W_KEYS, ws))
        out, qstack = _stack_forward(q0, kv, w, n_heads, gelu, cross)
        ctx.save_for_backward(qstack, kv, *ws)
        ctx.cfg = (n_heads, gelu, cross)
        return out

    @staticmethod
    def backward(ctx, dout):
        qstack, kv, *ws = ctx.saved_tensors
        n_heads, gelu, cross = ctx.cfg
        dq, dkv, dws = dout, None, []
        for l in reversed(range(qstack.shape[0])):
            with torch.enable_grad():
                x = qstack[l].detach().requires_grad_()
                kv_l = kv.detach().requires_grad_() if cross else None
                wl = {k: v[l].detach().requires_grad_()
                      for k, v in zip(W_KEYS, ws)}
                out = _plain_block(x, kv_l, wl, n_heads, gelu, cross)
                leaves = [x] + ([kv_l] if cross else []) + list(wl.values())
                grads = torch.autograd.grad(out, leaves, dq,
                                            allow_unused=True)
            dq = grads[0]
            if cross:
                dkv = grads[1] if dkv is None else dkv + grads[1]
            dws.append({k: torch.zeros_like(wl[k]) if g is None else g
                        for k, g in zip(wl, grads[-len(wl):])})
        dws.reverse()
        return (dq, dkv, None, None, None,
                *[torch.stack([d[k] for d in dws]) for k in W_KEYS])


def fused_block_stack(q0: torch.Tensor, kv: Optional[torch.Tensor],
                      w: Weights, n_heads: int, gelu: str = "tanh",
                      cross: bool = True) -> torch.Tensor:
    """Run a stack of pre-LN blocks: q0 (B, Sq, D), kv (B, Sk, D) (ignored
    with ``cross=False``, where the gradient flows through q0 alone), the
    stacked weights ``w``; returns the last block's output (B, Sq, D)."""
    _check_inputs("fused_block_stack", q0, kv, w, n_heads, gelu, cross)
    return _FusedBlockStack.apply(q0, kv if cross else None, n_heads, gelu,
                                  cross, torch.is_grad_enabled(),
                                  *[w[k] for k in W_KEYS])


fused_block_stack.launches = 0
fused_block_stack.bwd_launches = 0
fused_block_stack.state_allocs = 0


def fused_block_stack_fwd_plain_bwd(q0: torch.Tensor,
                                    kv: Optional[torch.Tensor], w: Weights,
                                    n_heads: int, gelu: str = "tanh",
                                    cross: bool = True) -> torch.Tensor:
    """``fused_block_stack`` with kernel #6's forward and a per-block plain
    recompute backward (``fused_blocks='fwd'``)."""
    _check_inputs("fused_block_stack", q0, kv, w, n_heads, gelu, cross)
    return _FusedBlockStackFwdPlainBwd.apply(q0, kv if cross else None,
                                             n_heads, gelu, cross,
                                             *[w[k] for k in W_KEYS])


# ---------------------------------------------------------------------------
# The stacks' GEMM body alone
# ---------------------------------------------------------------------------

# block_common.cuh's EpiMode, in order.
GEMM_MODES = ("bias", "bias_res", "bias_gelu", "gelu_grad", "f32", "f32_add",
              "round", "partial")
# The (A layout, B layout, epilogue) products the stacks launch, and the
# kernel whose library instantiates each: #6 the forward products
# x (mk) . W^T (nk), #7 the input gradients dy (mk) . W (kn) and the weight
# gradients' split partials dy^T (km) . x (kn).
GEMM_PAIRS = {("mk", "nk", "bias"): "fwd", ("mk", "nk", "bias_res"): "fwd",
              ("mk", "nk", "bias_gelu"): "fwd",
              ("mk", "kn", "gelu_grad"): "bwd", ("mk", "kn", "f32"): "bwd",
              ("mk", "kn", "f32_add"): "bwd", ("mk", "kn", "round"): "bwd",
              ("km", "kn", "partial"): "bwd"}
# What each epilogue writes ("out" and "out2" in the compute dtype, "outf"
# fp32, (splits, M, N) for the partials).
GEMM_OUTPUTS = {"bias": ("out",), "bias_res": ("out",),
                "bias_gelu": ("out", "out2"), "gelu_grad": ("outf", "out"),
                "f32": ("outf",), "f32_add": ("outf",), "round": ("out",),
                "partial": ("outf",)}


def gemm_dims(a: torch.Tensor, b: torch.Tensor, a_km: bool,
              b_kn: bool) -> Tuple[int, int, int]:
    """(M, N, K) of a product whose A is stored (M, K), or (K, M) with
    ``a_km``, and whose B is stored (N, K), or (K, N) with ``b_kn``."""
    m, k = (a.shape[1], a.shape[0]) if a_km else a.shape
    n = b.shape[1] if b_kn else b.shape[0]
    return m, n, k


def gemm_k_chunk(k: int, splits: int) -> int:
    """The K extent of one split, as the body cuts K: ceil(K / splits)
    rounded up to a multiple of 64."""
    per_split = -(-k // splits)
    return -(-per_split // 64) * 64


def gemm_body_ref(a, b, mode: str, a_km: bool = False, b_kn: bool = False,
                  bias=None, res=None, aux=None, outf=None,
                  gelu: str = "tanh", splits: int = 1) -> Dict[str, Any]:
    """Plain version of one product of the stacks' GEMM body: the fp32
    product of ``a`` and ``b`` as stored (layouts as ``gemm_dims``), then
    the epilogue ``mode`` with the body's roundings, the stacks' own
    (``_proj``, the residual add, ``_gelu``, ``_gelu_grad``): bias
    round(acc + b); bias_res round(res + round(acc + b)); bias_gelu a1 =
    round(acc + b), out2 = round(gelu(a1)); gelu_grad v = acc *
    gelu'(aux), fp32 and rounded; f32 acc; f32_add outf + acc; round
    round(acc); partial the fp32 sum over each split's K range
    (``gemm_k_chunk``). Returns the outputs the body writes
    (``GEMM_OUTPUTS``)."""
    dt = a.dtype
    am = a.float().t() if a_km else a.float()   # (M, K)
    bm = b.float() if b_kn else b.float().t()   # (K, N)
    if mode == "partial":
        c = gemm_k_chunk(am.shape[1], splits)
        return {"outf": torch.stack([am[:, z * c:(z + 1) * c]
                                     @ bm[z * c:(z + 1) * c]
                                     for z in range(splits)])}
    acc = am @ bm
    if mode == "bias":
        return {"out": (acc + bias.float()).to(dt)}
    if mode == "bias_res":
        return {"out": res + (acc + bias.float()).to(dt)}
    if mode == "bias_gelu":
        a1 = (acc + bias.float()).to(dt)
        return {"out": a1, "out2": _gelu(a1.float(), gelu).to(dt)}
    if mode == "gelu_grad":
        v = acc * _gelu_grad(aux.float(), gelu)
        return {"outf": v, "out": v.to(dt)}
    if mode == "f32":
        return {"outf": acc}
    if mode == "f32_add":
        return {"outf": outf + acc}
    if mode == "round":
        return {"out": acc.to(dt)}
    raise ValueError(f"gemm body: unknown epilogue {mode!r}")


def _gemm_library(a_km: bool, b_kn: bool, mode: str):
    """(the library's C entry, its error string) for a pair the stacks
    launch."""
    from mae_clip_torch.ops._build import (load_block_stack_bwd,
                                           load_block_stack_fwd)

    key = ("km" if a_km else "mk", "kn" if b_kn else "nk", mode)
    if key not in GEMM_PAIRS:
        raise ValueError(f"gemm body: the stacks launch no product {key}; "
                         f"they launch {sorted(GEMM_PAIRS)}")
    if GEMM_PAIRS[key] == "fwd":
        lib = load_block_stack_fwd()
        return lib.block_stack_fwd_gemm, lib.block_stack_error_string
    lib = load_block_stack_bwd()
    return lib.block_stack_bwd_gemm, lib.block_stack_bwd_error_string


def _launch_gemm(a, b, mode: str, a_km: bool = False, b_kn: bool = False,
                 bias=None, res=None, aux=None, out=None, out2=None,
                 outf=None, gelu: str = "tanh", splits: int = 1) -> None:
    """The body on the card into the given outputs (f32_add adds into
    ``outf``): bf16, dense. Raises where the body does not take the product;
    no other body runs it."""
    entry, error_string = _gemm_library(a_km, b_kn, mode)
    m, n, k = gemm_dims(a, b, a_km, b_kn)
    err = entry(_ptr(a), _ptr(b), _ptr(bias), _ptr(res), _ptr(aux),
                _ptr(out), _ptr(out2), _ptr(outf), m, n, k, int(a_km),
                int(b_kn), GEMM_MODES.index(mode), _GELU_CODES[gelu], splits,
                _stream(a))
    _raise_on_error(err, error_string, "gemm body")


def gemm_body(a, b, mode: str, a_km: bool = False, b_kn: bool = False,
              bias=None, res=None, aux=None, outf=None, gelu: str = "tanh",
              splits: int = 1) -> Dict[str, Any]:
    """One product of the stacks' GEMM body alone, as ``gemm_body_ref``
    (``outf`` is the f32_add epilogue's input, left as it is): the
    tensor-core body of the library that launches the pair on a CUDA
    tensor (bf16, dense), its plain version on a CPU one. For checking each
    template; the stacks call the body from C."""
    if a.device.type == "cpu":
        return gemm_body_ref(a, b, mode, a_km, b_kn, bias, res, aux, outf,
                             gelu, splits)
    tensors = [t for t in (a, b, bias, res, aux, outf) if t is not None]
    if a.dtype != torch.bfloat16 or any(
            t.device != a.device or not t.is_contiguous() for t in tensors):
        raise ValueError("gemm body: contiguous bf16 operands on one CUDA "
                         "device")
    m, n, _ = gemm_dims(a, b, a_km, b_kn)
    outs = {}
    for name in GEMM_OUTPUTS[mode]:
        if name == "outf":
            outs[name] = (outf.clone() if mode == "f32_add" else
                          torch.empty((splits, m, n) if mode == "partial"
                                      else (m, n), dtype=torch.float32,
                                      device=a.device))
        else:
            outs[name] = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _launch_gemm(a, b, mode, a_km, b_kn, bias, res, aux, outs.get("out"),
                 outs.get("out2"), outs.get("outf"), gelu, splits)
    return outs


def gemm_dw_splits(out: int, in_: int, rows: int) -> int:
    """The row splits #7 takes for a weight gradient (out, in) over ``rows``
    rows (``dw_splits`` in csrc/block_stack_bwd.cu)."""
    from mae_clip_torch.ops._build import load_block_stack_bwd

    return load_block_stack_bwd().block_stack_bwd_dw_splits(out, in_, rows)
